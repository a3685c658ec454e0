"""Building the port's CUDA sources, checking the lookups' operands, and
refusing autograd through kernel #3's op.

Build: nvcc compiles a source from csrc/ for sm_90a into a shared library
with a C interface, into `_build/` beside this package (named by a hash of
source, the headers of csrc/ and flags, so an edited source or header
rebuilds), and the wrapper loads it
with ctypes. Nothing is compiled on import: the CPU tests import the
wrappers on a machine with no nvcc.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from accflow_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' level types


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels cannot be built")


def build(source: Path, *defines: str) -> tuple[str, str]:
    """Compile `source` (with extra `defines`, e.g. "-DCORR_QT=16") unless
    this source and these flags were built before. Returns (library path,
    compiler output; empty when cached). The nvcc run or the cache hit is
    the host span "cuda_lib.build" (utils/profiling.py)."""
    with profiling.span("cuda_lib.build", "host"):
        flags = (*NVCC_FLAGS, *defines)
        src = source.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"{source.stem}-{tag}.so"
        if lib.exists():
            return str(lib), ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
        return str(lib), proc.stdout + proc.stderr


def check_lookup_operands(levels, coords: torch.Tensor) -> None:
    """Raise ValueError unless coords is contiguous (Q, 2) float32 and every
    level a contiguous (Q, hl, wl) map of one kernel level type on coords'
    device: what the lookup kernels take."""
    if coords.dtype != torch.float32 or coords.dim() != 2 or coords.shape[1] != 2:
        raise ValueError(f"coords must be (Q, 2) float32, got {tuple(coords.shape)} {coords.dtype}")
    if not coords.is_contiguous():
        raise ValueError("coords must be contiguous")
    q = coords.shape[0]
    for i, lvl in enumerate(levels):
        if lvl.dim() != 3 or lvl.shape[0] != q:
            raise ValueError(f"level {i} must be (Q={q}, hl, wl), got {tuple(lvl.shape)}")
        if lvl.dtype != levels[0].dtype or lvl.dtype not in DTYPE_CODE:
            raise ValueError(f"levels must all be float32 or all bfloat16, level {i} is {lvl.dtype}")
        if lvl.device != coords.device:
            raise ValueError(f"level {i} is on {lvl.device}, coords on {coords.device}")
        if not lvl.is_contiguous():
            raise ValueError(f"level {i} must be contiguous")


def refuse_autograd(op, name: str) -> None:
    """Make a call of the custom op `op` (`name`, "accflow::y_contract")
    raise when autograd would record it: grad mode on and an input that
    requires grad. Kernel #3 has no backward (neither had the TPU kernel,
    accflow_tpu/ops/corr_pallas.py:71-73); it serves inference and the
    frozen estimator of accumulator training, under no_grad. Without this,
    PyTorch would run the forward and fail only in backward(). (The lookup
    ops #1 and #2 have a backward kernel: ops/corr_backward_cuda.py.)"""
    def setup_context(ctx, inputs, output):
        raise RuntimeError(
            f"{name} has no backward, and neither has the reference's y_contract_bd: a "
            "fine_tune with a corr_lookup that has a bd level (experimental:fused_bd[2], "
            "experimental:fused_mix:...bd...) cannot run in either package (ROADMAP.md, "
            "queue 3, #16); fine-tune with corr_lookup 'fused'")

    def backward(ctx, grad):
        raise AssertionError("unreachable: setup_context refuses")

    op.register_autograd(backward, setup_context=setup_context)
