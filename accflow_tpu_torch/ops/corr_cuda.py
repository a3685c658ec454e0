"""Correlation window lookup as a hand-written CUDA kernel for Hopper.

Replaces accflow_tpu/ops/corr_pallas.py::lookup_corr_fused (and the XLA
"fused" lookup the JAX package defaults to). The kernel is
csrc/corr_lookup.cu; its header says how it works and what bounds it.

Build: nvcc compiles the source for sm_90a into a shared library with a C
interface at first use, into `_build/` beside this package (named by a
hash of source and flags, so an edited source rebuilds), and ctypes loads
it. Nothing is compiled on import: the CPU tests import this module on a
machine with no nvcc.

`lookup_corr_fused` takes CPU tensors to the plain lookup
(ops/corr.py::lookup_corr_plain) and CUDA tensors to the kernel, or raises.
`launches` counts kernel launches and nothing else. Radius (4) and level
count (4) are compiled into the kernel; `build` and `launch` also take a
variant built with other -D defines (chip_smoke.py's tile sweep).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from accflow_tpu_torch.ops.corr import lookup_corr_plain

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "corr_lookup.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
RADIUS = 4  # compiled into the kernel, as is the level count
LEVELS = 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the correlation lookup kernel cannot be built")


def build(*defines: str) -> tuple[str, str]:
    """Compile the kernel (with extra `defines`, e.g. "-DCORR_QT=16") unless
    this source and these flags were built before. Returns (library path,
    compiler output; empty when cached)."""
    flags = (*NVCC_FLAGS, *defines)
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"corr_lookup-{tag}.so"
    if lib.exists():
        return str(lib), ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return str(lib), proc.stdout + proc.stderr


def load(path: str) -> ctypes.CDLL:
    """The built library at `path`, with the C function's signature."""
    lib = ctypes.CDLL(path)
    lib.corr_lookup.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.corr_lookup.restype = ctypes.c_int
    return lib


def _check(levels, coords: torch.Tensor, radius: int) -> None:
    if radius != RADIUS:
        raise ValueError(f"the lookup is built for radius {RADIUS}, got {radius}")
    if len(levels) != LEVELS:
        raise ValueError(f"the lookup is built for {LEVELS} levels, got {len(levels)}")
    if coords.dtype != torch.float32 or coords.dim() != 2 or coords.shape[1] != 2:
        raise ValueError(f"coords must be (Q, 2) float32, got {tuple(coords.shape)} {coords.dtype}")
    if not coords.is_contiguous():
        raise ValueError("coords must be contiguous")
    q = coords.shape[0]
    for i, lvl in enumerate(levels):
        if lvl.dim() != 3 or lvl.shape[0] != q:
            raise ValueError(f"level {i} must be (Q={q}, hl, wl), got {tuple(lvl.shape)}")
        if lvl.dtype != levels[0].dtype or lvl.dtype not in _DTYPE_CODE:
            raise ValueError(f"levels must all be float32 or all bfloat16, level {i} is {lvl.dtype}")
        if lvl.device != coords.device:
            raise ValueError(f"level {i} is on {lvl.device}, coords on {coords.device}")
        if not lvl.is_contiguous():
            raise ValueError(f"level {i} must be contiguous")


def lookup_corr_fused(levels, coords: torch.Tensor, radius: int = RADIUS) -> torch.Tensor:
    """levels: list of 4 (Q, hl, wl) float32 or bfloat16 maps; coords (Q, 2)
    float32 -> (Q, 324) float32 in the reference channel layout (see
    ops/corr.py). CPU tensors take the plain lookup; CUDA tensors the kernel."""
    global _lib
    _check(levels, coords, radius)
    if coords.device.type == "cpu":
        return lookup_corr_plain(levels, coords, radius)
    if coords.device.type != "cuda":
        raise ValueError(f"no lookup for device {coords.device}")
    if _lib is None:
        _lib = load(build()[0])
    return launch(_lib, levels, coords)


def launch(lib: ctypes.CDLL, levels, coords: torch.Tensor) -> torch.Tensor:
    """Run the kernel of `lib` (from `load`) on CUDA tensors that passed
    `lookup_corr_fused`'s checks; raises if the launch fails."""
    global launches
    q = coords.shape[0]
    out = torch.empty((q, LEVELS * (2 * RADIUS + 1) ** 2), dtype=torch.float32,
                      device=coords.device)
    if q == 0:
        return out
    ptrs = (ctypes.c_void_p * LEVELS)(*[lvl.data_ptr() for lvl in levels])
    hw = (ctypes.c_int * (2 * LEVELS))(*[d for lvl in levels for d in lvl.shape[1:]])
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.corr_lookup(_DTYPE_CODE[levels[0].dtype], coords.data_ptr(), ptrs,
                             hw, q, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"corr_lookup kernel launch failed: cudaError {rc}")
    launches += 1
    return out
