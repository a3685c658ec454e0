"""Correlation window lookup as a hand-written CUDA kernel for Hopper.

Replaces accflow_tpu/ops/corr_pallas.py::lookup_corr_fused (and the XLA
"fused" lookup the JAX package defaults to). The kernel is
csrc/corr_lookup.cu; its header says how it works and what bounds it.

Build: nvcc compiles the source for sm_90a at first use into a shared
library with a C interface, which ctypes loads (ops/cuda_lib.py). Nothing
is compiled on import.

`lookup_corr_fused` takes CPU tensors to the plain lookup
(ops/corr.py::lookup_corr_plain) and CUDA tensors to the kernel, or raises.
`launches` counts kernel launches and nothing else. Radius (4) and level
count (4) are compiled into the kernel; `build` and `launch` also take a
variant built with other -D defines (chip_smoke.py's tile sweep).
"""

from __future__ import annotations

import ctypes

import torch

from accflow_tpu_torch.ops import cuda_lib
from accflow_tpu_torch.ops.corr import lookup_corr_plain

SOURCE = cuda_lib.CSRC / "corr_lookup.cu"
RADIUS = 4  # compiled into the kernel, as is the level count
LEVELS = 4

launches = 0
_lib = None


def build(*defines: str) -> tuple[str, str]:
    """Compile the kernel (with extra `defines`, e.g. "-DCORR_QT=16") unless
    this source and these flags were built before. Returns (library path,
    compiler output; empty when cached)."""
    return cuda_lib.build(SOURCE, *defines)


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
    cuda_lib.check_lookup_operands(levels, coords)


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
        rc = lib.corr_lookup(cuda_lib.DTYPE_CODE[levels[0].dtype], coords.data_ptr(), ptrs,
                             hw, q, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"corr_lookup kernel launch failed: cudaError {rc}")
    launches += 1
    return out
