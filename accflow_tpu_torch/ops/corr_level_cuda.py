"""Per-level correlation window lookup as a hand-written CUDA kernel for
Hopper, at radius 3 or 4 over RAFT's 4 levels.

Replaces accflow_tpu/ops/corr_pallas.py::lookup_corr_pallas, the TPU
per-level kernel that RAFT-small reaches (`corr_lookup="experimental:pallas"`).
The kernel is csrc/corr_level_lookup.cu; its header says how it works and
what bounds it. It computes what ops/corr.py::lookup_corr_plain computes:
the same function as ops/corr_cuda.py's 4-level radius-4 kernel, which full
RAFT keeps; RAFT-small always takes this one.

`lookup_corr_level` takes CPU tensors to the plain lookup and CUDA tensors
to the kernel, or raises. `launches` counts kernel launches and nothing
else. Built at first use (ops/cuda_lib.py), never on import; `build` and
`launch` also take a variant built for another level count
("-DCORR_LEVELS=1": chip_smoke.py's one-level probe).
"""

from __future__ import annotations

import ctypes

import torch

from accflow_tpu_torch.ops import cuda_lib
from accflow_tpu_torch.ops.corr import lookup_corr_plain

SOURCE = cuda_lib.CSRC / "corr_level_lookup.cu"
RADII = (3, 4)  # the instantiated template radii
LEVELS = 4  # compiled into the kernel (the default build)

launches = 0
_lib = None


def build(*defines: str) -> tuple[str, str]:
    """Compile the kernel (with extra `defines`, e.g. "-DCORR_LEVELS=1")
    unless this source and these flags were built before. Returns (library
    path, compiler output; empty when cached)."""
    return cuda_lib.build(SOURCE, *defines)


def load(path: str) -> ctypes.CDLL:
    """The built library at `path`, with the C function's signature."""
    lib = ctypes.CDLL(path)
    lib.corr_level_lookup.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.corr_level_lookup.restype = ctypes.c_int
    lib.corr_level_lookup_levels.argtypes = []
    lib.corr_level_lookup_levels.restype = ctypes.c_int
    return lib


def _check(levels, coords: torch.Tensor, radius: int) -> None:
    if radius not in RADII:
        raise ValueError(f"the per-level lookup is built for radius {RADII}, got {radius}")
    if len(levels) != LEVELS:
        raise ValueError(f"the per-level lookup is built for {LEVELS} levels, got {len(levels)}")
    cuda_lib.check_lookup_operands(levels, coords)


def lookup_corr_level(levels, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """levels: list of 4 (Q, hl, wl) float32 or bfloat16 maps; coords (Q, 2)
    float32 in level-0 pixels -> (Q, 4*(2r+1)^2) float32 in the reference
    channel layout (see ops/corr.py). CPU tensors take the plain lookup;
    CUDA tensors the kernel."""
    global _lib
    _check(levels, coords, radius)
    if coords.device.type == "cpu":
        return lookup_corr_plain(levels, coords, radius)
    if coords.device.type != "cuda":
        raise ValueError(f"no lookup for device {coords.device}")
    if _lib is None:
        _lib = load(build()[0])
    return launch(_lib, levels, coords, radius)


def launch(lib: ctypes.CDLL, levels, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Run the kernel of `lib` (from `load`) on CUDA tensors that passed
    `lookup_corr_level`'s checks (for as many levels as `lib` was built
    for); raises if the level count differs or the launch fails."""
    global launches
    n = len(levels)
    if lib.corr_level_lookup_levels() != n:
        raise ValueError(f"the library is built for {lib.corr_level_lookup_levels()} "
                         f"levels, got {n}")
    q = coords.shape[0]
    out = torch.empty((q, n * (2 * radius + 1) ** 2), dtype=torch.float32,
                      device=coords.device)
    if q == 0:
        return out
    ptrs = (ctypes.c_void_p * n)(*[lvl.data_ptr() for lvl in levels])
    hw = (ctypes.c_int * (2 * n))(*[d for lvl in levels for d in lvl.shape[1:]])
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.corr_level_lookup(cuda_lib.DTYPE_CODE[levels[0].dtype], radius,
                                   coords.data_ptr(), ptrs, hw, q, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"corr_level_lookup kernel launch failed: cudaError {rc}")
    launches += 1
    return out
