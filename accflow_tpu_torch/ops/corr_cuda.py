"""Correlation window lookup as a hand-written CUDA kernel for Hopper.

Replaces accflow_tpu/ops/corr_pallas.py::lookup_corr_fused (and the XLA
"fused" lookup the JAX package defaults to). The kernel is
csrc/corr_lookup.cu, the window kernel of csrc/corr_window.cuh at radius 4
(shared with ops/corr_level_cuda.py); their headers say how it works and
what bounds it.

Build: nvcc compiles the source for sm_90a at first use into a shared
library with a C interface, which ctypes loads (ops/cuda_lib.py). Nothing
is compiled on import.

`lookup_corr_fused` checks its operands and calls the torch op
`accflow::corr_lookup` (`corr_lookup_op`), whose CPU implementation is the
plain lookup (ops/corr.py::lookup_corr_plain) and whose CUDA
implementation launches the kernel, or raises; its fake implementation
gives the output's shape and dtype, so torch.export traces it and a CUDA
graph captures it as one dispatched op. `out_dtype` (float32, the TPU
kernel's, or bfloat16) is the output's type: bfloat16 is the float32 blend
rounded once to nearest even, bit for bit the float32 output cast.
`launches` counts kernel launches and nothing else (a CUDA graph's replay
of a captured launch does not pass through Python and is not counted).
Its backward is the backward kernel's op `accflow::corr_lookup_backward`
(ops/corr_backward_cuda.py): the levels' gradient, the coords none.
Radius (4) and level count (4) are compiled into the kernel: it serves
full RAFT's and GMA's default corr_radius 4 over corr_levels 4, and every
other (radius, levels) goes to kernel #2's build for it
(ops/corr.py::lookup_corr_kernel, ops/corr_level_cuda.py). `build` and
`launch` also take a variant built with other -D defines (chip_smoke.py's
tile sweep over CORR_QT, the queries per block).
"""

from __future__ import annotations

import ctypes

import torch

from accflow_tpu_torch.ops import corr_backward_cuda, cuda_lib
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
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.corr_lookup.restype = ctypes.c_int
    return lib


def _check(levels, coords: torch.Tensor, radius: int, out_dtype: torch.dtype) -> None:
    if out_dtype not in cuda_lib.DTYPE_CODE:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if radius != RADIUS:
        raise ValueError(f"the lookup is built for radius {RADIUS}, got {radius}")
    if len(levels) != LEVELS:
        raise ValueError(f"the lookup is built for {LEVELS} levels, got {len(levels)}")
    cuda_lib.check_lookup_operands(levels, coords)


def lookup_corr_fused(levels, coords: torch.Tensor, radius: int = RADIUS,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """levels: list of 4 (Q, hl, wl) float32 or bfloat16 maps; coords (Q, 2)
    float32 -> (Q, 324) in `out_dtype` (float32 or bfloat16), in the
    reference channel layout (see ops/corr.py). CPU tensors take the plain
    lookup; CUDA tensors the kernel."""
    _check(levels, coords, radius, out_dtype)
    if coords.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no lookup for device {coords.device}")
    return corr_lookup_op(list(levels), coords, out_dtype)


@torch.library.custom_op("accflow::corr_lookup", mutates_args=(), device_types="cpu",
                         schema="(Tensor[] levels, Tensor coords, ScalarType out_dtype) -> Tensor")
def corr_lookup_op(levels, coords, out_dtype):
    """The op behind lookup_corr_fused, on operands that passed its checks.
    CPU: the plain lookup."""
    return lookup_corr_plain(levels, coords, RADIUS, out_dtype)


@corr_lookup_op.register_kernel("cuda")
def _(levels, coords, out_dtype):
    global _lib
    if _lib is None:
        _lib = load(build()[0])
    return launch(_lib, levels, coords, out_dtype)


@corr_lookup_op.register_fake
def _(levels, coords, out_dtype):
    return coords.new_empty((coords.shape[0], LEVELS * (2 * RADIUS + 1) ** 2), dtype=out_dtype)


corr_backward_cuda.register_autograd(corr_lookup_op, corr_backward_cuda.corr_lookup_backward_op,
                                     "accflow::corr_lookup", radius=RADIUS)


def launch(lib: ctypes.CDLL, levels, coords: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Run the kernel of `lib` (from `load`) on CUDA tensors that passed
    `lookup_corr_fused`'s checks; raises if the launch fails."""
    global launches
    q = coords.shape[0]
    out = torch.empty((q, LEVELS * (2 * RADIUS + 1) ** 2), dtype=out_dtype,
                      device=coords.device)
    if q == 0:
        return out
    ptrs = (ctypes.c_void_p * LEVELS)(*[lvl.data_ptr() for lvl in levels])
    hw = (ctypes.c_int * (2 * LEVELS))(*[d for lvl in levels for d in lvl.shape[1:]])
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.corr_lookup(cuda_lib.DTYPE_CODE[levels[0].dtype], cuda_lib.DTYPE_CODE[out_dtype],
                             coords.data_ptr(), ptrs, hw, q, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"corr_lookup kernel launch failed: cudaError {rc}")
    launches += 1
    return out
