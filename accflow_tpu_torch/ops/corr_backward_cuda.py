"""The correlation lookups' backward as a hand-written CUDA kernel for
Hopper, and the autograd of the lookup ops.

JAX fine-tunes through the XLA "fused" lookup, whose gradient with respect
to the pyramid levels XLA's autodiff derives; the TPU kernels have no
backward (accflow_tpu/ops/corr_pallas.py:71-73). The port's lookups are
kernels #1 and #2 (ops/corr_cuda.py, ops/corr_level_cuda.py), so their
gradient is a kernel too: csrc/corr_lookup_backward.cu, the template of
csrc/corr_window_backward.cuh (whose header says how it works and what
bounds it) for kernel #1 (radius 4) and kernel #2 (radius 3 or 4), one
library with two C entries, built by nvcc at first use (ops/cuda_lib.py),
never on import.

Two torch ops carry it, `accflow::corr_lookup_backward` and
`accflow::corr_level_lookup_backward`: the plain backward on the CPU
(ops/corr.py::lookup_corr_plain_backward), the kernel on CUDA (or they
raise), and a fake implementation that gives the outputs' shapes and
dtypes, so that a CUDA graph can capture the step. `register_autograd`
makes them the backward of `accflow::corr_lookup` and
`accflow::corr_level_lookup`: the levels get their gradient, in the
levels' dtype; coords get none (JAX stops it), and a call whose coords
require grad raises. `launches` counts kernel #1's backward launches,
`level_launches` kernel #2's, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from accflow_tpu_torch.ops import cuda_lib
from accflow_tpu_torch.ops.corr import lookup_corr_plain_backward

SOURCE = cuda_lib.CSRC / "corr_lookup_backward.cu"
LEVELS = 4  # compiled into both entries
ENTRIES = ("corr_lookup_backward", "corr_level_lookup_backward")

launches = 0        # accflow::corr_lookup_backward (kernel #1's, radius 4)
level_launches = 0  # accflow::corr_level_lookup_backward (kernel #2's, radius 3 or 4)
_lib = None

_SCHEMA = ("(Tensor grad_out, Tensor coords, int[] hw, int radius, ScalarType dtype) "
           "-> Tensor[]")


def build(*defines: str) -> tuple[str, str]:
    """Compile the backward kernel's library unless this source and these
    flags were built before. Returns (library path, compiler output; empty
    when cached)."""
    return cuda_lib.build(SOURCE, *defines)


def load(path: str) -> ctypes.CDLL:
    """The built library at `path`, with both C functions' signatures."""
    lib = ctypes.CDLL(path)
    ptrs = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.c_longlong, ctypes.c_void_p]
    lib.corr_lookup_backward.argtypes = [ctypes.c_int, ctypes.c_int, *ptrs]
    lib.corr_level_lookup_backward.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, *ptrs]
    for entry in ENTRIES:
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def _shapes(hw) -> list:
    return [(hw[2 * i], hw[2 * i + 1]) for i in range(len(hw) // 2)]


def _check(grad_out: torch.Tensor, coords: torch.Tensor, hw, radius: int, dtype) -> None:
    """Raise ValueError unless the operands are what the kernel takes."""
    if dtype not in cuda_lib.DTYPE_CODE or grad_out.dtype not in cuda_lib.DTYPE_CODE:
        raise ValueError(f"levels and window gradient must be float32 or bfloat16, got "
                         f"{dtype} and {grad_out.dtype}")
    if coords.dtype != torch.float32 or coords.dim() != 2 or coords.shape[1] != 2:
        raise ValueError(f"coords must be (Q, 2) float32, got {tuple(coords.shape)} {coords.dtype}")
    cols = len(hw) // 2 * (2 * radius + 1) ** 2
    if len(hw) != 2 * LEVELS or grad_out.shape != (coords.shape[0], cols):
        raise ValueError(f"grad_out must be (Q={coords.shape[0]}, {cols}) for {LEVELS} levels, got "
                         f"{tuple(grad_out.shape)} for {len(hw) // 2}")
    if not (grad_out.is_contiguous() and coords.is_contiguous()):
        raise ValueError("grad_out and coords must be contiguous")
    if grad_out.device != coords.device:
        raise ValueError(f"grad_out is on {grad_out.device}, coords on {coords.device}")


def launch(lib: ctypes.CDLL, entry: str, grad_out: torch.Tensor, coords: torch.Tensor, hw,
           radius: int, dtype: torch.dtype) -> list:
    """Run `entry` of `lib` (from `load`; "corr_lookup_backward" takes
    radius 4) on CUDA tensors: the 4 levels' (Q, hl, wl) gradients in
    `dtype`. Raises on operands it does not take and if the launch fails."""
    global launches, level_launches
    _check(grad_out, coords, hw, radius, dtype)
    if entry == ENTRIES[0] and radius != 4:
        raise ValueError(f"{entry} is built for radius 4, got {radius}")
    q = coords.shape[0]
    grads = [torch.empty((q, h, w), dtype=dtype, device=coords.device) for h, w in _shapes(hw)]
    if q == 0:
        return grads
    if grad_out.data_ptr() % (4 * grad_out.element_size()):
        # The kernel copies each query's row in whole 4-value pieces.
        grad_out = grad_out.clone(memory_format=torch.contiguous_format)
    ptrs = (ctypes.c_void_p * LEVELS)(*[g.data_ptr() for g in grads])
    dims = (ctypes.c_int * (2 * LEVELS))(*hw)
    args = (coords.data_ptr(), grad_out.data_ptr(), ptrs, dims, q)
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        codes = (cuda_lib.DTYPE_CODE[dtype], cuda_lib.DTYPE_CODE[grad_out.dtype])
        if entry == ENTRIES[0]:
            rc = lib.corr_lookup_backward(*codes, *args, stream)
        else:
            rc = lib.corr_level_lookup_backward(*codes, radius, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    if entry == ENTRIES[0]:
        launches += 1
    else:
        level_launches += 1
    return grads


def _cuda(entry: str):
    def kernel(grad_out, coords, hw, radius, dtype):
        global _lib
        if _lib is None:
            _lib = load(build()[0])
        return launch(_lib, entry, grad_out, coords, hw, radius, dtype)

    return kernel


def _cpu(grad_out, coords, hw, radius, dtype):
    """CPU: the plain backward."""
    return lookup_corr_plain_backward(grad_out, coords, _shapes(hw), radius, dtype)


def _fake(grad_out, coords, hw, radius, dtype):
    return [coords.new_empty((coords.shape[0], h, w), dtype=dtype) for h, w in _shapes(hw)]


corr_lookup_backward_op = torch.library.custom_op(
    "accflow::corr_lookup_backward", _cpu, mutates_args=(), device_types="cpu", schema=_SCHEMA)
corr_level_lookup_backward_op = torch.library.custom_op(
    "accflow::corr_level_lookup_backward", _cpu, mutates_args=(), device_types="cpu",
    schema=_SCHEMA)
for _op, _entry in ((corr_lookup_backward_op, ENTRIES[0]),
                    (corr_level_lookup_backward_op, ENTRIES[1])):
    _op.register_kernel("cuda")(_cuda(_entry))
    _op.register_fake(_fake)


def register_autograd(op, backward_op, name: str, radius=None) -> None:
    """Make `backward_op` the backward of the lookup op `op` (`name`), whose
    inputs are (levels, coords, out_dtype) at the fixed `radius`, or
    (levels, coords, radius, out_dtype) when `radius` is None: the levels
    get their gradient, computed from the window's gradient and the coords
    saved by the forward; a call whose coords require grad raises, since the
    lookup has no gradient with respect to them (JAX stops it,
    accflow_tpu/models/raft.py:573)."""
    def setup_context(ctx, inputs, output):
        levels, coords = inputs[0], inputs[1]
        if coords.requires_grad:
            raise RuntimeError(
                f"{name}: coords require grad, but the lookup has no gradient with respect to "
                "them (JAX stops it at the top of every GRU iteration); detach them")
        ctx.save_for_backward(coords)
        ctx.hw = [d for lvl in levels for d in lvl.shape[1:]]
        ctx.radius = inputs[2] if radius is None else radius
        ctx.dtype = levels[0].dtype
        ctx.n_inputs = len(inputs)

    def backward(ctx, grad):
        (coords,) = ctx.saved_tensors
        grads = backward_op(grad.contiguous(), coords, ctx.hw, ctx.radius, ctx.dtype)
        return (list(grads),) + (None,) * (ctx.n_inputs - 1)

    op.register_autograd(backward, setup_context=setup_context)
