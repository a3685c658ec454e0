"""The correlation lookups' backward as a hand-written CUDA kernel for
Hopper, and the autograd of the lookup ops.

JAX fine-tunes through the XLA "fused" lookup, whose gradient with respect
to the pyramid levels XLA's autodiff derives; the TPU kernels have no
backward (accflow_tpu/ops/corr_pallas.py:71-73). The port's lookups are
kernels #1 and #2 (ops/corr_cuda.py, ops/corr_level_cuda.py), so their
gradient is a kernel too: csrc/corr_lookup_backward.cu, the template of
csrc/corr_window_backward.cuh (whose header says how it works and what
bounds it) for kernel #1 (radius 4, 4 levels) and kernel #2 (any radius
and level count), built by nvcc at first use (ops/cuda_lib.py), never on
import. As kernel #2's, the libraries go by (radius, levels) (`library`):
the default build has kernel #1's entry and kernel #2's at radius 3 or 4
over 4 levels; every other pair has a build of its own with -DCORR_RADIUS
and -DCORR_LEVELS and kernel #2's entry alone, so fine_tune trains at any
corr_radius and corr_levels, as JAX's autodiff does.

Two torch ops carry it, `accflow::corr_lookup_backward` and
`accflow::corr_level_lookup_backward`: the plain backward on the CPU
(ops/corr.py::lookup_corr_plain_backward), the kernel on CUDA (or they
raise), and a fake implementation that gives the outputs' shapes and
dtypes, so that a CUDA graph can capture the step. `register_autograd`
makes them the backward of `accflow::corr_lookup` and
`accflow::corr_level_lookup`: the levels get their gradient, in the
levels' dtype; coords get none (JAX stops it), and a call whose coords
require grad raises. `launches` counts kernel #1's backward launches,
`level_launches` kernel #2's (`level_build_launches` per (radius,
levels)), and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from accflow_tpu_torch.ops import cuda_lib
from accflow_tpu_torch.ops.corr import lookup_corr_plain_backward

SOURCE = cuda_lib.CSRC / "corr_lookup_backward.cu"
LEVELS = 4  # kernel #1's entry, and kernel #2's in the default build
RADII = (3, 4)  # kernel #2's entry in the default build
ENTRIES = ("corr_lookup_backward", "corr_level_lookup_backward")

launches = 0        # accflow::corr_lookup_backward (kernel #1's, radius 4)
level_launches = 0  # accflow::corr_level_lookup_backward (kernel #2's)
level_build_launches: dict = {}  # (radius, levels) -> kernel #2's backward launches
_libs: dict = {}  # (radius, levels) -> the loaded library

_SCHEMA = ("(Tensor grad_out, Tensor coords, int[] hw, int radius, ScalarType dtype) "
           "-> Tensor[]")


def build(*defines: str) -> tuple[str, str]:
    """Compile the backward kernel's library unless this source and these
    flags were built before. Returns (library path, compiler output; empty
    when cached)."""
    return cuda_lib.build(SOURCE, *defines)


def defines(radius: int, levels: int) -> tuple:
    """The -D flags of the build whose kernel #2 entry serves (radius,
    levels): none for the default build, else -DCORR_RADIUS and
    -DCORR_LEVELS."""
    if radius in RADII and levels == LEVELS:
        return ()
    return (f"-DCORR_RADIUS={radius}", f"-DCORR_LEVELS={levels}")


def library(radius: int, levels: int) -> ctypes.CDLL:
    """The loaded library for (radius, levels), built at its first use
    (kernel #1's entry: library(4, 4))."""
    key = (radius, levels)
    if key not in _libs:
        _libs[key] = load(build(*defines(radius, levels))[0])
    return _libs[key]


def load(path: str) -> ctypes.CDLL:
    """The built library at `path`, with its C functions' signatures (a
    build for another radius or level count has kernel #2's entry alone)."""
    lib = ctypes.CDLL(path)
    ptrs = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.c_longlong, ctypes.c_void_p]
    if hasattr(lib, ENTRIES[0]):
        lib.corr_lookup_backward.argtypes = [ctypes.c_int, ctypes.c_int, *ptrs]
        lib.corr_lookup_backward.restype = ctypes.c_int
    lib.corr_level_lookup_backward.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, *ptrs]
    lib.corr_level_lookup_backward.restype = ctypes.c_int
    for query in ("corr_level_lookup_backward_levels", "corr_level_lookup_backward_radius"):
        getattr(lib, query).argtypes = []
        getattr(lib, query).restype = ctypes.c_int
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
    nl = len(hw) // 2
    cols = nl * (2 * radius + 1) ** 2
    if nl < 1 or len(hw) != 2 * nl or grad_out.shape != (coords.shape[0], cols):
        raise ValueError(f"grad_out must be (Q={coords.shape[0]}, {cols}) for {nl} levels at "
                         f"radius {radius}, got {tuple(grad_out.shape)}")
    if not (grad_out.is_contiguous() and coords.is_contiguous()):
        raise ValueError("grad_out and coords must be contiguous")
    if grad_out.device != coords.device:
        raise ValueError(f"grad_out is on {grad_out.device}, coords on {coords.device}")


def launch(lib: ctypes.CDLL, entry: str, grad_out: torch.Tensor, coords: torch.Tensor, hw,
           radius: int, dtype: torch.dtype) -> list:
    """Run `entry` of `lib` (from `load`; "corr_lookup_backward" takes
    radius 4 over 4 levels, "corr_level_lookup_backward" the radius and
    level count `lib` was built for) on CUDA tensors: the levels' (Q, hl,
    wl) gradients in `dtype`. Raises on operands it does not take and if
    the launch fails."""
    global launches, level_launches
    _check(grad_out, coords, hw, radius, dtype)
    nl = len(hw) // 2
    if entry == ENTRIES[0]:
        if (radius, nl) != (4, LEVELS):
            raise ValueError(f"{entry} is built for radius 4 over {LEVELS} levels, got radius "
                             f"{radius} over {nl}")
    else:
        built = lib.corr_level_lookup_backward_radius()
        if (lib.corr_level_lookup_backward_levels() != nl
                or radius not in ((built,) if built else RADII)):
            raise ValueError(f"{entry}: the library is built for radius {built or RADII} over "
                             f"{lib.corr_level_lookup_backward_levels()} levels, got radius "
                             f"{radius} over {nl}")
    q = coords.shape[0]
    grads = [torch.empty((q, h, w), dtype=dtype, device=coords.device) for h, w in _shapes(hw)]
    if q == 0:
        return grads
    if grad_out.data_ptr() % (4 * grad_out.element_size()):
        # The kernel copies each query's row in pieces of up to 4 values.
        grad_out = grad_out.clone(memory_format=torch.contiguous_format)
    ptrs = (ctypes.c_void_p * nl)(*[g.data_ptr() for g in grads])
    dims = (ctypes.c_int * (2 * nl))(*hw)
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
        level_build_launches[radius, nl] = level_build_launches.get((radius, nl), 0) + 1
    return grads


def _cuda(entry: str):
    def kernel(grad_out, coords, hw, radius, dtype):
        return launch(library(radius, len(hw) // 2), entry, grad_out, coords, hw, radius, dtype)

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
