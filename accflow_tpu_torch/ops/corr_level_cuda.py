"""Per-level correlation window lookup as a hand-written CUDA kernel for
Hopper, at any radius and level count.

Replaces accflow_tpu/ops/corr_pallas.py::lookup_corr_pallas, the TPU
per-level kernel that RAFT-small reaches (`corr_lookup="experimental:pallas"`).
The kernel is csrc/corr_level_lookup.cu, the window kernel of
csrc/corr_window.cuh; their headers say how it works and what bounds it.
It computes what ops/corr.py::lookup_corr_plain computes: the same function
as ops/corr_cuda.py's 4-level radius-4 kernel (#1), which full RAFT and GMA
keep at their default corr_radius 4 and corr_levels 4. This one takes every
other (radius, levels): RAFT-small (radius 3) always, and full RAFT and GMA
at any other corr_radius or corr_levels, in inference and (with the
backward kernel's build for the same pair) in training.

Builds: one library per (radius, levels), compiled at first use and cached
in the build directory (`library`). The default build (no defines) serves
radius 3 or 4 over 4 levels (RADII, LEVELS); every other pair gets its own
build with -DCORR_RADIUS and -DCORR_LEVELS (`defines`), at 8 queries per
block, or fewer where a block's staged patches would outgrow the 227 KB of
shared memory a Hopper block may take (`block_queries`; a pair that does
not fit at one query per block raises ValueError by name).

`lookup_corr_level` checks its operands and calls the torch op
`accflow::corr_level_lookup` (`corr_level_lookup_op`): the plain lookup on
the CPU, the kernel on CUDA (or it raises), and a fake implementation for
torch.export; a CUDA graph captures it as one dispatched op. `out_dtype`
(float32, the TPU kernel's, or bfloat16) is the output's type: bfloat16 is
the float32 blend rounded once to nearest even, bit for bit the float32
output cast. `launches` counts kernel launches and nothing else (not a CUDA
graph's replays); `build_launches` counts them per (radius, levels).
Its backward is the backward kernel's op
`accflow::corr_level_lookup_backward` (ops/corr_backward_cuda.py). Built at
first use (ops/cuda_lib.py), never on import; `build` and `launch` also
take a variant built with other -D defines ("-DCORR_LEVELS=1":
chip_smoke.py's one-level probe; "-DCORR_QT=n": its tile sweep over the
queries per block).
"""

from __future__ import annotations

import ctypes

import torch

from accflow_tpu_torch.ops import corr_backward_cuda, cuda_lib
from accflow_tpu_torch.ops.corr import lookup_corr_plain

SOURCE = cuda_lib.CSRC / "corr_level_lookup.cu"
RADII = (3, 4)  # the default build's radii
LEVELS = 4  # the default build's level count
MAX_LEVELS = 16  # one thread per (query, level) of a block (corr_window.cuh)
BLOCK_QUERIES = (8, 4, 2, 1)  # queries per block, the first whose patches fit
SMEM_LIMIT = 227 * 1024  # shared memory one block may take on Hopper (bytes)

launches = 0
build_launches: dict = {}  # (radius, levels) -> launches
_libs: dict = {}  # (radius, levels) -> the loaded library


def build(*defines: str) -> tuple[str, str]:
    """Compile the kernel (with extra `defines`, e.g. "-DCORR_LEVELS=1")
    unless this source and these flags were built before. Returns (library
    path, compiler output; empty when cached)."""
    return cuda_lib.build(SOURCE, *defines)


def block_smem(radius: int, levels: int, qt: int) -> int:
    """Bytes of shared memory of one block of `qt` queries with float32
    levels and output (the largest types): corr_window.cuh's Smem."""
    p, taps = 2 * radius + 2, (2 * radius + 1) ** 2
    ve = 4  # float32 values per 16-byte chunk
    roww = (2 * ve + p - 2) // ve * ve
    tile = 4 * qt * levels * p * roww
    out = (4 * qt * levels * taps + 15) // 16 * 16
    return tile + out + 4 * qt * levels * 4 + 4 * qt * levels * 3


def block_queries(radius: int, levels: int) -> int:
    """Queries per block of the build for (radius, levels): the first of
    BLOCK_QUERIES whose block fits SMEM_LIMIT. ValueError where one query's
    patches do not fit."""
    for qt in BLOCK_QUERIES:
        if block_smem(radius, levels, qt) <= SMEM_LIMIT:
            return qt
    raise ValueError(
        f"kernel #2 (corr_level_lookup) at radius {radius} over {levels} levels: one query's "
        f"staged patches take {block_smem(radius, levels, 1)} B of shared memory, beyond the "
        f"{SMEM_LIMIT} B a block may take on Hopper")


def defines(radius: int, levels: int) -> tuple:
    """The -D flags of the build that serves (radius, levels): none for the
    default build (radius in RADII, LEVELS levels), else -DCORR_RADIUS and
    -DCORR_LEVELS, and -DCORR_QT where fewer than 8 queries a block fit."""
    if radius in RADII and levels == LEVELS:
        return ()
    qt = block_queries(radius, levels)
    flags = (f"-DCORR_RADIUS={radius}", f"-DCORR_LEVELS={levels}")
    return flags if qt == BLOCK_QUERIES[0] else (*flags, f"-DCORR_QT={qt}")


def library(radius: int, levels: int) -> ctypes.CDLL:
    """The loaded library for (radius, levels), built at its first use."""
    key = (radius, levels)
    if key not in _libs:
        _libs[key] = load(build(*defines(radius, levels))[0])
    return _libs[key]


def load(path: str) -> ctypes.CDLL:
    """The built library at `path`, with the C function's signature."""
    lib = ctypes.CDLL(path)
    lib.corr_level_lookup.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.corr_level_lookup.restype = ctypes.c_int
    for query in ("corr_level_lookup_levels", "corr_level_lookup_radius"):
        getattr(lib, query).argtypes = []
        getattr(lib, query).restype = ctypes.c_int
    return lib


def _check(levels, coords: torch.Tensor, radius: int, out_dtype: torch.dtype) -> None:
    if out_dtype not in cuda_lib.DTYPE_CODE:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if radius < 0:
        raise ValueError(f"the radius must be >= 0, got {radius}")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"the per-level lookup takes 1 to {MAX_LEVELS} levels, got {len(levels)}")
    cuda_lib.check_lookup_operands(levels, coords)


def lookup_corr_level(levels, coords: torch.Tensor, radius: int,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """levels: list of L (Q, hl, wl) float32 or bfloat16 maps (1 <= L <=
    MAX_LEVELS); coords (Q, 2) float32 in level-0 pixels -> (Q, L*(2r+1)^2)
    in `out_dtype` (float32 or bfloat16), in the reference channel layout
    (see ops/corr.py). CPU tensors take the plain lookup; CUDA tensors the
    kernel, built for (radius, L) (`library`): the default build for radius
    3 or 4 over 4 levels, a build of its own for every other pair. A
    build or launch failure raises."""
    _check(levels, coords, radius, out_dtype)
    if coords.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no lookup for device {coords.device}")
    return corr_level_lookup_op(list(levels), coords, radius, out_dtype)


@torch.library.custom_op(
    "accflow::corr_level_lookup", mutates_args=(), device_types="cpu",
    schema="(Tensor[] levels, Tensor coords, int radius, ScalarType out_dtype) -> Tensor")
def corr_level_lookup_op(levels, coords, radius, out_dtype):
    """The op behind lookup_corr_level, on operands that passed its checks.
    CPU: the plain lookup."""
    return lookup_corr_plain(levels, coords, radius, out_dtype)


@corr_level_lookup_op.register_kernel("cuda")
def _(levels, coords, radius, out_dtype):
    return launch(library(radius, len(levels)), levels, coords, radius, out_dtype)


@corr_level_lookup_op.register_fake
def _(levels, coords, radius, out_dtype):
    return coords.new_empty((coords.shape[0], len(levels) * (2 * radius + 1) ** 2),
                            dtype=out_dtype)


corr_backward_cuda.register_autograd(corr_level_lookup_op,
                                     corr_backward_cuda.corr_level_lookup_backward_op,
                                     "accflow::corr_level_lookup")


def launch(lib: ctypes.CDLL, levels, coords: torch.Tensor, radius: int,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Run the kernel of `lib` (from `load`) on CUDA tensors that passed
    `lookup_corr_level`'s checks (for as many levels and the radius `lib`
    was built for); raises if the level count or radius differs or the
    launch fails."""
    global launches
    n = len(levels)
    if lib.corr_level_lookup_levels() != n:
        raise ValueError(f"the library is built for {lib.corr_level_lookup_levels()} "
                         f"levels, got {n}")
    built = lib.corr_level_lookup_radius()
    if radius not in ((built,) if built else RADII):
        raise ValueError(f"the library is built for radius {built or RADII}, got {radius}")
    q = coords.shape[0]
    out = torch.empty((q, n * (2 * radius + 1) ** 2), dtype=out_dtype, device=coords.device)
    if q == 0:
        return out
    ptrs = (ctypes.c_void_p * n)(*[lvl.data_ptr() for lvl in levels])
    hw = (ctypes.c_int * (2 * n))(*[d for lvl in levels for d in lvl.shape[1:]])
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.corr_level_lookup(cuda_lib.DTYPE_CODE[levels[0].dtype],
                                   cuda_lib.DTYPE_CODE[out_dtype], radius, coords.data_ptr(),
                                   ptrs, hw, q, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"corr_level_lookup kernel launch failed: cudaError {rc}")
    launches += 1
    build_launches[radius, n] = build_launches.get((radius, n), 0) + 1
    return out
