"""The per-query y tent contraction of the split lookup as a hand-written
CUDA kernel for Hopper: tmp[q, b, x] = sum_y wy[q, b, y] * corr3[q, y, x],
b over the window's 2r+1 taps.

Replaces accflow_tpu/ops/corr_pallas.py::y_contract_bd, the TPU kernel that
the `experimental:fused_bd[2]` lookups run on pyramid levels 0 (and 1),
and `experimental:fused_mix:...` on its "bd" levels
(ops/corr.py::_level_window_bd). The kernel is csrc/corr_y_contract.cu; its
header says how it works and what bounds it. `y_contract_plain` is its plain
twin: the CPU path and the kernel's oracle.

`y_contract` checks its operands and calls the torch op
`accflow::y_contract` (`y_contract_op`): the plain twin on the CPU, the
kernel on CUDA (or it raises), and a fake implementation for torch.export;
a CUDA graph captures it as one dispatched op. `out_dtype` (float32, the
TPU kernel's, or bfloat16) is the output's type: bfloat16 is the float32
sums rounded once to nearest even, bit for bit the float32 output cast.
`launches` counts kernel launches and nothing else (not a CUDA graph's
replays); `build_launches` counts them per build's taps. Built at first
use (ops/cuda_lib.py), never on import: the taps per axis (NUM = 2r+1) are
compiled in, 9 (radius 4) in the default build and any other in a build of
its own with -DCORR_NUM (`library`), since JAX's fused_bd computes at any
corr_radius.
"""

from __future__ import annotations

import ctypes

import torch

from accflow_tpu_torch.ops import cuda_lib

SOURCE = cuda_lib.CSRC / "corr_y_contract.cu"
NUM = 9  # window taps per axis of the default build (radius 4)
PATHS = ("narrow", "mma")  # the kernel's paths by corr_y_contract_path's code

launches = 0
build_launches: dict = {}  # taps per axis -> launches
_libs: dict = {}  # taps per axis -> the loaded library


def build(*defines: str) -> tuple[str, str]:
    """Compile the kernel (with extra `defines`, e.g. "-DCORR_NUM=7") unless
    this source and these flags were built before. Returns (library path,
    compiler output; empty when cached)."""
    return cuda_lib.build(SOURCE, *defines)


def defines(num: int) -> tuple:
    """The -D flags of the build for `num` taps per axis: none for NUM."""
    return () if num == NUM else (f"-DCORR_NUM={num}",)


def library(num: int) -> ctypes.CDLL:
    """The loaded library for `num` taps per axis, built at its first use."""
    if num not in _libs:
        _libs[num] = load(build(*defines(num))[0])
    return _libs[num]


def load(path: str) -> ctypes.CDLL:
    """The built library at `path`, with the C function's signature."""
    lib = ctypes.CDLL(path)
    lib.corr_y_contract.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.corr_y_contract.restype = ctypes.c_int
    lib.corr_y_contract_path.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.corr_y_contract_path.restype = ctypes.c_int
    lib.corr_y_contract_num.argtypes = []
    lib.corr_y_contract_num.restype = ctypes.c_int
    return lib


def y_contract_plain(corr3: torch.Tensor, wy: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """corr3 (Q, hl, wl), wy (Q, n, hl) -> (Q, n, wl) in `out_dtype`: the
    products and sums in float32 (exact products of bfloat16 inputs), then
    one cast."""
    return torch.einsum("qby,qyx->qbx", wy.float(), corr3.float()).to(out_dtype)


def _check(corr3: torch.Tensor, wy: torch.Tensor, out_dtype: torch.dtype) -> None:
    if out_dtype not in cuda_lib.DTYPE_CODE:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if corr3.dim() != 3:
        raise ValueError(f"corr3 must be (Q, hl, wl), got {tuple(corr3.shape)}")
    q, hl, _ = corr3.shape
    if wy.dim() != 3 or wy.shape[0] != q or wy.shape[2] != hl or wy.shape[1] < 1:
        raise ValueError(f"wy must be (Q, 2r+1, hl) = ({q}, 2r+1, {hl}), got {tuple(wy.shape)}")
    if wy.dtype != corr3.dtype or corr3.dtype not in cuda_lib.DTYPE_CODE:
        raise ValueError(f"corr3 and wy must both be float32 or both bfloat16, "
                         f"got {corr3.dtype} and {wy.dtype}")
    if wy.device != corr3.device:
        raise ValueError(f"wy is on {wy.device}, corr3 on {corr3.device}")


def y_contract(corr3: torch.Tensor, wy: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """corr3 (Q, hl, wl), wy (Q, n, hl) (n = 2r+1 taps), both float32 or
    both bfloat16 -> (Q, n, wl) in `out_dtype` (float32 or bfloat16). CPU
    tensors take the plain twin; CUDA tensors the kernel built for n taps
    (the default build for 9, radius 4; a build of its own for every other
    n). A build or launch failure raises."""
    _check(corr3, wy, out_dtype)
    if corr3.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no y contraction for device {corr3.device}")
    return y_contract_op(corr3, wy, out_dtype)


@torch.library.custom_op("accflow::y_contract", mutates_args=(), device_types="cpu",
                         schema="(Tensor corr3, Tensor wy, ScalarType out_dtype) -> Tensor")
def y_contract_op(corr3, wy, out_dtype):
    """The op behind y_contract, on operands that passed its checks. CPU:
    the plain twin."""
    return y_contract_plain(corr3, wy, out_dtype)


@y_contract_op.register_kernel("cuda")
def _(corr3, wy, out_dtype):
    return launch(library(wy.shape[1]), corr3, wy, out_dtype)


@y_contract_op.register_fake
def _(corr3, wy, out_dtype):
    return corr3.new_empty((corr3.shape[0], wy.shape[1], corr3.shape[2]), dtype=out_dtype)


cuda_lib.refuse_autograd(y_contract_op, "accflow::y_contract")


def path(lib: ctypes.CDLL, corr3: torch.Tensor) -> str:
    """The kernel's path for `corr3` (a CUDA tensor): "mma" (tensor cores,
    bfloat16 maps 8, 16, 32 or 64 wide at a 16-byte aligned address, in a
    build of at most 16 taps) or "narrow" (element loads; every other shape,
    float32 maps among them)."""
    return PATHS[lib.corr_y_contract_path(cuda_lib.DTYPE_CODE[corr3.dtype],
                                          corr3.data_ptr(), corr3.shape[2])]


def launch(lib: ctypes.CDLL, corr3: torch.Tensor, wy: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Run the kernel of `lib` (from `load`) on CUDA tensors that passed
    `y_contract`'s checks; raises if they are not contiguous or the launch
    fails, or if `lib` is built for another number of taps than wy's. An
    empty output launches nothing."""
    global launches
    q, hl, wl = corr3.shape
    num = wy.shape[1]
    if lib.corr_y_contract_num() != num:
        raise ValueError(f"the library is built for {lib.corr_y_contract_num()} taps, got {num}")
    out = torch.empty((q, num, wl), dtype=out_dtype, device=corr3.device)
    if out.numel() == 0:
        return out
    if not (corr3.is_contiguous() and wy.is_contiguous()):
        raise ValueError("corr3 and wy must be contiguous")
    with torch.cuda.device(corr3.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.corr_y_contract(cuda_lib.DTYPE_CODE[corr3.dtype], cuda_lib.DTYPE_CODE[out_dtype],
                                 corr3.data_ptr(), wy.data_ptr(), q, hl, wl, out.data_ptr(),
                                 stream)
    if rc != 0:
        raise RuntimeError(f"corr_y_contract kernel launch failed: cudaError {rc}")
    launches += 1
    build_launches[num] = build_launches.get(num, 0) + 1
    return out
