"""The per-query y tent contraction of the split lookup as a hand-written
CUDA kernel for Hopper: tmp[q, b, x] = sum_y wy[q, b, y] * corr3[q, y, x].

Replaces accflow_tpu/ops/corr_pallas.py::y_contract_bd, the TPU kernel that
the `experimental:fused_bd[2]` lookups run on pyramid levels 0 (and 1)
(ops/corr.py::_level_window_bd). The kernel is csrc/corr_y_contract.cu; its
header says how it works and what bounds it. `y_contract_plain` is its plain
twin: the CPU path and the kernel's oracle.

`y_contract` takes CPU tensors to the plain twin and CUDA tensors to the
kernel, or raises. `launches` counts kernel launches and nothing else.
Built at first use (ops/cuda_lib.py), never on import.
"""

from __future__ import annotations

import ctypes

import torch

from accflow_tpu_torch.ops import cuda_lib

SOURCE = cuda_lib.CSRC / "corr_y_contract.cu"
NUM = 9  # window taps per axis (radius 4), compiled into the kernel

launches = 0
_lib = None


def build() -> tuple[str, str]:
    """Compile the kernel unless this source was built before. Returns
    (library path, compiler output; empty when cached)."""
    return cuda_lib.build(SOURCE)


def load(path: str) -> ctypes.CDLL:
    """The built library at `path`, with the C function's signature."""
    lib = ctypes.CDLL(path)
    lib.corr_y_contract.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.corr_y_contract.restype = ctypes.c_int
    return lib


def y_contract_plain(corr3: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """corr3 (Q, hl, wl), wy (Q, 9, hl) -> (Q, 9, wl) float32: the products
    and sums in float32 (exact products of bfloat16 inputs)."""
    return torch.einsum("qby,qyx->qbx", wy.float(), corr3.float())


def _check(corr3: torch.Tensor, wy: torch.Tensor) -> None:
    if corr3.dim() != 3:
        raise ValueError(f"corr3 must be (Q, hl, wl), got {tuple(corr3.shape)}")
    q, hl, _ = corr3.shape
    if tuple(wy.shape) != (q, NUM, hl):
        raise ValueError(f"wy must be (Q, {NUM}, hl) = {(q, NUM, hl)}, got {tuple(wy.shape)}")
    if wy.dtype != corr3.dtype or corr3.dtype not in cuda_lib.DTYPE_CODE:
        raise ValueError(f"corr3 and wy must both be float32 or both bfloat16, "
                         f"got {corr3.dtype} and {wy.dtype}")
    if wy.device != corr3.device:
        raise ValueError(f"wy is on {wy.device}, corr3 on {corr3.device}")


def y_contract(corr3: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """corr3 (Q, hl, wl), wy (Q, 9, hl), both float32 or both bfloat16 ->
    (Q, 9, wl) float32. CPU tensors take the plain twin; CUDA tensors the
    kernel."""
    global _lib
    _check(corr3, wy)
    if corr3.device.type == "cpu":
        return y_contract_plain(corr3, wy)
    if corr3.device.type != "cuda":
        raise ValueError(f"no y contraction for device {corr3.device}")
    if _lib is None:
        _lib = load(build()[0])
    return launch(_lib, corr3, wy)


def launch(lib: ctypes.CDLL, corr3: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """Run the kernel of `lib` (from `load`) on CUDA tensors that passed
    `y_contract`'s checks; raises if they are not contiguous or the launch
    fails. An empty output launches nothing."""
    global launches
    q, hl, wl = corr3.shape
    out = torch.empty((q, NUM, wl), dtype=torch.float32, device=corr3.device)
    if out.numel() == 0:
        return out
    if not (corr3.is_contiguous() and wy.is_contiguous()):
        raise ValueError("corr3 and wy must be contiguous")
    with torch.cuda.device(corr3.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.corr_y_contract(cuda_lib.DTYPE_CODE[corr3.dtype], corr3.data_ptr(),
                                 wy.data_ptr(), q, hl, wl, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"corr_y_contract kernel launch failed: cudaError {rc}")
    launches += 1
    return out
