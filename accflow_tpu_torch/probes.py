"""On-card timing probes, counterparts of the JAX package's Pallas probes
(standalone TPU scripts), and the bounds `chip_smoke.py` reports beside each
kernel's time. Each probe is a kernel of this package run on its own at a
fixed shape, held against its plain version:

- #4 one level's complete window lookup (scripts/probe_pallas_fused.py,
  probe_pf_bisect.py, probe_pf_compact.py): kernel #2 (csrc/
  corr_level_lookup.cu) built for one level ("-DCORR_LEVELS=1") at level 0
  of the clip shape, radius 4, bfloat16;
- #5 the y contraction at scripts/probe_pallas_bd.py's shape (q = 1024,
  64^2, bfloat16 in, float32 out) through kernel #3 (csrc/
  corr_y_contract.cu), under that probe's own bar (max abs 1e-2);
- #6 the memory floor of kernel #1's operands (scripts/
  probe_pallas_floor.py): the passthrough kernel csrc/corr_floor.cu, which
  reads every level once and writes (Q, 324) from a per-query sum.

Nothing here runs on import, and nothing here is on a model's path: the
floor kernel's wrapper is the only kernel wrapper of this module.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from accflow_tpu_torch.ops import corr_bd_cuda, corr_level_cuda, cuda_lib
from accflow_tpu_torch.ops.corr import lookup_corr_plain

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12     # bfloat16 tensor cores, dense
FLOOR_SOURCE = cuda_lib.CSRC / "corr_floor.cu"
FLOOR_COLS = 324

floor_launches = 0
_floor_lib = None


def bound(nbytes: float, flops: float, flops_per_s: float):
    """Least time on an H100 for `nbytes` moved and `flops` done at
    `flops_per_s`: (ms, "bytes" | "operations")."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lookup_bound(levels, coords, radius: int = 4):
    """Least time for the window lookup on an H100: bytes it must move
    (coords read, output written, and the patch cells inside each map that
    these coords touch, read once) over 3.35 TB/s, against ~11 float32
    operations per output over 67 TFLOP/s. Returns (ms, "bytes" |
    "operations", bytes)."""
    q, side = coords.shape[0], 2 * radius + 2
    elem = levels[0].element_size()
    cells = 0
    for l, lvl in enumerate(levels):
        hl, wl = lvl.shape[1:]
        o = torch.floor(coords / 2.0 ** l) - radius
        cols = (torch.minimum(o[:, 0] + side, torch.tensor(float(wl), device=o.device))
                - o[:, 0].clamp(min=0)).clamp(0, side)
        rows = (torch.minimum(o[:, 1] + side, torch.tensor(float(hl), device=o.device))
                - o[:, 1].clamp(min=0)).clamp(0, side)
        cells += int((cols * rows).sum().item())
    n_out = q * len(levels) * (2 * radius + 1) ** 2
    nbytes = q * 2 * 4 + n_out * 4 + cells * elem
    ms, by = bound(nbytes, n_out * 11, H100_F32_FLOPS)
    return ms, by, nbytes


def grid_sample_lookup(levels, coords, radius: int = 4):
    """The same windows through F.grid_sample, one call per level (the
    library yardstick of the lookups; the port never calls it): grid
    (Q, 9, 9, 2) with [q, a, b] at (x/2^l + a - r, y/2^l + b - r), so the
    flattened (9, 9) output is the a*9 + b channel order. Returns (run,
    result): run() launches the calls, result() gives (Q, L*81) float32."""
    num = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, device=coords.device, dtype=torch.float32)
    grids = []
    for l, lvl in enumerate(levels):
        hl, wl = lvl.shape[1:]
        c = coords / 2.0 ** l
        gx = (c[:, 0, None, None] + d[None, :, None]).expand(-1, num, num)
        gy = (c[:, 1, None, None] + d[None, None, :]).expand(-1, num, num)
        g = torch.stack([2 * gx / (wl - 1) - 1, 2 * gy / (hl - 1) - 1], dim=-1)
        grids.append(g.to(lvl.dtype).contiguous())
    inputs = [lvl.unsqueeze(1) for lvl in levels]

    def run():
        return [F.grid_sample(x, g, mode="bilinear", padding_mode="zeros",
                              align_corners=True) for x, g in zip(inputs, grids)]

    def result():
        return torch.cat([o.reshape(o.shape[0], -1).float() for o in run()], dim=1)

    return run, result


def y_contract_bound(corr3: torch.Tensor):
    """Least time of the y contraction of (Q, hl, wl) maps on an H100: corr3
    and wy (Q, 9, hl) read, (Q, 9, wl) float32 written; 2*9*hl*wl operations
    per query at the inputs' rate (bfloat16 tensor cores, or float32).
    Returns (ms, "bytes" | "operations", bytes)."""
    q, hl, wl = corr3.shape
    elem = corr3.element_size()
    nbytes = q * hl * wl * elem + q * 9 * hl * elem + q * 9 * wl * 4
    rate = H100_BF16_FLOPS if corr3.dtype == torch.bfloat16 else H100_F32_FLOPS
    ms, by = bound(nbytes, 2.0 * q * 9 * hl * wl, rate)
    return ms, by, nbytes


# ---------------------------------------------------------------------------
# The floor kernel (#6)
# ---------------------------------------------------------------------------

def build_floor() -> tuple[str, str]:
    """Compile csrc/corr_floor.cu unless built before: (path, compiler output)."""
    return cuda_lib.build(FLOOR_SOURCE)


def load_floor(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.corr_floor.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.corr_floor.restype = ctypes.c_int
    return lib


def floor_plain(levels, coords: torch.Tensor) -> torch.Tensor:
    """Per-query sum of the 4 levels' values (+ 0 * coords[:, 0]) in every
    one of the 324 columns, float32."""
    s = coords[:, 0] * 0.0
    for lvl in levels:
        s = s + lvl.float().reshape(lvl.shape[0], -1).sum(dim=1)
    return s[:, None].expand(-1, FLOOR_COLS).contiguous()


def floor(levels, coords: torch.Tensor) -> torch.Tensor:
    """The floor kernel on 4 CUDA (Q, hl, wl) levels and (Q, 2) coords ->
    (Q, 324) float32 (CPU tensors take floor_plain)."""
    global _floor_lib, floor_launches
    if len(levels) != 4:
        raise ValueError(f"the floor kernel reads 4 levels, got {len(levels)}")
    cuda_lib.check_lookup_operands(levels, coords)
    if coords.device.type == "cpu":
        return floor_plain(levels, coords)
    if coords.device.type != "cuda":
        raise ValueError(f"no floor kernel for device {coords.device}")
    if _floor_lib is None:
        _floor_lib = load_floor(build_floor()[0])
    q = coords.shape[0]
    out = torch.empty((q, FLOOR_COLS), dtype=torch.float32, device=coords.device)
    if q == 0:
        return out
    ptrs = (ctypes.c_void_p * 4)(*[lvl.data_ptr() for lvl in levels])
    hw = (ctypes.c_int * 8)(*[d for lvl in levels for d in lvl.shape[1:]])
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _floor_lib.corr_floor(cuda_lib.DTYPE_CODE[levels[0].dtype], coords.data_ptr(),
                                   ptrs, hw, q, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"corr_floor kernel launch failed: cudaError {rc}")
    floor_launches += 1
    return out


# ---------------------------------------------------------------------------
# The probes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Probe:
    """One probe at its fixed inputs: `kernel()` launches this package's
    kernel, `plain()` its plain version, `library()` one PyTorch call of the
    same function where there is one. `tol` bounds max |kernel - plain|,
    for the reason in `why`."""

    name: str
    replaces: str
    source: str
    kernel: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    library: Optional[Callable[[], object]]
    tol: float
    why: str
    bound_ms: float
    bound_by: str
    nbytes: int


def bd_probe(device) -> Probe:
    """#5: the y contraction at probe_pallas_bd.py's shape and inputs
    (standard normal wy and corr from numpy seed 0, cast to bfloat16)."""
    q, hl, wl = 1024, 64, 64
    rng = np.random.default_rng(0)
    wy = torch.from_numpy(rng.standard_normal((q, 9, hl)).astype(np.float32))
    corr = torch.from_numpy(rng.standard_normal((q, hl, wl)).astype(np.float32))
    wy, corr = (t.to(device=device, dtype=torch.bfloat16) for t in (wy, corr))
    ms, by, nbytes = y_contract_bound(corr)
    return Probe(
        "probe_y_contract", "scripts/probe_pallas_bd.py:51",
        "accflow_tpu_torch/csrc/corr_y_contract.cu",
        kernel=lambda: corr_bd_cuda.y_contract(corr, wy),
        plain=lambda: corr_bd_cuda.y_contract_plain(corr, wy),
        library=lambda: torch.bmm(wy, corr),
        tol=1e-2, why="the TPU probe's own bar against a float32 einsum "
        "(probe_pallas_bd.py:64-68); exact bf16 products, f32 sums in another order",
        bound_ms=ms, bound_by=by, nbytes=nbytes)


def level_probe(level0: torch.Tensor, coords: torch.Tensor) -> Probe:
    """#4: one level's radius-4 window lookup through kernel #2 built for
    one level, on level 0 of the clip shape (Q, 64, 64) and (Q, 2) coords."""
    lib = corr_level_cuda.load(corr_level_cuda.build("-DCORR_LEVELS=1")[0])
    cuda_lib.check_lookup_operands([level0], coords)
    ms, by, nbytes = lookup_bound([level0], coords, 4)
    lib_run, _ = grid_sample_lookup([level0], coords, 4)
    return Probe(
        "probe_level_lookup", "scripts/probe_pallas_fused.py:165",
        "accflow_tpu_torch/csrc/corr_level_lookup.cu",
        kernel=lambda: corr_level_cuda.launch(lib, [level0], coords, 4),
        plain=lambda: lookup_corr_plain([level0], coords, 4),
        library=lib_run,
        tol=1e-4, why="one fractional offset per window against the plain lookup's "
        "per-tap one: <= half an ulp of |x| times the maps' slope (as kernels #1, #2)",
        bound_ms=ms, bound_by=by, nbytes=nbytes)


def floor_probe(levels, coords: torch.Tensor) -> Probe:
    """#6: the floor kernel on the clip shape's 4 levels and coords. Its bar
    is the worst-case difference of two summation orders of n terms in
    float32, 2 n 2^-24 max_q sum|x| (each order's error is at most
    (n-1) 2^-24 sum|x|)."""
    n = sum(lvl[0].numel() for lvl in levels)
    abs_sum = sum(lvl.float().abs().reshape(lvl.shape[0], -1).sum(dim=1) for lvl in levels)
    tol = 2.0 * n * 2.0 ** -24 * float(abs_sum.max())
    q = coords.shape[0]
    nbytes = (sum(lvl.numel() * lvl.element_size() for lvl in levels)
              + coords.numel() * 4 + q * FLOOR_COLS * 4)
    ms, by = bound(nbytes, float(sum(lvl.numel() for lvl in levels)), H100_F32_FLOPS)
    return Probe(
        "corr_floor", "scripts/probe_pallas_floor.py:64",
        "accflow_tpu_torch/csrc/corr_floor.cu",
        kernel=lambda: floor(levels, coords),
        plain=lambda: floor_plain(levels, coords),
        library=None, tol=tol,
        why=f"two float32 summation orders of {n} terms: 2 n 2^-24 max sum|x|",
        bound_ms=ms, bound_by=by, nbytes=nbytes)
