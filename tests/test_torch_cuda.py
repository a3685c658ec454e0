"""The port's CUDA kernels against their plain versions, on the GPU: the
4-level radius-4 lookup (ops/corr_cuda.py), the per-level lookup
(ops/corr_level_cuda.py, also built for one level and with 4 and 16
queries per block), both with float32 and bfloat16 output, the y
contraction of the split lookup (ops/corr_bd_cuda.py) and the floor kernel of the probes
(probes.py); the CUDA graphs of the stream step (StreamAccumulator) and of a
loaded artifact (serving.py, streaming.py), and the splat's determinism;
GMA's small clip on the GPU against the CPU with kernels #1 and #3, RAFT's
small clip with each experimental corr_lookup spelling on the GPU against
the CPU, with its lookup kernel's launches,
FlowPipeline on the GPU, and one accumulator train step on the GPU against
the CPU and its kernel-#1 launches; the lookups' backward kernel
(ops/corr_backward_cuda.py) against the plain backward, and one fine-tune
step on the GPU against the CPU with its launches; the graphed train,
validation and eval steps (graphs.CudaGraphedStep, graphs.CudaGraphed)
against the eager ones, sync-free, once captured per signature, and
captured again after a resume; High-Speed Sintel's evaluation on the GPU
against the CPU, a graphed train step in a world of one over NCCL against
the step without a process group, the graphed train and fine-tune steps,
clip and pushes with a one-rank spatial handle over NCCL against eager
(and their counted collectives), graphs refusing gloo on the card, a
profiler trace on the card, and full
RAFT height-sharded over two gloo ranks on the card (this file run as a
script, `_spatial_child`) against one process, with kernel #1's launches
on each rank; and the estimator options: kernel #2, its backward and
kernel #3 built for other (radius, levels) and tap counts against their
plain versions, the model options GPU against CPU through their builds,
a fine-tune step at corr_levels 3, corr_radius 3, the group-norm
encoders.
Marked `cuda`; each test skips where there is no GPU (no
kernel can run there). This file imports neither JAX nor the JAX package,
so it runs on a machine with only torch:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

The lookup kernels share one fractional offset over each window's taps
where the plain version recomputes it per tap; at these coordinates
(|x| < 64) and unit-normal maps the difference stays below 1e-4. The y
contraction sums the same float32 products as its twin in another order
(bfloat16 products are exact in float32): below 1e-4 for sums of up to 70
unit-normal products."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from accflow_tpu_torch import graphs, probes, serving
from accflow_tpu_torch.models import (
    AccFlowConfig,
    accflow_forward,
    build_flow_estimator,
    init_accflow,
)
from accflow_tpu_torch.nn.layers import BatchNorm2d, Conv2d, InstanceNorm2d
from accflow_tpu_torch.ops import (
    corr_backward_cuda,
    corr_bd_cuda,
    corr_cuda,
    corr_level_cuda,
    softsplat,
)
from accflow_tpu_torch.ops.corr import (
    lookup_corr_plain,
    lookup_corr_plain_backward,
    lookup_corr_split_v2,
)
from accflow_tpu_torch.streaming import (
    StreamAccumulator,
    export_streaming,
    load_streaming_artifact,
    make_streaming_fns,
    save_streaming_artifact,
)

pytestmark = pytest.mark.cuda
TOL = dict(rtol=0, atol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the lookup kernel has no CPU mode")
    return torch.device("cuda")


def _case(dev, b, h, w, spread, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = b * h * w
    levels, hl, wl = [], h, w
    for _ in range(corr_cuda.LEVELS):
        levels.append(torch.randn((q, hl, wl), generator=gen).to(dtype))
        hl, wl = hl // 2, wl // 2
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    grid = torch.stack([xs, ys], -1).float().expand(b, h, w, 2).reshape(q, 2)
    coords = grid + (torch.rand((q, 2), generator=gen) * 2 - 1) * spread
    return [l.to(dev) for l in levels], coords.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 13, 7), (3, 5, 9)])
def test_kernel_matches_plain(dev, dtype, shape):
    levels, coords = _case(dev, *shape, spread=20, dtype=dtype)
    before = corr_cuda.launches
    got = corr_cuda.lookup_corr_fused(levels, coords)
    torch.cuda.synchronize()
    assert corr_cuda.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               lookup_corr_plain(levels, coords).cpu().numpy(), **TOL)


def test_zero_sized_levels_give_zero_rows(dev):
    """4x4 maps pool to 2x2, 1x1 and 0x0 (and a 1-wide map to 0 wide)."""
    levels, coords = _case(dev, 2, 4, 4, spread=3)
    got = corr_cuda.lookup_corr_fused(levels, coords)
    np.testing.assert_allclose(got.cpu().numpy(),
                               lookup_corr_plain(levels, coords).cpu().numpy(), **TOL)
    assert not got[:, 243:].any()


def test_far_coords_give_zeros(dev):
    levels, coords = _case(dev, 1, 8, 8, spread=1)
    coords[0] = torch.tensor([1e9, -1e9])
    coords[1] = torch.tensor([-3e38, 5.0])
    coords[2] = torch.tensor([40.0, 40.0])
    got = corr_cuda.lookup_corr_fused(levels, coords)
    assert not got[:3].any()
    np.testing.assert_allclose(got.cpu().numpy(),
                               lookup_corr_plain(levels, coords).cpu().numpy(), **TOL)


def test_empty_query_set_launches_nothing(dev):
    levels, coords = _case(dev, 1, 4, 4, spread=1)
    before = corr_cuda.launches
    got = corr_cuda.lookup_corr_fused([l[:0] for l in levels], coords[:0])
    assert got.shape == (0, 324) and corr_cuda.launches == before


@pytest.mark.parametrize("radius", corr_level_cuda.RADII)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 13, 7), (3, 5, 9)])
def test_level_kernel_matches_plain(dev, radius, dtype, shape):
    levels, coords = _case(dev, *shape, spread=20, dtype=dtype)
    before = corr_level_cuda.launches
    got = corr_level_cuda.lookup_corr_level(levels, coords, radius)
    torch.cuda.synchronize()
    assert corr_level_cuda.launches == before + 1  # all levels in one launch
    assert got.shape == (coords.shape[0], 4 * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got.cpu().numpy(),
                               lookup_corr_plain(levels, coords, radius).cpu().numpy(), **TOL)


@pytest.mark.parametrize("radius", corr_level_cuda.RADII)
def test_level_kernel_zero_sized_levels(dev, radius):
    levels, coords = _case(dev, 2, 4, 4, spread=3)
    got = corr_level_cuda.lookup_corr_level(levels, coords, radius)
    np.testing.assert_allclose(got.cpu().numpy(),
                               lookup_corr_plain(levels, coords, radius).cpu().numpy(), **TOL)
    assert not got[:, 3 * (2 * radius + 1) ** 2:].any()


def test_level_kernel_far_coords_give_zeros(dev):
    levels, coords = _case(dev, 1, 8, 8, spread=1)
    coords[0] = torch.tensor([1e9, -1e9])
    coords[1] = torch.tensor([-3e38, 5.0])
    coords[2] = torch.tensor([40.0, 40.0])
    got = corr_level_cuda.lookup_corr_level(levels, coords, 3)
    assert not got[:3].any()
    np.testing.assert_allclose(got.cpu().numpy(),
                               lookup_corr_plain(levels, coords, 3).cpu().numpy(), **TOL)


def test_level_kernel_empty_query_set_launches_nothing(dev):
    levels, coords = _case(dev, 1, 4, 4, spread=1)
    before = corr_level_cuda.launches
    got = corr_level_cuda.lookup_corr_level([l[:0] for l in levels], coords[:0], 3)
    assert got.shape == (0, 196) and corr_level_cuda.launches == before


def test_level_kernel_one_level_build(dev):
    """The probes' build of kernel #2 for one level (-DCORR_LEVELS=1)."""
    lib = corr_level_cuda.load(corr_level_cuda.build("-DCORR_LEVELS=1")[0])
    levels, coords = _case(dev, 2, 16, 16, spread=20, dtype=torch.bfloat16)
    got = corr_level_cuda.launch(lib, levels[:1], coords, 4)
    assert got.shape == (coords.shape[0], 81)
    np.testing.assert_allclose(got.cpu().numpy(),
                               lookup_corr_plain(levels[:1], coords, 4).cpu().numpy(), **TOL)
    with pytest.raises(ValueError, match="built for 1 levels"):
        corr_level_cuda.launch(lib, levels, coords, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(256, 8, 8), (37, 16, 8), (5, 4, 4), (3, 70, 33),
                                   (7, 9, 300), (11, 1, 1), (9, 64, 64)])
def test_y_contract_matches_plain(dev, dtype, shape):
    """Tile remainders of y (70 = 2 x 32 + 6), a row wider than a block
    (300 > 256), 1 x 1 maps and non-square ones."""
    q, hl, wl = shape
    gen = torch.Generator().manual_seed(q + hl + wl)
    corr3 = torch.randn((q, hl, wl), generator=gen).to(dtype).to(dev)
    wy = torch.randn((q, 9, hl), generator=gen).to(dtype).to(dev)
    before = corr_bd_cuda.launches
    got = corr_bd_cuda.y_contract(corr3, wy)
    torch.cuda.synchronize()
    assert corr_bd_cuda.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (q, 9, wl)
    np.testing.assert_allclose(got.cpu().numpy(),
                               corr_bd_cuda.y_contract_plain(corr3, wy).cpu().numpy(), **TOL)


def test_y_contract_empty_launches_nothing(dev):
    before = corr_bd_cuda.launches
    for q, hl, wl in ((0, 8, 8), (4, 8, 0)):
        got = corr_bd_cuda.y_contract(torch.zeros((q, hl, wl), device=dev),
                                      torch.zeros((q, 9, hl), device=dev))
        assert got.shape == (q, 9, wl)
    assert corr_bd_cuda.launches == before
    got = corr_bd_cuda.y_contract(torch.ones((3, 0, 5), device=dev),
                                  torch.ones((3, 9, 0), device=dev))
    assert got.shape == (3, 9, 5) and not got.any()
    with pytest.raises(ValueError, match="contiguous"):
        corr_bd_cuda.y_contract(torch.zeros((3, 5, 4), device=dev).transpose(1, 2),
                                torch.zeros((3, 9, 4), device=dev))


@pytest.mark.parametrize("level_impl", [("bd", "mm", "mm", "mm"), ("bd", "bd", "mm", "mm")])
def test_split_lookup_on_gpu_matches_plain_lookup(dev, level_impl):
    """The split windows through kernel #3, flattened level-major, are the
    plain lookup's rows (float32, TF32 off in the tent contractions)."""
    levels, coords = _case(dev, 2, 16, 16, spread=20)
    before = corr_bd_cuda.launches
    parts = lookup_corr_split_v2(levels, coords.view(2, 16, 16, 2), 4, level_impl)
    assert corr_bd_cuda.launches == before + level_impl.count("bd")
    flat = torch.cat([p.reshape(coords.shape[0], 81) for p in parts], dim=1)
    np.testing.assert_allclose(flat.cpu().numpy(),
                               lookup_corr_plain(levels, coords).cpu().numpy(), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 13, 7)])
def test_floor_kernel_matches_plain(dev, dtype, shape):
    """16x16 maps take the 16-byte vector loads, 13x7 the element loop.
    Tolerance: two float32 summation orders of the query's n values differ
    by at most 2 n 2^-24 sum|x| (the probe's own bar)."""
    levels, coords = _case(dev, *shape, spread=3, dtype=dtype)
    n = sum(lvl[0].numel() for lvl in levels)
    abs_sum = sum(lvl.float().abs().flatten(1).sum(1) for lvl in levels)
    before = probes.floor_launches
    got = probes.floor(levels, coords)
    torch.cuda.synchronize()
    assert probes.floor_launches == before + 1 and got.shape == (coords.shape[0], 324)
    np.testing.assert_allclose(got.cpu().numpy(),
                               probes.floor_plain(levels, coords).cpu().numpy(),
                               rtol=0, atol=2 * n * 2.0 ** -24 * float(abs_sum.max()))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


def _assert_bf16_out(got, got32, ref, tol):
    """A bfloat16 output: the kernel's float32 output cast bit for bit, and
    within tol + 2^-8 |ref| of the plain float32 value (one rounding)."""
    assert got.dtype == torch.bfloat16
    assert torch.equal(_bits(got), _bits(got32.to(torch.bfloat16)))
    assert bool(((got.float() - ref).abs() <= tol + 2.0 ** -8 * ref.abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 13, 7), (3, 5, 9), (1, 64, 64)])
def test_kernel_bf16_out(dev, dtype, shape):
    """16x16 and 64x64 maps take the chunk copies on every level, 13x7 and
    5x9 element staging on their odd-width levels."""
    levels, coords = _case(dev, *shape, spread=20, dtype=dtype)
    got32 = corr_cuda.lookup_corr_fused(levels, coords)
    before = corr_cuda.launches
    got = corr_cuda.lookup_corr_fused(levels, coords, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert corr_cuda.launches == before + 1
    ref = lookup_corr_plain(levels, coords)
    np.testing.assert_allclose(got32.cpu().numpy(), ref.cpu().numpy(), **TOL)
    _assert_bf16_out(got, got32, ref, TOL["atol"])


def test_kernel_bf16_out_edges(dev):
    """Zero-sized levels, far coords, a misaligned level view (element
    staging) and an empty query set, with bfloat16 output."""
    levels, coords = _case(dev, 2, 4, 4, spread=3)
    got = corr_cuda.lookup_corr_fused(levels, coords, out_dtype=torch.bfloat16)
    assert not got[:, 243:].any()
    _assert_bf16_out(got, corr_cuda.lookup_corr_fused(levels, coords),
                     lookup_corr_plain(levels, coords), TOL["atol"])
    levels, coords = _case(dev, 1, 8, 8, spread=1)
    coords[0] = torch.tensor([1e9, -1e9])
    coords[1] = torch.tensor([-3e38, 5.0])
    got = corr_cuda.lookup_corr_fused(levels, coords, out_dtype=torch.bfloat16)
    assert not got[:2].any()
    flat = torch.randn(levels[0].numel() + 1, device=dev)
    shifted = [flat[1:].view(levels[0].shape)] + levels[1:]  # 4 bytes off 16
    np.testing.assert_allclose(corr_cuda.lookup_corr_fused(shifted, coords).cpu().numpy(),
                               lookup_corr_plain(shifted, coords).cpu().numpy(), **TOL)
    before = corr_cuda.launches
    got = corr_cuda.lookup_corr_fused([l[:0] for l in levels], coords[:0],
                                      out_dtype=torch.bfloat16)
    assert got.shape == (0, 324) and got.dtype == torch.bfloat16
    assert corr_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,bf16_path", [
    ((9, 64, 64), "mma"), ((37, 16, 8), "mma"), ((6, 70, 64), "mma"), ((5, 130, 32), "mma"),
    ((3, 21, 16), "mma"), ((4, 8, 128), "narrow"), ((3, 72, 256), "narrow"),
    ((11, 1, 1), "narrow"), ((3, 70, 33), "narrow"), ((7, 9, 300), "narrow"),
    ((5, 3, 5), "narrow"),
])
def test_y_contract_paths_both_out_dtypes(dev, dtype, shape, bf16_path):
    """bfloat16: the MMA path (maps 64, 32, 16, 8 wide; hl = 70, 130 and 21
    not a multiple of the staged 64 rows or of 16, and 21 not of 8) and the
    narrow path (128, 256, 1, 33 and 300 wide; a 3 x 5 map of 30 bytes).
    float32: the narrow path at every shape. Both output types."""
    q, hl, wl = shape
    gen = torch.Generator().manual_seed(q + hl + wl)
    corr3 = torch.randn((q, hl, wl), generator=gen).to(dtype).to(dev)
    wy = torch.randn((q, 9, hl), generator=gen).to(dtype).to(dev)
    lib = corr_bd_cuda.load(corr_bd_cuda.build()[0])
    assert corr_bd_cuda.path(lib, corr3) == (bf16_path if dtype == torch.bfloat16 else "narrow")
    ref = corr_bd_cuda.y_contract_plain(corr3, wy)
    got32 = corr_bd_cuda.y_contract(corr3, wy)
    before = corr_bd_cuda.launches
    got = corr_bd_cuda.y_contract(corr3, wy, torch.bfloat16)
    torch.cuda.synchronize()
    assert corr_bd_cuda.launches == before + 1
    np.testing.assert_allclose(got32.cpu().numpy(), ref.cpu().numpy(), **TOL)
    _assert_bf16_out(got, got32, ref, TOL["atol"])


def test_y_contract_misaligned_view_takes_narrow_path(dev):
    """A (Q, 8, 64) bfloat16 view 2 bytes off a 16-byte boundary: rows are
    whole vectors but the base is not aligned, so the narrow path runs, not
    the MMA one."""
    flat = torch.randn(5 * 8 * 64 + 1, device=dev).to(torch.bfloat16)
    corr3 = flat[1:].view(5, 8, 64)
    wy = torch.randn((5, 9, 8), device=dev).to(torch.bfloat16)
    assert corr_bd_cuda.path(corr_bd_cuda.load(corr_bd_cuda.build()[0]), corr3) == "narrow"
    for out_dtype in (torch.float32, torch.bfloat16):
        got = corr_bd_cuda.y_contract(corr3, wy, out_dtype)
        ref = corr_bd_cuda.y_contract_plain(corr3, wy, out_dtype)
        np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                                   rtol=2.0 ** -8 if out_dtype == torch.bfloat16 else 0,
                                   atol=1e-4)


@pytest.mark.parametrize("radius", corr_level_cuda.RADII)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 13, 7), (3, 5, 9), (1, 64, 64)])
def test_level_kernel_both_out_dtypes(dev, radius, dtype, shape):
    """The per-level kernel with float32 and bfloat16 output: 16x16 and
    64x64 maps take the chunk copies on their wide levels, 13x7 and 5x9
    element staging on their odd-width ones."""
    levels, coords = _case(dev, *shape, spread=20, dtype=dtype)
    ref = lookup_corr_plain(levels, coords, radius)
    got32 = corr_level_cuda.lookup_corr_level(levels, coords, radius)
    before = corr_level_cuda.launches
    got = corr_level_cuda.lookup_corr_level(levels, coords, radius, torch.bfloat16)
    torch.cuda.synchronize()
    assert corr_level_cuda.launches == before + 1
    assert got.shape == got32.shape == (coords.shape[0], 4 * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got32.cpu().numpy(), ref.cpu().numpy(), **TOL)
    _assert_bf16_out(got, got32, ref, TOL["atol"])


@pytest.mark.parametrize("radius", corr_level_cuda.RADII)
def test_level_kernel_bf16_out_edges(dev, radius):
    """Zero-sized levels, far coords, a misaligned level view (element
    staging) and an empty query set, with bfloat16 output."""
    taps = (2 * radius + 1) ** 2
    levels, coords = _case(dev, 2, 4, 4, spread=3)
    got = corr_level_cuda.lookup_corr_level(levels, coords, radius, torch.bfloat16)
    assert not got[:, 3 * taps:].any()
    _assert_bf16_out(got, corr_level_cuda.lookup_corr_level(levels, coords, radius),
                     lookup_corr_plain(levels, coords, radius), TOL["atol"])
    levels, coords = _case(dev, 1, 8, 8, spread=1)
    coords[0] = torch.tensor([1e9, -1e9])
    coords[1] = torch.tensor([-3e38, 5.0])
    got = corr_level_cuda.lookup_corr_level(levels, coords, radius, torch.bfloat16)
    assert not got[:2].any()
    for dtype in (torch.float32, torch.bfloat16):
        flat = torch.randn(levels[0].numel() + 1, device=dev).to(dtype)
        shifted = [flat[1:].view(levels[0].shape)] + [l.to(dtype) for l in levels[1:]]
        ref = lookup_corr_plain(shifted, coords, radius)
        got32 = corr_level_cuda.lookup_corr_level(shifted, coords, radius)
        np.testing.assert_allclose(got32.cpu().numpy(), ref.cpu().numpy(), **TOL)
        _assert_bf16_out(corr_level_cuda.lookup_corr_level(shifted, coords, radius,
                                                           torch.bfloat16),
                         got32, ref, TOL["atol"])
    before = corr_level_cuda.launches
    got = corr_level_cuda.lookup_corr_level([l[:0] for l in levels], coords[:0], radius,
                                            torch.bfloat16)
    assert got.shape == (0, 4 * taps) and got.dtype == torch.bfloat16
    assert corr_level_cuda.launches == before


@pytest.mark.parametrize("defines", [("-DCORR_QT=4",), ("-DCORR_QT=16",),
                                     ("-DCORR_LEVELS=1",), ("-DCORR_LEVELS=1", "-DCORR_QT=4")])
def test_level_kernel_other_builds(dev, defines):
    """The tile sweep's builds (4 and 16 queries per block) and the probes'
    one-level build, both radii and output types; 57 queries leave a partial
    last block. One level at 4 queries per block writes its bfloat16 output
    element by element (4 x 81 or 4 x 49 values are no whole number of
    16-byte vectors)."""
    lib = corr_level_cuda.load(corr_level_cuda.build(*defines)[0])
    nl = lib.corr_level_lookup_levels()
    levels, coords = _case(dev, 1, 8, 8, spread=20, dtype=torch.bfloat16)
    levels, coords = [l[:57] for l in levels[:nl]], coords[:57]
    for radius in corr_level_cuda.RADII:
        ref = lookup_corr_plain(levels, coords, radius)
        got32 = corr_level_cuda.launch(lib, levels, coords, radius)
        got = corr_level_cuda.launch(lib, levels, coords, radius, torch.bfloat16)
        assert got.shape == (57, nl * (2 * radius + 1) ** 2)
        np.testing.assert_allclose(got32.cpu().numpy(), ref.cpu().numpy(), **TOL)
        _assert_bf16_out(got, got32, ref, TOL["atol"])


def _stream_models(device, dtype: str):
    """RAFT-small at 3 iterations under a hidden-32 warm-start accumulator
    whose ZeroConv is drawn from a seed (so the deformable conv deforms)."""
    est = build_flow_estimator("raft", compute_dtype=dtype, small=True, iters=3, device="cpu")
    acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype=dtype, warm_start=True),
                       device="cpu")
    gen = torch.Generator().manual_seed(2)
    zc = acc.accplus.conv2[4]
    with torch.no_grad():
        for p, scale in ((zc.conv.weight, 0.05), (zc.conv.bias, 0.5), (zc.scale, 0.1)):
            p.copy_(torch.randn(p.shape, generator=gen) * scale)
    est.model.to(device)
    return est, acc.to(device)


def _frames(device, t: int, n: int = 2, size: int = 64):
    gen = torch.Generator().manual_seed(9)
    return (torch.rand((t, n, size, size, 3), generator=gen) * 2 - 1).to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_push_equals_eager_step(dev, dtype):
    """StreamAccumulator.push replays one CUDA graph of step_fn: 5 pushes
    equal the eager step on the same state bit for bit (the graph replays
    the kernels the eager step chose), the replays launch no kernel through
    the wrappers, and a flow kept from push i is unchanged after later
    pushes (outputs do not alias the graph's buffers)."""
    est, acc = _stream_models(dev, dtype)
    frames = _frames(dev, 8)
    sa = StreamAccumulator(est, acc)
    step = make_streaming_fns(est, acc)[1]
    sa.reset(frames[:3])
    state = sa.state
    kept = []
    for i in range(3, 8):
        before = corr_level_cuda.launches
        out = sa.push(frames[i])
        ref, state = step(state, frames[i])
        torch.cuda.synchronize()
        # The eager step launches 3 (one per iteration); the first push also
        # its warm-ups and capture, a replay nothing through the wrapper.
        first = 3 * (graphs.WARMUP + 1) if i == 3 else 0
        assert corr_level_cuda.launches == before + 3 + first
        assert torch.equal(out, ref)
        assert all(torch.equal(a, b) for a, b in zip(sa.state, state))
        kept.append((out, out.clone()))
    assert sa._step.captures == 1
    assert all(torch.equal(a, b) for a, b in kept)


def test_sync_free_eager_push_and_clip(dev):
    """One eager push and one eager clip forward under the sync debug mode
    "error": no host synchronisation (and no pageable host copy) on the
    paths a CUDA graph captures."""
    est, acc = _stream_models(dev, "bfloat16")
    frames = _frames(dev, 4)
    init, step = make_streaming_fns(est, acc)
    _, state = init(frames[:3])
    full = build_flow_estimator("raft", compute_dtype="bfloat16", iters=2, device=dev)
    cold = init_accflow(AccFlowConfig(hidden=32, compute_dtype="bfloat16"), device=dev)
    serve = serving.build_serving_fn(full, cold)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(state, frames[3])
        serve(frames)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_splat_is_deterministic(dev):
    """The splat's scatter (accflow::splat_add) with every source on a few
    targets, run twice with the process's deterministic switch off: equal
    bit for bit (float atomics would sum in another order each time)."""
    gen = torch.Generator().manual_seed(4)
    values = torch.randn((2, 64, 64, 8), generator=gen).to(dev)
    flow = torch.rand((2, 64, 64, 2), generator=gen).to(dev)
    flow[..., 0] += 32 - torch.arange(64.0, device=dev)  # every column lands on 32-33
    assert not torch.are_deterministic_algorithms_enabled()
    a, b = softsplat.splat_add(values, flow), softsplat.splat_add(values, flow)
    assert torch.equal(a, b)
    assert not torch.are_deterministic_algorithms_enabled()


def test_cpu_artifact_moved_to_the_card(dev, tmp_path):
    """A clip artifact exported on the CPU, loaded for the card: it runs
    kernel #1 (the warm-up and capture launch it through the wrapper, the
    replays launch none through it) and agrees with the CPU program within
    1e-3 of the largest |flow| (float32 on both sides; summation order and
    the kernel's shared fractional offset, as chip_smoke.py's small clip)."""
    est = build_flow_estimator("raft", compute_dtype="float32", iters=2, device="cpu")
    acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32"), device="cpu")
    path = str(tmp_path / "clip.pt2")
    serving.save_artifact(serving.export_serving(est, acc, (3, 1, 32, 32, 3)), path)
    images = _frames("cpu", 3, 1, 32)
    ref = serving.load_artifact(path, device="cpu")(images)
    fn = serving.load_artifact(path, device=dev)
    before = corr_cuda.launches
    out = fn(images)
    torch.cuda.synchronize()
    assert corr_cuda.launches - before == 2 * (graphs.WARMUP + 1)  # 2 iterations a run
    for _ in range(2):
        again = fn(images)
    torch.cuda.synchronize()
    assert corr_cuda.launches - before == 6 and torch.equal(again, out)
    assert out.device.type == "cuda"
    diff = float((out.cpu() - ref).abs().max())
    assert diff <= 1e-3 * float(ref.abs().max()), diff


def test_streaming_artifact_on_the_card_is_deterministic(dev, tmp_path):
    """Two runs of a loaded streaming artifact (reset and 4 pushes, the
    warm start's splat in each step) are bit-equal, and within 1e-3 of the
    largest |flow| of the live accumulator (bfloat16; the artifact runs
    cuBLAS's bfloat16 GEMMs with float32 reductions, serving.numerics)."""
    est, acc = _stream_models(dev, "bfloat16")
    path = str(tmp_path / "stream.bin")
    save_streaming_artifact(path, *export_streaming(est, acc, (2, 64, 64)))
    art = load_streaming_artifact(path)
    frames = _frames(dev, 7)

    def run(s):
        outs = [s.reset(frames[:3])] + [s.push(f) for f in frames[3:]]
        return torch.stack(outs)

    first, second = run(art), run(art)
    assert torch.equal(first, second)
    live = run(StreamAccumulator(est, acc))
    assert float((first - live).abs().max()) <= 1e-3 * float(live.abs().max())


@pytest.mark.parametrize("lookup,kernel", [("fused", corr_cuda),
                                           ("experimental:fused_bd", corr_bd_cuda)])
def test_gma_small_clip_gpu_matches_cpu(dev, lookup, kernel):
    """AccFlow+GMA on a 4-frame 64^2 clip in float32 (TF32 off), gamma drawn
    nonzero: on the GPU through the kernel (2 launches: 2 iterations of one
    batched pair call) against the CPU's plain versions, within 1e-3 of the
    largest |flow| (summation order and the kernels' shared fractional
    offset, as chip_smoke.py's small clips)."""
    from accflow_tpu_torch.nn.layers import tf32

    clip = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (4, 1, 64, 64, 3))
                            .astype(np.float32))
    outs = {}
    for where in ("cpu", dev):
        est = build_flow_estimator("gma", compute_dtype="float32", device="cpu", iters=2,
                                   corr_lookup=lookup)
        with torch.no_grad():
            est.model.update_block.aggregator.gamma.fill_(3.0)
        est.model.to(where)
        acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32"), device=where)
        before = kernel.launches
        with tf32(False):
            outs[str(where)] = accflow_forward(acc, clip, est.pairs_fn()).cpu()
        assert kernel.launches - before == (2 if where == dev else 0)
    ref = outs["cpu"]
    diff = float((outs[str(dev)] - ref).abs().max())
    assert diff <= 1e-3 * float(ref.abs().max()), diff


EXPERIMENTAL_KERNEL = {"experimental:pallas": corr_level_cuda,
                       "experimental:fused_mix:rows,rows_gx,vpu_y,bd": corr_bd_cuda}


@pytest.mark.parametrize("lookup", [
    "experimental:pallas", "experimental:rows", "experimental:patch", "experimental:gather",
    "experimental:fusedv", "experimental:packed", "experimental:packed2",
    "experimental:fused_vy", "experimental:fused_cat", "experimental:fused_vy_cat",
    "experimental:fused_mix:rows,rows_gx,vpu_y,bd"])
def test_experimental_small_clip_gpu_matches_cpu(dev, lookup):
    """AccFlow+RAFT on the 4-frame 64^2 clip in float32 (TF32 off), 2
    iterations, with an experimental spelling: the GPU forward against the
    CPU's within 1e-3 of the largest |flow| (the small clips' bar). pallas
    launches kernel #2 and the mix kernel #3 once an iteration on the GPU;
    the other spellings run PyTorch ops and no lookup kernel."""
    from accflow_tpu_torch.nn.layers import tf32

    clip = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (4, 1, 64, 64, 3))
                            .astype(np.float32))
    kernels = (corr_cuda, corr_level_cuda, corr_bd_cuda)
    outs = {}
    for where in ("cpu", dev):
        est = build_flow_estimator("raft", compute_dtype="float32", device=where, iters=2,
                                   corr_lookup=lookup)
        acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32"), device=where)
        before = [k.launches for k in kernels]
        with tf32(False):
            outs[str(where)] = accflow_forward(acc, clip, est.pairs_fn()).cpu()
        want = [2 if where == dev and k is EXPERIMENTAL_KERNEL.get(lookup) else 0
                for k in kernels]
        assert [k.launches - b for k, b in zip(kernels, before)] == want
    ref = outs["cpu"]
    diff = float((outs[str(dev)] - ref).abs().max())
    assert torch.isfinite(outs[str(dev)]).all() and diff <= 1e-3 * float(ref.abs().max()), diff


def test_flow_pipeline_on_the_gpu(dev):
    """FlowPipeline on the card by default: pair_flow, long_range and a
    stream on 36x44 uint8 frames (padded to 40x48), float32."""
    from accflow_tpu_torch import FlowPipeline

    frames = np.random.default_rng(0).integers(0, 255, (4, 36, 44, 3), dtype=np.uint8)
    pipe = FlowPipeline.from_checkpoint("acc+gma", compute_dtype="float32", iters=2)
    assert next(pipe.est.model.parameters()).device.type == "cuda"
    before = corr_cuda.launches
    flow = pipe.pair_flow(frames[0], frames[1])
    assert flow.shape == (36, 44, 2) and np.isfinite(flow).all()
    assert corr_cuda.launches - before == 2
    cpu = FlowPipeline.from_checkpoint("acc+gma", compute_dtype="float32", iters=2,
                                       device="cpu")
    ref = cpu.long_range(frames[:3])
    got = pipe.long_range(frames[:3])
    assert float(np.abs(got - ref).max()) <= 1e-3 * float(np.abs(ref).max()) + 1e-5
    stream = pipe.stream(iters=2)
    outs = [stream.send(f) for f in frames]
    assert outs[1] is None and outs[3].shape == (36, 44, 2)


def _train_case(where, **cfg):
    """64^2, T=4, batch 2: RAFT at 4 iterations from seed 0, AccFlow hidden
    32 from seed 1 with its ZeroConv drawn from seed 2, float32, on `where`,
    and a batch (uint8-valued clips, label flows) from seed 5."""
    est = build_flow_estimator("raft", compute_dtype="float32", iters=4, device=where)
    acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32", **cfg), device="cpu")
    gen = torch.Generator().manual_seed(2)
    zc = acc.accplus.conv2[4]
    with torch.no_grad():
        for p, scale in ((zc.conv.weight, 0.05), (zc.conv.bias, 0.5), (zc.scale, 0.1)):
            p.copy_(torch.randn(p.shape, generator=gen) * scale)
    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 12)).astype(np.float32))
    labels = torch.from_numpy((4 * rng.standard_normal((2, 64, 64, 4))).astype(np.float32))
    return est, acc.to(where), imgs.to(where), labels.to(where)


def test_train_step_gpu_matches_cpu(dev):
    """One step's loss and gradients on the card (kernel #1, cuDNN) against
    the CPU (plain lookup), float32, TF32 off: loss within 1e-5 relative,
    gradients within 1e-4 in global relative L2, held over the context
    encoder's leaves and over the rest apart, so that a TF32 backward
    confined to one part cannot hide in the whole vector (chip_smoke.py's
    TRAIN_* bars)."""
    from accflow_tpu_torch.models.accflow import accflow_train_forward
    from accflow_tpu_torch.nn.layers import tf32
    from accflow_tpu_torch.train.engine import to_clip, to_flow_seq
    from accflow_tpu_torch.train.loss import sequence_loss_acc

    out = {}
    for where in ("cpu", dev):
        est, acc, imgs, labels = _train_case(where)
        before = corr_cuda.launches
        with tf32(False):
            loss, _ = sequence_loss_acc(
                accflow_train_forward(acc, to_clip(imgs), est.pairs_fn()), to_flow_seq(labels))
            loss.backward()
        assert corr_cuda.launches - before == (4 if where == dev else 0)
        out[str(where)] = float(loss), {k: p.grad.cpu() for k, p in acc.named_parameters()}
    (loss_g, g), (loss_c, c) = out[str(dev)], out["cpu"]
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)

    def rel(keys):
        num = sum(float(((g[k] - c[k]) ** 2).sum()) for k in keys)
        return (num / sum(float((c[k] ** 2).sum()) for k in keys)) ** 0.5

    ctx = [k for k in c if k.startswith("context.")]
    assert rel([k for k in c if k not in ctx]) <= 1e-4
    assert rel(ctx) <= 1e-4


def test_train_step_launches_kernel_1_per_iteration(dev):
    """engine.make_acc_train_step on the card: one batched pair call of the
    frozen RAFT per step, so kernel #1 launches once per GRU iteration (4),
    and the update moves the accumulator's weights."""
    from accflow_tpu_torch.train.engine import make_acc_train_step
    from accflow_tpu_torch.train.optim import make_optimizer

    est, acc, imgs, labels = _train_case(dev)
    before_w = [p.detach().clone() for p in acc.parameters()]
    step, _ = make_acc_train_step(est, acc, make_optimizer(acc.parameters(), 1e-4, 10),
                                  add_noise=True)
    before = corr_cuda.launches
    loss, metrics = step(imgs, labels, torch.Generator(device=dev).manual_seed(1))
    assert corr_cuda.launches - before == 4
    assert torch.isfinite(loss) and torch.isfinite(metrics["epe"])
    assert any(not torch.equal(a, b) for a, b in zip(before_w, acc.parameters()))


def _backward_case(dev, shape, spread, radius, grad_dtype, dyadic: bool, seed=0):
    """_case's coords (on a 1/256 grid when dyadic) and a unit-normal window
    gradient (Q, 4*(2r+1)^2) in grad_dtype; returns (grad_out, coords, hw,
    shapes)."""
    levels, coords = _case(dev, *shape, spread, seed=seed)
    if dyadic:
        coords = torch.round(coords * 256) / 256
    gen = torch.Generator().manual_seed(seed + 1)
    cols = corr_cuda.LEVELS * (2 * radius + 1) ** 2
    grad = torch.randn((coords.shape[0], cols), generator=gen).to(grad_dtype).to(dev)
    shapes = [tuple(lvl.shape[1:]) for lvl in levels]
    return grad, coords.contiguous(), [d for hw in shapes for d in hw], shapes


def _backward_op(radius):
    if radius == 4:
        return corr_backward_cuda.corr_lookup_backward_op
    return corr_backward_cuda.corr_level_lookup_backward_op


@pytest.mark.parametrize("radius", [4, 3])
@pytest.mark.parametrize("level_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 13, 7), (6, 4, 4)])
def test_backward_kernel_matches_plain(dev, radius, level_dtype, grad_dtype, shape):
    """The backward kernel (radius 4: kernel #1's entry; 3: kernel #2's)
    against lookup_corr_plain_backward, coords on a 1/256 grid +-20 px
    (both then blend with the same weights bit for bit and differ by
    summation order): float32 levels rtol 1e-5, atol 1e-6 x the largest
    |grad|; bfloat16 levels bit-equal to the kernel's float32 result cast
    and within its rounding of the plain one. Every map element is written
    (zeros outside the windows), the 4-wide maps of (6, 4, 4) included."""
    grad, coords, hw, shapes = _backward_case(dev, shape, 20, radius, grad_dtype, True)
    op = _backward_op(radius)
    ref = lookup_corr_plain_backward(grad, coords, shapes, radius)
    got32 = op(grad, coords, hw, radius, torch.float32)
    got = op(grad, coords, hw, radius, level_dtype)
    torch.cuda.synchronize()
    scale = max(float(r.abs().max()) for r in ref if r.numel())
    for g, g32, r in zip(got, got32, ref):
        assert g.dtype == level_dtype and g.shape == r.shape
        if level_dtype == torch.float32:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6 * scale)
        else:
            assert torch.equal(g.view(torch.int16), g32.to(torch.bfloat16).view(torch.int16))
            assert bool(((g.float() - r).abs() <= 1e-6 * scale + 2 ** -8 * r.abs()).all())


@pytest.mark.parametrize("radius", [4, 3])
def test_backward_kernel_edges(dev, radius):
    """Random (not grid) coords: within 1e-4 of the plain backward (the
    plain version recomputes the fractional offset per tap, as in the
    forward); coords far off every map give zero gradients; zero-sized
    levels give empty ones; an empty query set launches nothing."""
    op = _backward_op(radius)
    grad, coords, hw, shapes = _backward_case(dev, (2, 16, 16), 20, radius, torch.float32, False)
    for g, r in zip(op(grad, coords, hw, radius, torch.float32),
                    lookup_corr_plain_backward(grad, coords, shapes, radius)):
        torch.testing.assert_close(g, r, **TOL)
    far = coords + 1e4
    assert all(float(g.abs().max()) == 0 for g in op(grad, far, hw, radius, torch.float32))
    grad, coords, hw, shapes = _backward_case(dev, (1, 4, 4), 2, radius, torch.float32, True)
    assert shapes[3] == (0, 0)
    for g, r in zip(op(grad, coords, hw, radius, torch.float32),
                    lookup_corr_plain_backward(grad, coords, shapes, radius)):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
    before = (corr_backward_cuda.launches, corr_backward_cuda.level_launches)
    empty = op(grad[:0], coords[:0], hw, radius, torch.float32)
    assert [tuple(g.shape) for g in empty] == [(0, *s) for s in shapes]
    assert (corr_backward_cuda.launches, corr_backward_cuda.level_launches) == before


@pytest.mark.parametrize("op", ["corr_lookup", "corr_level_lookup"])
def test_lookup_ops_backward_through_the_kernel(dev, op):
    """autograd through the lookup ops on the card: one backward-kernel
    launch per backward, the plain backward's gradient (float32 levels,
    bfloat16 window), and coords that require grad raise."""
    levels, coords = _case(dev, 2, 16, 16, 20)
    levels = [lvl.requires_grad_(True) for lvl in levels]
    if op == "corr_lookup":
        call, radius = corr_cuda.lookup_corr_fused, 4
    else:
        call, radius = lambda lv, c, r, o: corr_level_cuda.lookup_corr_level(lv, c, r, o), 3
    out = call(levels, coords, radius, torch.bfloat16)
    cot = torch.randn(out.shape, device=dev).to(torch.bfloat16)
    before = corr_backward_cuda.launches + corr_backward_cuda.level_launches
    grads = torch.autograd.grad(out, levels, cot)
    assert corr_backward_cuda.launches + corr_backward_cuda.level_launches == before + 1
    ref = lookup_corr_plain_backward(cot, coords, [lvl.shape[1:] for lvl in levels], radius)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, **TOL)
    with pytest.raises(RuntimeError, match="coords require grad"):
        call(levels, coords.requires_grad_(True), radius, torch.bfloat16)


# The backward kernel's paths (csrc/corr_window_backward.cuh): (Q, level 0's
# map; each next level halves it). A level whose map rows are whole 16-byte
# vectors is written in 16-byte stores, any other element by element:
# 33x30 -> 16x15 -> 8x7 -> 4x3 has no such rows; 34x36 -> 17x18 -> 8x9 ->
# 4x4 has them in float32 at levels 0 and 3; 24x40 -> 12x20 -> 6x10 -> 3x5
# at levels 0 and 1 in float32, level 0 in bfloat16; 8x8 -> 1x1 holds a
# bfloat16 4x4 (elements) beside an 8x8 (vectors); 2x6 -> 0x0 has zero-sized
# levels; one query alone; 132 SMs x 8 resident blocks x 8 warps = 8,448
# queries fill the persistent grid at most, so 132 * 8 * 16 + 3 take it
# more than two passes. Every Q but 1 and 16 is odd: odd rows of a bfloat16
# window gradient start 8 bytes past a 16-byte boundary.
BWD_PATHS = {"no vector rows": (37, (33, 30)), "mixed widths": (35, (34, 36)),
             "mixed widths 2": (13, (24, 40)), "bf16 8x8 beside 4x4": (21, (8, 8)),
             "zero-sized levels": (9, (2, 6)), "one query": (1, (32, 32)),
             "beyond one pass": (132 * 8 * 16 + 3, (8, 8)), "Q 16": (16, (16, 16))}


def _paths_case(dev, q, hw0, radius, grad_dtype, seed=0):
    """Q queries, their level shapes from hw0 down (halving), coords on a
    1/256 grid over level 0's map and 6 px beyond it, and a unit-normal
    window gradient (Q, 4*(2r+1)^2) in grad_dtype; returns (grad_out, coords,
    hw, shapes)."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [(hw0[0] >> l, hw0[1] >> l) for l in range(corr_cuda.LEVELS)]
    span = torch.tensor([hw0[1] + 12.0, hw0[0] + 12.0])
    coords = torch.round((torch.rand((q, 2), generator=gen) * span - 6) * 256) / 256
    cols = corr_cuda.LEVELS * (2 * radius + 1) ** 2
    grad = torch.randn((q, cols), generator=gen).to(grad_dtype)
    return grad.to(dev), coords.to(dev), [d for hw in shapes for d in hw], shapes


def _poisoned_call(op, grad, coords, hw, shapes, radius, dtype):
    """op's gradients, called right after NaN-filled tensors of the outputs'
    shapes were freed, so that the caching allocator hands their memory to
    the outputs: an element the kernel leaves unwritten stays NaN."""
    q = coords.shape[0]
    poison = [torch.full((q, *s), float("nan"), dtype=dtype, device=coords.device)
              for s in shapes]
    del poison
    return op(grad, coords, hw, radius, dtype)


@pytest.mark.parametrize("radius", [4, 3])
@pytest.mark.parametrize("level_dtype,grad_dtype", [
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("case", list(BWD_PATHS))
def test_backward_kernel_paths(dev, radius, level_dtype, grad_dtype, case):
    """The backward kernel's 16-byte and element-by-element levels, zero-sized
    levels, one query, a Q the block's 8 warps do not divide, a Q beyond
    one pass of the persistent grid, and odd rows of a bfloat16 window
    gradient, against lookup_corr_plain_backward with
    test_backward_kernel_matches_plain's bars; every element written (the
    outputs land on freed NaN-filled memory); coords far off every map give
    all zeros."""
    q, hw0 = BWD_PATHS[case]
    grad, coords, hw, shapes = _paths_case(dev, q, hw0, radius, grad_dtype)
    op = _backward_op(radius)
    ref = lookup_corr_plain_backward(grad, coords, shapes, radius)
    got32 = _poisoned_call(op, grad, coords, hw, shapes, radius, torch.float32)
    got = _poisoned_call(op, grad, coords, hw, shapes, radius, level_dtype)
    torch.cuda.synchronize()
    scale = max(float(r.abs().max()) for r in ref if r.numel())
    for g, g32, r in zip(got, got32, ref):
        assert g.dtype == level_dtype and g.shape == r.shape
        assert bool(torch.isfinite(g).all()) and bool(torch.isfinite(g32).all())
        torch.testing.assert_close(g32, r, rtol=1e-5, atol=1e-6 * scale)
        if level_dtype == torch.bfloat16:
            assert torch.equal(g.view(torch.int16), g32.to(torch.bfloat16).view(torch.int16))
            assert bool(((g.float() - r).abs() <= 1e-6 * scale + 2 ** -8 * r.abs()).all())
    far = _poisoned_call(op, grad, coords + 1e4, hw, shapes, radius, level_dtype)
    assert all(bool((g == 0).all()) for g in far)


@pytest.mark.parametrize("radius", [4, 3])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_misaligned_window_gradient(dev, radius, grad_dtype):
    """A window gradient that starts one element past an aligned address (a
    view into a larger tensor) gives the aligned copy's gradients bit for bit
    (the wrapper copies it: the kernel copies whole 4-value pieces)."""
    grad, coords, hw, shapes = _paths_case(dev, 37, (33, 30), radius, grad_dtype)
    flat = torch.empty(grad.numel() + 1, dtype=grad_dtype, device=dev)
    view = flat[1:].view(grad.shape)
    view.copy_(grad)
    assert view.is_contiguous() and view.data_ptr() % 8 != 0
    op = _backward_op(radius)
    for g, a in zip(op(view, coords, hw, radius, torch.float32),
                    op(grad, coords, hw, radius, torch.float32)):
        assert torch.equal(g, a)


TIE_REL = 1e-5  # chip_smoke.py's: a ReLU input this close to zero is a tie

def tie_hooks(model, recorded=None):
    """Forward hooks on `model`'s convs and norms, whose outputs hold its
    ReLU inputs. Without `recorded`, each call's output is kept (float32, on
    the CPU) in the returned dict under the module's name. With another
    run's record, each call's output takes that run's value wherever the two
    lie on opposite sides of zero, each within TIE_REL of its tensor's
    median |value|: a ReLU input in a tie, which either rounding may put on
    either side of the kink; the gradient passes unchanged. Returns (record,
    ties: (module, call, elements) per call that had one, hook handles)."""
    rec, ties, handles = {}, [], []
    for name, m in model.named_modules():
        if not isinstance(m, (Conv2d, InstanceNorm2d, BatchNorm2d)):
            continue

        def hook(mod, inputs, out, name=name):
            calls = rec.setdefault(name, [])
            calls.append(out.detach().float().cpu() if recorded is None else None)
            if recorded is None:
                return None
            o, other = out.detach().float(), recorded[name][len(calls) - 1].to(out.device)
            tie = ((o * other < 0) & (o.abs() <= TIE_REL * o.abs().median())
                   & (other.abs() <= TIE_REL * other.abs().median()))
            if not bool(tie.any()):
                return None
            ties.append((name, len(calls) - 1, int(tie.sum())))
            return out + ((other - o) * tie).to(out.dtype).detach()

        handles.append(m.register_forward_hook(hook))
    return rec, ties, handles


def _finetune_case(where):
    """Full RAFT from seed 0, float32, and a 64^2 batch of 2 (uint8 values,
    label flows) from seed 5, on `where`, with make_finetune_step's step
    (12 iterations, noise off, remat "dots")."""
    from accflow_tpu_torch.train.finetune import make_finetune_step
    from accflow_tpu_torch.train.optim import make_optimizer

    est = build_flow_estimator("raft", compute_dtype="float32", device=where)
    rng = np.random.default_rng(5)
    img1, img2 = (torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)).to(where)
                  for _ in range(2))
    label = torch.from_numpy((4 * rng.standard_normal((2, 64, 64, 2))).astype(np.float32)).to(where)
    opt = make_optimizer(est.model.parameters(), 1e-4, 10)
    grads = {}
    update = opt.step

    def step():
        grads.update({k: p.grad.detach().cpu().clone() for k, p in est.model.named_parameters()
                      if p.grad is not None})
        update()

    opt.step = step
    train_step, _ = make_finetune_step(est, opt, add_noise=False, gamma=0.85)
    return est, train_step, (img1, img2, label), grads


def test_finetune_step_gpu_matches_cpu(dev):
    """One fine-tune step on the card (kernel #1 and its backward kernel,
    cuDNN) against the CPU (the plain lookup and backward), float32, TF32
    off: loss within 1e-5 relative, gradients within 1e-4 in relative L2
    over the fnet, the cnet and the update block apart, each running-
    statistics buffer within 1e-5 of its largest |value| (chip_smoke.py's
    bars); 12 forward and 12 backward kernel
    launches, no other lookup kernel. The CPU run takes the GPU's ReLU
    inputs where the two lie in a tie (tie_hooks): at this seed one, in the
    fnet's layer2.1.norm2 output (-1.06e-6 on the CPU, +1.41e-6 on the GPU,
    median 0.67), moved the fnet's gradient by 1.75e-4 in L2."""
    out = {}
    recorded = None
    for where in (dev, "cpu"):
        est, train_step, batch, grads = _finetune_case(where)
        recorded = tie_hooks(est.model, recorded)[0]
        before = (corr_cuda.launches, corr_backward_cuda.launches)
        loss, _ = train_step(*batch)
        after = (corr_cuda.launches, corr_backward_cuda.launches)
        assert [a - b for a, b in zip(after, before)] == ([12, 12] if where == dev else [0, 0])
        stats = {k: v.cpu() for k, v in est.model.state_dict().items() if "running" in k}
        out[str(where)] = float(loss), grads, stats
    (loss_g, g, s_g), (loss_c, c, s_c) = out[str(dev)], out["cpu"]
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for part in ("fnet.", "cnet.", "update_block."):
        keys = [k for k in c if k.startswith(part)]
        num = sum(float(((g[k] - c[k]) ** 2).sum()) for k in keys)
        assert (num / sum(float((c[k] ** 2).sum()) for k in keys)) ** 0.5 <= 1e-4, part
    for k in s_c:  # each buffer within 1e-5 of its largest |value|
        assert float((s_g[k] - s_c[k]).abs().max()) <= 1e-5 * float(s_c[k].abs().max()), k


def _graph_case(dev, kind: str, graphed: bool, n: int = 2, seed: int = 5, group=None,
                spatial=None):
    """A train step built afresh from seeds on the card and 3 batches of `n`
    samples: kind "acc" is make_acc_train_step's (_train_case's frozen RAFT
    at 4 iterations and AccFlow hidden 32, noise on); "none", "full" and
    "dots" make_finetune_step's for full RAFT from seed 0 (12 iterations,
    the cnet's BatchNorm on the batch's statistics, noise on, gamma 0.85)
    with that remat. float32 at 64^2; `group` the steps' process group,
    `spatial` their handle (given the height). Returns (model, optimizer,
    train_step, valid_step, batches, valid_batches)."""
    from accflow_tpu_torch.train.engine import make_acc_train_step
    from accflow_tpu_torch.train.finetune import make_finetune_step
    from accflow_tpu_torch.train.optim import make_optimizer

    rng = np.random.default_rng(seed)

    def draw(shape, uint8=False):
        a = (rng.integers(0, 256, shape).astype(np.uint8) if uint8
             else (4 * rng.standard_normal(shape)).astype(np.float32))
        return torch.from_numpy(a).to(dev)

    clips = [draw((n, 64, 64, 12), True) for _ in range(4)]
    flows = [draw((n, 64, 64, 4)) for _ in range(4)]
    spatial = None if spatial is None else spatial.at_height(64)
    if kind == "acc":
        est, model, _, _ = _train_case(dev)
        optimizer = make_optimizer(model.parameters(), 1e-4, 10)
        steps = make_acc_train_step(est, model, optimizer, add_noise=True, graphed=graphed,
                                    group=group, spatial=spatial)
        batches = [(c.float(), f) for c, f in zip(clips[:3], flows[:3])]
        return (model, optimizer, *steps, batches, batches)
    est = build_flow_estimator("raft", compute_dtype="float32", seed=0, device=dev)
    optimizer = make_optimizer(est.model.parameters(), 1e-4, 10)
    steps = make_finetune_step(est, optimizer, add_noise=True, gamma=0.85, remat=kind,
                               graphed=graphed, group=group, spatial=spatial)
    batches = [(c[..., :3], c[..., 3:6], f[..., :2]) for c, f in zip(clips[:3], flows[:3])]
    return (est.model, optimizer, *steps, batches, list(zip(clips[:3], flows[:3])))


def _train_state(model, optimizer) -> dict:
    """Parameters, AdamW's moments and the buffers (BatchNorm running
    statistics), float32 copies, by group."""
    named = list(model.named_parameters())
    st = optimizer.optimizer.state
    return {"parameters": {k: p.detach().clone() for k, p in named},
            "exp_avg": {k: st[p]["exp_avg"].clone() for k, p in named},
            "exp_avg_sq": {k: st[p]["exp_avg_sq"].clone() for k, p in named},
            "buffers": {k: b.clone() for k, b in model.named_buffers()}}


def _run_steps(dev, kind, graphed, steps: int = 5, group=None, spatial=None):
    """`steps` calls of _graph_case's train step (the batches cycled, noise
    from a generator seeded 11): (losses, state, train_step, optimizer,
    generator state, each step's mesh collectives and bytes)."""
    from accflow_tpu_torch.parallel import mesh

    model, optimizer, step, _, batches, _ = _graph_case(dev, kind, graphed, group=group,
                                                        spatial=spatial)
    gen = torch.Generator(device=dev).manual_seed(11)
    losses, counts = [], []
    for i in range(steps):
        c0 = mesh.counts()
        losses.append(float(step(*batches[i % len(batches)], gen)[0]))
        counts.append(tuple(a - b for a, b in zip(mesh.counts(), c0)))
    return losses, _train_state(model, optimizer), step, optimizer, gen.get_state(), counts


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms (warn only: an op without one runs
    as it is) while a test runs, restored after. With torch's defaults each
    run of _graph_case's accumulator step, eager or graphed, falls on one
    of two outcomes 1.25e-5 apart in the parameters after 5 steps on the
    card (cuDNN's deterministic mode removes the split), so a few eager
    runs cannot bound a graphed one; in this mode eager runs and graphed
    runs repeat bit for bit (8 of 8 calls)."""
    was, warn_only = (torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(was, warn_only=warn_only)


def _rel_l2(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    return (num / max(sum(float((b[k].double() ** 2).sum()) for k in b), 1e-30)) ** 0.5


def _assert_within_eager_spread(graphed, eager):
    """A graphed run (losses, state) against the first of two eager runs,
    within twice their distance plus 1e-6 (a few float32 roundings: a loss
    is read to one ulp, 1e-7 of it): losses step by step (relative), each
    state group in relative L2 (chip_smoke.py's GRAPH_SPREAD and
    GRAPH_FLOOR). Under `deterministic` the eager runs agree bit for bit,
    so the graphed run must too, up to the floor."""
    (lg, sg), (l1, s1), (l2, s2) = graphed, *eager
    for i, (a, b, c) in enumerate(zip(lg, l1, l2)):
        assert abs(a - b) <= 2 * abs(c - b) + 1e-6 * abs(b), (i, lg, l1, l2)
    for group in s1:
        got, spread = _rel_l2(sg[group], s1[group]), _rel_l2(s2[group], s1[group])
        assert got <= 2 * spread + 1e-6, (group, got, spread)


@pytest.mark.parametrize("kind", ["acc", "none", "full", "dots"])
def test_graphed_train_steps_match_eager(dev, deterministic, kind):
    """5 graphed steps (graphs.CudaGraphedStep: 2 eager, the capture replayed
    once, 2 replays) against 5 eager steps from the same init, batches and
    generator, for train_acc's step and for fine_tune's in each remat mode:
    losses, parameters, AdamW's moments and the BatchNorm buffers within the
    spread of two eager runs, under torch's deterministic algorithms
    (_assert_within_eager_spread, `deterministic`); the step ran
    eagerly WARMUP times and was captured once; AdamW's step count, the
    learning rate and the generator's state are eager's."""
    eager = [_run_steps(dev, kind, False) for _ in range(2)]
    e1, g = eager[0], _run_steps(dev, kind, True)
    _assert_within_eager_spread(g[:2], [e[:2] for e in eager])
    step, optimizer = g[2], g[3]
    assert step.eager_calls == graphs.WARMUP and step.captures == 1
    counts = {float(s["step"]) for s in optimizer.optimizer.state.values()}
    assert counts == {5.0} and optimizer.scheduler.last_epoch == 5
    assert optimizer.lr == e1[3].lr
    assert torch.equal(g[4], e1[4])


@pytest.mark.parametrize("kind", ["acc", "dots"])
def test_graphed_valid_steps_bit_equal_eager(dev, kind):
    """The validation step replayed from a CUDA graph (graphs.CudaGraphed,
    as train_acc and fine_tune run it) against the eager one on the same
    model, over 3 batches (warm-ups and capture, then replays): bit-equal."""
    _, _, _, valid, _, inputs = _graph_case(dev, kind, True)
    eager = _graph_case(dev, kind, False)[3]
    for x in inputs:
        got, want = valid(*x), eager(*x)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert valid.captures == 1


def test_graphed_step_captures_once_per_signature(dev):
    """A second batch size is a second signature: WARMUP eager calls and one
    capture each, none again for a signature seen before."""
    _, _, step, _, batches, _ = _graph_case(dev, "acc", True)
    small = _graph_case(dev, "acc", False, n=1)[4]
    gen = torch.Generator(device=dev).manual_seed(1)
    for b in batches + batches[:1]:
        step(*b, gen)
    assert (step.captures, step.eager_calls) == (1, graphs.WARMUP)
    for b in small + batches[:1]:
        step(*b, gen)
    assert (step.captures, step.eager_calls) == (2, 2 * graphs.WARMUP)


def test_graphed_step_refuses_what_it_cannot_key(dev):
    """On the card a graphed step takes tensors, torch.Generators and None,
    on one device."""
    wrapped = graphs.CudaGraphedStep(lambda *a: a[0])
    x = torch.ones(1, device=dev)
    with pytest.raises(TypeError, match="tensors, torch.Generators and None"):
        wrapped(x, 3)
    with pytest.raises(ValueError, match="one device"):
        wrapped(x, torch.ones(1))
    with pytest.raises(ValueError, match="one device"):
        wrapped(x, torch.Generator())
    assert wrapped.captures == 0 and wrapped.eager_calls == 0


@pytest.mark.parametrize("kind", ["acc", "dots"])
def test_whole_train_step_is_sync_free(dev, kind):
    """One eager step, its update included (clip, capturable AdamW, the
    schedule's in-place write, the BatchNorm write-back, the noise draw),
    and one graphed replay under torch.cuda.set_sync_debug_mode("error")."""
    _, _, eager, _, batches, _ = _graph_case(dev, kind, False)
    _, _, graphed, _, _, _ = _graph_case(dev, kind, True)
    gen = torch.Generator(device=dev).manual_seed(1)
    for b in batches:
        eager(*b, gen)
        graphed(*b, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager(*batches[0], gen)
        graphed(*batches[0], gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert graphed.captures == 1


def test_resume_then_capture_again(dev, deterministic):
    """3 graphed steps, the model's, optimizer's and generator's state saved
    through torch.save and loaded into a fresh step (as train_acc's resume
    does, before any step), 3 more graphed steps (WARMUP eager ones and a
    capture again): losses and state against 6 uninterrupted graphed steps
    within the spread of two such runs (under `deterministic`); AdamW's
    count goes on to 6."""
    import io

    runs = [_run_steps(dev, "acc", True, steps=6)[:2] for _ in range(2)]
    model, optimizer, step, _, batches, _ = _graph_case(dev, "acc", True)
    gen = torch.Generator(device=dev).manual_seed(11)
    losses = [float(step(*batches[i], gen)[0]) for i in range(3)]
    saved = io.BytesIO()
    torch.save({"model": model.state_dict(), **optimizer.state_dict(), "gen": gen.get_state()},
               saved)
    saved.seek(0)
    state = torch.load(saved, map_location="cpu")
    model, optimizer, step, _, batches, _ = _graph_case(dev, "acc", True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state)
    gen = torch.Generator(device=dev)
    gen.set_state(state["gen"])
    losses += [float(step(*batches[i % 3], gen)[0]) for i in range(3, 6)]
    assert (step.captures, step.eager_calls) == (1, graphs.WARMUP)
    assert {float(s["step"]) for s in optimizer.optimizer.state.values()} == {6.0}
    assert optimizer.scheduler.last_epoch == 6
    _assert_within_eager_spread((losses, _train_state(model, optimizer)), runs)


@pytest.mark.parametrize("model_name", ["acc|raft", "direct|raft"])
def test_graphed_evaluate_cvo_bit_equal_eager(dev, tmp_path, monkeypatch, model_name):
    """evaluate_cvo on the card replays one CUDA graph per micro-batch
    signature (4 synthetic 64^2 clips, batch 4, micro-batch 2, 2
    iterations, float32): its EPEs bit-equal to the same run with the
    graph wrapper taken out."""
    from accflow_tpu_torch.data.synthetic import write_synthetic_cvor
    from accflow_tpu_torch.train import evaluate

    root = write_synthetic_cvor(str(tmp_path / "cvor"), num_train=0, num_test=4)
    made = []

    class Recorded(graphs.CudaGraphed):
        def __init__(self, fn):
            super().__init__(fn)
            made.append(self)

    def run():
        return evaluate.evaluate_cvo(model_name, root, batch=4, micro_batch=2, iters=2,
                                     compute_dtype="float32", device=dev,
                                     result_file=str(tmp_path / "result.txt"))

    monkeypatch.setattr(evaluate, "CudaGraphed", Recorded)
    graphed = run()
    assert [g.captures for g in made] == [1]
    monkeypatch.setattr(evaluate, "CudaGraphed", lambda fn: fn)
    assert run() == graphed


@pytest.mark.parametrize("radius,chunk", [(4, 0), (4, 64), (3, 0), (3, 37)])
def test_ondemand_lookup_matches_plain_and_launches_per_chunk(dev, radius, chunk):
    """The volume-free lookup on the card (each chunk's rows rebuilt and read
    by kernel #1 at radius 4, #2 at radius 3) against the plain lookup on
    the CPU's stored pyramid: one launch per chunk (16x16 maps: 256 queries,
    AUTO one chunk, 64 four, 37 rounds down to 32: eight)."""
    from accflow_tpu_torch.nn.layers import tf32
    from accflow_tpu_torch.ops import corr

    gen = torch.Generator().manual_seed(1)
    f1, f2 = (torch.randn((2, 16, 16, 16), generator=gen) for _ in range(2))
    ys, xs = torch.meshgrid(torch.arange(16), torch.arange(16), indexing="ij")
    coords = (torch.stack([xs, ys], -1).float() + (torch.rand((2, 16, 16, 2), generator=gen)
                                                   * 40 - 20)).contiguous()
    ref = lookup_corr_plain(corr.build_corr_pyramid(f1, f2, 4), coords.reshape(-1, 2), radius)
    kernel = corr_cuda if radius == 4 else corr_level_cuda
    before = kernel.launches
    with tf32(False):
        od = corr.build_corr_on_demand(f1.to(dev), f2.to(dev), 4)
        got = corr.lookup_corr_on_demand(od, coords.to(dev), radius, chunk)
    torch.cuda.synchronize()
    assert kernel.launches - before == 256 // corr.prepare_ondemand_chunks(od, chunk).chunk
    np.testing.assert_allclose(got.reshape(-1, ref.shape[1]).cpu().numpy(), ref.numpy(), **TOL)


def test_ondemand_clip_gpu_matches_cpu_and_is_graphed(dev):
    """A 64^2 clip with corr_lookup ondemand:16 (4 chunks) on the GPU against
    the CPU (f32, TF32 off) within 1e-3 of the largest |flow|, and its CUDA
    graph (serving.build_serving_fn) bit-equal to the eager GPU run."""
    from accflow_tpu_torch.nn.layers import tf32

    clip = np.random.default_rng(3).uniform(-1, 1, (4, 1, 64, 64, 3)).astype(np.float32)
    outs = {}
    for where in ("cuda", "cpu"):
        est = build_flow_estimator("raft", compute_dtype="float32", iters=3, device=where,
                                   corr_lookup="ondemand:16")
        acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32"), device=where)
        with tf32(False):
            outs[where] = accflow_forward(acc, clip, est.pairs_fn()).cpu()
            if where == "cuda":
                graphed = graphs.CudaGraphed(serving.build_serving_fn(est, acc))
                images = torch.from_numpy(clip).to(dev)
                for _ in range(3):
                    replay = graphed(images)
                assert graphed.captures == 1
                assert torch.equal(replay.cpu(), outs[where])
    flow_max = float(outs["cpu"].abs().max())
    assert flow_max > 0
    assert float((outs["cuda"] - outs["cpu"]).abs().max()) <= 1e-3 * flow_max


def _write_png(path, img: np.ndarray) -> None:
    """(H, W, C) uint8 as an 8-bit PNG (grey or RGB), rows unfiltered."""
    import struct
    import zlib

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    h, w, c = img.shape
    rows = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                                  {1: 0, 3: 2}[c], 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("model_name", ["direct|raft", "acc|raft"])
def test_evaluate_sintel_gpu_matches_cpu(dev, tmp_path, model_name):
    """evaluate_sintel on 3 synthetic samples (5 frames of 72x40 resized to
    64x32, interv 2: T = 3, batch 2 with the second batch padded), float32,
    TF32 off, 2 iterations: the GPU (kernel #1, graphed) against the CPU
    (the plain lookup), each EPE within 1e-4 of the CPU's (chip_smoke.py's
    SINTEL_REL); the ground truth within +-0.25 px, the flows' scale, so
    that the EPEs read the flows' errors."""
    from accflow_tpu_torch.nn.layers import tf32
    from accflow_tpu_torch.train.evaluate import evaluate_sintel
    from accflow_tpu_torch.utils.frame_io import write_flow

    rng = np.random.default_rng(9)
    for s in range(3):
        sample = tmp_path / "hs" / f"alley_{s:04d}"
        (sample / "2_imgs").mkdir(parents=True)
        (sample / "43_imgs").mkdir()
        frames = rng.integers(0, 256, (5, 40, 72, 3), dtype=np.uint8)
        for i, img in enumerate(frames):
            _write_png(sample / "43_imgs" / f"frame_{i:04d}.png", img)
        for i, img in enumerate((frames[0], frames[-1])):
            _write_png(sample / "2_imgs" / f"frame_{i}.png", img)
        write_flow(str(sample / "flow.flo"),
                   rng.uniform(-0.25, 0.25, (32, 64, 2)).astype(np.float32))
        _write_png(sample / "occ.png",
                   (rng.uniform(size=(32, 64, 1)) > 0.7).astype(np.uint8) * 255)
    res = {}
    for where in ("cuda", "cpu"):
        with tf32(False):
            res[where] = evaluate_sintel(model_name, str(tmp_path / "hs"), interv=2, iters=2,
                                         compute_dtype="float32", size=(64, 32), batch=2,
                                         device=where)
    for k, v in res["cpu"].items():
        assert np.isfinite(v) and abs(res["cuda"][k] - v) <= 1e-4 * abs(v) + 1e-6, (k, res)


@pytest.mark.parametrize("kind", ["acc", "dots"])
def test_nccl_world_of_one_graphed_train_step_bit_equal(dev, deterministic, monkeypatch, kind):
    """train_acc's step ("acc") and fine_tune's ("dots": the cnet's
    train-mode BatchNorm) graphed in a world of one over NCCL, given the
    group (the gradient all-reduce, the loss mean and BatchNorm's sums over
    ranks, forward and backward, captured in the graph), under torch's
    deterministic algorithms: every loss and every state group bit-equal to
    the same 5 steps without a process group."""
    import socket

    from accflow_tpu_torch.parallel import mesh

    plain = _run_steps(dev, kind, True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), ACCFLOW_DISTRIBUTED="1").items():
        monkeypatch.setenv(k, v)
    assert mesh.maybe_init_distributed("cuda")
    try:
        assert torch.distributed.get_backend() == "nccl" and mesh.collectives_capturable()
        grouped = _run_steps(dev, kind, True, group=mesh.data_group())
    finally:
        torch.distributed.destroy_process_group()
    assert grouped[0] == plain[0]
    assert grouped[2].captures == 1
    for group, tensors in plain[1].items():
        for k, t in tensors.items():
            assert torch.equal(grouped[1][group][k], t), (group, k)


@pytest.fixture
def nccl_handle(dev, monkeypatch):
    """A world of one over NCCL (torchrun's environment through
    maybe_init_distributed) while a test runs, and a spatial handle of its
    one rank (JAX's mesh keeps a "spatial" axis of size 1): every exchange
    then runs as an NCCL collective of one rank."""
    import socket

    from accflow_tpu_torch.parallel import mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), ACCFLOW_DISTRIBUTED="1").items():
        monkeypatch.setenv(k, v)
    assert mesh.maybe_init_distributed("cuda")
    try:
        assert mesh.collectives_capturable(torch.distributed.group.WORLD)
        yield mesh.Spatial(torch.distributed.group.WORLD, 0, 1)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("kind", ["acc", "dots"])
def test_one_rank_handle_graphed_steps_match_eager(dev, deterministic, nccl_handle, kind):
    """make_acc_train_step ("acc") and make_finetune_step ("dots") with a
    one-rank spatial handle over NCCL, graphed (the halos, gathers, the
    backward's all_reduces and the gradient sum captured) against two eager
    runs with the handle under torch's deterministic algorithms
    (_assert_within_eager_spread); captured once; every step counts the
    eager step's collectives and bytes (a replay adds its capture's)."""
    eager = [_run_steps(dev, kind, False, spatial=nccl_handle) for _ in range(2)]
    g = _run_steps(dev, kind, True, spatial=nccl_handle)
    _assert_within_eager_spread(g[:2], [e[:2] for e in eager])
    assert g[2].eager_calls == graphs.WARMUP and g[2].captures == 1
    assert g[5] == eager[0][5] and g[5][0][0] > 0


def _handle_clip_and_stream(dev, sp):
    """RAFT (seed 0, 2 iterations) under AccFlow hidden 32 (the stream's
    warm-started), float32, on 6 frames of 64^2 from seed 9, with the
    handle `sp` given their height: (clip forward, init, step_fn,
    StreamAccumulator, frames)."""
    sp = sp.at_height(64)
    est = build_flow_estimator("raft", compute_dtype="float32", iters=2, device=dev)
    acc, warm = (init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32", warm_start=w),
                              device=dev) for w in (False, True))
    frames = (torch.rand((6, 1, 64, 64, 3), generator=torch.Generator().manual_seed(9)) * 2
              - 1).to(dev)

    def clip(x):
        return accflow_forward(acc, x, est.pairs_fn(spatial=sp), spatial=sp)

    init, step = make_streaming_fns(est, warm, spatial=sp)
    return clip, init, step, StreamAccumulator(est, warm, spatial=sp), frames


def test_one_rank_handle_graphed_clip_and_push_bit_equal(dev, nccl_handle):
    """With a one-rank handle over NCCL: the sharded clip in
    graphs.CudaGraphed (the handle's group) and StreamAccumulator's pushes,
    which replay a graph under NCCL, bit-equal to the eager clip and to
    step_fn; a replayed call counts the eager call's collectives and bytes,
    and launches kernel #1 through no wrapper."""
    from accflow_tpu_torch.parallel import mesh
    from accflow_tpu_torch.nn.layers import tf32

    clip, init, step, stream, frames = _handle_clip_and_stream(dev, nccl_handle)
    graphed = graphs.CudaGraphed(clip, nccl_handle.group)

    def counted(fn, *args):
        c0, l0 = mesh.counts(), corr_cuda.launches
        out = fn(*args)
        return out, tuple(a - b for a, b in zip(mesh.counts(), c0)), corr_cuda.launches - l0

    with tf32(False):
        want, want_counts, want_launches = counted(clip, frames[:4])
        graphed(frames[:4])
        got, got_counts, got_launches = counted(graphed, frames[:4])
        assert torch.equal(got, want) and graphed.captures == 1
        assert got_counts == want_counts and want_counts[0] > 0
        assert (want_launches, got_launches) == (2, 0)
        flow, state = init(frames[:3])
        assert torch.equal(stream.reset(frames[:3]), flow)
        for i in range(3, 6):  # the first push warms up and captures, the others replay
            (flow, state), step_counts, _ = counted(step, state, frames[i])
            pushed, push_counts, _ = counted(stream.push, frames[i])
            assert torch.equal(pushed, flow), i
        assert push_counts == step_counts and push_counts[0] > 0


def test_graphs_refuse_gloo_on_the_card(dev, monkeypatch):
    """A world of one over gloo with CUDA tensors: a graphed train step with
    a handle raises ValueError naming gloo at its first call, before it
    runs anything; a capture that reaches a gloo collective (after
    CudaGraphed's eager warm-ups) raises the same; StreamAccumulator's
    push with the handle runs eagerly."""
    import socket

    from accflow_tpu_torch.parallel import mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), ACCFLOW_DISTRIBUTED="1").items():
        monkeypatch.setenv(k, v)
    assert mesh.maybe_init_distributed("cuda", backend="gloo")
    try:
        sp = mesh.Spatial(torch.distributed.group.WORLD, 0, 1)
        model, _, step, _, batches, _ = _graph_case(dev, "acc", True, spatial=sp)
        with pytest.raises(ValueError, match="gloo"):
            step(*batches[0], torch.Generator(device=dev).manual_seed(1))
        assert step.eager_calls == 0 and step.captures == 0
        summed = graphs.CudaGraphed(lambda x: mesh.sum_ranks(x, sp))
        with pytest.raises(ValueError, match="gloo"):
            summed(torch.ones(4, device=dev))
        assert summed.captures == 0
        stream = _handle_clip_and_stream(dev, sp)[3]
        assert not isinstance(stream._step, graphs.CudaGraphed)
    finally:
        torch.distributed.destroy_process_group()


def test_profiling_trace_on_the_card(dev, tmp_path):
    """profiling.trace around a 64^2 RAFT forward writes a Chrome trace that
    names kernel #1's CUDA kernel (corr_window), with device time in its
    key_averages."""
    from accflow_tpu_torch.utils import profiling

    est = build_flow_estimator("raft", compute_dtype="bfloat16", iters=3, device=dev)
    i1, i2 = (torch.rand((1, 64, 64, 3), device=dev) * 2 - 1 for _ in range(2))
    with torch.no_grad():
        est.forward(i1, i2)
        with profiling.trace(str(tmp_path / "tr")) as prof:
            est.forward(i1, i2)
    assert "corr_window" in (tmp_path / "tr" / "trace.json").read_text()
    rows = [e for e in prof.key_averages() if "corr_window" in e.key]
    assert sum(e.count for e in rows) == 3
    assert sum(getattr(e, "self_device_time_total", 0) for e in rows) > 0


def test_device_prefetch_copies_to_the_card(dev):
    """device_prefetch hands over batches already on the card, equal to
    their numpy source, while the consumer captures and replays a graph
    between them (the copies wait for a capture: graphs.CAPTURE_LOCK)."""
    from accflow_tpu_torch.data.prefetch import device_prefetch

    batches = [{"a": np.full((4, 8), i, np.float32)} for i in range(6)]
    double = graphs.CudaGraphed(lambda x: x * 2)
    for i, b in enumerate(device_prefetch(iter(batches), depth=2, device=dev)):
        want = torch.from_numpy(batches[i]["a"])
        assert b["a"].is_cuda and torch.equal(b["a"].cpu(), want)
        assert torch.equal(double(b["a"]).cpu(), 2 * want)
    assert double.captures == 1


# ---------------------------------------------------------------------------
# The estimator options: corr_levels and corr_radius at any level count and
# radius (kernel #2's, the backward kernel's and kernel #3's builds for them)
# ---------------------------------------------------------------------------

# (radius, levels) builds of kernel #2 and its backward: JAX's examples (3, 3),
# (2, 2), (5, 6) and RAFT-small at 3 levels (3, 3), radius 4 over 3 levels,
# and (12, 6), whose block fits shared memory at 4 queries, not 8.
OPTION_BUILDS = [(3, 3), (2, 2), (6, 5), (4, 3), (12, 6)]


def _levels_case(dev, b, h, w, levels, spread, dtype=torch.float32, seed=0):
    """_case at `levels` levels: level 0 h x w, each next one pooled (to 0 x 0
    where a map runs out)."""
    gen = torch.Generator().manual_seed(seed)
    q = b * h * w
    maps = [torch.randn((q, h >> l, w >> l), generator=gen).to(dtype).to(dev)
            for l in range(levels)]
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    grid = torch.stack([xs, ys], -1).float().expand(b, h, w, 2).reshape(q, 2)
    coords = grid + (torch.rand((q, 2), generator=gen) * 2 - 1) * spread
    return maps, coords.contiguous().to(dev)


@pytest.mark.parametrize("radius,levels", OPTION_BUILDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16), (3, 8, 12)])
def test_level_kernel_at_any_radius_and_levels(dev, radius, levels, dtype, shape):
    """Kernel #2 built for (radius, levels) (corr_level_cuda.defines) against
    the plain lookup, float32 and bfloat16 output (the bfloat16 one the
    float32 one cast bit for bit); 8 x 12 over 5 or 6 levels pools to 1 x 1
    and 0 x 0, which give zeros; one launch counted for its build."""
    maps, coords = _levels_case(dev, *shape, levels, spread=20, dtype=dtype)
    ref = lookup_corr_plain(maps, coords, radius)
    before = corr_level_cuda.build_launches.get((radius, levels), 0)
    got32 = corr_level_cuda.lookup_corr_level(maps, coords, radius)
    got = corr_level_cuda.lookup_corr_level(maps, coords, radius, torch.bfloat16)
    torch.cuda.synchronize()
    assert corr_level_cuda.build_launches[radius, levels] == before + 2
    assert got32.shape == (coords.shape[0], levels * (2 * radius + 1) ** 2)
    np.testing.assert_allclose(got32.cpu().numpy(), ref.cpu().numpy(), **TOL)
    assert torch.equal(got.view(torch.int16), got32.to(torch.bfloat16).view(torch.int16))
    taps = (2 * radius + 1) ** 2
    for l, m in enumerate(maps):
        if m.shape[1] == 0 or m.shape[2] == 0:
            assert not got32[:, l * taps:(l + 1) * taps].any()


def test_level_kernel_refuses_what_no_block_holds(dev):
    """A radius whose patches outgrow shared memory at one query a block
    raises by name, with the limit, before any build; a library built for
    one radius refuses another."""
    with pytest.raises(ValueError, match=f"beyond the {corr_level_cuda.SMEM_LIMIT} B"):
        corr_level_cuda.defines(30, 16)
    maps, coords = _levels_case(dev, 1, 8, 8, 3, spread=2)
    with pytest.raises(ValueError, match="built for radius 3"):
        corr_level_cuda.launch(corr_level_cuda.library(3, 3), maps, coords, 2)


@pytest.mark.parametrize("radius,levels", OPTION_BUILDS[:3])
@pytest.mark.parametrize("level_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_at_any_radius_and_levels(dev, radius, levels, level_dtype, grad_dtype):
    """The backward kernel's build for (radius, levels) against the plain
    backward at test_backward_kernel_matches_plain's bars, coords on a 1/256
    grid, 37 queries: an odd level count makes each query's window gradient
    an odd number of values (4-byte pieces of float32, a register-staged copy
    of bfloat16), and an odd Q starts odd rows mid-vector; one launch
    counted for its build."""
    gen = torch.Generator().manual_seed(3)
    q = 37
    shapes = [(34 >> l, 36 >> l) for l in range(levels)]
    coords = torch.round((torch.rand((q, 2), generator=gen) * 48 - 6) * 256).div(256).to(dev)
    grad = torch.randn((q, levels * (2 * radius + 1) ** 2), generator=gen).to(grad_dtype).to(dev)
    hw = [d for s in shapes for d in s]
    op = corr_backward_cuda.corr_level_lookup_backward_op
    before = corr_backward_cuda.level_build_launches.get((radius, levels), 0)
    ref = lookup_corr_plain_backward(grad, coords, shapes, radius)
    got32 = op(grad, coords, hw, radius, torch.float32)
    got = op(grad, coords, hw, radius, level_dtype)
    torch.cuda.synchronize()
    assert corr_backward_cuda.level_build_launches[radius, levels] == before + 2
    scale = max(float(r.abs().max()) for r in ref if r.numel())
    for g, g32, r in zip(got, got32, ref):
        assert g.dtype == level_dtype and g.shape == r.shape
        if level_dtype == torch.float32:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6 * scale)
        else:
            assert torch.equal(g.view(torch.int16), g32.to(torch.bfloat16).view(torch.int16))
            assert bool(((g.float() - r).abs() <= 1e-6 * scale + 2 ** -8 * r.abs()).all())


@pytest.mark.parametrize("num", [5, 7, 13, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(37, 16, 16), (9, 64, 64), (5, 70, 33)])
def test_y_contract_at_any_taps(dev, num, dtype, shape):
    """Kernel #3 built for `num` taps (2r+1; corr_bd_cuda.defines) against
    its plain twin, float32 and bfloat16 output: bfloat16 maps 16 and 64
    wide take the MMA path up to 16 taps (17: narrow), the rest narrow."""
    q, hl, wl = shape
    gen = torch.Generator().manual_seed(num)
    corr3 = torch.randn(shape, generator=gen).to(dtype).to(dev)
    wy = torch.rand((q, num, hl), generator=gen).to(dtype).to(dev)
    lib = corr_bd_cuda.library(num)
    mma = dtype == torch.bfloat16 and wl in (16, 64) and num <= 16
    assert corr_bd_cuda.path(lib, corr3) == ("mma" if mma else "narrow")
    before = corr_bd_cuda.build_launches.get(num, 0)
    got32 = corr_bd_cuda.y_contract(corr3, wy)
    got = corr_bd_cuda.y_contract(corr3, wy, torch.bfloat16)
    torch.cuda.synchronize()
    assert corr_bd_cuda.build_launches[num] == before + 2
    ref = corr_bd_cuda.y_contract_plain(corr3, wy)
    assert got32.shape == (q, num, wl)
    np.testing.assert_allclose(got32.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(got.view(torch.int16), got32.to(torch.bfloat16).view(torch.int16))


# Estimators at the options JAX takes (its build_flow_estimator gave a finite
# flow for each at 64^2): (name, overrides, kernel module, its build's key).
OPTION_MODELS = {
    "raft (3, 3)": ("raft", dict(corr_levels=3, corr_radius=3), corr_level_cuda, (3, 3)),
    "raft (2, 2)": ("raft", dict(corr_levels=2, corr_radius=2), corr_level_cuda, (2, 2)),
    "raft (5, 6)": ("raft", dict(corr_levels=5, corr_radius=6), corr_level_cuda, (6, 5)),
    "raft-small 3 levels": ("raft", dict(small=True, corr_levels=3), corr_level_cuda, (3, 3)),
    "gma (3, 3)": ("gma", dict(corr_levels=3, corr_radius=3), corr_level_cuda, (3, 3)),
    "raft (3, 3) fused_bd": ("raft", dict(corr_levels=3, corr_radius=3,
                                          corr_lookup="experimental:fused_bd"), corr_bd_cuda, 7),
    "raft (3, 3) ondemand:16": ("raft", dict(corr_levels=3, corr_radius=3,
                                             corr_lookup="ondemand:16"), corr_level_cuda, (3, 3)),
}


def _option_flow(where, name, kw):
    est = build_flow_estimator(name, compute_dtype="float32", iters=3, device=where, **kw)
    if name == "gma":
        with torch.no_grad():
            est.model.update_block.aggregator.gamma.fill_(3.0)
    rng = np.random.default_rng(7)
    i1, i2 = (rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32) for _ in range(2))
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return est.forward(i1, i2)["flow_up"].cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("case", list(OPTION_MODELS))
def test_estimator_options_gpu_match_cpu_through_their_build(dev, case):
    """Each option's f32 forward (3 iterations, 64^2) on the card against
    the CPU (plain versions) within 1e-3 of the largest |flow| (chip_smoke's
    CLIP_REL), reaching its build's kernel: 3 launches of kernel #2's
    (radius, levels) build (12 for ondemand:16's four chunks of the 8 x 8
    queries), 3 of kernel #3 at 7 taps for fused_bd, and none of kernel
    #1."""
    name, kw, module, key = OPTION_MODELS[case]
    counts = module.build_launches
    before = (counts.get(key, 0), corr_cuda.launches)
    got = _option_flow(dev, name, kw)
    want = 12 if "ondemand" in case else 3
    assert (counts.get(key, 0) - before[0], corr_cuda.launches - before[1]) == (want, 0)
    ref = _option_flow("cpu", name, kw)
    assert np.isfinite(got).all() and float(np.abs(ref).max()) > 0
    assert float(np.abs(got - ref).max()) <= 1e-3 * float(np.abs(ref).max())


def test_finetune_step_at_3_levels_radius_3_gpu_matches_cpu(dev, monkeypatch):
    """test_finetune_step_gpu_matches_cpu at corr_levels 3, corr_radius 3:
    kernel #2's (3, 3) build and its backward build, 12 launches each, none
    of kernel #1's; the same bars."""
    real = build_flow_estimator
    monkeypatch.setitem(globals(), "build_flow_estimator",
                        lambda *a, **k: real(*a, corr_levels=3, corr_radius=3, **k))
    out = {}
    recorded = None
    for where in (dev, "cpu"):
        est, train_step, batch, grads = _finetune_case(where)
        assert est.model.cfg.corr_planes == 3 * 49
        recorded = tie_hooks(est.model, recorded)[0]
        before = (corr_level_cuda.build_launches.get((3, 3), 0),
                  corr_backward_cuda.level_build_launches.get((3, 3), 0), corr_cuda.launches)
        loss, _ = train_step(*batch)
        after = (corr_level_cuda.build_launches.get((3, 3), 0),
                 corr_backward_cuda.level_build_launches.get((3, 3), 0), corr_cuda.launches)
        want = [12, 12, 0] if where == dev else [0, 0, 0]
        assert [a - b for a, b in zip(after, before)] == want
        out[str(where)] = float(loss), grads
    (loss_g, g), (loss_c, c) = out[str(dev)], out["cpu"]
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for part in ("fnet.", "cnet.", "update_block."):
        keys = [k for k in c if k.startswith(part)]
        num = sum(float(((g[k] - c[k]) ** 2).sum()) for k in keys)
        assert (num / sum(float((c[k] ** 2).sum()) for k in keys)) ** 0.5 <= 1e-4, part


@pytest.mark.parametrize("encoder", ["basic", "small"])
def test_group_norm_encoders_gpu_match_cpu(dev, encoder):
    """The encoders with norm_fn "group" on the card against the CPU, f32
    (TF32 off), within 1e-5 of the largest |output| (cuDNN's convs against
    the CPU's, summation order apart), and one bfloat16 call finite."""
    from accflow_tpu_torch.models.encoders import BasicEncoder, SmallEncoder
    from accflow_tpu_torch.nn.layers import init_weights, tf32

    enc = init_weights((BasicEncoder if encoder == "basic" else SmallEncoder)(64, "group"), 0)
    with torch.no_grad():
        for m in enc.modules():
            if hasattr(m, "num_groups"):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 3, 64, 48)).astype(np.float32))
    with torch.no_grad(), tf32(False):
        ref = enc(x)
        got = enc.to(dev)(x.to(dev)).cpu()
        bf = enc(x.to(dev).to(torch.bfloat16))
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert bf.dtype == torch.bfloat16 and bool(torch.isfinite(bf).all())


# ---------------------------------------------------------------------------
# The spatial axis: two gloo ranks on the card, each on its rows of the image
# ---------------------------------------------------------------------------

SPATIAL_LOOKUPS = {"fused": 1, "ondemand:16": 2}  # chunks of a rank's 32 queries


def _spatial_forward(lookup: str, sp, counts: dict) -> torch.Tensor:
    """Full RAFT (seed 0, 2 iterations, float32, TF32 off) on a 64^2 pair
    from seed 9, on this rank's rows (sp) or the whole pair (None); records
    kernel #1's launches in `counts`. Returns the flow's rows."""
    from accflow_tpu_torch.nn.layers import tf32
    from accflow_tpu_torch.parallel import mesh

    est = build_flow_estimator("raft", compute_dtype="float32", iters=2, corr_lookup=lookup)
    pair = torch.rand((2, 1, 64, 64, 3), generator=torch.Generator().manual_seed(9)) * 2 - 1
    rows = mesh.shard_rows(pair.cuda(), sp, 2)
    before = corr_cuda.launches
    with tf32(False):
        flow = est.forward(rows[0], rows[1], spatial=sp)["flow_up"]
    counts[lookup] = corr_cuda.launches - before
    return flow.cpu()


def _spatial_child(rank: int, port: int, work: str) -> None:
    """One rank: join a gloo group with CUDA tensors (NCCL puts no two ranks
    on one card), make the (1, 2) mesh, run both lookups, save the rows."""
    from accflow_tpu_torch.parallel import mesh

    os.environ.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    assert mesh.maybe_init_distributed("cuda", backend="gloo")
    sp = mesh.make_mesh(n_data=1, n_spatial=2).axis
    counts = {}
    out = {lk: _spatial_forward(lk, sp, counts) for lk in SPATIAL_LOOKUPS}
    torch.save({"out": out, "launches": counts}, f"{work}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def spatial_ranks(tmp_path_factory):
    """Both ranks' rows and launches (a time limit: a deadlocked collective
    fails instead of hanging)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the lookup kernel has no CPU mode")
    import socket

    work = str(tmp_path_factory.mktemp("spatial_cuda"))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "spatial-child",
                               str(r), str(port), work], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(f"{work}/rank{r}.pt") for r in range(2)]


@pytest.mark.parametrize("lookup", list(SPATIAL_LOOKUPS))
def test_spatial_raft_two_ranks_match_one_process(dev, spatial_ranks, lookup):
    """The two ranks' rows, put together, within 1e-3 of the largest |flow|
    of the same forward in one process on the card (float32, TF32 off:
    summation order only, as the GPU against the CPU)."""
    one = _spatial_forward(lookup, None, {})
    got = torch.cat([r["out"][lookup] for r in spatial_ranks], dim=1)
    assert got.shape == one.shape == (1, 64, 64, 2)
    assert float((got - one).abs().max()) <= 1e-3 * float(one.abs().max())


@pytest.mark.parametrize("lookup", list(SPATIAL_LOOKUPS))
def test_spatial_kernel_1_launches_per_rank(dev, spatial_ranks, lookup):
    """Each rank launches kernel #1 once per iteration and chunk of its own
    queries: 2 for "fused", as one process; 4 for "ondemand:16" (2 chunks of
    a rank's 32 queries, one process's 64 make 4)."""
    counts = {}
    _spatial_forward(lookup, None, counts)
    want = 2 * SPATIAL_LOOKUPS[lookup]
    assert [r["launches"][lookup] for r in spatial_ranks] == [want, want]
    assert counts[lookup] == 2 * (64 // 16 if lookup != "fused" else 1)


if __name__ == "__main__" and sys.argv[1:2] == ["spatial-child"]:
    _spatial_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
