"""The port's CUDA kernels against their plain versions, on the GPU: the
4-level radius-4 lookup (ops/corr_cuda.py), the per-level lookup
(ops/corr_level_cuda.py, also built for one level and with 4 and 16
queries per block), both with float32 and bfloat16 output, the y
contraction of the split lookup (ops/corr_bd_cuda.py) and the floor kernel of the probes
(probes.py); the CUDA graphs of the stream step (StreamAccumulator) and of a
loaded artifact (serving.py, streaming.py), and the splat's determinism;
GMA's small clip on the GPU against the CPU with kernels #1 and #3, and
FlowPipeline on the GPU.
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
from accflow_tpu_torch.ops import corr_bd_cuda, corr_cuda, corr_level_cuda, softsplat
from accflow_tpu_torch.ops.corr import lookup_corr_plain, lookup_corr_split_v2
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
