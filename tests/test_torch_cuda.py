"""The port's CUDA kernels against their plain versions, on the GPU: the
4-level radius-4 lookup (ops/corr_cuda.py), the per-level lookup
(ops/corr_level_cuda.py, also built for one level), the y contraction of
the split lookup (ops/corr_bd_cuda.py) and the floor kernel of the probes
(probes.py). Marked `cuda`; each test skips where there is no GPU (no
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

from accflow_tpu_torch import probes
from accflow_tpu_torch.ops import corr_bd_cuda, corr_cuda, corr_level_cuda
from accflow_tpu_torch.ops.corr import lookup_corr_plain, lookup_corr_split_v2

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
