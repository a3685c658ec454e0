"""The correlation lookups' CUDA kernels (the 4-level radius-4 kernel of
ops/corr_cuda.py and the per-level kernel of ops/corr_level_cuda.py)
against their plain version, on the GPU. Marked `cuda`; each test skips
where there is no GPU (no kernel can run there). This file imports neither
JAX nor the JAX package, so it runs on a machine with only torch:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

The kernels share one fractional offset over each window's taps where the
plain version recomputes it per tap; at these coordinates (|x| < 64) and
unit-normal maps the difference stays below 1e-4."""

import numpy as np
import pytest
import torch

from accflow_tpu_torch.ops import corr_cuda, corr_level_cuda
from accflow_tpu_torch.ops.corr import lookup_corr_plain

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
