"""Correlation pyramid and plain window lookup of the PyTorch port against
JAX: `build_corr_pyramid`, `lookup_corr_gather`, and the fused Pallas
kernel `lookup_corr_fused_from_pyramid` in interpret mode with float32
streaming. Coords are spread +-20 px so that many taps fall outside the
maps. Tolerance 1e-4, as the JAX package holds its own lookups to each
other (tests/test_ops_golden.py:615-640)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu import ops as j_ops
from accflow_tpu.ops.corr_pallas import lookup_corr_fused_from_pyramid
from accflow_tpu_torch.ops import corr_cuda
from accflow_tpu_torch.ops.corr import build_corr_pyramid, lookup_corr_plain

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(rng, b, h, w, c, spread):
    f1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    coords = (np.asarray(j_ops.coords_grid(b, h, w))
              + rng.uniform(-spread, spread, (b, h, w, 2)).astype(np.float32))
    j_pyr = j_ops.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), num_levels=4)
    levels = build_corr_pyramid(torch.from_numpy(np.moveaxis(f1, -1, 1)),
                                torch.from_numpy(np.moveaxis(f2, -1, 1)), 4)
    return j_pyr, levels, coords


def test_build_corr_pyramid(rng):
    j_pyr, levels, _ = _inputs(rng, 2, 16, 16, 16, 20)
    assert [tuple(l.shape) for l in levels] == [(512, 16, 16), (512, 8, 8),
                                                (512, 4, 4), (512, 2, 2)]
    for lvl, ref in zip(levels, j_pyr.levels):
        np.testing.assert_allclose(lvl.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("reference", ["gather", "pallas_fused"])
def test_plain_lookup_matches_jax(rng, reference):
    j_pyr, levels, coords = _inputs(rng, 2, 16, 16, 16, 20)
    jc = jnp.asarray(coords)
    if reference == "gather":
        ref = j_ops.lookup_corr_gather(j_pyr, jc, radius=4)
    else:
        ref = lookup_corr_fused_from_pyramid(j_pyr, jc, radius=4,
                                             stream_dtype=jnp.float32)
    out = lookup_corr_plain(levels, torch.from_numpy(coords.reshape(-1, 2)), 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(512, 324), **TOL)


def test_zero_sized_level(rng):
    """4x4 features pool to 2x2, 1x1 and 0x0: the last level's taps are
    zero rows (JAX fix b39b14d)."""
    j_pyr, levels, coords = _inputs(rng, 1, 4, 4, 8, 2)
    assert tuple(levels[3].shape) == (16, 0, 0)
    ref = np.asarray(j_ops.lookup_corr_gather(j_pyr, jnp.asarray(coords), 4)).reshape(16, 324)
    out = lookup_corr_plain(levels, torch.from_numpy(coords.reshape(-1, 2)), 4)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert not out[:, 243:].any()


def test_wrapper_on_cpu_takes_plain_lookup(rng):
    _, levels, coords = _inputs(rng, 1, 8, 8, 8, 20)
    c = torch.from_numpy(coords.reshape(-1, 2))
    before = corr_cuda.launches
    np.testing.assert_array_equal(corr_cuda.lookup_corr_fused(levels, c).numpy(),
                                  lookup_corr_plain(levels, c).numpy())
    assert corr_cuda.launches == before  # the count is of kernel launches only
    # bf16 levels: the values are read as bf16 and blended in float32.
    bf = [l.bfloat16() for l in levels]
    np.testing.assert_array_equal(
        corr_cuda.lookup_corr_fused(bf, c).numpy(),
        lookup_corr_plain([l.float() for l in bf], c).numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    _, levels, coords = _inputs(rng, 1, 8, 8, 8, 20)
    c = torch.from_numpy(coords.reshape(-1, 2))
    bad = [
        (levels, c, 3),                                   # radius
        (levels + levels[:1], c, 4),                      # 5 levels
        (levels[:3], c, 4),                               # 3 levels
        (levels, c.double(), 4),                          # coords dtype
        (levels, c.t().contiguous().t(), 4),              # non-contiguous coords
        ([levels[0].transpose(1, 2)] + levels[1:], c, 4),  # non-contiguous level
        ([levels[0].half()] + levels[1:], c, 4),          # level dtype
        ([levels[0].bfloat16()] + levels[1:], c, 4),      # mixed dtypes
        ([l[:-1] for l in levels], c, 4),                 # Q mismatch
    ]
    for lv, cc, r in bad:
        with pytest.raises(ValueError):
            corr_cuda.lookup_corr_fused(lv, cc, r)
