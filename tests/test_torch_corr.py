"""Correlation pyramid and plain window lookup of the PyTorch port against
JAX: `build_corr_pyramid`, `lookup_corr_gather`, the fused Pallas kernel
`lookup_corr_fused_from_pyramid` and the per-level Pallas kernel
`lookup_corr_pallas`, both in interpret mode with float32 streaming.
Coords are spread +-20 px so that many taps fall outside the maps.
Tolerance 1e-4 against the fused kernel and the gather, as the JAX package
holds its own lookups to each other (tests/test_ops_golden.py:615-640);
1e-5 against the per-level kernel, which computes the same float32 blend
of the same taps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu import ops as j_ops
from accflow_tpu.ops.corr_pallas import lookup_corr_fused_from_pyramid, lookup_corr_pallas
from accflow_tpu_torch.ops import corr_cuda, corr_level_cuda
from accflow_tpu_torch.ops.corr import build_corr_pyramid, lookup_corr_plain


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs, restored after.
    The tests run in several worker processes on one machine; with torch's
    default of a thread per core in each, they oversubscribe its cores
    (tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("case", ["16x16", "4x4_zero_sized_level"])
def test_plain_lookup_matches_pallas_per_level(rng, radius, case):
    """The per-level kernel's plain version against JAX lookup_corr_pallas
    (interpret mode, storage dtype streamed). 4x4 features pool to a 0x0
    last level, whose taps are zero; the Pallas interpreter cannot run a
    0x0 block (ZeroDivisionError), so there the first three levels are held
    against the Pallas kernel and the last against lookup_corr_gather."""
    b, h, w, c, spread = (2, 16, 16, 16, 20) if case == "16x16" else (1, 4, 4, 8, 2)
    j_pyr, levels, coords = _inputs(rng, b, h, w, c, spread)
    jc = jnp.asarray(coords)
    q, taps = b * h * w, (2 * radius + 1) ** 2
    out = lookup_corr_plain(levels, torch.from_numpy(coords.reshape(-1, 2)), radius)
    assert tuple(out.shape) == (q, 4 * taps)
    if case == "16x16":
        ref = np.asarray(lookup_corr_pallas(j_pyr, jc, radius=radius, stream_dtype=None))
    else:
        assert tuple(levels[3].shape) == (16, 0, 0)
        head = lookup_corr_pallas(j_pyr._replace(levels=j_pyr.levels[:3]), jc,
                                  radius=radius, stream_dtype=None)
        tail = np.asarray(j_ops.lookup_corr_gather(j_pyr, jc, radius))[..., 3 * taps:]
        ref = np.concatenate([np.asarray(head), tail], axis=-1)
        assert not out[:, 3 * taps:].any()
    np.testing.assert_allclose(out.numpy(), ref.reshape(q, 4 * taps), rtol=1e-5, atol=1e-5)


def test_level_wrapper_on_cpu_takes_plain_lookup(rng):
    _, levels, coords = _inputs(rng, 1, 8, 8, 8, 20)
    c = torch.from_numpy(coords.reshape(-1, 2))
    before = corr_level_cuda.launches
    for radius in corr_level_cuda.RADII:
        np.testing.assert_array_equal(
            corr_level_cuda.lookup_corr_level(levels, c, radius).numpy(),
            lookup_corr_plain(levels, c, radius).numpy())
    assert corr_level_cuda.launches == before  # the count is of kernel launches only


def test_level_wrapper_rejects_what_the_kernel_does_not_take(rng):
    _, levels, coords = _inputs(rng, 1, 8, 8, 8, 20)
    c = torch.from_numpy(coords.reshape(-1, 2))
    bad = [
        (levels, c, -1),                                  # radius
        (levels * 5, c, 3),                               # level count: 20 > MAX_LEVELS
        ([], c, 3),                                       # no level
        (levels, c.double(), 3),                          # coords dtype
        (levels, c.t().contiguous().t(), 3),              # non-contiguous coords
        ([levels[0].transpose(1, 2)] + levels[1:], c, 3),  # non-contiguous level
        ([levels[0].half()] + levels[1:], c, 3),          # level dtype
        ([levels[0].bfloat16()] + levels[1:], c, 3),      # mixed dtypes
        ([l[:-1] for l in levels], c, 3),                 # Q mismatch
    ]
    for lv, cc, r in bad:
        with pytest.raises(ValueError):
            corr_level_cuda.lookup_corr_level(lv, cc, r)


def test_plain_lookup_bf16_out_is_the_f32_output_cast(rng):
    """out_dtype=bfloat16 rounds the float32 blend once: bit for bit the
    float32 output cast, for float32 and bfloat16 levels; the CPU wrapper
    routes out_dtype to the plain lookup."""
    _, levels, coords = _inputs(rng, 1, 8, 8, 8, 20)
    c = torch.from_numpy(coords.reshape(-1, 2))
    for lv in (levels, [l.bfloat16() for l in levels]):
        f32 = lookup_corr_plain(lv, c)
        bf = lookup_corr_plain(lv, c, 4, torch.bfloat16)
        assert f32.dtype == torch.float32 and bf.dtype == torch.bfloat16
        assert torch.equal(bf.view(torch.int16), f32.to(torch.bfloat16).view(torch.int16))
        before = corr_cuda.launches
        got = corr_cuda.lookup_corr_fused(lv, c, out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                           bf.view(torch.int16))
        assert corr_cuda.launches == before
    with pytest.raises(ValueError, match="out_dtype"):
        corr_cuda.lookup_corr_fused(levels, c, out_dtype=torch.float16)


@pytest.mark.parametrize("radius", [3, 4])
def test_level_wrapper_bf16_out_is_the_f32_output_cast(rng, radius):
    """The per-level wrapper's out_dtype=bfloat16 on CPU tensors takes the
    plain lookup and equals its float32 output cast bit for bit, for
    float32 and bfloat16 levels; other output types raise."""
    _, levels, coords = _inputs(rng, 1, 8, 8, 8, 20)
    c = torch.from_numpy(coords.reshape(-1, 2))
    for lv in (levels, [l.bfloat16() for l in levels]):
        before = corr_level_cuda.launches
        got = corr_level_cuda.lookup_corr_level(lv, c, radius, torch.bfloat16)
        f32 = lookup_corr_plain(lv, c, radius)
        assert got.dtype == torch.bfloat16 and got.shape == f32.shape
        assert torch.equal(got.view(torch.int16), f32.to(torch.bfloat16).view(torch.int16))
        assert corr_level_cuda.launches == before
    with pytest.raises(ValueError, match="out_dtype"):
        corr_level_cuda.lookup_corr_level(levels, c, radius, torch.float16)


@pytest.mark.parametrize("out_elem", [4, 2])
def test_lookup_bound_counts_the_output_bytes(out_elem):
    """Coords 8 B and the output at `out_elem` bytes a value per query, plus
    the patch cells inside each map: at (5.5, 5.5) on a 16^2 level 0 the
    10x10 patch from (1, 1) lies inside; on level 1 (8^2) the patch from
    (-2, -2) keeps 8 of its 10 rows and columns; levels 2 and 3 (4^2, 2^2)
    are covered whole."""
    from accflow_tpu_torch import probes

    levels = [torch.zeros((1, 16 >> l, 16 >> l), dtype=torch.bfloat16) for l in range(4)]
    coords = torch.tensor([[5.5, 5.5]])
    ms, by, nbytes = probes.lookup_bound(levels, coords, 4, out_elem)
    cells = 100 + 64 + 16 + 4
    assert nbytes == 8 + 324 * out_elem + cells * 2
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / probes.H100_BYTES_PER_S)
