"""The split lookup of the PyTorch port (`experimental:fused_bd[2]`) against
JAX on the CPU: the y contraction's plain twin against the Pallas kernel
`y_contract_bd` (interpret mode), `lookup_corr_split_v2`, the motion
encoder's `forward_split`, and RAFT with both spellings, float32, same
weights. Inputs are numpy from a seed.

Tolerances: y contraction 1e-5 for float32 (the same products summed in
another order) and 1e-4 for bfloat16 inputs (exact bfloat16 products, float32
sums in another order, values up to ~30); lookup and motion encoder 1e-4 /
1e-5 as the JAX package holds its lookups to each other
(tests/test_ops_golden.py:615-640); RAFT rtol 1e-3 / atol 5e-3, the bar the
JAX package meets against the PyTorch original."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu import ops as j_ops
from accflow_tpu.models.raft import RAFTConfig as JRAFTConfig
from accflow_tpu.models.raft import basic_motion_encoder_split as j_motion_split
from accflow_tpu.models.raft import init_raft as j_init_raft
from accflow_tpu.models.raft import raft_forward as j_raft_forward
from accflow_tpu.ops.corr import lookup_corr_split_v2 as j_split_v2
from accflow_tpu.ops.corr_pallas import y_contract_bd
from accflow_tpu_torch.convert import load_jax_params, to_jax_params
from accflow_tpu_torch.models import build_flow_estimator
from accflow_tpu_torch.models.raft import BasicMotionEncoder, RAFTConfig
from accflow_tpu_torch.nn.layers import init_weights
from accflow_tpu_torch.ops import corr_bd_cuda
from accflow_tpu_torch.ops.corr import (
    build_corr_pyramid,
    lookup_corr_split_v2,
    normalize_corr_lookup,
    resolve_auto_lookup,
    window_weights,
)

BF16 = {"float32": (np.float32, torch.float32, 1e-5),
        "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-4)}


@pytest.mark.parametrize("hw", [(8, 8), (16, 8), (4, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_y_contract_plain_matches_pallas(hw, dtype):
    hl, wl = hw
    rng = np.random.default_rng(hl * 100 + wl)
    corr = rng.standard_normal((256, hl, wl)).astype(np.float32)
    wy = rng.standard_normal((256, 9, hl)).astype(np.float32)
    jdt, tdt, tol = BF16[dtype]
    ref = y_contract_bd(jnp.asarray(corr).astype(jdt), jnp.asarray(wy).astype(jdt),
                        interpret=True)
    out = corr_bd_cuda.y_contract(torch.from_numpy(corr).to(tdt), torch.from_numpy(wy).to(tdt))
    assert out.dtype == torch.float32 and tuple(out.shape) == (256, 9, wl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=tol)


def test_y_contract_wrapper_checks():
    corr = torch.zeros((4, 6, 5))
    with pytest.raises(ValueError, match="wy must be"):
        corr_bd_cuda.y_contract(corr, torch.zeros((4, 9, 5)))
    with pytest.raises(ValueError, match="both be float32 or both bfloat16"):
        corr_bd_cuda.y_contract(corr, torch.zeros((4, 9, 6), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="no y contraction for device"):
        corr_bd_cuda.y_contract(corr.to("meta"), torch.zeros((4, 9, 6), device="meta"))
    before = corr_bd_cuda.launches
    out = corr_bd_cuda.y_contract(torch.zeros((0, 6, 5)), torch.zeros((0, 9, 6)))
    assert tuple(out.shape) == (0, 9, 5) and corr_bd_cuda.launches == before


def test_window_weights_match_jax(rng):
    centers = rng.uniform(-3, 12, (64, 9)).astype(np.float32)
    from accflow_tpu.ops.corr import _window_weights as j_window_weights

    np.testing.assert_allclose(window_weights(torch.from_numpy(centers), 10).numpy(),
                               np.asarray(j_window_weights(jnp.asarray(centers), 10)),
                               rtol=0, atol=1e-6)


def _pyramids(rng, b, h, w, c, spread):
    f1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    coords = (np.asarray(j_ops.coords_grid(b, h, w))
              + rng.uniform(-spread, spread, (b, h, w, 2)).astype(np.float32))
    j_pyr = j_ops.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), num_levels=4)
    levels = build_corr_pyramid(torch.from_numpy(np.moveaxis(f1, -1, 1)),
                                torch.from_numpy(np.moveaxis(f2, -1, 1)), 4)
    return j_pyr, levels, coords


@pytest.mark.parametrize("level_impl", [("bd", "mm", "mm", "mm"), ("bd", "bd", "mm", "mm")])
def test_lookup_corr_split_v2_matches_jax(rng, level_impl):
    """Coords spread +-20 px so many taps fall outside the maps; 16^2
    features pool to 8^2, 4^2, 2^2."""
    j_pyr, levels, coords = _pyramids(rng, 2, 16, 16, 16, 20)
    ref = j_split_v2(j_pyr, jnp.asarray(coords), 4, precision="highest",
                     level_impl=level_impl)
    out = lookup_corr_split_v2(levels, torch.from_numpy(coords), 4, level_impl)
    assert len(out) == 4
    for o, r in zip(out, ref):
        assert tuple(o.shape) == (2, 16, 16, 9, 9)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_split_windows_equal_plain_lookup(rng):
    """The split windows, flattened level-major a*9 + b, are the plain
    lookup's (Q, 324) row: the same function as kernel #1."""
    from accflow_tpu_torch.ops.corr import lookup_corr_plain

    _, levels, coords = _pyramids(rng, 1, 16, 16, 8, 20)
    parts = lookup_corr_split_v2(levels, torch.from_numpy(coords), 4, ("bd", "bd", "mm", "mm"))
    flat = torch.cat([p.reshape(256, 81) for p in parts], dim=1)
    plain = lookup_corr_plain(levels, torch.from_numpy(coords.reshape(-1, 2)), 4)
    np.testing.assert_allclose(flat.numpy(), plain.numpy(), rtol=1e-4, atol=1e-4)


def test_split_lookup_rejects_unported_level_impl(rng):
    _, levels, coords = _pyramids(rng, 1, 8, 8, 8, 2)
    with pytest.raises(ValueError, match="'vpu_y' is not ported"):
        lookup_corr_split_v2(levels, torch.from_numpy(coords), 4, ("vpu_y",))


def test_forward_split_matches_jax(rng):
    enc = init_weights(BasicMotionEncoder(324), seed=5).eval()
    p = to_jax_params(enc)
    flow = rng.standard_normal((2, 8, 8, 2)).astype(np.float32)
    parts = [rng.standard_normal((2, 8, 8, 9, 9)).astype(np.float32) for _ in range(4)]
    ref = j_motion_split(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(flow),
                         [jnp.asarray(x) for x in parts])
    with torch.no_grad():
        out = enc.forward_split(torch.from_numpy(flow).permute(0, 3, 1, 2),
                                [torch.from_numpy(x) for x in parts])
        flat = torch.from_numpy(np.concatenate([x.reshape(2, 8, 8, 81) for x in parts], -1))
        whole = enc(torch.from_numpy(flow).permute(0, 3, 1, 2), flat.permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def raft_setup():
    params = j_init_raft(jax.random.PRNGKey(0), JRAFTConfig(compute_dtype="float32"))
    frames = np.random.default_rng(0).uniform(-1, 1, (2, 1, 64, 64, 3)).astype(np.float32)
    return params, frames


@pytest.mark.parametrize("lookup", ["experimental:fused_bd", "experimental:fused_bd2"])
def test_raft_forward_split_lookup_matches_jax(raft_setup, lookup):
    params, frames = raft_setup
    cfg = JRAFTConfig(compute_dtype="float32", corr_lookup=lookup)
    ref = j_raft_forward(params, jnp.asarray(frames[0]), jnp.asarray(frames[1]), cfg,
                         iters=2, final_only=True)
    est = build_flow_estimator("raft", compute_dtype="float32", device="cpu",
                               corr_lookup=lookup)
    load_jax_params(est.model, params)
    out = est.forward(frames[0], frames[1], iters=2, final_only=True)
    for key in ("flow_up", "flow_low"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-3, atol=5e-3, err_msg=key)


@pytest.mark.parametrize("spelling,want", [
    ("fused", "fused"), ("mm", "fused"), ("pallas_fused", "fused"),
    ("experimental:fused_bd", "fused_bd"), ("experimental:fused_bd2", "fused_bd2"),
    ("auto", "auto"),
])
def test_normalize_corr_lookup(spelling, want):
    assert normalize_corr_lookup(spelling) == want


def test_corr_lookup_fence():
    with pytest.raises(ValueError, match="experimental:fused_bd"):
        RAFTConfig(corr_lookup="fused_bd")
    for spelling in ("ondemand", "ondemand:4096"):
        with pytest.raises(NotImplementedError, match="queue 1 #11"):
            RAFTConfig(corr_lookup=spelling)
    # "auto" is kernel #1's lookup within the stored volume's budget and
    # raises beyond it, where JAX picks the unported ondemand lookup.
    assert RAFTConfig(corr_lookup="auto").split_levels is None
    with pytest.raises(NotImplementedError, match="queue 1 #11"):
        resolve_auto_lookup("auto", 64, 64, 64)
    with pytest.raises(NotImplementedError, match="not ported"):
        RAFTConfig(corr_lookup="experimental:packed2")
    assert RAFTConfig(corr_lookup="experimental:fused_bd2").split_levels == ("bd", "bd", "mm", "mm")
    assert RAFTConfig(corr_lookup="mm").split_levels is None
    # RAFT-small keeps its per-level kernel whatever the spelling.
    assert RAFTConfig(small=True, corr_lookup="experimental:fused_bd").split_levels is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_y_contract_bf16_out_is_the_f32_output_cast(dtype):
    """out_dtype=bfloat16 rounds the float32 sums once: bit for bit the
    float32 output cast; the CPU wrapper routes out_dtype to the twin."""
    gen = torch.Generator().manual_seed(7)
    corr = torch.randn((32, 12, 10), generator=gen).to(dtype)
    wy = torch.randn((32, 9, 12), generator=gen).to(dtype)
    f32 = corr_bd_cuda.y_contract_plain(corr, wy)
    bf = corr_bd_cuda.y_contract_plain(corr, wy, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf.view(torch.int16), f32.to(torch.bfloat16).view(torch.int16))
    before = corr_bd_cuda.launches
    got = corr_bd_cuda.y_contract(corr, wy, torch.bfloat16)
    assert torch.equal(got.view(torch.int16), bf.view(torch.int16))
    assert corr_bd_cuda.launches == before
    with pytest.raises(ValueError, match="out_dtype"):
        corr_bd_cuda.y_contract(corr, wy, torch.float16)


@pytest.mark.parametrize("out_elem", [4, 2])
def test_y_contract_bound_counts_the_output_bytes(out_elem):
    from accflow_tpu_torch import probes

    corr = torch.zeros((10, 64, 32), dtype=torch.bfloat16)
    ms, by, nbytes = probes.y_contract_bound(corr, out_elem)
    assert nbytes == 10 * (64 * 32 * 2 + 9 * 64 * 2 + 9 * 32 * out_elem)
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / probes.H100_BYTES_PER_S)


@pytest.mark.parametrize("level_impl", [("bd", "mm", "mm", "mm"), ("bd", "bd", "mm", "mm")])
def test_lookup_corr_split_v2_bf16_matches_jax(rng, level_impl):
    """bfloat16 levels: the port multiplies the bf16 operands as they are
    (float32 sums, rounded once to bf16), JAX at default precision with
    float32 output. Both round tmp to bf16 before the x contraction; the
    port also rounds the window: <= 2^-8 of |window| apart from that, plus
    tmp's rounding moved by a different summation order (one bf16 ulp of
    |tmp|, carried through the 2-tap x blend). Bar: 2^-7 x max |window|."""
    j_pyr, levels, coords = _pyramids(rng, 2, 16, 16, 16, 20)
    j_bf = j_pyr._replace(levels=[l.astype(jnp.bfloat16) for l in j_pyr.levels])
    ref = j_split_v2(j_bf, jnp.asarray(coords), 4, precision="default", level_impl=level_impl)
    out = lookup_corr_split_v2([l.bfloat16() for l in levels], torch.from_numpy(coords), 4,
                               level_impl, torch.bfloat16)
    for o, r in zip(out, ref):
        assert o.dtype == torch.bfloat16 and tuple(o.shape) == (2, 16, 16, 9, 9)
        r = np.asarray(r).astype(np.float32)
        np.testing.assert_allclose(o.float().numpy(), r, rtol=0,
                                   atol=2.0 ** -7 * float(np.abs(r).max()))


def test_contract_reduces_bf16_in_float32(monkeypatch):
    """The split path's GEMMs run with cuBLAS's reduced-precision bfloat16
    reductions off (float32 sums, as the docstring says) and TF32 off, and
    both process-wide switches are restored afterwards."""
    from accflow_tpu_torch.ops import corr as corr_mod

    matmul = torch.backends.cuda.matmul
    seen = []
    real_bmm = torch.bmm

    def spy(a, b):
        seen.append((matmul.allow_bf16_reduced_precision_reduction, matmul.allow_tf32))
        return real_bmm(a, b)

    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction", True)
    monkeypatch.setattr(corr_mod.torch, "bmm", spy)
    a = torch.ones((2, 9, 4), dtype=torch.bfloat16)
    out = corr_mod._contract(a, torch.ones((2, 4, 3), dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and bool((out == 4).all())
    assert seen == [(False, False)]
    assert matmul.allow_bf16_reduced_precision_reduction is True
