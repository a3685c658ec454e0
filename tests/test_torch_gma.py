"""GMA of the PyTorch port (accflow_tpu_torch/models/gma.py) against JAX's
(accflow_tpu/models/gma.py) on the CPU in float32, at full width on 32x48
frames, batch 2, 3 iterations, same weights (JAX init moved across with
load_jax_params). GMA's aggregator starts with gamma = 0, which switches
the whole global-motion branch off, so the JAX tree's gamma is drawn from a
seed before it is bridged (and the tests check that it moves the flow).
Tolerance rtol 1e-3 / atol 5e-3, the bar the JAX package meets against the
PyTorch original (tests/test_model_parity.py:68); within the port, 1e-5
between chunked and dense attention (the same rows, chunked), 1e-4 between
the lookups (kernel #1's and the split lookup's plain versions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu.convert.torch_weights import convert_state_dict
from accflow_tpu.models.gma import GMAConfig as JGMAConfig
from accflow_tpu.models.gma import gma_forward as j_gma_forward
from accflow_tpu.models.gma import gma_pairs_forward as j_gma_pairs_forward
from accflow_tpu.models.gma import init_gma as j_init_gma
from accflow_tpu_torch.convert import load_jax_params, load_reference_state_dict, to_jax_params
from accflow_tpu_torch.models import GMAConfig, build_flow_estimator, gma
from accflow_tpu_torch.ops import corr as corr_ops


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


TOL = dict(rtol=1e-3, atol=5e-3)
ITERS = 3
BRANCHES = {"content": {}, "position_only": dict(position_only=True),
            "position_and_content": dict(position_and_content=True)}


def _jax_tree(rng):
    tree = j_init_gma(jax.random.PRNGKey(0), JGMAConfig(compute_dtype="float32"))
    tree["update_block"]["aggregator"]["gamma"] = jnp.asarray(rng.uniform(2.0, 4.0, (1,)),
                                                              jnp.float32)
    return tree


def _port(tree, **kw):
    est = build_flow_estimator("gma", compute_dtype="float32", device="cpu", **kw)
    load_jax_params(est.model, tree)
    return est


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    tree = _jax_tree(rng)
    frames = rng.uniform(-1, 1, (3, 2, 32, 48, 3)).astype(np.float32)
    return tree, _port(tree), frames


def test_bridge_round_trip(setup):
    """JAX tree -> port module -> JAX tree exactly, the embedding tables
    (emb) and the bare gamma included; JAX's converter reads the port's
    state_dict back to the same tree."""
    tree, est, _ = setup
    back = to_jax_params(est.model)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in leaves:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=str(path))
    assert float(est.model.update_block.aggregator.gamma.detach()) >= 2.0
    assert tuple(est.model.att.pos_emb.rel_height.weight.shape) == (319, 128)
    again = convert_state_dict(tree, est.model.state_dict())
    for (path, a), b in zip(leaves, jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(path))


def test_reference_state_dict_loads(setup):
    """A reference-style state_dict (nn.DataParallel's `module.` prefix,
    RelPosEmb's rel_ind buffer, num_batches_tracked) loads into a fresh
    model; an unknown key still raises."""
    _, est, _ = setup
    sd = {f"module.{k}": v.clone() for k, v in est.model.state_dict().items()}
    sd["module.att.pos_emb.rel_ind"] = torch.zeros(32, 32, dtype=torch.long)
    sd["module.cnet.norm1.num_batches_tracked"] = torch.tensor(3)
    fresh = build_flow_estimator("gma", compute_dtype="float32", device="cpu", seed=5).model
    load_reference_state_dict(fresh, {k.removeprefix("module."): v for k, v in sd.items()})
    for (k, a), b in zip(est.model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="unconsumed"):
        load_reference_state_dict(fresh, {**{k.removeprefix("module."): v
                                             for k, v in sd.items()},
                                          "att.extra.weight": torch.zeros(1)})


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_gma_forward_matches_jax(setup, branch):
    """flow_up, predictions and flow_low of every attention branch."""
    tree, _, frames = setup
    kw = BRANCHES[branch]
    ref = j_gma_forward(tree, jnp.asarray(frames[0]), jnp.asarray(frames[1]),
                        JGMAConfig(compute_dtype="float32", **kw), iters=ITERS)
    est = _port(tree, **kw)
    out = est.forward(frames[0], frames[1], iters=ITERS)
    assert tuple(out["predictions"].shape) == (ITERS, 2, 32, 48, 2)
    for key in ("flow_up", "predictions", "flow_low"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL, err_msg=key)
    # gamma moves the flow by far more than the port and JAX differ: the
    # global branch is on and held.
    with torch.no_grad():
        est.model.update_block.aggregator.gamma.zero_()
    off = est.forward(frames[0], frames[1], iters=ITERS)["flow_up"]
    moved = float((off - out["flow_up"]).abs().max())
    gap = float(np.abs(out["flow_up"].numpy() - np.asarray(ref["flow_up"])).max())
    assert moved > 2 * TOL["atol"] and moved > 1000 * gap, (moved, gap)


def test_chunked_attention(setup):
    """attn_chunk 10 (rounded down to 8, a divisor of H8 * W8 = 24: three
    chunks) equals dense in the port within 1e-5, and JAX's chunked path
    at the flow bar."""
    tree, est, frames = setup
    dense = est.forward(frames[0], frames[1], iters=ITERS)["flow_up"]
    chunked = _port(tree, attn_chunk=10).forward(frames[0], frames[1], iters=ITERS)["flow_up"]
    np.testing.assert_allclose(chunked.numpy(), dense.numpy(), rtol=0, atol=1e-5)
    ref = j_gma_forward(tree, jnp.asarray(frames[0]), jnp.asarray(frames[1]),
                        JGMAConfig(compute_dtype="float32", attn_chunk=10), iters=ITERS,
                        final_only=True)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(ref["flow_up"]), **TOL)
    attn = gma.attention(est.model, torch.zeros(1, 128, 4, 6), 10)
    assert isinstance(attn, gma.AttnOperands) and attn.chunk == 8  # divisor of 24
    with pytest.raises(ValueError, match="content-only"):
        GMAConfig(position_only=True, attn_chunk=8)


def test_gma_pairs_forward_matches_jax(setup):
    tree, est, frames = setup
    src, dst = (2, 2, 1), (1, 0, 0)
    ref = j_gma_pairs_forward(tree, jnp.asarray(frames), src, dst,
                              JGMAConfig(compute_dtype="float32"), iters=ITERS)
    out = est.pairs_fn(iters=ITERS)(frames, src, dst)
    assert tuple(out.shape) == (6, 32, 48, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_pairs_from_features_match_pairs_forward(setup):
    """gma_encode_frame + gma_flow_pairs_from_features (the streaming
    step's OFE call, the attention built once and shared) against
    gma_pairs_forward on the same pairs, with and without a warm start."""
    _, est, frames = setup
    encode, from_feats = est.encode_frame_fn(), est.pairs_from_features_fn(iters=ITERS)
    feats = [encode(f) for f in frames]
    got = from_feats(feats[2], [feats[1]["fmap"], feats[0]["fmap"]])
    ref = est.pairs_fn(iters=ITERS)(frames, (2, 2), (1, 0))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    init = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (4, 4, 6, 2))
                            .astype(np.float32))
    warm = from_feats(feats[2], [feats[1]["fmap"], feats[0]["fmap"]], flow_init=init)
    ref = torch.cat([est.forward(frames[2], frames[d], iters=ITERS, flow_init=init[2 * i:2 * i + 2],
                                 final_only=True)["flow_up"] for i, d in enumerate((1, 0))])
    np.testing.assert_allclose(warm.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_fused_bd_matches_fused(setup):
    """experimental:fused_bd (the split lookup, kernel #3's plain twin on
    the CPU) against fused (kernel #1's) under GMA."""
    tree, est, frames = setup
    ref = est.forward(frames[0], frames[1], iters=ITERS, final_only=True)["flow_up"]
    got = _port(tree, corr_lookup="experimental:fused_bd").forward(
        frames[0], frames[1], iters=ITERS, final_only=True)["flow_up"]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4)


def test_resolve_auto_attn_chunk(monkeypatch):
    """The cases of tests/test_ops_golden.py:467-490, on the port's
    byte counts, at JAX's 4 GiB budget; then at the port's own
    AUTO_VOLUME_BYTES (25 GiB, re-derived for the H100's 80 GB), where 6
    pairs of 160^2 maps stay dense (23.6 GB) and 7 chunk (27.5 GB)."""
    r = gma.resolve_auto_attn_chunk
    assert r(-1, 6, 1, 160, 160) == 0 and r(-1, 7, 1, 160, 160) == 1024
    monkeypatch.setattr(corr_ops, "AUTO_VOLUME_BYTES", 4 << 30)
    assert r(-1, 1, 1, 64, 64) == 0
    assert r(-1, 3, 1, 256, 256) == 1024
    assert r(16, 3, 1, 256, 256) == 16
    assert r(-1, 1, 1, 160, 160) == 0  # 3.9 GB of 4 GiB
    assert r(-1, 1, 1, 160, 160, reserved_bytes=1 << 30) == 1024
    assert r(-1, 1, 1, 160, 160, compute_dtype=torch.float32) == 1024
    assert r(-1, 3, 1, 256, 256, positional=True) == 0
    with pytest.raises(ValueError, match="symbolic"):
        r(-1, "b", 1, 8, 8)


def test_resolve_auto_lookup(setup, monkeypatch):
    """corr_lookup "auto" is kernel #1's "fused" within the budget, on the port's
    logical byte count (the TPU's lane padding not counted), and the
    volume-free "ondemand" beyond it; attn_chunk=-1 chunks once the budget
    is small, with the same flow, and so does a forward beyond the budget
    (ondemand, chunked attention)."""
    assert corr_ops.stored_volume_bytes(22, 64, 64) == 22 * 4096 * (4096 + 1024 + 256 + 64) * 4
    assert corr_ops.stored_volume_bytes(1, 3, 5, dtype=torch.bfloat16) == 15 * (15 + 2) * 2
    assert corr_ops.resolve_auto_lookup("auto", 22, 64, 64) == "fused"  # JAX: ondemand
    assert corr_ops.resolve_auto_lookup("experimental:fused_bd", 10 ** 6, 64, 64) == \
        "experimental:fused_bd"
    assert corr_ops.resolve_auto_lookup("auto", 11, 180, 320, dtype=torch.bfloat16) == "ondemand"
    tree, est, frames = setup
    dense = est.forward(frames[0], frames[1], iters=ITERS, final_only=True)["flow_up"]
    auto = _port(tree, corr_lookup="auto", attn_chunk=-1)
    got = auto.forward(frames[0], frames[1], iters=ITERS, final_only=True)["flow_up"]
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=1e-5)
    seen = []
    real = gma.resolve_auto_attn_chunk
    monkeypatch.setattr(gma, "resolve_auto_attn_chunk",
                        lambda *a, **kw: seen.append(real(*a, **kw)) or seen[-1])
    monkeypatch.setattr(corr_ops, "AUTO_VOLUME_BYTES",
                        corr_ops.stored_volume_bytes(2, 4, 6, dtype=torch.float32) + 1)
    got = auto.forward(frames[0], frames[1], iters=ITERS, final_only=True)["flow_up"]
    assert seen == [1024]
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=1e-5)
    monkeypatch.setattr(corr_ops, "AUTO_VOLUME_BYTES", 1)
    got = auto.forward(frames[0], frames[1], iters=ITERS, final_only=True)["flow_up"]
    assert seen == [1024, 1024]
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=1e-5)
