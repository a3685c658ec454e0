"""RAFT-small of the PyTorch port (small encoders, radius 3, ConvGRU,
upflow8) against JAX RAFT-small on 64x64 frames in float32, same weights
(JAX init, moved across with load_jax_params), cold and warm-started
(flow_init). The JAX side runs the two lookups RAFT-small can take: the
per-level Pallas kernel (`experimental:pallas`, interpret mode on the CPU),
which the port's per-level CUDA kernel replaces, and the default "mm".
Then the streaming step's OFE calls (raft_encode_frame +
raft_flow_pairs_from_features) against raft_pairs_forward, for both RAFT
configurations. Tolerance rtol 1e-3 / atol 5e-3, the bar the JAX package
meets against the PyTorch original (tests/test_model_parity.py:68)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu.models.raft import RAFTConfig as JRAFTConfig
from accflow_tpu.models.raft import init_raft as j_init_raft
from accflow_tpu.models.raft import raft_encode_frame as j_raft_encode_frame
from accflow_tpu.models.raft import raft_flow_pairs_from_features as j_pairs_from_features
from accflow_tpu.models.raft import raft_forward as j_raft_forward
from accflow_tpu.models.raft import raft_pairs_forward as j_raft_pairs_forward
from accflow_tpu_torch.convert import load_jax_params
from accflow_tpu_torch.models import build_flow_estimator


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


def _setup(small: bool, size: int):
    params = j_init_raft(jax.random.PRNGKey(0),
                         JRAFTConfig(small=small, compute_dtype="float32"))
    est = build_flow_estimator("raft", compute_dtype="float32", device="cpu",
                               small=small, iters=ITERS)
    load_jax_params(est.model, params)
    rng = np.random.default_rng(1)
    frames = rng.uniform(-1, 1, (3, 2, size, size, 3)).astype(np.float32)
    init = rng.uniform(-2, 2, (2, size // 8, size // 8, 2)).astype(np.float32)
    return params, est, frames, init


@pytest.fixture(scope="module")
def small():
    return _setup(True, 64)


def test_config():
    est = build_flow_estimator("raft", compute_dtype="float32", device="cpu", small=True)
    cfg, jcfg = est.model.cfg, JRAFTConfig(small=True)
    assert (cfg.hidden_dim, cfg.context_dim, cfg.radius, cfg.corr_planes) == (
        jcfg.hidden_dim, jcfg.context_dim, jcfg.radius, jcfg.corr_planes) == (96, 64, 3, 196)
    assert not hasattr(est.model.update_block, "mask")


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("lookup", ["experimental:pallas", "mm"])
def test_raft_small_forward(small, lookup, warm):
    """Every-iteration predictions, the final flow and flow_low."""
    params, est, frames, init = small
    flow_init = init if warm else None
    cfg = JRAFTConfig(small=True, compute_dtype="float32", corr_lookup=lookup)
    ref = j_raft_forward(params, jnp.asarray(frames[0]), jnp.asarray(frames[1]), cfg,
                         iters=ITERS, flow_init=None if flow_init is None else jnp.asarray(init))
    out = est.forward(frames[0], frames[1], flow_init=flow_init)
    assert tuple(out["predictions"].shape) == (ITERS, 2, 64, 64, 2)
    for key in ("flow_up", "predictions", "flow_low"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL,
                                   err_msg=key)


def test_flow_fn_is_final_flow_up(small):
    _, est, frames, init = small
    full = est.forward(frames[0], frames[1], flow_init=init)
    np.testing.assert_allclose(est.flow_fn()(frames[0], frames[1], flow_init=init).numpy(),
                               full["flow_up"].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("is_small", [True, False])
def test_pairs_from_features(is_small, small):
    """The streaming step's OFE call: frame 2 encoded alone, the maps of
    frames 1 and 0 from their own encodes; cold against JAX
    raft_pairs_forward, warm against JAX raft_flow_pairs_from_features."""
    params, est, frames, init = small if is_small else _setup(False, 32)
    n = frames.shape[1]
    cfg = JRAFTConfig(small=is_small, compute_dtype="float32")
    enc = est.encode_frame_fn()
    src, f1, f0 = enc(frames[2]), enc(frames[1]), enc(frames[0])
    pairs = est.pairs_from_features_fn()
    cold = pairs(src, [f1["fmap"], f0["fmap"]])
    ref = j_raft_pairs_forward(params, jnp.asarray(frames), (2, 2), (1, 0), cfg,
                               iters=ITERS, final_only=True)
    np.testing.assert_allclose(cold.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(cold.numpy(), est.pairs_fn()(frames, (2, 2), (1, 0)).numpy(),
                               rtol=1e-5, atol=1e-5)

    warm_init = np.concatenate([init[:n], -init[:n]])
    warm = pairs(src, [f1["fmap"], f0["fmap"]], flow_init=warm_init)
    j_enc = [j_raft_encode_frame(params, jnp.asarray(frames[i]), cfg) for i in (2, 1, 0)]
    ref = j_pairs_from_features(params, j_enc[0], [j_enc[1]["fmap"], j_enc[2]["fmap"]], cfg,
                                iters=ITERS, flow_init=jnp.asarray(warm_init))
    assert tuple(warm.shape) == (2 * n,) + frames.shape[2:4] + (2,)
    np.testing.assert_allclose(warm.numpy(), np.asarray(ref), **TOL)


def test_bf16_lookup_writes_the_compute_dtype(monkeypatch):
    """Under bfloat16 compute the RAFT-small loop asks the per-level lookup
    for bfloat16 output and casts nothing after it; the flow equals, bit for
    bit, the loop that takes float32 windows and casts them (the plain
    lookup's bfloat16 output is its float32 output cast)."""
    from accflow_tpu_torch.models import raft as raft_mod

    est = build_flow_estimator("raft", compute_dtype="bfloat16", device="cpu", seed=0,
                               small=True)
    frames = np.random.default_rng(1).uniform(-1, 1, (2, 1, 32, 32, 3)).astype(np.float32)
    asked = []
    level = raft_mod.lookup_corr_kernel

    def spy(levels, coords, radius, out_dtype=torch.float32):
        asked.append((radius, out_dtype))
        return level(levels, coords, radius, out_dtype)

    monkeypatch.setattr(raft_mod, "lookup_corr_kernel", spy)
    got = est.forward(frames[0], frames[1], iters=2, final_only=True)["flow_up"]
    assert asked == [(3, torch.bfloat16)] * 2

    def cast_after(levels, coords, radius, out_dtype=torch.float32):
        return level(levels, coords, radius).to(out_dtype)

    monkeypatch.setattr(raft_mod, "lookup_corr_kernel", cast_after)
    ref = est.forward(frames[0], frames[1], iters=2, final_only=True)["flow_up"]
    assert torch.equal(got, ref)
