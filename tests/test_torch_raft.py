"""RAFT of the PyTorch port against JAX RAFT at full width (basic encoders,
radius 4, 4 levels) on 64x64 frames in float32, same weights (JAX init,
moved across with load_jax_params). The JAX side runs both lookups the
port's single lookup replaces: the fused Pallas kernel (interpret mode on
the CPU) and the XLA default "fused". Tolerance rtol 1e-3 / atol 5e-3, the
bar the JAX package meets against the PyTorch original
(tests/test_model_parity.py:68)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu.models.gma import GMAConfig as JGMAConfig
from accflow_tpu.models.gma import gma_forward as j_gma_forward
from accflow_tpu.models.gma import init_gma as j_init_gma
from accflow_tpu.models.raft import RAFTConfig as JRAFTConfig
from accflow_tpu.models.raft import init_raft as j_init_raft
from accflow_tpu.models.raft import raft_forward as j_raft_forward
from accflow_tpu.models.raft import raft_pairs_forward as j_raft_pairs_forward
from accflow_tpu_torch.convert import load_jax_params
from accflow_tpu_torch.models import RAFTConfig, build_flow_estimator


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


@pytest.fixture(scope="module")
def setup():
    params = j_init_raft(jax.random.PRNGKey(0), JRAFTConfig(compute_dtype="float32"))
    est = build_flow_estimator("raft", compute_dtype="float32", device="cpu")
    load_jax_params(est.model, params)
    frames = np.random.default_rng(0).uniform(-1, 1, (3, 2, 64, 64, 3)).astype(np.float32)
    return params, est, frames


@pytest.mark.parametrize("lookup", ["pallas_fused", "fused"])
def test_raft_pairs_forward(setup, lookup):
    params, est, frames = setup
    src, dst = (2, 2, 1), (1, 0, 0)
    cfg = JRAFTConfig(compute_dtype="float32", corr_lookup=lookup)
    ref = j_raft_pairs_forward(params, jnp.asarray(frames), src, dst, cfg,
                               iters=ITERS, final_only=True)
    out = est.pairs_fn(iters=ITERS)(frames, src, dst)
    assert tuple(out.shape) == (6, 64, 64, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_raft_forward_predictions(setup):
    """Every-iteration upsampled predictions (final_only=False)."""
    params, est, frames = setup
    cfg = JRAFTConfig(compute_dtype="float32")
    ref = j_raft_forward(params, jnp.asarray(frames[0]), jnp.asarray(frames[1]), cfg,
                         iters=ITERS)
    out = est.forward(frames[0], frames[1], iters=ITERS)
    for key in ("flow_up", "predictions", "flow_low"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL,
                                   err_msg=key)


def test_build_flow_estimator_rejects():
    """An unknown name and a knob neither family knows raise; a knob of the
    other family is dropped (attn_chunk on a RAFT build, small on a GMA
    build), as JAX's _cfg_for does; and "gma" builds GMA, held against
    JAX's gma_forward (its gamma drawn nonzero, so the global branch is on)."""
    with pytest.raises(NotImplementedError, match="unknown flow estimator"):
        build_flow_estimator("flownet", device="cpu")
    with pytest.raises(TypeError):
        build_flow_estimator("raft", device="cpu", scan_unroll=4)
    with pytest.raises(TypeError):
        build_flow_estimator("gma", device="cpu", scan_remat="dots")
    assert build_flow_estimator("raft", device="cpu", attn_chunk=64).cfg == RAFTConfig()
    tree = j_init_gma(jax.random.PRNGKey(3), JGMAConfig(compute_dtype="float32"))
    tree["update_block"]["aggregator"]["gamma"] = jnp.full((1,), 3.0, jnp.float32)
    est = build_flow_estimator("Acc+GMA-cvo", compute_dtype="float32", device="cpu", small=True)
    load_jax_params(est.model, tree)
    frames = np.random.default_rng(4).uniform(-1, 1, (2, 1, 32, 32, 3)).astype(np.float32)
    ref = j_gma_forward(tree, jnp.asarray(frames[0]), jnp.asarray(frames[1]),
                        JGMAConfig(compute_dtype="float32"), iters=2, final_only=True)
    out = est.forward(frames[0], frames[1], iters=2, final_only=True)
    for key in ("flow_up", "flow_low"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL, err_msg=key)


def test_bf16_lookup_writes_the_compute_dtype(monkeypatch):
    """Under bfloat16 compute the GRU loop asks the lookup for bfloat16
    output and casts nothing after it; the flow equals, bit for bit, the
    loop that takes float32 windows and casts them (the plain lookup's
    bfloat16 output is its float32 output cast)."""
    from accflow_tpu_torch.models import raft as raft_mod

    est = build_flow_estimator("raft", compute_dtype="bfloat16", device="cpu", seed=0)
    frames = np.random.default_rng(1).uniform(-1, 1, (2, 1, 32, 32, 3)).astype(np.float32)
    asked = []
    fused = raft_mod.lookup_corr_kernel

    def spy(levels, coords, radius, out_dtype=torch.float32):
        asked.append(out_dtype)
        return fused(levels, coords, radius, out_dtype)

    monkeypatch.setattr(raft_mod, "lookup_corr_kernel", spy)
    got = est.forward(frames[0], frames[1], iters=2, final_only=True)["flow_up"]
    assert asked == [torch.bfloat16] * 2

    def cast_after(levels, coords, radius, out_dtype=torch.float32):
        return fused(levels, coords, radius).to(out_dtype)

    monkeypatch.setattr(raft_mod, "lookup_corr_kernel", cast_after)
    ref = est.forward(frames[0], frames[1], iters=2, final_only=True)["flow_up"]
    assert torch.equal(got, ref)
