"""The port's slice as a whole: AccFlow clip inference (fused OFE, RAFT or
GMA pairs) against JAX `accflow_forward(..., ofe_pairs=est.pairs_fn(...))`
on a T=4, N=1, 64x64 clip (32x48 with GMA) in float32 with hidden 32,
same weights on both sides; GMA's gamma drawn nonzero. Tolerance rtol 2e-3 / atol 2e-2, the bar the JAX package meets
against the PyTorch original (tests/test_model_parity.py:143)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu.models import build_flow_estimator as j_build_flow_estimator
from accflow_tpu.models.accflow import AccFlowConfig as JAccFlowConfig
from accflow_tpu.models.accflow import accflow_forward as j_accflow_forward
from accflow_tpu.models.accflow import init_accflow as j_init_accflow
from accflow_tpu_torch.convert import load_jax_params
from accflow_tpu_torch.models import (
    AccFlowConfig,
    accflow_forward,
    build_flow_estimator,
    init_accflow,
)


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


ITERS = 2


def _perturb_zero_conv(params, rng):
    """init_accflow zeroes AccPlus's ZeroConv (conv2.4), which makes the
    deformable conv's offsets and masks trivial; fill it with random values
    so the clip exercises real deformation."""
    zc = params["accplus"]["conv2"]["4"]
    zc["w"] = jnp.asarray(rng.standard_normal(zc["w"].shape) * 0.05, jnp.float32)
    zc["b"] = jnp.asarray(rng.standard_normal(zc["b"].shape) * 0.5, jnp.float32)
    zc["scale"] = jnp.asarray(rng.uniform(-0.1, 0.1, zc["scale"].shape), jnp.float32)
    return params


def test_accflow_clip_matches_jax():
    rng = np.random.default_rng(7)
    j_est = j_build_flow_estimator("raft", compute_dtype="float32")
    ofe_params = j_est.init(jax.random.PRNGKey(0))
    acfg = JAccFlowConfig(hidden=32, compute_dtype="float32")
    acc_params = _perturb_zero_conv(j_init_accflow(jax.random.PRNGKey(1), acfg), rng)
    frames = rng.uniform(-1, 1, (4, 1, 64, 64, 3)).astype(np.float32)

    ref = j_accflow_forward(acc_params, None, jnp.asarray(frames), acfg,
                            ofe_pairs=j_est.pairs_fn(ofe_params, iters=ITERS))

    est = build_flow_estimator("raft", compute_dtype="float32", device="cpu")
    load_jax_params(est.model, ofe_params)
    acc = load_jax_params(
        init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32"), device="cpu"),
        acc_params)
    assert acc.accplus.conv2[4].conv.weight.abs().sum() > 0
    out = accflow_forward(acc, frames, est.pairs_fn(iters=ITERS))

    assert tuple(out.shape) == (2, 1, 64, 64, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-3, atol=2e-2)


def test_accflow_gma_clip_matches_jax():
    """AccFlow+GMA: 11-pair-style batched GMA queries (each source frame's
    attention built once) under the accumulation cells."""
    rng = np.random.default_rng(8)
    j_est = j_build_flow_estimator("gma", compute_dtype="float32")
    ofe_params = j_est.init(jax.random.PRNGKey(0))
    ofe_params["update_block"]["aggregator"]["gamma"] = jnp.full((1,), 3.0, jnp.float32)
    acfg = JAccFlowConfig(hidden=32, compute_dtype="float32")
    acc_params = _perturb_zero_conv(j_init_accflow(jax.random.PRNGKey(1), acfg), rng)
    frames = rng.uniform(-1, 1, (4, 1, 32, 48, 3)).astype(np.float32)

    ref = j_accflow_forward(acc_params, None, jnp.asarray(frames), acfg,
                            ofe_pairs=j_est.pairs_fn(ofe_params, iters=ITERS))

    est = build_flow_estimator("gma", compute_dtype="float32", device="cpu")
    load_jax_params(est.model, ofe_params)
    acc = load_jax_params(
        init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32"), device="cpu"),
        acc_params)
    out = accflow_forward(acc, frames, est.pairs_fn(iters=ITERS))
    assert tuple(out.shape) == (2, 1, 32, 48, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-3, atol=2e-2)


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_accflow(AccFlowConfig(hidden=32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_flow_estimator("raft")
    with pytest.raises(ValueError, match="3 frames"):
        accflow_forward(init_accflow(AccFlowConfig(hidden=32), device="cpu"),
                        np.zeros((2, 1, 64, 64, 3), np.float32), None)
