"""The port's bfloat16 path against JAX's, on the CPU: full RAFT and
RAFT-small through `raft_pairs_forward`, and AccFlow+RAFT through
`accflow_forward` at T = 3, each at 64x64 with batch 1 and the JAX init
moved across with load_jax_params.

The two packages round to bfloat16 at different places (the port stores
the pyramid levels in bfloat16 where JAX keeps them in float32, and asks
the lookup for bfloat16 windows), so their bfloat16 outputs differ by
about as much as each differs from float32. The bar is JAX's own: the
port's bfloat16 flow may be no farther from JAX's float32 flow than JAX's
bfloat16 flow is, max |port bf16 - JAX f32| <= max |JAX bf16 - JAX f32|
on the same inputs. RAFT-small's port loop runs the per-level lookup's
plain twin with bfloat16 output."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu.models import build_flow_estimator as j_build_flow_estimator
from accflow_tpu.models.accflow import AccFlowConfig as JAccFlowConfig
from accflow_tpu.models.accflow import accflow_forward as j_accflow_forward
from accflow_tpu.models.accflow import init_accflow as j_init_accflow
from accflow_tpu.models.raft import RAFTConfig as JRAFTConfig
from accflow_tpu.models.raft import init_raft as j_init_raft
from accflow_tpu.models.raft import raft_pairs_forward as j_raft_pairs_forward
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


ITERS = 4
SRC, DST = (2, 2, 1), (1, 0, 0)  # AccFlow's three pair queries at T = 3


@functools.lru_cache(maxsize=None)
def _raft_params(small: bool):
    """The JAX init of PRNGKey(0) (jitted: eager init takes twice as long)."""
    cfg = JRAFTConfig(small=small, compute_dtype="float32")
    return jax.jit(lambda key: j_init_raft(key, cfg))(jax.random.PRNGKey(0))


def _frames(t: int) -> np.ndarray:
    return np.random.default_rng(0).uniform(-1, 1, (t, 1, 64, 64, 3)).astype(np.float32)


def _raft(small: bool):
    """(port bf16, JAX bf16, JAX f32) flows of the three pairs."""
    params = _raft_params(small)
    frames = _frames(3)
    ref = {cd: np.asarray(j_raft_pairs_forward(
        params, jnp.asarray(frames), SRC, DST, JRAFTConfig(small=small, compute_dtype=cd),
        iters=ITERS, final_only=True)) for cd in ("bfloat16", "float32")}
    est = build_flow_estimator("raft", compute_dtype="bfloat16", device="cpu", small=small)
    load_jax_params(est.model, params)
    out = est.pairs_fn(iters=ITERS)(frames, SRC, DST)
    return out.float().numpy(), ref["bfloat16"], ref["float32"]


def _accflow():
    rng = np.random.default_rng(7)
    frames = _frames(3)
    ofe_params = _raft_params(False)
    acc_params = jax.jit(lambda key: j_init_accflow(key, JAccFlowConfig(hidden=32)))(
        jax.random.PRNGKey(1))
    zc = acc_params["accplus"]["conv2"]["4"]  # ZeroConv starts at zero: deform for real
    zc["w"] = jnp.asarray(rng.standard_normal(zc["w"].shape) * 0.05, jnp.float32)
    zc["b"] = jnp.asarray(rng.standard_normal(zc["b"].shape) * 0.5, jnp.float32)
    zc["scale"] = jnp.asarray(rng.uniform(-0.1, 0.1, zc["scale"].shape), jnp.float32)
    ref = {}
    for cd in ("bfloat16", "float32"):
        j_est = j_build_flow_estimator("raft", compute_dtype=cd)
        ref[cd] = np.asarray(j_accflow_forward(
            acc_params, None, jnp.asarray(frames), JAccFlowConfig(hidden=32, compute_dtype=cd),
            ofe_pairs=j_est.pairs_fn(ofe_params, iters=ITERS)))
    est = build_flow_estimator("raft", compute_dtype="bfloat16", device="cpu")
    load_jax_params(est.model, ofe_params)
    acc = load_jax_params(
        init_accflow(AccFlowConfig(hidden=32, compute_dtype="bfloat16"), device="cpu"),
        acc_params)
    out = accflow_forward(acc, frames, est.pairs_fn(iters=ITERS))
    return out.float().numpy(), ref["bfloat16"], ref["float32"]


@pytest.mark.parametrize("model", ["raft", "raft_small", "accflow"])
def test_bf16_within_jax_bf16_error(model):
    port, j_bf16, j_f32 = {"raft": lambda: _raft(False), "raft_small": lambda: _raft(True),
                           "accflow": _accflow}[model]()
    assert port.shape == j_f32.shape and np.isfinite(port).all()
    port_err = float(np.abs(port - j_f32).max())
    jax_err = float(np.abs(j_bf16 - j_f32).max())
    print(f"{model}: max |port bf16 - JAX f32| {port_err:.3e}, "
          f"max |JAX bf16 - JAX f32| {jax_err:.3e}, max |flow| {np.abs(j_f32).max():.3f}")
    assert jax_err > 0  # the two JAX runs differ, or the bar says nothing
    assert port_err <= jax_err
