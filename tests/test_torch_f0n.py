"""AccFlow's other paths in the port (models/accflow.py): the forward (F0N)
direction, fused and stepwise, and the cold stepwise backward path
(fused_ofe=False), against JAX's accflow_forward on the CPU, after
tests/test_model_parity.py:430-505, and the F0N train step
(configs/AccRAFT-F0N.yml's `direction: forward`, labels from fflows)
against JAX's make_acc_train_step, after tests/test_training.py:440-470.
T=3 and 4, batch 1, 64x64, float32, hidden 32, the frozen estimator at 2
GRU iterations on the same weights on both sides (the port's seeded init
moved to JAX's layout, AccPlus's ZeroConv drawn nonzero so that the
deformable conv deforms).

Tolerances: clips rtol 2e-3 / atol 2e-2 against JAX (the bar the JAX
package meets against the PyTorch original, tests/test_model_parity.py:143),
1e-5 within the port between paths that compute the same function; the
train step at tests/test_torch_train.py's bars (loss rtol 1e-5; gradients
per leaf rtol 1e-3, atol 1e-3 of the leaf's largest, the context encoder's
by its relative L2 <= 1e-2, for the ReLU ties that file describes)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accflow_tpu.models import accflow as j_acc
from accflow_tpu.models import build_flow_estimator as j_build_flow_estimator
from accflow_tpu.train import engine as j_engine
from accflow_tpu.train import optim as j_optim
from accflow_tpu_torch.convert import load_jax_params, to_jax_params
from accflow_tpu_torch.models import AccFlowConfig, accflow_forward, build_flow_estimator
from accflow_tpu_torch.models import init_accflow
from accflow_tpu_torch.models.accflow import accflow_train_forward
from accflow_tpu_torch.train import engine
from accflow_tpu_torch.train.loss import sequence_loss_acc
from accflow_tpu_torch.train.optim import make_optimizer
from accflow_tpu_torch.utils import config
from test_torch_train import _assert_grads_close, _grad_tree, _keep_grads, _leaves, _rel_l2


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


ITERS, HIDDEN, SIZE = 2, 32, 64
CLIP_TOL = dict(rtol=2e-3, atol=2e-2)
SAME = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    """Both packages' estimator and accumulator trees on one init, and a
    4-frame clip."""
    rng = np.random.default_rng(21)
    est = build_flow_estimator("raft", compute_dtype="float32", iters=ITERS, device="cpu")
    acc = to_jax_params(init_accflow(AccFlowConfig(hidden=HIDDEN, compute_dtype="float32"),
                                     device="cpu"))
    zc = acc["accplus"]["conv2"]["4"]
    zc["w"] = (rng.standard_normal(zc["w"].shape) * 0.05).astype(np.float32)
    zc["b"] = (rng.standard_normal(zc["b"].shape) * 0.5).astype(np.float32)
    zc["scale"] = rng.uniform(-0.1, 0.1, zc["scale"].shape).astype(np.float32)
    j_est = j_build_flow_estimator("raft", compute_dtype="float32", iters=ITERS)
    ofe = to_jax_params(est.model)
    frames = rng.uniform(-1, 1, (4, 1, SIZE, SIZE, 3)).astype(np.float32)
    return dict(est=est, acc=acc, ofe=ofe, j_est=j_est, frames=frames)


def _port(setup, **cfg):
    model = init_accflow(AccFlowConfig(hidden=HIDDEN, compute_dtype="float32", **cfg),
                         device="cpu")
    return load_jax_params(model, setup["acc"])


def _run(setup, frames, **cfg):
    est = setup["est"]
    return accflow_forward(_port(setup, **cfg), frames, ofe_pairs=est.pairs_fn(),
                           ofe=est.flow_fn()).numpy()


def _jax(setup, frames, **cfg):
    j_est, ofe = setup["j_est"], setup["ofe"]
    acfg = j_acc.AccFlowConfig(hidden=HIDDEN, compute_dtype="float32", **cfg)

    def ofe_fn(a, b):
        return j_est.forward(ofe, a, b, final_only=True)["flow_up"]

    return np.asarray(j_acc.accflow_forward(setup["acc"], ofe_fn, jnp.asarray(frames), acfg,
                                            ofe_pairs=j_est.pairs_fn(ofe)))


def test_f0n_at_three_frames_is_the_reversed_backward_clip(setup):
    """F0N at T=3 is the cold backward accumulation of the reversed clip
    (the same cell call on the same OFE batch). Its first step is held
    against JAX's in test_f0n_matches_jax."""
    clip = setup["frames"][:3]
    fwd = _run(setup, clip, direction="forward")
    assert fwd.shape == (1, 1, SIZE, SIZE, 2)
    np.testing.assert_allclose(fwd, _run(setup, clip[::-1].copy(), fused_ofe=False), **SAME)


@pytest.mark.parametrize("fused_ofe", [True, False])
def test_f0n_matches_jax(setup, fused_ofe):
    """F0N at T=4, fused and stepwise, against JAX's of the same path; the
    fused path against the stepwise one within the port."""
    got = _run(setup, setup["frames"], direction="forward", fused_ofe=fused_ofe)
    assert got.shape == (2, 1, SIZE, SIZE, 2)
    np.testing.assert_allclose(
        got, _jax(setup, setup["frames"], direction="forward", fused_ofe=fused_ofe), **CLIP_TOL)
    if fused_ofe:
        np.testing.assert_allclose(
            got, _run(setup, setup["frames"], direction="forward", fused_ofe=False), **SAME)


def test_cold_stepwise_matches_fused_and_jax(setup):
    """The cold stepwise backward path (each step's own OFE queries)
    against JAX's and the port's fused path."""
    got = _run(setup, setup["frames"], fused_ofe=False)
    np.testing.assert_allclose(got, _jax(setup, setup["frames"], fused_ofe=False), **CLIP_TOL)
    np.testing.assert_allclose(got, _run(setup, setup["frames"]), **SAME)


def test_config_checks(setup):
    """As JAX: forward with warm_start and an unknown direction raise; a
    path without its OFE closure raises."""
    with pytest.raises(ValueError, match="backward-direction"):
        AccFlowConfig(direction="forward", warm_start=True)
    with pytest.raises(ValueError, match="direction"):
        AccFlowConfig(direction="sideways")
    model = _port(setup, direction="forward", fused_ofe=False)
    with pytest.raises(ValueError, match="stepwise"):
        accflow_forward(model, setup["frames"], ofe_pairs=setup["est"].pairs_fn())


@pytest.mark.parametrize("direction", ["backward", "forward"])
def test_stepwise_training_gives_the_fused_gradients(setup, direction):
    """accflow_train_forward on the stepwise path (the cold one, or F0N's)
    gives the fused path's loss and gradients: one function, two orders of
    the same OFE queries."""
    rng = np.random.default_rng(3)
    labels = torch.from_numpy(rng.standard_normal((2, 1, SIZE, SIZE, 2)).astype(np.float32))
    images = torch.from_numpy(setup["frames"])
    est, out = setup["est"], {}
    for fused in (True, False):
        model = _port(setup, direction=direction, fused_ofe=fused, remat=not fused)
        loss, _ = sequence_loss_acc(
            accflow_train_forward(model, images, est.pairs_fn(), est.flow_fn()), labels)
        loss.backward()
        out[fused] = (float(loss.detach()), _leaves(_grad_tree(model)))
    np.testing.assert_allclose(out[False][0], out[True][0], rtol=1e-6)
    for k, v in out[True][1].items():
        np.testing.assert_allclose(out[False][1][k], v, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(v).max()), err_msg=k)


def test_f0n_train_step_matches_jax(setup):
    """One train step of the F0N recipe (configs/AccRAFT-F0N.yml's
    direction, labels from fflows [F_{0,k}]) against JAX's
    make_acc_train_step with direction "forward": the loss and the raw
    gradients (read from JAX's optimizer state)."""
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (1, SIZE, SIZE, 12)).astype(np.float32)
    fflows = (4.0 * rng.standard_normal((1, SIZE, SIZE, 4))).astype(np.float32)
    tx, _ = j_optim.make_optimizer(2e-4, num_steps=4, wdecay=1e-5, epsilon=1e-8, clip=1.0)
    tx = optax.chain(_keep_grads(), tx)
    j_cfg = j_acc.AccFlowConfig(hidden=HIDDEN, compute_dtype="float32", direction="forward")
    j_step, _ = j_engine.make_acc_train_step(setup["j_est"], j_cfg, tx, add_noise=False)
    params = jax.tree.map(jnp.asarray, setup["acc"])
    state = j_engine.TrainState(params, tx.init(params), jnp.int32(0))
    state, j_loss, _ = j_step(state, setup["ofe"], jnp.asarray(imgs), jnp.asarray(fflows),
                              jax.random.PRNGKey(0))
    want = _leaves(jax.tree.map(np.asarray, state.opt_state[0]))

    model = _port(setup, direction="forward")
    grads = {}
    optimizer = make_optimizer(model.parameters(), 2e-4, 4, 1e-5, 1e-8, 1.0)
    update = optimizer.step

    def keep_then_step():
        grads.update(_leaves(_grad_tree(model)))
        update()

    optimizer.step = keep_then_step
    step, _ = engine.make_acc_train_step(setup["est"], model, optimizer, add_noise=False)
    loss, _ = step(imgs, fflows)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    ctx = [k for k in want if k.startswith("context/")]
    _assert_grads_close({k: v for k, v in grads.items() if k not in ctx},
                        {k: v for k, v in want.items() if k not in ctx})
    assert _rel_l2(grads, want, ctx) <= 1e-2


def test_build_acc_model_takes_the_f0n_config():
    """configs/AccRAFT-F0N.yml builds the forward-direction accumulator
    beside its frozen RAFT."""
    opt = config.parse_options("configs/AccRAFT-F0N.yml")
    opt.compute_dtype = "float32"
    _, acfg = engine.build_acc_model(opt, device="cpu")
    assert acfg.direction == "forward" and acfg.fused_ofe
