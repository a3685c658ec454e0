"""Accumulator training of the port (train/engine.py and its layers) against
JAX's train package on the CPU, at T=4, batch 2, 64x64, full RAFT at 2
iterations, hidden 32, float32, the same converted init on both sides with
AccPlus's ZeroConv drawn nonzero (at zero the deformable conv's offsets sit
where the sampler's coordinate derivative has two one-sided values).

- one step's loss (rtol 1e-5) and gradients against jax.value_and_grad,
  as make_acc_train_step computes them (read from its optimizer state, so
  that one compiled JAX step serves this case and the next):
  per leaf rtol 1e-3, atol 1e-3 x that leaf's largest |grad|, but for the
  context encoder's leaves, which are held by their global relative L2
  (<= 1e-2). A ReLU whose input lies
  within float32 rounding of zero takes the other side of its kink in one
  package: at this seed one element of 2.1M (context layer1.0.conv2's
  output, 1.9e-8 in one package and -9.1e-9 in float64) carries a gradient
  of 3.35 through in one and 0 in the other, which moves that layer's
  weight gradient by 2e-2 of its largest element and the context encoder's
  gradient by 1.2e-3 in L2; every other leaf agrees within 2e-6 of its
  largest element;
- 4 steps against make_acc_train_step (noise off, two batches cycled):
  losses rtol 1e-4, parameter deltas within tests/test_training.py:741-760's
  bounds (global relative L2 <= 5e-2, per leaf p99.9 <= 1.5 lr, max <= 3 lr);
- the differentiable ops' gradients against jax.grad (rtol 1e-4, atol 1e-4
  x the largest |grad| of each input);
- remat and grad_accum against the plain step; the learning rates against
  onecycle_linear; the noise against JAX's formula on the same draws;
- checkpoints, resume, PNGs, TB, train_acc end to end, the CLI, the config
  reader, kernel #3's refusal of autograd and the lookup ops' gradients.
"""

import copy
import glob
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from accflow_tpu.data.cvo import BatchIterator as JBatchIterator
from accflow_tpu.data.cvo import fetch_train_dataset as j_fetch_train_dataset
from accflow_tpu.models import accflow as j_acc
from accflow_tpu.models import build_flow_estimator as j_build_flow_estimator
from accflow_tpu.ops import deform as j_deform
from accflow_tpu.ops import sampling as j_sampling
from accflow_tpu.ops import upsample as j_upsample
from accflow_tpu.train import engine as j_engine
from accflow_tpu.train import loss as j_loss
from accflow_tpu.train import optim as j_optim
from accflow_tpu.utils.flow_viz import flow_to_image as j_flow_to_image
from accflow_tpu_torch.cli import train_acc as cli_train_acc
from accflow_tpu_torch.convert import load_jax_params, to_jax_params
from accflow_tpu_torch.data.synthetic import write_synthetic_cvor
from accflow_tpu_torch.models import AccFlowConfig, build_flow_estimator, init_accflow
from accflow_tpu_torch.models.accflow import FlowDecoder, FlowEncoder, accflow_train_forward
from accflow_tpu_torch.nn.layers import init_weights
from accflow_tpu_torch.ops import corr_bd_cuda, corr_cuda, corr_level_cuda, deform, sampling, upsample
from accflow_tpu_torch.ops.corr import lookup_corr_plain_backward
from accflow_tpu_torch.train import engine
from accflow_tpu_torch.train.accum import accumulate_grads
from accflow_tpu_torch.train.checkpoint import CheckpointManager
from accflow_tpu_torch.train.loss import sequence_loss_acc, sequence_loss_raft
from accflow_tpu_torch.train.optim import make_optimizer
from accflow_tpu_torch.utils import config

T, N, SIZE, ITERS, HIDDEN = 4, 2, 64, 2, 32
LR, STEPS = 2e-4, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs, restored after.
    The tests run in several worker processes on one machine; with torch's
    default of a thread per core in each, the port's backward passes ran
    70x slower than alone (6 processes: 233 s against 3.4 s with one
    thread each, for the three remat cases' steps)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaves(tree, prefix=""):
    """{path: numpy leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _grad_tree(model):
    """The module's .grad as a JAX-layout tree (zeros where None)."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(g.parameters(), model.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    return to_jax_params(g)


def _assert_grads_close(got: dict, want: dict, rtol=1e-3, atol_frac=1e-3):
    assert set(got) == set(want)
    for k in want:
        atol = atol_frac * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _rel_l2(got: dict, want: dict, keys) -> float:
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in keys)
    return (num / sum(float((want[k] ** 2).sum()) for k in keys)) ** 0.5


def _batch(rng):
    imgs = rng.integers(0, 256, (N, SIZE, SIZE, 3 * T)).astype(np.float32)
    labels = (4.0 * rng.standard_normal((N, SIZE, SIZE, 2 * (T - 2)))).astype(np.float32)
    return imgs, labels


def _keep_grads():
    """An optax stage that passes the gradients on unchanged and keeps the
    last ones as its state: chained before the optimizer, it lets JAX's
    train step give one step's raw gradients too."""
    return optax.GradientTransformation(lambda params: jax.tree.map(jnp.zeros_like, params),
                                        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def pair():
    """Both packages' estimator and accumulator on one init (the port's,
    moved to JAX's layout by to_jax_params; the ZeroConv drawn nonzero),
    two fixed batches, and JAX's train step (compiled at its first call;
    its optimizer state's first element holds the step's gradients)."""
    rng = np.random.default_rng(11)
    est = build_flow_estimator("raft", compute_dtype="float32", iters=ITERS, device="cpu")
    acc = to_jax_params(init_accflow(AccFlowConfig(hidden=HIDDEN, compute_dtype="float32"),
                                     device="cpu"))
    zc = acc["accplus"]["conv2"]["4"]
    zc["w"] = (rng.standard_normal(zc["w"].shape) * 0.05).astype(np.float32)
    zc["b"] = (rng.standard_normal(zc["b"].shape) * 0.5).astype(np.float32)
    zc["scale"] = rng.uniform(-0.1, 0.1, zc["scale"].shape).astype(np.float32)
    j_est = j_build_flow_estimator("raft", compute_dtype="float32", iters=ITERS)
    j_cfg = j_acc.AccFlowConfig(hidden=HIDDEN, compute_dtype="float32")
    tx, _ = j_optim.make_optimizer(LR, num_steps=STEPS, wdecay=1e-5, epsilon=1e-8, clip=1.0)
    tx = optax.chain(_keep_grads(), tx)
    j_step, _ = j_engine.make_acc_train_step(j_est, j_cfg, tx, add_noise=False)
    return dict(ofe=to_jax_params(est.model), acc=acc, tx=tx,
                j_step=j_step, est=est, batches=[_batch(rng), _batch(rng)])


def _port_acc(pair, **cfg):
    model = init_accflow(AccFlowConfig(hidden=HIDDEN, compute_dtype="float32", **cfg),
                         device="cpu")
    return load_jax_params(model, pair["acc"])


def _port_grads(pair, model, imgs, labels, grad_accum=1):
    """One step's loss and gradients of the port (no update)."""
    pairs = pair["est"].pairs_fn()
    model.zero_grad(set_to_none=True)
    loss, _, _ = accumulate_grads(
        lambda im, lb: sequence_loss_acc(accflow_train_forward(model, im, pairs), lb),
        grad_accum, engine.to_clip(imgs), engine.to_flow_seq(labels), axis=1)
    return float(loss), _leaves(_grad_tree(model))


def _j_state(pair):
    return j_engine.TrainState(jax.tree.map(jnp.asarray, pair["acc"]),
                               pair["tx"].init(pair["acc"]), jnp.int32(0))


def test_one_step_loss_and_grads_match_jax(pair):
    imgs, labels = pair["batches"][0]
    state, j_l, _ = pair["j_step"](_j_state(pair), pair["ofe"], jnp.asarray(imgs),
                                   jnp.asarray(labels), jax.random.PRNGKey(0))
    j_g = jax.tree.map(np.asarray, state.opt_state[0])
    loss, grads = _port_grads(pair, _port_acc(pair), imgs, labels)
    np.testing.assert_allclose(loss, float(j_l), rtol=1e-5)
    j_g = _leaves(j_g)
    ctx = [k for k in j_g if k.startswith("context/")]
    _assert_grads_close({k: v for k, v in grads.items() if k not in ctx},
                        {k: v for k, v in j_g.items() if k not in ctx})
    assert _rel_l2(grads, j_g, ctx) <= 1e-2
    # The ZeroConv's gradient is live: the offsets reach the deformable conv.
    assert np.abs(grads["accplus/conv2/4/w"]).max() > 0


def test_four_step_trajectory_matches_jax(pair):
    state = _j_state(pair)
    model = _port_acc(pair)
    step, _ = engine.make_acc_train_step(
        pair["est"], model, make_optimizer(model.parameters(), LR, STEPS, 1e-5, 1e-8, 1.0),
        add_noise=False)
    j_losses, losses = [], []
    for s in range(STEPS):
        imgs, labels = pair["batches"][s % 2]
        state, j_l, _ = pair["j_step"](state, pair["ofe"], jnp.asarray(imgs),
                                       jnp.asarray(labels), jax.random.PRNGKey(0))
        j_losses.append(float(j_l))
        losses.append(float(step(imgs, labels)[0]))
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)

    init = _leaves(pair["acc"])
    d_j = {k: v - init[k] for k, v in _leaves(jax.tree.map(np.asarray, state.params)).items()}
    d_t = {k: v - init[k] for k, v in _leaves(to_jax_params(model)).items()}
    num = sum(float(((d_t[k] - d_j[k]) ** 2).sum()) for k in d_j)
    den = sum(float((d_j[k] ** 2).sum()) for k in d_j)
    assert (num / den) ** 0.5 <= 5e-2
    for k in d_j:
        err = np.abs(d_t[k] - d_j[k])
        assert float(np.quantile(err, 0.999)) <= 1.5 * LR and err.max() <= 3 * LR, k


def _op_case(name, rng):
    """(JAX function, torch function or module, numpy inputs): functions on
    JAX layouts (NHWC, HWIO weights); a module with its JAX param tree and
    an NHWC input."""
    n, h, w = 2, 7, 9
    if name == "deform_conv3x3":
        cin, cout = 5, 6
        args = (rng.standard_normal((n, h, w, cin)), rng.uniform(-2.5, 2.5, (n, h, w, 18)),
                rng.uniform(0.1, 1.0, (n, h, w, 9)), rng.standard_normal((3, 3, cin, cout)) * 0.2,
                rng.standard_normal(cout))

        def port(x, off, m, wt, b):
            out = deform.deform_conv3x3(x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2),
                                        m.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), b)
            return out.permute(0, 2, 3, 1)

        return j_deform.deform_conv3x3, port, args
    if name == "bilinear_sample":
        args = (rng.standard_normal((n, h, w, 3)), rng.uniform(-2, 10, (n, 6, 5, 2)))
        return j_sampling.bilinear_sample, sampling.bilinear_sample, args
    if name == "backwarp":
        args = (rng.standard_normal((n, h, w, 4)), rng.uniform(-3, 3, (n, h, w, 2)))
        return j_sampling.backwarp, sampling.backwarp, args
    if name == "convex_upsample":
        args = (rng.standard_normal((n, 4, 5, 2)), rng.standard_normal((n, 4, 5, 576)))
        return j_upsample.convex_upsample, upsample.convex_upsample, args
    c = 8
    if name == "flow_encoder":
        module, x = FlowEncoder(c), rng.standard_normal((n, h, w, 2))
    else:
        module, x = FlowDecoder(c), rng.standard_normal((n, h, w, c))
    init_weights(module, 3)
    return getattr(j_acc, name), module, (to_jax_params(module), x)


def _cotangents(outs, rng):
    return [rng.standard_normal(o.shape).astype(np.float32) for o in outs]


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("op", ["deform_conv3x3", "bilinear_sample", "backwarp",
                                "convex_upsample", "flow_encoder", "flow_decoder"])
def test_op_grads_match_jax(op):
    rng = np.random.default_rng(5)
    j_fn, port, args = _op_case(op, rng)
    tol = dict(rtol=1e-4, atol_frac=1e-4)
    if isinstance(port, torch.nn.Module):  # gradients of its weights and its input
        tree, x = args
        x = x.astype(np.float32)
        j_args = (jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
        cots = _cotangents(_tuple(j_fn(*j_args)), rng)

        def j_obj(p, xx):
            return sum(jnp.sum(o.astype(jnp.float32) * c) for o, c in zip(_tuple(j_fn(p, xx)), cots))

        j_gp, j_gx = jax.jit(jax.grad(j_obj, argnums=(0, 1)))(*j_args)
        xt = _t(x).requires_grad_(True)
        outs = port(xt.permute(0, 3, 1, 2))
        outs = (outs.permute(0, 2, 3, 1),) if torch.is_tensor(outs) else outs
        sum((o.float() * _t(c)).sum() for o, c in zip(outs, cots)).backward()
        _assert_grads_close(_leaves(_grad_tree(port)), _leaves(j_gp), **tol)
        _assert_grads_close({"x": xt.grad.numpy()}, {"x": np.asarray(j_gx)}, **tol)
        return
    args = [a.astype(np.float32) for a in args]
    j_args = [jnp.asarray(a) for a in args]
    (cot,) = _cotangents([j_fn(*j_args)], rng)
    j_grads = jax.jit(jax.grad(lambda *a: jnp.sum(j_fn(*a) * cot),
                               argnums=tuple(range(len(args)))))(*j_args)
    ts = [_t(a).requires_grad_(True) for a in args]
    (port(*ts) * _t(cot)).sum().backward()
    _assert_grads_close({i: t.grad.numpy() for i, t in enumerate(ts)},
                        {i: np.asarray(g) for i, g in enumerate(j_grads)}, **tol)


@pytest.mark.parametrize("remat", [True, "full", "dots"])
def test_remat_gives_the_plain_grads(pair, remat):
    """remat changes what the backward stores, not the gradients (after
    tests/test_training.py:184's bars)."""
    imgs, labels = pair["batches"][0]
    loss0, g0 = _port_grads(pair, _port_acc(pair), imgs, labels)
    loss1, g1 = _port_grads(pair, _port_acc(pair, remat=remat), imgs, labels)
    assert loss1 == loss0
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_grad_accum_equals_the_full_batch(pair):
    """grad_accum=2 on batch 2: the same loss and gradients as one pass
    (after tests/test_training.py:475,506); 3 does not divide it and raises
    before any backward."""
    imgs, labels = pair["batches"][1]
    loss1, g1 = _port_grads(pair, _port_acc(pair), imgs, labels)
    loss2, g2 = _port_grads(pair, _port_acc(pair), imgs, labels, grad_accum=2)
    np.testing.assert_allclose(loss2, loss1, rtol=1e-5)
    for k in g1:
        np.testing.assert_allclose(g2[k], g1[k], rtol=1e-4, atol=1e-4 * np.abs(g1[k]).max(),
                                   err_msg=k)
    model = _port_acc(pair)
    with pytest.raises(ValueError, match="grad_accum=3"):
        _port_grads(pair, model, imgs, labels, grad_accum=3)
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("kind", ["acc", "raft"])
def test_losses_match_jax(kind):
    """sequence_loss_acc (unweighted L1 over the S outputs) and
    sequence_loss_raft (gamma-weighted over the iterations) with their EPE
    metrics, against JAX's on the same predictions, rtol 1e-6."""
    rng = np.random.default_rng(3)
    preds = rng.standard_normal((5, 2, 8, 8, 2)).astype(np.float32) * 3
    if kind == "acc":
        gt = rng.standard_normal((5, 2, 8, 8, 2)).astype(np.float32) * 3
        (j_l, j_m), (l, m) = (j_loss.sequence_loss_acc(jnp.asarray(preds), jnp.asarray(gt)),
                              sequence_loss_acc(_t(preds), _t(gt)))
    else:
        gt = rng.standard_normal((2, 8, 8, 2)).astype(np.float32) * 3
        (j_l, j_m), (l, m) = (j_loss.sequence_loss_raft(jnp.asarray(preds), jnp.asarray(gt), 0.85),
                              sequence_loss_raft(_t(preds), _t(gt), 0.85))
    np.testing.assert_allclose(float(l), float(j_l), rtol=1e-6)
    assert set(m) == set(j_m)
    for k in j_m:
        np.testing.assert_allclose(float(m[k]), float(j_m[k]), rtol=1e-6, err_msg=k)


def test_build_acc_model_refuses_the_forward_direction():
    """direction: forward (the F0N ablation, configs/AccRAFT-F0N.yml), refused
    before it was ported, builds the forward-direction accumulator (its
    paths and train step: tests/test_torch_f0n.py); an unknown direction
    raises before any model is built."""
    opt = config.parse_options("configs/AccRAFT-F0N.yml")
    opt.compute_dtype = "float32"
    assert engine.build_acc_model(opt, device="cpu")[1].direction == "forward"
    opt.direction = "sideways"
    with pytest.raises(ValueError, match="direction"):
        engine.build_acc_model(opt, device="cpu")


@pytest.mark.parametrize("total", [108, 1000])
def test_learning_rates_match_onecycle_linear(total):
    """make_optimizer's OneCycle over num_steps + 100 gives JAX's
    onecycle_linear at every step (108 has a fractional warm-up boundary,
    4.4); rtol 1e-4: JAX evaluates in float32, torch in float64."""
    opt = make_optimizer([torch.nn.Parameter(torch.zeros(1))], 1.2e-4, total - 100)
    schedule = j_optim.onecycle_linear(1.2e-4, total, 0.05)
    lrs = []
    for _ in range(total):
        lrs.append(opt.lr)
        opt.optimizer.step()
        opt.scheduler.step()
    np.testing.assert_allclose(lrs, [float(schedule(i)) for i in range(total)], rtol=1e-4,
                               atol=1e-11)


def test_reference_noise_matches_jax(monkeypatch):
    """The noise's pure part equals JAX's reference_noise fed the same
    draws (its uniform and normal patched to return them), and the draw
    takes stdv and then the normals from the generator."""
    rng = np.random.default_rng(2)
    u = np.float32(rng.uniform())
    normal = (rng.standard_normal((2, 8, 8, 3)) * 40).astype(np.float32)
    monkeypatch.setattr(j_engine.jax.random, "uniform", lambda key, *a, **k: jnp.float32(u))
    monkeypatch.setattr(j_engine.jax.random, "normal", lambda key, *a, **k: jnp.asarray(normal))
    want = np.asarray(j_engine.reference_noise(jax.random.PRNGKey(0), normal.shape))
    got = engine.noise_from_draws(torch.tensor(u * 5.0), _t(normal))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    gen = torch.Generator().manual_seed(4)
    noise = engine.reference_noise(gen, (2, 8, 8, 3))
    gen = torch.Generator().manual_seed(4)
    stdv = torch.rand((), generator=gen) * 5.0
    np.testing.assert_array_equal(noise.numpy(), engine.noise_from_draws(
        stdv, torch.randn((2, 8, 8, 3), generator=gen)).numpy())
    assert noise.min() >= -1.0 and noise.max() <= 1.0


def test_checkpoint_retention(tmp_path):
    """JAX's retention on its EPE sequence (after tests/test_training.py:297):
    `latest` every validation, numbered saves on new bests only, pruned
    oldest-first to keep - 1; restore by step, auto, and after final."""
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), keep=4)
    best = float("inf")
    for i, epe in enumerate([5.0, 4.0, 4.5, 3.0, 2.5, 2.9], start=1):
        step = 100 * i
        ckpt.save(step, {"w": torch.full((2,), float(step))})
        if epe <= best:
            best = epe
            ckpt.save_best(step, {"w": torch.full((2,), float(step))})
    assert ckpt.best_steps() == [200, 400, 500]
    assert ckpt.latest_step() == 600
    assert sorted(p.name for p in (tmp_path / "ckpt" / "latest").iterdir()) == ["600.pt"]
    assert float(ckpt.restore(500)["w"][0]) == 500.0
    assert float(ckpt.restore()["w"][0]) == 600.0
    ckpt.save_final(700, {"w": torch.full((2,), 700.0)})
    assert float(ckpt.restore()["w"][0]) == 700.0
    with pytest.raises(FileNotFoundError):
        ckpt.restore(300)


def _opts(tmp_path, root, **kw):
    opt = config.AttrDict(
        exp_name="Acc+RAFT", small=True, acc_hidden=HIDDEN, epochs=2, lr=1e-4, wdecay=1e-5,
        epsilon=1e-8, compute_dtype="float32", batch_per_gpu=2, clip=1.0, add_noise=True,
        log_freq=1, valid_freq=100, image_size=[48, 48], dataset_root=root,
        log_dir=str(tmp_path / "logs"), ckpt_dir=str(tmp_path / "ckpt"), visual_samples=[],
        resume=None, seed=3)
    opt.update(kw)
    return opt


@pytest.fixture(scope="module")
def cvor(tmp_path_factory):
    """Synthetic CVOR at 64^2: 4 clips per split (8 training samples over
    clean+final), 5 test clips."""
    return write_synthetic_cvor(str(tmp_path_factory.mktemp("cvor")), num_train=4,
                                num_test=5, h=SIZE, w=SIZE)


def test_train_acc_draws_jax_batches_and_resumes(tmp_path, cvor, monkeypatch):
    """train_acc end to end (RAFT-small, 48^2 crops of 64^2 clips, noise
    on): the batches, crops included, are JAX's BatchIterator's for the same
    seed and order; resume "auto" continues the count and the weights (and,
    as JAX's train_acc, restarts the epoch's iterator), and a resume by
    number restarts from that step (after tests/test_training.py:256)."""
    seen = []
    make = engine.make_acc_train_step

    def recording(*a, **k):
        step, valid = make(*a, **k)
        return (lambda imgs, flows, gen: seen.append(np.array(imgs)) or step(imgs, flows, gen),
                valid)

    monkeypatch.setattr(engine, "make_acc_train_step", recording)
    state = engine.train_acc(_opts(tmp_path, cvor), max_steps=2, device="cpu")
    assert state.step == 2
    j_batches = [b["imgs"] for b in JBatchIterator(
        j_fetch_train_dataset(cvor, ["bflows"], crop_size=[48, 48]), 2, shuffle=True,
        drop_last=True, seed=3, epoch=0)]
    for got, want in zip(seen, j_batches):
        np.testing.assert_array_equal(got, want)
    assert all(np.isfinite(p.detach().numpy()).all() for p in state.model.parameters())
    weights = {k: v.clone() for k, v in state.model.state_dict().items()}

    resumed = engine.train_acc(_opts(tmp_path, cvor, resume="auto"), max_steps=4, device="cpu")
    assert resumed.step == 4 and len(seen) == 4
    np.testing.assert_array_equal(seen[2], j_batches[0])
    moved = [not torch.equal(v, weights[k]) for k, v in resumed.model.state_dict().items()]
    assert any(moved)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    restored = ckpt.restore(2)
    assert restored["step"] == 2
    assert all(torch.equal(restored["model"][k], v) for k, v in weights.items())
    again = engine.train_acc(_opts(tmp_path, cvor, resume=2), max_steps=3, device="cpu")
    assert again.step == 3
    assert ckpt.latest_step() == 4 and restored["scheduler"]["last_epoch"] == 2


def test_train_acc_writes_pngs_and_tb(tmp_path, cvor):
    """One step with valid_freq 1 (after tests/test_training.py:380): the
    TB logger receives train/{loss,epe,lr} and val/epe, and PNGs land for
    validation SAMPLES 0 and 3 (3 is the second batch's second sample),
    each the colour wheel of that sample's last accumulated flow; the
    latest and best checkpoints hold step 1."""
    class TBStub:
        def __init__(self):
            self.writes = []

        def write_dict(self, scalars, step=None):
            self.writes.append((dict(scalars), step))

    tb = TBStub()
    state = engine.train_acc(_opts(tmp_path, cvor, valid_freq=1, visual_samples=[0, 3]),
                             max_steps=1, tb=tb, device="cpu")
    keys = set().union(*(set(s) for s, _ in tb.writes))
    assert {"train/loss", "train/epe", "train/lr", "val/epe"} <= keys
    for i in (0, 3):
        pngs = glob.glob(str(tmp_path / "logs" / "val" / f"im{i:03d}" / "*.png"))
        assert [osp.basename(p) for p in pngs] == ["000001.png"]
    _, valid = engine.make_acc_train_step(
        build_flow_estimator("raft", compute_dtype="float32", small=True, device="cpu"),
        state.model, state.optimizer, add_noise=False)
    dst = engine.fetch_valid_dataset(cvor, ["bflows"])
    batch = [dst.get(i) for i in (2, 3)]  # the validation batch that holds sample 3
    _, flow = valid(np.stack([b["imgs"] for b in batch]), np.stack([b["bflows"] for b in batch]))
    from PIL import Image

    png = np.asarray(Image.open(tmp_path / "logs" / "val" / "im003" / "000001.png"))
    np.testing.assert_array_equal(png, j_flow_to_image(flow[1].numpy()))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.best_steps() == [1] and ckpt.latest_step() == 1


def test_cli_trains_from_a_config(tmp_path, cvor):
    """python -m accflow_tpu_torch.cli.train_acc -c <config> --max-steps 2
    --device cpu, through main(argv), on configs/AccRAFT.yml's fields with
    the data, sizes and widths cut for the CPU; without --device it runs on
    the card, and with no card it raises."""
    text = open("configs/AccRAFT.yml").read()
    cut = {"dataset_root": cvor, "batch_per_gpu": 2, "image_size": "[48, 48]",
           "compute_dtype": "float32", "valid_freq": 2, "flow_pretrained": "~"}
    lines = [ln for ln in text.splitlines() if ln.split(":")[0] not in cut]
    lines += [f"{k}: {v}" for k, v in cut.items()]
    lines += ["small: true", f"acc_hidden: {HIDDEN}", f"log_dir: {tmp_path / 'logs'}",
              f"ckpt_dir: {tmp_path / 'ckpt'}"]
    cfg = tmp_path / "AccRAFT-cpu.yml"
    cfg.write_text("\n".join(lines) + "\n")
    state = cli_train_acc.main(["-c", str(cfg), "--max-steps", "2", "--device", "cpu"])
    assert state.step == 2
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli_train_acc.main(["-c", str(cfg), "--max-steps", "1"])


@pytest.mark.parametrize("path", sorted(glob.glob("configs/*.yml")))
def test_config_reader_matches_yaml(path):
    want = yaml.safe_load(open(path))
    got = config.parse_options(path)
    assert got == want
    assert all(type(got[k]) is type(want[k]) for k in want)
    assert got.lr == want["lr"]


@pytest.mark.parametrize("text", [
    "a:\n  b: 1\n",            # nesting
    "a: [1, [2]]\n",            # nested list
    "- 1\n",                    # block list
    "a: {b: 1}\n",              # flow mapping
    "a: &x 1\n",                # anchor
    "a: !!int 1\n",             # another tag
    "a: 1e-4\n",                # a string to YAML 1.1
    "a: yes\n",                 # a boolean to YAML 1.1
    "a: 1\na: 2\n",            # duplicate key
    "a: |\n  text\n",          # block scalar
])
def test_config_reader_refuses(text):
    with pytest.raises(ValueError):
        config.loads(text)


@pytest.mark.parametrize("op", ["corr_lookup", "corr_level_lookup", "y_contract"])
def test_kernel_ops_refuse_autograd(op):
    """Kernel #3 has no backward: a call of its op that autograd would
    record raises, naming fine_tune; under no_grad the same call runs. The
    lookup ops #1 and #2 have one (the backward kernel's ops): their
    gradient with respect to the levels is lookup_corr_plain_backward's
    (rtol 1e-6), the op's value under autograd is its value under no_grad,
    and coords that require grad raise."""
    gen = torch.Generator().manual_seed(0)
    levels = [torch.randn((6, 8 >> i, 8 >> i), generator=gen) for i in range(4)]
    coords = torch.rand((6, 2), generator=gen) * 7
    if op == "y_contract":
        wy = torch.rand((6, corr_bd_cuda.NUM, 8), generator=gen)
        with torch.no_grad():
            want = corr_bd_cuda.y_contract(levels[0], wy)
        levels[0].requires_grad_(True)
        with pytest.raises(RuntimeError, match="fine_tune"):
            corr_bd_cuda.y_contract(levels[0], wy)
        with torch.no_grad():
            assert torch.equal(corr_bd_cuda.y_contract(levels[0], wy), want)
        return
    radius = 4 if op == "corr_lookup" else 3
    if op == "corr_lookup":
        call = lambda lv, c: corr_cuda.lookup_corr_fused(lv, c)  # noqa: E731
    else:
        call = lambda lv, c: corr_level_cuda.lookup_corr_level(lv, c, radius)  # noqa: E731
    with torch.no_grad():
        want = call(levels, coords)
    for lvl in levels:
        lvl.requires_grad_(True)
    out = call(levels, coords)
    assert torch.equal(out.detach(), want)
    cot = torch.randn(out.shape, generator=gen)
    grads = torch.autograd.grad(out, levels, cot)
    ref = lookup_corr_plain_backward(cot, coords, [lvl.shape[1:] for lvl in levels], radius)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=0)
    with pytest.raises(RuntimeError, match="coords require grad"):
        call(levels, coords.requires_grad_(True))
