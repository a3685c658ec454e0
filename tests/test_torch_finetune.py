"""Estimator fine-tuning of the port (train/finetune.py and what it runs)
against JAX's train/finetune.py on the CPU, at 64x64, batch 2, full RAFT at
2 GRU iterations, float32, train-mode BatchNorm, noise off, the same init on
both sides (the port's seeded weights moved to JAX's layout by
to_jax_params, the cnet's running statistics drawn away from 0 and 1). The
GRU iteration counts of both packages' steps (12 to train, 20 to validate)
are cut by an adapter around each estimator.

- one step against JAX's make_finetune_step (compiled once; its optimizer
  state's first element keeps the step's raw gradients): loss rtol 1e-5;
  gradients per leaf rtol 1e-3, atol 1e-3 x that leaf's largest |grad|;
  the running statistics after the step against JAX's apply_bn_updates,
  rtol 1e-5. The biases of the convolutions that a normalisation follows
  (every conv of the fnet and the cnet but their last) have a gradient of
  0 in exact arithmetic, since the norm removes a per-channel constant:
  both packages give float32 noise there (~1e-10, up to 2.6x apart), so
  each such bias is held to |grad| <= 1e-5 x its conv weight's largest
  |grad| on both sides instead. A ReLU whose input lies within float32
  rounding of zero takes the other side of its kink in one package
  (test_torch_train.py): at this seed one element, channel 196 of the
  upsampling mask head's first conv (update_block.mask.0) at one pixel of
  the second iteration, 3.5e-8 against a median |input| of 0.05 in that
  channel, moves that conv's bias gradient by 5.9e-7 (5.7 % of the
  element, 1.6 % of the leaf's largest), so the mask head's leaves are
  held by their global relative L2 (<= 1e-2); every other leaf agrees
  within 6e-6 of its largest element;
- three steps (two batches cycled): losses rtol 1e-4, parameter deltas
  within tests/test_training.py:741-760's bounds;
- remat "dots" and "full" against "none" (and the lookups' forward and
  backward calls per step: "dots" keeps the lookup's output);
- the smaller pieces: select_pair, the plain lookup backward against
  jax.grad of JAX's lookup_corr, train-mode batch_norm, losses_extra,
  run_validation's cap, fine_tune end to end with resume, the CLI, the
  refusals of the lookups without a backward, and opcheck on the lookup ops
  and their backward ops.
GMA, RAFT-small and grad_accum 2 are in tests/test_torch_finetune_models.py,
so that the two files' JAX compiles run in parallel workers.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accflow_tpu import ops as j_ops
from accflow_tpu.data.cvo import BatchIterator as JBatchIterator
from accflow_tpu.data.cvo import fetch_train_dataset as j_fetch_train_dataset
from accflow_tpu.models import build_flow_estimator as j_build_flow_estimator
from accflow_tpu.nn import layers as j_layers
from accflow_tpu.train import finetune as j_ft
from accflow_tpu.train import losses_extra as j_losses
from accflow_tpu.train import optim as j_optim
from accflow_tpu.train.engine import TrainState as JTrainState
from accflow_tpu_torch.cli import fine_tune as cli_fine_tune
from accflow_tpu_torch.convert import load_jax_params, to_jax_params
from accflow_tpu_torch.data.synthetic import write_synthetic_cvor
from accflow_tpu_torch.models import build_flow_estimator
from accflow_tpu_torch.nn import layers
from accflow_tpu_torch.ops import corr_backward_cuda, corr_cuda
from accflow_tpu_torch.ops.corr import lookup_corr_plain_backward
from accflow_tpu_torch.train import finetune as ft
from accflow_tpu_torch.train import losses_extra
from accflow_tpu_torch.train.checkpoint import CheckpointManager
from accflow_tpu_torch.train.optim import make_optimizer
from accflow_tpu_torch.utils import config

N, SIZE, ITERS = 2, 64, 2
LR, STEPS, GAMMA = 2e-4, 3, 0.85


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs, restored after
    (several test workers share the machine: test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


class JIters:
    """JAX's estimator with every call's GRU iterations set to `iters`."""

    def __init__(self, est, iters):
        self.est, self.iters = est, iters

    def forward(self, params, image1, image2, iters=None, **kw):
        return self.est.forward(params, image1, image2, iters=self.iters, **kw)


class TIters:
    """The port's estimator with every call's GRU iterations set to `iters`."""

    def __init__(self, est, iters):
        self.est, self.iters, self.model = est, iters, est.model

    def forward(self, image1, image2, iters=None, **kw):
        return self.est.forward(image1, image2, iters=self.iters, **kw)


def _keep_grads():
    """An optax stage that passes the gradients on and keeps them as its
    state (tests/test_torch_train.py)."""
    return optax.GradientTransformation(lambda params: jax.tree.map(jnp.zeros_like, params),
                                        lambda updates, state, params=None: (updates, updates))


def _draw_bn_stats(tree, rng):
    """Running statistics away from the init's 0 and 1, in place."""
    for v in tree.values():
        if isinstance(v, dict):
            if "mean" in v and "var" in v:
                v["mean"] = (0.1 * rng.standard_normal(v["mean"].shape)).astype(np.float32)
                v["var"] = rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)
            else:
                _draw_bn_stats(v, rng)
    return tree


def _batch(rng, n=N, size=SIZE):
    img1, img2 = (rng.integers(0, 256, (n, size, size, 3)).astype(np.uint8) for _ in range(2))
    return img1, img2, (4.0 * rng.standard_normal((n, size, size, 2))).astype(np.float32)


def make_pair(name: str, size: int, iters: int, seed: int, grad_accum=(1,),
              normed=("fnet", "cnet"), **cfg):
    """Both packages' estimator `name` on the port's seeded init (the cnet's
    running statistics drawn), two batches, and JAX's fine-tune step for
    each grad_accum (noise off; compiled at its first call). normed: the
    encoders with a norm (normalized_biases)."""
    rng = np.random.default_rng(seed)
    tree = _draw_bn_stats(to_jax_params(build_flow_estimator(
        name, compute_dtype="float32", device="cpu", **cfg).model), rng)
    j_est = JIters(j_build_flow_estimator(name, compute_dtype="float32", **cfg), iters)
    tx, _ = j_optim.make_optimizer(LR, STEPS, 1e-5, 1e-8, 1.0,
                                   buffer_mask=j_layers.bn_buffer_mask(tree))
    tx = optax.chain(_keep_grads(), tx)
    steps = {k: j_ft.make_finetune_step(j_est, tx, add_noise=False, gamma=GAMMA,
                                        grad_accum=k)[0] for k in grad_accum}
    return dict(name=name, cfg=cfg, iters=iters, tree=tree, tx=tx, j_steps=steps, normed=normed,
                batches=[_batch(rng, size=size), _batch(rng, size=size)])


def j_state(pair):
    params = jax.tree.map(jnp.asarray, pair["tree"])
    return JTrainState(params, pair["tx"].init(params), jnp.int32(0))


def j_run(pair, state, batch, grad_accum=1):
    return pair["j_steps"][grad_accum](state, *(jnp.asarray(a) for a in batch),
                                       jax.random.PRNGKey(0))


def port_model(pair):
    est = build_flow_estimator(pair["name"], compute_dtype="float32", device="cpu",
                               **pair["cfg"])
    load_jax_params(est.model, pair["tree"])
    return est


def port_step(pair, est, remat="none", grad_accum=1):
    """The port's train step for `est`, whose optimizer keeps each step's
    raw gradients (before the clip) in `grads`."""
    optimizer = make_optimizer(est.model.parameters(), LR, STEPS, 1e-5, 1e-8, 1.0)
    grads = {}
    update = optimizer.step

    def step():
        grads.update({k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                      for k, p in est.model.named_parameters()})
        update()

    optimizer.step = step
    train_step, valid_step = ft.make_finetune_step(
        TIters(est, pair["iters"]), optimizer, add_noise=False, gamma=GAMMA,
        grad_accum=grad_accum, remat=remat)
    return train_step, valid_step, grads


def grad_leaves(model, grads) -> dict:
    """`grads` ({parameter name: tensor}) as JAX-layout leaves, without the
    running statistics."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for k, p in g.named_parameters():
            p.copy_(grads[k])
    return {k: v for k, v in _leaves(to_jax_params(g)).items()
            if not k.endswith(("/mean", "/var"))}


def normalized_biases(grads: dict, encoders) -> list:
    """The conv biases that a normalisation follows: in each of `encoders`
    (those with a norm), every conv's but the last one's (conv2 at the
    top)."""
    return [k for k in grads if k.endswith("/b") and k.split("/")[0] in encoders
            and k.split("/")[1] != "conv2"]


def assert_grads_match(got: dict, want: dict, zero_biases=(), l2_held=()):
    """Per leaf at rtol 1e-3, atol 1e-3 x its largest |grad|; the
    zero_biases near 0 on both sides; the leaves under the l2_held
    prefixes by their global relative L2 (<= 1e-2)."""
    assert set(got) == set(want)
    held = [k for k in want if k.startswith(tuple(l2_held))]
    if held:
        num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in held)
        assert (num / sum(float((want[k] ** 2).sum()) for k in held)) ** 0.5 <= 1e-2
    for k in want:
        if k in held:
            continue
        if k in zero_biases:
            scale = np.abs(want[k[:-1] + "w"]).max()
            assert np.abs(got[k]).max() <= 1e-5 * scale and np.abs(want[k]).max() <= 1e-5 * scale, k
            continue
        atol = 1e-3 * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=atol, err_msg=k)


def bn_stats(tree) -> dict:
    return {k: v for k, v in _leaves(tree).items() if k.endswith(("/mean", "/var"))}


def _flip_nearest_zero(flips: list):
    """A forward hook that flips the sign of its module's output element
    nearest zero, which must lie within 1e-6 x the median |output| of it: a
    ReLU input within float32 rounding of zero, which the two packages may
    round to either side of the kink."""
    def hook(module, inputs, out):
        a = out.detach().abs()
        idx = np.unravel_index(int(a.argmin()), a.shape)
        assert float(a[idx]) <= 1e-6 * float(a.median()), (idx, float(a[idx]))
        flips.append((idx, float(a[idx])))
        mask = torch.zeros_like(out)
        mask[idx] = 1.0
        return out - 2.0 * (out * mask).detach()  # the value flipped, the gradient passed

    return hook


def check_one_step(pair, grad_accum=1, l2_held=(), tie=None):
    """One step of each package from the same init on batch 0: loss,
    gradients and running statistics (module docstring's bars; the leaves
    under the l2_held prefixes by their global relative L2). tie: a module
    whose output holds a ReLU input within rounding of zero; the port then
    runs with it on either side (_flip_nearest_zero) and one of the two must
    meet every bar."""
    batch = pair["batches"][0]
    state, j_loss, _ = j_run(pair, j_state(pair), batch, grad_accum)
    want = {k: v for k, v in _leaves(jax.tree.map(np.asarray, state.opt_state[0])).items()
            if not k.endswith(("/mean", "/var"))}
    failures = []
    for flip in ((False,) if tie is None else (False, True)):
        est = port_model(pair)
        flips = []
        if flip:
            est.model.get_submodule(tie).register_forward_hook(_flip_nearest_zero(flips))
        train_step, _, grads = port_step(pair, est, grad_accum=grad_accum)
        loss, _ = train_step(*batch)
        try:
            np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
            assert_grads_match(grad_leaves(est.model, grads), want,
                               normalized_biases(want, pair["normed"]), l2_held)
            break
        except AssertionError as e:
            failures.append(e)
    else:
        raise failures[0]
    j_bn, t_bn = bn_stats(jax.tree.map(np.asarray, state.params)), bn_stats(to_jax_params(est.model))
    assert set(t_bn) == set(j_bn)
    for k in j_bn:
        np.testing.assert_allclose(t_bn[k], j_bn[k], rtol=1e-5, atol=1e-7, err_msg=k)
    init = bn_stats(pair["tree"])
    return {k: float(np.abs(j_bn[k] - init[k]).max()) for k in j_bn}, flips


@pytest.fixture(scope="module")
def raft():
    return make_pair("raft", SIZE, ITERS, seed=7)


def test_one_step_matches_jax(raft):
    moved, _ = check_one_step(raft, l2_held=("update_block/mask/",))
    # Train-mode BatchNorm ran: the cnet's 15 layers moved their statistics.
    assert len(moved) == 30 and min(moved.values()) > 0


def test_three_step_trajectory_matches_jax(raft):
    state = j_state(raft)
    est = port_model(raft)
    train_step, _, _ = port_step(raft, est)
    j_losses, losses = [], []
    for s in range(STEPS):
        batch = raft["batches"][s % 2]
        state, j_loss, _ = j_run(raft, state, batch)
        j_losses.append(float(j_loss))
        losses.append(float(train_step(*batch)[0]))
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    init = _leaves(raft["tree"])
    d_j = {k: v - init[k] for k, v in _leaves(jax.tree.map(np.asarray, state.params)).items()}
    d_t = {k: v - init[k] for k, v in _leaves(to_jax_params(est.model)).items()}
    num = sum(float(((d_t[k] - d_j[k]) ** 2).sum()) for k in d_j)
    den = sum(float((d_j[k] ** 2).sum()) for k in d_j)
    assert (num / den) ** 0.5 <= 5e-2
    for k in d_j:
        err = np.abs(d_t[k] - d_j[k])
        assert float(np.quantile(err, 0.999)) <= 1.5 * LR and err.max() <= 3 * LR, k


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gives_the_plain_step(raft, remat, monkeypatch):
    """remat changes what the backward stores, not the loss or the
    gradients (after tests/test_training.py:184's bars). The lookup's
    forward runs once per iteration under "dots", which keeps its output as
    JAX's checkpoint_dots keeps the lookup's einsums, and twice under
    "full"; its backward once per iteration."""
    batch = raft["batches"][0]
    runs = {}
    for mode in ("none", remat):
        fwd = _counting(monkeypatch, corr_cuda, "lookup_corr_plain")
        bwd = _counting(monkeypatch, corr_backward_cuda, "lookup_corr_plain_backward")
        est = port_model(raft)
        train_step, _, grads = port_step(raft, est, remat=mode)
        loss = float(train_step(*batch)[0])
        runs[mode] = (loss, grad_leaves(est.model, grads), len(fwd), len(bwd))
        monkeypatch.undo()
    (l0, g0, f0, b0), (l1, g1, f1, b1) = runs["none"], runs[remat]
    assert l1 == l0
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-4, atol=1e-5 * np.abs(g0[k]).max(),
                                   err_msg=k)
    assert (f0, b0, b1) == (ITERS, ITERS, ITERS)
    assert f1 == (ITERS if remat == "dots" else 2 * ITERS)


def test_select_pair_matches_jax():
    """50 draws from one seed pick the same slices as JAX's, the delta_*
    and fflows[interval - 2] cases among them."""
    rng = np.random.default_rng(1)
    batch = {"imgs": rng.integers(0, 256, (2, 4, 4, 21)).astype(np.uint8)}
    for key, c in (("fflows", 10), ("bflows", 10), ("delta_fflows", 12), ("delta_bflows", 12)):
        batch[key] = rng.standard_normal((2, 4, 4, c)).astype(np.float32)
    g_j, g_t = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(50):
        for got, want in zip(ft.select_pair(batch, g_t), j_ft.select_pair(batch, g_j)):
            np.testing.assert_array_equal(got, want)
    tb = {k: _t(v) for k, v in batch.items()}  # the engine slices device tensors
    for got, want in zip(ft.select_pair(tb, np.random.default_rng(4)),
                         j_ft.select_pair(batch, np.random.default_rng(4))):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("radius", [4, 3])
def test_plain_lookup_backward_matches_jax(radius):
    """lookup_corr_plain_backward against jax.grad of JAX's lookup_corr
    (the tent-weight einsums fine-tune differentiates) with respect to the
    levels, coords +-12 px off an 8x8 grid so that many windows leave the
    maps (maps 8^2 .. 1^2), rtol 1e-5 (atol 1e-6: both sum the same
    float32 products in another order)."""
    rng = np.random.default_rng(radius)
    b, h, w = 2, 8, 8
    q = b * h * w
    levels = [rng.standard_normal((q, h >> i, w >> i)).astype(np.float32) for i in range(4)]
    coords = (np.asarray(j_ops.coords_grid(b, h, w))
              + rng.uniform(-12, 12, (b, h, w, 2)).astype(np.float32))
    cot = rng.standard_normal((b, h, w, 4 * (2 * radius + 1) ** 2)).astype(np.float32)

    def obj(lv):
        pyr = j_ops.CorrPyramid(levels=tuple(lv), h1=h, w1=w)
        return jnp.sum(j_ops.lookup_corr(pyr, jnp.asarray(coords), radius) * cot)

    want = jax.grad(obj)([jnp.asarray(lv) for lv in levels])
    got = lookup_corr_plain_backward(_t(cot.reshape(q, -1)), _t(coords.reshape(q, 2)),
                                     [lv.shape[1:] for lv in levels], radius)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5, atol=1e-6)
    assert any(float(g.abs().max()) == 0 for g in got[0])  # a query whose window left its map


def test_batch_norm_train_matches_jax():
    """Train-mode batch_norm against JAX's batch_norm(train=True): output,
    the moved running statistics (unbiased running_var) and the gradients
    of x, weight and bias, rtol 1e-5."""
    rng = np.random.default_rng(2)
    x = (3.0 * rng.standard_normal((3, 5, 6, 4)) + 1.0).astype(np.float32)  # NHWC
    p = {"scale": rng.uniform(0.5, 1.5, 4), "bias": rng.standard_normal(4),
         "mean": rng.standard_normal(4), "var": rng.uniform(0.5, 2.0, 4)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def j_obj(xx, scale, bias):
        q = {**{k: jnp.asarray(v) for k, v in p.items()}, "scale": scale, "bias": bias}
        y = j_layers.batch_norm(q, xx, train=True)
        return jnp.sum(y * cot), (y, q["new_mean"], q["new_var"])

    (_, (y_j, m_j, v_j)), g_j = jax.value_and_grad(j_obj, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(p["scale"]), jnp.asarray(p["bias"]))
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    wt, bt = _t(p["scale"]).requires_grad_(True), _t(p["bias"]).requires_grad_(True)
    y, m, v = layers.batch_norm_train(xt, wt, bt, _t(p["mean"]), _t(p["var"]))
    (y.permute(0, 2, 3, 1) * _t(cot)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(), np.asarray(y_j), **tol)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), **tol)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), **tol)
    for got, want in zip((xt.grad.permute(0, 2, 3, 1), wt.grad, bt.grad), g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_batch_norm_modes_and_buffers():
    """BatchNorm2d: frozen by default (in torch's training mode too) it reads
    the running statistics and keeps nothing; under batch_statistics it
    keeps the moved statistics until collect_bn_updates takes them, and
    apply_bn_updates writes them. The running statistics are buffers, which
    AdamW never sees."""
    est = build_flow_estimator("raft", compute_dtype="float32", device="cpu")
    names = {k for k, _ in est.model.named_parameters()}
    assert not any(k.endswith(("running_mean", "running_var")) for k in names)
    x = torch.randn(2, 3, 16, 16)
    with torch.no_grad():
        est.model.train()
        frozen = est.model.cnet(x)
        est.model.eval()
    assert layers.collect_bn_updates(est.model) == {}
    torch.testing.assert_close(frozen, est.model.cnet(x), rtol=0, atol=0)
    with layers.batch_statistics(est.model.cnet):
        est.model.cnet(x)
    assert not est.model.cnet.norm1.batch_stats
    ups = layers.collect_bn_updates(est.model)
    assert len(ups) == 15 and layers.collect_bn_updates(est.model) == {}
    layers.apply_bn_updates(est.model, ups)
    assert torch.equal(est.model.cnet.norm1.running_mean, ups["cnet.norm1"][0])


@pytest.mark.parametrize("kind", ["l1", "l2", "charbonnier", "multiscale"])
def test_losses_extra_match_jax(kind):
    rng = np.random.default_rng(3)
    target = rng.standard_normal((2, 16, 12, 2)).astype(np.float32)
    if kind == "multiscale":
        preds = [rng.standard_normal((2, 16 >> i, 12 >> i, 2)).astype(np.float32)
                 for i in range(3)]
        got = losses_extra.multiscale_loss([_t(p) for p in preds], _t(target))
        want = j_losses.multiscale_loss([jnp.asarray(p) for p in preds], jnp.asarray(target))
    else:
        pred = rng.standard_normal(target.shape).astype(np.float32)
        got = losses_extra.get_loss(kind.upper())(_t(pred), _t(target))
        want = j_losses.get_loss(kind.upper())(jnp.asarray(pred), jnp.asarray(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        losses_extra.get_loss("huber")


def test_run_validation_caps_by_samples():
    """Capped at valid_sample + 1 samples, the last batch's surplus left
    out (after tests/test_training.py:336): 501 samples in 42 batches of
    12; a small set counts every sample once."""
    class FakeDataset:
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

        def get(self, i, rng=None):
            return {"imgs": np.full((4, 4, 3), i % 251, np.uint8),
                    "bflows": np.zeros((4, 4, 2), np.float32)}

    calls = []

    def valid_step(imgs, bflows):
        calls.append(imgs.shape[0])
        return torch.full((imgs.shape[0],), 2.0), None

    epe, n = ft.run_validation(valid_step, FakeDataset(1000), 12, "cpu", valid_sample=500)
    assert n == 501 and len(calls) == 42 and abs(epe - 2.0) < 1e-6
    assert ft.run_validation(valid_step, FakeDataset(30), 12, "cpu", valid_sample=500)[1] == 30


@pytest.fixture(scope="module")
def cvor(tmp_path_factory):
    """Synthetic CVOR at 64^2: 3 clips per split (6 training samples over
    clean+final), 3 test clips."""
    return write_synthetic_cvor(str(tmp_path_factory.mktemp("cvor")), num_train=3,
                                num_test=3, h=SIZE, w=SIZE)


def _opts(tmp_path, root, **kw):
    opt = config.AttrDict(
        exp_name="RAFT-cvo", small=True, epochs=2, lr=1e-4, wdecay=1e-5, epsilon=1e-8,
        compute_dtype="float32", batch_per_gpu=2, clip=1.0, add_noise=True, log_freq=1,
        valid_freq=2, image_size=[48, 48], dataset_root=root, valid_sample=1,
        log_dir=str(tmp_path / "logs"), ckpt_dir=str(tmp_path / "ckpt"), resume=None, seed=3,
        gamma=GAMMA)
    opt.update(kw)
    return opt


def test_fine_tune_draws_jax_pairs_and_resumes(tmp_path, cvor, monkeypatch):
    """fine_tune end to end (RAFT-small, 48^2 crops, noise on, 2 steps and a
    validation at step 2): each step's pair and label are what JAX's
    BatchIterator and select_pair give for the same seeds; the validation
    runs its capped pass; resume "auto" continues the count and the
    weights."""
    seen, valid_batches = [], []
    make = ft.make_finetune_step

    def recording(*a, **k):
        step, valid = make(*a, **k)

        def rec_step(img1, img2, label, gen):
            seen.append([np.array(x) for x in (img1, img2, label)])
            return step(img1, img2, label, gen)

        def rec_valid(imgs, bflows):
            valid_batches.append(imgs.shape[0])
            return valid(imgs, bflows)

        return rec_step, rec_valid

    monkeypatch.setattr(ft, "make_finetune_step", recording)
    state = ft.fine_tune(_opts(tmp_path, cvor), max_steps=2, device="cpu")
    assert state.step == 2 and valid_batches == [2]
    rng = np.random.default_rng(3 + 2)
    it = JBatchIterator(j_fetch_train_dataset(cvor, j_ft.ALL_FLOW_KEYS, crop_size=[48, 48]), 2,
                        shuffle=True, drop_last=True, seed=3, epoch=0)
    for got, jb in zip(seen, it):
        for g, w in zip(got, j_ft.select_pair(jb, rng)):
            np.testing.assert_array_equal(g, w)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() == 2 and ckpt.best_steps() == [2]
    weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert not torch.equal(weights["cnet.conv1.weight"],
                           build_flow_estimator("raft", compute_dtype="float32", small=True,
                                                device="cpu", seed=3).model.cnet.conv1.weight)
    resumed = ft.fine_tune(_opts(tmp_path, cvor, resume="auto"), max_steps=3, device="cpu")
    assert resumed.step == 3 and len(seen) == 3
    assert any(not torch.equal(v, weights[k]) for k, v in resumed.model.state_dict().items())
    assert ckpt.restore(2)["step"] == 2


def test_cli_fine_tunes_from_a_config(tmp_path, cvor):
    """python -m accflow_tpu_torch.cli.fine_tune -c <config> --max-steps 1
    --device cpu on configs/RAFT.yml's fields with the data, sizes and
    widths cut for the CPU; without --device it runs on the card, and with
    no card it raises."""
    text = open("configs/RAFT.yml").read()
    cut = {"dataset_root": cvor, "batch_per_gpu": 2, "image_size": "[48, 48]",
           "compute_dtype": "float32", "flow_pretrained": "~"}
    lines = [ln for ln in text.splitlines() if ln.split(":")[0] not in cut]
    lines += [f"{k}: {v}" for k, v in cut.items()]
    lines += ["small: true", f"log_dir: {tmp_path / 'logs'}", f"ckpt_dir: {tmp_path / 'ckpt'}"]
    cfg = tmp_path / "RAFT-cpu.yml"
    cfg.write_text("\n".join(lines) + "\n")
    state = cli_fine_tune.main(["-c", str(cfg), "--max-steps", "1", "--device", "cpu"])
    assert state.step == 1
    assert CheckpointManager(str(tmp_path / "ckpt")).restore()["step"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli_fine_tune.main(["-c", str(cfg), "--max-steps", "1"])


@pytest.mark.parametrize("lookup,match", [("experimental:fused_bd", "#16"),
                                          ("experimental:fused_bd2", "#16"),
                                          ("ondemand", None)])
def test_lookups_without_a_backward_raise(tmp_path, lookup, match):
    """A fine-tune through a lookup with no backward raises before any
    step, naming its ROADMAP item: the split lookups need kernel #3's
    backward (#16); the train forward raises the same for them. The
    volume-free ondemand lookup, which raised before it was ported, builds
    and differentiates into the features (its step is held against JAX by
    tests/test_torch_ondemand.py)."""
    opt = _opts(tmp_path, "unused", small=False, corr_lookup=lookup)
    est = build_flow_estimator("raft", compute_dtype="float32", corr_lookup=lookup,
                               device="cpu")
    img = np.zeros((1, 64, 64, 3), np.float32)
    if match is None:
        assert ft.build_estimator(opt, device="cpu").cfg.corr_lookup == lookup
        est.forward(img, img + 0.5, iters=1, train=True)["flow_up"].sum().backward()
        assert est.model.fnet.conv1.weight.grad.abs().sum() > 0
        return
    with pytest.raises(NotImplementedError, match=match):
        ft.build_estimator(opt, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        est.forward(img, img, iters=1, train=True)


@pytest.mark.parametrize("op", ["corr_lookup", "corr_level_lookup", "corr_lookup_backward",
                                "corr_level_lookup_backward"])
def test_lookup_ops_pass_opcheck(op):
    """torch.library.opcheck on the lookup ops with levels that require grad
    (their autograd is the backward kernel's op) and on the backward ops
    (their fake implementations give the real outputs' shapes and dtypes,
    so that a CUDA graph or torch.export can trace a fine-tune step)."""
    from accflow_tpu_torch.ops import corr_level_cuda

    gen = torch.Generator().manual_seed(0)
    q, hw = 12, [8, 8, 4, 4, 2, 2, 1, 1]
    levels = [torch.randn((q, 8 >> i, 8 >> i), generator=gen).requires_grad_(True)
              for i in range(4)]
    coords = torch.rand((q, 2), generator=gen) * 7
    cases = {
        "corr_lookup": (corr_cuda.corr_lookup_op, (levels, coords, torch.float32)),
        "corr_level_lookup": (corr_level_cuda.corr_level_lookup_op,
                              (levels, coords, 3, torch.bfloat16)),
        "corr_lookup_backward": (corr_backward_cuda.corr_lookup_backward_op,
                                 (torch.randn((q, 324), generator=gen), coords, hw, 4,
                                  torch.float32)),
        "corr_level_lookup_backward": (corr_backward_cuda.corr_level_lookup_backward_op,
                                       (torch.randn((q, 196), generator=gen), coords, hw, 3,
                                        torch.bfloat16)),
    }
    fn, args = cases[op]
    results = torch.library.opcheck(fn, args)
    assert set(results.values()) == {"SUCCESS"}, results
