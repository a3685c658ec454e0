"""The pieces of the port's graphed train steps that run on the CPU
(graphs.CudaGraphedStep, the device learning rate of train/optim.py,
engine.graph_steps), against the eager steps and JAX's schedule. The
graphs themselves run only on a card: tests/test_torch_cuda.py holds N
graphed steps against N eager ones there.

- CudaGraphedStep without a CUDA tensor calls the step and then `after`,
  once per call;
- an Optimizer whose learning rate is a 0-d float32 tensor (what
  make_optimizer builds for CUDA parameters), stepped by OneCycleLR in
  place, against today's float-rate Optimizer over 30 steps with the clip
  active: parameters within 1e-7, the rate within 1e-6 relative of JAX's
  onecycle_linear (float32 there, torch's float64 rounded once to float32
  here), the same tensor throughout and after load_state_dict;
- make_acc_train_step and make_finetune_step with graphed=True on CPU
  tensors (train_acc's and fine_tune's steps) against graphed=False over
  two steps with noise: losses, parameters, BatchNorm buffers and the
  learning rate bit-equal.
"""

import io

import numpy as np
import pytest
import torch

from accflow_tpu.train import optim as j_optim
from accflow_tpu_torch import graphs
from accflow_tpu_torch.models import AccFlowConfig, build_flow_estimator, init_accflow
from accflow_tpu_torch.train import engine
from accflow_tpu_torch.train import finetune as ft
from accflow_tpu_torch.train.optim import Optimizer, make_optimizer, one_cycle

LR, STEPS = 1.2e-4, 30


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs, restored after
    (tests/test_torch_train.py: several worker processes share the
    machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("array", [torch.ones, np.ones], ids=["tensor", "numpy"])
def test_graphed_step_on_cpu_calls_step_then_after(array):
    """Without a CUDA tensor the step runs as it is, on whatever it is
    given (train_acc's CPU batches are numpy arrays), then `after`."""
    calls = []

    def step(x, gen=None):
        calls.append(("step", gen))
        return torch.as_tensor(x) * 2, {"m": torch.as_tensor(x).sum()}

    wrapped = graphs.CudaGraphedStep(step, after=lambda: calls.append(("after", None)))
    gen = torch.Generator()
    for _ in range(3):
        y, metrics = wrapped(array(2), gen)
    assert calls == [("step", gen), ("after", None)] * 3
    assert torch.equal(y, torch.full((2,), 2.0, dtype=y.dtype)) and float(metrics["m"]) == 2.0
    assert wrapped.captures == 0 and wrapped.eager_calls == 0


def _params(seed):
    rng = np.random.default_rng(seed)
    return [torch.nn.Parameter(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
            for s in ((3, 4), (5,), (2, 2, 3))]


def _device_rate_optimizer(params):
    """make_optimizer's recipe with the rate a 0-d float32 tensor, on the
    CPU (foreach off: torch's foreach AdamW takes a tensor rate only when
    capturable, which the CPU is not)."""
    opt = torch.optim.AdamW(params, lr=torch.tensor(LR, dtype=torch.float32),
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-5, foreach=False)
    return Optimizer(opt, one_cycle(opt, LR, STEPS), clip=1.0)


def _step_both(opts, params, rng):
    """One update of every optimizer with the same gradients (norm ~5 and
    more: the clip at 1.0 acts)."""
    grads = [rng.standard_normal(p.shape).astype(np.float32) * 3 for p in params[0]]
    for opt, ps in zip(opts, params):
        opt.zero_grad()
        for p, g in zip(ps, grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()


def test_device_rate_matches_float_rate_and_jax_schedule():
    params = [_params(0), _params(0)]
    floats = make_optimizer(params[0], LR, STEPS)
    tensors = _device_rate_optimizer(params[1])
    rate = tensors.optimizer.param_groups[0]["lr"]
    assert isinstance(floats.optimizer.param_groups[0]["lr"], float)
    schedule = j_optim.onecycle_linear(LR, STEPS + 100, 0.05)
    rng = np.random.default_rng(1)
    got, want = [], []
    for i in range(STEPS):
        got.append(tensors.lr)
        want.append(float(schedule(i)))
        assert tensors.lr == np.float32(floats.lr)
        _step_both((floats, tensors), params, rng)
        assert tensors.optimizer.param_groups[0]["lr"] is rate  # written in place
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    for a, b in zip(*params):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-7)


def test_device_rate_survives_load_state_dict():
    params = [_params(0), _params(0)]
    rng = np.random.default_rng(2)
    first = _device_rate_optimizer(params[0])
    for _ in range(5):
        _step_both((first,), params[:1], rng)
    resumed = _device_rate_optimizer(params[1])
    rate = resumed.optimizer.param_groups[0]["lr"]
    with torch.no_grad():
        for p, q in zip(params[1], params[0]):
            p.copy_(q)
    saved = io.BytesIO()  # through torch.save and torch.load, as train/checkpoint.py
    torch.save(first.state_dict(), saved)
    saved.seek(0)
    resumed.load_state_dict(torch.load(saved, map_location="cpu"))
    assert resumed.optimizer.param_groups[0]["lr"] is rate and resumed.lr == first.lr
    assert resumed.scheduler.last_epoch == first.scheduler.last_epoch == 5
    _step_both((first, resumed), params, rng)
    for a, b in zip(*params):
        assert torch.equal(a, b)
    assert resumed.lr == first.lr


def _acc_case():
    """RAFT-small at 2 iterations, AccFlow hidden 16, clips of 4 frames."""
    est = build_flow_estimator("raft", compute_dtype="float32", small=True, iters=2,
                               device="cpu")
    rng = np.random.default_rng(3)
    batches = [(torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 12)).astype(np.float32)),
                torch.from_numpy((2 * rng.standard_normal((2, 64, 64, 4))).astype(np.float32)))
               for _ in range(2)]

    def make(graphed):
        model = init_accflow(AccFlowConfig(hidden=16, compute_dtype="float32"), seed=1,
                             device="cpu")
        optimizer = make_optimizer(model.parameters(), LR, STEPS)
        step, _ = engine.make_acc_train_step(est, model, optimizer, add_noise=True,
                                             graphed=graphed)
        return model, optimizer, step

    return make, batches


class _Iters:
    """The port's estimator with every call's GRU iterations set to 2."""

    def __init__(self, est):
        self.est, self.model = est, est.model

    def forward(self, image1, image2, iters=None, **kw):
        return self.est.forward(image1, image2, iters=2, **kw)


def _finetune_case():
    """Full RAFT (its cnet's BatchNorm on the batch's statistics) at 2
    iterations, remat "dots"."""
    rng = np.random.default_rng(4)
    batches = [tuple(torch.from_numpy(a) for a in (
        rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
        rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
        (2 * rng.standard_normal((2, 64, 64, 2))).astype(np.float32))) for _ in range(2)]

    def make(graphed):
        est = build_flow_estimator("raft", compute_dtype="float32", seed=0, device="cpu")
        optimizer = make_optimizer(est.model.parameters(), LR, STEPS)
        step, _ = ft.make_finetune_step(_Iters(est), optimizer, add_noise=True, gamma=0.85,
                                        graphed=graphed)
        return est.model, optimizer, step

    return make, batches


@pytest.mark.parametrize("case", [_acc_case, _finetune_case], ids=["train_acc", "fine_tune"])
def test_graphed_steps_on_cpu_equal_eager(case):
    make, batches = case()
    runs = {}
    for graphed in (False, True):
        model, optimizer, step = make(graphed)
        assert isinstance(step, graphs.CudaGraphedStep) == graphed
        gen = torch.Generator().manual_seed(7)
        losses = [step(*batch, gen)[0] for batch in batches]
        runs[graphed] = (losses, model.state_dict(), optimizer.lr, gen.get_state())
    (l0, s0, r0, g0), (l1, s1, r1, g1) = runs[False], runs[True]
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert s0.keys() == s1.keys() and all(torch.equal(s0[k], s1[k]) for k in s0)
    assert r0 == r1 and torch.equal(g0, g1)
