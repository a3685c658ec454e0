"""Data parallelism of the port (parallel/mesh.py and what runs under it)
on the CPU over gloo, against one process and against JAX.

- The mesh functions in one process (make_mesh, shard_batch, host_array,
  shard_params, average_gradients, all_mean, sync_processes) are the
  identity, and maybe_init_distributed's triggers follow torchrun's
  environment (monkeypatched); in a gloo world of one, the collectives
  given its group are exact copies, and batch_norm_train given the group
  is bit-equal to it given none, gradients included.
- One launch of two gloo ranks, each a process running this file as a
  script (`_child`), at batch_per_gpu 1:
  - a train_acc step (make_acc_train_step: full RAFT at 2 iterations,
    hidden 32, T=4, 64x64, float32, noise off) and a fine_tune step
    (make_finetune_step: full RAFT at 2 iterations, train-mode BatchNorm in
    the cnet, the running statistics drawn away from 0 and 1, 64x64,
    float32, noise off), each held against the same step in one process at
    batch 2 (loss and the rank-averaged gradients within 1e-6 relative L2)
    and against JAX's make_acc_train_step / make_finetune_step at batch 2
    with the bars of tests/test_torch_train.py and test_torch_finetune.py
    (the same seeds and constructions, so the same ReLU ties);
  - the BatchNorm running statistics after the step equal on both ranks,
    and within 1e-6 of one process's;
  - the step's noise: each rank's rows of one global draw;
  - batch_norm_train reduces over the group it is given and, given None,
    over its own rows alone although a group is active;
  - evaluate_cvo(data_parallel) on 2 synthetic clips at batch 2 and at
    batch 1 (a call padded to one row a rank): the gathered metrics equal
    one process's within 1e-5 (a batch of one against a batch of two;
    tests/test_warmstart_sintel.py's bar for the same comparison), and rank
    0 alone writes the result file;
  - train_acc end to end (RAFT-small, 2 steps and a validation): rank 0
    alone holds a log file handler and saves checkpoints, and the
    parameters end equal on both ranks.
"""

import contextlib
import copy
import logging
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accflow_tpu.models import accflow as j_acc
from accflow_tpu.models import build_flow_estimator as j_build_flow_estimator
from accflow_tpu.nn import layers as j_layers
from accflow_tpu.train import engine as j_engine
from accflow_tpu.train import finetune as j_ft
from accflow_tpu.train import optim as j_optim
from accflow_tpu_torch.convert import load_jax_params, load_npz_tree, save_npz_tree, to_jax_params
from accflow_tpu_torch.data.synthetic import write_synthetic_cvor
from accflow_tpu_torch.models import AccFlowConfig, build_flow_estimator, init_accflow
from accflow_tpu_torch.nn import layers
from accflow_tpu_torch.parallel import mesh
from accflow_tpu_torch.train import engine
from accflow_tpu_torch.train import finetune as ft
from accflow_tpu_torch.train.checkpoint import CheckpointManager
from accflow_tpu_torch.train.evaluate import evaluate_cvo
from accflow_tpu_torch.train.optim import make_optimizer
from accflow_tpu_torch.utils import config

T, N, SIZE, ITERS, HIDDEN = 4, 2, 64, 2, 32
LR, STEPS, GAMMA = 2e-4, 4, 0.85
WORLD = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs, restored after
    (several test workers share the machine: test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _rel_l2(got: dict, want: dict, keys=None) -> float:
    keys = list(want) if keys is None else keys
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in keys)
    return (num / sum(float((want[k] ** 2).sum()) for k in keys)) ** 0.5


# ---------------------------------------------------------------------------
# What each rank (and one process, for the reference) runs
# ---------------------------------------------------------------------------

class TIters:
    """The port's estimator with every call's GRU iterations set to `iters`
    (tests/test_torch_finetune.py)."""

    def __init__(self, est, iters):
        self.est, self.iters, self.model = est, iters, est.model

    def forward(self, image1, image2, iters=None, **kw):
        return self.est.forward(image1, image2, iters=self.iters, **kw)


@contextlib.contextmanager
def _rank_mean_grads(model, out: dict):
    """Record `model`'s gradients as the update sees them: after the mean
    over ranks, before the clip, as JAX-layout leaves in `out`."""
    orig = mesh.average_gradients

    def recording(params, group, sp=None):
        orig(params, group, sp)
        g = copy.deepcopy(model)
        with torch.no_grad():
            for p, q in zip(g.parameters(), model.parameters()):
                p.copy_(q.grad)
        out.update(_leaves(to_jax_params(g)))

    mesh.average_gradients = recording
    try:
        yield
    finally:
        mesh.average_gradients = orig


def _acc_step(work: str) -> dict:
    """One train_acc step on this rank's rows of the saved batch."""
    est = build_flow_estimator("raft", compute_dtype="float32", iters=ITERS, device="cpu")
    load_jax_params(est.model, load_npz_tree(f"{work}/acc_ofe.npz"))
    model = load_jax_params(init_accflow(AccFlowConfig(hidden=HIDDEN, compute_dtype="float32"),
                                         device="cpu"), load_npz_tree(f"{work}/acc.npz"))
    optimizer = make_optimizer(model.parameters(), LR, STEPS, 1e-5, 1e-8, 1.0)
    step, _ = engine.make_acc_train_step(est, model, optimizer, add_noise=False,
                                         group=mesh.data_group())
    batch = mesh.shard_batch(dict(np.load(f"{work}/acc_batch.npz")))
    grads = {}
    with _rank_mean_grads(model, grads):
        loss, metrics = step(batch["imgs"], batch["labels"])
    return {"acc_loss": float(loss), "acc_epe": float(metrics["epe"]),
            **{f"acc_grad/{k}": v for k, v in grads.items()}}


def _ft_step(work: str) -> dict:
    """One fine_tune step on this rank's rows of the saved batch."""
    est = build_flow_estimator("raft", compute_dtype="float32", device="cpu")
    load_jax_params(est.model, load_npz_tree(f"{work}/ft.npz"))
    optimizer = make_optimizer(est.model.parameters(), LR, 3, 1e-5, 1e-8, 1.0)
    step, _ = ft.make_finetune_step(TIters(est, ITERS), optimizer, add_noise=False, gamma=GAMMA,
                                    remat="none", group=mesh.data_group())
    batch = mesh.shard_batch(dict(np.load(f"{work}/ft_batch.npz")))
    grads = {}
    with _rank_mean_grads(est.model, grads):
        loss, _ = step(batch["img1"], batch["img2"], batch["label"])
    stats = {k: v for k, v in _leaves(to_jax_params(est.model)).items()
             if k.endswith(("/mean", "/var"))}
    return {"ft_loss": float(loss), **{f"ft_grad/{k}": v for k, v in grads.items()
                                       if not k.endswith(("/mean", "/var"))},
            **{f"ft_stats/{k}": v for k, v in stats.items()}}


def _noise() -> dict:
    gen = torch.Generator().manual_seed(5)
    return {"noise": engine.reference_noise(gen, (N // mesh.world_size(), 8, 8, 3),
                                            mesh.data_group()).numpy()}


def _bn_batch() -> np.ndarray:
    return np.random.default_rng(4).normal(0.5, 2.0, (N, 6, 5, 7)).astype(np.float32)


def _bn() -> dict:
    """batch_norm_train on this process's rows of a seeded batch, with the
    data group and with none: the layer reduces over the group it is given
    and nothing else, whatever process group is active."""
    x = torch.from_numpy(mesh.shard_batch(_bn_batch()))
    w, b = torch.linspace(0.5, 1.5, 6), torch.linspace(-0.2, 0.3, 6)
    out = {}
    for name, group in (("group", mesh.data_group()), ("local", None)):
        y, mean, var = layers.batch_norm_train(x, w, b, torch.zeros(6), torch.ones(6),
                                               group=group)
        out.update({f"bn_{name}/y": y.numpy(), f"bn_{name}/mean": mean.numpy(),
                    f"bn_{name}/var": var.numpy()})
    return out


def _eval(work: str) -> dict:
    """evaluate_cvo over the 2 clips at batch 2 (one row a rank) and at
    batch 1 (a call of one sample, padded to one row a rank)."""
    tree = load_npz_tree(f"{work}/acc_ofe.npz")
    out = {}
    for batch in (2, 1):
        res = evaluate_cvo("direct|raft", f"{work}/cvor", batch=batch, micro_batch=batch,
                           iters=ITERS, compute_dtype="float32", params=tree, device="cpu",
                           result_file=f"{work}/eval{batch}_rank{mesh.rank()}.txt")
        out.update({f"eval{batch}/{k}": v for k, v in res.items()})
    return out


def _engine(work: str) -> dict:
    """train_acc end to end: its side effects by rank, and the weights."""
    opt = config.AttrDict(
        exp_name="Acc+RAFT", small=True, acc_hidden=HIDDEN, epochs=2, lr=1e-4, wdecay=1e-5,
        epsilon=1e-8, compute_dtype="float32", batch_per_gpu=1, clip=1.0, add_noise=True,
        log_freq=1, valid_freq=2, image_size=[48, 48], dataset_root=f"{work}/cvor",
        log_dir=f"{work}/logs", ckpt_dir=f"{work}/ckpt", visual_samples=[0], resume=None,
        seed=3)
    saves = []
    orig = CheckpointManager._save
    CheckpointManager._save = lambda self, kind, step, *a: saves.append(kind) or orig(
        self, kind, step, *a)
    try:
        state = engine.train_acc(opt, max_steps=2, device="cpu")
    finally:
        CheckpointManager._save = orig
    handlers = logging.getLogger("accflow_torch").handlers
    return {"engine/file_handlers": sum(isinstance(h, logging.FileHandler) for h in handlers),
            "engine/saves": len(saves), "engine/step": state.step,
            "engine/params": torch.cat([p.detach().reshape(-1)
                                        for p in state.model.parameters()]).numpy()}


def _child(rank: int, port: int, work: str) -> None:
    """One rank of the launch: join the gloo group through torchrun's
    environment, run every case, save what it saw."""
    os.environ.update(WORLD_SIZE=str(WORLD), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    assert mesh.maybe_init_distributed("cpu")
    out = {}
    for case in (lambda: _acc_step(work), lambda: _ft_step(work), _noise, _bn,
                 lambda: _eval(work), lambda: _engine(work)):
        out.update(case())
        mesh.sync_processes("case")
    np.savez(f"{work}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# The launch and the references
# ---------------------------------------------------------------------------

def _keep_grads():
    """An optax stage that passes the gradients on and keeps them as its
    state (tests/test_torch_train.py)."""
    return optax.GradientTransformation(lambda params: jax.tree.map(jnp.zeros_like, params),
                                        lambda updates, state, params=None: (updates, updates))


def _draw_bn_stats(tree, rng):
    """Running statistics away from the init's 0 and 1, in place
    (tests/test_torch_finetune.py)."""
    for v in tree.values():
        if isinstance(v, dict):
            if "mean" in v and "var" in v:
                v["mean"] = (0.1 * rng.standard_normal(v["mean"].shape)).astype(np.float32)
                v["var"] = rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)
            else:
                _draw_bn_stats(v, rng)
    return tree


def _write_inputs(work: str) -> None:
    """The two steps' weights and batches, as tests/test_torch_train.py's
    `pair` (seed 11) and test_torch_finetune.py's make_pair (seed 7) draw
    them, and the synthetic CVOR data."""
    rng = np.random.default_rng(11)
    est = build_flow_estimator("raft", compute_dtype="float32", iters=ITERS, device="cpu")
    acc = to_jax_params(init_accflow(AccFlowConfig(hidden=HIDDEN, compute_dtype="float32"),
                                     device="cpu"))
    zc = acc["accplus"]["conv2"]["4"]
    zc["w"] = (rng.standard_normal(zc["w"].shape) * 0.05).astype(np.float32)
    zc["b"] = (rng.standard_normal(zc["b"].shape) * 0.5).astype(np.float32)
    zc["scale"] = rng.uniform(-0.1, 0.1, zc["scale"].shape).astype(np.float32)
    save_npz_tree(f"{work}/acc_ofe.npz", to_jax_params(est.model))
    save_npz_tree(f"{work}/acc.npz", acc)
    imgs = rng.integers(0, 256, (N, SIZE, SIZE, 3 * T)).astype(np.float32)
    labels = (4.0 * rng.standard_normal((N, SIZE, SIZE, 2 * (T - 2)))).astype(np.float32)
    np.savez(f"{work}/acc_batch.npz", imgs=imgs, labels=labels)

    rng = np.random.default_rng(7)
    tree = _draw_bn_stats(to_jax_params(build_flow_estimator(
        "raft", compute_dtype="float32", device="cpu").model), rng)
    save_npz_tree(f"{work}/ft.npz", tree)
    img1, img2 = (rng.integers(0, 256, (N, SIZE, SIZE, 3)).astype(np.uint8) for _ in range(2))
    label = (4.0 * rng.standard_normal((N, SIZE, SIZE, 2))).astype(np.float32)
    np.savez(f"{work}/ft_batch.npz", img1=img1, img2=img2, label=label)
    write_synthetic_cvor(f"{work}/cvor", num_train=4, num_test=2, h=SIZE, w=SIZE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launch:
    """Two gloo ranks started at setup; `ranks()` waits for them (a time
    limit) and returns what each saved."""

    def __init__(self, work: str):
        self.work = work
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=REPO)
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "child",
                                        str(r), str(port), work], cwd=work, env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                      for r in range(WORLD)]
        self._out = None

    def ranks(self):
        if self._out is None:
            logs = []
            for p in self.procs:
                try:
                    logs.append(p.communicate(timeout=240)[0].decode(errors="replace"))
                finally:
                    if p.poll() is None:
                        p.kill()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
            self._out = [dict(np.load(f"{self.work}/rank{r}.npz")) for r in range(WORLD)]
        return self._out


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("dp"))
    _write_inputs(work)
    run = Launch(work)
    yield run
    for p in run.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _section(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def test_mesh_single_process():
    """Without a process group every mesh function is the identity."""
    assert not mesh.active() and mesh.world_size() == 1 and mesh.is_main_process()
    assert mesh.make_mesh() == mesh.Mesh(1, 1, 0)
    with pytest.raises(ValueError, match="n_data=2"):
        mesh.make_mesh(n_data=2)
    with pytest.raises(ValueError, match="n_spatial=2"):
        mesh.make_mesh(n_spatial=2)  # a world of one does not split into two
    batch = {"a": np.arange(6).reshape(3, 2), "b": torch.arange(3)}
    sharded = mesh.shard_batch(batch)
    np.testing.assert_array_equal(sharded["a"], batch["a"])
    assert torch.equal(sharded["b"], batch["b"])
    np.testing.assert_array_equal(mesh.host_array(torch.arange(4.0)), np.arange(4.0))
    lin = torch.nn.Linear(3, 2)
    before = [p.detach().clone() for p in lin.parameters()]
    assert mesh.shard_params(lin) is lin
    lin(torch.ones(1, 3)).sum().backward()
    grads = [p.grad.clone() for p in lin.parameters()]
    assert mesh.data_group() is None
    mesh.average_gradients(lin.parameters(), None)
    assert all(torch.equal(p.grad, g) for p, g in zip(lin.parameters(), grads))
    assert all(torch.equal(p, b) for p, b in zip(lin.parameters(), before))
    tree = (torch.tensor(1.5), {"epe": torch.tensor(2.0)})
    assert mesh.all_mean(tree, None) is tree
    mesh.sync_processes("noop")
    assert mesh.collectives_capturable()


def test_maybe_init_distributed_triggers(monkeypatch):
    """No torchrun environment: no group. WORLD_SIZE > 1 or
    ACCFLOW_DISTRIBUTED=1 with a part of it missing raises; with all of it
    (a world of one, gloo on the CPU) the group comes up and the engines
    see it."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "ACCFLOW_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.maybe_init_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK"):
        mesh.maybe_init_distributed("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.maybe_init_distributed("cpu") is False
    monkeypatch.setenv("ACCFLOW_DISTRIBUTED", "1")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        mesh.maybe_init_distributed("cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert mesh.maybe_init_distributed("cpu") is True
        assert mesh.active() and mesh.world_size() == 1 and mesh.rank() == 0
        assert torch.distributed.get_backend() == "gloo"
        assert not mesh.collectives_capturable()
        assert mesh.maybe_init_distributed("cpu") is True  # already up
        grads = torch.nn.Linear(3, 2)
        grads(torch.ones(1, 3)).sum().backward()
        want = [p.grad.clone() for p in grads.parameters()]
        group = mesh.data_group()
        assert group is not None
        mesh.average_gradients(grads.parameters(), group)  # a world of one: an exact copy
        assert all(torch.equal(p.grad, g) for p, g in zip(grads.parameters(), want))
        x = torch.from_numpy(_bn_batch()).requires_grad_()
        w, b = torch.linspace(0.5, 1.5, 6), torch.linspace(-0.2, 0.3, 6)
        outs = [layers.batch_norm_train(x, w, b, torch.zeros(6), torch.ones(6), group=g)
                for g in (group, None)]
        grads_x = [torch.autograd.grad((o[0] * x.detach().cos()).sum(), x)[0] for o in outs]
        for a, c in zip([*outs[0], grads_x[0]], [*outs[1], grads_x[1]]):
            assert torch.equal(a, c)  # a group of one: the local statistics' bits
        np.testing.assert_array_equal(mesh.host_array(torch.arange(3.0)), np.arange(3.0))
    finally:
        torch.distributed.destroy_process_group()
    assert not mesh.active()


def test_two_ranks_train_acc_step(launch):
    """2 ranks x batch 1 against 1 process x batch 2 (1e-6 relative L2)
    and against JAX's make_acc_train_step at batch 2 (test_torch_train.py's
    bars: loss rtol 1e-5; per leaf rtol 1e-3, atol 1e-3 x its largest
    |grad|; the context encoder by its relative L2 <= 1e-2, for the ReLU tie
    that file names)."""
    work = launch.work
    one = _acc_step(work)
    ranks = launch.ranks()
    ref = _section(one, "acc_grad/")
    for r in ranks:
        got = _section(r, "acc_grad/")
        assert set(got) == set(ref)
        assert _rel_l2(got, ref) <= 1e-6
        assert abs(float(r["acc_loss"]) - one["acc_loss"]) <= 1e-6 * abs(one["acc_loss"])
    assert all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0] if "acc_grad/" in k)

    j_est = j_build_flow_estimator("raft", compute_dtype="float32", iters=ITERS)
    tx, _ = j_optim.make_optimizer(LR, num_steps=STEPS, wdecay=1e-5, epsilon=1e-8, clip=1.0)
    tx = optax.chain(_keep_grads(), tx)
    j_step, _ = j_engine.make_acc_train_step(
        j_est, j_acc.AccFlowConfig(hidden=HIDDEN, compute_dtype="float32"), tx, add_noise=False)
    acc = jax.tree.map(jnp.asarray, load_npz_tree(f"{work}/acc.npz"))
    batch = np.load(f"{work}/acc_batch.npz")
    state, j_loss, _ = j_step(j_engine.TrainState(acc, tx.init(acc), jnp.int32(0)),
                              load_npz_tree(f"{work}/acc_ofe.npz"), jnp.asarray(batch["imgs"]),
                              jnp.asarray(batch["labels"]), jax.random.PRNGKey(0))
    want = _leaves(jax.tree.map(np.asarray, state.opt_state[0]))
    got = _section(ranks[0], "acc_grad/")
    np.testing.assert_allclose(float(ranks[0]["acc_loss"]), float(j_loss), rtol=1e-5)
    ctx = [k for k in want if k.startswith("context/")]
    for k in want:
        if k not in ctx:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                       atol=1e-3 * float(np.abs(want[k]).max()), err_msg=k)
    assert _rel_l2(got, want, ctx) <= 1e-2


def test_two_ranks_fine_tune_step(launch):
    """The BatchNorm path: 2 ranks x batch 1 against 1 process x batch 2
    (gradients within 1e-6 relative L2, running statistics within 1e-6,
    equal on both ranks) and against JAX's make_finetune_step at batch 2
    (test_torch_finetune.py's bars: loss rtol 1e-5; per leaf rtol 1e-3,
    atol 1e-3 x its largest |grad|; the biases that a norm follows near 0
    on both sides; the mask head by its relative L2 <= 1e-2, for that
    file's ReLU tie; the running statistics rtol 1e-5, atol 1e-7)."""
    work = launch.work
    one = _ft_step(work)
    ranks = launch.ranks()
    ref, ref_stats = _section(one, "ft_grad/"), _section(one, "ft_stats/")
    for r in ranks:
        assert _rel_l2(_section(r, "ft_grad/"), ref) <= 1e-6
        assert abs(float(r["ft_loss"]) - one["ft_loss"]) <= 1e-6 * abs(one["ft_loss"])
        stats = _section(r, "ft_stats/")
        for k in ref_stats:
            np.testing.assert_allclose(stats[k], ref_stats[k], rtol=1e-6, atol=1e-7, err_msg=k)
    for k in ref_stats:
        np.testing.assert_array_equal(ranks[0]["ft_stats/" + k], ranks[1]["ft_stats/" + k])

    class JIters:
        def __init__(self, est):
            self.est = est

        def forward(self, params, image1, image2, iters=None, **kw):
            return self.est.forward(params, image1, image2, iters=ITERS, **kw)

    tree = load_npz_tree(f"{work}/ft.npz")
    tx, _ = j_optim.make_optimizer(LR, 3, 1e-5, 1e-8, 1.0,
                                   buffer_mask=j_layers.bn_buffer_mask(tree))
    tx = optax.chain(_keep_grads(), tx)
    j_step = j_ft.make_finetune_step(JIters(j_build_flow_estimator("raft",
                                                                   compute_dtype="float32")),
                                     tx, add_noise=False, gamma=GAMMA)[0]
    params = jax.tree.map(jnp.asarray, tree)
    batch = np.load(f"{work}/ft_batch.npz")
    state, j_loss, _ = j_step(j_engine.TrainState(params, tx.init(params), jnp.int32(0)),
                              *(jnp.asarray(batch[k]) for k in ("img1", "img2", "label")),
                              jax.random.PRNGKey(0))
    want = {k: v for k, v in _leaves(jax.tree.map(np.asarray, state.opt_state[0])).items()
            if not k.endswith(("/mean", "/var"))}
    got = _section(ranks[0], "ft_grad/")
    np.testing.assert_allclose(float(ranks[0]["ft_loss"]), float(j_loss), rtol=1e-5)
    assert set(got) == set(want)
    held = [k for k in want if k.startswith("update_block/mask/")]
    assert _rel_l2(got, want, held) <= 1e-2
    zero_biases = [k for k in want if k.endswith("/b") and k.split("/")[0] in ("fnet", "cnet")
                   and k.split("/")[1] != "conv2"]
    for k in want:
        if k in held:
            continue
        if k in zero_biases:
            scale = np.abs(want[k[:-1] + "w"]).max()
            assert np.abs(got[k]).max() <= 1e-5 * scale and np.abs(want[k]).max() <= 1e-5 * scale
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want[k]).max()), err_msg=k)
    j_stats = {k: v for k, v in _leaves(jax.tree.map(np.asarray, state.params)).items()
               if k.endswith(("/mean", "/var"))}
    for k in j_stats:
        np.testing.assert_allclose(ranks[0]["ft_stats/" + k], j_stats[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_two_ranks_noise_is_one_draw(launch):
    """Each rank adds its rows of the global batch's noise draw."""
    gen = torch.Generator().manual_seed(5)
    whole = engine.reference_noise(gen, (N, 8, 8, 3)).numpy()
    for r, out in enumerate(launch.ranks()):
        np.testing.assert_array_equal(out["noise"], whole[r: r + 1])


def test_two_ranks_batch_norm_takes_its_group(launch):
    """batch_norm_train under the two-rank group: given the group, each rank
    normalises its row with the global batch's statistics (one process at
    batch 2 within 1e-6); given None, with its own row's alone (bit-equal
    to one process on that row), whatever group is active."""
    x = torch.from_numpy(_bn_batch())
    w, b = torch.linspace(0.5, 1.5, 6), torch.linspace(-0.2, 0.3, 6)
    whole = layers.batch_norm_train(x, w, b, torch.zeros(6), torch.ones(6))
    for r, out in enumerate(launch.ranks()):
        np.testing.assert_allclose(out["bn_group/y"], whole[0][r: r + 1].numpy(), rtol=1e-6,
                                   atol=1e-6)
        for i, k in ((1, "mean"), (2, "var")):
            np.testing.assert_allclose(out[f"bn_group/{k}"], whole[i].numpy(), rtol=1e-6)
        own = layers.batch_norm_train(x[r: r + 1], w, b, torch.zeros(6), torch.ones(6))
        for i, k in enumerate(("y", "mean", "var")):
            np.testing.assert_array_equal(out[f"bn_local/{k}"], own[i].numpy())


def test_two_ranks_evaluate_cvo(launch):
    """evaluate_cvo(data_parallel): at batch 2 each rank runs one row; at
    batch 1 the call of one sample is padded to two rows, one a rank. The
    gathered metrics equal one process's (1e-5), on both ranks; rank 0
    alone writes the result line."""
    work = launch.work
    one = _eval(work)
    ranks = launch.ranks()
    for batch in (2, 1):
        ref = _section(one, f"eval{batch}/")
        for r in ranks:
            got = _section(r, f"eval{batch}/")
            assert set(got) == {"all", "occ", "vis"}
            for k in got:
                np.testing.assert_allclose(float(got[k]), ref[k], rtol=1e-5, atol=1e-5,
                                           err_msg=k)
        assert os.path.exists(f"{work}/eval{batch}_rank0.txt")
        assert not os.path.exists(f"{work}/eval{batch}_rank1.txt")


def test_two_ranks_rank_zero_writes(launch):
    """train_acc under two ranks: rank 0 alone holds a log file handler and
    saves checkpoints (latest and best at step 2, final), one log file in
    all; both ranks end on the same weights after 2 steps."""
    r0, r1 = launch.ranks()
    assert int(r0["engine/step"]) == int(r1["engine/step"]) == 2
    assert int(r0["engine/file_handlers"]) == 1 and int(r1["engine/file_handlers"]) == 0
    assert int(r0["engine/saves"]) == 3 and int(r1["engine/saves"]) == 0
    logs = [f for f in os.listdir(f"{launch.work}/logs") if f.endswith(".log")]
    assert len(logs) == 1
    np.testing.assert_array_equal(r0["engine/params"], r1["engine/params"])
    assert np.isfinite(r0["engine/params"]).all()
    pngs = os.listdir(f"{launch.work}/logs/val/im000")
    assert pngs == ["000002.png"]


if __name__ == "__main__" and sys.argv[1:2] == ["child"]:
    _child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
