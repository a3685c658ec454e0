"""The mesh's spatial axis of the port (parallel/mesh.py: image height
sharded over the ranks of a spatial group) on the CPU over gloo, against
one process and against the JAX package's unsharded runs.

- One launch of two gloo ranks, each a process running this file as a
  script (`_child`), at n_data 1, n_spatial 2; each rank holds its own rows
  of the inputs and gathers its outputs' rows for the comparison:
  - the primitives against the same function in one process, within 1e-5:
    the halo conv2d at 3x3, 7x7/2, 3x3/2, 1x1/2, 5x1, 1x5 and a 7x7 on an
    image of 4 rows (two a rank: a halo past the image's edge), instance_norm,
    convex_upsample, downflow8, backwarp, deform_conv3x3 and
    forward_splat_flow;
  - full RAFT's forward at 128^2, 2 iterations, float32, with "fused",
    "ondemand:64" and the split lookup "experimental:fused_bd", against
    JAX's unsharded est.forward with corr_lookup "mm" (rtol / atol 1e-3,
    tests/test_sharding.py:94,127);
  - the AccFlow clip (5 x 1 x 128^2, RAFT with "ondemand:64", hidden 128,
    its ZeroConv drawn so the deformable conv deforms) against JAX's
    unsharded "mm" clip at the AccFlow bar (rtol 2e-3 / atol 2e-2);
  - StreamAccumulator with warm_start (reset on 3 frames of 128^2 and 2
    pushes) against JAX's make_streaming_fns at the stream bar (rtol 2e-3 /
    atol 2e-2);
  - each of these also within 1e-4 x max |flow| of JAX's (FLOW_REL: the
    clip's and the stream's flows are ~0.1 px, so the AccFlow bar alone
    passes a run whose coordinates start every rank at row 0) and of the
    port's run in one process;
  - each rank's handle, and the collectives it counted.
- One launch of four gloo ranks: the primitives again on a (1, 4) mesh (1
  to 16 rows a rank: a 7x7 conv's halo then comes from three ranks up),
  and a (2, 2) mesh, each spatial pair on its own image, whose data groups
  are the mesh's columns.
- Without processes: make_mesh's rank layout against JAX's reshape of the
  device list, and the refusals (a height that does not split into blocks
  of 8 rows, GMA, RAFT-small, the stepwise, F0N and warm-start clip paths,
  a training forward with a handle).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from accflow_tpu_torch.convert import load_jax_params, load_npz_tree, save_npz_tree, to_jax_params
from accflow_tpu_torch.models import (
    AccFlowConfig,
    accflow_forward,
    build_flow_estimator,
    init_accflow,
)
from accflow_tpu_torch.nn import layers
from accflow_tpu_torch.ops.deform import deform_conv3x3
from accflow_tpu_torch.ops.grids import downflow8
from accflow_tpu_torch.ops.sampling import backwarp
from accflow_tpu_torch.ops.upsample import convex_upsample
from accflow_tpu_torch.ops.warmstart import forward_splat_flow
from accflow_tpu_torch.parallel import mesh
from accflow_tpu_torch.streaming import StreamAccumulator

WORLD, SIZE, ITERS = 2, 128, 2
LOOKUPS = ("fused", "ondemand:64", "experimental:fused_bd")
PRIM_TOL = dict(rtol=1e-5, atol=1e-5)
FLOW_TOL = dict(rtol=1e-3, atol=1e-3)  # tests/test_sharding.py's sharded-vs-unsharded bar
ACC_TOL = dict(rtol=2e-3, atol=2e-2)  # the AccFlow and stream bar (tests/test_torch_accflow.py)
# Beside those bars, a sharded output is held to JAX's within FLOW_REL x
# max |flow|. With random weights the clip's and the stream's flows are
# ~0.1 px, below ACC_TOL's atol, so that bar alone passes rows put in the
# wrong place (every rank's coordinates starting at row 0: 2.7e-2 and
# 7.4e-2 x max |flow| off). In float32 the two packages differ by summation
# order, ~3e-6 x max |flow| at these shapes.
FLOW_REL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs, restored after
    (several test workers share the machine: test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The primitives: each builds its whole inputs from a seed, runs on this
# rank's rows (spatial) or on the whole image (None), and returns the whole
# output (its rows gathered).
# ---------------------------------------------------------------------------

def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _conv(k, stride, h=32):
    def run(sp):
        rng = np.random.default_rng(10 * k[0] + k[1] + stride + h)
        x, w, b = _t(rng, 2, 3, h, 20), _t(rng, 4, 3, *k), _t(rng, 4)
        y = layers.conv2d(mesh.shard_rows(x, sp, 2), w, b, stride, spatial=sp)
        return mesh.gather_rows(y, sp, 2)
    return run


def _instance_norm(sp):
    rng = np.random.default_rng(1)
    x = _t(rng, 2, 5, 32, 20, scale=3.0) + _t(rng, 1, 5, 1, 1, scale=2.0)
    return mesh.gather_rows(layers.instance_norm(mesh.shard_rows(x, sp, 2), spatial=sp), sp, 2)


def _convex_upsample(sp):
    rng = np.random.default_rng(2)
    flow, mask = _t(rng, 2, 8, 10, 2, scale=3.0), _t(rng, 2, 8, 10, 576)
    up = convex_upsample(mesh.shard_rows(flow, sp), mesh.shard_rows(mask, sp), sp)
    return mesh.gather_rows(up, sp)


def _downflow8(sp):
    flow = _t(np.random.default_rng(3), 2, 64, 40, 2, scale=5.0)
    return mesh.gather_rows(downflow8(mesh.shard_rows(flow, sp), sp), sp)


def _backwarp(sp):
    rng = np.random.default_rng(4)
    image, flow = _t(rng, 2, 16, 12, 3), _t(rng, 2, 16, 12, 2, scale=4.0)
    return mesh.gather_rows(backwarp(image, mesh.shard_rows(flow, sp), sp), sp)


def _deform(sp):
    rng = np.random.default_rng(5)
    x, off, m = _t(rng, 2, 4, 16, 12), _t(rng, 2, 18, 16, 12, scale=3.0), _t(rng, 2, 9, 16, 12)
    w, b = _t(rng, 5, 4, 3, 3), _t(rng, 5)
    rows = [mesh.shard_rows(a, sp, 2) for a in (x, off, torch.sigmoid(m))]
    return mesh.gather_rows(deform_conv3x3(*rows, w, b, sp), sp, 2)


def _splat(sp):
    rng = np.random.default_rng(6)
    flow, advect = _t(rng, 2, 16, 12, 2, scale=3.0), _t(rng, 2, 16, 12, 2, scale=3.0)
    out = forward_splat_flow(mesh.shard_rows(flow, sp), mesh.shard_rows(advect, sp), sp)
    return mesh.gather_rows(out, sp)


PRIMITIVES = {
    "conv 3x3": _conv((3, 3), 1), "conv 7x7/2": _conv((7, 7), 2),
    "conv 3x3/2": _conv((3, 3), 2), "conv 1x1/2": _conv((1, 1), 2),
    "conv 5x1": _conv((5, 1), 1), "conv 1x5": _conv((1, 5), 1),
    "conv 7x7 on 4 rows": _conv((7, 7), 1, h=4),
    "instance_norm": _instance_norm, "convex_upsample": _convex_upsample,
    "downflow8": _downflow8, "backwarp": _backwarp, "deform_conv3x3": _deform,
    "forward_splat_flow": _splat,
}


# ---------------------------------------------------------------------------
# The models: weights and frames written by the launch, read by each rank
# and by the references
# ---------------------------------------------------------------------------

def _estimator(work: str, lookup: str):
    est = build_flow_estimator("raft", compute_dtype="float32", iters=ITERS, device="cpu",
                               corr_lookup=lookup)
    load_jax_params(est.model, load_npz_tree(f"{work}/ofe.npz"))
    return est


def _accumulator(work: str, warm_start: bool = False):
    acc = init_accflow(AccFlowConfig(compute_dtype="float32", warm_start=warm_start),
                       device="cpu")
    return load_jax_params(acc, load_npz_tree(f"{work}/acc.npz"))


def _models(sp, work: str) -> dict:
    """The RAFT forwards, the clip and the stream on this rank's rows (sp),
    or on the whole frames (None: the port's one-process runs); outputs
    whole, with the collectives each case counted."""
    data = np.load(f"{work}/inputs.npz")
    out = {}

    def case(name, fn):
        c0, b0 = mesh.collectives, mesh.bytes_sent
        out[name] = fn().numpy()
        out[f"{name}/collectives"] = mesh.collectives - c0
        out[f"{name}/bytes"] = mesh.bytes_sent - b0

    for lookup in LOOKUPS:
        est = _estimator(work, lookup)
        i1, i2 = (mesh.shard_rows(torch.from_numpy(data[k]), sp) for k in ("i1", "i2"))
        case(f"raft {lookup}",
             lambda: mesh.gather_rows(est.forward(i1, i2, spatial=sp)["flow_up"], sp))
    est, acc = _estimator(work, "ondemand:64"), _accumulator(work)
    clip = mesh.shard_rows(torch.from_numpy(data["clip"]), sp, 2)
    case("clip", lambda: mesh.gather_rows(
        accflow_forward(acc, clip, est.pairs_fn(spatial=sp), spatial=sp), sp, 2))
    stream = StreamAccumulator(_estimator(work, "fused"), _accumulator(work, True), spatial=sp)
    frames = mesh.shard_rows(torch.from_numpy(data["stream"]), sp, 2)

    def run_stream():
        outs = [stream.reset(frames[:3])] + [stream.push(frames[i]) for i in (3, 4)]
        return mesh.gather_rows(torch.stack(outs), sp, 2)

    case("stream", run_stream)
    return out


def _primitives(sp) -> dict:
    """Every primitive on this rank's rows, and in one process."""
    out = {}
    for name, fn in PRIMITIVES.items():
        out[f"prim/{name}"] = fn(sp).numpy()
        out[f"prim/{name}/ref"] = fn(None).numpy()
    return out


def _data_by_spatial(rank: int) -> dict:
    """A (2, 2) mesh: each data group's spatial pair runs a 3x3 conv and an
    instance norm on its own image (seed 100 + its data index), and the
    data group sums each member's rank."""
    m = mesh.make_mesh(n_data=2, n_spatial=2)
    d = rank // 2
    rng = np.random.default_rng(100 + d)
    x, w = _t(rng, 2, 3, 16, 12), _t(rng, 4, 3, 3, 3)

    def run(sp):
        y = layers.instance_norm(layers.conv2d(mesh.shard_rows(x, sp, 2), w, spatial=sp),
                                 spatial=sp)
        return mesh.gather_rows(y, sp, 2).numpy()

    ranks = torch.tensor([float(rank)])
    torch.distributed.all_reduce(ranks, group=m.data_group)
    return {"2x2/axis": np.array([m.axis.index, m.axis.size]), "2x2/out": run(m.axis),
            "2x2/ref": run(None), "2x2/data_sum": ranks.numpy()}


def _child(mode: str, world: int, rank: int, port: int, work: str) -> None:
    """One rank of a launch: join the gloo group through torchrun's
    environment, make the mesh, run the primitives (each beside its
    one-process run) and, for "models", the models on a (1, 2) mesh, for
    "meshes" the data x spatial check on a (2, 2) one; save what it saw."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    assert mesh.maybe_init_distributed("cpu")
    m = mesh.make_mesh(n_data=1, n_spatial=world)
    t0 = time.perf_counter()
    out = {"axis": np.array([m.axis.index, m.axis.size]), **_primitives(m.axis)}
    out.update(_models(m.axis, work) if mode == "models" else _data_by_spatial(rank))
    out["seconds"] = time.perf_counter() - t0
    np.savez(f"{work}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# The launch and the references
# ---------------------------------------------------------------------------

def _write_inputs(work: str) -> None:
    """Full RAFT's weights (seed 0) and the accumulator's (hidden 128, seed
    1, its ZeroConv drawn from seed 3), as JAX-layout trees, and the frames
    (uniform in [-1, 1], seeds as tests/test_sharding.py's)."""
    save_npz_tree(f"{work}/ofe.npz", to_jax_params(
        build_flow_estimator("raft", compute_dtype="float32", device="cpu").model))
    acc = to_jax_params(init_accflow(AccFlowConfig(compute_dtype="float32"), device="cpu"))
    rng = np.random.default_rng(3)
    zc = acc["accplus"]["conv2"]["4"]
    zc["w"] = (rng.standard_normal(zc["w"].shape) * 0.05).astype(np.float32)
    zc["b"] = (rng.standard_normal(zc["b"].shape) * 0.5).astype(np.float32)
    zc["scale"] = rng.uniform(-0.1, 0.1, zc["scale"].shape).astype(np.float32)
    save_npz_tree(f"{work}/acc.npz", acc)

    def frames(seed, shape):
        return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)

    pair = frames(1, (2, 1, SIZE, SIZE, 3))
    np.savez(f"{work}/inputs.npz", i1=pair[0], i2=pair[1], clip=frames(3, (5, 1, SIZE, SIZE, 3)),
             stream=frames(4, (5, 1, SIZE, SIZE, 3)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launch:
    """`world` gloo ranks running `mode` (_child), started at setup;
    `ranks()` waits for them (a time limit: a deadlocked collective fails
    the tests instead of hanging them) and returns what each saved."""

    def __init__(self, work: str, mode: str = "models", world: int = WORLD):
        self.work, self.world = work, world
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=REPO)
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "child", mode,
                                        str(world), str(r), str(port), work], cwd=work, env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                      for r in range(world)]
        self._out = None

    def ranks(self):
        if self._out is None:
            logs = []
            for p in self.procs:
                try:
                    logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
                finally:
                    if p.poll() is None:
                        p.kill()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
            self._out = [dict(np.load(f"{self.work}/rank{r}.npz")) for r in range(self.world)]
        return self._out


def _stop(run: Launch) -> None:
    for p in run.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("spatial"))
    _write_inputs(work)
    run = Launch(work)
    yield run
    _stop(run)


@pytest.fixture(scope="module")
def launch4(tmp_path_factory):
    """Four gloo ranks: the primitives on a (1, 4) mesh (a 7x7 conv at one
    row a rank reads its halo from three ranks up), then a (2, 2) mesh."""
    run = Launch(str(tmp_path_factory.mktemp("spatial4")), "meshes", 4)
    yield run
    _stop(run)


@pytest.fixture(scope="module")
def refs(launch):
    """JAX's unsharded runs (corr_lookup "mm") and the port's one-process
    runs, computed here while the ranks run."""
    import jax
    import jax.numpy as jnp

    from accflow_tpu.models import build_flow_estimator as j_build
    from accflow_tpu.models.accflow import AccFlowConfig as JAccFlowConfig
    from accflow_tpu.models.accflow import accflow_forward as j_accflow_forward
    from accflow_tpu.streaming import make_streaming_fns as j_make_streaming_fns

    work = launch.work
    data = np.load(f"{work}/inputs.npz")
    ofe, acc = load_npz_tree(f"{work}/ofe.npz"), load_npz_tree(f"{work}/acc.npz")
    j_est = j_build("raft", compute_dtype="float32", corr_lookup="mm", iters=ITERS)
    out = {"raft": np.asarray(jax.jit(lambda p, a, b: j_est.forward(p, a, b)["flow_up"])(
        ofe, jnp.asarray(data["i1"]), jnp.asarray(data["i2"])))}
    out["clip"] = np.asarray(jax.jit(lambda ap, op, ims: j_accflow_forward(
        ap, j_est.flow_fn(op), ims, JAccFlowConfig(compute_dtype="float32"),
        ofe_pairs=j_est.pairs_fn(op)))(acc, ofe, jnp.asarray(data["clip"])))
    init_fn, step_fn = j_make_streaming_fns(
        j_est, JAccFlowConfig(compute_dtype="float32", warm_start=True), ofe, acc)
    frames = jnp.asarray(data["stream"])
    flow, state = jax.jit(init_fn)(frames[:3])
    outs = [np.asarray(flow)]
    for i in (3, 4):
        flow, state = jax.jit(step_fn)(state, frames[i])
        outs.append(np.asarray(flow))
    out["stream"] = np.stack(outs)
    out["port"] = _models(None, work)
    return out


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_spatial_handles(launch):
    """Each rank holds the handle of its block of rows, and the models ran
    collectives (halos, gathers, sums) that it counted."""
    r0, r1 = launch.ranks()
    assert r0["axis"].tolist() == [0, 2] and r1["axis"].tolist() == [1, 2]
    for case in [f"raft {lookup}" for lookup in LOOKUPS] + ["clip", "stream"]:
        assert int(r0[f"{case}/collectives"]) == int(r1[f"{case}/collectives"]) > 0
        assert int(r0[f"{case}/bytes"]) > 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(PRIMITIVES))
def test_spatial_primitive_matches_one_process(request, name, world):
    """Over 2 ranks and over 4 (1 to 16 rows a rank), every rank's gathered
    output equal, within 1e-5 of one process's."""
    ranks = request.getfixturevalue("launch" if world == 2 else "launch4").ranks()
    got, ref = ranks[0][f"prim/{name}"], ranks[0][f"prim/{name}/ref"]
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **PRIM_TOL)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"prim/{name}"], got)


def test_data_by_spatial_mesh(launch4):
    """On a (2, 2) mesh each spatial pair shards its own image (a conv and
    an instance norm, within 1e-5 of one process), and the data groups are
    the columns: ranks {0, 2} and {1, 3}."""
    ranks = launch4.ranks()
    for r, out in enumerate(ranks):
        assert out["axis"].tolist() == [r, 4] and out["2x2/axis"].tolist() == [r % 2, 2]
        np.testing.assert_allclose(out["2x2/out"], out["2x2/ref"], **PRIM_TOL)
        assert float(out["2x2/data_sum"][0]) == 2 * (r % 2) + 2
    assert not np.allclose(ranks[0]["2x2/ref"], ranks[2]["2x2/ref"])


@pytest.mark.parametrize("lookup", LOOKUPS)
def test_spatial_raft_forward_matches_jax(launch, refs, lookup):
    """The sharded forward (either lookup) against JAX's unsharded "mm",
    and within 1e-4 x max |flow| of the port's one-process forward."""
    r0, r1 = launch.ranks()
    got, one = r0[f"raft {lookup}"], refs["port"][f"raft {lookup}"]
    assert got.shape == (1, SIZE, SIZE, 2)
    np.testing.assert_allclose(got, refs["raft"], **FLOW_TOL)
    assert np.abs(got - refs["raft"]).max() <= FLOW_REL * np.abs(refs["raft"]).max()
    np.testing.assert_array_equal(r1[f"raft {lookup}"], got)
    assert np.abs(got - one).max() <= 1e-4 * np.abs(one).max()


def test_spatial_clip_matches_jax(launch, refs):
    got = launch.ranks()[0]["clip"]
    assert got.shape == (3, 1, SIZE, SIZE, 2)
    np.testing.assert_allclose(got, refs["clip"], **ACC_TOL)
    assert np.abs(got - refs["clip"]).max() <= FLOW_REL * np.abs(refs["clip"]).max()


def test_spatial_clip_matches_one_process(launch, refs):
    got, ref = launch.ranks()[0]["clip"], refs["port"]["clip"]
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_spatial_stream_matches_jax(launch, refs):
    """reset and 2 warm-started pushes against JAX's init and step."""
    got = launch.ranks()[0]["stream"]
    assert got.shape == (3, 1, SIZE, SIZE, 2)
    np.testing.assert_allclose(got, refs["stream"], **ACC_TOL)
    assert np.abs(got - refs["stream"]).max() <= FLOW_REL * np.abs(refs["stream"]).max()


def test_spatial_stream_matches_one_process(launch, refs):
    got, ref = launch.ranks()[0]["stream"], refs["port"]["stream"]
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("n_data,n_spatial", [(1, 2), (2, 2), (4, 2)])
def test_mesh_layout_matches_jax(cpu_devices, n_data, n_spatial):
    from accflow_tpu.parallel.mesh import make_mesh as j_make_mesh

    devices = cpu_devices[: n_data * n_spatial]
    j_mesh = j_make_mesh(n_data, n_spatial, devices=devices)
    ids = {d.id: i for i, d in enumerate(devices)}
    want = np.vectorize(lambda d: ids[d.id])(j_mesh.devices)
    np.testing.assert_array_equal(mesh.mesh_layout(n_data, n_spatial), want)


def test_spatial_refusals(tmp_path):
    """A handle (never used for a collective here: each call refuses
    first) where the spatial axis is not ported, or where the height does
    not split into blocks of 8 rows."""
    sp = mesh.Spatial(None, 0, 2)
    with pytest.raises(ValueError, match="n_spatial=2"):
        mesh.make_mesh(n_spatial=2)
    est = build_flow_estimator("raft", compute_dtype="float32", iters=1, device="cpu")
    img = np.zeros((1, 12, 16, 3), np.float32)  # a rank's 12 rows of 24
    with pytest.raises(ValueError, match="multiple of 8"):
        est.forward(img, img, spatial=sp)
    with pytest.raises(ValueError, match="GMA"):
        build_flow_estimator("gma", compute_dtype="float32", device="cpu").pairs_fn(spatial=sp)
    small = build_flow_estimator("raft", compute_dtype="float32", small=True, device="cpu")
    with pytest.raises(ValueError, match="RAFT-small"):
        small.forward(img[:, :8], img[:, :8], spatial=sp)
    clip = np.zeros((4, 1, 16, 16, 3), np.float32)
    for kw in (dict(warm_start=True), dict(direction="forward"), dict(fused_ofe=False)):
        acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32", **kw),
                           device="cpu")
        with pytest.raises(ValueError, match="#12"):
            accflow_forward(acc, clip, est.pairs_fn(), est.flow_fn(), spatial=sp)
    with pytest.raises(ValueError, match="training over the spatial axis"):
        est.forward(img[:, :8], img[:, :8], train=True, spatial=sp)


if __name__ == "__main__" and sys.argv[1:2] == ["child"]:
    _child(sys.argv[2], *map(int, sys.argv[3:6]), sys.argv[6])
