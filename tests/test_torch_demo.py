"""The demo CLI of the port (accflow_tpu_torch/cli/demo.py) against JAX's
(accflow_tpu/cli/demo.py), after tests/test_demo.py: 3 PNG frames of 36x36
(padded to 40x40), 2 iterations, float32, the same weights on both sides
(the .npz checkpoints of tests/test_torch_api.py::write_checkpoints, GMA's
gamma and AccFlow's ZeroConv drawn nonzero). Each mode's .flo outputs are
held against JAX's demo on the same frames: pair flows at rtol 1e-3 /
atol 5e-3, long-range flows at rtol 2e-3 / atol 2e-2. The artifact modes
run programs that the port's export CLI writes (a GMA clip with chunked
attention and a symbolic batch; a RAFT stream) and equal the port's live
modes within 1e-4. The pairs mode also runs with --corr_lookup ondemand:8
(the volume-free lookup: at 40x40, 5 chunks of 5 queries) against JAX's demo
with the same lookup (tests/test_demo.py:52-66)."""

import os

import numpy as np
import pytest
import torch

from accflow_tpu.cli import demo as j_demo
from accflow_tpu.utils.frame_io import read_flow as j_read_flow
from accflow_tpu_torch.cli import demo
from accflow_tpu_torch.cli import export_serving
from accflow_tpu_torch.utils.frame_io import read_flow
from test_torch_api import write_checkpoints


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


SIZE = 36  # pads to 40
TOL = dict(rtol=1e-3, atol=5e-3)
ACC_TOL = dict(rtol=2e-3, atol=2e-2)
COMMON = ["--iters", "2", "--compute-dtype", "float32"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("demo")
    frames = root / "frames"
    frames.mkdir()
    base = np.random.default_rng(0).integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)
    for i in range(3):
        Image.fromarray(np.roll(base, 2 * i, axis=1)).save(frames / f"frame_{i:03d}.png")
    return dict(root=root, frames=str(frames), raft=write_checkpoints(root, "raft"),
                gma=write_checkpoints(root, "gma"))


def _run(env, name, args, jax_too=True):
    """The port's demo (on the CPU) and, with jax_too, JAX's on the same
    arguments; returns the two output directories."""
    out = str(env["root"] / name)
    demo.main(["--frames", env["frames"], "--out", out, "--device", "cpu", *COMMON, *args])
    if not jax_too:
        return out, None
    jout = str(env["root"] / f"jax_{name}")
    j_demo.main(["--frames", env["frames"], "--out", jout, *COMMON, *args])
    return out, jout


def _flo(out, name):
    path = os.path.join(out, name)
    assert os.path.exists(path), sorted(os.listdir(out))
    flow = read_flow(path)
    assert flow.shape == (SIZE, SIZE, 2) and np.isfinite(flow).all()
    return flow


def test_demo_pairs_mode(env):
    out, jout = _run(env, "pairs", ["--ofe_ckpt", env["raft"] + ".ofe.npz", "--warm_start"])
    for a, b in (("000", "001"), ("001", "002")):
        name = f"frame_{a}_to_frame_{b}"
        np.testing.assert_allclose(_flo(out, name + ".flo"), j_read_flow(
            os.path.join(jout, name + ".flo")), **TOL)
        assert os.path.exists(os.path.join(out, name + ".png"))  # the colour wheel


def test_demo_pairs_ondemand_lookup(env):
    out, jout = _run(env, "pairs_od", ["--ofe_ckpt", env["raft"] + ".ofe.npz", "--corr_lookup",
                                       "ondemand:8", "--no_viz"])
    name = "frame_000_to_frame_001.flo"
    np.testing.assert_allclose(_flo(out, name), j_read_flow(os.path.join(jout, name)), **TOL)


def test_demo_occ_mode(env):
    from PIL import Image

    out, jout = _run(env, "occ", ["--ofe_ckpt", env["raft"] + ".ofe.npz", "--occ", "--no_viz"])
    name = "frame_000_to_frame_001"
    np.testing.assert_allclose(_flo(out, name + ".flo"),
                               j_read_flow(os.path.join(jout, name + ".flo")), **TOL)
    mask = np.asarray(Image.open(os.path.join(out, name + "_occ.png")))
    jmask = np.asarray(Image.open(os.path.join(jout, name + "_occ.png")))
    assert mask.shape == (SIZE, SIZE) and set(np.unique(mask)) <= {0, 255}
    assert np.mean(mask == jmask) >= 0.99
    assert not os.path.exists(os.path.join(out, name + ".png"))


@pytest.fixture(scope="module")
def long_gma(env):
    return _run(env, "long", ["--mode", "long", "--ofe", "gma", "--acc_ckpt", env["gma"],
                              "--no_viz"])


@pytest.fixture(scope="module")
def stream_raft(env):
    return _run(env, "stream", ["--mode", "stream", "--stream_iters", "2", "--acc_ckpt",
                                env["raft"], "--no_viz"])


@pytest.mark.parametrize("mode", ["long_gma", "stream_raft"])
def test_demo_long_and_stream_modes(mode, request):
    out, jout = request.getfixturevalue(mode)
    name = "frame_002_to_frame_000.flo"
    np.testing.assert_allclose(_flo(out, name), j_read_flow(os.path.join(jout, name)),
                               **ACC_TOL)


def test_demo_bin_frames(env, long_gma, tmp_path):
    """Frames as .bin numpy files passed by name (read_gen's np.load
    branch, what chip_smoke.py feeds the demo): the PNG run's flows."""
    from PIL import Image

    files = []
    for i in range(3):
        files.append(str(tmp_path / f"frame_{i:03d}.bin"))
        with open(files[-1], "wb") as f:
            np.save(f, np.asarray(Image.open(os.path.join(env["frames"],
                                                          f"frame_{i:03d}.png"))))
    out = str(tmp_path / "out")
    demo.main(["--frames", *files, "--out", out, "--device", "cpu", *COMMON, "--mode", "long",
               "--ofe", "gma", "--acc_ckpt", env["gma"], "--no_viz"])
    name = "frame_002_to_frame_000.flo"
    np.testing.assert_array_equal(_flo(out, name), _flo(long_gma[0], name))


def test_demo_artifact_mode(env, long_gma):
    """export_serving --ofe gma --attn_chunk 16 --batch 0 (chunked attention,
    a symbolic batch) with the GMA checkpoint, then the demo from the
    artifact alone: the live long mode's flows (dense attention; chunked
    equals it). A frame size the artifact was not exported for is a
    clear error."""
    from PIL import Image

    path = str(env["root"] / "acc_gma.pt2")
    export_serving.main(["--ofe", "gma", "--attn_chunk", "16", "--acc_ckpt", env["gma"],
                         "--frames", "3", "--batch", "0", "--size", "40", "--device", "cpu",
                         *COMMON, "--out", path])
    out, _ = _run(env, "artifact", ["--artifact", path, "--no_viz"], jax_too=False)
    name = "frame_002_to_frame_000.flo"
    np.testing.assert_allclose(_flo(out, name), _flo(long_gma[0], name), rtol=1e-4, atol=1e-4)
    big = env["root"] / "big"
    big.mkdir()
    for i in range(3):
        Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(big / f"f{i}.png")
    with pytest.raises(SystemExit, match="re-export"):
        demo.main(["--frames", str(big), "--out", out, "--artifact", path, "--device", "cpu"])


def test_demo_streaming_artifact_mode(env, stream_raft):
    """export_serving --streaming with the RAFT checkpoint; the demo tells
    it apart by its magic and streams it: the live stream mode's flows."""
    path = str(env["root"] / "stream.bin")
    export_serving.main(["--streaming", "--acc_ckpt", env["raft"], "--batch", "1", "--size",
                         "40", "--device", "cpu", *COMMON, "--out", path])
    out, _ = _run(env, "sartifact", ["--artifact", path, "--no_viz"], jax_too=False)
    name = "frame_002_to_frame_000.flo"
    np.testing.assert_allclose(_flo(out, name), _flo(stream_raft[0], name), rtol=1e-4,
                               atol=1e-4)


def test_demo_rejects(env, tmp_path):
    from PIL import Image

    d = tmp_path / "one"
    d.mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(d / "a.png")
    with pytest.raises(SystemExit):
        demo.collect_frames([str(d)])
    with pytest.raises(SystemExit, match="exactly one"):
        demo.main(["--frames", "x", "--video", "y", "--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="video_stride"):
        demo.extract_video_frames(str(d / "a.png"), str(tmp_path / "v"), stride=0, limit=3)
