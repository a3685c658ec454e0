"""Streaming of the PyTorch port (accflow_tpu_torch/streaming.py) against
the JAX package's, on the CPU in float32:
- StreamAccumulator (RAFT-small at 4 iterations + a hidden-32 accumulator
  with a perturbed ZeroConv, 6 frames of 32x32, batch 2) against JAX's
  StreamAccumulator in both ini_init modes, and with GMA (acc+gma), and
  against the port's own warm-started clip forward (accflow_forward with
  warm_start=True); rtol 2e-3 / atol 2e-2, the bar the
  JAX package meets against the PyTorch original
  (tests/test_model_parity.py:143);
- FlowStream.send on frames whose size is not a multiple of 8, and its
  frame coercion (api._as_frames) against JAX's;
- consecutive-pair streaming (make_pair_streaming_fns);
- the port's copy of make_long_sequence, bit for bit;
- the trained drift fixture (tests/fixtures/drift_small_{ofe,acc}.npz)
  replayed through the port, under both bounds of
  tests/test_streaming.py:250-258;
- the streaming export (export_streaming, save / load_streaming_artifact,
  StreamingArtifact) at batch 1: reset and 2 pushes equal the live
  StreamAccumulator exactly and JAX's StreamAccumulator at the stream bar;
  FlowStream over the artifact returns unpadded flows; a file without the
  port's magic (a JAX artifact among them) is refused; on the CPU the
  accumulator's step runs as it is (no CUDA graph)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu.api import _as_frames as j_as_frames
from accflow_tpu.data.synthetic import make_long_sequence as j_make_long_sequence
from accflow_tpu.models import build_flow_estimator as j_build_flow_estimator
from accflow_tpu.models.accflow import AccFlowConfig as JAccFlowConfig
from accflow_tpu.models.accflow import init_accflow as j_init_accflow
from accflow_tpu.streaming import StreamAccumulator as JStreamAccumulator
from accflow_tpu.streaming import make_pair_streaming_fns as j_make_pair_streaming_fns
from accflow_tpu_torch.api import _as_frames
from accflow_tpu_torch.convert import load_jax_params, load_npz_tree
from accflow_tpu_torch.data.synthetic import make_long_sequence
from accflow_tpu_torch.models import (
    AccFlowConfig,
    accflow_forward,
    build_flow_estimator,
    init_accflow,
)
from accflow_tpu_torch.streaming import (
    FlowStream,
    StreamAccumulator,
    StreamingArtifact,
    export_streaming,
    load_streaming_artifact,
    make_pair_streaming_fns,
    make_streaming_fns,
    save_streaming_artifact,
)

TOL = dict(rtol=2e-3, atol=2e-2)
ITERS = 4
FIXTURES = Path(__file__).parent / "fixtures"


def _perturb_zero_conv(params, rng):
    """init_accflow zeroes AccPlus's ZeroConv (conv2.4); fill it so the
    deformable conv really deforms."""
    zc = params["accplus"]["conv2"]["4"]
    zc["w"] = jnp.asarray(rng.standard_normal(zc["w"].shape) * 0.05, jnp.float32)
    zc["b"] = jnp.asarray(rng.standard_normal(zc["b"].shape) * 0.5, jnp.float32)
    zc["scale"] = jnp.asarray(rng.uniform(-0.1, 0.1, zc["scale"].shape), jnp.float32)
    return params


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    j_est = j_build_flow_estimator("raft", compute_dtype="float32", small=True, iters=ITERS)
    ofe_params = j_est.init(jax.random.PRNGKey(0))
    acfg = JAccFlowConfig(hidden=32, compute_dtype="float32", warm_start=True)
    acc_params = _perturb_zero_conv(j_init_accflow(jax.random.PRNGKey(1), acfg), rng)
    est = build_flow_estimator("raft", compute_dtype="float32", device="cpu", small=True,
                               iters=ITERS)
    load_jax_params(est.model, ofe_params)
    acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32", warm_start=True),
                       device="cpu")
    load_jax_params(acc, acc_params)
    frames = rng.uniform(-1, 1, (6, 2, 32, 32, 3)).astype(np.float32)
    return dict(j_est=j_est, ofe_params=ofe_params, acfg=acfg, acc_params=acc_params,
                est=est, acc=acc, frames=frames)


def _run(stream, frames):
    outs = [stream.reset(frames[:3])]
    for i in range(3, frames.shape[0]):
        outs.append(stream.push(frames[i]))
    return np.stack([np.asarray(o) for o in outs])


@pytest.mark.parametrize("ini_init", ["ini", "carry"])
def test_stream_matches_jax(setup, ini_init):
    s = setup
    ref = _run(JStreamAccumulator(s["j_est"], s["acfg"], s["ofe_params"], s["acc_params"],
                                  ini_init=ini_init), jnp.asarray(s["frames"]))
    sa = StreamAccumulator(s["est"], s["acc"], ini_init=ini_init)
    out = _run(sa, s["frames"])
    assert out.shape == (4, 2, 32, 32, 2) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)
    fmap_n, fmap_prev, cn, c_prev, carry, dflow, flow_ini = sa.state
    assert tuple(fmap_n.shape) == (2, 128, 4, 4) and tuple(cn.shape) == (2, 32, 4, 4)
    assert all(tuple(f.shape) == (2, 4, 4, 2) for f in (carry, dflow, flow_ini))


def test_stream_gma_matches_jax():
    """StreamAccumulator with GMA (acc+gma: the attention of each new frame
    built once for both of its pair queries) against JAX's, 5 frames of
    32x32, batch 1, 3 iterations; gamma drawn nonzero."""
    rng = np.random.default_rng(13)
    j_est = j_build_flow_estimator("gma", compute_dtype="float32", iters=3)
    ofe_params = j_est.init(jax.random.PRNGKey(0))
    ofe_params["update_block"]["aggregator"]["gamma"] = jnp.full((1,), 3.0, jnp.float32)
    acfg = JAccFlowConfig(hidden=32, compute_dtype="float32", warm_start=True)
    acc_params = _perturb_zero_conv(j_init_accflow(jax.random.PRNGKey(1), acfg), rng)
    frames = rng.uniform(-1, 1, (5, 1, 32, 32, 3)).astype(np.float32)
    ref = _run(JStreamAccumulator(j_est, acfg, ofe_params, acc_params), jnp.asarray(frames))
    est = build_flow_estimator("gma", compute_dtype="float32", device="cpu", iters=3)
    load_jax_params(est.model, ofe_params)
    acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32", warm_start=True),
                       device="cpu")
    load_jax_params(acc, acc_params)
    out = _run(StreamAccumulator(est, acc), frames)
    assert out.shape == (3, 1, 32, 32, 2) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)


def test_stream_matches_warm_clip_forward(setup):
    """push() reproduces the in-clip warm-start recurrence."""
    s = setup
    out = _run(StreamAccumulator(s["est"], s["acc"]), s["frames"])
    clip = accflow_forward(s["acc"], s["frames"], ofe=s["est"].flow_fn())
    np.testing.assert_allclose(out, clip.numpy(), **TOL)


def test_stream_rejects(setup):
    with pytest.raises(ValueError, match="ini_init"):
        StreamAccumulator(setup["est"], setup["acc"], ini_init="anchor")
    with pytest.raises(RuntimeError, match="reset"):
        StreamAccumulator(setup["est"], setup["acc"]).push(setup["frames"][0])
    with pytest.raises(ValueError, match="flow_fn"):
        accflow_forward(setup["acc"], setup["frames"])
    cold = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32"), device="cpu")
    with pytest.raises(ValueError, match="pairs_fn"):
        accflow_forward(cold, setup["frames"], ofe=setup["est"].flow_fn())


def test_flow_stream_unpadded_frames(setup):
    """30x21 uint8 frames: FlowStream pads to 32x24, returns None while it
    seeds, then unpadded (30, 21, 2) flows equal to the accumulator's on
    the padded, normalized frames."""
    s = setup
    raw = np.random.default_rng(5).integers(0, 256, (5, 30, 21, 3)).astype(np.uint8)
    stream = FlowStream(StreamAccumulator(s["est"], s["acc"]))
    got = [stream.send(f) for f in raw]
    assert got[0] is None and got[1] is None
    assert all(g.shape == (30, 21, 2) and g.dtype == np.float32 for g in got[2:])
    # Sintel-mode padding: 2 rows and 3 columns split over both sides.
    norm = 2.0 * (raw.astype(np.float32) / 255.0) - 1.0
    padded = np.pad(norm, ((0, 0), (1, 1), (1, 2), (0, 0)), mode="edge")[:, None]
    ref = _run(StreamAccumulator(s["est"], s["acc"]), padded)[:, 0, 1:-1, 1:-2]
    np.testing.assert_allclose(np.stack(got[2:]), ref, rtol=1e-6, atol=1e-6)


def test_as_frames_matches_jax():
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (6, 5, 3)).astype(np.uint8)
    cases = [
        (rgb, False),                                          # HWC uint8
        (rgb[None].repeat(2, 0), False),                       # NHWC batch
        (rgb[..., 0], False),                                  # grayscale HW
        (np.concatenate([rgb, rgb[..., :1]], -1), False),      # RGBA
        (rgb.astype(np.float32), False),                       # float in [0, 255]
        (rng.uniform(-1, 1, (6, 5, 3)).astype(np.float32), True),
    ]
    for x, normalized in cases:
        (got, batched), (ref, j_batched) = (_as_frames(x, normalized),
                                            j_as_frames(x, normalized, "one"))
        assert batched == j_batched and got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    bad = [rng.uniform(0, 1, (6, 5, 3)),                      # looks [0, 1]-scaled
           rng.uniform(-1, 1, (6, 5, 3)),                     # looks normalized
           np.zeros((6, 5, 2)), np.zeros((1, 1, 6, 5, 3))]    # channels, rank
    for x in bad:
        with pytest.raises(ValueError):
            j_as_frames(x, False, "one")
        with pytest.raises(ValueError):
            _as_frames(x, False)


def test_pair_streaming_matches_jax(setup):
    s = setup
    j_init, j_step = j_make_pair_streaming_fns(s["j_est"], s["ofe_params"])
    init, step = make_pair_streaming_fns(s["est"])
    f = s["frames"]
    ref, j_state = j_init(jnp.asarray(f[0]), jnp.asarray(f[1]))
    out, state = init(f[0], f[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-3, atol=5e-3)
    for i in (2, 3):
        ref, j_state = j_step(j_state, jnp.asarray(f[i]))
        out, state = step(state, f[i])
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-3, atol=5e-3)


def test_make_long_sequence_matches_jax():
    kw = dict(seg_len=6, max_v=1, fg=True, fg_max_v=2)
    ours = make_long_sequence(np.random.default_rng(77), 64, 64, 36, **kw)
    ref = j_make_long_sequence(np.random.default_rng(77), 64, 64, 36, **kw)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    rot = dict(seg_len=4, max_v=2, rot_deg=3.0, zoom_amp=0.05, fg=False)
    ours = make_long_sequence(np.random.default_rng(3), 24, 32, 9, **rot)
    ref = j_make_long_sequence(np.random.default_rng(3), 24, 32, 9, **rot)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_drift_fixture_through_the_port():
    """The trained RAFT-small (6 iterations) and hidden-64 accumulator over
    the fixture's 36-frame sequence: EPE(i) for i = 2..35 within
    1.5 x recorded + 0.5 at every step, and the mean of the last 6 within
    2 x the mean of curve[2:8] + 1 (tests/test_streaming.py:250-258)."""
    est = build_flow_estimator("raft", compute_dtype="float32", device="cpu", small=True,
                               iters=6)
    load_jax_params(est.model, load_npz_tree(str(FIXTURES / "drift_small_ofe.npz")))
    acc = init_accflow(AccFlowConfig(hidden=64, compute_dtype="float32", warm_start=True),
                       device="cpu")
    load_jax_params(acc, load_npz_tree(str(FIXTURES / "drift_small_acc.npz")))
    ref_curve = np.load(FIXTURES / "drift_small_epe.npy")
    seq = make_long_sequence(np.random.default_rng(77), 64, 64, 36, seg_len=6, max_v=1,
                             fg=True, fg_max_v=2)
    imgs = (2.0 * (seq["imgs"].astype(np.float32) / 255.0) - 1.0)[:, None]
    with torch.inference_mode():
        outs = _run(StreamAccumulator(est, acc), imgs)[:, 0]
    gt = seq["bflows"][1: 1 + outs.shape[0]]
    curve = np.sqrt(((outs - gt) ** 2).sum(-1)).mean(axis=(1, 2))
    assert curve.shape == ref_curve.shape == (34,)
    assert (curve <= ref_curve * 1.5 + 0.5).all(), f"{curve} vs recorded {ref_curve}"
    assert curve[-6:].mean() <= 2.0 * curve[2:8].mean() + 1.0, curve


def test_accumulator_step_on_the_cpu_is_step_fn(setup):
    """On the CPU push runs make_streaming_fns' step as it is: no graph is
    captured, and the output and state are step_fn's, bit for bit."""
    s = setup
    sa = StreamAccumulator(s["est"], s["acc"])
    sa.reset(s["frames"][:3])
    state = sa.state
    out = sa.push(s["frames"][3])
    step = make_streaming_fns(s["est"], s["acc"])[1]
    ref, ref_state = step(state, torch.from_numpy(s["frames"][3]))
    assert sa._step.captures == 0
    assert torch.equal(out, ref) and all(torch.equal(a, b) for a, b in zip(sa.state, ref_state))


@pytest.fixture(scope="module")
def artifact(setup, tmp_path_factory):
    """setup's weights with 2 OFE iterations (the export traces each one),
    exported at batch 1 and saved; the JAX and port models beside it."""
    s = setup
    j_est = j_build_flow_estimator("raft", compute_dtype="float32", small=True, iters=2)
    est = build_flow_estimator("raft", compute_dtype="float32", device="cpu", small=True,
                               iters=2)
    load_jax_params(est.model, s["ofe_params"])
    programs = export_streaming(est, s["acc"], (1, 32, 32))
    path = str(tmp_path_factory.mktemp("streaming") / "stream.bin")
    save_streaming_artifact(path, *programs)
    return dict(path=path, programs=programs, est=est, j_est=j_est)


def test_streaming_artifact_equals_live_and_jax(setup, artifact):
    s, a = setup, artifact
    frames = s["frames"][:5, :1]
    art = load_streaming_artifact(a["path"], device="cpu")
    assert art.frame_shape == (1, 32, 32, 3)
    with pytest.raises(RuntimeError, match="reset"):
        art.push(frames[0])
    out = _run(art, frames)
    assert out.shape == (3, 1, 32, 32, 2) and np.isfinite(out).all()
    np.testing.assert_array_equal(out, _run(StreamAccumulator(a["est"], s["acc"]), frames))
    ref = _run(JStreamAccumulator(a["j_est"], s["acfg"], s["ofe_params"], s["acc_params"]),
               jnp.asarray(frames))
    np.testing.assert_allclose(out, ref, **TOL)


def test_flow_stream_over_the_artifact(setup, artifact):
    """30x29 uint8 frames pad to the artifact's 32x32; FlowStream returns
    unpadded (30, 29, 2) flows, the live accumulator's exactly (the
    programs as exported; the test above holds the saved file)."""
    raw = np.random.default_rng(5).integers(0, 256, (5, 30, 29, 3)).astype(np.uint8)
    art = FlowStream(StreamingArtifact(*artifact["programs"], device="cpu"))
    live = FlowStream(StreamAccumulator(artifact["est"], setup["acc"]))
    got, ref = [art.send(f) for f in raw], [live.send(f) for f in raw]
    assert got[0] is None and got[1] is None
    assert all(g.shape == (30, 29, 2) and g.dtype == np.float32 for g in got[2:])
    np.testing.assert_array_equal(np.stack(got[2:]), np.stack(ref[2:]))


@pytest.mark.parametrize("head", [b"SFLOWSTRM1\n", b"not an artifact"])
def test_streaming_artifact_refuses_other_files(artifact, tmp_path, head):
    """JAX's streaming magic (accflow_tpu/streaming.py) or none at all."""
    path = tmp_path / "other.bin"
    path.write_bytes(head + Path(artifact["path"]).read_bytes()[32:])
    with pytest.raises(ValueError, match="bad magic"):
        load_streaming_artifact(str(path), device="cpu")
