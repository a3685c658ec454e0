"""FlowPipeline and ArtifactPipeline of the port (accflow_tpu_torch/api.py)
against JAX's (accflow_tpu/api.py), after tests/test_api.py: on the CPU in
float32, 36x44 uint8 frames (padded to 40x48, so the padder works), 2
iterations. Both pipelines load the same weights from one checkpoint, the
.npz pair <stem>.acc.npz + <stem>.ofe.npz written by
accflow_tpu.convert.store from JAX trees (AccFlow's ZeroConv and GMA's
gamma drawn nonzero), so the checkpoint path is held too.

Bars: flows rtol 1e-3 / atol 5e-3 (the estimator's), long-range and stream
rtol 2e-3 / atol 2e-2 (AccFlow's); within the port 1e-5 (the same ops on
the same padded inputs); occlusion bits as the protocol's threshold of the
port's own flows, and on >= 99 % of the pixels as JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu.api import FlowPipeline as JFlowPipeline
from accflow_tpu.convert.store import save_params
from accflow_tpu.models.accflow import AccFlowConfig as JAccFlowConfig
from accflow_tpu.models.accflow import init_accflow as j_init_accflow
from accflow_tpu.models.gma import GMAConfig as JGMAConfig
from accflow_tpu.models.gma import init_gma as j_init_gma
from accflow_tpu.models.raft import RAFTConfig as JRAFTConfig
from accflow_tpu.models.raft import init_raft as j_init_raft
from accflow_tpu_torch import ArtifactPipeline, FlowPipeline, serving
from accflow_tpu_torch.models import accflow_forward
from accflow_tpu_torch.ops.occlusion import calc_occ_mask
from accflow_tpu_torch.ops.padding import InputPadder
from accflow_tpu_torch.train.evaluate import evaluate_sequence

H, W = 36, 44  # pads to 40x48
TOL = dict(rtol=1e-3, atol=5e-3)
ACC_TOL = dict(rtol=2e-3, atol=2e-2)


def _acc_tree(seed: int):
    rng = np.random.default_rng(seed)
    tree = j_init_accflow(jax.random.PRNGKey(1), JAccFlowConfig(compute_dtype="float32"))
    zc = tree["accplus"]["conv2"]["4"]
    zc["w"] = jnp.asarray(rng.standard_normal(zc["w"].shape) * 0.05, jnp.float32)
    zc["scale"] = jnp.asarray(rng.uniform(-0.1, 0.1, zc["scale"].shape), jnp.float32)
    return tree


def write_checkpoints(root, ofe: str) -> str:
    """Save a JAX `ofe` ("raft" or "gma") tree and an AccFlow tree as the
    .npz pair under root; returns the stem."""
    if ofe == "gma":
        tree = j_init_gma(jax.random.PRNGKey(0), JGMAConfig(compute_dtype="float32"))
        tree["update_block"]["aggregator"]["gamma"] = jnp.full((1,), 3.0, jnp.float32)
    else:
        tree = j_init_raft(jax.random.PRNGKey(0), JRAFTConfig(compute_dtype="float32"))
    stem = str(root / f"acc+{ofe}")
    save_params(stem + ".ofe.npz", tree)
    save_params(stem + ".acc.npz", _acc_tree(5))
    return stem


@pytest.fixture(scope="module")
def frames_u8():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    return np.stack([np.roll(base, 2 * i, axis=1) for i in range(3)], axis=0)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    stem = write_checkpoints(tmp_path_factory.mktemp("ckpt"), "raft")
    kw = dict(acc_ckpt=stem, compute_dtype="float32", iters=2)
    return (FlowPipeline.from_checkpoint("acc+raft", device="cpu", **kw),
            JFlowPipeline.from_checkpoint("acc+raft", **kw))


def _norm(u8):
    return 2.0 * (u8.astype(np.float32) / 255.0) - 1.0


def test_pair_flow_matches_jax(pipes, frames_u8):
    pipe, jpipe = pipes
    flow = pipe.pair_flow(frames_u8[0], frames_u8[1])
    assert flow.shape == (H, W, 2) and flow.dtype == np.float32
    np.testing.assert_allclose(flow, jpipe.pair_flow(frames_u8[0], frames_u8[1]), **TOL)
    # The estimator on the padded pair, unpadded: nothing more.
    i1, i2 = _norm(frames_u8[0])[None], _norm(frames_u8[1])[None]
    padder = InputPadder(i1.shape)
    out = pipe.est.forward(padder.pad_np(i1), padder.pad_np(i2), iters=2, final_only=True)
    np.testing.assert_allclose(flow, padder.unpad(out["flow_up"])[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    flow2 = pipe.pair_flow(_norm(frames_u8[0]), _norm(frames_u8[1]), normalized=True)
    np.testing.assert_allclose(flow2, flow, rtol=1e-6, atol=1e-6)


def test_pair_flow_batched_and_gray(pipes, frames_u8):
    pipe, jpipe = pipes
    b1, b2 = np.stack([frames_u8[0], frames_u8[1]]), np.stack([frames_u8[1], frames_u8[2]])
    flows = pipe.pair_flow(b1, b2)
    assert flows.shape == (2, H, W, 2)
    np.testing.assert_allclose(flows[0], pipe.pair_flow(frames_u8[0], frames_u8[1]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(flows, jpipe.pair_flow(b1, b2), **TOL)
    g = frames_u8[0][..., 0]
    np.testing.assert_allclose(
        pipe.pair_flow(g, frames_u8[1][..., 0]),
        pipe.pair_flow(np.stack([g] * 3, -1), np.stack([frames_u8[1][..., 0]] * 3, -1)),
        rtol=1e-6, atol=1e-6)
    rgba = np.concatenate([frames_u8[0], frames_u8[0][..., :1]], axis=-1)
    np.testing.assert_allclose(pipe.pair_flow(rgba, frames_u8[1]),
                               pipe.pair_flow(frames_u8[0], frames_u8[1]), rtol=1e-6, atol=1e-6)


def test_occlusion_matches_protocol_and_jax(pipes, frames_u8):
    """occlusion() = calc_occ_mask over the two directions' padded flows
    (the eval protocol's check, test_cvo.py:53-78), with JAX's flow and
    JAX's mask on >= 99 % of the pixels (a bit flips where the consistency
    error sits within the flows' float32 difference of the threshold)."""
    pipe, jpipe = pipes
    flow, occ = pipe.occlusion(frames_u8[0], frames_u8[1])
    assert flow.shape == (H, W, 2) and occ.shape == (H, W, 1)
    assert set(np.unique(occ)) <= {0.0, 1.0}
    fwd = pipe.pair_flow(frames_u8[0], frames_u8[1])
    bwd = pipe.pair_flow(frames_u8[1], frames_u8[0])
    np.testing.assert_allclose(flow, fwd, rtol=1e-5, atol=1e-5)
    padder = InputPadder(_norm(frames_u8[0])[None].shape)
    _, occ_fw = calc_occ_mask(torch.from_numpy(padder.pad_np(bwd[None])),
                              torch.from_numpy(padder.pad_np(fwd[None])))
    np.testing.assert_array_equal(occ, padder.unpad(occ_fw)[0].numpy())
    jflow, jocc = jpipe.occlusion(frames_u8[0], frames_u8[1])
    np.testing.assert_allclose(flow, jflow, **TOL)
    assert np.mean(occ == jocc) >= 0.99


def test_pairs_matches_jax_and_evaluate_sequence(pipes, frames_u8):
    pipe, jpipe = pipes
    flows = pipe.pairs(frames_u8, warm_start=True)
    assert flows.shape == (2, H, W, 2)
    np.testing.assert_allclose(flows, jpipe.pairs(frames_u8, warm_start=True), **TOL)
    clip = _norm(frames_u8)[:, None]
    padder = InputPadder(clip.shape)
    want = padder.unpad(evaluate_sequence(pipe.est, padder.pad_np(clip), iters=2,
                                          warm_start=True))[:, 0]
    np.testing.assert_allclose(flows, want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pipe.pairs(list(frames_u8), warm_start=True), flows,
                               rtol=1e-6, atol=1e-6)


def test_long_range_matches_jax_and_accflow_forward(pipes, frames_u8):
    pipe, jpipe = pipes
    outs = pipe.long_range(frames_u8)
    assert outs.shape == (1, H, W, 2)
    np.testing.assert_allclose(outs, jpipe.long_range(frames_u8), **ACC_TOL)
    clip = _norm(frames_u8)[:, None]
    padder = InputPadder(clip.shape)
    want = accflow_forward(pipe.acc, padder.pad_np(clip), pipe.est.pairs_fn(iters=2))
    np.testing.assert_allclose(outs, padder.unpad(want)[:, 0].numpy(), rtol=1e-5, atol=1e-5)
    outs_b = pipe.long_range(clip, normalized=True)
    assert outs_b.shape == (1, 1, H, W, 2)
    np.testing.assert_allclose(outs_b[:, 0], outs, rtol=1e-6, atol=1e-6)


def test_stream_matches_jax(pipes, frames_u8):
    """stream(): None while it seeds on the first two frames, then F_{i,0}."""
    pipe, jpipe = pipes
    seq = np.concatenate([frames_u8, np.roll(frames_u8[-1:], 2, axis=1)])
    mine, theirs = pipe.stream(iters=2), jpipe.stream(iters=2)
    for i, frame in enumerate(seq):
        got, ref = mine.send(frame), theirs.send(frame)
        if i < 2:
            assert got is None and ref is None
        else:
            assert got.shape == (H, W, 2)
            np.testing.assert_allclose(got, np.asarray(ref), **ACC_TOL)


def test_artifact_pipeline_matches_flow_pipeline(pipes, frames_u8, tmp_path):
    """A clip artifact of the pipeline's models at (3, 1, 40, 48): its
    long_range equals the pipeline's; what a fixed artifact refuses; "auto"
    cannot size a symbolic batch (tests/test_torch_demo.py runs one)."""
    pipe, _ = pipes
    path = str(tmp_path / "tiny.pt2")
    serving.save_artifact(serving.export_serving(pipe.est, pipe.acc, (3, 1, 40, 48, 3)), path)
    apipe = FlowPipeline.from_artifact(path, device="cpu")
    assert isinstance(apipe, ArtifactPipeline) and apipe.clip_shape == (3, 1, 40, 48, 3)
    np.testing.assert_allclose(apipe.long_range(frames_u8), pipe.long_range(frames_u8),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="3-frame"):
        apipe.long_range(np.repeat(frames_u8, 2, axis=0))
    with pytest.raises(ValueError, match="re-export"):
        apipe.long_range(np.zeros((3, 64, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="batch"):
        apipe.long_range(np.repeat(_norm(frames_u8)[:, None], 2, axis=1), normalized=True)
    with pytest.raises(ValueError, match="symbolic"):
        serving.export_serving(pipe.est, pipe.acc, (3, None, 40, 48, 3))


def test_api_errors(pipes, frames_u8):
    pipe, _ = pipes
    with pytest.raises(ValueError, match="disagree"):
        pipe.pair_flow(frames_u8[0], frames_u8[1][:-2])
    with pytest.raises(ValueError, match=">= 3 frames"):
        pipe.long_range(frames_u8[:2])
    with pytest.raises(ValueError, match="SEQUENCE"):
        pipe.pairs(frames_u8[0])
    with pytest.raises(ValueError, match="RGB"):
        pipe.pair_flow(np.zeros((8, 8, 5)), np.zeros((8, 8, 5)))
    ofe_only = FlowPipeline(pipe.est)
    for call in (lambda: ofe_only.long_range(frames_u8), lambda: ofe_only.stream()):
        with pytest.raises(ValueError, match="accumulator weights"):
            call()
    with pytest.raises(ValueError, match=r"\[0, 1\]-scaled"):
        pipe.pair_flow(np.random.default_rng(0).uniform(0, 1, (8, 8, 3)),
                       np.zeros((8, 8, 3)) + 0.5)
    with pytest.raises(ValueError, match="already normalized"):
        pipe.pair_flow(_norm(frames_u8[0]), _norm(frames_u8[1]))


def test_pipeline_gma_matches_jax(frames_u8, tmp_path):
    """from_checkpoint('acc+gma') threads the cross-model knobs (iters,
    corr_lookup, attn_chunk) into GMA's config and loads the same
    checkpoint as JAX; pair_flow and long_range at the bars."""
    stem = write_checkpoints(tmp_path, "gma")
    kw = dict(acc_ckpt=stem, compute_dtype="float32", iters=2, corr_lookup="mm", attn_chunk=8)
    pipe = FlowPipeline.from_checkpoint("acc+gma", device="cpu", **kw)
    jpipe = JFlowPipeline.from_checkpoint("acc+gma", **kw)
    assert pipe.est.cfg.attn_chunk == 8 and pipe.est.cfg.iters == 2
    assert float(pipe.est.model.update_block.aggregator.gamma.detach()) == 3.0
    np.testing.assert_allclose(pipe.pair_flow(frames_u8[0], frames_u8[1]),
                               jpipe.pair_flow(frames_u8[0], frames_u8[1]), **TOL)
    np.testing.assert_allclose(pipe.long_range(frames_u8), jpipe.long_range(frames_u8),
                               **ACC_TOL)


def test_from_checkpoint_routing(monkeypatch):
    """ofe_ckpt loads the estimator even when the acc branch is on (the
    accumulator then from its seed); acc_ckpt with ofe_ckpt is an error."""
    import accflow_tpu_torch.convert as convert

    calls = {}
    monkeypatch.setattr(convert, "load_flow_estimator_checkpoint",
                        lambda path, model: calls.setdefault("ofe", path))
    pipe = FlowPipeline.from_checkpoint("acc+raft", ofe_ckpt="raft-things.pth",
                                        compute_dtype="float32", iters=2, device="cpu")
    assert calls["ofe"] == "raft-things.pth" and pipe.acc is not None
    with pytest.raises(ValueError, match="not both"):
        FlowPipeline.from_checkpoint("acc+raft", ofe_ckpt="a.pth", acc_ckpt="b.pth",
                                     device="cpu")
