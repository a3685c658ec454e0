"""The volume-free correlation lookup of the port (`corr_lookup=
"ondemand[:chunk]"`, ops/corr.py::lookup_corr_on_demand) against JAX's
(accflow_tpu/ops/corr.py) on the CPU, where the chunks' rows go through the
lookup kernels' plain versions, after tests/test_ops_golden.py:309-400 and
:883, :405-460, :520-560, tests/test_eval.py:46,69 and
tests/test_training.py:150-180. Inputs are numpy from a seed, float32.

Tolerances: the op 1e-5 (the same float32 products and blends, in another
order); its gradient 1e-5 of the largest element; flows rtol 1e-3 / atol
5e-3 against JAX (the bar the JAX package meets against the PyTorch
original) and 1e-5 within the port between lookups that compute the same
function; EPEs rtol 1e-3 / atol 5e-3; the fine-tune step at
tests/test_torch_finetune.py's bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu import ops as j_ops
from accflow_tpu.models.gma import GMAConfig as JGMAConfig
from accflow_tpu.models.gma import gma_forward as j_gma_forward
from accflow_tpu.models.raft import RAFTConfig as JRAFTConfig
from accflow_tpu.models.raft import raft_forward as j_raft_forward
from accflow_tpu.ops.corr import CorrPyramid as JCorrPyramid
from accflow_tpu.train.evaluate import evaluate_cvo as j_evaluate_cvo
from accflow_tpu_torch.convert import load_jax_params, to_jax_params
from accflow_tpu_torch.data.synthetic import write_synthetic_cvor
from accflow_tpu_torch.models import AccFlowConfig, build_flow_estimator, gma, init_accflow
from accflow_tpu_torch.models import raft as raft_mod
from accflow_tpu_torch.ops import corr as corr_ops
from accflow_tpu_torch.ops.corr_cuda import lookup_corr_fused
from accflow_tpu_torch.train.evaluate import evaluate_cvo
from test_torch_finetune import check_one_step, make_pair


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


TOL = dict(rtol=1e-3, atol=5e-3)
OP_TOL = dict(rtol=1e-5, atol=1e-5)


def _features(seed, b=2, h=16, w=16, c=16, spread=20.0):
    """fmap1, fmap2 (B, H, W, C) and coords (B, H, W, 2) float32 numpy."""
    rng = np.random.default_rng(seed)
    f1, f2 = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(2))
    coords = np.asarray(j_ops.coords_grid(b, h, w)) + rng.uniform(
        -spread, spread, (b, h, w, 2)).astype(np.float32)
    return f1, f2, coords.astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _port_lookup(f1, f2, coords, chunk, dtype=torch.float32, prepared=False):
    od = corr_ops.build_corr_on_demand(_nchw(f1), _nchw(f2), 4, dtype=dtype)
    if prepared:
        od = corr_ops.prepare_ondemand_chunks(od, chunk)
    return corr_ops.lookup_corr_on_demand(od, torch.from_numpy(coords), 4, chunk)


@pytest.mark.parametrize("chunk", [0, 16, 64, 37])
def test_lookup_matches_jax_and_the_stored_volume(chunk):
    """Each chunking (0 AUTO, one chunk here; 37 rounds down to 32)
    against JAX's lookup_corr_on_demand and the port's stored pyramid."""
    f1, f2, coords = _features(0)
    od = j_ops.build_corr_on_demand(jnp.asarray(f1), jnp.asarray(f2), num_levels=4)
    ref = np.asarray(j_ops.lookup_corr_on_demand(od, jnp.asarray(coords), radius=4,
                                                 chunk=chunk))
    got = _port_lookup(f1, f2, coords, chunk)
    assert tuple(got.shape) == (2, 16, 16, 324) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **OP_TOL)
    levels = corr_ops.build_corr_pyramid(_nchw(f1), _nchw(f2), 4)
    stored = lookup_corr_fused(levels, torch.from_numpy(coords).reshape(-1, 2))
    np.testing.assert_allclose(got.numpy().reshape(-1, 324), stored.numpy(), **OP_TOL)


def test_prepared_chunks_and_the_chunk_rule():
    """f1 prepared chunk-major once (the GRU loop's form) gives the same
    windows; the chunk is the largest divisor of H*W not above the request,
    AUTO the largest whose float32 rows fit OD_AUTO_BYTES (>= 256)."""
    f1, f2, coords = _features(1)
    np.testing.assert_allclose(_port_lookup(f1, f2, coords, 64, prepared=True).numpy(),
                               _port_lookup(f1, f2, coords, 64).numpy(), rtol=0, atol=0)
    od = corr_ops.build_corr_on_demand(_nchw(f1), _nchw(f2), 4)
    assert [corr_ops.prepare_ondemand_chunks(od, c).chunk for c in (0, 16, 37, 1000)] == \
        [256, 16, 32, 256]
    assert corr_ops._auto_chunk(11, 57600, 76480) == corr_ops._divisor_chunk(57600, 1276) == 1200
    assert corr_ops._auto_chunk(2, 4096, 5440) == 4096


def test_bf16_rows_match_a_bf16_stored_volume():
    """Rows cast to bfloat16 before the lookup (the stored levels' type):
    the windows of a bfloat16 stored pyramid, and JAX's blend of the same
    bfloat16 rows in float32 (its gather lookup on the rounded levels)."""
    f1, f2, coords = _features(2)
    got = _port_lookup(f1, f2, coords, 64, dtype=torch.bfloat16)
    levels = corr_ops.build_corr_pyramid(_nchw(f1), _nchw(f2), 4, dtype=torch.bfloat16)
    stored = lookup_corr_fused(levels, torch.from_numpy(coords).reshape(-1, 2))
    np.testing.assert_allclose(got.numpy().reshape(-1, 324), stored.numpy(), **OP_TOL)
    pyr = j_ops.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), num_levels=4,
                                   dtype=jnp.bfloat16)
    pyr32 = JCorrPyramid(tuple(lv.astype(jnp.float32) for lv in pyr.levels), pyr.h1, pyr.w1)
    ref = np.asarray(j_ops.lookup_corr_gather(pyr32, jnp.asarray(coords), radius=4))
    np.testing.assert_allclose(got.numpy(), ref, **OP_TOL)


def test_gradient_matches_jax():
    """The gradient of sum(windows) with respect to both feature maps through
    4 recomputed chunks (nn.remat) against jax.grad of JAX's lookup."""
    f1, f2, coords = _features(3)
    a, b = (_nchw(x).requires_grad_() for x in (f1, f2))
    od = corr_ops.build_corr_on_demand(a, b, 4)
    corr_ops.lookup_corr_on_demand(od, torch.from_numpy(coords), 4, 64).sum().backward()

    def loss(x, y):
        odx = j_ops.build_corr_on_demand(x, y, num_levels=4)
        return j_ops.lookup_corr_on_demand(odx, jnp.asarray(coords), radius=4, chunk=64).sum()

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))
    for got, ref in zip((a.grad, b.grad), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("chunk", [0, 8])
def test_degenerate_level(chunk):
    """4x4 features pool to 2x2, 1x1 and a 0x0 coarsest level, whose
    windows are zeros (tests/test_ops_golden.py:883)."""
    f1, f2, coords = _features(4, b=1, h=4, w=4, c=8, spread=2.0)
    pyr = j_ops.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), num_levels=4)
    ref = np.asarray(j_ops.lookup_corr(pyr, jnp.asarray(coords), radius=4))
    got = _port_lookup(f1, f2, coords, chunk)
    np.testing.assert_allclose(got.numpy(), ref, **OP_TOL)
    assert not got[..., 243:].any()


@pytest.mark.parametrize("spelling,err", [("ondemand:1k", "chunk suffix"),
                                          ("ondemand:0", "must be positive"),
                                          ("ondemand:-8", "must be positive")])
def test_bad_suffix_raises(spelling, err):
    with pytest.raises(ValueError, match=err):
        corr_ops.normalize_corr_lookup(spelling)
    with pytest.raises(ValueError, match=err):
        build_flow_estimator("raft", compute_dtype="float32", corr_lookup=spelling,
                             device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((1, 64, 64, 3)).astype(np.float32) for _ in range(2)]


def _tree(name, **cfg):
    """A seeded estimator of the port as a JAX-layout tree (JAX's own
    init costs seconds per model on the CPU); GMA's gamma set nonzero."""
    tree = to_jax_params(build_flow_estimator(name, compute_dtype="float32", device="cpu",
                                              **cfg).model)
    if name == "gma":
        tree["update_block"]["aggregator"]["gamma"] = np.full((1,), 3.0, np.float32)
    return tree


@pytest.mark.parametrize("small", [False, True])
def test_raft_ondemand_matches_jax(frames, small):
    """Full RAFT (kernel #1) and RAFT-small (kernel #2, radius 3) with
    ondemand:16 against JAX's, and within 1e-5 of the port's stored path."""
    i1, i2 = frames
    jcfg = JRAFTConfig(small=small, compute_dtype="float32", corr_lookup="ondemand:16")
    params = _tree("raft", small=small)
    ref = j_raft_forward(params, jnp.asarray(i1), jnp.asarray(i2), jcfg, iters=3)
    out = {}
    for lookup in ("ondemand:16", "fused"):
        est = build_flow_estimator("raft", compute_dtype="float32", small=small,
                                   corr_lookup=lookup, device="cpu")
        load_jax_params(est.model, params)
        out[lookup] = est.forward(i1, i2, iters=3)
    for key in ("flow_up", "flow_low", "predictions"):
        np.testing.assert_allclose(out["ondemand:16"][key].numpy(), np.asarray(ref[key]), **TOL,
                                   err_msg=key)
        np.testing.assert_allclose(out["ondemand:16"][key].numpy(), out["fused"][key].numpy(),
                                   **OP_TOL, err_msg=key)


def test_raft_ondemand_one_row_chunks_at_batch_2_matches_jax():
    """Full RAFT at batch 2 with ondemand:8 at 64^2: chunks of one row at
    1/8, whose windows come back strided by the batch, which no view
    flattens (the lookup raised before models/raft.py flattened them with
    reshape; ROADMAP.md queue 3), against JAX's and the port's stored
    path."""
    rng = np.random.default_rng(6)
    i1, i2 = (rng.standard_normal((2, 64, 64, 3)).astype(np.float32) for _ in range(2))
    params = _tree("raft")
    ref = j_raft_forward(params, jnp.asarray(i1), jnp.asarray(i2),
                         JRAFTConfig(compute_dtype="float32", corr_lookup="ondemand:8"), iters=2)
    out = {}
    for lookup in ("ondemand:8", "fused"):
        est = build_flow_estimator("raft", compute_dtype="float32", corr_lookup=lookup,
                                   device="cpu")
        load_jax_params(est.model, params)
        out[lookup] = est.forward(i1, i2, iters=2)["flow_up"].numpy()
    np.testing.assert_allclose(out["ondemand:8"], np.asarray(ref["flow_up"]), **TOL)
    np.testing.assert_allclose(out["ondemand:8"], out["fused"], **OP_TOL)


def test_auto_switches_to_ondemand_beyond_the_budget(frames, monkeypatch):
    """"auto" is the stored path within AUTO_VOLUME_BYTES and "ondemand"
    beyond it, with the same flows (tests/test_ops_golden.py:421-460); it
    no longer raises."""
    assert corr_ops.resolve_auto_lookup("auto", 1, 64, 64) == "fused"
    big = corr_ops.stored_volume_bytes(11, 180, 320, dtype=torch.bfloat16)  # 7 frames, 1440p
    assert big > corr_ops.AUTO_VOLUME_BYTES
    assert corr_ops.resolve_auto_lookup("auto", 11, 180, 320, dtype=torch.bfloat16) == "ondemand"
    assert corr_ops.resolve_auto_lookup("fused", 11, 180, 320) == "fused"
    i1, i2 = frames
    params = _tree("raft")
    ests = {}
    for lookup in ("fused", "auto"):
        ests[lookup] = build_flow_estimator("raft", compute_dtype="float32", corr_lookup=lookup,
                                            device="cpu")
        load_jax_params(ests[lookup].model, params)
    ref = ests["fused"].forward(i1, i2, iters=2)["flow_up"].numpy()
    seen = []
    real = raft_mod.lookup_corr_on_demand
    monkeypatch.setattr(raft_mod, "lookup_corr_on_demand",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    np.testing.assert_allclose(ests["auto"].forward(i1, i2, iters=2)["flow_up"].numpy(), ref,
                               rtol=0, atol=0)
    assert not seen
    monkeypatch.setattr(corr_ops, "AUTO_VOLUME_BYTES", 1)
    np.testing.assert_allclose(ests["auto"].forward(i1, i2, iters=2)["flow_up"].numpy(), ref,
                               **OP_TOL)
    assert len(seen) == 2


def test_gma_ondemand_with_chunked_attention_matches_jax(frames, monkeypatch):
    """GMA with ondemand:16 and attn_chunk=16, the hi-res memory
    configuration, against JAX's dense stored path (gamma drawn nonzero);
    under ondemand the attention's auto budget reserves no pyramid
    (accflow_tpu/models/gma.py:394-412)."""
    i1, i2 = frames
    tree = _tree("gma")
    ref = j_gma_forward(tree, jnp.asarray(i1), jnp.asarray(i2),
                        JGMAConfig(compute_dtype="float32", corr_lookup="mm"), iters=2)
    est = build_flow_estimator("gma", compute_dtype="float32", corr_lookup="ondemand:16",
                               attn_chunk=16, device="cpu")
    load_jax_params(est.model, tree)
    out = est.forward(i1, i2, iters=2)
    np.testing.assert_allclose(out["flow_up"].numpy(), np.asarray(ref["flow_up"]), **TOL)
    seen = []
    real = gma.resolve_auto_attn_chunk
    monkeypatch.setattr(gma, "resolve_auto_attn_chunk",
                        lambda *a, **kw: seen.append(kw["reserved_bytes"]) or real(*a, **kw))
    for lookup in ("ondemand", "fused"):
        est = build_flow_estimator("gma", compute_dtype="float32", corr_lookup=lookup,
                                   attn_chunk=-1, device="cpu")
        load_jax_params(est.model, tree)
        est.forward(i1, i2, iters=1)
    assert seen == [0, corr_ops.stored_volume_bytes(1, 8, 8, dtype=torch.float32)]


@pytest.fixture(scope="module")
def cvor_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cvor"))
    write_synthetic_cvor(root, num_train=1, num_test=2, h=64, w=64)
    return root


@pytest.mark.parametrize("model,attn_chunk", [("acc|raft", 0), ("direct|gma", 16)])
def test_evaluate_cvo_ondemand_matches_jax(cvor_root, tmp_path, model, attn_chunk):
    """evaluate_cvo with ondemand:16 (the accumulation protocol through the
    batched pair queries; GMA with chunked attention) against JAX's on the
    same weights and lookup (tests/test_eval.py:46,69)."""
    params = _tree(model.split("|")[1])
    acc = to_jax_params(init_accflow(AccFlowConfig(compute_dtype="float32"), device="cpu"))
    kw = dict(split="final", batch=2, iters=2, compute_dtype="float32", params=params,
              acc_params=acc, corr_lookup="ondemand:16", attn_chunk=attn_chunk)
    ref = j_evaluate_cvo(model, cvor_root, result_file=str(tmp_path / "j.txt"), **kw)
    got = evaluate_cvo(model, cvor_root, device="cpu", result_file=str(tmp_path / "t.txt"),
                       **kw)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], **TOL, err_msg=k)


def test_finetune_step_through_ondemand_matches_jax():
    """One fine-tune step with corr_lookup ondemand:16 (4 chunks, each
    recomputed in the backward pass) against JAX's make_finetune_step:
    loss, gradients and running statistics at tests/test_torch_finetune.py's
    bars (its seed-7 tie in the mask head held the same way)."""
    pair = make_pair("raft", 64, 2, seed=7, corr_lookup="ondemand:16")
    check_one_step(pair, l2_held=("update_block/mask/",))
