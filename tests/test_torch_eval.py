"""The CVO evaluation path of the PyTorch port against JAX on the CPU:
occlusion, CVOR records and synthetic clips, the dataset and batch helpers,
EPE, reference checkpoints (.pth) and `evaluate_cvo` itself, at 64^2 with
2 iterations in float32. Inputs are numpy from a seed.

Tolerances: ops 1e-5 (float32, the same arithmetic); occlusion bits exact
away from the threshold; data exact; EPEs rtol 1e-3 / atol 5e-3 against
JAX, the flow bar the JAX package meets against the PyTorch original; within
the port, 1e-4 between lookups that compute the same function."""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu.convert.torch_weights import load_accflow_checkpoint as j_load_acc_ckpt
from accflow_tpu.data import augment as j_augment
from accflow_tpu.data import cvo as j_cvo
from accflow_tpu.data import records as j_records
from accflow_tpu.data import synthetic as j_synth
from accflow_tpu.models.raft import RAFTConfig as JRAFTConfig
from accflow_tpu.models.raft import init_raft as j_init_raft
from accflow_tpu.ops.occlusion import calc_occ_mask as j_calc_occ_mask
from accflow_tpu.train import engine as j_engine
from accflow_tpu.train.evaluate import cal_epe as j_cal_epe
from accflow_tpu.train.evaluate import evaluate_cvo as j_evaluate_cvo
from accflow_tpu_torch.cli import test_cvo as cli
from accflow_tpu_torch.convert import (
    load_flow_estimator_checkpoint,
    load_reference_state_dict,
    to_jax_params,
)
from accflow_tpu_torch.data import augment, cvo, records, synthetic
from accflow_tpu_torch.data.prefetch import device_prefetch, threaded_batches
from accflow_tpu_torch.models import AccFlowConfig, build_flow_estimator, init_accflow
from accflow_tpu_torch.ops.occlusion import calc_occ_mask
from accflow_tpu_torch.train import engine
from accflow_tpu_torch.train.evaluate import cal_epe, default_micro_batch, evaluate_cvo


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


EPE_TOL = dict(rtol=1e-3, atol=5e-3)


def test_calc_occ_mask_matches_jax(rng):
    """Constant motion per sample plus noise, so that about half the pixels
    pass the consistency check."""
    v = rng.uniform(-4, 4, (2, 1, 1, 2))
    bflow = (v + rng.normal(0, 0.3, (2, 24, 20, 2))).astype(np.float32)
    fflow = (-v + rng.normal(0, 0.3, (2, 24, 20, 2))).astype(np.float32)
    got = [m.numpy() for m in calc_occ_mask(torch.from_numpy(bflow), torch.from_numpy(fflow))]
    ref = [np.asarray(m) for m in j_calc_occ_mask(jnp.asarray(bflow), jnp.asarray(fflow))]
    assert 0.05 < ref[0].mean() < 0.95  # both sides of the threshold occur
    # Bits exact where the consistency error is not within 1e-4 of the threshold.
    from accflow_tpu_torch.ops.sampling import backwarp

    b, f = torch.from_numpy(bflow), torch.from_numpy(fflow)
    thresh = 0.01 * (f.norm(dim=-1) + b.norm(dim=-1)) + 0.5
    margins = [((f + backwarp(b, f)).norm(dim=-1) - thresh).abs(),
               ((b + backwarp(f, b)).norm(dim=-1) - thresh).abs()]
    for g, r, margin in zip(got, ref, margins[::-1]):
        assert g.shape == r.shape == (2, 24, 20, 1) and g.dtype == np.float32
        far = margin.numpy()[..., None] > 1e-4
        np.testing.assert_array_equal(g[far], r[far])


def test_flow_codec_matches_jax(rng):
    flow = rng.uniform(-300, 300, (8, 6, 2)).astype(np.float32)
    enc = records.encode_flow_u16(flow)
    np.testing.assert_array_equal(enc, j_records.encode_flow_u16(flow))
    np.testing.assert_array_equal(records.decode_flow_u16(enc), j_records.decode_flow_u16(enc))


@pytest.mark.parametrize("seg_len", [None, 2])
def test_make_clip_matches_jax(seg_len):
    got = synthetic.make_clip(np.random.default_rng(3), 24, 32, seg_len=seg_len)
    ref = j_synth.make_clip(np.random.default_rng(3), 24, 32, seg_len=seg_len)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert synthetic.key_specs(24, 32) == j_synth.key_specs(24, 32)


@pytest.fixture(scope="module")
def cvor_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cvor"))
    synthetic.write_synthetic_cvor(root, num_train=3, num_test=2, h=64, w=64)
    return root


def test_synthetic_cvor_reads_back_in_both_packages(cvor_root, tmp_path):
    ref_root = j_synth.write_synthetic_cvor(str(tmp_path / "j"), num_train=3, num_test=2,
                                            h=64, w=64)
    for sub in ("train", "test"):
        for name in synthetic.key_specs(64, 64):
            with open(osp.join(cvor_root, sub, f"{name}.bin"), "rb") as a, \
                    open(osp.join(ref_root, sub, f"{name}.bin"), "rb") as b:
                assert a.read() == b.read(), (sub, name)
        mine, theirs = records.CVORReader(osp.join(cvor_root, sub)), \
            j_records.CVORReader(osp.join(cvor_root, sub))
        assert len(mine) == len(theirs)
        for i in range(len(mine)):
            got, ref = mine.sample(i), theirs.sample(i)
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{sub} {i} {k}")
            got = mine.sample_cropped(i, 3, 5, 16, 24)
            ref = theirs.sample_cropped(i, 3, 5, 16, 24)
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("split", ["clean", "final", "clean+final"])
def test_datasets_and_batches_match_jax(cvor_root, split):
    keys = ["fflows", "bflows"]
    for mine, theirs, shuffle in (
        (cvo.fetch_valid_dataset(cvor_root, keys, split),
         j_cvo.fetch_valid_dataset(cvor_root, keys, split), False),
        (cvo.fetch_train_dataset(cvor_root, keys, crop_size=(32, 48), split=split),
         j_cvo.fetch_train_dataset(cvor_root, keys, crop_size=(32, 48), split=split), True),
    ):
        its = [m.BatchIterator(d, 2, shuffle=shuffle, drop_last=shuffle, seed=4)
               for m, d in ((cvo, mine), (j_cvo, theirs))]
        assert len(its[0]) == len(its[1])
        for got, ref in zip(*its):
            assert set(got) == set(ref) == {"fflows", "bflows", "imgs"}
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k])


def test_random_crop_matches_jax_and_the_train_crop(cvor_root):
    """augment.random_crop against JAX's, and the training dataset's crop
    of the raw records: the same window from the same generator."""
    sample = records.CVORReader(osp.join(cvor_root, "train")).sample(1)
    for size in (32, (16, 40)):
        got = augment.random_crop(sample, size, np.random.default_rng(5))
        ref = j_augment.random_crop(sample, size, np.random.default_rng(5))
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    ds = cvo.CVODataset(cvor_root, ["fflows", "bflows"], is_training=True, crop_size=(16, 40))
    got = ds.get(1, np.random.default_rng(5))
    ref = augment.random_crop({k: sample[k] for k in got}, (16, 40), np.random.default_rng(5))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_engine_helpers_match_jax(rng):
    imgs = rng.integers(0, 256, (3, 8, 6, 21)).astype(np.uint8)
    flows = rng.normal(0, 3, (3, 8, 6, 10)).astype(np.float32)
    np.testing.assert_allclose(engine.to_clip(imgs, 7).numpy(),
                               np.asarray(j_engine.to_clip(jnp.asarray(imgs), 7)), atol=1e-6)
    np.testing.assert_array_equal(engine.to_flow_seq(flows).numpy(),
                                  np.asarray(j_engine.to_flow_seq(jnp.asarray(flows))))
    with pytest.raises(ValueError):
        engine.to_clip(imgs, 6)
    batch = {"imgs": imgs, "bflows": flows}
    for size in (3, 5):
        got, n = engine.pad_batch(batch, size)
        ref, n_ref = j_engine.pad_batch(batch, size)
        assert n == n_ref == 3
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


def test_cal_epe_matches_jax(rng):
    pred = rng.normal(0, 2, (3, 10, 12, 2)).astype(np.float32)
    label = rng.normal(0, 2, (3, 10, 12, 2)).astype(np.float32)
    occ = (rng.uniform(size=(3, 10, 12, 1)) < 0.3).astype(np.float32)
    occ[1] = 0.0  # an empty occluded region: reported as 0, not nan
    got = cal_epe(torch.from_numpy(pred), torch.from_numpy(label), torch.from_numpy(occ))
    ref = j_cal_epe(jnp.asarray(pred), jnp.asarray(label), jnp.asarray(occ))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    assert float(got[1][1]) == 0.0


def test_prefetch_on_cpu_passes_through():
    batches = [({"a": np.full((2,), i)}, i) for i in range(5)]
    out = list(device_prefetch(iter(batches), depth=2, device="cpu"))
    assert [b[1] for b in out] == list(range(5)) and out[3][0]["a"][0] == 3
    assert list(threaded_batches(iter(range(7)), num_threads=1, buffer=2)) == list(range(7))

    def broken():
        yield 1
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(threaded_batches(broken(), num_threads=1))
    assert default_micro_batch(10) == 5 and default_micro_batch(8) == 8
    assert default_micro_batch(9) == 3


@pytest.fixture(scope="module")
def raft_tree():
    return j_init_raft(jax.random.PRNGKey(0), JRAFTConfig(compute_dtype="float32"))


@pytest.mark.parametrize("lookup", ["fused", "experimental:fused_bd"])
def test_evaluate_cvo_direct_matches_jax(cvor_root, raft_tree, tmp_path, lookup):
    kw = dict(split="clean", batch=2, iters=2, compute_dtype="float32", corr_lookup=lookup)
    ref = j_evaluate_cvo("direct|raft", cvor_root, params=raft_tree,
                         result_file=str(tmp_path / "j.txt"), **kw)
    got = evaluate_cvo("direct|raft", cvor_root, params=raft_tree, device="cpu",
                       result_file=str(tmp_path / "t.txt"), **kw)
    assert set(got) == {"all", "occ", "vis"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], **EPE_TOL, err_msg=k)
    assert "AVG EPE direct|raft" in (tmp_path / "t.txt").read_text()


def test_evaluate_cvo_acc_split_lookup_matches_fused(cvor_root, tmp_path):
    """acc|raft (the batched pair queries and AccFlow's cells) with the split
    lookup against kernel #1's plain lookup, and the warm-started paths run."""
    res = {lk: evaluate_cvo("acc|raft", cvor_root, split="final", batch=2, iters=2,
                            compute_dtype="float32", corr_lookup=lk, device="cpu",
                            result_file=str(tmp_path / "r.txt"))
           for lk in ("fused", "experimental:fused_bd", "experimental:fused_bd2")}
    for lk in ("experimental:fused_bd", "experimental:fused_bd2"):
        for k in res["fused"]:
            np.testing.assert_allclose(res[lk][k], res["fused"][k], rtol=0, atol=1e-4)
    for name in ("acc|raft", "direct|raft"):
        warm = evaluate_cvo(name, cvor_root, batch=2, iters=2, compute_dtype="float32",
                            warm_start=True, device="cpu", result_file=str(tmp_path / "w.txt"))
        assert all(np.isfinite(v) for v in warm.values())


def test_evaluate_cvo_rejects(cvor_root):
    """What the port refuses: an unknown estimator and a volume-free lookup
    with a bad chunk suffix (as JAX does). GMA and attn_chunk, refused before
    GMA was ported, are held against JAX by test_evaluate_cvo_gma_matches_jax,
    and the volume-free lookup, refused before it was ported, by
    tests/test_torch_ondemand.py::test_evaluate_cvo_ondemand_matches_jax."""
    with pytest.raises(NotImplementedError, match="unknown flow estimator"):
        evaluate_cvo("direct|flownet", cvor_root, device="cpu")
    with pytest.raises(ValueError, match="must be positive"):
        evaluate_cvo("direct|gma", cvor_root, corr_lookup="ondemand:0", device="cpu")


@pytest.fixture(scope="module")
def gma_trees():
    """GMA (gamma drawn nonzero) and AccFlow (ZeroConv drawn) JAX trees."""
    from accflow_tpu.models.accflow import AccFlowConfig as JAccFlowConfig
    from accflow_tpu.models.accflow import init_accflow as j_init_accflow
    from accflow_tpu.models.gma import GMAConfig as JGMAConfig
    from accflow_tpu.models.gma import init_gma as j_init_gma

    rng = np.random.default_rng(12)
    gma_tree = j_init_gma(jax.random.PRNGKey(0), JGMAConfig(compute_dtype="float32"))
    gma_tree["update_block"]["aggregator"]["gamma"] = jnp.full((1,), 3.0, jnp.float32)
    acc_tree = j_init_accflow(jax.random.PRNGKey(1), JAccFlowConfig(compute_dtype="float32"))
    zc = acc_tree["accplus"]["conv2"]["4"]
    zc["w"] = jnp.asarray(rng.standard_normal(zc["w"].shape) * 0.05, jnp.float32)
    zc["scale"] = jnp.asarray(rng.uniform(-0.1, 0.1, zc["scale"].shape), jnp.float32)
    return gma_tree, acc_tree


@pytest.mark.parametrize("model,attn_chunk", [("acc|gma", 0), ("direct|gma", 16)])
def test_evaluate_cvo_gma_matches_jax(cvor_root, gma_trees, tmp_path, model, attn_chunk):
    """evaluate_cvo with GMA (acc: the pair queries and the cells; direct
    with chunked attention, attn_chunk threaded through) against JAX's."""
    gma_tree, acc_tree = gma_trees
    kw = dict(split="clean", batch=2, iters=2, compute_dtype="float32", params=gma_tree,
              acc_params=acc_tree, attn_chunk=attn_chunk)
    ref = j_evaluate_cvo(model, cvor_root, result_file=str(tmp_path / "j.txt"), **kw)
    got = evaluate_cvo(model, cvor_root, device="cpu", result_file=str(tmp_path / "t.txt"), **kw)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], **EPE_TOL, err_msg=k)
    assert f"AVG EPE {model}" in (tmp_path / "t.txt").read_text()


def _reference_state_dict(module, prefix=""):
    """A reference-style state_dict of a port module: the `module.` prefix
    of nn.DataParallel, each downsample norm also under its norm3 name, and
    BatchNorm's num_batches_tracked."""
    sd = {}
    for k, v in module.state_dict().items():
        sd[f"module.{prefix}{k}"] = v.clone()
        if ".downsample.1." in k:
            sd[f"module.{prefix}{k.replace('.downsample.1.', '.norm3.')}"] = v.clone()
        if k.endswith("running_var"):
            sd[f"module.{prefix}{k[:-len('running_var')]}num_batches_tracked"] = torch.tensor(7)
    return sd


def test_pth_checkpoints_load_in_both_packages(cvor_root, tmp_path):
    ofe = build_flow_estimator("raft", compute_dtype="float32", device="cpu", seed=3).model
    acc = init_accflow(AccFlowConfig(compute_dtype="float32"), seed=4, device="cpu")
    with torch.no_grad():
        ofe.cnet.norm1.running_mean.uniform_(-0.5, 0.5)
        ofe.cnet.layer2[0].downsample[1].running_var.uniform_(0.5, 2.0)
        acc.accplus.conv2[4].scale.uniform_(-0.1, 0.1)
    sd = {**_reference_state_dict(acc), **_reference_state_dict(ofe, "ofe.")}
    assert any(".norm3." in k for k in sd)
    pth = str(tmp_path / "acc+raft-test.pth")
    torch.save(sd, pth)

    from accflow_tpu.models.accflow import AccFlowConfig as JAccFlowConfig
    from accflow_tpu.models.accflow import init_accflow as j_init_accflow

    j_acc, j_ofe = j_load_acc_ckpt(
        pth, j_init_accflow(jax.random.PRNGKey(1), JAccFlowConfig(compute_dtype="float32")),
        j_init_raft(jax.random.PRNGKey(0), JRAFTConfig(compute_dtype="float32")))
    kw = dict(batch=2, iters=2, compute_dtype="float32", device="cpu",
              result_file=str(tmp_path / "r.txt"))
    from_pth = evaluate_cvo("acc|raft", cvor_root, acc_ckpt=pth, **kw)
    from_jax = evaluate_cvo("acc|raft", cvor_root, params=j_ofe, acc_params=j_acc, **kw)
    assert from_pth == from_jax
    mine = to_jax_params(acc)
    flat = jax.tree_util.tree_leaves_with_path(j_acc)
    assert len(flat) == len(jax.tree_util.tree_leaves(mine))
    for path, leaf in flat:
        node = mine
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))

    # A raft-* checkpoint on its own, and what the loader refuses.
    raft_pth = str(tmp_path / "raft-test.pth")
    torch.save({"state_dict": _reference_state_dict(ofe)}, raft_pth)
    fresh = build_flow_estimator("raft", compute_dtype="float32", device="cpu", seed=9).model
    load_flow_estimator_checkpoint(raft_pth, fresh)
    for (k, a), b in zip(ofe.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    bad = {k.removeprefix("module."): v for k, v in _reference_state_dict(ofe).items()}
    bad["update_block.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unconsumed"):
        load_reference_state_dict(fresh, bad)
    del bad["update_block.extra.weight"], bad["fnet.conv1.weight"]
    with pytest.raises(KeyError, match="fnet.conv1.weight"):
        load_reference_state_dict(fresh, bad)


def test_cli_synthetic_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "cvor")
    res = cli.main(["--synthetic", "--size", "64", "--iters", "2", "--device", "cpu",
                    "--dataset-root", root, "--batch", "4", "--corr_lookup",
                    "experimental:fused_bd"])
    assert all(np.isfinite(v) for v in res.values())
    assert (tmp_path / "test_result_clean_E6.txt").exists()
    with pytest.raises(SystemExit):
        cli.main(["--scan_unroll", "4", "--device", "cpu", "--dataset-root", root])
