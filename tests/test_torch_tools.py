"""The port's host tools against JAX's on the CPU: cli/convert_ckpt.py,
cli/convert_data.py, the native CVOR core (native/), utils/profiling.py and
utils/logging.py::ScopeTimer.

- convert_ckpt for raft, gma and acc+raft: a reference-style .pth written
  from port modules (the `module.` prefix, the norm3 aliases,
  num_batches_tracked; weights drawn off their init), converted by both
  packages' CLIs: the .npz trees equal leaf for leaf, bit for bit, under the
  same file names;
- convert_data with tests/test_convert_data.py:15-63's stubbed lmdb and
  pyarrow: the CVOR directory byte-equal to JAX's, and the SystemExit
  messages without lmdb or with a pyarrow lacking deserialize;
- the native core (built with g++ here) against numpy, bit for bit: its
  flow decode, which data/records.py goes through, and numpy's path
  without g++; its image normalisation and cropped batch gather (plain and
  with the flow decode) against JAX's accflow_tpu.native, bit for bit,
  native and numpy's path alike (tests/test_native.py:21-45's cases);
- trace and ScopeTimer on the CPU (the spans: test_torch_profiling.py).
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

from accflow_tpu import native as j_native
from accflow_tpu.cli import convert_ckpt as j_convert_ckpt
from accflow_tpu.cli import convert_data as j_convert_data
from accflow_tpu_torch import native
from accflow_tpu_torch.cli import convert_ckpt, convert_data
from accflow_tpu_torch.convert import load_npz_tree
from accflow_tpu_torch.data import records
from accflow_tpu_torch.models import AccFlowConfig, build_flow_estimator, init_accflow
from accflow_tpu_torch.utils import profiling
from accflow_tpu_torch.utils.logging import ScopeTimer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs, restored after
    (several test workers share the machine: test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_state_dict(module, prefix=""):
    """A reference-style state_dict of a port module (tests/test_torch_eval.py):
    the `module.` prefix of nn.DataParallel, each downsample norm also under
    its norm3 name, and BatchNorm's num_batches_tracked."""
    sd = {}
    for k, v in module.state_dict().items():
        sd[f"module.{prefix}{k}"] = v.clone()
        if ".downsample.1." in k:
            sd[f"module.{prefix}{k.replace('.downsample.1.', '.norm3.')}"] = v.clone()
        if k.endswith("running_var"):
            sd[f"module.{prefix}{k[:-len('running_var')]}num_batches_tracked"] = torch.tensor(7)
    return sd


@torch.no_grad()
def _drawn(module, seed: int):
    """`module` with every parameter and buffer moved off its init (the
    zero-init convs and scales, the running statistics)."""
    gen = torch.Generator().manual_seed(seed)
    for t in list(module.parameters()) + list(module.buffers()):
        if t.is_floating_point():
            t.add_(0.01 * torch.randn(t.shape, generator=gen)).abs_() if t.ndim == 1 else \
                t.add_(0.01 * torch.randn(t.shape, generator=gen))
    return module


def _npz_leaves(path):
    with np.load(path) as data:
        return {k: np.array(data[k]) for k in data.files}


@pytest.mark.parametrize("model", ["raft", "gma", "acc+raft"])
def test_convert_ckpt_matches_jax(tmp_path, model, capsys):
    ofe = _drawn(build_flow_estimator(model, compute_dtype="float32", device="cpu").model, 1)
    sd = _reference_state_dict(ofe, "ofe." if "acc" in model else "")
    if "acc" in model:
        sd.update(_reference_state_dict(_drawn(init_accflow(AccFlowConfig(), device="cpu"), 2)))
    pth = str(tmp_path / f"{model}.pth")
    torch.save(sd, pth)
    convert_ckpt.main(["--pth", pth, "--model", model, "--out", str(tmp_path / "port")])
    j_convert_ckpt.main(["--pth", pth, "--model", model, "--out", str(tmp_path / "jax")])
    names = [".acc.npz", ".ofe.npz"] if "acc" in model else [".npz"]
    for suffix in names:
        ours, theirs = _npz_leaves(tmp_path / f"port{suffix}"), _npz_leaves(
            tmp_path / f"jax{suffix}")
        assert set(ours) == set(theirs) and ours
        for k in theirs:
            assert ours[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert "wrote" in capsys.readouterr().out
    assert load_npz_tree(str(tmp_path / f"port{names[-1]}"))


def _fake_modules(store):
    """Fake `lmdb` + `pyarrow` over an in-memory {bytes: value} store whose
    'deserialization' is the identity (tests/test_convert_data.py)."""
    class FakeTxn:
        def get(self, key):
            return store[key]

    class FakeEnv:
        def begin(self, write=False):
            txn = FakeTxn()

            class Ctx:
                def __enter__(self_):
                    return txn

                def __exit__(self_, *a):
                    return False

            return Ctx()

    fake_lmdb = types.ModuleType("lmdb")
    fake_lmdb.open = lambda *a, **k: FakeEnv()
    fake_pa = types.ModuleType("pyarrow")
    fake_pa.deserialize = lambda blob: blob
    return fake_lmdb, fake_pa


@pytest.fixture()
def fake_lmdb(monkeypatch):
    rng = np.random.default_rng(0)
    n, h, w = 3, 16, 16
    store = {b"__samples__": [f"{i:05d}" for i in range(n)]}
    for i in range(n):
        for k in records.ALL_KEYS:
            if "flow" in k:
                v = records.encode_flow_u16(rng.uniform(-50, 50, (h, w, 10)).astype(np.float32))
            else:
                v = rng.integers(0, 255, (h, w, 21), dtype=np.uint8)
            store[f"{i:05d}_{k}".encode()] = v
    fake_lmdb, fake_pa = _fake_modules(store)
    monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb)
    monkeypatch.setitem(sys.modules, "pyarrow", fake_pa)
    return store


def test_convert_data_matches_jax(tmp_path, fake_lmdb):
    assert convert_data.convert("fake.lmdb", str(tmp_path / "port"), limit=None) == 3
    assert j_convert_data.convert("fake.lmdb", str(tmp_path / "jax"), limit=None) == 3
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    assert len(files) == len(records.ALL_KEYS) + 1
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    rd = records.CVORReader(str(tmp_path / "port"))
    raw = rd.raw(2, "bflows")
    np.testing.assert_array_equal(raw, fake_lmdb[b"00002_bflows"])  # bit for bit
    assert convert_data.convert("fake.lmdb", str(tmp_path / "two"), limit=2) == 2


def test_convert_data_refusals(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(SystemExit, match="`lmdb` package is required"):
        convert_data.convert("x.lmdb", str(tmp_path / "o"))
    monkeypatch.setitem(sys.modules, "lmdb", types.ModuleType("lmdb"))
    monkeypatch.setitem(sys.modules, "pyarrow", types.ModuleType("pyarrow"))
    with pytest.raises(SystemExit, match="pyarrow>=12 removed the legacy deserialize"):
        convert_data.convert("x.lmdb", str(tmp_path / "o"))


def test_native_core_is_bit_equal_to_numpy(monkeypatch):
    """g++ is on this machine: the core builds (into _build/), checks its ABI
    version, and its decode gives numpy's bits, also through
    data/records.py, which calls it; without g++, numpy's path runs."""
    assert native.available()
    assert str(native.build()).startswith(str(native.BUILD_DIR))
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 65536, (3, 40, 56, 10), dtype=np.uint16)
    want = (raw.astype(np.float32) - records.FLOW_OFFSET) / records.FLOW_SCALE
    calls = []
    real = native.decode_flow_u16
    monkeypatch.setattr(native, "decode_flow_u16", lambda a: calls.append(a.shape) or real(a))
    for got in (real(raw), records.decode_flow_u16(raw), records.decode_flow_u16(raw[1, 3:9])):
        assert got.dtype == np.float32
    assert calls == [raw.shape, (6, 56, 10)]
    np.testing.assert_array_equal(real(raw).view(np.uint32), want.view(np.uint32))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.get_lib() is None and not native.available()
    np.testing.assert_array_equal(real(raw).view(np.uint32), want.view(np.uint32))


def _no_gxx(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.get_lib() is None


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_normalize_u8_matches_jax(monkeypatch, path):
    """2*(x/255)-1 over every uint8 value and a batch of images, bit for
    bit against JAX's native core (its numpy path gives the same bits)."""
    if path == "numpy":
        _no_gxx(monkeypatch)
    else:
        assert native.available()
    raw = np.concatenate([np.arange(256, dtype=np.uint8),
                          np.random.default_rng(2).integers(0, 256, 3 * 5 * 7 * 3, np.uint8)])
    for x in (raw, raw[256:].reshape(3, 5, 7, 3)):
        got, want = native.normalize_u8(x), j_native.normalize_u8(x)
        assert got.dtype == np.float32 and got.shape == x.shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("decode_flow", [False, True])
def test_gather_crop_matches_jax(monkeypatch, path, decode_flow):
    """Crops of a uint8 image column and of a uint16 flow column (decoded
    to float32 with decode_flow), in the order asked, one crop at the
    records' far corner: bit for bit against JAX's gather_crop."""
    if path == "numpy":
        _no_gxx(monkeypatch)
    rng = np.random.default_rng(3)
    if decode_flow:
        col = rng.integers(0, 65536, (4, 12, 12, 10), dtype=np.uint16)
        idx, y0, x0 = np.array([1, 3, 3]), np.array([2, 0, 4]), np.array([0, 4, 4])
    else:
        col = rng.integers(0, 256, (6, 16, 16, 3), dtype=np.uint8)
        idx, y0, x0 = np.array([4, 0, 2, 5]), np.array([1, 0, 7, 8]), np.array([3, 8, 0, 8])
    got = native.gather_crop(col, idx, y0, x0, (8, 8), decode_flow=decode_flow)
    want = j_native.gather_crop(col, idx.astype(np.int64), y0.astype(np.int32),
                                x0.astype(np.int32), (8, 8), decode_flow=decode_flow)
    assert got.dtype == want.dtype == (np.float32 if decode_flow else np.uint8)
    assert got.shape == (len(idx), 8, 8, col.shape[-1])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="leaves the column"):
        native.gather_crop(col, idx, y0 + 1, x0 + 9, (8, 8), decode_flow=decode_flow)


def test_trace_and_scope_timer(tmp_path, capsys):
    """On the CPU: trace writes a Chrome trace that names the ops run;
    ScopeTimer prints and keeps its elapsed time."""
    x = torch.randn(96, 96)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.mm(x, x)
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert "aten::mm" in text and any("aten::mm" in e.key for e in prof.key_averages())
    with ScopeTimer("block") as t:
        pass
    assert t.elapsed >= 0 and "block: " in capsys.readouterr().out
