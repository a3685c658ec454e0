"""High-Speed Sintel evaluation of the port (utils/frame_io.read_png,
data/sintel.py, train/evaluate.py::evaluate_sintel, cli/test_sintel.py)
against cv2 and JAX's package on the CPU.

- read_png against cv2.imread on grey, RGB and RGBA PNGs that cv2 wrote, and
  on PNGs from a hand encoder with each row filter 0-4 and their mix: equal
  bits; 16-bit, palette and interlaced PNGs raise ValueError naming the file;
- resize_linear against cv2.resize(INTER_LINEAR) on float32, up and down,
  within 1e-3 in 0-255 units;
- HighSpeedSintel.get against JAX's on the fixture of
  tests/test_warmstart_sintel.py:159-185, built again here with frames of
  another size than `size` (the resize runs) and one grey occlusion png:
  flow and mask exact, frames within 1e-3; a .jpg without cv2 raises
  ImportError naming the file;
- evaluate_sintel for direct|raft, acc|raft and acc|gma against JAX's on the
  same weights (load_jax_params of the port's seeded init), float32,
  2 iterations: the unpadded flows that both compute within rtol 1e-3 and
  an atol of 1e-3 of their largest value (random weights give flows of a
  few hundredths of a pixel for AccFlow and a few tenths for one estimator
  call, below the pixel bars of ROADMAP.md), and the metrics within rtol
  2e-3 / atol 2e-2 (AccFlow's bar) against a ground truth drawn at the
  flows' scale (an independent ground truth of pixels hides a flow's errors
  in the EPEs); batch 2 against batch 1 within 1e-5; cli/test_sintel end to
  end.
"""

import struct
import sys
import zlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from accflow_tpu.data.sintel import HighSpeedSintel as JHighSpeedSintel  # noqa: E402
from accflow_tpu.train.evaluate import evaluate_sintel as j_evaluate_sintel  # noqa: E402
from accflow_tpu_torch.cli import test_sintel as cli  # noqa: E402
from accflow_tpu_torch.convert import to_jax_params  # noqa: E402
from accflow_tpu_torch.data.sintel import HighSpeedSintel, resize_linear  # noqa: E402
from accflow_tpu_torch.models import AccFlowConfig, build_flow_estimator, init_accflow  # noqa: E402
from accflow_tpu_torch.train.evaluate import evaluate_sintel  # noqa: E402
from accflow_tpu_torch.utils.frame_io import read_png, write_flow  # noqa: E402

SIZE = (64, 32)  # (W, H) the high-FPS frames are resized to
SRC_HW = (40, 72)  # the frames' own size
EVAL_TOL = dict(rtol=2e-3, atol=2e-2)
FLOW_RTOL = 1e-3  # of the largest flow: float32 on both sides
GT_PX = 0.25  # the ground truth's range: the flows' scale at random weights


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs, restored after
    (several test workers share the machine: test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filtered(img: np.ndarray, kinds) -> bytes:
    """The PNG scanlines of (H, W, C) uint8 `img`, row y filtered with
    kinds[y % len(kinds)] (0 None, 1 Sub, 2 Up, 3 Avg, 4 Paeth), by the
    specification's predictors over the unfiltered bytes."""
    x = img.astype(np.int16)
    up, left, corner = (np.zeros_like(x) for _ in range(3))
    up[1:], left[:, 1:], corner[1:, 1:] = x[:-1], x[:, :-1], x[:-1, :-1]
    pa, pb, pc = np.abs(up - corner), np.abs(left - corner), np.abs(left + up - 2 * corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, corner))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    rows = []
    for y in range(x.shape[0]):
        k = kinds[y % len(kinds)]
        rows.append(bytes([k]) + ((x[y] - preds[k][y]) & 255).astype(np.uint8).tobytes())
    return b"".join(rows)


def write_png(path, img: np.ndarray, kinds=(0,), depth=8, colour=None, interlace=0) -> None:
    """A hand-encoded PNG of (H, W, C) uint8 `img` (C of 1-4)."""
    h, w, c = img.shape
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c] if colour is None else colour
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)))
        f.write(_chunk(b"IDAT", zlib.compress(_filtered(img, kinds))))
        f.write(_chunk(b"IEND", b""))


def _cv2_rgb_order(img: np.ndarray) -> np.ndarray:
    """cv2.imread(IMREAD_UNCHANGED)'s BGR(A) as RGB(A), grey as (H, W, 1)."""
    if img.ndim == 2:
        return img[..., None]
    return img[..., [2, 1, 0, 3][: img.shape[-1]]]


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_matches_cv2_on_cv2_pngs(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (37, 53, channels), dtype=np.uint8)
    ramp = np.add.outer(np.arange(37), np.arange(53)).astype(np.uint8)  # smooth rows too
    img[:18] = ramp[:18, :, None]
    path = str(tmp_path / "cv2.png")
    cv2.imwrite(path, img[..., 0] if channels == 1 else img)
    got = read_png(path)
    np.testing.assert_array_equal(got, _cv2_rgb_order(cv2.imread(path, cv2.IMREAD_UNCHANGED)))
    np.testing.assert_array_equal(got, img[..., [2, 1, 0, 3][:channels]] if channels > 1 else img)


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_png_row_filters(tmp_path, kinds, channels):
    """Each filter type, and a mix (row by row), on every colour type, from
    the hand encoder: the pixels back bit for bit, and cv2's reading the
    same (grey+alpha: cv2 has no such layout under IMREAD_UNCHANGED)."""
    rng = np.random.default_rng(10 * channels + len(kinds))
    img = rng.integers(0, 256, (23, 31, channels), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    write_png(path, img, kinds)
    got = read_png(path)
    np.testing.assert_array_equal(got, img)
    if channels != 2:
        np.testing.assert_array_equal(got, _cv2_rgb_order(cv2.imread(path,
                                                                     cv2.IMREAD_UNCHANGED)))


def test_read_png_refuses_what_it_lacks(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    cases = {"16-bit": dict(depth=16), "palette": dict(colour=3),
             "interlaced": dict(interlace=1)}
    for what, kw in cases.items():
        path = str(tmp_path / f"{what}.png")
        write_png(path, img, **kw)
        with pytest.raises(ValueError, match=what) as e:
            read_png(path)
        assert path in str(e.value)
    not_png = tmp_path / "x.png"
    not_png.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(not_png))


@pytest.mark.parametrize("src,dst", [((32, 64), (100, 50)), ((40, 72), (64, 32)),
                                     ((436, 1024), (512, 200)), ((30, 40), (17, 11)),
                                     ((64, 128), (64, 32))])
def test_resize_matches_cv2(src, dst):
    img = np.random.default_rng(0).uniform(0, 255, src + (3,)).astype(np.float32)
    want = cv2.resize(img, dst)
    got = resize_linear(img, dst)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def sintel_dir(tmp_path_factory):
    """tests/test_warmstart_sintel.py's synthetic High-Speed Sintel layout,
    three samples of 2_imgs/, 43_imgs/ (5 frames), a .flo and an occlusion
    png, with frames of SRC_HW (not SIZE, so that the resize runs), the
    ground truth within +-GT_PX and the last sample's occlusion png grey."""
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("hs") / "hs_sintel"
    h, w = SRC_HW
    for s in range(3):
        sample = root / f"alley_1_{s:04d}"
        (sample / "2_imgs").mkdir(parents=True)
        (sample / "43_imgs").mkdir()
        for i in range(2):
            cv2.imwrite(str(sample / "2_imgs" / f"frame_{i}.png"),
                        rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        for i in range(5):
            cv2.imwrite(str(sample / "43_imgs" / f"frame_{i:02d}.png"),
                        rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        write_flow(str(sample / "flow.flo"),
                   rng.uniform(-GT_PX, GT_PX, (SIZE[1], SIZE[0], 2)).astype(np.float32))
        occ = (rng.uniform(size=(SIZE[1], SIZE[0])) > 0.7).astype(np.uint8) * 255
        occ_img = occ if s == 2 else np.stack([occ, 255 - occ, occ // 2], -1)
        cv2.imwrite(str(sample / "occ.png"), occ_img)
    return str(root)


def test_loader_matches_jax(sintel_dir):
    ours, theirs = HighSpeedSintel(sintel_dir, interv=2, size=SIZE), \
        JHighSpeedSintel(sintel_dir, interv=2, size=SIZE)
    assert ours.samples == theirs.samples and len(ours) == 3
    for i in range(3):
        a, b = ours.get(i), theirs.get(i)
        assert set(a) == set(b)
        for k in ("gt_flow", "occ_mask"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        assert len(a["hs_sintel_imgs"]) == len(b["hs_sintel_imgs"]) == 3
        assert a["hs_sintel_imgs"][0].shape == (SIZE[1], SIZE[0], 3)
        for key in ("hs_sintel_imgs", "sintel_imgs"):
            np.testing.assert_allclose(np.stack(a[key]), np.stack(b[key]), rtol=0, atol=1e-3)


def test_jpg_frame_needs_cv2(tmp_path, monkeypatch):
    sample = tmp_path / "s" / "a"
    for sub in ("2_imgs", "43_imgs"):
        (sample / sub).mkdir(parents=True)
    write_png(str(sample / "2_imgs" / "f0.png"), np.zeros((8, 8, 3), np.uint8))
    write_png(str(sample / "2_imgs" / "f1.png"), np.zeros((8, 8, 3), np.uint8))
    write_png(str(sample / "occ.png"), np.zeros((8, 8, 1), np.uint8))
    cv2.imwrite(str(sample / "43_imgs" / "f0.jpg"), np.zeros((8, 8, 3), np.uint8))
    write_flow(str(sample / "flow.flo"), np.zeros((8, 8, 2), np.float32))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="f0.jpg"):
        HighSpeedSintel(str(tmp_path / "s"), interv=1, size=(8, 8)).get(0)


def _weights(model_name: str):
    est = build_flow_estimator(model_name, compute_dtype="float32", device="cpu")
    acc = init_accflow(AccFlowConfig(compute_dtype="float32"), seed=1, device="cpu")
    return to_jax_params(est.model), to_jax_params(acc)


def _record_flows(monkeypatch):
    """Record the unpadded flows of both evaluate_sintel calls, batch by
    batch (the padded trailing rows included): JAX's through its
    InputPadder.unpad, the port's through the per-sample metric."""
    from accflow_tpu.ops import padding as j_padding
    from accflow_tpu_torch.train import evaluate

    flows = {"jax": [], "port": []}
    j_unpad, epes = j_padding.InputPadder.unpad, evaluate._sintel_epes

    def j_recording(self, x):
        out = j_unpad(self, x)
        flows["jax"].extend(np.asarray(out))
        return out

    def recording(flow, gt, occ):
        flows["port"].append(np.array(flow))
        return epes(flow, gt, occ)

    monkeypatch.setattr(j_padding.InputPadder, "unpad", j_recording)
    monkeypatch.setattr(evaluate, "_sintel_epes", recording)
    return flows


@pytest.mark.parametrize("mode", ["direct|raft", "acc|raft", "acc|gma"])
def test_evaluate_sintel_matches_jax(sintel_dir, mode, tmp_path, monkeypatch):
    params, acc_params = _weights(mode)
    kw = dict(interv=2, iters=2, compute_dtype="float32", size=SIZE, params=params,
              acc_params=acc_params, batch=2)
    flows = _record_flows(monkeypatch)
    want = j_evaluate_sintel(mode, sintel_dir, **kw)
    got = evaluate_sintel(mode, sintel_dir, device="cpu",
                          result_file=str(tmp_path / "r.txt"), **kw)
    assert len(flows["port"]) == len(flows["jax"]) == 4  # 3 samples in 2 batches of 2
    ours, theirs = np.stack(flows["port"]), np.stack(flows["jax"])
    assert ours.shape == (4, SIZE[1], SIZE[0], 2)
    scale = float(np.abs(theirs).max())
    assert scale > 0.01, scale
    np.testing.assert_allclose(ours, theirs, rtol=FLOW_RTOL, atol=FLOW_RTOL * scale)
    assert set(got) == {"all", "occ", "noc"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **EVAL_TOL, err_msg=k)
    assert f"AVG EPE sintel {mode} interv=2" in (tmp_path / "r.txt").read_text()


def test_evaluate_sintel_batched_equals_per_sample(sintel_dir):
    """batch 2 over 3 samples (one full batch, one padded by repetition and
    trimmed) against batch 1 (after tests/test_warmstart_sintel.py:205)."""
    params, _ = _weights("raft")
    kw = dict(interv=2, iters=2, compute_dtype="float32", size=SIZE, params=params,
              device="cpu")
    r1 = evaluate_sintel("direct|raft", sintel_dir, batch=1, **kw)
    r2 = evaluate_sintel("direct|raft", sintel_dir, batch=2, **kw)
    for k in r1:
        np.testing.assert_allclose(r2[k], r1[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_cli_end_to_end(sintel_dir, tmp_path, monkeypatch):
    """python -m accflow_tpu_torch.cli.test_sintel through main(argv) with an
    .npz checkpoint pair: JAX's flags plus --device. The CLI, as JAX's,
    takes no size: the resize target is patched to SIZE for the CPU."""
    import functools

    from accflow_tpu_torch.convert import save_npz_tree
    from accflow_tpu_torch.train import evaluate

    monkeypatch.setattr(evaluate, "evaluate_sintel",
                        functools.partial(evaluate.evaluate_sintel, size=SIZE))

    params, acc_params = _weights("raft")
    save_npz_tree(str(tmp_path / "ck.ofe.npz"), params)
    save_npz_tree(str(tmp_path / "ck.acc.npz"), acc_params)
    out = tmp_path / "res.txt"
    res = cli.main(["-acc", "acc", "-ofe", "raft", "--acc_ckpt", str(tmp_path / "ck"),
                    "--dataset-root", sintel_dir, "--interv", "2", "--iters", "2",
                    "--compute-dtype", "float32", "--batch", "2", "--result-file", str(out),
                    "--device", "cpu"])
    assert set(res) == {"all", "occ", "noc"} and all(np.isfinite(v) for v in res.values())
    assert "AVG EPE sintel acc|raft interv=2" in out.read_text()
    with pytest.raises(SystemExit):
        cli.main(["--acc", "sideways", "--device", "cpu"])
