"""High-Speed Sintel evaluation data, the port's counterpart of
accflow_tpu/data/sintel.py (reference data/dataset.py:164-236).

Per sample directory: `2_imgs/` (the original Sintel pair), `43_imgs/`
(high-FPS interpolated frames), one `.flo` ground-truth flow and one
occlusion png. `interv` subsamples the 43-frame sequence (img0,
img_interv, ...). Frames are returned HWC float32 RGB in [0, 255]; the
engines normalise.

JAX's loader reads with cv2, which the card's machine lacks: here PNGs go
through utils.frame_io.read_png and the high-FPS frames are resized by
`resize_linear`, cv2.resize's INTER_LINEAR formula written in numpy. The
colour conversion is cv2.imread's: grey is replicated to three channels and
alpha dropped; the occlusion mask is channel 0 of cv2's BGR order (blue, or
the grey value). A .jpg still needs cv2.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob
from typing import Dict, List

import numpy as np

from accflow_tpu_torch.utils.frame_io import read_flow, read_png


def _read_rgb_u8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as cv2.imread(path)[..., ::-1] gives it."""
    if path.lower().endswith(".png"):
        img = read_png(path)
        return np.repeat(img[..., :1], 3, axis=-1) if img.shape[-1] <= 2 else img[..., :3]
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path}: reading a non-PNG frame needs cv2, which is absent") from e
    return cv2.imread(path)[..., ::-1]


def _taps(src: int, dst: int):
    """cv2's INTER_LINEAR taps along one axis: source index pairs and the
    weight of the second, at half-pixel centres, clamped at both edges."""
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    frac[i0 < 0] = 0.0
    i0 = np.maximum(i0, 0)
    frac[i0 >= src - 1] = 0.0
    i0 = np.minimum(i0, src - 1)
    return i0, np.minimum(i0 + 1, src - 1), frac


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, size) with INTER_LINEAR on a float32 (H, W, C) image:
    size is (W, H); each output pixel is the bilinear blend of the source at
    ((x + 0.5) * W_in / W - 0.5, likewise in y), edges clamped, no
    antialiasing. Rows are blended first, then columns, as cv2 does."""
    w, h = int(size[0]), int(size[1])
    src = np.asarray(img, np.float32)
    x0, x1, fx = _taps(src.shape[1], w)
    y0, y1, fy = _taps(src.shape[0], h)
    fx, fy = fx[None, :, None], fy[:, None, None]
    rows = src[:, x0] * (1.0 - fx) + src[:, x1] * fx
    return rows[y0] * (1.0 - fy) + rows[y1] * fy


class HighSpeedSintel:
    def __init__(self, data_dir: str, interv: int = 6, blacklist=(), size=(1024, 436)):
        """size: (W, H) the high-FPS frames are resized to; (1024, 436)
        matches the reference (data/dataset.py:213)."""
        self.data_dir = data_dir
        self.interv = interv
        self.size = tuple(size)
        self.samples: List[str] = [osp.join(data_dir, x) for x in sorted(os.listdir(data_dir))
                                   if x not in blacklist]

    def __len__(self) -> int:
        return len(self.samples)

    def get(self, index: int) -> Dict:
        root = self.samples[index]

        def frames(sub):
            return (sorted(glob(osp.join(root, sub, "*.png")))
                    + sorted(glob(osp.join(root, sub, "*.jpg"))))

        ori, hs = frames("2_imgs"), frames("43_imgs")
        gt_flow = read_flow(glob(osp.join(root, "*.flo"))[0])
        occ = _read_rgb_u8(glob(osp.join(root, "*.png"))[0])[..., 2:3]  # cv2's BGR channel 0
        imgs_hs = [resize_linear(_read_rgb_u8(hs[i]).astype(np.float32), self.size)
                   for i in range(0, len(hs), self.interv)]
        return {
            "gt_flow": gt_flow.astype(np.float32),
            "occ_mask": occ.astype(np.float32) / 255.0,
            "sintel_imgs": [_read_rgb_u8(p).astype(np.float32) for p in ori[:2]],
            "hs_sintel_imgs": imgs_hs,
        }


def fetch_sintel_dataset(data_root: str, interv: int = 6, blacklist=(), size=(1024, 436)):
    return HighSpeedSintel(data_root, interv, blacklist, size)
