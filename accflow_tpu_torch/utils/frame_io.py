"""Flow/image file IO: .flo (Middlebury), .pfm, KITTI 16-bit png; the
port's copy of accflow_tpu/utils/frame_io.py (numpy only; PIL and cv2 are
imported inside the branches that need them).

Behavior-compatible with the reference's utils/frame_utils.py:16-144.
"""

from __future__ import annotations

import re
from os.path import splitext

import numpy as np

TAG_CHAR = np.array([202021.25], np.float32)


def read_flow(fn: str) -> np.ndarray:
    """Read a .flo file -> (H, W, 2) float32."""
    with open(fn, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic != 202021.25:
            raise ValueError(f"{fn}: invalid .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
        return np.resize(data, (h, w, 2))


def write_flow(fn: str, uv: np.ndarray, v: np.ndarray | None = None) -> None:
    """Write a .flo file from (H, W, 2) or separate u, v planes."""
    n_bands = 2
    if v is None:
        assert uv.ndim == 3 and uv.shape[2] == 2
        u = uv[:, :, 0]
        v = uv[:, :, 1]
    else:
        u = uv
    assert u.shape == v.shape
    height, width = u.shape
    with open(fn, "wb") as f:
        TAG_CHAR.tofile(f)
        np.array(width).astype(np.int32).tofile(f)
        np.array(height).astype(np.int32).tofile(f)
        tmp = np.zeros((height, width * n_bands), np.float32)
        tmp[:, np.arange(width) * 2] = u
        tmp[:, np.arange(width) * 2 + 1] = v
        tmp.astype(np.float32).tofile(f)


def read_pfm(file: str):
    with open(file, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim_match = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if dim_match:
            width, height = map(int, dim_match.groups())
        else:
            raise ValueError("Malformed PFM header.")
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        if scale < 0:
            scale = -scale
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = np.reshape(data, shape)
    return np.flipud(data), scale


def read_flow_kitti(fn: str):
    """KITTI png16: flow = (png/64 - 512), valid = 3rd channel."""
    import cv2

    flow = cv2.imread(fn, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    flow = flow[:, :, ::-1].astype(np.float32)
    flow, valid = flow[:, :, :2], flow[:, :, 2]
    flow = (flow - 2**15) / 64.0
    return flow, valid


def write_flow_kitti(fn: str, uv: np.ndarray) -> None:
    import cv2

    uv = 64.0 * uv + 2**15
    valid = np.ones([uv.shape[0], uv.shape[1], 1])
    uv = np.concatenate([uv, valid], axis=-1).astype(np.uint16)
    cv2.imwrite(fn, uv[..., ::-1])


def read_gen(file_name: str):
    ext = splitext(file_name)[-1]
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        from PIL import Image

        return np.array(Image.open(file_name))
    if ext in (".bin", ".raw"):
        return np.load(file_name)
    if ext == ".flo":
        return read_flow(file_name).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(file_name)[0].astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    raise ValueError(f"unsupported extension: {ext}")
