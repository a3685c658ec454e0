"""Flow/image file IO: .flo (Middlebury), .pfm, KITTI 16-bit png; the
port's copy of accflow_tpu/utils/frame_io.py (numpy only; PIL and cv2 are
imported inside the branches that need them), and `read_png`, an 8-bit PNG
decoder on the standard library's zlib for machines without PIL or cv2.

Behavior-compatible with the reference's utils/frame_utils.py:16-144.
"""

from __future__ import annotations

import re
import struct
import zlib
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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type: grey, grey+alpha, RGB, RGBA


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG (grey, grey+alpha, RGB or RGBA) as
    (H, W, C) uint8, decoded with zlib and the five row filters of the PNG
    specification. Any other PNG (16-bit samples, a palette, Adam7
    interlacing) raises ValueError naming the file and what it lacks."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat, pos = None, [], 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {colour} (palette) is not supported: "
                         "read_png reads grey, grey+alpha, RGB and RGBA")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG samples are not supported: read_png "
                         "reads 8-bit samples only")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported: read_png reads "
                         "non-interlaced images only")
    bpp = _PNG_CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (w * bpp + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    rows = raw[: h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    filters, pixels = rows[:, 0], rows[:, 1:].reshape(h, w, bpp)
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: PNG row filter {int(filters.max())} does not exist")
    if np.isin(filters, (3, 4)).any():
        out = _unfilter_wavefront(filters, pixels)
    else:
        out = _unfilter_rows(filters, pixels)
    return out


def _unfilter_rows(filters: np.ndarray, pixels: np.ndarray) -> np.ndarray:
    """Rows filtered with None (0), Sub (1) or Up (2) only, one row at a
    time: Sub is a running sum along the row, Up a sum with the row above
    (both modulo 256)."""
    out = np.empty_like(pixels)
    prev = np.zeros_like(pixels[0])
    for y, kind in enumerate(filters):
        line = pixels[y]
        if kind == 1:
            line = np.cumsum(line, axis=0, dtype=np.uint8)
        elif kind == 2:
            line = line + prev
        out[y] = line
        prev = out[y]
    return out


def _unfilter_wavefront(filters: np.ndarray, pixels: np.ndarray) -> np.ndarray:
    """Any mix of the five filters. Avg (3) and Paeth (4) predict a byte from
    the decoded bytes to its left, above and above-left, so a row is
    sequential along x; but every pixel on one anti-diagonal y + x = d
    depends only on diagonals d-1 and d-2. So the image is decoded one
    diagonal at a time, vectorised along it, in a skewed copy where
    diagonal d is row d + 2 and pixel (y, x) sits at column y + 1: its left,
    upper and upper-left neighbours are then plain slices of rows d + 1 and
    d, and the entries never written (outside the image) are the zeros that
    PNG predicts from there."""
    h, w, bpp = pixels.shape
    ys, xs = np.mgrid[:h, :w]
    raw = np.zeros((h + w - 1, h, bpp), np.int16)
    raw[ys + xs, ys] = pixels
    dec = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    kinds = filters.astype(np.int16)[:, None]
    sub, up_, avg, paeth_ = (kinds == k for k in (1, 2, 3, 4))
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h - 1, d) + 1
        left, up, corner = dec[d + 1, y0 + 1: y1 + 1], dec[d + 1, y0: y1], dec[d, y0: y1]
        pa, pb, pc = np.abs(up - corner), np.abs(left - corner), np.abs(left + up - 2 * corner)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, corner))
        pred = np.where(sub[y0:y1], left, np.where(up_[y0:y1], up, np.where(
            avg[y0:y1], (left + up) >> 1, np.where(paeth_[y0:y1], paeth, 0))))
        dec[d + 2, y0 + 1: y1 + 1] = (raw[d, y0:y1] + pred) & 255
    return dec[ys + xs + 2, ys + 1].astype(np.uint8)
