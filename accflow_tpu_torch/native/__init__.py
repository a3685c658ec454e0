"""The host C++ core of the CVOR data path (src/cvor_core.cpp, the port's
own copy of accflow_tpu/native's: the flow decode, the image normalisation
and the cropped batch gather), loaded with ctypes: counterpart of
accflow_tpu/native/__init__.py, for data/records.py.

It is built with g++ at first use, never on import, into the git-ignored
`_build/` beside this package (named by a hash of the source and flags, so
an edited source rebuilds), and its ABI version is checked. Without g++ on
the machine `get_lib()` is None and decode_flow_u16, normalize_u8 and
gather_crop compute the same bits in numpy, as JAX's do; a g++ that fails,
or a library of another ABI version, raises. This is host code: no device
kernel lives here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "cvor_core.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_P = ctypes.POINTER


def build() -> Optional[Path]:
    """Compile the core unless this source and these flags were built
    before. Returns the library's path, or None when there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"cvor_core-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded core, built on the first call; None without g++."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        path = build()
        if path is not None:
            lib = ctypes.CDLL(str(path))
            lib.cvor_abi_version.restype = ctypes.c_int
            lib.cvor_abi_version.argtypes = []
            if lib.cvor_abi_version() != ABI_VERSION:
                raise RuntimeError(f"{path}: ABI version {lib.cvor_abi_version()}, "
                                   f"expected {ABI_VERSION}")
            lib.cvor_decode_flow_u16.argtypes = [_P(ctypes.c_uint16), _P(ctypes.c_float),
                                                 ctypes.c_int64, ctypes.c_int]
            lib.cvor_decode_flow_u16.restype = None
            lib.cvor_normalize_u8.argtypes = [_P(ctypes.c_uint8), _P(ctypes.c_float),
                                              ctypes.c_int64, ctypes.c_int]
            lib.cvor_normalize_u8.restype = None
            crop = [_P(ctypes.c_int64), _P(ctypes.c_int32), _P(ctypes.c_int32),
                    *[ctypes.c_int64] * 6]
            lib.cvor_gather_crop.argtypes = [ctypes.c_void_p, *crop, ctypes.c_int64,
                                             ctypes.c_void_p, ctypes.c_int]
            lib.cvor_gather_crop.restype = None
            lib.cvor_gather_crop_decode_flow.argtypes = [_P(ctypes.c_uint16), *crop,
                                                         _P(ctypes.c_float), ctypes.c_int]
            lib.cvor_gather_crop_decode_flow.restype = None
            _lib = lib
        _tried = True
        return _lib


def available() -> bool:
    return get_lib() is not None


# Values a decode thread takes on. A call spawns its threads afresh, which
# costs more than it saves on what the readers decode per call (a 256^2
# training crop of one flow key is 0.66M values, a 512^2 sample 2.6M): those
# run on the calling thread, and only larger arrays (a whole column) spread
# over up to 8 threads.
VALUES_PER_THREAD = 1 << 22


def _threads(n: int) -> int:
    return max(1, min(os.cpu_count() or 1, 8, n // VALUES_PER_THREAD))


def decode_flow_u16(src: np.ndarray) -> np.ndarray:
    """uint16 -> float32 flow decode ((v - 2^15) / 128), native when built;
    the numpy path gives the same bits."""
    flat = np.ascontiguousarray(src, dtype=np.uint16)
    lib = get_lib()
    if lib is None:
        return (flat.astype(np.float32) - np.float32(32768.0)) / np.float32(128.0)
    out = np.empty(flat.shape, np.float32)
    lib.cvor_decode_flow_u16(flat.ctypes.data_as(_P(ctypes.c_uint16)),
                             out.ctypes.data_as(_P(ctypes.c_float)), flat.size,
                             _threads(flat.size))
    return out


def normalize_u8(src: np.ndarray) -> np.ndarray:
    """uint8 -> float32 2*(x/255)-1, native when built; the numpy path gives
    the same bits (x/255 rounded once, the doubling exact)."""
    flat = np.ascontiguousarray(src, dtype=np.uint8)
    lib = get_lib()
    if lib is None:
        return np.float32(2.0) * (flat.astype(np.float32) / np.float32(255.0)) - np.float32(1.0)
    out = np.empty(flat.shape, np.float32)
    lib.cvor_normalize_u8(flat.ctypes.data_as(_P(ctypes.c_uint8)),
                          out.ctypes.data_as(_P(ctypes.c_float)), flat.size,
                          _threads(flat.size))
    return out


def gather_crop(column: np.ndarray, indices, y0, x0, crop_hw: tuple,
                decode_flow: bool = False) -> np.ndarray:
    """The crops column[i, y:y+ch, x:x+cw] for i, y, x in zip(indices, y0,
    x0) of a column (N, H, W, C) (an array or a memmap) -> (B, ch, cw, C):
    float32 flow, decoded as decode_flow_u16 does, with decode_flow (a
    uint16 column), else the column's dtype. Native when built (rows copied
    over the batch x rows on up to 8 threads); the numpy path gives the
    same bits. ValueError for a crop outside the records."""
    n, h, w, c = column.shape
    ch, cw = crop_hw
    indices = np.ascontiguousarray(indices, np.int64)
    y0 = np.ascontiguousarray(y0, np.int32)
    x0 = np.ascontiguousarray(x0, np.int32)
    b = len(indices)
    if b and (indices.min() < 0 or indices.max() >= n or y0.min() < 0 or x0.min() < 0
              or y0.max() + ch > h or x0.max() + cw > w):
        raise ValueError(f"a crop of {ch}x{cw} at {list(zip(indices, y0, x0))} leaves "
                         f"the column's records ({n}, {h}, {w})")
    if decode_flow and column.dtype != np.uint16:
        raise ValueError(f"decode_flow needs a uint16 column, got {column.dtype}")
    lib = get_lib()
    if lib is None or b == 0:
        out = np.stack([column[i, yy:yy + ch, xx:xx + cw] for i, yy, xx in zip(indices, y0, x0)]
                       ) if b else np.empty((0, ch, cw, c), column.dtype)
        return decode_flow_u16(out) if decode_flow else out
    base = np.asarray(column)
    if not base.flags.c_contiguous:
        base = np.ascontiguousarray(base)
    crop = (indices.ctypes.data_as(_P(ctypes.c_int64)), y0.ctypes.data_as(_P(ctypes.c_int32)),
            x0.ctypes.data_as(_P(ctypes.c_int32)), b, h, w, c, ch, cw)
    threads = min(os.cpu_count() or 1, 8, b * ch)
    if decode_flow:
        out = np.empty((b, ch, cw, c), np.float32)
        lib.cvor_gather_crop_decode_flow(base.ctypes.data_as(_P(ctypes.c_uint16)), *crop,
                                         out.ctypes.data_as(_P(ctypes.c_float)), threads)
        return out
    out = np.empty((b, ch, cw, c), column.dtype)
    lib.cvor_gather_crop(base.ctypes.data, *crop, column.dtype.itemsize, out.ctypes.data,
                         threads)
    return out
