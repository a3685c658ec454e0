"""Middlebury flow visualization (color wheel), numpy implementation; the
port's copy of accflow_tpu/utils/flow_viz.py.

Behavior-compatible with the reference's flow_to_image (utils/flow_viz.py,
byte-identical copies also at networks/{raft,gma}/utils/flow_viz.py):
55-entry RY/YG/GC/CB/BM/MR wheel, flow normalized by its maximum radius,
bilinear interpolation between wheel spokes, out-of-range shown dimmed.

Provenance: this constant-table algorithm follows the canonical Middlebury
flow-color code of Baker et al. / Daniel Scharstein (C++) and Deqing Sun
(MATLAB), as popularized by Tom Runia's MIT-licensed
OpticalFlow_Visualization (github.com/tomrunia/OpticalFlow_Visualization),
which is also what the reference vendors. Any correct implementation of the
wheel is necessarily near-identical; this one is restyled (module-level
wheel constant, modulo wrap, type hints) but algorithmically the same.
"""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(0, RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(0, YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(0, GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(0, BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = make_colorwheel()


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray, convert_to_bgr: bool = False) -> np.ndarray:
    flow_image = np.zeros((u.shape[0], u.shape[1], 3), np.uint8)
    ncols = _WHEEL.shape[0]
    rad = np.sqrt(np.square(u) + np.square(v))
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    for i in range(3):
        tmp = _WHEEL[:, i]
        col0 = tmp[k0] / 255.0
        col1 = tmp[k1] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        ch_idx = 2 - i if convert_to_bgr else i
        flow_image[:, :, ch_idx] = np.floor(255 * col)
    return flow_image


def flow_to_image(
    flow_uv: np.ndarray, clip_flow: float | None = None, convert_to_bgr: bool = False
) -> np.ndarray:
    """flow (H, W, 2) -> RGB uint8 (H, W, 3)."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[:, :, 0], flow_uv[:, :, 1]
    rad = np.sqrt(np.square(u) + np.square(v))
    rad_max = np.max(rad)
    epsilon = 1e-5
    u = u / (rad_max + epsilon)
    v = v / (rad_max + epsilon)
    return flow_uv_to_colors(u, v, convert_to_bgr)
