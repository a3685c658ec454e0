"""Input padding to /8-divisible dimensions, counterpart of
accflow_tpu/ops/padding.py (reference InputPadder,
networks/raft/utils/utils.py:7-28): replicate padding; 'sintel' mode splits
the pad evenly, otherwise all height padding goes to the bottom."""

from __future__ import annotations

import numpy as np


class InputPadder:
    """Pads (..., H, W, C) images so H and W are divisible by 8."""

    def __init__(self, dims, mode: str = "sintel"):
        self.ht, self.wd = dims[-3:-1] if len(dims) >= 3 else dims
        pad_ht = (((self.ht // 8) + 1) * 8 - self.ht) % 8
        pad_wd = (((self.wd // 8) + 1) * 8 - self.wd) % 8
        if mode == "sintel":
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2)
        else:
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)

    def pad_np(self, x: np.ndarray) -> np.ndarray:
        """Edge-pad a numpy array of any leading rank (..., H, W, C) on the
        host (FlowStream pads frames before they reach the device)."""
        left, right, top, bottom = self._pad
        width = [(0, 0)] * (x.ndim - 3) + [(top, bottom), (left, right), (0, 0)]
        return np.pad(x, width, mode="edge")

    def unpad(self, x):
        left, right, top, bottom = self._pad
        h, w = x.shape[-3:-1]
        return x[..., top: h - bottom, left: w - right, :]
