"""Batch helpers of accflow_tpu/train/engine.py that evaluation needs:
`to_clip`, `to_flow_seq`, `pad_batch`. The rest of that engine is training
(not ported; ROADMAP.md, queue 1 #10)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def to_clip(imgs, frames: Optional[int] = None) -> torch.Tensor:
    """(N, H, W, 3*T) uint8/float (numpy or tensor) -> (T, N, H, W, 3)
    float32 in [-1, 1], on the input's device (train_acc.py:62). frames, if
    given, asserts the clip length (the CVO protocol's 7)."""
    x = torch.as_tensor(imgs)
    n, h, w, c = x.shape
    t = c // 3
    if c % 3 or (frames is not None and t != frames):
        raise ValueError(f"expected {frames or 'T'} frames of 3 channels, got {c} channels")
    x = 2.0 * (x.float() / 255.0) - 1.0
    return x.reshape(n, h, w, t, 3).movedim(3, 0)


def to_flow_seq(flows) -> torch.Tensor:
    """(N, H, W, 2*S) -> (S, N, H, W, 2) (train_acc.py:59)."""
    x = torch.as_tensor(flows)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, c // 2, 2).movedim(3, 0)


def pad_batch(batch: dict, size: int):
    """Pad a host batch dict to `size` samples by repeating the last sample
    (every batch keeps one shape). Returns (padded, n_valid)."""
    n = next(iter(batch.values())).shape[0]
    if n == size:
        return batch, n
    pad = size - n
    return {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
            for k, v in batch.items()}, n
