"""The inference API's frame coercion, counterpart of accflow_tpu/api.py:
`_as_frames` for one image, as FlowStream (streaming.py) sends it. Its
sequence mode and FlowPipeline are not ported yet (ROADMAP.md, queue 1)."""

from __future__ import annotations

import numpy as np


def _as_frames(image, normalized: bool) -> tuple[np.ndarray, bool]:
    """Coerce one user image, HWC or an NHWC batch (grayscale and RGBA
    taken), to (N, H, W, 3) float32 in [-1, 1]; `normalized` frames are
    already in [-1, 1]. Returns (array, had_batch_axis)."""
    a = np.asarray(image)
    if a.ndim == 2:  # single grayscale
        a = a[..., None]
    if a.shape[-1] == 1:  # grayscale -> RGB, like cli/demo.py
        a = np.concatenate([a] * 3, axis=-1)
    if a.shape[-1] == 4:  # drop alpha
        a = a[..., :3]
    if a.shape[-1] != 3:
        raise ValueError(f"expected channels-last RGB images, got shape {a.shape}")
    if a.ndim not in (3, 4):
        raise ValueError(f"expected one (N)HWC image, got shape {a.shape}")
    batched = a.ndim == 4
    a = a.astype(np.float32)
    if not batched:
        a = a[None]
    if not normalized:
        if a.size:
            # Guard the classic footguns: float frames in [0, 1]
            # (matplotlib/skimage convention) or already in [-1, 1] would be
            # silently crushed to ~-1 by the [0, 255] preprocess.
            amin, amax = float(a.min()), float(a.max())
            if amin < 0.0:
                raise ValueError(
                    f"float frames span [{amin:.3g}, {amax:.3g}] — they look "
                    "already normalized; pass normalized=True"
                )
            if amax <= 1.0 and np.issubdtype(np.asarray(image).dtype, np.floating):
                raise ValueError(
                    f"float frames span [{amin:.3g}, {amax:.3g}] — they look "
                    "[0, 1]-scaled; scale to [0, 255] or pass normalized=True "
                    "for [-1, 1] input"
                )
        a = 2.0 * (a / 255.0) - 1.0  # test_cvo.py:32-50 preprocess
    return a, batched
