"""Training augmentation, the port's own copy of accflow_tpu/data/augment.py.
The reference FlowAugmentor (data/augmentor.py) applies only a random crop,
identical across every tensor in the sample."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def random_crop(
    sample: Mapping[str, np.ndarray],
    crop_size,
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """Crop all HWC arrays in `sample` with one shared random window."""
    if isinstance(crop_size, int):
        crop_size = (crop_size, crop_size)
    ch, cw = crop_size
    ht, wd = next(iter(sample.values())).shape[:2]
    y0 = int(rng.integers(0, ht - ch)) if ht > ch else 0
    x0 = int(rng.integers(0, wd - cw)) if wd > cw else 0
    return {k: v[y0 : y0 + ch, x0 : x0 + cw, :] for k, v in sample.items()}
