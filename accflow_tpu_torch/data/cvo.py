"""CVO dataset pipelines over CVOR storage (see records.py), the port's own
copy of accflow_tpu/data/cvo.py.

Mirrors the reference's data layer behavior (data/dataset.py):
- key whitelist {fflows, bflows, delta_fflows, delta_bflows} (+ imgs or
  imgs_blur chosen by split, dataset.py:80-83; the blur key is renamed to
  "imgs" in the output dict, :95-97);
- "clean+final" concatenates both splits (dataset.py:113-126);
- training applies the shared random crop; eval never augments;
- train loaders shuffle and drop the last partial batch; eval loaders are
  sequential and keep it.

Batches are dicts of numpy arrays shaped (N, H, W, C) (channels-last; the
reference's CHW `totensor` is a torch convention we do not carry over).
prefetch.py overlaps decode with device compute and feeds the card.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from accflow_tpu_torch.data.records import CVORReader

FLOW_KEYS = ("fflows", "bflows", "delta_fflows", "delta_bflows")


class CVODataset:
    """One split of CVO, reading the requested keys only."""

    def __init__(
        self,
        root: str,
        keys: Sequence[str],
        split: str = "clean",
        is_training: bool = True,
        crop_size=256,
    ):
        keys = [k.lower() for k in keys]
        for k in keys:
            if k not in FLOW_KEYS:
                raise ValueError(f"invalid key: {k}")
        img_key = "imgs" if split == "clean" else "imgs_blur"
        self._img_key = img_key
        self._keys = list(keys) + [img_key]
        subdir = "train" if is_training else "test"
        self.reader = CVORReader(osp.join(root, subdir), self._keys)
        self.is_training = is_training
        self.crop_size = crop_size

    def __len__(self) -> int:
        return len(self.reader)

    def get(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        if self.is_training:
            # Same draw order/window as augment.random_crop, but the crop
            # is applied to the RAW records so only the window is decoded.
            rng = rng if rng is not None else np.random.default_rng()
            cs = self.crop_size
            ch, cw = (cs, cs) if isinstance(cs, int) else cs
            spec = next(iter(self.reader.meta["keys"].values()))
            ht, wd = spec["shape"][0], spec["shape"][1]
            y0 = int(rng.integers(0, ht - ch)) if ht > ch else 0
            x0 = int(rng.integers(0, wd - cw)) if wd > cw else 0
            sample = self.reader.sample_cropped(index, y0, x0, ch, cw)
        else:
            sample = self.reader.sample(index)
        if self._img_key != "imgs":
            sample["imgs"] = sample.pop(self._img_key)
        return sample


class ConcatDataset:
    """dataset_clean + dataset_final (reference: `dataset = clean + final`)."""

    def __init__(self, datasets: List):
        self.datasets = datasets
        self._sizes = [len(d) for d in datasets]

    def __len__(self) -> int:
        return sum(self._sizes)

    def get(self, index: int, rng=None):
        for d, n in zip(self.datasets, self._sizes):
            if index < n:
                return d.get(index, rng)
            index -= n
        raise IndexError(index)


def _collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchIterator:
    """Deterministic, seedable batch iterator (one epoch)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool,
        drop_last: bool,
        seed: int = 0,
        epoch: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, self.epoch))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, stop, self.batch_size):
            idx = order[start : start + self.batch_size]
            yield _collate([self.dataset.get(int(i), rng) for i in idx])


def fetch_train_dataset(
    root: str, keys: Sequence[str], crop_size=256, split: str = "clean+final"
):
    if "+" in split:
        parts = [
            CVODataset(root, keys, split=s, is_training=True, crop_size=crop_size)
            for s in split.split("+")
        ]
        return ConcatDataset(parts)
    return CVODataset(root, keys, split=split, is_training=True, crop_size=crop_size)


def fetch_valid_dataset(root: str, keys: Sequence[str], split: str = "clean"):
    if "+" in split:
        parts = [
            CVODataset(root, keys, split=s, is_training=False)
            for s in split.split("+")
        ]
        return ConcatDataset(parts)
    return CVODataset(root, keys, split=split, is_training=False)
