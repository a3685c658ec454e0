"""CVOR: a columnar storage format for CVO-style video-flow data, the port's
own numpy copy of accflow_tpu/data/records.py (importing accflow_tpu.data
pulls in jax). The files it writes and reads are the JAX package's.

The reference stores CVO in LMDB with values serialized by the legacy
`pyarrow.serialize` (data/dataset.py:36-69) — a format removed from modern
pyarrow and poorly suited to high-throughput accelerator feeding (per-key
B-tree lookups, python deserialization, no zero-copy).

CVOR instead stores one flat binary file per key ("column"), mmap-able and
zero-copy: every sample has identical static shapes (7 frames of HxWx3
uint8; 5 or 6 flows of HxWx2), so sample i's bytes live at a fixed offset
i * record_nbytes — no index, no decoder, O(1) random access, and reads can
go straight into pinned host buffers for device transfer.

Flow encoding matches the LMDB fingerprint exactly: uint16 with
value = flow * 128 + 2^15, decoded as (v - 2^15) / 128 (dataset.py:65-67),
so converted datasets are bit-identical to the reference's decode.

Layout of a CVOR dataset directory:
    meta.json           {"num_samples": N, "keys": {name: {"shape": [...],
                         "dtype": "uint8"|"uint16"}}, "version": 1}
    <key>.bin           N consecutive raw records, C-order.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, Iterable, Mapping, Sequence

import numpy as np

FLOW_OFFSET = np.float32(2**15)
FLOW_SCALE = np.float32(128.0)


def encode_flow_u16(flow: np.ndarray) -> np.ndarray:
    """float32 flow -> uint16 storage (reference LMDB encoding)."""
    v = np.rint(flow.astype(np.float32) * FLOW_SCALE + FLOW_OFFSET)
    return np.clip(v, 0, 65535).astype(np.uint16)


def decode_flow_u16(raw: np.ndarray) -> np.ndarray:
    """uint16 storage -> float32 flow ((v - 2^15) / 128, dataset.py:65-67),
    in numpy: the JAX package's own fallback, bit-identical to its native
    decoder, which this package does not import."""
    return (raw.astype(np.float32) - FLOW_OFFSET) / FLOW_SCALE


class CVORWriter:
    """Streaming writer: append one sample dict at a time."""

    def __init__(self, out_dir: str, key_specs: Mapping[str, dict]):
        """key_specs: {name: {"shape": tuple, "dtype": "uint8"|"uint16"}}.

        Flow keys must use dtype uint16 (use encode_flow_u16 on the values
        or pass float32 arrays — they are encoded automatically)."""
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.key_specs = {
            k: {"shape": tuple(v["shape"]), "dtype": str(v["dtype"])}
            for k, v in key_specs.items()
        }
        self._files = {
            k: open(osp.join(out_dir, f"{k}.bin"), "wb") for k in key_specs
        }
        self.num_samples = 0

    def add(self, sample: Mapping[str, np.ndarray]) -> None:
        for k, spec in self.key_specs.items():
            arr = np.asarray(sample[k])
            if spec["dtype"] == "uint16" and arr.dtype != np.uint16:
                arr = encode_flow_u16(arr)
            arr = np.ascontiguousarray(arr.astype(spec["dtype"], copy=False))
            if tuple(arr.shape) != spec["shape"]:
                raise ValueError(
                    f"{k}: expected {spec['shape']}, got {arr.shape}"
                )
            self._files[k].write(arr.tobytes())
        self.num_samples += 1

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        meta = {
            "version": 1,
            "num_samples": self.num_samples,
            "keys": {
                k: {"shape": list(v["shape"]), "dtype": v["dtype"]}
                for k, v in self.key_specs.items()
            },
        }
        with open(osp.join(self.out_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CVORReader:
    """Zero-copy mmap reader. `sample(i, keys)` returns decoded float32
    arrays (HWC layout, frames/flows concatenated along channels exactly
    like the reference LMDB samples)."""

    def __init__(self, path: str, keys: Sequence[str] | None = None):
        with open(osp.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self.path = path
        self.num_samples = self.meta["num_samples"]
        available = self.meta["keys"]
        self.keys = list(keys) if keys is not None else list(available)
        for k in self.keys:
            if k not in available:
                raise KeyError(f"key {k!r} not in dataset ({list(available)})")
        self._mm: Dict[str, np.memmap] = {}
        for k in self.keys:
            spec = available[k]
            self._mm[k] = np.memmap(
                osp.join(path, f"{k}.bin"),
                dtype=spec["dtype"],
                mode="r",
                shape=tuple([self.num_samples] + list(spec["shape"])),
            )

    def __len__(self) -> int:
        return self.num_samples

    def raw(self, index: int, key: str) -> np.ndarray:
        return self._mm[key][index]

    def sample_cropped(
        self, index: int, y0: int, x0: int, ch: int, cw: int,
        keys: Iterable[str] | None = None,
    ) -> Dict[str, np.ndarray]:
        """Like sample(), but slices the (y0:y0+ch, x0:x0+cw) window from
        the raw memmap BEFORE decoding — the training loader decodes only
        the crop (a 4x decode saving at the reference's 256^2-of-512^2
        recipe), reading just the needed rows from disk cache."""
        out = {}
        for k in keys if keys is not None else self.keys:
            raw = np.ascontiguousarray(self._mm[k][index, y0 : y0 + ch, x0 : x0 + cw])
            if "flow" in k:
                out[k] = decode_flow_u16(raw)
            else:
                out[k] = raw
        return out

    def sample(self, index: int, keys: Iterable[str] | None = None) -> Dict[str, np.ndarray]:
        out = {}
        for k in keys if keys is not None else self.keys:
            raw = self._mm[k][index]
            if "flow" in k:
                out[k] = decode_flow_u16(raw)
            else:
                out[k] = np.asarray(raw, dtype=np.float32)
        return out
