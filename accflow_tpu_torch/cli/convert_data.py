"""Convert the reference CVO LMDB datasets to CVOR columnar storage, the
port's counterpart of accflow_tpu/cli/convert_data.py (the same output):

    python -m accflow_tpu_torch.cli.convert_data --lmdb path/to/cvo_train.lmdb \\
        --out data/cvor/train

Requires the `lmdb` package and a pyarrow <= 11 (legacy
`pyarrow.deserialize`, pinned by the reference's environment.yml), both
optional: this tool is needed once, on a machine with the original data.
The CVOR output needs neither. Flow uint16 payloads are copied bit for bit
(the (v - 2^15)/128 decode, data/dataset.py:65-67, is applied at read time
by CVORReader).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def convert(lmdb_path: str, out_dir: str, limit: int | None = None) -> int:
    try:
        import lmdb  # type: ignore
    except ImportError as e:
        raise SystemExit(
            "the `lmdb` package is required for conversion (pip install lmdb)"
        ) from e
    import pyarrow as pa

    if not hasattr(pa, "deserialize"):
        raise SystemExit(
            "pyarrow>=12 removed the legacy deserialize; run this converter "
            "with pyarrow<=11 (the reference pins pyarrow==11)"
        )

    from accflow_tpu_torch.data.records import ALL_KEYS, CVORWriter

    env = lmdb.open(lmdb_path, subdir=os.path.isdir(lmdb_path), readonly=True, lock=False,
                    readahead=False, meminit=False)
    with env.begin(write=False) as txn:
        def value(i: int, key: str) -> np.ndarray:
            return np.asarray(pa.deserialize(txn.get(f"{i:05d}_{key}".encode())))

        samples = pa.deserialize(txn.get(b"__samples__"))
        n = len(samples) if limit is None else min(limit, len(samples))
        specs = {k: {"shape": tuple(value(0, k).shape),
                     "dtype": "uint16" if "flow" in k else "uint8"} for k in ALL_KEYS}
        with CVORWriter(out_dir, specs) as wr:
            for i in range(n):
                wr.add({k: value(i, k) for k in ALL_KEYS})
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--lmdb", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    n = convert(args.lmdb, args.out, args.limit)
    print(f"converted {n} samples -> {args.out}")


if __name__ == "__main__":
    main()
