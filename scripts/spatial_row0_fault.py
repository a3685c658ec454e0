#!/usr/bin/env python3
"""Whether phase 21's bars (chip_smoke.py: the spatial axis over two gloo
ranks on one card) catch rows put in the wrong place:

    python3 scripts/spatial_row0_fault.py      # from the root of a checkout

It runs phase 21 as chip_smoke.py does, with one fault planted in the two
sharded ranks only: RAFT's coordinates start every rank at row 0
(models/raft.py::raft_iterate's coords_grid, where a rank's rows start at
its first global row). The one-process references run unchanged. Each
case's distance to one process is printed beside its bar, and every case
runs to its end (chip_smoke's `fail` is recorded, not raised). The code of
the checkout is not changed: the fault is patched in at run time, in the
ranks' processes, which this script starts in place of chip_smoke.py's.

The last line is one JSON object: each case's distance, bar and whether
the bar caught the fault. The exit code is 0 if every case caught it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def plant_row0_fault() -> None:
    """Every rank's RAFT coordinates start at row 0."""
    from accflow_tpu_torch.models import raft

    coords_grid = raft.coords_grid
    raft.coords_grid = lambda *a, **k: coords_grid(*a, **{**k, "row0": 0})


class _Subprocess:
    """chip_smoke's subprocess module, with phase 21's ranks started as
    this script (which plants the fault, then runs chip_smoke's child)."""

    def __getattr__(self, name):
        return getattr(subprocess, name)

    @staticmethod
    def Popen(cmd, **kw):
        if "--spatial-child" in cmd:
            cmd = [sys.executable, str(Path(__file__).resolve()), *cmd[2:]]
        return subprocess.Popen(cmd, **kw)


def main() -> int:
    if sys.argv[1:2] == ["--spatial-child"]:
        plant_row0_fault()
        return chip_smoke.main()
    if not chip_smoke.torch.cuda.is_available():
        print("spatial_row0_fault: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.smi("name,power.limit"))
    failures = []
    chip_smoke.fail = failures.append
    chip_smoke.subprocess = _Subprocess()
    chip_smoke.build_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        rows = chip_smoke.spatial_phase(tmp)
    out = {case: dict(max_abs=rows[case]["max_abs"], bar=rows[case]["bar"],
                      flow_max=rows[case]["flow_max"],
                      caught=not rows[case]["max_abs"] <= rows[case]["bar"])
           for case in chip_smoke.SPATIAL_CASES}
    for case, r in out.items():
        print(f"row-0 fault ({case}): max abs {r['max_abs']:.3e} against one process, bar "
              f"{r['bar']:.3e} ({r['max_abs'] / r['bar']:.2f}x; |flow| max {r['flow_max']:.3e}): "
              f"{'caught' if r['caught'] else 'NOT caught'}")
    print(f"phase 21's checks that failed: {len(failures)}")
    print(json.dumps({"row0_fault": out}))
    return 0 if all(r["caught"] for r in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
