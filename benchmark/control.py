"""The control of a cell's `correct` on the card, on several seeds:

    python3 benchmark/control.py --workload accraft-cvo6 --seeds 11,12,13

prints, for each seed, the float8 reference's flow_err_px and flow_gap
(harness/compare.py) on the clips and weights that a run of the
cell with that seed compares (harness/control.py), beside the cell's
limit, and a JSON line of all of them last. On a cell of several chips the reference
is one process on one card, as rank 0 runs it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import compare, registry
    from benchmark.harness.control import control_readings

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = registry.cell(registry.load_spec(), args.workload)
    limit = compare.limit(args.workload)
    readings = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        readings[seed] = control_readings(cell, seed, torch.device("cuda"))
        print(f"control {args.workload} seed {seed}: {readings[seed]} (limit {limit!r} on "
              f"flow_err_px); {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "limit": limit, "control": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
