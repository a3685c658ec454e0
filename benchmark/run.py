"""Run one cell of the benchmark of accflow_tpu_torch once, from the root of
a checkout:

    python3 benchmark/run.py --workload accraft-cvo6 --seed 7 --seconds 30 --trace 0

The cell is a `workloads` entry of BENCHMARK.json (harness/registry.py).
The last line of standard output is the result, one JSON object: with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
metrics read from torch.profiler over the window. The numbers that decide
`correct` are the last lines of standard error and the result's last key.

Without a card, or with fewer cards than the cell asks for, it exits 2 and
prints no result. A cell of N > 1 chips runs N processes, one a card, the
frame height split over them; this process launches them, waits for them
and prints rank 0's result. Kernel caches stay in the checkout: the port's
CUDA libraries in accflow_tpu_torch/_build/, and torch's extension and
Triton caches under .bench_cache/.
"""

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Set by this script for the ranks it launches.
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    # Used by the benchmark's own tests only.
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _caches() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        path = ROOT / ".bench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def _finish(result: dict) -> int:
    """Print the checks and the result line; 3 without a result."""
    from benchmark.harness.runner import forbidden_modules

    found = sorted(set(result.get("forbidden", [])) | set(forbidden_modules()))
    if found:
        print(f"bench: refused: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"bench: correct={result['correct']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness import registry

    cell = registry.cell(registry.load_spec(), args.workload)
    for m in cell["per_layer"]:
        m["reader"] = registry.load_metric(m["name"])
    chips = cell["workload"]["chips"]
    _caches()
    import torch

    if args.rank is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"bench: {args.workload} needs {chips} CUDA card(s); this machine has {n}",
                  file=sys.stderr)
            return 2
        if chips > 1:
            from benchmark.harness.launch import launch

            result = launch(args, chips, T0_WALL, Path(__file__).resolve())
            return 1 if result is None else _finish(result)
    from benchmark.harness.runner import run_rank

    rank = args.rank or 0
    result = run_rank(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", rank), args.t0 or T0_WALL, rank=rank, world=chips,
                      fault=args.fault)
    if args.rank is not None:  # a launched rank: rank 0 hands its result to the launcher
        torch.distributed.destroy_process_group()
        if result is not None:
            print(json.dumps(result), flush=True)
        return 0
    return _finish(result)


if __name__ == "__main__":
    sys.exit(main())
