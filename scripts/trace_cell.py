"""Run one benchmark cell's set-up and measured window with the port's spans
on (or off) and print where a call's time goes: device ms a call by span
and by kind of kernel, the spans' own readings, and what the spans cost.

    python3 scripts/trace_cell.py --workload accraft-1080p --seed 7 --seconds 30 --spans 1

Set-up and window are the benchmark's (benchmark/harness: the cell's
configuration built with weights and clips drawn from the seed, its
warm-up calls, the closed loop, torch.profiler over the window's last
10 s); the spans (accflow_tpu_torch/utils/profiling.py) are switched on
before the build with --spans 1. One card. The table goes to standard
error, and the last line of standard output is one JSON object:

- frames_per_s, latency_mean_ms: the window before the profile starts;
- kernels_per_call, kinds_ms, device_idle_pct: the profiled calls, as
  the benchmark's readers read them; gaps_ms: the device's idle gaps by
  the innermost host event over them (benchmark/harness/profile.py's
  labels; with spans on, "graphs.replay" is a gap while the host was in
  a replay's Python, outside its copies and launch);
- with --spans 1, per profiled call: ofe_ms (acc.ofe), corr_build_ms
  (corr.build), update_ms (est.update less its children: corr.build,
  gma.aggregate), attention_ms (gma.attention and gma.aggregate),
  cells_ms (acc.cells), clip_ms (acc.clip), call_idle_ms (the device
  idle inside acc.clip's aligned extent), events_per_call; capture_s
  (graphs.capture less cuda_lib.build in set-up) and build_s
  (cuda_lib.build); the residual of the alignment (profiling.align), the
  residuals of the calls it left out (the profile's device clock stepped
  inside them: the table and call_idle_ms are over the other calls) and
  the span x kind table.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

T0 = time.time()
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from accflow_tpu_torch.utils import profiling  # noqa: E402
from benchmark.harness import profile as prof_mod  # noqa: E402
from benchmark.harness import registry, runner, system, traffic  # noqa: E402


def print_table(rows: dict, idle: dict, calls: int) -> None:
    kinds = sorted({k for row in rows.values() for k in row})
    print("span x kind, device ms a call (innermost span; 'None': outside every span)",
          file=sys.stderr)
    print(f"{'span':<16}" + "".join(f"{k:>12}" for k in kinds) + f"{'idle':>10}{'total':>11}",
          file=sys.stderr)
    for span in sorted(rows, key=lambda s: -sum(rows[s].values())):
        row = rows[span]
        gap = 1e3 * idle.get(span, 0.0) / calls if span != "None" else 0.0
        print(f"{span:<16}" + "".join(f"{row.get(k, 0.0):>12.3f}" for k in kinds)
              + f"{gap:>10.3f}{sum(row.values()):>11.3f}", file=sys.stderr)


def print_gaps(gaps_ms: dict) -> None:
    """The device's idle gaps by their label, ms a call, longest first."""
    print("idle gaps by the host event over them, ms a call", file=sys.stderr)
    for label, ms in sorted(gaps_ms.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:10.4f}  {label}", file=sys.stderr)


def run(cell: dict, seed: int, seconds: float, spans: bool, device) -> dict:
    """One run of `cell` (registry.cell) on `device`; the result line."""
    config, tr = cell["config"], cell["traffic"]
    if spans:
        profiling.spans(True)
    est, acc = system.build(config, seed, device)
    pool = traffic.clip_pool(tr, seed + 1, device)
    fn = system.serve_fn(est, acc)
    for i in range(tr["warmup_calls"]):
        fn(pool[i % tr["pool"]])
    runner._sync(device)
    setup_s = time.time() - T0
    setup = profiling.drain()
    times, _, start, _, prof, traced_calls, traced_s = runner.window(fn, pool, seconds, device,
                                                                     True)
    untraced = times[:len(times) - traced_calls]
    n_frames = tr["batch"] * tr["frames"]
    out = {"workload": cell["workload"]["name"], "seed": seed, "spans": int(spans),
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "setup_s": setup_s, "traced_calls": traced_calls,
           "frames_per_s": len(untraced) * n_frames / (untraced[-1][1] - start),
           "latency_mean_ms": 1e3 * statistics.fmean(d - i for i, d in untraced),
           "traced_latency_mean_ms": 1e3 * statistics.fmean(
               d - i for i, d in times[len(times) - traced_calls:])}
    summary = prof_mod.summarize(prof, traced_calls, traced_s, (0, 0))
    out["kernels_per_call"] = sum(n for _, n in summary["kernels"].values()) / traced_calls
    out["kinds_ms"] = {k: 1e3 * v / traced_calls for k, v in prof_mod.by_kind(summary).items()}
    out["busy_ms"] = 1e3 * summary["busy_s"] / traced_calls
    out["device_idle_pct"] = 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
    out["gaps_ms"] = {k: 1e3 * v / traced_calls for k, v in summary["gaps"].items()}
    print_gaps(out["gaps_ms"])
    if not spans:
        return out
    out.update(profiling.setup_s(setup))
    recs = profiling.drain()
    calls = set(sorted({r.call for r in recs if r.name == "acc.clip"})[-traced_calls:])
    recs = [r for r in recs if r.call in calls]
    out.update(profiling.layer_ms(recs))
    aligned, residuals, dropped = profiling.align(prof, recs, drop=True)
    att = profiling.attribute(prof, aligned, [(a, b) for a, b, _ in dropped.values()])
    kept = len(residuals)
    out["call_idle_ms"] = 1e3 * sum(att["idle"].values()) / kept
    out["idle_by_span_ms"] = {k: 1e3 * v / kept for k, v in att["idle"].items()}
    res = list(residuals.values())
    out["residual_us"] = [min(res), statistics.fmean(res), max(res)]
    out["dropped_residual_us"] = [r for _, _, r in dropped.values()]
    out["table_ms"] = profiling.span_table(att, kept, prof_mod.kind_of)
    print_table(out["table_ms"], att["idle"], kept)
    print(f"trace_cell: each replay's events' extent less its kernels' (profiling.align) "
          f"min / mean / max {out['residual_us']} us over {kept} calls; left out "
          f"{len(dropped)}: {out['dropped_residual_us']} us", file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    cell = registry.cell(registry.load_spec(), args.workload)
    if cell["workload"]["chips"] != 1 or not torch.cuda.is_available():
        print("trace_cell: needs a card, and a cell of one chip", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.spans), torch.device("cuda", 0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
