"""One run of one cell: set-up, the measured window, the readings, the
comparison with the reference, and the result line.

Set-up (counted in setup_s, from the process's start to the first timed
call): the imports, the card, the kernel libraries, the weights drawn on
the card from the seed, the pool of clips drawn on the card from the
seed, and `warmup_calls` calls of the graphed entry on the pool (the
first one runs the function twice eagerly and captures its graph: every
shape the window uses). The window is a closed loop with one client:
each call takes the next clip of the pool, and the next call is issued
only once its flows are ready on the device; calls run until `seconds`
have passed. On a cell of N chips the frame height is split over N ranks,
one process a card, and rank 0 decides when the window ends.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from benchmark import work
from benchmark.harness import compare, faults, profile, traffic
from benchmark.harness import weights as weight_draw

FORBIDDEN = ("jax", "jaxlib", "flax", "accflow_tpu")  # top-level names, compared whole


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# A traced run profiles the last TRACE_S seconds of its window: a profile
# of every call of a 30 s window of the CVO-6 clip holds 1.6 million
# device events, which take minutes to read.
TRACE_S = 10.0
GO, TRACE, STOP = 0, 1, 2


def window(fn, inputs, seconds: float, device, trace: bool, agree=None):
    """The closed loop. Returns (per-call (issue, done) times, {pool index:
    the last flows of that clip}, window start, window end, the profile of
    the traced part or None, its calls, its seconds). agree: on several
    ranks, rank 0's decision (GO, TRACE, STOP) made every rank's."""
    times, kept = [], {}
    pool = inputs.shape[0]
    prof, traced_from, traced_calls = None, None, 0
    start = time.perf_counter()
    i = 0
    while True:
        issue = time.perf_counter()
        with torch.profiler.record_function("bench.issue"):
            out = fn(inputs[i % pool])
        with torch.profiler.record_function("bench.wait"):
            _sync(device)
        done = time.perf_counter()
        with torch.profiler.record_function("bench.next"):
            times.append((issue, done))
            kept[i % pool] = out
            i += 1
            elapsed = done - start
            state = STOP if elapsed >= seconds else (
                TRACE if trace and prof is None and elapsed >= seconds - TRACE_S else GO)
            if agree is not None:
                state = agree(state)
        if state == TRACE:
            prof = profile.start()
            traced_from, traced_calls = time.perf_counter(), i
        elif state == STOP:
            traced_s = 0.0
            if prof is not None:
                prof.__exit__(None, None, None)
                traced_s, traced_calls = done - traced_from, i - traced_calls
            return times, kept, start, done, prof, traced_calls, traced_s


def run_rank(cell: dict, seed: int, seconds: float, trace: bool, device, t0_wall: float,
             rank: int = 0, world: int = 1, fault: str | None = None) -> dict | None:
    """One rank's run of `cell` (registry.cell) on `device`. Returns rank
    0's result line as a dict (None on other ranks): `attempted` counts
    the window's calls, `failed` the pool's clips whose last flows held a
    non-finite value. fault: one of harness/faults.py's, planted by the
    tests for this run and taken out after it."""
    undo = faults.plant(fault)
    try:
        return _run_rank(cell, seed, seconds, trace, device, t0_wall, rank, world, fault)
    finally:
        undo()


def _run_rank(cell, seed, seconds, trace, device, t0_wall, rank, world, fault):
    from benchmark.harness import system

    config, tr, w = cell["config"], cell["traffic"], cell["workload"]
    ctrl = None
    if world > 1:
        import torch.distributed as dist
        system.init_distributed(device)
        ctrl = dist.new_group(backend="gloo")
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    shape = traffic.clip_shape(tr)
    est, acc = system.build(config, seed, device)
    est_sd, acc_sd = weight_draw.snapshot(est), weight_draw.snapshot(acc)
    pool = traffic.clip_pool(tr, seed + 1, device)
    path = system.lookup_path(est, shape)
    if rank == 0:
        print(f"bench: {w['name']}: clips {tuple(shape)}, pool {tr['pool']}, corr_lookup "
              f"{config['estimator']['corr_lookup']!r} resolves to {path!r}", file=sys.stderr)
    if world > 1:
        sp = system.spatial_handle(shape[2])
        fn, inputs = system.sharded_fn(est, acc, sp), system.shard(pool, sp)
    else:
        fn, inputs = system.serve_fn(est, acc), pool
    fn = faults.wrap(fn, fault)
    for i in range(tr["warmup_calls"]):
        fn(inputs[i % tr["pool"]])
    _sync(device)

    agree = None
    if ctrl is not None:
        import torch.distributed as dist

        def agree(state: int) -> int:
            flag = torch.tensor([state])
            dist.broadcast(flag, 0, group=ctrl)
            return int(flag.item())

        dist.barrier(group=ctrl)
    setup_s = time.time() - t0_wall
    counts0 = system.exchange_counts()
    times, kept, start, end, prof, traced_calls, traced_s = window(
        fn, inputs, seconds, device, trace, agree)
    counts1 = system.exchange_counts()
    window_s = end - start
    summary = None
    if prof is not None:
        # The exchange counters over the whole window, per call as traced.
        per_call = tuple((b - a) * traced_calls // len(times) for a, b in zip(counts0, counts1))
        summary = profile.summarize(prof, traced_calls, traced_s, per_call)
        del prof
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    picked = compare.sample(seed, tr["compared_clips"], kept)
    outs = [kept[i] for i in picked]
    bad = sum(int(not torch.isfinite(o).all()) for o in kept.values())
    del fn, est, acc, kept, inputs
    if device.type == "cuda":
        torch.cuda.empty_cache()

    if ctrl is not None:
        import torch.distributed as dist
        gathered = [None] * world
        dist.gather_object(dict(outs=[o.cpu() for o in outs], summary=summary, peak=peak,
                                found=found, bad=bad), gathered if rank == 0 else None, dst=0,
                           group=ctrl)
        if rank != 0:
            return None
        outs = [torch.cat([g["outs"][k] for g in gathered], dim=2).to(device)
                for k in range(len(picked))]
        summaries = [g["summary"] for g in gathered]
        peak = max(g["peak"] for g in gathered)
        found = sorted({m for g in gathered for m in g["found"]})
        bad = max(g["bad"] for g in gathered)
    else:
        summaries = [summary]
    if found:
        return dict(forbidden=found)

    judged = compare.judge(outs, est_sd, acc_sd, config, [pool[i] for i in picked])
    err = judged["flow_err_px"]
    bound = compare.limit(w["name"])
    correct = bool(err <= bound and bad == 0)
    print(f"bench: flow_gap {judged['flow_gap']!r} (relative, not compared)", file=sys.stderr)

    n_frames = tr["batch"] * tr["frames"]
    latencies = [d - i for i, d in times]
    result_metrics = {}
    if not trace:
        values = {"frames_per_s": len(times) * n_frames / window_s,
                  "latency_p95_ms": 1e3 * _p95(latencies), "setup_s": setup_s}
        for m in cell["end_to_end"]:
            result_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": world, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(times), "failed": bad,
           "metrics": result_metrics, "device": dev}
    if trace and device.type == "cuda" and all(s is not None for s in summaries):
        ctx = profile.Context(summaries, work.clip_work(config, shape), w["chips"])
        for m in cell["per_layer"]:
            value = m["reader"].read(ctx)
            if value is not None:
                result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = sum(s["busy_s"] for s in summaries) / len(summaries)
        dev["window_s"] = summaries[0]["window_s"]
        out["breakdown"] = profile.breakdown(summaries)
    out["checks"] = {"flow_err_px": {"value": err, "limit": bound},
                     "nonfinite_outputs": {"value": bad, "limit": 0}}
    return out


def _p95(values: list) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]
