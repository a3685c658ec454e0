"""Profiling and step timing, the port's counterpart of
accflow_tpu/utils/profiling.py: a torch.profiler trace (a Chrome trace,
viewable in Perfetto or chrome://tracing) and a device-step timer.

device_step_time times K against 2K chained calls, each call's inputs
nudged by its predecessor's output (a data dependency, so no call can start
early or be skipped), and reads one scalar back at the end of each run,
which synchronises with the device: launch and read-back overheads cancel in
the difference.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block, CPU and (on a machine with a GPU) CUDA
    activities, written to <log_dir>/trace.json as a Chrome trace when the
    block ends: `with trace("/tmp/trace") as prof: step()`. Yields the
    profiler (prof.key_averages() for the sums by kernel)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed_pair_median(f1: Callable, f2: Callable, args: tuple, k: int,
                      repeats: int = 3) -> float:
    """Median per-iteration seconds over `repeats` K-vs-2K timing pairs:
    f1 runs K iterations and f2 2K, each returning a scalar whose float()
    waits for the work. Both must already be warm (one call each). A pair
    whose difference is not positive (a host delay landing on one leg) is
    discarded and retried, up to 3 x repeats attempts, never floored; if
    every attempt is degenerate, RuntimeError: a failed measurement, not a
    number."""
    dts = []
    for _ in range(3 * repeats):
        if len(dts) >= repeats:
            break
        t0 = time.perf_counter()
        float(f1(*args))
        t1 = time.perf_counter()
        float(f2(*args))
        t2 = time.perf_counter()
        dt = ((t2 - t1) - (t1 - t0)) / k
        if dt > 0:
            dts.append(dt)
        else:
            print("timing: discarding degenerate K-vs-2K pair (t2K-tK = %.1f ms)"
                  % (1e3 * k * dt), file=sys.stderr, flush=True)
    if not dts:
        raise RuntimeError("every K-vs-2K timing pair came out non-positive: the "
                           "measurement failed")
    return float(sorted(dts)[len(dts) // 2])


def _nudge(out, args, s):
    """The default chain: every floating tensor argument plus s x 1e-30 (an
    invisible epsilon of the last output), so each call reads its
    predecessor's result."""
    eps = s * 1e-30
    return tuple(a + eps.to(a.dtype) if torch.is_tensor(a) and a.is_floating_point() else a
                 for a in args)


def device_step_time(step_fn: Callable, args, iters: int = 8,
                     chain: Callable | None = None) -> float:
    """Seconds per step_fn(*args) call: K = iters chained calls against 2K
    (timed_pair_median, one pair). The first leaf of each call's output is
    summed into a float32 checksum, and `chain(out, args, s)` maps the output
    and that sum to the next call's args (default: _nudge). Both runs are
    warmed once before the timed pair."""
    chain = chain or _nudge

    def make_loop(k: int):
        def loop(a):
            checksum = None
            for _ in range(k):
                out = step_fn(*a)
                first = torch.utils._pytree.tree_leaves(out)[0]
                s = first.float().sum()
                a = chain(out, a, s)
                checksum = s if checksum is None else checksum + s
            return checksum

        return loop

    f1, f2 = make_loop(iters), make_loop(2 * iters)
    args = tuple(args)
    float(f1(args))
    float(f2(args))
    return timed_pair_median(f1, f2, (args,), iters, repeats=1)
