"""The traced run's readings: torch.profiler over the measured window,
reduced on each rank to a summary that the per-layer readers
(benchmark/metrics/) and the result's `breakdown` read.

A summary: the window's calls and seconds, the device's busy seconds (the
union of every device activity's interval: kernels, copies, sets), each
kernel name's seconds and launches, the idle gaps of the device summed by
what the host was doing meanwhile (the innermost host event that covers
the gap's middle), and the exchange counters' change over the window.

KINDS and kind_of sort kernels by name into kinds, first match on the
lower-cased name.
"""

from __future__ import annotations

import bisect

import torch
from torch.autograd import DeviceType

KINDS = (
    ("lookup", ("corr_window", "y_contract")),
    ("conv", ("fprop", "implicit", "conv", "cudnn", "wgrad", "dgrad")),
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
    ("nccl", ("nccl",)),
    ("gather", ("index", "gather", "scatter")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("copy", ("copy", "cat", "nchw", "nhwc", "transpose")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


# Idle gaps shorter than this (the device's own spacing of queued
# kernels) are summed under SHORT, not looked up among the host's events.
LABEL_GAP_US = 5.0
SHORT = "between queued kernels (< 5 us)"


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def start():
    """A started torch.profiler (host and, with a card, device
    activities); the caller exits it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(prof, calls: int, window_s: float, counters: tuple) -> dict:
    """This rank's summary of a profile of `calls` calls in `window_s`
    seconds; counters: the (collectives, bytes) the window added."""
    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # The host's record_function ranges show on the device too.
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
                device.append((e.name, tr.start, tr.end))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    kernels = {}
    for name, start, end in device:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (end - start) / 1e6
        k[1] += 1
    busy = _union([(s, e) for _, s, e in device])
    gaps = {}
    host.sort()
    starts = [h[0] for h in host]
    for (_, end), (start, _) in zip(busy, busy[1:]):
        if start - end < LABEL_GAP_US:
            gaps[SHORT] = gaps.get(SHORT, 0.0) + (start - end) / 1e6
            continue
        mid = (end + start) / 2
        i = bisect.bisect_right(starts, mid)
        cover = [h for h in host[max(0, i - 512):i] if h[1] >= mid]
        label = min(cover, key=lambda h: h[1] - h[0])[2] if cover else "host idle"
        gaps[label] = gaps.get(label, 0.0) + (start - end) / 1e6
    return dict(calls=calls, window_s=window_s, busy_s=sum(e - s for s, e in busy) / 1e6,
                kernels=kernels, gaps=gaps, collectives=counters[0], bytes_sent=counters[1])


def by_kind(summary: dict) -> dict:
    """{kind: seconds} over the summary's kernels."""
    out = {}
    for name, (secs, _) in summary["kernels"].items():
        kind = kind_of(name)
        out[kind] = out.get(kind, 0.0) + secs
    return out


def breakdown(summaries: list) -> dict:
    """The result line's breakdown: the ten device operations that took the
    most seconds and the ten host activities behind the longest idle time,
    summed over the window, the mean over ranks."""
    n = len(summaries)
    ops, gaps = {}, {}
    for s in summaries:
        for name, (secs, _) in s["kernels"].items():
            ops[name] = ops.get(name, 0.0) + secs / n
        for label, secs in s["gaps"].items():
            gaps[label] = gaps.get(label, 0.0) + secs / n
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


class Context:
    """What a per-layer reader reads: the ranks' summaries, the run's work
    per call (benchmark/work.py), the cell's chips, the card's peaks."""

    PEAK_BF16_FLOPS = 989e12  # NVIDIA H100 SXM, dense bfloat16
    HBM_BYTES_PER_S = 3.35e12

    def __init__(self, summaries: list, work: dict, chips: int):
        self.ranks = summaries
        self.work = work
        self.chips = chips
        self.calls = summaries[0]["calls"]
        self.window_s = summaries[0]["window_s"]

    def per_call(self, pick) -> float | None:
        """The mean over ranks of pick(summary) seconds, per call, in ms;
        None where no rank saw any."""
        vals = [pick(s) for s in self.ranks]
        if not any(vals) or not self.calls:
            return None
        return 1e3 * sum(vals) / len(vals) / self.calls

    def kernel_seconds(self, summary: dict, *keys: str) -> float:
        return sum(secs for name, (secs, _) in summary["kernels"].items()
                   if any(k in name.lower() for k in keys))
