"""Profiling, the port's counterpart of accflow_tpu/utils/profiling.py: a
torch.profiler trace (a Chrome trace, viewable in Perfetto or
chrome://tracing) and named spans inside the program.

Spans. `span(name)` marks a layer's work where it happens (the clip, the
estimator's pair queries, each GRU iteration, the correlation rows, GMA's
attention, the accumulation cells; graphs' captures and cuda_lib's
builds on the host):

    profiling.spans(True)
    flows = serve(clip)                # eager, or replayed from a CUDA graph
    records = profiling.drain()        # [Span(id, name, parent, call, start_ms, end_ms, ...)]

Off (the default), span() tests one module flag and returns a shared
no-op context: no record_function, no event, no allocation, no device
work, so a graph captured with spans off holds exactly the kernels it
holds without them.

On, a span opens torch.profiler.record_function(name), so the host side
shows in any profile, and marks its start and end: on the card with two
CUDA events on the current stream (enable_timing, external: a graph
capture keeps them as event-record nodes, and every replay times them
again), on the CPU with the host's clock. A span opened while no span of
its clock is open starts a call: it and every span inside it share a
call id, and their start and end are ms after the call's origin, its
first span's start. `parent` is the id of the enclosing span of the same
clock. Spans of clock "host" (set-up work: a graph's capture, a kernel
library's build) form trees of their own on the host's clock; clock
"none" opens the record_function only.

A call that closes while its stream is being captured into a CUDA graph
is kept by the graph (`take_captured`, graphs._Graph), which queues it
again under a new call id on each replay (`replaying`). A replay reuses
its events, so before it the previous replay's are read, with a sync on
its last event, if drain() has not read them yet: with spans off a replay
queues nothing and syncs on nothing. Records stay in memory until
drain() returns them; reset() drops them. The state is the process's,
for the one thread that runs the model.

`align(prof, records)` puts the calls on the clock of a torch.profiler
profile: call k ends with the last device activity of the k-th graph
replay (the activities of its cudaGraphLaunch), or with the k-th range
of the call's first span where the call ran eagerly (a call timed on
the host starts with it), and checks that each replay's events enclose
its launch's kernels. `attribute` then gives each device activity, and
each idle gap of the device inside a call, to the innermost span that
covers its middle. `trace` switches spans on for
its block and writes the aligned spans into its Chrome trace as a track
beside the kernels.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import sys
import time
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_OFF = contextlib.nullcontext()
_on = False  # spans(True) sets it; span() tests it and nothing else while it is off
_device = False  # spans of clock "device" timed by CUDA events (else the host's clock)


class Span(NamedTuple):
    """One span of one call. start_ms and end_ms are ms after the call's
    origin; clock says what timed them: "device" (CUDA events on the
    card) or "host" (the host's clock). graph: replayed from a CUDA graph."""

    id: int
    name: str
    parent: int | None
    call: int
    start_ms: float
    end_ms: float
    clock: str
    graph: bool

    @property
    def ms(self) -> float:
        return self.end_ms - self.start_ms


class _Call:
    """The spans of one call in the order they opened: names, parents
    (indices into names), start and end marks (CUDA events, or the host's
    clock in seconds). `call` is its id, `unread` whether drain() has yet
    to read its marks (a graph's call: those of its last replay)."""

    __slots__ = ("timed", "names", "parents", "starts", "ends", "call", "unread", "graph")

    def __init__(self, timed: str, call: int):
        self.timed, self.call = timed, call
        self.names, self.parents, self.starts, self.ends = [], [], [], []
        self.unread, self.graph = False, False

    def read(self) -> list:
        global _ids
        self.unread = False
        if self.timed == "device":
            origin = self.starts[0]
            self.ends[0].synchronize()  # the root closes last
            marks = [(origin.elapsed_time(s), origin.elapsed_time(e))
                     for s, e in zip(self.starts, self.ends)]
        else:
            t0 = self.starts[0]
            marks = [(1e3 * (s - t0), 1e3 * (e - t0)) for s, e in zip(self.starts, self.ends)]
        base, _ids = _ids, _ids + len(self.names)
        return [Span(base + i, name, None if p is None else base + p, self.call, s, e,
                     self.timed, self.graph)
                for i, (name, p, (s, e)) in enumerate(zip(self.names, self.parents, marks))]


_open = {"device": [], "host": []}  # the open spans of each clock, innermost last
_pending: list = []  # (_Call, its call id when queued): marks not read yet
_records: list = []  # read, until drain()
_captured: list = []  # calls closed during a graph capture, until take_captured()
_calls = 0  # the last call id given
_ids = 0  # the last record id given


def _new_call() -> int:
    global _calls
    _calls += 1
    return _calls


def _mark(timed: str):
    if timed == "device":
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        return ev
    return time.perf_counter()


class _Span:
    __slots__ = ("name", "clock", "rf", "call", "index", "timed")

    def __init__(self, name: str, clock: str):
        self.name, self.clock = name, clock

    def __enter__(self):
        self.rf = record_function(self.name)
        self.rf.__enter__()
        if self.clock == "none":
            return self
        self.timed = "device" if self.clock == "device" and _device else "host"
        stack = _open[self.clock]
        if stack:
            parent = stack[-1]
            self.call = parent.call
        else:
            parent, self.call = None, _Call(self.timed, _new_call())
        call = self.call
        self.index = len(call.names)
        call.names.append(self.name)
        call.parents.append(None if parent is None else parent.index)
        call.starts.append(_mark(self.timed))
        call.ends.append(None)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        try:
            if self.clock != "none":
                stack = _open[self.clock]
                stack.remove(self)
                self.call.ends[self.index] = _mark(self.timed)
                if not stack:
                    _close(self.call)
        finally:
            self.rf.__exit__(*exc)
        return False


def _close(call: _Call) -> None:
    if call.timed == "device" and torch.cuda.is_current_stream_capturing():
        _captured.append(call)
    elif call.timed == "device":
        call.unread = True
        _pending.append((call, call.call))
    else:
        _records.extend(call.read())


def span(name: str, clock: str = "device"):
    """A context manager that marks the block as span `name` while spans
    are on (module docstring), and does nothing while they are off.
    clock: "device" (CUDA events where spans(True) found a card, else the
    host's clock), "host" (the host's clock), "none" (record_function
    only: a name in a profile, no record)."""
    if not _on:
        return _OFF
    return _Span(name, clock)


def spans(on: bool) -> None:
    """Switch spans on or off. Spans of clock "device" are timed with CUDA
    events where torch sees a card, else on the host's clock."""
    global _on, _device
    _on = bool(on)
    if on:
        _device = torch.cuda.is_available()


def _read_pending() -> None:
    for call, cid in _pending:
        if call.unread and call.call == cid:
            _records.extend(call.read())
    _pending.clear()


def drain() -> list:
    """Every span recorded since the last drain() or reset(), read (a
    sync on each unread call's last event), by call and opening order."""
    global _records
    _read_pending()
    out, _records = sorted(_records, key=lambda s: (s.call, s.id)), []
    return out


def reset() -> None:
    """Drop every recorded span that drain() has not returned, and the
    calls a capture left that no graph took."""
    for call, _ in _pending:
        call.unread = False
    _pending.clear()
    _records.clear()
    _captured.clear()


def take_captured() -> list:
    """The calls that closed during a graph capture since the last
    take_captured() (their events are the graph's event-record nodes),
    for graphs._Graph: taken just before its capture, to drop what an
    aborted capture left, and just after it."""
    global _captured
    out, _captured = _captured, []
    return out


def replaying(calls: list) -> None:
    """Before a graph's replay: read the previous replay's spans of
    `calls` if they are unread, then queue this replay's under new call
    ids. Nothing while spans are off."""
    if not _on:
        return
    for call in calls:
        if call.unread:
            _records.extend(call.read())
        call.call, call.unread, call.graph = _new_call(), True, True
        _pending.append((call, call.call))


def self_ms(records: list) -> dict:
    """{record id: its duration less the part its children cover} in ms
    (children of one span run one after another)."""
    own = {s.id: s.ms for s in records}
    for s in records:
        if s.parent in own:
            own[s.parent] -= s.ms
    return own


def layer_ms(records: list) -> dict:
    """The layers' spans summed over the acc.clip calls of `records`, ms a
    call: ofe_ms (acc.ofe), corr_build_ms (corr.build), update_ms
    (est.update less its children: corr.build, gma.aggregate),
    attention_ms (gma.attention and gma.aggregate), cells_ms (acc.cells),
    clip_ms (acc.clip); and events_per_call (two CUDA events a span).
    Empty where `records` hold no acc.clip."""
    calls = len({s.call for s in records if s.name == "acc.clip"})
    if not calls:
        return {}
    own = self_ms(records)
    total: dict = {}
    for s in records:
        total[s.name] = total.get(s.name, 0.0) + s.ms
    return {"ofe_ms": total.get("acc.ofe", 0.0) / calls,
            "corr_build_ms": total.get("corr.build", 0.0) / calls,
            "update_ms": sum(own[s.id] for s in records if s.name == "est.update") / calls,
            "attention_ms": (total.get("gma.attention", 0.0)
                             + total.get("gma.aggregate", 0.0)) / calls,
            "cells_ms": total.get("acc.cells", 0.0) / calls,
            "clip_ms": total.get("acc.clip", 0.0) / calls,
            "events_per_call": 2 * len(records) / calls}


def setup_s(records: list) -> dict:
    """Set-up's host spans in `records`, s: capture_s (graphs.capture less
    the cuda_lib.build inside it) and build_s (cuda_lib.build)."""
    own = self_ms(records)
    return {"capture_s": sum(own[s.id] for s in records if s.name == "graphs.capture") / 1e3,
            "build_s": sum(s.ms for s in records if s.name == "cuda_lib.build") / 1e3}


def span_table(attributed: dict, calls: int, kind_of) -> dict:
    """{innermost span: {kind: device ms a call}} from attribute()'s
    kernels over `calls` calls; kind_of(kernel name) gives the kind; the
    span None (outside every span) as "None"."""
    out: dict = {}
    for owner, kernels in attributed["kernels"].items():
        row = out.setdefault(str(owner), {})
        for name, (secs, _) in kernels.items():
            kind = kind_of(name)
            row[kind] = row.get(kind, 0.0) + 1e3 * secs / calls
    return out


# -- the profile's clock ---------------------------------------------------


def _device_activities(events) -> list:
    """(start_us, end_us, correlation id, name) of each device activity of
    a profile: kernels, copies, sets; not the device's view of host ranges."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.id, e.name) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


# A replayed call's CUDA events enclose its kernels: the first completes
# before the graph's first kernel starts (the launch's latency, 0.05-1.4 ms
# on an H100 for a graph of ~3,600 kernels), the last right after the last
# kernel. So its events' extent less its activities' extent (the residual)
# lies in [-ALIGN_SLACK_US, ALIGN_LATENCY_US]. A call outside that range was
# paired with another launch, or the profile's device timestamps stepped
# inside it: torch.profiler maps them onto the host's clock by a rate that
# drifts (~0.1 %) and is set again now and then, a step of milliseconds.
ALIGN_SLACK_US = 50.0
ALIGN_LATENCY_US = 3000.0


def align(prof, records: list, drop: bool = False) -> tuple:
    """Put the calls of `records` on the clock of torch.profiler profile
    `prof`: the k-th call replayed from a graph ends with the last device
    activity of the k-th cudaGraphLaunch (the activities that share its
    correlation id), the k-th call that ran eagerly with the k-th range
    of its first span's name on the device; a call timed on the host, or
    one whose name has no range on the device, starts with the k-th such
    range on the host. On the card a call is placed by its end, where
    events and kernels meet; a replayed call is checked (ALIGN_SLACK_US):
    one whose residual falls outside the range raises ValueError, or with
    `drop` is left out. Returns ([(Span, start_us, end_us)], {call: residual_us},
    {left-out call: (first_us, last_us, residual_us)}). ValueError also
    where the profile holds another number of graph launches than the
    records have replayed calls, or fewer ranges of a name than calls."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    by_corr: dict = {}
    for start, end, corr, _ in _device_activities(events):
        by_corr.setdefault(corr, []).append((start, end))
    launches = sorted((e.time_range.start, e.id) for e in events
                      if e.device_type == DeviceType.CPU and e.name == "cudaGraphLaunch")
    calls: dict = {}
    for s in records:
        calls.setdefault(s.call, []).append(s)
    replays = sum(1 for group in calls.values() if min(group, key=lambda s: s.id).graph)
    if replays != len(launches):
        raise ValueError(f"{replays} replayed calls, {len(launches)} cudaGraphLaunch "
                         f"in the profile")
    ranges: dict = {}  # name -> (on the card?, (start, end) of each range of it)
    taken: dict = {}  # how many replays, or ranges of a name, the calls so far took
    out, residuals, dropped = [], {}, {}
    for cid in sorted(calls):
        group = sorted(calls[cid], key=lambda s: s.id)
        root = group[0]
        key = "graph" if root.graph else root.name
        k = taken.get(key, 0)
        taken[key] = k + 1
        if root.graph:
            acts = by_corr.get(launches[k][1])
            if not acts:
                raise ValueError(f"call {cid}: no device activity of graph launch {k}")
            first, last = min(a for a, _ in acts), max(b for _, b in acts)
            on_card = True
        else:
            if key not in ranges:
                named = [e for e in events if e.name == root.name]
                on_card = [e for e in named if e.device_type == DeviceType.CUDA]
                ranges[key] = (bool(on_card), sorted((e.time_range.start, e.time_range.end)
                                                     for e in on_card or named))
            on_card, found = ranges[key]
            if k >= len(found):
                raise ValueError(f"call {cid}: {k + 1} calls of {root.name!r}, "
                                 f"{len(found)} ranges of it in the profile")
            first, last = found[k]
        origin = first if root.clock == "host" or not on_card else last - 1e3 * root.end_ms
        residual = first - origin
        if root.graph and not -ALIGN_SLACK_US <= residual <= ALIGN_LATENCY_US:
            if not drop:
                raise ValueError(f"call {cid}: its events span {1e3 * root.end_ms:.1f} us, its "
                                 f"device activities {last - first:.1f} us")
            dropped[cid] = (first, last, residual)
            continue
        residuals[cid] = residual
        out += [(s, origin + 1e3 * s.start_ms, origin + 1e3 * s.end_ms) for s in group]
    return out, residuals, dropped


def _innermost(aligned: list, points: list) -> list:
    """For each time in `points` (sorted), the name of the innermost
    aligned span that covers it, or None."""
    # A sweep: spans pushed as the points pass their start (an outer span
    # before the inner one that starts with it), popped from the top once
    # ended. Spans nest, so the top that has not ended covers the point.
    order = sorted(((a, b, s.name) for (s, a, b) in aligned), key=lambda t: (t[0], -t[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(order) and order[i][0] <= t:
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def attribute(prof, aligned: list, skip: tuple = ()) -> dict:
    """Each device activity of `prof` to the innermost aligned span that
    covers its middle, and each idle gap of the device (between the union
    of its activities' intervals) whose middle lies inside a span to the
    innermost such span; activities and gaps whose middle lies inside one
    of the (start_us, end_us) intervals of `skip` (align's left-out calls)
    are left out. Returns {"kernels": {span name or None: {kernel name:
    [seconds, launches]}}, "idle": {span name: seconds}}."""
    skip = sorted(skip)

    def kept(t: float) -> bool:
        i = bisect.bisect_right(skip, (t, float("inf"))) - 1
        return i < 0 or t > skip[i][1]

    acts = [a for a in _device_activities(prof.events()) if kept((a[0] + a[1]) / 2)]
    kernels: dict = {}
    mids = sorted(((a + b) / 2, b - a, name) for a, b, _, name in acts)
    for (_, dur, name), owner in zip(mids, _innermost(aligned, [m[0] for m in mids])):
        row = kernels.setdefault(owner, {}).setdefault(name, [0.0, 0])
        row[0] += dur / 1e6
        row[1] += 1
    busy = []
    for a, b, _, _ in acts:
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    gaps = [(e, s) for (_, e), (s, _) in zip(busy, busy[1:]) if kept((e + s) / 2)]
    idle: dict = {}
    for (e, s), owner in zip(gaps, _innermost(aligned, [(e + s) / 2 for e, s in gaps])):
        if owner is not None:
            idle[owner] = idle.get(owner, 0.0) + (s - e) / 1e6
    return {"kernels": kernels, "idle": idle}


# -- the trace -------------------------------------------------------------

_SPAN_PID = 0x5350  # the Chrome trace's process id of the spans' track


def _shift_us(doc, prof) -> float:
    """What to add to the profile's times (us after the trace's start) for
    the Chrome trace's (us after its baseTimeNanoseconds); without those,
    matched on the profile's first event."""
    try:
        return (prof.profiler.kineto_results.trace_start_ns() - doc["baseTimeNanoseconds"]) / 1e3
    except (AttributeError, KeyError, TypeError):
        first = min(prof.events(), key=lambda e: e.time_range.start)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        return min(float(e["ts"]) for e in events
                   if e.get("name") == first.name and "ts" in e) - first.time_range.start


def _write_track(path: str, prof, aligned: list) -> None:
    """Add the aligned spans to the Chrome trace at `path`, as a process
    of their own."""
    with open(path) as f:
        doc = json.load(f)
    shift = _shift_us(doc, prof)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    events.append({"ph": "M", "name": "process_name", "pid": _SPAN_PID,
                   "args": {"name": "spans (accflow_tpu_torch)"}})
    for s, a, b in aligned:
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": _SPAN_PID, "tid": 0,
                       "ts": a + shift, "dur": b - a,
                       "args": {"call": s.call, "id": s.id, "parent": s.parent}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block, CPU and (on a machine with a GPU) CUDA
    activities, with spans on, written to <log_dir>/trace.json as a Chrome
    trace when the block ends, the spans of the block's calls aligned
    (align) as a track of their own: `with trace("/tmp/trace") as prof:
    step()`. Yields the profiler (prof.key_averages() for the sums by
    kernel). The spans stay recorded for drain()."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on, first = _on, _calls + 1
    spans(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        if not was_on:
            spans(False)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _read_pending()
    mine = [s for s in _records if s.call >= first]
    try:
        aligned, _, _ = align(prof, mine)
    except ValueError as e:  # a call the profile does not hold, or a replay its kernels outlast
        print(f"profiling.trace: spans not aligned ({e})", file=sys.stderr)
        return
    _write_track(path, prof, aligned)
