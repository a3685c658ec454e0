"""The port's spans (accflow_tpu_torch/utils/profiling.py) on the CPU: the
span tree (parents, calls, self time), spans off recording nothing and
touching neither the profiler nor CUDA, reset and drain, a graph's
captured calls queued on each replay and none left by an aborted
capture, the full span set of an AccRAFT and an AccGMA clip forward at
64^2 in float32 (stored pyramid and the volume-free lookup), the
layers' readings, align and attribute on a synthetic profile, and
trace's span track. The card's side (CUDA events captured in a graph)
is in test_torch_cuda.py."""

import contextlib
import json
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from accflow_tpu_torch.models import (
    AccFlowConfig,
    accflow_forward,
    build_flow_estimator,
    init_accflow,
)
from accflow_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def clean_spans():
    profiling.spans(False)
    profiling.reset()
    yield
    profiling.spans(False)
    profiling.reset()
    for stack in profiling._open.values():
        stack.clear()


@pytest.fixture
def clock(monkeypatch):
    """The host's clock as a counter that the test advances (seconds)."""
    now = [0.0]
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: now[0])
    return now


def test_span_tree_parents_calls_and_self_time(clock):
    profiling.spans(True)
    for _ in range(2):
        with profiling.span("a"):
            clock[0] += 1
            with profiling.span("b"):
                clock[0] += 2
            with profiling.span("c"):
                clock[0] += 1
                with profiling.span("d", "host"):  # a tree of its own
                    clock[0] += 1
                clock[0] += 1
            clock[0] += 4
    recs = profiling.drain()
    assert [r.name for r in recs] == ["a", "b", "c", "d"] * 2  # by call, then opening order
    calls = sorted({r.call for r in recs})
    assert len(calls) == 4  # two "a" calls, two "d" calls
    by = {(r.call, r.name): r for r in recs}
    a1 = [r for r in recs if r.name == "a"][0]
    kids = [r for r in recs if r.call == a1.call]
    assert {r.name: r.parent for r in kids} == {"a": None, "b": a1.id, "c": a1.id}
    assert {r.name: (r.start_ms, r.end_ms) for r in kids} == {
        "a": (0.0, 10e3), "b": (1e3, 3e3), "c": (3e3, 6e3)}
    own = profiling.self_ms(recs)
    assert own[a1.id] == pytest.approx(10e3 - 2e3 - 3e3)
    d = [r for r in recs if r.name == "d"]
    assert all(r.parent is None and r.ms == pytest.approx(1e3) for r in d)
    assert all(r.clock == "host" and not r.graph for r in recs)
    assert len(by) == len(recs)
    assert profiling.drain() == []


def test_spans_off_record_nothing_and_touch_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with spans off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not profiling._on
    assert profiling.span("acc.clip") is profiling.span("x", "host") is profiling._OFF
    est = build_flow_estimator("raft", compute_dtype="float32", iters=2, device="cpu")
    acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32"), device="cpu")
    clip = np.random.default_rng(0).uniform(-1, 1, (3, 1, 32, 32, 3)).astype(np.float32)
    accflow_forward(acc, clip, est.pairs_fn(iters=2))
    assert profiling.drain() == []


def test_reset_and_drain(clock):
    profiling.spans(True)
    with profiling.span("a"):
        clock[0] += 1
    profiling.reset()
    assert profiling.drain() == []
    with profiling.span("b"):
        clock[0] += 1
    profiling.spans(False)
    with profiling.span("c"):  # off: not recorded
        clock[0] += 1
    recs = profiling.drain()
    assert [r.name for r in recs] == ["b"] and recs[0].ms == pytest.approx(1e3)
    assert profiling.drain() == []


class _Event:
    """A CUDA event's stand-in: recorded at the test's clock."""

    def __init__(self, t: float):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, later) -> float:
        return 1e3 * (later.t - self.t)


def test_a_graph_queues_its_captured_calls_on_each_replay(clock, monkeypatch):
    """The calls closed while a stream is captured (CUDA events and the
    capture stood in for) are kept by the graph and queued under a new
    call id on each replay; a replay reads the previous one's marks
    first; with spans off a replay queues nothing."""
    monkeypatch.setattr(profiling, "_mark", lambda timed: _Event(clock[0]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    profiling.spans(True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with profiling.span("acc.clip"):
        clock[0] += 1
        with profiling.span("acc.ofe"):
            clock[0] += 2
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert profiling.drain() == []  # a capture runs nothing: no record of its own
    calls = profiling.take_captured()
    assert len(calls) == 1 and profiling.take_captured() == []
    profiling.replaying(calls)
    profiling.replaying(calls)  # reads the first replay's marks before queueing
    recs = profiling.drain()
    assert Counter(r.name for r in recs) == {"acc.clip": 2, "acc.ofe": 2}
    assert len({r.call for r in recs}) == 2
    assert all(r.graph and r.clock == "device" for r in recs)
    clip = [r for r in recs if r.name == "acc.clip"]
    ofe = [r for r in recs if r.name == "acc.ofe"]
    assert [r.ms for r in clip] == [3e3, 3e3]
    assert [(r.start_ms, r.ms) for r in ofe] == [(1e3, 2e3)] * 2
    assert [o.parent for o in ofe] == [c.id for c in clip]
    profiling.spans(False)
    profiling.replaying(calls)
    assert profiling.drain() == []


def test_an_aborted_capture_leaves_no_calls_to_the_next_graph(clock, monkeypatch):
    """A capture that fails after its spans closed (the card's capture,
    graph and streams stood in for) hands its calls to no graph: the next
    _Graph keeps its own capture's call alone, and reset() drops what an
    aborted capture left."""
    from torch.utils import _pytree as pytree

    from accflow_tpu_torch import graphs

    capturing, fail = [False], [True]

    @contextlib.contextmanager
    def graph(*a, **k):
        capturing[0] = True
        try:
            yield
        finally:
            capturing[0] = False
        if fail[0]:
            raise RuntimeError("operation failed due to a previous error during capture")

    monkeypatch.setattr(profiling, "_mark",
                        lambda timed: _Event(clock[0]) if timed == "device" else clock[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: SimpleNamespace(replay=lambda: None))
    monkeypatch.setattr(graphs, "_capture_stream", lambda: None)
    monkeypatch.setattr(graphs, "_on_capture_stream", lambda fn, args: fn(*args))

    def clip(x):
        with profiling.span("acc.clip"):
            clock[0] += 1
            with profiling.span("acc.ofe"):
                clock[0] += 2
            return x + 1

    leaves, spec = pytree.tree_flatten((torch.zeros(2),))
    profiling.spans(True)
    with pytest.raises(RuntimeError, match="during capture"):
        graphs._Graph(clip, leaves, spec, warmup=1)
    assert profiling._captured  # the aborted capture's call, until the next capture
    fail[0] = False
    g = graphs._Graph(clip, leaves, spec, warmup=1)
    assert len(g.spans) == 1 and profiling.take_captured() == []
    profiling.reset()
    g(leaves)
    recs = profiling.drain()
    assert [r.name for r in recs] == ["acc.clip", "acc.ofe"] and all(r.graph for r in recs)
    fail[0] = True
    with pytest.raises(RuntimeError, match="during capture"):
        graphs._Graph(clip, leaves, spec, warmup=0)
    profiling.reset()
    assert profiling.take_captured() == [] and profiling.drain() == []
    assert all(not stack for stack in profiling._open.values())


def _rec(i, name, parent, call, start, end, clock="device"):
    return profiling.Span(i, name, parent, call, start, end, clock, True)


def test_layer_readings_setup_and_span_table():
    """layer_ms's sums a call (update_ms the iterations' self time, less
    the rows and the aggregation inside them), setup_s's capture less the
    builds inside it, and span_table's device ms a call by span and kind."""
    recs = []
    for c in (1, 2):
        b = 10 * c
        recs += [_rec(b, "acc.clip", None, c, 0.0, 10.0),
                 _rec(b + 1, "acc.ofe", b, c, 0.0, 8.0),
                 _rec(b + 2, "gma.attention", b + 1, c, 0.5, 1.0),
                 _rec(b + 3, "est.update", b + 1, c, 1.0, 4.0),
                 _rec(b + 4, "corr.build", b + 3, c, 1.0, 2.0),
                 _rec(b + 5, "gma.aggregate", b + 3, c, 2.0, 2.5),
                 _rec(b + 6, "est.update", b + 1, c, 4.0, 7.0),
                 _rec(b + 7, "acc.cells", b, c, 8.0, 9.9)]
    got = profiling.layer_ms(recs)
    assert got == pytest.approx({"ofe_ms": 8.0, "corr_build_ms": 1.0, "update_ms": 4.5,
                                 "attention_ms": 1.0, "cells_ms": 1.9, "clip_ms": 10.0,
                                 "events_per_call": 16.0})
    assert profiling.layer_ms([r for r in recs if r.name != "acc.clip"]) == {}
    setup = [_rec(1, "graphs.capture", None, 1, 0.0, 4000.0, "host"),
             _rec(2, "cuda_lib.build", 1, 1, 100.0, 1100.0, "host"),
             _rec(3, "graphs.capture", None, 2, 0.0, 2000.0, "host")]
    assert profiling.setup_s(setup) == pytest.approx({"capture_s": 5.0, "build_s": 1.0})
    att = {"kernels": {"est.update": {"gemm_a": [4e-3, 24], "add": [2e-3, 24]},
                       None: {"Memcpy HtoD": [1e-4, 2]}}, "idle": {}}
    kind = {"gemm_a": "gemm", "add": "elementwise", "Memcpy HtoD": "copy"}.get
    table = profiling.span_table(att, 2, kind)
    assert sorted(table) == ["None", "est.update"]
    assert table["est.update"] == pytest.approx({"gemm": 2.0, "elementwise": 1.0})
    assert table["None"] == pytest.approx({"copy": 0.05})


CASES = [("raft", "fused", {"corr.build": 1}),
         ("gma", "fused", {"corr.build": 1, "gma.attention": 1, "gma.aggregate": 12}),
         ("raft", "ondemand:16", {"corr.build": 4 * 12})]  # 8x8 queries: 4 chunks of 16


@pytest.mark.parametrize("family,lookup,extra", CASES, ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_clip_forward_span_set(family, lookup, extra):
    """Each span's count and parent in one call of the fused AccFlow clip
    forward (7 frames would be 11 pairs; 4 frames here, 5 pairs, 2 cells),
    and the clip covering its children."""
    torch.set_num_threads(4)
    est = build_flow_estimator(family, compute_dtype="float32", device="cpu", corr_lookup=lookup)
    acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32"), device="cpu")
    clip = np.random.default_rng(0).uniform(-1, 1, (4, 1, 64, 64, 3)).astype(np.float32)
    profiling.spans(True)
    accflow_forward(acc, clip, est.pairs_fn(iters=12))
    profiling.spans(False)
    recs = profiling.drain()
    assert Counter(r.name for r in recs) == {"acc.clip": 1, "acc.ofe": 1, "acc.cells": 1,
                                             "est.update": 12, **extra}
    assert len({r.call for r in recs}) == 1
    name = {r.id: r.name for r in recs}
    parents = Counter((r.name, name.get(r.parent)) for r in recs)
    assert parents["acc.ofe", "acc.clip"] == parents["acc.cells", "acc.clip"] == 1
    assert parents["est.update", "acc.ofe"] == 12
    want_corr = "est.update" if lookup.startswith("ondemand") else "acc.ofe"
    assert parents["corr.build", want_corr] == extra["corr.build"]
    if family == "gma":
        assert parents["gma.attention", "acc.ofe"] == 1
        assert parents["gma.aggregate", "est.update"] == 12
    root = recs[0]
    assert root.name == "acc.clip" and root.start_ms == 0.0
    for r in recs[1:]:
        assert 0.0 <= r.start_ms <= r.end_ms <= root.end_ms
    kids = sum(r.ms for r in recs if r.parent == root.id)
    assert kids <= root.ms
    assert min(profiling.self_ms(recs).values()) >= 0.0


def _event(name, start, end, device=False, corr=0, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU, id=corr,
                           is_user_annotation=annotation)


def _graph_call(call, base_id):
    s = profiling.Span
    return [s(base_id, "acc.clip", None, call, 0.0, 0.092, "device", True),
            s(base_id + 1, "x", base_id, call, 0.0, 0.040, "device", True),
            s(base_id + 2, "y", base_id, call, 0.045, 0.090, "device", True)]


def test_align_and_attribute_on_a_synthetic_profile():
    """Two replays: each call ends with its launch's last kernel (the
    copy-in before it is another launch's), its origin 2 us before the
    first kernel; every kernel to the innermost span over its middle, the
    idle gap inside the call to the clip."""
    events = [_event("cudaMemcpyAsync", 80, 82, corr=3), _event("Memcpy DtoD", 90, 95, True, 3),
              _event("cudaGraphLaunch", 100, 104, corr=7),
              _event("k1", 110, 150, True, 7), _event("k2", 155, 200, True, 7),
              _event("cudaGraphLaunch", 1000, 1004, corr=9),
              _event("k1", 1010, 1050, True, 9), _event("k2", 1055, 1100, True, 9),
              _event("acc.clip", 1010, 1100, True, 9, annotation=True)]
    prof = SimpleNamespace(events=lambda: events)
    recs = _graph_call(1, 0) + _graph_call(2, 3)
    aligned, residuals, dropped = profiling.align(prof, recs)
    starts = {(s.call, s.name): (a, b) for s, a, b in aligned}
    assert starts[1, "acc.clip"] == pytest.approx((108, 200))
    assert starts[2, "y"] == pytest.approx((1053, 1098))
    assert residuals == pytest.approx({1: 2.0, 2: 2.0})  # 92 us of events, 90 us of kernels
    assert dropped == {}
    att = profiling.attribute(prof, aligned)
    assert att["kernels"]["x"]["k1"] == pytest.approx([80e-6, 2])
    assert att["kernels"]["y"]["k2"] == pytest.approx([90e-6, 2])
    assert att["kernels"][None] == {"Memcpy DtoD": pytest.approx([5e-6, 1])}
    assert att["idle"] == {"acc.clip": pytest.approx(10e-6)}  # 150-155 and 1050-1055
    with pytest.raises(ValueError, match="cudaGraphLaunch"):
        profiling.align(prof, recs + _graph_call(3, 6))


def test_align_checks_each_replay_against_its_kernels():
    """A replay whose kernels span more than its events (the profile's
    device clock stepped 5 ms between its two kernels) raises, or with
    drop is left out, its kernels and gaps with it; so is one whose
    events outlast its kernels by more than a launch's latency."""
    events = [_event("cudaGraphLaunch", 100, 104, corr=7),
              _event("k1", 110, 150, True, 7), _event("k2", 155, 200, True, 7),
              _event("cudaGraphLaunch", 1000, 1004, corr=9),
              _event("k1", 1010, 1050, True, 9), _event("k2", 6055, 6100, True, 9),
              _event("cudaGraphLaunch", 7000, 7004, corr=11),
              _event("k1", 7010, 7050, True, 11), _event("k2", 7055, 7100, True, 11)]
    prof = SimpleNamespace(events=lambda: events)
    recs = _graph_call(1, 0) + _graph_call(2, 3) + _graph_call(3, 6)
    with pytest.raises(ValueError, match="call 2: its events span 92.0 us, its device "
                                         "activities 5090.0 us"):
        profiling.align(prof, recs)
    aligned, residuals, dropped = profiling.align(prof, recs, drop=True)
    assert sorted({s.call for s, _, _ in aligned}) == [1, 3]
    assert residuals == pytest.approx({1: 2.0, 3: 2.0})
    assert dropped == {2: pytest.approx((1010, 6100, 92 - 5090))}
    att = profiling.attribute(prof, aligned, [(a, b) for a, b, _ in dropped.values()])
    assert att["kernels"] == {"x": {"k1": pytest.approx([80e-6, 2])},
                              "y": {"k2": pytest.approx([90e-6, 2])}}
    assert att["idle"] == {"acc.clip": pytest.approx(10e-6)}
    events[5] = _event("k2", 1055, 1100, True, 9)  # call 2 as it ran
    late = _graph_call(1, 0) + _graph_call(2, 3) + _graph_call(3, 6)
    late[6] = late[6]._replace(end_ms=3.592)  # call 3's events outlast its kernels by 3.5 ms
    with pytest.raises(ValueError, match="call 3: its events span 3592.0 us"):
        profiling.align(prof, late)


def test_trace_writes_the_span_track(tmp_path):
    """On the CPU: trace switches spans on for its block, aligns the
    block's eager calls with their host ranges, writes them as a track of
    their own beside the ops, leaves them for drain() and switches spans
    off again."""
    est = build_flow_estimator("raft", compute_dtype="float32", iters=2, device="cpu")
    acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32"), device="cpu")
    clip = np.random.default_rng(0).uniform(-1, 1, (3, 1, 32, 32, 3)).astype(np.float32)
    with profiling.trace(str(tmp_path / "tr")):
        accflow_forward(acc, clip, est.pairs_fn(iters=2))
    assert not profiling._on
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    track = [e for e in events if e.get("cat") == "span"]
    assert Counter(e["name"] for e in track) == {"acc.clip": 1, "acc.ofe": 1, "acc.cells": 1,
                                                 "corr.build": 1, "est.update": 2}
    clip_ev = [e for e in track if e["name"] == "acc.clip"][0]
    ops = [e for e in events if e.get("name") == "acc.clip" and e.get("cat") != "span"]
    assert ops and abs(clip_ev["ts"] - float(ops[0]["ts"])) < 1.0
    assert all(clip_ev["ts"] <= e["ts"] and e["ts"] + e["dur"] <= clip_ev["ts"]
               + clip_ev["dur"] + 1.0 for e in track)
    assert len(profiling.drain()) == len(track)
