"""The harness leaves the program's spans (accflow_tpu_torch/utils/
profiling.py) off: a run with --trace 0 records none, so the measured
window replays graphs captured without them."""

import time

import torch

from accflow_tpu_torch.utils import profiling
from benchmark.harness import registry, runner

SMALL = dict(height=64, width=64, frames=4, pool=3, warmup_calls=1, compared_clips=2)
SEED = 2**31 + 77


def small_cell(workload: str) -> dict:
    cell = registry.cell(registry.load_spec(), workload)
    cell["traffic"].update(SMALL)
    cell["config"]["estimator"]["iters"] = 3
    return cell


def test_trace_0_leaves_the_spans_off(monkeypatch):
    torch.set_num_threads(4)
    opened = []
    monkeypatch.setattr(profiling, "_Span", lambda *a: opened.append(a))
    out = runner.run_rank(small_cell("accraft-cvo6"), SEED, 0.5, False, torch.device("cpu"),
                          time.time())
    assert out["correct"] and not profiling._on
    assert opened == [] and profiling.drain() == []

