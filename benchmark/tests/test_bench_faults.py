"""A run with the timed path broken underneath comes out not correct, once
for each fault a clip cell can have (harness/faults.py), and a sound run
comes out correct: the rest of a run (set-up, window, comparison) driven
past the check for a card. On the CPU at a small size; the height split
(a cell of N > 1 chips) runs as the 1080p cell on two gloo ranks. The
lookup's faults on the CPU at 256² and 12 GRU iterations, where four
levels and twelve iterations have room to work, and on the card (the
`cuda` marker) at each cell's own size on three seeds, every fault in
every cell but a window read one cell off at 1080p, which read under the
limit on one seed of three (PERF.md §2)."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import faults, launch, registry, runner

SMALL = dict(height=64, width=64, frames=4, pool=3, warmup_calls=1, compared_clips=2)
SEED = 2**31 + 99


def small_cell(workload: str) -> dict:
    cell = registry.cell(registry.load_spec(), workload)
    cell["traffic"].update(SMALL)
    cell["config"]["estimator"]["iters"] = 3
    return cell


@pytest.mark.parametrize("fault", [None, "stale", "half_batch", "altered"])
def test_fault_turns_correct_false(fault):
    torch.set_num_threads(4)
    out = runner.run_rank(small_cell("accraft-cvo6"), SEED, 0.5, False, torch.device("cpu"),
                          time.time(), fault=fault)
    err = out["checks"]["flow_err_px"]
    assert out["correct"] is (fault is None), err
    assert out["attempted"] >= 1 and set(out["metrics"]) >= {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("fault", faults.LOOKUP)
def test_lookup_fault_turns_correct_false(fault):
    torch.set_num_threads(4)
    cell = registry.cell(registry.load_spec(), "accraft-cvo6")
    cell["traffic"].update(SMALL, height=256, width=256)
    out = runner.run_rank(cell, SEED, 0.5, False, torch.device("cpu"), time.time(), fault=fault)
    assert out["correct"] is False, out["checks"]


CELLS = [w["name"] for w in registry.load_spec()["workloads"] if w["chips"] == 1]
CARD_CASES = [(w, f) for w in CELLS for f in faults.LOOKUP
              if (w, f) != ("accraft-1080p", "lookup_offset")]
CARD_SEEDS = (2**31 + 201, 2**31 + 202, 2**31 + 203)


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", CARD_CASES)
def test_lookup_fault_turns_correct_false_at_the_cell_size(workload, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size and kernel #1")
    cell = registry.cell(registry.load_spec(), workload)
    for seed in CARD_SEEDS:
        out = runner.run_rank(cell, seed, 1.0, False, torch.device("cuda"), time.time(),
                              fault=fault)
        err = out["checks"]["flow_err_px"]
        print(json.dumps(dict(workload=workload, fault=fault, seed=seed, flow_err_px=err)),
              file=sys.stderr)
        assert out["correct"] is False, (seed, err)
        torch.cuda.empty_cache()


CHILD = """
import json, sys, time, torch
sys.path.insert(0, {root!r})
from benchmark.harness import registry, runner
cell = registry.cell(registry.load_spec(), "accraft-1080p")
cell["workload"]["chips"] = 2
cell["traffic"].update({small!r}, batch=1)
cell["config"]["estimator"]["iters"] = 2
torch.set_num_threads(2)
out = runner.run_rank(cell, {seed}, 0.5, False, torch.device("cpu"), time.time(),
                      rank={rank}, world=2, fault={fault!r})
if out is not None:
    print(json.dumps(out))
"""


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_height_split_without_exchange_is_not_correct(fault):
    port = launch.free_port()
    procs = []
    for rank in range(2):
        code = CHILD.format(root=str(registry.ROOT), small=SMALL, seed=SEED, rank=rank,
                            fault=fault)
        env = {**os.environ, **launch.torchrun_env(2, rank, port)}
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-3000:] + outs[1][1][-3000:]
    result = json.loads(outs[0][0].strip().splitlines()[-1])
    assert result["correct"] is (fault is None), result["checks"]
