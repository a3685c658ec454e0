"""The control of `correct`: the reference in float8 e4m3, put in the
program's place, fails each clip cell's limit on flow_err_px. On the card
(the `cuda` marker) at the cell's own size on three seeds, as
benchmark/control.py runs it; on the CPU at 128² and the cell's 12 GRU
iterations, every one of three seeds (at 64² and 4 iterations the
control reads under a limit set at the cell's size on one seed in
three)."""

import pytest
import torch

from benchmark.harness import compare, registry
from benchmark.harness.control import control_readings

CELLS = ["accraft-cvo6", "accgma-cvo6", "accraft-1080p"]
SEEDS = (2**31 + 5, 2**31 + 6, 2**31 + 7)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit_at_128(workload):
    cell = registry.cell(registry.load_spec(), workload)
    cell["traffic"].update(height=128, width=128, frames=4, pool=3, compared_clips=2)
    errs = [control_readings(cell, seed, torch.device("cpu"))["flow_err_px"] for seed in SEEDS]
    assert min(errs) > compare.limit(workload), errs


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit_at_the_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    cell = registry.cell(registry.load_spec(), workload)
    for seed in SEEDS:
        err = control_readings(cell, seed, torch.device("cuda"))["flow_err_px"]
        assert err > compare.limit(workload), (seed, err)
