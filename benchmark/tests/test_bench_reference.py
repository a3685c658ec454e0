"""The plain reference (benchmark/reference/) against accflow_tpu_torch's
CPU forward of the same clip, float32, with the same weights: the clip
entry the benchmark times (serving.build_serving_fn) on RAFT and GMA, the
accumulator's ZeroConv and GMA's gamma drawn so that every branch works.
The two sum in other orders: the bar is 1e-4 of the largest |flow|
(measured about 6e-7 of it)."""

import pytest
import torch

from benchmark.harness import registry, system, traffic
from benchmark.harness import weights as weight_draw
from benchmark.reference import Arith, clip_flows, exact

REL = 1e-4


@pytest.mark.parametrize("workload", ["accraft-cvo6", "accgma-cvo6"])
def test_reference_matches_the_port_at_64(workload):
    from accflow_tpu_torch import models, serving

    cell = registry.cell(registry.load_spec(), workload)
    config, tr = cell["config"], dict(cell["traffic"], height=64, width=64, frames=5, pool=1)
    config["estimator"]["iters"] = 4
    cpu = torch.device("cpu")
    est, acc = system.build(config, 11, cpu, {"compute_dtype": "float32"})
    clip = traffic.clip_pool(tr, 12, cpu)[0]
    est_name = config["estimator"]["family"]
    with torch.no_grad():
        got = serving.build_serving_fn(models.FlowEstimator(est_name, est), acc)(clip)
        with exact():
            ref = clip_flows(Arith(), weight_draw.snapshot(est), weight_draw.snapshot(acc),
                             config["estimator"], clip)
    assert got.shape == ref.shape == (3, 2, 64, 64, 2)
    scale = float(ref.abs().max())
    assert scale > 1e-3
    assert float((got - ref).abs().max()) <= REL * scale
