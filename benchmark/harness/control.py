"""The control of `correct`: the reference put in the program's place and
computed in the precision below the configuration's bfloat16, float8
e4m3 (reference/layers.py::Float8Arith), on the clips and weights a run of
the cell with that seed draws and compares. Its flow_err_px
(harness/compare.py) has to exceed the cell's limit: it is the upper
reading that the limit is set below. The benchmark's own runs never run
it.
"""

from __future__ import annotations

import torch

from benchmark.harness import compare, traffic
from benchmark.harness import weights as weight_draw
from benchmark.reference import Float8Arith


def control_readings(cell: dict, seed: int, device) -> dict:
    """compare.judge of the float8 reference's flows on the clips a run of
    `cell` with `seed` compares (every clip of the pool visited, as in a
    window of that many calls or more)."""
    from benchmark.harness import system

    config, tr = cell["config"], cell["traffic"]
    est, acc = system.build(config, seed, device)
    est_sd, acc_sd = weight_draw.snapshot(est), weight_draw.snapshot(acc)
    del est, acc
    pool = traffic.clip_pool(tr, seed + 1, device)
    picked = compare.sample(seed, tr["compared_clips"], range(tr["pool"]))
    clips = [pool[i] for i in picked]
    ctrl = compare.reference_flows(est_sd, acc_sd, config, clips, Float8Arith())
    return compare.judge(ctrl, est_sd, acc_sd, config, clips)
