"""What decides `correct`: the flows that the timed calls returned, held to
the plain reference (benchmark/reference/, float32 with TF32 off) on the
same weights and clips.

The number compared is `flow_err_px`: over every compared flow map (one
F_{i,0} of one batch element of one sampled clip) the largest root mean
square of the map's difference from the reference's, in pixels. The
reference runs once the window has closed and the program's state is
freed, one clip and one pair at a time (reference/raft.py). `flow_gap`,
the same difference relative to the reference map's norm, is printed
beside it and not compared: it swings with the random weights' output
scale from seed to seed and did not separate the program from the
control (the reference in float8 e4m3, the precision below the
configuration's bfloat16); the error in pixels does (PERF.md §2).

Each cell's limit is a file of its own, benchmark/limits/<workload>.json
(`limit`), with the readings it was set from: the largest flow_err_px of
sound runs of the program over a dozen seeds or more (`lower`) and the
smallest of the control on the same seeds at the cell's size (`upper`).
A cell without one cannot be judged, and its run fails.
"""

from __future__ import annotations

import json
import random

import torch

from benchmark.harness.registry import ROOT
from benchmark.reference import Arith, clip_flows, exact


def limit(workload: str, root=ROOT) -> float:
    """The cell's limit on flow_err_px."""
    path = root / "benchmark" / "limits" / f"{workload}.json"
    return float(json.loads(path.read_text())["limit"])


def sample(seed: int, k: int, visited) -> list:
    """The pool entries to compare, drawn from the seed among those the
    window ran (sorted)."""
    ran = sorted(visited)
    return sorted(random.Random(seed).sample(ran, min(k, len(ran))))


def gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """flow_gap of flows `out` against reference flows `ref`, both (maps,
    H, W, 2)."""
    o, r = out.float().flatten(1), ref.float().flatten(1)
    norms = r.norm(dim=1)
    return float(((o - r).norm(dim=1) / torch.maximum(norms, norms.median())).max())


def flow_gap(outs: list, refs: list) -> float:
    """flow_gap over all maps of the compared clips ((T-2, N, H, W, 2) each)."""
    return gap(torch.cat([o.flatten(0, 1) for o in outs]),
               torch.cat([r.flatten(0, 1) for r in refs]))


@torch.no_grad()
def reference_flows(est_sd: dict, acc_sd: dict, config: dict, clips, arith=None) -> list:
    """The reference's flows of each clip (T, N, H, W, 3) in `clips`, one
    at a time, each (T-2, N, H, W, 2) on the clip's device."""
    arith = arith or Arith()
    with exact():
        return [clip_flows(arith, est_sd, acc_sd, config["estimator"], c) for c in clips]


def flow_err_px(outs: list, refs: list) -> float:
    """The largest per-map root mean square difference, in pixels, over
    all maps of the compared clips ((T-2, N, H, W, 2) each)."""
    o = torch.cat([x.flatten(0, 1) for x in outs]).float().flatten(1)
    r = torch.cat([x.flatten(0, 1) for x in refs]).float().flatten(1)
    return float((o - r).pow(2).mean(dim=1).sqrt().max())


def judge(outs: list, est_sd: dict, acc_sd: dict, config: dict, clips) -> dict:
    """flow_err_px and flow_gap of flows `outs` of `clips`."""
    refs = reference_flows(est_sd, acc_sd, config, clips)
    return dict(flow_err_px=flow_err_px(outs, refs), flow_gap=flow_gap(outs, refs))
