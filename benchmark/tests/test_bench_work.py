"""benchmark/work.py against the operations torch counts
(torch.utils.flop_counter.FlopCounterMode) over the plain reference at a
small size, and its correlation and lookup-bytes terms."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import work
from benchmark.harness import registry, system, traffic
from benchmark.harness import weights as weight_draw
from benchmark.reference import Arith, clip_flows

SHAPE = (4, 2, 64, 96)


def _config(name: str) -> dict:
    cfg = json.loads((registry.BENCH / "configs" / f"{name}.json").read_text())
    cfg["estimator"]["iters"] = 2
    return cfg


@pytest.mark.parametrize("name", ["accraft", "accgma"])
def test_conv_and_gemm_operations_match_flop_counter(name):
    cfg = _config(name)
    cpu = torch.device("cpu")
    est, acc = system.build(cfg, 3, cpu, {"compute_dtype": "float32"})
    tr = {"generator": "moving_clips", "frames": SHAPE[0], "batch": SHAPE[1], "height": SHAPE[2],
          "width": SHAPE[3], "max_velocity": 2, "velocity_period": 6, "pool": 1}
    clip = traffic.clip_pool(tr, 4, cpu)[0]
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        clip_flows(Arith(), weight_draw.snapshot(est), weight_draw.snapshot(acc),
                   cfg["estimator"], clip)
    counts = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    w = work.clip_work(cfg, SHAPE, hoisted=False)
    assert counts["aten.convolution"] == w["conv"]
    # The reference builds each pair's pyramid with bmm; the deformable
    # conv and GMA's attention are mm / bmm too.
    assert counts.get("aten.bmm", 0) + counts.get("aten.mm", 0) == (
        w["corr_pyramid"] + w["deform"] + w["attention"])


def test_hoisted_gru_counts_the_context_once_a_pair():
    cfg = _config("accraft")
    plain, hoisted = work.clip_work(cfg, SHAPE, hoisted=False), work.clip_work(cfg, SHAPE)
    t, n, h, w = SHAPE
    pairs, iters = 2 * (t - 2) + 1, cfg["estimator"]["iters"]
    once = 2 * 3 * work.conv_flops(n, 128, 128, h // 8, w // 8, (1, 5))
    assert plain["conv"] - hoisted["conv"] == pairs * (iters - 1) * once


def test_correlation_takes_the_lesser_count():
    cfg = json.loads((registry.BENCH / "configs" / "accraft.json").read_text())
    big = work.clip_work(cfg, (7, 2, 512, 512))
    assert big["corr_window"] < big["corr_pyramid"] and big["corr"] == big["corr_window"]
    small = work.clip_work(_config("accraft"), SHAPE)
    assert small["corr_pyramid"] < small["corr_window"] and small["corr"] == small["corr_pyramid"]
    assert big["flops"] == big["conv"] + big["deform"] + big["attention"] + big["corr"]


@pytest.mark.parametrize("hw", [(64, 96), (1080, 1920)])
def test_lookup_bytes_match_the_port_bound_at_zero_flow(hw):
    from accflow_tpu_torch.probes import lookup_bound

    cfg = json.loads((registry.BENCH / "configs" / "accraft.json").read_text())
    h8, w8 = hw[0] // 8, hw[1] // 8
    ys, xs = torch.meshgrid(torch.arange(h8, dtype=torch.float32),
                            torch.arange(w8, dtype=torch.float32), indexing="ij")
    coords = torch.stack([xs, ys], -1).reshape(-1, 2)
    levels = [torch.zeros(1, hl, wl, dtype=torch.bfloat16)
              for hl, wl in work.level_sizes(h8, w8, 4)]
    levels = [lvl.expand(coords.shape[0], -1, -1) for lvl in levels]
    _, _, nbytes = lookup_bound(levels, coords, 4, out_elem=2)
    per_launch = work.clip_work(cfg, (7, 1, *hw))["lookup_launch_bytes"]
    assert per_launch == nbytes
