"""The system under test: the clip-serving entry of accflow_tpu_torch, built
from a configuration file, with the benchmark's own weights. This is the
one module of the benchmark that imports the program.

One card: `serving.build_serving_fn(est, acc)` under `graphs.CudaGraphed`,
the graphed call that `serving.serve_exported` makes of a loaded
artifact. Height split over the ranks of a spatial handle:
`models.accflow_forward(acc, x, est.pairs_fn(spatial=sp), spatial=sp)`
under `graphs.CudaGraphed(forward, sp.group)`, each rank given its rows
(`mesh.shard_rows`).
"""

from __future__ import annotations

import torch

from accflow_tpu_torch import graphs, models, serving
from accflow_tpu_torch.ops import corr as corr_ops
from accflow_tpu_torch.parallel import mesh
from benchmark.harness import weights


def _configs(config: dict):
    e, dtype = config["estimator"], config["compute_dtype"]
    common = dict(iters=e["iters"], compute_dtype=dtype, corr_lookup=e["corr_lookup"],
                  corr_levels=e["corr_levels"], corr_radius=e["corr_radius"])
    if e["family"] == "raft":
        est = models.RAFT, models.RAFTConfig(**common)
    elif e["family"] == "gma":
        if e["attention"] != "content":
            raise ValueError(f"the reference and benchmark/work.py compute GMA's content-only "
                             f"attention, not {e['attention']!r}")
        est = models.GMA, models.GMAConfig(num_heads=e["attention_heads"], dim_head=e["dim_head"],
                                           attn_chunk=e["attn_chunk"], **common)
    else:
        raise ValueError(f"unknown estimator family {e['family']!r}")
    a = config["accumulator"]
    if (a["direction"], a["path"]) != ("backward", "fused"):
        raise ValueError(f"the harness serves the backward fused path, not {a}")
    acc = models.AccFlowConfig(hidden=a["hidden"], ofe_iters=e["iters"], compute_dtype=dtype)
    return est, acc


def build(config: dict, seed: int, device, overrides: dict | None = None):
    """(estimator model, accumulator) of `config` on `device`, weights drawn
    from `seed` (harness/weights.py). overrides: estimator config fields
    to replace (the tests' small sizes and dtypes)."""
    (est_cls, est_cfg), acc_cfg = _configs(config)
    if overrides:
        est_cfg = type(est_cfg)(**{**est_cfg.__dict__, **overrides})
        acc_cfg = type(acc_cfg)(**{**acc_cfg.__dict__,
                                   **{k: v for k, v in overrides.items() if k == "compute_dtype"}})
    with torch.device("meta"):
        est, acc = est_cls(est_cfg), models.AccFlow(acc_cfg)
    est, acc = est.to_empty(device=device).eval(), acc.to_empty(device=device).eval()
    check_widths(est, config["estimator"])
    weights.draw([est, acc], seed, device, config["widened"])
    return est, acc


def check_widths(est, e: dict) -> None:
    """Refuse a configuration whose widths the port's build does not have:
    its full-width RAFT and GMA fix the feature, hidden and context widths,
    which the reference and benchmark/work.py read from the file."""
    sd = dict(est.named_parameters())
    built = dict(feature_dim=sd["fnet.conv2.weight"].shape[0],
                 hidden_dim=sd["update_block.gru.convz1.weight"].shape[0],
                 context_dim=sd["cnet.conv2.weight"].shape[0]
                 - sd["update_block.gru.convz1.weight"].shape[0])
    wrong = {k: (e[k], v) for k, v in built.items() if e[k] != v}
    if wrong:
        raise ValueError(f"the port builds other widths than the configuration states "
                         f"(stated, built): {wrong}")


def lookup_path(est, clip_shape) -> str:
    """What the estimator's corr_lookup resolves to for this clip's 11
    pair queries (the fused clip's batch of pairs)."""
    cfg = est.cfg
    t, n, h, w = clip_shape
    pairs = 2 * (t - 2) + 1
    return corr_ops.resolve_auto_lookup(corr_ops.normalize_corr_lookup(cfg.corr_lookup), pairs * n,
                                        h // 8, w // 8, cfg.corr_levels, cfg.level_dtype())


def serve_fn(est, acc):
    """The graphed clip call of one card."""
    flow_est = models.FlowEstimator(type(est).__name__.lower(), est)
    return graphs.CudaGraphed(serving.build_serving_fn(flow_est, acc))


def spatial_handle(height: int):
    """This rank's handle of the whole world split over the frame height."""
    return mesh.make_mesh(1, mesh.world_size()).axis.at_height(height)


def sharded_fn(est, acc, sp):
    """The graphed clip call of one rank of a height split."""
    flow_est = models.FlowEstimator(type(est).__name__.lower(), est)

    def forward(x):
        return models.accflow_forward(acc, x, flow_est.pairs_fn(spatial=sp), spatial=sp)

    return graphs.CudaGraphed(forward, sp.group)


def shard(frames: torch.Tensor, sp) -> torch.Tensor:
    """This rank's rows of clips (..., T, N, H, W, 3)."""
    return mesh.shard_rows(frames, sp, frames.dim() - 3)


def init_distributed(device) -> bool:
    """Join the ranks launched in torchrun's environment: NCCL on the card
    LOCAL_RANK names, gloo on the CPU."""
    return mesh.maybe_init_distributed(device.type)


def exchange_counts() -> tuple:
    """(collectives, bytes sent) this rank's exchanges counted so far."""
    return mesh.counts()
