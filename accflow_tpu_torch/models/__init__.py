"""Model factory, counterpart of accflow_tpu/models/__init__.py: substring
dispatch on the experiment/model name ("Acc+RAFT-cvo" selects RAFT)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from accflow_tpu_torch.models.accflow import (  # noqa: F401
    AccFlow,
    AccFlowConfig,
    accflow_forward,
    init_accflow,
)
from accflow_tpu_torch.models.raft import (  # noqa: F401
    RAFT,
    RAFTConfig,
    init_raft,
    raft_forward,
    raft_pairs_forward,
)


class FlowEstimator:
    """A RAFT model with its forward entry points."""

    def __init__(self, name: str, model: RAFT):
        self.name = name
        self.model = model

    def forward(self, image1, image2, iters: Optional[int] = None,
                final_only: bool = False) -> dict:
        return raft_forward(self.model, image1, image2, iters, final_only)

    def pairs_fn(self, iters: Optional[int] = None, final_only: bool = True):
        """Closure (frames, src_idx, dst_idx) -> (P*N, H, W, 2) flows with
        deduplicated frame encoding, for accflow_forward."""
        def fn(frames, src_idx, dst_idx):
            return raft_pairs_forward(self.model, frames, src_idx, dst_idx,
                                      iters=iters, final_only=final_only)

        return fn


def build_flow_estimator(name: str, compute_dtype: str = "bfloat16", device=None,
                         seed: int = 0, **cfg_overrides) -> FlowEstimator:
    """RAFT for any name containing "raft", with weights drawn from `seed`
    on `device` (default cuda; raises without a GPU unless device="cpu").
    Extra kwargs override RAFTConfig fields; unknown ones raise."""
    lname = name.lower()
    if "gma" in lname:
        raise NotImplementedError(
            "GMA is not ported to accflow_tpu_torch yet (see ROADMAP.md, queue 1)"
        )
    if "raft" not in lname:
        raise NotImplementedError(f"unknown flow estimator: {name}")
    unknown = set(cfg_overrides) - {f.name for f in dataclasses.fields(RAFTConfig)}
    if unknown:
        raise TypeError(f"unknown RAFTConfig override(s): {sorted(unknown)}")
    cfg = RAFTConfig(compute_dtype=compute_dtype, **cfg_overrides)
    return FlowEstimator(name, init_raft(cfg, seed=seed, device=device))
