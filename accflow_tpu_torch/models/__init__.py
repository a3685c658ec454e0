"""Model factory, counterpart of accflow_tpu/models/__init__.py: substring
dispatch on the experiment/model name ("Acc+RAFT-cvo" selects RAFT,
"acc+gma" GMA)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from accflow_tpu_torch.models.accflow import (  # noqa: F401
    AccFlow,
    AccFlowConfig,
    accflow_forward,
    init_accflow,
)
from accflow_tpu_torch.models.gma import (  # noqa: F401
    GMA,
    GMAConfig,
    gma_encode_frame,
    gma_flow_pairs_from_features,
    gma_forward,
    gma_pairs_forward,
    init_gma,
)
from accflow_tpu_torch.models.raft import (  # noqa: F401
    RAFT,
    RAFTConfig,
    init_raft,
    raft_encode_frame,
    raft_flow_pairs_from_features,
    raft_forward,
    raft_pairs_forward,
)

# Each family's entry points: forward, pairs_forward, encode_frame,
# flow_pairs_from_features (one contract for both).
_ENTRY_POINTS = {
    RAFT: (raft_forward, raft_pairs_forward, raft_encode_frame, raft_flow_pairs_from_features),
    GMA: (gma_forward, gma_pairs_forward, gma_encode_frame, gma_flow_pairs_from_features),
}


class FlowEstimator:
    """A RAFT (full width or small) or GMA model with its forward entry
    points, picked by the model's type. iters: the GRU iterations of a call
    that names none (default: the model config's)."""

    def __init__(self, name: str, model, iters: Optional[int] = None):
        self.name = name
        self.model = model
        self.iters = iters
        (self._forward, self._pairs_forward, self._encode_frame,
         self._pairs_from_features) = _ENTRY_POINTS[type(model)]

    @property
    def cfg(self):
        return self.model.cfg

    def forward(self, image1, image2, iters: Optional[int] = None, flow_init=None,
                final_only: bool = False) -> dict:
        return self._forward(self.model, image1, image2, self._iters(iters), flow_init,
                             final_only)

    def _iters(self, iters: Optional[int]) -> Optional[int]:
        return self.iters if iters is None else iters

    def pairs_fn(self, iters: Optional[int] = None, final_only: bool = True):
        """Closure (frames, src_idx, dst_idx) -> (P*N, H, W, 2) flows with
        deduplicated frame encoding, for accflow_forward."""
        def fn(frames, src_idx, dst_idx):
            return self._pairs_forward(self.model, frames, src_idx, dst_idx,
                                       iters=self._iters(iters), final_only=final_only)

        return fn

    def encode_frame_fn(self):
        """Closure (image_batch) -> cacheable per-frame features
        ({fmap, net, inp}) for the streaming state (streaming.py)."""
        def fn(image):
            return self._encode_frame(self.model, image)

        return fn

    def pairs_from_features_fn(self, iters: Optional[int] = None,
                               final_only: bool = True):
        """Closure (src_feats, dst_fmaps, flow_init=None) -> (P*N, H, W, 2)
        flows from precomputed features: the streaming step's OFE call."""
        def fn(src, dst_fmaps, flow_init=None):
            return self._pairs_from_features(self.model, src, dst_fmaps, self._iters(iters),
                                             flow_init, final_only)

        return fn

    def flow_fn(self):
        """Closure (image1, image2, flow_init=None) -> final full-res flow,
        for AccFlow's warm-started stepwise OFE (AccFlowConfig.warm_start)."""
        def fn(image1, image2, flow_init=None):
            return self.forward(image1, image2, flow_init=flow_init,
                                final_only=True)["flow_up"]

        return fn


def _cfg_for(cls, other_cls, compute_dtype: str, overrides: dict):
    """`cls` from `overrides`, dropping the keys that are fields of the
    other family's config only (so one knob set, attn_chunk among them,
    threads through both) and raising TypeError on keys neither knows
    (accflow_tpu/models/__init__.py::_cfg_for)."""
    mine = {f.name for f in dataclasses.fields(cls)}
    theirs = {f.name for f in dataclasses.fields(other_cls)}
    unknown = set(overrides) - mine - theirs
    if unknown:
        raise TypeError(f"unknown {cls.__name__} override(s): {sorted(unknown)}")
    return cls(compute_dtype=compute_dtype, **{k: v for k, v in overrides.items() if k in mine})


def build_flow_estimator(name: str, compute_dtype: str = "bfloat16", device=None,
                         seed: int = 0, **cfg_overrides) -> FlowEstimator:
    """RAFT for any name containing "raft", else GMA for one containing
    "gma", with weights drawn from `seed` on `device` (default cuda; raises
    without a GPU unless device="cpu"). Extra kwargs override RAFTConfig /
    GMAConfig fields (small=True for RAFT-small, iters, corr_lookup,
    attn_chunk, ...); a field of the other family's config only is dropped,
    an unknown one raises TypeError."""
    lname = name.lower()
    if "raft" in lname:
        cfg = _cfg_for(RAFTConfig, GMAConfig, compute_dtype, cfg_overrides)
        return FlowEstimator(name, init_raft(cfg, seed=seed, device=device))
    if "gma" in lname:
        cfg = _cfg_for(GMAConfig, RAFTConfig, compute_dtype, cfg_overrides)
        return FlowEstimator(name, init_gma(cfg, seed=seed, device=device))
    raise NotImplementedError(f"unknown flow estimator: {name}")
