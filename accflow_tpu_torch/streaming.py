"""Stateful streaming: long-range flow over an unbounded video stream, one
frame at a time, with warm-started OFE queries. Counterpart of
accflow_tpu/streaming.py (its StableHLO export waits for the port's
torch.export work, ROADMAP.md queue 1).

    acc = StreamAccumulator(est, accflow)   # est built with iters=6, say
    out0 = acc.reset(frames3)               # cold start on [I0, I1, I2] -> F_{2,0}
    out  = acc.push(frame)                  # each new frame I_i -> F_{i,0}

A `push` encodes only the new frame (1 fnet + 1 cnet + 1 context encode),
runs one warm-started 2-pair GRU solve (I_i -> I_{i-1} and I_i -> I_0) from
feature maps carried in the state, and one accumulation cell. It reproduces
the in-clip warm-start recurrence (models/accflow.py::
_accflow_forward_warmstart) up to conv batch-splitting.

State tuple, threaded between calls and kept on the device, in the JAX
package's order (`streaming.py:55-63`):
    (fmap_n, fmap_prev, cn, c_prev, carry, dflow, flow_ini)
    fmap_n, fmap_prev  OFE fnet maps of frame 0 and frame i-1, (N, C, H/8, W/8)
    cn, c_prev         accumulator context of frame 0 and frame i-1, (N, C, H/8, W/8)
    carry              accumulated flow F_{i-1,0}, (N, H/8, W/8, 2) float32
    dflow              previous local pair flow f_{i-1,i-2}, (N, H/8, W/8, 2)
    flow_ini           previous direct flow F_{i-1,0} (the OFE's), (N, H/8, W/8, 2)
Feature maps are NCHW in the compute dtype; flows NHWC float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from accflow_tpu_torch.api import _as_frames
from accflow_tpu_torch.models.accflow import AccFlow, _cell_from_ctx
from accflow_tpu_torch.models.raft import to_nchw
from accflow_tpu_torch.nn.layers import tf32
from accflow_tpu_torch.ops.grids import downflow8
from accflow_tpu_torch.ops.padding import InputPadder
from accflow_tpu_torch.ops.warmstart import forward_splat_flow


def make_streaming_fns(est, acc: AccFlow, ini_init: str = "ini"):
    """(init_fn, step_fn) for streaming backward accumulation.

    init_fn(frames3 (3, N, H, W, 3)) -> (F_{2,0} (N, H, W, 2), state): the
        cold start on the first three frames (the OFE also seeds F_{1,0}).
    step_fn(state, frame (N, H, W, 3)) -> (F_{i,0}, state): one
        warm-started accumulation step.
    The OFE runs its RAFTConfig.iters iterations per query. ini_init picks the warm
    start of the long-range query I_i -> I_0: "ini" advects the previous
    step's direct flow (the in-clip recurrence); "carry" advects the
    previous accumulated output, the JAX package's documented negative
    result (it diverges on long streams; accflow_tpu/streaming.py:87-99)."""
    if ini_init not in ("ini", "carry"):
        raise ValueError(f"ini_init must be 'ini' or 'carry', got {ini_init!r}")
    cd = acc.cfg.dtype
    encode = est.encode_frame_fn()
    pairs_ff = est.pairs_from_features_fn()

    def encode_ctx(frames):
        with tf32(False):
            return acc.context(to_nchw(frames, cd))

    @torch.no_grad()
    def init_fn(frames3):
        i_n, i2, i1 = frames3[0], frames3[1], frames3[2]
        n = i1.shape[0]
        feats1, feats2, featsn = encode(i1), encode(i2), encode(i_n)
        # Queries frame 2 -> 1 and 2 -> 0, and the seed 1 -> 0, from features.
        flows_a = pairs_ff(feats1, [feats2["fmap"], featsn["fmap"]])
        seed = pairs_ff(feats2, [featsn["fmap"]])
        dflow, flow_ini, seed = downflow8(torch.cat([flows_a, seed])).chunk(3)
        ctx = encode_ctx(torch.cat([i1, i2, i_n]))
        c1, cn = ctx[:n], ctx[2 * n:]
        carry, out = _cell_from_ctx(acc, dflow, flow_ini, seed, c1, ctx[n: 2 * n], cn)
        return out, (featsn["fmap"], feats1["fmap"], cn, c1, carry, dflow, flow_ini)

    @torch.no_grad()
    def step_fn(state, frame):
        fmap_n, fmap_prev, cn, c_prev, carry, dflow, flow_ini = state
        src = encode(frame)
        # Advect the previous step's flows into the new frame's grid
        # (constant velocity along the negated backward pair flow) and
        # warm-start both OFE queries from them.
        advect = -dflow
        ini_seed = flow_ini if ini_init == "ini" else carry
        init = torch.cat([forward_splat_flow(dflow, advect),
                          forward_splat_flow(ini_seed, advect)])
        flows = pairs_ff(src, [fmap_prev, fmap_n], flow_init=init)
        dflow, flow_ini = downflow8(flows).chunk(2)
        c1 = encode_ctx(frame)
        carry, out = _cell_from_ctx(acc, dflow, flow_ini, carry, c1, c_prev, cn)
        return out, (fmap_n, src["fmap"], cn, c1, carry, dflow, flow_ini)

    return init_fn, step_fn


def make_pair_streaming_fns(est):
    """Consecutive-pair streaming: (init_fn, step_fn) with
    init_fn(f0, f1) -> (flow_{0->1}, state) and step_fn(state, frame) ->
    (flow_{i-1->i}, state). Each step warm-starts from the previous flow
    advected along itself (upstream RAFT's Sintel recipe); state =
    (prev_frame, flow_low)."""

    def init_fn(frame0, frame1):
        out = est.forward(frame0, frame1, final_only=True)
        return out["flow_up"], (frame1, out["flow_low"])

    def step_fn(state, frame):
        prev, flow_low = state
        out = est.forward(prev, frame, flow_init=forward_splat_flow(flow_low),
                          final_only=True)
        return out["flow_up"], (frame, out["flow_low"])

    return init_fn, step_fn


class StreamAccumulator:
    """Stateful wrapper around make_streaming_fns. Frames go to the
    accumulator's device; outputs and the state stay there between calls
    (no host round trips beyond the frame upload)."""

    def __init__(self, est, acc: AccFlow, ini_init: str = "ini"):
        self._init, self._step = make_streaming_fns(est, acc, ini_init=ini_init)
        self._device = next(acc.parameters()).device
        self._state = None

    @property
    def state(self):
        return self._state

    def _frames(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self._device)

    def reset(self, frames3) -> torch.Tensor:
        """Cold start on (3, N, H, W, 3) normalized frames -> F_{2,0}."""
        out, self._state = self._init(self._frames(frames3))
        return out

    def push(self, frame) -> torch.Tensor:
        """Advance one frame: (N, H, W, 3) -> F_{i,0} (N, H, W, 2)."""
        if self._state is None:
            raise RuntimeError("push() before reset(): seed with 3 frames first")
        out, self._state = self._step(self._state, self._frames(frame))
        return out


class FlowStream:
    """User-facing stream over a StreamAccumulator: feed raw
    frames one at a time, get long-range flows F_{i,0} back as numpy.
    Handles [0, 255] -> [-1, 1] normalization, /8 padding and unpadding;
    buffers the first three frames (the cold start), so the first two
    send() calls return None.

        stream = FlowStream(StreamAccumulator(est, acc))
        for frame in video:
            flow = stream.send(frame)   # (H, W, 2) or None while seeding
    """

    def __init__(self, backend, normalized: bool = False):
        self._backend = backend
        self._normalized = normalized
        self._buffer: list = []
        self._padder = None
        self._batched: Optional[bool] = None
        self.index = 0  # frames consumed

    def _prep(self, frame):
        a, batched = _as_frames(frame, self._normalized)
        if self._batched is None:
            self._batched = batched
        elif batched != self._batched:
            raise ValueError("all frames must agree in batchedness")
        if self._padder is None:
            self._padder = InputPadder(a.shape)
        return self._padder.pad_np(a)

    def send(self, frame) -> Optional[np.ndarray]:
        """Feed one HWC (or NHWC) frame; returns F_{i,0} unpadded float32
        numpy once i >= 2, else None (seeding)."""
        a = self._prep(frame)
        self.index += 1
        if self.index < 3:
            self._buffer.append(a)
            return None
        if self.index == 3:
            self._buffer.append(a)
            out = self._backend.reset(np.stack(self._buffer, axis=0))
            self._buffer = []
        else:
            out = self._backend.push(a)
        out = self._padder.unpad(out).float().cpu().numpy()
        return out if self._batched else out[0]
