"""AccFlow: occlusion-aware accumulation of long-range flow, counterpart
of accflow_tpu/models/accflow.py, with all of its paths for inference
(`accflow_forward`) and training (`accflow_train_forward`):
- backward (the paper's model, [F_{2,0} .. F_{T-1,0}]): the fused-OFE path
  (`_accflow_forward_fused`, the default), the cold stepwise path
  (`_accflow_forward_stepwise`, AccFlowConfig.fused_ofe=False) and the
  warm-started stepwise path (`_accflow_forward_warmstart`,
  AccFlowConfig.warm_start), whose cell on precomputed context features
  (`_cell_from_ctx`) the streaming step shares;
- forward (the F0N ablation, AccFlowConfig.direction="forward",
  [F_{0,2} .. F_{0,T-1}]): fused (`_accflow_forward_f0n_fused`) and
  stepwise (`_accflow_forward_f0n`). The same cell with the roles swapped
  (the deformable conv warps the encoded local flow by offsets conditioned
  on the encoded carry), so the weights are the same tree; at T=3 it is the
  backward accumulation of the reversed clip.

Modules (networks/AccFlow_.py): FlowEncoder (:48-65), FlowDecoder (:13-45,
convex 8x upsampling), the context BasicEncoder (norm "none"), AccPlus
(:68-109: conv stacks and a modulated 3x3 deformable conv whose 18 offsets
and 9 sigmoid masks come from a ZeroConv2d) and Blending (:112-124).

The fused forwards query every OFE pair of the clip in one batched
estimator call, compute the context features, the maps that do not depend
on the carry and the flow encodings of the queried flows once, and run only
the carry-dependent cell modules in the sequential loop (F0N's occlusion
map is of the carry, so it stays in the loop). The stepwise forwards query
the OFE step by step; the warm-started one starts each step's queries from
the previous step's flows advected into the new frame. Cell modules run in the
compute dtype; OFE flows, occlusion maps and decoder outputs are float32.

Height sharding (parallel/mesh.py): every path (`accflow_forward(...,
spatial=...)`, with `ofe_pairs` from `FlowEstimator.pairs_fn(spatial=...)`
or `ofe` from `flow_fn(spatial=...)` of RAFT, RAFT-small or GMA) and the
streaming cell (`_cell_from_ctx`) run on this rank's block of rows of the
frames, at any height that splits into 8-row blocks (mesh.split_rows;
blocks may differ by 8 rows). The convs read halo rows (their modules take
the handle from nn.layers.spatial_sharding, which each cell sets itself,
so that a rematerialised cell's recompute reads them too), the occlusion
and error maps warp the gathered context of their source frames (F0N's
carry map that of frame i-1, inside the loop), the deformable conv samples
the gathered carry encoding, the convex upsampling reads a halo row of
the flow, and the warm start's advected inits are the group's summed
splats (ops/softsplat.py). The estimator runs on each rank's own queries
against the whole pyramid (kernel #1, or #2 for RAFT-small).

Training (train/engine.py) differentiates a path (fused or stepwise, in
either direction) with respect to the accumulator's weights and detaches
what JAX detaches: the frozen estimator's flows (computed under no_grad, so
its lookup kernel runs with no autograd graph), the occlusion and error
maps, and the carry entering each cell (truncated backpropagation through
the recurrence). The context encoder trains through AccPlus's and
Blending's context inputs. AccFlowConfig.remat recomputes each cell in the
backward pass (the stepwise paths' cell modules; their OFE queries carry no
gradient and are not recomputed). With a spatial handle every exchange is
differentiable (parallel/mesh.py), so each rank's loss part reaches the
weights through the other ranks' rows too (train/engine.py).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn as nn

from accflow_tpu_torch.device import resolve_device
from accflow_tpu_torch.models.encoders import BasicEncoder
from accflow_tpu_torch.models.raft import to_nchw
from accflow_tpu_torch.nn.layers import Conv2d, ZeroConv2d, init_weights, spatial_sharding, tf32
from accflow_tpu_torch.nn.remat import remat_wrap
from accflow_tpu_torch.ops.deform import deform_conv3x3
from accflow_tpu_torch.ops.grids import downflow8
from accflow_tpu_torch.ops.occlusion import photometric_occ
from accflow_tpu_torch.ops.upsample import convex_upsample
from accflow_tpu_torch.ops.warmstart import forward_splat_flow
from accflow_tpu_torch.parallel import mesh
from accflow_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class AccFlowConfig:
    """hidden: cell width. ofe_iters: GRU iterations of the OFE queries
    (what callers pass to FlowEstimator.pairs_fn). warm_start: the
    warm-started stepwise path (accflow_forward's `ofe`; backward only).
    fused_ofe: the fused path (one batched OFE call, accflow_forward's
    `ofe_pairs`), else the cold stepwise one (`ofe`). direction: "backward"
    (F_{i,0}) or "forward" (F0N, F_{0,i}); an unknown one, or "forward"
    with warm_start, raises ValueError. remat, in training: False stores
    every cell's activations; True or "full" recomputes each cell in the
    backward pass from its inputs; "dots" keeps the outputs of its
    convolutions and matmuls and recomputes the rest. The JAX config's
    acc_unroll and stem_s2d are TPU knobs, not carried over."""

    hidden: int = 128
    ofe_iters: int = 12
    compute_dtype: str = "bfloat16"
    warm_start: bool = False
    remat: "bool | str" = False
    fused_ofe: bool = True
    direction: str = "backward"

    def __post_init__(self):
        if self.remat not in (False, True, "full", "dots"):
            raise ValueError(f"remat must be False, True, 'full' or 'dots', got {self.remat!r}")
        if self.direction not in ("backward", "forward"):
            raise ValueError(f"unknown accumulation direction: {self.direction!r}")
        if self.direction == "forward" and self.warm_start:
            raise ValueError("warm_start is a backward-direction feature")

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def _stack(cin, mid, cout, k1, k2):
    return nn.Sequential(Conv2d(cin, mid, k1), nn.ReLU(), Conv2d(mid, cout, k2))


class FlowEncoder(nn.Module):
    def __init__(self, c: int = 128):
        super().__init__()
        self.conv1 = Conv2d(2, c, 7)
        self.conv2 = Conv2d(c, c * 2, 3)
        self.conv3 = Conv2d(c * 2, c, 1)

    def forward(self, x):
        return self.conv3(torch.relu(self.conv2(torch.relu(self.conv1(x)))))


class FlowDecoder(nn.Module):
    def __init__(self, c: int = 128):
        super().__init__()
        self.flow = _stack(c, c * 2, 2, 3, 3)
        self.mask = _stack(c, c * 2, 64 * 9, 3, 1)

    def forward(self, x, spatial=None):
        """x (N, C, h, w) -> (flow_small (N, h, w, 2), flow (N, 8h, 8w, 2)), float32.
        spatial: the convex upsampling's handle."""
        flow_small = self.flow(x).float().permute(0, 2, 3, 1)
        flow = convex_upsample(flow_small, self.mask(x).permute(0, 2, 3, 1), spatial)
        return flow_small, flow


class AccPlus(nn.Module):
    def __init__(self, c: int = 128):
        super().__init__()
        self.conv1 = _stack(c * 2 + 1, c * 2, c, 3, 3)
        self.conv2 = nn.Sequential(
            Conv2d(c * 2, c * 2, 3), nn.ReLU(), Conv2d(c * 2, c, 3), nn.ReLU(),
            ZeroConv2d(c, 27),
        )
        self.dconv = Conv2d(c, c, 3)  # weights of the deformable conv
        self.conv3 = _stack(c * 2 + 1, c * 2, c, 3, 3)
        self.conv4 = nn.Sequential(
            Conv2d(c * 4, c * 2, 3), nn.ReLU(), Conv2d(c * 2, c, 3), nn.ReLU(),
            Conv2d(c, c, 1),
        )

    def forward(self, df, f, o, c, spatial=None):
        """df: encoded local flow; f: encoded carry F_{i-1,0}; o: binary
        occlusion map (N, 1, h, w); c: context of frame i (AccFlow_.py:97-109).
        spatial: the deformable conv's handle."""
        o = o.to(df.dtype)
        x = self.conv1(torch.cat([df, f, o], dim=1))
        x = self.conv2(torch.cat([x, c], dim=1))
        off, m = x[:, :18], torch.sigmoid(x[:, 18:])
        f_ = deform_conv3x3(f, off.float(), m.float(), self.dconv.weight, self.dconv.bias,
                            spatial)
        x = self.conv3(torch.cat([f_, df, o], dim=1))
        return self.conv4(torch.cat([x, c, f_, df], dim=1))


class Blending(nn.Module):
    def __init__(self, c: int = 128):
        super().__init__()
        self.mask = _stack(c, c * 2, 1, 1, 3)

    def forward(self, f1, f2, emap):
        m = torch.sigmoid(self.mask(emap))
        return f1 * m + (1.0 - m) * f2


class AccFlow(nn.Module):
    def __init__(self, cfg: AccFlowConfig = AccFlowConfig()):
        super().__init__()
        c = cfg.hidden
        self.cfg = cfg
        self.flow_encoder = FlowEncoder(c)
        self.flow_decoder = FlowDecoder(c)
        self.context = BasicEncoder(c, "none")
        self.accplus = AccPlus(c)
        self.blending = Blending(c)


def init_accflow(cfg: AccFlowConfig = AccFlowConfig(), seed: int = 1,
                 device=None) -> AccFlow:
    """AccFlow cell modules with weights drawn from `seed` (AccPlus's
    ZeroConv2d starts at zero), in eval mode on `device` (default cuda;
    raises without a GPU unless device="cpu")."""
    dev = resolve_device(device)
    return init_weights(AccFlow(cfg), seed).to(dev).eval()


def _nhwc32(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 2, 3, 1)


def _cell_from_ctx(model: AccFlow, dflow, flow_ini, f2n, c1, c2, cn, spatial=None):
    """The cell modules on precomputed 1/8-res OFE flows (N, h8, w8, 2)
    float32 (local dflow f_{i,i-1}, direct flow_ini F_{i,0}, carry f2n
    F_{i-1,0}) and context features c1/c2/cn of frames i, i-1, 0
    ((N, C, h8, w8), compute dtype). The context encoder is a per-sample
    conv stack, so streaming (streaming.py) caches c2/cn and encodes only
    the new frame. The occlusion and error maps are detached, as JAX stops
    them. Returns (carry (N, h8, w8, 2), flow (N, H, W, 2)), float32.
    spatial: every input and output is this rank's rows; the context of
    frames i-1 and 0 is gathered (one collective) for the maps' warps."""
    cd = model.cfg.dtype
    n = dflow.shape[0]
    with tf32(False), spatial_sharding(model, spatial):
        enc = model.flow_encoder(to_nchw(torch.cat([flow_ini, dflow, f2n]), cd))
        f_ini, df, f = enc[:n], enc[n: 2 * n], enc[2 * n:]
        c1_32 = _nhwc32(c1)
        if spatial is None:
            c2_32, cn_32 = _nhwc32(c2), _nhwc32(cn)
        else:
            c2_32, cn_32 = _nhwc32(mesh.gather_rows(torch.cat([c2, cn]), spatial, dim=2)).chunk(2)
        o = photometric_occ(dflow, c1_32, c2_32, spatial=spatial).detach()
        f_acc = model.accplus(df, f, to_nchw(o, cd), c1, spatial)
        emap = photometric_occ(flow_ini, c1_32, cn_32, binary=False, spatial=spatial).detach()
        f_fuse = model.blending(f_ini, f_acc, to_nchw(emap, cd))
        return model.flow_decoder(f_fuse, spatial)


def _cell_modules(model: AccFlow, dflow, flow_ini, f2n, i1, i2, i_n, spatial=None):
    """_cell_from_ctx with the context of frames i1, i2, i_n (N, H, W, 3)
    encoded here, in one batched call."""
    n = i1.shape[0]
    with tf32(False), spatial_sharding(model, spatial):
        ctx = model.context(to_nchw(torch.cat([i1, i2, i_n]), model.cfg.dtype))
    return _cell_from_ctx(model, dflow, flow_ini, f2n, ctx[:n], ctx[n: 2 * n], ctx[2 * n:],
                          spatial)


def _accflow_forward_stepwise(model: AccFlow, ofe, images: torch.Tensor,
                              spatial=None) -> torch.Tensor:
    """Cold stepwise accumulation (accflow_tpu/models/accflow.py:296-324,
    680-697, AccFlow_.py:177-201): step i queries the OFE for its own pairs,
    I_i -> I_{i-1} and I_i -> I_0 (and, on the first step, the seed
    I_1 -> I_0), then runs the cell. `ofe` is FlowEstimator.flow_fn()."""
    i_n = images[0]
    cell = remat_wrap(functools.partial(_cell_modules, model, spatial=spatial), model.cfg.remat)
    carry, outs = None, []
    for i in range(2, images.shape[0]):
        i1, i2 = images[i], images[i - 1]
        with span("acc.ofe"):
            if carry is None:
                flows = downflow8(ofe(torch.cat([i1, i1, i2]), torch.cat([i2, i_n, i_n])),
                                  spatial)
                dflow, flow_ini, carry = flows.detach().chunk(3)
            else:
                flows = downflow8(ofe(torch.cat([i1, i1]), torch.cat([i2, i_n])), spatial)
                dflow, flow_ini = flows.detach().chunk(2)
        with span("acc.cells"):
            carry, out = cell(dflow, flow_ini, carry.detach(), i1, i2, i_n)
        outs.append(out)
    return torch.stack(outs)


def _accflow_forward_f0n(model: AccFlow, ofe, images: torch.Tensor,
                         spatial=None) -> torch.Tensor:
    """Stepwise forward accumulation, [F_{0,2} .. F_{0,T-1}]
    (accflow_tpu/models/accflow.py:391-458): the cell with the roles
    swapped, F_{0,i}(x) = F_{0,i-1}(x) + f_{i-1,i}(x + F_{0,i-1}(x)). Slots
    of _cell_modules: dflow <- the carry F_{0,i-1} (its occlusion between
    frames 0 and i-1), flow_ini <- the direct flow F_{0,i} (the blending's
    alternative), f2n <- the local flow f_{i-1,i} (the deformable conv's
    operand), frames (0, i-1, i). The first step's OFE call also seeds the
    carry F_{0,1}. `ofe` is FlowEstimator.flow_fn()."""
    i0 = images[0]
    with span("acc.ofe"):
        flows = downflow8(ofe(torch.cat([i0, i0, images[1]]),
                              torch.cat([images[1], images[2], images[2]])), spatial)
        seed, direct, local = flows.detach().chunk(3)
    with span("acc.cells"):
        carry, out = _cell_modules(model, seed, direct, local, i0, images[1], images[2], spatial)
    outs = [out]
    cell = remat_wrap(functools.partial(_cell_modules, model, spatial=spatial), model.cfg.remat)
    for i in range(3, images.shape[0]):
        i2, i_n = images[i - 1], images[i]
        with span("acc.ofe"):
            flows = downflow8(ofe(torch.cat([i0, i2]), torch.cat([i_n, i_n])), spatial)
            direct, local = flows.detach().chunk(2)
        with span("acc.cells"):
            carry, out = cell(carry.detach(), direct, local, i0, i2, i_n)
        outs.append(out)
    return torch.stack(outs)


def _accflow_forward_warmstart(model: AccFlow, ofe, images: torch.Tensor,
                               spatial=None) -> torch.Tensor:
    """Stepwise accumulation with warm-started OFE queries (the reference
    README's TODO, built on upstream RAFT's forward-interpolate warm start).
    Between steps the query frame advances one frame, so the previous
    step's 1/8-res flows are advected into the new frame's grid along the
    negated backward pair flow (constant velocity) and passed to the
    estimator as flow_init:

        dflow_init    <- splat(dflow_prev,    -dflow_prev)
        flow_ini_init <- splat(flow_ini_prev, -dflow_prev)

    `ofe` is FlowEstimator.flow_fn(). Only the estimator's starting point
    changes: with enough iterations the outputs match the cold path.
    spatial: each splat is the group's summed splat of its rows."""
    t = images.shape[0]
    i_n = images[0]
    i1, i2 = images[2], images[1]
    with span("acc.ofe"):
        flows = downflow8(ofe(torch.cat([i1, i1, i2]), torch.cat([i2, i_n, i_n])), spatial)
        dflow, flow_ini, seed = flows.chunk(3)
    with span("acc.cells"):
        carry, out = _cell_modules(model, dflow, flow_ini, seed, i1, i2, i_n, spatial)
    outs = [out]
    for i in range(3, t):
        i1, i2 = images[i], images[i - 1]
        with span("acc.ofe"):  # the warm start's advection, then the query
            advect = -dflow
            init = torch.cat([forward_splat_flow(dflow, advect, spatial),
                              forward_splat_flow(flow_ini, advect, spatial)])
            flows = downflow8(ofe(torch.cat([i1, i1]), torch.cat([i2, i_n]), flow_init=init),
                              spatial)
            dflow, flow_ini = flows.chunk(2)
        with span("acc.cells"):
            carry, out = _cell_modules(model, dflow, flow_ini, carry, i1, i2, i_n, spatial)
        outs.append(out)
    return torch.stack(outs)


def _clip_images(model: AccFlow, images) -> torch.Tensor:
    dev = next(model.parameters()).device
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    if images.shape[0] < 3:
        raise ValueError("AccFlow needs at least 3 frames")
    return images


def _dispatch(model: AccFlow, images: torch.Tensor, ofe_pairs, ofe,
              spatial=None) -> torch.Tensor:
    """The path of model.cfg (direction, warm_start, fused_ofe), given the
    OFE closure it takes (accflow_tpu/models/accflow.py:644-697), on this
    rank's rows under a spatial handle: the span "acc.clip", holding
    "acc.ofe" (the estimator's queries, with the 1/8 downsampling of their
    flows) and "acc.cells" (the context encoder, the maps, the flow
    encoder and the cells) once each on the fused paths, once a step on
    the stepwise ones (utils/profiling.py)."""
    with span("acc.clip"):
        return _path(model, images, ofe_pairs, ofe, spatial)


def _path(model: AccFlow, images: torch.Tensor, ofe_pairs, ofe, spatial):
    cfg = model.cfg
    forward = cfg.direction == "forward"
    mesh.check_rows(images.shape[2], spatial)
    if cfg.warm_start:
        if ofe is None:
            raise ValueError("warm_start needs ofe=FlowEstimator.flow_fn()")
        return _accflow_forward_warmstart(model, ofe, images, spatial)
    if cfg.fused_ofe:
        if ofe_pairs is None:
            raise ValueError("the fused path needs ofe_pairs=FlowEstimator.pairs_fn()")
        fused = _accflow_forward_f0n_fused if forward else _accflow_forward_fused
        return fused(model, ofe_pairs, images, spatial)
    if ofe is None:
        raise ValueError("the stepwise path (fused_ofe=False) needs ofe=FlowEstimator.flow_fn()")
    return (_accflow_forward_f0n if forward else _accflow_forward_stepwise)(model, ofe, images,
                                                                            spatial)


@torch.no_grad()
def accflow_forward(model: AccFlow, images, ofe_pairs=None, ofe=None,
                    spatial=None) -> torch.Tensor:
    """Accumulate long-range flow over a clip.

    images: (T, N, H, W, 3) frames [I0 .. I_{T-1}] in [-1, 1], T >= 3.
    ofe_pairs: (frames, src_idx, dst_idx) -> (P*N, H, W, 2) pair flows
    (FlowEstimator.pairs_fn), for the fused paths. ofe: (image1, image2,
    flow_init=None) -> (N, H, W, 2) flows (FlowEstimator.flow_fn), for the
    stepwise paths (cfg.fused_ofe=False, cfg.warm_start). Returns
    (T-2, N, H, W, 2) float32: [F_{2,0}, ..., F_{T-1,0}], or with
    cfg.direction="forward" [F_{0,2}, ..., F_{0,T-1}]. spatial (a
    parallel.mesh.Spatial handle, given the frames' height): images and
    the flows are this rank's rows, and ofe_pairs / ofe are
    FlowEstimator.pairs_fn(spatial=...) / flow_fn(spatial=...) with the
    same handle."""
    return _dispatch(model, _clip_images(model, images), ofe_pairs, ofe, spatial)


def accflow_train_forward(model: AccFlow, images, ofe_pairs, ofe=None,
                          spatial=None) -> torch.Tensor:
    """accflow_forward with autograd recording the accumulator (the
    training forward of accflow_tpu/models/accflow.py's accflow_forward
    under jax.grad): the same outputs, differentiable with respect to
    `model`'s weights, on the path of model.cfg (fused or stepwise, either
    direction); the frozen estimator's flows, the occlusion and error maps
    and each cell's incoming carry are detached. `ofe_pairs`, `ofe` and
    `spatial` as accflow_forward's: under a handle the outputs are this
    rank's rows, and their gradients reach the other ranks' rows through
    the exchanges' backward (parallel/mesh.py)."""
    if model.cfg.warm_start:
        raise ValueError("training runs the fused or the cold stepwise path; warm_start is an "
                         "inference path")
    return _dispatch(model, _clip_images(model, images), ofe_pairs, ofe, spatial)


def _accflow_forward_fused(model: AccFlow, ofe_pairs, images: torch.Tensor,
                           spatial=None) -> torch.Tensor:
    """Fused-OFE backward accumulation (accflow_tpu/models/accflow.py:553-641).
    spatial: images and flows are this rank's rows; the context of frames
    0 .. T-2, the maps' warp sources, is gathered once."""
    cd = model.cfg.dtype
    t, n, h, w, _ = images.shape
    s, h8, w8 = t - 2, h // 8, w // 8

    # One batched OFE call, pair order [dflow_2..dflow_{T-1} | ini_2..ini_{T-1}
    # | seed] (accflow.py:574-575).
    src_idx = tuple(range(2, t)) + tuple(range(2, t)) + (1,)
    dst_idx = tuple(range(1, t - 1)) + (0,) * s + (0,)
    with span("acc.ofe"):
        flows = downflow8(ofe_pairs(images, src_idx, dst_idx), spatial).detach()
    dflows, inis, seed = flows[: s * n], flows[s * n: 2 * s * n], flows[2 * s * n:]

    with span("acc.cells"), tf32(False), spatial_sharding(model, spatial):
        ctx = model.context(to_nchw(images.reshape(t * n, h, w, 3), cd))
        ctx = ctx.view(t, n, *ctx.shape[1:])  # (T, N, C, h8, w8)
        ctx32 = ctx.float().permute(0, 1, 3, 4, 2)  # (T, N, h8, w8, C)
        c_dim = ctx32.shape[-1]
        # The warps' sources: frames 0 .. T-2, the whole height.
        src32 = ctx32 if spatial is None else \
            mesh.gather_rows(ctx[:-1], spatial, dim=3).float().permute(0, 1, 3, 4, 2)
        sh8 = src32.shape[2]

        # Occlusion / error maps of the queried flows (detached in the reference).
        o = photometric_occ(dflows, ctx32[2:].reshape(s * n, h8, w8, c_dim),
                            src32[1:t - 1].reshape(s * n, sh8, w8, c_dim), spatial=spatial)
        emap = photometric_occ(
            inis, ctx32[2:].reshape(s * n, h8, w8, c_dim),
            src32[0].expand(s, n, sh8, w8, c_dim).reshape(s * n, sh8, w8, c_dim),
            binary=False, spatial=spatial,
        )
        o = to_nchw(o, cd).view(s, n, 1, h8, w8).detach()
        emap = to_nchw(emap, cd).view(s, n, c_dim, h8, w8).detach()

        enc = model.flow_encoder(to_nchw(torch.cat([inis, dflows]), cd))
        f_inis = enc[: s * n].view(s, n, *enc.shape[1:])
        dfs = enc[s * n:].view(s, n, *enc.shape[1:])

        def cell(carry, f_ini, df, o_i, emap_i, c_i):
            with spatial_sharding(model, spatial):  # again in a remat recompute
                f = model.flow_encoder(to_nchw(carry.detach(), cd))
                f_acc = model.accplus(df, f, o_i, c_i, spatial)
                return model.flow_decoder(model.blending(f_ini, f_acc, emap_i), spatial)

        cell = remat_wrap(cell, model.cfg.remat)
        carry, outs = seed, []
        for i in range(s):
            carry, out = cell(carry, f_inis[i], dfs[i], o[i], emap[i], ctx[i + 2])
            outs.append(out)
        return torch.stack(outs)


def _accflow_forward_f0n_fused(model: AccFlow, ofe_pairs, images: torch.Tensor,
                               spatial=None) -> torch.Tensor:
    """Fused-OFE forward accumulation (accflow_tpu/models/accflow.py:461-550;
    slots as _accflow_forward_f0n): one batched OFE call for the direct
    flows F_{0,i}, the local flows f_{i-1,i} and the seed F_{0,1}; the
    context, the error maps of the direct flows and the flow encodings once.
    The occlusion map of the carry between frames 0 and i-1 stays in the
    loop. spatial: images and flows are this rank's rows; the context of
    frames 1 .. T-1, the maps' warp sources, is gathered once."""
    cd = model.cfg.dtype
    t, n, h, w, _ = images.shape
    s, h8, w8 = t - 2, h // 8, w // 8

    # Pair order [direct_2..direct_{T-1} | local_2..local_{T-1} | seed]
    # (accflow.py:478-479).
    src_idx = (0,) * s + tuple(range(1, t - 1)) + (0,)
    dst_idx = tuple(range(2, t)) + tuple(range(2, t)) + (1,)
    with span("acc.ofe"):
        flows = downflow8(ofe_pairs(images, src_idx, dst_idx), spatial).detach()
    directs, locals_, seed = flows[: s * n], flows[s * n: 2 * s * n], flows[2 * s * n:]

    with span("acc.cells"), tf32(False), spatial_sharding(model, spatial):
        ctx = model.context(to_nchw(images.reshape(t * n, h, w, 3), cd))
        ctx = ctx.view(t, n, *ctx.shape[1:])  # (T, N, C, h8, w8)
        ctx32 = ctx.float().permute(0, 1, 3, 4, 2)  # (T, N, h8, w8, C)
        c_dim = ctx32.shape[-1]
        c0, c0_32 = ctx[0], ctx32[0]
        # The warps' sources: frames 1 .. T-1 (src32[k] is frame k + 1), the
        # whole height.
        src32 = ctx32[1:] if spatial is None else \
            mesh.gather_rows(ctx[1:], spatial, dim=3).float().permute(0, 1, 3, 4, 2)
        sh8 = src32.shape[2]

        emap = photometric_occ(
            directs, c0_32.expand(s, n, h8, w8, c_dim).reshape(s * n, h8, w8, c_dim),
            src32[1:].reshape(s * n, sh8, w8, c_dim), binary=False, spatial=spatial)
        emap = to_nchw(emap, cd).view(s, n, c_dim, h8, w8).detach()

        enc = model.flow_encoder(to_nchw(torch.cat([directs, locals_]), cd))
        f_dirs = enc[: s * n].view(s, n, *enc.shape[1:])
        f_locs = enc[s * n:].view(s, n, *enc.shape[1:])

        def cell(carry, f_dir, f_loc, emap_i, c_prev32):
            with spatial_sharding(model, spatial):  # again in a remat recompute
                carry = carry.detach()
                f = model.flow_encoder(to_nchw(carry, cd))
                o = photometric_occ(carry, c0_32, c_prev32, spatial=spatial).detach()
                f_acc = model.accplus(f, f_loc, to_nchw(o, cd), c0, spatial)
                return model.flow_decoder(model.blending(f_dir, f_acc, emap_i), spatial)

        cell = remat_wrap(cell, model.cfg.remat)
        carry, outs = seed, []
        for i in range(s):
            carry, out = cell(carry, f_dirs[i], f_locs[i], emap[i], src32[i])
            outs.append(out)
        return torch.stack(outs)
