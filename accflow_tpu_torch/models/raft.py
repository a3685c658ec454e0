"""RAFT optical-flow estimator (inference), counterpart of
accflow_tpu/models/raft.py at the full width of the repo's RAFT: basic
encoders (fnet 256 channels, instance norm; cnet 128 hidden + 128 context,
frozen batch norm), radius 4, 4 levels.

One iteration: the correlation window lookup (ops/corr_cuda.py: the CUDA
kernel on the GPU, the plain gather on the CPU) gives the (Q, 324) motion
encoder input (JAX's `pallas_fused` path) -> BasicMotionEncoder ->
SepConvGRU -> FlowHead. Encoders and the update block run in the compute
dtype; the pyramid products, coordinates and upsampling in float32, and
the stored pyramid levels in the compute dtype.

Images are (N, H, W, 3) in [-1, 1]; flows (N, H, W, 2) in (x, y) order.
Feature maps inside are NCHW, kept channels_last in memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from accflow_tpu_torch.device import resolve_device
from accflow_tpu_torch.models.encoders import BasicEncoder
from accflow_tpu_torch.nn.layers import Conv2d, conv2d, init_weights, tf32
from accflow_tpu_torch.ops.corr import build_corr_pyramid
from accflow_tpu_torch.ops.corr_cuda import LEVELS, RADIUS, lookup_corr_fused
from accflow_tpu_torch.ops.grids import coords_grid
from accflow_tpu_torch.ops.upsample import convex_upsample


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """The full-width RAFT of the JAX package (RAFTConfig with small=False).
    Its TPU-only knobs (corr_lookup, scan_unroll, scan_remat, stem_s2d,
    corr_volume_dtype) are not carried over: the port has one lookup, and
    the pyramid levels are stored in the compute dtype."""

    iters: int = 12
    compute_dtype: str = "bfloat16"

    hidden_dim = 128  # class constants, not fields: RAFT-small is not ported
    context_dim = 128
    corr_levels = LEVELS  # both compiled into the lookup kernel
    corr_radius = RADIUS

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def corr_planes(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2


def to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(N, H, W, C) -> (N, C, H, W) in `dtype`, channels_last in memory."""
    return x.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 256, 1)
        self.convc2 = Conv2d(256, 192, 3)
        self.convf1 = Conv2d(2, 128, 7)
        self.convf2 = Conv2d(128, 64, 3)
        self.conv = Conv2d(64 + 192, 128 - 2, 3)

    def forward(self, flow, corr):
        """flow (N, 2, H, W), corr (N, corr_planes, H, W) -> (N, 128, H, W)."""
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """Separable (1x5 then 5x1) ConvGRU (update.py:33-60)."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        cat = hidden_dim + input_dim
        for ax, k in (("1", (1, 5)), ("2", (5, 1))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{ax}", Conv2d(cat, hidden_dim, k))
        self.hidden_dim = hidden_dim

    def fused_step(self, inp: torch.Tensor):
        """A GRU step specialised to the loop-invariant context `inp`.

        The GRU input is cat(inp, varying) and `inp` never changes across
        iterations. A conv is linear in its input channels, so each gate's
        conv over cat(h, inp, varying) splits into three channel slices;
        conv_inp(inp) + bias is computed once here (make_fused_sep_gru,
        accflow_tpu/models/raft.py:159-204), and the per-iteration convs
        are fused across gates (z|r|q over `varying`, z|r over h).
        Returns step(h, varying) -> h."""
        hd, idim, cd = self.hidden_dim, inp.shape[1], inp.dtype
        pre = {}
        for ax in ("1", "2"):
            gates = [getattr(self, f"conv{g}{ax}") for g in "zrq"]
            w_inp = torch.cat([g.weight[:, hd:hd + idim] for g in gates])
            bias = torch.cat([g.bias for g in gates])
            pre[ax] = (
                conv2d(inp, w_inp, bias),
                torch.cat([g.weight[:, hd + idim:] for g in gates]).to(cd),
                torch.cat([g.weight[:, :hd] for g in gates[:2]]).to(cd),
                gates[2].weight[:, :hd].to(cd),
            )

        def step(h, varying):
            for ax in ("1", "2"):
                a_inp, w_var, w_h_zr, w_h_q = pre[ax]
                s = conv2d(varying, w_var) + a_inp
                hzr = conv2d(h, w_h_zr)
                z = torch.sigmoid(hzr[:, :hd] + s[:, :hd])
                r = torch.sigmoid(hzr[:, hd:] + s[:, hd:2 * hd])
                q = torch.tanh(conv2d(r * h, w_h_q) + s[:, 2 * hd:])
                h = (1.0 - z) * h + z * q
            return h

        return step


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3)
        self.conv2 = Conv2d(hidden_dim, 2, 3)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        hd = cfg.hidden_dim
        self.encoder = BasicMotionEncoder(cfg.corr_planes)
        self.gru = SepConvGRU(hd, 128 + hd)
        self.flow_head = FlowHead(hd, 256)
        self.mask = nn.Sequential(Conv2d(128, 256, 3), nn.ReLU(), Conv2d(256, 64 * 9, 1))

    def upsample_mask(self, net):
        """0.25-scaled convex-upsampling mask head (update.py:122-125,135)."""
        return 0.25 * self.mask(net)


class RAFT(nn.Module):
    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.cfg = cfg
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch")
        self.update_block = BasicUpdateBlock(cfg)


def init_raft(cfg: RAFTConfig = RAFTConfig(), seed: int = 0, device=None) -> RAFT:
    """RAFT with weights drawn from `seed`, in eval mode on `device`
    (default cuda; raises without a GPU unless device="cpu")."""
    dev = resolve_device(device)
    return init_weights(RAFT(cfg), seed).to(dev).eval()


def raft_cnet(model: RAFT, images: torch.Tensor):
    """Context encoder on NCHW images -> (net, inp) initial state."""
    out = model.cnet(images)
    hd = model.cfg.hidden_dim
    return torch.tanh(out[:, :hd]), torch.relu(out[:, hd:])


def raft_iterate(model: RAFT, levels, net, inp, iters: int, final_only: bool):
    """The GRU refinement loop on a built pyramid. net/inp (N, C, h8, w8)
    in the compute dtype. Returns {"flow_up", "flow_low"[, "predictions"]}."""
    cfg, ub = model.cfg, model.update_block
    cd = cfg.dtype
    n, _, h8, w8 = net.shape
    coords0 = coords_grid(n, h8, w8, device=net.device)
    coords1 = coords0.clone()
    gru_step = ub.gru.fused_step(inp)
    preds = []
    for _ in range(iters):
        flow = coords1 - coords0
        corr = lookup_corr_fused(levels, coords1.view(-1, 2), cfg.corr_radius)
        corr = corr.view(n, h8, w8, -1).permute(0, 3, 1, 2).to(cd)
        motion = ub.encoder(flow.permute(0, 3, 1, 2).to(cd), corr)
        net = gru_step(net, motion)
        delta = ub.flow_head(net)
        coords1 = (coords1 + delta.float().permute(0, 2, 3, 1)).contiguous()
        if not final_only:
            mask = ub.upsample_mask(net).permute(0, 2, 3, 1)
            preds.append(convex_upsample(coords1 - coords0, mask))
    out = {"flow_low": coords1 - coords0}
    if final_only:
        mask = ub.upsample_mask(net).permute(0, 2, 3, 1)
        out["flow_up"] = convex_upsample(coords1 - coords0, mask)
    else:
        out["flow_up"] = preds[-1]
        out["predictions"] = torch.stack(preds)
    return out


def _as_images(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def raft_forward(model: RAFT, image1, image2, iters: Optional[int] = None,
                 final_only: bool = False):
    """Flow image1 -> image2; images (N, H, W, 3). Returns flow_up
    (N, H, W, 2) float32, flow_low (N, H/8, W/8, 2) and, unless
    final_only, the per-iteration upsampled `predictions`."""
    dev = next(model.parameters()).device
    frames = torch.stack([_as_images(image1, dev), _as_images(image2, dev)])
    return _pairs(model, frames, (0,), (1,), iters, final_only)


@torch.no_grad()
def raft_pairs_forward(model: RAFT, frames, src_idx, dst_idx,
                       iters: Optional[int] = None, final_only: bool = True):
    """Flow for many (src, dst) frame pairs with deduplicated encodes.

    frames (K, N, H, W, 3); src_idx/dst_idx equal-length index tuples. Each
    used frame is fnet-encoded once and each source frame cnet-encoded once
    (AccFlow's 11 clip queries cost 7 fnet + 6 cnet encodes, not 22 + 11).
    Returns flow_up (P*N, H, W, 2), pairs stacked P-major."""
    dev = next(model.parameters()).device
    return _pairs(model, _as_images(frames, dev), src_idx, dst_idx, iters,
                  final_only)["flow_up"]


def _pairs(model, frames, src_idx, dst_idx, iters, final_only):
    cfg = model.cfg
    cd = cfg.dtype
    iters = cfg.iters if iters is None else iters
    src_idx = tuple(int(i) for i in src_idx)
    dst_idx = tuple(int(i) for i in dst_idx)
    k, n, h, w, _ = frames.shape
    p = len(src_idx)
    with tf32(False):
        used = sorted(set(src_idx) | set(dst_idx))
        pos = {f: i for i, f in enumerate(used)}
        fmaps = model.fnet(to_nchw(frames[used].reshape(-1, h, w, 3), cd))
        fmaps = fmaps.view(len(used), n, *fmaps.shape[1:])
        fmap1 = fmaps[[pos[i] for i in src_idx]].flatten(0, 1)
        fmap2 = fmaps[[pos[i] for i in dst_idx]].flatten(0, 1)
        levels = build_corr_pyramid(fmap1, fmap2, cfg.corr_levels, dtype=cd)
        del fmaps, fmap1, fmap2

        src_used = sorted(set(src_idx))
        spos = {f: i for i, f in enumerate(src_used)}
        net_u, inp_u = raft_cnet(model, to_nchw(frames[src_used].reshape(-1, h, w, 3), cd))
        sel = [spos[i] for i in src_idx]
        net = net_u.view(len(src_used), n, *net_u.shape[1:])[sel].flatten(0, 1)
        inp = inp_u.view(len(src_used), n, *inp_u.shape[1:])[sel].flatten(0, 1)
        return raft_iterate(model, levels, net, inp, iters, final_only)
