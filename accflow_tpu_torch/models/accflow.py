"""AccFlow: occlusion-aware backward accumulation of long-range flow
(inference), counterpart of accflow_tpu/models/accflow.py — the fused-OFE
path, `_accflow_forward_fused`.

Modules (networks/AccFlow_.py): FlowEncoder (:48-65), FlowDecoder (:13-45,
convex 8x upsampling), the context BasicEncoder (norm "none"), AccPlus
(:68-109: conv stacks and a modulated 3x3 deformable conv whose 18 offsets
and 9 sigmoid masks come from a ZeroConv2d) and Blending (:112-124).

The forward queries every OFE pair of the clip in one batched estimator
call, computes the context features, occlusion and error maps and the flow
encodings of the queried flows once, and runs only the carry-dependent
cell modules in the sequential loop. Cell modules run in the compute
dtype; OFE flows, occlusion maps and decoder outputs are float32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from accflow_tpu_torch.device import resolve_device
from accflow_tpu_torch.models.encoders import BasicEncoder
from accflow_tpu_torch.models.raft import to_nchw
from accflow_tpu_torch.nn.layers import Conv2d, ZeroConv2d, init_weights, tf32
from accflow_tpu_torch.ops.deform import deform_conv3x3
from accflow_tpu_torch.ops.grids import downflow8
from accflow_tpu_torch.ops.occlusion import photometric_occ
from accflow_tpu_torch.ops.upsample import convex_upsample


@dataclasses.dataclass(frozen=True)
class AccFlowConfig:
    """hidden: cell width. ofe_iters: GRU iterations of the OFE queries
    (what callers pass to FlowEstimator.pairs_fn). The JAX config's other
    fields select paths this port does not carry (stepwise, warm start,
    forward direction, remat, acc_unroll, stem_s2d)."""

    hidden: int = 128
    ofe_iters: int = 12
    compute_dtype: str = "bfloat16"

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

    def forward(self, x):
        """x (N, C, h, w) -> (flow_small (N, h, w, 2), flow (N, 8h, 8w, 2)), float32."""
        flow_small = self.flow(x).float().permute(0, 2, 3, 1)
        flow = convex_upsample(flow_small, self.mask(x).permute(0, 2, 3, 1))
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

    def forward(self, df, f, o, c):
        """df: encoded local flow; f: encoded carry F_{i-1,0}; o: binary
        occlusion map (N, 1, h, w); c: context of frame i (AccFlow_.py:97-109)."""
        o = o.to(df.dtype)
        x = self.conv1(torch.cat([df, f, o], dim=1))
        x = self.conv2(torch.cat([x, c], dim=1))
        off, m = x[:, :18], torch.sigmoid(x[:, 18:])
        f_ = deform_conv3x3(f, off.float(), m.float(), self.dconv.weight, self.dconv.bias)
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


@torch.no_grad()
def accflow_forward(model: AccFlow, images, ofe_pairs) -> torch.Tensor:
    """Accumulate long-range flow over a clip.

    images: (T, N, H, W, 3) frames [I0 .. I_{T-1}] in [-1, 1], T >= 3.
    ofe_pairs: (frames, src_idx, dst_idx) -> (P*N, H, W, 2) pair flows
    (FlowEstimator.pairs_fn). Returns (T-2, N, H, W, 2) float32:
    [F_{2,0}, ..., F_{T-1,0}]."""
    cd = model.cfg.dtype
    dev = next(model.parameters()).device
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    t, n, h, w, _ = images.shape
    if t < 3:
        raise ValueError("AccFlow needs at least 3 frames")
    s, h8, w8 = t - 2, h // 8, w // 8

    # One batched OFE call, pair order [dflow_2..dflow_{T-1} | ini_2..ini_{T-1}
    # | seed] (accflow.py:574-575).
    src_idx = tuple(range(2, t)) + tuple(range(2, t)) + (1,)
    dst_idx = tuple(range(1, t - 1)) + (0,) * s + (0,)
    flows = downflow8(ofe_pairs(images, src_idx, dst_idx))
    dflows, inis, seed = flows[: s * n], flows[s * n: 2 * s * n], flows[2 * s * n:]

    with tf32(False):
        ctx = model.context(to_nchw(images.reshape(t * n, h, w, 3), cd))
        ctx = ctx.view(t, n, *ctx.shape[1:])  # (T, N, C, h8, w8)
        ctx32 = ctx.float().permute(0, 1, 3, 4, 2)  # (T, N, h8, w8, C)
        c_dim = ctx32.shape[-1]

        # Occlusion / error maps of the queried flows (detached in the reference).
        o = photometric_occ(dflows, ctx32[2:].reshape(s * n, h8, w8, c_dim),
                            ctx32[1:-1].reshape(s * n, h8, w8, c_dim))
        emap = photometric_occ(
            inis, ctx32[2:].reshape(s * n, h8, w8, c_dim),
            ctx32[0].expand(s, n, h8, w8, c_dim).reshape(s * n, h8, w8, c_dim),
            binary=False,
        )
        o = to_nchw(o, cd).view(s, n, 1, h8, w8)
        emap = to_nchw(emap, cd).view(s, n, c_dim, h8, w8)

        enc = model.flow_encoder(to_nchw(torch.cat([inis, dflows]), cd))
        f_inis = enc[: s * n].view(s, n, *enc.shape[1:])
        dfs = enc[s * n:].view(s, n, *enc.shape[1:])

        carry, outs = seed, []
        for i in range(s):
            f = model.flow_encoder(to_nchw(carry, cd))
            f_acc = model.accplus(dfs[i], f, o[i], ctx[i + 2])
            f_fuse = model.blending(f_inis[i], f_acc, emap[i])
            carry, out = model.flow_decoder(f_fuse)
            outs.append(out)
        return torch.stack(outs)
