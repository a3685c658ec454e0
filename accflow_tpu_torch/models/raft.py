"""RAFT optical-flow estimator, counterpart of accflow_tpu/models/raft.py,
in its two configurations:
- full width (RAFTConfig()): basic encoders (fnet 256 channels, instance
  norm; cnet 128 hidden + 128 context, frozen batch norm), radius 4, 4
  levels, SepConvGRU, convex upsampling;
- RAFT-small (RAFTConfig(small=True)): small encoders (fnet 128, instance
  norm; cnet 96 hidden + 64 context, no norm), radius 3, 4 levels, a 3x3
  ConvGRU, no mask head: flows are upsampled with upflow8.
corr_levels and corr_radius set the pyramid's level count and the window's
radius (RAFT-small keeps radius 3 whatever corr_radius says, as in JAX);
convc1's input width follows (corr_planes). The lookup kernel follows the
pair (ops/corr.py::lookup_corr_kernel): kernel #1 at radius 4 over 4
levels, kernel #2 built for every other pair.

One iteration: the correlation window lookup gives the motion encoder its
input -> motion encoder -> GRU -> FlowHead. RAFTConfig.corr_lookup picks the
lookup of full RAFT (ops/corr.py::normalize_corr_lookup):
- "fused" (also spelled "mm" or "pallas_fused", one function in JAX): the
  4-level radius-4 kernel (ops/corr_cuda.py), a (Q, 324) input to convc1
  (kernel #2, ops/corr_level_cuda.py, at any other radius or level count);
- "ondemand[:chunk]": the volume-free lookup (ops/corr.py::
  lookup_corr_on_demand): features, not the volume, are stored, and every
  iteration rebuilds each chunk's rows and reads them with the same kernel
  as "fused" (#2 for RAFT-small), so high resolutions fit the card;
- "auto": "fused" while the stored pyramid fits ops/corr.py's budget,
  "ondemand" beyond it (resolve_auto_lookup, per shape in each entry point);
- the experimental spellings, behind "experimental:", dispatched as JAX's
  step dispatches them (accflow_tpu/models/raft.py:575-657; ops/corr.py
  names their functions):
  - flat lookups into convc1, like "fused": "pallas" (kernel #2,
    ops/corr_level_cuda.py, at the config's radius; bfloat16 levels unless
    the compute dtype is float32), "rows", "patch", "gather" (PyTorch ops);
  - split lookups, per-level (N, H, W, 2r+1, 2r+1) windows into
    BasicMotionEncoder.forward_split: "fused_bd" / "fused_bd2" (level 0,
    or 0 and 1, through the y_contract kernel #3, ops/corr_bd_cuda.py,
    built for 2r+1 taps; the rest torch.bmm), "fused_vy" (the y
    contraction summed in float32), "fusedv" (the x contraction as 2r+1
    multiply-and-sum passes), "packed" / "packed2" (levels 1.. or 2..
    packed into one map, whose windows come as one (N, H, W, L', 2r+1,
    2r+1) entry), "fused_mix:<l0,l1,l2,l3>" (a level impl
    each from mm, bd, rows, rows_gx, vpu_y; kernel #3 for bd);
  - split lookups into BasicMotionEncoder.forward_stacked (convc1 as one
    product over the stacked windows): "fused_cat", "fused_vy_cat".
RAFT-small takes the per-level kernel (ops/corr_level_cuda.py) on the
stored pyramid or under ondemand, and for "experimental:pallas"; "rows",
"patch" and "gather" are its flat lookups at radius 3; every split
spelling maps to its default lookup, as JAX maps them to its flat one. On
the CPU each kernel is replaced by its plain version. Encoders and the
update block run in the compute dtype; the pyramid products, coordinates
and upsampling in float32, and the stored pyramid levels in
corr_volume_dtype (RAFTConfig.level_dtype: by default the compute dtype
when inferring, float32 when training).

Images are (N, H, W, 3) in [-1, 1]; flows (N, H, W, 2) in (x, y) order.
Feature maps inside are NCHW, kept channels_last in memory.

Inference (raft_forward and the other entry points) runs under no_grad.
The entry points of both sizes, raft_train_forward among them, take a
`spatial` handle
(parallel/mesh.py): the frames, every activation, the correlation's queries
and the flows are then this rank's rows of a height-sharded image, the
convs read halo rows, the instance norms combine the ranks' statistics,
each target frame's fnet map is gathered once (the keys of every query),
and kernel #1 (#2 for RAFT-small) reads this rank's queries against the
whole pyramid; RAFT-small's upflow8 reads one halo row each way.
raft_train_forward is fine-tuning's forward (JAX's forward with
train=True): autograd records it, the cnet's BatchNorm normalises with the
batch's statistics and keeps its running-statistics updates
(nn.layers.collect_bn_updates), the pyramid is stored (or, under
ondemand, rebuilt) in float32 unless corr_volume_dtype says otherwise
(JAX's default corr_volume_dtype), so that the levels' gradient sums its
iterations in float32, and the lookups' backward is the backward kernel
(ops/corr_backward_cuda.py, built for the config's radius and levels). The coordinates are detached at the top of
every iteration, as JAX's stop_gradient; `remat` checkpoints each
iteration (JAX's scan_remat).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from accflow_tpu_torch.device import resolve_device
from accflow_tpu_torch.models.encoders import BasicEncoder, SmallEncoder
from accflow_tpu_torch.nn.layers import (
    Conv2d,
    batch_statistics,
    conv2d,
    init_weights,
    spatial_sharding,
    tf32,
)
from accflow_tpu_torch.nn.remat import remat_wrap
from accflow_tpu_torch.ops.corr import (
    FLAT_LOOKUPS,
    SPLIT_LOOKUPS,
    STACKED_LOOKUPS,
    OnDemandCorr,
    build_corr_operands,
    lookup_corr_kernel,
    lookup_corr_on_demand,
    lookup_flat,
    normalize_corr_lookup,
    resolve_auto_lookup,
    split_level_impls,
    split_windows,
)
from accflow_tpu_torch.ops.grids import coords_grid, upflow8
from accflow_tpu_torch.ops.upsample import convex_upsample
from accflow_tpu_torch.parallel import mesh
from accflow_tpu_torch.utils.profiling import span


VOLUME_DTYPES = (None, "float32", "bfloat16")  # corr_volume_dtype's values


def check_corr_fields(cfg) -> None:
    """ValueError for a corr_levels, corr_radius or corr_volume_dtype that no
    kernel takes, and for experimental:packed[2] with no level to pack
    (levels 1.. or 2..), where JAX's lookup_corr_split_packed fails with an
    IndexError (RAFTConfig's and GMAConfig's __post_init__)."""
    if cfg.corr_levels < 1 or cfg.corr_radius < 0:
        raise ValueError(f"corr_levels must be >= 1 and corr_radius >= 0, got "
                         f"{cfg.corr_levels} and {cfg.corr_radius}")
    if cfg.corr_volume_dtype not in VOLUME_DTYPES:
        raise ValueError(f"corr_volume_dtype must be one of {VOLUME_DTYPES}, got "
                         f"{cfg.corr_volume_dtype!r}")
    start = {"packed": 1, "packed2": 2}.get(cfg.lookup_impl)
    if start is not None and not cfg.small and cfg.corr_levels <= start:
        raise ValueError(f"corr_lookup={cfg.corr_lookup!r} packs levels {start}.., and "
                         f"corr_levels={cfg.corr_levels} leaves none to pack")


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    """The JAX package's RAFTConfig: full width, or RAFT-small with
    small=True, from which the widths follow. corr_lookup selects full
    RAFT's lookup (module docstring; an unported spelling raises here).
    corr_levels and corr_radius are JAX's fields, at JAX's defaults (4, 4);
    the window's radius is `radius`, 3 for RAFT-small whatever corr_radius
    says (accflow_tpu/models/raft.py:110-112). Its TPU-only knobs
    (scan_unroll, stem_s2d) are not carried over; scan_remat is
    raft_train_forward's `remat` argument.

    corr_volume_dtype is the dtype of the stored pyramid levels (and of the
    ondemand lookup's rebuilt rows), when inferring and when training:
    "float32" and "bfloat16" mean what they mean in JAX
    (accflow_tpu/models/raft.py:64-67), and "auto" sizes the volume by it.
    JAX's default is "float32". The port's default, None, keeps the
    levels in the compute dtype when inferring and in float32 when
    training (level_dtype): at float32 compute that is JAX's "float32",
    and at bfloat16 compute it is JAX's "bfloat16" for the lookups'
    forward, which barely moves the flow: on the CPU, full RAFT at batch
    2, 12 iterations, the port's max |bf16 - JAX float32| went from
    3.61e-2 (bfloat16 levels) to 3.80e-2 (float32 levels) at 64^2, and
    from 3.26e-2 to 3.16e-2 at 96^2, against JAX's own bfloat16 error of
    5.66e-2 and 6.61e-2. tests/test_torch_bf16.py holds the port's
    bfloat16 flow to JAX's own bfloat16 error."""

    iters: int = 12
    compute_dtype: str = "bfloat16"
    small: bool = False
    corr_lookup: str = "fused"
    corr_levels: int = 4
    corr_radius: int = 4
    corr_volume_dtype: Optional[str] = None

    def __post_init__(self):
        normalize_corr_lookup(self.corr_lookup)
        check_corr_fields(self)

    @property
    def lookup_impl(self) -> str:
        """The normalized spelling (ops/corr.py::normalize_corr_lookup)."""
        return normalize_corr_lookup(self.corr_lookup)

    @property
    def split_levels(self):
        """The per-level impls of a split spelling built on
        lookup_corr_split_v2 (fused_bd: "bd" then "mm"; fused_bd2: "bd" on
        two levels; fused_vy[_cat]: "vpu_y"; fused_mix: its list, the last
        entry repeated), or None: for every other spelling, and for
        RAFT-small, which maps split spellings to its default lookup."""
        return None if self.small else split_level_impls(self.lookup_impl, self.corr_levels)

    @property
    def hidden_dim(self) -> int:
        return 96 if self.small else 128

    @property
    def context_dim(self) -> int:
        return 64 if self.small else 128

    @property
    def radius(self) -> int:
        """The window's radius: 3 for RAFT-small, corr_radius otherwise."""
        return 3 if self.small else self.corr_radius

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def level_dtype(self, train: bool = False) -> torch.dtype:
        """The stored levels' dtype: corr_volume_dtype where it is set, else
        float32 when training and the compute dtype when inferring."""
        if self.corr_volume_dtype is not None:
            return getattr(torch, self.corr_volume_dtype)
        return torch.float32 if train else self.dtype

    @property
    def corr_planes(self) -> int:
        return self.corr_levels * (2 * self.radius + 1) ** 2


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
        return self._tail(flow, self.convc1(corr))

    def forward_split(self, flow, corr_levels):
        """forward on the split lookup's per-level windows: corr_levels is a
        list of (N, H, W, 2r+1, 2r+1) windows [a, b] of one level each, or
        (N, H, W, L', 2r+1, 2r+1) of L' packed levels
        (lookup_corr_split_packed), in the compute dtype. convc1 is 1x1, so
        convc1(cat(levels)) = bias + sum_l window_l . W_l, W_l being convc1's
        (2r+1)^2 input channels from l*(2r+1)^2 on (a*(2r+1) + b order),
        sliced by each entry's width: the same weight, split by level. The bias comes
        first, then each entry's product (a packed entry's over its levels'
        channels at once), each rounded to the compute dtype
        (accflow_tpu/models/raft.py::basic_motion_encoder_split)."""
        cd = corr_levels[0].dtype
        n, h, w = corr_levels[0].shape[:3]
        wc = self.convc1.weight.view(self.convc1.weight.shape[0], -1)
        cor, k0 = self.convc1.bias.to(cd), 0
        for part in corr_levels:
            x = part.reshape(n, h, w, -1)
            cor = cor + x @ wc[:, k0:k0 + x.shape[-1]].t().to(cd)
            k0 += x.shape[-1]
        cor = cor.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self._tail(flow, cor)

    def forward_stacked(self, flow, corr_levels):
        """forward on the L per-level (N, H, W, 2r+1, 2r+1) windows stacked
        into (N, H, W, L*(2r+1)^2) (level, a, b: convc1's channel order): convc1 as one
        product over them, rounded to the compute dtype, and the bias added
        after it (accflow_tpu/models/raft.py::basic_motion_encoder_stacked),
        where forward_split adds the bias first."""
        cd = corr_levels[0].dtype
        n, h, w = corr_levels[0].shape[:3]
        x = torch.stack(corr_levels, dim=3).reshape(n, h, w, -1)
        wc = self.convc1.weight.view(self.convc1.weight.shape[0], -1)
        cor = x @ wc.t().to(cd) + self.convc1.bias.to(cd)
        cor = cor.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self._tail(flow, cor)

    def _tail(self, flow, cor):
        """The layers after convc1, on its pre-activation output `cor`."""
        cor = torch.relu(self.convc2(torch.relu(cor)))
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

    def fused_step(self, inp: torch.Tensor, spatial=None):
        """A GRU step specialised to the loop-invariant context `inp`
        (spatial: the handle of its rows; the 5x1 convs read halo rows).

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
                conv2d(inp, w_inp, bias, spatial=spatial),
                torch.cat([g.weight[:, hd + idim:] for g in gates]).to(cd),
                torch.cat([g.weight[:, :hd] for g in gates[:2]]).to(cd),
                gates[2].weight[:, :hd].to(cd),
            )

        def step(h, varying):
            for ax in ("1", "2"):
                a_inp, w_var, w_h_zr, w_h_q = pre[ax]
                s = conv2d(varying, w_var, spatial=spatial) + a_inp
                hzr = conv2d(h, w_h_zr, spatial=spatial)
                z = torch.sigmoid(hzr[:, :hd] + s[:, :hd])
                r = torch.sigmoid(hzr[:, hd:] + s[:, hd:2 * hd])
                q = torch.tanh(conv2d(r * h, w_h_q, spatial=spatial) + s[:, 2 * hd:])
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
    """gru_input: the GRU's input channels beside the hidden state (context
    + motion, 128 + hidden; GMA's update block adds its aggregated motion)."""

    def __init__(self, cfg: RAFTConfig, gru_input: Optional[int] = None):
        super().__init__()
        hd = cfg.hidden_dim
        self.encoder = BasicMotionEncoder(cfg.corr_planes)
        self.gru = SepConvGRU(hd, 128 + hd if gru_input is None else gru_input)
        self.flow_head = FlowHead(hd, 256)
        self.mask = nn.Sequential(Conv2d(128, 256, 3), nn.ReLU(), Conv2d(256, 64 * 9, 1))

    def upsample_mask(self, net):
        """0.25-scaled convex-upsampling mask head (update.py:122-125,135)."""
        return 0.25 * self.mask(net)


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 96, 1)
        self.convf1 = Conv2d(2, 64, 7)
        self.convf2 = Conv2d(64, 32, 3)
        self.conv = Conv2d(128, 80, 3)

    def forward(self, flow, corr):
        """flow (N, 2, H, W), corr (N, corr_planes, H, W) -> (N, 82, H, W)."""
        cor = torch.relu(self.convc1(corr))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class ConvGRU(nn.Module):
    """3x3 ConvGRU (update.py:19-31)."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        cat = hidden_dim + input_dim
        self.convz = Conv2d(cat, hidden_dim, 3)
        self.convr = Conv2d(cat, hidden_dim, 3)
        self.convq = Conv2d(cat, hidden_dim, 3)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * q


class SmallUpdateBlock(nn.Module):
    """RAFT-small's update block: no mask head (update.py:99-113)."""

    def __init__(self, cfg: RAFTConfig):
        super().__init__()
        self.encoder = SmallMotionEncoder(cfg.corr_planes)
        self.gru = ConvGRU(cfg.hidden_dim, 82 + cfg.context_dim)
        self.flow_head = FlowHead(cfg.hidden_dim, 128)


class RAFT(nn.Module):
    def __init__(self, cfg: RAFTConfig = RAFTConfig()):
        super().__init__()
        self.cfg = cfg
        planes = cfg.hidden_dim + cfg.context_dim
        if cfg.small:
            self.fnet = SmallEncoder(128, "instance")
            self.cnet = SmallEncoder(planes, "none")
            self.update_block = SmallUpdateBlock(cfg)
        else:
            self.fnet = BasicEncoder(256, "instance")
            self.cnet = BasicEncoder(planes, "batch")
            self.update_block = BasicUpdateBlock(cfg)


def init_raft(cfg: RAFTConfig = RAFTConfig(), seed: int = 0, device=None) -> RAFT:
    """RAFT with weights drawn from `seed`, in eval mode on `device`
    (default cuda; raises without a GPU unless device="cpu")."""
    dev = resolve_device(device)
    return init_weights(RAFT(cfg), seed).to(dev).eval()


def raft_cnet(model: RAFT, images: torch.Tensor, train: bool = False):
    """Context encoder on NCHW images -> (net, inp) initial state. train:
    its BatchNorm layers normalise with the batch's statistics and keep
    their running-statistics updates (nn.layers.batch_statistics)."""
    with batch_statistics(model.cnet, train):
        out = model.cnet(images)
    hd = model.cfg.hidden_dim
    return torch.tanh(out[:, :hd]), torch.relu(out[:, hd:])


def raft_iterate(model: RAFT, levels, net, inp, iters: int, final_only: bool,
                 flow_init: Optional[torch.Tensor] = None, aggregate=None,
                 remat: str = "none", spatial=None):
    """The GRU refinement loop on a built pyramid, or on the volume-free
    lookup's operands (OnDemandCorr from build_corr_operands, their chunk
    set outside the loop). net/inp (N, C, h8, w8) in the compute
    dtype; flow_init an optional (N, h8, w8, 2) warm start,
    added to the coordinate grid in float32. aggregate: GMA's global
    motion, motion (N, 128, h8, w8) -> (N, 128, h8, w8), whose output joins
    the motion features in the GRU's input (models/gma.py::gma_iterate).
    The coordinates are detached at the top of every iteration (JAX's
    stop_gradient). remat ("none", "dots" or "full", nn.remat.remat_wrap)
    checkpoints each iteration under autograd. spatial: net, inp, flow_init
    and the flows are this rank's rows (the update block's layers take the
    handle from spatial_sharding), the coordinates global. Each iteration
    is the span "est.update" (utils/profiling.py).
    Returns {"flow_up", "flow_low"[, "predictions"]}."""
    cfg, ub = model.cfg, model.update_block
    cd = cfg.dtype
    n, _, h8, w8 = net.shape
    coords0 = coords_grid(n, h8, w8, device=net.device,
                          row0=0 if spatial is None else spatial.row0(h8))
    coords1 = coords0.clone()
    if flow_init is not None:
        flow_init = torch.as_tensor(flow_init, dtype=torch.float32, device=net.device)
        coords1 = (coords1 + flow_init).contiguous()
    motion_of = _motion_fn(cfg, ub.encoder, levels, n, h8, w8)
    if cfg.small:
        def gru_step(h, motion):
            return ub.gru(h, torch.cat([inp, motion], dim=1))

        def upsample(flow, net):
            return upflow8(flow, spatial)
    else:
        gru_step = ub.gru.fused_step(inp, spatial)

        def upsample(flow, net):
            return convex_upsample(flow, ub.upsample_mask(net).permute(0, 2, 3, 1), spatial)

    def iteration(net, coords1):
        flow = coords1 - coords0
        motion = motion_of(flow.permute(0, 3, 1, 2).to(cd), coords1)
        if aggregate is not None:
            motion = torch.cat([motion, aggregate(motion)], dim=1)
        net = gru_step(net, motion)
        delta = ub.flow_head(net)
        coords1 = (coords1 + delta.float().permute(0, 2, 3, 1)).contiguous()
        if final_only:
            return net, coords1
        return net, coords1, upsample(coords1 - coords0, net)

    def sharded(net, coords1):
        # The layers take the handle in the iteration: a checkpoint's
        # recompute runs in the backward, after the caller's spatial_sharding.
        with spatial_sharding(model, spatial):
            return iteration(net, coords1)

    step = remat_wrap(sharded, remat)
    preds = []
    for _ in range(iters):
        with span("est.update"):
            net, coords1, *pred = step(net, coords1.detach())
        preds += pred
    out = {"flow_low": coords1 - coords0}
    if final_only:
        out["flow_up"] = upsample(coords1 - coords0, net)
    else:
        out["flow_up"] = preds[-1]
        out["predictions"] = torch.stack(preds)
    return out


def _motion_fn(cfg, encoder, levels, n: int, h8: int, w8: int):
    """motion(flow_cd, coords1) -> the motion encoder's output on the
    lookup that cfg.corr_lookup selects (module docstring), for levels (the
    stored pyramid, or OnDemandCorr) of n maps of h8 x w8 queries; coords1
    (n, h8, w8, 2) float32. Flat lookups give convc1 one (n, L*(2r+1)^2,
    h8, w8) input in the compute dtype; split lookups give forward_split or
    forward_stacked their windows."""
    cd, r = cfg.dtype, cfg.radius
    impl = cfg.lookup_impl
    if isinstance(levels, OnDemandCorr):
        def flat(c):  # lookup_corr_kernel on each chunk's rows
            # reshape: at batch > 1 with chunks of one row the windows are a
            # batch-strided view, which no view can flatten.
            return lookup_corr_on_demand(levels, c, r, out_dtype=cd).reshape(n * h8 * w8, -1)
    elif impl in FLAT_LOOKUPS and not (cfg.small and impl == "pallas"):
        def flat(c):
            return lookup_flat(impl, levels, c, r, cd).view(n * h8 * w8, -1)
    elif not cfg.small and (impl in SPLIT_LOOKUPS or cfg.split_levels is not None):
        consume = encoder.forward_stacked if impl in STACKED_LOOKUPS else encoder.forward_split

        def motion(flow_cd, c):
            return consume(flow_cd, split_windows(impl, levels, c, r, cd))
        return motion
    else:
        # Kernel #1 at radius 4 over 4 levels, #2 at every other pair (always
        # for RAFT-small, which maps split spellings here); the kernel writes
        # the compute dtype itself.
        def flat(c):
            return lookup_corr_kernel(levels, c.view(-1, 2), r, out_dtype=cd)

    def motion(flow_cd, c):
        return encoder(flow_cd, flat(c).view(n, h8, w8, -1).permute(0, 3, 1, 2))
    return motion


def _as_images(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def raft_forward(model: RAFT, image1, image2, iters: Optional[int] = None,
                 flow_init=None, final_only: bool = False, spatial=None):
    """Flow image1 -> image2; images (N, H, W, 3). flow_init: optional
    (N, H/8, W/8, 2) warm start. Returns flow_up (N, H, W, 2) float32,
    flow_low (N, H/8, W/8, 2) and, unless final_only, the per-iteration
    upsampled `predictions`. spatial (a parallel.mesh.Spatial handle):
    images, flow_init and the flows are this rank's rows."""
    dev = next(model.parameters()).device
    frames = torch.stack([_as_images(image1, dev), _as_images(image2, dev)])
    return _pairs(model, frames, (0,), (1,), iters, final_only, flow_init, spatial=spatial)


@torch.no_grad()
def raft_pairs_forward(model: RAFT, frames, src_idx, dst_idx,
                       iters: Optional[int] = None, final_only: bool = True, spatial=None):
    """Flow for many (src, dst) frame pairs with deduplicated encodes.

    frames (K, N, H, W, 3); src_idx/dst_idx equal-length index tuples. Each
    used frame is fnet-encoded once and each source frame cnet-encoded once
    (AccFlow's 11 clip queries cost 7 fnet + 6 cnet encodes, not 22 + 11).
    Returns flow_up (P*N, H, W, 2), pairs stacked P-major. spatial: frames
    and flows are this rank's rows (raft_forward)."""
    dev = next(model.parameters()).device
    return _pairs(model, _as_images(frames, dev), src_idx, dst_idx, iters,
                  final_only, spatial=spatial)["flow_up"]


def check_trainable_lookup(cfg) -> None:
    """Raise NotImplementedError for exactly the lookups that JAX cannot
    differentiate, those that reach a Pallas call, which has no autodiff
    rule (accflow_tpu/ops/corr_pallas.py:71-73): experimental:pallas on
    every model (the TPU's lookup_corr_pallas; kernel #2 here), and a split
    spelling with a "bd" level on full RAFT and GMA (y_contract_bd; kernel
    #3 has no backward either, ROADMAP.md #16). RAFT-small maps split
    spellings to its default lookup, which trains. Every other spelling
    trains: the stored and the volume-free (ondemand) lookups through the
    backward kernel, the other experimental ones through autograd of their
    PyTorch ops."""
    if cfg.lookup_impl == "pallas":
        raise NotImplementedError(
            f"corr_lookup={cfg.corr_lookup!r} has no backward in the reference: "
            "lookup_corr_pallas is a Pallas call, which JAX cannot differentiate; train "
            "with corr_lookup 'fused'")
    if "bd" in (cfg.split_levels or ()):
        raise NotImplementedError(
            f"corr_lookup={cfg.corr_lookup!r} has no backward: kernel #3 has none, and "
            "neither has the reference's y_contract_bd, which JAX cannot differentiate "
            "either (ROADMAP.md, queue 3, #16); train with corr_lookup 'fused'")


def raft_train_forward(model: RAFT, image1, image2, iters: Optional[int] = None,
                       flow_init=None, final_only: bool = False, remat: str = "none",
                       spatial=None):
    """raft_forward for training (JAX's forward with train=True): autograd
    records it; the cnet's BatchNorm uses the batch's statistics and keeps
    its running-statistics updates for collect_bn_updates; the pyramid is
    stored in float32; remat ("none", "dots", "full") checkpoints each GRU
    iteration. The lookups that reach a Pallas call in the reference
    (experimental:pallas, a split lookup with a "bd" level) have no
    backward there: NotImplementedError (check_trainable_lookup). spatial: images,
    flow_init and the flows are this rank's rows, as in raft_forward; the
    gathered fnet map's backward returns each key row's gradient (the
    pyramid's, from the lookups' backward on this rank's queries) to its
    owner, and the BatchNorm statistics are the mesh's
    (nn/layers.py::batch_norm_train). Under remat each checkpointed
    iteration re-runs its halo exchanges in the backward, on every rank in
    the same order (nn/remat.py)."""
    check_trainable_lookup(model.cfg)
    dev = next(model.parameters()).device
    frames = torch.stack([_as_images(image1, dev), _as_images(image2, dev)])
    return _pairs(model, frames, (0,), (1,), iters, final_only, flow_init, train=True,
                  remat=remat, spatial=spatial)


def _pairs(model, frames, src_idx, dst_idx, iters, final_only, flow_init=None,
           train: bool = False, remat: str = "none", spatial=None):
    cfg = model.cfg
    iters = cfg.iters if iters is None else iters
    n = frames.shape[1]
    mesh.check_rows(frames.shape[2], spatial)
    with tf32(False), spatial_sharding(model, spatial):
        levels, net_u, inp_u, sel = _encode_pairs(model, frames, src_idx, dst_idx, train,
                                                  spatial)
        return raft_iterate(model, levels, gather_pairs(net_u, sel, n),
                            gather_pairs(inp_u, sel, n), iters, final_only, flow_init,
                            remat=remat, spatial=spatial)


def _encode_pairs(model, frames, src_idx, dst_idx, train: bool = False, spatial=None):
    """The encodes of the pair queries (src_idx[i] -> dst_idx[i]) on frames
    (K, N, H, W, 3), each used frame fnet-encoded once and each source frame
    cnet-encoded once. Returns (levels, net_u, inp_u, sel): the pyramid of
    the P*N pairs (P-major), the cnet state of the S unique source frames
    ((S*N, C, h8, w8) each) and, per pair, the index of its source among
    them (gather_pairs picks the pairs' rows). corr_lookup "auto" is
    resolved at this shape (resolve_auto_lookup): the levels are the stored
    pyramid or the volume-free lookup's operands (build_corr_operands).
    train: the cnet's BatchNorm in batch-statistics mode (raft_train_forward).
    The levels take cfg.level_dtype(train): corr_volume_dtype, or by
    default float32 when training and the compute dtype when inferring.
    spatial: frames are this rank's rows; "auto" is resolved at the global
    shape (every rank takes the same path), the queries are this rank's
    and each target frame's fnet map is gathered once (the whole height:
    the keys)."""
    cfg = model.cfg
    cd = cfg.dtype
    level_dtype = cfg.level_dtype(train)
    src_idx = tuple(int(i) for i in src_idx)
    dst_idx = tuple(int(i) for i in dst_idx)
    k, n, h, w, _ = frames.shape
    h8 = h // 8 if spatial is None else spatial.height(h // 8)
    lookup = resolve_auto_lookup(normalize_corr_lookup(cfg.corr_lookup), len(src_idx) * n,
                                 h8, w // 8, cfg.corr_levels, level_dtype)
    # Frames and per-frame features are picked by concatenating views, not
    # by indexing with Python lists: a list index becomes a host tensor
    # copied to the device at run time, which a CUDA graph cannot capture.
    used = sorted(set(src_idx) | set(dst_idx))
    pos = {f: i for i, f in enumerate(used)}
    fmaps = model.fnet(to_nchw(_select(frames, used).reshape(-1, h, w, 3), cd))
    fmaps = fmaps.view(len(used), n, *fmaps.shape[1:])
    fmap1 = _select(fmaps, [pos[i] for i in src_idx]).flatten(0, 1)
    if spatial is None:
        fmap2 = _select(fmaps, [pos[i] for i in dst_idx]).flatten(0, 1)
    else:
        dst_used = sorted(set(dst_idx))
        full = mesh.gather_rows(_select(fmaps, [pos[i] for i in dst_used]), spatial, dim=3)
        fmap2 = _select(full, [dst_used.index(i) for i in dst_idx]).flatten(0, 1)
    levels = build_corr_operands(fmap1, fmap2, cfg.corr_levels, lookup, dtype=level_dtype)
    del fmaps, fmap1, fmap2

    src_used = sorted(set(src_idx))
    spos = {f: i for i, f in enumerate(src_used)}
    net_u, inp_u = raft_cnet(model, to_nchw(_select(frames, src_used).reshape(-1, h, w, 3), cd),
                             train)
    return levels, net_u, inp_u, [spos[i] for i in src_idx]


def gather_pairs(x_u: torch.Tensor, sel, n: int) -> torch.Tensor:
    """Rows of the unique source frames (S*N, ...) -> the pairs' (P*N, ...):
    pair i takes source sel[i]'s N rows."""
    return _select(x_u.view(-1, n, *x_u.shape[1:]), sel).flatten(0, 1)


def _select(x: torch.Tensor, idx) -> torch.Tensor:
    """x[idx] for a list of ints along dim 0, as one stack of views."""
    return torch.stack([x[i] for i in idx])


@torch.no_grad()
def raft_encode_frame(model: RAFT, image, spatial=None) -> dict:
    """Cacheable per-frame features for streaming (streaming.py): the fnet
    map and the cnet (net, inp) state of (N, H, W, 3) frames. Both encoders
    are per-sample (instance norm, frozen batch norm or none), so encoding
    frames apart is exact against the batched encodes of _pairs. spatial:
    image and the features are this rank's rows."""
    cd = model.cfg.dtype
    x = to_nchw(_as_images(image, next(model.parameters()).device), cd)
    mesh.check_rows(x.shape[2], spatial)
    with tf32(False), spatial_sharding(model, spatial):
        fmap = model.fnet(x)
        net, inp = raft_cnet(model, x)
    return {"fmap": fmap, "net": net, "inp": inp}


@torch.no_grad()
def raft_flow_pairs_from_features(model: RAFT, src: dict, dst_fmaps,
                                  iters: Optional[int] = None, flow_init=None,
                                  final_only: bool = True, spatial=None) -> torch.Tensor:
    """Pair flows src -> each of the P dst maps from precomputed features:
    src is raft_encode_frame of the query frames, dst_fmaps a list of P
    cached fnet maps (the streaming step encodes only the new frame).
    flow_init: optional (P*N, H/8, W/8, 2) warm start. Returns flow_up
    (P*N, H, W, 2), P-major. spatial: the features, flow_init and the flows
    are this rank's rows; the dst maps are gathered in one collective."""
    cfg = model.cfg
    iters = cfg.iters if iters is None else iters
    p = len(dst_fmaps)
    n, _, h8, w8 = src["fmap"].shape
    mesh.check_rows(8 * h8, spatial)
    h8_all = h8 if spatial is None else spatial.height(h8)
    lookup = resolve_auto_lookup(normalize_corr_lookup(cfg.corr_lookup), p * n, h8_all, w8,
                                 cfg.corr_levels, cfg.level_dtype())
    with tf32(False), spatial_sharding(model, spatial):
        levels = build_corr_operands(torch.cat([src["fmap"]] * p),
                                     mesh.gather_rows(torch.cat(list(dst_fmaps)), spatial, dim=2),
                                     cfg.corr_levels, lookup, dtype=cfg.level_dtype())
        net = torch.cat([src["net"]] * p)
        inp = torch.cat([src["inp"]] * p)
        return raft_iterate(model, levels, net, inp, iters, final_only,
                            flow_init, spatial=spatial)["flow_up"]
