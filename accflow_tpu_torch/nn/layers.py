"""NN layers of the port (NCHW), counterpart of accflow_tpu/nn/layers.py.

Each layer is a functional form (what the tests hold against JAX) plus a
small `nn.Module` that owns its parameters under the reference torch
`state_dict` names (`weight`, `bias`, `running_mean`, `running_var`,
ZeroConv2d's `conv.*` and `scale`, Embedding's `weight`), so `convert.py`
maps them 1:1 onto the JAX param tree.

Parameters are kept in float32 and cast to the input's dtype at each call,
as the JAX `conv2d` does: the compute dtype is a property of the
activations, not of the module.

Initialisers reproduce the JAX package's (which reproduce torch's), drawn
from a `torch.Generator` passed to `reset_parameters`:
- "torch": weight and bias U(-1/sqrt(fan_in), +1/sqrt(fan_in));
- "kaiming_normal_out": weight N(0, 2/fan_out), bias as "torch";
- "zeros";
and Embedding's table N(0, 1).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from accflow_tpu_torch.parallel import mesh


@contextlib.contextmanager
def tf32(enabled: bool):
    """Set both TF32 switches for the block and restore them afterwards:
    `torch.backends.cuda.matmul.allow_tf32` (cuBLAS float32 matmuls) and
    `torch.backends.cudnn.allow_tf32` (cuDNN float32 convolutions; on by
    default in PyTorch). They are process-wide. Float32 math on the card is
    exact only with both off; TF32 keeps 10 mantissa bits, so it is exact
    for products of bfloat16-valued operands (7 bits)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Functional forms
# ---------------------------------------------------------------------------

def conv2d(x, weight, bias=None, stride: int = 1, padding=None, spatial=None):
    """NCHW conv in x's dtype; weight (O, I, kh, kw). padding defaults to
    torch-style 'same for odd kernels' ((k-1)//2 per side).

    spatial (a parallel.mesh.Spatial handle): x is this rank's rows of the
    image and so is the output. A kernel taller than one row reads the
    halo rows its output rows need from the ranks above and below
    (mesh.halo_rows: zeros past the image's edges, as the padding) and
    runs with no vertical padding. Output row o reads input rows
    o*stride - p .. o*stride - p + kh - 1, so the halo is p rows above and
    kh - stride - p below: 3 and 2 for a 7x7/2 conv, 1 and 0 for a 3x3/2,
    none for a 1x1/2 (local heights are even wherever a stride is 2)."""
    kh, kw = weight.shape[-2:]
    if padding is None:
        padding = ((kh - 1) // 2, (kw - 1) // 2)
    b = None if bias is None else bias.to(x.dtype)
    if spatial is not None and kh > 1:
        ph, pw = padding
        above, below = mesh.halo_rows(x, spatial, ph, max(kh - stride - ph, 0))
        x, padding = torch.cat([above, x, below], dim=2), (0, pw)
    return F.conv2d(x, weight.to(x.dtype), b, stride, padding)


def instance_norm(x: torch.Tensor, eps: float = 1e-5, spatial=None) -> torch.Tensor:
    """Per-(sample, channel) normalisation over H, W with no affine, eps
    1e-5 and biased variance (nn.InstanceNorm2d defaults). Statistics and
    the normalisation run in float32; the result takes x's dtype.

    spatial: x is this rank's rows, and the statistics are those of the
    whole image (whole_image_stats)."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(2, 3), keepdim=True, unbiased=False)
    if spatial is not None:
        mean, var = whole_image_stats(mean, var, x.shape[2], spatial)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def whole_image_stats(mean, var, rows: int, spatial):
    """The whole image's mean and biased variance from this rank's, over
    `rows` rows of the image: each rank's gathered and combined by the
    parallel variance formula, mean = sum_r w_r mean_r and var = sum_r w_r
    (var_r + (mean_r - mean)^2), w_r the rank's share of the rows (as
    batch_norm_train's spatial path)."""
    means, variances = mesh.stack_ranks(torch.stack([mean, var]), spatial).unbind(1)
    blocks = spatial.blocks(rows)
    share = [b / sum(blocks) for b in blocks]
    mean = sum(w * m for w, m in zip(share, means.unbind(0)))
    var = sum(w * (v + (m - mean) ** 2)
              for w, m, v in zip(share, means.unbind(0), variances.unbind(0)))
    return mean, var


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
               eps: float = 1e-5, spatial=None) -> torch.Tensor:
    """Per-(sample, group) normalisation over the group's channels and H, W,
    then the per-channel affine map (accflow_tpu/nn/layers.py::group_norm,
    nn.GroupNorm): biased variance, eps 1e-5. Statistics, normalisation and
    affine map run in float32; the result takes x's dtype. JAX computes it
    outside any kernel, and so does this (plain tensor ops).

    spatial: x is this rank's rows, and the statistics are those of the
    whole image (whole_image_stats)."""
    n, c, h, w = x.shape
    xf = x.float().reshape(n, num_groups, c // num_groups, h, w)
    var, mean = torch.var_mean(xf, dim=(2, 3, 4), keepdim=True, unbiased=False)
    if spatial is not None:
        mean, var = whole_image_stats(mean, var, h, spatial)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, c, h, w)
    return (y * weight.float().view(1, -1, 1, 1) + bias.float().view(1, -1, 1, 1)).to(x.dtype)


def batch_norm(x, weight, bias, running_mean, running_var, eps: float = 1e-5):
    """Frozen (eval-mode) BatchNorm2d: the affine map from the running
    statistics, folded in float32 and applied in x's dtype."""
    scale = weight * torch.rsqrt(running_var + eps)
    shift = bias - running_mean * scale
    return x * scale.to(x.dtype).view(1, -1, 1, 1) + shift.to(x.dtype).view(1, -1, 1, 1)


def batch_norm_train(x, weight, bias, running_mean, running_var, eps: float = 1e-5,
                     momentum: float = 0.1, group=None, spatial=None):
    """Train-mode BatchNorm2d (accflow_tpu/nn/layers.py::batch_norm with
    train=True): x normalised with its batch's statistics over (N, H, W),
    taken in float32 with the biased variance, the affine map applied in
    float32 and the result cast to x's dtype. Returns (y, new_mean,
    new_var): the running statistics moved by `momentum` towards the
    batch's, running_var with the unbiased variance, detached. They are
    returned, not applied: a train step applies them once, after its update
    (collect_bn_updates / apply_bn_updates), and F.batch_norm's in-place
    update would move them once per micro-batch.

    With a process `group` (the caller's data-parallel axis, parallel/mesh.py)
    the statistics are those of the group's global batch, as under JAX's
    GSPMD: each rank's own (every rank holds as many samples), combined by
    the parallel variance formula, mean = E_r[mean_r] and var = E_r[var_r +
    (mean_r - mean)^2], through a differentiable sum over ranks; every rank
    then normalises alike and moves its running statistics alike (a group
    of one gives the local statistics' bits). With group None the local
    statistics are all that runs, whatever process group is active.

    With a `spatial` handle x is this rank's rows of its samples, whose
    blocks may differ by 8-row multiples: the same formula weighs each
    rank's statistics by its share of the elements, w_r = its rows over
    n_data x the global height (mean = sum_r w_r mean_r, var = sum_r w_r
    (var_r + (mean_r - mean)^2)), over the ranks of the spatial group, or
    of the whole mesh (data x spatial: mesh.mesh_sum) when a data `group`
    is given too; the running variance's n / (n - 1) takes the global
    element count."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
    n = x.shape[0] * x.shape[2] * x.shape[3]
    if spatial is not None:
        n_data = 1 if group is None else torch.distributed.get_world_size(group)
        height = spatial.height(x.shape[2])
        n = x.shape[0] * n_data * height * x.shape[3]
        share = x.shape[2] / (n_data * height)
        local_mean = mean
        mean = mesh.mesh_sum(share * local_mean, group, spatial)
        var = mesh.mesh_sum(share * (var + (local_mean - mean) ** 2), group, spatial)
    elif group is not None:
        world = torch.distributed.get_world_size(group)
        n *= world
        local_mean = mean
        mean = mesh.global_sum(local_mean, group) / world
        var = mesh.global_sum(var + (local_mean - mean) ** 2, group) / world
    with torch.no_grad():
        new_mean = (1.0 - momentum) * running_mean + momentum * mean
        new_var = (1.0 - momentum) * running_var + momentum * var * (n / max(n - 1, 1))
    scale = weight * torch.rsqrt(var + eps)
    shift = bias - mean * scale
    return (xf * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)).to(x.dtype), new_mean, new_var


def zero_conv2d(x, weight, bias, scale, spatial=None):
    """ZeroConv2d (networks/modules.py:81-97): conv3x3(x) * exp(3 * scale);
    scale broadcasts over channels ((C,) or (1, C, 1, 1))."""
    out = conv2d(x, weight, bias, spatial=spatial)
    return out * torch.exp(scale.to(out.dtype).reshape(1, -1, 1, 1) * 3.0)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Conv2d(nn.Module):
    """Conv with torch-style same padding, computing in its input's dtype.
    `spatial` (spatial_sharding) is the handle of the rows it is given,
    None for the whole image."""

    def __init__(self, cin: int, cout: int, ksize, stride: int = 1,
                 bias: bool = True, init: str = "torch"):
        super().__init__()
        kh, kw = (ksize, ksize) if isinstance(ksize, int) else ksize
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride = stride
        self.init = init
        self.spatial = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        cout, cin, kh, kw = self.weight.shape
        if self.init == "zeros":
            self.weight.zero_()
            if self.bias is not None:
                self.bias.zero_()
            return
        bound = math.sqrt(1.0 / (cin * kh * kw))
        if self.init == "torch":
            self.weight.uniform_(-bound, bound, generator=generator)
        elif self.init == "kaiming_normal_out":
            self.weight.normal_(0.0, math.sqrt(2.0 / (cout * kh * kw)),
                                generator=generator)
        else:
            raise ValueError(self.init)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, spatial=self.spatial)


class BatchNorm2d(nn.Module):
    """BatchNorm2d: parameters `weight`/`bias`, buffers
    `running_mean`/`running_var` (the reference's names, without
    `num_batches_tracked`, which neither mode reads). By default it is
    frozen and applies the running statistics, whatever torch's training
    flag says; with `batch_stats` set (`batch_statistics`) it applies the
    batch's, as torch's model.train() does, and keeps the moved running
    statistics in `new_stats` until collect_bn_updates takes them; `group`
    (batch_norm_group) is the process group its batch statistics reduce
    over, None for this process's batch, and `spatial` (spatial_sharding)
    the handle of the rows it is given, whose statistics it combines with
    the other ranks' (batch_norm_train). AdamW never sees the buffers: they
    are not parameters."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.batch_stats = False
        self.new_stats = None
        self.group = None
        self.spatial = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator  # deterministic, as init_batch_norm
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        if not self.batch_stats:
            return batch_norm(x, self.weight, self.bias, self.running_mean,
                              self.running_var)
        y, mean, var = batch_norm_train(x, self.weight, self.bias, self.running_mean,
                                        self.running_var, group=self.group,
                                        spatial=self.spatial)
        self.new_stats = (mean, var)
        return y


@contextlib.contextmanager
def batch_statistics(module: nn.Module, enabled: bool = True):
    """With `enabled`, the BatchNorm2d layers of `module` normalise with
    their batch's statistics within the block (torch's model.train(), what
    the reference fine-tunes with), and are frozen again afterwards. The
    other layers have no training mode."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.batch_stats = enabled
    try:
        yield
    finally:
        for m in bns:
            m.batch_stats = False


@contextlib.contextmanager
def batch_norm_group(module: nn.Module, group):
    """Within the block, the BatchNorm2d layers of `module` reduce their
    batch statistics over the ranks of the process group `group` (None:
    this process's batch alone), as flax's BatchNorm reduces over its
    axis_name: a train step that runs data-parallel passes its group here.
    Under a spatial handle (spatial_sharding) a group stands for its ranks'
    whole mesh, data x spatial (batch_norm_train)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.group = group
    try:
        yield
    finally:
        for m in bns:
            m.group = None


@contextlib.contextmanager
def spatial_sharding(module: nn.Module, spatial):
    """Within the block, the layers of `module` that read a spatial handle
    (those with a `spatial` attribute: Conv2d, InstanceNorm2d and
    BatchNorm2d) are given `spatial`, the
    parallel.mesh.Spatial handle of the rows they are given, as
    batch_norm_group gives BatchNorm2d its group, and get back what they
    had after it; None, this process's whole image, leaves them as they
    are."""
    if spatial is None:
        yield
        return
    layers = [(m, m.spatial) for m in module.modules() if hasattr(m, "spatial")]
    for m, _ in layers:
        m.spatial = spatial
    try:
        yield
    finally:
        for m, prev in layers:
            m.spatial = prev


def collect_bn_updates(model: nn.Module) -> dict:
    """Take the moved running statistics that BatchNorm2d layers of `model`
    kept from their last forward under batch_statistics: {layer name: (mean,
    var)} (accflow_tpu/nn/layers.py::collect_bn_updates)."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm2d) and m.new_stats is not None:
            out[name] = m.new_stats
            m.new_stats = None
    return out


@torch.no_grad()
def apply_bn_updates(model: nn.Module, updates: dict) -> None:
    """Write collect_bn_updates' statistics into the layers' buffers
    (accflow_tpu/nn/layers.py::apply_bn_updates), in place: a train step
    captured in a CUDA graph moves them on every replay."""
    for name, (mean, var) in updates.items():
        m = model.get_submodule(name)
        m.running_mean.copy_(mean)
        m.running_var.copy_(var)


class InstanceNorm2d(nn.Module):
    """nn.InstanceNorm2d defaults (no parameters); `spatial` as Conv2d's."""

    def __init__(self):
        super().__init__()
        self.spatial = None

    def forward(self, x):
        return instance_norm(x, spatial=self.spatial)


class GroupNorm2d(nn.Module):
    """nn.GroupNorm's parameters `weight` and `bias` (JAX's `scale` and
    `bias`; ones and zeros at init), `num_groups` groups; `spatial` as
    Conv2d's. It keeps no running state, so train and eval mode are one
    (accflow_tpu/nn/layers.py::apply_norm)."""

    def __init__(self, num_groups: int, num_features: int):
        super().__init__()
        if num_groups < 1 or num_features % num_groups:
            raise ValueError(f"{num_features} channels do not split into {num_groups} groups")
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.spatial = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator  # deterministic, as init_group_norm
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.num_groups, spatial=self.spatial)


class ZeroConv2d(nn.Module):
    """3x3 conv scaled by exp(3 * scale), zero at init (AccPlus offsets)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, init="zeros")
        self.scale = nn.Parameter(torch.zeros(1, cout, 1, 1))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        self.scale.zero_()

    def forward(self, x):
        return zero_conv2d(x, self.conv.weight, self.conv.bias, self.scale, self.conv.spatial)


class Embedding(nn.Module):
    """A lookup table `weight` (num, dim), N(0, 1) at init as nn.Embedding
    (GMA's RelPosEmb tables, rel_height / rel_width); indexed directly by
    its user."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, 1.0, generator=generator)


def make_norm(norm_fn: str, num_features: int, num_groups: int = 8) -> nn.Module:
    """The encoders' norm modes: "instance" and "none" carry no parameters
    (and so no state_dict keys), "batch" is BatchNorm2d, "group" GroupNorm2d
    with `num_groups` groups (accflow_tpu/nn/layers.py::init_norm)."""
    if norm_fn == "batch":
        return BatchNorm2d(num_features)
    if norm_fn == "group":
        return GroupNorm2d(num_groups, num_features)
    if norm_fn == "instance":
        return InstanceNorm2d()
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(norm_fn)


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Re-initialise every layer of `module` from one torch.Generator
    seeded with `seed`, in module registration order (CPU generator: the
    same seed gives the same weights whatever the device)."""
    gen = torch.Generator().manual_seed(seed)
    for sub in module.modules():
        reset = getattr(sub, "reset_parameters", None)
        if reset is None:
            continue
        if any(p.device.type != "cpu" for p in sub.parameters(recurse=False)):
            raise ValueError("init_weights runs before the module is moved to its device")
        reset(gen)
    return module
