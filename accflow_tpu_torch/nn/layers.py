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

def conv2d(x, weight, bias=None, stride: int = 1, padding=None):
    """NCHW conv in x's dtype; weight (O, I, kh, kw). padding defaults to
    torch-style 'same for odd kernels' ((k-1)//2 per side)."""
    kh, kw = weight.shape[-2:]
    if padding is None:
        padding = ((kh - 1) // 2, (kw - 1) // 2)
    b = None if bias is None else bias.to(x.dtype)
    return F.conv2d(x, weight.to(x.dtype), b, stride, padding)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, channel) normalisation over H, W with no affine, eps
    1e-5 and biased variance (nn.InstanceNorm2d defaults). Statistics and
    the normalisation run in float32; the result takes x's dtype."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(2, 3), keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def batch_norm(x, weight, bias, running_mean, running_var, eps: float = 1e-5):
    """Frozen (eval-mode) BatchNorm2d: the affine map from the running
    statistics, folded in float32 and applied in x's dtype."""
    scale = weight * torch.rsqrt(running_var + eps)
    shift = bias - running_mean * scale
    return x * scale.to(x.dtype).view(1, -1, 1, 1) + shift.to(x.dtype).view(1, -1, 1, 1)


def zero_conv2d(x, weight, bias, scale):
    """ZeroConv2d (networks/modules.py:81-97): conv3x3(x) * exp(3 * scale);
    scale broadcasts over channels ((C,) or (1, C, 1, 1))."""
    out = conv2d(x, weight, bias)
    return out * torch.exp(scale.to(out.dtype).reshape(1, -1, 1, 1) * 3.0)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Conv2d(nn.Module):
    """Conv with torch-style same padding, computing in its input's dtype."""

    def __init__(self, cin: int, cout: int, ksize, stride: int = 1,
                 bias: bool = True, init: str = "torch"):
        super().__init__()
        kh, kw = (ksize, ksize) if isinstance(ksize, int) else ksize
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride = stride
        self.init = init

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
        return conv2d(x, self.weight, self.bias, self.stride)


class BatchNorm2d(nn.Module):
    """Frozen BatchNorm2d: parameters `weight`/`bias`, buffers
    `running_mean`/`running_var` (the reference's names, without
    `num_batches_tracked`, which eval mode never reads)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator  # deterministic, as init_batch_norm
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var)


class InstanceNorm2d(nn.Module):
    """nn.InstanceNorm2d defaults (no parameters)."""

    def forward(self, x):
        return instance_norm(x)


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
        return zero_conv2d(x, self.conv.weight, self.conv.bias, self.scale)


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


def make_norm(norm_fn: str, num_features: int) -> nn.Module:
    """The encoders' norm modes: "instance" and "none" carry no parameters
    (and so no state_dict keys), "batch" is frozen BatchNorm2d."""
    if norm_fn == "batch":
        return BatchNorm2d(num_features)
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
