"""Weights drawn on the device from the run's seed, in two large draws (one
uniform, one normal, each as long as all parameters together), then
scaled per parameter as the upstream models initialise them:

- the convolutions of the three basic encoders (the feature, context and
  AccFlow context encoders): N(0, 2 / fan_out), kaiming normal;
- every other weight, and every bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
  torch's default, a bias taking its layer weight's fan-in;
- norms: weight 1, bias 0, running mean 0, running variance 1;
- embedding tables: N(0, 1);
- AccPlus's ZeroConv, zero in a fresh model, drawn so that the deformable
  conv deforms (weight 0.05 N, bias 0.5 N, scale 0.1 N), and GMA's gamma,
  zero in a fresh model, U(2, 4) so that the aggregation adds;
- the layers a configuration's `widened` names (parameter name prefix ->
  factor) at that factor times torch's default bound. `accraft` widens the
  accumulator's flow encoder's first conv 4x: the 1/8-scale flows it
  encodes are a few tenths to a few units, so that at the default bound
  its bias and the context carry the cells and the long-range flows lean
  little on the estimator's flows; at 4x an estimator fault, such as a
  lookup window read one cell off, moves the compared flows about twice as
  far beside the program's own rounding (PERF.md §2).

The models are built on the meta device and placed on the card empty, so
nothing is drawn or copied on the host.
"""

from __future__ import annotations

import math

import torch

ENCODERS = ("fnet.", "cnet.", "context.")
SPECIAL = {  # name suffix -> (distribution, scale, shift)
    "accplus.conv2.4.conv.weight": ("normal", 0.05, 0.0),
    "accplus.conv2.4.conv.bias": ("normal", 0.5, 0.0),
    "accplus.conv2.4.scale": ("normal", 0.1, 0.0),
    "update_block.aggregator.gamma": ("uniform01", 2.0, 2.0),
}


def _fan_in(params: dict, name: str) -> int:
    weight = params[name[: -len("bias")] + "weight"] if name.endswith("bias") else params[name]
    return max(weight[0].numel(), 1)


def _rule(name: str, p: torch.Tensor, params: dict, widened: dict):
    """(distribution, scale, shift) of parameter `name`: the value is
    shift + scale * draw, draw from U(-1, 1), U(0, 1), N(0, 1) or the
    constant 1 ("one") or 0 ("zero")."""
    if name in SPECIAL:
        return SPECIAL[name]
    if "norm" in name or ".downsample.1." in name:
        return ("one", 1.0, 0.0) if name.endswith("weight") else ("zero", 0.0, 0.0)
    if "pos_emb" in name:
        return ("normal", 1.0, 0.0)
    if p.dim() >= 2 and name.startswith(ENCODERS):
        fan_out = p.shape[0] * p[0, 0].numel()
        return ("normal", math.sqrt(2.0 / fan_out), 0.0)
    factor = next((f for prefix, f in widened.items() if name.startswith(prefix)), 1.0)
    return ("uniform", factor / math.sqrt(_fan_in(params, name)), 0.0)


@torch.no_grad()
def draw(modules, seed: int, device, widened: dict) -> None:
    """Fill every parameter and buffer of `modules` (nn.Modules already on
    `device`, each with its own parameter names) from `seed`; `widened`:
    the configuration's parameter name prefixes drawn at a factor times
    the default bound."""
    todo = []
    for m in modules:
        params = dict(m.named_parameters())
        todo += [(name, p, params) for name, p in params.items()]
        for name, b in m.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)
    total = sum(p.numel() for _, p, _ in todo)
    gen = torch.Generator(device=device).manual_seed(seed)
    uniform = torch.rand(total, generator=gen, device=device)
    normal = torch.randn(total, generator=gen, device=device)
    start = 0
    for name, p, params in todo:
        dist, scale, shift = _rule(name, p, params, widened)
        k = p.numel()
        if dist == "one":
            p.fill_(1.0)
        elif dist == "zero":
            p.zero_()
        else:
            src = normal[start:start + k] if dist == "normal" else uniform[start:start + k]
            if dist == "uniform":
                src = src * 2 - 1
            p.copy_((src * scale + shift).view_as(p))
        start += k


def snapshot(module: torch.nn.Module) -> dict:
    """A float32 copy of the module's state (name -> tensor) for the
    reference, taken before the program runs."""
    return {k: v.detach().float().clone() for k, v in module.state_dict().items()}
