"""Optimizer and learning-rate schedule of the reference recipe, the port's
counterpart of accflow_tpu/train/optim.py.

train_acc.py:72-87: AdamW(lr, weight_decay, eps) with OneCycleLR(max_lr=lr,
total_steps=num_steps+100, pct_start=0.05, anneal_strategy="linear",
cycle_momentum=False), and global-norm gradient clipping at `clip` before
each update (train_acc.py:231), the order of JAX's optax.chain. JAX builds
torch's two-phase linear OneCycle by hand (onecycle_linear); here it is
torch's own scheduler.
"""

from __future__ import annotations

import torch


class Optimizer:
    """AdamW, its OneCycle schedule and the clip, stepped together."""

    def __init__(self, optimizer: torch.optim.Optimizer, scheduler, clip: float):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.clip = clip

    def params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Clip the gradients to global norm `clip`, update, advance the
        schedule. A parameter that no loss reached (GMA's positional tables
        under content-only attention) gets a zero gradient first: optax
        updates every leaf, AdamW's decay included, where torch's AdamW
        skips a parameter without a gradient."""
        for p in self.params():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch.nn.utils.clip_grad_norm_(self.params(), self.clip)
        self.optimizer.step()
        self.scheduler.step()

    @property
    def lr(self) -> float:
        """The learning rate of the next update (JAX's schedule(count))."""
        return self.optimizer.param_groups[0]["lr"]

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])


def make_optimizer(params, lr: float, num_steps: int, wdecay: float = 1e-5,
                   epsilon: float = 1e-8, clip: float = 1.0,
                   pct_start: float = 0.05) -> Optimizer:
    """AdamW(betas 0.9, 0.999) + linear OneCycle over num_steps + 100 +
    global-norm clip over `params`."""
    opt = torch.optim.AdamW(list(params), lr=lr, betas=(0.9, 0.999), eps=epsilon,
                            weight_decay=wdecay)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        opt, max_lr=lr, total_steps=num_steps + 100, pct_start=pct_start,
        anneal_strategy="linear", cycle_momentum=False,
    )
    return Optimizer(opt, sched, clip)
