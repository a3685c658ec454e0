"""Optimizer and learning-rate schedule of the reference recipe, the port's
counterpart of accflow_tpu/train/optim.py.

train_acc.py:72-87: AdamW(lr, weight_decay, eps) with OneCycleLR(max_lr=lr,
total_steps=num_steps+100, pct_start=0.05, anneal_strategy="linear",
cycle_momentum=False), and global-norm gradient clipping at `clip` before
each update (train_acc.py:231), the order of JAX's optax.chain. JAX builds
torch's two-phase linear OneCycle by hand (onecycle_linear); here it is
torch's own scheduler.

On CUDA parameters the update can be captured in a CUDA graph
(graphs.CudaGraphedStep): AdamW runs with capturable=True (its step counts
and bias corrections stay on the device) and the learning rate is a 0-d
float32 tensor on the device, which OneCycleLR writes in place (fill_)
after each update, outside the graph. On the CPU the learning rate stays a
Python float and AdamW runs as torch's default for CPU tensors.
"""

from __future__ import annotations

import torch

from accflow_tpu_torch.parallel import mesh


class Optimizer:
    """AdamW, its OneCycle schedule and the clip. step() is update() then
    advance(); a graphed train step captures update() and calls advance()
    after each replay."""

    def __init__(self, optimizer: torch.optim.Optimizer, scheduler, clip: float):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.clip = clip

    def params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def update(self, group=None, spatial=None) -> None:
        """Clip the gradients to global norm `clip` and update. A parameter
        that no loss reached (GMA's positional tables under content-only
        attention) gets a zero gradient first: optax updates every leaf,
        AdamW's decay included, where torch's AdamW skips a parameter
        without a gradient. The gradients are made the mesh's first, once,
        before the clip, by one collective (parallel.mesh.average_gradients,
        as GSPMD's gradient mean): with a process `group` (the caller's
        data-parallel axis) averaged over its ranks; with a spatial handle
        (each rank holding the gradient of its part of the loss,
        train/loss.py) summed over its ranks as well. Every rank then clips
        and updates the same bits. No host synchronisation."""
        for p in self.params():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        mesh.average_gradients(self.params(), group, spatial)
        torch.nn.utils.clip_grad_norm_(self.params(), self.clip)
        self.optimizer.step()

    def advance(self) -> None:
        """Advance the schedule: the learning rate of the next update."""
        self.scheduler.step()

    def step(self, group=None, spatial=None) -> None:
        self.update(group, spatial)
        self.advance()

    @property
    def lr(self) -> float:
        """The learning rate of the next update (JAX's schedule(count)); a
        device rate is read back to the host."""
        return float(self.optimizer.param_groups[0]["lr"])

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Load a state_dict. A device learning rate keeps its tensor (the
        one a captured update reads) and takes the loaded value; load before
        the first capture, which fixes the optimizer's state tensors."""
        rates = [g["lr"] for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(state["optimizer"])
        for group, rate in zip(self.optimizer.param_groups, rates):
            if isinstance(rate, torch.Tensor):
                group["lr"] = rate.fill_(float(group["lr"]))
        self.scheduler.load_state_dict(state["scheduler"])


def one_cycle(optimizer: torch.optim.Optimizer, lr: float, num_steps: int,
              pct_start: float = 0.05):
    """The recipe's linear OneCycle over num_steps + 100 steps."""
    return torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=lr, total_steps=num_steps + 100, pct_start=pct_start,
        anneal_strategy="linear", cycle_momentum=False,
    )


def make_optimizer(params, lr: float, num_steps: int, wdecay: float = 1e-5,
                   epsilon: float = 1e-8, clip: float = 1.0,
                   pct_start: float = 0.05) -> Optimizer:
    """AdamW(betas 0.9, 0.999) + linear OneCycle over num_steps + 100 +
    global-norm clip over `params`; capturable, with the learning rate a
    device tensor, on CUDA parameters (module docstring)."""
    params = list(params)
    dev = params[0].device
    capturable = dev.type == "cuda"
    rate = torch.tensor(lr, dtype=torch.float32, device=dev) if capturable else lr
    opt = torch.optim.AdamW(params, lr=rate, betas=(0.9, 0.999), eps=epsilon,
                            weight_decay=wdecay, capturable=capturable)
    return Optimizer(opt, one_cycle(opt, lr, num_steps, pct_start), clip)
