"""Data parallelism over torch.distributed, the port's counterpart of
accflow_tpu/parallel/mesh.py.

JAX runs one SPMD program over a device mesh: batch-sharded inputs,
replicated parameters, and the psums GSPMD inserts (the gradient mean, and
train-mode BatchNorm's statistics over the global batch). The port runs one
process per GPU (torchrun), each with the same program on its rows of the
global batch:

- every rank draws the same global batch from the same seeded loader and
  keeps its own rows (shard_batch);
- the gradients are averaged over ranks before the clip and the update
  (average_gradients, from train/optim.py), and the loss and metrics too
  (all_mean);
- train-mode BatchNorm reduces its mean and variance over the global batch
  (nn/layers.py::batch_norm_train), so every rank moves its running
  statistics the same way;
- per-sample metrics are gathered onto every rank (host_array);
- rank 0 alone writes logs, PNGs, TensorBoard and checkpoints, after a
  barrier (is_main_process, sync_processes).

The engines own the data-parallel decision: train_acc and fine_tune take
data_group() and hand it to their step builders, which pass it on to the
optimizer's update, the BatchNorm layers (layers.batch_norm_group) and the
noise draw, as flax passes an axis_name. Those collectives take their group
explicitly, and None (one process) is the identity: no layer reads the
global process group.

On the card the collectives are NCCL's, captured inside a train step's CUDA
graph (graphs.CudaGraphedStep); on the CPU they are gloo's, eagerly. The
mesh's `spatial` axis (height sharding with halo exchanges, JAX's
hi-res serving and streaming) is not ported: ROADMAP.md queue 1, #12.

Without a process group every function is the single-process identity, and
the engines' outputs are those of the code before this module existed.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def active() -> bool:
    """True when a default process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def maybe_init_distributed(device=None, backend: Optional[str] = None) -> bool:
    """Join a torchrun job when the environment says so; a single process
    is a no-op. Triggers: torchrun's environment (WORLD_SIZE > 1 with RANK,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT), or ACCFLOW_DISTRIBUTED=1 with
    that environment (a world of one). The backend is NCCL for a CUDA
    `device` (the card LOCAL_RANK, made current) and gloo for the CPU, unless
    `backend` names one. Returns True when a process group is active
    (already, or now)."""
    if active():
        return True
    env = os.environ
    asked = env.get("ACCFLOW_DISTRIBUTED", "").lower() in ("1", "true")
    if int(env.get("WORLD_SIZE", "1")) <= 1 and not asked:
        return False
    missing = [k for k in ("WORLD_SIZE",) + _TORCHRUN_ENV if k not in env]
    if missing:
        raise ValueError(f"a distributed launch needs torchrun's environment; {missing} "
                         "are not set")
    dev = torch.device("cuda" if device is None else device)
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend != "nccl":
        kw.pop("device_id", None)
    dist.init_process_group(backend, init_method="env://", world_size=int(env["WORLD_SIZE"]),
                            rank=int(env["RANK"]), **kw)
    return True


def is_main_process() -> bool:
    """True on the one process that owns host-side side effects (result
    files, PNGs, log files, TensorBoard, checkpoints, run-dir archiving)."""
    return rank() == 0


def sync_processes(tag: str = "sync") -> None:
    """A barrier across ranks (no-op in one process): no rank touches a run
    dir while rank 0 is still archiving or creating it. `tag` names the
    point for a reader of the code; the barrier does not carry it."""
    del tag
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def data_group():
    """The process group of the data-parallel axis (the whole world) when
    one is active, else None: what the engines give their step builders."""
    return dist.group.WORLD if active() else None


def collectives_capturable() -> bool:
    """Whether a CUDA graph may capture this process's collectives: always
    without a process group, and with NCCL's; gloo runs eagerly."""
    return not active() or dist.get_backend() == "nccl"


class Mesh(NamedTuple):
    """The world's layout: `data` ranks, each holding the whole image
    (`spatial` is 1), and this process's rank."""
    data: int
    spatial: int
    rank: int


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1) -> Mesh:
    """The data-parallel layout of the process group (one rank per GPU).
    n_spatial > 1 (height sharding) raises NotImplementedError."""
    if n_spatial != 1:
        raise NotImplementedError(
            "the mesh's spatial axis (height sharding with halo exchanges) is not ported: "
            "ROADMAP.md queue 1, #12")
    if n_data is not None and n_data != world_size():
        raise ValueError(f"n_data={n_data}: the process group has {world_size()} ranks")
    return Mesh(world_size(), 1, rank())


def local_rows(n: int) -> slice:
    """This rank's rows of a global batch of n; the world must divide n."""
    world = world_size()
    if n % world:
        raise ValueError(f"a global batch of {n} does not split over {world} ranks")
    per = n // world
    return slice(rank() * per, (rank() + 1) * per)


def shard_batch(batch):
    """This rank's rows of a global batch: an array or tensor, or a dict of
    them, batch on axis 0."""
    if isinstance(batch, dict):
        return {k: shard_batch(v) for k, v in batch.items()}
    return batch[local_rows(batch.shape[0])]


@torch.no_grad()
def shard_params(module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (a broadcast), in
    place; the same module in one process."""
    if world_size() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def _flat_mean(tensors, group) -> None:
    """Average `tensors` over the ranks of `group` in place, through one
    flat buffer per dtype (one collective, NCCL-capturable)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat.div_(dist.get_world_size(group))
        offset = 0
        for t in ts:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


def average_gradients(params, group) -> None:
    """The mean of every parameter's .grad over the ranks of `group`, in
    place (a world of one included: the collective is then an exact copy);
    nothing for group None."""
    if group is not None:
        _flat_mean([p.grad for p in params if p.grad is not None], group)


def all_mean(tree, group):
    """The mean over the ranks of `group` of a dict, tuple or list of 0-d
    tensors (a step's loss and metrics), as new tensors; the input
    unchanged for group None."""
    if group is None:
        return tree
    leaves, spec = torch.utils._pytree.tree_flatten(tree)
    flat = torch.stack([x.detach().float().reshape(()) for x in leaves])
    dist.all_reduce(flat, group=group)
    flat = flat / dist.get_world_size(group)
    return torch.utils._pytree.tree_unflatten(list(flat.unbind(0)), spec)


class _GlobalSum(torch.autograd.Function):
    """The sum over the ranks of a group; its gradient is the sum over
    ranks of the gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the ranks of `group` (not None), differentiable,
    as GSPMD's psum."""
    return _GlobalSum.apply(t, group)


def host_array(t) -> np.ndarray:
    """Each rank's slice of a per-sample vector (batch on axis 0, the same
    length on every rank) gathered in rank order into the whole vector, as
    numpy on every rank. A collective: every rank calls it at the same
    point. gloo gathers on the host."""
    t = torch.as_tensor(t).detach()
    if world_size() == 1:
        return t.cpu().numpy()
    if dist.get_backend() != "nccl":
        t = t.cpu()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy()
