"""Data and spatial parallelism over torch.distributed, the port's
counterpart of accflow_tpu/parallel/mesh.py.

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
  (nn/layers.py::batch_norm_train; under a spatial handle over the whole
  mesh, each rank weighted by its elements: mesh_sum), so every rank moves
  its running statistics the same way;
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
graph (graphs.CudaGraphedStep); on the CPU they are gloo's, eagerly.

The mesh's `spatial` axis shards image height (JAX's hi-res serving,
streaming, and height-sharded accumulator training and fine-tuning, where
GSPMD inserts the halo exchanges and gathers). make_mesh(n_data, n_spatial) lays the ranks
out as JAX's reshape(n_data, n_spatial): a spatial group is n_spatial
consecutive ranks, and each rank gets a `Spatial` handle. Every rank holds
its own block of rows of the frames and of every activation (shard_rows):
the frame height's 1/8-scale rows split as evenly as possible, the first
ranks one more (split_rows; a handle given the height by
`Spatial.at_height` carries the table, one without it splits evenly), so
every block starts on a multiple of 8 rows at full resolution and the
stride-2 convs line up. The model code writes out what GSPMD inserts, each
through the handle it is given:
- a conv reads `halo_rows` above and below its rows (nn/layers.py::conv2d);
- instance norm combines the ranks' statistics, weighted by their pixels
  (`stack_ranks`);
- the correlation's keys, a backward warp's source, the deformable conv's
  input, GMA's attention keys and values are the whole height
  (`gather_rows`), the queries this rank's own;
- a forward splat sums the ranks' full-height splats (`sum_ranks`).
The collectives are all_gather and all_reduce. Under NCCL an all_gather
fills one (size, ...) tensor on the device (all_gather_into_tensor); under
gloo, which takes CUDA tensors in all_reduce but not in all_gather, it is
staged through the host. Unequal blocks are padded to the largest and
trimmed after, so every call sees static shapes. `collectives` and
`bytes_sent` count them, in the forward and in the backward alike.

Every exchange is differentiable, as GSPMD's transpose of it is. Each rank
back-propagates its own part of the loss (train/loss.py: its pixels' sum
over the global count), so the gradient of a tensor another rank read is
the sum of what every rank's part sends back: stack_ranks' backward
all-reduces the stacked gradient over the group and keeps this rank's
slice (a halo row's gradient returns to the rank that owns the row, a
gathered block's to its owner, instance norm's statistics' to each rank),
and sum_ranks' backward all-reduces the gradient. The ranks' parameter
gradients are then summed over the spatial group and averaged over the
data group, in one all_reduce over the world divided by n_data
(average_gradients with the handle, from train/optim.py).
Every rank builds the same graph in the same order, so the backward's
collectives line up (and a rematerialised cell re-runs its forward's in the
same order on each).
Full RAFT, RAFT-small and GMA take a handle in every inference entry
point and in their training forward (train/finetune.py::make_finetune_step:
each rank's queries against the gathered keys, the lookups' backward on
them, the key-side gradient summed back to its owner by the gather's
backward, train-mode BatchNorm over the mesh), AccFlow in each clip path
and in its training forward (train/engine.py::make_acc_train_step). The
engines (train_acc, fine_tune) stay data-parallel, as JAX's do.

Graphs. As JAX jits a height-sharded program with GSPMD's collectives in
it, the port captures a sharded step in a CUDA graph (graphs.py) with its
exchanges in it: StreamAccumulator's push, a sharded clip in CudaGraphed,
and the train steps of make_acc_train_step / make_finetune_step(graphed=
True, spatial=) in CudaGraphedStep. What makes that hold:
- NCCL only. A graph captures NCCL's collectives; gloo's are host-staged
  and cannot be captured. collectives_capturable(group) says which;
  graphs given a group refuse gloo on the card (require_capturable: a
  ValueError that names the backend), and every collective here raises
  the same where a capture is under way on a gloo group.
- No host copy in a capture: every collective's buffers are made on the
  device, and _halo_index's tables (a copy from a host list) are cached
  by the eager warm-ups that precede each capture, so a capture finds
  them there.
- A group's NCCL communicator may be made at its first collective
  (make_mesh's groups): a graph's warm-ups run that, never the capture.
- The counters are Python: a replay runs none of the code that adds to
  them. Each graph records what its capture counted and adds it on every
  replay (graphs._Graph), so a graphed call counts what an eager call
  counts; nothing reads the counters inside a graph.
- graphs.CAPTURE_LOCK is held by every capture (a graphed NCCL fine-tune
  without it failed twice, cause unknown).

Without a process group every function is the single-process identity, and
the engines' outputs are those of the code before this module existed.
"""

from __future__ import annotations

import functools
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


def collectives_capturable(group=None) -> bool:
    """Whether a CUDA graph may capture the collectives of `group` (None:
    the default group): always without a process group, and with NCCL's;
    gloo runs eagerly."""
    return not active() or dist.get_backend(group) == "nccl"


def require_capturable(group=None) -> None:
    """ValueError unless a CUDA graph may capture the collectives of
    `group` (collectives_capturable): gloo stages them through the host."""
    if not collectives_capturable(group):
        raise ValueError(f"a CUDA graph cannot capture {dist.get_backend(group)}'s collectives "
                         "(gloo stages them through the host): graphs need NCCL, one rank per "
                         "card; run the step eagerly (graphed=False)")


def _no_capture_on(group) -> None:
    """require_capturable(group) while a CUDA graph is being captured on
    this thread's stream: a collective of gloo's never reaches a capture."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        require_capturable(group)


def split_rows(height: int, n: int) -> tuple:
    """Each of n ranks' rows of a frame height, top to bottom: the 1/8-scale
    rows split as evenly as possible, the first ranks one more, times 8
    (1024x440 over 2: 224 + 216; 48 over 4: 16, 16, 8, 8). ValueError where
    the height is not a multiple of 8, or has fewer rows at 1/8 than ranks."""
    if height % 8:
        raise ValueError(f"a height of {height} is not a multiple of 8: the spatial axis splits "
                         "the frames into blocks of 8-row multiples")
    h8 = height // 8
    if h8 < n:
        raise ValueError(f"a height of {height} has {h8} rows at 1/8, fewer than n_spatial={n}")
    q, r = divmod(h8, n)
    return tuple(8 * (q + (i < r)) for i in range(n))


class Spatial(NamedTuple):
    """The spatial axis as one rank sees it: the process `group` of the
    ranks that share its frames, this rank's `index` in it (the index-th
    block of rows, top to bottom) and its `size`. `rows` is every rank's
    block at full resolution (split_rows of the frames' height, set by
    at_height); without it the rows split evenly. A tensor's local height
    fixes its scale, and `blocks`, `height` and `row0` answer at that scale:
    every rank's rows, the global height and this rank's first row."""
    group: object
    index: int
    size: int
    rows: tuple = ()

    def at_height(self, height: int) -> "Spatial":
        """This handle for frames of `height` rows (split_rows)."""
        return self._replace(rows=split_rows(height, self.size))

    def blocks(self, local: int) -> list:
        """Every rank's rows at the scale where this rank holds `local`."""
        if not self.rows:
            return [local] * self.size
        own = self.rows[self.index]
        if any(r * local % own for r in self.rows):
            raise ValueError(f"{local} rows are no scale of this rank's block of {own} "
                             f"(rows {self.rows})")
        return [r * local // own for r in self.rows]

    def split(self, height: int) -> list:
        """Every rank's rows of a tensor whose whole height is `height`."""
        if not self.rows:
            if height % self.size:
                raise ValueError(f"{height} rows do not split over n_spatial={self.size}")
            return [height // self.size] * self.size
        total = sum(self.rows)
        if any(r * height % total for r in self.rows):
            raise ValueError(f"{height} rows are no scale of the handle's height {total}")
        return [r * height // total for r in self.rows]

    def height(self, local: int) -> int:
        return sum(self.blocks(local))

    def row0(self, local: int) -> int:
        return sum(self.blocks(local)[:self.index])


class Mesh(NamedTuple):
    """The world's layout: `data` x `spatial` ranks and this process's rank;
    with `spatial` > 1, this rank's spatial handle (`axis`) and the process
    group of its data axis (`data_group`)."""
    data: int
    spatial: int
    rank: int
    axis: Optional[Spatial] = None
    data_group: object = None


def mesh_layout(n_data: int, n_spatial: int) -> np.ndarray:
    """The ranks as a (n_data, n_spatial) array: a row is a spatial group,
    a column a data group (accflow_tpu/parallel/mesh.py::make_mesh's
    reshape of the device list)."""
    return np.arange(n_data * n_spatial).reshape(n_data, n_spatial)


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1) -> Mesh:
    """The layout of the process group (one rank per GPU). With n_spatial
    > 1 every rank makes every group, rows of mesh_layout first and then
    its columns (torch.distributed.new_group is collective), and keeps its
    own. ValueError where the world does not split so."""
    world = world_size()
    if n_spatial < 1 or world % n_spatial:
        raise ValueError(f"n_spatial={n_spatial}: a world of {world} rank(s) does not split "
                         f"into spatial groups of {n_spatial}")
    if n_data is None:
        n_data = world // n_spatial
    if n_data * n_spatial != world:
        raise ValueError(f"n_data={n_data}: the process group has {world} ranks")
    if n_spatial == 1:
        return Mesh(world, 1, rank())
    layout = mesh_layout(n_data, n_spatial)
    rows = [dist.new_group(list(map(int, r))) for r in layout]
    cols = [dist.new_group(list(map(int, c))) for c in layout.T]
    d, s = divmod(rank(), n_spatial)
    return Mesh(n_data, n_spatial, rank(), Spatial(rows[d], s, n_spatial), cols[s])


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


def _flat_reduce(tensors, group, divisor: int) -> None:
    """Sum `tensors` over the ranks of `group` and divide them by
    `divisor`, in place, through one flat buffer per dtype (one collective,
    NCCL-capturable)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    _no_capture_on(group)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat.div_(divisor)
        offset = 0
        for t in ts:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


def average_gradients(params, group, sp: Optional[Spatial] = None) -> None:
    """The mesh's gradient in every parameter's .grad, in place, through one
    flat collective: the mean over the ranks of the data-parallel `group`
    (a world of one included: the collective is then an exact copy). With a
    spatial handle `sp` each rank holds the gradient of its own part of the
    loss (train/loss.py), which the spatial group sums: the collective is
    then the world's sum (the mesh: every spatial group of every data
    group) divided by the mesh's n_data, counted as a spatial one. Nothing
    for group and sp None. Every rank then holds the same bits."""
    grads = [p.grad for p in params if p.grad is not None]
    if sp is not None:
        world = world_size()
        _count(2 * sum(g.numel() * g.element_size() for g in grads) * (world - 1) / world)
        _flat_reduce(grads, dist.group.WORLD, world // sp.size)
    elif group is not None:
        _flat_reduce(grads, group, dist.get_world_size(group))


def all_mean(tree, group):
    """The mean over the ranks of `group` of a dict, tuple or list of 0-d
    tensors (a step's loss and metrics), as new tensors; the input
    unchanged for group None."""
    return tree if group is None else _reduce_tree(tree, group, spatial=False)


def _all_reduce(t: torch.Tensor, group, counted: bool) -> torch.Tensor:
    """The sum of `t` over the ranks of `group`, on every rank (a new
    tensor; counted in `collectives` and `bytes_sent` when `counted`, as
    the spatial axis's are): an all_reduce, which gloo runs on CUDA tensors
    too."""
    if counted:
        n = dist.get_world_size(group)
        _count(2 * t.numel() * t.element_size() * (n - 1) / n)
    _no_capture_on(group)
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _reduce_tree(tree, group, spatial: bool):
    """A dict, tuple or list of tensors reduced over the ranks of `group`,
    detached, through one flat collective: a spatial group's counted sum
    (`spatial`), else a data group's mean."""
    leaves, spec = torch.utils._pytree.tree_flatten(tree)
    flat = _all_reduce(torch.cat([x.detach().float().reshape(-1) for x in leaves]), group,
                       spatial)
    if not spatial:
        flat = flat / dist.get_world_size(group)
    parts = flat.split([x.numel() for x in leaves])
    return torch.utils._pytree.tree_unflatten(
        [p.view(x.shape) for p, x in zip(parts, leaves)], spec)


class _GlobalSum(torch.autograd.Function):
    """The sum over the ranks of a group; its gradient is the sum over
    ranks of the gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t, group, counted):
        ctx.group, ctx.counted = group, counted
        return _all_reduce(t, group, counted)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group, ctx.counted), None, None


def global_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the ranks of `group` (not None), differentiable,
    as GSPMD's psum."""
    return _GlobalSum.apply(t, group, False)


def mesh_sum(t: torch.Tensor, group, sp: Spatial) -> torch.Tensor:
    """The sum of `t` over the ranks of the spatial group of `sp` or, with a
    data `group` (not None), over the whole mesh: every spatial group of
    every data group, the world that make_mesh lays out (train-mode
    BatchNorm's statistics of the global batch). Differentiable (_GlobalSum)
    and counted as the spatial axis's collectives."""
    return _GlobalSum.apply(t, sp.group if group is None else dist.group.WORLD, True)


def _all_gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank of `group`'s `t` (the same shape on each), stacked in rank
    order on a new axis 0: under NCCL one all_gather_into_tensor on the
    device, into the stack itself; under gloo, which gathers CUDA tensors
    in all_reduce only, an all_gather of host copies, stacked on the
    host."""
    _no_capture_on(group)
    src = t.detach()
    if dist.get_backend(group) == "nccl":
        src = src.contiguous()
        out = src.new_empty((size, *src.shape))
        dist.all_gather_into_tensor(out, src, group=group)
        return out
    src = src.cpu().contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts)


def host_array(t) -> np.ndarray:
    """Each rank's slice of a per-sample vector (batch on axis 0, the same
    length on every rank) gathered in rank order into the whole vector, as
    numpy on every rank. A collective: every rank calls it at the same
    point. gloo gathers on the host."""
    t = torch.as_tensor(t).detach()
    if world_size() == 1:
        return t.cpu().numpy()
    return _all_gather(t, None, world_size()).flatten(0, 1).cpu().numpy()


# ---------------------------------------------------------------------------
# The spatial axis: rows of a tensor over the ranks of a Spatial handle
# ---------------------------------------------------------------------------

collectives = 0  # spatial collectives this process ran (a graph's replays included)
bytes_sent = 0  # the bytes this rank sent in them (ring algorithms' count)


def _count(nbytes: float) -> None:
    add_counts(1, int(nbytes))


def counts() -> tuple:
    """(collectives, bytes_sent) so far."""
    return collectives, bytes_sent


def add_counts(n: int, nbytes: int) -> None:
    """Add `n` collectives of `nbytes` bytes in all to the counters (a
    graph's replay adds what its capture counted)."""
    global collectives, bytes_sent
    collectives += n
    bytes_sent += nbytes


def global_rows(local: int, sp: Optional[Spatial]) -> int:
    """The whole height of a tensor of which this rank holds `local` rows
    (Spatial.height): `local` without a handle."""
    return local if sp is None else sp.height(local)


def check_rows(local: int, sp: Optional[Spatial]) -> None:
    """ValueError unless this rank's `local` rows of the frames are its
    block of the handle's table (split_rows), or, for a handle without
    one, a multiple of 8 rows (the even split that table gives). Names
    which: a height that is not a multiple of 8, fewer 1/8 rows than
    ranks, or a height whose blocks are unequal and the handle not given
    it (Spatial.at_height)."""
    if sp is None:
        return
    if sp.rows:
        if local != sp.rows[sp.index]:
            raise ValueError(f"this rank holds {local} rows; its block of a height of "
                             f"{sum(sp.rows)} is {sp.rows[sp.index]} (mesh.shard_rows)")
        return
    if local % 8:
        height = local * sp.size
        rows = split_rows(height, sp.size)
        raise ValueError(f"a height of {height} splits over n_spatial={sp.size} into blocks of "
                         f"{list(rows)} rows: give the handle the height "
                         f"(Spatial.at_height({height})) and cut the frames with shard_rows")


def shard_rows(x, sp: Optional[Spatial], dim: int = 1):
    """This rank's rows of `x` (a tensor or array) along `dim`, by the
    handle's table (Spatial.split); `x` itself without a handle."""
    if sp is None:
        return x
    blocks = sp.split(x.shape[dim])
    index = [slice(None)] * x.ndim
    start = sum(blocks[:sp.index])
    index[dim] = slice(start, start + blocks[sp.index])
    return x[tuple(index)]


class _StackRanks(torch.autograd.Function):
    """stack_ranks. Backward: rank i's stack fed every rank's loss part, so
    the gradient of rank j's tensor is the sum over ranks of their stacks'
    gradients at slot j: one all_reduce of the stacked gradient, this
    rank's slot kept (gloo has no reduce_scatter on every build)."""

    @staticmethod
    def forward(ctx, t, sp):
        ctx.sp = sp
        _count(t.numel() * t.element_size() * (sp.size - 1))
        return _all_gather(t, sp.group, sp.size).to(t.device)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.sp.group, True)[ctx.sp.index], None


def stack_ranks(t: torch.Tensor, sp: Spatial) -> torch.Tensor:
    """Every rank's `t` (the same shape on each), stacked in rank order on
    a new axis 0, on every rank: an all_gather, through the host under
    gloo. Exact: the bytes are moved, not summed. Differentiable
    (_StackRanks: its backward is an all_reduce)."""
    return _StackRanks.apply(t, sp)


def gather_rows(x: torch.Tensor, sp: Optional[Spatial], dim: int = 1) -> torch.Tensor:
    """The whole height of `x` along `dim` from every rank's rows, on every
    rank; `x` itself without a handle. Unequal blocks are padded to the
    largest for the gather (whose bytes count the padding) and trimmed."""
    if sp is None:
        return x
    blocks = sp.blocks(x.shape[dim])
    parts = stack_ranks(_pad_rows(x, max(blocks), dim), sp).unbind(0)
    return torch.cat([p.narrow(dim, 0, b) for p, b in zip(parts, blocks)], dim=dim)


def _pad_rows(x: torch.Tensor, rows: int, dim: int) -> torch.Tensor:
    """x with zero rows appended along `dim` up to `rows`."""
    if x.shape[dim] == rows:
        return x
    shape = list(x.shape)
    shape[dim] = rows - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def halo_rows(x: torch.Tensor, sp: Spatial, top: int, bottom: int, dim: int = 2):
    """The `top` rows above this rank's rows of `x` along `dim` and the
    `bottom` rows below them, as (above, below), from one all_gather of
    each rank's edge rows (its last min(top, h) and first min(bottom, h)
    of its h rows, padded to the largest block's count): a halo may reach
    past the nearest rank. Rows above the image's top or below its bottom
    are zeros. Both are picked from one table of every rank's edge rows and
    a zero row, so every rank's halos read the gathered stack (and its
    backward, a collective, runs on every rank): a row's gradient returns
    to the rank that owns it."""
    h = x.shape[dim]
    blocks = sp.blocks(h)
    tl, bl = min(top, h), min(bottom, h)
    tpad, bpad = min(top, max(blocks)), min(bottom, max(blocks))
    edges = torch.cat([_pad_rows(x.narrow(dim, h - tl, tl), tpad, dim),
                       _pad_rows(x.narrow(dim, 0, bl), bpad, dim)], dim=dim)
    table = torch.cat(list(stack_ranks(edges, sp).unbind(0))
                      + [torch.zeros_like(x.narrow(dim, 0, 1))], dim=dim)
    rows = table.index_select(dim, _halo_index(tuple(blocks), sp.index, top, bottom, x.device))
    return rows.narrow(dim, 0, top), rows.narrow(dim, top, bottom)


@functools.lru_cache(maxsize=512)
def _halo_index(blocks: tuple, index: int, top: int, bottom: int,
                device: torch.device) -> torch.Tensor:
    """halo_rows' rows of its table (each rank's tpad + bpad edge rows in
    rank order, then a zero row) for rank `index` of `blocks`: the `top`
    above its rows, then the `bottom` below them, on `device`. Made once
    for each shape: a copy from a host list, which a CUDA graph's capture
    may not hold. The eager warm-ups that precede every capture (graphs.py)
    make each table a sharded step reads, so the capture finds it here."""
    starts = np.cumsum((0,) + blocks).tolist()
    tpad, bpad = min(top, max(blocks)), min(bottom, max(blocks))
    width = tpad + bpad  # each rank's edge rows in the table
    r0, h, height = starts[index], blocks[index], starts[-1]

    def row(g: int) -> int:
        if g < 0 or g >= height:
            return len(blocks) * width  # the zero row
        owner = int(np.searchsorted(starts, g, side="right")) - 1
        off, hr = g - starts[owner], blocks[owner]
        pos = off - (hr - min(top, hr)) if g < r0 else tpad + off
        return owner * width + pos

    rows = list(range(r0 - top, r0)) + list(range(r0 + h, r0 + h + bottom))
    return torch.tensor([row(g) for g in rows], dtype=torch.long, device=device)


def sum_ranks(t: torch.Tensor, sp: Spatial) -> torch.Tensor:
    """The sum of `t` over the ranks of the spatial group, on every rank (a
    new tensor): an all_reduce, which gloo runs on CUDA tensors too.
    Differentiable: every rank's sum read this rank's tensor, so its
    gradient is the sum over ranks of their sums' gradients (_GlobalSum)."""
    return _GlobalSum.apply(t, sp.group, True)


def spatial_sum(tree, sp: Optional[Spatial]):
    """The sum over the ranks of the spatial group of a dict, tuple or list
    of tensors (a step's loss and metrics, each rank's part of them, or a
    per-sample vector), detached, as new tensors; the input unchanged
    without a handle. One collective."""
    return tree if sp is None else _reduce_tree(tree, sp.group, spatial=True)
