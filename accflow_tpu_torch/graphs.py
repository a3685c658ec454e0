"""CUDA graphs for functions of fixed shapes: the port's counterpart of
`jax.jit` where the JAX package compiles a step or a clip
(accflow_tpu/streaming.py:194-195, accflow_tpu/serving.py:85,
accflow_tpu/train/engine.py:118,146, accflow_tpu/train/finetune.py:79,107,
accflow_tpu/train/evaluate.py:122).

    step = CudaGraphed(step_fn)
    out, state = step(state, frame)     # captured on the first call, replayed after

The port runs eagerly, one launch per op, so a small step on a large card
waits on the host. `CudaGraphed` wraps a pure function of tensors (a pytree
of tensors in, a pytree of tensors out). On a CUDA device it runs the
function WARMUP times on torch's capture stream (kernel builds, library
handles, cuDNN's choices, allocator growth), then captures one
`torch.cuda.CUDAGraph` per input signature (pytree structure, shapes,
dtypes and devices; JAX also recompiles per shape). A call copies its
inputs into the signature's static buffers, replays the graph and returns
clones of the outputs: fresh tensors that a later replay cannot overwrite,
so a caller may keep the flow of push i after push i+1. What the function
decided on the host at capture (Python branches, the kernels chosen under
the process's numerics switches) is fixed in the graph. A failed capture or
replay raises: there is no eager fallback.

`CudaGraphedStep` wraps a step with side effects, a train step that updates
parameters, optimizer state and BatchNorm buffers in place and draws from a
torch.Generator, so that N calls have the effect of N eager steps (see its
docstring).

Collectives. A function that runs collectives (a data-parallel step's
gradient mean, a height-sharded step's exchanges: parallel/mesh.py) is
captured with them where they are NCCL's; both wrappers take that `group`
and, on the card, refuse gloo's with a ValueError before any run
(mesh.require_capturable). The warm-ups make each group's NCCL
communicator and fill mesh's host-made caches, so that the capture holds
no host copy. mesh's `collectives` and `bytes_sent` are counted in
Python, which a replay does not run: each graph keeps what its capture
counted and adds it on every replay, so a graphed call counts what an
eager one does (the capture call: one call's worth; CudaGraphed's
warm-ups are eager calls and count as such).

A capture checks only its own thread's CUDA calls (capture_error_mode
"thread_local"), and holds CAPTURE_LOCK, which data/prefetch.py's copies
to the card take too: a data loader's thread may go on decoding the next
batch meanwhile, but issues no CUDA work until the capture ends. On a CPU
device the function is called as it is: that is the device the caller
asked for, not a fallback.
"""

from __future__ import annotations

import threading

import torch
from torch.utils import _pytree as pytree

from accflow_tpu_torch.parallel import mesh

WARMUP = 2  # eager runs on the capture stream before a capture
# Held by each capture and by data/prefetch.py's copies to the card, so
# that no other thread issues CUDA work while a graph is captured.
CAPTURE_LOCK = threading.Lock()


def _capture_stream() -> torch.cuda.Stream:
    """torch's one capture stream (torch.cuda.graph's default), not a new
    stream per capture: cuBLAS keeps a workspace for every stream it has
    run on."""
    if torch.cuda.graph.default_capture_stream is None:
        torch.cuda.graph.default_capture_stream = torch.cuda.Stream()
    return torch.cuda.graph.default_capture_stream


def _on_capture_stream(fn, args):
    """fn(*args) eagerly on the capture stream, after the current stream's
    work so far and before its later work."""
    side, current = _capture_stream(), torch.cuda.current_stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn(*args)
    current.wait_stream(side)
    return out


class _Graph:
    """One captured signature: static inputs, the graph, its outputs, and
    the mesh collectives and bytes its capture counted (`counts`: added
    on each replay, taken back from the capture). The leaves that are not
    tensors (torch.Generators, None) are static: the graph is captured
    with them, each generator registered with it."""

    def __init__(self, fn, leaves, spec, warmup: int):
        self.inputs = [torch.empty_like(x).copy_(x) if isinstance(x, torch.Tensor) else x
                       for x in leaves]
        args = pytree.tree_unflatten(self.inputs, spec)
        with torch.cuda.device(_device(leaves)):
            for _ in range(warmup):
                _on_capture_stream(fn, args)
            self.graph = torch.cuda.CUDAGraph()
            for gen in leaves:
                if isinstance(gen, torch.Generator):
                    self.graph.register_generator_state(gen)
            before = mesh.counts()
            with CAPTURE_LOCK, torch.cuda.graph(self.graph, stream=_capture_stream(),
                                                capture_error_mode="thread_local"):
                out = fn(*args)
        self.counts = tuple(a - b for a, b in zip(mesh.counts(), before))
        mesh.add_counts(*(-c for c in self.counts))
        self.outputs, self.out_spec = pytree.tree_flatten(out)
        if not all(isinstance(o, torch.Tensor) for o in self.outputs):
            raise TypeError("a graphed function returns tensors only")

    def __call__(self, leaves):
        for buf, x in zip(self.inputs, leaves):
            if isinstance(x, torch.Tensor):
                buf.copy_(x)
        self.graph.replay()
        mesh.add_counts(*self.counts)
        return pytree.tree_unflatten([o.clone() for o in self.outputs], self.out_spec)


def _indexed(dev: torch.device) -> torch.device:
    """`dev` with its index ("cuda" is the current card, as a generator
    made with device="cuda" says)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _device(leaves) -> torch.device:
    return next(x.device for x in leaves if isinstance(x, torch.Tensor))


def _signature(leaves, spec):
    return spec, tuple((x.shape, x.dtype, x.device) if isinstance(x, torch.Tensor) else x
                       for x in leaves)


class CudaGraphed:
    """`fn` replayed from CUDA graphs on CUDA tensors, called as it is on
    CPU tensors (see the module docstring). `group`: the process group of
    the collectives `fn` runs, None for none; on the card it must be
    NCCL's, checked before the first run. `captures` counts the graphs
    captured so far."""

    def __init__(self, fn, group=None):
        self._fn, self._group = fn, group
        self._graphs: dict = {}

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        if not leaves or not all(isinstance(x, torch.Tensor) for x in leaves):
            raise TypeError("a graphed function takes tensors only")
        devices = {x.device for x in leaves}
        if len(devices) != 1:
            raise ValueError(f"a graphed function takes tensors on one device, got {devices}")
        if leaves[0].device.type != "cuda":
            return self._fn(*args)
        if self._group is not None:
            mesh.require_capturable(self._group)
        key = _signature(leaves, spec)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _Graph(self._fn, leaves, spec, WARMUP)
        return graph(leaves)


class CudaGraphedStep:
    """`fn`, a step with side effects (a train step: it updates parameters,
    AdamW's state and BatchNorm buffers in place and draws its noise from a
    torch.Generator), replayed from CUDA graphs on CUDA tensors so that N
    calls have the effect of N eager steps, as JAX's jitted train step with
    its donated state. For each input signature the first WARMUP calls run
    `fn` eagerly on the capture stream: they are real steps, and they
    create what a capture cannot (AdamW's state, library handles, cuDNN's
    choices). The next call captures `fn` (a capture records kernels and
    runs none), then replays the graph once for that call's step; later
    calls copy their tensors into the static buffers and replay. A
    torch.Generator argument is static (part of the signature, passed on as
    it is) and is registered with the graph before the capture, so that a
    replay draws what an eager step would and moves the generator's offset
    as far. `after` (a learning-rate schedule's advance, which writes a host
    value into a device tensor) runs after every call, outside the graph.
    On the card the arguments are tensors, torch.Generators and None, and
    the outputs tensors, returned as clones. Without a CUDA tensor among
    its arguments `fn` and then `after` run as they are. `group`: the
    process group of the collectives `fn` runs (the data axis, or a
    spatial handle's), None for none; on the card it must be NCCL's,
    checked before the first eager call. `captures` counts the graphs
    captured, `eager_calls` the calls of `fn` that ran eagerly on the
    card."""

    def __init__(self, fn, after=None, group=None):
        self._fn, self._after, self._group = fn, after, group
        self._graphs: dict = {}
        self._warm: dict = {}  # signature -> its eager calls so far
        self.eager_calls = 0

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves):
            out = self._on_card(args, leaves, spec)
        else:
            out = self._fn(*args)
        if self._after is not None:
            self._after()
        return out

    def _on_card(self, args, leaves, spec):
        if not all(isinstance(x, (torch.Tensor, torch.Generator)) or x is None for x in leaves):
            raise TypeError("a graphed step takes tensors, torch.Generators and None only")
        if self._group is not None:
            mesh.require_capturable(self._group)
        devices = {_indexed(x.device) for x in leaves
                   if isinstance(x, (torch.Tensor, torch.Generator))}
        if len(devices) != 1:
            raise ValueError(f"a graphed step takes tensors and generators on one device, "
                             f"got {devices}")
        key = _signature(leaves, spec)
        graph = self._graphs.get(key)
        if graph is not None:
            return graph(leaves)
        done = self._warm.get(key, 0)
        if done < WARMUP:
            self._warm[key] = done + 1
            self.eager_calls += 1
            with torch.cuda.device(_device(leaves)):
                out = _on_capture_stream(self._fn, args)
            current = torch.cuda.current_stream()
            for o in pytree.tree_leaves(out):
                if isinstance(o, torch.Tensor):
                    o.record_stream(current)  # made on the capture stream, read on this one
            return out
        graph = self._graphs[key] = _Graph(self._fn, leaves, spec, warmup=0)
        return graph(leaves)
