"""CUDA graphs for functions of fixed shapes: the port's counterpart of
`jax.jit` where the JAX package compiles a step or a clip
(accflow_tpu/streaming.py:194-195, accflow_tpu/serving.py:85).

    step = CudaGraphed(step_fn)
    out, state = step(state, frame)     # captured on the first call, replayed after

The port runs eagerly, one launch per op, so a small step on a large card
waits on the host. `CudaGraphed` wraps a function of tensors (a pytree of
tensors in, a pytree of tensors out). On a CUDA device it runs the
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

On a CPU device the function is called as it is: that is the device the
caller asked for, not a fallback.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

WARMUP = 2  # eager runs on a side stream before a capture


class _Graph:
    """One captured signature: static inputs, the graph, its outputs."""

    def __init__(self, fn, leaves, spec):
        dev = leaves[0].device
        self.inputs = [torch.empty_like(x).copy_(x) for x in leaves]
        args = pytree.tree_unflatten(self.inputs, spec)
        with torch.cuda.device(dev):
            self.graph = torch.cuda.CUDAGraph()
            capture = torch.cuda.graph(self.graph)
            # Warm up on torch's one capture stream, not a new stream per
            # capture: cuBLAS keeps a workspace for every stream it has run on.
            side = capture.capture_stream
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn(*args)
            torch.cuda.current_stream().wait_stream(side)
            with capture:
                out = fn(*args)
        self.outputs, self.out_spec = pytree.tree_flatten(out)
        if not all(isinstance(o, torch.Tensor) for o in self.outputs):
            raise TypeError("a graphed function returns tensors only")

    def __call__(self, leaves):
        for buf, x in zip(self.inputs, leaves):
            buf.copy_(x)
        self.graph.replay()
        return pytree.tree_unflatten([o.clone() for o in self.outputs], self.out_spec)


class CudaGraphed:
    """`fn` replayed from CUDA graphs on CUDA tensors, called as it is on
    CPU tensors (see the module docstring). `captures` counts the graphs
    captured so far."""

    def __init__(self, fn):
        self._fn = fn
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
        key = (spec, tuple((x.shape, x.dtype, x.device) for x in leaves))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _Graph(self._fn, leaves, spec)
        return graph(leaves)
