"""Serving export: the AccFlow clip pipeline as one file, counterpart of
accflow_tpu/serving.py.

The whole serving computation (the flow estimator's batched pair queries,
the accumulation cells, the upsampling) with the weights in it is traced by
`torch.export` into an `ExportedProgram` and saved with
`torch.export.save`:

    ep = export_serving(est, acc, (7, 2, 512, 512, 3))
    save_artifact(ep, path)
    ...
    fn = load_artifact(path)        # on the card by default
    flows = fn(images)              # (T, N, H, W, 3) -> (T-2, N, H, W, 2)

The program is specialised on clip length and resolution; the batch is
fixed, or symbolic when clip_shape's batch is None (a `torch.export.Dim`,
as JAX's `symbolic_shape("b")`), and then one artifact serves any batch.
Kernels #1-#3 and the splat's scatter are torch ops (`accflow::*`, see
ops/corr_cuda.py, ops/corr_level_cuda.py, ops/corr_bd_cuda.py,
ops/softsplat.py) that the program calls by name. So, unlike JAX's
artifact, which needs only jax, a torch artifact loads only after
`import accflow_tpu_torch` (any of its modules) has registered them.

A loaded artifact runs on the device it is loaded for; a program exported
on another device is moved with `torch.export.passes.move_to_device_pass`.
On the card it replays a CUDA graph per input shape (graphs.py), the
counterpart of JAX's compiled call. It runs under the numerics switches the
eager path sets around its ops, which an exported program does not record
(`numerics`): TF32 off for the float32 convs and matmuls of a float32
program; in a bfloat16 program the one float32 GEMM is the correlation
pyramid's on bfloat16-valued features, exact under TF32, where the eager
path allows it (ops/corr.py::build_corr_pyramid), so TF32 stays on there;
and float32 reductions in cuBLAS's bfloat16 GEMMs.
"""

from __future__ import annotations

import contextlib
import copy

import torch
import torch.nn as nn
from torch.export.passes import move_to_device_pass

from accflow_tpu_torch.device import resolve_device
from accflow_tpu_torch.graphs import CudaGraphed
from accflow_tpu_torch.models import FlowEstimator
from accflow_tpu_torch.models.accflow import AccFlow, accflow_forward
from accflow_tpu_torch.nn.layers import tf32
from accflow_tpu_torch.ops.corr import _float32_reduction


def build_serving_fn(est: FlowEstimator, acc: AccFlow):
    """(T, N, H, W, 3) [-1, 1]-normalized clip -> (T-2, N, H, W, 2) flows
    F_{i,0} for i = 2..T-1, eagerly, through accflow_forward with the
    estimator's batched pair queries (and its flow_fn for a warm-started
    accumulator)."""
    pairs, flow = est.pairs_fn(), est.flow_fn()

    def serve(images: torch.Tensor) -> torch.Tensor:
        return accflow_forward(acc, images, ofe_pairs=pairs, ofe=flow)

    return serve


def cast_weights(module: nn.Module, dtype) -> nn.Module:
    """A copy of `module` with every floating parameter and buffer in
    `dtype` (a torch.dtype or its name). bfloat16 halves an artifact; the
    layers cast weights to the activation dtype at use (nn/layers.py), so
    on the bfloat16 compute path only the few float32 ops see once-rounded
    weights."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return copy.deepcopy(module).to(dtype)


def cast_models(est: FlowEstimator, acc: AccFlow, weights_dtype):
    """(est, acc) with their weights in `weights_dtype`, or as they are
    for None."""
    if weights_dtype is None:
        return est, acc
    return (FlowEstimator(est.name, cast_weights(est.model, weights_dtype)),
            cast_weights(acc, weights_dtype))


class Program(nn.Module):
    """`fn` as the forward of a module that owns `models`, so that
    torch.export takes their weights as the program's parameters."""

    def __init__(self, fn, *models: nn.Module):
        super().__init__()
        self.models = nn.ModuleList(models)
        self._fn = fn

    def forward(self, *inputs):
        return self._fn(*inputs)


def export(program: Program, inputs: tuple, dynamic_shapes=None) -> torch.export.ExportedProgram:
    """torch.export.export of `program` on example `inputs`, traced with
    autograd off: the port's forwards switch it off themselves, and a
    program traced with it on records each switch as a region that does not
    survive save and load."""
    with torch.no_grad():
        return torch.export.export(program, inputs, dynamic_shapes=dynamic_shapes, strict=False)


def export_serving(est: FlowEstimator, acc: AccFlow, clip_shape,
                   weights_dtype=None) -> torch.export.ExportedProgram:
    """torch.export.ExportedProgram of build_serving_fn for clip_shape =
    (T, N, H, W, 3), float32 frames on the models' device. N=None exports a
    symbolic batch (any N >= 1). weights_dtype: storage dtype of the
    weights in the program (cast_weights), e.g. "bfloat16"."""
    est, acc = cast_models(est, acc, weights_dtype)
    t, n, h, w, c = clip_shape
    example = torch.zeros((t, 2 if n is None else n, h, w, c),
                          device=next(acc.parameters()).device)
    # One entry for Program.forward's *inputs, holding the images' spec.
    dynamic = (({1: torch.export.Dim("batch", min=1)},),) if n is None else None
    return export(Program(build_serving_fn(est, acc), est.model, acc), (example,), dynamic)


def save_artifact(exported: torch.export.ExportedProgram, path: str) -> None:
    torch.export.save(exported, path)


def load_exported(path) -> torch.export.ExportedProgram:
    """The saved artifact as an ExportedProgram (its `graph_signature` and
    placeholders give the input shapes; `.module()` runs it)."""
    return torch.export.load(path)


_LOOKUPS = ("accflow.corr_lookup.default", "accflow.corr_level_lookup.default",
            "accflow.y_contract.default")


def compute_dtype(exported: torch.export.ExportedProgram) -> torch.dtype:
    """The program's compute dtype: what its correlation lookups write
    (raft_iterate asks kernels #1 and #2 for it, _level_window_bd asks
    kernel #3 for the levels' dtype, which is it); float32 if it has none."""
    for module in exported.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in module.graph.nodes:
                if str(node.target) in _LOOKUPS:
                    return node.args[-1]
    return torch.float32


@contextlib.contextmanager
def numerics(dtype: torch.dtype = torch.float32):
    """The eager path's numerics switches for a whole exported program of
    compute dtype `dtype` (see the module docstring), no autograd, the
    previous state restored afterwards."""
    with torch.no_grad(), tf32(dtype == torch.bfloat16), _float32_reduction():
        yield


def program_on(exported: torch.export.ExportedProgram, device=None):
    """(the program's module on `device`, that device): `device` defaults
    to cuda (resolve_device); a program whose weights lie elsewhere is
    moved there first."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    weights = list(exported.state_dict.values()) + list(exported.constants.values())
    if any(isinstance(x, torch.Tensor) and x.device != dev for x in weights):
        exported = move_to_device_pass(exported, dev)
    return exported.module(), dev


def load_artifact(path, device=None):
    """Load a saved clip artifact onto `device` (default cuda); returns a
    callable (images (T, N, H, W, 3), array or tensor) -> (T-2, N, H, W, 2)
    float32 flows on that device, replayed from CUDA graphs on the card."""
    dev = resolve_device(device)
    exported = load_exported(path)
    dtype = compute_dtype(exported)
    module, dev = program_on(exported, dev)
    run = CudaGraphed(module)

    def call(images):
        with numerics(dtype):
            return run(torch.as_tensor(images, dtype=torch.float32, device=dev))

    return call
