"""The mesh's spatial axis of the port (parallel/mesh.py: image height
sharded over the ranks of a spatial group) on the CPU over gloo, against
one process and against the JAX package's unsharded runs.

- One launch of two gloo ranks, each a process running this file as a
  script (`_child`), at n_data 1, n_spatial 2; each rank holds its own rows
  of the inputs and gathers its outputs' rows for the comparison:
  - the primitives against the same function in one process, within 1e-5:
    the halo conv2d at 3x3, 7x7/2, 3x3/2, 1x1/2, 5x1, 1x5 and a 7x7 on an
    image of 4 rows (two a rank: a halo past the image's edge),
    instance_norm, convex_upsample, downflow8, upflow8, backwarp,
    deform_conv3x3 and forward_splat_flow; and at unequal blocks (a handle
    given a height of 40: 24 + 16 rows) upflow8, instance_norm, halo_rows
    itself and a 7x7/2 conv;
  - full RAFT's forward at 128^2, 2 iterations, float32, with "fused",
    "ondemand:64" and the split lookup "experimental:fused_bd", against
    JAX's unsharded est.forward with corr_lookup "mm" (rtol / atol 1e-3,
    tests/test_sharding.py:94,127); RAFT-small's with "fused" and
    "ondemand:64" (kernel #2's path; upflow8's halo rows);
  - GMA's pair at 64^2 with gamma drawn in [2, 4] (at its init of 0 the
    attention adds nothing): dense, chunks of 16 query rows, "auto", and
    the positional branch beside the content one (content-only attention
    cannot see the keys' order);
  - the AccFlow clips (5 x 1 x 128^2 with RAFT "ondemand:64"; 5 x 1 x 64^2
    with each GMA variant; 4 x 1 x 64^2 with RAFT's level mix
    "experimental:fused_mix:rows,rows_gx,vpu_y,mm", each rank's queries
    against the gathered levels, held to one process within FLOW_REL x
    max |flow|, the bar of chip_smoke.py's (bd clip); 4 x 1 x 40x48 at 24 + 16 rows on every path:
    fused, warm-started, F0N fused and stepwise, cold stepwise; hidden 128,
    its ZeroConv drawn so the deformable conv deforms) against JAX's
    unsharded "mm" clip at the AccFlow bar (rtol 2e-3 / atol 2e-2; a
    stepwise path against JAX's fused clip of its direction, the same
    function: tests/test_torch_f0n.py);
  - the accumulator's sharded train step (train/engine.py::
    make_acc_train_step with a handle; a batch of 2 clips of 4 frames at
    40x48, 24 + 16 rows, hidden 32, RAFT at 2 iterations, float32, no
    noise): its loss and the raw gradients the update reduces against
    JAX's make_acc_train_step unsharded (loss rtol 1e-5, gradients at
    tests/test_torch_train.py's bars) and against one process on the
    fused, F0N fused, cold stepwise and remat "full" paths (relative L2
    <= 1e-4 over the whole vector and over the context encoder's leaves,
    where a lost halo gradient shows), the ranks' gradients bit-equal; its
    noise rows bit-equal to one process's draw; valid_step's per-sample
    EPE;
  - the estimators' sharded fine-tune step (train/finetune.py::
    make_finetune_step with a handle; FT_PATHS: a batch of 2 pairs at
    40x48, 24 + 16 rows, float32, 2 iterations, remat "dots"): full RAFT
    and GMA (positional) against JAX's make_finetune_step unsharded (loss
    rtol 1e-5, gradients and running statistics at
    tests/test_torch_finetune.py's bars), and against one process on
    RAFT, RAFT "ondemand:6" (3 and 2 chunks a rank), GMA, RAFT-small and
    RAFT with grad_accum 2 (relative L2 <= 1e-4 over the whole vector, the
    fnet's leaves, where a lost key gradient shows, and the cnet's, where a
    lost halo or a BatchNorm over the wrong count shows; the running
    statistics rtol 1e-5), the ranks' gradients and statistics bit-equal;
    its noise rows and valid_step's per-sample EPE; train-mode BatchNorm
    itself and its input gradient at 24 + 16 rows;
  - the exchanges' backward: the input gradients of the halo conv, the
    instance norm, upflow8 and the convex upsampling at unequal blocks,
    the deformable conv (its gathered input) and a summed canvas
    (sum_ranks) against one process's, within 1e-5;
  - StreamAccumulator with warm_start (a reset on 3 frames and 2 pushes)
    with RAFT (b), RAFT-small (a) and GMA (c), and the drift fixture's
    trained weights over its first 10 frames, against JAX's
    make_streaming_fns at the stream bar;
  - each of these also within 1e-4 x max |flow| of JAX's (FLOW_REL: the
    clip's and the stream's flows are ~0.1 px, so the AccFlow bar alone
    passes a run whose coordinates start every rank at row 0) and of the
    port's run in one process;
  - the estimator options: full RAFT at corr_levels 3, corr_radius 3 (its
    pair at 128^2, each rank's queries against the gathered keys through
    kernel #2's (3, 3) lookup's plain version) against JAX's unsharded
    forward (FLOW_TOL, FLOW_REL) and one process; a basic encoder with
    norm_fn "group" on a 40x48 frame at 24 + 16 rows (the group statistics
    combined over the ranks) against JAX's basic_encoder (rtol / atol
    1e-4, tests/test_torch_ops.py's encoder bar) and one process (1e-5 x
    its largest |value|);
  - each rank's handle, and the collectives it counted.
- One launch of four gloo ranks: the primitives again on a (1, 4) mesh (1
  to 16 rows a rank: a 7x7 conv's halo then comes from three ranks up;
  16, 8, 8, 8 at a height of 40), full RAFT at 48x64 (16, 16, 8, 8 rows)
  against JAX unsharded, JAX's GSPMD run over 4 devices and one process,
  and a (2, 2) mesh, each spatial pair on its own image, whose data groups
  are the mesh's columns; on it the train step, one sample a data group
  and 24 + 16 rows a spatial pair, against JAX and one process at batch
  2, and its noise rows; the fine-tune step likewise (RAFT: its BatchNorm
  over all four ranks).
- In the launch of two ranks also, on CPU tensors: the train and
  fine-tune steps with graphed=True and a handle bit-equal to graphed=False
  (loss, reduced gradients, running statistics, collectives and bytes);
  StreamAccumulator's pushes bit-equal to step_fn's; the gathers under
  gloo bit-equal to a host all_gather, NCCL's all_gather_into_tensor never
  called.
- Without processes: make_mesh's rank layout against JAX's reshape of the
  device list, split_rows' blocks, and the refusals (a height not a
  multiple of 8, fewer rows at 1/8 than ranks, unequal blocks the handle
  was not given); a graphed step with a handle is a CudaGraphedStep.
"""

import contextlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from accflow_tpu_torch import graphs
from accflow_tpu_torch.convert import load_jax_params, load_npz_tree, save_npz_tree, to_jax_params
from accflow_tpu_torch.data.synthetic import make_long_sequence
from accflow_tpu_torch.models import (
    AccFlowConfig,
    accflow_forward,
    build_flow_estimator,
    init_accflow,
)
from accflow_tpu_torch.models.encoders import BasicEncoder
from accflow_tpu_torch.nn import layers
from accflow_tpu_torch.ops.deform import deform_conv3x3
from accflow_tpu_torch.ops.grids import downflow8, upflow8
from accflow_tpu_torch.ops.sampling import backwarp
from accflow_tpu_torch.ops.upsample import convex_upsample
from accflow_tpu_torch.ops.warmstart import forward_splat_flow
from accflow_tpu_torch.parallel import mesh
from accflow_tpu_torch.streaming import StreamAccumulator, make_streaming_fns
from accflow_tpu_torch.train import engine, finetune
from accflow_tpu_torch.train.optim import make_optimizer

WORLD, SIZE, ITERS = 2, 128, 2
LOOKUPS = ("fused", "ondemand:64", "experimental:fused_bd")
MIX = "experimental:fused_mix:rows,rows_gx,vpu_y,mm"  # the mix clip's lookup (PyTorch ops only)
GMA_SIZE = 64  # GMA's pair, clip and stream (c): 64^2
# GMA's attention branches and attn_chunk: dense, chunks of 16 local query
# rows (2 a rank), "auto" (resolved at the global shape), and the
# relative-position branch beside the content one (its score takes the
# queries' global rows; max_pos_size covers the 8 rows and columns at 1/8).
GMA_VARIANTS = {"dense": {}, "chunk16": dict(attn_chunk=16), "auto": dict(attn_chunk=-1),
                "positional": dict(position_and_content=True, max_pos_size=10)}
SMALL_LOOKUPS = ("fused", "ondemand:64")  # RAFT-small at 128^2: 1 and 2 chunks a rank
DRIFT_FRAMES = 10  # the drift fixture's prefix: a reset on 3 frames and 7 pushes
CLIP40 = (4, 1, 40, 48, 3)  # the clip at a height of 40: 24 + 16 rows over 2 ranks
RAFT48 = (1, 48, 64, 3)  # RAFT over 4 ranks: 16, 16, 8, 8 rows
# The clip paths a handle reaches beside the fused one, each at CLIP40, and
# the JAX clip each is held to (the stepwise paths compute the fused paths'
# function of their direction).
CLIP_PATHS = {"warm start": dict(warm_start=True), "f0n fused": dict(direction="forward"),
              "f0n stepwise": dict(direction="forward", fused_ofe=False),
              "stepwise": dict(fused_ofe=False)}
CLIP_JAX = {"warm start": "clip 40 warm start", "f0n fused": "clip 40 f0n",
            "f0n stepwise": "clip 40 f0n", "stepwise": "clip 40"}
# The sharded train step: a batch of 2 clips of CLIP40's shape, AccFlow
# hidden 32 (its ZeroConv drawn), on each path JAX's step trains.
TRAIN_BATCH, TRAIN_HIDDEN, TRAIN_LR = 2, 32, 1e-4
TRAIN_PATHS = {"fused": {}, "f0n fused": dict(direction="forward"),
               "stepwise": dict(fused_ofe=False), "remat full": dict(remat="full")}
GRAD_REL = 1e-4  # sharded against one process, relative L2 of the gradients
# The estimators' sharded fine-tune step (make_finetune_step with a handle):
# a batch of 2 pairs at 40x48 (24 + 16 rows, 3 + 2 at 1/8), float32, 2 GRU
# iterations, remat "dots" (the step's default). Full RAFT and GMA (its
# positional branch, gamma drawn) from their seed-0 weights with drawn
# running statistics, RAFT-small from the launch's. "raft" and "gma" run
# without noise (JAX draws its own), the others with it. "ondemand:6" cuts
# each rank's 18 and 12 queries an image into 3 and 2 chunks.
FT_SHAPE = (2, 40, 48)
FT_PATHS = {"raft": dict(model="raft"), "gma": dict(model="gma"),
            "ondemand": dict(model="raft", corr_lookup="ondemand:6", noise=True),
            "small": dict(model="small", noise=True),
            "grad_accum 2": dict(model="raft", grad_accum=2, noise=True)}
FT_JAX = ("raft", "gma")  # the paths held against JAX's make_finetune_step
FT_GAMMA = 0.85
# A ReLU input within TIE_REL of its tensor's median |value| of zero is a
# tie, which float32 roundings of another summation order (halo rows, the
# ranks' statistics combined) may put on the other side of the kink: at
# "raft"'s first GRU iteration one of flow_head.conv1's outputs is -9.2e-8
# in one process and +4.3e-7 on rank 0, which moves every cnet leaf's
# gradient by ~4e-3 of its largest element. So the sharded step takes one
# process's value at each tie (_relu_ties; chip_smoke.py's relu_ties, whose
# one process takes the ranks' values) and counts them.
TIE_REL = 1e-5
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PRIM_TOL = dict(rtol=1e-5, atol=1e-5)
FLOW_TOL = dict(rtol=1e-3, atol=1e-3)  # tests/test_sharding.py's sharded-vs-unsharded bar
ACC_TOL = dict(rtol=2e-3, atol=2e-2)  # the AccFlow and stream bar (tests/test_torch_accflow.py)
# Beside those bars, a sharded output is held to JAX's within FLOW_REL x
# max |flow|. With random weights the clip's and the stream's flows are
# ~0.1 px, below ACC_TOL's atol, so that bar alone passes rows put in the
# wrong place (every rank's coordinates starting at row 0: 2.7e-2 and
# 7.4e-2 x max |flow| off). In float32 the two packages differ by summation
# order, ~3e-6 x max |flow| at these shapes.
FLOW_REL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAFT33 = dict(corr_levels=3, corr_radius=3)  # the estimator options' RAFT
GROUP_OUT = 64  # the group-norm basic encoder's output channels


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs, restored after
    (several test workers share the machine: test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The primitives: each builds its whole inputs from a seed, runs on this
# rank's rows (spatial) or on the whole image (None), and returns the whole
# output (its rows gathered).
# ---------------------------------------------------------------------------

def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _bound(sp, height):
    """The handle given the frames' height (mesh.split_rows: unequal blocks
    where the 1/8 rows do not split evenly); None as it is."""
    return sp if sp is None or height is None else sp.at_height(height)


def _conv(k, stride, h=32, height=None):
    """A conv on h rows; with `height`, a handle given that frame height."""
    def run(sp):
        sp = _bound(sp, height)
        rng = np.random.default_rng(10 * k[0] + k[1] + stride + h)
        x, w, b = _t(rng, 2, 3, h, 20), _t(rng, 4, 3, *k), _t(rng, 4)
        y = layers.conv2d(mesh.shard_rows(x, sp, 2), w, b, stride, spatial=sp)
        return mesh.gather_rows(y, sp, 2)
    return run


def _instance_norm(h=32, height=None):
    def run(sp):
        sp = _bound(sp, height)
        rng = np.random.default_rng(1)
        x = _t(rng, 2, 5, h, 20, scale=3.0) + _t(rng, 1, 5, 1, 1, scale=2.0)
        y = layers.instance_norm(mesh.shard_rows(x, sp, 2), spatial=sp)
        return mesh.gather_rows(y, sp, 2)
    return run


def _bn_inputs(h=40):
    """Train-mode BatchNorm's input (2, 5, h, 20), weight, bias and running
    statistics, seed 11."""
    rng = np.random.default_rng(11)
    x = _t(rng, 2, 5, h, 20, scale=3.0) + _t(rng, 1, 5, 1, 1, scale=2.0)
    var = torch.from_numpy(rng.uniform(0.5, 2.0, 5).astype(np.float32))
    return x, _t(rng, 5), _t(rng, 5), _t(rng, 5, scale=0.1), var


def _batch_norm(sp):
    """batch_norm_train on each rank's rows at a height of 40 (24 + 16, over
    4 ranks 16, 8, 8, 8): the output gathered, then the moved running mean
    and variance (the spatial group's statistics, weighted by rows)."""
    sp = _bound(sp, 40)
    x, w, b, rm, rv = _bn_inputs()
    y, mean, var = layers.batch_norm_train(mesh.shard_rows(x, sp, 2), w, b, rm, rv, spatial=sp)
    return torch.cat([mesh.gather_rows(y, sp, 2).reshape(-1), mean, var])


def _upflow8(h8, height=None):
    """upflow8 of an h8-row field at 1/8 (with `height`: blocks of 3 + 2
    rows at 1/8 over 2 ranks, 2, 1, 1, 1 over 4, for a height of 40)."""
    def run(sp):
        sp = _bound(sp, height)
        flow = _t(np.random.default_rng(7 + h8), 2, h8, 6, 2, scale=3.0)
        return mesh.gather_rows(upflow8(mesh.shard_rows(flow, sp), sp), sp)
    return run


def _halo(h, top, bottom, height):
    """halo_rows itself: each rank's rows with their halo, as windows of
    top + 1 + bottom rows about each of its rows, against the zero-padded
    image's (a handle given `height`; h rows, at that scale)."""
    def run(sp):
        sp = _bound(sp, height)
        x = _t(np.random.default_rng(8 + h + top), 2, 3, h, 5)
        if sp is None:
            ext, rows = F.pad(x, (0, 0, top, bottom)), h
        else:
            xl = mesh.shard_rows(x, sp, 2)
            above, below = mesh.halo_rows(xl, sp, top, bottom)
            ext, rows = torch.cat([above, xl, below], 2), xl.shape[2]
        win = torch.stack([ext[:, :, i:i + rows] for i in range(top + 1 + bottom)], 1)
        return mesh.gather_rows(win.flatten(1, 2), sp, 2)
    return run


def _convex_upsample(sp):
    rng = np.random.default_rng(2)
    flow, mask = _t(rng, 2, 8, 10, 2, scale=3.0), _t(rng, 2, 8, 10, 576)
    up = convex_upsample(mesh.shard_rows(flow, sp), mesh.shard_rows(mask, sp), sp)
    return mesh.gather_rows(up, sp)


def _downflow8(sp):
    flow = _t(np.random.default_rng(3), 2, 64, 40, 2, scale=5.0)
    return mesh.gather_rows(downflow8(mesh.shard_rows(flow, sp), sp), sp)


def _backwarp(sp):
    rng = np.random.default_rng(4)
    image, flow = _t(rng, 2, 16, 12, 3), _t(rng, 2, 16, 12, 2, scale=4.0)
    return mesh.gather_rows(backwarp(image, mesh.shard_rows(flow, sp), sp), sp)


def _deform(sp):
    rng = np.random.default_rng(5)
    x, off, m = _t(rng, 2, 4, 16, 12), _t(rng, 2, 18, 16, 12, scale=3.0), _t(rng, 2, 9, 16, 12)
    w, b = _t(rng, 5, 4, 3, 3), _t(rng, 5)
    rows = [mesh.shard_rows(a, sp, 2) for a in (x, off, torch.sigmoid(m))]
    return mesh.gather_rows(deform_conv3x3(*rows, w, b, sp), sp, 2)


def _splat(sp):
    rng = np.random.default_rng(6)
    flow, advect = _t(rng, 2, 16, 12, 2, scale=3.0), _t(rng, 2, 16, 12, 2, scale=3.0)
    out = forward_splat_flow(mesh.shard_rows(flow, sp), mesh.shard_rows(advect, sp), sp)
    return mesh.gather_rows(out, sp)


def _vjp(fn, xs, dims, cot, cot_dim, height=None):
    """The exchanges' backward: each rank's part of the loss is its rows of
    fn's output against the cotangent `cot`, and it back-propagates that
    part alone (train/loss.py's convention); the gradients of the inputs
    `xs` (whole, each sharded along its entry of `dims`), gathered and
    flattened into one vector."""
    def run(sp):
        sp = _bound(sp, height)
        local = [mesh.shard_rows(x, sp, d).clone().requires_grad_(True) for x, d in zip(xs, dims)]
        (fn(sp, *local) * mesh.shard_rows(cot, sp, cot_dim)).sum().backward()
        grads = [torch.zeros_like(x) if x.grad is None else x.grad for x in local]
        return torch.cat([mesh.gather_rows(g, sp, d).reshape(-1) for g, d in zip(grads, dims)])
    return run


def _grad_cases() -> dict:
    """Input gradients through each exchange, against one process's."""
    rng = np.random.default_rng(9)
    x40, w7, b4 = _t(rng, 2, 3, 40, 20), _t(rng, 4, 3, 7, 7), _t(rng, 4)
    n40 = _t(rng, 2, 5, 40, 20, scale=3.0) + _t(rng, 1, 5, 1, 1, scale=2.0)
    up, fl = _t(rng, 2, 5, 6, 2, scale=3.0), _t(rng, 2, 8, 10, 2, scale=3.0)
    mask = _t(rng, 2, 8, 10, 576)
    dx, doff, dm = _t(rng, 2, 4, 16, 12), _t(rng, 2, 18, 16, 12, scale=3.0), _t(rng, 2, 9, 16, 12)
    dw, db = _t(rng, 5, 4, 3, 3), _t(rng, 5)
    canvas = _t(rng, 2, 16, 12, 3)
    bn_x, bn_w, bn_b, bn_rm, bn_rv = _bn_inputs()

    def flipped_sum(sp, x):
        # Each rank's rows placed in a full-height canvas upside down, the
        # canvases summed: rank i's rows land in other ranks' rows.
        if sp is None:
            return x.flip(1)
        h, r0 = sp.height(x.shape[1]), sp.row0(x.shape[1])
        full = x.new_zeros((x.shape[0], h) + x.shape[2:])
        full = full.index_copy(1, torch.arange(r0, r0 + x.shape[1]), x)
        return mesh.shard_rows(mesh.sum_ranks(full.flip(1), sp), sp)

    return {
        "conv 7x7/2 uneven grad": _vjp(lambda sp, x: layers.conv2d(x, w7, b4, 2, spatial=sp),
                                       [x40], [2], _t(rng, 2, 4, 20, 10), 2, 40),
        "instance_norm uneven grad": _vjp(lambda sp, x: layers.instance_norm(x, spatial=sp),
                                          [n40], [2], _t(rng, 2, 5, 40, 20), 2, 40),
        "upflow8 uneven grad": _vjp(lambda sp, x: upflow8(x, sp), [up[:, :5]], [1],
                                    _t(rng, 2, 40, 48, 2), 1, 40),
        "convex_upsample grad": _vjp(lambda sp, f, m: convex_upsample(f, m, sp), [fl, mask],
                                     [1, 1], _t(rng, 2, 64, 80, 2), 1),
        "deform_conv3x3 grad": _vjp(lambda sp, x, o, m: deform_conv3x3(x, o, torch.sigmoid(m),
                                                                       dw, db, sp),
                                    [dx, doff, dm], [2, 2, 2], _t(rng, 2, 5, 16, 12), 2),
        "sum_ranks grad": _vjp(flipped_sum, [canvas], [1], _t(rng, 2, 16, 12, 3), 1),
        "batch_norm uneven grad": _vjp(
            lambda sp, x: layers.batch_norm_train(x, bn_w, bn_b, bn_rm, bn_rv, spatial=sp)[0],
            [bn_x], [2], _t(rng, 2, 5, 40, 20), 2, 40),
    }


PRIMITIVES = {
    "conv 3x3": _conv((3, 3), 1), "conv 7x7/2": _conv((7, 7), 2),
    "conv 3x3/2": _conv((3, 3), 2), "conv 1x1/2": _conv((1, 1), 2),
    "conv 5x1": _conv((5, 1), 1), "conv 1x5": _conv((1, 5), 1),
    "conv 7x7 on 4 rows": _conv((7, 7), 1, h=4),
    "instance_norm": _instance_norm(), "convex_upsample": _convex_upsample,
    "downflow8": _downflow8, "backwarp": _backwarp, "deform_conv3x3": _deform,
    "forward_splat_flow": _splat, "upflow8": _upflow8(8),
    # Unequal blocks: a height of 40 is 24 + 16 rows over 2 ranks, 16, 8, 8,
    # 8 over 4 (at 1/8: 3 + 2, and 2, 1, 1, 1).
    "upflow8 uneven": _upflow8(5, 40), "instance_norm uneven": _instance_norm(40, 40),
    "halo_rows uneven": _halo(40, 3, 2, 40), "halo_rows uneven at 1/8": _halo(5, 3, 3, 40),
    "conv 7x7/2 uneven": _conv((7, 7), 2, h=40, height=40),
    "batch_norm uneven": _batch_norm,
}
# The exchanges' backward, each rank back-propagating its rows of the
# output. The gradients sum 8 to 81 products each (|grad| up to ~70), which
# the sharded backward adds in another order: held within GRAD_PRIM_REL of
# the largest |grad| (float32 rounding; a lost or unsummed halo, gather or
# sum moves whole rows by their size).
GRAD_PRIMITIVES = _grad_cases()
GRAD_PRIM_REL = 1e-6


# ---------------------------------------------------------------------------
# The models: weights and frames written by the launch, read by each rank
# and by the references
# ---------------------------------------------------------------------------

def _estimator(work: str, lookup: str):
    est = build_flow_estimator("raft", compute_dtype="float32", iters=ITERS, device="cpu",
                               corr_lookup=lookup)
    load_jax_params(est.model, load_npz_tree(f"{work}/ofe.npz"))
    return est


def _accumulator(work: str, **cfg):
    acc = init_accflow(AccFlowConfig(compute_dtype="float32", **cfg), device="cpu")
    return load_jax_params(acc, load_npz_tree(f"{work}/acc.npz"))


def _branch(variant: str) -> str:
    """The attention branch of a GMA variant, which names its weights and
    its JAX reference (the chunked and auto variants are the content
    branch's function)."""
    return "positional" if variant == "positional" else "content"


def _branch_cfg(branch: str) -> dict:
    return GMA_VARIANTS["positional"] if branch == "positional" else {}


def _gma(work: str, variant: str):
    est = build_flow_estimator("gma", compute_dtype="float32", iters=ITERS, device="cpu",
                               **GMA_VARIANTS[variant])
    load_jax_params(est.model, load_npz_tree(f"{work}/gma {_branch(variant)}.npz"))
    return est


def _small(work: str, lookup: str):
    est = build_flow_estimator("raft", compute_dtype="float32", iters=ITERS, device="cpu",
                               small=True, corr_lookup=lookup)
    load_jax_params(est.model, load_npz_tree(f"{work}/small.npz"))
    return est


def _raft33(work: str):
    """Full RAFT at corr_levels 3, corr_radius 3 (convc1 takes 3 x 49
    channels), from the launch's weights."""
    est = build_flow_estimator("raft", compute_dtype="float32", iters=ITERS, device="cpu",
                               **RAFT33)
    load_jax_params(est.model, load_npz_tree(f"{work}/ofe33.npz"))
    return est


def _group_encoder(work: str):
    return load_jax_params(BasicEncoder(GROUP_OUT, "group"), load_npz_tree(f"{work}/group.npz"))


def _drift_models():
    """The drift fixture's trained RAFT-small (6 iterations) and hidden-64
    warm-start accumulator (tests/test_torch_stream.py)."""
    est = build_flow_estimator("raft", compute_dtype="float32", device="cpu", small=True,
                               iters=6)
    load_jax_params(est.model, load_npz_tree(f"{FIXTURES}/drift_small_ofe.npz"))
    acc = init_accflow(AccFlowConfig(hidden=64, compute_dtype="float32", warm_start=True),
                       device="cpu")
    return est, load_jax_params(acc, load_npz_tree(f"{FIXTURES}/drift_small_acc.npz"))


def _models(sp, work: str) -> dict:
    """The RAFT, GMA and RAFT-small forwards, the clips and the streams on
    this rank's rows (sp), or on the whole frames (None: the port's
    one-process runs); outputs whole, with the collectives each case
    counted."""
    data = np.load(f"{work}/inputs.npz")
    out = {}

    def case(name, fn):
        c0, b0 = mesh.collectives, mesh.bytes_sent
        out[name] = fn().numpy()
        out[f"{name}/collectives"] = mesh.collectives - c0
        out[f"{name}/bytes"] = mesh.bytes_sent - b0

    for lookup in LOOKUPS:
        est = _estimator(work, lookup)
        i1, i2 = (mesh.shard_rows(torch.from_numpy(data[k]), sp) for k in ("i1", "i2"))
        case(f"raft {lookup}",
             lambda: mesh.gather_rows(est.forward(i1, i2, spatial=sp)["flow_up"], sp))
    est, acc = _estimator(work, "ondemand:64"), _accumulator(work)
    clip = mesh.shard_rows(torch.from_numpy(data["clip"]), sp, 2)
    case("clip", lambda: mesh.gather_rows(
        accflow_forward(acc, clip, est.pairs_fn(spatial=sp), spatial=sp), sp, 2))
    sp40 = None if sp is None else sp.at_height(CLIP40[2])
    clip40 = mesh.shard_rows(torch.from_numpy(data["clip40"]), sp40, 2)
    case("clip 40", lambda: mesh.gather_rows(
        accflow_forward(acc, clip40, est.pairs_fn(spatial=sp40), spatial=sp40), sp40, 2))
    for name, cfg in CLIP_PATHS.items():
        acc_p = _accumulator(work, **cfg)
        case(f"clip 40 {name}", lambda: mesh.gather_rows(accflow_forward(
            acc_p, clip40, est.pairs_fn(spatial=sp40), est.flow_fn(spatial=sp40), spatial=sp40),
            sp40, 2))

    mix_clip = mesh.shard_rows(torch.from_numpy(data["gma_clip"][:4]), sp, 2)
    case("clip mix", lambda: mesh.gather_rows(accflow_forward(
        acc, mix_clip, _estimator(work, MIX).pairs_fn(spatial=sp), spatial=sp), sp, 2))

    def run_stream(stream, frames):  # a reset on 3 frames, then a push of each other
        frames = mesh.shard_rows(frames, sp, 2)
        outs = [stream.reset(frames[:3])] + [stream.push(f) for f in frames[3:]]
        return mesh.gather_rows(torch.stack(outs), sp, 2)

    stream = torch.from_numpy(data["stream"])
    case("stream", lambda: run_stream(StreamAccumulator(
        _estimator(work, "fused"), _accumulator(work, warm_start=True), spatial=sp), stream))

    # GMA: a pair, the clip (each attention variant) and stream (c), at 64^2.
    g_clip = torch.from_numpy(data["gma_clip"])
    g_rows = mesh.shard_rows(g_clip, sp, 2)
    for v in GMA_VARIANTS:
        g_est = _gma(work, v)
        case(f"gma {v}", lambda: mesh.gather_rows(
            g_est.forward(g_rows[0], g_rows[1], spatial=sp)["flow_up"], sp))
        case(f"gma clip {v}", lambda: mesh.gather_rows(
            accflow_forward(acc, g_rows, g_est.pairs_fn(spatial=sp), spatial=sp), sp, 2))
    case("gma stream", lambda: run_stream(StreamAccumulator(
        _gma(work, "dense"), _accumulator(work, warm_start=True), spatial=sp), g_clip))

    # RAFT-small (kernel #2's path): a pair with each lookup, stream (a).
    for lookup in SMALL_LOOKUPS:
        small = _small(work, lookup)
        i1, i2 = (mesh.shard_rows(torch.from_numpy(data[k]), sp) for k in ("i1", "i2"))
        case(f"small {lookup}",
             lambda: mesh.gather_rows(small.forward(i1, i2, spatial=sp)["flow_up"], sp))
    case("small stream", lambda: run_stream(StreamAccumulator(
        _small(work, "fused"), _accumulator(work, warm_start=True), spatial=sp), stream))
    case("drift", lambda: run_stream(StreamAccumulator(*_drift_models(), spatial=sp),
                                     torch.from_numpy(data["drift"])))

    # The estimator options: RAFT (3, 3)'s pair, a group-norm basic encoder
    # at 24 + 16 rows (its NCHW output gathered along the height).
    est33 = _raft33(work)
    i1, i2 = (mesh.shard_rows(torch.from_numpy(data[k]), sp) for k in ("i1", "i2"))
    case("raft 33", lambda: mesh.gather_rows(est33.forward(i1, i2, spatial=sp)["flow_up"], sp))
    enc = _group_encoder(work)
    frame = mesh.shard_rows(torch.from_numpy(data["clip40"][0]), sp40).permute(0, 3, 1, 2)

    def encode():
        with torch.no_grad(), layers.spatial_sharding(enc, sp40):
            return mesh.gather_rows(enc(frame), sp40, 2)

    case("group encoder", encode)
    return out


def _train_batch(work: str, data_index: int = 0, n_data: int = 1, sp=None):
    """The train batch (imgs (N, H, W, 3T), label flows (N, H, W, 2S)):
    this data group's samples, this rank's rows of them."""
    data = np.load(f"{work}/train.npz")
    n = TRAIN_BATCH // n_data
    return [mesh.shard_rows(torch.from_numpy(data[k][data_index * n: (data_index + 1) * n]), sp)
            for k in ("imgs", "labels")]


def _train_step(work: str, path: str, sp=None, group=None, data_index: int = 0,
                n_data: int = 1, valid: bool = False) -> dict:
    """One sharded train step (make_acc_train_step with the data `group`
    and the handle, eager, no noise) on path `path`: its loss and the
    gradients its update reduced, before the clip (read where
    mesh.average_gradients leaves them), as JAX-layout leaves; with
    `valid`, first valid_step's per-sample EPE and last output (whole)."""
    est = _estimator(work, "fused")
    acc = init_accflow(AccFlowConfig(hidden=TRAIN_HIDDEN, compute_dtype="float32",
                                     **TRAIN_PATHS[path]), device="cpu")
    load_jax_params(acc, load_npz_tree(f"{work}/acc32.npz"))
    step, valid_step = engine.make_acc_train_step(
        est, acc, make_optimizer(acc.parameters(), TRAIN_LR, 10), add_noise=False, group=group,
        spatial=sp)
    imgs, labels = _train_batch(work, data_index, n_data, sp)
    out = {}
    if valid:
        epe, last = valid_step(imgs, labels)
        out.update({"train/valid/epe": epe.numpy(),
                    "train/valid/out": mesh.gather_rows(last, sp).numpy()})
    grads, average = [], mesh.average_gradients

    def record(params, grp, spatial=None):
        average(params, grp, spatial)
        grads.extend(p.grad.clone() for p in params)

    mesh.average_gradients = record
    try:
        loss, _ = step(imgs, labels)
    finally:
        mesh.average_gradients = average
    with torch.no_grad():
        for p, g in zip(acc.parameters(), grads):
            p.copy_(g)
    out[f"train/{path}/loss"] = np.array(float(loss))
    out.update({f"train/{path}/g/{k}": v for k, v in _leaves(to_jax_params(acc)).items()})
    return out


def _leaves(tree, prefix=""):
    """{path: numpy leaf} of a nested dict (test_torch_train.py's, which
    imports jax: the ranks do not)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _train_noise(sp=None, group=None, n: int = TRAIN_BATCH) -> np.ndarray:
    """reference_noise for this rank's n samples of a CLIP40-shaped clip,
    from a generator at seed 5, its rows gathered."""
    h = CLIP40[2] if sp is None else sp.split(CLIP40[2])[sp.index]
    noise = engine.reference_noise(torch.Generator().manual_seed(5), (n, h) + CLIP40[3:],
                                   group, sp)
    return mesh.gather_rows(noise, sp).numpy()


def _train_cases(work: str, sp=None) -> dict:
    """The train step on every path of TRAIN_PATHS, and the noise, on a
    (1, 2) mesh's rows (sp, given the height) or in one process (None)."""
    sp = _bound(sp, CLIP40[2])
    out = {"train/noise": _train_noise(sp)}
    for path in TRAIN_PATHS:
        out.update(_train_step(work, path, sp, valid=path == "fused"))
    return out


class _Iters:
    """An estimator whose every call runs `iters` GRU iterations (the
    fine-tune step's 12 and 20 cut, as tests/test_torch_finetune.py's
    TIters)."""

    def __init__(self, est, iters):
        self.est, self.iters, self.model = est, iters, est.model

    def forward(self, image1, image2, iters=None, **kw):
        return self.est.forward(image1, image2, iters=self.iters, **kw)


def _ft_estimator(work: str, path: str):
    cfg = dict(FT_PATHS[path])
    model = cfg.pop("model")
    for k in ("noise", "grad_accum"):
        cfg.pop(k, None)
    if model == "small":
        return _small(work, cfg.get("corr_lookup", "fused"))
    if model == "gma":
        cfg.update(GMA_VARIANTS["positional"])
    est = build_flow_estimator(model, compute_dtype="float32", device="cpu", **cfg)
    load_jax_params(est.model, load_npz_tree(f"{work}/ft {model}.npz"))
    return est


def _ft_batch(work: str, data_index: int = 0, n_data: int = 1, sp=None):
    """The fine-tune batch (img1, img2, label): this data group's samples,
    this rank's rows of them."""
    data = np.load(f"{work}/ft.npz")
    n = FT_SHAPE[0] // n_data
    return [mesh.shard_rows(torch.from_numpy(data[k][data_index * n: (data_index + 1) * n]), sp)
            for k in ("img1", "img2", "label")]


@contextlib.contextmanager
def _relu_inputs(fn):
    """Within the block every torch.relu (F.relu and nn.ReLU call it) is of
    fn(call, input) in place of its input."""
    relu, calls = torch.relu, []

    def watched(x):
        calls.append(1)
        return relu(fn(len(calls) - 1, x))

    torch.relu = watched
    try:
        yield
    finally:
        torch.relu = relu


def _relu_ties(ref: list, sp, data_index: int, n_data: int, batch: int, ties: list):
    """_relu_inputs by which each ReLU input takes one process's value
    (`ref`: one process's ReLU inputs, NCHW, on the whole micro-batch of
    `batch` samples, frames of a pair batch-major, and the whole height;
    this data group's samples and this rank's rows of them) where the two
    lie on opposite sides of zero, each within TIE_REL of its tensor's
    median |value|: a tie. The gradient passes unchanged; `ties` gets
    (call, elements) of each."""
    def take(call, x):
        whole = ref[call]
        k, n = whole.shape[0] // batch, batch // n_data
        other = mesh.shard_rows(whole.view(k, batch, *whole.shape[1:])[
            :, data_index * n: (data_index + 1) * n].flatten(0, 1), sp, 2)
        o = x.detach()
        tie = ((o * other < 0) & (o.abs() <= TIE_REL * o.abs().median())
               & (other.abs() <= TIE_REL * other.abs().median()))
        if not bool(tie.any()):
            return x
        ties.append((call, int(tie.sum())))
        return x + ((other - o) * tie).detach()
    return _relu_inputs(take)


def _ft_step(work: str, path: str, sp=None, group=None, data_index: int = 0, n_data: int = 1,
             valid: bool = False, record=None) -> dict:
    """One sharded fine-tune step (make_finetune_step with the data `group`
    and the handle, eager) on path `path`, the generator at seed 5: its
    loss, the gradients its update reduced (before the clip, as JAX-layout
    leaves), the running statistics after it, the noise it drew (gathered),
    the collectives and bytes it counted and, with a handle, the ReLU ties
    at which it took one process's values (_relu_ties, one process's step
    run here first); with `valid`, first valid_step's per-sample EPE and
    flow (gathered) on the pair. `record`: a list that gets the step's ReLU
    inputs."""
    cfg = FT_PATHS[path]
    ref, ties = [], []
    if sp is not None:
        _ft_step(work, path, record=ref)
    est = _ft_estimator(work, path)
    step, valid_step = finetune.make_finetune_step(
        _Iters(est, ITERS), make_optimizer(est.model.parameters(), TRAIN_LR, 10),
        add_noise=cfg.get("noise", False), gamma=FT_GAMMA, grad_accum=cfg.get("grad_accum", 1),
        group=group, spatial=sp)
    img1, img2, label = _ft_batch(work, data_index, n_data, sp)
    pre, out = f"ft/{path}/", {}
    if valid:
        epe, flow = valid_step(torch.cat([img1, img2], -1), label)
        out.update({pre + "valid/epe": epe.numpy(),
                    pre + "valid/flow": mesh.gather_rows(flow, sp).numpy()})
    grads, noises, average, draw = [], [], mesh.average_gradients, finetune.reference_noise

    def reduce(params, grp, spatial=None):
        average(params, grp, spatial)
        grads.extend(p.grad.clone() for p in params)

    def noise(*a):
        noises.append(draw(*a))
        return noises[-1]

    if sp is not None:
        watch = _relu_ties(ref, sp, data_index, n_data, FT_SHAPE[0] // cfg.get("grad_accum", 1),
                           ties)
    else:
        watch = _relu_inputs(lambda call, x: x if record is None else record.append(
            x.detach().clone()) or x)
    mesh.average_gradients, finetune.reference_noise = reduce, noise
    c0, b0 = mesh.collectives, mesh.bytes_sent
    try:
        # A checkpoint's recompute runs to the iteration's end, so that one
        # process sees as many ReLU calls as a rank.
        with watch, torch.utils.checkpoint.set_checkpoint_early_stop(False):
            loss, _ = step(img1, img2, label, torch.Generator().manual_seed(5))
    finally:
        mesh.average_gradients, finetune.reference_noise = average, draw
    out.update({pre + "loss": np.array(float(loss)), pre + "ties": np.array(len(ties)),
                pre + "collectives": np.array(mesh.collectives - c0),
                pre + "bytes": np.array(mesh.bytes_sent - b0)})
    if noises:
        out[pre + "noise"] = mesh.gather_rows(noises[0], sp).numpy()
    leaves = _leaves(to_jax_params(est.model))
    out.update({pre + "bn/" + k: v for k, v in leaves.items() if k.endswith(("/mean", "/var"))})
    with torch.no_grad():
        for p, g in zip(est.model.parameters(), grads):
            p.copy_(g)
    out.update({pre + "g/" + k: v for k, v in _leaves(to_jax_params(est.model)).items()
                if not k.endswith(("/mean", "/var"))})
    return out


def _ft_cases(work: str, sp=None) -> dict:
    """The fine-tune step on every path of FT_PATHS (valid_step on "raft"),
    on a (1, 2) mesh's rows (sp, given the height) or in one process."""
    sp = _bound(sp, FT_SHAPE[1])
    out = {}
    for path in FT_PATHS:
        out.update(_ft_step(work, path, sp, valid=path == "raft"))
    return out


def _graphed_step(pre: str, model, call) -> dict:
    """One call of a train step: its loss, the gradients its update reduced
    (before the clip), the running statistics after it and the collectives
    and bytes it counted, as numpy under `pre`."""
    grads, average = [], mesh.average_gradients

    def record(params, grp, spatial=None):
        average(params, grp, spatial)
        grads.extend(p.grad.clone() for p in params)

    mesh.average_gradients = record
    c0 = mesh.counts()
    try:
        loss, _ = call()
    finally:
        mesh.average_gradients = average
    out = {pre + "loss": np.array(float(loss)),
           pre + "counts": np.array([a - b for a, b in zip(mesh.counts(), c0)])}
    out.update({f"{pre}g/{i}": g.numpy() for i, g in enumerate(grads)})
    out.update({f"{pre}bn/{k}": v.numpy() for k, v in model.state_dict().items()
                if "running" in k})
    return out


def _graphed_cases(work: str, sp) -> dict:
    """Under the handle, on CPU tensors (where the graphed wrappers call the
    step as it is): make_acc_train_step and make_finetune_step (full RAFT)
    with graphed=True and graphed=False, noise on, one step each at 24 + 16
    rows (_graphed_step); StreamAccumulator's reset and pushes (stream (b))
    beside make_streaming_fns' init and step_fn on the same rows; and
    stack_ranks, gather_rows and host_array with all_gather_into_tensor
    refused (gloo never takes NCCL's path), beside an all_gather of the
    same tensors stacked, whether a graph may capture the handle's group
    (mesh.collectives_capturable)."""
    out = {}
    sp40, sp_ft = sp.at_height(CLIP40[2]), sp.at_height(FT_SHAPE[1])
    for graphed in (False, True):
        acc = init_accflow(AccFlowConfig(hidden=TRAIN_HIDDEN, compute_dtype="float32"),
                           device="cpu")
        load_jax_params(acc, load_npz_tree(f"{work}/acc32.npz"))
        step, _ = engine.make_acc_train_step(
            _estimator(work, "fused"), acc, make_optimizer(acc.parameters(), TRAIN_LR, 10),
            add_noise=True, graphed=graphed, spatial=sp40)
        imgs, labels = _train_batch(work, sp=sp40)
        out.update(_graphed_step(f"graphed/{graphed}/train/", acc,
                                 lambda: step(imgs, labels, torch.Generator().manual_seed(3))))
        est = _ft_estimator(work, "raft")
        step, _ = finetune.make_finetune_step(
            _Iters(est, ITERS), make_optimizer(est.model.parameters(), TRAIN_LR, 10),
            add_noise=True, gamma=FT_GAMMA, graphed=graphed, spatial=sp_ft)
        img1, img2, label = _ft_batch(work, sp=sp_ft)
        out.update(_graphed_step(f"graphed/{graphed}/ft/", est.model,
                                 lambda: step(img1, img2, label, torch.Generator().manual_seed(5))))

    est, acc = _estimator(work, "fused"), _accumulator(work, warm_start=True)
    frames = mesh.shard_rows(torch.from_numpy(np.load(f"{work}/inputs.npz")["stream"]), sp, 2)
    stream = StreamAccumulator(est, acc, spatial=sp)
    init, step_fn = make_streaming_fns(est, acc, spatial=sp)
    flow, state = init(frames[:3])
    fns = [flow]
    for f in frames[3:]:
        flow, state = step_fn(state, f)
        fns.append(flow)
    out["graphed/stream/accumulator"] = torch.stack(
        [stream.reset(frames[:3])] + [stream.push(f) for f in frames[3:]]).numpy()
    out["graphed/stream/step_fn"] = torch.stack(fns).numpy()

    x = torch.from_numpy(np.random.default_rng(40).standard_normal((2, 3, 8, 5)).astype(
        np.float32)) + sp.index
    gather_into = torch.distributed.all_gather_into_tensor

    def refuse(*a, **k):
        raise AssertionError("all_gather_into_tensor under gloo")

    torch.distributed.all_gather_into_tensor = refuse
    try:
        got = [mesh.stack_ranks(x, sp), mesh.gather_rows(x, sp, 2), mesh.host_array(x[:, 0, 0, 0])]
    finally:
        torch.distributed.all_gather_into_tensor = gather_into
    parts = [torch.empty_like(x) for _ in range(sp.size)]
    torch.distributed.all_gather(parts, x, group=sp.group)
    want = [torch.stack(parts), torch.cat(parts, 2), torch.cat([p[:, 0, 0, 0] for p in parts])]
    for name, a, b in zip(("stack", "rows", "host"), got, want):
        out[f"gloo/{name}"], out[f"gloo/{name}/ref"] = np.asarray(a), b.numpy()
    out["gloo/capturable"] = np.array(mesh.collectives_capturable(sp.group))
    return out


def _primitives(sp) -> dict:
    """Every primitive (and its backward) on this rank's rows, and in one
    process."""
    out = {}
    for name, fn in {**PRIMITIVES, **GRAD_PRIMITIVES}.items():
        out[f"prim/{name}"] = fn(sp).numpy()
        out[f"prim/{name}/ref"] = fn(None).numpy()
    return out


def _data_by_spatial(rank: int, work: str) -> dict:
    """A (2, 2) mesh: each data group's spatial pair runs a 3x3 conv and an
    instance norm on its own image (seed 100 + its data index), the data
    group sums each member's rank, and the train step runs on data x
    spatial (the gradients summed over each pair, averaged over the
    columns), with its noise rows."""
    m = mesh.make_mesh(n_data=2, n_spatial=2)
    d = rank // 2
    rng = np.random.default_rng(100 + d)
    x, w = _t(rng, 2, 3, 16, 12), _t(rng, 4, 3, 3, 3)

    def run(sp):
        y = layers.instance_norm(layers.conv2d(mesh.shard_rows(x, sp, 2), w, spatial=sp),
                                 spatial=sp)
        return mesh.gather_rows(y, sp, 2).numpy()

    ranks = torch.tensor([float(rank)])
    torch.distributed.all_reduce(ranks, group=m.data_group)
    # The train step: one sample a data group, 24 + 16 rows a spatial pair.
    sp = m.axis.at_height(CLIP40[2])
    step = _train_step(work, "fused", sp, m.data_group, d, 2)
    ft = _ft_step(work, "raft", m.axis.at_height(FT_SHAPE[1]), m.data_group, d, 2)
    return {"2x2/axis": np.array([m.axis.index, m.axis.size]), "2x2/out": run(m.axis),
            "2x2/ref": run(None), "2x2/data_sum": ranks.numpy(),
            "2x2/noise": _train_noise(sp, m.data_group, TRAIN_BATCH // 2),
            **{f"2x2/{k}": v for k, v in {**step, **ft}.items()}}


def _raft48(sp, work: str) -> dict:
    """Full RAFT on a 48x64 pair over the (1, 4) mesh: 6 rows at 1/8 split
    2, 2, 1, 1 (16, 16, 8, 8 rows), with the collectives it counted."""
    data = np.load(f"{work}/inputs.npz")
    sp = sp.at_height(RAFT48[1])
    i1, i2 = (mesh.shard_rows(torch.from_numpy(data[k]), sp) for k in ("i1", "i2"))
    c0 = mesh.collectives
    flow = mesh.gather_rows(_estimator(work, "fused").forward(i1, i2, spatial=sp)["flow_up"], sp)
    return {"raft48": flow.numpy(), "raft48/rows": np.array([i1.shape[1]]),
            "raft48/collectives": np.array([mesh.collectives - c0])}


def _child(mode: str, world: int, rank: int, port: int, work: str) -> None:
    """One rank of a launch: join the gloo group through torchrun's
    environment, make the mesh, run the primitives (each beside its
    one-process run) and, for "models", the models and the train step on a
    (1, 2) mesh, for "meshes" RAFT at 48x64 on the (1, 4) mesh and the data
    x spatial checks on a (2, 2) one; save what it saw."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    assert mesh.maybe_init_distributed("cpu")
    m = mesh.make_mesh(n_data=1, n_spatial=world)
    t0 = time.perf_counter()
    out = {"axis": np.array([m.axis.index, m.axis.size]), **_primitives(m.axis)}
    if mode == "models":
        out.update(_models(m.axis, work), **_train_cases(work, m.axis), **_ft_cases(work, m.axis),
                   **_graphed_cases(work, m.axis))
    else:
        out.update(_raft48(m.axis, work), **_data_by_spatial(rank, work))
    out["seconds"] = time.perf_counter() - t0
    np.savez(f"{work}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# The launch and the references
# ---------------------------------------------------------------------------

def _write_inputs(work: str) -> None:
    """Full RAFT's weights (seed 0), GMA's (seed 0, its gamma drawn in [2, 4]
    from seed 5: at its init of 0 the attention adds nothing), RAFT-small's
    (seed 0) and the accumulator's (hidden 128, seed 1, its ZeroConv drawn
    from seed 3), as JAX-layout trees, and the frames (uniform in [-1, 1],
    seeds as tests/test_sharding.py's; the drift fixture's first frames)."""
    save_npz_tree(f"{work}/ofe.npz", to_jax_params(
        build_flow_estimator("raft", compute_dtype="float32", device="cpu").model))
    save_npz_tree(f"{work}/small.npz", to_jax_params(
        build_flow_estimator("raft", compute_dtype="float32", device="cpu", small=True).model))
    save_npz_tree(f"{work}/ofe33.npz", to_jax_params(
        build_flow_estimator("raft", compute_dtype="float32", device="cpu", **RAFT33).model))
    group = to_jax_params(layers.init_weights(BasicEncoder(GROUP_OUT, "group"), 0))
    rng = np.random.default_rng(11)  # the group norms' scale and bias away from 1 and 0
    _draw_group_affine(group, rng)
    save_npz_tree(f"{work}/group.npz", group)
    for branch in ("content", "positional"):  # the tables' size follows max_pos_size
        gma = to_jax_params(build_flow_estimator(
            "gma", compute_dtype="float32", device="cpu", **_branch_cfg(branch)).model)
        gma["update_block"]["aggregator"]["gamma"] = np.random.default_rng(5).uniform(
            2.0, 4.0, (1,)).astype(np.float32)
        save_npz_tree(f"{work}/gma {branch}.npz", gma)
    acc = to_jax_params(init_accflow(AccFlowConfig(compute_dtype="float32"), device="cpu"))
    rng = np.random.default_rng(3)
    zc = acc["accplus"]["conv2"]["4"]
    zc["w"] = (rng.standard_normal(zc["w"].shape) * 0.05).astype(np.float32)
    zc["b"] = (rng.standard_normal(zc["b"].shape) * 0.5).astype(np.float32)
    zc["scale"] = rng.uniform(-0.1, 0.1, zc["scale"].shape).astype(np.float32)
    save_npz_tree(f"{work}/acc.npz", acc)

    def frames(seed, shape):
        return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)

    pair = frames(1, (2, 1, SIZE, SIZE, 3))
    seq = make_long_sequence(np.random.default_rng(77), 64, 64, 36, seg_len=6, max_v=1,
                             fg=True, fg_max_v=2)["imgs"][:DRIFT_FRAMES]
    _write_train_inputs(work)
    _write_ft_inputs(work)
    np.savez(f"{work}/inputs.npz", i1=pair[0], i2=pair[1], clip=frames(3, (5, 1, SIZE, SIZE, 3)),
             stream=frames(4, (5, 1, SIZE, SIZE, 3)),
             gma_clip=frames(6, (5, 1, GMA_SIZE, GMA_SIZE, 3)), clip40=frames(7, CLIP40),
             drift=(2.0 * (seq.astype(np.float32) / 255.0) - 1.0)[:, None])


def _draw_group_affine(tree, rng) -> None:
    """Each group norm's scale in [0.5, 1.5] and bias N(0, 0.1), in place."""
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"scale", "bias"}:
            v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32)
            v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
        elif isinstance(v, dict):
            _draw_group_affine(v, rng)


def _write_train_inputs(work: str) -> None:
    """The train step's accumulator (hidden 32, seed 1, its ZeroConv drawn
    from seed 9) as a JAX-layout tree, and its batch: TRAIN_BATCH clips of
    CLIP40's frames as uint8 values and their label flows (~4 px), seed 12."""
    acc = to_jax_params(init_accflow(AccFlowConfig(hidden=TRAIN_HIDDEN, compute_dtype="float32"),
                                     device="cpu"))
    rng = np.random.default_rng(9)
    zc = acc["accplus"]["conv2"]["4"]
    zc["w"] = (rng.standard_normal(zc["w"].shape) * 0.05).astype(np.float32)
    zc["b"] = (rng.standard_normal(zc["b"].shape) * 0.5).astype(np.float32)
    zc["scale"] = rng.uniform(-0.1, 0.1, zc["scale"].shape).astype(np.float32)
    save_npz_tree(f"{work}/acc32.npz", acc)
    t, _, h, w, _ = CLIP40
    rng = np.random.default_rng(12)
    np.savez(f"{work}/train.npz",
             imgs=rng.integers(0, 256, (TRAIN_BATCH, h, w, 3 * t)).astype(np.float32),
             labels=(4.0 * rng.standard_normal((TRAIN_BATCH, h, w, 2 * (t - 2)))).astype(np.float32))


def _write_ft_inputs(work: str) -> None:
    """The fine-tune step's full RAFT and GMA (positional; gamma drawn in
    [2, 4] from seed 5), seed 0, their cnet's running statistics drawn away
    from 0 and 1 (seed 11), as JAX-layout trees, and its batch: FT_SHAPE
    pairs of uint8 values and their label flows (~4 px), seed 13."""
    rng = np.random.default_rng(11)

    def draw_stats(tree):
        for v in tree.values():
            if isinstance(v, dict) and "mean" in v:
                v["mean"] = (0.1 * rng.standard_normal(v["mean"].shape)).astype(np.float32)
                v["var"] = rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)
            elif isinstance(v, dict):
                draw_stats(v)

    for model, cfg in (("raft", {}), ("gma", GMA_VARIANTS["positional"])):
        tree = to_jax_params(build_flow_estimator(model, compute_dtype="float32", device="cpu",
                                                  **cfg).model)
        draw_stats(tree["cnet"])
        if model == "gma":
            tree["update_block"]["aggregator"]["gamma"] = np.random.default_rng(5).uniform(
                2.0, 4.0, (1,)).astype(np.float32)
        save_npz_tree(f"{work}/ft {model}.npz", tree)
    n, h, w = FT_SHAPE
    rng = np.random.default_rng(13)
    np.savez(f"{work}/ft.npz",
             img1=rng.integers(0, 256, (n, h, w, 3)).astype(np.float32),
             img2=rng.integers(0, 256, (n, h, w, 3)).astype(np.float32),
             label=(4.0 * rng.standard_normal((n, h, w, 2))).astype(np.float32))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launch:
    """`world` gloo ranks running `mode` (_child), started at setup;
    `ranks()` waits for them (a time limit: a deadlocked collective fails
    the tests instead of hanging them) and returns what each saved."""

    def __init__(self, work: str, mode: str = "models", world: int = WORLD):
        self.work, self.world = work, world
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=REPO)
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "child", mode,
                                        str(world), str(r), str(port), work], cwd=work, env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                      for r in range(world)]
        self._out = None

    def ranks(self):
        if self._out is None:
            logs = []
            for p in self.procs:
                try:
                    logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
                finally:
                    if p.poll() is None:
                        p.kill()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
            self._out = [dict(np.load(f"{self.work}/rank{r}.npz")) for r in range(self.world)]
        return self._out


def _stop(run: Launch) -> None:
    for p in run.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("spatial"))
    _write_inputs(work)
    run = Launch(work)
    yield run
    _stop(run)


@pytest.fixture(scope="module")
def launch4(tmp_path_factory):
    """Four gloo ranks: the primitives on a (1, 4) mesh (a 7x7 conv at one
    row a rank reads its halo from three ranks up), RAFT at 48x64 (16, 16,
    8, 8 rows a rank), then a (2, 2) mesh (the train step on data x
    spatial)."""
    work = str(tmp_path_factory.mktemp("spatial4"))
    save_npz_tree(f"{work}/ofe.npz", to_jax_params(
        build_flow_estimator("raft", compute_dtype="float32", device="cpu").model))
    pair = np.random.default_rng(8).uniform(-1, 1, (2,) + RAFT48).astype(np.float32)
    np.savez(f"{work}/inputs.npz", i1=pair[0], i2=pair[1])
    _write_train_inputs(work)
    _write_ft_inputs(work)
    run = Launch(work, "meshes", 4)
    yield run
    _stop(run)


@pytest.fixture(scope="module")
def refs(launch):
    """JAX's unsharded runs (corr_lookup "mm"; the train step's raw
    gradients) and the port's one-process runs, computed here while the
    ranks run."""
    import jax
    import jax.numpy as jnp

    from accflow_tpu.models import build_flow_estimator as j_build
    from accflow_tpu.models import encoders as j_enc
    from accflow_tpu.models.accflow import AccFlowConfig as JAccFlowConfig
    from accflow_tpu.models.accflow import accflow_forward as j_accflow_forward
    from accflow_tpu.streaming import make_streaming_fns as j_make_streaming_fns

    work = launch.work
    data = {k: jnp.asarray(v) for k, v in np.load(f"{work}/inputs.npz").items()}
    ofe, acc = load_npz_tree(f"{work}/ofe.npz"), load_npz_tree(f"{work}/acc.npz")
    small = load_npz_tree(f"{work}/small.npz")
    f32 = JAccFlowConfig(compute_dtype="float32")

    def pair(j_est, params, frames):
        return np.asarray(jax.jit(lambda p, a, b: j_est.forward(p, a, b)["flow_up"])(
            params, frames[0], frames[1]))

    def clip(j_est, params, frames, cfg=f32):
        return np.asarray(jax.jit(lambda ap, op, ims: j_accflow_forward(
            ap, j_est.flow_fn(op), ims, cfg, ofe_pairs=j_est.pairs_fn(op)))(acc, params, frames))

    def stream(j_est, params, acc_params, frames, cfg):
        # The weights are arguments, not constants folded into the programs:
        # a quicker compile.
        init = jax.jit(lambda op, ap, x: j_make_streaming_fns(j_est, cfg, op, ap)[0](x))
        step = jax.jit(lambda op, ap, st, x: j_make_streaming_fns(j_est, cfg, op, ap)[1](st, x))
        flow, state = init(params, acc_params, frames[:3])
        outs = [np.asarray(flow)]
        for f in frames[3:]:
            flow, state = step(params, acc_params, state, f)
            outs.append(np.asarray(flow))
        return np.stack(outs)

    warm = JAccFlowConfig(compute_dtype="float32", warm_start=True)
    j_est = j_build("raft", compute_dtype="float32", corr_lookup="mm", iters=ITERS)
    out = {"raft": pair(j_est, ofe, (data["i1"], data["i2"])),
           "clip": clip(j_est, ofe, data["clip"]), "clip 40": clip(j_est, ofe, data["clip40"]),
           "clip 40 warm start": clip(j_est, ofe, data["clip40"], warm),
           "clip 40 f0n": clip(j_est, ofe, data["clip40"],
                               JAccFlowConfig(compute_dtype="float32", direction="forward")),
           "stream": stream(j_est, ofe, acc, data["stream"], warm)}
    out["train"] = _jax_train_step(work, ofe)
    out["ft"] = {path: _jax_finetune_step(work, path) for path in FT_JAX}
    for branch in ("content", "positional"):
        gma = load_npz_tree(f"{work}/gma {branch}.npz")
        j_gma = j_build("gma", compute_dtype="float32", corr_lookup="mm", iters=ITERS,
                        **_branch_cfg(branch))
        out[f"gma {branch}"] = pair(j_gma, gma, data["gma_clip"])
        out[f"gma clip {branch}"] = clip(j_gma, gma, data["gma_clip"])
        if branch == "content":
            out["gma stream"] = stream(j_gma, gma, acc, data["gma_clip"], warm)
    j_small = j_build("raft", compute_dtype="float32", small=True, iters=ITERS)
    out["small"] = pair(j_small, small, (data["i1"], data["i2"]))
    j33 = j_build("raft", compute_dtype="float32", corr_lookup="mm", iters=ITERS, **RAFT33)
    out["raft 33"] = pair(j33, load_npz_tree(f"{work}/ofe33.npz"), (data["i1"], data["i2"]))
    out["group encoder"] = np.moveaxis(np.asarray(jax.jit(
        lambda p, x: j_enc.basic_encoder(p, x, "group"))(
            load_npz_tree(f"{work}/group.npz"), data["clip40"][0])), -1, 1)
    out["small stream"] = stream(j_small, small, acc, data["stream"], warm)
    out["drift"] = stream(
        j_build("raft", compute_dtype="float32", small=True, iters=6),
        load_npz_tree(f"{FIXTURES}/drift_small_ofe.npz"),
        load_npz_tree(f"{FIXTURES}/drift_small_acc.npz"), data["drift"],
        JAccFlowConfig(hidden=64, compute_dtype="float32", warm_start=True))
    out["port"] = {**_models(None, work), **_train_cases(work), **_ft_cases(work)}
    return out


def _jax_train_step(work: str, ofe) -> dict:
    """JAX's make_acc_train_step, unsharded, on the train batch (the raw
    gradients from _keep_grads chained before its optimizer,
    tests/test_torch_train.py): {"loss", "grads": JAX-layout leaves}."""
    import jax
    import jax.numpy as jnp
    import optax
    from test_torch_train import _keep_grads

    from accflow_tpu.models import build_flow_estimator as j_build
    from accflow_tpu.models import encoders as j_enc
    from accflow_tpu.models.accflow import AccFlowConfig as JAccFlowConfig
    from accflow_tpu.train import engine as j_engine
    from accflow_tpu.train import optim as j_optim

    j_est = j_build("raft", compute_dtype="float32", corr_lookup="mm", iters=ITERS)
    tx = optax.chain(_keep_grads(), j_optim.make_optimizer(
        TRAIN_LR, num_steps=10, wdecay=1e-5, epsilon=1e-8, clip=1.0)[0])
    j_step, _ = j_engine.make_acc_train_step(
        j_est, JAccFlowConfig(hidden=TRAIN_HIDDEN, compute_dtype="float32"), tx, add_noise=False)
    params = jax.tree.map(jnp.asarray, load_npz_tree(f"{work}/acc32.npz"))
    batch = np.load(f"{work}/train.npz")
    state, loss, _ = j_step(j_engine.TrainState(params, tx.init(params), jnp.int32(0)), ofe,
                            jnp.asarray(batch["imgs"]), jnp.asarray(batch["labels"]),
                            jax.random.PRNGKey(0))
    return {"loss": float(loss), "grads": _leaves(jax.tree.map(np.asarray, state.opt_state[0]))}


def _jax_finetune_step(work: str, path: str) -> dict:
    """JAX's make_finetune_step, unsharded, on the fine-tune batch
    (corr_lookup "mm", ITERS GRU iterations through
    tests/test_torch_finetune.py's JIters, noise off; the raw gradients
    from _keep_grads, the running statistics after the step): {"loss",
    "grads", "bn": JAX-layout leaves}."""
    import jax
    import jax.numpy as jnp
    import optax
    from test_torch_finetune import JIters
    from test_torch_train import _keep_grads

    from accflow_tpu.models import build_flow_estimator as j_build
    from accflow_tpu.nn import layers as j_layers
    from accflow_tpu.train import finetune as j_ft
    from accflow_tpu.train import optim as j_optim
    from accflow_tpu.train.engine import TrainState as JTrainState

    model = FT_PATHS[path]["model"]
    tree = load_npz_tree(f"{work}/ft {model}.npz")
    j_est = JIters(j_build(model, compute_dtype="float32", corr_lookup="mm",
                           **(GMA_VARIANTS["positional"] if model == "gma" else {})), ITERS)
    tx = optax.chain(_keep_grads(), j_optim.make_optimizer(
        TRAIN_LR, 10, 1e-5, 1e-8, 1.0, buffer_mask=j_layers.bn_buffer_mask(tree))[0])
    step, _ = j_ft.make_finetune_step(j_est, tx, add_noise=False, gamma=FT_GAMMA)
    params = jax.tree.map(jnp.asarray, tree)
    batch = np.load(f"{work}/ft.npz")
    state, loss, _ = step(JTrainState(params, tx.init(params), jnp.int32(0)),
                          *(jnp.asarray(batch[k]) for k in ("img1", "img2", "label")),
                          jax.random.PRNGKey(0))
    stats = ("/mean", "/var")
    grads = _leaves(jax.tree.map(np.asarray, state.opt_state[0]))
    return {"loss": float(loss), "grads": {k: v for k, v in grads.items() if not k.endswith(stats)},
            "bn": {k: v for k, v in _leaves(jax.tree.map(np.asarray, state.params)).items()
                   if k.endswith(stats)}}


@pytest.fixture(scope="module")
def refs4(launch4, cpu_devices):
    """RAFT at 48x64: JAX unsharded ("mm"), JAX's own GSPMD run with the
    height over 4 devices (12 rows each: JAX's even split), and the port in
    one process."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from accflow_tpu.models import build_flow_estimator as j_build
    from accflow_tpu.parallel.mesh import make_mesh as j_make_mesh
    from accflow_tpu.parallel.mesh import shard_params as j_shard_params

    work = launch4.work
    data = np.load(f"{work}/inputs.npz")
    ofe = load_npz_tree(f"{work}/ofe.npz")
    j_est = j_build("raft", compute_dtype="float32", corr_lookup="mm", iters=ITERS)
    fwd = jax.jit(lambda p, a, b: j_est.forward(p, a, b)["flow_up"])
    i1, i2 = jnp.asarray(data["i1"]), jnp.asarray(data["i2"])
    j_mesh = j_make_mesh(n_data=1, n_spatial=4, devices=cpu_devices[:4])
    sh = NamedSharding(j_mesh, P(None, "spatial", None, None))
    gspmd = fwd(j_shard_params(j_mesh, ofe), jax.device_put(i1, sh), jax.device_put(i2, sh))
    assert len(gspmd.sharding.device_set) == 4
    port = _estimator(work, "fused").forward(data["i1"], data["i2"])["flow_up"]
    return {"jax": np.asarray(fwd(ofe, i1, i2)), "gspmd": np.asarray(gspmd),
            "port": port.numpy()}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_spatial_handles(launch):
    """Each rank holds the handle of its block of rows, and the models ran
    collectives (halos, gathers, sums) that it counted."""
    r0, r1 = launch.ranks()
    assert r0["axis"].tolist() == [0, 2] and r1["axis"].tolist() == [1, 2]
    cases = [k[:-len("/collectives")] for k in r0 if k.endswith("/collectives")]
    # clip, clip 40, clip mix and stream beside the lookups' pairs and the
    # paths; the estimator options' RAFT (3, 3) pair and group-norm encoder
    assert len(cases) == (len(LOOKUPS) + 4 + len(CLIP_PATHS) + 2 * len(GMA_VARIANTS) + 1
                          + len(SMALL_LOOKUPS) + 2 + len(FT_PATHS) + 2)
    for case in cases:
        assert int(r0[f"{case}/collectives"]) == int(r1[f"{case}/collectives"]) > 0
        assert int(r0[f"{case}/bytes"]) == int(r1[f"{case}/bytes"]) > 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(PRIMITIVES))
def test_spatial_primitive_matches_one_process(request, name, world):
    """Over 2 ranks and over 4 (1 to 16 rows a rank), every rank's gathered
    output equal, within 1e-5 of one process's."""
    ranks = request.getfixturevalue("launch" if world == 2 else "launch4").ranks()
    got, ref = ranks[0][f"prim/{name}"], ranks[0][f"prim/{name}/ref"]
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **PRIM_TOL)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"prim/{name}"], got)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(GRAD_PRIMITIVES))
def test_spatial_exchange_grads_match_one_process(request, name, world):
    """Over 2 ranks and over 4, the input gradients through each exchange
    (every rank back-propagating its own rows' part of the loss), gathered,
    equal on every rank and within GRAD_PRIM_REL of one process's largest
    |grad| (rtol 1e-5)."""
    ranks = request.getfixturevalue("launch" if world == 2 else "launch4").ranks()
    got, ref = ranks[0][f"prim/{name}"], ranks[0][f"prim/{name}/ref"]
    assert got.shape == ref.shape and np.isfinite(got).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=GRAD_PRIM_REL * np.abs(ref).max())
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"prim/{name}"], got)


def test_data_by_spatial_mesh(launch4):
    """On a (2, 2) mesh each spatial pair shards its own image (a conv and
    an instance norm, within 1e-5 of one process), and the data groups are
    the columns: ranks {0, 2} and {1, 3}."""
    ranks = launch4.ranks()
    for r, out in enumerate(ranks):
        assert out["axis"].tolist() == [r, 4] and out["2x2/axis"].tolist() == [r % 2, 2]
        np.testing.assert_allclose(out["2x2/out"], out["2x2/ref"], **PRIM_TOL)
        assert float(out["2x2/data_sum"][0]) == 2 * (r % 2) + 2
    assert not np.allclose(ranks[0]["2x2/ref"], ranks[2]["2x2/ref"])


@pytest.mark.parametrize("lookup", LOOKUPS)
def test_spatial_raft_forward_matches_jax(launch, refs, lookup):
    """The sharded forward (either lookup) against JAX's unsharded "mm",
    and within 1e-4 x max |flow| of the port's one-process forward."""
    r0, r1 = launch.ranks()
    got, one = r0[f"raft {lookup}"], refs["port"][f"raft {lookup}"]
    assert got.shape == (1, SIZE, SIZE, 2)
    np.testing.assert_allclose(got, refs["raft"], **FLOW_TOL)
    assert np.abs(got - refs["raft"]).max() <= FLOW_REL * np.abs(refs["raft"]).max()
    np.testing.assert_array_equal(r1[f"raft {lookup}"], got)
    assert np.abs(got - one).max() <= 1e-4 * np.abs(one).max()


def _holds(got, jax_ref, one, tol):
    """got against JAX (tol, and FLOW_REL x max |flow|) and within 1e-4 x
    max |flow| of the port's one-process run."""
    assert got.shape == jax_ref.shape == one.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_ref, **tol)
    assert np.abs(got - jax_ref).max() <= FLOW_REL * np.abs(jax_ref).max()
    assert np.abs(got - one).max() <= 1e-4 * np.abs(one).max()


@pytest.mark.parametrize("variant", list(GMA_VARIANTS))
def test_spatial_gma_forward_matches_jax(launch, refs, variant):
    """GMA's pair on two ranks (each its own queries against the gathered
    keys and values; gamma in [2, 4], so the attention moves the flow),
    every attention variant, against JAX's unsharded forward of its branch
    and the port's one-process run; both ranks' outputs equal."""
    r0, r1 = launch.ranks()
    _holds(r0[f"gma {variant}"], refs[f"gma {_branch(variant)}"], refs["port"][f"gma {variant}"],
           FLOW_TOL)
    np.testing.assert_array_equal(r1[f"gma {variant}"], r0[f"gma {variant}"])


@pytest.mark.parametrize("variant", list(GMA_VARIANTS))
def test_spatial_gma_clip_matches_jax(launch, refs, variant):
    got = launch.ranks()[0][f"gma clip {variant}"]
    assert got.shape == (3, 1, GMA_SIZE, GMA_SIZE, 2)
    _holds(got, refs[f"gma clip {_branch(variant)}"], refs["port"][f"gma clip {variant}"],
           ACC_TOL)


def test_spatial_gma_stream_matches_jax(launch, refs):
    """Stream (c): GMA's gma_flow_pairs_from_features through a reset and 2
    warm-started pushes."""
    _holds(launch.ranks()[0]["gma stream"], refs["gma stream"], refs["port"]["gma stream"],
           ACC_TOL)


@pytest.mark.parametrize("lookup", SMALL_LOOKUPS)
def test_spatial_small_forward_matches_jax(launch, refs, lookup):
    """RAFT-small (kernel #2's lookup on each rank's queries; upflow8 with
    its halo rows) against JAX's unsharded forward and one process."""
    r0, r1 = launch.ranks()
    _holds(r0[f"small {lookup}"], refs["small"], refs["port"][f"small {lookup}"], FLOW_TOL)
    np.testing.assert_array_equal(r1[f"small {lookup}"], r0[f"small {lookup}"])


def test_spatial_small_stream_matches_jax(launch, refs):
    """Stream (a): RAFT-small, a reset and 2 warm-started pushes."""
    _holds(launch.ranks()[0]["small stream"], refs["small stream"],
           refs["port"]["small stream"], ACC_TOL)


def test_spatial_mix_clip_matches_one_process(launch, refs):
    """The 4-frame 64^2 clip with RAFT's level mix (rows, rows_gx, vpu_y,
    mm: each rank's queries against the gathered levels, no exchange of its
    own) on two ranks against one process, within FLOW_REL x max |flow|;
    both ranks' outputs equal."""
    r0, r1 = launch.ranks()
    got, one = r0["clip mix"], refs["port"]["clip mix"]
    assert got.shape == (2, 1, GMA_SIZE, GMA_SIZE, 2) and np.isfinite(got).all()
    assert np.abs(got - one).max() <= FLOW_REL * np.abs(one).max() and np.abs(one).max() > 0
    np.testing.assert_array_equal(r1["clip mix"], got)


def test_spatial_raft_estimator_options_match_jax(launch, refs):
    """Full RAFT at corr_levels 3, corr_radius 3 on two ranks (each rank's
    queries against the gathered keys, 3 levels at radius 3) against JAX's
    unsharded forward at the same fields and the port's one process; both
    ranks' outputs equal."""
    r0, r1 = launch.ranks()
    _holds(r0["raft 33"], refs["raft 33"], refs["port"]["raft 33"], FLOW_TOL)
    np.testing.assert_array_equal(r1["raft 33"], r0["raft 33"])


def test_spatial_group_norm_encoder_matches_jax(launch, refs):
    """The group-norm basic encoder on a 40x48 frame at 24 + 16 rows (each
    group's statistics those of the whole image) against JAX's unsharded
    basic_encoder (tests/test_torch_ops.py's encoder bar) and the port's
    one process (1e-5 x its largest |value|)."""
    r0, r1 = launch.ranks()
    got, one = r0["group encoder"], refs["port"]["group encoder"]
    assert got.shape == (1, GROUP_OUT, 5, 6) and np.isfinite(got).all()
    np.testing.assert_allclose(got, refs["group encoder"], rtol=1e-4, atol=1e-4)
    assert np.abs(got - one).max() <= 1e-5 * np.abs(one).max()
    np.testing.assert_array_equal(r1["group encoder"], got)


def test_spatial_drift_prefix_matches_jax(launch, refs):
    """The drift fixture's trained RAFT-small and accumulator over its first
    10 frames (a reset and 7 pushes; flows of several px), on two ranks."""
    got = launch.ranks()[0]["drift"]
    assert got.shape == (DRIFT_FRAMES - 2, 1, 64, 64, 2) and np.abs(got).max() > 1.0
    _holds(got, refs["drift"], refs["port"]["drift"], ACC_TOL)


def test_spatial_uneven_clip_matches_jax(launch, refs):
    """The clip at a height of 40 over two ranks: 24 + 16 rows."""
    got = launch.ranks()[0]["clip 40"]
    assert got.shape == (CLIP40[0] - 2,) + CLIP40[1:4] + (2,)
    _holds(got, refs["clip 40"], refs["port"]["clip 40"], ACC_TOL)


def test_spatial_uneven_raft_four_ranks(launch4, refs4):
    """Full RAFT at 48x64 over four ranks of 16, 16, 8 and 8 rows, against
    JAX unsharded, JAX's GSPMD run over 4 devices and one process."""
    ranks = launch4.ranks()
    assert [int(r["raft48/rows"][0]) for r in ranks] == [16, 16, 8, 8]
    got = ranks[0]["raft48"]
    _holds(got, refs4["jax"], refs4["port"], FLOW_TOL)
    _holds(got, refs4["gspmd"], refs4["port"], FLOW_TOL)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["raft48"], got)
        assert int(r["raft48/collectives"][0]) == int(ranks[0]["raft48/collectives"][0]) > 0


@pytest.mark.parametrize("height,n,rows", [(440, 2, (224, 216)), (720, 4, (184, 184, 176, 176)),
                                           (48, 4, (16, 16, 8, 8))])
def test_split_rows(height, n, rows):
    """The blocks: the 1/8 rows as even as possible, the first ranks one
    more; a handle given the height answers every scale from them."""
    assert mesh.split_rows(height, n) == rows
    sp = mesh.Spatial(None, n - 1, n).at_height(height)
    assert sp.height(rows[-1]) == height and sp.row0(rows[-1]) == height - rows[-1]
    assert sp.height(rows[-1] // 8) == height // 8
    assert sp.row0(rows[-1] // 8) == (height - rows[-1]) // 8
    assert sp.split(height // 2) == [r // 2 for r in rows]


def test_spatial_clip_matches_jax(launch, refs):
    got = launch.ranks()[0]["clip"]
    assert got.shape == (3, 1, SIZE, SIZE, 2)
    np.testing.assert_allclose(got, refs["clip"], **ACC_TOL)
    assert np.abs(got - refs["clip"]).max() <= FLOW_REL * np.abs(refs["clip"]).max()


def test_spatial_clip_matches_one_process(launch, refs):
    got, ref = launch.ranks()[0]["clip"], refs["port"]["clip"]
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_spatial_stream_matches_jax(launch, refs):
    """reset and 2 warm-started pushes against JAX's init and step."""
    got = launch.ranks()[0]["stream"]
    assert got.shape == (3, 1, SIZE, SIZE, 2)
    np.testing.assert_allclose(got, refs["stream"], **ACC_TOL)
    assert np.abs(got - refs["stream"]).max() <= FLOW_REL * np.abs(refs["stream"]).max()


def test_spatial_stream_matches_one_process(launch, refs):
    got, ref = launch.ranks()[0]["stream"], refs["port"]["stream"]
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("n_data,n_spatial", [(1, 2), (2, 2), (4, 2)])
def test_mesh_layout_matches_jax(cpu_devices, n_data, n_spatial):
    from accflow_tpu.parallel.mesh import make_mesh as j_make_mesh

    devices = cpu_devices[: n_data * n_spatial]
    j_mesh = j_make_mesh(n_data, n_spatial, devices=devices)
    ids = {d.id: i for i, d in enumerate(devices)}
    want = np.vectorize(lambda d: ids[d.id])(j_mesh.devices)
    np.testing.assert_array_equal(mesh.mesh_layout(n_data, n_spatial), want)


@pytest.mark.parametrize("path", list(CLIP_PATHS))
def test_spatial_clip_paths_match_jax(launch, refs, path):
    """The warm-started, F0N (fused and stepwise) and cold stepwise clips at
    a height of 40 over two ranks (24 + 16 rows), against JAX's unsharded
    clip and the port's one-process run of the path."""
    got = launch.ranks()[0][f"clip 40 {path}"]
    assert got.shape == (CLIP40[0] - 2,) + CLIP40[1:4] + (2,)
    _holds(got, refs[CLIP_JAX[path]], refs["port"][f"clip 40 {path}"], ACC_TOL)
    np.testing.assert_array_equal(launch.ranks()[1][f"clip 40 {path}"], got)


def _train_ranks(request, mesh_shape: str):
    """Each rank's train and fine-tune step outputs on the (1, 2) or the
    (2, 2) mesh, as the one-process run names them."""
    if mesh_shape == "1x2":
        return request.getfixturevalue("launch").ranks()
    return [{k[len("2x2/"):]: v for k, v in r.items() if k.startswith(("2x2/train/", "2x2/ft/"))}
            for r in request.getfixturevalue("launch4").ranks()]


def _grads(out: dict, path: str) -> dict:
    pre = f"train/{path}/g/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def _context(grads: dict) -> list:
    """The context encoder's leaves, where a halo row's lost gradient
    shows (the rest see the context through a 3x3 conv at most)."""
    return [k for k in grads if k.startswith("context/")]


def _same_grads(ranks, path: str) -> dict:
    """Rank 0's reduced gradients, every other rank's bit-equal to them."""
    got = _grads(ranks[0], path)
    for r in ranks[1:]:
        g = _grads(r, path)
        assert set(g) == set(got)
        for k in got:
            np.testing.assert_array_equal(g[k], got[k], err_msg=k)
    return got


@pytest.mark.parametrize("mesh_shape", ["1x2", "2x2"])
def test_spatial_train_step_matches_jax(request, refs, mesh_shape):
    """The fused path's sharded step (24 + 16 rows a spatial pair; on the
    (2, 2) mesh one sample a data group) against JAX's unsharded
    make_acc_train_step at batch 2: the loss within rtol 1e-5, the raw
    gradients at test_one_step_loss_and_grads_match_jax's bars (per leaf
    rtol 1e-3, atol 1e-3 of its largest; the context encoder's leaves by
    their relative L2, 1e-2)."""
    from test_torch_train import _assert_grads_close, _rel_l2

    ranks, want = _train_ranks(request, mesh_shape), refs["train"]
    got = _same_grads(ranks, "fused")
    np.testing.assert_allclose(float(ranks[0]["train/fused/loss"]), want["loss"], rtol=1e-5)
    ctx = _context(want["grads"])
    _assert_grads_close({k: v for k, v in got.items() if k not in ctx},
                        {k: v for k, v in want["grads"].items() if k not in ctx})
    assert _rel_l2(got, want["grads"], ctx) <= 1e-2
    assert np.abs(got["accplus/conv2/4/w"]).max() > 0  # the offsets reach the deformable conv


@pytest.mark.parametrize("mesh_shape,path", [("1x2", p) for p in TRAIN_PATHS] + [("2x2", "fused")])
def test_spatial_train_step_matches_one_process(request, refs, mesh_shape, path):
    """The sharded step on each path against the port's one process at
    batch 2: the loss within rtol 1e-5, the whole gradient and the context
    encoder's leaves each within GRAD_REL in relative L2, every rank's
    reduced gradients bit-equal."""
    from test_torch_train import _rel_l2

    ranks, one = _train_ranks(request, mesh_shape), refs["port"]
    got, want = _same_grads(ranks, path), _grads(one, path)
    np.testing.assert_allclose(float(ranks[0][f"train/{path}/loss"]),
                               float(one[f"train/{path}/loss"]), rtol=1e-5)
    assert set(got) == set(want)
    assert _rel_l2(got, want, list(want)) <= GRAD_REL
    assert _rel_l2(got, want, _context(want)) <= GRAD_REL


@pytest.mark.parametrize("mesh_shape", ["1x2", "2x2"])
def test_spatial_train_noise_rows(request, refs, mesh_shape):
    """reference_noise under a handle (and on the (2, 2) mesh a data
    group): each rank's rows, gathered, bit-equal to one process's draw
    for the global batch from the same generator seed."""
    one = refs["port"]["train/noise"]
    if mesh_shape == "1x2":
        for r in request.getfixturevalue("launch").ranks():
            np.testing.assert_array_equal(r["train/noise"], one)
        return
    for rank, r in enumerate(request.getfixturevalue("launch4").ranks()):
        d = rank // 2
        np.testing.assert_array_equal(r["2x2/noise"], one[d: d + 1])


def test_spatial_valid_step_matches_one_process(launch, refs):
    """valid_step under a handle: the per-sample EPE over the global pixels
    (rtol 1e-5) on every rank, and the last output's rows (gathered)
    within FLOW_REL x max |flow| of one process's."""
    one = refs["port"]
    for r in launch.ranks():
        assert r["train/valid/epe"].shape == (TRAIN_BATCH,)
        np.testing.assert_allclose(r["train/valid/epe"], one["train/valid/epe"], rtol=1e-5)
        got, want = r["train/valid/out"], one["train/valid/out"]
        assert got.shape == want.shape == (TRAIN_BATCH,) + CLIP40[2:4] + (2,)
        assert np.abs(got - want).max() <= FLOW_REL * np.abs(want).max()


def _ft(out: dict, path: str, part: str) -> dict:
    """The fine-tune step's leaves of `part` ("g": the reduced gradients,
    "bn": the running statistics after the step) on path `path`."""
    pre = f"ft/{path}/{part}/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def _same_ft(ranks, path: str) -> tuple:
    """Rank 0's reduced gradients and running statistics, every other
    rank's bit-equal to them."""
    got = {part: _ft(ranks[0], path, part) for part in ("g", "bn")}
    for r in ranks[1:]:
        for part, leaves in got.items():
            other = _ft(r, path, part)
            assert set(other) == set(leaves)
            for k in leaves:
                np.testing.assert_array_equal(other[k], leaves[k], err_msg=k)
    return got["g"], got["bn"]


def _assert_stats_close(got: dict, want: dict) -> None:
    """The running statistics after the step at
    tests/test_torch_finetune.py's bar (rtol 1e-5, atol 1e-7)."""
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("mesh_shape,path", [("1x2", p) for p in FT_JAX] + [("2x2", "raft")])
def test_spatial_finetune_step_matches_jax(request, refs, mesh_shape, path):
    """The sharded fine-tune step (24 + 16 rows a spatial pair; on the (2, 2)
    mesh one sample a data group, BatchNorm over all four ranks) against
    JAX's unsharded make_finetune_step at batch 2: the loss within rtol
    1e-5, the raw gradients at tests/test_torch_finetune.py's bars (per
    leaf rtol 1e-3, atol 1e-3 of its largest; the biases a norm follows
    near 0 on both sides), the cnet's 15 layers' running statistics rtol
    1e-5 (atol 1e-7)."""
    from test_torch_finetune import assert_grads_match, normalized_biases

    ranks, want = _train_ranks(request, mesh_shape), refs["ft"][path]
    got, stats = _same_ft(ranks, path)
    np.testing.assert_allclose(float(ranks[0][f"ft/{path}/loss"]), want["loss"], rtol=1e-5)
    assert_grads_match(got, want["grads"], normalized_biases(want["grads"], ("fnet", "cnet")))
    assert len(stats) == 30
    _assert_stats_close(stats, want["bn"])


@pytest.mark.parametrize("mesh_shape,path", [("1x2", p) for p in FT_PATHS] + [("2x2", "raft")])
def test_spatial_finetune_step_matches_one_process(request, refs, mesh_shape, path):
    """The sharded fine-tune step on each path against the port's one
    process at batch 2: the loss within rtol 1e-5; the gradients within
    GRAD_REL in relative L2 over the whole vector, the fnet's leaves (the
    gathered keys' gradient) and the cnet's (halos, BatchNorm) apart; the
    running statistics rtol 1e-5; every rank's reduced gradients and
    statistics bit-equal."""
    from test_torch_train import _rel_l2

    ranks, one = _train_ranks(request, mesh_shape), refs["port"]
    got, stats = _same_ft(ranks, path)
    want = _ft(one, path, "g")
    np.testing.assert_allclose(float(ranks[0][f"ft/{path}/loss"]), float(one[f"ft/{path}/loss"]),
                               rtol=1e-5)
    assert set(got) == set(want)
    for prefix in ("", "fnet/", "cnet/"):
        assert _rel_l2(got, want, [k for k in want if k.startswith(prefix)]) <= GRAD_REL, prefix
    _assert_stats_close(stats, _ft(one, path, "bn"))


def test_spatial_finetune_noise_and_valid_step(launch, refs):
    """The noise each path's sharded step drew, its rows gathered,
    bit-equal to one process's draw for the whole pairs; valid_step under
    a handle: the per-sample EPE over the global pixels (rtol 1e-5) on
    every rank, the flow's rows within FLOW_REL x max |flow| of one
    process's."""
    one = refs["port"]
    noisy = [p for p, cfg in FT_PATHS.items() if cfg.get("noise")]
    for r in launch.ranks():
        for path in noisy:
            assert one[f"ft/{path}/noise"].shape == FT_SHAPE + (3,)
            np.testing.assert_array_equal(r[f"ft/{path}/noise"], one[f"ft/{path}/noise"])
        assert r["ft/raft/valid/epe"].shape == (FT_SHAPE[0],)
        np.testing.assert_allclose(r["ft/raft/valid/epe"], one["ft/raft/valid/epe"], rtol=1e-5)
        got, want = r["ft/raft/valid/flow"], one["ft/raft/valid/flow"]
        assert got.shape == want.shape == FT_SHAPE + (2,)
        assert np.abs(got - want).max() <= FLOW_REL * np.abs(want).max()


@pytest.mark.parametrize("step", ["train", "ft"])
def test_spatial_graphed_step_on_cpu_bit_equal_eager(launch, step):
    """make_acc_train_step ("train") and make_finetune_step ("ft") with
    graphed=True and a handle, on CPU tensors, where the graphed wrappers
    call the step as it is: on every rank the loss, the reduced gradients,
    the running statistics after the step and the collectives and bytes it
    counted are bit-equal to graphed=False's."""
    for r in launch.ranks():
        eager, graphed = ({k[len(pre):]: v for k, v in r.items() if k.startswith(pre)}
                          for pre in (f"graphed/False/{step}/", f"graphed/True/{step}/"))
        assert set(eager) == set(graphed) and any(k.startswith("g/") for k in eager)
        assert eager["counts"][0] > 0 and eager["counts"][1] > 0
        assert (step == "ft") == any(k.startswith("bn/") for k in eager)
        for k in eager:
            np.testing.assert_array_equal(graphed[k], eager[k], err_msg=k)


def test_spatial_stream_accumulator_pushes_bit_equal_step_fn(launch):
    """StreamAccumulator with a handle (gloo: its push runs step_fn eagerly)
    against make_streaming_fns' init and step_fn on the same rows: the reset
    and every push bit-equal on every rank."""
    for r in launch.ranks():
        got, want = r["graphed/stream/accumulator"], r["graphed/stream/step_fn"]
        assert got.shape == want.shape == (5 - 2, 1, SIZE // WORLD, SIZE, 2)
        np.testing.assert_array_equal(got, want)


def test_spatial_gloo_gathers_on_the_host(launch):
    """Under gloo the gathers never take NCCL's all_gather_into_tensor (it
    raised if called): stack_ranks, gather_rows and host_array bit-equal to
    an all_gather of the same tensors stacked, concatenated; and a graph
    may not capture the handle's group."""
    for r in launch.ranks():
        for name in ("stack", "rows", "host"):
            np.testing.assert_array_equal(r[f"gloo/{name}"], r[f"gloo/{name}/ref"], err_msg=name)
        assert r["gloo/stack"].shape == (WORLD, 2, 3, 8, 5)
        assert not r["gloo/capturable"]


def test_spatial_refusals(tmp_path):
    """A handle (never used for a collective here: each call refuses
    first) where the frames do not split into blocks of 8-row multiples (a
    height not a multiple of 8, fewer rows at 1/8 than ranks, unequal
    blocks the handle was not given). Every AccFlow clip path, the
    accumulator's train step, the estimators' fine-tune step (graphed or
    not), GMA and RAFT-small take a handle: the launches run them; a
    graphed step with a handle is built as CudaGraphedStep."""
    sp = mesh.Spatial(None, 0, 2)
    with pytest.raises(ValueError, match="n_spatial=2"):
        mesh.make_mesh(n_spatial=2)
    est = build_flow_estimator("raft", compute_dtype="float32", iters=1, device="cpu")
    img = np.zeros((1, 12, 16, 3), np.float32)
    with pytest.raises(ValueError, match="not a multiple of 8"):
        est.forward(img[:, :10], img[:, :10], spatial=sp)  # a height of 20
    with pytest.raises(ValueError, match="fewer than n_spatial=2"):
        sp.at_height(8)
    with pytest.raises(ValueError, match=r"at_height\(24\)"):
        est.forward(img, img, spatial=sp)  # 12 rows a rank of 24: blocks of 16 + 8
    with pytest.raises(ValueError, match="its block of a height of 24 is 16"):
        est.forward(img, img, spatial=sp.at_height(24))
    acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32"), device="cpu")
    steps = (engine.make_acc_train_step(est, acc, make_optimizer(acc.parameters(), TRAIN_LR, 10),
                                        add_noise=False, graphed=True, spatial=sp),
             finetune.make_finetune_step(est, make_optimizer(est.model.parameters(), TRAIN_LR, 10),
                                         add_noise=False, gamma=FT_GAMMA, graphed=True, spatial=sp))
    for step, valid in steps:
        assert isinstance(step, graphs.CudaGraphedStep) and isinstance(valid, graphs.CudaGraphed)


if __name__ == "__main__" and sys.argv[1:2] == ["child"]:
    _child(sys.argv[2], *map(int, sys.argv[3:6]), sys.argv[6])
