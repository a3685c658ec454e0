"""Accumulator training engine, the port's counterpart of
accflow_tpu/train/engine.py (reference train_acc.py), and the batch helpers
that evaluation shares (`to_clip`, `to_flow_seq`, `pad_batch`).

Recipe (configs/AccRAFT*.yml, train_acc.py):
- data: CVO clean+final, keys ["bflows"] (["fflows"] for `direction:
  forward`, the F0N ablation of configs/AccRAFT-F0N.yml), random 256^2 crop, batch
  batch_per_gpu, shuffled, last partial batch dropped;
- a frozen estimator (RAFT or GMA) from flow_pretrained, the AccFlow
  modules trained;
- AdamW(lr, wdecay, eps) + linear OneCycle over num_steps+100, gradient
  clip 1.0, per-step noise augmentation (train_acc.py:216-220, with its
  clamp-to-[0,255]-then-renormalize quirk);
- periodic validation on CVO-test clean, latest and best-k checkpoints,
  flow PNGs of chosen validation samples.

On the card the step runs on each GPU of the job: the frozen estimator under
no_grad (its correlation lookups are kernel #1, or #2 for RAFT-small), the
accumulator's forward and backward through PyTorch's own ops, bf16 compute
with float32 master weights and float32 flow state. As JAX jits the whole
step, train_acc replays it from a CUDA graph (graphs.CudaGraphedStep: the
noise draw, forward, backward, clip and AdamW update in the graph, the
schedule's advance and the loss read outside) and its validation step too
(graphs.CudaGraphed); on the CPU both run eagerly.

Data parallelism (parallel/mesh.py, JAX's mesh): under torchrun the global
batch is batch_per_gpu x world, every rank draws it from the same seeded
loader and keeps its rows, the step's noise is drawn for the global batch
and sliced likewise, the gradients, loss and metrics are averaged over
ranks inside the step (captured with it over NCCL), the validation EPEs are
gathered, and rank 0 alone writes logs, PNGs, TensorBoard and checkpoints.

Height sharding (JAX's make_acc_train_step with images and flows sharded
P("data", "spatial"), accflow_tpu/train/engine.py:111-160): the step
builder takes a spatial handle beside the data group, and each rank holds
its rows of its samples (mesh.shard_batch, then mesh.shard_rows). The
frozen estimator runs on the rank's queries under no_grad, the accumulator
differentiates through the exchanges (parallel/mesh.py), each rank
back-propagates its part of the loss over the global pixels
(train/loss.py), and the update sums the gradients over the spatial group
and averages them over the data group, once, before the clip. The noise is
the rank's rows of one global draw. As JAX jits that program with GSPMD's
collectives in it, graphed=True captures the step with its exchanges
(halos, gathers, the backward's all_reduces, the gradient sum) in one CUDA
graph over NCCL; gloo's host-staged collectives cannot be captured, and a
graphed step on the card refuses them. The estimators' fine-tune step
takes the handle the same way
(train/finetune.py::make_finetune_step). The engines (train_acc, fine_tune)
stay data-parallel only, as JAX's do.
"""

from __future__ import annotations

import functools
import os
import os.path as osp
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from accflow_tpu_torch import graphs
from accflow_tpu_torch.convert import load_flow_estimator_checkpoint, load_jax_params
from accflow_tpu_torch.data.cvo import BatchIterator, fetch_train_dataset, fetch_valid_dataset
from accflow_tpu_torch.data.prefetch import device_prefetch
from accflow_tpu_torch.device import resolve_device
from accflow_tpu_torch.models import build_flow_estimator
from accflow_tpu_torch.models.accflow import (
    AccFlow,
    AccFlowConfig,
    accflow_forward,
    accflow_train_forward,
    init_accflow,
)
from accflow_tpu_torch.nn.layers import tf32
from accflow_tpu_torch.parallel import mesh
from accflow_tpu_torch.train.accum import accumulate_grads
from accflow_tpu_torch.train.checkpoint import CheckpointManager
from accflow_tpu_torch.train.loss import sequence_loss_acc
from accflow_tpu_torch.train.optim import Optimizer, make_optimizer
from accflow_tpu_torch.utils.flow_viz import flow_to_image
from accflow_tpu_torch.utils.logging import Timer, count_parameters, get_timestamp, setup_logger


class TrainState(NamedTuple):
    """What train_acc (and finetune.fine_tune) returns: the trained model
    (the accumulator; the estimator's module), its optimizer and the step
    count."""
    model: torch.nn.Module
    optimizer: Optimizer
    step: int


def to_clip(imgs, frames: Optional[int] = None) -> torch.Tensor:
    """(N, H, W, 3*T) uint8/float (numpy or tensor) -> (T, N, H, W, 3)
    float32 in [-1, 1], on the input's device (train_acc.py:62). frames, if
    given, asserts the clip length (the CVO protocol's 7)."""
    x = torch.as_tensor(imgs)
    n, h, w, c = x.shape
    t = c // 3
    if c % 3 or (frames is not None and t != frames):
        raise ValueError(f"expected {frames or 'T'} frames of 3 channels, got {c} channels")
    x = 2.0 * (x.float() / 255.0) - 1.0
    return x.reshape(n, h, w, t, 3).movedim(3, 0)


def to_flow_seq(flows) -> torch.Tensor:
    """(N, H, W, 2*S) -> (S, N, H, W, 2) (train_acc.py:59)."""
    x = torch.as_tensor(flows)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, c // 2, 2).movedim(3, 0)


def pad_batch(batch: dict, size: int):
    """Pad a host batch dict to `size` samples by repeating the last sample
    (every batch keeps one shape). Returns (padded, n_valid)."""
    n = next(iter(batch.values())).shape[0]
    if n == size:
        return batch, n
    pad = size - n
    return {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
            for k, v in batch.items()}, n


def noise_from_draws(stdv: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """The reference's noise (train_acc.py:216-220) from its draws: stdv
    ~ U[0, 5) and a unit normal per pixel; the noise is clamped to
    [0, 255] and then renormalized with 2x/255 - 1, which shifts the
    baseline by -1 and keeps only the positive lobe. Faithful to the
    reference, which trained its released checkpoints this way."""
    return 2.0 * (torch.clamp(stdv * normal, 0.0, 255.0) / 255.0) - 1.0


def reference_noise(gen: torch.Generator, frame_shape, group=None,
                    spatial=None) -> torch.Tensor:
    """One step's noise (N, H, W, 3) float32, drawn from `gen` on its
    device: stdv, then the normals. With a process `group` the draw is the
    group's global batch's (N x world rows, the same on every rank) and this
    rank's rows of it are returned, so that the ranks together add the
    noise one process would. With a spatial handle H is this rank's block
    of rows: the draw is at the global height, and the rank's block of it
    is returned."""
    n, h = frame_shape[0], frame_shape[1]
    world, rank = ((1, 0) if group is None
                   else (torch.distributed.get_world_size(group), torch.distributed.get_rank(group)))
    height = mesh.global_rows(h, spatial)
    stdv = torch.rand((), generator=gen, device=gen.device) * 5.0
    normal = torch.randn((n * world, height, *frame_shape[2:]), generator=gen,
                         device=gen.device)
    return mesh.shard_rows(noise_from_draws(stdv, normal)[rank * n: (rank + 1) * n], spatial)


# Estimator options a config may set (corr_levels, corr_radius,
# corr_volume_dtype: RAFTConfig's and GMAConfig's fields); absent or null,
# the estimator keeps its default.
CORR_OPTIONS = ("corr_levels", "corr_radius", "corr_volume_dtype")


def corr_options(opt) -> dict:
    """The CORR_OPTIONS that `opt` sets, for build_flow_estimator."""
    return {k: opt[k] for k in CORR_OPTIONS if opt.get(k) is not None}


def build_acc_model(opt, device=None):
    """(estimator, AccFlowConfig) from an experiment name like Acc+RAFT-cvo
    (RAFT, or GMA for a name with "gma"), the estimator's weights from seed
    0 on `device`, at the config's corr_options. `direction` "forward"
    selects the F0N ablation; an unknown direction raises ValueError before
    any model is built."""
    cd = opt.get("compute_dtype", "bfloat16")
    acfg = AccFlowConfig(compute_dtype=cd, hidden=int(opt.get("acc_hidden", 128)),
                         remat=opt.get("remat", False),
                         direction=opt.get("direction", "backward"))
    est = build_flow_estimator(
        opt.exp_name, compute_dtype=cd, device=device,
        small=bool(opt.get("small", False)),
        corr_lookup=opt.get("corr_lookup", "fused"),
        attn_chunk=int(opt.get("attn_chunk", 0)), **corr_options(opt),
    )
    return est, acfg


def graph_steps(make_update, valid_step, optimizer: Optimizer, graphed: bool, group=None,
                spatial=None):
    """(train_step, valid_step) of a step factory: with `graphed`, the
    update make_update(optimizer.update) in graphs.CudaGraphedStep with the
    schedule's advance after each call, and valid_step in
    graphs.CudaGraphed (both run eagerly on CPU tensors); else the eager
    make_update(optimizer.step) and valid_step. A process `group` and a
    spatial handle are handed to the update (its gradient sum and mean
    over ranks); with `graphed`, their collectives are captured in the
    graphs, which on the card refuse a group that is not NCCL's."""
    update, step = optimizer.update, optimizer.step
    if group is not None or spatial is not None:
        update = functools.partial(update, group, spatial)
        step = functools.partial(step, group, spatial)
    if graphed:
        collective = group if spatial is None else spatial.group
        return (graphs.CudaGraphedStep(make_update(update), after=optimizer.advance,
                                       group=collective),
                graphs.CudaGraphed(valid_step, collective))
    return make_update(step), valid_step


def make_acc_train_step(est, model: AccFlow, optimizer: Optimizer, add_noise: bool,
                        grad_accum: int = 1, graphed: bool = False, group=None, spatial=None):
    """(train_step, valid_step) for the accumulator `model` against the
    frozen estimator `est`, on the path of model.cfg (the fused paths take
    its pairs_fn, the stepwise ones its flow_fn).

    train_step(imgs (N, H, W, 3T), label_flows (N, H, W, 2S), gen=None) ->
    (loss, metrics), device tensors: one optimizer update (with a process
    `group`, the data-parallel axis, on this rank's rows: the gradients,
    loss and metrics averaged over its ranks, the noise this rank's rows of
    one global draw); with add_noise the step's noise is drawn from the
    torch.Generator `gen`. Forward and
    backward run under one TF32 setting, off (what the forward's blocks
    set), so that no backward conv of a float32 step runs in TF32.
    valid_step(imgs, label_flows) -> (per-sample EPE (N,), last output
    (N, H, W, 2)), under no_grad. graphed: the two as train_acc runs them,
    replayed from CUDA graphs on CUDA tensors (graph_steps). label_flows
    are the direction's: bflows [F_{k,0}], or fflows [F_{0,k}] forward.

    spatial (mesh.Mesh.axis given the frames' height by at_height): imgs
    and label_flows are this rank's rows of its samples (mesh.shard_batch,
    then mesh.shard_rows(x, spatial, dim=1)); each rank back-propagates its
    part of the loss over the global pixels, the update sums the gradients
    over the spatial group (then averages them over `group`) before the
    clip, the reported loss and metrics are the group's sums of the parts,
    and valid_step returns the per-sample EPE over the global pixels and
    this rank's rows of the last output. graphed=True with a handle
    captures the step with its exchanges over NCCL (graph_steps); on the
    card under gloo its first call raises ValueError."""
    pairs, ofe = est.pairs_fn(spatial=spatial), est.flow_fn(spatial=spatial)

    def loss_fn(images, labels):
        return sequence_loss_acc(accflow_train_forward(model, images, pairs, ofe, spatial),
                                 labels, spatial)

    def make_update(finish):
        def train_step(imgs, label_flows, gen: Optional[torch.Generator] = None):
            images = to_clip(imgs)
            labels = to_flow_seq(label_flows)
            if add_noise:
                images = images + reference_noise(gen, images.shape[1:], group, spatial)[None]
            optimizer.zero_grad()
            with tf32(False):
                loss, metrics, _ = accumulate_grads(loss_fn, grad_accum, images, labels, axis=1)
            finish()
            return mesh.all_mean(mesh.spatial_sum((loss, metrics), spatial), group)

        return train_step

    def valid_step(imgs, label_flows):
        outs = accflow_forward(model, to_clip(imgs), ofe_pairs=pairs, ofe=ofe, spatial=spatial)
        labels = to_flow_seq(label_flows)
        # Per-sample EPE of the last accumulated flow, so the engine can
        # aggregate over padded validation batches.
        epe = torch.sqrt(torch.sum((outs[-1] - labels[-1]) ** 2, dim=-1))
        h, w = epe.shape[1:]
        return (mesh.spatial_sum(epe.sum(dim=(1, 2)) / (mesh.global_rows(h, spatial) * w),
                                 spatial), outs[-1])

    return graph_steps(make_update, valid_step, optimizer, graphed, group, spatial)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_flow_png(flow_nhwc: np.ndarray, path: str) -> None:
    """The first flow of (N, H, W, 2) as a colour-wheel PNG (8-bit RGB),
    written with zlib and struct."""
    img = np.ascontiguousarray(flow_to_image(np.asarray(flow_nhwc[0])), dtype=np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))  # filter 0 per row
    os.makedirs(osp.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw)))
        f.write(_png_chunk(b"IEND", b""))


def checkpoint_state(model: torch.nn.Module, optimizer: Optimizer, step: int) -> dict:
    """What a training checkpoint holds (train/checkpoint.py): the model's
    state_dict under the reference's names, the optimizer's and the
    schedule's state, and the step."""
    return {"model": model.state_dict(), **optimizer.state_dict(), "step": step}


def open_run_dirs(opt, logger_name: str, phase: str):
    """(log_dir, ckpt_dir, logger) of a training run: rank 0 archives stale
    run dirs unless resuming (train_acc.py:39-45: logs and checkpoints) and
    creates the log dir, every rank waits for it, and rank 0's logger alone
    writes the log file."""
    main = mesh.is_main_process()
    log_dir = opt.get("log_dir", f"./logs/{opt.exp_name}")
    ckpt_dir = opt.get("ckpt_dir", f"./checkpoints/{opt.exp_name}")
    if opt.get("resume") is None and main:
        for d in (log_dir, ckpt_dir):
            if osp.isdir(d):
                os.rename(d, d + "_archived_" + get_timestamp())
    if main:
        os.makedirs(log_dir, exist_ok=True)
    mesh.sync_processes("archive_dirs")
    return log_dir, ckpt_dir, setup_logger(logger_name, log_dir, phase + opt.exp_name,
                                           tofile=main)


def train_acc(opt, max_steps: Optional[int] = None, tb=None, device=None) -> TrainState:
    """Train the AccFlow accumulator on one device (cuda unless `device`
    names another; without a GPU it raises unless device="cpu"), or on every
    rank of a torchrun job (parallel.mesh.maybe_init_distributed: the global
    batch batch_per_gpu x world, module docstring). `opt`
    mirrors configs/Acc*.yml plus `dataset_root` (CVOR data) and optional
    `ofe_params` (a JAX-layout numpy tree) or `flow_pretrained` (a
    reference .pth or a .npz tree). max_steps stops early. Returns the
    TrainState.

    tb: an optional utils.tb.TBLogger receiving train/{loss,epe,lr} at every
    log point and val/epe at every validation (`use_tb: true` in opt builds
    one on log_dir)."""
    dev = resolve_device(device)
    mesh.maybe_init_distributed(dev)
    batch = opt.batch_per_gpu * mesh.world_size()
    seed = opt.get("seed", 0)

    # Debug-name frequency override (train_acc.py:33-35).
    if "debug" in str(opt.exp_name).lower():
        opt["valid_freq"] = 10
        opt["log_freq"] = 1
    log_dir, ckpt_dir, logger = open_run_dirs(opt, "accflow_torch", "train_")
    main = mesh.is_main_process()
    own_tb = tb is None and bool(opt.get("use_tb")) and main
    if own_tb:
        from accflow_tpu_torch.utils.tb import TBLogger

        tb = TBLogger(osp.join(log_dir, "tb"))

    # Backward accumulation trains against bflows [F_{k,0}], the forward
    # (F0N) ablation against fflows [F_{0,k}]: each aligns with its
    # direction's output list.
    flow_key = "fflows" if opt.get("direction") == "forward" else "bflows"
    train_dst = fetch_train_dataset(opt.dataset_root, [flow_key], crop_size=opt.image_size,
                                    split="clean+final")
    valid_dst = fetch_valid_dataset(opt.dataset_root, [flow_key], split="clean")
    sample_per_epoch = len(train_dst) // batch + 1
    num_steps = sample_per_epoch * opt.epochs
    logger.info("Train on %d samples, batch %d on %s x %d, %d iters/epoch, %d total",
                len(train_dst), batch, dev, mesh.world_size(), sample_per_epoch, num_steps)

    # Frozen OFE + trainable accumulator.
    est, acfg = build_acc_model(opt, device=dev)
    if opt.get("ofe_params") is not None:
        load_jax_params(est.model, opt.ofe_params)
    elif opt.get("flow_pretrained"):
        load_flow_estimator_checkpoint(opt.flow_pretrained, est.model)
        logger.info("Loaded frozen OFE from %s", opt.flow_pretrained)
    else:
        logger.info("WARNING: frozen OFE uses random init (no flow_pretrained)")
    est.model.requires_grad_(False)

    model = mesh.shard_params(init_accflow(acfg, seed=seed, device=dev))
    logger.info("Parameter Count: trainable: %d, frozen (OFE): %d",
                count_parameters(model), count_parameters(est.model))
    optimizer = make_optimizer(model.parameters(), opt.lr, num_steps, opt.wdecay,
                               opt.epsilon, opt.clip)
    train_step, valid_step = make_acc_train_step(
        est, model, optimizer, opt.add_noise, grad_accum=int(opt.get("grad_accum", 1)),
        graphed=mesh.collectives_capturable(), group=mesh.data_group())
    ckpt = CheckpointManager(ckpt_dir, keep=4)

    current_step = 0
    if opt.get("resume") is not None:
        # resume (train_acc.py:27-32): "auto" -> the latest saved step; an
        # int -> that numbered checkpoint.
        state = ckpt.restore(None if str(opt.resume) == "auto" else int(opt.resume))
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state)
        current_step = int(state["step"])
        logger.info("Resumed from step %d", current_step)

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    timer = Timer()
    losses, epes = [], []
    best_val_epe = 1e10
    best_val_step = current_step
    start_epoch = current_step // sample_per_epoch
    stop = False

    for epoch in range(start_epoch, opt.epochs):
        if stop:
            break
        it = BatchIterator(train_dst, batch, shuffle=True, drop_last=True, seed=seed,
                           epoch=epoch)
        timer.tick()
        for batch_t in device_prefetch(map(mesh.shard_batch, it), depth=2, device=dev):
            current_step += 1
            loss, metrics = train_step(batch_t["imgs"], batch_t[flow_key], gen)
            losses.append(float(loss))
            epes.append(float(metrics["epe"]))
            timer.tick()

            if current_step % opt.log_freq == 0 or current_step < 25:
                avg_time = timer.get_average_and_reset()
                eta_h = avg_time * (num_steps - current_step) / 3600
                avg_loss = sum(losses) / len(losses)
                avg_epe = sum(epes) / len(epes)
                lr_now = optimizer.lr
                logger.info(
                    "<epoch:%2d, iter:%6d, t:%.2fs, eta:%.2fh, loss:%.3f, epe:%.3f, lr:%.2e>",
                    epoch, current_step, avg_time, eta_h, avg_loss, avg_epe, lr_now,
                )
                if tb is not None:
                    tb.write_dict({"train/loss": avg_loss, "train/epe": avg_epe,
                                   "train/lr": lr_now}, current_step)
                losses, epes = [], []

            if current_step % opt.valid_freq == 0 or current_step == num_steps - 1:
                epes_sum, epes_n = 0.0, 0
                # visual_samples indexes SAMPLES of the validation set
                # (train_acc.py:283-289 dumps dataset sample i, not batch i).
                visual = sorted(set(opt.get("visual_samples", [])))
                val_last = {}
                vit = BatchIterator(valid_dst, batch, shuffle=False, drop_last=False)
                for vb in vit:
                    vb, n_valid = pad_batch(vb, batch)
                    vb = {k: torch.as_tensor(v).to(dev) for k, v in mesh.shard_batch(vb).items()}
                    per_sample, flow_last = valid_step(vb["imgs"], vb[flow_key])
                    epes_sum += float(mesh.host_array(per_sample)[:n_valid].sum())
                    base = epes_n
                    epes_n += n_valid
                    want = [i for i in visual if base <= i < base + n_valid]
                    if want:
                        flow_np = mesh.host_array(flow_last)
                        for i in want:
                            val_last[i] = flow_np[i - base: i - base + 1]
                epe = epes_sum / max(epes_n, 1)
                state = checkpoint_state(model, optimizer, current_step)
                if main:
                    ckpt.save(current_step, state)  # `latest` (train_acc.py:268)
                if epe <= best_val_epe:
                    best_val_epe, best_val_step = epe, current_step
                    for index in visual:
                        if main and index in val_last:
                            save_flow_png(val_last[index], osp.join(
                                log_dir, "val/im%03d/%06d.png" % (index, current_step)))
                    # Numbered best-EPE save, pruned oldest-first
                    # (train_acc.py:291-301).
                    if main:
                        ckpt.save_best(current_step, state)
                logger.info("Validation EPE: %.3f, best: %.3f (step %d)",
                            epe, best_val_epe, best_val_step)
                if tb is not None:
                    tb.write_dict({"val/epe": epe}, current_step)

            if max_steps is not None and current_step >= max_steps:
                stop = True
                break

    if main:  # final.pth (train_acc.py:311)
        ckpt.save_final(max(current_step, 1), checkpoint_state(model, optimizer, current_step))
    mesh.sync_processes("final")
    if own_tb:
        tb.close()
    logger.info("Finish training")
    return TrainState(model, optimizer, current_step)
