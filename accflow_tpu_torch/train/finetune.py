"""Estimator (RAFT / GMA) fine-tuning, the port's counterpart of
accflow_tpu/train/finetune.py (reference fine_tune.py).

Recipe (configs/RAFT.yml, GMA.yml):
- data: CVO clean+final with all four flow-key groups, random crops of
  image_size, batch batch_per_gpu, shuffled, last partial batch dropped;
- each step picks one task on the host (select_pair: interval in [1, 7),
  direction +-1), which selects the input pair and its ground truth among
  the local and cross-frame, forward and backward flows;
- the estimator in training mode (its context encoder's BatchNorm on the
  batch's statistics, the running statistics moved once per step after the
  update), 12 GRU iterations, the gamma-weighted sequence loss (gamma 0.85);
- the accumulator recipe's noise, AdamW, OneCycle and clip;
- validation: the flow imgs[-1] -> imgs[0] at 20 iterations against
  bflows[-1], capped at valid_sample + 1 samples.

On the card the step runs on one GPU, bf16 compute with float32 master
weights and float32 flow state; the pyramid is float32, and the lookup's
forward and backward are kernel #1 and its backward kernel (kernel #2 and
its backward for RAFT-small). Each GRU iteration is checkpointed as JAX's
scan_remat ("dots" by default). As JAX jits the step, fine_tune replays it
from a CUDA graph (engine.graph_steps: the noise draw, forward, remat's
recompute, backward, clip, AdamW update and the BatchNorm write-back in
the graph; select_pair's host choice arrives as the step's inputs, so one
graph serves every pair) and its validation step too; on the CPU both run
eagerly. Under torchrun the step is data-parallel as train_acc's
(train/engine.py), and train-mode BatchNorm takes the global batch's
statistics (nn/layers.py::batch_norm_train), as JAX's GSPMD step does.

make_finetune_step also takes a spatial handle, as make_acc_train_step
does: JAX's make_finetune_step with its batch sharded P("data",
"spatial"), where GSPMD trains the estimator on height shards. Each rank
holds its rows of its samples; the estimator's training forward runs on
them (halos, the gathered target fnet map and GMA's keys and values, the
lookups and their backward kernel on this rank's queries), BatchNorm takes
the mesh's statistics, each rank back-propagates its pixels' part of the
sequence loss over the global count, and the update sums the gradients
over the spatial group and averages them over the data group. With
graphed=True the step is captured over NCCL with every exchange in it (the
halos and gathers, those that remat re-runs in the backward, BatchNorm's
sums over the mesh, the backward's all_reduces, the gradient sum), as
JAX's jit holds GSPMD's; under gloo on the card it refuses
(engine.graph_steps). fine_tune itself stays data-parallel, as JAX's
builds its mesh with n_spatial 1 (accflow_tpu/train/finetune.py:147).
"""

from __future__ import annotations

import os.path as osp
from typing import Optional

import numpy as np
import torch

from accflow_tpu_torch.convert import load_flow_estimator_checkpoint, load_jax_params
from accflow_tpu_torch.data.cvo import BatchIterator, fetch_train_dataset, fetch_valid_dataset
from accflow_tpu_torch.data.prefetch import device_prefetch
from accflow_tpu_torch.device import resolve_device
from accflow_tpu_torch.models import FlowEstimator, build_flow_estimator
from accflow_tpu_torch.models.raft import check_trainable_lookup
from accflow_tpu_torch.nn.layers import apply_bn_updates, batch_norm_group, tf32
from accflow_tpu_torch.parallel import mesh
from accflow_tpu_torch.train.accum import accumulate_grads
from accflow_tpu_torch.train.checkpoint import CheckpointManager
from accflow_tpu_torch.train.engine import (
    TrainState,
    checkpoint_state,
    corr_options,
    graph_steps,
    open_run_dirs,
    pad_batch,
    reference_noise,
)
from accflow_tpu_torch.train.loss import sequence_loss_raft
from accflow_tpu_torch.train.optim import Optimizer, make_optimizer
from accflow_tpu_torch.utils.logging import Timer, count_parameters

ALL_FLOW_KEYS = ["fflows", "bflows", "delta_fflows", "delta_bflows"]
TRAIN_ITERS = 12  # JAX's train step runs 12 GRU iterations, its validation 20
VALID_ITERS = 20


def select_pair(batch: dict, rng: np.random.Generator):
    """The step's task (fine_tune.py:208-222) on a batch of channel-cat
    arrays: (img1, img2, label_flow) slices. The draws and their quirks are
    JAX's, so one seed makes the same choices in both packages."""
    imgs = batch["imgs"]

    def frame(i):
        return imgs[..., 3 * i: 3 * i + 3]

    def flow(key, i):
        return batch[key][..., 2 * i: 2 * i + 2]

    interval = int(rng.integers(1, 7))
    direction = int(rng.choice([-1, 1]))
    if interval * direction == 1:
        return frame(0), frame(1), flow("delta_fflows", 0)
    if interval * direction == -1:
        return frame(1), frame(0), flow("delta_bflows", 0)
    if direction == 1:
        return frame(0), frame(interval), flow("fflows", interval - 2)
    return frame(interval), frame(0), flow("bflows", interval - 2)


def _normalize(img) -> torch.Tensor:
    return 2.0 * (torch.as_tensor(img).float() / 255.0) - 1.0


def make_finetune_step(est: FlowEstimator, optimizer: Optimizer, add_noise: bool, gamma: float,
                       grad_accum: int = 1, remat: str = "dots", graphed: bool = False,
                       group=None, spatial=None):
    """(train_step, valid_step) of JAX's make_finetune_step for the
    estimator `est`.

    train_step(img1, img2, label, gen=None) -> (loss, metrics), device
    tensors; images (N, H, W, 3) uint8 values, label (N, H, W, 2): the
    images normalised to [-1, 1], with add_noise one reference_noise draw
    from the torch.Generator `gen` added to both; the training forward
    (TRAIN_ITERS iterations, `remat` per iteration) and the sequence loss
    at `gamma`, over `grad_accum` micro-batches; backward, the update, then
    the running statistics' averaged update. Forward and backward run under
    one TF32 setting, off, so no backward conv of a float32 step runs in
    TF32. valid_step(imgs (N, H, W, 3T), bflows (N, H, W, 2S)) -> (per-sample
    EPE (N,), flow (N, H, W, 2)): imgs[-1] -> imgs[0] at VALID_ITERS
    iterations against bflows[-1], BatchNorm on its running statistics,
    under no_grad. graphed: the two as fine_tune runs them, replayed from
    CUDA graphs on CUDA tensors (engine.graph_steps). group: the process
    group of the data-parallel axis, or None: over its ranks the gradients,
    loss and metrics are averaged, the BatchNorm statistics reduced
    (layers.batch_norm_group) and the noise drawn for the global batch.

    spatial (mesh.Mesh.axis given the frames' height by at_height): the
    images and labels are this rank's rows of its samples (mesh.shard_batch,
    then mesh.shard_rows(x, spatial, dim=1)); the noise is this rank's rows
    of one global draw, BatchNorm reduces over the data x spatial ranks,
    each rank back-propagates its part of the loss over the global pixels,
    the update sums the gradients over the spatial group (then averages
    them over `group`) before the clip, grad_accum splits N (which every
    spatial rank holds whole), the reported loss and metrics are the
    group's sums of the parts, and valid_step returns the per-sample EPE
    over the global pixels and this rank's rows of the flow. graphed=True
    with a handle captures the step with its exchanges over NCCL
    (engine.graph_steps); on the card under gloo its first call raises
    ValueError. A lookup that JAX cannot differentiate raises
    NotImplementedError here (models/raft.py::check_trainable_lookup)."""
    model = est.model
    check_trainable_lookup(model.cfg)

    def loss_fn(i1, i2, label):
        with batch_norm_group(model, group):
            out = est.forward(i1, i2, iters=TRAIN_ITERS, train=True, remat=remat,
                              spatial=spatial)
        return sequence_loss_raft(out["predictions"], label, gamma, spatial)

    def make_update(finish):
        def train_step(img1, img2, label, gen: Optional[torch.Generator] = None):
            i1, i2 = _normalize(img1), _normalize(img2)
            if add_noise:
                noise = reference_noise(gen, i1.shape, group, spatial)
                i1, i2 = i1 + noise, i2 + noise
            optimizer.zero_grad()
            with tf32(False):
                loss, metrics, bn_updates = accumulate_grads(
                    loss_fn, grad_accum, i1, i2, torch.as_tensor(label).float(), axis=0,
                    model=model)
            finish()
            apply_bn_updates(model, bn_updates)
            return mesh.all_mean(mesh.spatial_sum((loss, metrics), spatial), group)

        return train_step

    def valid_step(imgs, bflows):
        imgs = torch.as_tensor(imgs)
        n_frames = imgs.shape[-1] // 3
        i1 = _normalize(imgs[..., 3 * (n_frames - 1):])
        i2 = _normalize(imgs[..., :3])
        label = torch.as_tensor(bflows)[..., -2:]
        flow = est.forward(i1, i2, iters=VALID_ITERS, final_only=True, spatial=spatial)["flow_up"]
        epe = torch.sqrt(torch.sum((flow - label) ** 2, dim=-1))
        if spatial is None:
            return epe.mean(dim=(1, 2)), flow
        h, w = epe.shape[1:]
        return (mesh.spatial_sum(epe.sum(dim=(1, 2)) / (mesh.global_rows(h, spatial) * w),
                                 spatial), flow)

    return graph_steps(make_update, valid_step, optimizer, graphed, group, spatial)


def run_validation(valid_step, valid_dst, batch: int, device, valid_sample: int = 500):
    """One validation pass, capped by samples: the reference validates at
    batch 1 and stops at index valid_sample (fine_tune.py:262-279), after
    valid_sample + 1 samples; the last batch's surplus is left out, so the
    batch size cannot change the pass. Under a process group `batch` is the
    global batch, each rank runs its rows and the EPEs are gathered.
    Returns (mean EPE, samples)."""
    epes_sum, epes_n = 0.0, 0
    cap = int(valid_sample) + 1
    for vb in BatchIterator(valid_dst, batch, shuffle=False, drop_last=False):
        vb, n_valid = pad_batch(vb, batch)
        vb = mesh.shard_batch(vb)
        per_sample, _ = valid_step(torch.as_tensor(vb["imgs"]).to(device),
                                   torch.as_tensor(vb["bflows"]).to(device))
        n_use = min(n_valid, cap - epes_n)
        epes_sum += float(mesh.host_array(per_sample)[:n_use].sum())
        epes_n += n_use
        if epes_n >= cap:
            break
    return epes_sum / max(epes_n, 1), epes_n


def build_estimator(opt, device=None) -> FlowEstimator:
    """The estimator of a fine-tune config (RAFT for a name with "raft",
    else GMA, at the config's corr_levels, corr_radius and
    corr_volume_dtype where it sets them: engine.corr_options) with its
    weights from `init_params` (a JAX-layout numpy tree), `flow_pretrained`
    (a reference .pth or an .npz tree) or the seed, on `device`. A lookup that JAX cannot differentiate raises
    NotImplementedError (models/raft.py::check_trainable_lookup:
    experimental:pallas, a split lookup with a "bd" level); every other
    spelling trains."""
    est = build_flow_estimator(
        opt.exp_name, compute_dtype=opt.get("compute_dtype", "bfloat16"), device=device,
        seed=opt.get("seed", 0), small=bool(opt.get("small", False)),
        corr_lookup=opt.get("corr_lookup", "fused"), attn_chunk=int(opt.get("attn_chunk", 0)),
        **corr_options(opt))
    check_trainable_lookup(est.cfg)
    if opt.get("init_params") is not None:
        load_jax_params(est.model, opt.init_params)
    elif opt.get("flow_pretrained"):
        load_flow_estimator_checkpoint(opt.flow_pretrained, est.model)
    return est


def fine_tune(opt, max_steps: Optional[int] = None, tb=None, device=None) -> TrainState:
    """Fine-tune RAFT or GMA on CVO on one device (cuda unless `device`
    names another; without a GPU it raises unless device="cpu"), or on every
    rank of a torchrun job (as train_acc). `opt`
    mirrors configs/{RAFT,GMA}.yml plus `dataset_root` (CVOR data) and
    optional `init_params` (a JAX-layout numpy tree of the estimator),
    `scan_remat` ("dots" by default, "none", "full"), `grad_accum`, `seed`
    and `resume` ("auto" or a step). max_steps stops early. Returns the
    TrainState (model: the estimator's module).

    tb: an optional utils.tb.TBLogger receiving train/{loss,epe,lr} at every
    log point and val/epe at every validation (`use_tb: true` in opt builds
    one on log_dir)."""
    dev = resolve_device(device)
    mesh.maybe_init_distributed(dev)
    batch = opt.batch_per_gpu * mesh.world_size()
    seed = opt.get("seed", 0)
    gamma = opt.get("gamma", 0.85)

    # Debug-name frequency override (train_acc.py:33-35).
    if "debug" in str(opt.exp_name).lower():
        opt["valid_freq"] = 10
        opt["log_freq"] = 1
    log_dir, ckpt_dir, logger = open_run_dirs(opt, "accflow_torch_ft", "finetune_")
    main = mesh.is_main_process()
    own_tb = tb is None and bool(opt.get("use_tb")) and main
    if own_tb:
        from accflow_tpu_torch.utils.tb import TBLogger

        tb = TBLogger(osp.join(log_dir, "tb"))

    train_dst = fetch_train_dataset(opt.dataset_root, ALL_FLOW_KEYS, crop_size=opt.image_size,
                                    split="clean+final")
    valid_dst = fetch_valid_dataset(opt.dataset_root, ["bflows"], split="clean")
    sample_per_epoch = len(train_dst) // batch + 1
    num_steps = sample_per_epoch * opt.epochs
    logger.info("Fine-tune on %d samples, batch %d on %s x %d, %d total steps",
                len(train_dst), batch, dev, mesh.world_size(), num_steps)

    est = build_estimator(opt, device=dev)
    mesh.shard_params(est.model)
    if opt.get("init_params") is None and opt.get("flow_pretrained"):
        logger.info("Initialized from %s", opt.flow_pretrained)
    logger.info("Parameter Count: trainable: %d", count_parameters(est.model))
    # The BatchNorm running statistics are buffers, not parameters: AdamW
    # never sees them (JAX masks them out of its optimizer, bn_buffer_mask).
    optimizer = make_optimizer(est.model.parameters(), opt.lr, num_steps, opt.wdecay,
                               opt.epsilon, opt.clip)
    train_step, valid_step = make_finetune_step(
        est, optimizer, opt.add_noise, gamma, grad_accum=int(opt.get("grad_accum", 1)),
        remat=opt.get("scan_remat", "dots"), graphed=mesh.collectives_capturable(),
        group=mesh.data_group())
    ckpt = CheckpointManager(ckpt_dir, keep=4)
    current_step = 0
    if opt.get("resume") is not None:
        # "auto" -> the latest saved step; an int -> that numbered checkpoint
        # (train_acc.py:27-32).
        state = ckpt.restore(None if str(opt.resume) == "auto" else int(opt.resume))
        est.model.load_state_dict(state["model"])
        optimizer.load_state_dict(state)
        current_step = int(state["step"])
        logger.info("Resumed from step %d", current_step)

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    host_rng = np.random.default_rng(seed + 2)
    timer = Timer()
    losses, epes = [], []
    best_val_epe = 1e10
    best_val_step = current_step
    stop = False

    for epoch in range(current_step // sample_per_epoch, opt.epochs):
        if stop:
            break
        it = BatchIterator(train_dst, batch, shuffle=True, drop_last=True, seed=seed,
                           epoch=epoch)
        timer.tick()
        for batch_t in device_prefetch(map(mesh.shard_batch, it), depth=2, device=dev):
            current_step += 1
            img1, img2, label = select_pair(batch_t, host_rng)
            loss, metrics = train_step(img1, img2, label, gen)
            losses.append(float(loss))
            epes.append(float(metrics["epe"]))
            timer.tick()

            if current_step % opt.log_freq == 0 or current_step < 25:
                avg_time = timer.get_average_and_reset()
                avg_loss = sum(losses) / len(losses)
                avg_epe = sum(epes) / len(epes)
                lr_now = optimizer.lr
                logger.info("<epoch:%2d, iter:%6d, t:%.2fs, loss:%.3f, epe:%.3f, lr:%.2e>",
                            epoch, current_step, avg_time, avg_loss, avg_epe, lr_now)
                if tb is not None:
                    tb.write_dict({"train/loss": avg_loss, "train/epe": avg_epe,
                                   "train/lr": lr_now}, current_step)
                losses, epes = [], []

            if current_step % opt.valid_freq == 0 or current_step == num_steps - 1:
                epe, _ = run_validation(valid_step, valid_dst, batch, dev,
                                        opt.get("valid_sample", 500))
                state = checkpoint_state(est.model, optimizer, current_step)
                if main:
                    ckpt.save(current_step, state)  # `latest` (fine_tune.py:285)
                if epe <= best_val_epe:
                    best_val_epe, best_val_step = epe, current_step
                    if main:
                        ckpt.save_best(current_step, state)
                logger.info("Validation EPE: %.3f, best: %.3f (step %d)",
                            epe, best_val_epe, best_val_step)
                if tb is not None:
                    tb.write_dict({"val/epe": epe}, current_step)

            if max_steps is not None and current_step >= max_steps:
                stop = True
                break

    if main:
        ckpt.save_final(max(current_step, 1),
                        checkpoint_state(est.model, optimizer, current_step))
    mesh.sync_processes("final")
    if own_tb:
        tb.close()
    logger.info("Finish fine-tuning")
    return TrainState(est.model, optimizer, current_step)
