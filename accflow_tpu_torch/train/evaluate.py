"""CVO and High-Speed Sintel evaluation (reference test_cvo.py), counterpart
of accflow_tpu/train/evaluate.py's `cal_epe`, `evaluate_cvo`,
`evaluate_sequence` and `evaluate_sintel`, for RAFT and GMA (`acc|raft`,
`direct|gma`, ...).

Protocol (BASELINE.md):
- CVO-{end} (end = 6): the flow from frame `end` back to frame 0 on the CVO
  test set, clean or final, batch 10;
- direct: F_{end,0} = estimator(imgs[end], imgs[0]); acc: the last output
  of AccFlow over imgs[:end+1];
- the occlusion mask from the bidirectional consistency of the ground truth
  pair (bflows[end-2], fflows[end-2]) with thresh 0.01*(|f|+|b|)+0.5
  (test_cvo.py:53-78);
- per-sample EPE all / occ / vis averaged over the dataset and appended to
  test_result_{split}_E{end}.txt (test_cvo.py:157-166).

Batches stream from the CVOR reader through `device_prefetch`; each batch
runs in micro-batches (one model call each) while the metrics follow
`batch` exactly, the padded trailing batch counted by its valid samples.
A micro-batch's call (the clip to its flow, the occlusion mask and the
per-sample EPEs) replays a CUDA graph on the card (graphs.CudaGraphed, as
JAX jits eval_batch); padding and the micro-batch divisor give it one
signature, and the EPEs are read back outside the graph. Under a process
group of more than one rank (parallel/mesh.py) each rank runs its share of
every micro-batch and the per-sample metrics are gathered; rank 0 writes
the result line.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from accflow_tpu_torch.convert import (
    load_accflow_checkpoint,
    load_flow_estimator_checkpoint,
    load_jax_params,
)
from accflow_tpu_torch.data.cvo import BatchIterator, fetch_valid_dataset
from accflow_tpu_torch.data.prefetch import device_prefetch
from accflow_tpu_torch.device import resolve_device
from accflow_tpu_torch.graphs import CudaGraphed
from accflow_tpu_torch.models import (
    AccFlowConfig,
    accflow_forward,
    build_flow_estimator,
    init_accflow,
)
from accflow_tpu_torch.ops.occlusion import calc_occ_mask
from accflow_tpu_torch.ops.padding import InputPadder
from accflow_tpu_torch.parallel import mesh
from accflow_tpu_torch.train.engine import pad_batch, to_clip, to_flow_seq


def cal_epe(pred, label, occ_mask):
    """Per-sample EPE all / occ / vis (test_cvo.py:81-101) of (N, H, W, 2)
    flows and an (N, H, W, 1) occlusion mask (1 = occluded). A sample with
    an empty region reports 0 there (the reference would give nan)."""
    diff = torch.sqrt(torch.sum((pred - label) ** 2, dim=-1, keepdim=True))

    def masked_mean(mask):
        denom = mask.sum(dim=(1, 2, 3))
        num = (diff * mask).sum(dim=(1, 2, 3))
        return torch.where(denom > 0, num / denom.clamp(min=1.0), torch.zeros_like(num))

    return diff.mean(dim=(1, 2, 3)), masked_mean(occ_mask), masked_mean(1.0 - occ_mask)


def default_micro_batch(batch: int) -> int:
    """The largest divisor of `batch` that is <= 8."""
    return batch if batch <= 8 else max(d for d in range(1, 9) if batch % d == 0)


def evaluate_cvo(
    model_name: str,
    dataset_root: str,
    split: str = "clean",
    batch: int = 10,
    end: int = 6,
    iters: int = 12,
    acc_ckpt: Optional[str] = None,
    ofe_ckpt: Optional[str] = None,
    params=None,
    acc_params=None,
    compute_dtype: str = "bfloat16",
    result_file: Optional[str] = None,
    frames: int = 7,
    warm_start: bool = False,
    corr_lookup: str = "fused",
    micro_batch: Optional[int] = None,
    data_parallel: bool = True,
    attn_chunk: int = 0,
    device=None,
):
    """Run the CVO-{end} protocol. model_name: e.g. "direct|raft",
    "acc|gma" (test_cvo.py:118). Weights: `params` / `acc_params` as
    JAX-layout param trees (what convert.to_jax_params and the JAX package
    give), else the checkpoints (a reference .pth or .npz; an acc checkpoint
    holds the OFE too), else drawn from seeds 0 (the estimator) and 1
    (AccFlow). attn_chunk: GMA's (GMAConfig.attn_chunk; dropped for RAFT).
    Returns {"all", "occ", "vis"} mean EPEs.

    micro_batch: samples per model call (default: the largest divisor of
    `batch` <= 8); a non-divisor is rounded down to one. warm_start: acc
    mode warm-starts each accumulation step's OFE queries
    (AccFlowConfig.warm_start); direct mode estimates imgs[end] -> imgs[k]
    for k = end-1 .. 0, each solve initialised from the previous interval's
    1/8-res flow. data_parallel: under a process group of more than one
    rank, each rank runs its rows of every micro-batch (padded up to a
    multiple of the world by repeating its last sample) and the per-sample
    metrics are gathered (JAX's batch-sharded eval); metrics are unchanged,
    and one rank is a no-op. device: cuda unless given."""
    dev = resolve_device(device)
    use_acc = "acc" in model_name.split("|")[0]
    est, acc = _eval_models(model_name, dev, compute_dtype, iters, params, acc_params,
                            acc_ckpt, ofe_ckpt, corr_lookup=corr_lookup,
                            attn_chunk=int(attn_chunk), warm_start=warm_start)

    @CudaGraphed
    @torch.no_grad()
    def eval_batch(imgs, bflows, fflows):
        images = to_clip(imgs, frames)[: end + 1].to(dev)
        bseq = to_flow_seq(bflows)[: end - 1].to(dev, torch.float32)
        fseq = to_flow_seq(fflows)[: end - 1].to(dev, torch.float32)
        if use_acc:
            fn0 = accflow_forward(acc, images, ofe_pairs=est.pairs_fn(), ofe=est.flow_fn())[-1]
        elif warm_start:
            # Source-anchored: the query grid never moves, so no splat.
            out = est.forward(images[-1], images[-2], final_only=True)
            for k in range(end - 2, -1, -1):
                out = est.forward(images[-1], images[k], flow_init=out["flow_low"],
                                  final_only=True)
            fn0 = out["flow_up"]
        else:
            fn0 = est.forward(images[-1], images[0], final_only=True)["flow_up"]
        bmask, _ = calc_occ_mask(bseq[-1], fseq[-1])
        return cal_epe(fn0, bseq[-1], bmask)

    dst = fetch_valid_dataset(dataset_root, ["fflows", "bflows"], split=split)
    it = BatchIterator(dst, batch, shuffle=False, drop_last=False)
    micro_batch = max(1, min(micro_batch or default_micro_batch(batch), batch))
    while batch % micro_batch:
        micro_batch -= 1
    call_rows, shard = _sharded(data_parallel, micro_batch)

    alls, occs, viss = [], [], []
    padded = (pad_batch(b, batch) for b in it)
    for b, n_valid in device_prefetch(padded, depth=2, device=dev):
        for m0 in range(0, n_valid, micro_batch):
            mb = {k: shard(_pad_rows(v[m0: m0 + micro_batch], call_rows)) for k, v in b.items()}
            epes = eval_batch(mb["imgs"], mb["bflows"], mb["fflows"])
            nv = min(n_valid - m0, micro_batch)
            for out, e in zip((alls, occs, viss), epes):
                out.append(mesh.host_array(e)[:nv])

    result = {"all": float(np.mean(np.concatenate(alls))),
              "occ": float(np.mean(np.concatenate(occs))),
              "vis": float(np.mean(np.concatenate(viss)))}
    line = "AVG EPE %s: \nall:%.4f vis:%.4f occ:%.4f \n\n" % (
        model_name, result["all"], result["vis"], result["occ"])
    _report(line, result_file or f"test_result_{split}_E{end}.txt")
    return result


def _eval_models(model_name: str, dev, compute_dtype: str, iters: int, params, acc_params,
                 acc_ckpt, ofe_ckpt, warm_start: bool = False, **est_kw):
    """(estimator, accumulator or None) of an evaluation: weights from the
    JAX-layout trees `params` / `acc_params`, else the checkpoints (an acc
    checkpoint holds the OFE too), else seeds 0 (the estimator) and 1
    (AccFlow)."""
    use_acc = "acc" in model_name.split("|")[0]
    est = build_flow_estimator(model_name, compute_dtype=compute_dtype, device=dev,
                               iters=iters, **est_kw)
    acc = None
    if use_acc:
        acc = init_accflow(AccFlowConfig(compute_dtype=compute_dtype, ofe_iters=iters,
                                         warm_start=warm_start), seed=1, device=dev)
    if params is not None:
        load_jax_params(est.model, params)
    elif use_acc and acc_ckpt:
        load_accflow_checkpoint(acc_ckpt, acc, est.model)
    elif ofe_ckpt:
        load_flow_estimator_checkpoint(ofe_ckpt, est.model)
    if use_acc and acc_params is not None:
        load_jax_params(acc, acc_params)
    return est, acc


def _sharded(data_parallel: bool, rows: int):
    """(rows of one call, this rank's selection of them) of a data-parallel
    evaluation: under more than one rank, a call of `rows` samples padded up
    to a multiple of the world (by repeating its last sample; the gathered
    metrics are trimmed to the valid ones) and this rank's share of it; else
    `rows` and the identity."""
    world = mesh.world_size()
    if not data_parallel or world == 1:
        return rows, lambda v: v
    return -(-rows // world) * world, mesh.shard_batch


def _pad_rows(v, n: int):
    """`v` (batch on axis 0) with its last row repeated up to n rows."""
    v = torch.as_tensor(v)
    return v if v.shape[0] == n else torch.cat([v, v[-1:].expand(n - v.shape[0], *v.shape[1:])])


def _report(line: str, result_file: Optional[str]) -> None:
    """The result line on the console and appended to `result_file`, by the
    main process only (every rank holds the same gathered metrics)."""
    if mesh.is_main_process():
        print(line.strip())
        if result_file:
            with open(result_file, "a+") as f:
                f.write(line)


def evaluate_sequence(est, frames, iters: int = 12, warm_start: bool = True) -> torch.Tensor:
    """Consecutive-pair flows over a frame sequence with upstream RAFT's
    warm start (networks/raft/utils/utils.py:31-63 semantics, the splat on
    the device: ops/warmstart.py), accflow_tpu/train/evaluate.py's
    evaluate_sequence. frames (T, N, H, W, 3) in [-1, 1], on the
    estimator's device or the host. Returns (T-1, N, H, W, 2) float32 flows
    [f_{0->1}, ..., f_{T-2 -> T-1}]; with warm_start each solve starts from
    the previous 1/8-res flow advected along itself."""
    from accflow_tpu_torch.ops.warmstart import forward_splat_flow

    out = est.forward(frames[0], frames[1], iters=iters, final_only=True)
    flows = [out["flow_up"]]
    for i in range(1, frames.shape[0] - 1):
        init = forward_splat_flow(out["flow_low"]) if warm_start else None
        out = est.forward(frames[i], frames[i + 1], iters=iters, flow_init=init,
                          final_only=True)
        flows.append(out["flow_up"])
    return torch.stack(flows)


def _sintel_epes(flow: np.ndarray, gt: np.ndarray, occ: np.ndarray):
    """EPE all / occ / noc of one (H, W, 2) flow against its ground truth
    and boolean occlusion mask; an empty region reports 0."""
    epe = np.sqrt(((flow - gt) ** 2).sum(-1))
    return (float(epe.mean()), float(epe[occ].mean()) if occ.any() else 0.0,
            float(epe[~occ].mean()) if (~occ).any() else 0.0)


def evaluate_sintel(
    model_name: str,
    data_root: str,
    interv: int = 6,
    iters: int = 12,
    params=None,
    acc_params=None,
    ofe_ckpt: Optional[str] = None,
    acc_ckpt: Optional[str] = None,
    compute_dtype: str = "bfloat16",
    blacklist=(),
    result_file: Optional[str] = None,
    size=(1024, 436),
    batch: int = 4,
    corr_lookup: str = "fused",
    data_parallel: bool = True,
    device=None,
):
    """High-Speed Sintel evaluation over data/sintel.py (the reference ships
    the loader, data/dataset.py:164-236, but no engine). Per sample the
    `43_imgs` high-FPS sequence subsampled at `interv` spans the original
    Sintel pair whose ground-truth flow and occlusion mask are given; the
    long-range flow img0 -> img1 is estimated by:

    - "direct|...": one estimator call on the endpoint pair;
    - "acc|...": AccFlow over the REVERSED subsampled sequence (AccFlow
      accumulates frame i -> frame 0, so reversing makes the last output
      img0 -> img1).

    Frames are padded by InputPadder(mode="sintel") and the flow unpadded
    before the metric. The loader resizes every sequence to `size` (W, H),
    so samples run `batch` at a time in one call of one signature, replayed
    from a CUDA graph on the card (graphs.CudaGraphed); the trailing partial
    batch is padded by repeating its last sample and trimmed after.
    Weights, `corr_lookup` and `device` as evaluate_cvo's. data_parallel:
    under more than one rank, each rank runs its rows of the batch (padded
    up to a multiple of the world) and the per-sample metrics are gathered. Reports EPE all / occ / noc (the
    Sintel convention) averaged over samples; rank 0 prints the line and
    appends it to `result_file` when given."""
    from accflow_tpu_torch.data.sintel import fetch_sintel_dataset

    dev = resolve_device(device)
    use_acc = "acc" in model_name.split("|")[0]
    est, acc = _eval_models(model_name, dev, compute_dtype, iters, params, acc_params,
                            acc_ckpt, ofe_ckpt, corr_lookup=corr_lookup)

    @CudaGraphed
    @torch.no_grad()
    def eval_call(frames):  # (T, B, Hp, Wp, 3) -> (B, Hp, Wp, 2)
        if use_acc:
            return accflow_forward(acc, frames.flip(0), ofe_pairs=est.pairs_fn(),
                                   ofe=est.flow_fn())[-1]
        return est.forward(frames[0], frames[-1], final_only=True)["flow_up"]

    dst = fetch_sintel_dataset(data_root, interv=interv, blacklist=blacklist, size=size)
    call_rows, shard = _sharded(data_parallel, batch)
    metrics = {"all": [], "occ": [], "noc": []}
    padder, pending = None, []  # pending: (padded (T, Hp, Wp, 3) frames, gt, occ)

    def flush():
        n_valid = len(pending)
        pending.extend([pending[-1]] * (call_rows - n_valid))
        rows = shard(np.arange(call_rows))
        frames = torch.as_tensor(np.stack([pending[i][0] for i in rows], axis=1)).to(dev)
        flow = padder.unpad(eval_call(frames)).float().cpu().numpy()
        local = np.array([_sintel_epes(f, *pending[i][1:]) for f, i in zip(flow, rows)])
        for name, col in zip(("all", "occ", "noc"), mesh.host_array(local)[:n_valid].T):
            metrics[name].extend(col.tolist())
        pending.clear()

    for idx in range(len(dst)):
        sample = dst.get(idx)
        hs = np.stack(sample["hs_sintel_imgs"], axis=0)  # (T, H, W, 3)
        frames = (2.0 * (hs / 255.0) - 1.0).astype(np.float32)
        if padder is None:
            padder = InputPadder(frames.shape[-3:-1], mode="sintel")
        pending.append((padder.pad_np(frames), sample["gt_flow"],
                        sample["occ_mask"][..., 0] > 0.5))
        if len(pending) == batch:
            flush()
    if pending:
        flush()

    result = {k: float(np.mean(v)) for k, v in metrics.items()}
    line = "AVG EPE sintel %s interv=%d: \nall:%.4f noc:%.4f occ:%.4f \n\n" % (
        model_name, interv, result["all"], result["noc"], result["occ"])
    _report(line, result_file)
    return result
