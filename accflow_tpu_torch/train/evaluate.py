"""CVO evaluation (reference test_cvo.py), counterpart of
accflow_tpu/train/evaluate.py's `cal_epe`, `evaluate_cvo` and
`evaluate_sequence`, for RAFT and GMA (`acc|raft`, `direct|gma`, ...).

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
from accflow_tpu_torch.models import (
    AccFlowConfig,
    accflow_forward,
    build_flow_estimator,
    init_accflow,
)
from accflow_tpu_torch.ops.occlusion import calc_occ_mask
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
    1/8-res flow. data_parallel is a no-op on one device (multi-GPU waits
    for ROADMAP.md queue 1 #12). device: cuda unless given."""
    del data_parallel  # one device
    dev = resolve_device(device)
    use_acc = "acc" in model_name.split("|")[0]
    est = build_flow_estimator(model_name, compute_dtype=compute_dtype, device=dev,
                               corr_lookup=corr_lookup, iters=iters,
                               attn_chunk=int(attn_chunk))
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

    alls, occs, viss = [], [], []
    padded = (pad_batch(b, batch) for b in it)
    for b, n_valid in device_prefetch(padded, depth=2, device=dev):
        for m0 in range(0, n_valid, micro_batch):
            mb = {k: v[m0: m0 + micro_batch] for k, v in b.items()}
            epes = eval_batch(mb["imgs"], mb["bflows"], mb["fflows"])
            nv = min(n_valid - m0, micro_batch)
            for out, e in zip((alls, occs, viss), epes):
                out.append(e[:nv].cpu().numpy())

    result = {"all": float(np.mean(np.concatenate(alls))),
              "occ": float(np.mean(np.concatenate(occs))),
              "vis": float(np.mean(np.concatenate(viss)))}
    line = "AVG EPE %s: \nall:%.4f vis:%.4f occ:%.4f \n\n" % (
        model_name, result["all"], result["vis"], result["occ"])
    print(line.strip())
    if result_file is None:
        result_file = f"test_result_{split}_E{end}.txt"
    with open(result_file, "a+") as f:
        f.write(line)
    return result


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
