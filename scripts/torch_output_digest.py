#!/usr/bin/env python3
"""Digests of the PyTorch port's outputs on one NVIDIA GPU, to show that a
change of the port leaves a path's numbers as they were:

    python3 scripts/torch_output_digest.py      # from the root of a checkout

It imports the accflow_tpu_torch beside this script (the checkout's), so a
copy of this file in another checkout digests that checkout's port: run the
parent's and the change's in turns in one process each, on one card, and
compare their lines. It uses only entry points that every port since
accumulator training has (accflow_forward, make_streaming_fns,
evaluate_cvo, train_acc), with weights and data from seeds, at the full
widths chip_smoke.py runs:

- clip: AccFlow+RAFT, 7 frames of 512^2, batch 2, 12 iterations, bf16,
  eager: the sha256 of the output's bytes; clip_gma: the same with GMA,
  its gamma set to 2.5 (at its init of 0 the attention adds nothing);
- stream (a) RAFT-small and (b) full RAFT under AccFlow 128, warm-started,
  512^2, batch 2, 6 iterations: a reset on 3 frames and 5 pushes, the
  sha256 of every output's bytes;
- eval: evaluate_cvo, acc|raft with "fused", 6 synthetic 512^2 clips at
  batch 6, 12 iterations, bf16: the metrics as floats;
- train_acc: configs/AccRAFT.yml as shipped on 12 synthetic 256^2 clips, 3
  steps from seed 0, noise on: the losses as floats and the sha256 of the
  trained weights;
- fine_tune: configs/RAFT.yml as shipped on the same clips, 3 steps from
  seed 0: the losses and the sha256 of the trained weights and buffers
  (fine_tune, and so this entry, exists since estimator fine-tuning).

The last line is one JSON object with these entries and the card's name.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from accflow_tpu_torch import models  # noqa: E402
from accflow_tpu_torch.convert import to_jax_params  # noqa: E402
from accflow_tpu_torch.data.synthetic import write_synthetic_cvor  # noqa: E402
from accflow_tpu_torch.streaming import make_streaming_fns  # noqa: E402
from accflow_tpu_torch.train import engine  # noqa: E402
from accflow_tpu_torch.train import finetune  # noqa: E402
from accflow_tpu_torch.train.evaluate import evaluate_cvo  # noqa: E402
from accflow_tpu_torch.utils.config import parse_options  # noqa: E402


def sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def accumulator(**cfg):
    """AccFlow hidden 128, bf16, from seed 1, its ZeroConv drawn from seed 2
    (at zero the deformable conv's offsets would not move)."""
    acc = models.init_accflow(models.AccFlowConfig(compute_dtype="bfloat16", **cfg), seed=1,
                              device="cpu")
    gen = torch.Generator().manual_seed(2)
    zc = acc.accplus.conv2[4]
    with torch.no_grad():
        for p, scale in ((zc.conv.weight, 0.05), (zc.conv.bias, 0.5), (zc.scale, 0.1)):
            p.copy_(torch.randn(p.shape, generator=gen) * scale)
    return acc.cuda()


def frames(t: int, n: int, size: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((t, n, size, size, 3), generator=gen) * 2 - 1).cuda()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_output_digest: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"card": card, "root": str(ROOT)}
    with torch.no_grad():
        est = models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0)
        acc = accumulator()
        out["clip"] = sha(models.accflow_forward(acc, frames(7, 2, 512, 3), est.pairs_fn()))
        est = models.build_flow_estimator("gma", compute_dtype="bfloat16", seed=0)
        est.model.update_block.aggregator.gamma.fill_(2.5)
        out["clip_gma"] = sha(models.accflow_forward(acc, frames(7, 2, 512, 3), est.pairs_fn()))
        for label, small in (("stream_a", True), ("stream_b", False)):
            est = models.build_flow_estimator("raft", compute_dtype="bfloat16", small=small,
                                              iters=6, seed=0)
            init, step = make_streaming_fns(est, accumulator(warm_start=True))
            seq = frames(8, 2, 512, 4)
            flow, state = init(seq[:3])
            flows = [flow]
            for i in range(3, 8):
                flow, state = step(state, seq[i])
                flows.append(flow)
            out[label] = sha(*flows)
        del est, acc
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        root = str(Path(tmp) / "cvor512")
        write_synthetic_cvor(root, num_train=0, num_test=6, h=512, w=512)
        res = evaluate_cvo("acc|raft", root, batch=6, iters=12, compute_dtype="bfloat16",
                           corr_lookup="fused", acc_params=to_jax_params(accumulator().cpu()),
                           device="cuda", result_file=str(Path(tmp) / "result.txt"))
        out["eval"] = {k: float(v) for k, v in res.items()}
        torch.cuda.empty_cache()
        root = str(Path(tmp) / "cvor256")
        write_synthetic_cvor(root, num_train=12, num_test=2, h=256, w=256)
        for key, module, factory, run, config in (
                ("train", engine, "make_acc_train_step", engine.train_acc, "AccRAFT.yml"),
                ("finetune", finetune, "make_finetune_step", finetune.fine_tune, "RAFT.yml")):
            opt = parse_options(str(ROOT / "configs" / config))
            opt.update(dataset_root=root, log_dir=str(Path(tmp) / key / "logs"),
                       ckpt_dir=str(Path(tmp) / key / "ckpt"), flow_pretrained=None,
                       visual_samples=[], seed=0, valid_freq=1000)
            losses = []
            make = getattr(module, factory)

            def recording(*a, make=make, losses=losses, **k):
                step, valid = make(*a, **k)

                def rec(*args):
                    loss, metrics = step(*args)
                    losses.append(float(loss))
                    return loss, metrics

                return rec, valid

            setattr(module, factory, recording)
            try:
                state = run(opt, max_steps=3)
            finally:
                setattr(module, factory, make)
            out[f"{key}_losses"] = losses
            out[f"{key}_weights"] = sha(*state.model.state_dict().values())
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
