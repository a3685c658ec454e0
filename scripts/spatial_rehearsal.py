#!/usr/bin/env python3
"""Rehearse `chip_smoke.py --nccl-spatial`'s cases on CPU gloo ranks at a
small size, and count each call's spatial collectives and bytes per rank.

    python scripts/spatial_rehearsal.py [--ranks 4] [--size 64]

Each case runs as the chip run does, the configurations as shipped, but in
float32 on the CPU at size^2 frames and batch 2 (batch 2 a data group on
the (2, 2) mesh, 2 a rank data-parallel), one call each, with graphed=True
and graphed=False (on CPU tensors a graphed wrapper calls the function as
it is, so both must count alike): (o) AccFlow+RAFT on a 7-frame clip
("fused"), (p) stream (b) (warm start, 6 iterations: the reset, then a
push), (q) configs/AccRAFT.yml's train step, (r) configs/RAFT.yml's
fine-tune step; on n_spatial 2 and `ranks`, the (2, 2) mesh (four ranks)
and, for (q), data-parallel over every rank; with --ranks 1, the one-rank
handle of a world of one (phase 19a's). The ranks are this script started
once per rank. A collective
count depends on the model and its iterations, not on the frame size, the
batch or the dtype; the bytes scale with them. Rank 0 prints one JSON line
per case and mesh with every rank's counts.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from accflow_tpu_torch.models import AccFlowConfig, accflow_forward, build_flow_estimator  # noqa: E402
from accflow_tpu_torch.models import init_accflow  # noqa: E402
from accflow_tpu_torch.parallel import mesh  # noqa: E402
from accflow_tpu_torch.streaming import StreamAccumulator, make_streaming_fns  # noqa: E402
from accflow_tpu_torch.train import engine, finetune  # noqa: E402
from accflow_tpu_torch.train.optim import make_optimizer  # noqa: E402
from accflow_tpu_torch.utils.config import parse_options  # noqa: E402


def counted(fn) -> list:
    """[collectives, bytes] of one call of fn()."""
    c0 = mesh.counts()
    fn()
    return [a - b for a, b in zip(mesh.counts(), c0)]


def inference(sp, size: int, graphed: bool) -> dict:
    """(o) one clip forward; (p) a reset and a push of stream (b)."""
    est = build_flow_estimator("raft", compute_dtype="float32", device="cpu")
    acc = init_accflow(AccFlowConfig(compute_dtype="float32"), device="cpu")
    rng = np.random.default_rng(0)
    clip = mesh.shard_rows(torch.from_numpy(rng.uniform(-1, 1, (7, 2, size, size, 3)).astype(
        np.float32)), sp, 2)
    out = {"o": counted(lambda: accflow_forward(acc, clip, est.pairs_fn(spatial=sp),
                                                spatial=sp))}
    est6 = build_flow_estimator("raft", compute_dtype="float32", iters=6, device="cpu")
    warm = init_accflow(AccFlowConfig(compute_dtype="float32", warm_start=True), device="cpu")
    if graphed:
        stream = StreamAccumulator(est6, warm, spatial=sp)
        out["p reset"] = counted(lambda: stream.reset(clip[:3]))
        out["p push"] = counted(lambda: stream.push(clip[3]))
    else:
        init, step = make_streaming_fns(est6, warm, spatial=sp)
        state = {}
        out["p reset"] = counted(lambda: state.update(s=init(clip[:3])[1]))
        out["p push"] = counted(lambda: step(state["s"], clip[3]))
    return out


def steps(sp, group, data, size: int, graphed: bool, kinds="qr") -> dict:
    """One (q) AccRAFT.yml and (r) RAFT.yml step as shipped but float32 at
    size^2, this rank's share (`data`: its index, n_data) of a batch of 2
    a data group, its rows of `sp`."""
    out = {}
    d, n_data = data
    rng = np.random.default_rng(1)
    n = 2 * n_data

    def rows(a):
        return mesh.shard_rows(torch.from_numpy(a).chunk(n_data)[d], sp)

    if "q" in kinds:
        opt = parse_options(str(REPO / "configs" / "AccRAFT.yml"))
        opt.update(compute_dtype="float32")
        est, acfg = engine.build_acc_model(opt, device="cpu")
        acc = init_accflow(acfg, device="cpu")
        step, _ = engine.make_acc_train_step(
            est, acc, make_optimizer(acc.parameters(), opt.lr, 100), opt.add_noise,
            graphed=graphed, group=group, spatial=sp)
        imgs = rows(rng.integers(0, 256, (n, size, size, 21)).astype(np.float32))
        labels = rows((4 * rng.standard_normal((n, size, size, 10))).astype(np.float32))
        out["q"] = counted(lambda: step(imgs, labels, torch.Generator().manual_seed(0)))
    if "r" in kinds:
        opt = parse_options(str(REPO / "configs" / "RAFT.yml"))
        opt.update(compute_dtype="float32", flow_pretrained=None)
        est = finetune.build_estimator(opt, device="cpu")
        step, _ = finetune.make_finetune_step(
            est, make_optimizer(est.model.parameters(), opt.lr, 100), opt.add_noise,
            opt.get("gamma", 0.85), remat=opt.get("scan_remat", "dots"), graphed=graphed,
            group=group, spatial=sp)
        img1, img2 = (rows(rng.integers(0, 256, (n, size, size, 3)).astype(np.uint8))
                      for _ in range(2))
        label = rows((4 * rng.standard_normal((n, size, size, 2))).astype(np.float32))
        out["r"] = counted(lambda: step(img1, img2, label, torch.Generator().manual_seed(0)))
    return out


def child(rank: int, world: int, port: int, size: int) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), ACCFLOW_DISTRIBUTED="1")
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    mesh.maybe_init_distributed("cpu")
    if world == 1:  # phase 19a's one-rank handle in a world of one
        handles = {"1": (mesh.Spatial(torch.distributed.group.WORLD, 0, 1), None, (0, 1))}
    else:
        handles = {str(n): (mesh.make_mesh(world // n, n).axis, None, (0, 1))
                   for n in sorted({2, world})}
    if world == 4:
        m = mesh.make_mesh(2, 2)
        handles["2x2"] = (m.axis, m.data_group, (rank // 2, 2))
    rows = []
    for name, (sp, group, data) in handles.items():
        sp = sp.at_height(size)
        for graphed in (False, True):
            got = steps(sp, group, data, size, graphed)
            if group is None:
                got.update(inference(sp, size, graphed))
            rows.append(dict(mesh=name, graphed=graphed, rank=rank, **got))
    for graphed in (False, True):
        rows.append(dict(mesh=f"data x{world}", graphed=graphed, rank=rank,
                         **steps(None, torch.distributed.group.WORLD, (rank, world), size,
                                 graphed, "q")))
    gathered = [None] * world
    torch.distributed.all_gather_object(gathered, rows)
    if rank == 0:
        for i, row in enumerate(rows):
            print(json.dumps({"mesh": row["mesh"], "graphed": row["graphed"], "size": size,
                              **{k: [g[i][k] for g in gathered] for k in row
                                 if k not in ("mesh", "graphed", "rank")}}))
    torch.distributed.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--size", type=int, default=64, help="frame height and width (8 x ranks x k)")
    ap.add_argument("--child", nargs=2, type=int, metavar=("RANK", "PORT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child[0], args.ranks, args.child[1], args.size)
        return 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--ranks", str(args.ranks), "--size",
                               str(args.size), "--child", str(r), str(port)])
             for r in range(args.ranks)]
    return max(p.wait() for p in procs)


if __name__ == "__main__":
    sys.exit(main())
