"""CVO evaluation CLI of the port, counterpart of accflow_tpu/cli/test_cvo.py
(reference test_cvo.py flags, :106-112):

    python -m accflow_tpu_torch.cli.test_cvo -d clean -acc direct -ofe raft \\
        --ofe_ckpt checkpoints/raft-things.pth --dataset-root data/cvor

Beyond the reference: --dataset-root (CVOR data), --synthetic (write a small
synthetic dataset there first), --size/--iters/--batch, --corr_lookup, and
--device (cuda by default; cpu runs the plain path). Under torchrun each rank
runs its rows of every micro-batch.
"""

from __future__ import annotations

import argparse
import os.path as osp


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data", "-d", type=str, choices=["clean", "final"], default="clean")
    parser.add_argument("--acc", "-acc", type=str, choices=["acc", "direct"], default="direct")
    parser.add_argument("--acc_ckpt", type=str, default=None)
    parser.add_argument("--ofe", "-ofe", type=str, choices=["raft", "gma"], default="raft")
    parser.add_argument("--ofe_ckpt", type=str, default=None)
    parser.add_argument("--dataset-root", type=str, default="./data/cvor")
    parser.add_argument("--batch", type=int, default=10)
    parser.add_argument("--micro_batch", type=int, default=None,
                        help="samples per model call (default: the largest divisor of "
                        "batch <= 8); metrics still aggregate per --batch")
    parser.add_argument("--end", type=int, default=6)
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--compute-dtype", type=str, default="bfloat16")
    parser.add_argument("--corr_lookup", type=str, default="fused",
                        help="correlation lookup: fused (also mm, pallas_fused), auto, "
                        "ondemand[:chunk] or an experimental: spelling (see "
                        "RAFTConfig.corr_lookup)")
    parser.add_argument("--attn_chunk", type=int, default=0,
                        help="gma only: >0 recomputes the attention per chunk of query "
                        "rows instead of storing the (HW)^2 matrix; -1 picks per shape; "
                        "0 (default) stores it")
    parser.add_argument("--scan_unroll", type=int, default=1,
                        help="the JAX package's GRU-scan unroll; the port runs its GRU "
                        "loop eagerly and takes only 1")
    parser.add_argument("--warm_start", action="store_true",
                        help="warm-start consecutive pair solves (AccFlowConfig.warm_start; "
                        "direct: the source-anchored flow_init chain)")
    parser.add_argument("--synthetic", action="store_true",
                        help="write a small synthetic CVOR dataset at --dataset-root first")
    parser.add_argument("--size", type=int, default=64, help="synthetic frame size")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.scan_unroll != 1:
        parser.error(f"--scan_unroll {args.scan_unroll}: the port has no GRU scan to "
                     "unroll (a TPU compile knob); only 1 is accepted")

    if args.synthetic and not osp.exists(osp.join(args.dataset_root, "test", "meta.json")):
        from accflow_tpu_torch.data.synthetic import write_synthetic_cvor

        write_synthetic_cvor(args.dataset_root, num_train=2, num_test=4,
                             h=args.size, w=args.size)

    from accflow_tpu_torch.parallel.mesh import maybe_init_distributed
    from accflow_tpu_torch.train.evaluate import evaluate_cvo

    maybe_init_distributed(args.device)
    return evaluate_cvo(
        args.acc + "|" + args.ofe,
        args.dataset_root,
        split=args.data,
        batch=args.batch,
        end=args.end,
        iters=args.iters,
        acc_ckpt=args.acc_ckpt,
        ofe_ckpt=args.ofe_ckpt,
        compute_dtype=args.compute_dtype,
        warm_start=args.warm_start,
        corr_lookup=args.corr_lookup,
        micro_batch=args.micro_batch,
        attn_chunk=args.attn_chunk,
        device=args.device,
    )


if __name__ == "__main__":
    main()
