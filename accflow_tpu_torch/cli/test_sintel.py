"""High-Speed Sintel evaluation CLI of the port, counterpart of
accflow_tpu/cli/test_sintel.py (a consumer for the reference's
High_Speed_Sintel loader, data/dataset.py:164-236):

    python -m accflow_tpu_torch.cli.test_sintel -acc acc -ofe raft \\
        --acc_ckpt checkpoints/acc_raft.pth --dataset-root data/hs_sintel

Per sample the subsampled high-FPS sequence spans the original Sintel pair;
EPE all / noc / occ are reported against the pair's ground-truth flow.
Beyond JAX's flags: --device (cuda by default; cpu runs the plain path).
Under torchrun each rank runs its rows of every batch.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--acc", "-acc", type=str, choices=["acc", "direct"], default="acc")
    parser.add_argument("--acc_ckpt", type=str, default=None)
    parser.add_argument("--ofe", "-ofe", type=str, choices=["raft", "gma"], default="raft")
    parser.add_argument("--ofe_ckpt", type=str, default=None)
    parser.add_argument("--dataset-root", type=str, default="./data/hs_sintel")
    parser.add_argument("--interv", type=int, default=6,
                        help="high-FPS frame subsampling stride")
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--compute-dtype", type=str, default="bfloat16")
    parser.add_argument("--result-file", type=str, default=None)
    parser.add_argument("--batch", type=int, default=4,
                        help="samples per model call (every sequence is resized to one "
                        "shape, so one call signature)")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from accflow_tpu_torch.parallel.mesh import maybe_init_distributed
    from accflow_tpu_torch.train.evaluate import evaluate_sintel

    maybe_init_distributed(args.device)
    return evaluate_sintel(
        args.acc + "|" + args.ofe,
        args.dataset_root,
        interv=args.interv,
        iters=args.iters,
        acc_ckpt=args.acc_ckpt,
        ofe_ckpt=args.ofe_ckpt,
        compute_dtype=args.compute_dtype,
        result_file=args.result_file,
        batch=args.batch,
        device=args.device,
    )


if __name__ == "__main__":
    main()
