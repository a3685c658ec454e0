"""Export the AccFlow serving pipeline of the port as a torch.export
artifact, counterpart of accflow_tpu/cli/export_serving.py:

    python -m accflow_tpu_torch.cli.export_serving --ofe raft \\
        --acc_ckpt checkpoints/acc+raft-things.pth \\
        --frames 7 --batch 2 --size 512 --out acc_raft_512.pt2

The artifact holds the weights (converted by convert.load_accflow_checkpoint;
random from seeds without --acc_ckpt) and loads with
accflow_tpu_torch.serving.load_artifact on the card or the CPU, after
`import accflow_tpu_torch` has registered the port's ops (JAX's artifact
needs only jax). --streaming exports the stateful warm-start streaming
pipeline instead (streaming.export_streaming: one file holding the init and
step programs; streaming.load_streaming_artifact, fed frame by frame through
FlowStream). --batch 0 exports a symbolic batch (not with --streaming,
whose state has a concrete batch); --iters defaults to 12, or 6 with
--streaming.

Where the port differs from the JAX CLI: --device (cuda by default, or
cpu: the device the models are built and traced on) takes the place of
--platforms; --scan_unroll has no counterpart, since the port's GRU loop is
unrolled in Python; --corr_lookup ondemand[:chunk], and auto beyond its
budget, raise the port's "not ported yet" error. --corr_lookup auto and
--attn_chunk -1 need a concrete --batch (as in JAX).
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ofe", choices=["raft", "gma"], default="raft")
    parser.add_argument("--acc_ckpt", type=str, default=None,
                        help="acc+{ofe}-*.pth checkpoint (OFE included), or its .npz pair")
    parser.add_argument("--frames", type=int, default=7)
    parser.add_argument("--batch", type=int, default=2,
                        help="0 exports a symbolic batch (serves any batch >= 1)")
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--iters", type=int, default=None,
                        help="OFE iterations (default 12; 6 with --streaming)")
    parser.add_argument("--streaming", action="store_true",
                        help="export the stateful warm-start streaming pipeline (init + "
                        "step programs) instead of the fixed-clip function")
    parser.add_argument("--compute-dtype", type=str, default="bfloat16")
    parser.add_argument("--corr_lookup", type=str, default="fused",
                        help="correlation lookup: fused (also mm, pallas_fused), auto or "
                        "experimental:fused_bd[2] (see RAFTConfig.corr_lookup)")
    parser.add_argument("--attn_chunk", type=int, default=0,
                        help="gma only: >0 recomputes the attention per chunk of query "
                        "rows; -1 picks per shape; 0 (default) stores the (HW)^2 matrix")
    parser.add_argument("--weights_dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="storage dtype of the weights in the artifact; bfloat16 "
                        "halves it")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args(argv)
    if args.streaming and not args.batch:
        parser.error("--streaming needs a concrete --batch (the state is shape-specialised); "
                     "got --batch 0")

    from accflow_tpu_torch.models import AccFlowConfig, build_flow_estimator, init_accflow

    iters = args.iters if args.iters is not None else (6 if args.streaming else 12)
    est = build_flow_estimator(args.ofe, compute_dtype=args.compute_dtype, iters=iters,
                               corr_lookup=args.corr_lookup, attn_chunk=args.attn_chunk,
                               device=args.device)
    acc = init_accflow(AccFlowConfig(compute_dtype=args.compute_dtype), device=args.device)
    if args.acc_ckpt:
        from accflow_tpu_torch.convert import load_accflow_checkpoint

        load_accflow_checkpoint(args.acc_ckpt, acc, est.model)

    t0 = time.perf_counter()
    if args.streaming:
        from accflow_tpu_torch.streaming import export_streaming, save_streaming_artifact

        init_ep, step_ep = export_streaming(est, acc, (args.batch, args.size, args.size),
                                            weights_dtype=args.weights_dtype)
        save_streaming_artifact(args.out, init_ep, step_ep)
        kind = "streaming "
    else:
        from accflow_tpu_torch.serving import export_serving, save_artifact

        exported = export_serving(
            est, acc, (args.frames, args.batch or None, args.size, args.size, 3),
            weights_dtype=args.weights_dtype)
        save_artifact(exported, args.out)
        kind = ""
    print(f"exported {kind}{args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB, "
          f"device {next(acc.parameters()).device}, iters {iters}, "
          f"{time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
