"""Convert reference .pth checkpoints to .npz param trees, the port's
counterpart of accflow_tpu/cli/convert_ckpt.py (the same files, under the
same names, which both packages load):

    # estimator checkpoints (raft-things.pth, gma-cvo.pth, ...)
    python -m accflow_tpu_torch.cli.convert_ckpt --pth raft-things.pth \\
        --model raft --out raft-things.npz

    # full AccFlow checkpoints (acc+raft-things.pth, ...) -> two files
    python -m accflow_tpu_torch.cli.convert_ckpt --pth acc+raft-things.pth \\
        --model acc+raft --out acc-raft-things

The .pth is read with torch.load(weights_only=True) into the port's
full-width modules on the CPU (convert.load_reference_state_dict: every key
accounted for), and written with convert.to_jax_params and save_npz_tree.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pth", required=True)
    parser.add_argument("--model", required=True, help="raft | gma | acc+raft | acc+gma")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    from accflow_tpu_torch.convert import (
        load_accflow_checkpoint,
        load_flow_estimator_checkpoint,
        save_npz_tree,
        to_jax_params,
    )
    from accflow_tpu_torch.models import AccFlowConfig, build_flow_estimator, init_accflow

    est = build_flow_estimator(args.model, device="cpu")
    if "acc" in args.model:
        acc = init_accflow(AccFlowConfig(), device="cpu")
        load_accflow_checkpoint(args.pth, acc, est.model)
        out = args.out.removesuffix(".npz")
        save_npz_tree(out + ".acc.npz", to_jax_params(acc))
        save_npz_tree(out + ".ofe.npz", to_jax_params(est.model))
        print(f"wrote {out}.acc.npz and {out}.ofe.npz")
    else:
        load_flow_estimator_checkpoint(args.pth, est.model)
        out = args.out if args.out.endswith(".npz") else args.out + ".npz"
        save_npz_tree(out, to_jax_params(est.model))
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
