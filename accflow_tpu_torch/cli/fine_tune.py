"""Estimator fine-tuning CLI of the port, counterpart of
accflow_tpu/cli/fine_tune.py (reference fine_tune.py):

    python -m accflow_tpu_torch.cli.fine_tune -c configs/RAFT.yml

--max-steps stops early; --device picks the device (cuda by default,
raising without a GPU; cpu runs the plain lookups and their plain backward).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", "-c", type=str, default="./configs/RAFT.yml")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; cpu runs the plain lookups)")
    args = parser.parse_args(argv)

    from accflow_tpu_torch.train.finetune import fine_tune
    from accflow_tpu_torch.utils.config import parse_options

    return fine_tune(parse_options(args.config), max_steps=args.max_steps, device=args.device)


if __name__ == "__main__":
    main()
