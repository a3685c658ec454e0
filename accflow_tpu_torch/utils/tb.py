"""TensorBoard logging, the port's copy of accflow_tpu/utils/tb.py (the
reference ships a tbLogger wrapper, utils/util.py:156-172, but leaves it
commented out at its call sites). Without torch.utils.tensorboard or
tensorboardX it writes nothing."""

from __future__ import annotations

from typing import Dict


class TBLogger:
    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self._writer = SummaryWriter(log_dir)
        except Exception:
            try:
                from tensorboardX import SummaryWriter  # type: ignore

                self._writer = SummaryWriter(log_dir)
            except Exception:
                self._writer = None

    def write_dict(self, scalars: Dict[str, float], step: int) -> None:
        if self._writer is None:
            return
        for k, v in scalars.items():
            self._writer.add_scalar(k, float(v), step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
