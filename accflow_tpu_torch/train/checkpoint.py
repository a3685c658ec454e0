"""Training checkpoints and resume, the port's counterpart of
accflow_tpu/train/checkpoint.py (reference: torch.save of the model and
{iter, scheduler, optimizer}, train_acc.py:96-110,174-191).

Retention is the reference's, as JAX keeps it (train_acc.py:268,279-301,311):
- every validation overwrites a single `latest` checkpoint;
- a NUMBERED checkpoint is saved only on a new best validation EPE, and
  the numbered set is pruned oldest-first so that numbered + latest never
  exceeds `keep` (default 4: latest and the 3 most recent record-breaking
  checkpoints; non-improving validations never evict the best model);
- a `final` checkpoint is written when training completes (the last
  `keep` kept).

Layout under <ckpt_dir>/: `latest/<step>.pt`, `best/<step>.pt`,
`final/<step>.pt`, each a torch.save dict (what train/engine.py saves: the
accumulator's state_dict under the reference's names, the optimizer's and
the schedule's state, and the step), read back with weights_only=True.
JAX's checkpoints are orbax directories: the two packages' training
checkpoints are not interchangeable.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 4):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self._dirs = {kind: os.path.join(self.directory, kind)
                      for kind in ("latest", "best", "final")}
        for d in self._dirs.values():
            os.makedirs(d, exist_ok=True)

    def _steps(self, kind: str) -> list:
        return sorted(int(f[:-3]) for f in os.listdir(self._dirs[kind])
                      if f.endswith(".pt") and f[:-3].isdigit())

    def _path(self, kind: str, step: int) -> str:
        return os.path.join(self._dirs[kind], f"{step}.pt")

    def _save(self, kind: str, step: int, state: Any, max_to_keep: int) -> None:
        """Write `state` as <kind>/<step>.pt, then drop the lowest steps of
        `kind` beyond `max_to_keep` (the new one is kept in `latest`)."""
        path = self._path(kind, step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)  # a crash mid-save leaves the older files intact
        steps = self._steps(kind)
        if kind == "latest":
            steps.remove(step)
            max_to_keep -= 1
        while len(steps) > max_to_keep:
            os.remove(self._path(kind, steps.pop(0)))

    # -- saves ------------------------------------------------------------
    def save(self, step: int, state: Any) -> None:
        """The every-validation `latest` save (train_acc.py:268): it
        replaces the one before."""
        self._save("latest", step, state, 1)

    def save_best(self, step: int, state: Any) -> None:
        """Numbered save on a new best EPE; prunes the OLDEST numbered
        checkpoints so numbered + latest <= keep (train_acc.py:291-301)."""
        self._save("best", step, state, self.keep - 1)

    def save_final(self, step: int, state: Any) -> None:
        """End-of-training save (train_acc.py:311 `final.pth`)."""
        self._save("final", step, state, self.keep)

    # -- queries / restore --------------------------------------------------
    def latest_step(self) -> Optional[int]:
        """Highest step across `latest` and `final` (a completed run's
        final save is newer than its last validation's latest save)."""
        steps = self._steps("latest") + self._steps("final")
        return max(steps) if steps else None

    def best_steps(self) -> list:
        return self._steps("best")

    def restore(self, step: Optional[int] = None) -> Any:
        """What was saved at `step`, on the CPU: step=None -> the latest
        checkpoint (resume="auto"); an int -> that step, looked up in best/
        then latest/ then final/ (the reference resumes `%06d.pth` by
        number, train_acc.py:27-32)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        for kind in ("best", "latest", "final"):
            if step in self._steps(kind):
                return torch.load(self._path(kind, step), map_location="cpu",
                                  weights_only=True)
        raise FileNotFoundError(f"step {step} not found in {self.directory}")
