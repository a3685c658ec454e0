"""Logger and timers, the port's copy of accflow_tpu/utils/logging.py
(reference utils/util.py:68-153)."""

from __future__ import annotations

import logging
import os
import os.path as osp
import time
from datetime import datetime


def get_timestamp() -> str:
    return datetime.now().strftime("%y%m%d-%H%M%S")


def setup_logger(
    logger_name: str,
    root: str,
    phase: str,
    level=logging.INFO,
    screen: bool = True,
    tofile: bool = False,
) -> logging.Logger:
    """The logger `logger_name`, writing to the screen and, with `tofile`,
    to <root>/<phase>_<timestamp>.log. The handlers of an earlier call are
    closed and replaced, so a second run in one process logs each line
    once."""
    lg = logging.getLogger(logger_name)
    for handler in list(lg.handlers):
        lg.removeHandler(handler)
        handler.close()
    formatter = logging.Formatter(
        "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
        datefmt="%y-%m-%d %H:%M:%S",
    )
    lg.setLevel(level)
    lg.propagate = False
    if tofile:
        os.makedirs(root, exist_ok=True)
        log_file = osp.join(root, phase + "_{}.log".format(get_timestamp()))
        fh = logging.FileHandler(log_file, mode="w")
        fh.setFormatter(formatter)
        lg.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        lg.addHandler(sh)
    return lg


def count_parameters(module) -> int:
    """Total parameter count of a torch module (reference count_parameters,
    utils/util.py:89-92; what trains is the optimizer's choice, not the
    module's)."""
    return sum(p.numel() for p in module.parameters())


class Timer:
    """Average step timer with reset (reference Timer, util.py:109-126)."""

    def __init__(self):
        self._last = None
        self._total = 0.0
        self._count = 0

    def tick(self) -> None:
        now = time.time()
        if self._last is not None:
            self._total += now - self._last
            self._count += 1
        self._last = now

    def get_average_and_reset(self) -> float:
        avg = self._total / max(self._count, 1)
        self._total = 0.0
        self._count = 0
        return avg


class ScopeTimer:
    """Wall time of a `with` block, printed (or logged to `logger`) as
    "<msg>: <seconds>s" when it ends, and kept in `elapsed`."""

    def __init__(self, msg: str = "", logger=None):
        self.msg = msg
        self.logger = logger

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.start
        text = f"{self.msg}: {self.elapsed:.3f}s"
        if self.logger is not None:
            self.logger.info(text)
        else:
            print(text)
