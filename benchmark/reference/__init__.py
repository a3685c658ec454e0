"""The benchmark's plain reference of the measured clip: RAFT and GMA pair
flows and AccFlow's accumulation in plain PyTorch, float32 with TF32 off
(`Arith` under `exact()`), or the control's float8 (`Float8Arith`). It
imports nothing of the measured program and takes only the benchmark's
own weights and frames."""

from benchmark.reference.accflow import clip_flows  # noqa: F401
from benchmark.reference.layers import Arith, Float8Arith, exact  # noqa: F401
