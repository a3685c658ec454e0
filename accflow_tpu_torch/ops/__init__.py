"""Ops of the port (counterpart of accflow_tpu/ops)."""
