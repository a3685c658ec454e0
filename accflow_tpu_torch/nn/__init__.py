"""Layers of the port (counterpart of accflow_tpu/nn)."""
