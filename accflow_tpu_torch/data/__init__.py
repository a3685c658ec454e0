"""Data of the port (counterpart of accflow_tpu/data)."""
