"""Command-line entry points of the port (counterpart of accflow_tpu/cli)."""
