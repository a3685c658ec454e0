"""Evaluation of the port (counterpart of accflow_tpu/train): the CVO
protocol (evaluate.py) and the batch helpers it needs (engine.py)."""
