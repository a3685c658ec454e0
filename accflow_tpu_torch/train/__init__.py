"""Training and evaluation of the port (counterpart of accflow_tpu/train):
accumulator training (engine.py, with loss.py, optim.py, accum.py and
checkpoint.py) and the CVO protocol (evaluate.py)."""
