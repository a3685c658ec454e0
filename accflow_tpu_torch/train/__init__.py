"""Training and evaluation of the port (counterpart of accflow_tpu/train):
accumulator training (engine.py, with loss.py, optim.py, accum.py and
checkpoint.py), estimator fine-tuning (finetune.py, losses_extra.py) and
the CVO protocol (evaluate.py)."""
