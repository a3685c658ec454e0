"""PyTorch/CUDA port of accflow_tpu: AccFlow+RAFT long-range flow inference,
streaming and CVO evaluation.

The JAX package `accflow_tpu` is the reference; module paths here mirror
it (`nn/`, `ops/`, `models/`, `data/`, `train/`, `cli/`, `convert.py`) so
each part has an obvious counterpart. This package imports torch only,
never jax or accflow_tpu.

Entry points (`models.build_flow_estimator`, `models.init_raft`,
`models.init_accflow`, `train.evaluate.evaluate_cvo`, `cli.test_cvo`)
place models on the GPU by default and raise when none is present, unless
the caller passes ``device="cpu"``.
"""
