"""PyTorch/CUDA port of accflow_tpu: AccFlow+RAFT long-range flow inference.

The JAX package `accflow_tpu` is the reference; module paths here mirror
it (`nn/`, `ops/`, `models/`, `convert.py`) so each part has an obvious
counterpart. This package imports torch only, never jax or accflow_tpu.

Entry points (`models.build_flow_estimator`, `models.init_raft`,
`models.init_accflow`) place models on the GPU by default and raise when
none is present, unless the caller passes ``device="cpu"``.
"""
