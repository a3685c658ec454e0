"""PyTorch/CUDA port of accflow_tpu: AccFlow long-range flow inference over
RAFT or GMA, streaming, CVO evaluation, the FlowPipeline inference API and
accumulator training.

The JAX package `accflow_tpu` is the reference; module paths here mirror
it (`nn/`, `ops/`, `models/`, `data/`, `train/`, `cli/`, `convert.py`) so
each part has an obvious counterpart. This package imports torch only,
never jax or accflow_tpu.

Entry points (`FlowPipeline`, `models.build_flow_estimator`,
`models.init_raft`, `models.init_gma`, `models.init_accflow`,
`train.evaluate.evaluate_cvo`, `cli.test_cvo`, `cli.demo`,
`train.engine.train_acc`, `cli.train_acc`,
`serving.load_artifact`, `streaming.load_streaming_artifact`,
`cli.export_serving`) place models on the GPU by default and raise when
none is present, unless the caller passes ``device="cpu"``.

Importing the package registers its torch ops (`accflow::corr_lookup`,
`accflow::corr_level_lookup`, `accflow::y_contract`, `accflow::splat_add`),
which a saved artifact (serving.py, streaming.py) calls by name: a torch
artifact loads only after `import accflow_tpu_torch`.
"""

from accflow_tpu_torch.ops import corr_bd_cuda, corr_cuda, corr_level_cuda, softsplat  # noqa: F401
from accflow_tpu_torch.api import ArtifactPipeline, FlowPipeline  # noqa: F401,E402
