"""The port's serving export (accflow_tpu_torch/serving.py,
cli/export_serving.py) and its CUDA-graph wrapper (graphs.py) on the CPU,
in float32 at 32x32 (tests/test_torch_stream.py holds the streaming
export):
- a clip artifact (full RAFT at 2 iterations under a hidden-32 AccFlow
  with a perturbed ZeroConv, T=3) exported, saved, loaded and run equals
  the port's eager build_serving_fn exactly, as JAX's round trip does
  (tests/test_extras.py:255-291), and matches jax.jit of JAX's
  build_serving_fn on the same weights at the AccFlow bar, rtol 2e-3 /
  atol 2e-2 (tests/test_model_parity.py:143);
- one artifact with a symbolic batch serves batch 1 and 3 (rtol / atol
  1e-5 against eager: the same ops at another batch);
- bfloat16 weights: under 0.6x the float32 file, and equal to eager on the
  cast models exactly;
- the CLI writes an artifact that a fresh interpreter with torch and
  accflow_tpu_torch alone loads and runs, and refuses what is not ported.
On the CPU a loaded artifact and graphs.CudaGraphed run their function as
it is; tests/test_torch_cuda.py holds the CUDA graphs on the card."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu.models import build_flow_estimator as j_build_flow_estimator
from accflow_tpu.models.accflow import AccFlowConfig as JAccFlowConfig
from accflow_tpu.serving import build_serving_fn as j_build_serving_fn
from accflow_tpu_torch import serving
from accflow_tpu_torch.cli import export_serving as cli
from accflow_tpu_torch.convert import to_jax_params
from accflow_tpu_torch.graphs import CudaGraphed
from accflow_tpu_torch.models import AccFlowConfig, build_flow_estimator, init_accflow
from accflow_tpu_torch.ops.corr_level_cuda import lookup_corr_level


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs, restored after.
    The tests run in several worker processes on one machine; with torch's
    default of a thread per core in each, they oversubscribe its cores
    (tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-3, atol=2e-2)
ITERS = 2
CLIP = (3, 1, 32, 32, 3)
REPO = Path(__file__).resolve().parent.parent


def _perturb_zero_conv(acc, seed: int) -> None:
    """init_accflow zeroes AccPlus's ZeroConv; draw it from `seed` so the
    deformable conv really deforms."""
    gen = torch.Generator().manual_seed(seed)
    zc = acc.accplus.conv2[4]
    with torch.no_grad():
        for p, scale in ((zc.conv.weight, 0.05), (zc.conv.bias, 0.5), (zc.scale, 0.1)):
            p.copy_(torch.randn(p.shape, generator=gen) * scale)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The port's models from seeds (their weights moved to JAX's layout by
    to_jax_params for the JAX side) and their f32 artifact at CLIP."""
    est = build_flow_estimator("raft", compute_dtype="float32", device="cpu", iters=ITERS)
    acc = init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32"), device="cpu")
    _perturb_zero_conv(acc, 2)
    exported = serving.export_serving(est, acc, CLIP)
    path = str(tmp_path_factory.mktemp("serving") / "clip.pt2")
    serving.save_artifact(exported, path)
    images = np.random.default_rng(21).uniform(-1, 1, CLIP).astype(np.float32)
    return dict(est=est, acc=acc, exported=exported, path=path, images=images)


def test_clip_artifact_equals_eager_and_jax(clip):
    c = clip
    assert os.path.getsize(c["path"]) > 1_000_000  # the weights are in it
    out = serving.load_artifact(c["path"], device="cpu")(c["images"])
    eager = serving.build_serving_fn(c["est"], c["acc"])(torch.from_numpy(c["images"]))
    assert tuple(out.shape) == (1, 1, 32, 32, 2) and out.dtype == torch.float32
    assert torch.equal(out, eager)
    j_est = j_build_flow_estimator("raft", compute_dtype="float32", iters=ITERS)
    acfg = JAccFlowConfig(hidden=32, compute_dtype="float32")
    serve = j_build_serving_fn(j_est, acfg, to_jax_params(c["est"].model), to_jax_params(c["acc"]))
    ref = jax.jit(serve)(jnp.asarray(c["images"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_clip_artifact_calls_the_ports_op(clip):
    """The lookup is the op accflow::corr_lookup in the program."""
    ep = clip["exported"]
    targets = {str(n.target) for m in ep.graph_module.modules() if hasattr(m, "graph")
               for n in m.graph.nodes if n.op == "call_function"}
    assert "accflow.corr_lookup.default" in targets


def test_symbolic_batch_serves_any_batch(clip, tmp_path):
    c = clip
    path = str(tmp_path / "clip_b.pt2")
    serving.save_artifact(serving.export_serving(c["est"], c["acc"], (3, None, 32, 32, 3)), path)
    fn = serving.load_artifact(path, device="cpu")
    serve = serving.build_serving_fn(c["est"], c["acc"])
    for b in (1, 3):
        images = np.random.default_rng(b).uniform(-1, 1, (3, b, 32, 32, 3)).astype(np.float32)
        out = fn(images)
        assert tuple(out.shape) == (1, b, 32, 32, 2)
        np.testing.assert_allclose(out.numpy(), serve(torch.from_numpy(images)).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_bf16_weights_halve_the_artifact(clip, tmp_path):
    c = clip
    path = str(tmp_path / "clip_bf16.pt2")
    serving.save_artifact(
        serving.export_serving(c["est"], c["acc"], CLIP, weights_dtype="bfloat16"), path)
    assert os.path.getsize(path) < 0.6 * os.path.getsize(c["path"])
    est16, acc16 = serving.cast_models(c["est"], c["acc"], "bfloat16")
    assert next(acc16.parameters()).dtype == torch.bfloat16
    assert next(c["acc"].parameters()).dtype == torch.float32  # the originals stay
    out = serving.load_artifact(path, device="cpu")(c["images"])
    assert torch.equal(out, serving.build_serving_fn(est16, acc16)(torch.from_numpy(c["images"])))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compute_dtype_is_what_the_lookups_write(rng, dtype):
    """serving.numerics allows TF32 only for a bfloat16 program, known by
    the dtype its lookup op writes."""
    levels = [torch.from_numpy(rng.standard_normal((8, 8 >> l, 8 >> l)).astype(np.float32))
              for l in range(4)]
    coords = torch.from_numpy(rng.uniform(0, 7, (8, 2)).astype(np.float32))

    def lookup(lv, c):
        return lookup_corr_level([x.to(dtype) for x in lv], c, 3, out_dtype=dtype)

    assert serving.compute_dtype(serving.export(serving.Program(lookup), (levels, coords))) == dtype
    with serving.numerics(dtype):
        assert torch.backends.cudnn.allow_tf32 == (dtype == torch.bfloat16)
        assert not torch.is_grad_enabled()


def test_load_artifact_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """Without a device the artifact goes to cuda, and raises where there
    is none (nothing carries on quietly on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.load_artifact(str(tmp_path / "any.pt2"))


def test_graphed_function_on_the_cpu_runs_as_it_is():
    calls = []

    def fn(state, x):
        calls.append(1)
        return x * 2, (state[0] + x,)

    g = CudaGraphed(fn)
    x = torch.arange(4.0)
    out, (s,) = g((torch.ones(4),), x)
    assert torch.equal(out, x * 2) and torch.equal(s, x + 1)
    assert len(calls) == 1 and g.captures == 0
    with pytest.raises(TypeError, match="tensors only"):
        g((torch.ones(4),), 3.0)
    with pytest.raises(ValueError, match="one device"):
        g((torch.ones(4, device="meta"),), x)


def test_cli_exports_an_artifact_that_runs(tmp_path):
    """The CLI's artifact in a fresh interpreter that imports torch and
    accflow_tpu_torch only: torch.export.load reads it once the package has
    registered its ops (JAX's artifact needs only jax), and it runs."""
    out = str(tmp_path / "cli.pt2")
    cli.main(["--device", "cpu", "--size", "32", "--frames", "3", "--batch", "1",
              "--iters", "2", "--compute-dtype", "float32", "--out", out])
    code = ("import sys, torch, accflow_tpu_torch\n"
            "ep = torch.export.load(sys.argv[1])\n"
            "with torch.no_grad():\n"
            "    flows = ep.module()(torch.zeros(3, 1, 32, 32, 3))\n"
            "print(tuple(flows.shape), bool(torch.isfinite(flows).all()))\n")
    run = subprocess.run([sys.executable, "-c", code, out], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split("\n")[-2] == "(1, 1, 32, 32, 2) True"


def test_cli_exports_the_volume_free_lookup(tmp_path):
    """--corr_lookup ondemand:8 bakes the volume-free lookup (2 chunks of
    rebuilt rows per lookup at 32^2) into the artifact, as JAX's CLI does:
    the loaded program equals the eager stored-volume clip on the same
    seeded weights."""
    out = str(tmp_path / "od.pt2")
    cli.main(["--device", "cpu", "--size", "32", "--frames", "3", "--batch", "1",
              "--iters", "2", "--compute-dtype", "float32", "--corr_lookup", "ondemand:8",
              "--out", out])
    clip = np.random.default_rng(4).uniform(-1, 1, (3, 1, 32, 32, 3)).astype(np.float32)
    got = serving.load_artifact(out, device="cpu")(clip)
    est = build_flow_estimator("raft", compute_dtype="float32", iters=2, device="cpu")
    acc = init_accflow(AccFlowConfig(compute_dtype="float32"), device="cpu")
    from accflow_tpu_torch.models import accflow_forward

    want = accflow_forward(acc, clip, est.pairs_fn())
    np.testing.assert_allclose(np.asarray(got), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("args,err", [
    (["--ofe", "gma", "--corr_lookup", "experimental:nope"], ValueError),
    (["--corr_lookup", "ondemand:0"], ValueError),
    # "auto" sizes the stored volume by the batch: a symbolic one cannot be
    # sized (as in JAX).
    (["--corr_lookup", "auto", "--batch", "0"], ValueError),
    (["--streaming", "--batch", "0"], SystemExit),
])
def test_cli_refuses(tmp_path, args, err):
    """What the CLI refuses: a spelling JAX does not know (every one it
    computes is ported, experimental:packed2 among them), an ondemand
    chunk that is not positive, "auto" with a symbolic batch, a streaming
    export with a symbolic batch. (--ofe gma and --attn_chunk, refused
    before GMA was ported, export in tests/test_torch_demo.py; ondemand and
    "auto" beyond its budget, refused before the volume-free lookup was
    ported, export in test_cli_exports_the_volume_free_lookup.)"""
    with pytest.raises(err):
        cli.main(["--device", "cpu", "--size", "32", "--out", str(tmp_path / "x.pt2"), *args])
