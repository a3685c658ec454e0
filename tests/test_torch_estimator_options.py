"""The estimator options of the port (corr_levels, corr_radius and
corr_volume_dtype on RAFT, RAFT-small and GMA) against the JAX package on
the CPU, where kernel #2's builds for each (radius, levels) and kernel #3's
for each tap count run as their plain versions. JAX's params come from a
PRNGKey and are carried across with load_jax_params; inputs are numpy from
a seed, float32.

Tolerances: flows rtol 1e-3 / atol 5e-3 (the bar the JAX package meets
against the PyTorch original, tests/test_model_parity.py:68), AccFlow's
clip rtol 2e-3 / atol 2e-2 (:143), the fine-tune step's loss rtol 1e-5
(tests/test_torch_finetune.py). The two-rank cases of these options are in
tests/test_torch_spatial.py's launch, the card's in tests/test_torch_cuda.py
and chip_smoke.py phase 26."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accflow_tpu.models import build_flow_estimator as j_build_flow_estimator
from accflow_tpu.models.accflow import AccFlowConfig as JAccFlowConfig
from accflow_tpu.models.accflow import accflow_forward as j_accflow_forward
from accflow_tpu.models.accflow import init_accflow as j_init_accflow
from accflow_tpu.nn import layers as j_layers
from accflow_tpu.train import finetune as j_ft
from accflow_tpu.train import optim as j_optim
from accflow_tpu.train.engine import TrainState as JTrainState
from accflow_tpu_torch.convert import load_jax_params, to_jax_params
from accflow_tpu_torch.models import (
    AccFlowConfig,
    GMAConfig,
    RAFTConfig,
    accflow_forward,
    build_flow_estimator,
    init_accflow,
)
from accflow_tpu_torch.models import raft as raft_mod
from accflow_tpu_torch.ops import corr as corr_ops
from accflow_tpu_torch.ops import corr_bd_cuda, corr_level_cuda
from accflow_tpu_torch.train import finetune as ft
from accflow_tpu_torch.train.optim import make_optimizer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs, restored after
    (several test workers share the machine: tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-3, atol=5e-3)
ACC_TOL = dict(rtol=2e-3, atol=2e-2)
ITERS = 2
# JAX's examples: every one gave a finite flow in JAX at 64^2. (5, 6) at
# 64^2 pools level 3 to 1 x 1 and level 4 to nothing. The split and
# volume-free lookups run at (3, 3); fused_bd's kernel #3 at 7 taps.
CASES = {
    "raft (3, 3)": ("raft", dict(corr_levels=3, corr_radius=3)),
    "raft (2, 2)": ("raft", dict(corr_levels=2, corr_radius=2)),
    "raft (5, 6)": ("raft", dict(corr_levels=5, corr_radius=6)),
    "raft-small corr_levels 3": ("raft", dict(small=True, corr_levels=3)),
    "gma (3, 3)": ("gma", dict(corr_levels=3, corr_radius=3)),
    "raft (3, 3) ondemand:16": ("raft", dict(corr_levels=3, corr_radius=3,
                                             corr_lookup="ondemand:16")),
    "raft (3, 3) experimental:fused_bd": ("raft", dict(corr_levels=3, corr_radius=3,
                                                       corr_lookup="experimental:fused_bd")),
    "raft (3, 3) corr_volume_dtype float32": ("raft", dict(corr_levels=3, corr_radius=3,
                                                           corr_volume_dtype="float32")),
    "raft (3, 3) corr_volume_dtype bfloat16": ("raft", dict(corr_levels=3, corr_radius=3,
                                                            corr_volume_dtype="bfloat16")),
    "gma corr_volume_dtype bfloat16": ("gma", dict(corr_volume_dtype="bfloat16")),
}
# The fields that shape the weights: cases that share them share one init.
SHAPE_KEYS = ("small", "corr_levels", "corr_radius")
_params: dict = {}


def _jax_params(name: str, kw: dict):
    """JAX's params for `name` at these fields, from PRNGKey(0) (once per
    shape); GMA's gamma set to 3 (at its init of 0 the attention adds
    nothing)."""
    key = (name,) + tuple(kw.get(k) for k in SHAPE_KEYS)
    if key not in _params:
        shape = {k: v for k, v in kw.items() if k in SHAPE_KEYS}
        params = j_build_flow_estimator(name, compute_dtype="float32", **shape).init(
            jax.random.PRNGKey(0))
        if name == "gma":
            params["update_block"]["aggregator"]["gamma"] = jnp.full((1,), 3.0, jnp.float32)
        _params[key] = params
    return _params[key]


def _pair(seed=0, n=1, size=64):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32) for _ in range(2)]


def _port(name: str, kw: dict, params):
    est = build_flow_estimator(name, compute_dtype="float32", device="cpu", **kw)
    load_jax_params(est.model, params)
    return est


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    """Each option's forward (flow_up, flow_low and the per-iteration
    predictions) against JAX's at the same fields and weights; convc1's
    input width is JAX's corr_planes, and the stored levels take
    corr_volume_dtype (the compute dtype by default)."""
    name, kw = CASES[case]
    params = _jax_params(name, kw)
    i1, i2 = _pair()
    j_est = j_build_flow_estimator(name, compute_dtype="float32", **kw)
    # The weights are arguments of the jitted forward, not constants folded
    # into it: a quicker compile (tests/test_torch_spatial.py).
    ref = jax.jit(lambda p, a, b: j_est.forward(p, a, b, iters=ITERS))(
        params, jnp.asarray(i1), jnp.asarray(i2))
    est = _port(name, kw, params)
    cfg = est.model.cfg
    assert est.model.update_block.encoder.convc1.weight.shape[1] == cfg.corr_planes == \
        j_est.cfg.corr_planes
    assert cfg.level_dtype() == getattr(torch, kw.get("corr_volume_dtype", "float32"))
    out = est.forward(i1, i2, iters=ITERS)
    for key in ("flow_up", "flow_low", "predictions"):
        assert np.isfinite(out[key].numpy()).all()
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL, err_msg=key)


def test_degenerate_levels_read_zeros():
    """corr_levels 5 at 64^2 (8 x 8 at 1/8): levels 8^2, 4^2, 2^2, 1^2 and an
    empty one; the lookup (kernel #2's plain version at (6, 5)) gives zeros
    for the empty level, as JAX's."""
    levels = corr_ops.build_corr_pyramid(*(torch.randn(1, 16, 8, 8) for _ in range(2)), 5)
    assert [tuple(lv.shape[1:]) for lv in levels] == [(8, 8), (4, 4), (2, 2), (1, 1), (0, 0)]
    coords = torch.rand(64, 2) * 8
    out = corr_ops.lookup_corr_kernel(levels, coords, 6)
    assert out.shape == (64, 5 * 169) and not out[:, 4 * 169:].any() and out[:, :169].any()


def test_accflow_clip_matches_jax():
    """One AccFlow clip (4 frames of 64^2, hidden 32) with RAFT at (3, 3)
    pairs against JAX's accflow_forward at the AccFlow bar."""
    kw = CASES["raft (3, 3)"][1]
    params = _jax_params("raft", kw)
    j_est = j_build_flow_estimator("raft", compute_dtype="float32", **kw)
    acfg = JAccFlowConfig(hidden=32, compute_dtype="float32")
    acc_params = j_init_accflow(jax.random.PRNGKey(1), acfg)
    frames = np.random.default_rng(3).uniform(-1, 1, (4, 1, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(lambda ap, op, ims: j_accflow_forward(
        ap, None, ims, acfg, ofe_pairs=j_est.pairs_fn(op, iters=ITERS)))(
            acc_params, params, jnp.asarray(frames))
    acc = load_jax_params(init_accflow(AccFlowConfig(hidden=32, compute_dtype="float32"),
                                       device="cpu"), acc_params)
    out = accflow_forward(acc, frames, _port("raft", kw, params).pairs_fn(iters=ITERS))
    assert tuple(out.shape) == (2, 1, 64, 64, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ACC_TOL)


class _Iters:
    """An estimator whose every call runs `iters` GRU iterations (the
    fine-tune steps' 12 cut to ITERS on both sides)."""

    def __init__(self, est, iters, model=None):
        self.est, self.iters = est, iters
        if model is not None:
            self.model = model

    def forward(self, *args, iters=None, **kw):
        return self.est.forward(*args, iters=self.iters, **kw)


def test_finetune_loss_matches_jax():
    """One make_finetune_step of full RAFT at (3, 3) (batch 2 at 32x48,
    float32 levels, noise off; 3 levels: 4x6, 2x3, 1x1) against JAX's: the
    loss within 1e-5 relative (the lookups' backward through kernel #2's
    (3, 3) backward's plain version)."""
    kw = CASES["raft (3, 3)"][1]
    params = _jax_params("raft", kw)
    rng = np.random.default_rng(4)
    img1, img2 = (rng.integers(0, 256, (2, 32, 48, 3)).astype(np.uint8) for _ in range(2))
    label = (4.0 * rng.standard_normal((2, 32, 48, 2))).astype(np.float32)
    tree = jax.tree.map(np.asarray, params)
    tx, _ = j_optim.make_optimizer(2e-4, 3, 1e-5, 1e-8, 1.0,
                                   buffer_mask=j_layers.bn_buffer_mask(tree))
    j_step = j_ft.make_finetune_step(
        _Iters(j_build_flow_estimator("raft", compute_dtype="float32", **kw), ITERS), tx,
        add_noise=False, gamma=0.85)[0]
    state = JTrainState(params, tx.init(params), jnp.int32(0))
    _, j_loss, _ = j_step(state, jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(label),
                          jax.random.PRNGKey(0))
    est = _port("raft", kw, params)
    optimizer = make_optimizer(est.model.parameters(), 2e-4, 3, 1e-5, 1e-8, 1.0)
    step, _ = ft.make_finetune_step(_Iters(est, ITERS, est.model), optimizer, add_noise=False,
                                    gamma=0.85)
    loss, _ = step(torch.from_numpy(img1), torch.from_numpy(img2), torch.from_numpy(label))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)


def test_level_dtype_follows_corr_volume_dtype():
    """The stored levels' dtype: corr_volume_dtype when set, on inference and
    training alike; by default the compute dtype when inferring and float32
    when training (bit for bit the port's levels before the field). Other
    values, and fields no kernel takes, raise by name."""
    for cls in (RAFTConfig, GMAConfig):
        assert cls().level_dtype() == torch.bfloat16
        assert cls().level_dtype(train=True) == torch.float32
        assert cls(compute_dtype="float32").level_dtype() == torch.float32
        for vd in ("float32", "bfloat16"):
            cfg = cls(corr_volume_dtype=vd)
            assert cfg.level_dtype() == cfg.level_dtype(train=True) == getattr(torch, vd)
        with pytest.raises(ValueError, match="corr_volume_dtype"):
            cls(corr_volume_dtype="float16")
        with pytest.raises(ValueError, match="corr_levels"):
            cls(corr_levels=0)
    assert RAFTConfig(small=True, corr_radius=5).radius == 3
    assert RAFTConfig(corr_radius=5).corr_planes == 4 * 121
    assert GMAConfig(corr_levels=2, corr_radius=1).corr_planes == 2 * 9


@pytest.mark.parametrize("spelling,levels", [("packed", 1), ("packed2", 2)])
def test_packed_without_levels_to_pack_is_refused_where_jax_fails(spelling, levels):
    """experimental:packed[2] packs levels 1.. (2..): at corr_levels 1 (2)
    none is left, and JAX's forward fails (IndexError in
    lookup_corr_split_packed); the port refuses the config by name. One
    level more works in both (tests above hold such splits at (3, 3))."""
    kw = dict(corr_levels=levels, corr_radius=2, corr_lookup=f"experimental:{spelling}")
    j_est = j_build_flow_estimator("raft", compute_dtype="float32", **kw)
    # The weights of the same shapes from the port's init (quicker than
    # JAX's; JAX fails before they matter).
    params = to_jax_params(build_flow_estimator(
        "raft", compute_dtype="float32", device="cpu", corr_levels=levels, corr_radius=2).model)
    i1, i2 = _pair(size=32)
    with pytest.raises(IndexError):
        j_est.forward(params, jnp.asarray(i1), jnp.asarray(i2), iters=1)
    with pytest.raises(ValueError, match="none to pack"):
        build_flow_estimator("raft", compute_dtype="float32", device="cpu", **kw)
    build_flow_estimator("raft", compute_dtype="float32", device="cpu",
                         **dict(kw, corr_levels=levels + 1))


def test_auto_switches_at_half_the_pairs_in_float32(monkeypatch):
    """"auto" sizes the stored pyramid in its levels' dtype: float32 levels
    take twice the bytes, so they switch to ondemand at half the pairs of
    bfloat16 ones; an estimator sizes it by its corr_volume_dtype (with the
    budget at one bfloat16 pair, the bfloat16 estimator stores its pyramid
    and the float32 one takes ondemand), with the same flows."""
    h8, w8, levels = 8, 8, 3
    bf16 = corr_ops.stored_volume_bytes(1, h8, w8, levels, torch.bfloat16)
    assert corr_ops.stored_volume_bytes(1, h8, w8, levels, torch.float32) == 2 * bf16
    monkeypatch.setattr(corr_ops, "AUTO_VOLUME_BYTES", 4 * bf16)
    picks = {dt: [corr_ops.resolve_auto_lookup("auto", b, h8, w8, levels, dt) for b in range(1, 6)]
             for dt in (torch.bfloat16, torch.float32)}
    assert picks[torch.bfloat16] == ["fused"] * 4 + ["ondemand"]
    assert picks[torch.float32] == ["fused"] * 2 + ["ondemand"] * 3
    monkeypatch.setattr(corr_ops, "AUTO_VOLUME_BYTES", bf16)
    seen = []
    real = raft_mod.lookup_corr_on_demand
    monkeypatch.setattr(raft_mod, "lookup_corr_on_demand",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    kw = CASES["raft (3, 3)"][1]
    params = _jax_params("raft", kw)
    i1, i2 = _pair()
    flows = {}
    for vd in ("bfloat16", "float32"):
        est = _port("raft", dict(kw, corr_lookup="auto", corr_volume_dtype=vd), params)
        seen.clear()
        flows[vd] = est.forward(i1, i2, iters=ITERS)["flow_up"].numpy()
        assert len(seen) == (0 if vd == "bfloat16" else ITERS)
    ref = _port("raft", kw, params).forward(i1, i2, iters=ITERS)["flow_up"].numpy()
    np.testing.assert_allclose(flows["float32"], ref, rtol=1e-5, atol=1e-5)


def test_kernel_builds_follow_the_fields():
    """Which build serves which (radius, levels): the default builds for
    kernel #2's radius 3 or 4 over 4 levels and kernel #3's 9 taps, a build
    of its own with the fields as defines for every other; a block that
    does not fit shared memory at 8 queries takes fewer, and one that does
    not fit at 1 raises by name."""
    assert corr_level_cuda.defines(3, 4) == corr_level_cuda.defines(4, 4) == ()
    assert corr_level_cuda.defines(3, 3) == ("-DCORR_RADIUS=3", "-DCORR_LEVELS=3")
    assert corr_level_cuda.defines(14, 4)[-1] == "-DCORR_QT=4"
    with pytest.raises(ValueError, match="shared memory"):
        corr_level_cuda.defines(30, 16)
    assert corr_bd_cuda.defines(9) == () and corr_bd_cuda.defines(7) == ("-DCORR_NUM=7",)
