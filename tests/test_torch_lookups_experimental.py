"""The experimental corr_lookup spellings of the PyTorch port against JAX on
the CPU: each lookup function against its JAX counterpart, the spellings
through RAFT, GMA and RAFT-small, and the gradient of the sequence loss
through a level mix. Inputs are numpy from a seed.

- Op level: levels of 256 queries over 64^2, 32^2, 16^2 and 8^2 maps drawn
  unit-normal, coords in [-20, 84) (windows partly and wholly outside the
  maps), a quarter of them whole pixels and a sixteenth multiples of 8
  (whole at every level). lookup_corr_rows, _patch and _gather at radius 3
  and 4; the plain path of experimental:pallas (kernel #2's, against JAX's
  lookup_corr_pallas in interpret mode, stream_dtype=None) at radius 4, its
  new use (RAFT-small's radius 3 is tests/test_torch_raft_small.py's);
  lookup_corr_split with both x contractions, _split_packed with
  start 1 and 2, _split_v2 with each level impl (bd on levels 1-3 and on
  one row's 16 queries, fractional coords: JAX's y_contract_bd in interpret
  mode takes seconds a level). Float32 at rtol / atol 1e-5 (the same float32 products in
  another summation order: <= 1.4e-6 measured). Bfloat16 levels against
  JAX's bfloat16 path at precision "default":
  - rows, patch, pallas and split "vpu" (and rows_gx) compute in float32
    from the same bfloat16 values on both sides: 1e-5, as float32;
  - gather: JAX's bilinear_sample multiplies and sums the four taps in
    bfloat16 (seven roundings of <= 2^-9 of the window's size), the port in
    float32: 2^-6 x max |window| (6.5e-3 measured);
  - the split windows whose x contraction is a product (mxu, packed, the
    v2 impls but rows_gx): both round tmp to bfloat16, the port also rounds
    the window (<= 2^-8 of it) where JAX keeps float32, and tmp's rounding
    may fall on the other side under another summation order (one ulp,
    carried through the x blend): 2^-7 x max |window|, as
    tests/test_torch_bd.py holds the split lookup.
- Model level against JAX at 64^2, 2 iterations, batch 1, float32, the
  port's seeded weights in both (GMA's gamma drawn in [2, 4]): RAFT rows
  (flat), pallas (kernel #2's plain path at radius 4; JAX in interpret
  mode), packed (split and packed), GMA fused_vy_cat (stacked, vpu_y), RAFT
  fused_mix:rows,rows_gx,vpu_y,bd (kernel #3's plain twin) and RAFT-small
  patch (radius 3), at rtol 1e-3 / atol 5e-3 (tests/test_model_parity.py:
  68); the other spellings (gather, fusedv, packed2, fused_vy, fused_cat)
  through the port's RAFT within the same bar of its fused flow.
- Gradient: the sequence loss of RAFT's train forward (train-mode
  BatchNorm) with fused_mix:rows,rows_gx,vpu_y,mm against jax.grad of
  JAX's, per leaf at rtol 1e-3 / atol 1e-3 x the leaf's largest |grad|
  (the biases a norm follows, 0 in exact arithmetic, near 0 on both sides:
  tests/test_torch_finetune.py's bars). At this seed one input of the
  upsampling mask head's first ReLU (channel 182 of update_block.mask.0)
  lies within float32 rounding of zero and takes the other side of the
  kink in one package, with "fused" as with the mix (its bias gradient
  moves by 9.9e-7, 2.8 % of the leaf's largest): the mask head's leaves
  are held by their global relative L2 (<= 1e-2; 4.4e-3 measured), as
  tests/test_torch_finetune.py holds them for the same reason; packed's parameter gradients
  against fused's in the port; experimental:pallas and a bd level refused
  by make_finetune_step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu.models import build_flow_estimator as j_build_flow_estimator
from accflow_tpu.nn.layers import collect_bn_updates
from accflow_tpu.ops import corr as j_corr
from accflow_tpu.ops.corr_pallas import lookup_corr_pallas as j_lookup_corr_pallas
from accflow_tpu.train.loss import sequence_loss_raft as j_sequence_loss_raft
from accflow_tpu_torch.convert import load_jax_params, to_jax_params
from accflow_tpu_torch.models import build_flow_estimator
from accflow_tpu_torch.ops import corr
from accflow_tpu_torch.train import finetune as ft
from accflow_tpu_torch.train.loss import sequence_loss_raft
from accflow_tpu_torch.train.optim import make_optimizer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread while this module runs, restored after
    (several test workers share the machine: test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MAPS = (64, 32, 16, 8)
DTYPES = {"float32": (jnp.float32, torch.float32, "highest"),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, "default")}
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16 bars as fractions of max |window| (module docstring); None: F32_TOL.
BF16_GATHER, BF16_SPLIT = 2.0 ** -6, 2.0 ** -7


@pytest.fixture(scope="module")
def op_inputs():
    rng = np.random.default_rng(11)
    levels = [rng.standard_normal((256, m, m)).astype(np.float32) for m in MAPS]
    coords = rng.uniform(-20, 84, (1, 16, 16, 2)).astype(np.float32)
    coords[0, :4] = np.round(coords[0, :4])
    coords[0, 4] = 8 * np.round(coords[0, 4] / 8)
    return levels, coords


def _flat(fn):
    return lambda lv, c, r, dt: fn(lv, c, r)


# name -> (port fn(levels, coords, radius, dtype), JAX fn(pyramid, coords, radius,
# precision), radius, bfloat16 bar)
OPS = {}
for _r in (3, 4):
    OPS[f"rows r{_r}"] = (_flat(corr.lookup_corr_rows),
                          lambda p, c, r, pr: j_corr.lookup_corr_rows(p, c, r, pr), _r, None)
    OPS[f"patch r{_r}"] = (_flat(corr.lookup_corr_patch),
                           lambda p, c, r, pr: j_corr.lookup_corr_patch(p, c, r), _r, None)
    OPS[f"gather r{_r}"] = (_flat(corr.lookup_corr_gather),
                            lambda p, c, r, pr: j_corr.lookup_corr_gather(p, c, r), _r,
                            BF16_GATHER)
OPS["pallas r4"] = (_flat(corr.lookup_corr_pallas),
                    lambda p, c, r, pr: j_lookup_corr_pallas(p, c, r, stream_dtype=None,
                                                             interpret=True), 4, None)
for _x, _bar in (("mxu", BF16_SPLIT), ("vpu", None)):
    OPS[f"split {_x}"] = (lambda lv, c, r, dt, x=_x: corr.lookup_corr_split(lv, c, r, x),
                          lambda p, c, r, pr, x=_x: j_corr.lookup_corr_split(p, c, r, pr, x),
                          4, _bar)
for _s in (1, 2):
    OPS[f"packed {_s}"] = (
        lambda lv, c, r, dt, s=_s: corr.lookup_corr_split_packed(lv, c, r, s),
        lambda p, c, r, pr, s=_s: j_corr.lookup_corr_split_packed(p, c, r, pr, s), 4, BF16_SPLIT)
for _k in corr.LEVEL_IMPLS:
    _impl = ("mm", "bd") if _k == "bd" else (_k,)
    OPS[f"v2 {_k}"] = (
        lambda lv, c, r, dt, k=_impl: corr.lookup_corr_split_v2(lv, c, r, k, dt),
        lambda p, c, r, pr, k=_impl: j_corr.lookup_corr_split_v2(p, c, r, pr, k), 4,
        None if _k == "rows_gx" else BF16_SPLIT)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(OPS))
def test_lookup_matches_jax(op_inputs, name, dtype):
    levels, coords = op_inputs
    if name == "v2 bd":  # row 5's 16 queries: JAX's y_contract_bd is slow interpreted
        levels, coords = [lv[80:96] for lv in levels], coords[:, 5:6]
    jdt, tdt, precision = DTYPES[dtype]
    port, ref_fn, radius, bar = OPS[name]
    b, h, w, _ = coords.shape
    pyr = j_corr.CorrPyramid(levels=tuple(jnp.asarray(lv).astype(jdt) for lv in levels),
                             h1=h, w1=w)
    ref = jax.jit(lambda c: ref_fn(pyr, c, radius, precision))(jnp.asarray(coords))
    got = port([torch.from_numpy(lv).to(tdt) for lv in levels], torch.from_numpy(coords),
               radius, tdt)
    got, ref = (got, [ref]) if isinstance(got, list) else ([got], [ref])
    ref = ref[0] if isinstance(ref[0], (list, tuple)) else ref
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r).astype(np.float32)
        assert tuple(g.shape) == r.shape and g.shape[:3] == (b, h, w)
        if dtype == "bfloat16" and bar is not None:
            np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                                       atol=bar * float(np.abs(r).max()))
        else:
            np.testing.assert_allclose(g.float().numpy(), r, **F32_TOL)


def test_split_windows_are_the_flat_windows(op_inputs):
    """Every split spelling's windows, flattened level-major a*9 + b (a
    packed entry's levels in order), are lookup_corr_gather's: the
    function kernel #1 computes."""
    levels, coords = op_inputs
    lv = [torch.from_numpy(x) for x in levels]
    c = torch.from_numpy(coords)
    flat = corr.lookup_corr_gather(lv, c, 4).numpy()
    for impl in corr.SPLIT_LOOKUPS + ("fused_mix:rows,rows_gx,vpu_y,bd",):
        parts = corr.split_windows(impl, lv, c, 4)
        got = torch.cat([p.reshape(1, 16, 16, -1) for p in parts], dim=-1).numpy()
        np.testing.assert_allclose(got, flat, rtol=1e-5, atol=1e-5, err_msg=impl)


@pytest.mark.parametrize("spelling,want", [
    ("experimental:pallas", "pallas"), ("experimental:rows", "rows"),
    ("experimental:fused_mix:rows,bd", "fused_mix:rows,bd"),
    ("experimental:fused", "fused"), ("experimental:ondemand:64", "ondemand:64"),
])
def test_experimental_spellings_normalize(spelling, want):
    assert corr.normalize_corr_lookup(spelling) == want


@pytest.mark.parametrize("spelling,match", [
    ("experimental:nope", "unknown corr_lookup"), ("rows", "experimental:rows"),
    ("experimental:fused_mix:rows,nope", "unknown level impl 'nope'"),
    ("experimental:fused_mix:", "unknown level impl ''"),
])
def test_bad_spellings_raise_value_error(spelling, match):
    with pytest.raises(ValueError, match=match):
        corr.normalize_corr_lookup(spelling)


def test_split_levels_repeat_the_last_entry():
    from accflow_tpu_torch.models.raft import RAFTConfig

    assert RAFTConfig(corr_lookup="experimental:fused_mix:rows,vpu_y").split_levels == (
        "rows", "vpu_y", "vpu_y", "vpu_y")
    assert RAFTConfig(corr_lookup="experimental:fused_vy_cat").split_levels == ("vpu_y",) * 4
    for impl in ("packed", "fusedv", "fused_cat", "rows", "pallas"):
        assert RAFTConfig(corr_lookup=f"experimental:{impl}").split_levels is None
    assert RAFTConfig(small=True, corr_lookup="experimental:fused_vy").split_levels is None


# ---------------------------------------------------------------------------
# The spellings through the models
# ---------------------------------------------------------------------------

SIZE, ITERS = 64, 2
MODEL_CASES = {  # JAX-held: (model, spelling, config)
    "raft rows": ("raft", "experimental:rows", {}),
    "raft pallas": ("raft", "experimental:pallas", {}),
    "raft packed": ("raft", "experimental:packed", {}),
    "gma fused_vy_cat": ("gma", "experimental:fused_vy_cat", {}),
    "raft mix": ("raft", "experimental:fused_mix:rows,rows_gx,vpu_y,bd", {}),
    "small patch": ("raft", "experimental:patch", dict(small=True)),
}
PORT_ONLY = ("gather", "fusedv", "packed2", "fused_vy", "fused_cat")
FLOW_TOL = dict(rtol=1e-3, atol=5e-3)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).uniform(-1, 1, (2, 1, SIZE, SIZE, 3)).astype(np.float32)


def _port(name, lookup, **cfg):
    est = build_flow_estimator(name, compute_dtype="float32", device="cpu", corr_lookup=lookup,
                               **cfg)
    if name == "gma":
        with torch.no_grad():
            est.model.update_block.aggregator.gamma.fill_(2.5)
    return est


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_matches_jax(frames, case):
    name, lookup, cfg = MODEL_CASES[case]
    est = _port(name, lookup, **cfg)
    params = jax.tree.map(jnp.asarray, to_jax_params(est.model))
    j_est = j_build_flow_estimator(name, compute_dtype="float32", corr_lookup=lookup, **cfg)
    ref = jax.jit(lambda p, a, b: j_est.forward(p, a, b, iters=ITERS, final_only=True))(
        params, jnp.asarray(frames[0]), jnp.asarray(frames[1]))
    out = est.forward(frames[0], frames[1], iters=ITERS, final_only=True)
    assert float(np.abs(out["flow_up"].numpy()).max()) > 0.5
    for key in ("flow_up", "flow_low"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **FLOW_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("impl", PORT_ONLY)
def test_port_spelling_matches_fused(frames, impl):
    ref = _port("raft", "fused").forward(frames[0], frames[1], iters=ITERS, final_only=True)
    out = _port("raft", f"experimental:{impl}").forward(frames[0], frames[1], iters=ITERS,
                                                        final_only=True)
    for key in ("flow_up", "flow_low"):
        np.testing.assert_allclose(out[key].numpy(), ref[key].numpy(), **FLOW_TOL, err_msg=key)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

GAMMA = 0.85
MIX = "experimental:fused_mix:rows,rows_gx,vpu_y,mm"


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _port_grads(est, i1, i2, label) -> tuple:
    """The port's sequence loss of one train forward and its parameter
    gradients as JAX-layout leaves (no running statistics)."""
    out = est.forward(i1, i2, iters=ITERS, train=True)
    loss, _ = sequence_loss_raft(out["predictions"], torch.from_numpy(label), GAMMA)
    loss.backward()
    g = copy.deepcopy(est.model)
    with torch.no_grad():
        for (_, p), (_, q) in zip(est.model.named_parameters(), g.named_parameters()):
            q.copy_(p.grad)
    grads = {k: v for k, v in _leaves(to_jax_params(g)).items()
             if not k.endswith(("/mean", "/var"))}
    return float(loss.detach()), grads


def _train_batch():
    rng = np.random.default_rng(5)
    i1, i2 = (rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2))
    return i1, i2, (4.0 * rng.standard_normal((2, SIZE, SIZE, 2))).astype(np.float32)


def test_mix_gradient_matches_jax():
    """The sequence loss's gradient through the level mix (the rows and
    vpu_y windows' autograd, train-mode BatchNorm) against jax.grad of
    JAX's, at tests/test_torch_finetune.py's bars."""
    i1, i2, label = _train_batch()
    est = _port("raft", MIX)
    params = jax.tree.map(jnp.asarray, to_jax_params(est.model))
    j_est = j_build_flow_estimator("raft", compute_dtype="float32", corr_lookup=MIX)

    def j_loss(p):
        out = j_est.forward(p, jnp.asarray(i1), jnp.asarray(i2), iters=ITERS, train=True)
        loss, _ = j_sequence_loss_raft(out["predictions"], jnp.asarray(label), GAMMA)
        collect_bn_updates(p)
        return loss

    j_value, j_grads = jax.jit(jax.value_and_grad(j_loss))(params)
    want = {k: v for k, v in _leaves(jax.tree.map(np.asarray, j_grads)).items()
            if not k.endswith(("/mean", "/var"))}
    loss, got = _port_grads(est, i1, i2, label)
    np.testing.assert_allclose(loss, float(j_value), rtol=1e-5)
    assert set(got) == set(want)
    # The conv biases that a norm follows have a gradient of 0 in exact
    # arithmetic: float32 noise on both sides, held near 0.
    zero = [k for k in want if k.endswith("/b") and k.split("/")[0] in ("fnet", "cnet")
            and k.split("/")[1] != "conv2"]
    mask = [k for k in want if k.startswith("update_block/mask/")]
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in mask)
    assert (num / sum(float((want[k] ** 2).sum()) for k in mask)) ** 0.5 <= 1e-2
    for k in set(want) - set(mask):
        if k in zero:
            scale = np.abs(want[k[:-1] + "w"]).max()
            assert np.abs(got[k]).max() <= 1e-5 * scale and np.abs(want[k]).max() <= 1e-5 * scale
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want[k]).max()), err_msg=k)


def test_packed_gradient_matches_fused():
    """experimental:packed trains through autograd of its PyTorch ops: its
    loss and parameter gradients are fused's (kernel #1's plain path and
    its backward), in global relative L2 and per leaf as above."""
    i1, i2, label = _train_batch()
    l_f, g_f = _port_grads(_port("raft", "fused"), i1, i2, label)
    l_p, g_p = _port_grads(_port("raft", "experimental:packed"), i1, i2, label)
    np.testing.assert_allclose(l_p, l_f, rtol=1e-5)
    num = sum(float(((g_p[k] - g_f[k]) ** 2).sum()) for k in g_f)
    assert (num / sum(float((g_f[k] ** 2).sum()) for k in g_f)) ** 0.5 <= 1e-4
    big = [k for k in g_f if not (k.endswith("/b") and k.split("/")[0] in ("fnet", "cnet"))]
    for k in big:
        np.testing.assert_allclose(g_p[k], g_f[k], rtol=1e-3,
                                   atol=1e-3 * float(np.abs(g_f[k]).max()), err_msg=k)


@pytest.mark.parametrize("name,small,lookup,match", [
    ("raft", False, "experimental:pallas", "Pallas call"),
    ("gma", False, "experimental:pallas", "Pallas call"),
    ("raft", True, "experimental:pallas", "Pallas call"),
    ("raft", False, "experimental:fused_mix:rows,bd", "#16"),
    ("raft", False, MIX, None),
    ("raft", True, "experimental:fused_bd", None),
])
def test_finetune_refuses_what_jax_cannot_differentiate(name, small, lookup, match):
    """make_finetune_step (and the train forward) raise for the spellings
    that reach a Pallas call in JAX: pallas on RAFT, GMA and RAFT-small, a
    bd level on full RAFT. A mix without bd builds its step, and so does
    RAFT-small with fused_bd, which runs its default lookup (kernel #2's,
    with its backward) as JAX maps it to its flat one."""
    kw = dict(small=True) if small else {}
    est = build_flow_estimator(name, compute_dtype="float32", device="cpu", corr_lookup=lookup,
                               **kw)
    opt = make_optimizer(est.model.parameters(), 1e-4, 2, 1e-5, 1e-8, 1.0)
    img = np.zeros((1, SIZE, SIZE, 3), np.float32)
    if match is None:
        ft.make_finetune_step(est, opt, add_noise=False, gamma=GAMMA)
        est.forward(img, img + 0.5, iters=1, train=True)["flow_up"].sum().backward()
        assert est.model.fnet.conv1.weight.grad.abs().sum() > 0
        return
    with pytest.raises(NotImplementedError, match=match):
        ft.make_finetune_step(est, opt, add_noise=False, gamma=GAMMA)
    with pytest.raises(NotImplementedError, match=match):
        est.forward(img, img, iters=1, train=True)
