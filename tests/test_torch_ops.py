"""Ops and layers of the PyTorch port against their JAX counterparts, on
the CPU in float32, same inputs from a numpy seed. Tolerance 1e-5: the two
compute the same arithmetic, in possibly another summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accflow_tpu.models import encoders as j_enc
from accflow_tpu.nn import layers as j_layers
from accflow_tpu.ops import deform as j_deform
from accflow_tpu.ops import grids as j_grids
from accflow_tpu.ops import occlusion as j_occ
from accflow_tpu.ops import padding as j_padding
from accflow_tpu.ops import sampling as j_sampling
from accflow_tpu.ops import softsplat as j_softsplat
from accflow_tpu.ops import upsample as j_upsample
from accflow_tpu.ops import warmstart as j_warmstart
from accflow_tpu_torch.convert import load_jax_params
from accflow_tpu_torch.models.encoders import BasicEncoder, BottleneckBlock, SmallEncoder
from accflow_tpu_torch.nn import layers
from accflow_tpu_torch.ops import (
    deform,
    grids,
    occlusion,
    padding,
    sampling,
    softsplat,
    upsample,
    warmstart,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(np.moveaxis(a, -1, 1))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


def test_coords_grid():
    _close(grids.coords_grid(2, 5, 7), j_grids.coords_grid(2, 5, 7), rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(5, 7), (1, 4), (8, 8)])
def test_upflow8(rng, hw):
    flow = rng.standard_normal((2, *hw, 2)).astype(np.float32)
    _close(grids.upflow8(_t(flow)), j_grids.upflow8(jnp.asarray(flow)))


def test_downflow8(rng):
    flow = rng.standard_normal((2, 24, 40, 2)).astype(np.float32)
    _close(grids.downflow8(_t(flow)), j_grids.downflow8(jnp.asarray(flow)))
    with pytest.raises(ValueError):
        grids.downflow8(_t(flow[:, :20]))


def test_bilinear_sample(rng):
    img = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    coords = rng.uniform(-3, 13, (2, 6, 5, 2)).astype(np.float32)
    _close(sampling.bilinear_sample(_t(img), _t(coords)),
           j_sampling.bilinear_sample(jnp.asarray(img), jnp.asarray(coords)))


def test_backwarp(rng):
    img = rng.standard_normal((2, 12, 10, 4)).astype(np.float32)
    flow = rng.uniform(-4, 4, (2, 12, 10, 2)).astype(np.float32)
    _close(sampling.backwarp(_t(img), _t(flow)),
           j_sampling.backwarp(jnp.asarray(img), jnp.asarray(flow)))


def test_convex_upsample(rng):
    flow = rng.standard_normal((2, 6, 5, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 6, 5, 576)).astype(np.float32)
    _close(upsample.convex_upsample(_t(flow), _t(mask)),
           j_upsample.convex_upsample(jnp.asarray(flow), jnp.asarray(mask)))


@pytest.mark.parametrize("binary", [True, False])
def test_photometric_occ(rng, binary):
    n, h, w, c = 2, 10, 12, 8
    flow = rng.uniform(-3, 3, (n, h, w, 2)).astype(np.float32)
    feat2 = rng.standard_normal((n, h, w, c)).astype(np.float32)
    warped = np.asarray(j_sampling.backwarp(jnp.asarray(feat2), jnp.asarray(flow)))
    # Per-pixel error of exactly 0.5 or 1.5 on every channel: the binary
    # test (mean |err| <= 1.0) is far from its threshold everywhere.
    shift = rng.choice([-1.5, -0.5, 0.5, 1.5], (n, h, w, 1)).astype(np.float32)
    feat1 = warped + shift
    _close(occlusion.photometric_occ(_t(flow), _t(feat1), _t(feat2), binary),
           j_occ.photometric_occ(jnp.asarray(flow), jnp.asarray(feat1),
                                 jnp.asarray(feat2), binary))


def test_deform_conv3x3(rng):
    n, h, w, cin, cout = 2, 7, 9, 5, 6
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    off = rng.uniform(-2.5, 2.5, (n, h, w, 18)).astype(np.float32)
    mask = rng.uniform(0.1, 1.0, (n, h, w, 9)).astype(np.float32)
    wt = rng.standard_normal((3, 3, cin, cout)).astype(np.float32) * 0.2
    b = rng.standard_normal(cout).astype(np.float32)
    ref = j_deform.deform_conv3x3(jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask),
                                  jnp.asarray(wt), jnp.asarray(b))
    out = deform.deform_conv3x3(_nchw(x), _nchw(off), _nchw(mask),
                                _t(wt.transpose(3, 2, 0, 1)), _t(b))
    _close(out.permute(0, 2, 3, 1), ref)


def test_instance_norm(rng):
    x = rng.normal(1.5, 2.0, (2, 6, 7, 4)).astype(np.float32)
    _close(layers.instance_norm(_nchw(x)).permute(0, 2, 3, 1),
           j_layers.instance_norm(jnp.asarray(x)))


def test_batch_norm_frozen(rng):
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 2, 4), "bias": rng.standard_normal(4),
         "mean": rng.standard_normal(4), "var": rng.uniform(0.5, 2, 4)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    ref = j_layers.batch_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    out = layers.batch_norm(_nchw(x), _t(p["scale"]), _t(p["bias"]), _t(p["mean"]),
                            _t(p["var"]))
    _close(out.permute(0, 2, 3, 1), ref)


def test_zero_conv2d(rng):
    x = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)
    wt = rng.standard_normal((3, 3, 4, 7)).astype(np.float32) * 0.3
    b = rng.standard_normal(7).astype(np.float32)
    scale = rng.uniform(-0.3, 0.3, 7).astype(np.float32)
    ref = j_layers.zero_conv2d(
        {"w": jnp.asarray(wt), "b": jnp.asarray(b), "scale": jnp.asarray(scale)},
        jnp.asarray(x))
    out = layers.zero_conv2d(_nchw(x), _t(wt.transpose(3, 2, 0, 1)), _t(b), _t(scale))
    _close(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("norm_fn", ["instance", "batch", "none"])
def test_basic_encoder(rng, norm_fn):
    params = j_enc.init_basic_encoder(jax.random.PRNGKey(3), 3, 32, norm_fn)
    if norm_fn == "batch":  # non-trivial running statistics
        params = jax.tree_util.tree_map_with_path(
            lambda path, v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape), jnp.float32)
            if path[-1].key in ("var", "scale") else
            jnp.asarray(rng.standard_normal(v.shape) * 0.1, jnp.float32)
            if path[-1].key in ("mean", "bias") else v, params)
    x = rng.uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    ref = j_enc.basic_encoder(params, jnp.asarray(x), norm_fn)
    enc = load_jax_params(BasicEncoder(32, norm_fn), params)
    with torch.no_grad():
        out = enc(_nchw(x))
    # Not one op but a stack of 12 convs and norms: float32 summation order
    # compounds to ~2e-5 (observed), past the single-op 1e-5.
    _close(out.permute(0, 2, 3, 1), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("norm_fn", ["instance", "none"])
def test_bottleneck_block(rng, norm_fn, stride):
    """A strided block projects its input (16 -> 32 channels); a stride-1
    block keeps the width, as every one in SmallEncoder does."""
    cin = 32 if stride == 1 else 16
    params = j_enc.init_bottleneck_block(jax.random.PRNGKey(5), cin, 32, norm_fn, stride)
    x = rng.standard_normal((2, 12, 10, cin)).astype(np.float32)
    ref = j_enc.bottleneck_block(params, jnp.asarray(x), norm_fn, stride)
    blk = load_jax_params(BottleneckBlock(cin, 32, norm_fn, stride), params)
    with torch.no_grad():
        out = blk(_nchw(x))
    _close(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("norm_fn", ["instance", "none"])
def test_small_encoder(rng, norm_fn):
    """RAFT-small's fnet (instance norm) and cnet (no norm)."""
    params = j_enc.init_small_encoder(jax.random.PRNGKey(4), 40, norm_fn)
    x = rng.uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    ref = j_enc.small_encoder(params, jnp.asarray(x), norm_fn)
    enc = load_jax_params(SmallEncoder(40, norm_fn), params)
    with torch.no_grad():
        out = enc(_nchw(x))
    # A stack of 14 convs and 7 instance norms: float32 summation order
    # compounds past 1e-5 on values near zero, so the absolute part of the
    # 1e-5 bar is taken relative to the output's largest magnitude.
    ref = np.asarray(ref)
    _close(out.permute(0, 2, 3, 1), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["summation", "average", "linear", "softmax"])
def test_softsplat(rng, mode):
    """Flows up to +-3 px on a 9x11 grid: corners collide and leave the
    image, so the scatter-add's accumulation and its dropped taps are hit."""
    img = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    flow = rng.uniform(-3, 3, (2, 9, 11, 2)).astype(np.float32)
    metric = rng.standard_normal((2, 9, 11, 1)).astype(np.float32)
    m = mode in ("linear", "softmax")
    if mode == "linear":
        metric = np.abs(metric) + 0.1
    ref = j_softsplat.softsplat(jnp.asarray(img), jnp.asarray(flow),
                                jnp.asarray(metric) if m else None, mode=mode)
    out = softsplat.softsplat(_t(img), _t(flow), _t(metric) if m else None, mode=mode)
    _close(out, ref)


def test_softsplat_rejects():
    x = torch.zeros((1, 4, 4, 2))
    with pytest.raises(ValueError, match="metric"):
        softsplat.softsplat(x, x, mode="softmax")
    with pytest.raises(ValueError, match="mode"):
        softsplat.softsplat(x, x, mode="max")


@pytest.mark.parametrize("advect", [False, True])
def test_forward_splat_flow(rng, advect):
    flow = rng.uniform(-2.5, 2.5, (2, 8, 10, 2)).astype(np.float32)
    adv = rng.uniform(-2.5, 2.5, (2, 8, 10, 2)).astype(np.float32) if advect else None
    ref = j_warmstart.forward_splat_flow(jnp.asarray(flow),
                                         None if adv is None else jnp.asarray(adv))
    _close(warmstart.forward_splat_flow(_t(flow), None if adv is None else _t(adv)), ref)


def test_forward_interpolate_flow(rng):
    flow = rng.uniform(-3, 3, (9, 12, 2)).astype(np.float32)
    np.testing.assert_array_equal(warmstart.forward_interpolate_flow(flow),
                                  j_warmstart.forward_interpolate_flow(flow))
    far = np.full((4, 4, 2), 50.0, np.float32)  # every point leaves the image
    assert not warmstart.forward_interpolate_flow(far).any()


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
def test_input_padder(rng, mode):
    x = rng.uniform(0, 255, (2, 3, 37, 50, 3)).astype(np.float32)
    ours, ref = padding.InputPadder(x.shape, mode), j_padding.InputPadder(x.shape, mode)
    padded = ours.pad_np(x)
    np.testing.assert_array_equal(padded, ref.pad_np(x))
    assert padded.shape[2] % 8 == 0 and padded.shape[3] % 8 == 0
    np.testing.assert_array_equal(ours.unpad(padded), x)
