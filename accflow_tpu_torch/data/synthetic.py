"""Synthetic clips and long sequences with exact ground truth, the port's
own numpy copy of accflow_tpu/data/synthetic.py (importing accflow_tpu.data
pulls in jax): `make_clip` and `write_synthetic_cvor` (CVO-style clips of a
translating texture, the evaluation's stand-in for the CVO test set) and
`make_long_sequence` with their helpers. The copy draws from the generator
in the same order, so a seed gives the same frames and flows bit for bit:
the drift fixture's recorded EPE curve (tests/fixtures/drift_small_epe.npy)
was measured on `make_long_sequence` of np.random.default_rng(77), 64^2, 36
frames, seg_len=6, max_v=1, fg=True, fg_max_v=2."""

from __future__ import annotations

import os.path as osp

import numpy as np

from accflow_tpu_torch.data.records import CVORWriter


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth random RGB texture with enough structure for matching."""
    base = rng.uniform(0, 255, size=(h // 4 + 2, w // 4 + 2, 3))
    up = np.kron(base, np.ones((4, 4, 1)))[:h, :w]
    noise = rng.uniform(-12, 12, size=(h, w, 3))
    return np.clip(up + noise, 0, 255).astype(np.float32)


def _shift(img: np.ndarray, dy: int, dx: int) -> np.ndarray:
    return np.roll(np.roll(img, dy, axis=0), dx, axis=1)


def _segment_velocities(
    rng: np.random.Generator, frames: int, seg_len, max_v: int
):
    """Per-step integer velocities (vy_t, vx_t) for t=1..frames-1:
    constant when seg_len is None, else redrawn every seg_len steps
    (piecewise-constant, time-varying motion)."""
    steps = frames - 1
    if seg_len is None:
        # Two scalar draws: bit-stream-identical to the original make_clip
        # (a batched integers(size=2) consumes the stream differently).
        v = np.array(
            [rng.integers(-max_v, max_v + 1), rng.integers(-max_v, max_v + 1)]
        )
        return np.repeat(v[None], steps, axis=0)
    segs = (steps + seg_len - 1) // seg_len
    vs = rng.integers(-max_v, max_v + 1, size=(segs, 2))
    return np.repeat(vs, seg_len, axis=0)[:steps]


def make_clip(rng: np.random.Generator, h: int, w: int, frames: int = 7, seg_len=None):
    """One clip: frames + exact fflows/bflows/delta flows (HWC, channel-cat).

    seg_len=None keeps a constant velocity per clip; an int redraws it
    every seg_len frames (exact GT via cumulative integer shifts)."""
    tex = _texture(rng, h, w)
    vel = _segment_velocities(rng, frames, seg_len, max_v=3)  # (frames-1, 2)
    cum = np.concatenate([np.zeros((1, 2), np.int64), np.cumsum(vel, axis=0)])
    imgs = [_shift(tex, int(cum[t, 0]), int(cum[t, 1])).astype(np.uint8)
            for t in range(frames)]

    def flow(dy, dx):
        f = np.empty((h, w, 2), np.float32)
        f[..., 0] = dx
        f[..., 1] = dy
        return f

    fflows = [flow(*cum[k]) for k in range(2, frames)]     # F0k
    bflows = [flow(*(-cum[k])) for k in range(2, frames)]  # Fk0
    dflows_f = [flow(*vel[t]) for t in range(frames - 1)]     # F_{t,t+1}
    dflows_b = [flow(*(-vel[t])) for t in range(frames - 1)]  # F_{t+1,t}
    return {
        "imgs": np.concatenate(imgs, axis=-1),
        "imgs_blur": np.concatenate(imgs, axis=-1),
        "fflows": np.concatenate(fflows, axis=-1),
        "bflows": np.concatenate(bflows, axis=-1),
        "delta_fflows": np.concatenate(dflows_f, axis=-1),
        "delta_bflows": np.concatenate(dflows_b, axis=-1),
    }


def key_specs(h: int, w: int, frames: int = 7) -> dict:
    """CVOR key specs of a clip (records.py)."""
    return {
        "imgs": {"shape": (h, w, 3 * frames), "dtype": "uint8"},
        "imgs_blur": {"shape": (h, w, 3 * frames), "dtype": "uint8"},
        "fflows": {"shape": (h, w, 2 * (frames - 2)), "dtype": "uint16"},
        "bflows": {"shape": (h, w, 2 * (frames - 2)), "dtype": "uint16"},
        "delta_fflows": {"shape": (h, w, 2 * (frames - 1)), "dtype": "uint16"},
        "delta_bflows": {"shape": (h, w, 2 * (frames - 1)), "dtype": "uint16"},
    }


def write_synthetic_cvor(root: str, num_train: int = 4, num_test: int = 2, h: int = 64,
                         w: int = 64, frames: int = 7, seed: int = 0, seg_len=None) -> str:
    """Create <root>/{train,test} CVOR datasets of make_clip clips drawn
    from `seed`. Returns root."""
    rng = np.random.default_rng(seed)
    for sub, n in (("train", num_train), ("test", num_test)):
        with CVORWriter(osp.join(root, sub), key_specs(h, w, frames)) as wr:
            for _ in range(n):
                wr.add(make_clip(rng, h, w, frames, seg_len=seg_len))
    return root


def _sample_wrap(tex: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Bilinear sample of an HWC texture at float coords with torus wrap.
    Exact (a pure gather) whenever ys/xs are integral."""
    h, w = tex.shape[:2]
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]

    def at(yy, xx):
        return tex[yy % h, xx % w]

    return (
        at(y0, x0) * (1 - wy) * (1 - wx)
        + at(y0, x0 + 1) * (1 - wy) * wx
        + at(y0 + 1, x0) * wy * (1 - wx)
        + at(y0 + 1, x0 + 1) * wy * wx
    )


def make_long_sequence(
    rng: np.random.Generator,
    h: int,
    w: int,
    frames: int,
    seg_len: int = 8,
    max_v: int = 2,
    rot_deg: float = 0.0,
    zoom_amp: float = 0.0,
    fg: bool = True,
    fg_frac: float = 0.25,
    fg_max_v: int = 3,
):
    """A long sequence with time-varying motion and EXACT long-range GT,
    for streaming drift studies (the 7-frame `make_clip` recurrence run
    far past its training horizon — the reference's AccFlow_.py:157-175
    only ever composes 5 steps).

    Scene model (torus world — content wraps, so it never leaves frame):
      background  a smooth texture under a composed per-frame similarity
                  A_i: piecewise-constant integer translation (redrawn
                  every `seg_len` frames) plus optional oscillating
                  rotation (`rot_deg` amplitude, degrees) and zoom
                  (`zoom_amp`, fractional). Frame i renders the texture at
                  T_i(s) = z_i R(phi_i)(s-c) + c + S_i, so the backward
                  long-range flow is analytically exact:
                  F_{i,0}(p) = T_i^{-1}(p) - p.
      foreground  (fg=True) an independently-textured rectangle
                  (`fg_frac` of each side) translating with its own
                  piecewise velocity, composited on top — real occlusion
                  events: background content whose frame-0 position is
                  covered by the patch is OCCLUDED w.r.t. frame 0.

    GT convention matches make_clip / CVO bflows: F_{i,0} is the
    displacement added to frame-i coords to reach the content's frame-0
    coords, UNWRAPPED (the true trajectory — beyond half a period it is
    not recoverable from a single image pair, which is exactly what
    accumulation is for).

    Returns {"imgs": (frames,h,w,3) uint8,
             "bflows": (frames-1,h,w,2) float32  # F_{i,0}, i=1..frames-1
             "vis":    (frames-1,h,w) bool}      # visible in frame 0
    """
    tex = _texture(rng, h, w)
    vel = _segment_velocities(rng, frames, seg_len, max_v)  # (frames-1, 2)
    cum = np.concatenate([np.zeros((1, 2), np.int64), np.cumsum(vel, axis=0)])
    phis = np.deg2rad(rot_deg) * np.sin(2 * np.pi * np.arange(frames) / 32.0)
    zooms = 1.0 + zoom_amp * np.sin(2 * np.pi * np.arange(frames) / 24.0)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0

    ph, pw = max(2, int(h * fg_frac)), max(2, int(w * fg_frac))
    fgtex = None
    if fg:
        # Distinct statistics so the patch is trackable against the bg.
        fgtex = np.clip(_texture(rng, ph, pw) * 0.5 + 96.0, 0, 255)
        q0 = np.array([rng.integers(0, h), rng.integers(0, w)], np.int64)
        fvel = _segment_velocities(rng, frames, seg_len, fg_max_v)
        fcum = q0[None] + np.concatenate(
            [np.zeros((1, 2), np.int64), np.cumsum(fvel, axis=0)]
        )

    rows, cols = np.mgrid[0:h, 0:w].astype(np.float64)

    def inv_map(i):
        """Frame-i pixel coords -> frame-0 (texture) coords, unwrapped."""
        yy = rows - cum[i, 0] - cy
        xx = cols - cum[i, 1] - cx
        c, s = np.cos(-phis[i]), np.sin(-phis[i])
        ys = (c * yy - s * xx) / zooms[i] + cy
        xs = (s * yy + c * xx) / zooms[i] + cx
        return ys, xs

    def fg_mask(i):
        qy, qx = int(fcum[i, 0]), int(fcum[i, 1])
        my = (np.arange(h)[:, None] - qy) % h < ph
        mx = (np.arange(w)[None, :] - qx) % w < pw
        return my & mx

    imgs = np.empty((frames, h, w, 3), np.uint8)
    bflows = np.empty((frames - 1, h, w, 2), np.float32)
    vis = np.ones((frames - 1, h, w), bool)
    for i in range(frames):
        ys, xs = inv_map(i)
        frame = _sample_wrap(tex, ys, xs)
        if fg:
            m = fg_mask(i)
            qy, qx = int(fcum[i, 0]), int(fcum[i, 1])
            py = (np.arange(h)[:, None] - qy) % h  # (h, 1) in-patch row
            px = (np.arange(w)[None, :] - qx) % w  # (1, w) in-patch col
            fgimg = fgtex[py % ph, px % pw]  # (h, w, 3); valid where m
            frame = np.where(m[..., None], fgimg, frame)
        imgs[i] = np.clip(frame, 0, 255).astype(np.uint8)
        if i == 0:
            continue
        # Background backward flow F_{i,0} = A_i(p) - p (exact).
        f = np.stack([xs - cols, ys - rows], axis=-1).astype(np.float32)
        v = np.ones((h, w), bool)
        if fg:
            # Foreground pixels: rigid patch, displacement fcum[0]-fcum[i].
            f[m] = np.array(
                [fcum[0, 1] - fcum[i, 1], fcum[0, 0] - fcum[i, 0]], np.float32
            )
            # Background pixels whose frame-0 (wrapped) position is under
            # the frame-0 patch are occluded; foreground always visible.
            m0 = fg_mask(0)
            y0w = np.rint(ys).astype(np.int64) % h
            x0w = np.rint(xs).astype(np.int64) % w
            v = ~(m0[y0w, x0w] & ~m)
        bflows[i - 1] = f
        vis[i - 1] = v
    return {"imgs": imgs, "bflows": bflows, "vis": vis}
