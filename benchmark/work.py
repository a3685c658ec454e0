"""Operations and bytes of one clip call, from a configuration's and a
traffic mix's shapes: the yardstick of `clip_mfu_pct` and
`lookup_roofline`.

Operations are multiply-adds times two, counted for the work the outputs
need at the model's published layout (the reference's layers,
benchmark/reference/):

- convolutions: 2 x N x Cout x Hout x Wout x Cin x kh x kw each, no bias;
  the GRU's share of its loop-invariant input (the context `inp`) once a
  pair, since the outputs need it once (`hoisted`; False counts it every
  iteration, as the plain reference computes it);
- matrix products: GMA's similarity (once a source frame) and
  aggregation (every iteration), the deformable conv's contraction;
- the correlation, the lesser of two ways to the same windows: the
  all-pairs pyramid built once (a pair's queries against every key of
  every level) or each iteration's window entries, (2r+2)^2 a level and a
  query, from which the (2r+1)^2 bilinear taps are blended. Either gives
  the outputs; the lesser is what they need, whatever implements it.

Bytes of the window lookups (kernel #1 or #2 on the path): per launch,
the level cells that the queries' (2r+2)^2 patches touch inside each map,
read once, at the levels' type; the windows written once at the compute
type; the coordinates (two float32) read once. The patches are placed at
zero flow, the queries' own pixels: the random-weight flows are well
under a pixel at 1/8 scale, and the count then needs no data.
"""

from __future__ import annotations

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _down(n: int, times: int = 1) -> int:
    """Output size of a stride-2 conv with 'same' padding (ceil(n / 2))."""
    for _ in range(times):
        n = (n + 1) // 2
    return n


def conv_flops(n: int, cin: int, cout: int, h: int, w: int, k, stride: int = 1) -> int:
    kh, kw = (k, k) if isinstance(k, int) else k
    if stride == 2:
        h, w = _down(h), _down(w)
    return 2 * n * cout * h * w * cin * kh * kw


def encoder_flops(n: int, h: int, w: int, cout: int) -> int:
    """RAFT's BasicEncoder on n images of h x w."""
    total = conv_flops(n, 3, 64, h, w, 7, 2)
    h, w = _down(h), _down(w)
    cin = 64
    for planes, stride in ((64, 1), (96, 2), (128, 2)):
        total += conv_flops(n, cin, planes, h, w, 3, stride)
        if stride == 2 or cin != planes:
            total += conv_flops(n, cin, planes, h, w, 1, stride)
        if stride == 2:
            h, w = _down(h), _down(w)
        total += conv_flops(n, planes, planes, h, w, 3) * 3
        cin = planes
    return total + conv_flops(n, 128, cout, h, w, 1)


def level_sizes(h8: int, w8: int, levels: int) -> list:
    sizes, h, w = [], h8, w8
    for _ in range(levels):
        sizes.append((h, w))
        h, w = h // 2, w // 2
    return sizes


def _touched(n: int, scale: int, size: int, radius: int) -> int:
    """Cells of one axis of a level map that the (2r+2)-wide patches of the
    n queries 0 .. n-1 touch, summed over the queries."""
    side = 2 * radius + 2
    total = 0
    for x in range(n):
        lo = x // scale - radius
        total += max(0, min(lo + side, size) - max(lo, 0))
    return total


def clip_work(config: dict, shape: tuple, hoisted: bool = True) -> dict:
    """Operations and lookup bytes of one call on clips of `shape` (T, N,
    H, W) under `config` (a configuration file). Returns the terms and
    their total ("flops"), and "lookup_bytes"."""
    e = config["estimator"]
    t, n, h, w = shape
    h8, w8 = h // 8, w // 8
    hw = h8 * w8
    pairs = 2 * (t - 2) + 1
    sources = t - 1  # frames 1 .. T-1
    iters, radius, levels = e["iters"], e["corr_radius"], e["corr_levels"]
    c, hd, cd = e["feature_dim"], e["hidden_dim"], e["context_dim"]
    gma = e["attention_heads"] > 0
    planes = levels * (2 * radius + 1) ** 2

    conv = encoder_flops(t * n, h, w, c) + encoder_flops(sources * n, h, w, hd + cd)
    conv += encoder_flops(t * n, h, w, config["accumulator"]["hidden"])
    # Each iteration of a pair: the motion encoder, the GRU, the flow head.
    it = (conv_flops(n, planes, 256, h8, w8, 1) + conv_flops(n, 256, 192, h8, w8, 3)
          + conv_flops(n, 2, 128, h8, w8, 7) + conv_flops(n, 128, 64, h8, w8, 3)
          + conv_flops(n, 256, 126, h8, w8, 3))
    varying = 128 * (2 if gma else 1)
    gru_in = hd + (0 if hoisted else cd) + varying
    it += 2 * 3 * conv_flops(n, gru_in, hd, h8, w8, (1, 5))
    it += conv_flops(n, hd, 256, h8, w8, 3) + conv_flops(n, 256, 2, h8, w8, 3)
    if gma:
        it += conv_flops(n, 128, e["attention_heads"] * e["dim_head"], h8, w8, 1)
    per_pair = iters * it
    per_pair += conv_flops(n, hd, 256, h8, w8, 3) + conv_flops(n, 256, 576, h8, w8, 1)
    if hoisted:
        per_pair += 2 * 3 * conv_flops(n, cd, hd, h8, w8, (1, 5))
    conv += pairs * per_pair
    if gma:
        conv += sources * conv_flops(n, cd, 2 * e["attention_heads"] * e["dim_head"], h8, w8, 1)

    # The accumulator: 3 flow encodings a step, AccPlus, the blending mask,
    # the decoder.
    a = config["accumulator"]["hidden"]
    s = t - 2
    enc = (conv_flops(n, 2, a, h8, w8, 7) + conv_flops(n, a, 2 * a, h8, w8, 3)
           + conv_flops(n, 2 * a, a, h8, w8, 1))
    cell = 3 * enc
    cell += conv_flops(n, 2 * a + 1, 2 * a, h8, w8, 3) + conv_flops(n, 2 * a, a, h8, w8, 3)
    cell += (conv_flops(n, 2 * a, 2 * a, h8, w8, 3) + conv_flops(n, 2 * a, a, h8, w8, 3)
             + conv_flops(n, a, 27, h8, w8, 3))
    cell += conv_flops(n, 2 * a + 1, 2 * a, h8, w8, 3) + conv_flops(n, 2 * a, a, h8, w8, 3)
    cell += (conv_flops(n, 4 * a, 2 * a, h8, w8, 3) + conv_flops(n, 2 * a, a, h8, w8, 3)
             + conv_flops(n, a, a, h8, w8, 1))
    cell += conv_flops(n, a, 2 * a, h8, w8, 1) + conv_flops(n, 2 * a, 1, h8, w8, 3)
    cell += (conv_flops(n, a, 2 * a, h8, w8, 3) + conv_flops(n, 2 * a, 2, h8, w8, 3)
             + conv_flops(n, a, 2 * a, h8, w8, 3) + conv_flops(n, 2 * a, 576, h8, w8, 1))
    conv += s * cell

    deform = s * 2 * n * hw * 9 * a * a
    attention = 0
    if gma:
        dh = e["attention_heads"] * e["dim_head"]
        attention = sources * 2 * n * hw * hw * dh + pairs * iters * 2 * n * hw * hw * dh
    sizes = level_sizes(h8, w8, levels)
    pyramid = pairs * 2 * n * hw * c * sum(hl * wl for hl, wl in sizes)
    window = pairs * iters * 2 * n * hw * c * levels * (2 * radius + 2) ** 2
    corr = min(pyramid, window)

    level_bytes = DTYPE_BYTES[config["compute_dtype"]]
    cells = sum(_touched(w8, 2 ** lvl, wl, radius) * _touched(h8, 2 ** lvl, hl, radius)
                for lvl, (hl, wl) in enumerate(sizes))
    per_launch = (n * cells * level_bytes + n * hw * planes * level_bytes + n * hw * 2 * 4)
    return dict(conv=conv, deform=deform, attention=attention, corr_pyramid=pyramid,
                corr_window=window, corr=corr, flops=conv + deform + attention + corr,
                lookup_bytes=pairs * iters * per_launch, lookup_launch_bytes=per_launch)
