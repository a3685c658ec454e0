#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (accflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--tile-sweep]   # repo root, one GPU

Phases, each of which ends the run with a non-zero exit code if it fails:
1. the card's name and power limit (nvidia-smi);
2. build the correlation lookup kernel from csrc/ with nvcc (timed);
3. at the main path's lookup shape (Q = 22*64*64 queries, levels 64^2,
   32^2, 16^2, 8^2, coords +-20 px around the grid), float32 and bfloat16
   levels: the kernel against the plain lookup on the card, then the
   median times of the kernel, the plain lookup and F.grid_sample per level
   (the library yardstick; the port never calls it) beside the bound;
4. the main path: AccFlow+RAFT clip inference, 7 frames of 512^2, batch 2,
   12 RAFT iterations per pair, bfloat16 compute with float32 flow state,
   weights from a seed; output shape, finiteness and 12 lookup launches
   per forward are checked, frames/s and peak memory printed. Then a small
   clip in float32 (TF32 off) runs once on the GPU (through the kernel)
   and once on the CPU (through the plain lookup) with the same weights,
   and the two must agree.
Optional phases: --tile-sweep builds the kernel with 4, 8 and 16 queries
per block and times them in turns (after phase 3); --profile prints where
the device time of the main path's clip forward goes (torch.profiler).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a GPU, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

try:
    from accflow_tpu_torch import models
    from accflow_tpu_torch.ops import corr, corr_cuda
except ImportError as e:  # this file alone, outside the repository
    sys.exit(f"chip_smoke: run from the repository root ({e})")

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores
LOOKUP_TOL = 1e-4            # kernel vs plain lookup, max abs (see check_lookup)
CLIP_REL = 1e-3              # GPU vs CPU clip: max abs diff / max |flow| (see small_clip)
TILES = (4, 8, 16)           # queries per block tried by --tile-sweep; 8 ships
KINDS = (  # --profile: kind of a kernel, first match on its lower-cased name
    ("corr lookup (this port's kernel)", ("corr_lookup",)),
    ("conv / GEMM (cuDNN, cuBLAS)", ("conv", "gemm", "xmma", "cutlass", "cudnn", "sm90_", "wgrad", "dgrad")),
    ("gather / index", ("index", "gather", "scatter")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("copy / cast / layout", ("copy", "cat", "nchw", "nhwc", "transpose")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi(fields: str) -> str:
    """The first card's `fields` as nvidia-smi prints them (csv, no header)."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi printed no card")
    return out[0]


def cuda_ms(fn, inner: int, rounds: int = 5) -> float:
    """Device time of one call (CUDA events around `inner` back-to-back
    calls, so the host's launch overhead overlaps the device's work),
    median over `rounds`, after one warm-up call."""
    fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def lookup_bound(levels, coords, radius: int = 4):
    """Least time for the lookup on an H100: bytes it must move (coords read,
    output written, and the patch cells inside each map that these coords
    touch, read once) over 3.35 TB/s, against ~11 float32 operations per
    output over 67 TFLOP/s. Returns (ms, "bytes" | "operations", bytes)."""
    q, side = coords.shape[0], 2 * radius + 2
    elem = levels[0].element_size()
    cells = 0
    for l, lvl in enumerate(levels):
        hl, wl = lvl.shape[1:]
        o = torch.floor(coords / 2.0 ** l) - radius
        cols = (torch.minimum(o[:, 0] + side, torch.tensor(float(wl), device=o.device))
                - o[:, 0].clamp(min=0)).clamp(0, side)
        rows = (torch.minimum(o[:, 1] + side, torch.tensor(float(hl), device=o.device))
                - o[:, 1].clamp(min=0)).clamp(0, side)
        cells += int((cols * rows).sum().item())
    n_out = q * len(levels) * (2 * radius + 1) ** 2
    nbytes = q * 2 * 4 + n_out * 4 + cells * elem
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, n_out * 11 / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def grid_sample_lookup(levels, coords, radius: int = 4):
    """The same windows through F.grid_sample, one call per level: grid
    (Q, 9, 9, 2) with [q, a, b] at (x/2^l + a - r, y/2^l + b - r), so the
    flattened (9, 9) output is the a*9 + b channel order."""
    num = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, device=coords.device, dtype=torch.float32)
    grids = []
    for l, lvl in enumerate(levels):
        hl, wl = lvl.shape[1:]
        c = coords / 2.0 ** l
        gx = (c[:, 0, None, None] + d[None, :, None]).expand(-1, num, num)
        gy = (c[:, 1, None, None] + d[None, None, :]).expand(-1, num, num)
        g = torch.stack([2 * gx / (wl - 1) - 1, 2 * gy / (hl - 1) - 1], dim=-1)
        grids.append(g.to(lvl.dtype).contiguous())
    inputs = [lvl.unsqueeze(1) for lvl in levels]

    def run():
        return [F.grid_sample(x, g, mode="bilinear", padding_mode="zeros",
                              align_corners=True) for x, g in zip(inputs, grids)]

    def result():
        return torch.cat([o.reshape(o.shape[0], -1).float() for o in run()], dim=1)

    return run, result


def lookup_inputs():
    """The main path's lookup shape: Q = 22*64*64 queries (11 pairs at batch
    2, 512^2 frames), unit-normal float32 levels of 64^2, 32^2, 16^2, 8^2,
    coords on the grid +-20 px."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, h, w = 22, 64, 64
    q = b * h * w
    levels32 = [torch.randn((q, h >> l, w >> l), generator=gen, device=dev)
                for l in range(4)]
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    grid = torch.stack([xs, ys], -1).float().expand(b, h, w, 2).reshape(q, 2)
    coords = (grid + torch.empty((q, 2), device=dev).uniform_(-20, 20, generator=gen)).contiguous()
    return levels32, coords


def check_lookup(levels32, coords):
    """Phase 3. The kernel shares one fractional offset over a window's 81
    taps; the plain lookup recomputes x/2^l + (a - 4) per tap, whose float32
    rounding (<= half an ulp of |x| <= ~100, i.e. <= 4e-6) times the maps'
    local slope (unit-normal values, |slope| <= ~8) stays below 1e-4."""
    rows = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        levels = [lvl.to(dtype) for lvl in levels32]
        got = corr_cuda.lookup_corr_fused(levels, coords)
        ref = corr.lookup_corr_plain(levels, coords)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        lib_run, lib_result = grid_sample_lookup(levels, coords)
        lib_err = float((lib_result() - ref).abs().max())
        print(f"lookup {name}: kernel vs plain max abs {err:.3e} (tol {LOOKUP_TOL:g}); "
              f"grid_sample vs plain {lib_err:.3e}")
        if not err <= LOOKUP_TOL:
            fail(f"lookup kernel disagrees with the plain lookup ({name}): {err}")
        ms = cuda_ms(lambda: corr_cuda.lookup_corr_fused(levels, coords), 20)
        plain_ms = cuda_ms(lambda: corr.lookup_corr_plain(levels, coords), 2, 3)
        library_ms = cuda_ms(lib_run, 10)
        bound_ms, bound_by, nbytes = lookup_bound(levels, coords)
        print(f"lookup {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B at 3.35 TB/s)")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
        del levels, got, ref, lib_run, lib_result
    return rows


def tile_sweep(levels32, coords):
    """--tile-sweep: the kernel built with each of TILES queries per block,
    each checked against the plain lookup, timed in the order
    4, 8, 16, 16, 8, 4 so that a drift of the card's clock cancels."""
    libs = {}
    for qt in TILES:
        path, log = corr_cuda.build(f"-DCORR_QT={qt}")
        libs[qt] = corr_cuda.load(path)
        regs = [m.strip() for m in log.splitlines() if "registers" in m]
        print(f"tile sweep: built QT={qt} {regs}")
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        levels = [lvl.to(dtype) for lvl in levels32]
        ref = corr.lookup_corr_plain(levels, coords)
        times = {qt: [] for qt in TILES}
        for qt in (*TILES, *reversed(TILES)):
            err = float((corr_cuda.launch(libs[qt], levels, coords) - ref).abs().max())
            if not err <= LOOKUP_TOL:
                fail(f"tile sweep: QT={qt} disagrees with the plain lookup ({name}): {err}")
            times[qt].append(cuda_ms(lambda: corr_cuda.launch(libs[qt], levels, coords), 20))
        print(f"tile sweep {name}: " + "; ".join(
            f"QT={qt} {', '.join(f'{t:.4f}' for t in ts)} ms" for qt, ts in times.items()))
        del levels, ref


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def profile_forward(forward, wall_ms: float, reps: int = 3) -> None:
    """--profile: device time of `forward` by kind of kernel and the top
    kernels, per forward; the busy share is the summed device time over
    `wall_ms`, the forward's unprofiled wall time (the profiler slows the
    host), and the rest is the device waiting on the host."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            forward()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3 / reps, evt.count // reps, evt.key))
    busy_ms = sum(r[0] for r in rows)
    if not busy_ms > 0:
        fail("profile: the profiler saw no device time")
    print(f"profile: {wall_ms:.2f} ms per forward ({prof_ms:.2f} ms under the profiler); "
          f"device busy {busy_ms:.2f} ms = {100 * busy_ms / wall_ms:.1f} % of the unprofiled forward")
    by_kind: dict[str, list] = {}
    for ms, count, name in rows:
        acc = by_kind.setdefault(kind_of(name), [0.0, 0])
        acc[0] += ms
        acc[1] += count
    print("profile: device time by kind, per forward:")
    for kind, (ms, count) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f} %  {count:6d} launches  {kind}")
    print("profile: top kernels, per forward:")
    for ms, count, name in sorted(rows, reverse=True)[:25]:
        print(f"  {ms:9.3f} ms {count:6d}x  {name[:110]}")


def perturb_zero_conv(acc, seed: int) -> None:
    """AccPlus's ZeroConv starts at zero, which makes the deformable conv's
    offsets and masks trivial; draw it from `seed` so the run deforms."""
    gen = torch.Generator().manual_seed(seed)
    zc = acc.accplus.conv2[4]
    with torch.no_grad():
        for p, scale in ((zc.conv.weight, 0.05), (zc.conv.bias, 0.5), (zc.scale, 0.1)):
            p.copy_(torch.randn(p.shape, generator=gen) * scale)


def main_path(with_profile: bool):
    """Phase 4: the clip forward at full size (and --profile's breakdown of
    it), then the small GPU-vs-CPU clip."""
    dev = torch.device("cuda")
    t, n, size = 7, 2, 512
    est = models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0)
    acfg = models.AccFlowConfig(compute_dtype="bfloat16")
    acc = models.init_accflow(acfg, seed=1, device="cpu")
    perturb_zero_conv(acc, 2)
    acc = acc.to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.empty((t, n, size, size, 3), device=dev).uniform_(-1, 1, generator=gen)
    pairs = est.pairs_fn(iters=acfg.ofe_iters)

    def forward():
        return models.accflow_forward(acc, images, pairs)

    for _ in range(2):  # warm-up: cuDNN algorithm choice, allocator growth
        forward()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    corr_cuda.launches = 0
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = forward()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = corr_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    clocks = smi("clocks.sm,power.draw,temperature.gpu")
    if tuple(out.shape) != (t - 2, n, size, size, 2) or out.dtype != torch.float32:
        fail(f"main path output {tuple(out.shape)} {out.dtype}")
    if not bool(torch.isfinite(out).all()):
        fail("main path output is not finite")
    if launches != 12 * reps:
        fail(f"lookup kernel launched {launches} times in {reps} forwards, expected {12 * reps}")
    fps = n * t / statistics.median(secs)
    print(f"main path: output {tuple(out.shape)} finite, |flow| mean {float(out.abs().mean()):.4f}; "
          f"{launches} lookup launches in {reps} forwards; median {statistics.median(secs) * 1e3:.2f} ms "
          f"per forward (runs {', '.join(f'{s * 1e3:.2f}' for s in secs)} ms) = {fps:.3f} frames/s; "
          f"peak memory {peak / 2**30:.3f} GiB; after the runs: SM clock, power, temperature {clocks}")
    if with_profile:
        profile_forward(forward, statistics.median(secs) * 1e3)
    del est, acc, images, out
    torch.cuda.empty_cache()
    small_clip()
    return launches, fps


def small_clip() -> None:
    """A 4-frame 64^2 clip in float32, TF32 off, with the same seeds: on the
    GPU (through the kernel) and on the CPU (through the plain lookup, the
    path tests/test_torch_*.py hold against JAX). Both sides are float32
    and differ only by summation order (cuDNN against CPU convs) and the
    kernel's shared fractional offset (~1e-5 per tap on unit-normal maps,
    phase 3): 1.9e-7 max abs at |flow| max 0.15 on an H100 (PERF.md). The
    bar, CLIP_REL of the largest |flow|, leaves ~800x room for that and
    fails a lookup error that moves the flow by a thousandth of its size."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clip = np.random.default_rng(3).uniform(-1, 1, (4, 1, 64, 64, 3)).astype(np.float32)
    outs = {}
    for where in ("cuda", "cpu"):
        est = models.build_flow_estimator("raft", compute_dtype="float32", device=where, seed=0)
        cfg = models.AccFlowConfig(compute_dtype="float32")
        acc = models.init_accflow(cfg, seed=1, device="cpu")
        perturb_zero_conv(acc, 2)
        before = corr_cuda.launches
        outs[where] = models.accflow_forward(acc.to(where), clip, est.pairs_fn()).cpu().numpy()
        print(f"small clip on {where}: {corr_cuda.launches - before} kernel launches")
        if (corr_cuda.launches > before) != (where == "cuda"):
            fail(f"small clip on {where} launched the kernel {corr_cuda.launches - before} times")
    diff = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    flow_max = float(np.abs(outs["cpu"]).max())
    tol = CLIP_REL * flow_max
    print(f"small clip GPU vs CPU: max abs {diff:.3e}, |flow| max {flow_max:.3e} "
          f"(tol {CLIP_REL:g} x |flow| max = {tol:.3e})")
    if not flow_max > 0 or not np.isfinite(outs["cuda"]).all():
        fail("small clip: the flow is zero or not finite, nothing to compare")
    if not diff <= tol:
        fail(f"small clip: GPU and CPU differ by {diff:.3e} > {tol:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="print where the main path's device time goes")
    ap.add_argument("--tile-sweep", action="store_true",
                    help="time the lookup kernel at 4, 8 and 16 queries per block")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    line = smi("name,power.limit")
    print(line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib, log = corr_cuda.build()
    print(f"built {lib} in {time.perf_counter() - t0:.2f} s")
    for msg in log.splitlines():
        if "registers" in msg or "error" in msg.lower():
            print(f"  nvcc: {msg.strip()}")

    levels32, coords = lookup_inputs()
    rows = check_lookup(levels32, coords)
    if args.tile_sweep:
        tile_sweep(levels32, coords)
    del levels32, coords
    torch.cuda.empty_cache()
    launches, fps = main_path(args.profile)
    print(f"frames/s {fps:.3f} on {line} (AccFlow+RAFT, 7x512^2, batch 2, 12 iters, bf16)")

    main_row = rows["bfloat16"]  # the main path stores its levels in bf16
    print(json.dumps({"kernels": [{
        "name": "corr_lookup", "route": "cuda",
        "source": "accflow_tpu_torch/csrc/corr_lookup.cu",
        "replaces": "accflow_tpu/ops/corr_pallas.py:264",
        "launches": launches, **main_row,
        "levels_dtype": "bfloat16", "float32_levels": rows["float32"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
