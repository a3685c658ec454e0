#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (accflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--tile-sweep]   # repo root, one GPU

Phases, each of which ends the run with a non-zero exit code if it fails:
1. the card's name and power limit (nvidia-smi);
2. build every kernel from csrc/ with nvcc, one process each, started
   together (timed): the lookups #1 and #2, the y contraction #3, the
   floor kernel and the one-level build of #2 (the probes');
3. kernel #1, the 4-level radius-4 lookup (csrc/corr_lookup.cu), at the
   clip path's lookup shape (Q = 22*64*64 queries, levels 64^2, 32^2, 16^2,
   8^2, coords +-20 px around the grid), float32 and bfloat16 levels: the
   kernel against the plain lookup on the card, then the device times
   (device_ms: CUDA events, the card held by a spin kernel) of the kernel,
   the plain lookup and F.grid_sample per level (the library yardstick;
   the port never calls it) beside the bound, and the kernel's wall time
   per call back to back (CUDA events);
4. kernel #2, the per-level lookup (csrc/corr_level_lookup.cu), the same
   checks and times at the stream's shape (Q = 4*64*64, radius 3) and at
   the clip path's shape (radius 4, beside kernel #1's time);
4b. kernel #3, the y contraction (csrc/corr_y_contract.cu), at levels 0 and
   1 of the clip path's shape with the tent weights of its coords, float32
   and bfloat16: the kernel against its plain twin, then the device times
   of the kernel, the twin and torch.bmm beside the bound;
4c. the probes (probes.py): #4 kernel #2 built for one level at level 0
   of the clip shape, #5 kernel #3 at scripts/probe_pallas_bd.py's shape,
   #6 the floor kernel over kernel #1's operands, beside kernel #1's time
   and bound;
5. the clip path: AccFlow+RAFT clip inference, 7 frames of 512^2, batch 2,
   12 RAFT iterations per pair, bfloat16 compute with float32 flow state,
   weights from a seed; output shape, finiteness and 12 kernel-#1 launches
   per forward are checked, frames/s and peak memory printed; then the same
   clip with corr_lookup="experimental:fused_bd" (12 kernel-#3 launches and
   no kernel-#1 launch per forward). Then a small clip in float32 (TF32
   off) runs on the GPU (through the kernels) and on the CPU (through the
   plain versions) with the same weights, with both lookups, and the GPU
   must agree with the CPU and fused_bd with fused;
6. the stream at full width (scripts/bench_stream.py's stream6 protocol:
   512^2, batch 2, bfloat16 compute with float32 flow state, 6 OFE
   iterations per step): reset on 3 frames, 2 warm-up pushes, 30 timed
   pushes, for (a) RAFT-small + AccFlow hidden 128 (kernel #2) and (b) full
   RAFT + AccFlow hidden 128 (kernel #1); ms per push, frames/s, peak
   memory, output shape and finiteness, 6 launches per push;
7. the trained drift fixture (tests/fixtures/drift_small_{ofe,acc}.npz:
   RAFT-small, hidden-64 accumulator) streamed over the fixture's 36-frame
   sequence in float32, TF32 off, on the GPU: the EPE(i) curve must meet
   both bounds of tests/test_streaming.py:250-258; the same stream on the
   CPU (plain lookup) must agree with it (DRIFT_REL, DRIFT_EPE_PX);
8. the CVO evaluation at full width (train/evaluate.py::evaluate_cvo): 10
   synthetic CVOR clips of 512^2 written to a temporary directory, batch 10
   (micro-batch 5), 12 iterations, bfloat16, acc|raft with fused,
   experimental:fused_bd and experimental:fused_bd2 and direct|raft with
   fused and experimental:fused_bd: EPE all / vis / occ, seconds per batch,
   peak memory and launches (24 per batch; 48 with fused_bd2); each split
   lookup's EPEs within EVAL_EPE_REL of fused's.
Optional phases: --tile-sweep builds kernel #1 with 4, 8 and 16 queries
per block and times them in turns (after phase 3); --profile prints where
the device time of the clip forward (with fused and with
experimental:fused_bd) and of a stream push goes (torch.profiler). The
line before the last is {"kernels": [...]}; the last line is {"ok": true,
"device": {...}}. Without a GPU, or without the package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

try:
    from accflow_tpu_torch import models, probes
    from accflow_tpu_torch.convert import load_jax_params, load_npz_tree, to_jax_params
    from accflow_tpu_torch.data.synthetic import make_long_sequence, write_synthetic_cvor
    from accflow_tpu_torch.nn.layers import tf32
    from accflow_tpu_torch.ops import corr, corr_bd_cuda, corr_cuda, corr_level_cuda
    from accflow_tpu_torch.probes import grid_sample_lookup, lookup_bound
    from accflow_tpu_torch.streaming import StreamAccumulator
    from accflow_tpu_torch.train.evaluate import evaluate_cvo
except ImportError as e:  # this file alone, outside the repository
    sys.exit(f"chip_smoke: run from the repository root ({e})")

LOOKUP_TOL = 1e-4            # kernel vs plain lookup, max abs (see check_lookup)
SPIN_CYCLES = 2 * 10**8      # device_ms's first spin: ~0.1 s at the H100's 1.98 GHz
# Kernel #3 vs its plain twin. float32 inputs: max abs 1e-4; both sum the
# same float32 products over y in another order, ~1e-7 at |tmp| <= ~5.
# bfloat16 inputs: max abs 1e-3 x max |tmp|; the products of two bfloat16
# values are exact in float32, so the two differ by summation order only
# (~1e-7 relative), and the bar is relative because |tmp| scales with the maps.
Y_TOL_F32 = 1e-4
Y_REL_BF16 = 1e-3
CLIP_REL = 1e-3              # GPU vs CPU clip: max abs diff / max |flow| (see small_clip)
DRIFT_REL = 1e-3             # GPU vs CPU drift stream, first output (see drift_fixture)
DRIFT_EPE_PX = 0.05          # GPU vs CPU drift stream, per-step EPE (see drift_fixture)
# Eval at full width, bfloat16: |EPE(split lookup) - EPE(fused)| <=
# EVAL_EPE_REL x EPE(fused) + 1e-3 px for all / vis / occ. The split lookup
# rounds the tent weights wy and the y contraction's output to bfloat16
# (<= 2^-9 relative each) where kernel #1 blends the same bfloat16 map
# values in float32, so each window value moves by <= ~0.4 %, no more than
# the bfloat16 rounding the motion encoder applies to it anyway; averaged
# over 512^2 pixels and 10 clips the EPE moves by far less than 2 %. A wrong
# window (transposed offsets, a wrong level scale, a missing level) changes
# the flow everywhere. Fixed before the phase's first run.
EVAL_EPE_REL = 0.02
FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"
KERNELS = (corr_cuda, corr_level_cuda, corr_bd_cuda)  # each wrapper's `launches` count
TILES = (4, 8, 16)           # queries per block tried by --tile-sweep; 8 ships
KINDS = (  # --profile: kind of a kernel, first match on its lower-cased name
    ("corr lookup (this port's kernels)", ("corr_lookup", "level_lookup", "y_contract")),
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
    """Wall time of one call as its caller sees it: CUDA events around
    `inner` back-to-back calls, median over `rounds`, after one warm-up
    call. Where a call's kernels are shorter than the host's work to issue
    them, this times the host (see device_ms)."""
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


def device_rows(prof, calls: int):
    """(ms per call, launches per call, name) of each kernel in a profile
    of `calls` calls."""
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3 / calls, evt.count // calls, evt.key))
    return rows


def device_ms(fn, calls: int) -> float:
    """Device time of one call, after one warm-up call: the time between
    two CUDA events recorded on the stream around `calls` calls, over
    `calls`. The calls are issued while a spin kernel (torch.cuda._sleep)
    holds the card, so the card runs them back to back and never waits for
    the host between them: the host's time for a call (checks, allocation,
    ctypes; longer than the kernel at the stream's lookup shape) is left
    out, and what remains beside the kernels is the card's own gap between
    queued launches. If issuing the calls took the host longer than the
    spin, the spin is lengthened and the calls issued again.
    (torch.profiler's kernel times, which this replaced, miss kernels now
    and then on the card: a profile of 20 launches saw 12.)"""
    fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(4):
        spin0, spin1, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(4))
        spin0.record()
        torch.cuda._sleep(cycles)
        spin1.record()
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if issue_ms < spin0.elapsed_time(spin1):
            return start.elapsed_time(end) / calls
        cycles *= 4
    fail(f"device_ms: the host took {issue_ms:.1f} ms to issue {calls} calls, longer "
         "than the spin that was to hold the card")


def lookup_inputs(b: int):
    """A lookup shape of the port: Q = b*64*64 queries (b pair-batches of
    512^2 frames; 22 on the clip path, 4 in the stream), unit-normal float32
    levels of 64^2, 32^2, 16^2, 8^2, coords on the grid +-20 px."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    h, w = 64, 64
    q = b * h * w
    levels32 = [torch.randn((q, h >> l, w >> l), generator=gen, device=dev)
                for l in range(4)]
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    grid = torch.stack([xs, ys], -1).float().expand(b, h, w, 2).reshape(q, 2)
    coords = (grid + torch.empty((q, 2), device=dev).uniform_(-20, 20, generator=gen)).contiguous()
    return levels32, coords


def check_lookup(label: str, kernel, levels32, coords, radius: int, beside=None):
    """Phases 3 and 4: `kernel(levels, coords)` against the plain lookup at
    `radius`, then its time beside the plain lookup's, F.grid_sample's, the
    bound and, when given, `beside(levels, coords)`'s (kernel #1 on the same
    inputs). Times are device times (device_ms); the kernel's `wall_ms` is
    the event timing of back-to-back calls, wrapper included. Both kernels
    share one fractional offset over a window's taps;
    the plain lookup recomputes x/2^l + (a - r) per tap, whose float32
    rounding (<= half an ulp of |x| <= ~100, i.e. <= 4e-6) times the maps'
    local slope (unit-normal values, |slope| <= ~8) stays below 1e-4."""
    rows = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        levels = [lvl.to(dtype) for lvl in levels32]
        got = kernel(levels, coords)
        ref = corr.lookup_corr_plain(levels, coords, radius)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        lib_run, lib_result = grid_sample_lookup(levels, coords, radius)
        lib_err = float((lib_result() - ref).abs().max())
        print(f"{label} {name}: kernel vs plain max abs {err:.3e} (tol {LOOKUP_TOL:g}); "
              f"grid_sample vs plain {lib_err:.3e}")
        if not err <= LOOKUP_TOL:
            fail(f"{label}: kernel disagrees with the plain lookup ({name}): {err}")
        ms = device_ms(lambda: kernel(levels, coords), 20)
        wall_ms = cuda_ms(lambda: kernel(levels, coords), 20)
        plain_ms = device_ms(lambda: corr.lookup_corr_plain(levels, coords, radius), 2)
        library_ms = device_ms(lib_run, 10)
        bound_ms, bound_by, nbytes = lookup_bound(levels, coords, radius)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms, wall_ms=wall_ms)
        extra = ""
        if beside is not None:
            row["corr_lookup_ms"] = device_ms(lambda: beside(levels, coords), 20)
            extra = f", kernel #1 {row['corr_lookup_ms']:.4f} ms"
        print(f"{label} {name}: kernel {ms:.4f} ms ({wall_ms:.4f} ms per call back to back), "
              f"plain {plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms, bound {bound_ms:.4f} "
              f"ms ({bound_by}: {nbytes} B at 3.35 TB/s){extra}")
        rows[name] = row
        del levels, got, ref, lib_run, lib_result
    return rows


def check_y_contract(levels32, coords):
    """Phase 4b: kernel #3 at levels 0 and 1 of the clip shape: corr3 the
    level's unit-normal maps, wy the tent weights of the coords' y windows
    (what _level_window_bd gives it), float32 and bfloat16. The kernel
    against its plain twin (Y_TOL_F32, Y_REL_BF16), then device times of
    the kernel, the twin and torch.bmm (the library yardstick, bf16 out)
    beside the bound. Returns {level: {dtype: row}}."""
    rows = {}
    delta = torch.linspace(-4, 4, 9, device=coords.device)
    with tf32(False):
        for l in (0, 1):
            hl = levels32[l].shape[1]
            wy32 = corr.window_weights(coords[:, 1:2] / 2.0 ** l + delta, hl)
            for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                corr3, wy = levels32[l].to(dtype), wy32.to(dtype)
                got = corr_bd_cuda.y_contract(corr3, wy)
                ref = corr_bd_cuda.y_contract_plain(corr3, wy)
                lib_out = torch.bmm(wy, corr3)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                scale = float(ref.abs().max())
                tol = Y_TOL_F32 if dtype == torch.float32 else Y_REL_BF16 * scale
                lib_err = float((lib_out.float() - ref).abs().max())
                print(f"kernel #3 level {l} {name}: kernel vs plain max abs {err:.3e} "
                      f"(tol {tol:.3e}, max |tmp| {scale:.3f}); torch.bmm vs plain {lib_err:.3e}")
                if not err <= tol:
                    fail(f"kernel #3 level {l} {name}: kernel disagrees with its plain twin: {err}")
                ms = device_ms(lambda: corr_bd_cuda.y_contract(corr3, wy), 20)
                wall_ms = cuda_ms(lambda: corr_bd_cuda.y_contract(corr3, wy), 20)
                plain_ms = device_ms(lambda: corr_bd_cuda.y_contract_plain(corr3, wy), 5)
                library_ms = device_ms(lambda: torch.bmm(wy, corr3), 20)
                bound_ms, bound_by, nbytes = probes.y_contract_bound(corr3)
                print(f"kernel #3 level {l} {name}: kernel {ms:.4f} ms ({wall_ms:.4f} ms per call "
                      f"back to back), plain {plain_ms:.4f} ms, torch.bmm {library_ms:.4f} ms, "
                      f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B at 3.35 TB/s) = "
                      f"{100 * bound_ms / ms:.1f} % of bound")
                rows.setdefault(f"level{l}", {})[name] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=library_ms, wall_ms=wall_ms)
                del corr3, wy, got, ref, lib_out
    return rows


def probe_launches() -> int:
    """The launches the probes' kernels count, summed."""
    return corr_level_cuda.launches + corr_bd_cuda.launches + probes.floor_launches


def run_probes(levels32, coords, rows1):
    """Phase 4c: the probes (probes.py), each against its plain version,
    then timed; the floor's time is printed beside kernel #1's (rows1, the
    bf16 row of phase 3) and kernel #1's bound. A probe is on no model path:
    its path is its timed run, whose launches (warm-up included, the
    comparison's not) its row reports. Returns the JSON rows."""
    levels = [lvl.to(torch.bfloat16) for lvl in levels32]
    out = []
    for make in (lambda: probes.level_probe(levels[0], coords),
                 lambda: probes.bd_probe(coords.device),
                 lambda: probes.floor_probe(levels, coords)):
        probe = make()
        got, ref = probe.kernel(), probe.plain()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        print(f"probe {probe.name} (replaces {probe.replaces}): kernel vs plain max abs "
              f"{err:.3e} (tol {probe.tol:.3e}: {probe.why})")
        if not err <= probe.tol:
            fail(f"probe {probe.name}: kernel disagrees with its plain version: {err}")
        del got, ref
        before = probe_launches()
        ms = device_ms(probe.kernel, 20)
        launched = probe_launches() - before
        if launched < 21:  # a warm-up and 20 profiled calls (more if a profile was retaken)
            fail(f"probe {probe.name}: {launched} kernel launches in its timed run, expected 21")
        plain_ms = device_ms(probe.plain, 3)
        library_ms = device_ms(probe.library, 10) if probe.library is not None else None
        lib = f", library {library_ms:.4f} ms" if library_ms is not None else ""
        print(f"probe {probe.name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound "
              f"{probe.bound_ms:.4f} ms ({probe.bound_by}: {probe.nbytes} B) = "
              f"{100 * probe.bound_ms / ms:.1f} % of bound")
        if probe.name == "corr_floor":
            print(f"probe corr_floor: the floor of kernel #1's operands {ms:.4f} ms beside "
                  f"kernel #1 {rows1['ms']:.4f} ms and its bound {rows1['bound_ms']:.4f} ms "
                  f"(bf16 levels, clip shape)")
        out.append({"name": probe.name, "route": "cuda", "source": probe.source,
                    "replaces": probe.replaces, "launches": launched, "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": probe.bound_ms,
                    "bound_by": probe.bound_by, "library_ms": library_ms,
                    "path": "probe: its own timed run"})
    del levels
    return out


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
    rows = device_rows(prof, reps)
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


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def expect_counts(path: str, kernel, expected: int) -> int:
    """After a path's run from reset_counts(): `kernel` launched `expected`
    times and every other kernel never. Returns the count."""
    counts = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in KERNELS}
    print(f"{path}: kernel launches {counts}")
    for k in KERNELS:
        want = expected if k is kernel else 0
        if k.launches != want:
            fail(f"{path}: {k.__name__} launched {k.launches} times, expected {want}")
    return kernel.launches


def time_clip(label: str, forward, kernel, shape):
    """Two warm-up forwards (cuDNN algorithm choice, allocator growth), then
    5 timed ones: `kernel` must launch 12 times per forward and no other
    kernel at all; the output must be float32 of `shape` and finite.
    Returns (launches, median seconds, seconds, output, peak bytes)."""
    for _ in range(2):
        forward()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    reset_counts()
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = forward()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = expect_counts(label, kernel, 12 * reps)
    peak = torch.cuda.max_memory_allocated()
    clocks = smi("clocks.sm,power.draw,temperature.gpu")
    if tuple(out.shape) != shape or out.dtype != torch.float32:
        fail(f"{label} output {tuple(out.shape)} {out.dtype}")
    if not bool(torch.isfinite(out).all()):
        fail(f"{label} output is not finite")
    med = statistics.median(secs)
    print(f"{label}: output {tuple(out.shape)} finite, |flow| mean {float(out.abs().mean()):.4f}; "
          f"{launches} lookup launches in {reps} forwards; median {med * 1e3:.2f} ms "
          f"per forward (runs {', '.join(f'{s * 1e3:.2f}' for s in secs)} ms) = "
          f"{shape[1] * (shape[0] + 2) / med:.3f} frames/s; peak memory {peak / 2**30:.3f} GiB; "
          f"after the runs: SM clock, power, temperature {clocks}")
    return launches, med, secs, out, peak


def clip_path(with_profile: bool):
    """Phase 5: the clip forward at full size (and --profile's breakdown of
    it), the same clip with the split lookup, then the small GPU-vs-CPU
    clip. Returns (kernel #1 launches, frames/s, kernel #3 launches,
    frames/s with fused_bd)."""
    dev = torch.device("cuda")
    t, n, size = 7, 2, 512
    acfg = models.AccFlowConfig(compute_dtype="bfloat16")
    acc = models.init_accflow(acfg, seed=1, device="cpu")
    perturb_zero_conv(acc, 2)
    acc = acc.to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.empty((t, n, size, size, 3), device=dev).uniform_(-1, 1, generator=gen)
    shape = (t - 2, n, size, size, 2)
    est = models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0)
    pairs = est.pairs_fn(iters=acfg.ofe_iters)

    def forward():
        return models.accflow_forward(acc, images, pairs)

    launches, med, _, out, _ = time_clip("clip path", forward, corr_cuda, shape)
    fps = n * t / med
    if with_profile:
        profile_forward(forward, med * 1e3)
    del est, pairs
    torch.cuda.empty_cache()

    est_bd = models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0,
                                         corr_lookup="experimental:fused_bd")
    pairs_bd = est_bd.pairs_fn(iters=acfg.ofe_iters)

    def forward_bd():
        return models.accflow_forward(acc, images, pairs_bd)

    launches_bd, med_bd, _, out_bd, _ = time_clip(
        "clip path, experimental:fused_bd", forward_bd, corr_bd_cuda, shape)
    fps_bd = n * t / med_bd
    if with_profile:
        profile_forward(forward_bd, med_bd * 1e3)
    gap = float((out_bd - out).abs().max())
    print(f"clip path, same process: fused {med * 1e3:.2f} ms ({fps:.3f} frames/s), "
          f"experimental:fused_bd {med_bd * 1e3:.2f} ms ({fps_bd:.3f} frames/s); bf16 outputs "
          f"differ by max abs {gap:.3e} at |flow| max {float(out.abs().max()):.3e}")
    del est_bd, pairs_bd, acc, images, out, out_bd
    torch.cuda.empty_cache()
    small_clip()
    return launches, fps, launches_bd, fps_bd


def small_clip() -> None:
    """A 4-frame 64^2 clip in float32, TF32 off, with the same seeds: on the
    GPU (through the kernels) and on the CPU (through the plain versions,
    the path tests/test_torch_*.py hold against JAX), with corr_lookup
    fused and experimental:fused_bd. Both sides are float32 and differ
    only by summation order (cuDNN against CPU convs; the tent contractions)
    and the lookup kernel's shared fractional offset (~1e-5 per tap on
    unit-normal maps, phase 3): 1.9e-7 max abs at |flow| max 0.15 on an
    H100 (PERF.md). The bar, CLIP_REL of the largest |flow|, leaves ~800x
    room for that and fails a lookup error that moves the flow by a
    thousandth of its size; it holds GPU against CPU for both lookups and
    fused_bd against fused on the GPU (the same function, computed as
    bilinear taps by kernel #1 and as tent contractions by kernel #3)."""
    clip = np.random.default_rng(3).uniform(-1, 1, (4, 1, 64, 64, 3)).astype(np.float32)
    outs = {}
    for lookup, kernel in (("fused", corr_cuda), ("experimental:fused_bd", corr_bd_cuda)):
        for where in ("cuda", "cpu"):
            est = models.build_flow_estimator("raft", compute_dtype="float32", device=where,
                                              seed=0, corr_lookup=lookup)
            cfg = models.AccFlowConfig(compute_dtype="float32")
            acc = models.init_accflow(cfg, seed=1, device="cpu")
            perturb_zero_conv(acc, 2)
            reset_counts()
            with tf32(False):
                outs[lookup, where] = models.accflow_forward(
                    acc.to(where), clip, est.pairs_fn()).cpu().numpy()
            expect_counts(f"small clip {lookup} on {where}", kernel,
                          12 if where == "cuda" else 0)
    for a, b in ((("fused", "cuda"), ("fused", "cpu")),
                 (("experimental:fused_bd", "cuda"), ("experimental:fused_bd", "cpu")),
                 (("experimental:fused_bd", "cuda"), ("fused", "cuda"))):
        diff = float(np.abs(outs[a] - outs[b]).max())
        flow_max = float(np.abs(outs[b]).max())
        tol = CLIP_REL * flow_max
        print(f"small clip {a[0]} on {a[1]} vs {b[0]} on {b[1]}: max abs {diff:.3e}, "
              f"|flow| max {flow_max:.3e} (tol {CLIP_REL:g} x |flow| max = {tol:.3e})")
        if not flow_max > 0 or not np.isfinite(outs[a]).all():
            fail("small clip: the flow is zero or not finite, nothing to compare")
        if not diff <= tol:
            fail(f"small clip: {a} and {b} differ by {diff:.3e} > {tol:.3e}")


def moving_frames(t: int, n: int, size: int, seed: int) -> torch.Tensor:
    """(t, n, size, size, 3) frames in [-1, 1] on the card: a smooth random
    texture per batch element, each frame shifted (torus wrap) by a
    velocity of up to 4 px per frame redrawn every 6 frames, so warm starts
    see real motion."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    coarse = torch.rand((n, 3, size // 8, size // 8), generator=gen, device=dev)
    tex = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
    tex = (tex + 0.05 * torch.randn(tex.shape, generator=gen, device=dev)).clamp(0, 1) * 2 - 1
    vel = torch.randint(-4, 5, ((t + 5) // 6, n, 2), generator=gen, device=dev)
    vel = vel.repeat_interleave(6, dim=0)[:t].cpu()
    vel[0] = 0
    cum = vel.cumsum(0).tolist()
    frames = torch.stack([
        torch.stack([torch.roll(tex[b], shifts=(cum[i][b][0], cum[i][b][1]), dims=(1, 2))
                     for b in range(n)]) for i in range(t)])
    return frames.permute(0, 1, 3, 4, 2).contiguous()


def stream_path(label: str, small: bool, with_profile: bool):
    """Phase 6: scripts/bench_stream.py's stream6 protocol through the
    port's StreamAccumulator: 512^2, batch 2, bf16 compute, 6 OFE iterations
    per step, AccFlow hidden 128 with its ZeroConv perturbed; reset on 3
    frames, 2 warm-up pushes, 30 timed pushes (host clock around each push,
    synchronised). Returns (kernel launches in the run, frames/s, median ms)."""
    n, size, warm, timed, iters = 2, 512, 2, 30, 6
    kernel = corr_level_cuda if small else corr_cuda
    est = models.build_flow_estimator("raft", compute_dtype="bfloat16", small=small,
                                      iters=iters, seed=0)
    acc = models.init_accflow(models.AccFlowConfig(compute_dtype="bfloat16", warm_start=True),
                              seed=1, device="cpu")
    perturb_zero_conv(acc, 2)
    sa = StreamAccumulator(est, acc.to("cuda"))
    frames = moving_frames(3 + warm + timed, n, size, seed=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = sa.reset(frames[:3])
    for i in range(3, 3 + warm):
        out = sa.push(frames[i])
    torch.cuda.synchronize()
    before = kernel.launches
    secs = []
    for i in range(3 + warm, 3 + warm + timed):
        t0 = time.perf_counter()
        out = sa.push(frames[i])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    in_timed = kernel.launches - before
    launches = expect_counts(f"stream {label}", kernel, 2 * iters + (warm + timed) * iters)
    peak = torch.cuda.max_memory_allocated()
    clocks = smi("clocks.sm,power.draw,temperature.gpu")
    if tuple(out.shape) != (n, size, size, 2) or out.dtype != torch.float32:
        fail(f"stream {label} output {tuple(out.shape)} {out.dtype}")
    if not bool(torch.isfinite(out).all()):
        fail(f"stream {label} output is not finite")
    if in_timed != iters * timed:
        fail(f"stream {label}: {in_timed} launches in {timed} pushes, expected {iters * timed}")
    med = statistics.median(secs) * 1e3
    fps = n * timed / sum(secs)
    print(f"stream {label}: output {tuple(out.shape)} finite, |flow| mean "
          f"{float(out.abs().mean()):.4f}; {in_timed} launches in {timed} pushes "
          f"({in_timed / timed:g} per push; {launches} with reset and warm-up); median "
          f"{med:.3f} ms per push (min {min(secs) * 1e3:.3f}, max {max(secs) * 1e3:.3f}) = "
          f"{fps:.3f} frames/s; peak memory {peak / 2**30:.3f} GiB; "
          f"after the runs: SM clock, power, temperature {clocks}")
    if with_profile:
        replay = itertools.cycle(frames[3:])
        profile_forward(lambda: sa.push(next(replay)), med)
    del est, acc, sa, frames, out
    torch.cuda.empty_cache()
    return launches, fps, med, peak


def drift_run(where: str, seq):
    """The fixture's stream on `where`, float32, TF32 off: outputs F_{i,0}
    for i = 2..35 as (34, 64, 64, 2) numpy."""
    est = models.build_flow_estimator("raft", compute_dtype="float32", small=True, iters=6,
                                      device=where)
    load_jax_params(est.model, load_npz_tree(str(FIXTURES / "drift_small_ofe.npz")))
    acc = models.init_accflow(models.AccFlowConfig(hidden=64, compute_dtype="float32",
                                                   warm_start=True), device=where)
    load_jax_params(acc, load_npz_tree(str(FIXTURES / "drift_small_acc.npz")))
    imgs = (2.0 * (seq["imgs"].astype(np.float32) / 255.0) - 1.0)[:, None]
    sa = StreamAccumulator(est, acc)
    with tf32(False):
        outs = [sa.reset(imgs[:3])]
        outs += [sa.push(imgs[i]) for i in range(3, imgs.shape[0])]
    return torch.stack(outs)[:, 0].cpu().numpy()


def drift_fixture():
    """Phase 7: the trained RAFT-small (6 iterations) + hidden-64
    accumulator streamed over the fixture's 36-frame sequence on the GPU
    (kernel #2) and on the CPU (plain lookup).

    Bounds on the GPU curve, tests/test_streaming.py:250-258: EPE(i) <=
    1.5 x recorded + 0.5 at every step, and the mean of the last 6 <= 2 x
    the mean of curve[2:8] + 1.
    GPU vs CPU, both float32: they differ by summation order (cuDNN, the
    splat's accumulation) and the kernel's shared fractional offset, ~1e-6
    of the flow per step; the warm start carries each step's flow into the
    next search, and a binary occlusion bit (mean error <= 1.0) or a
    bilinear floor can flip at a pixel. Bars: the first output F_{2,0}
    (before any warm start) within DRIFT_REL of the largest |flow|, as the
    small clip; and |EPE_gpu(i) - EPE_cpu(i)| <= DRIFT_EPE_PX at every step
    (about 1 % of the smallest recorded EPE, 2.97 px), room for a few
    flipped pixels per step but not for a lookup error that moves the flow."""
    seq = make_long_sequence(np.random.default_rng(77), 64, 64, 36, seg_len=6, max_v=1,
                             fg=True, fg_max_v=2)
    gt = seq["bflows"][1:35]
    ref_curve = np.load(FIXTURES / "drift_small_epe.npy")
    reset_counts()
    gpu = drift_run("cuda", seq)
    launches = expect_counts("drift fixture on the GPU", corr_level_cuda, 12 + 33 * 6)
    cpu = drift_run("cpu", seq)
    curves = {k: np.sqrt(((v - gt) ** 2).sum(-1)).mean(axis=(1, 2)) for k, v in
              (("gpu", gpu), ("cpu", cpu))}
    curve = curves["gpu"]
    print("drift fixture EPE(i), i = 2..35, GPU: " + " ".join(f"{v:.4f}" for v in curve))
    print("drift fixture EPE(i), i = 2..35, CPU: " + " ".join(f"{v:.4f}" for v in curves["cpu"]))
    print("drift fixture EPE(i), recorded:        " + " ".join(f"{v:.4f}" for v in ref_curve))
    early, late = float(curve[2:8].mean()), float(curve[-6:].mean())
    worst = float((curve - (1.5 * ref_curve + 0.5)).max())
    print(f"drift fixture bounds: max(curve - (1.5 x recorded + 0.5)) = {worst:.4f} (<= 0); "
          f"late {late:.4f} <= 2 x early {early:.4f} + 1 = {2 * early + 1:.4f}")
    if not (worst <= 0 and late <= 2 * early + 1):
        fail("drift fixture: the GPU stream breaks the drift bounds")
    first = float(np.abs(gpu[0] - cpu[0]).max())
    first_tol = DRIFT_REL * float(np.abs(cpu[0]).max())
    epe_gap = np.abs(curves["gpu"] - curves["cpu"])
    print(f"drift fixture GPU vs CPU: F_2,0 max abs {first:.3e} (tol {first_tol:.3e}); "
          f"per-step EPE gap max {epe_gap.max():.3e} px, mean {epe_gap.mean():.3e} px "
          f"(tol {DRIFT_EPE_PX} px); flows max abs over all steps {np.abs(gpu - cpu).max():.3e}")
    if not np.isfinite(gpu).all() or not first <= first_tol:
        fail(f"drift fixture: first output GPU vs CPU {first:.3e} > {first_tol:.3e}")
    if not epe_gap.max() <= DRIFT_EPE_PX:
        fail(f"drift fixture: per-step EPE GPU vs CPU differs by {epe_gap.max():.3e} px")
    return launches


def eval_phase():
    """Phase 8: the CVO evaluation at full width on synthetic CVOR clips
    (10 of 512^2, written to a temporary directory): one warm-up call, then
    acc|raft with fused, fused_bd and fused_bd2 and direct|raft with fused
    and fused_bd, batch 10 (micro-batch 5), 12 iterations, bfloat16, RAFT
    from seed 0 and AccFlow from seed 1 with its ZeroConv perturbed. Returns
    {(model, lookup): row}."""
    clips, batch, n_batches = 10, 10, 1
    acc = models.init_accflow(models.AccFlowConfig(compute_dtype="bfloat16"), seed=1,
                              device="cpu")
    perturb_zero_conv(acc, 2)
    acc_tree = to_jax_params(acc)
    del acc
    runs = (("acc|raft", "fused", corr_cuda, 24), ("acc|raft", "experimental:fused_bd", corr_bd_cuda, 24),
            ("acc|raft", "experimental:fused_bd2", corr_bd_cuda, 48),
            ("direct|raft", "fused", corr_cuda, 24),
            ("direct|raft", "experimental:fused_bd", corr_bd_cuda, 24))
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = str(Path(tmp) / "cvor")
        t0 = time.perf_counter()
        write_synthetic_cvor(root, num_train=0, num_test=clips, h=512, w=512)
        print(f"eval: wrote {clips} synthetic CVOR clips of 512^2 in "
              f"{time.perf_counter() - t0:.2f} s")

        def run(model, lookup):
            return evaluate_cvo(model, root, batch=batch, iters=12, compute_dtype="bfloat16",
                                corr_lookup=lookup, acc_params=acc_tree, device="cuda",
                                result_file=str(Path(tmp) / "result.txt"))

        run("acc|raft", "fused")  # warm-up: cuDNN algorithm choice at batch 5
        for model, lookup, kernel, want in runs:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            res = run(model, lookup)
            torch.cuda.synchronize()
            secs = (time.perf_counter() - t0) / n_batches
            launches = expect_counts(f"eval {model} {lookup}", kernel, want * n_batches)
            peak = torch.cuda.max_memory_allocated()
            if not all(np.isfinite(v) for v in res.values()):
                fail(f"eval {model} {lookup}: EPE not finite {res}")
            print(f"eval {model} {lookup}: EPE all {res['all']:.4f} vis {res['vis']:.4f} "
                  f"occ {res['occ']:.4f}; {secs:.3f} s per batch of {batch} (micro-batch 5); "
                  f"peak memory {peak / 2**30:.3f} GiB; {launches} launches")
            rows[model, lookup] = dict(res, s_per_batch=secs, peak_gib=peak / 2**30,
                                       launches=launches)
    for model, lookup, _, _ in runs:
        if lookup == "fused":
            continue
        ref, got = rows[model, "fused"], rows[model, lookup]
        for k in ("all", "vis", "occ"):
            gap, bar = abs(got[k] - ref[k]), EVAL_EPE_REL * ref[k] + 1e-3
            print(f"eval {model} {lookup} vs fused: EPE {k} {got[k]:.4f} vs {ref[k]:.4f}, "
                  f"gap {gap:.4f} (bar {bar:.4f})")
            if not gap <= bar:
                fail(f"eval {model}: {lookup} EPE {k} {got[k]} differs from fused's "
                     f"{ref[k]} by more than {bar}")
    return rows


def build_kernels() -> None:
    """Phase 2: one nvcc per source (and per build of a source), started
    together."""
    builds = (corr_cuda.build, corr_level_cuda.build, corr_bd_cuda.build,
              probes.build_floor, lambda: corr_level_cuda.build("-DCORR_LEVELS=1"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(lambda b: b(), builds))
    print(f"built {len(built)} kernel libraries in {time.perf_counter() - t0:.2f} s")
    for (lib, log) in built:
        print(f"  {lib}")
        for msg in log.splitlines():
            if "registers" in msg or "stack" in msg or "error" in msg.lower():
                print(f"    nvcc: {msg.strip()}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="print where the clip forwards' and a stream push's device time goes")
    ap.add_argument("--tile-sweep", action="store_true",
                    help="time kernel #1 at 4, 8 and 16 queries per block")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    line = smi("name,power.limit")
    print(line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    build_kernels()

    levels32, coords = lookup_inputs(22)
    rows1 = check_lookup("kernel #1 (radius 4, clip shape)", corr_cuda.lookup_corr_fused,
                         levels32, coords, 4)
    if args.tile_sweep:
        tile_sweep(levels32, coords)
    rows2_r4 = check_lookup(
        "kernel #2 (radius 4, clip shape)",
        lambda lv, c: corr_level_cuda.lookup_corr_level(lv, c, 4), levels32, coords, 4,
        beside=corr_cuda.lookup_corr_fused)
    rows3 = check_y_contract(levels32, coords)
    probe_rows = run_probes(levels32, coords, rows1["bfloat16"])
    del levels32, coords
    torch.cuda.empty_cache()
    levels32, coords = lookup_inputs(4)
    rows2 = check_lookup("kernel #2 (radius 3, stream shape)",
                         lambda lv, c: corr_level_cuda.lookup_corr_level(lv, c, 3),
                         levels32, coords, 3)
    del levels32, coords
    torch.cuda.empty_cache()

    launches1, fps, launches3_clip, fps_bd = clip_path(args.profile)
    print(f"frames/s {fps:.3f} on {line} (AccFlow+RAFT, 7x512^2, batch 2, 12 iters, bf16); "
          f"{fps_bd:.3f} with experimental:fused_bd")
    launches2, fps_a, ms_a, _ = stream_path("(a) RAFT-small", True, args.profile)
    _, fps_b, ms_b, _ = stream_path("(b) full RAFT", False, args.profile)
    print(f"stream frames/s on {line} (512^2, batch 2, 6 iters, bf16): (a) RAFT-small "
          f"{fps_a:.3f} ({ms_a:.3f} ms per push), (b) full RAFT {fps_b:.3f} ({ms_b:.3f} ms)")
    drift_fixture()
    evals = eval_phase()

    print(json.dumps({"kernels": [
        {"name": "corr_lookup", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_lookup.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:264",
         "launches": launches1, **rows1["bfloat16"],
         "levels_dtype": "bfloat16", "float32_levels": rows1["float32"],
         "eval_launches": evals["acc|raft", "fused"]["launches"]},
        {"name": "corr_level_lookup", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_level_lookup.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:466",
         "launches": launches2, **rows2["bfloat16"],
         "levels_dtype": "bfloat16", "radius": 3, "float32_levels": rows2["float32"],
         "radius4_clip_shape": rows2_r4},
        {"name": "corr_y_contract", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_y_contract.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:343",
         "launches": evals["acc|raft", "experimental:fused_bd"]["launches"],
         **rows3["level0"]["bfloat16"], "shape": "level 0 of the clip path, bfloat16 in",
         "float32_inputs": rows3["level0"]["float32"], "level1": rows3["level1"],
         "clip_launches": launches3_clip,
         "fused_bd2_eval_launches": evals["acc|raft", "experimental:fused_bd2"]["launches"]},
        *probe_rows,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
