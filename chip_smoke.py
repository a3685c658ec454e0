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
   8^2, coords +-20 px around the grid), float32 and bfloat16 levels, each
   with float32 and bfloat16 output: the kernel against the plain lookup on
   the card (a bfloat16 output also bit-equal to the kernel's float32
   output cast), then the device times (device_ms: CUDA events, the card
   held by a spin kernel) of the kernel, the plain lookup and F.grid_sample
   per level (the library yardstick; the port never calls it) beside the
   bound for that output type, and the kernel's wall time per call back to
   back (CUDA events);
4. kernel #2, the per-level lookup (csrc/corr_level_lookup.cu), the same
   checks and times, float32 and bfloat16 levels each with float32 and
   bfloat16 output, at the stream's shape (Q = 4*64*64, radius 3) and at
   the clip path's shape (radius 4, beside kernel #1's time with the same
   output type);
4b. kernel #3, the y contraction (csrc/corr_y_contract.cu), at levels 0 and
   1 of the clip path's shape with the tent weights of its coords, float32
   and bfloat16 in, float32 and bfloat16 out: the kernel against its plain
   twin (a bfloat16 output also bit-equal to its float32 output cast), then
   the device times of the kernel, the twin and torch.bmm beside the bound
   for that output type; then the bfloat16 split lookup as
   experimental:fused_bd2 runs it (kernel #3 on levels 0 and 1, cuBLAS's
   bfloat16 GEMMs on all four) against the float32 split lookup on the same
   levels (SPLIT_REL);
4c. the probes (probes.py): #4 kernel #2 built for one level at level 0
   of the clip shape, #5 kernel #3 at scripts/probe_pallas_bd.py's shape,
   #6 the floor kernel over kernel #1's operands, beside kernel #1's time
   and bound;
5. the clip path: AccFlow+RAFT clip inference, 7 frames of 512^2, batch 2,
   12 RAFT iterations per pair, bfloat16 compute with float32 flow state,
   weights from a seed; output shape, finiteness and 12 kernel-#1 launches
   per forward are checked, frames/s and peak memory printed; one eager
   forward runs under torch.cuda.set_sync_debug_mode("error") (no host
   synchronisation); 5b: the same clip through graphs.CudaGraphed (warm-up
   and capture timed apart, 5 timed replays, a profile of one replay for
   its device busy time and lookup launches, the output against eager);
   9a: the clip exported with bfloat16 weights (serving.export_serving),
   saved, loaded for the card and run (export, save and load seconds,
   size, time, the flows against eager under ARTIFACT_REL); then the same
   clip with corr_lookup="experimental:fused_bd" (12 kernel-#3 launches and
   no kernel-#1 launch per forward). Then a small clip in float32 (TF32
   off) runs on the GPU (through the kernels) and on the CPU (through the
   plain versions) with the same weights, with both lookups, and the GPU
   must agree with the CPU and fused_bd with fused;
6. the stream at full width (scripts/bench_stream.py's stream6 protocol:
   512^2, batch 2, bfloat16 compute with float32 flow state, 6 OFE
   iterations per step): reset on 3 frames, 2 warm-up pushes, 30 timed
   pushes, for (a) RAFT-small + AccFlow hidden 128 (kernel #2) and (b) full
   RAFT + AccFlow hidden 128 (kernel #1), first eagerly (ms per push,
   frames/s, peak memory, output shape and finiteness, 6 launches per
   push, one push under the sync debug mode "error"), then graphed
   (StreamAccumulator: the same numbers, the first push's warm-up and
   capture timed apart, a profile of one replay, each push against the
   eager one); for (a), 9b: the stream exported with bfloat16 weights,
   saved, loaded for the card and pushed the same frames (ARTIFACT_REL);
7. the trained drift fixture (tests/fixtures/drift_small_{ofe,acc}.npz:
   RAFT-small, hidden-64 accumulator) streamed over the fixture's 36-frame
   sequence in float32, TF32 off, on the GPU, eagerly and graphed: the
   EPE(i) curve must meet both bounds of tests/test_streaming.py:250-258,
   the graphed stream must agree with the eager one (DRIFT_REL), and the
   same stream on the CPU (plain lookup) with the GPU's (DRIFT_REL,
   DRIFT_EPE_PX);
8. the CVO evaluation at full width (train/evaluate.py::evaluate_cvo): 10
   synthetic CVOR clips of 512^2 written to a temporary directory, batch 10
   (micro-batch 5), 12 iterations, bfloat16, acc|raft with fused,
   experimental:fused_bd and experimental:fused_bd2 and direct|raft with
   fused and experimental:fused_bd: EPE all / vis / occ, seconds per batch,
   peak memory and launches (24 per batch; 48 with fused_bd2); each split
   lookup's EPEs within EVAL_EPE_REL of fused's; acc|gma and direct|gma
   with fused (24 kernel-#1 launches per batch);
6c. stream (c): phase 6's protocol with GMA (gamma from seed 3; kernel #1,
   6 launches per push), every graphed push bit-equal to the eager one;
10. the GMA clip: AccFlow+GMA on the clip path's frames and accumulator (7
   x 512^2, batch 2, 11 pair queries, 12 iterations, bf16, dense
   attention), eager and graphed as phases 5 and 5b (12 kernel-#1 launches
   per forward, graphed against eager, peak memory, --profile's
   breakdown), then the attention's pieces timed alone (similarity,
   softmax, cast, gather to the pairs, one iteration's aggregate GEMM)
   beside their byte bounds; 10b: the small clip with GMA (kernels #1 and
   #3 against the CPU, as phase 5's);
11. chunked attention: one GMA pair forward at 512^2, batch 2, with
   attn_chunk=1024 against dense (CLIP_REL), time and peak of both;
12. FlowPipeline on random weights, acc+raft and acc+gma, on HWC uint8
   frames at the Sintel size 436 x 1024: long_range on 7 frames against
   accflow_forward on the padded clip, pair_flow, occlusion, pairs with
   a warm start, 30 frames of stream(), each call's seconds; 12b:
   ArtifactPipeline on phase 9a's bf16 clip artifact against long_range
   on the batch it fills (ARTIFACT_REL);
13. the demo CLI in its own process (--mode long --ofe gma --no_viz, the
   7 frames as .bin files, phase 12's GMA weights as an .npz checkpoint):
   its .flo files against phase 12's long_range (CLIP_REL).
Optional phases: --tile-sweep builds kernels #1 and #2 with 4, 8 and 16
queries per block and times them in turns (#1 at the clip shape after phase
3, #2 at the stream shape after phase 4); --profile prints where
the device time of the clip forward (with fused and with
experimental:fused_bd, and with GMA) and of a stream push, eager and
graphed, goes (torch.profiler). A {"graphs": {...}} line holds the eager
and graphed medians, busy times, launches per replay and peaks, and the
artifacts' numbers, with the card's name and power limit; a {"gma": {...}}
line the numbers of phases 6c and 8's GMA runs and 10-13. The line before
the last is {"kernels": [...]}; the last line is {"ok": true, "device":
{...}}. Without a GPU, or without the package beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
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
    from accflow_tpu_torch import ArtifactPipeline, FlowPipeline, graphs, models, probes, serving
    from accflow_tpu_torch.api import _as_frames
    from accflow_tpu_torch.convert import (
        load_jax_params,
        load_npz_tree,
        save_npz_tree,
        to_jax_params,
    )
    from accflow_tpu_torch.data.synthetic import make_long_sequence, write_synthetic_cvor
    from accflow_tpu_torch.models import gma
    from accflow_tpu_torch.models.raft import gather_pairs, raft_cnet, to_nchw
    from accflow_tpu_torch.nn.layers import tf32
    from accflow_tpu_torch.ops import corr, corr_bd_cuda, corr_cuda, corr_level_cuda
    from accflow_tpu_torch.ops.occlusion import calc_occ_mask
    from accflow_tpu_torch.ops.padding import InputPadder
    from accflow_tpu_torch.probes import grid_sample_lookup, lookup_bound
    from accflow_tpu_torch.streaming import (
        StreamAccumulator,
        export_streaming,
        load_streaming_artifact,
        make_streaming_fns,
        save_streaming_artifact,
    )
    from accflow_tpu_torch.train.evaluate import evaluate_cvo
    from accflow_tpu_torch.utils.frame_io import read_flow
except ImportError as e:  # this file alone, outside the repository
    sys.exit(f"chip_smoke: run from the repository root ({e})")

LOOKUP_TOL = 1e-4            # kernel vs plain lookup, max abs (see check_lookup)
# A bfloat16 output is the kernel's float32 value rounded once to nearest
# even: it must equal the kernel's own float32 output cast bit for bit, and
# it may differ from the plain float32 value by the float32 bar plus that
# rounding, at most 2^-8 of the value (bfloat16 keeps 8 significant bits).
BF16_ROUND = 2.0 ** -8
SPIN_CYCLES = 2 * 10**8      # device_ms's first spin: ~0.1 s at the H100's 1.98 GHz
# Kernel #3 vs its plain twin. float32 inputs: max abs 1e-4; both sum the
# same float32 products over y in another order, ~1e-7 at |tmp| <= ~5.
# bfloat16 inputs: max abs 1e-3 x max |tmp|; the products of two bfloat16
# values are exact in float32, so the two differ by summation order only
# (~1e-7 relative), and the bar is relative because |tmp| scales with the maps.
Y_TOL_F32 = 1e-4
Y_REL_BF16 = 1e-3
# Phase 4b's split windows, bfloat16 vs float32 on the same bfloat16-valued
# levels, per element: |bf16 - f32| <= SPLIT_REL x A + 1e-6, A the window
# of |levels| (the sum of |products| under the non-negative tents). The
# bfloat16 path rounds wy, tmp, wx and the window once each, each by <= 2^-8
# relative (BF16_ROUND) with float32 sums, so <= 4 x 2^-8 x A to first
# order; the bar leaves one rounding more for the higher-order terms and the
# float32 sums' order. Fixed before the check's first run on the card (on
# the CPU at batch 2 the largest |bf16 - f32| / A was 1.19e-2).
SPLIT_REL = 5 * BF16_ROUND
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
# A loaded bfloat16 artifact (clip or stream) against the eager path on the
# same inputs and weights: max abs <= ARTIFACT_REL x the largest |flow|. The
# program runs the eager path's ops on weights stored in bfloat16, which the
# bfloat16 path casts them to at use anyway (the frozen norms' init values
# are exact in bfloat16); it differs only where serving.numerics differs
# from the eager switches: cuBLAS's bfloat16 GEMMs (the deformable conv's)
# reduce in float32, not in bfloat16 split-K partials. That moves a GEMM
# output by ~2^-8 of its size at most, and the flow by less; a wrong
# weight, op or lookup moves it everywhere. Fixed before the first run.
ARTIFACT_REL = 1e-3
REPO = Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "fixtures"
KERNELS = (corr_cuda, corr_level_cuda, corr_bd_cuda)  # each wrapper's `launches` count
TILES = (4, 8, 16)           # queries per block of kernels #1 and #2 tried by --tile-sweep; 8 ships
KINDS = (  # --profile: kind of a kernel, first match on its lower-cased name
    ("corr lookup (this port's kernels)", ("corr_window", "y_contract")),
    ("conv (cuDNN)", ("fprop", "implicit", "conv", "cudnn", "wgrad", "dgrad")),
    ("GEMM (cuBLAS: pyramid, GMA attention and aggregate, split lookup)",
     ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
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


def check_out(label: str, got, got32, ref, tol: float) -> float:
    """`got` (a kernel's output in float32 or bfloat16) against the plain
    float32 `ref`: max abs within `tol`, and for bfloat16 within `tol` +
    BF16_ROUND x |ref| at every element and bit-equal to the kernel's own
    float32 output `got32` cast. Returns the max abs difference."""
    diff = (got.float() - ref).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if got.dtype == torch.float32:
        if not err <= tol:
            fail(f"{label}: kernel disagrees with its plain version: {err} > {tol}")
        return err
    if not torch.equal(got.view(torch.int16), got32.to(torch.bfloat16).view(torch.int16)):
        fail(f"{label}: the bfloat16 output is not the float32 output cast bit for bit")
    if not bool((diff <= tol + BF16_ROUND * ref.abs()).all()):
        fail(f"{label}: kernel disagrees with its plain version beyond the bf16 rounding: {err}")
    return err


def out_name(dtype) -> str:
    return "f32 out" if dtype == torch.float32 else "bf16 out"


def check_lookup(label: str, kernel, levels32, coords, radius: int, beside=None,
                 out_dtypes=(torch.float32,)):
    """Phases 3 and 4: `kernel(levels, coords, out_dtype)` against the plain
    lookup at `radius`, for each of `out_dtypes` (float32 first), then its
    time beside the plain lookup's (with the same output type),
    F.grid_sample's, the bound (with that output type's bytes) and, when
    given, `beside(levels, coords, out_dtype)`'s (kernel #1 on the same
    inputs). Times
    are device times (device_ms); the kernel's `wall_ms` is the event timing
    of back-to-back calls, wrapper included. Both kernels share one
    fractional offset over a window's taps;
    the plain lookup recomputes x/2^l + (a - r) per tap, whose float32
    rounding (<= half an ulp of |x| <= ~100, i.e. <= 4e-6) times the maps'
    local slope (unit-normal values, |slope| <= ~8) stays below 1e-4.
    A bfloat16 output is held as check_out says. Rows are keyed by the
    levels' dtype, with ", bf16 out" for a bfloat16 output."""
    rows = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        levels = [lvl.to(dtype) for lvl in levels32]
        ref = corr.lookup_corr_plain(levels, coords, radius)
        lib_run, lib_result = grid_sample_lookup(levels, coords, radius)
        lib_err = float((lib_result() - ref).abs().max())
        library_ms = device_ms(lib_run, 10)
        got32 = None
        for out_dtype in out_dtypes:
            on = out_name(out_dtype)
            got = kernel(levels, coords, out_dtype)
            torch.cuda.synchronize()
            if out_dtype == torch.float32:
                got32 = got
            err = check_out(f"{label} {name} {on}", got, got32, ref, LOOKUP_TOL)
            print(f"{label} {name}, {on}: kernel vs plain max abs {err:.3e} (tol {LOOKUP_TOL:g}"
                  f"{'' if out_dtype == torch.float32 else ' + 2^-8 |plain|; bit-equal to the f32 output cast'}"
                  f"); grid_sample vs plain {lib_err:.3e}")
            ms = device_ms(lambda: kernel(levels, coords, out_dtype), 20)
            wall_ms = cuda_ms(lambda: kernel(levels, coords, out_dtype), 20)
            plain_ms = device_ms(
                lambda: corr.lookup_corr_plain(levels, coords, radius, out_dtype), 2)
            bound_ms, bound_by, nbytes = lookup_bound(levels, coords, radius,
                                                      torch.tensor([], dtype=out_dtype).element_size())
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms, wall_ms=wall_ms)
            extra = ""
            if beside is not None:
                row["corr_lookup_ms"] = device_ms(lambda: beside(levels, coords, out_dtype), 20)
                extra = f", kernel #1 {row['corr_lookup_ms']:.4f} ms"
            print(f"{label} {name}, {on}: kernel {ms:.4f} ms ({wall_ms:.4f} ms per call back to "
                  f"back), plain {plain_ms:.4f} ms, grid_sample {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B at 3.35 TB/s) = "
                  f"{100 * bound_ms / ms:.1f} % of bound{extra}")
            rows[name if out_dtype == torch.float32 else f"{name}, bf16 out"] = row
            del got
        del levels, ref, lib_run, lib_result, got32
    return rows


def check_y_contract(levels32, coords):
    """Phase 4b: kernel #3 at levels 0 and 1 of the clip shape: corr3 the
    level's unit-normal maps, wy the tent weights of the coords' y windows
    (what _level_window_bd gives it), float32 and bfloat16 in, float32 and
    bfloat16 out. The kernel against its plain twin (Y_TOL_F32, Y_REL_BF16;
    a bfloat16 output as check_out says), then device times of the kernel,
    the twin (same output type) and torch.bmm (the library yardstick, which
    writes the inputs' type) beside the bound (with the output type's
    bytes). Returns {level: {"<in dtype>[, bf16 out]": row}}."""
    rows = {}
    delta = torch.linspace(-4, 4, 9, device=coords.device)
    with tf32(False):
        for l in (0, 1):
            hl = levels32[l].shape[1]
            wy32 = corr.window_weights(coords[:, 1:2] / 2.0 ** l + delta, hl)
            for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                corr3, wy = levels32[l].to(dtype), wy32.to(dtype)
                path = corr_bd_cuda.path(corr_bd_cuda.load(corr_bd_cuda.build()[0]), corr3)
                ref = corr_bd_cuda.y_contract_plain(corr3, wy)
                lib_out = torch.bmm(wy, corr3)
                torch.cuda.synchronize()
                scale = float(ref.abs().max())
                tol = Y_TOL_F32 if dtype == torch.float32 else Y_REL_BF16 * scale
                lib_err = float((lib_out.float() - ref).abs().max())
                library_ms = device_ms(lambda: torch.bmm(wy, corr3), 20)
                got32 = None
                for out_dtype in (torch.float32, torch.bfloat16):
                    on = out_name(out_dtype)
                    label = f"kernel #3 level {l} {name}, {on}"
                    got = corr_bd_cuda.y_contract(corr3, wy, out_dtype)
                    torch.cuda.synchronize()
                    if out_dtype == torch.float32:
                        got32 = got
                    err = check_out(label, got, got32, ref, tol)
                    print(f"{label} ({path} path): kernel vs plain max "
                          f"abs {err:.3e} (tol {tol:.3e}, max |tmp| {scale:.3f}); torch.bmm vs "
                          f"plain {lib_err:.3e}")
                    ms = device_ms(lambda: corr_bd_cuda.y_contract(corr3, wy, out_dtype), 20)
                    wall_ms = cuda_ms(lambda: corr_bd_cuda.y_contract(corr3, wy, out_dtype), 20)
                    plain_ms = device_ms(
                        lambda: corr_bd_cuda.y_contract_plain(corr3, wy, out_dtype), 5)
                    bound_ms, bound_by, nbytes = probes.y_contract_bound(
                        corr3, torch.tensor([], dtype=out_dtype).element_size())
                    print(f"{label}: kernel {ms:.4f} ms ({wall_ms:.4f} ms per call back to "
                          f"back), plain {plain_ms:.4f} ms, torch.bmm {library_ms:.4f} ms, bound "
                          f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B at 3.35 TB/s) = "
                          f"{100 * bound_ms / ms:.1f} % of bound")
                    key = name if out_dtype == torch.float32 else f"{name}, bf16 out"
                    rows.setdefault(f"level{l}", {})[key] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms, wall_ms=wall_ms,
                        kernel_path=path)
                    del got
                del corr3, wy, got32, ref, lib_out
    return rows


def check_split_windows(levels32, coords) -> float:
    """Phase 4b, last: lookup_corr_split_v2 on bfloat16 levels at the clip
    shape, levels 0 and 1 through kernel #3 and 2 and 3 through torch.bmm
    (experimental:fused_bd2's split), every window bfloat16; against the
    same function in float32 (TF32 off, every level through torch.bmm) on
    the same levels as float32, under SPLIT_REL. Returns the largest
    |bf16 - f32| / A."""
    b, h, w = coords.shape[0] // 4096, 64, 64
    c4 = coords.view(b, h, w, 2)
    levels = [lvl.to(torch.bfloat16) for lvl in levels32]
    as_f32 = [lvl.float() for lvl in levels]
    with tf32(False):
        got = corr.lookup_corr_split_v2(levels, c4, 4, ("bd", "bd", "mm", "mm"), torch.bfloat16)
        ref = corr.lookup_corr_split_v2(as_f32, c4, 4, ("mm",), torch.float32)
        mag = corr.lookup_corr_split_v2([lvl.abs() for lvl in as_f32], c4, 4, ("mm",),
                                        torch.float32)
    torch.cuda.synchronize()
    worst = 0.0
    for l, (g, r, a) in enumerate(zip(got, ref, mag)):
        if g.dtype != torch.bfloat16 or g.shape != r.shape:
            fail(f"split windows level {l}: {g.dtype} {tuple(g.shape)}")
        diff = (g.float() - r).abs()
        ratio = float((diff / (a + 1e-6)).max())
        print(f"split windows level {l} (bf16, {'kernel #3' if l < 2 else 'torch.bmm'}) vs "
              f"float32: max abs {float(diff.max()):.3e}, max |diff| / A {ratio:.3e} "
              f"(bar {SPLIT_REL:.3e} x A + 1e-6; max A {float(a.max()):.3f})")
        if not bool((diff <= SPLIT_REL * a + 1e-6).all()):
            fail(f"split windows level {l}: bf16 differs from float32 beyond the bar ({ratio})")
        worst = max(worst, ratio)
    del levels, as_f32, got, ref, mag
    return worst


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


def tile_sweep(label: str, wrapper, run, levels32, coords, radius: int):
    """--tile-sweep: a lookup kernel (`wrapper`: ops/corr_cuda.py or
    ops/corr_level_cuda.py) built with each of TILES queries per block
    (its builds run in parallel), each launched as `run(lib, levels,
    out_dtype)`, checked against the plain lookup and timed (float32 and
    bfloat16 output) in the order 4, 8, 16, 16, 8, 4 so that a drift of the
    card's clock cancels."""
    with ThreadPoolExecutor(len(TILES)) as pool:
        built = list(pool.map(lambda qt: wrapper.build(f"-DCORR_QT={qt}"), TILES))
    libs = {}
    for qt, (path, log) in zip(TILES, built):
        libs[qt] = wrapper.load(path)
        regs = [m.strip() for m in log.splitlines() if "registers" in m]
        print(f"tile sweep {label}: built QT={qt} {regs}")
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        levels = [lvl.to(dtype) for lvl in levels32]
        ref = corr.lookup_corr_plain(levels, coords, radius)
        for out_dtype in (torch.float32, torch.bfloat16):
            times = {qt: [] for qt in TILES}
            for qt in (*TILES, *reversed(TILES)):
                got = run(libs[qt], levels, out_dtype)
                err = float((got.float() - ref).abs().max())
                if not err <= LOOKUP_TOL + BF16_ROUND * float(ref.abs().max()):
                    fail(f"tile sweep {label}: QT={qt} disagrees with the plain lookup "
                         f"({name}): {err}")
                times[qt].append(device_ms(lambda: run(libs[qt], levels, out_dtype), 20))
            print(f"tile sweep {label} {name} levels, {out_name(out_dtype)}: " + "; ".join(
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


def perturb_gamma(model, seed: int) -> None:
    """GMA's aggregator starts with gamma = 0, which switches its global
    motion branch off; draw it from `seed`, U(2, 4), so the run aggregates."""
    gen = torch.Generator().manual_seed(seed)
    gamma = model.update_block.aggregator.gamma
    with torch.no_grad():
        gamma.copy_(torch.rand(gamma.shape, generator=gen) * 2 + 2)


def clip_inputs(t: int = 7, n: int = 2, size: int = 512):
    """The clip path's accumulator (AccFlow hidden 128, bf16, seed 1, its
    ZeroConv drawn from seed 2) and frames (uniform in [-1, 1] from seed 0),
    on the card."""
    acc = models.init_accflow(models.AccFlowConfig(compute_dtype="bfloat16"), seed=1,
                              device="cpu")
    perturb_zero_conv(acc, 2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.empty((t, n, size, size, 3), device="cuda").uniform_(-1, 1, generator=gen)
    return acc.to("cuda"), images


def gma_estimator(**kw):
    """GMA from seed 0 on the card, bf16 unless told, gamma from seed 3."""
    kw.setdefault("compute_dtype", "bfloat16")
    est = models.build_flow_estimator("gma", seed=0, **kw)
    perturb_gamma(est.model, 3)
    return est


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


def kernel_names(kernel) -> tuple:
    """Substrings of the CUDA kernel names a wrapper launches (KINDS)."""
    return ("y_contract",) if kernel is corr_bd_cuda else ("corr_window",)


def replay_profile(fn, kernel):
    """One call of `fn` (a CUDA graph's replay, which launches nothing
    through the wrappers' counters) under torch.profiler: (device busy ms,
    launches of `kernel`'s CUDA kernel, all kernel launches)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof, 1)
    ours = sum(count for _, count, name in rows if any(k in name for k in kernel_names(kernel)))
    return sum(r[0] for r in rows), ours, sum(r[1] for r in rows)


def timed_runs(fn, reps: int):
    """`reps` calls of `fn`, each synchronised: (seconds each, last output)."""
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs, out


def graphed_clip(label: str, serve, images, eager_out, kernel, per_forward: int) -> dict:
    """Phase 5b: `serve` (the eager clip function) through graphs.CudaGraphed:
    the first call warms up and captures (timed apart), then 2 warm-up and 5
    timed replays. The wrappers count the warm-ups' and the capture's
    launches and none in the replays; a profile of one replay counts
    `per_forward` launches of `kernel`'s CUDA kernel. The output against the
    eager forward's on the same inputs: the same kernels, so bit-equal is
    expected; held within CLIP_REL of the largest |flow|."""
    run = graphs.CudaGraphed(serve)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    capture_s, _ = timed_runs(lambda: run(images), 1)
    expected = per_forward * (graphs.WARMUP + 1)
    expect_counts(f"{label}, warm-up and capture", kernel, expected)
    timed_runs(lambda: run(images), 2)
    secs, out = timed_runs(lambda: run(images), 5)
    expect_counts(f"{label}, after 7 replays (none counted)", kernel, expected)
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()
    busy, ours, total = replay_profile(lambda: run(images), kernel)
    if ours != per_forward:
        fail(f"{label}: the profile of one replay saw {ours} launches of the lookup kernel, "
             f"expected {per_forward}")
    if tuple(out.shape) != tuple(eager_out.shape) or not bool(torch.isfinite(out).all()):
        fail(f"{label}: output {tuple(out.shape)} or not finite")
    diff, flow_max = float((out - eager_out).abs().max()), float(eager_out.abs().max())
    if not diff <= CLIP_REL * flow_max:
        fail(f"{label}: graphed differs from eager by {diff:.3e} > {CLIP_REL} x {flow_max:.3e}")
    med = statistics.median(secs)
    frames = images.shape[0] * images.shape[1]
    print(f"{label}: median {med * 1e3:.2f} ms per forward (runs "
          f"{', '.join(f'{t * 1e3:.2f}' for t in secs)} ms) = {frames / med:.3f} frames/s; "
          f"first call (2 warm-ups + capture) {capture_s[0]:.2f} s; one replay: device busy "
          f"{busy:.2f} ms, {total} kernels, {ours} lookup launches; vs eager max abs {diff:.3e} "
          f"({'bit-equal' if diff == 0 else 'not bit-equal'}; bar {CLIP_REL:g} x {flow_max:.3e}); "
          f"peak memory {peak / 2**30:.3f} GiB, reserved {reserved / 2**30:.3f} GiB")
    return dict(median_ms=med * 1e3, frames_per_s=frames / med, capture_s=capture_s[0],
                busy_ms=busy, kernels_per_replay=total, launches_per_replay=ours,
                max_abs_vs_eager=diff, peak_gib=peak / 2**30, reserved_gib=reserved / 2**30)


def check_artifact(label: str, got, ref) -> float:
    """A loaded artifact's outputs `got` against the eager path's `ref`
    under ARTIFACT_REL; returns the max abs difference."""
    diff, flow_max = float((got - ref).abs().max()), float(ref.abs().max())
    print(f"{label}: vs eager max abs {diff:.3e} (bar {ARTIFACT_REL:g} x |flow| max "
          f"{flow_max:.3e} = {ARTIFACT_REL * flow_max:.3e})")
    if not bool(torch.isfinite(got).all()) or not diff <= ARTIFACT_REL * flow_max:
        fail(f"{label}: the artifact differs from eager by {diff:.3e}")
    return diff


def clip_artifact(est, acc, images, eager_out, tmp: str) -> dict:
    """Phase 9a: the clip exported at full width with bfloat16 weights
    (serving.export_serving), saved, loaded for the card
    (serving.load_artifact: a CUDA graph of the program) and run on the
    clip path's images: export, save and load seconds, the file's size,
    the first call (warm-ups and capture) and 5 timed calls, and the flows
    against the eager forward's (ARTIFACT_REL)."""
    path = str(Path(tmp) / "clip_bf16.pt2")
    t0 = time.perf_counter()
    exported = serving.export_serving(est, acc, tuple(images.shape), weights_dtype="bfloat16")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serving.save_artifact(exported, path)
    save_s = time.perf_counter() - t0
    del exported
    t0 = time.perf_counter()
    fn = serving.load_artifact(path)
    load_s = time.perf_counter() - t0
    reset_counts()
    first, _ = timed_runs(lambda: fn(images), 1)
    expect_counts("clip artifact, warm-up and capture", corr_cuda, 12 * (graphs.WARMUP + 1))
    secs, out = timed_runs(lambda: fn(images), 5)
    diff = check_artifact("clip artifact (bf16 weights, 7x512^2, batch 2)", out, eager_out)
    del fn
    gc.collect()  # a loaded program's fx graph modules are reference cycles holding its weights
    med = statistics.median(secs)
    size = Path(path).stat().st_size
    print(f"clip artifact: export {export_s:.2f} s, save {save_s:.2f} s, {size / 1e6:.1f} MB, "
          f"load {load_s:.2f} s, first call {first[0]:.2f} s, median {med * 1e3:.2f} ms per "
          f"forward ({14 / med:.3f} frames/s)")
    return dict(export_s=export_s, save_s=save_s, load_s=load_s, mb=size / 1e6,
                first_call_s=first[0], median_ms=med * 1e3, max_abs_vs_eager=diff)


def clip_path(with_profile: bool, tmp: str):
    """Phase 5: the clip forward at full size (and --profile's breakdown of
    it), one eager forward under the sync debug mode "error", the same clip
    graphed (5b) and as a loaded artifact (9a), the clip with the split
    lookup, then the small GPU-vs-CPU clip. Returns (kernel #1 launches,
    frames/s, kernel #3 launches, frames/s with fused_bd, the small clip's
    GPU launches by lookup, {"graphed": ..., "artifact": ...})."""
    t, n, size = 7, 2, 512
    acc, images = clip_inputs(t, n, size)
    shape = (t - 2, n, size, size, 2)
    est = models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0)
    pairs = est.pairs_fn(iters=acc.cfg.ofe_iters)

    def forward():
        return models.accflow_forward(acc, images, pairs)

    launches, med, _, out, eager_peak = time_clip("clip path", forward, corr_cuda, shape)
    fps = n * t / med
    if with_profile:
        profile_forward(forward, med * 1e3)
    sync_free("clip path: one eager forward", forward)
    torch.cuda.empty_cache()
    extra = {"graphed": graphed_clip("clip path, graphed", serving.build_serving_fn(est, acc),
                                     images, out, corr_cuda, 12)}
    extra["graphed"]["eager_median_ms"], extra["graphed"]["eager_peak_gib"] = (
        med * 1e3, eager_peak / 2**30)
    print(f"clip path, same process on {smi('name,power.limit')}: eager median {med * 1e3:.2f} ms "
          f"({fps:.3f} frames/s, peak {eager_peak / 2**30:.3f} GiB), graphed "
          f"{extra['graphed']['median_ms']:.2f} ms ({extra['graphed']['frames_per_s']:.3f} "
          f"frames/s, peak {extra['graphed']['peak_gib']:.3f} GiB)")
    torch.cuda.empty_cache()
    extra["artifact"] = clip_artifact(est, acc, images, out, tmp)
    del est, pairs
    torch.cuda.empty_cache()

    est_bd = models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0,
                                         corr_lookup="experimental:fused_bd")
    pairs_bd = est_bd.pairs_fn(iters=acc.cfg.ofe_iters)

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
    small = small_clip()
    return launches, fps, launches_bd, fps_bd, small, extra


def sync_free(label: str, fn) -> None:
    """`fn` once under torch.cuda.set_sync_debug_mode("error"): it fails on
    any host synchronisation (a pageable host copy among them), which a
    CUDA graph's capture could not hold."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"{label} under the sync debug mode 'error': no host synchronisation")


def small_clip(ofe: str = "raft") -> dict:
    """A 4-frame 64^2 clip in float32, TF32 off, with the same seeds (and,
    with ofe="gma" in phase 10b, GMA's gamma from seed 3): on the
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
    bilinear taps by kernel #1 and as tent contractions by kernel #3).
    Returns each lookup's kernel launches on the GPU (float32 outputs)."""
    clip = np.random.default_rng(3).uniform(-1, 1, (4, 1, 64, 64, 3)).astype(np.float32)
    outs, launches = {}, {}
    for lookup, kernel in (("fused", corr_cuda), ("experimental:fused_bd", corr_bd_cuda)):
        for where in ("cuda", "cpu"):
            est = models.build_flow_estimator(ofe, compute_dtype="float32", device=where,
                                              seed=0, corr_lookup=lookup)
            if ofe == "gma":
                perturb_gamma(est.model, 3)
            cfg = models.AccFlowConfig(compute_dtype="float32")
            acc = models.init_accflow(cfg, seed=1, device="cpu")
            perturb_zero_conv(acc, 2)
            reset_counts()
            with tf32(False):
                outs[lookup, where] = models.accflow_forward(
                    acc.to(where), clip, est.pairs_fn()).cpu().numpy()
            n = expect_counts(f"small clip {ofe} {lookup} on {where}", kernel,
                              12 if where == "cuda" else 0)
            if where == "cuda":
                launches[lookup] = n
    for a, b in ((("fused", "cuda"), ("fused", "cpu")),
                 (("experimental:fused_bd", "cuda"), ("experimental:fused_bd", "cpu")),
                 (("experimental:fused_bd", "cuda"), ("fused", "cuda"))):
        diff = float(np.abs(outs[a] - outs[b]).max())
        flow_max = float(np.abs(outs[b]).max())
        tol = CLIP_REL * flow_max
        print(f"small clip {ofe} {a[0]} on {a[1]} vs {b[0]} on {b[1]}: max abs {diff:.3e}, "
              f"|flow| max {flow_max:.3e} (tol {CLIP_REL:g} x |flow| max = {tol:.3e})")
        if not flow_max > 0 or not np.isfinite(outs[a]).all():
            fail(f"small clip {ofe}: the flow is zero or not finite, nothing to compare")
        if not diff <= tol:
            fail(f"small clip {ofe}: {a} and {b} differ by {diff:.3e} > {tol:.3e}")
    return launches


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


def stream_path(label: str, small: bool, with_profile: bool, tmp=None, ofe: str = "raft",
                bit_equal: bool = False) -> dict:
    """Phase 6: scripts/bench_stream.py's stream6 protocol: 512^2, batch 2,
    bf16 compute, 6 OFE iterations per step, AccFlow hidden 128 with its
    ZeroConv perturbed; reset on 3 frames, 2 warm-up pushes, 30 timed
    pushes (host clock around each push, synchronised), first eagerly
    (make_streaming_fns' pair, the counters counting every launch), then one
    eager push under the sync debug mode "error", then graphed
    (StreamAccumulator: the first push warms up and captures, timed apart;
    the counters count those launches and none in the replays; a profile of
    one replay counts the kernel's launches) on the same frames, each push
    held against the eager one (the same kernels: bit-equal expected, held
    within CLIP_REL of the largest |flow|). With `tmp`, phase 9b: the
    stream exported with bfloat16 weights, saved, loaded for the card and
    run on the same frames (ARTIFACT_REL). ofe="gma" (stream (c), phase
    6c) runs GMA with its gamma from seed 3; bit_equal fails the phase
    unless every graphed push equals the eager one bit for bit. Returns the
    numbers."""
    n, size, warm, timed, iters = 2, 512, 2, 30, 6
    kernel = corr_level_cuda if small else corr_cuda
    est = models.build_flow_estimator(ofe, compute_dtype="bfloat16", small=small,
                                      iters=iters, seed=0)
    if ofe == "gma":
        perturb_gamma(est.model, 3)
    acc = models.init_accflow(models.AccFlowConfig(compute_dtype="bfloat16", warm_start=True),
                              seed=1, device="cpu")
    perturb_zero_conv(acc, 2)
    acc = acc.to("cuda")
    init, step = make_streaming_fns(est, acc)
    frames = moving_frames(3 + warm + timed, n, size, seed=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, state = init(frames[:3])
    for i in range(3, 3 + warm):
        out, state = step(state, frames[i])
    torch.cuda.synchronize()
    before = kernel.launches
    secs, eager_outs = [], []
    for i in range(3 + warm, 3 + warm + timed):
        t0 = time.perf_counter()
        out, state = step(state, frames[i])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        eager_outs.append(out)
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
    print(f"stream {label}, eager: output {tuple(out.shape)} finite, |flow| mean "
          f"{float(out.abs().mean()):.4f}; {in_timed} launches in {timed} pushes "
          f"({in_timed / timed:g} per push; {launches} with reset and warm-up); median "
          f"{med:.3f} ms per push (min {min(secs) * 1e3:.3f}, max {max(secs) * 1e3:.3f}) = "
          f"{fps:.3f} frames/s; peak memory {peak / 2**30:.3f} GiB; "
          f"after the runs: SM clock, power, temperature {clocks}")
    sync_free(f"stream {label}: one eager push", lambda: step(state, frames[3]))
    if with_profile:
        replay = itertools.cycle(frames[3:])
        profile_forward(lambda: step(state, next(replay)), med)

    sa = StreamAccumulator(est, acc)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sa.reset(frames[:3])
    capture_s, _ = timed_runs(lambda: sa.push(frames[3]), 1)
    for i in range(4, 3 + warm):
        sa.push(frames[i])
    g_secs, diffs = [], []
    for j, i in enumerate(range(3 + warm, 3 + warm + timed)):
        t0 = time.perf_counter()
        g_out = sa.push(frames[i])
        torch.cuda.synchronize()
        g_secs.append(time.perf_counter() - t0)
        diffs.append(float((g_out - eager_outs[j]).abs().max()))
    expect_counts(f"stream {label}, graphed (reset, warm-ups and capture; replays uncounted)",
                  kernel, 2 * iters + (graphs.WARMUP + 1) * iters)
    g_peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()
    busy, ours, total = replay_profile(lambda: sa.push(frames[3]), kernel)
    if ours != iters:
        fail(f"stream {label}: the profile of one replay saw {ours} lookup launches, "
             f"expected {iters}")
    diff, flow_max = max(diffs), max(float(o.abs().max()) for o in eager_outs)
    if not diff <= CLIP_REL * flow_max or (bit_equal and diff != 0):
        fail(f"stream {label}: graphed pushes differ from eager by {diff:.3e}")
    g_med = statistics.median(g_secs) * 1e3
    g_fps = n * timed / sum(g_secs)
    print(f"stream {label}, graphed: median {g_med:.3f} ms per push (min "
          f"{min(g_secs) * 1e3:.3f}, max {max(g_secs) * 1e3:.3f}) = {g_fps:.3f} frames/s; first "
          f"push (2 warm-ups + capture) {capture_s[0]:.2f} s; one replay: device busy "
          f"{busy:.3f} ms, {total} kernels, {ours} lookup launches; vs eager over {timed} "
          f"pushes max abs {diff:.3e} ({'bit-equal' if diff == 0 else 'not bit-equal'}; bar "
          f"{CLIP_REL:g} x {flow_max:.3e}); peak memory {g_peak / 2**30:.3f} GiB, reserved "
          f"{reserved / 2**30:.3f} GiB")
    if with_profile:
        replay = itertools.cycle(frames[3:])
        profile_forward(lambda: sa.push(next(replay)), g_med)
    row = dict(eager_median_ms=med, eager_frames_per_s=fps, eager_peak_gib=peak / 2**30,
               median_ms=g_med, frames_per_s=g_fps, capture_s=capture_s[0], busy_ms=busy,
               kernels_per_replay=total, launches_per_replay=ours, max_abs_vs_eager=diff,
               peak_gib=g_peak / 2**30, reserved_gib=reserved / 2**30, launches=launches)
    del sa
    torch.cuda.empty_cache()
    if tmp is not None:
        row["artifact"] = stream_artifact(est, acc, frames, eager_outs, tmp, warm)
    del est, acc, frames, out, state, eager_outs
    torch.cuda.empty_cache()
    return row


def stream_artifact(est, acc, frames, eager_outs, tmp: str, warm: int) -> dict:
    """Phase 9b: the stream exported at its shape with bfloat16 weights
    (streaming.export_streaming), saved, loaded for the card
    (load_streaming_artifact: the step program replayed from a CUDA graph),
    reset on the same 3 frames and pushed the same frames: export, save and
    load seconds, size, the timed pushes' median, and each timed push
    against the eager one (ARTIFACT_REL)."""
    path = str(Path(tmp) / "stream_bf16.bin")
    t0 = time.perf_counter()
    programs = export_streaming(est, acc, tuple(frames.shape[1:4]), weights_dtype="bfloat16")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_streaming_artifact(path, *programs)
    save_s = time.perf_counter() - t0
    del programs
    t0 = time.perf_counter()
    art = load_streaming_artifact(path)
    load_s = time.perf_counter() - t0
    art.reset(frames[:3])
    for i in range(3, 3 + warm):
        art.push(frames[i])
    secs, outs = [], []
    for i in range(3 + warm, frames.shape[0]):
        t0 = time.perf_counter()
        outs.append(art.push(frames[i]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    diff = check_artifact(f"stream artifact (bf16 weights, {tuple(frames.shape[1:4])}, "
                          f"{len(outs)} pushes)", torch.stack(outs), torch.stack(eager_outs))
    del art
    gc.collect()
    med = statistics.median(secs) * 1e3
    size = Path(path).stat().st_size
    print(f"stream artifact: export {export_s:.2f} s, save {save_s:.2f} s, {size / 1e6:.1f} MB, "
          f"load {load_s:.2f} s, median {med:.3f} ms per push")
    return dict(export_s=export_s, save_s=save_s, load_s=load_s, mb=size / 1e6,
                median_ms=med, max_abs_vs_eager=diff)


def drift_run(where: str, seq, graphed: bool = True):
    """The fixture's stream on `where`, float32, TF32 off: outputs F_{i,0}
    for i = 2..35 as (34, 64, 64, 2) numpy, through StreamAccumulator (on
    the card a CUDA graph of the step) or, with graphed=False, through
    make_streaming_fns' eager pair."""
    est = models.build_flow_estimator("raft", compute_dtype="float32", small=True, iters=6,
                                      device=where)
    load_jax_params(est.model, load_npz_tree(str(FIXTURES / "drift_small_ofe.npz")))
    acc = models.init_accflow(models.AccFlowConfig(hidden=64, compute_dtype="float32",
                                                   warm_start=True), device=where)
    load_jax_params(acc, load_npz_tree(str(FIXTURES / "drift_small_acc.npz")))
    imgs = torch.from_numpy((2.0 * (seq["imgs"].astype(np.float32) / 255.0) - 1.0)[:, None])
    imgs = imgs.to(where)
    with tf32(False):
        if graphed:
            sa = StreamAccumulator(est, acc)
            outs = [sa.reset(imgs[:3])] + [sa.push(imgs[i]) for i in range(3, imgs.shape[0])]
        else:
            init, step = make_streaming_fns(est, acc)
            out, state = init(imgs[:3])
            outs = [out]
            for i in range(3, imgs.shape[0]):
                out, state = step(state, imgs[i])
                outs.append(out)
    return torch.stack(outs)[:, 0].cpu().numpy()


def drift_fixture():
    """Phase 7: the trained RAFT-small (6 iterations) + hidden-64
    accumulator streamed over the fixture's 36-frame sequence on the GPU
    (kernel #2), eagerly and graphed (StreamAccumulator), and on the CPU
    (plain lookup). The graphed stream against the eager one: the same
    kernels, bit-equal expected, held within DRIFT_REL of the largest
    |flow| over all 34 outputs.

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
    gpu = drift_run("cuda", seq, graphed=False)
    launches = expect_counts("drift fixture on the GPU", corr_level_cuda, 12 + 33 * 6)
    reset_counts()
    graphed = drift_run("cuda", seq)
    expect_counts("drift fixture on the GPU, graphed (reset, warm-ups and capture)",
                  corr_level_cuda, 12 + (graphs.WARMUP + 1) * 6)
    g_diff = float(np.abs(graphed - gpu).max())
    print(f"drift fixture GPU graphed vs eager, 34 outputs: max abs {g_diff:.3e} "
          f"({'bit-equal' if g_diff == 0 else 'not bit-equal'}; bar {DRIFT_REL:g} x |flow| max)")
    if not g_diff <= DRIFT_REL * float(np.abs(gpu).max()):
        fail(f"drift fixture: the graphed stream differs from the eager one by {g_diff:.3e}")
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
    acc|raft with fused, fused_bd and fused_bd2, direct|raft with fused
    and fused_bd, and acc|gma and direct|gma with fused, batch 10
    (micro-batch 5), 12 iterations, bfloat16, RAFT and GMA from seed 0
    (GMA's gamma from seed 3) and AccFlow from seed 1 with its ZeroConv
    perturbed. Returns {(model, lookup): row}."""
    clips, batch, n_batches = 10, 10, 1
    acc = models.init_accflow(models.AccFlowConfig(compute_dtype="bfloat16"), seed=1,
                              device="cpu")
    perturb_zero_conv(acc, 2)
    acc_tree = to_jax_params(acc)
    gma_est = models.build_flow_estimator("gma", seed=0, device="cpu")
    perturb_gamma(gma_est.model, 3)
    gma_tree = to_jax_params(gma_est.model)
    del acc, gma_est
    runs = (("acc|raft", "fused", corr_cuda, 24), ("acc|raft", "experimental:fused_bd", corr_bd_cuda, 24),
            ("acc|raft", "experimental:fused_bd2", corr_bd_cuda, 48),
            ("direct|raft", "fused", corr_cuda, 24),
            ("direct|raft", "experimental:fused_bd", corr_bd_cuda, 24),
            ("acc|gma", "fused", corr_cuda, 24), ("direct|gma", "fused", corr_cuda, 24))
    rows = {}
    print(f"eval: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated before its runs "
          "(earlier phases' tensors; in each run's peak)")
    with tempfile.TemporaryDirectory() as tmp:
        root = str(Path(tmp) / "cvor")
        t0 = time.perf_counter()
        write_synthetic_cvor(root, num_train=0, num_test=clips, h=512, w=512)
        print(f"eval: wrote {clips} synthetic CVOR clips of 512^2 in "
              f"{time.perf_counter() - t0:.2f} s")

        def run(model, lookup):
            return evaluate_cvo(model, root, batch=batch, iters=12, compute_dtype="bfloat16",
                                corr_lookup=lookup, acc_params=acc_tree, device="cuda",
                                params=gma_tree if "gma" in model else None,
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
        if lookup == "fused":  # the GMA runs have no split-lookup twin here
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


def attention_parts(est, images) -> dict:
    """Phase 10, the attention's pieces at the GMA clip's shapes, each
    timed alone (device_ms): the similarity of the 12 unique source images
    (6 source frames x batch 2; (12, 4096, 4096) float32, TF32 on bf16
    values), the float32 softmax, its cast to bf16, the gather to the 22
    pairs, and one iteration's aggregate GEMM (22 x 4096 x 4096 bf16 by
    (4096, 128) bf16, float32 reductions), each beside its byte bound
    (inputs read once, the output written once, at 3.35 TB/s)."""
    model = est.model
    t, n = images.shape[:2]
    sel = [s - 1 for s in tuple(range(2, t)) * 2 + (1,)]  # the clip's 11 pair queries
    with torch.no_grad(), tf32(False):
        _, inp = raft_cnet(model, to_nchw(images[1:].reshape(-1, *images.shape[2:]),
                                          torch.bfloat16))  # source frames 1 .. t-1
        q, k = (gma._heads(x, 1).float() for x in model.att.to_qk(inp).split(128, dim=1))
        sim = gma._similarity(q, k, True)
        soft = torch.softmax(sim, dim=-1)
        attn = soft.to(torch.bfloat16)
        attn_p = gather_pairs(attn, sel, n)
        v = torch.randn((attn_p.shape[0], 1, attn_p.shape[-1], 128), device="cuda",
                        dtype=torch.bfloat16)
        hw = sim.shape[-1]

        def aggregate_gemm():
            with corr._float32_reduction():
                return torch.matmul(attn_p, v)

        rows = {}
        for name, fn, nbytes in (
                ("similarity", lambda: gma._similarity(q, k, True),
                 q.numel() * 4 * 2 + sim.numel() * 4),
                ("softmax", lambda: torch.softmax(sim, dim=-1), sim.numel() * 8),
                ("cast to bf16", lambda: soft.to(torch.bfloat16), sim.numel() * 6),
                ("gather to the pairs", lambda: gather_pairs(attn, sel, n), attn_p.numel() * 4),
                ("aggregate GEMM, one iteration", aggregate_gemm,
                 attn_p.numel() * 2 + v.numel() * 4)):
            ms = device_ms(fn, 5)
            rows[name] = dict(ms=ms, bound_ms=nbytes / 3.35e9)
            print(f"GMA attention, {name}: {ms:.4f} ms, byte bound {nbytes / 3.35e9:.4f} ms "
                  f"({nbytes} B)")
        print(f"GMA attention: {len(sel) * n} pairs of {hw} queries from {q.shape[0]} source "
              f"images; per clip forward: similarity + softmax + cast + gather "
              f"{sum(rows[k]['ms'] for k in list(rows)[:4]):.3f} ms once, aggregate GEMM "
              f"12 x {rows['aggregate GEMM, one iteration']['ms']:.4f} ms")
    del sim, soft, attn, attn_p, v, q, k, inp
    torch.cuda.empty_cache()
    return rows


def gma_clip_path(with_profile: bool) -> dict:
    """Phase 10: AccFlow+GMA on the CVO-6 protocol at full width, the clip
    path's frames and accumulator (7 x 512^2, batch 2, 11 pair queries, 12
    iterations, bf16, dense attention: GMAConfig's attn_chunk 0), GMA from
    seed 0 with its gamma from seed 3: 2 warm-up and 5 timed eager forwards
    (12 kernel-#1 launches each, output checked, peak memory), --profile's
    breakdown, one eager forward under the sync debug mode "error", then the
    same clip graphed (graphed_clip: 2 warm-up and 5 timed replays, the
    output against eager), then the attention's pieces (attention_parts).
    Returns the numbers."""
    t, n, size = 7, 2, 512
    acc, images = clip_inputs(t, n, size)
    est = gma_estimator()
    pairs = est.pairs_fn(iters=12)

    def forward():
        return models.accflow_forward(acc, images, pairs)

    launches, med, _, out, peak = time_clip("GMA clip", forward, corr_cuda, (t - 2, n, size,
                                                                              size, 2))
    if with_profile:
        profile_forward(forward, med * 1e3)
    sync_free("GMA clip: one eager forward", forward)
    torch.cuda.empty_cache()
    graphed = graphed_clip("GMA clip, graphed", serving.build_serving_fn(est, acc), images, out,
                           corr_cuda, 12)
    torch.cuda.empty_cache()
    parts = attention_parts(est, images)
    print(f"GMA clip, same process on {smi('name,power.limit')}: eager median {med * 1e3:.2f} ms "
          f"({n * t / med:.3f} frames/s, peak {peak / 2**30:.3f} GiB), graphed "
          f"{graphed['median_ms']:.2f} ms ({graphed['frames_per_s']:.3f} frames/s, busy "
          f"{graphed['busy_ms']:.2f} ms, peak {graphed['peak_gib']:.3f} GiB)")
    del est, pairs, acc, images, out
    torch.cuda.empty_cache()
    return dict(eager_median_ms=med * 1e3, eager_frames_per_s=n * t / med,
                eager_peak_gib=peak / 2**30, launches=launches, graphed=graphed,
                attention=parts)


def chunked_attention() -> dict:
    """Phase 11: one GMA pair forward (final only) at 512^2, batch 2, 12
    iterations, bf16, with attn_chunk=1024 (four chunks of query rows
    recomputed at every aggregate) against dense attention (attn_chunk 0),
    the same weights and images: 2 warm-up and 5 timed calls each, peak
    memory each, and the flows within CLIP_REL of the largest |flow| (each
    row's softmax sees every key in both; they differ by the GEMMs'
    summation order over row blocks, then bf16 rounding)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    i1, i2 = torch.empty((2, 2, 512, 512, 3), device="cuda").uniform_(-1, 1, generator=gen)
    rows, outs = {}, {}
    for chunk in (0, 1024):
        est = gma_estimator(attn_chunk=chunk)

        def fwd():
            return est.forward(i1, i2, final_only=True)["flow_up"]

        timed_runs(fwd, 2)
        torch.cuda.reset_peak_memory_stats()
        secs, outs[chunk] = timed_runs(fwd, 5)
        rows[chunk] = dict(median_ms=statistics.median(secs) * 1e3,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del est
        torch.cuda.empty_cache()
    diff, flow_max = float((outs[1024] - outs[0]).abs().max()), float(outs[0].abs().max())
    print(f"GMA pair forward 512^2 batch 2: dense {rows[0]['median_ms']:.2f} ms (peak "
          f"{rows[0]['peak_gib']:.3f} GiB), attn_chunk=1024 {rows[1024]['median_ms']:.2f} ms "
          f"(peak {rows[1024]['peak_gib']:.3f} GiB); chunked vs dense max abs {diff:.3e} (bar "
          f"{CLIP_REL:g} x |flow| max {flow_max:.3e})")
    if not flow_max > 0 or not diff <= CLIP_REL * flow_max:
        fail(f"chunked attention differs from dense by {diff:.3e}")
    return dict(dense=rows[0], chunk1024=rows[1024], max_abs=diff, flow_max=flow_max)


def sintel_frames(t: int, seed: int) -> np.ndarray:
    """(t, 436, 1024, 3) uint8 HWC frames at the Sintel size (not /8
    divisible in height): moving_frames at 1024^2, the top 436 rows."""
    f = moving_frames(t, 1, 1024, seed)[:, 0, :436]
    return ((f + 1) * 127.5).round().clamp(0, 255).to(torch.uint8).cpu().numpy()


def api_call(label: str, fn, reps: int = 2):
    """`reps` calls of fn (the first warms up); prints and returns (seconds
    of the last, its output)."""
    secs, out = timed_runs(fn, reps)
    print(f"FlowPipeline {label}: {secs[-1] * 1e3:.2f} ms per call (first {secs[0] * 1e3:.2f})")
    return secs[-1], out


def pipeline_phase(tmp: str, graphed_clip_ms: float) -> dict:
    """Phase 12: FlowPipeline.from_checkpoint("acc+raft") and ("acc+gma")
    on random weights (seeds 0 and 1, the ZeroConv from seed 2, GMA's gamma
    from seed 3), bf16, 12 iterations, corr_lookup "auto" and attn_chunk -1
    (resolved per shape), on HWC uint8 frames at the Sintel size 436 x 1024
    (padded to 440 x 1024): long_range on 7 frames against accflow_forward
    on the padded clip, cropped (the same ops: bit-equal expected, held
    within CLIP_REL of the largest |flow|); pair_flow against pairs()' first
    (cold) flow; occlusion against the estimator's batched two-direction
    solve and calc_occ_mask of it; pairs(warm_start=True) over the 7
    frames; 30 frames of stream() (a CUDA graph per push). Each call's
    seconds (the second call), beside the graphed clip's. Then phase 12b:
    ArtifactPipeline on the clip path's bf16 artifact (7 x 512^2, batch 2),
    fed one batch of uint8 frames, which it fills to two, against the RAFT
    pipeline's long_range on that filled batch (ARTIFACT_REL). Returns the numbers and, for the demo
    phase, the GMA pipeline's long_range and its frames."""
    frames = sintel_frames(30, seed=6)
    clip7 = frames[:7]
    rows, keep = {}, {}
    for name in ("acc+raft", "acc+gma"):
        pipe = FlowPipeline.from_checkpoint(name)
        perturb_zero_conv(pipe.acc, 2)
        if "gma" in name:
            perturb_gamma(pipe.est.model, 3)
        row = {}
        reset_counts()
        row["long_range_s"], lr = api_call(f"{name} long_range, 7 frames",
                                           lambda: pipe.long_range(clip7))
        expect_counts(f"FlowPipeline {name} long_range (2 calls)", corr_cuda, 24)
        padder = InputPadder((7, 1, 436, 1024, 3))
        padded = padder.pad_np(_as_frames(clip7, False, "many")[0])
        ref = padder.unpad(models.accflow_forward(pipe.acc, padded, pipe.est.pairs_fn(iters=12)))
        ref = ref[:, 0].float().cpu().numpy()
        diff, flow_max = float(np.abs(lr - ref).max()), float(np.abs(ref).max())
        print(f"FlowPipeline {name} long_range vs accflow_forward on the padded clip: max abs "
              f"{diff:.3e} ({'bit-equal' if diff == 0 else 'not bit-equal'}; bar {CLIP_REL:g} x "
              f"{flow_max:.3e}); output {lr.shape}")
        if lr.shape != (5, 436, 1024, 2) or not flow_max > 0 or not diff <= CLIP_REL * flow_max:
            fail(f"FlowPipeline {name}: long_range {lr.shape} differs from accflow_forward by "
                 f"{diff:.3e}")
        row["long_range_vs_accflow_forward"] = diff
        row["pair_flow_s"], pf = api_call(f"{name} pair_flow", lambda: pipe.pair_flow(frames[0],
                                                                                      frames[1]))
        row["occlusion_s"], (of, occ) = api_call(
            f"{name} occlusion", lambda: pipe.occlusion(frames[0], frames[1]))
        row["pairs_s"], prs = api_call(f"{name} pairs, 7 frames, warm start",
                                       lambda: pipe.pairs(clip7, warm_start=True))
        # occlusion solves both directions as one batch of 2, so its flow is
        # held against that batched solve (bf16 convs round differently at
        # another batch) and its mask against calc_occ_mask of it.
        pad1 = InputPadder((1, 436, 1024, 3))
        p1, p2 = (pad1.pad_np(_as_frames(f, False)[0]) for f in frames[:2])
        both = pipe.est.forward(np.concatenate([p1, p2]), np.concatenate([p2, p1]),
                                final_only=True)["flow_up"]
        occ_ref = pad1.unpad(calc_occ_mask(both[1:], both[:1])[1])[0].cpu().numpy()
        of_ref = pad1.unpad(both[:1])[0].float().cpu().numpy()
        gaps = (float(np.abs(prs[0] - pf).max()), float(np.abs(of - of_ref).max()))
        same_occ = float(np.mean(occ == occ_ref))
        print(f"FlowPipeline {name}: pair_flow vs pairs()[0] max abs {gaps[0]:.3e}; occlusion's "
              f"flow vs the batched two-direction solve {gaps[1]:.3e}, its mask equal to "
              f"calc_occ_mask's on {100 * same_occ:.2f} % of pixels; occluded share "
              f"{float(occ.mean()):.4f}")
        if (pf.shape != (436, 1024, 2) or prs.shape != (6, 436, 1024, 2)
                or occ.shape != (436, 1024, 1) or not set(np.unique(occ)) <= {0.0, 1.0}
                or not all(np.isfinite(x).all() for x in (pf, prs, of))
                or not gaps[0] <= CLIP_REL * float(np.abs(pf).max())
                or not gaps[1] <= CLIP_REL * float(np.abs(of_ref).max()) or same_occ < 0.99):
            fail(f"FlowPipeline {name}: pair_flow / occlusion / pairs disagree or are malformed")
        stream = pipe.stream()
        secs, outs = [], []
        for f in frames:
            t0 = time.perf_counter()
            outs.append(stream.send(f))
            secs.append(time.perf_counter() - t0)
        if any(o is not None for o in outs[:2]) or not all(
                o.shape == (436, 1024, 2) and np.isfinite(o).all() for o in outs[2:]):
            fail(f"FlowPipeline {name}: stream outputs malformed")
        row["stream_send_median_ms"] = statistics.median(secs[5:]) * 1e3
        print(f"FlowPipeline {name} stream: 30 frames, send() median "
              f"{row['stream_send_median_ms']:.2f} ms over frames 6-30 (first push, warm-ups "
              f"and capture {secs[3] * 1e3:.1f} ms); the graphed clip (7 x 512^2, batch 2) "
              f"{graphed_clip_ms:.2f} ms")
        rows[name] = row
        keep[name] = (pipe, lr)
        del stream
    torch.cuda.empty_cache()

    f512 = ((moving_frames(7, 1, 512, seed=7)[:, 0] + 1) * 127.5).round().clamp(0, 255)
    f512 = f512.to(torch.uint8).cpu().numpy()
    apipe = ArtifactPipeline(str(Path(tmp) / "clip_bf16.pt2"))
    reset_counts()
    art_s, got = api_call("ArtifactPipeline long_range (bf16 clip artifact, 1 of batch 2)",
                          lambda: apipe.long_range(f512))
    expect_counts("ArtifactPipeline (warm-ups and capture; replays uncounted)", corr_cuda,
                  12 * (graphs.WARMUP + 1))
    # The artifact fills its batch of 2 with the clip twice; long_range on
    # that batch is the like-for-like reference (bf16 convs round
    # differently at batch 1).
    ref = keep["acc+raft"][0].long_range(np.stack([f512, f512], axis=1))[:, 0]
    diff = check_artifact("ArtifactPipeline vs FlowPipeline acc+raft long_range on the filled "
                          "batch", torch.from_numpy(got), torch.from_numpy(ref))
    rows["artifact"] = dict(long_range_s=art_s, max_abs_vs_pipeline=diff)
    del apipe
    gc.collect()
    pipe_gma, lr_gma = keep.pop("acc+gma")
    keep.clear()
    torch.cuda.empty_cache()
    return rows, pipe_gma, lr_gma, clip7


def demo_phase(tmp: str, pipe, lr, clip7) -> dict:
    """Phase 13: `python -m accflow_tpu_torch.cli.demo --mode long --ofe gma
    --no_viz` in its own process on the 7 Sintel-size frames written as .bin
    numpy files (read_gen's np.load branch, passed by name), with the GMA
    pipeline's weights handed over as an .npz checkpoint (save_npz_tree):
    its .flo files, read back, against that pipeline's long_range on the
    same frames (the same kernels: bit-equal expected; CLIP_REL)."""
    d = Path(tmp) / "demo"
    d.mkdir()
    files = []
    for i, f in enumerate(clip7):
        files.append(str(d / f"frame_{i:03d}.bin"))
        with open(files[-1], "wb") as fh:
            np.save(fh, f)
    stem = str(d / "acc+gma")
    save_npz_tree(stem + ".ofe.npz", to_jax_params(pipe.est.model))
    save_npz_tree(stem + ".acc.npz", to_jax_params(pipe.acc))
    out = d / "out"
    cmd = [sys.executable, "-m", "accflow_tpu_torch.cli.demo", "--frames", *files, "--mode",
           "long", "--ofe", "gma", "--acc_ckpt", stem, "--no_viz", "--out", str(out)]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=str(REPO))
    secs = time.perf_counter() - t0
    print("demo: " + " | ".join(run.stdout.strip().splitlines()[-3:]))
    if run.returncode != 0:
        fail(f"demo exited {run.returncode}: {run.stderr[-2000:]}")
    got = np.stack([read_flow(str(out / f"frame_{i:03d}_to_frame_000.flo")) for i in range(2, 7)])
    diff, flow_max = float(np.abs(got - lr).max()), float(np.abs(lr).max())
    print(f"demo --mode long --ofe gma, 7 frames 436 x 1024: {secs:.1f} s for the process; "
          f".flo vs FlowPipeline.long_range max abs {diff:.3e} "
          f"({'bit-equal' if diff == 0 else 'not bit-equal'}; bar {CLIP_REL:g} x {flow_max:.3e})")
    if got.shape != lr.shape or not diff <= CLIP_REL * flow_max:
        fail(f"demo: its flows differ from FlowPipeline.long_range by {diff:.3e}")
    return dict(process_s=secs, max_abs_vs_pipeline=diff)


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
                    help="time kernels #1 and #2 at 4, 8 and 16 queries per block")
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
    rows1 = check_lookup("kernel #1 (radius 4, clip shape)",
                         lambda lv, c, o: corr_cuda.lookup_corr_fused(lv, c, 4, o),
                         levels32, coords, 4, out_dtypes=(torch.float32, torch.bfloat16))
    if args.tile_sweep:
        tile_sweep("kernel #1", corr_cuda,
                   lambda lib, lv, o: corr_cuda.launch(lib, lv, coords, o), levels32, coords, 4)
    rows2_r4 = check_lookup(
        "kernel #2 (radius 4, clip shape)",
        lambda lv, c, o: corr_level_cuda.lookup_corr_level(lv, c, 4, o), levels32, coords, 4,
        beside=lambda lv, c, o: corr_cuda.lookup_corr_fused(lv, c, 4, o),
        out_dtypes=(torch.float32, torch.bfloat16))
    rows3 = check_y_contract(levels32, coords)
    split_ratio = check_split_windows(levels32, coords)
    probe_rows = run_probes(levels32, coords, rows1["bfloat16"])
    del levels32, coords
    torch.cuda.empty_cache()
    levels32, coords = lookup_inputs(4)
    rows2 = check_lookup("kernel #2 (radius 3, stream shape)",
                         lambda lv, c, o: corr_level_cuda.lookup_corr_level(lv, c, 3, o),
                         levels32, coords, 3, out_dtypes=(torch.float32, torch.bfloat16))
    if args.tile_sweep:
        tile_sweep("kernel #2", corr_level_cuda,
                   lambda lib, lv, o: corr_level_cuda.launch(lib, lv, coords, 3, o),
                   levels32, coords, 3)
    del levels32, coords
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        launches1, fps, launches3_clip, fps_bd, small, clip_extra = clip_path(args.profile, tmp)
        print(f"frames/s {fps:.3f} on {line} (AccFlow+RAFT, 7x512^2, batch 2, 12 iters, bf16); "
              f"{fps_bd:.3f} with experimental:fused_bd; graphed "
              f"{clip_extra['graphed']['frames_per_s']:.3f}; loaded bf16 artifact "
              f"{14 / clip_extra['artifact']['median_ms'] * 1e3:.3f}")
        stream_a = stream_path("(a) RAFT-small", True, args.profile, tmp)
        gma_row = gma_clip_path(args.profile)
        gma_small = small_clip("gma")
        chunked = chunked_attention()
        api_rows, pipe_gma, lr_gma, clip7 = pipeline_phase(
            tmp, clip_extra["graphed"]["median_ms"])
        demo_row = demo_phase(tmp, pipe_gma, lr_gma, clip7)
        del pipe_gma
        torch.cuda.empty_cache()
    print(f"GMA frames/s on {line} (AccFlow+GMA, 7x512^2, batch 2, 12 iters, bf16): eager "
          f"{gma_row['eager_frames_per_s']:.3f}, graphed {gma_row['graphed']['frames_per_s']:.3f}")
    stream_b = stream_path("(b) full RAFT", False, args.profile)
    stream_c = stream_path("(c) GMA", False, False, ofe="gma", bit_equal=True)
    print(f"stream frames/s on {line} (512^2, batch 2, 6 iters, bf16): (a) RAFT-small eager "
          f"{stream_a['eager_frames_per_s']:.3f} ({stream_a['eager_median_ms']:.3f} ms per push), "
          f"graphed {stream_a['frames_per_s']:.3f} ({stream_a['median_ms']:.3f} ms); (b) full "
          f"RAFT eager {stream_b['eager_frames_per_s']:.3f} ({stream_b['eager_median_ms']:.3f} "
          f"ms), graphed {stream_b['frames_per_s']:.3f} ({stream_b['median_ms']:.3f} ms)")
    drift_launches = drift_fixture()
    evals = eval_phase()
    print(json.dumps({"graphs": {"card": line, "clip": clip_extra, "stream_a": stream_a,
                                 "stream_b": stream_b}}))
    print(json.dumps({"gma": {
        "card": line, "clip": gma_row, "small_clip_launches": gma_small,
        "chunked_attention": chunked, "stream_c": stream_c,
        "eval": {f"{m} {lk}": evals[m, lk] for m, lk in evals if "gma" in m},
        "pipeline": api_rows, "demo": demo_row}}))

    # Kernels #1 and #3 have a row for each output type, each timed in the
    # configuration whose launches it reports: corr_lookup and
    # corr_y_contract are the bf16 main paths (bf16 levels or maps in, bf16
    # out: the clip, stream and eval); the *_f32_out rows are float32 in and
    # out, what the f32 small clip on the GPU launches (its maps are 8^2 at
    # level 0; the rows' times are at the clip shape). The bf16-in, f32-out
    # times, which no path launches, stand under "bfloat16_in". Kernel #2
    # likewise: corr_level_lookup is stream (a)'s (bf16 in and out, radius
    # 3, the stream shape), corr_level_lookup_f32_out the f32 drift
    # fixture's on the GPU (f32 in and out, timed at the stream shape).
    print(json.dumps({"kernels": [
        {"name": "corr_lookup", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_lookup.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:264",
         "launches": launches1, "launches_in": "the clip path (5 forwards)",
         **rows1["bfloat16, bf16 out"], "levels_dtype": "bfloat16", "out_dtype": "bfloat16",
         "eval_launches": evals["acc|raft", "fused"]["launches"],
         "gma_clip_launches": gma_row["launches"], "stream_c_launches": stream_c["launches"],
         "gma_eval_launches": evals["acc|gma", "fused"]["launches"]},
        {"name": "corr_lookup_f32_out", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_lookup.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:264",
         "launches": small["fused"], "launches_in": "the f32 small clip on the GPU",
         "gma_small_clip_launches": gma_small["fused"],
         **rows1["float32"], "levels_dtype": "float32", "out_dtype": "float32",
         "float32_levels_bf16_out": rows1["float32, bf16 out"],
         "bfloat16_in": rows1["bfloat16"]},
        {"name": "corr_level_lookup", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_level_lookup.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:466",
         "launches": stream_a["launches"],
         "launches_in": "stream (a), eager (reset, 2 warm-up and 30 pushes)",
         **rows2["bfloat16, bf16 out"], "levels_dtype": "bfloat16", "out_dtype": "bfloat16",
         "radius": 3, "bfloat16_in_f32_out": rows2["bfloat16"],
         "float32_levels": rows2["float32"],
         "float32_levels_bf16_out": rows2["float32, bf16 out"],
         "radius4_clip_shape": rows2_r4},
        {"name": "corr_level_lookup_f32_out", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_level_lookup.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:466",
         "launches": drift_launches, "launches_in": "the f32 drift fixture on the GPU",
         **rows2["float32"], "levels_dtype": "float32", "out_dtype": "float32", "radius": 3},
        {"name": "corr_y_contract", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_y_contract.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:343",
         "launches": evals["acc|raft", "experimental:fused_bd"]["launches"],
         "launches_in": "one acc|raft experimental:fused_bd eval batch",
         **rows3["level0"]["bfloat16, bf16 out"],
         "shape": "level 0 of the clip path, bfloat16 in", "out_dtype": "bfloat16",
         "level1": rows3["level1"]["bfloat16, bf16 out"],
         "clip_launches": launches3_clip,
         "fused_bd2_eval_launches": evals["acc|raft", "experimental:fused_bd2"]["launches"],
         "split_windows_max_diff_over_A": split_ratio},
        {"name": "corr_y_contract_f32_out", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_y_contract.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:343",
         "launches": small["experimental:fused_bd"],
         "launches_in": "the f32 small clip on the GPU, experimental:fused_bd",
         "gma_small_clip_launches": gma_small["experimental:fused_bd"],
         **rows3["level0"]["float32"],
         "shape": "level 0 of the clip path, float32 in", "out_dtype": "float32",
         "level1": rows3["level1"]["float32"],
         "float32_in_bf16_out": rows3["level0"]["float32, bf16 out"],
         "bfloat16_in": {"level0": rows3["level0"]["bfloat16"],
                         "level1": rows3["level1"]["bfloat16"]}},
        *probe_rows,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
