#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (accflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--tile-sweep]   # repo root, one GPU
    python3 chip_smoke.py --nccl-spatial               # instead: 2+ GPUs, one rank each

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
   size, time, the flows against eager under ARTIFACT_REL) (the same clip
   with corr_lookup="experimental:fused_bd" is phase 25's). Then a small
   clip in float32 (TF32 off) runs on the GPU (through the kernels) and on
   the CPU (through the plain versions) with the same weights, with fused
   and experimental:fused_bd, and the GPU must agree with the CPU and
   fused_bd with fused;
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
   peak memory and launches; each split lookup's EPEs within EVAL_EPE_REL
   of fused's; acc|gma and direct|gma with fused. Each micro-batch call
   replays a CUDA graph (graphs.CudaGraphed): the first call's 2 warm-ups
   and capture are counted (12 launches each, 24 with fused_bd2) and timed
   apart from the replay; each run is repeated eagerly (24 launches per
   batch, 48 with fused_bd2), and its EPEs must equal the graphed ones bit
   for bit;
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
   its .flo files against phase 12's long_range (CLIP_REL);
14. accumulator training (train/engine.py::train_acc) with
   configs/AccRAFT.yml as shipped (batch 6, 256^2 crops of 7-frame clips,
   bf16, hidden 128, noise, lr 1.2e-4; the frozen RAFT at 12 iterations
   from seed 0 on kernel #1) on 24 + 6 synthetic CVOR clips of 256^2:
   kernel #1 against the plain lookup at the step's lookup shape (Q =
   66*32*32, maps 32^2..4^2; LOOKUP_TOL); (a) 13 steps with a validation
   at step 10, then resume "auto" for 5 more, the steps and the validation
   replayed from CUDA graphs (graphs.CudaGraphedStep: noise, forward,
   backward, clip and AdamW in the graph): every loss finite, the steps 2
   eager, the capture, then replays, one capture each (the resumed run
   captures again, and AdamW's count and the schedule go on to 18), 12
   kernel-#1 launches counted per eager or captured step and per
   validation warm-up and capture, none in a replay, 12 in the profile of
   the last replay (its device busy time and idle share), no plain lookup,
   the checkpoints and the visual PNG on disk; ms per replayed step (the
   validation's step left out), clips/s, peak memory; one step's forward
   and backward under the sync debug mode "error"; configs/AccGMA.yml for
   6 steps (GMA frozen on kernel #1); (b) one step at 64^2 in float32 on
   the GPU against the CPU (TRAIN_* bars); (c) remat "full" and "dots" and
   grad_accum 2 against the plain step at full width in bf16, with their
   peaks (MEMORY_REL_BF16; grad_accum by ACCUM_F32_RATIO against the f32
   step), and at (b)'s size in float32 (MEMORY_REL_F32); (d) GRAPH_STEPS
   steps eager and graphed from the same init, batches and generator:
   eager and graphed ms per step, the capture call, peaks, one replay's
   profile, one eager step and one replay (updates included) under the
   sync debug mode "error", the graphed validation step bit-equal to the
   eager one; then two eager runs and a graphed one under torch's
   deterministic algorithms, the graphed run held to the eager runs'
   spread (GRAPH_SPREAD, GRAPH_FLOOR: losses, parameters, AdamW's
   moments);
   with --profile, the device time of a train step and of its frozen RAFT;
15. estimator fine-tuning (train/finetune.py::fine_tune) with
   configs/RAFT.yml as shipped (full RAFT, batch 6, 256^2 pairs chosen by
   select_pair, 12 iterations, bf16 with float32 flow state and a float32
   pyramid, noise, gamma 0.85, AdamW 1.2e-4, OneCycle, clip 1.0, remat
   "dots"; weights from seed 0) on phase 14's synthetic CVOR clips: (a)
   kernels #1 and #2 (radius 3) at the step's lookup shape as phases 3 and
   4 check them, then the lookups' backward kernel (csrc/corr_lookup_backward.cu) against the plain
   backward at the step's lookup shape (Q = 6*32*32, maps 32^2..4^2): kernel
   #1's entry with float32 levels and bfloat16, float32 window gradients and
   with bfloat16 levels, kernel #2's at radius 3, coords on a 1/256 grid
   (BWD_REL), at the path's coords (LOOKUP_TOL) and far off the maps
   (zeros), each timed beside the plain backward, grid_sample's backward and
   the bound; (b) 13 steps with a validation at step 10, then resume "auto"
   for 5 more, graphed as phase 14's (the BatchNorm write-back in the
   graph too): 12 kernel-#1 and 12 backward-kernel launches counted per
   eager or captured step and seen in the profile of a replay, 20 kernel-#1
   launches per validation warm-up and capture, no plain lookup or
   backward, ms per replayed step, clips/s, peak memory; configs/GMA.yml
   for 6 steps; RAFT-small (small: true, kernel #2 and its backward) for
   6; (c) one step's forward and backward under the sync debug mode
   "error"; (d) one 64^2 float32 step on the GPU against the CPU (TRAIN_*,
   FT_STATS_REL); (e) remat "none", "full" and "dots" at full width, eager:
   ms per step, peak, gradients against "none"; (f) phase 14d's graphed
   against eager steps for each remat mode (the BatchNorm buffers held
   too; the validation step with "dots"); with --profile, the device time
   of one step by kind;
16. the volume-free lookup (corr_lookup "ondemand[:chunk]": each chunk's
   rows rebuilt every iteration and read by kernel #1, #2 for RAFT-small):
   (a) small clips at 64^2, f32, TF32 off, ondemand:16 on the GPU against
   the CPU and against fused, for RAFT, GMA and RAFT-small (CLIP_REL; 48
   launches per forward); (b) the 7x512^2 batch-2 bf16 clip with fused,
   ondemand (one chunk) and ondemand:1024 (4 chunks), eager and graphed,
   against fused (CLIP_REL), ms per forward, peak, 12 launches per chunk
   and forward; (c) FlowPipeline.long_range (acc+raft, 7 frames) at
   1280x720 and 1920x1080 with fused and ondemand (seconds, peak; ondemand
   against fused), the stored-volume budget derived from the fused peaks
   and AUTO_VOLUME_BYTES held under it, what "auto" picks at 512^2 ..
   1440p, and 2560x1440 through "auto" (it must take ondemand) with
   acc+raft and acc+gma; (d) fine_tune with RAFT.yml and corr_lookup
   ondemand, graphed, 6 steps, and a 64^2 f32 step with ondemand:16 on the
   GPU against the CPU (phase 15d's bars; launches as the CPU's plain calls);
17. AccFlow's forward (F0N) direction and cold stepwise path: (a) train_acc
   with configs/AccRAFT-F0N.yml as shipped (labels from fflows), graphed,
   13 steps; (b) the 64^2 f32 F0N train step on the GPU against the CPU
   (TRAIN_* bars); (c) the 7x512^2 bf16 clip: F0N fused against F0N
   stepwise, the cold backward stepwise path against the fused one
   (CLIP_REL);
18. High-Speed Sintel at its real shape: a synthetic tree of 8 samples of
   43 frames of 1024x436 (PNGs written here with several row filters),
   evaluated by cli/test_sintel as shipped (interv 6: T = 8, 12 iterations,
   bf16, batch 4) for acc|raft, direct|raft and acc|gma: seconds per
   sample, the loader's share, peak memory, kernel #1's predicted launches;
   (b) a 64x32 float32 tree on the GPU against the CPU (SINTEL_REL);
19. data parallelism: (a) train_acc (AccRAFT.yml) and fine_tune (RAFT.yml)
   as shipped in a world of one over NCCL, graphed, bit-equal to the same
   runs without a process group under deterministic algorithms; (b)
   evaluate_cvo(data_parallel) under that group, bit-equal to phase 8;
   then, under that group, a spatial handle of its one rank (every
   exchange an NCCL collective of one rank), each case eager and graphed
   (one_rank_spatial): (o) the CVO-6 clip through graphs.CudaGraphed and
   (p) stream (b)'s pushes through StreamAccumulator, graphed bit-equal to
   eager; (q) AccRAFT.yml's and (r) RAFT.yml's steps, DP_STEPS graphed
   against two eager runs under deterministic algorithms (GRAPH_SPREAD,
   GRAPH_FLOOR); a graphed call's collectives and bytes as an eager
   call's, kernel #1's launches (and the backward kernel's) in a replay's
   profile as an eager call's, one eager call and one replay under the
   sync debug mode "error", ms per call eager and graphed, NCCL's share of
   a replay's device time; (c)
   two ranks on the one card over gloo with CUDA tensors, eagerly, one
   train_acc and one fine_tune step at batch_per_gpu 1 against one process
   at batch 2 (the script runs itself twice with --dp-child);
20. the host tools: a convert_ckpt round trip of the full-width acc+raft
   (the clip forward bit-equal), the native CVOR core's decode of a
   CVO-test-sized flow column against numpy, profiling.trace naming kernel
   #1, the graphed clip's spans under profiling.trace beside phase 5b's;
21. the mesh's spatial axis (height sharding) for inference: two gloo
   ranks on the one card with CUDA tensors (the script runs itself twice
   with --spatial-child), n_spatial 2, each on its rows of the frames,
   against this process on the whole frames: (a) RAFT 128^2, 2 iterations,
   f32 (TF32 off), fused and ondemand:64 (CLIP_REL); (b) the CVO-6 clip,
   (c) a 7-frame 1920x1088 clip at batch 1 through "auto" (ondemand at the
   global shape), (d) stream (b) with warm_start, reset and 5 pushes, all
   bf16 (BATCH_SPREAD x each case's own batch-1-vs-2 distance): each rank's
   peak beside one process's, seconds per call, collectives and bytes,
   kernel #1's launches (equal on both ranks, one per iteration and chunk,
   no other kernel) and Q; (bd clip) phase 5's 64^2 f32 small clip with
   experimental:fused_bd (kernel #3 on each rank's queries: 12 launches a
   rank, Q adding up to one process's; FLOW_REL); and in each rank,
   graphed requests over gloo on the card, which must raise ValueError
   naming gloo (gloo_refusals);
22. the spatial axis for GMA and RAFT-small and at unequal row blocks, in
   phase 21's launch of two ranks and against this process likewise: (e)
   the AccFlow+GMA CVO-6 clip (gamma drawn in [2, 4]), (f) stream (a)
   (RAFT-small: kernel #2 on each rank's queries) and (g) stream (c) (GMA),
   bf16 (BATCH_SPREAD); (h) Sintel's padded 1024x440 at 224 + 216 rows: a
   RAFT pair in f32 (CLIP_REL) and the bf16 AccFlow+RAFT 7-frame clip at
   batch 1; (i) the drift fixture (trained weights, f32, 36 frames at 64^2:
   DRIFT_REL on every output and DRIFT_EPE_PX per step); f32 pairs at 40x64 (24 +
   16 rows) of GMA with its positional branch and of RAFT-small (CLIP_REL);
   the same readings, the ranks' queries per launch adding up to one
   process's;
23. the accumulator's train step over the spatial axis and the clip paths
   that took a handle last, in phase 21's launch of two ranks: (j) one
   train step (make_acc_train_step with a handle, AdamW's update left out)
   at 64^2, f32 (TF32 off), AccFlow hidden 128, on the fused, F0N
   fused and cold stepwise paths, and the fused one at 40x64 (24 + 16
   rows): the loss (TRAIN_LOSS_REL) and the reduced gradients, the context
   encoder's and the rest apart (TRAIN_GRAD_REL), against this process,
   both ranks' gradients bit-equal; (k) AccRAFT.yml as shipped (batch 6 a
   spatial pair, 7 x 256^2, bf16, noise on): its gradients against one
   process's f32 step (ACCUM_F32_RATIO x one process's bf16 step's
   distance), each rank's peak, seconds per step, the forward's and the
   backward's collectives and bytes, kernel #1's launches and Q; (l) the
   warm-started, F0N fused and cold stepwise CVO-6 clips (BATCH_SPREAD),
   kernel #1's launches a rank (60, 12, 60) and Q;
24. the estimators' fine-tune step over the spatial axis, in phase 21's
   launch of two ranks: (m) one step of make_finetune_step with a handle
   (AdamW's update left out), f32 (TF32 off), batch 2 at 64^2, 12
   iterations, remat "dots": full RAFT "fused" and "ondemand:16" (2 chunks
   a rank), GMA (positional, gamma drawn), RAFT-small (kernel #2), and RAFT
   at 40x64 (24 + 16 rows): the loss (TRAIN_LOSS_REL), the reduced
   gradients over the fnet, the cnet and the rest apart (TRAIN_GRAD_REL)
   and the moved running statistics (FT_STATS_REL) against this process,
   both ranks' gradients and statistics bit-equal; (n) RAFT.yml as shipped
   (batch 6 a spatial pair, 256^2, bf16, remat "dots", noise on): its
   gradients against one process's f32 step (ACCUM_F32_RATIO), each rank's
   peak, seconds per step, the forward's and the backward's collectives
   and bytes, kernel #1's and the backward kernel's launches a rank (12
   each) and Q;
25. the experimental corr_lookup spellings (run after phase 5; (d) in
   phase 21's launch): (a) each of pallas, rows, patch, gather, fusedv,
   packed, packed2, fused_vy, fused_cat, fused_vy_cat and
   fused_mix:rows,rows_gx,vpu_y,bd on phase 5's 64^2 f32 small clip on the
   GPU against fused there (CLIP_REL), 12 launches of kernel #2 (pallas) or
   #3 (the mix) and none of any lookup kernel for the others; (b) each and
   experimental:fused_bd on the CVO-6 clip (7 x 512^2, batch 2, bf16): one
   eager forward under the sync debug mode "error", one warm and one timed
   forward (ms, frames/s, peak, launches, the max abs distance from fused's
   flow, which must be finite and not all zero); (c) kernel #2 at radius 4
   on the clip's shape, bf16 in and out, as experimental:pallas launches it
   (phase 4's row, beside kernel #1's, with #1's bound and library call);
   (d) the 64^2 f32 small clip with experimental:fused_mix:rows,rows_gx,
   vpu_y,mm on phase 21's two gloo ranks (mix clip, FLOW_REL, no lookup
   kernel). An {"experimental": ...} line holds the readings, and a
   {"phase_seconds": ...} line each phase's seconds;
26. the estimator options (run after phase 17; (f) in phase 21's launch):
   corr_levels and corr_radius at any level count and radius, through
   kernel #2 built for each (radius, levels) but kernel #1's (4, 4), the
   backward kernel likewise and kernel #3 for 2r+1 taps; corr_volume_dtype;
   norm_fn "group". (a) RAFT at (3, 3), (2, 2) and (5, 6), RAFT-small at 3
   levels, GMA at (3, 3), RAFT (3, 3) with experimental:fused_bd (kernel #3
   at 7 taps) and with ondemand:16, each on phase 5's 64^2 f32 small clip
   on the GPU against the CPU (CLIP_REL), each build's launches counted;
   (b) kernel #2's (3, 3), (2, 2) and (6, 5) builds at the CVO-6 clip's
   lookup shape (bf16 in), kernel #3 at 7 taps at its level 0, the
   backward kernel's (3, 3) build at the fine-tune shape, each against its
   plain version and timed beside its bound and library yardstick; (c) the
   CVO-6 clip with full RAFT and with GMA at (3, 3), eager and graphed
   (bit-equal), and RAFT's with corr_volume_dtype "float32" (ms, peak, its
   distance from the default's flow); (d) a 64^2 f32 fine-tune step at (3,
   3) on the GPU against the CPU (phase 15d's bars) and RAFT.yml with
   corr_levels 3, corr_radius 3 through fine_tune, graphed, 6 steps; (e)
   the basic and small encoders with norm_fn "group" on the GPU against the
   CPU (GROUP_REL), one bf16 call each at 512^2; (f) RAFT (3, 3) and a
   group-norm basic encoder on two gloo ranks at 40x64 (24 + 16 rows)
   against one process (FLOW_REL). An {"options": ...} line holds the
   readings.
--nccl-spatial runs none of these phases: on every card of the machine
(two or more; four through the tool's --chips 4) it starts one NCCL rank
per card (the script with --nccl-spatial-child) and runs, eagerly and
graphed, (o) the CVO-6 clip and (p) stream (b) at n_spatial 2 and 4, (q)
AccRAFT.yml's and (r) RAFT.yml's steps at n_spatial 2 and 4 (each
spatial group on the whole batch) and on the (2, 2) mesh (each data group
on half of it), and (q) data-parallel over every rank (6 clips a rank),
after the ranks have computed the one-process references between them:
(o), (p) within BATCH_SPREAD x the case's batch-1-vs-2 distance, (q), (r)
one step's reduced gradients within ACCUM_F32_RATIO (every rank's
bit-equal, kernel #1's and the backward kernel's 12 launches a rank, Q
adding up to one process's), graphed against eager as phase 19a holds
it; with each rank's ms per call eager and graphed, collectives and bytes,
peaks and NCCL's share of a replay beside one process's, in an
{"nccl_spatial": ...} line.
Optional phases: --tile-sweep builds kernels #1 and #2 with 4, 8 and 16
queries per block and times them in turns (#1 at the clip shape after phase
3, #2 at the stream shape after phase 4); --profile prints where
the device time of the clip forward (with fused and with
experimental:fused_bd, and with GMA) and of a stream push, eager and
graphed, goes (torch.profiler). A {"graphs": {...}} line holds the eager
and graphed medians, busy times, launches per replay and peaks, and the
artifacts' numbers, with the card's name and power limit; a {"gma": {...}}
line the numbers of phases 6c and 8's GMA runs and 10-13, and a
{"train": {...}} line phase 14's, a {"finetune": {...}} line phase 15's
(graphed and eager ms per step, busy time, idle share, peaks, capture
calls, the graphed-vs-eager distances beside their bars), an
{"ondemand": {...}} line phase 16's, an {"f0n": {...}} line phase 17's, and
{"sintel"}, {"data_parallel"}, {"host_tools"} and {"spatial"} lines phases
18-24's. The line before
the last is {"kernels": [...]}; the last line is {"ok": true, "device":
{...}}. Without a GPU, or without the package beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import itertools
import json
import os
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.profiler import ProfilerActivity, profile

try:
    from accflow_tpu_torch import (
        ArtifactPipeline,
        FlowPipeline,
        graphs,
        models,
        native,
        probes,
        serving,
    )
    from accflow_tpu_torch.api import _as_frames
    from accflow_tpu_torch.cli import convert_ckpt as cli_convert_ckpt
    from accflow_tpu_torch.cli import test_sintel as cli_test_sintel
    from accflow_tpu_torch.convert import (
        load_accflow_checkpoint,
        load_jax_params,
        load_npz_tree,
        save_npz_tree,
        to_jax_params,
    )
    from accflow_tpu_torch.data import records
    from accflow_tpu_torch.data.sintel import HighSpeedSintel, resize_linear
    from accflow_tpu_torch.data.cvo import BatchIterator, fetch_train_dataset
    from accflow_tpu_torch.data.synthetic import make_long_sequence, write_synthetic_cvor
    from accflow_tpu_torch.models import gma
    from accflow_tpu_torch.models.raft import gather_pairs, raft_cnet, to_nchw
    from accflow_tpu_torch.models.encoders import BasicEncoder, SmallEncoder
    from accflow_tpu_torch.nn.layers import init_weights, spatial_sharding, tf32
    from accflow_tpu_torch.ops import (
        corr,
        corr_backward_cuda,
        corr_bd_cuda,
        corr_cuda,
        corr_level_cuda,
    )
    from accflow_tpu_torch.ops.occlusion import calc_occ_mask
    from accflow_tpu_torch.ops.padding import InputPadder
    from accflow_tpu_torch.probes import (
        grid_sample_lookup,
        grid_sample_lookup_backward,
        lookup_backward_bound,
        lookup_bound,
    )
    from accflow_tpu_torch.streaming import (
        StreamAccumulator,
        export_streaming,
        load_streaming_artifact,
        make_streaming_fns,
        save_streaming_artifact,
    )
    from accflow_tpu_torch.models.accflow import accflow_train_forward
    from accflow_tpu_torch.train import engine
    from accflow_tpu_torch.train.accum import accumulate_grads
    from accflow_tpu_torch.train.checkpoint import CheckpointManager
    from accflow_tpu_torch.train import finetune as ft
    from accflow_tpu_torch.train import evaluate
    from accflow_tpu_torch.train.loss import sequence_loss_acc, sequence_loss_raft
    from accflow_tpu_torch.train.optim import make_optimizer
    from accflow_tpu_torch.utils.config import parse_options
    from accflow_tpu_torch.parallel import mesh
    from accflow_tpu_torch.utils import profiling
    from accflow_tpu_torch.utils.frame_io import read_flow, read_png, write_flow
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
# Phase 14b, one train step on the GPU (kernel #1, cuDNN) against the CPU
# (plain lookup, CPU convs), float32, TF32 off: the loss within TRAIN_LOSS_REL
# relative, the gradients within TRAIN_GRAD_REL in global relative L2, held
# over the context encoder's leaves and over the others apart, so that a
# TF32 backward confined to the context encoder (~1e-3) cannot hide in the
# whole vector. Both sides differ by summation order (~1e-7 relative per
# op), which moves the loss by ~1e-6 and the gradients by ~1e-6 in L2.
# Phase 14c: options that change what the backward stores (remat) or splits
# (grad_accum) against the plain step, global relative L2 of the whole
# gradient vector: MEMORY_REL_F32 at 14b's size in float32, MEMORY_REL_BF16
# at full width in bfloat16 for remat (the same kernels recomputed). In
# bfloat16 a step's gradients depend on the batch its kernels see: on an
# H100 the frozen estimator's flows at grad_accum's micro-batch of 3 move
# the plain step's gradients by 9.5e-4 alone, and each micro-batch's
# backward rounds its own bfloat16 gradients (one bfloat16 rounding of the
# gradient vector: 1.6e-3), so grad_accum 2 lies 1.27e-3 from the plain
# step. It is held to the float32 step instead: its gradients may lie no
# further than ACCUM_F32_RATIO times the bfloat16 plain step's from the
# float32 plain step on the same batch (a missing or twice-scaled
# micro-batch moves them by ~1/2 or more); memory_options prints those
# readings beside it.
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-4
# Phase 15a, the backward kernel against the plain backward at coords on a
# 1/256 grid: both then blend with bit-equal weights and differ only by
# summation order, so float32 gradients agree within BWD_REL of each element
# plus 1e-6 of the largest; a bfloat16 gradient is the kernel's float32 one
# rounded once (bit-equal to it cast), within BF16_ROUND of the plain one.
# At the path's own coords the plain backward recomputes the fractional
# offset per tap, as the forward does: LOOKUP_TOL, for the same reason.
BWD_REL = 1e-5
# Phase 15d, one fine-tune step at 64^2 in float32 on the GPU (kernel #1, its
# backward kernel, cuDNN) against the CPU (the plain lookup and backward),
# TF32 off: the loss within TRAIN_LOSS_REL relative, the gradients within
# TRAIN_GRAD_REL in relative L2 over the fnet, the cnet and the update block
# apart, each running-statistics buffer within FT_STATS_REL of its largest
# |value| (float32 means over the batch in another summation order; an
# element's own relative error is unbounded where a channel's mean is ~0).
FT_STATS_REL = 1e-5
# A ReLU input within TIE_REL of its tensor's median |value| of zero is a tie
# that either package's rounding may put on either side of the kink; one
# such element took the other side on the GPU than on the CPU in 15d (the
# fnet's layer2.1.norm2 output, -1.06e-6 on the CPU and +1.41e-6 on the GPU
# at a median of 0.67, which moved the fnet's gradient by 1.75e-4 in L2), so
# 15d's CPU run takes the GPU's value at each tie (relu_ties) and counts them.
TIE_REL = 1e-5
MEMORY_REL_F32 = 1e-5
MEMORY_REL_BF16 = 1e-3
ACCUM_F32_RATIO = 1.2
# Phases 14d and 15f, GRAPH_STEPS graphed train steps (graphs.CudaGraphedStep)
# against as many eager ones from the same init, inputs and generator. The
# backward sums in no fixed order, so eager runs differ (train_acc's losses
# part in the 7th digit). Worse for a bar, with torch's
# defaults each run of tests/test_torch_cuda.py's 64^2 f32 accumulator
# step, eager or graphed, falls on one of two outcomes 1.25e-5 apart in
# the parameters after 5 steps (torch.backends.cudnn.deterministic removes
# the split), so a few eager runs cannot bound a graphed one
# (three plain runs, then two plain and one nudged by a float32 rounding,
# each failed that way on the card). Under torch's deterministic
# algorithms (warn only) eager and graphed runs of that step repeat bit
# for bit (8 of 8 calls). So the graphed run is held there: each step's
# loss and each state group (parameters, AdamW's moments, BatchNorm
# buffers, in relative L2) against the first of two eager runs within
# GRAPH_SPREAD times their distance plus GRAPH_FLOOR (a few float32
# roundings: a loss is read to one ulp, 1e-7 of it). The times, peaks and
# profiles are taken with torch's defaults, as the engines run, and the
# graphed run's distance from eager there is printed beside it. Deliberate
# faults (stale input buffers, the schedule not advanced, the BatchNorm
# write-back left out, the generator not registered) moved that step's
# losses by 1e-3 to 5e-2 and its buffers by 0.21, or raised. The
# validation and eval steps have no backward: bit-equal.
# Phase 17c, a stepwise AccFlow path (F0N's, the cold backward one) against
# its fused path on the 7x512^2 clip. They compute one function: in float32
# with TF32 off the two agree within CLIP_REL of the largest |flow| (2.3e-6
# of it on an H100). In bfloat16 they do not run the same kernels: the
# stepwise paths query the estimator 5 times with batches of 6 and 4 pairs,
# the fused ones once with 22, and cuDNN and cuBLAS may take other algorithms
# at other batches, whose bfloat16 roundings the 12 GRU iterations carry
# on. On an NVIDIA H100 80GB HBM3 (700 W) this check at 1e-3 of the largest
# |flow| read 1.503e-3 (F0N) and 1.544e-3 (cold) against 1.675e-4, while the
# fused clip run as two batch-1 clips lies 1.839e-3 from itself at batch 2,
# and every one of these bfloat16 runs lies 3.9-4.1e-3 from float32. So the
# bfloat16 stepwise clip is held to BATCH_SPREAD times that batch-1-vs-2
# distance of the fused clip, measured in the same run; the float32 bar
# holds the function.
BATCH_SPREAD = 2.0
GRAPH_STEPS = 8  # 2 eager (graphs.WARMUP), the capture replayed once, 5 replays
# Phase 18b, evaluate_sintel's EPEs at 64x32 in float32 (TF32 off) on the GPU
# (kernel #1, cuDNN) against the CPU (the plain lookup, CPU convs): within
# SINTEL_REL of the CPU's EPE plus 1e-6 px. The two flows differ by
# summation order (phase 5's small clip: ~1e-6 of the largest |flow| in
# float32), and an EPE is a mean of per-pixel distances to a random ground
# truth of ~1 px, so it moves by ~1e-6 of itself; a wrong pad, crop, resize
# or mask moves it by percents. Fixed before the phase's first run.
SINTEL_REL = 1e-4
SINTEL_SAMPLES = 8  # phase 18's samples: two batches of 4
DP_STEPS = 8  # phase 19a's steps per run: 2 eager, the capture, 5 replays
# Phase 19c's launches per step on each rank (and in one process): the
# accumulator step's frozen RAFT at 4 iterations, the fine-tune step's RAFT
# at 12 with its lookup's backward (remat "dots" keeps the lookup's output).
DP_STEP_LAUNCHES = {"train": {"corr_lookup": 4},
                    "finetune": {"corr_lookup": 12, "corr_lookup_backward": 12}}
GRAPH_SPREAD = 2.0
GRAPH_FLOOR = 1e-6
# Phase 21, height sharding over two gloo ranks on the one card against one
# process. (a) is float32 with TF32 off: the ranks run the same math on
# their rows (halo rows, the whole image's instance-norm statistics, every
# query against the whole pyramid), and differ from one process by
# summation order where cuDNN picks another algorithm for the shorter
# height or the two halves' statistics are combined (~1e-6 of the largest
# |flow|): held within CLIP_REL of it, as the GPU against the CPU. (b), (c)
# and (d) are bfloat16: there a conv's output moves by a bfloat16 rounding
# wherever its float32 sum falls on the other side of a rounding boundary,
# which another algorithm's summation order makes happen here and there,
# and 12 GRU iterations carry it on; the same thing moves a clip run at
# batch 1 against batch 2 (BATCH_SPREAD). So each is held to BATCH_SPREAD
# times that case's own batch-1-vs-2 distance in one process, measured in
# the same run: (b) the clip's two batch-1 clips against the batch-2 clip,
# (c) the 1088p clip at batch 1 against the same clip beside another at
# batch 2, (d) the stream's two batch-1 streams against the batch-2 stream.
# A wrong halo, row offset or gather moves the flow everywhere. Fixed
# before the phase's first run.
SPATIAL_SIZE_C = (1088, 1920)  # (c)'s frames: 1080p padded to a multiple of 8 * 2 rows
# Phase 22, the axis for GMA and RAFT-small and at unequal blocks, holds its
# cases as phase 21 does: (h)'s pair is float32 (TF32 off), within CLIP_REL
# of the largest |flow|; (e), (f), (g) and (h)'s clip are bfloat16, within
# BATCH_SPREAD times each case's own batch-1-vs-2 distance; (i), the drift
# fixture in float32 with trained weights and flows of several px, holds
# every output F_{i,0} within DRIFT_REL of the largest |flow| and each
# step's EPE within DRIFT_EPE_PX of one process's (phase 7's bars; both
# sides run the same kernel, so no binary occlusion bit flipped in the
# first run: all 34 outputs within 2.0e-6 of the largest |flow|). Where a
# rank holds one chunk, the ranks' queries per launch add up to one
# process's. Fixed before the phase's first run, (i)'s bar on every output
# (not F_{2,0} alone) after it.
SPATIAL_SIZE_H = (440, 1024)  # (h): Sintel's 1024x436 padded, 224 + 216 rows over 2 ranks
# Phase 23, the train step and the clip paths over the spatial axis, in the
# same launch. (j) is float32 with TF32 off: the ranks run one process's
# math on their rows, and their gradients differ from one process's by
# summation order (the halo rows' and the gathered blocks' gradients added
# on their owners, the weights' gradients summed over the ranks: ~1e-6
# relative, as phase 14b's GPU against the CPU), so it takes 14b's bars,
# TRAIN_LOSS_REL and TRAIN_GRAD_REL, over the context encoder (where a lost
# halo gradient shows) and the rest apart; the ranks' reduced gradients are
# bit-equal (one all_reduce gives both the same bits). (k) is bfloat16 at
# full width, where a step's gradients move with the kernels cuDNN picks for
# the shorter height; it takes 14c's grad_accum bar (ACCUM_F32_RATIO: the
# sharded bfloat16 gradients no further from one process's float32 ones
# than 1.2 x one process's bfloat16 ones; a lost halo gradient or a loss
# over the wrong count moves them by 1e-1 or more). (l)'s clips are
# bfloat16, held as (b) is (BATCH_SPREAD). Fixed before the phase's first
# run.
# Phase 24, the estimators' fine-tune step over the spatial axis, in the
# same launch, holds its cases as phase 23 does and phase 15d holds the GPU
# against the CPU: (m) is float32 with TF32 off, so the sharded step is one
# process's math on the ranks' rows (BatchNorm's statistics combined from
# the ranks', the gathered keys' gradient summed on their owners) and takes
# 15d's bars, TRAIN_LOSS_REL, TRAIN_GRAD_REL over the fnet (a lost key
# gradient), the cnet (a halo, a BatchNorm over the wrong ranks or count)
# and the rest apart, and FT_STATS_REL on the running statistics; the
# ranks' gradients and statistics are bit-equal. (n) is bfloat16 at full
# width and takes (k)'s bar (ACCUM_F32_RATIO). The bars were fixed before
# the phase's first run. The ties one process takes from the ranks were
# first those of the convs' and norms' outputs, and the fnet's gradient
# then missed its bar by 76x: at 64^2 the ranks' forward differed from one
# process's by up to 2.2e-5 x a tensor's median |value|, the kernels by
# 6e-7 from their plain versions, and the flips lay at ReLU inputs no hook
# sees, the encoders' residual sums. relu_ties watches every ReLU input, at
# the same TIE_REL, and puts the fnet at 3.4e-6.
SPATIAL_CLIP_KW = {"l warm": dict(warm_start=True), "l f0n": dict(direction="forward"),
                   "l stepwise": dict(fused_ofe=False)}
SPATIAL_TRAIN_KW = {"j fused": {}, "j f0n": dict(direction="forward"),
                    "j stepwise": dict(fused_ofe=False), "j fused 40": {}, "k": {}}
SPATIAL_J = ("j fused", "j f0n", "j stepwise", "j fused 40")  # the float32 train cases
REPO = Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "fixtures"
COUNTERS = (  # each kernel wrapper's launch count: (kernel, module, attribute)
    ("corr_lookup", corr_cuda, "launches"),
    ("corr_level_lookup", corr_level_cuda, "launches"),
    ("y_contract", corr_bd_cuda, "launches"),
    ("corr_lookup_backward", corr_backward_cuda, "launches"),
    ("corr_level_lookup_backward", corr_backward_cuda, "level_launches"),
)
BUILD_COUNTERS = (  # the same launches per build: {(radius, levels) or taps: n}
    (corr_level_cuda, "build_launches"),
    (corr_bd_cuda, "build_launches"),
    (corr_backward_cuda, "level_build_launches"),
)
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


def lookup_inputs(b: int, h: int = 64, w: int = 64, levels: int = 4):
    """A lookup shape of the port: Q = b*h*w queries (b pair-batches of
    8h x 8w frames; 22 of 512^2 on the clip path, 4 in the stream, 66 of
    256^2 in a train step), unit-normal float32 levels of h x w down to
    h/2^(levels-1) x w/2^(levels-1), coords on the grid +-20 px."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = b * h * w
    levels32 = [torch.randn((q, h >> l, w >> l), generator=gen, device=dev)
                for l in range(levels)]
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
                 out_dtypes=(torch.float32,), level_dtypes=(torch.float32, torch.bfloat16)):
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
    levels' dtype (each of `level_dtypes`), with ", bf16 out" for a
    bfloat16 output."""
    rows = {}
    for dtype in level_dtypes:
        name = str(dtype)[6:]
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


def check_y_contract(levels32, coords, radius: int = 4, levels=(0, 1),
                     in_dtypes=(torch.float32, torch.bfloat16)):
    """Phase 4b: kernel #3 at `levels` (0 and 1) of the clip shape: corr3 the
    level's unit-normal maps, wy the tent weights of the coords' y windows
    at `radius` (what _level_window_bd gives it: 2r+1 taps, kernel #3's
    build for them), each of `in_dtypes` in, float32 and bfloat16 out. The
    kernel against its plain twin (Y_TOL_F32, Y_REL_BF16;
    a bfloat16 output as check_out says), then device times of the kernel,
    the twin (same output type) and torch.bmm (the library yardstick, which
    writes the inputs' type) beside the bound (with the output type's
    bytes). Returns {level: {"<in dtype>[, bf16 out]": row}}."""
    rows = {}
    num = 2 * radius + 1
    delta = torch.linspace(-radius, radius, num, device=coords.device)
    with tf32(False):
        for l in levels:
            hl = levels32[l].shape[1]
            wy32 = corr.window_weights(coords[:, 1:2] / 2.0 ** l + delta, hl)
            for dtype in in_dtypes:
                name = str(dtype)[6:]
                corr3, wy = levels32[l].to(dtype), wy32.to(dtype)
                path = corr_bd_cuda.path(corr_bd_cuda.library(num), corr3)
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
                    label = f"kernel #3 ({num} taps) level {l} {name}, {on}"
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
                        corr3, torch.tensor([], dtype=out_dtype).element_size(), num)
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


def print_by_kind(title: str, rows) -> dict:
    """device_rows summed by kind_of their kernel names, printed under
    `title`, largest first; returns {kind: [ms, launches]}."""
    busy_ms = sum(r[0] for r in rows)
    by_kind: dict[str, list] = {}
    for ms, count, name in rows:
        acc = by_kind.setdefault(kind_of(name), [0.0, 0])
        acc[0] += ms
        acc[1] += count
    print(title)
    for kind, (ms, count) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f} %  {count:6d} launches  {kind}")
    return by_kind


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
    print_by_kind("profile: device time by kind, per forward:", rows)
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
    for _, module, attr in COUNTERS:
        setattr(module, attr, 0)
    for module, attr in BUILD_COUNTERS:
        getattr(module, attr).clear()


def launch_counts() -> dict:
    return {name: getattr(module, attr) for name, module, attr in COUNTERS}


def expect_counts(path: str, kernel, expected: int, **others: int) -> int:
    """After a path's run from reset_counts(): `kernel` (a forward kernel's
    wrapper module) launched `expected` times, each kernel named in `others`
    (a COUNTERS name) as often as given there, and every other kernel never.
    Returns `kernel`'s count."""
    counts = launch_counts()
    print(f"{path}: kernel launches {counts}")
    for name, module, attr in COUNTERS:
        want = expected if (module is kernel and attr == "launches") else others.get(name, 0)
        if counts[name] != want:
            fail(f"{path}: {name} launched {counts[name]} times, expected {want}")
    return kernel.launches


def time_clip(label: str, forward, kernel, shape, per_forward: int = 12):
    """Two warm-up forwards (cuDNN algorithm choice, allocator growth), then
    5 timed ones: `kernel` must launch `per_forward` times per forward (12,
    or 12 per chunk of the volume-free lookup) and no other kernel at all;
    the output must be float32 of `shape` and finite. Returns (launches,
    median seconds, seconds, output, peak bytes)."""
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
    launches = expect_counts(label, kernel, per_forward * reps)
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
    rows = profile_rows(fn)
    ours = sum(count for _, count, name in rows if any(k in name for k in kernel_names(kernel)))
    return sum(r[0] for r in rows), ours, sum(r[1] for r in rows)


def profiled(fn):
    """fn() once under torch.profiler: (its output, device_rows of it)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, device_rows(prof, 1)


def profile_rows(fn):
    """device_rows of one call of `fn` under torch.profiler."""
    return profiled(fn)[1]


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
    graphed (5b) and as a loaded artifact (9a), then the small GPU-vs-CPU
    clip (the split lookup's full-width clip is phase 25's). Returns
    (kernel #1 launches, frames/s, median seconds, the small clip's GPU
    launches by lookup, {"graphed": ..., "artifact": ...})."""
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
    del est, pairs, acc, images, out
    torch.cuda.empty_cache()
    small = small_clip()
    return launches, fps, med, small, extra


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
    outs, launches = {}, {}
    for lookup, kernel in (("fused", corr_cuda), ("experimental:fused_bd", corr_bd_cuda)):
        for where in ("cuda", "cpu"):
            outs[lookup, where] = small_clip_forward(lookup, where, ofe)
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


def small_clip_forward(lookup: str, where: str, ofe: str = "raft", **overrides) -> np.ndarray:
    """small_clip's forward: the 4-frame 64^2 float32 clip (seed 3) through
    AccFlow (seed 1, its ZeroConv from seed 2) and the estimator `ofe`
    (seed 0; GMA's gamma from seed 3) with corr_lookup `lookup` (and the
    config `overrides`), on `where`, TF32 off, the launch counts reset
    before it. Returns the flows on the host."""
    clip = np.random.default_rng(3).uniform(-1, 1, (4, 1, 64, 64, 3)).astype(np.float32)
    est = models.build_flow_estimator(ofe, compute_dtype="float32", device=where, seed=0,
                                      corr_lookup=lookup, **overrides)
    if ofe == "gma":
        perturb_gamma(est.model, 3)
    acc = models.init_accflow(models.AccFlowConfig(compute_dtype="float32"), seed=1,
                              device="cpu")
    perturb_zero_conv(acc, 2)
    reset_counts()
    with tf32(False):
        return models.accflow_forward(acc.to(where), clip, est.pairs_fn()).cpu().numpy()


# Phase 25: the experimental corr_lookup spellings (ops/corr.py), each the
# windows of "fused" laid out another way: (a) on phase 5's 64^2 float32
# small clip on the GPU against "fused" there, within CLIP_REL of the
# largest |flow| (float32, TF32 off: summation order apart, as GPU against
# CPU), with their launches per forward: pallas 12 of kernel #2, a mix with
# a bd level 12 of kernel #3, every other spelling no lookup kernel; (b) on
# the CVO-6 clip at full width in bfloat16 (with fused_bd, moved here from
# phase 5), one eager forward under the sync debug mode "error", then one
# warm and one timed forward: ms, frames/s, peak, the launches, and the
# flow finite, not all zero, its max abs distance from fused's printed (the
# float32 clip in (a) carries the bar; in bfloat16 each spelling rounds its
# windows its own way).
EXPERIMENTAL = ("pallas", "rows", "patch", "gather", "fusedv", "packed", "packed2", "fused_vy",
                "fused_cat", "fused_vy_cat", "fused_mix:rows,rows_gx,vpu_y,bd")
EXPERIMENTAL_KERNEL = {"fused": corr_cuda, "pallas": corr_level_cuda, "fused_bd": corr_bd_cuda,
                       "fused_mix:rows,rows_gx,vpu_y,bd": corr_bd_cuda}  # else none


def expect_lookup_counts(label: str, impl: str) -> int:
    """expect_counts for spelling `impl` after one clip forward: 12
    launches of its kernel (EXPERIMENTAL_KERNEL), or no lookup kernel at
    all. Returns that kernel's count (0 for none)."""
    kernel = EXPERIMENTAL_KERNEL.get(impl)
    n = expect_counts(label, kernel or corr_cuda, 12 if kernel else 0)
    return n if kernel else 0


def experimental_small_clips() -> dict:
    """Phase 25 (a). Returns each spelling's row."""
    ref = small_clip_forward("fused", "cuda")
    expect_lookup_counts("phase 25 (a) small clip fused", "fused")
    flow_max = float(np.abs(ref).max())
    if not flow_max > 0 or not np.isfinite(ref).all():
        fail("phase 25 (a): the fused flow is zero or not finite, nothing to compare")
    rows = {}
    for impl in EXPERIMENTAL:
        label = f"phase 25 (a) small clip experimental:{impl}"
        out = small_clip_forward(f"experimental:{impl}", "cuda")
        n = expect_lookup_counts(label, impl)
        diff = float(np.abs(out - ref).max())
        print(f"{label} on the GPU vs fused on the GPU: max abs {diff:.3e}, |flow| max "
              f"{flow_max:.3e} (tol {CLIP_REL:g} x |flow| max = {CLIP_REL * flow_max:.3e})")
        if not np.isfinite(out).all() or not diff <= CLIP_REL * flow_max:
            fail(f"{label}: differs from fused by {diff:.3e} > {CLIP_REL * flow_max:.3e}")
        rows[impl] = dict(max_abs=diff, flow_max=flow_max, launches=n)
    return rows


def experimental_clip(impl: str, acc, images, ref=None, with_profile: bool = False) -> tuple:
    """Phase 25 (b) for one spelling ("fused" first, the yardstick): one
    eager forward under the sync debug mode "error", one warm, one timed;
    (its readings, against `ref` (fused's flow) the max abs distance; its
    flow)."""
    lookup = impl if impl == "fused" else f"experimental:{impl}"
    label = f"phase 25 (b) clip {lookup}"
    est = models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0,
                                      corr_lookup=lookup)
    pairs = est.pairs_fn(iters=acc.cfg.ofe_iters)

    def forward():
        return models.accflow_forward(acc, images, pairs)

    sync_free(label, forward)
    forward()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = forward()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = expect_lookup_counts(label, impl)
    peak = torch.cuda.max_memory_allocated()
    t, b = images.shape[:2]
    if not bool(torch.isfinite(out).all()) or not float(out.abs().max()) > 0:
        fail(f"{label}: the flow is not finite or all zero")
    row = dict(ms=secs * 1e3, frames_per_s=b * t / secs, peak_gib=peak / 2**30, launches=n)
    gap = ""
    if ref is not None:
        row["max_abs_vs_fused"] = float((out - ref).abs().max())
        gap = (f"; bf16 flow differs from fused's by max abs {row['max_abs_vs_fused']:.3e} at "
               f"|flow| max {float(ref.abs().max()):.3e}")
    print(f"{label}: {row['ms']:.2f} ms per forward ({row['frames_per_s']:.3f} frames/s), peak "
          f"{row['peak_gib']:.3f} GiB, {n} lookup-kernel launches{gap}")
    if with_profile and impl == "fused_bd":
        profile_forward(forward, row["ms"])
    del est, pairs
    return row, out


def experimental_phase(fused_phase5_ms: float, with_profile: bool = False) -> dict:
    """Phase 25 (a) and (b) ((c) is phase 4's kernel #2 at the clip shape,
    radius 4; (d) runs in phase 21's launch). Returns their rows and
    seconds."""
    t0 = time.perf_counter()
    small = experimental_small_clips()
    torch.cuda.empty_cache()
    acc, images = clip_inputs()
    full, ref = {}, None
    for impl in ("fused",) + EXPERIMENTAL + ("fused_bd",):
        full[impl], out = experimental_clip(impl, acc, images, ref, with_profile)
        if ref is None:
            ref = out
        del out
        torch.cuda.empty_cache()
    print(f"phase 25 (b) on {smi('name,power.limit')}: ms per forward (one timed after a warm "
          f"one), peak GiB: " + ", ".join(f"{k} {r['ms']:.2f} ({r['peak_gib']:.3f})"
                                          for k, r in full.items())
          + f"; phase 5's fused median {fused_phase5_ms:.2f} ms")
    del acc, images, ref
    torch.cuda.empty_cache()
    return dict(small_clip=small, clip=full, seconds=time.perf_counter() - t0)


# Phase 26, the estimator options (the module docstring lists its parts).
# (a)'s cases are JAX's examples, each of which gave a finite flow in JAX at
# 64^2; each runs its build (kernel #2's (radius, levels), kernel #3's 7
# taps) 12 times a forward (48 under ondemand:16's 4 chunks) and kernel #1
# never. (e)'s GROUP_REL: float32 encoders, cuDNN against the CPU's convs,
# differ by summation order (~1e-6 of the largest value); a wrong group,
# statistic or affine map moves the output by its own size. Fixed before
# the phase's first run.
OPTION_CLIPS = {  # (a): estimator, overrides, kernel module, build key, launches a forward
    "raft (3, 3)": ("raft", dict(corr_levels=3, corr_radius=3), corr_level_cuda, (3, 3), 12),
    "raft (2, 2)": ("raft", dict(corr_levels=2, corr_radius=2), corr_level_cuda, (2, 2), 12),
    "raft (5, 6)": ("raft", dict(corr_levels=5, corr_radius=6), corr_level_cuda, (6, 5), 12),
    "raft-small corr_levels 3": ("raft", dict(small=True, corr_levels=3), corr_level_cuda,
                                 (3, 3), 12),
    "gma (3, 3)": ("gma", dict(corr_levels=3, corr_radius=3), corr_level_cuda, (3, 3), 12),
    "raft (3, 3) experimental:fused_bd": (
        "raft", dict(corr_levels=3, corr_radius=3, corr_lookup="experimental:fused_bd"),
        corr_bd_cuda, 7, 12),
    "raft (3, 3) ondemand:16": ("raft", dict(corr_levels=3, corr_radius=3,
                                             corr_lookup="ondemand:16"), corr_level_cuda,
                                (3, 3), 48),
}
OPTION_BUILDS = ((3, 3), (2, 2), (6, 5))  # kernel #2's builds of (b): (radius, levels)
OPTION_33 = dict(corr_levels=3, corr_radius=3)
GROUP_REL = 1e-5


def option_small_clips() -> dict:
    """Phase 26 (a). Returns each case's row."""
    rows = {}
    for case, (ofe, kw, module, key, per_forward) in OPTION_CLIPS.items():
        kw = dict(kw)
        lookup = kw.pop("corr_lookup", "fused")
        outs, launched = {}, {}
        for where in ("cuda", "cpu"):
            label = f"phase 26 (a) small clip {case} on {where}"
            outs[where] = small_clip_forward(lookup, where, ofe, **kw)
            expect_counts(label, module, per_forward if where == "cuda" else 0)
            launched[where] = dict(module.build_launches)
        if launched["cuda"] != {key: per_forward}:
            fail(f"phase 26 (a) {case}: launches by build {launched['cuda']}, expected "
                 f"{per_forward} of {key}")
        diff = float(np.abs(outs["cuda"] - outs["cpu"]).max())
        flow_max = float(np.abs(outs["cpu"]).max())
        print(f"phase 26 (a) small clip {case} on the GPU vs the CPU: max abs {diff:.3e}, |flow| "
              f"max {flow_max:.3e} (tol {CLIP_REL:g} x |flow| max = {CLIP_REL * flow_max:.3e}); "
              f"{per_forward} launches of the {key} build")
        if not (flow_max > 0 and np.isfinite(outs["cuda"]).all()
                and diff <= CLIP_REL * flow_max):
            fail(f"phase 26 (a) {case}: GPU and CPU differ by {diff:.3e} (|flow| max "
                 f"{flow_max:.3e})")
        rows[case] = dict(max_abs=diff, flow_max=flow_max, launches=per_forward, build=str(key))
    return rows


def option_kernels() -> dict:
    """Phase 26 (b). Returns the rows by build: "r<R> l<L>" (kernel #2),
    "y_contract 7", "backward r3 l3"."""
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {}
    for radius, nl in OPTION_BUILDS:
        levels32, coords = lookup_inputs(22, levels=nl)
        rows[f"r{radius} l{nl}"] = check_lookup(
            f"phase 26 (b) kernel #2 ({radius}, {nl}), clip shape",
            lambda lv, c, o, r=radius: corr_level_cuda.lookup_corr_level(lv, c, r, o),
            levels32, coords, radius, out_dtypes=(f32, bf16), level_dtypes=(bf16,))
        if (radius, nl) == (3, 3):
            rows["y_contract 7"] = check_y_contract(levels32, coords, 3, (0,), (bf16,))["level0"]
        del levels32, coords
        torch.cuda.empty_cache()
    levels32, coords = lookup_inputs(6, 32, 32, levels=3)
    rows["backward r3 l3"] = check_backward(
        "phase 26 (b) backward kernel (3, 3), fine-tune shape",
        corr_backward_cuda.corr_level_lookup_backward_op, 3, levels32, coords,
        ((f32, bf16), (bf16, bf16)))
    del levels32, coords
    torch.cuda.empty_cache()
    return rows


def option_clips() -> dict:
    """Phase 26 (c). Returns each clip's row."""
    t, n, size = 7, 2, 512
    acc, images = clip_inputs(t, n, size)
    shape = (t - 2, n, size, size, 2)
    rows, default_out = {}, None
    for case, make in (
            ("raft (3, 3)", lambda: models.build_flow_estimator("raft", seed=0, **OPTION_33)),
            ("gma (3, 3)", lambda: gma_estimator(**OPTION_33)),
            ("raft (3, 3) corr_volume_dtype float32", lambda: models.build_flow_estimator(
                "raft", seed=0, corr_volume_dtype="float32", **OPTION_33))):
        label = f"phase 26 (c) clip {case}"
        est = make()
        pairs = est.pairs_fn(iters=acc.cfg.ofe_iters)

        def forward(pairs=pairs):
            return models.accflow_forward(acc, images, pairs)

        launches, med, _, out, peak = time_clip(label, forward, corr_level_cuda, shape)
        if corr_level_cuda.build_launches != {(3, 3): 12 * 5}:
            fail(f"{label}: launches by build {corr_level_cuda.build_launches}")
        row = dict(eager_ms=med * 1e3, eager_frames_per_s=n * t / med, eager_peak_gib=peak / 2**30,
                   launches=launches)
        if "float32" in case:
            row["max_abs_vs_bf16_levels"] = float((out - default_out).abs().max())
            print(f"{label}: float32 levels against the default's bfloat16 levels: max abs "
                  f"{row['max_abs_vs_bf16_levels']:.3e} at |flow| max "
                  f"{float(default_out.abs().max()):.3e}; peak {row['eager_peak_gib']:.3f} GiB")
        else:
            torch.cuda.empty_cache()
            row["graphed"] = graphed_clip(f"{label}, graphed", serving.build_serving_fn(est, acc),
                                          images, out, corr_level_cuda, 12)
            if row["graphed"]["max_abs_vs_eager"] != 0:
                fail(f"{label}: the graphed clip is not bit-equal to the eager one")
        if case == "raft (3, 3)":
            default_out = out
        rows[case] = row
        del est, pairs, out
        torch.cuda.empty_cache()
    del acc, images, default_out
    torch.cuda.empty_cache()
    return rows


def option_training(root: str, tmp: str) -> dict:
    """Phase 26 (d). Returns the GPU-vs-CPU step's row and the run's."""
    step = finetune_gpu_vs_cpu(**OPTION_33)
    run = engine_run("RAFT.yml corr_levels 3, corr_radius 3",
                     train_opts("RAFT.yml", root, Path(tmp) / "finetune_33", **OPTION_33), 6,
                     finetune=True, level_kernel=True)
    run.pop("state")
    builds = (dict(corr_level_cuda.build_launches), dict(corr_backward_cuda.level_build_launches))
    if set(builds[0]) != {(3, 3)} or set(builds[1]) != {(3, 3)}:
        fail(f"phase 26 (d) RAFT.yml (3, 3): launches by build {builds}")
    run["builds"] = {k: {str(b): n for b, n in d.items()} for k, d in zip(("fwd", "bwd"), builds)}
    gc.collect()
    torch.cuda.empty_cache()
    return dict(gpu_vs_cpu=step, raft_yml=run)


def group_encoder(cls, seed: int):
    """`cls` (BasicEncoder or SmallEncoder) with 128 outputs and norm_fn
    "group", its weights from seed 0 and each group norm's affine map drawn
    from `seed` (scale in [0.5, 1.5], bias N(0, 0.1)), on the CPU."""
    enc = init_weights(cls(128, "group"), 0)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in enc.modules():
            if hasattr(m, "num_groups"):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)
    return enc


def option_group_norm() -> dict:
    """Phase 26 (e). Returns each encoder's row."""
    rows = {}
    gen = torch.Generator().manual_seed(26)
    x = torch.rand((2, 3, 64, 48), generator=gen) * 2 - 1
    x512 = (torch.rand((2, 3, 512, 512), generator=gen) * 2 - 1).cuda()
    for name, cls in (("basic", BasicEncoder), ("small", SmallEncoder)):
        enc = group_encoder(cls, 26)
        with torch.no_grad():
            with tf32(False):
                ref = enc(x)
                got = enc.cuda()(x.cuda()).cpu()
            diff, top = float((got - ref).abs().max()), float(ref.abs().max())
            bf = x512.to(torch.bfloat16)
            enc(bf)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = enc(bf)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        print(f"phase 26 (e) {name} encoder, norm_fn group: GPU vs CPU f32 max abs {diff:.3e} "
              f"(bar {GROUP_REL:g} x {top:.3e}); bf16 at 512^2, batch 2: {tuple(y.shape)} in "
              f"{ms:.2f} ms (one call after a warm one)")
        if not (diff <= GROUP_REL * top and y.dtype == torch.bfloat16
                and bool(torch.isfinite(y).all())):
            fail(f"phase 26 (e) {name} encoder: GPU vs CPU {diff:.3e}, bf16 finite "
                 f"{bool(torch.isfinite(y).all())}")
        rows[name] = dict(max_abs=diff, max_abs_bar=GROUP_REL * top, bf16_512_ms=ms)
        del enc, y
    return rows


def option_launches(options: dict, spatial: dict, build) -> dict:
    """The kernels line's launches of kernel #2's `build` ((radius, levels)):
    phase 26 (c)'s RAFT clip for (3, 3) (5 eager forwards, bf16 in and
    out, the row's own configuration), else phase 26 (a)'s f32 small clip."""
    if build == (3, 3):
        return dict(launches=options["clips"]["raft (3, 3)"]["launches"],
                    launches_in="phase 26 (c), the CVO-6 clip with RAFT at corr_levels 3, "
                                "corr_radius 3, 5 eager forwards (bf16 in and out)",
                    spatial_launches=spatial["26f pair"]["launches"],
                    spatial_launches_in="phase 26 (f), each of two gloo ranks on one card, a "
                                        "40x64 f32 pair at 2 iterations")
    case = next(c for c, v in OPTION_CLIPS.items() if v[3] == build and v[2] is corr_level_cuda)
    return dict(launches=options["small_clips"][case]["launches"],
                launches_in=f"phase 26 (a), the f32 small clip with {case} (f32 in and out)")


def options_phase(root: str, tmp: str) -> dict:
    """Phase 26 (a)-(e); (f) runs in phase 21's launch. Returns the rows."""
    t0 = time.perf_counter()
    out = dict(small_clips=option_small_clips(), kernels=option_kernels(), clips=option_clips(),
               training=option_training(root, tmp), group_norm=option_group_norm())
    out["seconds"] = time.perf_counter() - t0
    clips = out["clips"]
    print(f"phase 26 on {smi('name,power.limit')}: CVO-6 clip eager / graphed ms "
          + ", ".join(f"{k} {r['eager_ms']:.2f} / "
                      f"{r['graphed']['median_ms'] if 'graphed' in r else float('nan'):.2f}"
                      for k, r in clips.items())
          + f"; RAFT.yml (3, 3) {out['training']['raft_yml']['ms_per_step']:.2f} ms per step; "
          f"{out['seconds']:.1f} s")
    return out


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


class EvalGraphs:
    """Phase 8's view into evaluate_cvo's graph: while active,
    evaluate.CudaGraphed is a subclass that keeps each instance and times
    each call to its end (synchronised: the first call warms up, captures
    and replays), or with eager=True the identity, so that the same run
    goes eagerly for the comparison."""

    def __init__(self, eager: bool = False):
        self.eager, self.made, self.calls = eager, [], []

    def __enter__(self):
        self._cls = evaluate.CudaGraphed
        probe = self

        class Timed(graphs.CudaGraphed):
            def __init__(self, fn):
                super().__init__(fn)
                probe.made.append(self)

            def __call__(self, *args):
                t0 = time.perf_counter()
                out = super().__call__(*args)
                torch.cuda.synchronize()
                probe.calls.append(time.perf_counter() - t0)
                return out

        evaluate.CudaGraphed = (lambda fn: fn) if self.eager else Timed
        return self

    def __exit__(self, *exc):
        evaluate.CudaGraphed = self._cls


def eval_weights():
    """Phase 8's trees: AccFlow from seed 1 with its ZeroConv from seed 2,
    GMA from seed 0 with its gamma from seed 3."""
    acc = models.init_accflow(models.AccFlowConfig(compute_dtype="bfloat16"), seed=1,
                              device="cpu")
    perturb_zero_conv(acc, 2)
    gma_est = models.build_flow_estimator("gma", seed=0, device="cpu")
    perturb_gamma(gma_est.model, 3)
    return to_jax_params(acc), to_jax_params(gma_est.model)


def eval_cvo_synthetic(root: str, clips: int = 10) -> None:
    """Phase 8's data: `clips` synthetic CVOR test clips of 512^2."""
    t0 = time.perf_counter()
    write_synthetic_cvor(root, num_train=0, num_test=clips, h=512, w=512)
    print(f"eval: wrote {clips} synthetic CVOR clips of 512^2 in "
          f"{time.perf_counter() - t0:.2f} s")


def eval_phase():
    """Phase 8: the CVO evaluation at full width on synthetic CVOR clips
    (10 of 512^2, written to a temporary directory): one warm-up call, then
    acc|raft with fused, fused_bd and fused_bd2, direct|raft with fused
    and fused_bd, and acc|gma and direct|gma with fused, batch 10
    (micro-batch 5), 12 iterations, bfloat16, RAFT and GMA from seed 0
    (GMA's gamma from seed 3) and AccFlow from seed 1 with its ZeroConv
    perturbed. Each micro-batch replays evaluate_cvo's CUDA graph (the
    first call warms up WARMUP times, captures and replays: its launches
    are counted WARMUP + 1 times, the second call's none); the first
    call's and the replay's seconds apart (EvalGraphs); then the same run
    eagerly, whose EPEs the graphed ones must equal bit for bit. Returns
    {(model, lookup): row}."""
    clips, batch, n_batches = 10, 10, 1
    acc_tree, gma_tree = eval_weights()
    # (model, lookup, kernel, launches per micro-batch call)
    runs = (("acc|raft", "fused", corr_cuda, 12), ("acc|raft", "experimental:fused_bd", corr_bd_cuda, 12),
            ("acc|raft", "experimental:fused_bd2", corr_bd_cuda, 24),
            ("direct|raft", "fused", corr_cuda, 12),
            ("direct|raft", "experimental:fused_bd", corr_bd_cuda, 12),
            ("acc|gma", "fused", corr_cuda, 12), ("direct|gma", "fused", corr_cuda, 12))
    rows = {}
    print(f"eval: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated before its runs "
          "(earlier phases' tensors; in each run's peak)")
    with tempfile.TemporaryDirectory() as tmp:
        root = str(Path(tmp) / "cvor")
        eval_cvo_synthetic(root, clips)

        def run(model, lookup):
            return evaluate.evaluate_cvo(
                model, root, batch=batch, iters=12, compute_dtype="bfloat16",
                corr_lookup=lookup, acc_params=acc_tree, device="cuda",
                params=gma_tree if "gma" in model else None,
                result_file=str(Path(tmp) / "result.txt"))

        run("acc|raft", "fused")  # warm-up: cuDNN algorithm choice at batch 5
        for model, lookup, kernel, want in runs:
            out = {}
            for mode in ("graphed", "eager"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.perf_counter()
                with EvalGraphs(eager=mode == "eager") as probe:
                    res = run(model, lookup)
                torch.cuda.synchronize()
                secs = (time.perf_counter() - t0) / n_batches
                calls = 2 * n_batches  # micro-batches
                counted = want * ((graphs.WARMUP + 1) if mode == "graphed" else calls)
                launches = expect_counts(f"eval {model} {lookup} {mode}", kernel, counted)
                if mode == "graphed" and ([g.captures for g in probe.made] != [1]
                                          or len(probe.calls) != calls):
                    fail(f"eval {model} {lookup}: captures {[g.captures for g in probe.made]}, "
                         f"{len(probe.calls)} calls")
                out[mode] = dict(res, s_per_batch=secs, peak_gib=torch.cuda.max_memory_allocated()
                                 / 2**30, launches=launches, call_s=probe.calls)
            res, ref = out["graphed"], out["eager"]
            if not all(np.isfinite(res[k]) for k in ("all", "vis", "occ")):
                fail(f"eval {model} {lookup}: EPE not finite {res}")
            if any(res[k] != ref[k] for k in ("all", "vis", "occ")):
                fail(f"eval {model} {lookup}: graphed EPEs {res} differ from eager {ref}")
            print(f"eval {model} {lookup}: EPE all {res['all']:.4f} vis {res['vis']:.4f} "
                  f"occ {res['occ']:.4f} (graphed, bit-equal to eager); {res['s_per_batch']:.3f} s "
                  f"per batch of {batch} (micro-batch 5) graphed: first call (2 warm-ups, capture, "
                  f"replay) {res['call_s'][0]:.3f} s, replay {res['call_s'][1] * 1e3:.2f} ms; eager "
                  f"{ref['s_per_batch']:.3f} s per batch; peak memory graphed "
                  f"{res['peak_gib']:.3f} GiB, eager {ref['peak_gib']:.3f} GiB; launches counted "
                  f"{res['launches']} graphed, {ref['launches']} eager")
            rows[model, lookup] = dict(res, eager_s_per_batch=ref["s_per_batch"],
                                       eager_peak_gib=ref["peak_gib"],
                                       eager_launches=ref["launches"],
                                       capture_call_s=res["call_s"][0],
                                       replay_ms=res["call_s"][1] * 1e3)
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


class StepProbe:
    """Phases 14's and 15's view into a training loop, without changing
    it: while active it wraps the factory `module.factory`
    (engine.make_acc_train_step, finetune.make_finetune_step, which the
    engines call with graphed=True) so that each train step records its
    start time, its kernel launches as the wrappers count them, its loss
    tensor and its kind ("eager" for a graphed step's warm-ups, "capture",
    "replay"), and each validation batch its launches and kind ("capture":
    the warm-ups, the capture and one replay; "replay"). The train step
    numbered `profile_at` (1-based in this run) runs under torch.profiler
    (a replay: its kernels, which no counter sees). The plain lookups and
    the plain backward are wrapped too, to count their calls (none is
    allowed on the card)."""

    PLAIN = ((corr_cuda, "lookup_corr_plain"), (corr_level_cuda, "lookup_corr_plain"),
             (corr_backward_cuda, "lookup_corr_plain_backward"))

    def __init__(self, module, factory: str, profile_at=None):
        self.module, self.factory, self.profile_at = module, factory, profile_at
        self.starts, self.losses, self.kinds, self.valid_kinds = [], [], [], []
        self.steps, self.valid = [], []  # each call's launches: {COUNTERS name: n}
        self.plain_calls = 0
        self.profile_rows = None
        self.train_step = self.valid_step = None

    def __enter__(self):
        self._make = getattr(self.module, self.factory)
        self._plain = [getattr(m, name) for m, name in self.PLAIN]

        def make(*a, **k):
            step, valid = self._make(*a, **k)
            self.train_step, self.valid_step = step, valid

            def probed_step(*args):
                self.starts.append(time.perf_counter())
                c0, e0, k0 = launch_counts(), step.eager_calls, step.captures
                if len(self.starts) == self.profile_at:
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        loss, metrics = step(*args)
                        torch.cuda.synchronize()
                    self.profile_rows = device_rows(prof, 1)
                else:
                    loss, metrics = step(*args)
                self.steps.append({k: v - c0[k] for k, v in launch_counts().items()})
                self.kinds.append("eager" if step.eager_calls > e0 else
                                  "capture" if step.captures > k0 else "replay")
                self.losses.append(loss)
                return loss, metrics

            def probed_valid(*args):
                c0, k0 = launch_counts(), valid.captures
                out = valid(*args)
                self.valid.append({k: v - c0[k] for k, v in launch_counts().items()})
                self.valid_kinds.append("capture" if valid.captures > k0 else "replay")
                return out

            return probed_step, probed_valid

        def counted(plain):
            def fn(*a, **k):
                self.plain_calls += 1
                return plain(*a, **k)
            return fn

        setattr(self.module, self.factory, make)
        for (m, name), plain in zip(self.PLAIN, self._plain):
            setattr(m, name, counted(plain))
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.factory, self._make)
        for (m, name), plain in zip(self.PLAIN, self._plain):
            setattr(m, name, plain)

    def check_graphs(self, label: str, per_call: dict, per_valid: dict) -> dict:
        """The run's graphs: its steps were graphs.WARMUP eager ones, the
        capture, then replays, with `per_call` launches ({COUNTERS name: n})
        in each eager and capture call and none counted in a replay; its
        validation batches a capture (graphs.WARMUP + 1 times `per_valid`)
        then replays; one capture of each step; the profiled replay launched
        the forward and backward kernels as often as `per_call` says (by the
        CUDA kernels' names). Returns the profiled replay's numbers."""
        want = ["eager"] * graphs.WARMUP + ["capture"] + ["replay"] * (len(self.kinds) - 3)
        if self.kinds != want:
            fail(f"{label}: steps ran as {self.kinds}, expected {want}")
        if self.valid_kinds and self.valid_kinds != ["capture"] + ["replay"] * (
                len(self.valid_kinds) - 1):
            fail(f"{label}: validation batches ran as {self.valid_kinds}")
        for kind, c in zip(self.kinds, self.steps):
            got = {k: v for k, v in c.items() if v}
            if got != (per_call if kind != "replay" else {}):
                fail(f"{label}: launches counted in a {kind} step {got}, expected "
                     f"{per_call if kind != 'replay' else {}}")
        cap = {k: v * (graphs.WARMUP + 1) for k, v in per_valid.items()}
        for kind, c in zip(self.valid_kinds, self.valid):
            got = {k: v for k, v in c.items() if v}
            if got != (cap if kind == "capture" else {}):
                fail(f"{label}: launches counted in a {kind} validation batch {got}")
        if self.train_step.captures != 1 or self.valid_step.captures != (1 if self.valid else 0):
            fail(f"{label}: captures {self.train_step.captures} (train step), "
                 f"{self.valid_step.captures} (validation)")
        rows = self.profile_rows or []
        fwd = sum(n for _, n, name in rows if "corr_window_kernel" in name)
        bwd = sum(n for _, n, name in rows if "corr_window_backward_kernel" in name)
        want_fwd = sum(v for k, v in per_call.items() if not k.endswith("_backward"))
        want_bwd = sum(v for k, v in per_call.items() if k.endswith("_backward"))
        if (fwd, bwd) != (want_fwd, want_bwd):
            fail(f"{label}: the profile of one replay saw {fwd} forward and {bwd} backward "
                 f"lookup launches, expected {want_fwd} and {want_bwd}")
        busy = sum(r[0] for r in rows)
        if not busy > 0:
            fail(f"{label}: the profile of one replay saw no device time")
        kinds = print_by_kind(f"{label}: one replay's device time by kind:", rows)
        return dict(busy_ms=busy, kernels=sum(r[1] for r in rows), lookup_launches=fwd,
                    backward_launches=bwd, by_kind=kinds)


class TBStub:
    """A TBLogger stand-in that keeps what train_acc writes."""

    def __init__(self):
        self.writes = []

    def write_dict(self, scalars, step=None):
        self.writes.append((dict(scalars), step))


def train_opts(config: str, root: str, run_dir: Path, **over):
    """configs/<config> as shipped (batch 6, 256^2, bf16, hidden 128, noise,
    lr 1.2e-4), with the data, the run's directories, the validation cadence
    and the visual samples set for this phase; no flow_pretrained file
    exists here, so the frozen estimator keeps its seed-0 weights."""
    opt = parse_options(str(REPO / "configs" / config))
    opt.update(dataset_root=root, log_dir=str(run_dir / "logs"), ckpt_dir=str(run_dir / "ckpt"),
               flow_pretrained=None, visual_samples=[0], seed=0, **over)
    return opt


def check_resumed(label: str, run: dict, state) -> None:
    """A resume "auto" after 13 steps ran 5 more (WARMUP eager, a capture,
    replays) and its AdamW count and schedule went on from 13 to 18."""
    opt = state.optimizer
    counts = {float(v["step"]) for v in opt.optimizer.state.values()}
    if (run["last_step"], run["steps"], counts, opt.scheduler.last_epoch) != (18, 5, {18.0}, 18):
        fail(f"{label} resume: {run['steps']} steps to step {run['last_step']}, AdamW counts "
             f"{counts}, schedule at {opt.scheduler.last_epoch}; expected 5 to 18")
    print(f"{label} resume: restored step 13, ran steps 14..18 as {', '.join(run['kinds'])} "
          "(captured again); AdamW's count and the schedule at 18")


def engine_run(label: str, opt, steps: int, finetune: bool = False, small: bool = False,
               level_kernel: bool = False) -> dict:
    """train_acc (or with `finetune`, fine_tune) under a StepProbe from
    zeroed counts, up to step `steps`, its steps and validation batches
    replayed from CUDA graphs (StepProbe.check_graphs): every loss finite;
    per eager or captured step 12 launches of the forward kernel (#1, or #2
    for RAFT-small and, with `level_kernel`, for corr_levels or corr_radius
    other than 4) and, fine-tuning, as many of its backward kernel, per
    validation batch 12 (fine-tuning: VALID_ITERS = 20) forward launches
    times WARMUP + 1 at its capture, none counted in a replay, and as many
    seen in the profile of the last step (a replay); no other kernel, no
    plain lookup or backward. Seconds per step: the median interval between
    step starts over the replays but the last (profiled) one, leaving out
    the steps a validation follows. The idle share is 1 - the profiled
    replay's device busy time / that median. Returns the run's numbers."""
    level_kernel = small or level_kernel
    fwd, bwd = ("corr_level_lookup", "corr_level_lookup_backward") if level_kernel else (
        "corr_lookup", "corr_lookup_backward")
    module, factory, run = ((ft, "make_finetune_step", ft.fine_tune) if finetune else
                            (engine, "make_acc_train_step", engine.train_acc))
    per_call = {fwd: 12, bwd: 12} if finetune else {fwd: 12}
    per_valid = {fwd: ft.VALID_ITERS if finetune else 12}
    what = "fine-tune" if finetune else "train"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tb = TBStub()
    reset_counts()
    t0 = time.perf_counter()
    first = int(opt.get("resume") is not None and CheckpointManager(opt.ckpt_dir).latest_step()
                or 0) + 1
    with StepProbe(module, factory, profile_at=steps - first + 1) as probe:
        state = run(opt, max_steps=steps, tb=tb)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n, nv = len(probe.starts), len(probe.valid)
    if state.step - n + 1 != first:
        fail(f"{what} {label}: ran steps {state.step - n + 1}..{state.step}, expected from {first}")
    replay = probe.check_graphs(f"{what} {label}", per_call, per_valid)
    graphed_calls = graphs.WARMUP + 1
    expect_counts(f"{what} {label}", corr_level_cuda if level_kernel else corr_cuda,
                  12 * graphed_calls + per_valid[fwd] * graphed_calls * min(nv, 1),
                  **({bwd: 12 * graphed_calls} if finetune else {}))
    if probe.plain_calls:
        fail(f"{what} {label}: the plain lookup or backward ran {probe.plain_calls} times")
    losses = [float(l) for l in probe.losses]
    if not all(np.isfinite(losses)):
        fail(f"{what} {label}: losses not finite {losses}")
    per_step = [b - a for i, (a, b) in enumerate(zip(probe.starts, probe.starts[1:]), first)
                if probe.kinds[i - first] == "replay" and i % opt.valid_freq]
    med = statistics.median(per_step) if per_step else float("nan")
    replay["idle_share"] = 1.0 - replay["busy_ms"] / (med * 1e3)
    val = [s["val/epe"] for s, _ in tb.writes if "val/epe" in s]
    batch = opt.batch_per_gpu
    print(f"{what} {label}: steps {first}..{state.step} in {secs:.2f} s (with set-up, "
          f"validation, checkpoints) as {', '.join(probe.kinds)}; median {med * 1e3:.2f} ms per "
          f"replayed step over {len(per_step)} = {batch / med:.3f} clips/s (batch {batch}, "
          f"{opt.image_size[0]}x{opt.image_size[1]}); peak memory {peak / 2**30:.3f} GiB; one "
          f"replay: device busy {replay['busy_ms']:.2f} ms (idle {100 * replay['idle_share']:.1f} "
          f"% of the median), {replay['kernels']} kernels, {replay['lookup_launches']} forward "
          f"and {replay['backward_launches']} backward lookup launches; counted per eager or "
          f"captured step {per_call}, per validation capture "
          f"{ {k: v * graphed_calls for k, v in per_valid.items()} } ({nv} validation batches, "
          f"{probe.valid_kinds}); plain calls {probe.plain_calls}")
    print(f"{what} {label}: losses {', '.join(f'{l:.4f}' for l in losses)}; validation "
          f"EPE {val}")
    return dict(state=state, steps=n, last_step=state.step, s_total=secs, kinds=probe.kinds,
                ms_per_step=med * 1e3, ms_steps=[t * 1e3 for t in per_step],
                clips_per_s=batch / med, peak_gib=peak / 2**30, losses=losses, val_epe=val,
                launches_per_step=per_call, launches_per_valid_batch=per_valid,
                valid_batches=nv, replay=replay, launches=launch_counts(),
                plain_calls=probe.plain_calls)


def train_state(model, optimizer) -> dict:
    """Parameters, AdamW's moments and the buffers (BatchNorm running
    statistics), copies, by group; groups without tensors left out."""
    named = list(model.named_parameters())
    st = optimizer.optimizer.state
    groups = {"parameters": {k: p.detach().clone() for k, p in named},
              "exp_avg": {k: st[p]["exp_avg"].clone() for k, p in named},
              "exp_avg_sq": {k: st[p]["exp_avg_sq"].clone() for k, p in named},
              "buffers": {k: b.clone() for k, b in model.named_buffers()}}
    return {g: v for g, v in groups.items() if v}


def run_steps(build, graphed: bool, inputs) -> dict:
    """build(graphed) -> (model, optimizer, train_step, valid_step,
    eager_valid_step), made afresh; one train step per tuple of `inputs`,
    noise from a card generator seeded 1, each step timed to its loss read
    (host clock, as the engines read it) and its mesh collectives and bytes
    counted. Returns the run."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, optimizer, step, valid, eager_valid = build(graphed)
    gen = torch.Generator(device="cuda").manual_seed(1)
    losses, secs, counts = [], [], []
    for args in inputs:
        c0 = mesh.counts()
        t0 = time.perf_counter()
        losses.append(float(step(*args, gen)[0]))
        secs.append(time.perf_counter() - t0)
        counts.append(tuple(a - b for a, b in zip(mesh.counts(), c0)))
    return dict(model=model, optimizer=optimizer, step=step, valid=valid,
                eager_valid=eager_valid, gen=gen, losses=losses, secs=secs, counts=counts,
                peak=torch.cuda.max_memory_allocated(), state=train_state(model, optimizer))


def nccl_share(rows) -> tuple:
    """(device ms of NCCL's kernels, their share of the device busy time) in
    a profile's rows (device_rows)."""
    busy = sum(r[0] for r in rows)
    nccl = sum(ms for ms, _, name in rows if "nccl" in name.lower())
    return nccl, (nccl / busy if busy > 0 else 0.0)


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (warn only: an op without one runs
    as it is) within the block."""
    was, warn_only = (torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def distances(run, ref) -> dict:
    """Each step's loss gap and each state group's relative L2 of `run`
    from `ref`."""
    return dict(loss_gaps=[abs(a - b) for a, b in zip(run["losses"], ref["losses"])],
                **{g: rel_l2(run["state"][g], ref["state"][g]) for g in ref["state"]})


def graph_readings(label: str, e1: dict, g: dict, inputs, per_call: dict, valid_inputs) -> dict:
    """graph_vs_eager's checks and readings of an eager run `e1` and a
    graphed run `g` (run_steps): WARMUP eager calls and one capture,
    AdamW's count, the learning rate and the generator's state as eager's,
    every step's mesh collectives and bytes as the eager step's (a replay
    adds what its capture counted); ms per step (eager: steps 2 on;
    graphed: the replays, steps 4 on), the capture call, peaks; one more
    replay under torch.profiler (device busy, idle share, NCCL's kernels'
    share, the forward and backward lookup launches, which must match
    `per_call`); one more eager step and one more replay, updates
    included, under the sync debug mode "error"; with `valid_inputs`, the
    graphed validation step against the eager one on the graphed run's
    model, bit-equal (its first call warms up and captures)."""
    step, opt_g, opt_e = g["step"], g["optimizer"], e1["optimizer"]
    counts = {float(v["step"]) for v in opt_g.optimizer.state.values()}
    if (step.eager_calls, step.captures) != (graphs.WARMUP, 1) or counts != {float(len(inputs))} \
            or opt_g.lr != opt_e.lr or not torch.equal(g["gen"].get_state(), e1["gen"].get_state()):
        fail(f"{label} graphed: eager calls {step.eager_calls}, captures {step.captures}, AdamW "
             f"counts {counts}, lr {opt_g.lr} vs {opt_e.lr}, generator as eager's "
             f"{torch.equal(g['gen'].get_state(), e1['gen'].get_state())}")
    if g["counts"] != e1["counts"]:
        fail(f"{label} graphed: collectives and bytes per step {g['counts']}, eager "
             f"{e1['counts']}")
    eager_ms = statistics.median(e1["secs"][1:]) * 1e3
    graphed_ms = statistics.median(g["secs"][graphs.WARMUP + 1:]) * 1e3
    rows = profile_rows(lambda: step(*inputs[0], g["gen"]))
    busy = sum(r[0] for r in rows)
    fwd = sum(n for _, n, name in rows if "corr_window_kernel" in name)
    bwd = sum(n for _, n, name in rows if "corr_window_backward_kernel" in name)
    want = (sum(v for k, v in per_call.items() if not k.endswith("_backward")),
            sum(v for k, v in per_call.items() if k.endswith("_backward")))
    if (fwd, bwd) != want or not busy > 0:
        fail(f"{label} graphed: one replay's profile saw {fwd} forward and {bwd} backward "
             f"lookup launches, {busy} ms busy; expected {want}")
    sync_free(f"{label} eager step, update included", lambda: e1["step"](*inputs[0], e1["gen"]))
    sync_free(f"{label} graphed step (a replay)", lambda: step(*inputs[0], g["gen"]))
    for i, args in enumerate(valid_inputs):
        got, ref = g["valid"](*args), g["eager_valid"](*args)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"{label}: graphed validation batch {i} differs from eager")
    if valid_inputs and g["valid"].captures != 1:
        fail(f"{label}: validation captures {g['valid'].captures}")
    nccl_ms, share = nccl_share(rows)
    row = dict(eager_ms=eager_ms, graphed_ms=graphed_ms,
               eager_ms_steps=[t * 1e3 for t in e1["secs"]],
               graphed_ms_steps=[t * 1e3 for t in g["secs"]],
               capture_call_s=g["secs"][graphs.WARMUP], busy_ms=busy,
               idle_share=1.0 - busy / graphed_ms, kernels_per_replay=sum(r[1] for r in rows),
               lookup_launches_per_replay=fwd, backward_launches_per_replay=bwd,
               nccl_ms_per_replay=nccl_ms, nccl_share=share,
               collectives_per_step=e1["counts"][-1][0], bytes_per_step=e1["counts"][-1][1],
               eager_peak_gib=e1["peak"] / 2**30, graphed_peak_gib=g["peak"] / 2**30,
               valid_bit_equal=len(valid_inputs))
    print(f"{label}: eager {eager_ms:.2f} ms per step, graphed {graphed_ms:.2f} ms (replays; "
          f"the capture call {row['capture_call_s']:.2f} s); one replay: device busy {busy:.2f} "
          f"ms (idle {100 * row['idle_share']:.1f} %, NCCL {nccl_ms:.3f} ms = "
          f"{100 * share:.2f} %), {row['kernels_per_replay']} kernels, {fwd} forward and {bwd} "
          f"backward lookup launches; collectives and bytes per step {e1['counts'][-1]}, a "
          f"graphed step's as eager's; peak eager {row['eager_peak_gib']:.3f} GiB, graphed "
          f"{row['graphed_peak_gib']:.3f} GiB"
          + (f"; {len(valid_inputs)} validation batches bit-equal" if valid_inputs else ""))
    return row


def graph_vs_eager(label: str, build, inputs, per_call: dict, valid_inputs=(),
                   defaults: bool = True) -> dict:
    """Phases 14d and 15f (and 19a's steps with a spatial handle): train
    steps on `inputs` from the same init (build, as run_steps takes it) and
    generator, eagerly (the step make_*_step returns) and graphed
    (graphed=True, the engines' step: graphs.WARMUP eager steps, the
    capture replayed once, replays). With `defaults`, first an eager and a
    graphed run with torch's default numerics (graph_readings; the graphed
    run's distance from eager a reading). Then, under torch's deterministic
    algorithms, two eager runs and a graphed one (graph_readings of these
    without `defaults`): each step's loss and each state group of the
    graphed run against the first eager run's within GRAPH_SPREAD x the
    eager runs' distance + GRAPH_FLOOR."""
    row = {"steps": len(inputs)}
    if defaults:
        e1, g = run_steps(build, False, inputs), run_steps(build, True, inputs)
        row["default_numerics"] = distances(g, e1)
        row.update(graph_readings(label, e1, g, inputs, per_call, valid_inputs))
        dflt = row["default_numerics"]
        print(f"{label}: graphed vs eager over {len(inputs)} steps with torch's defaults (a "
              f"reading): loss gaps {', '.join(f'{x:.2e}' for x in dflt['loss_gaps'])}; "
              + "; ".join(f"{k} {v:.3e}" for k, v in dflt.items() if k != "loss_gaps"))
        del e1, g
    with deterministic():
        d1, d2, dg = (run_steps(build, graphed, inputs) for graphed in (False, False, True))
        spread, got = distances(d2, d1), distances(dg, d1)
        if not defaults:
            row.update(graph_readings(label, d1, dg, inputs, per_call, valid_inputs))
    held = {"loss": dict(gaps=got["loss_gaps"], eager_spread=spread["loss_gaps"])}
    if not all(gap <= GRAPH_SPREAD * sp + GRAPH_FLOOR * abs(b)
               for gap, sp, b in zip(got["loss_gaps"], spread["loss_gaps"], d1["losses"])):
        fail(f"{label} graphed (deterministic algorithms): losses {dg['losses']} vs eager "
             f"{d1['losses']} and {d2['losses']}")
    for group in d1["state"]:
        bar = GRAPH_SPREAD * spread[group] + GRAPH_FLOOR
        held[group] = dict(graphed_vs_eager=got[group], eager_spread=spread[group], bar=bar)
        if not got[group] <= bar:
            fail(f"{label} graphed (deterministic algorithms): {group} {got[group]:.3e} from "
                 f"eager, over {bar:.3e}")
    row["deterministic"] = held
    print(f"{label}: graphed vs eager under deterministic algorithms: loss gaps "
          f"{', '.join(f'{x:.2e}' for x in got['loss_gaps'])} (eager run-to-run "
          f"{', '.join(f'{x:.2e}' for x in spread['loss_gaps'])}); "
          + "; ".join(f"{k} {v['graphed_vs_eager']:.3e} (eager {v['eager_spread']:.3e}, bar "
                      f"{v['bar']:.3e})" for k, v in held.items() if "bar" in v))
    del d1, d2, dg
    gc.collect()
    torch.cuda.empty_cache()
    return row


def one_step_grads(pairs, model, images, labels, grad_accum: int = 1):
    """One step's loss and gradients (no update), TF32 off, as
    engine.make_acc_train_step computes them, with the frozen estimator's
    `pairs` (FlowEstimator.pairs_fn): {name: float32 CPU grad}."""
    model.zero_grad(set_to_none=True)
    with tf32(False):
        loss, _, _ = accumulate_grads(
            lambda im, lb: sequence_loss_acc(accflow_train_forward(model, im, pairs), lb),
            grad_accum, images, labels, axis=1)
    return float(loss), {k: p.grad.detach().float().cpu() for k, p in model.named_parameters()}


def rel_l2(got: dict, ref: dict, keys=None) -> float:
    keys = list(ref) if keys is None else keys
    num = sum(float(((got[k] - ref[k]) ** 2).sum()) for k in keys)
    return (num / sum(float((ref[k] ** 2).sum()) for k in keys)) ** 0.5


def bf16_rounded(grads: dict) -> dict:
    return {k: g.to(torch.bfloat16).float() for k, g in grads.items()}


def bf16_share(grads: dict) -> float:
    """The share of the gradient elements that are bfloat16 values."""
    same = sum(int((r == grads[k]).sum()) for k, r in bf16_rounded(grads).items())
    return same / sum(g.numel() for g in grads.values())


def micro_batch_pairs(pairs, k: int):
    """`pairs` run on k micro-batches of the clip (axis 1) and the flows put
    back in its (P*N, H, W, 2) order: the frozen estimator at grad_accum's
    batch, for a plain step of the accumulator."""
    def fn(images, src, dst):
        parts = [pairs(part, src, dst) for part in images.chunk(k, dim=1)]
        return torch.cat([f.view(len(src), -1, *f.shape[1:]) for f in parts], 1).flatten(0, 1)

    return fn


def small_train_batch(where: str):
    """Phase 14b's batch: 2 clips of 4 frames at 64^2 (uint8 values) and
    their 2 label flows, from seed 5, on `where`."""
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (2, 64, 64, 12)).astype(np.float32)
    labels = (4.0 * rng.standard_normal((2, 64, 64, 4))).astype(np.float32)
    return (engine.to_clip(torch.from_numpy(imgs)).to(where),
            engine.to_flow_seq(torch.from_numpy(labels)).to(where))


def small_train_models(where: str, **cfg):
    """RAFT at 4 iterations from seed 0 and AccFlow hidden 32 from seed 1
    with its ZeroConv from seed 2, float32, on `where`."""
    est = models.build_flow_estimator("raft", compute_dtype="float32", iters=4, seed=0,
                                      device=where)
    acc = models.init_accflow(models.AccFlowConfig(hidden=32, compute_dtype="float32", **cfg),
                              seed=1, device="cpu")
    perturb_zero_conv(acc, 2)
    return est, acc.to(where)


def train_gpu_vs_cpu(direction: str = "backward") -> dict:
    """Phase 14b (17b with direction "forward": the F0N step): one train
    step's loss and gradients at 64^2, T=4, batch 2, RAFT at 4 iterations,
    hidden 32, float32, TF32 off, from the same init and batch: the GPU
    through kernel #1 (4 launches) against the CPU through the plain lookup
    (TRAIN_* bars)."""
    out = {}
    label = "train step 64^2" + (" F0N" if direction == "forward" else "")
    for where in ("cuda", "cpu"):
        est, acc = small_train_models(where, direction=direction)
        images, labels = small_train_batch(where)
        reset_counts()
        out[where] = one_step_grads(est.pairs_fn(), acc, images, labels)
        expect_counts(f"{label} on {where}", corr_cuda, 4 if where == "cuda" else 0)
    (loss_g, g), (loss_c, c) = out["cuda"], out["cpu"]
    ctx = [k for k in c if k.startswith("context.")]
    rest = [k for k in c if k not in ctx]
    row = dict(loss_gpu=loss_g, loss_cpu=loss_c, loss_rel=abs(loss_g - loss_c) / abs(loss_c),
               grad_rel_l2=rel_l2(g, c, rest), context_grad_rel_l2=rel_l2(g, c, ctx),
               all_grad_rel_l2=rel_l2(g, c))
    print(f"{label} GPU vs CPU: loss {loss_g:.7f} vs {loss_c:.7f} (relative "
          f"{row['loss_rel']:.3e}, bar {TRAIN_LOSS_REL:g}); gradient relative L2 outside the "
          f"context encoder {row['grad_rel_l2']:.3e}, context encoder "
          f"{row['context_grad_rel_l2']:.3e} (bar {TRAIN_GRAD_REL:g} each), whole vector "
          f"{row['all_grad_rel_l2']:.3e}")
    if not (row["loss_rel"] <= TRAIN_LOSS_REL and row["grad_rel_l2"] <= TRAIN_GRAD_REL
            and row["context_grad_rel_l2"] <= TRAIN_GRAD_REL):
        fail(f"{label}: GPU and CPU disagree {row}")
    return row


def memory_options(root: str) -> dict:
    """Phase 14c: remat "full" and "dots" and grad_accum 2 against the plain
    step, each one step's gradients from the same init and batch: at full
    width (the recipe's first training batch, batch 6, 256^2, bf16, hidden
    128, RAFT at 12 iterations) with each one's peak memory, then at 14b's
    size in float32. Bars: MEMORY_REL_F32 in float32; in bfloat16
    MEMORY_REL_BF16 for remat against the plain step, and ACCUM_F32_RATIO
    for grad_accum against the float32 plain step. Beside grad_accum's bar it
    prints what shows its cause: the share of each step's gradient elements
    that are bfloat16 values, the size of one bfloat16 rounding of its
    gradient vector, and its distance from a plain step whose frozen flows
    come from micro-batches of its size (the estimator's batch left out)."""
    rows = {}
    opts = (("plain", {}, 1), ("remat full", {"remat": "full"}, 1),
            ("remat dots", {"remat": "dots"}, 1), ("grad_accum 2", {}, 2))
    it = BatchIterator(fetch_train_dataset(root, ["bflows"], crop_size=256), 6,
                       shuffle=True, drop_last=True, seed=0, epoch=0)
    batch = next(iter(it))
    images = engine.to_clip(torch.from_numpy(batch["imgs"]).cuda())
    labels = engine.to_flow_seq(torch.from_numpy(batch["bflows"]).cuda())

    def accumulator(dtype: str, **cfg):
        acc = models.init_accflow(models.AccFlowConfig(compute_dtype=dtype, **cfg), seed=1,
                                  device="cpu")
        perturb_zero_conv(acc, 2)
        return acc.cuda()

    est = models.build_flow_estimator("raft", compute_dtype="float32", seed=0)
    _, g32 = one_step_grads(est.pairs_fn(), accumulator("float32"), images, labels)
    est = models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0)
    grads = {}
    for name, cfg, k in opts:
        acc = accumulator("bfloat16", **cfg)
        one_step_grads(est.pairs_fn(), acc, images, labels, k)  # warm-up: cuDNN's choices
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads[name] = one_step_grads(est.pairs_fn(), acc, images, labels, k)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        rel = rel_l2(grads[name], grads["plain"])
        rows[name] = dict(loss=loss, peak_gib=peak / 2**30, above_weights_gib=(peak - base) / 2**30,
                          ms=secs * 1e3, grad_rel_l2_vs_plain=rel)
        print(f"train memory option {name} (full width, bf16): loss {loss:.5f}, forward + "
              f"backward {secs * 1e3:.2f} ms, peak {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} "
              f"above what was allocated before), gradients vs plain relative L2 {rel:.3e}"
              + ("" if k > 1 else f" (bar {MEMORY_REL_BF16:g})"))
        if k == 1 and not rel <= MEMORY_REL_BF16:
            fail(f"train memory option {name}: gradients differ from the plain step's by {rel}")
        del acc
    plain_f32 = rel_l2(grads["plain"], g32)
    rows["plain"]["bf16_vs_f32_grad_rel_l2"] = plain_f32
    accum = grads["grad_accum 2"]
    _, split = one_step_grads(micro_batch_pairs(est.pairs_fn(), 2), accumulator("bfloat16"),
                              images, labels)
    row = rows["grad_accum 2"]
    row.update(vs_f32_grad_rel_l2=rel_l2(accum, g32), bar=ACCUM_F32_RATIO * plain_f32,
               vs_plain_ofe_micro_batched=rel_l2(accum, split),
               plain_ofe_micro_batched_vs_plain=rel_l2(split, grads["plain"]),
               bf16_share_plain=bf16_share(grads["plain"]), bf16_share=bf16_share(accum),
               one_bf16_rounding=rel_l2(bf16_rounded(accum), accum))
    print(f"train memory option grad_accum 2 (full width, bf16): gradients vs the f32 plain "
          f"step relative L2 {row['vs_f32_grad_rel_l2']:.3e}, the bf16 plain step's "
          f"{plain_f32:.3e} (bar {ACCUM_F32_RATIO:g}x that: {row['bar']:.3e}); vs a plain step "
          f"whose frozen flows come from micro-batches of 3 {row['vs_plain_ofe_micro_batched']:.3e} "
          f"(that step vs plain {row['plain_ofe_micro_batched_vs_plain']:.3e}); gradient "
          f"elements that are bf16 values: plain {row['bf16_share_plain']:.4f}, grad_accum 2 "
          f"{row['bf16_share']:.4f}; one bf16 rounding of its gradient vector "
          f"{row['one_bf16_rounding']:.3e}")
    if not row["vs_f32_grad_rel_l2"] <= row["bar"]:
        fail(f"train memory option grad_accum 2: gradients {row['vs_f32_grad_rel_l2']} from the "
             f"f32 step's, over {row['bar']}")
    del est, images, labels, split, accum
    torch.cuda.empty_cache()
    images, labels = small_train_batch("cuda")
    small = {}
    for name, cfg, k in opts:
        est, acc = small_train_models("cuda", **cfg)
        _, small[name] = one_step_grads(est.pairs_fn(), acc, images, labels, k)
        rel = rel_l2(small[name], small["plain"])
        rows[name]["f32_64px_grad_rel_l2_vs_plain"] = rel
        print(f"train memory option {name} (64^2, float32): gradients vs plain relative L2 "
              f"{rel:.3e} (bar {MEMORY_REL_F32:g})")
        if not rel <= MEMORY_REL_F32:
            fail(f"train memory option {name} in float32: gradients differ from the plain "
                 f"step's by {rel}")
    return rows


def profile_train_step(est, state, batch, wall_ms: float) -> None:
    """--profile: the device time of one train step (engine.make_acc_train_step's,
    noise on, the AdamW update included) and of its frozen estimator's
    pair call alone, by kind of kernel."""
    step, _ = engine.make_acc_train_step(est, state.model, state.optimizer, add_noise=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    imgs, flows = (torch.from_numpy(batch[k]).cuda() for k in ("imgs", "bflows"))
    print("profile: one AccRAFT train step (batch 6, 256^2, bf16)")
    profile_forward(lambda: step(imgs, flows, gen), wall_ms)
    images, pairs = engine.to_clip(imgs), est.pairs_fn()
    t = images.shape[0]
    src = tuple(range(2, t)) * 2 + (1,)
    dst = tuple(range(1, t - 1)) + (0,) * (t - 2) + (0,)
    secs, _ = timed_runs(lambda: pairs(images, src, dst), 5)
    print("profile: its frozen RAFT alone (66 pairs, 12 iterations, no_grad)")
    profile_forward(lambda: pairs(images, src, dst), statistics.median(secs) * 1e3)


def train_phase(tmp: str, with_profile: bool = False) -> dict:
    """Phase 14: accumulator training (train/engine.py::train_acc) at the
    AccRAFT recipe's full width (configs/AccRAFT.yml as shipped: batch 6,
    256^2 crops of 7-frame clips, bf16, hidden 128, noise on, lr 1.2e-4,
    frozen RAFT at 12 iterations on kernel #1) on 24 synthetic CVOR
    training clips (48 samples over clean+final) and 6 test clips of 256^2:
    kernel #1 against the plain lookup at the step's lookup shape (Q =
    66*32*32, maps of 32^2 down to 4^2, whose 4-wide bfloat16 rows stage
    element by element); (a) 13 steps with a validation at step 10 (visual sample 0, latest and
    best checkpoints), then resume "auto" for 2 more, the count going on
    from 13; one step's forward and backward under the sync debug mode
    "error"; configs/AccGMA.yml for 4 steps (GMA frozen on kernel #1);
    (b) train_gpu_vs_cpu; (c) memory_options. with_profile: profile_train_step."""
    levels32, coords = lookup_inputs(66, 32, 32)
    lookup_rows = check_lookup("kernel #1 (radius 4, train shape)",
                               lambda lv, c, o: corr_cuda.lookup_corr_fused(lv, c, 4, o),
                               levels32, coords, 4, out_dtypes=(torch.float32, torch.bfloat16))
    del levels32, coords
    torch.cuda.empty_cache()
    root = str(Path(tmp) / "cvor_train")
    t0 = time.perf_counter()
    write_synthetic_cvor(root, num_train=24, num_test=6, h=256, w=256)
    print(f"train: wrote 24 + 6 synthetic CVOR clips of 256^2 in {time.perf_counter() - t0:.2f} s")
    run_dir = Path(tmp) / "train_raft"
    opt = train_opts("AccRAFT.yml", root, run_dir, valid_freq=10)
    raft = engine_run("AccRAFT", opt, 13)
    ckpt = CheckpointManager(opt.ckpt_dir)
    files = sorted(str(p.relative_to(run_dir)) for p in run_dir.rglob("*") if p.is_file())
    print(f"train AccRAFT: files {files}")
    if ckpt.latest_step() != 13 or ckpt.best_steps() != [10]:
        fail(f"train AccRAFT: checkpoints latest {ckpt.latest_step()}, best {ckpt.best_steps()}")
    if not (run_dir / "logs" / "val" / "im000" / "000010.png").is_file():
        fail("train AccRAFT: no visual sample PNG at step 10")
    resumed = engine_run("AccRAFT resumed", train_opts("AccRAFT.yml", root, run_dir,
                                                       valid_freq=10, resume="auto"), 18)
    state = resumed.pop("state")
    check_resumed("train AccRAFT", resumed, state)
    raft.pop("state")

    est, _ = engine.build_acc_model(opt, device="cuda")
    it = BatchIterator(fetch_train_dataset(root, ["bflows"], crop_size=256), 6,
                              shuffle=True, drop_last=True, seed=0, epoch=0)
    batch = next(iter(it))
    images = engine.to_clip(torch.from_numpy(batch["imgs"]).cuda())
    labels = engine.to_flow_seq(torch.from_numpy(batch["bflows"]).cuda())

    def forward_backward():
        with tf32(False):
            loss, _ = sequence_loss_acc(accflow_train_forward(state.model, images, est.pairs_fn()),
                                        labels)
            loss.backward()

    sync_free("train step forward + backward (AccRAFT, batch 6, 256^2)", forward_backward)
    if with_profile:
        profile_train_step(est, state, batch, raft["ms_per_step"])
    del est, state, images, labels
    gc.collect()
    torch.cuda.empty_cache()

    gma_opt = train_opts("AccGMA.yml", root, Path(tmp) / "train_gma")
    gma = engine_run("AccGMA", gma_opt, 6)
    gma.pop("state")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(lookup_train_shape=lookup_rows, accraft=raft, resumed=resumed, files=files,
                accgma=gma, graphed=acc_graph_runs(opt, root),
                gpu_vs_cpu=train_gpu_vs_cpu(), memory_options=memory_options(root))


def acc_graph_runs(opt, root: str) -> dict:
    """Phase 14d: graph_vs_eager for the AccRAFT recipe's step (the frozen
    RAFT of build_acc_model, the accumulator from seed 0, make_optimizer as
    train_acc builds it, noise on) on the first GRAPH_STEPS training
    batches of epoch 0, the validation step on the first 3 of them."""
    est, acfg = engine.build_acc_model(opt, device="cuda")
    est.model.requires_grad_(False)
    it = BatchIterator(fetch_train_dataset(root, ["bflows"], crop_size=opt.image_size),
                       opt.batch_per_gpu, shuffle=True, drop_last=True, seed=0, epoch=0)
    inputs = [tuple(torch.from_numpy(b[k]).cuda() for k in ("imgs", "bflows"))
              for b in itertools.islice(iter(it), GRAPH_STEPS)]

    def build(graphed):
        model = models.init_accflow(acfg, seed=0, device="cuda")
        optimizer = make_optimizer(model.parameters(), opt.lr, 100, opt.wdecay, opt.epsilon,
                                   opt.clip)
        steps = engine.make_acc_train_step(est, model, optimizer, opt.add_noise, graphed=graphed)
        eager_valid = engine.make_acc_train_step(est, model, optimizer, opt.add_noise)[1]
        return model, optimizer, *steps, eager_valid

    return graph_vs_eager("train AccRAFT steps", build, inputs, {"corr_lookup": 12},
                          valid_inputs=inputs[:3])


def finetune_graph_runs(opt, root: str) -> dict:
    """Phase 15f: graph_vs_eager for the RAFT.yml recipe's step (full RAFT
    from seed 0, noise on, gamma 0.85) in each remat mode, on the pairs
    select_pair draws (seed 2) from the first GRAPH_STEPS training batches
    of epoch 0 (remat "full" runs the lookup's forward again in the
    backward: 24 launches a step); with "dots", the validation step on the
    first 3 batches."""
    it = BatchIterator(fetch_train_dataset(root, ft.ALL_FLOW_KEYS, crop_size=opt.image_size),
                       opt.batch_per_gpu, shuffle=True, drop_last=True, seed=0, epoch=0)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in itertools.islice(iter(it), GRAPH_STEPS)]
    rng = np.random.default_rng(2)
    inputs = [ft.select_pair(b, rng) for b in batches]
    rows = {}
    for remat in ("none", "full", "dots"):
        kw = dict(add_noise=opt.add_noise, gamma=opt.get("gamma", 0.85), remat=remat)

        def build(graphed, kw=kw):
            est = ft.build_estimator(opt, device="cuda")
            optimizer = make_optimizer(est.model.parameters(), opt.lr, 100, opt.wdecay,
                                       opt.epsilon, opt.clip)
            steps = ft.make_finetune_step(est, optimizer, graphed=graphed, **kw)
            return est.model, optimizer, *steps, ft.make_finetune_step(est, optimizer, **kw)[1]

        rows[remat] = graph_vs_eager(
            f"fine-tune RAFT remat {remat} steps", build, inputs,
            {"corr_lookup": 24 if remat == "full" else 12, "corr_lookup_backward": 12},
            valid_inputs=[(b["imgs"], b["bflows"]) for b in batches[:3]] if remat == "dots" else ())
    return rows


def check_backward(label: str, op, radius: int, levels32, coords, cases) -> dict:
    """Phase 15a: the backward kernel's op `op` (accflow::corr_lookup_backward
    or accflow::corr_level_lookup_backward) against the plain backward at
    `radius`, for each (levels dtype, window-gradient dtype) of `cases`:
    at coords on a 1/256 grid (BWD_REL; a bfloat16 result also bit-equal to
    the kernel's float32 result cast), at the path's own coords (LOOKUP_TOL)
    and far off every map (all zeros); then its device time beside the plain
    backward's, grid_sample's backward with respect to its input (the
    library yardstick; the port never calls it) and the bound. Rows keyed
    "<levels> levels, <grad> grad"."""
    q = coords.shape[0]
    shapes = [tuple(lvl.shape[1:]) for lvl in levels32]
    hw = [d for hw_l in shapes for d in hw_l]
    gen = torch.Generator(device=coords.device).manual_seed(1)
    grad32 = torch.randn((q, len(shapes) * (2 * radius + 1) ** 2), generator=gen,
                         device=coords.device)
    on_grid = (torch.round(coords * 256) / 256).contiguous()
    far = (coords + 1e4).contiguous()
    rows = {}
    for level_dtype, grad_dtype in cases:
        key = f"{str(level_dtype)[6:]} levels, {str(grad_dtype)[6:]} grad"
        grad = grad32.to(grad_dtype)
        ref = corr.lookup_corr_plain_backward(grad, on_grid, shapes, radius)
        got32 = op(grad, on_grid, hw, radius, torch.float32)
        got = op(grad, on_grid, hw, radius, level_dtype)
        torch.cuda.synchronize()
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((g.float() - r).abs().max()) for g, r in zip(got, ref))
        for g, g32, r in zip(got, got32, ref):
            if level_dtype == torch.bfloat16 and not torch.equal(
                    g.view(torch.int16), g32.to(torch.bfloat16).view(torch.int16)):
                fail(f"{label} {key}: the bfloat16 result is not the float32 result cast")
            rel = BWD_REL if level_dtype == torch.float32 else BF16_ROUND
            if not bool(((g.float() - r).abs() <= rel * r.abs() + 1e-6 * scale).all()):
                fail(f"{label} {key}: kernel disagrees with the plain backward: {err}")
        ref_p = corr.lookup_corr_plain_backward(grad, coords, shapes, radius)
        got_p = op(grad, coords, hw, radius, level_dtype)
        err_p = max(float((g.float() - r).abs().max()) for g, r in zip(got_p, ref_p))
        bf = 0.0 if level_dtype == torch.float32 else BF16_ROUND
        if not all(bool(((g.float() - r).abs() <= LOOKUP_TOL + bf * r.abs()).all())
                   for g, r in zip(got_p, ref_p)):
            fail(f"{label} {key}: kernel disagrees with the plain backward at the path's coords: "
                 f"{err_p}")
        if any(float(g.abs().max()) != 0 for g in op(grad, far, hw, radius, level_dtype)):
            fail(f"{label} {key}: coords far off the maps gave a nonzero gradient")
        levels = [lvl.to(level_dtype) for lvl in levels32]
        lib_run, lib_result = grid_sample_lookup_backward(levels, coords, grad, radius)
        lib_err = max(float((g - r).abs().max()) for g, r in zip(lib_result(), ref_p))
        ms = device_ms(lambda: op(grad, coords, hw, radius, level_dtype), 20)
        wall_ms = cuda_ms(lambda: op(grad, coords, hw, radius, level_dtype), 20)
        plain_ms = device_ms(
            lambda: corr.lookup_corr_plain_backward(grad, coords, shapes, radius, level_dtype), 2)
        library_ms = device_ms(lib_run, 10)
        bound_ms, bound_by, nbytes = lookup_backward_bound(
            grad, coords, shapes, torch.tensor([], dtype=level_dtype).element_size())
        print(f"{label} {key}: kernel vs plain max abs {err:.3e} on grid coords (bar {BWD_REL:g} "
              f"relative + 1e-6 x {scale:.3e}), {err_p:.3e} at the path's coords (bar "
              f"{LOOKUP_TOL:g}), far coords all zero; grid_sample backward vs plain {lib_err:.3e}")
        print(f"{label} {key}: kernel {ms:.4f} ms ({wall_ms:.4f} ms per call back to back), plain "
              f"{plain_ms:.4f} ms, grid_sample backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes} B at 3.35 TB/s) = {100 * bound_ms / ms:.1f} % of bound")
        rows[key] = dict(max_abs_err=err, max_abs_err_path_coords=err_p, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                         wall_ms=wall_ms, library_max_abs_vs_plain=lib_err)
        del got, got32, ref, ref_p, got_p, lib_run, lib_result, levels
    return rows


def finetune_step_parts(opt, root: str):
    """The recipe's estimator (seed 0) and its first training pair (the
    engine's first batch and select_pair draw) on the card."""
    est = ft.build_estimator(opt, device="cuda")
    it = BatchIterator(fetch_train_dataset(root, ft.ALL_FLOW_KEYS, crop_size=opt.image_size),
                       opt.batch_per_gpu, shuffle=True, drop_last=True, seed=0, epoch=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(iter(it)).items()}
    return est, ft.select_pair(batch, np.random.default_rng(2))


@contextlib.contextmanager
def relu_ties(recorded=None):
    """Within the block every torch.relu (F.relu and nn.ReLU call it) is
    watched: without `recorded`, each call's input is kept (float32, on the
    CPU) in the yielded list; with another run's list, each call's input
    takes that run's value wherever the two lie on opposite sides of zero,
    each within TIE_REL of its tensor's median |value| (a tie), and the
    gradient passes unchanged: a ReLU input in a tie, which either rounding
    may put on either side of the kink. Yields (record, ties: (call,
    elements) per call that had one). Watch with the checkpoints' early
    stop off (torch.utils.checkpoint.set_checkpoint_early_stop), so that a
    recompute makes as many calls in either run."""
    rec, ties, relu = [], [], torch.relu

    def watched(x):
        rec.append(x.detach().float().cpu() if recorded is None else None)
        if recorded is not None:
            o, other = x.detach().float(), recorded[len(rec) - 1].to(x.device)
            tie = ((o * other < 0) & (o.abs() <= TIE_REL * o.abs().median())
                   & (other.abs() <= TIE_REL * other.abs().median()))
            if bool(tie.any()):
                ties.append((len(rec) - 1, int(tie.sum())))
                x = x + ((other - o) * tie).to(x.dtype).detach()
        return relu(x)

    torch.relu = watched
    try:
        yield rec, ties
    finally:
        torch.relu = relu


def finetune_gpu_vs_cpu(corr_lookup: str = "fused", **overrides) -> dict:
    """Phase 15d (16d with corr_lookup "ondemand:16": 4 chunks, each
    rebuilt in the backward pass; 26d with the `overrides` corr_levels 3,
    corr_radius 3: kernel #2's (3, 3) build and its backward's, where these
    names say kernel #1 and its backward): one fine-tune step (make_finetune_step:
    12 iterations, noise off, remat "dots") of full RAFT from seed 0 at
    64^2, batch 2, float32, TF32 off, on the GPU (kernel #1 and its
    backward kernel, 12 launches each under "fused"; as many as the CPU run
    calls the plain lookup and backward under ondemand) and on the CPU (the
    plain lookup and backward): loss,
    gradients over the fnet, the cnet and the update block apart, and each
    running-statistics buffer after the step (TRAIN_LOSS_REL,
    TRAIN_GRAD_REL, FT_STATS_REL). The CPU run takes the GPU's ReLU inputs at their ties
    (relu_ties, TIE_REL); their count is printed."""
    rng = np.random.default_rng(5)
    img1, img2 = (rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8) for _ in range(2))
    label = (4 * rng.standard_normal((2, 64, 64, 2))).astype(np.float32)
    out, calls = {}, {}
    recorded = None
    what = ("fine-tune step 64^2" + ("" if corr_lookup == "fused" else f" {corr_lookup}")
            + "".join(f" {k} {v}" for k, v in overrides.items()))
    kernel1 = (overrides.get("corr_levels", 4), overrides.get("corr_radius", 4)) == (4, 4)
    fwd_name, fwd_module = ("corr_lookup", corr_cuda) if kernel1 else (
        "corr_level_lookup", corr_level_cuda)
    plain = [(fwd_module, "lookup_corr_plain"), (corr_backward_cuda, "lookup_corr_plain_backward")]
    for where in ("cuda", "cpu"):
        est = models.build_flow_estimator("raft", compute_dtype="float32", seed=0, device=where,
                                          corr_lookup=corr_lookup, **overrides)
        opt = make_optimizer(est.model.parameters(), 1e-4, 10)
        grads = {}
        update = opt.step

        def step(update=update, grads=grads, est=est):
            grads.update({k: p.grad.detach().float().cpu().clone()
                          for k, p in est.model.named_parameters()})
            update()

        opt.step = step
        train_step, _ = ft.make_finetune_step(est, opt, add_noise=False, gamma=0.85)
        reset_counts()
        originals = [getattr(m, name) for m, name in plain]
        calls[where] = {name: 0 for _, name in plain}
        for (m, name), fn in zip(plain, originals):
            def counted(*a, fn=fn, name=name, seen=calls[where], **k):
                seen[name] += 1
                return fn(*a, **k)
            setattr(m, name, counted)
        try:
            with relu_ties(recorded) as (rec, ties), \
                    torch.utils.checkpoint.set_checkpoint_early_stop(False):
                loss, _ = train_step(*(torch.from_numpy(a).to(where)
                                       for a in (img1, img2, label)))
        finally:
            for (m, name), fn in zip(plain, originals):
                setattr(m, name, fn)
        if where == "cuda":
            gpu_counts = launch_counts()
        stats = {k: v.float().cpu() for k, v in est.model.state_dict().items() if "running" in k}
        out[where] = float(loss), grads, stats
        recorded = rec
    fwd, bwd = calls["cpu"].values()
    want = {k: 0 for k in gpu_counts} | {fwd_name: fwd, f"{fwd_name}_backward": bwd}
    print(f"{what}: GPU kernel launches {gpu_counts}, CPU plain calls {fwd} lookups and {bwd} "
          f"backwards, GPU plain calls {calls['cuda']}")
    if (gpu_counts != want or any(calls["cuda"].values()) or not (bwd >= 12 and fwd >= bwd)
            or (corr_lookup == "fused" and (fwd, bwd) != (12, 12))):
        fail(f"{what}: GPU launches {gpu_counts}, expected the CPU's {want}")
    (loss_g, g, s_g), (loss_c, c, s_c) = out["cuda"], out["cpu"]
    row = dict(loss_gpu=loss_g, loss_cpu=loss_c, loss_rel=abs(loss_g - loss_c) / abs(loss_c),
               relu_ties=ties, launches=gpu_counts)
    for part in ("fnet", "cnet", "update_block"):
        row[f"{part}_grad_rel_l2"] = rel_l2(g, c, [k for k in c if k.startswith(part + ".")])
    row["stats_max_rel"] = max(float((s_g[k] - s_c[k]).abs().max() / s_c[k].abs().max())
                               for k in s_c)
    print(f"{what} GPU vs CPU: loss {loss_g:.7f} vs {loss_c:.7f} (relative "
          f"{row['loss_rel']:.3e}, bar {TRAIN_LOSS_REL:g}); gradient relative L2 fnet "
          f"{row['fnet_grad_rel_l2']:.3e}, cnet {row['cnet_grad_rel_l2']:.3e}, update block "
          f"{row['update_block_grad_rel_l2']:.3e} (bar {TRAIN_GRAD_REL:g} each); running "
          f"statistics max relative {row['stats_max_rel']:.3e} (bar {FT_STATS_REL:g}); ReLU "
          f"inputs in a tie, taken from the GPU run: {ties}")
    if not (row["loss_rel"] <= TRAIN_LOSS_REL and row["stats_max_rel"] <= FT_STATS_REL
            and all(row[f"{p}_grad_rel_l2"] <= TRAIN_GRAD_REL
                    for p in ("fnet", "cnet", "update_block"))):
        fail(f"{what}: GPU and CPU disagree {row}")
    return row


def finetune_remat_options(opt, root: str) -> dict:
    """Phase 15e: remat "none", "full" and "dots" (the recipe's default) in
    make_finetune_step at the recipe's full width: each from the seed-0
    estimator on the first training pair, 2 warm-up steps, then 3 timed
    steps (host clock to a synchronise; median), the peak memory of those,
    kernel #1's forward launches per step, and the first step's gradients
    against "none"'s (MEMORY_REL_BF16: the same kernels, recomputed)."""
    rows, ref = {}, None
    for remat in ("none", "full", "dots"):
        est, (img1, img2, label) = finetune_step_parts(opt, root)
        optimizer = make_optimizer(est.model.parameters(), 1e-4, 100)
        grads = {}
        update = optimizer.step

        def step_keeping(update=update, grads=grads, est=est):
            if not grads:
                grads.update({k: p.grad.detach().float().clone()
                              for k, p in est.model.named_parameters() if p.grad is not None})
            update()

        optimizer.step = step_keeping
        step, _ = ft.make_finetune_step(est, optimizer, add_noise=False, gamma=0.85, remat=remat)
        step(img1, img2, label)
        step(img1, img2, label)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = launch_counts()
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(img1, img2, label)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        fwd = (launch_counts()["corr_lookup"] - c0["corr_lookup"]) // 3
        ref = grads if ref is None else ref
        rel = rel_l2(grads, ref)
        rows[remat] = dict(ms_per_step=statistics.median(secs) * 1e3,
                           ms_steps=[t * 1e3 for t in secs],
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           lookup_launches_per_step=fwd, grad_rel_l2_vs_none=rel)
        print(f"fine-tune remat {remat} (RAFT, batch 6, 256^2, bf16): median "
              f"{rows[remat]['ms_per_step']:.2f} ms per step over 3, peak "
              f"{rows[remat]['peak_gib']:.3f} GiB, kernel #1 {fwd} forward launches per step, "
              f"first step's gradients vs none relative L2 {rel:.3e} (bar {MEMORY_REL_BF16:g})")
        if not rel <= MEMORY_REL_BF16:
            fail(f"fine-tune remat {remat}: gradients differ from remat none's by {rel}")
        del est, optimizer, step, grads, img1, img2, label
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def finetune_phase(root: str, tmp: str, with_profile: bool = False) -> dict:
    """Phase 15: estimator fine-tuning (train/finetune.py::fine_tune) with
    configs/RAFT.yml as shipped (full RAFT, batch 6, 256^2 pairs, 12
    iterations, bf16 with float32 flow state and float32 pyramid, noise,
    gamma 0.85, AdamW at 1.2e-4 with OneCycle and clip 1.0, remat "dots";
    flow_pretrained unset: the weights from seed 0) on phase 14's synthetic
    CVOR clips: (a) kernels #1 and #2 (radius 3) against the plain lookup at
    the step's lookup shape (Q = 6*32*32, maps 32^2 .. 4^2: float32 levels,
    float32 and bfloat16 output, and bfloat16 levels), then the backward
    kernel against the plain backward at that shape: kernel #1's entry
    with float32 levels and a bfloat16 window gradient (the step's), float32
    and bfloat16 gradients, bfloat16 levels; kernel #2's at radius 3;
    (b) 13 steps with a validation at step 10, then resume "auto" for 2 more;
    configs/GMA.yml for 4 steps; RAFT-small (RAFT.yml with small: true, kernel
    #2 and its backward) for 4; (c) one step's forward and backward under the
    sync debug mode "error"; (d) finetune_gpu_vs_cpu; (e) finetune_remat_options.
    with_profile: the device time of one step by kind."""
    levels32, coords = lookup_inputs(6, 32, 32)
    f32, bf16 = torch.float32, torch.bfloat16
    fwd1 = check_lookup("kernel #1 (radius 4, fine-tune shape)",
                        lambda lv, c, o: corr_cuda.lookup_corr_fused(lv, c, 4, o),
                        levels32, coords, 4, out_dtypes=(f32, bf16))
    fwd2 = check_lookup("kernel #2 (radius 3, fine-tune shape)",
                        lambda lv, c, o: corr_level_cuda.lookup_corr_level(lv, c, 3, o),
                        levels32, coords, 3, out_dtypes=(f32, bf16))
    bwd1 = check_backward("backward kernel #1 entry (radius 4, fine-tune shape)",
                          corr_backward_cuda.corr_lookup_backward_op, 4, levels32, coords,
                          ((f32, bf16), (f32, f32), (bf16, bf16)))
    bwd2 = check_backward("backward kernel #2 entry (radius 3, fine-tune shape)",
                          corr_backward_cuda.corr_level_lookup_backward_op, 3, levels32, coords,
                          ((f32, bf16), (bf16, bf16)))
    del levels32, coords
    torch.cuda.empty_cache()
    run_dir = Path(tmp) / "finetune_raft"
    opt = train_opts("RAFT.yml", root, run_dir, valid_freq=10)
    raft = engine_run("RAFT", opt, 13, finetune=True)
    ckpt = CheckpointManager(opt.ckpt_dir)
    if ckpt.latest_step() != 13 or ckpt.best_steps() != [10] or raft["valid_batches"] != 1:
        fail(f"fine-tune RAFT: checkpoints latest {ckpt.latest_step()}, best {ckpt.best_steps()}, "
             f"validation batches {raft['valid_batches']}")
    resumed = engine_run("RAFT resumed", train_opts("RAFT.yml", root, run_dir, valid_freq=10,
                                                    resume="auto"), 18, finetune=True)
    check_resumed("fine-tune RAFT", resumed, resumed.pop("state"))
    raft.pop("state")

    est, (img1, img2, label) = finetune_step_parts(opt, root)
    i1, i2 = (2.0 * (x.float() / 255.0) - 1.0 for x in (img1, img2))

    def forward_backward():
        with tf32(False):
            out = est.forward(i1, i2, iters=ft.TRAIN_ITERS, train=True, remat="dots")
            sequence_loss_raft(out["predictions"], label.float(), 0.85)[0].backward()

    sync_free("fine-tune step forward + backward (RAFT, batch 6, 256^2)", forward_backward)
    if with_profile:
        step, _ = ft.make_finetune_step(est, make_optimizer(est.model.parameters(), 1e-4, 10),
                                        add_noise=True, gamma=0.85)
        gen = torch.Generator(device="cuda").manual_seed(1)
        print("profile: one RAFT fine-tune step (batch 6, 256^2, bf16, remat dots)")
        profile_forward(lambda: step(img1, img2, label, gen), raft["ms_per_step"])
    del est, img1, img2, label, i1, i2
    gc.collect()
    torch.cuda.empty_cache()

    gma = engine_run("GMA", train_opts("GMA.yml", root, Path(tmp) / "finetune_gma"), 6,
                     finetune=True)
    gma.pop("state")
    small = engine_run("RAFT-small", train_opts("RAFT.yml", root, Path(tmp) / "finetune_small",
                                                small=True), 6, finetune=True, small=True)
    small.pop("state")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(lookup_kernel_1=fwd1, lookup_kernel_2=fwd2, backward_kernel_1=bwd1,
                backward_kernel_2=bwd2, raft=raft, resumed=resumed,
                gma=gma, raft_small=small, gpu_vs_cpu=finetune_gpu_vs_cpu(),
                remat_options=finetune_remat_options(opt, root),
                graphed=finetune_graph_runs(opt, root))


def ondemand_small_clips() -> dict:
    """Phase 16a: small_clip's 4-frame 64^2 clip (float32, TF32 off, the
    same seeds) with corr_lookup "ondemand:16" (4 chunks of 16 queries per
    lookup) on the GPU against the same on the CPU (the plain lookups on
    each chunk's rows), and against "fused" on the GPU, for full RAFT and
    GMA (kernel #1) and RAFT-small (kernel #2, radius 3): CLIP_REL of the
    largest |flow|; 12 x 4 launches per forward under ondemand:16. Returns
    the GPU launches of each."""
    clip = np.random.default_rng(3).uniform(-1, 1, (4, 1, 64, 64, 3)).astype(np.float32)
    rows = {}
    for label, name, kw, kernel in (("RAFT", "raft", {}, corr_cuda),
                                    ("GMA", "gma", {}, corr_cuda),
                                    ("RAFT-small", "raft", {"small": True}, corr_level_cuda)):
        outs = {}
        for lookup, where in (("ondemand:16", "cuda"), ("ondemand:16", "cpu"), ("fused", "cuda")):
            est = models.build_flow_estimator(name, compute_dtype="float32", device=where,
                                              seed=0, corr_lookup=lookup, **kw)
            if name == "gma":
                perturb_gamma(est.model, 3)
            acc = models.init_accflow(models.AccFlowConfig(compute_dtype="float32"), seed=1,
                                      device="cpu")
            perturb_zero_conv(acc, 2)
            reset_counts()
            with tf32(False):
                outs[lookup, where] = models.accflow_forward(
                    acc.to(where), clip, est.pairs_fn()).cpu().numpy()
            per = 48 if lookup == "ondemand:16" else 12
            n = expect_counts(f"small clip {label} {lookup} on {where}", kernel,
                              per if where == "cuda" else 0)
            if where == "cuda":
                rows[f"{label} {lookup}"] = n
        for other in (("ondemand:16", "cpu"), ("fused", "cuda")):
            got, ref = outs["ondemand:16", "cuda"], outs[other]
            diff, flow_max = float(np.abs(got - ref).max()), float(np.abs(ref).max())
            print(f"small clip {label} ondemand:16 on cuda vs {other[0]} on {other[1]}: max abs "
                  f"{diff:.3e}, |flow| max {flow_max:.3e} (bar {CLIP_REL:g} x |flow| max)")
            rows[f"{label} vs {other[0]} on {other[1]}"] = diff
            if not flow_max > 0 or not np.isfinite(got).all() or not diff <= CLIP_REL * flow_max:
                fail(f"small clip {label} ondemand:16: differs from {other} by {diff:.3e}")
    return rows


def ondemand_clip() -> dict:
    """Phase 16b: the clip path (7 x 512^2, batch 2, 12 iterations, bf16,
    phase 5's seeds) with corr_lookup "fused", "ondemand" (AUTO: one chunk
    of 4096 queries) and "ondemand:1024" (4 chunks), eager (time_clip: 12
    kernel-#1 launches per chunk and forward) and, for the volume-free
    lookups, graphed (graphed_clip) and one forward under the sync debug
    mode "error": each against the fused forward within CLIP_REL of the
    largest |flow|; ms per forward and peak memory of each."""
    t, n, size = 7, 2, 512
    acc, images = clip_inputs(t, n, size)
    shape = (t - 2, n, size, size, 2)
    rows, ref = {}, None
    for lookup, chunks in (("fused", 1), ("ondemand", 1), ("ondemand:1024", 4)):
        est = models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0,
                                          corr_lookup=lookup)
        pairs = est.pairs_fn(iters=acc.cfg.ofe_iters)

        def forward(pairs=pairs):
            return models.accflow_forward(acc, images, pairs)

        gc.collect()
        torch.cuda.empty_cache()
        launches, med, _, out, peak = time_clip(f"clip path, {lookup}", forward, corr_cuda,
                                                shape, per_forward=12 * chunks)
        row = dict(chunks=chunks, ms_per_forward=med * 1e3, peak_gib=peak / 2**30,
                   launches=launches)
        if ref is None:
            ref = out
        else:
            diff, flow_max = float((out - ref).abs().max()), float(ref.abs().max())
            print(f"clip path, {lookup} vs fused: max abs {diff:.3e} "
                  f"({'bit-equal' if diff == 0 else 'not bit-equal'}; bar {CLIP_REL:g} x "
                  f"{flow_max:.3e})")
            if not diff <= CLIP_REL * flow_max:
                fail(f"clip path, {lookup}: differs from fused by {diff:.3e}")
            row["max_abs_vs_fused"] = diff
            sync_free(f"clip path, {lookup}: one eager forward", forward)
            torch.cuda.empty_cache()
            row["graphed"] = graphed_clip(f"clip path, {lookup}, graphed",
                                          serving.build_serving_fn(est, acc), images, out,
                                          corr_cuda, 12 * chunks)
        rows[lookup] = row
        del est, pairs, out
    del acc, images, ref
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def video_frames(t: int, h: int, w: int, seed: int) -> np.ndarray:
    """(t, h, w, 3) uint8 HWC frames of a moving texture (moving_frames at
    max(h, w)^2, cropped)."""
    f = moving_frames(t, 1, max(h, w), seed)[:, 0, :h, :w]
    return ((f + 1) * 127.5).round().clamp(0, 255).to(torch.uint8).cpu().numpy()


def hires_call(label: str, pipe, frames, chunks: int):
    """One FlowPipeline.long_range call on `frames` from zeroed counts and
    peak: 12 kernel-#1 launches per chunk, finite flows of the frames'
    size. Returns (its seconds, warm-up included: a second call read within
    4 % of the first in PR 19's and PR 20's runs; peak bytes; flows)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    secs, out = timed_runs(lambda: pipe.long_range(frames), 1)
    peak = torch.cuda.max_memory_allocated()
    expect_counts(label, corr_cuda, 12 * chunks)
    t, h, w, _ = frames.shape
    if out.shape != (t - 2, h, w, 2) or not np.isfinite(out).all():
        fail(f"{label}: long_range output {out.shape} malformed or not finite")
    print(f"{label}: {secs[0]:.3f} s per call (one call), peak memory {peak / 2**30:.3f} GiB, "
          f"{chunks} chunk(s) per lookup, {12 * chunks} kernel-#1 launches, |flow| max "
          f"{float(np.abs(out).max()):.3e}")
    return secs[0], peak, out


def od_chunks(lookup: str, pairs: int, h8: int, w8: int) -> int:
    """Chunks per lookup of a resolved spelling for `pairs` pairs of h8 x w8
    maps: 1 for fused, else as ops/corr.py cuts them (its own code, run on
    shapes only)."""
    if not corr.is_ondemand(lookup):
        return 1
    fmap = torch.empty((pairs, 1, h8, w8), device="meta")
    od = corr.prepare_ondemand_chunks(corr.build_corr_on_demand(fmap, fmap),
                                      corr.ondemand_chunk(lookup))
    return h8 * w8 // od.chunk


def hires_phase() -> dict:
    """Phase 16c: FlowPipeline.long_range (acc+raft, bf16, 12 iterations,
    phase 12's seeds) on 7 uint8 frames of a moving texture: at 1280x720
    and 1920x1080 with corr_lookup "fused" and "ondemand" (seconds per call,
    peak memory; ondemand against fused within CLIP_REL), from which the
    stored-volume budget is derived: the peak is fitted as a line in the
    stored pyramid's bytes V (bf16, 11 pairs) through the two fused
    readings, and the budget is the V whose peak is 3/4 of the card's
    memory; ops/corr.py's AUTO_VOLUME_BYTES must not exceed it. Then "auto"
    at 2560x1440 (no stored pyramid fits: 90 GiB), which must take the
    volume-free lookup (the launches say so), with acc+raft and acc+gma
    (attn_chunk -1, gamma from seed 3; one call): seconds, peak (under the
    card's memory), chunks. Prints what "auto" picks at 512^2, 720p, 1080p
    and 1440p."""
    total = torch.cuda.get_device_properties(0).total_memory
    rows, vols, peaks = {}, {}, {}
    for w, h in ((1280, 720), (1920, 1080)):
        frames = video_frames(7, h, w, seed=8)
        outs = {}
        for lookup in ("fused", "ondemand"):
            pipe = FlowPipeline.from_checkpoint("acc+raft", corr_lookup=lookup)
            perturb_zero_conv(pipe.acc, 2)
            chunks = od_chunks(lookup, 11, h // 8, w // 8)
            secs, peak, outs[lookup] = hires_call(f"FlowPipeline long_range {w}x{h} {lookup}",
                                                  pipe, frames, chunks)
            rows[f"{w}x{h} {lookup}"] = dict(s_per_call=secs, peak_gib=peak / 2**30,
                                             chunks=chunks, launches=12 * chunks)
            del pipe
        diff, flow_max = (float(np.abs(outs["ondemand"] - outs["fused"]).max()),
                          float(np.abs(outs["fused"]).max()))
        print(f"FlowPipeline long_range {w}x{h}: ondemand vs fused max abs {diff:.3e} (bar "
              f"{CLIP_REL:g} x {flow_max:.3e})")
        if not diff <= CLIP_REL * flow_max:
            fail(f"long_range {w}x{h}: ondemand differs from fused by {diff:.3e}")
        rows[f"{w}x{h} ondemand"]["max_abs_vs_fused"] = diff
        vols[h] = corr.stored_volume_bytes(11, h // 8, w // 8, dtype=torch.bfloat16)
        peaks[h] = rows[f"{w}x{h} fused"]["peak_gib"] * 2**30
    slope = (peaks[1080] - peaks[720]) / (vols[1080] - vols[720])
    base = peaks[720] - slope * vols[720]
    budget = (0.75 * total - base) / slope
    derived = dict(card_bytes=total, volume_bytes={str(k): v for k, v in vols.items()},
                   fused_peak_bytes={str(k): v for k, v in peaks.items()},
                   peak_per_volume_byte=slope, base_bytes=base, budget_bytes=budget,
                   auto_volume_bytes=corr.AUTO_VOLUME_BYTES)
    print(f"stored-volume budget on {smi('name,power.limit')} ({total / 2**30:.2f} GiB): fused "
          f"peak = {slope:.4f} x V + {base / 2**30:.3f} GiB through 720p (V "
          f"{vols[720] / 2**30:.3f} GiB, peak {peaks[720] / 2**30:.3f}) and 1080p (V "
          f"{vols[1080] / 2**30:.3f} GiB, peak {peaks[1080] / 2**30:.3f}); 3/4 of the card holds "
          f"V <= {budget / 2**30:.3f} GiB; AUTO_VOLUME_BYTES = "
          f"{corr.AUTO_VOLUME_BYTES / 2**30:.3f} GiB")
    if not corr.AUTO_VOLUME_BYTES <= budget:
        fail(f"AUTO_VOLUME_BYTES {corr.AUTO_VOLUME_BYTES} exceeds the derived budget {budget:.0f}")
    picks = {}
    for label, pairs, w, h in (("512^2 (CVO clip, batch 2)", 22, 512, 512),
                               ("512^2", 11, 512, 512), ("1280x720", 11, 1280, 720),
                               ("1920x1080", 11, 1920, 1080), ("2560x1440", 11, 2560, 1440)):
        pick = corr.resolve_auto_lookup("auto", pairs, h // 8, w // 8, dtype=torch.bfloat16)
        vol = corr.stored_volume_bytes(pairs, h // 8, w // 8, dtype=torch.bfloat16)
        picks[label] = dict(pick=pick, volume_gib=vol / 2**30,
                            chunks=od_chunks(pick, pairs, h // 8, w // 8))
        print(f"auto at {label}, {pairs} pairs: stored pyramid {vol / 2**30:.3f} GiB -> {pick} "
              f"({picks[label]['chunks']} chunk(s))")
    if picks["2560x1440"]["pick"] != "ondemand":
        fail("auto does not pick ondemand at 2560x1440")
    frames = video_frames(7, 1440, 2560, seed=9)
    chunks = picks["2560x1440"]["chunks"]
    for name in ("acc+raft", "acc+gma"):
        pipe = FlowPipeline.from_checkpoint(name)
        perturb_zero_conv(pipe.acc, 2)
        if "gma" in name:
            perturb_gamma(pipe.est.model, 3)
        secs, peak, _ = hires_call(f"FlowPipeline {name} long_range 2560x1440 auto", pipe,
                                   frames, chunks)
        if not peak < total:
            fail(f"{name} at 2560x1440: peak {peak} over the card's {total}")
        rows[f"2560x1440 auto {name}"] = dict(s_per_call=secs, peak_gib=peak / 2**30,
                                              chunks=chunks, launches=12 * chunks)
        del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rows=rows, budget=derived, auto_picks=picks)


def finetune_ondemand(root: str, tmp: str) -> dict:
    """Phase 16d: fine_tune with configs/RAFT.yml as shipped but for
    corr_lookup "ondemand" (AUTO: one chunk of the 256^2 step's 1024
    queries, rebuilt in float32 each iteration), graphed, 6 steps
    (engine_run: 12 kernel-#1 and 12 backward-kernel launches per eager or
    captured step): ms per step and peak beside phase 15's fused run; then
    finetune_gpu_vs_cpu with "ondemand:16" (4 chunks, each recomputed in
    the backward pass)."""
    opt = train_opts("RAFT.yml", root, Path(tmp) / "finetune_ondemand",
                     corr_lookup="ondemand")
    run = engine_run("RAFT ondemand", opt, 6, finetune=True)
    run.pop("state")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(raft=run, gpu_vs_cpu=finetune_gpu_vs_cpu("ondemand:16"))


def accflow_clip(label: str, acc_kw: dict, est, images, per_forward: int):
    """One AccFlow clip forward in est's compute dtype (accumulator hidden
    128 from seed 1, its ZeroConv from seed 2, configured by acc_kw) with
    est's pairs_fn and flow_fn, TF32 off where the port keeps it off, after
    one warm-up: `per_forward` kernel-#1 launches, finite output. Returns
    (seconds, output)."""
    acc = models.init_accflow(models.AccFlowConfig(compute_dtype=est.cfg.compute_dtype,
                                                   **acc_kw), seed=1, device="cpu")
    perturb_zero_conv(acc, 2)
    acc = acc.cuda()

    def forward():
        with tf32(False):
            return models.accflow_forward(acc, images, ofe_pairs=est.pairs_fn(),
                                          ofe=est.flow_fn())

    if est.cfg.compute_dtype == "bfloat16":
        forward()  # a warm-up for the timed call; the float32 clip is not timed twice
    reset_counts()
    secs, out = timed_runs(forward, 1)
    expect_counts(label, corr_cuda, per_forward)
    if not bool(torch.isfinite(out).all()):
        fail(f"{label}: output not finite")
    print(f"{label}: {secs[0] * 1e3:.2f} ms per forward, output {tuple(out.shape)}, "
          f"{per_forward} kernel-#1 launches")
    return secs[0], out


def f0n_clips() -> dict:
    """Phase 17c: the 7x512^2 batch-2 clip (12 iterations) through F0N fused
    (12 launches) and stepwise (5 OFE calls: 60), and the backward fused
    (12) and cold stepwise (60) paths, in float32 (TF32 off) and bfloat16:
    each stepwise path against its fused one, in float32 within CLIP_REL of
    the largest |flow|, in bfloat16 within BATCH_SPREAD times the distance
    between the bfloat16 fused clip at batch 2 and the same two clips at
    batch 1 (see BATCH_SPREAD)."""
    _, images = clip_inputs()
    cases = (("F0N fused", dict(direction="forward"), 12),
             ("F0N stepwise", dict(direction="forward", fused_ofe=False), 60),
             ("backward fused", {}, 12),
             ("backward cold stepwise", dict(fused_ofe=False), 60))
    rows, outs = {}, {}
    for dtype in ("float32", "bfloat16"):
        est = models.build_flow_estimator("raft", compute_dtype=dtype, seed=0)
        for label, kw, per in cases:
            secs, outs[label, dtype] = accflow_clip(f"clip 7x512^2 {label} {dtype}", kw, est,
                                                    images, per)
            rows[f"{label} {dtype}"] = dict(ms_per_forward=secs * 1e3, launches=per)
        if dtype == "bfloat16":
            halves = [accflow_clip(f"clip 7x512^2 backward fused bfloat16, clip {i} alone", {},
                                   est, images[:, i:i + 1].contiguous(), 12)[1]
                      for i in range(2)]
            outs["backward fused, batch 1", dtype] = torch.cat(halves, dim=1)
        del est
        gc.collect()
        torch.cuda.empty_cache()

    def dist(a, b):
        got, ref = outs[a], outs[b]
        diff, flow_max = float((got - ref).abs().max()), float(ref.abs().max())
        print(f"clip 7x512^2 {a[0]} {a[1]} vs {b[0]} {b[1]}: max abs {diff:.3e} "
              f"({'bit-equal' if diff == 0 else 'not bit-equal'}), |flow| max {flow_max:.3e}, "
              f"ratio {diff / flow_max:.3e}")
        return diff, flow_max

    floor = dist(("backward fused, batch 1", "bfloat16"), ("backward fused", "bfloat16"))[0]
    rows["backward fused bfloat16"]["batch_1_vs_2"] = floor
    for a, b in (("F0N stepwise", "F0N fused"), ("backward cold stepwise", "backward fused")):
        diff, flow_max = dist((a, "float32"), (b, "float32"))
        rows[f"{a} float32"]["max_abs_vs_fused"] = diff
        if not diff <= CLIP_REL * flow_max:
            fail(f"clip {a} float32: differs from {b} by {diff:.3e} > {CLIP_REL} x {flow_max:.3e}")
        diff = dist((a, "bfloat16"), (b, "bfloat16"))[0]
        rows[f"{a} bfloat16"]["max_abs_vs_fused"] = diff
        print(f"clip 7x512^2 {a} bfloat16: {diff:.3e} from {b} (bar {BATCH_SPREAD:g} x the fused "
              f"clip's batch-1-vs-2 distance {floor:.3e})")
        if not diff <= BATCH_SPREAD * floor:
            fail(f"clip {a} bfloat16: differs from {b} by {diff:.3e} > {BATCH_SPREAD} x {floor:.3e}")
        for c in (a, b):
            rows[f"{c} bfloat16"]["max_abs_vs_float32"] = dist((c, "bfloat16"), (b, "float32"))[0]
    del images, outs
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def f0n_phase(root: str, tmp: str) -> dict:
    """Phase 17: AccFlow's forward (F0N) direction and cold stepwise path.
    (a) train_acc with configs/AccRAFT-F0N.yml as shipped (direction
    forward, labels from fflows; batch 6, 256^2, bf16, noise, frozen RAFT on
    kernel #1), graphed, 13 steps with a validation at step 10, as phase
    14's AccRAFT run; (b) train_gpu_vs_cpu for the F0N step (TRAIN_* bars);
    (c) f0n_clips."""
    opt = train_opts("AccRAFT-F0N.yml", root, Path(tmp) / "train_f0n", valid_freq=10)
    if opt.direction != "forward":
        fail(f"configs/AccRAFT-F0N.yml: direction {opt.direction!r}")
    run = engine_run("AccRAFT-F0N", opt, 13)
    run.pop("state")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(train=run, gpu_vs_cpu=train_gpu_vs_cpu(direction="forward"), clips=f0n_clips())


# ---------------------------------------------------------------------------
# Phases 18-20: High-Speed Sintel, data parallelism, the host tools
# ---------------------------------------------------------------------------

def png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray, kinds) -> bytes:
    """(H, W, C) uint8 `img` (C of 1 or 3) as an 8-bit PNG, row y filtered
    with kinds[y % len(kinds)] (0 None, 1 Sub, 2 Up, 3 Avg, 4 Paeth)."""
    h, w, c = img.shape
    x = img.astype(np.int16)
    up, left, corner = (np.zeros_like(x) for _ in range(3))
    up[1:], left[:, 1:], corner[1:, 1:] = x[:-1], x[:, :-1], x[:-1, :-1]
    pa, pb, pc = np.abs(up - corner), np.abs(left - corner), np.abs(left + up - 2 * corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, corner))
    preds = (np.zeros_like(x), left, up, (left + up) >> 1, paeth)
    rows = b"".join(bytes([kinds[y % len(kinds)]])
                    + ((x[y] - preds[kinds[y % len(kinds)]][y]) & 255).astype(np.uint8).tobytes()
                    for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2}[c], 0, 0, 0))
            + png_chunk(b"IDAT", zlib.compress(rows, 1)) + png_chunk(b"IEND", b""))


def write_sintel_tree(root: Path, samples: int, frames, seed: int, flow_hw,
                      flow_max: float = 20.0) -> None:
    """A synthetic High-Speed Sintel tree in the reference's layout: per
    sample `frames(s)` ((T, H, W, 3) uint8) as 43_imgs/ (even frames' rows
    filtered Sub and Up, odd frames' None, Avg and Paeth), its first and
    last frame as 2_imgs/ (Up), a .flo of `flow_hw` uniform in +-flow_max
    px and a grey occlusion png (Paeth)."""
    rng = np.random.default_rng(seed)
    for s in range(samples):
        sample = root / f"alley_{s:04d}"
        (sample / "2_imgs").mkdir(parents=True)
        (sample / "43_imgs").mkdir()
        clip = frames(s)
        files = [(sample / "43_imgs" / f"frame_{i:04d}.png", img,
                  (1, 2) if i % 2 == 0 else (0, 3, 4)) for i, img in enumerate(clip)]
        files += [(sample / "2_imgs" / f"frame_{i}.png", img, (2,))
                  for i, img in enumerate((clip[0], clip[-1]))]
        with ThreadPoolExecutor(8) as pool:  # zlib lets go of the GIL
            list(pool.map(lambda f: f[0].write_bytes(png_bytes(f[1], f[2])), files))
        write_flow(str(sample / "flow.flo"),
                   rng.uniform(-flow_max, flow_max, (*flow_hw, 2)).astype(np.float32))
        occ = (rng.uniform(size=flow_hw) > 0.8).astype(np.uint8)[..., None] * 255
        (sample / "occ.png").write_bytes(png_bytes(occ, (4,)))


class LoaderClock:
    """While active, the seconds each HighSpeedSintel.get takes."""

    def __enter__(self):
        self.secs, self._get = [], HighSpeedSintel.get
        clock = self

        def get(self_, index):
            t0 = time.perf_counter()
            out = clock._get(self_, index)
            clock.secs.append(time.perf_counter() - t0)
            return out

        HighSpeedSintel.get = get
        return self

    def __exit__(self, *exc):
        HighSpeedSintel.get = self._get


def sintel_phase(tmp: str) -> dict:
    """Phase 18: High-Speed Sintel at its real shape. A synthetic tree of
    SINTEL_SAMPLES samples, each 43 frames of 1024x436 (sintel_frames), is
    written with the PNG writer above; then cli/test_sintel.main as shipped
    (interv 6: T = 8 frames, 12 iterations, bf16, batch 4, padded to
    1024x440) for acc|raft, direct|raft and acc|gma (weights from the seeds):
    seconds per sample, the loader's share (HighSpeedSintel.get), the peak
    memory, and kernel #1's launches, which the code predicts: one call
    signature, so 12 per forward times WARMUP + 1 at the first batch's
    capture and none in the second batch's replay. Then sintel_gpu_vs_cpu."""
    root = Path(tmp) / "hs_sintel"
    t0 = time.perf_counter()
    write_sintel_tree(root, SINTEL_SAMPLES, lambda s: sintel_frames(43, 40 + s), 3, (436, 1024))
    write_s = time.perf_counter() - t0
    print(f"sintel: wrote {SINTEL_SAMPLES} samples of 43 + 2 frames of 1024x436 in "
          f"{write_s:.2f} s")
    frames = root / "alley_0000" / "43_imgs"
    decode = {name: statistics.median(timed_runs(lambda: read_png(str(frames / f)), 3)[0])
              for name, f in (("sub_up", "frame_0000.png"), ("avg_paeth", "frame_0001.png"))}
    img = read_png(str(frames / "frame_0000.png")).astype(np.float32)
    decode["resize"] = statistics.median(timed_runs(lambda: resize_linear(img, (1024, 436)), 3)[0])
    print(f"sintel loader pieces, host seconds per 1024x436 frame: read_png with Sub/Up rows "
          f"{decode['sub_up']:.4f}, with None/Avg/Paeth rows (the diagonal wavefront) "
          f"{decode['avg_paeth']:.4f}; resize_linear {decode['resize']:.4f}")
    rows = {}
    for mode in ("acc|raft", "direct|raft", "acc|gma"):
        acc, ofe = mode.split("|")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with LoaderClock() as clock, EvalGraphs() as probe:
            res = cli_test_sintel.main(["-acc", acc, "-ofe", ofe, "--dataset-root", str(root),
                                        "--interv", "6", "--iters", "12", "--compute-dtype",
                                        "bfloat16", "--batch", "4",
                                        "--result-file", str(Path(tmp) / "sintel.txt")])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        calls = SINTEL_SAMPLES // 4
        launches = expect_counts(f"sintel {mode}", corr_cuda, 12 * (graphs.WARMUP + 1))
        if [g.captures for g in probe.made] != [1] or len(probe.calls) != calls:
            fail(f"sintel {mode}: captures {[g.captures for g in probe.made]}, "
                 f"{len(probe.calls)} calls, expected 1 capture and {calls} calls")
        if not all(np.isfinite(res[k]) for k in ("all", "occ", "noc")):
            fail(f"sintel {mode}: EPE not finite {res}")
        row = dict(res, s_per_sample=secs / SINTEL_SAMPLES,
                   loader_s_per_sample=sum(clock.secs) / SINTEL_SAMPLES,
                   loader_share=sum(clock.secs) / secs, capture_call_s=probe.calls[0],
                   replay_call_s=probe.calls[1:], peak_gib=torch.cuda.max_memory_allocated()
                   / 2**30, launches=launches)
        print(f"sintel {mode}: EPE all {res['all']:.4f} noc {res['noc']:.4f} occ "
              f"{res['occ']:.4f}; {row['s_per_sample']:.3f} s per sample over {SINTEL_SAMPLES} "
              f"(loader {row['loader_s_per_sample']:.3f} s per sample, "
              f"{100 * row['loader_share']:.1f} % of the run); model calls (batch 4, T=8, "
              f"1024x440): first {row['capture_call_s']:.3f} s (2 warm-ups, capture, replay), "
              f"then {', '.join(f'{c:.3f}' for c in row['replay_call_s'])} s; peak memory "
              f"{row['peak_gib']:.3f} GiB; kernel #1 launches {launches} (predicted "
              f"12 x {graphs.WARMUP + 1})")
        rows[mode] = row
    return dict(write_s=write_s, decode_s=decode, rows=rows, gpu_vs_cpu=sintel_gpu_vs_cpu(tmp))


def sintel_gpu_vs_cpu(tmp: str) -> dict:
    """Phase 18b: evaluate_sintel on a small tree (3 samples of 5 frames of
    72x40 resized to 64x32, interv 2: T = 3), float32, TF32 off, 2
    iterations, batch 2 (the second batch padded), on the GPU (kernel #1, 2
    per forward, counted at the capture's WARMUP + 1 calls) and on the CPU
    (the plain lookup): each EPE within SINTEL_REL of the CPU's. The ground
    truth is drawn within +-0.25 px, the scale of the flows that random
    weights give at 2 iterations, so that the EPEs read the flows' errors
    and not the ground truth's size alone (at +-20 px float32 cannot see a
    1e-6 px change in an EPE of ~15)."""
    root = Path(tmp) / "hs_sintel_small"
    rng = np.random.default_rng(9)
    write_sintel_tree(root, 3, lambda s: rng.integers(0, 256, (5, 40, 72, 3), dtype=np.uint8),
                      4, (32, 64), flow_max=0.25)
    rows = {}
    for mode in ("direct|raft", "acc|raft"):
        res = {}
        for where in ("cuda", "cpu"):
            reset_counts()
            with tf32(False):
                res[where] = evaluate.evaluate_sintel(
                    mode, str(root), interv=2, iters=2, compute_dtype="float32", size=(64, 32),
                    batch=2, device=where)
            expect_counts(f"sintel 64x32 {mode} on {where}", corr_cuda,
                          2 * (graphs.WARMUP + 1) if where == "cuda" else 0)
        gaps = {k: abs(res["cuda"][k] - res["cpu"][k]) for k in res["cpu"]}
        if not all(0 < v < 1 for v in res["cpu"].values()):
            fail(f"sintel 64x32 {mode}: EPEs {res['cpu']} are not of the flows' scale")
        print(f"sintel 64x32 {mode} GPU vs CPU: {res['cuda']} vs {res['cpu']}, gaps {gaps} "
              f"(bar {SINTEL_REL:g} x EPE + 1e-6)")
        if not all(gaps[k] <= SINTEL_REL * abs(res["cpu"][k]) + 1e-6 for k in gaps):
            fail(f"sintel 64x32 {mode}: GPU {res['cuda']} and CPU {res['cpu']} disagree")
        rows[mode] = dict(gpu=res["cuda"], cpu=res["cpu"], gaps=gaps)
    return rows


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def torchrun_env(world: int, rank: int, port: int) -> dict:
    return dict(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK="0",
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def params_equal(a, b) -> bool:
    return all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters())) and all(
        torch.equal(p, q) for p, q in zip(a.buffers(), b.buffers()))


def dp_phase(root: str, tmp: str, train: dict, finetune: dict, evals: dict) -> dict:
    """Phase 19: data parallelism (parallel/mesh.py). (a) A world of one
    over NCCL, through maybe_init_distributed (ACCFLOW_DISTRIBUTED=1 with
    torchrun's environment), the train steps graphed with their collectives
    captured (the gradient all-reduce; in fine_tune also the train-mode
    BatchNorm's sums over ranks, forward and backward): train_acc with configs/AccRAFT.yml as shipped and
    fine_tune with configs/RAFT.yml as shipped, DP_STEPS steps each on phase
    14's clips, under deterministic(), bit-equal (every loss, every
    parameter and buffer) to the same runs without a process group; their
    ms per step beside phase 14's and 15's. (b) evaluate_cvo(data_parallel)
    under the same group on phase 8's clips and weights (acc|raft, fused):
    bit-equal to phase 8's EPEs. Then, under the same group, a spatial
    handle of one rank: (o)-(r), one_rank_spatial. (c) dp_two_ranks."""
    out = {}
    for key, config, finetune_run in (("train", "AccRAFT.yml", False),
                                      ("finetune", "RAFT.yml", True)):
        runs = {}
        for label in ("no group", "nccl"):
            if label == "nccl" and not mesh.active():
                os.environ.update(torchrun_env(1, 0, free_port()), ACCFLOW_DISTRIBUTED="1")
                if not mesh.maybe_init_distributed("cuda"):
                    fail("dp: maybe_init_distributed did not start a group")
                if (torch.distributed.get_backend(), mesh.world_size(),
                        mesh.collectives_capturable()) != ("nccl", 1, True):
                    fail(f"dp: group {torch.distributed.get_backend()} x {mesh.world_size()}")
            opt = train_opts(config, root, Path(tmp) / f"dp_{key}_{label.replace(' ', '_')}",
                             valid_freq=100)
            with deterministic():
                runs[label] = engine_run(f"{config} {label}", opt, DP_STEPS, finetune=finetune_run)
        plain, dp = runs["no group"], runs["nccl"]
        same = plain["losses"] == dp["losses"] and params_equal(plain["state"].model,
                                                               dp["state"].model)
        ref_ms = (finetune["raft"] if finetune_run else train["accraft"])["ms_per_step"]
        print(f"dp {config}: world of one over NCCL (graphed, its collectives captured) "
              f"{dp['ms_per_step']:.2f} ms per step, without a group {plain['ms_per_step']:.2f} "
              f"ms (both under deterministic algorithms; phase {15 if finetune_run else 14}, "
              f"torch's defaults: {ref_ms:.2f} ms); losses and weights "
              f"{'bit-equal' if same else 'DIFFER'}")
        if not same:
            fail(f"dp {config}: the NCCL run differs from the run without a group: losses "
                 f"{dp['losses']} vs {plain['losses']}")
        out[key] = dict(ms_per_step=dp["ms_per_step"], no_group_ms_per_step=plain["ms_per_step"],
                        phase_ms_per_step=ref_ms, losses=dp["losses"], launches=dp["launches"],
                        peak_gib=dp["peak_gib"], replay=dp["replay"], bit_equal=same)
        for r in runs.values():
            r.pop("state")
        gc.collect()
        torch.cuda.empty_cache()

    acc_tree, _ = eval_weights()
    with tempfile.TemporaryDirectory() as etmp:
        eval_cvo_synthetic(str(Path(etmp) / "cvor"))
        res = evaluate.evaluate_cvo("acc|raft", str(Path(etmp) / "cvor"), batch=10, iters=12,
                                    compute_dtype="bfloat16", corr_lookup="fused",
                                    acc_params=acc_tree, device="cuda", data_parallel=True,
                                    result_file=str(Path(etmp) / "result.txt"))
    ref = evals["acc|raft", "fused"]
    same = all(res[k] == ref[k] for k in ("all", "vis", "occ"))
    print(f"dp evaluate_cvo(data_parallel) acc|raft fused over NCCL x 1: {res} vs phase 8 "
          f"{ {k: ref[k] for k in res} }: {'bit-equal' if same else 'DIFFER'}")
    if not same:
        fail("dp evaluate_cvo under the group differs from phase 8")
    out["eval"] = dict(res, bit_equal=same)
    out["spatial_one_rank"] = one_rank_spatial()
    torch.distributed.destroy_process_group()
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "ACCFLOW_DISTRIBUTED"):
        os.environ.pop(k, None)
    out["two_ranks"] = dp_two_ranks(tmp)
    return out


def dp_steps() -> dict:
    """Phase 19c's two steps on this rank's rows, eagerly, float32, TF32 off,
    noise off: a train_acc step (make_acc_train_step; phase 14b's models and
    batch: RAFT at 4 iterations, hidden 32, T=4, 64^2) and a fine_tune step
    (make_finetune_step; phase 15d's: full RAFT from seed 0, 12 iterations,
    remat "dots", train-mode BatchNorm) at a global batch of 2. Returns the
    losses, the gradients as the update sees them (averaged over ranks), the
    running statistics after the step and the launches."""
    out = {}
    est, acc = small_train_models("cuda")
    rng = np.random.default_rng(5)
    batch = {"imgs": rng.integers(0, 256, (2, 64, 64, 12)).astype(np.float32),
             "labels": (4.0 * rng.standard_normal((2, 64, 64, 4))).astype(np.float32)}
    rng = np.random.default_rng(5)
    pair = {"img1": rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
            "img2": rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
            "label": (4 * rng.standard_normal((2, 64, 64, 2))).astype(np.float32)}
    ft_est = models.build_flow_estimator("raft", compute_dtype="float32", seed=0, device="cuda")
    for name, model, make, inputs in (
            ("train", acc, lambda o: engine.make_acc_train_step(est, acc, o, add_noise=False,
                                                                 group=mesh.data_group()),
             ("imgs", "labels")),
            ("finetune", ft_est.model,
             lambda o: ft.make_finetune_step(ft_est, o, add_noise=False, gamma=0.85,
                                             group=mesh.data_group()),
             ("img1", "img2", "label"))):
        src = batch if name == "train" else pair
        rows = mesh.shard_batch(src)
        optimizer = make_optimizer(model.parameters(), 1e-4, 10)
        step, _ = make(optimizer)
        grads, orig = {}, mesh.average_gradients

        def recording(params, group, sp=None, model=model, grads=grads, orig=orig):
            orig(params, group, sp)
            grads.update({k: p.grad.detach().float().cpu().clone()
                          for k, p in model.named_parameters()})

        mesh.average_gradients = recording
        reset_counts()
        try:
            loss, _ = step(*(torch.from_numpy(rows[k]).cuda() for k in inputs))
        finally:
            mesh.average_gradients = orig
        out[name] = dict(loss=float(loss), grads=grads, launches=launch_counts(),
                         stats={k: v.float().cpu() for k, v in model.state_dict().items()
                                if "running" in k})
    return out


def dp_child(rank: int, port: int, work: str) -> int:
    """One rank of phase 19c, started by dp_two_ranks as its own process:
    join the gloo group on the one card, run dp_steps, save what it saw."""
    os.environ.update(torchrun_env(2, rank, port))
    if not mesh.maybe_init_distributed("cuda", backend="gloo"):
        fail("dp child: no group")
    try:
        torch.save(dp_steps(), Path(work) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def dp_two_ranks(tmp: str) -> dict:
    """Phase 19c: a world of two on the one card, two processes over gloo
    with CUDA tensors, eagerly (CUDA graphs capture NCCL's collectives, not
    gloo's), batch_per_gpu 1: dp_steps on each rank against dp_steps in
    this process without a group at batch 2. Bars (TRAIN_LOSS_REL,
    TRAIN_GRAD_REL over the whole gradient vector, FT_STATS_REL): one
    sample per rank runs its convs at batch 1, so the two sides differ by
    summation order, as the GPU and the CPU do in 14b and 15d; the ranks
    hold equal gradients and running statistics, bit for bit."""
    work = Path(tmp) / "dp_two_ranks"
    work.mkdir()
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--dp-child",
                               str(r), str(port), str(work)], cwd=str(REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"dp two ranks: rank {r} exited {p.returncode}:\n{log[-3000:]}")
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=True) for r in range(2)]
    ref = dp_steps()
    rows = {}
    for name in ("train", "finetune"):
        want = ref[name]
        got = [r[name] for r in ranks]
        equal = all(torch.equal(got[0]["grads"][k], got[1]["grads"][k]) for k in want["grads"]) \
            and all(torch.equal(got[0]["stats"][k], got[1]["stats"][k]) for k in want["stats"])
        row = dict(loss_rel=abs(got[0]["loss"] - want["loss"]) / abs(want["loss"]),
                   grad_rel_l2=rel_l2(got[0]["grads"], want["grads"]),
                   stats_max_rel=max((float((got[0]["stats"][k] - want["stats"][k]).abs().max()
                                            / want["stats"][k].abs().max())
                                      for k in want["stats"]), default=0.0),
                   ranks_equal=equal, rank_launches=[g["launches"] for g in got],
                   one_process_launches=want["launches"])
        print(f"dp two ranks {name} (gloo, CUDA tensors, eager, batch_per_gpu 1) vs one "
              f"process at batch 2: loss relative {row['loss_rel']:.3e} (bar "
              f"{TRAIN_LOSS_REL:g}), gradient relative L2 {row['grad_rel_l2']:.3e} (bar "
              f"{TRAIN_GRAD_REL:g}), running statistics max relative {row['stats_max_rel']:.3e} "
              f"(bar {FT_STATS_REL:g}); ranks equal: {equal}; launches per rank "
              f"{row['rank_launches']}")
        launched = {k: v for k, v in row["rank_launches"][0].items() if v}
        if not (row["loss_rel"] <= TRAIN_LOSS_REL and row["grad_rel_l2"] <= TRAIN_GRAD_REL
                and row["stats_max_rel"] <= FT_STATS_REL and equal
                and row["rank_launches"][0] == row["rank_launches"][1] == want["launches"]
                and launched == DP_STEP_LAUNCHES[name]):
            fail(f"dp two ranks {name}: {row}, expected launches {DP_STEP_LAUNCHES[name]}")
        rows[name] = row
    print(f"dp two ranks: both processes in {secs:.2f} s (start, build cache, steps)")
    return dict(rows, seconds=secs)


# ---------------------------------------------------------------------------
# Graphed spatial steps: the clip, the stream and the train steps with a
# spatial handle, eager and replayed from CUDA graphs with their exchanges
# (phase 19a's one-rank handle over NCCL; --nccl-spatial's N cards)
# ---------------------------------------------------------------------------

GRAPHED_CALLS = 6  # (o)'s forwards a side: a warm-up (graphed: the capture), then timed (graphed: the last profiled)


def drive_calls(label: str, calls, profiled_last: bool = True) -> dict:
    """`calls` (zero-argument callables, one call each) in order: the first
    warms up (a graph's warm-ups and capture); the second runs under the
    sync debug mode "error" with its mesh collectives and bytes and the
    kernel wrappers' launches counted; it and the next ones are timed; the
    last runs under torch.profiler if `profiled_last`, else is timed too.
    Returns every output, the counts, the seconds, the profile's rows (or
    none) and the peak."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs = [calls[0]()]
    reset_counts()
    c0 = mesh.counts()
    t0 = time.perf_counter()
    sync_free(label, lambda: outs.append(calls[1]()))
    secs = [time.perf_counter() - t0]
    counted = tuple(a - b for a, b in zip(mesh.counts(), c0))
    launches = launch_counts()
    for call in calls[2:len(calls) - profiled_last]:
        t0 = time.perf_counter()
        outs.append(call())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    rows = []
    if profiled_last:
        out, rows = profiled(calls[-1])
        outs.append(out)
    return dict(outs=outs, counts=counted, launches=launches, secs=secs, rows=rows,
                peak=torch.cuda.max_memory_allocated())


def graphed_inference(label: str, case: str, sp, elems=(0, 1)) -> dict:
    """(o) the CVO-6 clip (case "b": 7 x 512^2, bf16, RAFT fused) or (p)
    stream (b) (case "d": 512^2, warm start, a reset on 3 frames and 5
    pushes) on this rank's rows of `sp` (None: the whole frames), with the
    batch elements `elems`, TF32 off, eagerly and graphed: the clip through
    graphs.CudaGraphed with the handle's group, the pushes through
    StreamAccumulator, whose push replays a graph where the handle's group
    is NCCL's; each side through drive_calls (a stream's reset first). Fails
    unless every graphed output is bit-equal to the eager one, a graphed
    call counts the eager call's collectives and bytes and launches no
    kernel through a wrapper (a replay), the eager call launches kernel #1
    per_call times and nothing else, and the replay's profile runs as many
    of kernel #1's CUDA kernel. Returns the readings and the output on the
    host (the clip's; the stream's reset and pushes, stacked)."""
    est, acc, frames = spatial_inputs(case, elems)
    if sp is not None:
        sp = sp.at_height(frames.shape[2])
    group = None if sp is None else sp.group
    rows = mesh.shard_rows(frames, sp, 2)
    runs = {}
    with tf32(False):
        if case == "b":
            def forward(x):
                return models.accflow_forward(acc, x, est.pairs_fn(spatial=sp), spatial=sp)

            graphed, per_call = graphs.CudaGraphed(forward, group), 12
            for side, fn in (("eager", forward), ("graphed", graphed)):
                runs[side] = drive_calls(f"{label} {side} forward",
                                         [functools.partial(fn, rows)] * GRAPHED_CALLS,
                                         profiled_last=side == "graphed")
        else:
            init, step = make_streaming_fns(est, acc, spatial=sp)
            stream, held, per_call = StreamAccumulator(est, acc, spatial=sp), {}, 6

            def push(i):
                out, held["state"] = step(held["state"], rows[i])
                return out

            for side, reset, fn in (("eager", init, push),
                                    ("graphed", stream.reset, lambda i: stream.push(rows[i]))):
                first = reset(rows[:3])
                if side == "eager":
                    first, held["state"] = first
                runs[side] = drive_calls(f"{label} {side} push",
                                         [functools.partial(fn, i) for i in range(3, len(rows))],
                                         profiled_last=side == "graphed")
                runs[side]["outs"].insert(0, first)
    e, g = runs["eager"], runs["graphed"]
    equal = all(torch.equal(a, b) for a, b in zip(e["outs"], g["outs"]))
    replay = sum(n for _, n, name in g["rows"] if "corr_window_kernel" in name)
    others = {k: v for k, v in e["launches"].items() if k != "corr_lookup" and v}
    nccl_ms, share = nccl_share(g["rows"])
    busy = sum(x[0] for x in g["rows"])
    row = dict(eager_ms=statistics.median(e["secs"]) * 1e3,
               graphed_ms=statistics.median(g["secs"]) * 1e3,
               eager_ms_calls=[t * 1e3 for t in e["secs"]],
               graphed_ms_calls=[t * 1e3 for t in g["secs"]],
               collectives=e["counts"][0], bytes=e["counts"][1], graphed_counts=list(g["counts"]),
               eager_peak_gib=e["peak"] / 2**30, graphed_peak_gib=g["peak"] / 2**30,
               busy_ms=busy, nccl_ms=nccl_ms, nccl_share=share,
               launches=e["launches"]["corr_lookup"], replay_launches=replay,
               bit_equal=equal, rows=None if sp is None else list(sp.rows))
    print(f"{label}: eager {row['eager_ms']:.2f} ms per call, graphed {row['graphed_ms']:.2f} "
          f"ms; graphed outputs {'bit-equal to' if equal else 'DIFFER from'} eager "
          f"({len(e['outs'])} outputs); collectives and bytes per call eager "
          f"{tuple(e['counts'])}, graphed {tuple(g['counts'])}; kernel #1 {row['launches']} "
          f"launches eager, {replay} in a replay's profile; a replay's device busy "
          f"{busy:.2f} ms (NCCL {nccl_ms:.3f} ms = {100 * share:.2f} %); peak eager "
          f"{row['eager_peak_gib']:.3f} GiB, graphed {row['graphed_peak_gib']:.3f} GiB")
    if not (equal and g["counts"] == e["counts"] and row["launches"] == per_call == replay
            and not others and not any(g["launches"].values())):
        fail(f"{label}: graphed bit-equal {equal}, counts {g['counts']} vs {e['counts']}, "
             f"launches eager {e['launches']} (expected {per_call} of corr_lookup), graphed "
             f"call {g['launches']} (expected none), a replay's profile {replay}")
    out = g["outs"][-1] if case == "b" else torch.stack(g["outs"])
    row["out"] = out.float().cpu()
    del est, acc, frames, rows, runs, e, g
    gc.collect()
    torch.cuda.empty_cache()
    return row


def spatial_graph_steps(label: str, kind: str, sp, group=None, data=(0, 1),
                        batch=None) -> dict:
    """(q) kind "k": configs/AccRAFT.yml's train step as shipped (the frozen
    RAFT from seed 0, the accumulator from seed 0, noise on); (r) kind "n":
    configs/RAFT.yml's fine-tune step as shipped (full RAFT from seed 0,
    remat "dots", noise on): through graph_vs_eager without its
    default-numerics pair, on DP_STEPS batches from seed 31 (`batch` clips
    or pairs, the config's batch_per_gpu if None): this rank's share of
    each for its data index of n_data (`data`), then its rows of `sp`
    (given the height; None: the whole frames), with the data `group`;
    (q)'s validation step on the first batch. Its bars: GRAPH_SPREAD and
    GRAPH_FLOOR, a graphed step's collectives and bytes as the eager
    step's, kernel #1 (and the backward kernel) 12 a replay."""
    opt = parse_options(str(REPO / "configs" / ("AccRAFT.yml" if kind == "k" else "RAFT.yml")))
    opt.update(flow_pretrained=None)
    (h, w), n = opt.image_size, batch or opt.batch_per_gpu
    d, n_data = data
    rng = np.random.default_rng(31)
    sp = None if sp is None else sp.at_height(h)

    def draw(*shape, flow=False):
        a = (4.0 * rng.standard_normal((n, h, w) + shape)).astype(np.float32) if flow else \
            rng.integers(0, 256, (n, h, w) + shape, dtype=np.uint8)
        return mesh.shard_rows(torch.from_numpy(a).chunk(n_data)[d].cuda(), sp)

    if kind == "k":
        est, acfg = engine.build_acc_model(opt, device="cuda")
        est.model.requires_grad_(False)
        inputs = [(draw(21).float(), draw(10, flow=True)) for _ in range(DP_STEPS)]

        def build(graphed):
            model = models.init_accflow(acfg, seed=0, device="cuda")
            optimizer = make_optimizer(model.parameters(), opt.lr, 100, opt.wdecay,
                                       opt.epsilon, opt.clip)
            make = functools.partial(engine.make_acc_train_step, est, model, optimizer,
                                     opt.add_noise, group=group, spatial=sp)
            return model, optimizer, *make(graphed=graphed), make()[1]

        per_call, valid = {"corr_lookup": 12}, inputs[:1]
    else:
        inputs = [(draw(3), draw(3), draw(2, flow=True)) for _ in range(DP_STEPS)]

        def build(graphed):
            est = ft.build_estimator(opt, device="cuda")
            optimizer = make_optimizer(est.model.parameters(), opt.lr, 100, opt.wdecay,
                                       opt.epsilon, opt.clip)
            make = functools.partial(ft.make_finetune_step, est, optimizer, opt.add_noise,
                                     opt.get("gamma", 0.85), remat=opt.get("scan_remat", "dots"),
                                     group=group, spatial=sp)
            return est.model, optimizer, *make(graphed=graphed), make()[1]

        per_call, valid = {"corr_lookup": 12, "corr_lookup_backward": 12}, ()
    row = graph_vs_eager(label, build, inputs, per_call, valid_inputs=valid, defaults=False)
    del inputs
    gc.collect()
    torch.cuda.empty_cache()
    return row


def one_rank_spatial() -> dict:
    """Phase 19a's spatial cases, in the world of one over NCCL: a handle
    of one rank, mesh.Spatial(WORLD, 0, 1) given each case's height (JAX's
    mesh keeps a "spatial" axis of size 1), so that every exchange runs as
    an NCCL collective of one rank: (o) the CVO-6 clip and (p) stream (b)
    through graphed_inference (graphed bit-equal to eager), (q)
    AccRAFT.yml's and (r) RAFT.yml's steps through spatial_graph_steps
    (GRAPH_SPREAD, GRAPH_FLOOR); a graphed call's collectives and bytes as
    an eager call's, kernel #1 12 a clip forward and a step, 6 a push, the
    backward kernel 12 a fine-tune step."""
    sp = mesh.Spatial(torch.distributed.group.WORLD, 0, 1)
    rows = {"o": graphed_inference("dp (o) clip, one-rank handle", "b", sp),
            "p": graphed_inference("dp (p) stream (b), one-rank handle", "d", sp)}
    for row in rows.values():
        row.pop("out")
    rows["q"] = spatial_graph_steps("dp (q) AccRAFT.yml steps, one-rank handle", "k", sp)
    rows["r"] = spatial_graph_steps("dp (r) RAFT.yml steps, one-rank handle", "n", sp)
    return rows


# ---------------------------------------------------------------------------
# Phase 21: the spatial axis (height sharding) over two gloo ranks
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def kernel_shapes(rec: list):
    """Within the block, each launch of kernel #1, #2 or #3 appends (Q,
    bytes of the levels or the level it reads) to `rec` (corr_cuda.launch,
    corr_level_cuda.launch and corr_bd_cuda.launch, which their ops call)."""
    orig1, orig2, orig3 = corr_cuda.launch, corr_level_cuda.launch, corr_bd_cuda.launch

    def record(levels, coords):
        rec.append((int(coords.shape[0]), sum(lv.numel() * lv.element_size() for lv in levels)))

    def launch1(lib, levels, coords, out_dtype=torch.float32):
        record(levels, coords)
        return orig1(lib, levels, coords, out_dtype)

    def launch2(lib, levels, coords, radius, out_dtype=torch.float32):
        record(levels, coords)
        return orig2(lib, levels, coords, radius, out_dtype)

    def launch3(lib, corr3, wy, out_dtype=torch.float32):
        record([corr3], corr3)
        return orig3(lib, corr3, wy, out_dtype)

    corr_cuda.launch, corr_level_cuda.launch, corr_bd_cuda.launch = launch1, launch2, launch3
    try:
        yield
    finally:
        corr_cuda.launch, corr_level_cuda.launch, corr_bd_cuda.launch = orig1, orig2, orig3


def spatial_inputs(case: str, elems):
    """Case `case` of phase 21 with the batch elements `elems` (element i's
    frames are the same in any batch): (estimator, accumulator or None,
    frames), from seeds, on the card."""
    if case.startswith("a"):
        est = models.build_flow_estimator("raft", compute_dtype="float32", iters=2, seed=0,
                                          corr_lookup=case.split(" ", 1)[1])
        return est, None, moving_frames(2, 1, 128, seed=21)
    if case in SPATIAL_CLIP_LOOKUP:  # phase 5's small clip, on kernel #3 or the mix
        est = models.build_flow_estimator("raft", compute_dtype="float32", seed=0,
                                          corr_lookup=SPATIAL_CLIP_LOOKUP[case])
        acc = models.init_accflow(models.AccFlowConfig(compute_dtype="float32"), seed=1,
                                  device="cpu")
        perturb_zero_conv(acc, 2)
        clip = np.random.default_rng(3).uniform(-1, 1, (4, 1, 64, 64, 3)).astype(np.float32)
        return est, acc.to("cuda"), torch.from_numpy(clip).cuda()
    if case == "b":
        acc, images = clip_inputs()
        return (models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0), acc,
                images[:, list(elems)].contiguous())
    if case == "c":
        acc = clip_inputs(t=3, n=1, size=8)[0]
        h, w = SPATIAL_SIZE_C
        frames = torch.cat([moving_frames(7, 1, w, seed=8 + i)[:, :, :h] for i in elems], 1)
        return (models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0,
                                            corr_lookup="auto"), acc, frames.contiguous())
    if case == "e":
        acc, images = clip_inputs()
        return gma_estimator(), acc, images[:, list(elems)].contiguous()
    if case in SPATIAL_CLIP_KW:  # (l): the clip's accumulator on another path
        images = clip_inputs()[1]
        acc = models.init_accflow(models.AccFlowConfig(compute_dtype="bfloat16",
                                                       **SPATIAL_CLIP_KW[case]), seed=1,
                                  device="cpu")
        perturb_zero_conv(acc, 2)
        return (models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0),
                acc.to("cuda"), images[:, list(elems)].contiguous())
    if case == "e pair":
        est = gma_estimator(compute_dtype="float32", iters=2, position_and_content=True)
        return est, None, moving_frames(2, 1, 64, seed=23)[:, :, :40].contiguous()
    if case == "f pair":
        est = models.build_flow_estimator("raft", compute_dtype="float32", iters=2, seed=0,
                                          small=True)
        return est, None, moving_frames(2, 1, 64, seed=24)[:, :, :40].contiguous()
    if case == "26f pair":  # phase 26 (f): RAFT at corr_levels 3, corr_radius 3
        est = models.build_flow_estimator("raft", compute_dtype="float32", iters=2, seed=0,
                                          **OPTION_33)
        return est, None, moving_frames(2, 1, 64, seed=26)[:, :, :40].contiguous()
    if case == "26f group":  # phase 26 (f): a basic encoder with norm_fn "group"
        return group_encoder(BasicEncoder, 27).cuda(), None, moving_frames(1, 1, 64, seed=27)[:, :, :40].contiguous()
    if case == "h pair":
        est = models.build_flow_estimator("raft", compute_dtype="float32", iters=2, seed=0)
        h, w = SPATIAL_SIZE_H
        return est, None, moving_frames(2, 1, w, seed=22)[:, :, :h].contiguous()
    if case == "h clip":
        acc = clip_inputs(t=3, n=1, size=8)[0]
        h, w = SPATIAL_SIZE_H
        frames = torch.cat([moving_frames(7, 1, w, seed=30 + i)[:, :, :h] for i in elems], 1)
        return (models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0), acc,
                frames.contiguous())
    if case == "i":
        est = models.build_flow_estimator("raft", compute_dtype="float32", small=True, iters=6)
        load_jax_params(est.model, load_npz_tree(str(FIXTURES / "drift_small_ofe.npz")))
        acc = models.init_accflow(models.AccFlowConfig(hidden=64, compute_dtype="float32",
                                                       warm_start=True))
        load_jax_params(acc, load_npz_tree(str(FIXTURES / "drift_small_acc.npz")))
        seq = make_long_sequence(np.random.default_rng(77), 64, 64, 36, seg_len=6, max_v=1,
                                 fg=True, fg_max_v=2)
        imgs = (2.0 * (seq["imgs"][:SPATIAL_DRIFT_FRAMES].astype(np.float32) / 255.0) - 1.0)
        return est, acc, torch.from_numpy(imgs[:, None]).cuda()
    # (d), (f), (g): a stream of 512^2 at batch 2, 6 iterations, warm start
    if case == "d":
        est = models.build_flow_estimator("raft", compute_dtype="bfloat16", iters=6, seed=0)
    elif case == "f":
        est = models.build_flow_estimator("raft", compute_dtype="bfloat16", iters=6, seed=0,
                                          small=True)
    else:
        est = gma_estimator(iters=6)
    acc = models.init_accflow(models.AccFlowConfig(compute_dtype="bfloat16", warm_start=True),
                              seed=1, device="cpu")
    perturb_zero_conv(acc, 2)
    frames = moving_frames(SPATIAL_STREAM_FRAMES, 2, 512, seed=4)
    return est, acc.to("cuda"), frames[:, list(elems)].contiguous()


SPATIAL_CASES = ("a fused", "a ondemand:64", "b", "c", "d", "bd clip", "mix clip")
# (bd clip) and, phase 25 (d), (mix clip): the small clip with these lookups.
SPATIAL_CLIP_LOOKUP = {"bd clip": "experimental:fused_bd",
                       "mix clip": "experimental:fused_mix:rows,rows_gx,vpu_y,mm"}
# The streams' frames, a reset on 3 and a push of each other: (d), (f), (g)
# 8, and the drift fixture's 36.
SPATIAL_STREAM_FRAMES, SPATIAL_DRIFT_FRAMES = 8, 36
# Phase 22: (e) the AccFlow+GMA clip, (f) stream (a) (RAFT-small), (g)
# stream (c) (GMA), (h) Sintel's padded height (a float32 RAFT pair, a bf16
# clip), (i) the drift fixture; and a float32 pair at a height of 40 (24 +
# 16 rows) of GMA with its positional branch (e pair) and of RAFT-small (f
# pair), whose bar sees what the bf16 bars are too loose for (a wrong
# gather, a halo or a norm weight off: the planted faults of
# scripts/spatial_row0_fault.py).
SPATIAL22_CASES = ("e", "e pair", "f", "f pair", "g", "h pair", "h clip", "i")
SPATIAL23_CASES = tuple(SPATIAL_CLIP_KW)  # (l); (j) and (k) are train steps (SPATIAL_TRAIN_KW)
# Phase 26 (f): RAFT at corr_levels 3, corr_radius 3 (kernel #2's (3, 3)
# build on each rank's queries against the gathered keys) and a basic
# encoder with norm_fn "group" (the group statistics combined over the
# ranks), float32 at 40x64 (24 + 16 rows), held within FLOW_REL of the
# largest |value| of one process's run. Fixed before the cases' first run.
SPATIAL26_CASES = ("26f pair", "26f group")
SPATIAL_BATCH = {"b": (0, 1), "d": (0, 1), "e": (0, 1), "f": (0, 1), "g": (0, 1),
                 **{c: (0, 1) for c in SPATIAL23_CASES}}  # else (0,)
SPATIAL_STREAMS = ("d", "f", "g", "i")
SPATIAL_F32 = ("a fused", "a ondemand:64", "e pair", "f pair", "h pair", "i", "bd clip",
               "mix clip", *SPATIAL26_CASES)
# (bd clip), phase 5's 64^2 f32 small clip on kernel #3 (experimental:
# fused_bd, whose split lookup the spatial axis had run on the CPU only): f32
# with TF32 off, so the ranks differ from one process by summation order
# (phase 21 (a): <= 2.6e-6 of max |flow|); held within FLOW_REL of the
# largest |flow|, tests/test_torch_spatial.py's bar, which a rank's queries
# read against its own rows alone (a row-0 fault) fails where CLIP_REL
# does not. Fixed before the case's first run on the card. Phase 25 (d),
# (mix clip), the same clip with the level mix rows, rows_gx, vpu_y, mm
# (PyTorch ops only, no lookup kernel: each rank's queries against the
# gathered levels), takes the same bar.
FLOW_REL = 1e-4


def spatial_run(case: str, sp, elems=None) -> dict:
    """Case `case` on this rank's rows (sp) or on the whole frames (None),
    with the batch elements `elems` (None: the case's own): one call (a
    stream: a reset and a push of each other frame), its first: its
    seconds, the peak, the kernel launches, the Q and level
    bytes per launch of kernels #1 and #2, the collectives and bytes, and
    this rank's rows of the output on the host. A handle is given the
    frames' height (mesh.split_rows)."""
    elems = SPATIAL_BATCH.get(case, (0,)) if elems is None else elems
    est, acc, frames = spatial_inputs(case, elems)
    if sp is not None:
        sp = sp.at_height(frames.shape[2])  # the frames' blocks: (h) 224 + 216 rows
    rows = mesh.shard_rows(frames, sp, 2)
    if case in SPATIAL_STREAMS and sp is not None:
        stream = StreamAccumulator(est, acc, spatial=sp)  # a push with a handle runs eagerly

        def call():
            return torch.stack([stream.reset(rows[:3])] + [stream.push(rows[i])
                                                           for i in range(3, len(rows))])
    elif case in SPATIAL_STREAMS:
        init, step = make_streaming_fns(est, acc)  # eager too: each push counts its launches

        def call():
            out, state = init(rows[:3])
            outs = [out]
            for i in range(3, len(rows)):
                out, state = step(state, rows[i])
                outs.append(out)
            return torch.stack(outs)
    elif case == "26f group":  # the encoder's NCHW features at 1/8
        def call():
            with torch.no_grad(), spatial_sharding(est, sp):
                return est(rows[0].permute(0, 3, 1, 2))
    elif acc is None:
        def call():
            return est.forward(rows[0], rows[1], spatial=sp)["flow_up"]
    else:
        def call():
            return models.accflow_forward(acc, rows, est.pairs_fn(spatial=sp),
                                          est.flow_fn(spatial=sp), spatial=sp)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    shapes = []
    with tf32(False):
        reset_counts()
        c0, b0 = mesh.collectives, mesh.bytes_sent
        t0 = time.perf_counter()
        with kernel_shapes(shapes):
            out = call()
        torch.cuda.synchronize()
        secs = [time.perf_counter() - t0]
    return dict(out=out.float().cpu(), secs=secs, peak=torch.cuda.max_memory_allocated(),
                launches=launch_counts(), q=sorted({q for q, _ in shapes}),
                level_bytes=max((b for _, b in shapes), default=0),
                collectives=mesh.collectives - c0, bytes=mesh.bytes_sent - b0)




def spatial_child(rank: int, port: int, work: str) -> int:
    """One rank of phases 21-23, started by spatial_launch as its own
    process: join the gloo group on the one card, make the (1, 2) mesh,
    wait for spatial_launch's go file (its start overlaps the launching
    process's work, not its timed runs on the card), run every case on this
    rank's rows, save what it saw."""
    os.environ.update(torchrun_env(2, rank, port))
    if not mesh.maybe_init_distributed("cuda", backend="gloo"):
        fail("spatial child: no group")
    try:
        sp = mesh.make_mesh(n_data=1, n_spatial=2).axis
        if (sp.index, sp.size) != (rank, 2):
            fail(f"spatial child {rank}: handle {sp}")
        deadline = time.monotonic() + 900
        while not (Path(work) / "go").exists():
            if time.monotonic() > deadline:
                fail(f"spatial child {rank}: no go file in 900 s")
            time.sleep(0.05)
        out = {case: spatial_run(case, sp)
               for case in SPATIAL_CASES + SPATIAL22_CASES + SPATIAL23_CASES + SPATIAL26_CASES}
        out.update({case: spatial_train_run(case, sp, record=case in SPATIAL_J)
                    for case in SPATIAL_TRAIN_KW})
        out.update({case: spatial_ft_run(case, sp, record=case in SPATIAL_M)
                    for case in SPATIAL_FT_KW})
        out["gloo refusals"] = gloo_refusals(sp)
        torch.save(out, Path(work) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def gloo_refusals(sp) -> list:
    """Graphed requests with a handle over gloo on the card, each of which
    must raise a ValueError that names gloo: make_acc_train_step(graphed=
    True) (its first call, before it runs anything), and a collective of
    the handle's group inside a CudaGraphed capture (after its eager
    warm-ups, which gloo runs). Returns the messages."""
    est = models.build_flow_estimator("raft", compute_dtype="float32", iters=1, seed=0)
    acc = models.init_accflow(models.AccFlowConfig(hidden=32, compute_dtype="float32"),
                              device="cuda")
    step, _ = engine.make_acc_train_step(est, acc, make_optimizer(acc.parameters(), 1e-4, 10),
                                         add_noise=False, graphed=True, spatial=sp.at_height(16))
    imgs, labels = torch.zeros((1, 8, 16, 12), device="cuda"), torch.zeros((1, 8, 16, 4),
                                                                          device="cuda")
    summed = graphs.CudaGraphed(lambda x: mesh.sum_ranks(x, sp))
    msgs = []
    for name, call in (("train step", lambda: step(imgs, labels)),
                       ("capture", lambda: summed(torch.ones(4, device="cuda")))):
        try:
            call()
        except ValueError as e:
            if "gloo" not in str(e):
                fail(f"spatial child: the graphed {name} over gloo raised {e!r}")
            msgs.append(f"{name}: {e}")
        else:
            fail(f"spatial child: a graphed {name} over gloo on the card did not raise")
    if step.eager_calls or step.captures or summed.captures:
        fail(f"spatial child: a refused graph ran ({step.eager_calls} eager steps, "
             f"{step.captures} + {summed.captures} captures)")
    return msgs


def spatial_chunks(case: str, rows: int) -> int:
    """Chunks of queries per lookup for `rows` query rows at 1/8 against
    the whole image's keys, as the lookup the case resolves to cuts them
    (ops/corr.py's own code, run on shapes only)."""
    if case.startswith("a "):
        lookup, pairs, h8, w8 = case.split(" ", 1)[1], 1, 16, 16
    elif case == "c":
        pairs, h8, w8 = 11, SPATIAL_SIZE_C[0] // 8, SPATIAL_SIZE_C[1] // 8
        lookup = corr.resolve_auto_lookup("auto", pairs, h8, w8, 4, torch.bfloat16)
    else:
        return 1
    if not corr.is_ondemand(lookup):
        return 1
    f1, f2 = (torch.empty((pairs, 1, h, w8), device="meta") for h in (rows, h8))
    od = corr.prepare_ondemand_chunks(corr.build_corr_on_demand(f1, f2),
                                      corr.ondemand_chunk(lookup))
    return rows * w8 // od.chunk


# Each case's lookup kernel and its launches per chunk of queries in one
# call: one per GRU iteration and OFE call (a stream: the reset's two calls
# at 6 iterations, then 6 a push).
SPATIAL_KERNEL = {"f": "corr_level_lookup", "f pair": "corr_level_lookup",
                  "i": "corr_level_lookup", "bd clip": "y_contract",
                  "26f pair": "corr_level_lookup"}  # else corr_lookup
SPATIAL_PER_CHUNK = {"a": 2, "e pair": 2, "f pair": 2, "h pair": 2, "mix clip": 0,
                     "26f pair": 2, "26f group": 0,
                     **{c: 12 + (SPATIAL_STREAM_FRAMES - 3) * 6 for c in ("d", "f", "g")},
                     "i": 12 + (SPATIAL_DRIFT_FRAMES - 3) * 6,
                     "l warm": 5 * 12, "l stepwise": 5 * 12}  # else 12: a fused clip



def spatial_train_inputs(case: str, dtype=None, batch=None):
    """Phase 23's train case `case`: (estimator, accumulator, imgs (N, H,
    W, 3T), label flows (N, H, W, 2S), add_noise), from seeds, on the card.
    (j): phase 14b's batch (2 clips of 4 frames at 64^2 from seed 5; "j
    fused 40" their first 40 rows), RAFT at 4 iterations, AccFlow hidden
    128 on the case's path, float32. (k): configs/AccRAFT.yml as shipped
    (RAFT at 12 iterations, hidden 128, noise on; `dtype` in place of its
    bfloat16 if given), on 6 clips of 7 frames at 256^2 (uint8 values from
    seed 23) and their label flows. Both accumulators from seed 1, their
    ZeroConv from seed 2. `batch`: (k)'s number of clips, if not its
    batch_per_gpu."""
    if case == "k":
        opt = parse_options(str(REPO / "configs" / "AccRAFT.yml"))
        opt["compute_dtype"] = dtype or opt.compute_dtype
        est, acfg = engine.build_acc_model(opt, device="cuda")
        (h, w), n, t, add_noise = (opt.image_size, batch or opt.batch_per_gpu, 7,
                                   bool(opt.add_noise))
        rng = np.random.default_rng(23)
    else:
        est = models.build_flow_estimator("raft", compute_dtype="float32", iters=4, seed=0)
        acfg = models.AccFlowConfig(compute_dtype="float32", **SPATIAL_TRAIN_KW[case])
        (h, w), n, t, add_noise = (64, 64), 2, 4, False
        rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (n, h, w, 3 * t)).astype(np.float32)
    labels = (4.0 * rng.standard_normal((n, h, w, 2 * (t - 2)))).astype(np.float32)
    if case == "j fused 40":
        imgs, labels = imgs[:, :40], labels[:, :40]
    acc = models.init_accflow(acfg, seed=1, device="cpu")
    perturb_zero_conv(acc, 2)
    return (est, acc.cuda(), torch.from_numpy(np.ascontiguousarray(imgs)).cuda(),
            torch.from_numpy(np.ascontiguousarray(labels)).cuda(), add_noise)


SPATIAL_TRAIN_LAUNCHES = {"j stepwise": 2 * 4, "k": 12}  # kernel #1 a step; else 4 (one call)


def spatial_train_run(case: str, sp, dtype=None, record: bool = False, recorded=None,
                      group=None, data=(0, 1), batch=None) -> dict:
    """Phase 23's train case on this rank's rows (sp) or on the whole
    frames (None): one step of make_acc_train_step (eager, TF32 off as
    the step sets it; AdamW's update left out), its first: its
    loss, the gradients its update reduced (before the clip; float32 on the
    host), the collectives and bytes of its forward (to the loss) and of its
    backward (to the gradient sum), its seconds, the peak, the kernel
    launches and kernel #1's Q. With `record`, the last step's ReLU inputs
    (relu_ties), as "record"; with another run's `recorded` (the whole
    frames'), its values taken at ties, counted as "ties". `group`, `data`
    (this rank's data index, n_data) and `batch`: a data-parallel axis,
    whose ranks each take their share of the `batch` clips (--nccl-spatial)."""
    est, acc, imgs, labels, add_noise = spatial_train_inputs(case, dtype, batch)
    d, n_data = data
    imgs, labels = (x.chunk(n_data)[d] for x in (imgs, labels))
    if sp is not None:
        sp = sp.at_height(imgs.shape[1])
        imgs, labels = mesh.shard_rows(imgs, sp), mesh.shard_rows(labels, sp)
    optimizer = make_optimizer(acc.parameters(), 1e-4, 10)
    optimizer.optimizer.step = lambda *a, **k: None  # AdamW's update left out
    step, _ = engine.make_acc_train_step(est, acc, optimizer, add_noise, group=group, spatial=sp)
    marks, grads, shapes = {}, {}, []
    loss_fn, reduce = engine.sequence_loss_acc, mesh.average_gradients

    def loss_at(*a, **k):  # the forward's end
        marks["forward"] = (mesh.collectives, mesh.bytes_sent)
        return loss_fn(*a, **k)

    def reduce_at(params, group, spatial=None):  # the backward's end, then the gradient sum
        marks["backward"] = (mesh.collectives, mesh.bytes_sent)
        reduce(params, group, spatial)
        grads.update({k: p.grad.detach().float().cpu() for k, p in acc.named_parameters()})

    engine.sequence_loss_acc, mesh.average_gradients = loss_at, reduce_at
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    watch = record or recorded is not None
    try:
        reset_counts()
        c0 = (mesh.collectives, mesh.bytes_sent)
        gen = torch.Generator(device="cuda").manual_seed(7)
        t0 = time.perf_counter()
        watcher = relu_ties(recorded) if watch else contextlib.nullcontext(([], []))
        with kernel_shapes(shapes), watcher as (rec, ties), \
                torch.utils.checkpoint.set_checkpoint_early_stop(not watch):
            loss, _ = step(imgs, labels, gen)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        engine.sequence_loss_acc, mesh.average_gradients = loss_fn, reduce
    fwd, bwd = marks["forward"], marks["backward"]
    return dict(loss=float(loss), grads=grads, secs=secs, peak=torch.cuda.max_memory_allocated(),
                launches=launch_counts(), q=sorted({q for q, _ in shapes}),
                forward_collectives=fwd[0] - c0[0], forward_bytes=fwd[1] - c0[1],
                backward_collectives=bwd[0] - fwd[0], backward_bytes=bwd[1] - fwd[1],
                record=rec if record else None, ties=ties)


def spatial_k_references() -> dict:
    """(k) in this process on the whole frames, as shipped ("k") and in
    float32 ("k f32": the grad_accum bar's reference)."""
    ref = {"k": spatial_train_run("k", None), "k f32": spatial_train_run("k", None, "float32")}
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def spatial_j_references(ranks) -> dict:
    """The (j) cases in this process on the whole frames, each taking the
    ranks' values (their ReLU inputs' rows put together) at a ReLU input in
    a tie (relu_ties: float32 roundings of another summation order may put
    an input within TIE_REL of zero on either side of the kink; the ties
    are counted and printed)."""
    ref = {}
    for case in SPATIAL_J:
        whole = [torch.cat(calls, dim=2) for calls in zip(*(r[case]["record"] for r in ranks))]
        ref[case] = spatial_train_run(case, None, recorded=whole)
    return ref


def spatial_train_check(case: str, one: dict, got: list, one_f32=None) -> dict:
    """Train case `case`'s two ranks (`got`) against this process (`one`;
    for (k) also `one_f32`): its row of readings, printed; a loss or
    gradients past the bars (SPATIAL_TRAIN comments), ranks whose reduced
    gradients differ in a bit, a launch count off or another kernel fails
    the phase."""
    g0, g1 = got[0]["grads"], got[1]["grads"]
    same = set(g0) == set(g1) and all(torch.equal(g0[k], g1[k]) for k in g0)
    ctx = [k for k in g0 if k.startswith("context.")]
    rest = [k for k in g0 if k not in ctx]
    loss_rel = abs(got[0]["loss"] - one["loss"]) / abs(one["loss"])
    row = dict(loss=got[0]["loss"], one_process_loss=one["loss"], loss_rel=loss_rel,
               ranks_bit_equal=same, kernel="corr_lookup",
               rank_peak_gib=[g["peak"] / 2**30 for g in got],
               one_process_peak_gib=one["peak"] / 2**30,
               rank_s_per_step=[g["secs"] for g in got], one_process_s_per_step=one["secs"],
               **{k: [g[k] for g in got] for k in ("forward_collectives", "forward_bytes",
                                                   "backward_collectives", "backward_bytes")},
               launches=[g["launches"]["corr_lookup"] for g in got],
               one_process_launches=one["launches"]["corr_lookup"],
               q=[g["q"] for g in got], one_process_q=one["q"])
    row["ties"] = one["ties"]
    if case == "k":
        dist, base = rel_l2(g0, one_f32["grads"]), rel_l2(one["grads"], one_f32["grads"])
        row.update(vs_f32_grad_rel_l2=dist, one_bf16_vs_f32_grad_rel_l2=base,
                   bar=ACCUM_F32_RATIO * base, vs_one_bf16_grad_rel_l2=rel_l2(g0, one["grads"]),
                   ratio=dist / (ACCUM_F32_RATIO * base))
        what = (f"gradients vs one process's f32 step relative L2 {dist:.3e}, one process's "
                f"bf16 step's {base:.3e} (bar {ACCUM_F32_RATIO:g}x that: {row['bar']:.3e}); vs "
                f"one process's bf16 step {row['vs_one_bf16_grad_rel_l2']:.3e}; loss "
                f"{got[0]['loss']:.5f} (one process {one['loss']:.5f})")
    else:
        grad, grad_ctx = rel_l2(g0, one["grads"], rest), rel_l2(g0, one["grads"], ctx)
        row.update(grad_rel_l2=grad, context_grad_rel_l2=grad_ctx, bar=TRAIN_GRAD_REL,
                   loss_bar=TRAIN_LOSS_REL,
                   ratio=max(loss_rel / TRAIN_LOSS_REL, grad / TRAIN_GRAD_REL,
                             grad_ctx / TRAIN_GRAD_REL))
        what = (f"loss {got[0]['loss']:.7f} vs {one['loss']:.7f} (relative {loss_rel:.3e}, bar "
                f"{TRAIN_LOSS_REL:g}); gradient relative L2 outside the context encoder "
                f"{grad:.3e}, context encoder {grad_ctx:.3e} (bar {TRAIN_GRAD_REL:g} each; one "
                f"process took the ranks' values at {sum(t[1] for t in one['ties'])} ReLU "
                f"inputs in a tie: {one['ties']})")
    h = one["q"] and got[0]["q"]
    print(f"spatial ({case}) train step, two gloo ranks on one card vs one process: {what}; "
          f"ranks' reduced gradients {'bit-equal' if same else 'DIFFER'}; peak per rank "
          f"{', '.join(f'{x:.3f}' for x in row['rank_peak_gib'])} GiB (one process "
          f"{row['one_process_peak_gib']:.3f}); seconds per step, two gloo ranks sharing one card "
          f"(not a reading of NCCL): {', '.join(f'{x:.3f}' for x in row['rank_s_per_step'])} "
          f"(one process {row['one_process_s_per_step']:.3f}); collectives forward "
          f"{row['forward_collectives']}, backward {row['backward_collectives']}; bytes sent "
          f"forward {row['forward_bytes']}, backward {row['backward_bytes']}; corr_lookup "
          f"launches {row['launches']} (one process {row['one_process_launches']}), Q "
          f"{row['q']} (one process {row['one_process_q']})")
    if not (row["ratio"] <= 1.0 and same and np.isfinite(row["loss"])):
        fail(f"spatial ({case}) train step: {what}; ranks bit-equal {same}")
    want = SPATIAL_TRAIN_LAUNCHES.get(case, 4)
    others = [{k: v for k, v in g["launches"].items() if k != "corr_lookup" and v} for g in got]
    if not (row["launches"] == [want, want] and row["one_process_launches"] == want
            and others == [{}, {}] and h
            and sum(q[0] for q in row["q"]) == row["one_process_q"][0]
            and min(row["forward_collectives"]) > 0 and min(row["backward_collectives"]) > 0):
        fail(f"spatial ({case}) train step: launches {[g['launches'] for g in got]}, one process "
             f"{one['launches']}, expected {want} of corr_lookup; Q {row['q']} against "
             f"{row['one_process_q']}; collectives {row['forward_collectives']} / "
             f"{row['backward_collectives']}")
    return row


# Phase 24: the estimators' fine-tune step over the spatial axis, in phase
# 21's launch of two ranks. (m) one step of make_finetune_step with a
# handle, float32 (TF32 off), batch 2 at 64^2, 12 GRU iterations, remat
# "dots" (the step's default), noise off: full RAFT "fused" and
# "ondemand:16" (2 chunks of 16 queries a rank's image, 4 in one process),
# GMA (its positional branch, gamma drawn in [2, 4]) and RAFT-small
# (kernel #2), and full RAFT at 40x64 (24 + 16 rows); (n) configs/RAFT.yml
# as shipped (batch 6 a spatial pair, 256^2, bf16, noise on).
SPATIAL_FT_KW = {"m raft": dict(model="raft"),
                 "m ondemand": dict(model="raft", corr_lookup="ondemand:16"),
                 "m gma": dict(model="gma"), "m small": dict(model="small"),
                 "m raft 40": dict(model="raft", rows=40), "n": {}}
SPATIAL_M = tuple(c for c in SPATIAL_FT_KW if c.startswith("m"))  # the float32 cases
SPATIAL_FT_F32 = tuple(c for c in SPATIAL_M if c != "m small")  # kernel #1's
# Chunks of queries an image per lookup, on a rank and in one process; else 1.
SPATIAL_FT_CHUNKS = {"m ondemand": (2, 4)}


def spatial_ft_inputs(case: str, dtype=None, batch=None):
    """Phase 24's case `case`: (estimator, img1, img2, label, add_noise,
    remat), from seeds, on the card. (m): phase 15d's pair batch (2 pairs
    at 64^2 of uint8 values from seed 5, "m raft 40" their first 40 rows),
    float32 estimators from seed 0 (GMA: gma_estimator's gamma), noise off.
    (n): configs/RAFT.yml as shipped (its estimator from seed 0, no
    flow_pretrained file here; `dtype` in place of its bfloat16 if given),
    6 pairs at 256^2 from seed 23 and their label flows, noise on; `batch`
    pairs, if given."""
    if case == "n":
        opt = parse_options(str(REPO / "configs" / "RAFT.yml"))
        opt.update(flow_pretrained=None, compute_dtype=dtype or opt.compute_dtype)
        est = ft.build_estimator(opt, device="cuda")
        (h, w), n, add_noise = opt.image_size, batch or opt.batch_per_gpu, bool(opt.add_noise)
        full, remat, rng = h, opt.get("scan_remat", "dots"), np.random.default_rng(23)
    else:
        kw = dict(SPATIAL_FT_KW[case])
        model, rows = kw.pop("model"), kw.pop("rows", 64)
        if model == "gma":
            est = gma_estimator(compute_dtype="float32", position_and_content=True)
        else:
            est = models.build_flow_estimator("raft", compute_dtype="float32", seed=0,
                                              small=model == "small", **kw)
        (h, w), n, add_noise = (rows, 64), 2, False
        full, remat, rng = 64, "dots", np.random.default_rng(5)
    img1, img2 = (rng.integers(0, 256, (n, full, w, 3)).astype(np.uint8) for _ in range(2))
    label = (4 * rng.standard_normal(img1.shape[:3] + (2,))).astype(np.float32)
    return (est, *(torch.from_numpy(np.ascontiguousarray(a[:, :h])).cuda()
                   for a in (img1, img2, label)), add_noise, remat)


def spatial_ft_run(case: str, sp, dtype=None, record: bool = False, recorded=None,
                   group=None, data=(0, 1), batch=None) -> dict:
    """Phase 24's case on this rank's rows (sp) or on the whole frames
    (None): one step of make_finetune_step (eager, TF32 off as the step
    sets it; AdamW's update left out), its first: its loss, the
    gradients its update reduced (before the clip; float32 on the host),
    the running statistics after it, the collectives and bytes of its
    forward (to the loss) and of its backward (to the gradient sum), its
    seconds, the peak, the kernel launches and the Q of kernel #1's (#2's)
    forward launches. `record`: the step's ReLU inputs (relu_ties), as
    "record"; `recorded`: another run's (the ranks' rows put together),
    whose values this run takes at ties, counted as "ties". `group`, `data`
    and `batch` as spatial_train_run's."""
    est, img1, img2, label, add_noise, remat = spatial_ft_inputs(case, dtype, batch)
    d, n_data = data
    img1, img2, label = (x.chunk(n_data)[d] for x in (img1, img2, label))
    if sp is not None:
        sp = sp.at_height(img1.shape[1])
        img1, img2, label = (mesh.shard_rows(x, sp) for x in (img1, img2, label))
    optimizer = make_optimizer(est.model.parameters(), 1e-4, 10)
    optimizer.optimizer.step = lambda *a, **k: None  # AdamW's update left out
    step, _ = ft.make_finetune_step(est, optimizer, add_noise, gamma=0.85, remat=remat,
                                    group=group, spatial=sp)
    marks, grads, shapes = {}, {}, []
    loss_fn, reduce = ft.sequence_loss_raft, mesh.average_gradients

    def loss_at(*a, **k):  # the forward's end
        marks["forward"] = (mesh.collectives, mesh.bytes_sent)
        return loss_fn(*a, **k)

    def reduce_at(params, group, spatial=None):  # the backward's end, then the gradient sum
        marks["backward"] = (mesh.collectives, mesh.bytes_sent)
        reduce(params, group, spatial)
        grads.update({k: p.grad.detach().float().cpu() for k, p in est.model.named_parameters()})

    ft.sequence_loss_raft, mesh.average_gradients = loss_at, reduce_at
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    watch = record or recorded is not None
    try:
        reset_counts()
        c0 = (mesh.collectives, mesh.bytes_sent)
        gen = torch.Generator(device="cuda").manual_seed(7)
        t0 = time.perf_counter()
        # Watching ReLUs, a checkpoint's recompute runs to the iteration's
        # end, so that a rank sees as many calls as one process (an early
        # stop follows the saved tensors, which the halos change).
        watcher = relu_ties(recorded) if watch else contextlib.nullcontext(([], []))
        with kernel_shapes(shapes), watcher as (rec, ties), \
                torch.utils.checkpoint.set_checkpoint_early_stop(not watch):
            loss, _ = step(img1, img2, label, gen)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        ft.sequence_loss_raft, mesh.average_gradients = loss_fn, reduce
    fwd, bwd = marks["forward"], marks["backward"]
    stats = {k: v.float().cpu() for k, v in est.model.state_dict().items() if "running" in k}
    return dict(loss=float(loss), grads=grads, stats=stats, secs=secs,
                peak=torch.cuda.max_memory_allocated(), launches=launch_counts(),
                q=sorted({q for q, _ in shapes}),
                forward_collectives=fwd[0] - c0[0], forward_bytes=fwd[1] - c0[1],
                backward_collectives=bwd[0] - fwd[0], backward_bytes=bwd[1] - fwd[1],
                record=rec if record else None, ties=ties)


def spatial_ft_references() -> dict:
    """(n) in this process on the whole frames, as shipped ("n") and in
    float32 ("n f32": the bar's reference)."""
    ref = {"n": spatial_ft_run("n", None), "n f32": spatial_ft_run("n", None, "float32")}
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def spatial_m_references(ranks) -> dict:
    """The (m) cases in this process on the whole frames, each taking the
    ranks' values at a ReLU input in a tie (relu_ties: every ReLU input of
    the estimators is NCHW, its rows the ranks')."""
    ref = {}
    for case in SPATIAL_M:
        whole = [torch.cat(calls, dim=2) for calls in zip(*(r[case]["record"] for r in ranks))]
        ref[case] = spatial_ft_run(case, None, recorded=whole)
    return ref


def spatial_ft_check(case: str, one: dict, got: list, one_f32=None) -> dict:
    """Phase 24's case `case`: its two ranks (`got`) against this process
    (`one`; for (n) also `one_f32`), its row of readings, printed. (m): the
    loss within TRAIN_LOSS_REL, the gradients within TRAIN_GRAD_REL in
    relative L2 over the fnet (where a lost key gradient shows), the cnet
    (halos, BatchNorm) and the rest apart, each running-statistics buffer
    within FT_STATS_REL of its largest |value|; (n): ACCUM_F32_RATIO, as
    (k). Both: the ranks' gradients and running statistics bit-equal, the
    lookup's forward and backward kernels launched as many times on both
    ranks as the case predicts (12 each a step, x chunks; "ondemand"
    recomputes each chunk's forward in the backward), no other kernel, the
    ranks' Q adding up to one process's (each chunk's Q, under ondemand,
    equal), collectives in the forward and the backward."""
    g0, g1 = got[0]["grads"], got[1]["grads"]
    same = (set(g0) == set(g1) and all(torch.equal(g0[k], g1[k]) for k in g0)
            and all(torch.equal(got[0]["stats"][k], got[1]["stats"][k]) for k in got[0]["stats"]))
    parts = {p: [k for k in g0 if k.startswith(p + ".")] for p in ("fnet", "cnet")}
    parts["rest"] = [k for k in g0 if not k.startswith(("fnet.", "cnet."))]
    small = case == "m small"
    kernel, backward = (("corr_level_lookup", "corr_level_lookup_backward") if small
                        else ("corr_lookup", "corr_lookup_backward"))
    loss_rel = abs(got[0]["loss"] - one["loss"]) / abs(one["loss"])
    row = dict(loss=got[0]["loss"], one_process_loss=one["loss"], loss_rel=loss_rel,
               ranks_bit_equal=same, kernel=kernel,
               rank_peak_gib=[g["peak"] / 2**30 for g in got],
               one_process_peak_gib=one["peak"] / 2**30,
               rank_s_per_step=[g["secs"] for g in got], one_process_s_per_step=one["secs"],
               **{k: [g[k] for g in got] for k in ("forward_collectives", "forward_bytes",
                                                   "backward_collectives", "backward_bytes")},
               launches=[g["launches"][kernel] for g in got],
               backward_launches=[g["launches"][backward] for g in got],
               one_process_launches=one["launches"][kernel],
               one_process_backward_launches=one["launches"][backward],
               q=[g["q"] for g in got], one_process_q=one["q"], ties=one["ties"])
    if case == "n":
        dist, base = rel_l2(g0, one_f32["grads"]), rel_l2(one["grads"], one_f32["grads"])
        row.update(vs_f32_grad_rel_l2=dist, one_bf16_vs_f32_grad_rel_l2=base,
                   bar=ACCUM_F32_RATIO * base, vs_one_bf16_grad_rel_l2=rel_l2(g0, one["grads"]),
                   ratio=dist / (ACCUM_F32_RATIO * base))
        what = (f"gradients vs one process's f32 step relative L2 {dist:.3e}, one process's "
                f"bf16 step's {base:.3e} (bar {ACCUM_F32_RATIO:g}x that: {row['bar']:.3e}); vs "
                f"one process's bf16 step {row['vs_one_bf16_grad_rel_l2']:.3e}; loss "
                f"{got[0]['loss']:.5f} (one process {one['loss']:.5f})")
    else:
        rels = {p: rel_l2(g0, one["grads"], keys) for p, keys in parts.items()}
        stats = max((float((got[0]["stats"][k] - v).abs().max() / v.abs().max())
                     for k, v in one["stats"].items()), default=0.0)
        row.update(**{f"{p}_grad_rel_l2": v for p, v in rels.items()}, stats_max_rel=stats,
                   bar=TRAIN_GRAD_REL, loss_bar=TRAIN_LOSS_REL, stats_bar=FT_STATS_REL,
                   ratio=max(loss_rel / TRAIN_LOSS_REL, stats / FT_STATS_REL,
                             *(v / TRAIN_GRAD_REL for v in rels.values())))
        what = (f"loss {got[0]['loss']:.7f} vs {one['loss']:.7f} (relative {loss_rel:.3e}, bar "
                f"{TRAIN_LOSS_REL:g}); gradient relative L2 fnet {rels['fnet']:.3e}, cnet "
                f"{rels['cnet']:.3e}, rest {rels['rest']:.3e} (bar {TRAIN_GRAD_REL:g} each); "
                f"running statistics max relative {stats:.3e} (bar {FT_STATS_REL:g}); one "
                f"process took the ranks' values at {sum(t[1] for t in one['ties'])} ReLU "
                f"inputs in a tie (call, elements): {one['ties']}")
    print(f"spatial ({case}) fine-tune step, two gloo ranks on one card vs one process: {what}; "
          f"ranks' reduced gradients and running statistics "
          f"{'bit-equal' if same else 'DIFFER'}; peak per rank "
          f"{', '.join(f'{x:.3f}' for x in row['rank_peak_gib'])} GiB (one process "
          f"{row['one_process_peak_gib']:.3f}); seconds per step, two gloo ranks sharing one card "
          f"(not a reading of NCCL): {', '.join(f'{x:.3f}' for x in row['rank_s_per_step'])} "
          f"(one process {row['one_process_s_per_step']:.3f}); collectives forward "
          f"{row['forward_collectives']}, backward {row['backward_collectives']}; bytes sent "
          f"forward {row['forward_bytes']}, backward {row['backward_bytes']}; {kernel} launches "
          f"{row['launches']} (one process {row['one_process_launches']}), {backward} "
          f"{row['backward_launches']} (one process {row['one_process_backward_launches']}), Q "
          f"{row['q']} (one process {row['one_process_q']})")
    if not (row["ratio"] <= 1.0 and same and np.isfinite(row["loss"])):
        fail(f"spatial ({case}) fine-tune step: {what}; ranks bit-equal {same}")
    chunks, chunks_one = SPATIAL_FT_CHUNKS.get(case, (1, 1))

    def want(c):  # (forward, backward) launches a step at c chunks an image
        return 12 * c * (2 if c > 1 else 1), 12 * c

    others = [{k: v for k, v in g["launches"].items() if k not in (kernel, backward) and v}
              for g in got]
    q_ok = (all(q == row["one_process_q"] for q in row["q"]) if chunks > 1 else
            row["one_process_q"] and sum(q[0] for q in row["q"] if q) == row["one_process_q"][0])
    if not ((row["launches"][0], row["backward_launches"][0]) == want(chunks)
            and row["launches"][1] == row["launches"][0]
            and row["backward_launches"][1] == row["backward_launches"][0]
            and (row["one_process_launches"], row["one_process_backward_launches"])
            == want(chunks_one) and others == [{}, {}] and q_ok
            and row["forward_collectives"][0] == row["forward_collectives"][1] > 0
            and row["backward_collectives"][0] == row["backward_collectives"][1] > 0):
        fail(f"spatial ({case}) fine-tune step: launches {[g['launches'] for g in got]}, one "
             f"process {one['launches']}, expected {want(chunks)} and {want(chunks_one)} of "
             f"{kernel} / {backward}; Q {row['q']} against {row['one_process_q']}; collectives "
             f"{row['forward_collectives']} / {row['backward_collectives']}")
    return row


def spatial_references(cases) -> tuple:
    """The cases in this process on the whole frames (one call each),
    and the bf16 cases' batch-1-vs-2 spread: the batch-2 runs' batch-1
    counterparts ((b), (e), (d), (f), (g): each batch element alone; (c),
    (h)'s clip: the element at batch 1 against the same beside another at
    batch 2)."""
    ref = {case: spatial_run(case, None) for case in cases}
    spread = {}
    for case in cases:
        if case in ("c", "h clip"):
            spread[case] = spatial_run(case, None, (0, 1))["out"][:, :1]
        elif case not in SPATIAL_F32:
            spread[case] = torch.cat([spatial_run(case, None, (i,))["out"] for i in range(2)], 1)
    gc.collect()
    torch.cuda.empty_cache()
    return ref, spread


def spatial_launch(tmp: str, command=None, meanwhile=None) -> tuple:
    """Both ranks of phases 21-23 (this script with --spatial-child, or
    `command`, a script and its arguments, in its place), to their end:
    what each saved, the seconds from their go to their end, and what
    `meanwhile` returned. The ranks start (imports, the group, the mesh),
    then wait for the go file, which is written after `meanwhile()` has run
    here: their start overlaps it, their cases run on a card of their own."""
    work = Path(tmp) / f"spatial-{time.monotonic_ns()}"
    work.mkdir()
    port = free_port()
    procs = [subprocess.Popen([sys.executable, *(command or [str(REPO / "chip_smoke.py")]),
                               "--spatial-child", str(r), str(port), str(work)], cwd=str(REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        result = meanwhile() if meanwhile else None
        (work / "go").touch()
        t0 = time.perf_counter()
        for p in procs:
            logs.append(p.communicate(timeout=900)[0].decode(errors="replace"))
        secs = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"spatial: rank {r} exited {p.returncode}:\n{log[-3000:]}")
    return [torch.load(work / f"rank{r}.pt", weights_only=True) for r in range(2)], secs, result


def spatial_check(case: str, one: dict, spread, got: list) -> dict:
    """Case `case`'s two ranks (`got`) against this process (`one`, and
    `spread` for the bf16 bar): its row of readings, printed; a distance
    past its bar, a launch count off, or another kernel fails the phase."""
    pair = case.startswith("a ") or case.endswith("pair")
    out = torch.cat([g["out"] for g in got], dim=1 if pair else 2)
    diff, flow_max = float((out - one["out"]).abs().max()), float(one["out"].abs().max())
    extra = {}
    if case == "i":
        first = float((out[0] - one["out"][0]).abs().max())
        gt = torch.from_numpy(make_long_sequence(
            np.random.default_rng(77), 64, 64, 36, seg_len=6, max_v=1, fg=True,
            fg_max_v=2)["bflows"][1:SPATIAL_DRIFT_FRAMES - 1])
        curves = [((o[:, 0] - gt) ** 2).sum(-1).sqrt().mean((1, 2)) for o in (out, one["out"])]
        epe_gap = float((curves[0] - curves[1]).abs().max())
        bar, why = DRIFT_REL * flow_max, f"{DRIFT_REL:g} x max |flow|"
        extra = dict(first_max_abs=first, epe_gap_px=epe_gap, epe_bar_px=DRIFT_EPE_PX)
        ok = diff <= bar and epe_gap <= DRIFT_EPE_PX
    elif case in SPATIAL_F32:
        rel = FLOW_REL if case in (*SPATIAL_CLIP_LOOKUP, *SPATIAL26_CASES) else CLIP_REL
        bar, why = rel * flow_max, f"{rel:g} x max |flow|"
        ok = diff <= bar
    else:
        floor = float((spread - one["out"]).abs().max())
        bar, why = BATCH_SPREAD * floor, f"{BATCH_SPREAD:g} x batch-1-vs-2 {floor:.3e}"
        ok = diff <= bar
    kernel = SPATIAL_KERNEL.get(case, "corr_lookup")
    per_chunk = SPATIAL_PER_CHUNK.get(case, SPATIAL_PER_CHUNK.get(case[0], 12))
    # rows at 1/8: of the flow's height, or the group encoder's (NCHW) own
    h8 = one["out"].shape[2] if case == "26f group" else one["out"].shape[-3] // 8
    blocks = mesh.split_rows(8 * h8, 2)
    want = [per_chunk * spatial_chunks(case, b // 8) for b in blocks]
    want_one = per_chunk * spatial_chunks(case, h8)
    launched = [g["launches"] for g in got]
    row = dict(max_abs=diff, flow_max=flow_max, bar=bar, rows=list(blocks), kernel=kernel,
               rank_peak_gib=[g["peak"] / 2**30 for g in got],
               one_process_peak_gib=one["peak"] / 2**30,
               rank_s_per_call=[g["secs"][-1] for g in got],
               one_process_s_per_call=one["secs"][-1],
               collectives=[g["collectives"] for g in got], bytes=[g["bytes"] for g in got],
               launches=[lc[kernel] for lc in launched],
               one_process_launches=one["launches"][kernel],
               q=[g["q"] for g in got], one_process_q=one["q"],
               level_bytes=[g["level_bytes"] for g in got],
               one_process_level_bytes=one["level_bytes"], **extra)
    print(f"spatial ({case}) two gloo ranks on one card vs one process: max abs {diff:.3e} "
          + (f"over all outputs; F_2,0 {extra['first_max_abs']:.3e}, per-step EPE gap "
             f"{extra['epe_gap_px']:.3e} px (bar {DRIFT_EPE_PX} px); " if extra else "")
          + f"(bar {why}: {bar:.3e}; |flow| max {flow_max:.3e}); rows {list(blocks)}; peak per "
          f"rank {', '.join(f'{x:.3f}' for x in row['rank_peak_gib'])} GiB (one process "
          f"{row['one_process_peak_gib']:.3f}); seconds per call, two gloo ranks sharing one "
          f"card (not a reading of NCCL): {', '.join(f'{x:.3f}' for x in row['rank_s_per_call'])}"
          f" (one process {row['one_process_s_per_call']:.3f}); collectives "
          f"{row['collectives']}, bytes sent {row['bytes']} per call; {kernel} launches "
          f"{row['launches']} (one process {row['one_process_launches']}), Q {row['q']} (one "
          f"process {row['one_process_q']}), level bytes per launch {row['level_bytes']} (one "
          f"process {row['one_process_level_bytes']})")
    if not ok or not np.isfinite(out.numpy()).all():
        fail(f"spatial ({case}): sharded differs from one process by {diff:.3e} (bar "
             f"{bar:.3e}){'; ' + str(extra) if extra else ''}")
    others = [{k: v for k, v in lc.items() if k != kernel and v} for lc in launched]
    if not (row["launches"] == want and row["one_process_launches"] == want_one
            and others == [{}, {}] and row["collectives"][0] == row["collectives"][1] > 0):
        fail(f"spatial ({case}): launches {launched}, one process {one['launches']}, "
             f"expected {want} and {want_one} of {kernel}; collectives {row['collectives']}")
    if case in SPATIAL22_CASES + SPATIAL23_CASES + ("bd clip", "26f pair") and (
            sum(q[0] if q else 0 for q in row["q"])
                                    != (row["one_process_q"] or [0])[0]):
        fail(f"spatial ({case}): queries per launch {row['q']} do not add up to one "
             f"process's {row['one_process_q']}")
    return row


def spatial_phase(tmp: str) -> dict:
    """Phases 21-24: the mesh's spatial axis. Two
    processes on the one card, each a gloo rank with CUDA tensors (NCCL
    puts no two ranks on one GPU; gloo gathers through the host), n_data 1
    and n_spatial 2, eagerly; each runs on its rows of the frames, every
    case in one launch. Phase 21: (a) full RAFT at 128^2, 2 iterations,
    float32 (TF32 off), "fused" and "ondemand:64"; (b) the CVO-6 clip (7 x
    512^2, batch 2, 12 iterations, bf16, "fused"); (c) a 7-frame 1920x1088
    clip at batch 1 through "auto", which must take the volume-free lookup
    (resolved at the global shape: 31 GB stored, past the budget; each
    rank's half would fit); (d) stream (b) (RAFT at 512^2, batch 2, 6
    iterations, warm_start): reset and 5 pushes. Phase 22: (e) the
    AccFlow+GMA CVO-6 clip (gamma drawn in [2, 4]); (f) stream (a)
    (RAFT-small: kernel #2) and (g) stream (c) (GMA), (d)'s protocol; (h)
    Sintel's padded 1024x440, 224 + 216 rows: a float32 RAFT pair at 2
    iterations and the bf16 AccFlow+RAFT 7-frame clip at batch 1; (i) the
    drift fixture (trained RAFT-small and hidden-64 accumulator, float32,
    36 frames at 64^2); float32 pairs at 40x64 (24 + 16 rows), 2
    iterations, of GMA with its positional branch and of RAFT-small. Each
    against the same run in this process on the
    whole frames (the bars: the SPATIAL comments at the top), with each
    rank's and this process's peak, seconds per call (two gloo ranks
    sharing one card: not a reading of NCCL), collectives and bytes per
    call, and the lookup kernel's launches and Q: both ranks' launches
    equal, one per GRU iteration and chunk of queries as in one process (a
    rank holds half the queries: "fused" keeps one chunk, "ondemand" halves
    the chunks), and no other kernel. Phase 23 (the train cases: their own
    bars and readings, spatial_train_check; the clips as (b)): (j) the
    train step in f32 at 64^2 on the fused, F0N fused and cold stepwise
    paths and at 40x64; (k) AccRAFT.yml's step at full width; (l) the
    warm-started, F0N fused and cold stepwise CVO-6 clips. Phase 24 (the
    fine-tune step, spatial_ft_check): (m) float32 at 64^2 with full RAFT
    "fused" and "ondemand:16", GMA and RAFT-small, and RAFT at 40x64; (n)
    RAFT.yml's step at full width. Phase 26 (f): RAFT at corr_levels 3,
    corr_radius 3 and a group-norm basic encoder, f32 at 40x64 (24 + 16
    rows). Returns each case's row."""
    cases = SPATIAL_CASES + SPATIAL22_CASES + SPATIAL23_CASES + SPATIAL26_CASES
    ranks, secs, (ref, spread, train_ref, ft_ref) = spatial_launch(
        tmp, meanwhile=lambda: (*spatial_references(cases), spatial_k_references(),
                                spatial_ft_references()))
    rows = {case: spatial_check(case, ref[case], spread.get(case), [r[case] for r in ranks])
            for case in cases}
    train_ref.update(spatial_j_references(ranks))
    rows.update({case: spatial_train_check(case, train_ref[case], [r[case] for r in ranks],
                                           train_ref["k f32"]) for case in SPATIAL_TRAIN_KW})
    ft_ref.update(spatial_m_references(ranks))
    rows.update({case: spatial_ft_check(case, ft_ref[case], [r[case] for r in ranks],
                                        ft_ref["n f32"]) for case in SPATIAL_FT_KW})
    c_lookup = corr.resolve_auto_lookup("auto", 11, SPATIAL_SIZE_C[0] // 8,
                                        SPATIAL_SIZE_C[1] // 8, 4, torch.bfloat16)
    if not (corr.is_ondemand(c_lookup) and spatial_chunks("c", SPATIAL_SIZE_C[0] // 16) > 1):
        fail(f"spatial (c): auto resolved to {c_lookup!r}")
    refusals = ranks[0]["gloo refusals"]
    print(f"spatial: graphed requests over gloo on the card, refused on both ranks: {refusals}")
    print(f"spatial: both ranks in {secs:.2f} s from their go (their start overlapped this "
          f"process's runs); (c) auto -> "
          f"{c_lookup} at the global shape, {spatial_chunks('c', SPATIAL_SIZE_C[0] // 16)} "
          "chunks a rank")
    return dict(rows, seconds=secs, c_lookup=c_lookup, gloo_refusals=refusals)


def host_tools_phase(tmp: str, graphed_clip_ms: float) -> dict:
    """Phase 20: the host tools. (a) convert_ckpt: a full-width acc+raft
    (phase 5's weights) saved as a reference-named .pth (the `module.`
    prefix, the OFE under `ofe.`, norm3 aliases, num_batches_tracked),
    converted to the .npz pair by cli/convert_ckpt, loaded into fresh
    modules: the 7x512^2 clip forward bit-equal to the saved modules'. (b)
    the native CVOR core built and used by data/records.py: its decode of a
    flow column the size of CVO's test bflows (536 clips of 512^2 x 10
    uint16) bit-equal to numpy's, both timed, and both timed at the sizes
    the readers decode per call (a 256^2 training crop, a 512^2 sample). (c) profiling.trace of an
    eager 64^2 pair: its Chrome trace names kernel #1. (d) the spans of
    the graphed clip, captured and replayed twice under profiling.trace:
    two replays' acc.clip on the trace's span track, the children of each
    within it, beside phase 5b's median."""
    out = {}
    est = models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0)
    acc, images = clip_inputs()
    sd = {}
    for prefix, module in (("", acc), ("ofe.", est.model)):
        for k, v in module.state_dict().items():
            sd[f"module.{prefix}{k}"] = v.detach().cpu().clone()
            if ".downsample.1." in k:
                sd[f"module.{prefix}{k.replace('.downsample.1.', '.norm3.')}"] = v.detach().cpu()
            if k.endswith("running_var"):
                sd[f"module.{prefix}{k[:-len('running_var')]}num_batches_tracked"] = \
                    torch.tensor(1)
    pth, stem = Path(tmp) / "acc+raft-smoke.pth", Path(tmp) / "acc-raft-smoke"
    torch.save(sd, pth)
    t0 = time.perf_counter()
    cli_convert_ckpt.main(["--pth", str(pth), "--model", "acc+raft", "--out", str(stem)])
    convert_s = time.perf_counter() - t0
    est2 = models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=5)
    acc2 = models.init_accflow(models.AccFlowConfig(compute_dtype="bfloat16"), seed=6,
                               device="cuda")
    load_accflow_checkpoint(str(stem), acc2, est2.model)
    with torch.no_grad():
        ref = models.accflow_forward(acc, images, est.pairs_fn())
        got = models.accflow_forward(acc2, images, est2.pairs_fn())
    same = torch.equal(ref, got)
    print(f"host tools convert_ckpt: .pth ({len(sd)} keys) -> {stem.name}.acc.npz + .ofe.npz "
          f"in {convert_s:.2f} s; the loaded clip forward (7x512^2, bf16) "
          f"{'bit-equal' if same else 'DIFFERS'} to the saved modules'")
    if not same:
        fail(f"convert_ckpt round trip: max abs {float((ref - got).abs().max()):.3e}")
    out["convert_ckpt"] = dict(keys=len(sd), seconds=convert_s, bit_equal=same)
    del est2, acc2, ref, got
    gc.collect()
    torch.cuda.empty_cache()

    built_t0 = time.perf_counter()
    lib = native.build()
    if lib is None or not native.available():
        fail("native core: g++ missing or the core did not load")
    build_s = time.perf_counter() - built_t0
    column = np.random.default_rng(0).integers(0, 65536, (536, 512, 512, 10), dtype=np.uint16)
    t0 = time.perf_counter()
    want = (column.astype(np.float32) - records.FLOW_OFFSET) / records.FLOW_SCALE
    numpy_s = time.perf_counter() - t0
    calls, real = [], native.decode_flow_u16
    native.decode_flow_u16 = lambda raw: calls.append(raw.shape) or real(raw)
    try:
        t0 = time.perf_counter()
        got = records.decode_flow_u16(column)
        native_s = time.perf_counter() - t0
    finally:
        native.decode_flow_u16 = real
    same = calls == [column.shape] and np.array_equal(got.view(np.uint32), want.view(np.uint32))
    print(f"host tools native core: {lib.name} (built or cached in {build_s:.2f} s); decode of "
          f"a {column.shape} uint16 column ({column.nbytes / 2**30:.2f} GiB): native "
          f"{native_s:.3f} s, numpy {numpy_s:.3f} s, {'bit-equal' if same else 'DIFFER'}")
    if not same:
        fail("native core: records.decode_flow_u16 did not go through it, or its bits differ")
    out["native"] = dict(library=lib.name, column_shape=list(column.shape), native_s=native_s,
                         numpy_s=numpy_s, bit_equal=same)
    del column, want, got
    gc.collect()
    # What the readers decode per call: one flow key of a 256^2 training
    # crop (CVORReader.sample_cropped) and of a 512^2 evaluation sample.
    calls = {}
    for name, shape in (("train_crop", (256, 256, 10)), ("eval_sample", (512, 512, 10))):
        raw = np.random.default_rng(1).integers(0, 65536, shape, dtype=np.uint16)
        want = (raw.astype(np.float32) - records.FLOW_OFFSET) / records.FLOW_SCALE
        if not np.array_equal(records.decode_flow_u16(raw).view(np.uint32), want.view(np.uint32)):
            fail(f"native core: the {name} decode's bits differ from numpy's")
        row = {}
        for side, fn in (("native_ms", lambda: records.decode_flow_u16(raw)),
                         ("numpy_ms", lambda: (raw.astype(np.float32) - records.FLOW_OFFSET)
                          / records.FLOW_SCALE)):
            times = []
            for _ in range(50):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            row[side] = 1e3 * statistics.median(times)
        calls[name] = dict(row, shape=list(shape), threads=native._threads(raw.size))
        print(f"host tools native core at a reader's call, {name} {shape}: native "
              f"{row['native_ms']:.4f} ms ({calls[name]['threads']} thread), numpy "
              f"{row['numpy_ms']:.4f} ms (medians of 50), bit-equal")
    out["native"]["reader_calls"] = calls

    small = models.build_flow_estimator("raft", compute_dtype="bfloat16", seed=0)
    i1, i2 = (torch.empty((1, 64, 64, 3), device="cuda").uniform_(-1, 1) for _ in range(2))
    with torch.no_grad():
        small.forward(i1, i2)
        with profiling.trace(str(Path(tmp) / "trace")) as prof:
            small.forward(i1, i2)
    text = (Path(tmp) / "trace" / "trace.json").read_text()
    named = [k for k in kernel_names(corr_cuda) if k in text]
    rows = [e for e in prof.key_averages() if "corr_window" in e.key]
    print(f"host tools trace: {len(text) / 1e6:.2f} MB Chrome trace; kernel #1 named: {named}, "
          f"{sum(e.count for e in rows)} launches in its key_averages")
    if not named:
        fail("profiling.trace: the trace does not name kernel #1")
    out["trace"] = dict(bytes=len(text), kernel_1_named=bool(named),
                        kernel_1_events=sum(e.count for e in rows))

    run = graphs.CudaGraphed(serving.build_serving_fn(est, acc))
    with profiling.trace(str(Path(tmp) / "spans")):
        run(images)  # warm-ups, capture, the first replay
        run(images)
    recs = [r for r in profiling.drain() if r.graph]
    doc = json.loads((Path(tmp) / "spans" / "trace.json").read_text())
    track = [e for e in (doc["traceEvents"] if isinstance(doc, dict) else doc)
             if e.get("cat") == "span"]
    clips = [r for r in recs if r.name == "acc.clip"]
    kids = [sum(r.ms for r in recs if r.parent == c.id) for c in clips]
    names = sorted({r.name for r in recs})
    print(f"host tools spans: graphed clip (7x512^2, batch 2) under profiling.trace, 2 replays: "
          f"acc.clip {[round(c.ms, 3) for c in clips]} ms, its children {[round(k, 3) for k in kids]} "
          f"ms (phase 5b's median {graphed_clip_ms:.2f} ms); spans {names}; "
          f"{sum(e['name'] == 'acc.clip' for e in track)} acc.clip on the trace's span track")
    if len(clips) != 2 or not any(e["name"] == "acc.clip" for e in track):
        fail("profiling.trace: the graphed clip's spans are not in the trace")
    if any(k > c.ms for k, c in zip(kids, clips)):
        fail("profiling spans: the children of acc.clip outlast it")
    out["spans"] = dict(clip_ms=[c.ms for c in clips], children_ms=kids, names=names,
                        phase5b_median_ms=graphed_clip_ms)
    del run, est, acc, images, small
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# --nccl-spatial: the spatial axis over NCCL on N cards, one rank per card
# ---------------------------------------------------------------------------

NCCL_JOBS = ("o", "p", "q", "r")  # the one-process references, shared out over the ranks
NCCL_DEADLINE = 600  # seconds for all of --nccl-spatial's ranks (351 s on four H100s at 700 W)
NCCL_CASE = {"o": "b", "p": "d", "q": "k", "r": "n"}  # each job's case of phases 21-24


def nccl_references(jobs, world: int) -> dict:
    """This rank's share of --nccl-spatial's one-process references, on its
    own card: (o), (p) graphed_inference on the whole frames (the reading
    of one process) and each batch element alone (the bf16 bar's
    batch-1-vs-2 spread, spatial_run's); (q) spatial_train_run("k") as
    shipped and in f32, at batch 6 and at 6 x world (the data-parallel
    case's global batch), and spatial_graph_steps("k") (the reading); (r)
    spatial_ft_run("n") as shipped and in f32, spatial_graph_steps("n")."""
    out = {}
    for job in jobs:
        case = NCCL_CASE[job]
        if job in "op":
            out[job] = graphed_inference(f"nccl ({job}) one process", case, None)
            out[f"{job} spread"] = torch.cat([spatial_run(case, None, (i,))["out"]
                                              for i in range(2)], 1)
            continue
        run = spatial_train_run if job == "q" else spatial_ft_run
        out[job] = run(case, None)
        out[f"{job} f32"] = run(case, None, "float32")
        if job == "q":
            out["q data"] = run(case, None, batch=6 * world)
            out["q data f32"] = run(case, None, "float32", batch=6 * world)
        out[f"{job} steps"] = spatial_graph_steps(f"nccl ({job}) one process", case, None)
    for row in out.values():
        if isinstance(row, dict):
            row.pop("record", None)
    return out


def nccl_spatial_child(rank: int, world: int, port: int, work: str) -> int:
    """One rank of --nccl-spatial, on card `rank`: join the NCCL group, make
    the meshes (n_spatial 2 and `world`; on four cards the (2, 2) mesh is
    n_spatial 2's), compute this rank's share of the one-process
    references, then every case on its rows, eager and graphed: (o) and
    (p) at each n_spatial; (q) and (r) one step (the reduced gradients) and
    spatial_graph_steps at each n_spatial with each spatial group on the
    whole batch, and on the (2, 2) mesh with each data group on its half;
    (q) data-parallel over every rank (no handle, a global batch of 6 a
    rank). Saves what it saw."""
    os.environ.update(torchrun_env(world, rank, port), LOCAL_RANK=str(rank))
    if not mesh.maybe_init_distributed("cuda") or torch.distributed.get_backend() != "nccl":
        fail(f"nccl child {rank}: no NCCL group")
    try:
        meshes = {n: mesh.make_mesh(world // n, n) for n in sorted({2, world})}
        out = {"ref": nccl_references(NCCL_JOBS[rank::world], world),
               "card": torch.cuda.get_device_name(rank)}
        mesh.sync_processes("references")
        steps = {str(n): (m.axis, None, (0, 1)) for n, m in meshes.items()}
        if world == 4:
            steps["2x2"] = (meshes[2].axis, meshes[2].data_group, (rank // 2, 2))
        for n, m in meshes.items():
            for job in "op":
                out[f"{job} {n}"] = graphed_inference(f"nccl ({job}) n_spatial {n}",
                                                      NCCL_CASE[job], m.axis)
        for name, (sp, group, data) in steps.items():
            for job, run in (("q", spatial_train_run), ("r", spatial_ft_run)):
                out[f"{job} {name}"] = dict(
                    grads=run(NCCL_CASE[job], sp, group=group, data=data),
                    steps=spatial_graph_steps(f"nccl ({job}) mesh {name}", NCCL_CASE[job], sp,
                                              group, data))
        world_group = torch.distributed.group.WORLD
        out["q data"] = dict(
            grads=spatial_train_run("k", None, group=world_group, data=(rank, world),
                                    batch=6 * world),
            steps=spatial_graph_steps(f"nccl (q) data-parallel x{world}", "k", None, world_group,
                                      (rank, world), 6 * world))
        torch.save(out, Path(work) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def nccl_launch(world: int, work: Path) -> tuple:
    """`world` ranks of nccl_spatial_child, one per card, to their end: what
    each saved and their seconds. A rank that fails ends the others (they
    would wait in a collective) and the run."""
    port = free_port()
    logs = [open(work / f"rank{r}.log", "w") for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--nccl-spatial-child",
                               str(r), str(world), str(port), str(work)], cwd=str(REPO),
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    try:
        deadline = time.monotonic() + NCCL_DEADLINE
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                for f in logs:
                    f.flush()
                text = (work / f"rank{bad[0] if bad else 0}.log").read_text()
                fail(f"nccl-spatial: rank {bad[0] if bad else 'all'} "
                     f"{'exited ' + str(procs[bad[0]].returncode) if bad else 'timed out'}:\n"
                     f"{text[-6000:]}")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    secs = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            fail(f"nccl-spatial: rank {r} exited {p.returncode}:\n"
                 f"{(work / f'rank{r}.log').read_text()[-6000:]}")
    print((work / "rank0.log").read_text(), end="")
    return [torch.load(work / f"rank{r}.pt", weights_only=True) for r in range(world)], secs


def nccl_inference_check(job: str, n: int, ranks: list, refs: dict) -> dict:
    """(o) or (p) at n_spatial `n`: the first spatial group's rows put
    together against one process, within BATCH_SPREAD x the case's
    batch-1-vs-2 distance; the readings of each rank beside one
    process's."""
    rows = [r[f"{job} {n}"] for r in ranks]
    one = refs[job]
    got = torch.cat([rows[i]["out"] for i in range(n)], dim=2)
    floor = float((refs[f"{job} spread"] - one["out"]).abs().max())
    diff = float((got - one["out"]).abs().max())
    keys = ("eager_ms", "graphed_ms", "collectives", "bytes", "eager_peak_gib",
            "graphed_peak_gib", "busy_ms", "nccl_share", "launches")
    row = dict(max_abs=diff, bar=BATCH_SPREAD * floor, batch_spread=floor, rows=rows[0]["rows"],
               **{k: [r[k] for r in rows] for k in keys},
               one_process={k: one[k] for k in keys})
    print(f"nccl ({job}) n_spatial {n} over NCCL vs one process: max abs {diff:.3e} (bar "
          f"{BATCH_SPREAD:g} x batch-1-vs-2 {floor:.3e}); rows {row['rows']}; ms per call eager "
          f"{', '.join(f'{x:.2f}' for x in row['eager_ms'])}, graphed "
          f"{', '.join(f'{x:.2f}' for x in row['graphed_ms'])} (one process "
          f"{one['eager_ms']:.2f} / {one['graphed_ms']:.2f}); collectives {row['collectives']}, "
          f"bytes {row['bytes']} a call a rank; peak eager / graphed per rank "
          f"{', '.join(f'{a:.3f}/{b:.3f}' for a, b in zip(row['eager_peak_gib'], row['graphed_peak_gib']))}"
          f" GiB (one process {one['eager_peak_gib']:.3f}/{one['graphed_peak_gib']:.3f}); NCCL "
          f"share of a replay {', '.join(f'{100 * x:.2f}' for x in row['nccl_share'])} %")
    if not (diff <= row["bar"] and torch.isfinite(got).all()):
        fail(f"nccl ({job}) n_spatial {n}: {diff:.3e} from one process, bar {row['bar']:.3e}")
    return row


def nccl_step_check(job: str, name: str, n_spatial: int, ranks: list, refs: dict) -> dict:
    """(q) or (r) on mesh `name`: rank 0's reduced gradients against one
    process's f32 step within ACCUM_F32_RATIO x one process's bf16 step's
    distance, every rank's bit-equal; kernel #1 (and the backward kernel)
    12 a step a rank, the ranks' Q adding up to one process's (times the
    spatial groups that hold the whole batch); the readings of each rank's
    graphed and eager steps beside one process's."""
    data = name == "data"
    key = f"{job} {name}"
    rows = [r[key] for r in ranks]
    one, one_f32 = (refs[f"{job} data"], refs[f"{job} data f32"]) if data else \
        (refs[job], refs[f"{job} f32"])
    grads = [r["grads"]["grads"] for r in rows]
    same = all(set(g) == set(grads[0]) and all(torch.equal(g[k], grads[0][k]) for k in g)
               for g in grads[1:])
    dist, base = rel_l2(grads[0], one_f32["grads"]), rel_l2(one["grads"], one_f32["grads"])
    ratio = dist / (ACCUM_F32_RATIO * base)
    kernels = ("corr_lookup",) + (("corr_lookup_backward",) if job == "r" else ())
    launches = [{k: r["grads"]["launches"][k] for k in kernels} for r in rows]
    copies = 1 if (data or name == "2x2") else len(ranks) // n_spatial
    q_sum = sum(r["grads"]["q"][0] for r in rows)
    steps = [r["steps"] for r in rows]
    keys = ("eager_ms", "graphed_ms", "collectives_per_step", "bytes_per_step",
            "eager_peak_gib", "graphed_peak_gib", "nccl_share", "busy_ms")
    row = dict(vs_f32_grad_rel_l2=dist, one_bf16_vs_f32_grad_rel_l2=base, ratio=ratio,
               ranks_bit_equal=same, launches=launches, q=[r["grads"]["q"] for r in rows],
               one_process_q=one["q"], loss=rows[0]["grads"]["loss"], one_loss=one["loss"],
               **{k: [r["grads"][k] for r in rows] for k in (
                   "forward_collectives", "forward_bytes", "backward_collectives",
                   "backward_bytes", "peak", "secs")},
               **{k: [s[k] for s in steps] for k in keys},
               deterministic=[s["deterministic"] for s in steps],
               one_process={k: refs[f"{job} steps"][k] for k in keys})
    print(f"nccl ({job}) {name} over NCCL: gradients vs one process's f32 step relative L2 "
          f"{dist:.3e}, one process's bf16 step's {base:.3e} ({ratio:.3f} of the bar); ranks' "
          f"gradients {'bit-equal' if same else 'DIFFER'}; launches a rank {launches}; Q "
          f"{row['q']} (one process {one['q']}); collectives forward / backward "
          f"{row['forward_collectives']} / {row['backward_collectives']}, bytes "
          f"{row['forward_bytes']} / {row['backward_bytes']}; steps eager "
          f"{', '.join(f'{x:.2f}' for x in row['eager_ms'])} ms, graphed "
          f"{', '.join(f'{x:.2f}' for x in row['graphed_ms'])} ms (one process "
          f"{row['one_process']['eager_ms']:.2f} / {row['one_process']['graphed_ms']:.2f}); peak "
          f"graphed {', '.join(f'{x:.3f}' for x in row['graphed_peak_gib'])} GiB (one process "
          f"{row['one_process']['graphed_peak_gib']:.3f}); NCCL share of a replay "
          f"{', '.join(f'{100 * x:.2f}' for x in row['nccl_share'])} %")
    if not (ratio <= 1.0 and same and all(v == 12 for lc in launches for v in lc.values())
            and q_sum == one["q"][0] * copies):
        fail(f"nccl ({job}) {name}: ratio {ratio:.3f}, ranks equal {same}, launches {launches}, "
             f"Q {row['q']} summing to {q_sum} against {one['q']} x {copies}")
    return row


def nccl_spatial_main() -> int:
    """--nccl-spatial: the spatial axis over NCCL on every card of the
    machine (two or more), nccl_spatial_child's cases held and read."""
    world = torch.cuda.device_count()
    if world < 2:
        print(f"chip_smoke --nccl-spatial: needs two cards or more, found {world}",
              file=sys.stderr)
        return 1
    line = smi("name,power.limit")
    print(line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{world}")
    build_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        ranks, secs = nccl_launch(world, Path(tmp))
    refs = {k: v for r in ranks for k, v in r["ref"].items()}
    out = {"card": line, "world": world, "seconds": secs}
    for n in sorted({2, world}):
        for job in "op":
            out[f"{job} {n}"] = nccl_inference_check(job, n, ranks, refs)
    for name in [str(n) for n in sorted({2, world})] + (["2x2"] if world == 4 else []):
        for job in "qr":
            n_spatial = 2 if name == "2x2" else int(name)
            out[f"{job} {name}"] = nccl_step_check(job, name, n_spatial, ranks, refs)
    out["q data"] = nccl_step_check("q", "data", 1, ranks, refs)
    out["one_process"] = {**{job: {k: v for k, v in refs[job].items() if k != "out"}
                             for job in "op"},
                          **{job: refs[f"{job} steps"] for job in "qr"}}
    print(f"nccl-spatial: {world} ranks in {secs:.1f} s on {line} x{world}")
    print(json.dumps({"nccl_spatial": out}, default=str))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": world}}))
    return 0


def build_kernels() -> None:
    """Phase 2: one nvcc per source (and per build of a source), started
    together."""
    builds = (corr_cuda.build, corr_level_cuda.build, corr_bd_cuda.build,
              corr_backward_cuda.build, probes.build_floor,
              lambda: corr_level_cuda.build("-DCORR_LEVELS=1"),
              # phase 26's builds: kernel #2 and its backward for other (radius,
              # levels), kernel #3 for 7 taps
              *[lambda rl=rl: corr_level_cuda.build(*corr_level_cuda.defines(*rl))
                for rl in OPTION_BUILDS],
              lambda: corr_backward_cuda.build(*corr_backward_cuda.defines(3, 3)),
              lambda: corr_bd_cuda.build(*corr_bd_cuda.defines(7)))
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
    ap.add_argument("--dp-child", nargs=3, metavar=("RANK", "PORT", "DIR"),
                    help="run one rank of phase 19c (started by the script itself)")
    ap.add_argument("--spatial-child", nargs=3, metavar=("RANK", "PORT", "DIR"),
                    help="run one rank of phase 21 (started by the script itself)")
    ap.add_argument("--nccl-spatial", action="store_true",
                    help="instead of the phases, the spatial axis over NCCL on every card (2+)")
    ap.add_argument("--nccl-spatial-child", nargs=4, metavar=("RANK", "WORLD", "PORT", "DIR"),
                    help="run one rank of --nccl-spatial (started by the script itself)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.nccl_spatial:
        return nccl_spatial_main()
    if args.nccl_spatial_child:
        rank, world, port, work = args.nccl_spatial_child
        return nccl_spatial_child(int(rank), int(world), int(port), work)
    if args.dp_child:
        rank, port, work = args.dp_child
        return dp_child(int(rank), int(port), work)
    if args.spatial_child:
        rank, port, work = args.spatial_child
        return spatial_child(int(rank), int(port), work)

    line = smi("name,power.limit")
    print(line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase_secs, last = {}, [time.perf_counter()]

    def lap() -> float:
        now = time.perf_counter()
        secs, last[0] = now - last[0], now
        return secs

    build_kernels()
    phase_secs["2"] = lap()

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
    phase_secs["3-4c"] = lap()

    with tempfile.TemporaryDirectory() as tmp:
        launches1, fps, clip_med, small, clip_extra = clip_path(args.profile, tmp)
        phase_secs["5"] = lap()
        experimental = experimental_phase(clip_med * 1e3, args.profile)
        phase_secs["25 (a), (b)"] = lap()
        fps_bd = experimental["clip"]["fused_bd"]["frames_per_s"]
        print(f"frames/s {fps:.3f} on {line} (AccFlow+RAFT, 7x512^2, batch 2, 12 iters, bf16); "
              f"{fps_bd:.3f} with experimental:fused_bd (phase 25, one timed forward); graphed "
              f"{clip_extra['graphed']['frames_per_s']:.3f}; loaded bf16 artifact "
              f"{14 / clip_extra['artifact']['median_ms'] * 1e3:.3f}")
        stream_a = stream_path("(a) RAFT-small", True, args.profile, tmp)
        phase_secs["6a, 9b"] = lap()
        gma_row = gma_clip_path(args.profile)
        gma_small = small_clip("gma")
        chunked = chunked_attention()
        phase_secs["10-11"] = lap()
        api_rows, pipe_gma, lr_gma, clip7 = pipeline_phase(
            tmp, clip_extra["graphed"]["median_ms"])
        demo_row = demo_phase(tmp, pipe_gma, lr_gma, clip7)
        del pipe_gma
        torch.cuda.empty_cache()
        phase_secs["12-13"] = lap()
    print(f"GMA frames/s on {line} (AccFlow+GMA, 7x512^2, batch 2, 12 iters, bf16): eager "
          f"{gma_row['eager_frames_per_s']:.3f}, graphed {gma_row['graphed']['frames_per_s']:.3f}")
    stream_b = stream_path("(b) full RAFT", False, args.profile)
    stream_c = stream_path("(c) GMA", False, False, ofe="gma", bit_equal=True)
    phase_secs["6b, 6c"] = lap()
    print(f"stream frames/s on {line} (512^2, batch 2, 6 iters, bf16): (a) RAFT-small eager "
          f"{stream_a['eager_frames_per_s']:.3f} ({stream_a['eager_median_ms']:.3f} ms per push), "
          f"graphed {stream_a['frames_per_s']:.3f} ({stream_a['median_ms']:.3f} ms); (b) full "
          f"RAFT eager {stream_b['eager_frames_per_s']:.3f} ({stream_b['eager_median_ms']:.3f} "
          f"ms), graphed {stream_b['frames_per_s']:.3f} ({stream_b['median_ms']:.3f} ms)")
    drift_launches = drift_fixture()
    phase_secs["7"] = lap()
    evals = eval_phase()
    phase_secs["8"] = lap()
    with tempfile.TemporaryDirectory() as tmp:
        train = train_phase(tmp, args.profile)
        phase_secs["14"] = lap()
        root = str(Path(tmp) / "cvor_train")
        finetune = finetune_phase(root, tmp, args.profile)
        phase_secs["15"] = lap()
        ondemand = dict(small_clips=ondemand_small_clips(), clip=ondemand_clip(),
                        hires=hires_phase(), finetune=finetune_ondemand(root, tmp))
        phase_secs["16"] = lap()
        f0n = f0n_phase(root, tmp)
        phase_secs["17"] = lap()
        options = options_phase(root, tmp)
        phase_secs["26 (a)-(e)"] = lap()
        sintel = sintel_phase(tmp)
        phase_secs["18"] = lap()
        dp = dp_phase(root, tmp, train, finetune, evals)
        phase_secs["19"] = lap()
        tools = host_tools_phase(tmp, clip_extra["graphed"]["median_ms"])
        phase_secs["20"] = lap()
        spatial = spatial_phase(tmp)
        phase_secs["21-24, 25 (d)"] = lap()
    print(f"train on {line} (graphed, train_acc): AccRAFT {train['accraft']['ms_per_step']:.2f} "
          f"ms per step ({train['accraft']['clips_per_s']:.3f} clips/s, peak "
          f"{train['accraft']['peak_gib']:.3f} GiB, idle "
          f"{100 * train['accraft']['replay']['idle_share']:.1f} %); AccGMA "
          f"{train['accgma']['ms_per_step']:.2f} ms per step "
          f"({train['accgma']['clips_per_s']:.3f} clips/s, peak {train['accgma']['peak_gib']:.3f} GiB)"
          f"; steps alone: eager {train['graphed']['eager_ms']:.2f} ms, graphed "
          f"{train['graphed']['graphed_ms']:.2f} ms, busy {train['graphed']['busy_ms']:.2f} ms")
    print(f"fine-tune on {line} (graphed, fine_tune): " + "; ".join(
        f"{name} {finetune[key]['ms_per_step']:.2f} ms per step ({finetune[key]['clips_per_s']:.3f} "
        f"clips/s, peak {finetune[key]['peak_gib']:.3f} GiB)"
        for name, key in (("RAFT", "raft"), ("GMA", "gma"), ("RAFT-small", "raft_small")))
        + "; RAFT steps alone, eager / graphed / busy ms: " + ", ".join(
            f"{remat} {r['eager_ms']:.2f} / {r['graphed_ms']:.2f} / {r['busy_ms']:.2f}"
            for remat, r in finetune["graphed"].items()))
    hires = ondemand["hires"]["rows"]
    print(f"ondemand on {line}: clip 7x512^2 batch 2 eager " + ", ".join(
        f"{lk} {r['ms_per_forward']:.2f} ms (peak {r['peak_gib']:.3f} GiB)"
        for lk, r in ondemand["clip"].items()) + "; long_range " + ", ".join(
        f"{k} {r['s_per_call']:.3f} s (peak {r['peak_gib']:.3f} GiB)" for k, r in hires.items())
        + f"; fine-tune RAFT ondemand {ondemand['finetune']['raft']['ms_per_step']:.2f} ms per "
        f"step (peak {ondemand['finetune']['raft']['peak_gib']:.3f} GiB; fused "
        f"{finetune['raft']['ms_per_step']:.2f} ms, {finetune['raft']['peak_gib']:.3f} GiB)")
    print(f"F0N on {line}: train AccRAFT-F0N {f0n['train']['ms_per_step']:.2f} ms per step "
          f"({f0n['train']['clips_per_s']:.3f} clips/s, peak {f0n['train']['peak_gib']:.3f} GiB, "
          f"idle {100 * f0n['train']['replay']['idle_share']:.1f} %; AccRAFT "
          f"{train['accraft']['ms_per_step']:.2f} ms); clip 7x512^2 " + ", ".join(
              f"{k} {c['ms_per_forward']:.2f} ms" for k, c in f0n["clips"].items()))
    print(f"sintel on {line} (1024x436, interv 6, 12 iters, bf16, batch 4): " + ", ".join(
        f"{m} {r['s_per_sample']:.3f} s per sample (loader {100 * r['loader_share']:.1f} %, peak "
        f"{r['peak_gib']:.3f} GiB)" for m, r in sintel["rows"].items()))
    print(f"data parallel on {line}: world of one over NCCL, graphed, deterministic: " + ", ".join(
        f"{name} {dp[k]['ms_per_step']:.2f} ms per step (no group "
        f"{dp[k]['no_group_ms_per_step']:.2f}, bit-equal)"
        for name, k in (("train_acc", "train"), ("fine_tune", "finetune")))
        + "; two gloo ranks on one card agree with one process at batch 2")
    print(json.dumps({"sintel": {"card": line, **sintel}}, default=str))
    print(json.dumps({"data_parallel": {"card": line, **dp}}, default=str))
    print(f"spatial axis on {line}: two gloo ranks on one card (not a reading of NCCL), each "
          "against one process: " + "; ".join(
              f"({case}) max abs {spatial[case]['max_abs']:.3e} (bar {spatial[case]['bar']:.3e}), "
              f"peak per rank {max(spatial[case]['rank_peak_gib']):.3f} GiB (one process "
              f"{spatial[case]['one_process_peak_gib']:.3f})"
              for case in SPATIAL_CASES + SPATIAL22_CASES + SPATIAL23_CASES + SPATIAL26_CASES)
          + "; train steps " + "; ".join(
              f"({case}) {spatial[case]['ratio']:.3f} of its bar, peak per rank "
              f"{max(spatial[case]['rank_peak_gib']):.3f} GiB (one process "
              f"{spatial[case]['one_process_peak_gib']:.3f})" for case in SPATIAL_TRAIN_KW)
          + "; fine-tune steps " + "; ".join(
              f"({case}) {spatial[case]['ratio']:.3f} of its bar, peak per rank "
              f"{max(spatial[case]['rank_peak_gib']):.3f} GiB (one process "
              f"{spatial[case]['one_process_peak_gib']:.3f})" for case in SPATIAL_FT_KW))
    print(json.dumps({"host_tools": {"card": line, **tools}}, default=str))
    print(json.dumps({"spatial": {"card": line, **spatial}}, default=str))
    print(json.dumps({"ondemand": {"card": line, **ondemand}}, default=str))
    print(json.dumps({"f0n": {"card": line, **f0n}}, default=str))
    print(json.dumps({"graphs": {"card": line, "clip": clip_extra, "stream_a": stream_a,
                                 "stream_b": stream_b}}))
    print(json.dumps({"gma": {
        "card": line, "clip": gma_row, "small_clip_launches": gma_small,
        "chunked_attention": chunked, "stream_c": stream_c,
        "eval": {f"{m} {lk}": evals[m, lk] for m, lk in evals if "gma" in m},
        "pipeline": api_rows, "demo": demo_row}}))
    print(json.dumps({"train": {"card": line, **train}}))
    print(json.dumps({"finetune": {"card": line, **finetune}}))
    experimental.update(c=rows2_r4["bfloat16, bf16 out"], d=spatial["mix clip"])
    print(json.dumps({"experimental": {"card": line, **experimental}}))
    options["spatial"] = {c: spatial[c] for c in SPATIAL26_CASES}
    print(json.dumps({"options": {"card": line, **options}}, default=str))
    print(json.dumps({"phase_seconds": {"card": line, **phase_secs,
                                        "total": sum(phase_secs.values())}}))

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
         "gma_eval_launches": evals["acc|gma", "fused"]["launches"],
         "eval_launches_in": "one acc|raft fused eval batch, graphed: a micro-batch call's "
                             "2 warm-ups and its capture counted, the replay not",
         "train_launches": train["accraft"]["launches"]["corr_lookup"],
         "train_launches_in": f"AccRAFT training, {train['accraft']['steps']} graphed steps "
                              "and a validation batch: 2 eager steps, the capture and the "
                              "validation's 2 warm-ups and capture counted, replays not",
         "train_launches_per_step": train["accraft"]["launches_per_step"],
         "train_launches_per_validation_batch": train["accraft"]["launches_per_valid_batch"],
         "train_launches_per_replay": train["accraft"]["replay"]["lookup_launches"],
         "gma_train_launches": train["accgma"]["launches"]["corr_lookup"],
         "train_shape": train["lookup_train_shape"],
         "finetune_launches": finetune["raft"]["launches"]["corr_lookup"],
         "finetune_launches_in": f"RAFT fine-tune, {finetune['raft']['steps']} graphed steps "
                                 "and a validation batch (float32 levels, bfloat16 out), "
                                 "counted as in training",
         "finetune_launches_per_replay": finetune["raft"]["replay"]["lookup_launches"],
         "finetune_shape": finetune["lookup_kernel_1"],
         "ondemand_clip_launches": {lk: r["launches"] for lk, r in ondemand["clip"].items()},
         "ondemand_clip_launches_in": "5 eager forwards of the 7x512^2 clip each (12 per "
                                      "chunk and forward)",
         "hires_launches": {k: r["launches"] for k, r in hires.items()},
         "finetune_ondemand_launches": ondemand["finetune"]["raft"]["launches"]["corr_lookup"],
         "finetune_ondemand_launches_in": "RAFT fine-tune with corr_lookup ondemand, 6 graphed "
                                          "steps, counted as in training",
         "f0n_train_launches": f0n["train"]["launches"]["corr_lookup"],
         "f0n_train_launches_in": "AccRAFT-F0N training, 13 graphed steps and a validation "
                                  "batch, counted as in training",
         "f0n_clip_launches": {k: c["launches"] for k, c in f0n["clips"].items()},
         **{f"sintel_{m.replace('|', '_')}_launches": r["launches"]
            for m, r in sintel["rows"].items()},
         "sintel_launches_in": "cli/test_sintel over 8 samples at batch 4 (1024x440, T=8): one "
                               "signature's 2 warm-ups and capture counted, the replay not",
         "dp_train_launches": dp["train"]["launches"]["corr_lookup"],
         "dp_finetune_launches": dp["finetune"]["launches"]["corr_lookup"],
         "dp_launches_in": f"train_acc (AccRAFT.yml) and fine_tune (RAFT.yml) in a world of one "
                           f"over NCCL, {DP_STEPS} graphed steps each, counted as in training",
         "dp_two_ranks_launches": {k: r["rank_launches"] for k, r in dp["two_ranks"].items()
                                   if isinstance(r, dict)},
         "dp_spatial_launches": {
             "o": dp["spatial_one_rank"]["o"]["launches"],
             "p": dp["spatial_one_rank"]["p"]["launches"],
             **{k: dp["spatial_one_rank"][k]["lookup_launches_per_replay"] for k in "qr"}},
         "dp_spatial_launches_in": "phase 19a's one-rank spatial handle over NCCL: (o) one eager "
                                   "CVO-6 clip forward, (p) one eager push of stream (b) (a "
                                   "replay's profile ran as many), (q) and (r) a replayed "
                                   "AccRAFT.yml and RAFT.yml step's profile",
         "spatial_launches": {c: spatial[c]["launches"] for c in ("b", "c", "d", "e", "g",
                                                                  "h clip", "k", "n")
                              + SPATIAL23_CASES},
         "spatial_q": {c: spatial[c]["q"] for c in ("b", "c", "d", "e", "g", "h clip", "k", "n")
                       + SPATIAL23_CASES},
         "spatial_launches_in": "phases 21-23, each of two gloo ranks on one card, height "
                                "sharded, one call each: (b) a CVO-6 clip forward, (c) a "
                                "7x1920x1088 clip forward through auto (ondemand), (d) a "
                                "stream's reset and 5 pushes, (e) an AccFlow+GMA CVO-6 clip "
                                "forward, (g) a GMA stream (c), (h) a 7x1024x440 clip forward "
                                "at 224 + 216 rows, (k) an AccRAFT.yml train step (batch 6, "
                                "256^2), (l) a warm-started, F0N fused and cold stepwise CVO-6 "
                                "clip forward, (n) a RAFT.yml fine-tune step (batch 6, 256^2, "
                                "float32 levels)"},
        {"name": "corr_lookup_f32_out", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_lookup.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:264",
         "launches": small["fused"], "launches_in": "the f32 small clip on the GPU",
         "spatial_launches": {c: spatial[c]["launches"] for c in ("a fused", "a ondemand:64",
                                                                  "h pair", *SPATIAL_J,
                                                                  *SPATIAL_FT_F32)},
         "spatial_q": {c: spatial[c]["q"] for c in ("a fused", "a ondemand:64", "h pair",
                                                    *SPATIAL_J, *SPATIAL_FT_F32)},
         "spatial_launches_in": "phases 21 (a), 22 (h), 23 (j) and 24 (m), each of two gloo "
                                "ranks on one card, height sharded: one 128^2 forward "
                                "(1024x440 at 224 + 216 rows) at 2 iterations; "
                                "one 64^2 train step (40x64 at 24 + 16 rows) at 4 iterations; "
                                "one 64^2 fine-tune step (40x64) at 12 iterations",
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
         "radius4_clip_shape": rows2_r4,
         "pallas_clip_launches": experimental["clip"]["pallas"]["launches"],
         "pallas_clip_launches_in": "phase 25 (b), one timed forward of the CVO-6 clip with "
                                    "experimental:pallas (radius 4, bfloat16 in and out: "
                                    "radius4_clip_shape's 'bfloat16, bf16 out' row)",
         "finetune_launches": finetune["raft_small"]["launches"]["corr_level_lookup"],
         "finetune_launches_in": "RAFT-small fine-tune, 6 graphed steps (float32 levels, "
                                 "bfloat16 out): 2 eager steps and the capture counted",
         "finetune_shape": finetune["lookup_kernel_2"],
         "ondemand_small_clip_launches": ondemand["small_clips"]["RAFT-small ondemand:16"],
         "spatial_launches": spatial["f"]["launches"], "spatial_q": spatial["f"]["q"],
         "spatial_launches_in": "phase 22 (f), each of two gloo ranks on one card, height "
                                "sharded: stream (a), a reset and 5 pushes"},
        {"name": "corr_level_lookup_f32_out", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_level_lookup.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:466",
         "launches": drift_launches, "launches_in": "the f32 drift fixture on the GPU",
         "spatial_launches": {c: spatial[c]["launches"] for c in ("i", "m small")},
         "spatial_q": {c: spatial[c]["q"] for c in ("i", "m small")},
         "spatial_launches_in": "phases 22 (i) and 24 (m), each of two gloo ranks on one card, "
                                "height sharded: the drift fixture's 36 frames; one 64^2 "
                                "RAFT-small fine-tune step at 12 iterations",
         "pallas_small_clip_launches": experimental["small_clip"]["pallas"]["launches"],
         "pallas_small_clip_launches_in": "phase 25 (a), the f32 small clip with "
                                          "experimental:pallas (radius 4)",
         **rows2["float32"], "levels_dtype": "float32", "out_dtype": "float32", "radius": 3},
        {"name": "corr_y_contract", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_y_contract.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:343",
         "launches": evals["acc|raft", "experimental:fused_bd"]["launches"],
         "launches_in": "one acc|raft experimental:fused_bd eval batch, graphed: a "
                        "micro-batch call's 2 warm-ups and its capture counted",
         **rows3["level0"]["bfloat16, bf16 out"],
         "shape": "level 0 of the clip path, bfloat16 in", "out_dtype": "bfloat16",
         "level1": rows3["level1"]["bfloat16, bf16 out"],
         "clip_launches": experimental["clip"]["fused_bd"]["launches"],
         "clip_launches_in": "phase 25 (b), one timed forward of the CVO-6 clip with "
                             "experimental:fused_bd",
         "mix_clip_launches": experimental["clip"][EXPERIMENTAL[-1]]["launches"],
         "mix_clip_launches_in": f"phase 25 (b), one timed forward of the CVO-6 clip with "
                                 f"experimental:{EXPERIMENTAL[-1]} (bd on level 3)",
         "fused_bd2_eval_launches": evals["acc|raft", "experimental:fused_bd2"]["launches"],
         "split_windows_max_diff_over_A": split_ratio},
        {"name": "corr_y_contract_f32_out", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_y_contract.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:343",
         "launches": small["experimental:fused_bd"],
         "launches_in": "the f32 small clip on the GPU, experimental:fused_bd",
         "spatial_launches": spatial["bd clip"]["launches"], "spatial_q": spatial["bd clip"]["q"],
         "spatial_launches_in": "phase 21 (bd clip), each of two gloo ranks on one card, height "
                                "sharded: the 64^2 f32 small clip, one forward",
         "gma_small_clip_launches": gma_small["experimental:fused_bd"],
         "mix_small_clip_launches": experimental["small_clip"][EXPERIMENTAL[-1]]["launches"],
         "mix_small_clip_launches_in": f"phase 25 (a), the f32 small clip with "
                                       f"experimental:{EXPERIMENTAL[-1]}",
         **rows3["level0"]["float32"],
         "shape": "level 0 of the clip path, float32 in", "out_dtype": "float32",
         "level1": rows3["level1"]["float32"],
         "float32_in_bf16_out": rows3["level0"]["float32, bf16 out"],
         "bfloat16_in": {"level0": rows3["level0"]["bfloat16"],
                         "level1": rows3["level1"]["bfloat16"]}},
        {"name": "corr_lookup_backward", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_lookup_backward.cu",
         "replaces": "accflow_tpu/ops/corr.py:997",
         "replaces_note": "no TPU kernel: the gradient XLA derives for the fused lookup "
                          "(lookup_corr) in JAX's fine-tune step; the Pallas kernels have none",
         "launches": finetune["raft"]["launches"]["corr_lookup_backward"],
         "launches_in": f"RAFT fine-tune, {finetune['raft']['steps']} graphed steps: 2 eager "
                        "steps and the capture counted, replays not",
         "launches_per_replay": finetune["raft"]["replay"]["backward_launches"],
         **finetune["backward_kernel_1"]["float32 levels, bfloat16 grad"],
         "levels_dtype": "float32", "grad_dtype": "bfloat16", "radius": 4,
         "shape": "Q = 6*32*32, maps 32^2 .. 4^2",
         "gma_launches": finetune["gma"]["launches"]["corr_lookup_backward"],
         "finetune_ondemand_launches":
             ondemand["finetune"]["raft"]["launches"]["corr_lookup_backward"],
         "finetune_ondemand_64_launches": ondemand["finetune"]["gpu_vs_cpu"]["launches"],
         "dp_finetune_backward_launches": dp["finetune"]["launches"]["corr_lookup_backward"],
         "dp_two_ranks_finetune_launches": dp["two_ranks"]["finetune"]["rank_launches"],
         "dp_spatial_launches": dp["spatial_one_rank"]["r"]["backward_launches_per_replay"],
         "dp_spatial_launches_in": "phase 19a (r), a replayed RAFT.yml step's profile under the "
                                   "one-rank spatial handle over NCCL",
         "spatial_launches": {c: spatial[c]["backward_launches"]
                              for c in (*SPATIAL_FT_F32, "n")},
         "spatial_launches_in": "phase 24, each of two gloo ranks on one card, height sharded: "
                                "one fine-tune step of (m) at 64^2 (40x64) f32 and of (n) "
                                "RAFT.yml (batch 6, 256^2)",
         "other_dtypes": {k: v for k, v in finetune["backward_kernel_1"].items()
                          if k != "float32 levels, bfloat16 grad"}},
        {"name": "corr_level_lookup_backward", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_lookup_backward.cu",
         "replaces": "accflow_tpu/ops/corr.py:997",
         "replaces_note": "no TPU kernel: the gradient XLA derives for RAFT-small's lookup "
                          "(lookup_corr at radius 3) in JAX's fine-tune step",
         "launches": finetune["raft_small"]["launches"]["corr_level_lookup_backward"],
         "launches_in": f"RAFT-small fine-tune, {finetune['raft_small']['steps']} graphed "
                        "steps: 2 eager steps and the capture counted, replays not",
         "launches_per_replay": finetune["raft_small"]["replay"]["backward_launches"],
         **finetune["backward_kernel_2"]["float32 levels, bfloat16 grad"],
         "levels_dtype": "float32", "grad_dtype": "bfloat16", "radius": 3,
         "shape": "Q = 6*32*32, maps 32^2 .. 4^2",
         "bfloat16_levels": finetune["backward_kernel_2"]["bfloat16 levels, bfloat16 grad"],
         "spatial_launches": spatial["m small"]["backward_launches"],
         "spatial_launches_in": "phase 24 (m), each of two gloo ranks on one card, height "
                                "sharded: one 64^2 RAFT-small fine-tune step, f32"},
        *[{"name": f"corr_level_lookup_r{r}_l{nl}", "route": "cuda",
           "source": "accflow_tpu_torch/csrc/corr_level_lookup.cu",
           "replaces": "accflow_tpu/ops/corr_pallas.py:466",
           "build": " ".join(corr_level_cuda.defines(r, nl)), "radius": r, "levels": nl,
           **option_launches(options, spatial, (r, nl)),
           **options["kernels"][f"r{r} l{nl}"]["bfloat16, bf16 out"],
           "levels_dtype": "bfloat16", "out_dtype": "bfloat16",
           "shape": f"Q = 22*64*64, maps 64^2 .. {64 >> (nl - 1)}^2",
           "bf16_in_f32_out": options["kernels"][f"r{r} l{nl}"]["bfloat16"]}
          for r, nl in OPTION_BUILDS],
        {"name": "corr_y_contract_num7", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_y_contract.cu",
         "replaces": "accflow_tpu/ops/corr_pallas.py:343", "build": "-DCORR_NUM=7",
         "launches": options["small_clips"]["raft (3, 3) experimental:fused_bd"]["launches"],
         "launches_in": "phase 26 (a), the f32 small clip with RAFT at (3, 3) and "
                        "experimental:fused_bd (its level 0; f32 in and out)",
         **options["kernels"]["y_contract 7"]["bfloat16, bf16 out"],
         "shape": "level 0 of the clip path, bfloat16 in, 7 taps", "out_dtype": "bfloat16",
         "bf16_in_f32_out": options["kernels"]["y_contract 7"]["bfloat16"]},
        {"name": "corr_level_lookup_backward_r3_l3", "route": "cuda",
         "source": "accflow_tpu_torch/csrc/corr_lookup_backward.cu",
         "replaces": "accflow_tpu/ops/corr.py:997",
         "replaces_note": "no TPU kernel: the gradient XLA derives for the lookup at "
                          "corr_levels 3, corr_radius 3 in JAX's fine-tune step",
         "build": "-DCORR_RADIUS=3 -DCORR_LEVELS=3",
         "launches": options["training"]["raft_yml"]["launches"]["corr_level_lookup_backward"],
         "launches_in": "phase 26 (d), RAFT.yml with corr_levels 3, corr_radius 3, 6 graphed "
                        "steps: 2 eager steps and the capture counted, replays not",
         "launches_per_replay": options["training"]["raft_yml"]["replay"]["backward_launches"],
         **options["kernels"]["backward r3 l3"]["float32 levels, bfloat16 grad"],
         "levels_dtype": "float32", "grad_dtype": "bfloat16", "radius": 3, "levels": 3,
         "shape": "Q = 6*32*32, maps 32^2 .. 8^2",
         "bfloat16_levels": options["kernels"]["backward r3 l3"]["bfloat16 levels, bfloat16 grad"]},
        *probe_rows,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
