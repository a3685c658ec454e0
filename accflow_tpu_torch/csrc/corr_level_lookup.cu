// Per-level correlation window lookup for Hopper (sm_90a), at any radius
// and level count.
//
// Replaces accflow_tpu/ops/corr_pallas.py::lookup_corr_pallas (the TPU
// per-level kernel: body `_level_kernel`, launcher `_lookup_level`, one
// launch per level, tent weights and two small dots per query for the MXU).
// For each query, the (2R+1)^2 bilinear window of each of the L levels,
// (Q, L*(2R+1)^2) in float32 or bfloat16. RAFT-small (radius 3) runs it in
// every GRU iteration, and so does every estimator whose corr_radius and
// corr_levels are not kernel #1's (4, 4). The kernel is corr_window.cuh's
// (R, NL), whose header says how it works: one block takes QT queries and
// all levels, stages the patch rows as 16-byte chunks by cp.async and
// writes its contiguous run of outputs as 16-byte vectors.
//
// Builds. The default build instantiates R = 3 and R = 4 over RAFT's 4
// levels. A build with -DCORR_RADIUS=r instantiates that radius alone, and
// -DCORR_LEVELS=n sets the level count (n = 1: the one-level probe of
// chip_smoke.py, which stands in for the TPU probes of a single level's
// lookup, scripts/probe_pallas_fused.py); ops/corr_level_cuda.py builds one
// library per (radius, levels) a config asks for, and lowers -DCORR_QT
// where a block's staged patches would outgrow shared memory.
//
// Bound (H100 SXM, 3.35 TB/s): memory. At the stream's shape (2 pairs x
// batch 2 at 512^2: Q = 16,384, radius 3, levels 64^2 .. 8^2, bfloat16)
// one launch writes Q*196 outputs, 12.8 MB as float32 and 6.4 MB as
// bfloat16, and reads at most Q*4*64 patch elements, 8.4 MB: 4-6 us. About
// 10 FLOPs per output, far below the compute roofline. At QT = 8 the
// stream's 2,048 blocks of 128 threads fit the 132 SMs in one wave.

#include "corr_window.cuh"

#ifndef CORR_LEVELS
#define CORR_LEVELS 4
#endif

// The level count this library was built for.
extern "C" int corr_level_lookup_levels() { return CORR_LEVELS; }

// The radius this library was built for; 0 for the default build (3 and 4).
extern "C" int corr_level_lookup_radius() {
#ifdef CORR_RADIUS
  return CORR_RADIUS;
#else
  return 0;
#endif
}

#ifdef CORR_RADIUS
static_assert(CORR_RADIUS >= 1, "a window of at least 3 x 3 taps");
static_assert(Smem<float, float, CORR_RADIUS, CORR_LEVELS>::BYTES <= 227 * 1024,
              "a block's staged patches outgrow shared memory: lower CORR_QT");
#endif

// C interface (loaded with ctypes). dtype: 0 = float32 levels, 1 =
// bfloat16; out_dtype: 0 = float32 output, 1 = bfloat16. levels:
// CORR_LEVELS pointers to contiguous (q, hw[2l], hw[2l+1]) maps; coords:
// contiguous (q, 2) float32; out: contiguous (q, CORR_LEVELS*(2*radius+1)^2).
// Launches on `stream`; returns cudaGetLastError() (0 = success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int corr_level_lookup(int dtype, int out_dtype, int radius, const float* coords,
                                 const void* const* levels, const int* hw,
                                 long long q, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef CORR_RADIUS
  if (radius == CORR_RADIUS)
    return window_lookup<CORR_RADIUS, CORR_LEVELS>(dtype, out_dtype, coords, levels, hw, q,
                                                   out, s);
#else
  if (radius == 3)
    return window_lookup<3, CORR_LEVELS>(dtype, out_dtype, coords, levels, hw, q, out, s);
  if (radius == 4)
    return window_lookup<4, CORR_LEVELS>(dtype, out_dtype, coords, levels, hw, q, out, s);
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}
