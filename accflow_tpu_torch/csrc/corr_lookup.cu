// Correlation-pyramid window lookup for Hopper (sm_90a): 4 levels, radius 4.
//
// Replaces accflow_tpu/ops/corr_pallas.py::lookup_corr_fused (the TPU
// all-levels kernel) and the XLA "fused" lookup: for each query, the
// 81-tap bilinear window of each of the 4 levels, (Q, 324) in float32 or
// bfloat16. The kernel is corr_window.cuh's (R = 4, NL = 4), whose header
// says how it works; this file is its C entry.
//
// Bound (H100 SXM, 3.35 TB/s): memory. At the main path's shape
// (Q = 22*64*64 = 90,112 queries, levels 64^2, 32^2, 16^2, 8^2) one launch
// writes Q*324 outputs, 116.8 MB as float32 and 58.4 MB as bfloat16, and
// reads at most Q*4*100 patch elements: 144.2 MB as float32, 72.1 MB as
// bfloat16 (fewer where patches leave the map), plus 0.7 MB of coords.
// About 10 FLOPs per output: far below the compute roofline. A patch row
// is 20 B (bfloat16) or 40 B (float32) anywhere in its map row, so DRAM
// moves the 1.5-2 (2-3) 32-byte sectors it touches: with float32 output the
// practical floor is about 0.09 ms, above the 0.048 ms the bound counts.
// Levels 2 and 3 (16^2, 8^2) have rows of 32 and 16 B in bfloat16: their
// patch rows are whole map rows, so the patch reads at most the whole map
// and no separate whole-map read is needed.

#include "corr_window.cuh"

// C interface (loaded with ctypes). dtype: 0 = float32 levels, 1 =
// bfloat16; out_dtype: 0 = float32 output, 1 = bfloat16. levels: 4
// pointers to contiguous (q, hw[2l], hw[2l+1]) maps; coords: contiguous
// (q, 2) float32; out: contiguous (q, 4*81). Launches on `stream`; returns
// cudaGetLastError() (0 = success), or cudaErrorInvalidValue for arguments
// the kernel does not take.
extern "C" int corr_lookup(int dtype, int out_dtype, const float* coords,
                           const void* const* levels, const int* hw,
                           long long q, void* out, void* stream) {
  return window_lookup<4, 4>(dtype, out_dtype, coords, levels, hw, q, out,
                             static_cast<cudaStream_t>(stream));
}
