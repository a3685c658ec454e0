// Correlation-pyramid window lookup for Hopper (sm_90a).
//
// Replaces accflow_tpu/ops/corr_pallas.py::lookup_corr_fused (the TPU
// all-levels kernel) and the XLA "fused" lookup: for each query q and level
// l, the (2R+1)^2 = 81-tap bilinear window of q's own (hl, wl) correlation
// map around coords(q) / 2^l, align_corners, zeros outside the map. Output
// (Q, L*81) float32, level-major; channel l*81 + a*9 + b samples
// (x/2^l + a - R, y/2^l + b - R), so the outer index a is the x offset.
//
// Design. The window offsets are integers, so all 81 taps of one
// (query, level) share one fractional offset (fx, fy): the window is a read
// of the 10x10 patch at (floor(x/2^l) - R, floor(y/2^l) - R) and a 4-weight
// blend into 9x9 outputs. A block takes QT consecutive queries:
//   1. per (query, level): patch origin and the 4 blend weights;
//   2. stage each patch in shared memory as float, zeros outside the map
//      (a zero-sized level or far-off coords read nothing);
//   3. blend, one output per thread in flat order, so the block's
//      QT*L*81 floats are written as one contiguous, coalesced run.
// Radius, level count (L = 4) and QT are compile-time constants, so every
// index division is by a constant. QT = 8 and 16 time within 2 % of each
// other and QT = 4 is 10-17 % slower on an H100 (`python3 chip_smoke.py
// --tile-sweep`, PERF.md); 8 takes half of 16's shared memory.
// The TPU kernel's tent-weight matmuls and block-diagonal packing existed to
// feed the MXU; they have no purpose here.
//
// Bound (H100 SXM, 3.35 TB/s): memory. At the main path's shape
// (Q = 22*64*64 = 90,112 queries, levels 64^2, 32^2, 16^2, 8^2) one launch
// writes Q*324*4 B = 116.8 MB and reads at most Q*4*100 patch elements:
// 144.2 MB as float32, 72.1 MB as bfloat16 (fewer where patches leave the
// map), plus 0.7 MB of coords. About 10 FLOPs per output: far below the
// compute roofline. The patch rows are 20-40 B pieces scattered over 3.7e8
// map elements, so DRAM moves whole sectors for them: the reads cost more
// than the bytes the bound counts (PERF.md). Offsets into the levels are
// 64-bit (Q*hl*wl passes 2^31 at larger frames or batches).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int R = 4;               // window radius
constexpr int NUM = 2 * R + 1;     // 9 taps per axis
constexpr int P = NUM + 1;         // 10: patch side
constexpr int TAPS = NUM * NUM;    // 81
constexpr int NL = 4;              // pyramid levels
#ifndef CORR_QT
#define CORR_QT 8
#endif
constexpr int QT = CORR_QT;        // queries per block
constexpr int THREADS = 256;

struct Levels {
  const void* ptr[NL];
  int h[NL];
  int w[NL];
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
corr_lookup_kernel(const float* __restrict__ coords, Levels lv,
                   float* __restrict__ out, int64_t q_total) {
  __shared__ float patch[QT][NL][P * P];
  __shared__ int origin[QT][NL][2];
  __shared__ float weight[QT][NL][4];

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QT;
  const int nq = static_cast<int>(q_total - q0 < QT ? q_total - q0 : QT);

  // 1. Patch origin and the 4 blend weights of the shared fractional
  //    offset, per (query, level).
  for (int i = threadIdx.x; i < nq * NL; i += THREADS) {
    const int qi = i / NL, l = i % NL;
    const float s = 1.0f / static_cast<float>(1 << l);  // exact power of 2
    const float cx = coords[(q0 + qi) * 2] * s;
    const float cy = coords[(q0 + qi) * 2 + 1] * s;
    const float fx0 = floorf(cx), fy0 = floorf(cy);
    const float fx = cx - fx0, fy = cy - fy0;
    weight[qi][l][0] = (1.0f - fx) * (1.0f - fy);
    weight[qi][l][1] = fx * (1.0f - fy);
    weight[qi][l][2] = (1.0f - fx) * fy;
    weight[qi][l][3] = fx * fy;
    // Clamp before the int conversion: beyond the margin the whole patch
    // lies outside the map and stays zero, as it would unclamped.
    const float mx = static_cast<float>(lv.w[l] + P), my = static_cast<float>(lv.h[l] + P);
    origin[qi][l][0] = static_cast<int>(fminf(fmaxf(fx0, -2.0f * P), mx)) - R;
    origin[qi][l][1] = static_cast<int>(fminf(fmaxf(fy0, -2.0f * P), my)) - R;
  }
  __syncthreads();

  // 2. Stage the 10x10 patches, zeros outside the map.
  for (int i = threadIdx.x; i < nq * NL * P * P; i += THREADS) {
    const int qi = i / (NL * P * P);
    const int rem = i % (NL * P * P);
    const int l = rem / (P * P), p = rem % (P * P);
    const int gx = origin[qi][l][0] + p % P;
    const int gy = origin[qi][l][1] + p / P;
    const int h = lv.h[l], w = lv.w[l];
    float v = 0.0f;
    if (gx >= 0 && gx < w && gy >= 0 && gy < h) {
      const T* map = static_cast<const T*>(lv.ptr[l]) +
                     (q0 + qi) * (static_cast<int64_t>(h) * w);
      v = load_f32(map + static_cast<int64_t>(gy) * w + gx);
    }
    patch[qi][l][p] = v;
  }
  __syncthreads();

  // 3. Blend: tap (a, b) reads patch cells (a..a+1, b..b+1), x along a.
  float* tile = out + q0 * (NL * TAPS);
  for (int i = threadIdx.x; i < nq * NL * TAPS; i += THREADS) {
    const int qi = i / (NL * TAPS);
    const int c = i % (NL * TAPS);
    const int l = c / TAPS, t = c % TAPS;
    const int a = t / NUM, b = t % NUM;
    const float* wt = weight[qi][l];
    const float* pp = patch[qi][l] + b * P + a;
    tile[i] = wt[0] * pp[0] + wt[1] * pp[1] + wt[2] * pp[P] + wt[3] * pp[P + 1];
  }
}

}  // namespace

// C interface (loaded with ctypes). dtype: 0 = float32 levels, 1 = bfloat16.
// levels: 4 pointers to contiguous (q, hw[2l], hw[2l+1]) maps; coords:
// contiguous (q, 2) float32; out: contiguous (q, 4*81) float32. Launches on
// `stream`; returns cudaGetLastError() (0 = success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int corr_lookup(int dtype, const float* coords,
                           const void* const* levels, const int* hw,
                           long long q, float* out, void* stream) {
  if (q < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0) return 0;
  Levels lv{};
  for (int l = 0; l < NL; ++l) {
    lv.ptr[l] = levels[l];
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
  }
  const dim3 blocks(static_cast<unsigned int>((q + QT - 1) / QT));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    corr_lookup_kernel<float><<<blocks, THREADS, 0, s>>>(coords, lv, out, q);
  } else if (dtype == 1) {
    corr_lookup_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(coords, lv, out, q);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
