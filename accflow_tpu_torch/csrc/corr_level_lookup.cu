// Per-level correlation window lookup for Hopper (sm_90a), radius 3 or 4.
//
// Replaces accflow_tpu/ops/corr_pallas.py::lookup_corr_pallas (the TPU
// per-level kernel: body `_level_kernel`, launcher `_lookup_level`, one
// launch per level). For each query q and level l, the (2R+1)^2 bilinear
// window of q's own (hl, wl) correlation map around coords(q) / 2^l,
// align_corners, zeros outside the map. Output (Q, 4*(2R+1)^2) float32,
// level-major; channel l*(2R+1)^2 + a*(2R+1) + b samples
// (x/2^l + a - R, y/2^l + b - R), so the outer index a is the x offset.
// RAFT-small (radius 3) runs it in every GRU iteration.
//
// Design. The TPU kernel builds tent weights and runs two small dots per
// query, one query per loop step: a shape for the MXU. Here the window
// offsets are integers, so all taps of one (query, level) share one
// fractional offset (fx, fy): the window is a read of the (2R+2)^2 patch at
// (floor(x/2^l) - R, floor(y/2^l) - R) and a 4-weight blend. A block takes
// QT consecutive queries of ONE level (grid.y = level), so every level goes
// in one launch, and writes that level's columns at offset l*(2R+1)^2 of the
// output rows: no concatenation afterwards.
//   1. per query: patch origin and the 4 blend weights;
//   2. stage the patches in shared memory as float, zeros outside the map
//      (a zero-sized level or far-off coords read nothing);
//   3. blend, one output per thread; each query's (2R+1)^2 outputs are one
//      contiguous run of the output row.
// The radius is a template parameter (3 and 4 instantiated), so every index
// division is by a constant; the level count is RAFT's 4, as in
// corr_lookup.cu, unless the build sets another with -DCORR_LEVELS=n (the
// one-level probe of chip_smoke.py, which stands in for the TPU probes of a
// single level's lookup, scripts/probe_pallas_fused.py).
//
// Bound (H100 SXM, 3.35 TB/s): memory. At the stream's shape (2 pairs x
// batch 2 at 512^2: Q = 16,384, radius 3, levels 64^2 .. 8^2, bf16) one
// launch writes Q*196*4 B = 12.8 MB and reads at most Q*4*64*2 B = 8.4 MB
// of patches: ~6 us, so launch and tail latency set its time there. About
// 10 FLOPs per output, far below the compute roofline. Offsets into the
// levels are 64-bit (Q*hl*wl passes 2^31 at larger frames or batches).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

#ifndef CORR_LEVELS
#define CORR_LEVELS 4
#endif
constexpr int LEVELS = CORR_LEVELS;
constexpr int QT = 16;  // queries per block
constexpr int THREADS = 256;

struct Levels {
  const void* ptr[LEVELS];
  int h[LEVELS];
  int w[LEVELS];
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
level_lookup_kernel(const float* __restrict__ coords, Levels lv,
                    float* __restrict__ out, int64_t q_total) {
  constexpr int NUM = 2 * R + 1;   // taps per axis
  constexpr int P = NUM + 1;       // patch side
  constexpr int TAPS = NUM * NUM;
  __shared__ float patch[QT][P * P];
  __shared__ int origin[QT][2];
  __shared__ float weight[QT][4];

  // The level's fields, selected with constant indices: a runtime index
  // into the parameter struct would copy all of it to local memory.
  const int l = blockIdx.y;
  const void* level = nullptr;
  int h = 0, w = 0;
#pragma unroll
  for (int k = 0; k < LEVELS; ++k) {
    if (k == l) {
      level = lv.ptr[k];
      h = lv.h[k];
      w = lv.w[k];
    }
  }
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QT;
  const int nq = static_cast<int>(q_total - q0 < QT ? q_total - q0 : QT);

  // 1. Patch origin and the 4 blend weights of the shared fractional offset.
  if (threadIdx.x < nq) {
    const int qi = threadIdx.x;
    const float s = 1.0f / static_cast<float>(1 << l);  // exact power of 2
    const float cx = coords[(q0 + qi) * 2] * s;
    const float cy = coords[(q0 + qi) * 2 + 1] * s;
    const float fx0 = floorf(cx), fy0 = floorf(cy);
    const float fx = cx - fx0, fy = cy - fy0;
    weight[qi][0] = (1.0f - fx) * (1.0f - fy);
    weight[qi][1] = fx * (1.0f - fy);
    weight[qi][2] = (1.0f - fx) * fy;
    weight[qi][3] = fx * fy;
    // Clamp before the int conversion: beyond the margin the whole patch
    // lies outside the map and stays zero, as it would unclamped.
    const float mx = static_cast<float>(w + P), my = static_cast<float>(h + P);
    origin[qi][0] = static_cast<int>(fminf(fmaxf(fx0, -2.0f * P), mx)) - R;
    origin[qi][1] = static_cast<int>(fminf(fmaxf(fy0, -2.0f * P), my)) - R;
  }
  __syncthreads();

  // 2. Stage the patches, zeros outside the map.
  const T* map = static_cast<const T*>(level);
  const int64_t map_elems = static_cast<int64_t>(h) * w;
  for (int i = threadIdx.x; i < nq * P * P; i += THREADS) {
    const int qi = i / (P * P), p = i % (P * P);
    const int gx = origin[qi][0] + p % P;
    const int gy = origin[qi][1] + p / P;
    float v = 0.0f;
    if (gx >= 0 && gx < w && gy >= 0 && gy < h) {
      v = load_f32(map + (q0 + qi) * map_elems + static_cast<int64_t>(gy) * w + gx);
    }
    patch[qi][p] = v;
  }
  __syncthreads();

  // 3. Blend: tap (a, b) reads patch cells (a..a+1, b..b+1), x along a.
  constexpr int row = LEVELS * TAPS;
  float* dst = out + q0 * row + l * TAPS;
  for (int i = threadIdx.x; i < nq * TAPS; i += THREADS) {
    const int qi = i / TAPS, t = i % TAPS;
    const int a = t / NUM, b = t % NUM;
    const float* wt = weight[qi];
    const float* pp = patch[qi] + b * P + a;
    dst[qi * row + t] = wt[0] * pp[0] + wt[1] * pp[1] + wt[2] * pp[P] + wt[3] * pp[P + 1];
  }
}

template <typename T>
int launch_radius(int radius, dim3 grid, cudaStream_t s, const float* coords,
                  const Levels& lv, float* out, long long q) {
  if (radius == 3) {
    level_lookup_kernel<T, 3><<<grid, THREADS, 0, s>>>(coords, lv, out, q);
  } else if (radius == 4) {
    level_lookup_kernel<T, 4><<<grid, THREADS, 0, s>>>(coords, lv, out, q);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The level count this library was built for.
extern "C" int corr_level_lookup_levels() { return LEVELS; }

// C interface (loaded with ctypes). dtype: 0 = float32 levels, 1 = bfloat16.
// levels: LEVELS pointers to contiguous (q, hw[2l], hw[2l+1]) maps; coords:
// contiguous (q, 2) float32; out: contiguous (q, LEVELS*(2*radius+1)^2)
// float32.
// Launches on `stream`; returns cudaGetLastError() (0 = success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int corr_level_lookup(int dtype, int radius, const float* coords,
                                 const void* const* levels, const int* hw,
                                 long long q, float* out, void* stream) {
  if (q < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0) return 0;
  Levels lv{};
  for (int l = 0; l < LEVELS; ++l) {
    lv.ptr[l] = levels[l];
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
  }
  const dim3 grid(static_cast<unsigned int>((q + QT - 1) / QT),
                  static_cast<unsigned int>(LEVELS));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_radius<float>(radius, grid, s, coords, lv, out, q);
  if (dtype == 1) return launch_radius<__nv_bfloat16>(radius, grid, s, coords, lv, out, q);
  return static_cast<int>(cudaErrorInvalidValue);
}
