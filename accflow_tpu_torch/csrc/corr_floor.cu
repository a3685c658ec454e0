// Passthrough of the lookup's operands for Hopper (sm_90a): the memory floor
// of kernel #1 (corr_lookup.cu).
//
// Replaces scripts/probe_pallas_floor.py (its kernel `make(tq, nlev)`,
// launched by pl.pallas_call at :64), the TPU probe that streamed the fused
// lookup's blocks through a kernel doing no lookup at all, to find the DMA
// and grid floor under kernel #1. Here: for each query q, the sum of every
// value of its 4 correlation maps (Q, hl, wl) plus 0 * coords(q, 0), written
// to all 324 columns of out(q, :), float32. It reads each level and the
// coords once, in full, and writes (Q, 324) once: what kernel #1 could never
// need to exceed, so its time is a floor measured on the card for the bytes
// of kernel #1's operands (kernel #1 itself reads only the 10x10 patches).
//
// Design: one warp per query, 8 queries per 256-thread block. A query's map
// on each level is one contiguous run; lanes read it as 16-byte vectors
// where the run is 16-byte aligned and a whole number of vectors (every
// level of the clip path: 64^2 .. 8^2 maps), else element by element. The
// warp's partial sums meet by shuffles; its lanes write the 324 columns,
// coalesced.
//
// Bound (H100 SXM, 3.35 TB/s): memory. At the clip path's shape (Q = 90,112,
// levels 64^2 .. 8^2 bfloat16) it reads 980 MB of levels and 0.7 MB of
// coords and writes 117 MB: 1.10 GB, 0.328 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NL = 4;
constexpr int OUT_COLS = 324;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Levels {
  const void* ptr[NL];
  int64_t elems[NL];  // hl * wl
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float vec_sum(const uint4& v, const float*) {
  return __uint_as_float(v.x) + __uint_as_float(v.y) + __uint_as_float(v.z) +
         __uint_as_float(v.w);
}
__device__ __forceinline__ float vec_sum(const uint4& v, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    s += f.x + f.y;
  }
  return s;
}

template <typename T>
__device__ float run_sum(const T* p, int64_t n, int lane) {
  constexpr int VEC = 16 / sizeof(T);
  float s = 0.0f;
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0 && n % VEC == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
    const int64_t nv = n / VEC;
#pragma unroll 4
    for (int64_t i = lane; i < nv; i += 32) s += vec_sum(__ldg(v + i), p);
  } else {
    for (int64_t i = lane; i < n; i += 32) s += load_f32(p + i);
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
floor_kernel(const float* __restrict__ coords, Levels lv, float* __restrict__ out,
             int64_t q_total) {
  const int lane = threadIdx.x & 31;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (q >= q_total) return;  // whole warps leave together
  float s = 0.0f;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const T* map = static_cast<const T*>(lv.ptr[l]) + q * lv.elems[l];
    s += run_sum(map, lv.elems[l], lane);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  s += 0.0f * coords[q * 2];
  float* dst = out + q * OUT_COLS;
  for (int c = lane; c < OUT_COLS; c += 32) dst[c] = s;
}

}  // namespace

// C interface (loaded with ctypes). dtype: 0 = float32 levels, 1 = bfloat16.
// levels: 4 pointers to contiguous (q, hw[2l], hw[2l+1]) maps; coords:
// contiguous (q, 2) float32; out: contiguous (q, 324) float32. Launches on
// `stream`; returns cudaGetLastError() (0 = success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int corr_floor(int dtype, const float* coords, const void* const* levels,
                          const int* hw, long long q, float* out, void* stream) {
  if (q < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0) return 0;
  Levels lv{};
  for (int l = 0; l < NL; ++l) {
    lv.ptr[l] = levels[l];
    lv.elems[l] = static_cast<int64_t>(hw[2 * l]) * hw[2 * l + 1];
  }
  const dim3 blocks(static_cast<unsigned int>((q + WARPS - 1) / WARPS));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    floor_kernel<float><<<blocks, THREADS, 0, s>>>(coords, lv, out, q);
  } else if (dtype == 1) {
    floor_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(coords, lv, out, q);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
