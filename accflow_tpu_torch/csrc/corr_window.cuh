// The correlation window lookup for Hopper (sm_90a), shared by the
// 4-level radius-4 kernel (corr_lookup.cu, kernel #1) and the per-level
// kernel of any radius and level count (corr_level_lookup.cu, kernel #2):
// both compute ops/corr.py::lookup_corr_plain.
//
// For each query q and level l < NL, the (2R+1)^2 bilinear window of q's
// own (hl, wl) correlation map around coords(q) / 2^l, align_corners,
// zeros outside the map. Output (Q, NL*(2R+1)^2) level-major, float32 or
// bfloat16 (the float32 blend rounded once to nearest even: bit for bit
// the float32 output cast, so a caller that casts at once gets the cast
// for free); channel l*(2R+1)^2 + a*(2R+1) + b samples
// (x/2^l + a - R, y/2^l + b - R), so the outer index a is the x offset.
//
// The window offsets are integers, so all taps of one (query, level) share
// one fractional offset (fx, fy): the window is a read of the (2R+2)^2
// patch at (floor(x/2^l) - R, floor(y/2^l) - R) and a 4-weight blend. The
// TPU kernels' tent-weight matmuls and block-diagonal packing existed to
// feed the MXU; they have no purpose here.
//
// Design. A block of 16 * QT threads takes QT consecutive queries and all
// NL levels (CORR_QT, default 8; `chip_smoke.py --tile-sweep` times 4, 8
// and 16), so its output is one contiguous run of QT*NL*(2R+1)^2 values:
//   1. per (query, level): the patch origin, rounded down to a 16-byte
//      chunk of its map row, the offset inside that chunk, and the 4 blend
//      weights, into shared memory;
//   2. stage each patch row as the 16-byte chunks that cover it, copied raw
//      into shared memory by cp.async, a chunk outside the map zero-filled
//      by the copy itself (source size 0). The chunk copies are split over
//      the block's threads in a loop with a compile-time trip count, so
//      each thread issues all of its copies before it waits for any, and
//      the copies cost no registers; several blocks per SM overlap one
//      block's copies with another's blend (a loop with a runtime trip
//      count and one 2-byte load per element, each stored before the next
//      was issued, kept a thread waiting out a DRAM latency per element);
//   3. blend, one window column (2R+1 consecutive outputs) per thread, from
//      the 2 x (2R+2) patch cells it reads once, into an output tile in
//      shared memory, in the output type (a thread writing straight to
//      device memory made every store instruction touch 32 sectors);
//   4. write the block's outputs as one contiguous run of 16-byte vectors
//      where QT*NL*(2R+1)^2 values are a whole number of them (every build
//      at QT = 8), else element by element.
// The chunk copies need map rows that are whole 16-byte chunks (wl*elem a
// multiple of 16) and a 16-byte aligned map: every level of the clip and
// stream paths. A level without both (an odd width, a misaligned view)
// stages the same chunk layout element by element, with the same zeros,
// and blends the same way. A chunk never straddles two map rows on the copy
// path, so a chunk is either inside the map or outside it. Radius, level
// count and QT are compile-time constants, so every index division is by a
// constant. Offsets into the levels are 64-bit (Q*hl*wl passes 2^31 at
// larger frames or batches). A zero-sized level or far-off coords read
// nothing and give zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

#ifndef CORR_QT
#define CORR_QT 8
#endif
constexpr int QT = CORR_QT;        // queries per block (1, 2, 4, 8 or 16)
constexpr int THREADS = 16 * QT;   // 128 at QT = 8

template <int NL>
struct Levels {
  const void* ptr[NL];
  int h[NL];
  int w[NL];
  int chunked[NL];  // 1: rows are whole 16-byte chunks and the map is aligned
};

// Source of the zero-filling copies (never read: source size 0).
__device__ __align__(16) unsigned char zero_src[16];

// Level l's fields, selected with constant indices: a runtime index into
// the parameter struct would copy all of it to local memory.
template <int NL>
__device__ __forceinline__ void level_fields(const Levels<NL>& lv, int l, const void*& ptr,
                                             int& h, int& w, int& chunked) {
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    if (k == l) {
      ptr = lv.ptr[k];
      h = lv.h[k];
      w = lv.w[k];
      chunked = lv.chunked[k];
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float zero_of(const float*) { return 0.0f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(const __nv_bfloat16*) {
  return __ushort_as_bfloat16(0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Shared memory of one block, in this order: the patch tile T[QT][NL][P][ROWW],
// the output tile O[QT * NL * TAPS], the blend weights float[QT][NL][4] and
// the origins int[QT][NL][3].
template <typename T, typename O, int R, int NL>
struct Smem {
  static constexpr int P = 2 * R + 2;                          // patch side
  static constexpr int TAPS = (2 * R + 1) * (2 * R + 1);
  static constexpr int VE = 16 / static_cast<int>(sizeof(T));  // values per 16-byte chunk
  static constexpr int CH = (2 * VE + P - 2) / VE;             // chunks covering a patch row
  static constexpr int ROWW = CH * VE;                         // staged values per patch row
  static constexpr size_t TILE = sizeof(T) * QT * NL * P * ROWW;
  static constexpr size_t OUT = (sizeof(O) * QT * NL * TAPS + 15) / 16 * 16;
  static constexpr size_t WEIGHT = sizeof(float) * QT * NL * 4;
  static constexpr size_t BYTES = TILE + OUT + WEIGHT + sizeof(int) * QT * NL * 3;
};

// The bounds name the thread count only: an explicit minimum of one block
// per SM let ptxas take 79 registers instead of 40, and every shape slowed.
template <typename T, typename O, int R, int NL>
__global__ void __launch_bounds__(THREADS)
corr_window_kernel(const float* __restrict__ coords, Levels<NL> lv, O* __restrict__ out,
                   int64_t q_total) {
  using S = Smem<T, O, R, NL>;
  constexpr int NUM = 2 * R + 1, P = S::P, TAPS = S::TAPS;
  constexpr int VE = S::VE, CH = S::CH, ROWW = S::ROWW;
  constexpr int JOBS = QT * NL * P * CH;  // chunk copies per block
  extern __shared__ __align__(16) unsigned char smem[];
  auto tile = reinterpret_cast<T(*)[NL][P][ROWW]>(smem);
  O* otile = reinterpret_cast<O*>(smem + S::TILE);
  auto weight = reinterpret_cast<float(*)[NL][4]>(smem + S::TILE + S::OUT);
  // x of the first chunk, y of the first row, offset inside the chunk
  auto org = reinterpret_cast<int(*)[NL][3]>(smem + S::TILE + S::OUT + S::WEIGHT);

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QT;
  const int nq = static_cast<int>(q_total - q0 < QT ? q_total - q0 : QT);

  // 1. Origins and the 4 blend weights of the shared fractional offset.
  static_assert(NL <= 16, "one thread per (query, level)");
  if (threadIdx.x < nq * NL) {
    const int qi = threadIdx.x / NL, l = threadIdx.x % NL;
    const void* ptr;
    int h, w, chunked;
    level_fields(lv, l, ptr, h, w, chunked);
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
    const float mx = static_cast<float>(w + P), my = static_cast<float>(h + P);
    const int ox = static_cast<int>(fminf(fmaxf(fx0, -2.0f * P), mx)) - R;
    const int oy = static_cast<int>(fminf(fmaxf(fy0, -2.0f * P), my)) - R;
    const int c0 = (ox >= 0 ? ox : ox - (VE - 1)) / VE;  // floor division
    org[qi][l][0] = c0 * VE;
    org[qi][l][1] = oy;
    org[qi][l][2] = ox - c0 * VE;
  }
  __syncthreads();

  // 2. Stage the chunks covering each patch row, zeros outside the map.
#pragma unroll
  for (int k = 0; k < (JOBS + THREADS - 1) / THREADS; ++k) {
    const int i = k * THREADS + static_cast<int>(threadIdx.x);
    if (i < nq * NL * P * CH) {
      const int qi = i / (NL * P * CH);
      const int rem = i % (NL * P * CH);
      const int l = rem / (P * CH);
      const int row = (rem / CH) % P, ch = rem % CH;
      const int off = org[qi][l][2];
      if (ch * VE < off + P) {  // the chunk holds part of the patch row
        const void* ptr;
        int h, w, chunked;
        level_fields(lv, l, ptr, h, w, chunked);
        const int xs = org[qi][l][0] + ch * VE, gy = org[qi][l][1] + row;
        const bool in_rows = gy >= 0 && gy < h;
        const T* map = static_cast<const T*>(ptr) +
                       ((q0 + qi) * h + (in_rows ? gy : 0)) * static_cast<int64_t>(w);
        T* dst = &tile[qi][l][row][ch * VE];
        if (chunked) {
          const bool inside = in_rows && xs >= 0 && xs < w;
          cp_async16(dst, inside ? static_cast<const void*>(map + xs) : zero_src,
                     inside ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < VE; ++e) {
            const int x = xs + e;
            dst[e] = in_rows && x >= 0 && x < w ? __ldg(map + x) : zero_of(map);
          }
        }
      }
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 3. Blend: tap (a, b) reads patch cells (a..a+1, b..b+1), x along a. A
  //    thread takes one column a of a (query, level): its 2R+1 taps b are
  //    consecutive outputs, blended from the 2 x (2R+2) patch cells it reads
  //    once, into the output tile.
  for (int i = threadIdx.x; i < nq * NL * NUM; i += THREADS) {
    const int qi = i / (NL * NUM);
    const int l = (i / NUM) % NL, a = i % NUM;
    const float w0 = weight[qi][l][0], w1 = weight[qi][l][1];
    const float w2 = weight[qi][l][2], w3 = weight[qi][l][3];
    const T* pp = &tile[qi][l][0][org[qi][l][2] + a];
    O* dst = otile + i * NUM;  // = qi * NL * TAPS + l * TAPS + a * NUM
    float x0 = to_f32(pp[0]), x1 = to_f32(pp[1]);
#pragma unroll
    for (int b = 0; b < NUM; ++b) {
      const float y0 = to_f32(pp[(b + 1) * ROWW]), y1 = to_f32(pp[(b + 1) * ROWW + 1]);
      put(dst + b, w0 * x0 + w1 * x1 + w2 * y0 + w3 * y1);
      x0 = y0;
      x1 = y1;
    }
  }
  __syncthreads();

  // 4. Write the block's nq * NL * TAPS outputs, one contiguous run, as
  //    16-byte vectors when every block's run starts 16-byte aligned, the
  //    tail of a partial last block element by element.
  const int n = nq * NL * TAPS;
  constexpr int OV = 16 / static_cast<int>(sizeof(O));
  constexpr bool VEC = (QT * NL * TAPS) % OV == 0;
  O* dst = out + q0 * (NL * TAPS);
  const int nv = VEC ? n / OV : 0;
  const uint4* src = reinterpret_cast<const uint4*>(otile);
  for (int v = threadIdx.x; v < nv; v += THREADS) reinterpret_cast<uint4*>(dst)[v] = src[v];
  for (int e = nv * OV + threadIdx.x; e < n; e += THREADS) dst[e] = otile[e];
}

template <typename T, typename O, int R, int NL>
int launch(const float* coords, const Levels<NL>& lv, long long q, void* out,
           cudaStream_t s) {
  constexpr size_t bytes = Smem<T, O, R, NL>::BYTES;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        corr_window_kernel<T, O, R, NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 blocks(static_cast<unsigned int>((q + QT - 1) / QT));
  corr_window_kernel<T, O, R, NL><<<blocks, THREADS, bytes, s>>>(
      coords, lv, static_cast<O*>(out), q);
  return static_cast<int>(cudaGetLastError());
}

// The C entries' common part: levels as NL pointers to contiguous
// (q, hw[2l], hw[2l+1]) maps of type `dtype` (0 = float32, 1 = bfloat16),
// out_dtype 0 = float32 output, 1 = bfloat16. Returns cudaGetLastError()
// (0 = success), or cudaErrorInvalidValue for arguments the kernel does not
// take.
template <int R, int NL>
int window_lookup(int dtype, int out_dtype, const float* coords, const void* const* levels,
                  const int* hw, long long q, void* out, cudaStream_t s) {
  if (q < 0 || (q + QT - 1) / QT > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if ((dtype != 0 && dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0) return 0;
  const int elem = dtype == 0 ? 4 : 2;
  Levels<NL> lv{};
  for (int l = 0; l < NL; ++l) {
    lv.ptr[l] = levels[l];
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    const bool empty = lv.h[l] == 0 || lv.w[l] == 0;
    lv.chunked[l] = empty || ((lv.w[l] * elem) % 16 == 0 &&
                              (reinterpret_cast<uintptr_t>(levels[l]) & 15) == 0);
  }
  if (dtype == 0 && out_dtype == 0) return launch<float, float, R, NL>(coords, lv, q, out, s);
  if (dtype == 0) return launch<float, __nv_bfloat16, R, NL>(coords, lv, q, out, s);
  if (out_dtype == 0) return launch<__nv_bfloat16, float, R, NL>(coords, lv, q, out, s);
  return launch<__nv_bfloat16, __nv_bfloat16, R, NL>(coords, lv, q, out, s);
}

}  // namespace
