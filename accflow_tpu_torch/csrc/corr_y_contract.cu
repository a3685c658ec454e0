// Per-query y tent contraction for Hopper (sm_90a):
//   tmp[q, b, x] = sum_y wy[q, b, y] * corr[q, y, x]
// for corr (Q, hl, wl) and wy (Q, NUM, hl), both float32 or both bfloat16,
// accumulated in float32; out (Q, NUM, wl) float32, or bfloat16 rounded once
// from the float32 sums (round to nearest even): bit for bit the float32
// output cast, so a caller that casts at once gets the cast for free.
//
// Replaces accflow_tpu/ops/corr_pallas.py::y_contract_bd (kernel body
// `kernel`, launched by pl.pallas_call), which the `experimental:fused_bd`
// and `fused_bd2` lookups run on pyramid levels 0 (and 1) in every GRU
// iteration. The TPU kernel packs G = 8 queries block-diagonally into one
// (G*9, G*hl) x (G*hl, wl) dot so that its matrix unit sees a full tile; it
// wastes (G-1)/G of the products on zeros. That packing is a TPU tile-size
// workaround and has no purpose here.
//
// Bound (H100 SXM, 3.35 TB/s): memory. At level 0 of the clip path
// (Q = 22*64*64 = 90,112 queries, 64^2, bfloat16 in) one launch reads
// 738 MB of corr and 104 MB of wy and writes 208 MB of float32 (0.313 ms)
// or 104 MB of bfloat16 (946 MB in all, 0.282 ms). Its 6.6 GFLOP take
// 0.1 ms on the float32 FMA units (67 TFLOP/s), under the loads.
//
// What held the first version back: one thread per (query, x) column with
// one 2-byte load per map row kept about 16 KB in flight per SM, half of
// what Little's law asks at this card's latency and rate (51 % of the bound
// on an H100 80GB HBM3 at 700 W). 16-byte bfloat16 loads into registers were
// not enough either: the 72 float32 FMAs per vector of 8 values, about 0.1
// ms of the FMA pipes' time at this shape, held such a launch at 64 % of the
// bound (same card). So bfloat16 maps go to the tensor cores.
//
// Design (MMA path: bfloat16 maps 8, 16, 32 or 64 wide, levels 0 and 1 of
// the clip path). One warp per query, 4 per block. The warp copies 64 map
// rows and their wy columns into shared memory with cp.async (16-byte
// copies, all issued before the first wait, about 9 KB per warp at level 0;
// no registers hold them), then multiplies them on the tensor cores:
// out (9 taps padded to 16 rows, wl) += wy (16, 16 y) x corr (16 y, wl) per
// m16n8k16 mma.sync, products exact and sums float32, a 16-row tile of
// accumulators per 8 map columns. Map rows past hl are zeros (the copies'
// source size 0, or stores), taps 9-15 zero registers. A staged row is
// padded by 16 B, so the four rows of a B fragment and the eight of an A
// fragment fall in different banks; 4 warps take 42 KB, so 5 blocks (20
// warps) fit on an SM.
//
// Narrow path, for every other shape (float32 maps, which the bfloat16 GRU
// loop never runs; bfloat16 maps of other widths; a misaligned pointer):
// one thread per (query, x) column with 9 float32 sums and one element load
// per row, the tent rows in shared memory 32 y at a time, 256 / wl queries
// per block (1-32): the first version, at 79 % of the bound with float32
// maps at level 0 (same card). The host picks the path from the dtype, the
// width and the pointer (corr_y_contract_path).
// Offsets are 64-bit (Q*hl*wl passes 2^31 at larger inputs).
//
// NUM, the window's taps per axis (2R+1), is compiled in: 9 (radius 4) by
// default, any other with -DCORR_NUM=n (ops/corr_bd_cuda.py builds one
// library per radius a config asks for; JAX's fused_bd takes any radius).
// The MMA path pads the NUM taps to 16 rows (tap t in row t), so it takes
// NUM <= 16; the narrow path takes any NUM, with its queries per block
// capped so that their staged tent rows fit 48 KB of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

#ifndef CORR_NUM
#define CORR_NUM 9
#endif
constexpr int NUM = CORR_NUM;      // window taps per axis (2 x radius + 1)
static_assert(NUM >= 1, "at least one tap");
constexpr int THREADS = 256;

// MMA path.
constexpr int MW = 4;              // warps (one query each) per block
constexpr int YK = 64;             // map rows staged per warp at a time
constexpr int WYS = YK + 8;        // bfloat16 values per staged wy row (144 B)

// Narrow path.
constexpr int YT = 32;             // y values of wy staged per step
constexpr int QB_MAX = 32;         // queries per block at most
constexpr int WS = YT * NUM + 1;   // floats per query in shared memory (odd)

// Source of the zero-filling copies (never read: source size 0).
__device__ __align__(16) unsigned char zero_src[16];

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// d += a b for one m16n8k16 tile: bfloat16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// p[0], p[1] = a, b (p 4-byte aligned for bfloat16, 8-byte for float32).
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One warp per query: out (NUM taps padded to 16, wl) = wy (16, hl) x
// corr (hl, wl) on the tensor cores, NT tiles of 8 columns, 16 rows of the
// map per step. Both operands pass through shared memory, copied by
// cp.async 64 map rows at a time: a map row padded by 16 B (so the 4 rows a
// B fragment reads fall in different banks), zeros past hl; the A rows of
// taps NUM-15 are zero registers.
template <typename O, int NT>
__global__ void __launch_bounds__(MW * 32)
y_contract_mma_kernel(const __nv_bfloat16* __restrict__ corr,
                      const __nv_bfloat16* __restrict__ wy, O* __restrict__ out,
                      int64_t q_total, int hl, int wy_vec) {
  constexpr int WL = NT * 8;   // map width
  constexpr int RS = WL + 8;   // bfloat16 values per staged map row
  constexpr int VPR = WL / 8;  // 16-byte vectors per map row
  __shared__ __align__(16) unsigned short c_s[MW][YK * RS];
  __shared__ __align__(16) unsigned short w_s[MW][NUM * WYS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * MW + warp;
  if (q >= q_total) return;  // whole warps leave; only __syncwarp below
  const int g = lane >> 2, t = lane & 3;  // the fragments' row group and pair
  unsigned short* cs = c_s[warp];
  unsigned short* ws = w_s[warp];
  const __nv_bfloat16* map = corr + q * hl * WL;
  const __nv_bfloat16* wq = wy + q * NUM * hl;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int y0 = 0; y0 < hl; y0 += YK) {
    const int ny = hl - y0 < YK ? hl - y0 : YK;
    const int nk = (ny + 15) & ~15;  // rows rounded up to whole k-steps
    __syncwarp();  // the warp is done with the previous rows
    for (int i = lane; i < nk * VPR; i += 32) {
      const int r = i / VPR, v = i % VPR;
      const bool in = r < ny;
      cp_async16(cs + r * RS + v * 8,
                 in ? static_cast<const void*>(map + static_cast<int64_t>(y0 + r) * WL + v * 8)
                    : zero_src,
                 in ? 16 : 0);
    }
    if (wy_vec) {  // hl % 8 == 0 and wy 16-byte aligned: whole vectors
      const int vr = nk / 8;
      for (int i = lane; i < NUM * vr; i += 32) {
        const int b = i / vr, v = i % vr;
        const bool in = v * 8 < ny;
        cp_async16(ws + b * WYS + v * 8,
                   in ? static_cast<const void*>(wq + static_cast<int64_t>(b) * hl + y0 + v * 8)
                      : zero_src,
                   in ? 16 : 0);
      }
    } else {
      for (int i = lane; i < NUM * nk; i += 32) {
        const int b = i / nk, y = i % nk;
        ws[b * WYS + y] =
            y < ny ? __bfloat16_as_ushort(wq[static_cast<int64_t>(b) * hl + y0 + y]) : 0;
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    for (int k0 = 0; k0 < nk; k0 += 16) {
      uint32_t a[4] = {0u, 0u, 0u, 0u};  // A rows g and g + 8: taps g, g + 8, or padding
      if (g < NUM) {
        a[0] = *reinterpret_cast<const uint32_t*>(ws + g * WYS + k0 + 2 * t);
        a[2] = *reinterpret_cast<const uint32_t*>(ws + g * WYS + k0 + 2 * t + 8);
      }
      if (g + 8 < NUM) {
        a[1] = *reinterpret_cast<const uint32_t*>(ws + (g + 8) * WYS + k0 + 2 * t);
        a[3] = *reinterpret_cast<const uint32_t*>(ws + (g + 8) * WYS + k0 + 2 * t + 8);
      }
      const unsigned short* c0 = cs + (k0 + 2 * t) * RS + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const unsigned short* c = c0 + n * 8;  // B rows k0+2t, +1, +8, +9 of column g
        const uint32_t b0 = c[0] | (static_cast<uint32_t>(c[RS]) << 16);
        const uint32_t b1 = c[8 * RS] | (static_cast<uint32_t>(c[9 * RS]) << 16);
        mma_bf16(acc[n], a, b0, b1);
      }
    }
  }

  // D rows are taps: g holds (c0, c1), g + 8 (c2, c3), each where the tap
  // exists (NUM = 9: every g, and g + 8 for g = 0); columns n*8 + 2t, +1.
  O* dst = out + q * (NUM * WL) + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (g < NUM) put2(dst + g * WL + n * 8, acc[n][0], acc[n][1]);
    if (g + 8 < NUM) put2(dst + (g + 8) * WL + n * 8, acc[n][2], acc[n][3]);
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
y_contract_narrow_kernel(const T* __restrict__ corr, const T* __restrict__ wy,
                         O* __restrict__ out, int64_t q_total, int hl, int wl, int qb) {
  extern __shared__ float w_n[];  // [qb][WS]: wy[q0 + qi, b, y0 + y] at qi*WS + y*NUM + b

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * qb;
  const int nq = static_cast<int>(q_total - q0 < qb ? q_total - q0 : qb);
  const int items = nq * wl;                             // (query, x) columns
  const int passes = (qb * wl + THREADS - 1) / THREADS;  // the same in every block

  for (int pass = 0; pass < passes; ++pass) {
    const int item = pass * THREADS + threadIdx.x;
    const bool active = item < items;
    const int qi = active ? item / wl : 0;
    const int x = active ? item % wl : 0;
    const T* col = corr + (q0 + qi) * static_cast<int64_t>(hl) * wl + x;
    float acc[NUM];
#pragma unroll
    for (int b = 0; b < NUM; ++b) acc[b] = 0.0f;

    for (int y0 = 0; y0 < hl; y0 += YT) {
      const int ny = hl - y0 < YT ? hl - y0 : YT;
      __syncthreads();  // every thread is done with the previous step's rows
      for (int i = threadIdx.x; i < nq * NUM * ny; i += THREADS) {
        const int qj = i / (NUM * ny), r = i % (NUM * ny);
        const int b = r / ny, y = r % ny;
        w_n[qj * WS + y * NUM + b] =
            load_f32(wy + ((q0 + qj) * NUM + b) * static_cast<int64_t>(hl) + y0 + y);
      }
      __syncthreads();
      if (active) {
        const float* ws = w_n + qi * WS;
#pragma unroll 8
        for (int y = 0; y < ny; ++y) {
          const float c = load_f32(col + static_cast<int64_t>(y0 + y) * wl);
#pragma unroll
          for (int b = 0; b < NUM; ++b) acc[b] = fmaf(ws[y * NUM + b], c, acc[b]);
        }
      }
    }
    if (active) {
      O* dst = out + (q0 + qi) * static_cast<int64_t>(NUM) * wl + x;
#pragma unroll
      for (int b = 0; b < NUM; ++b) put(dst + static_cast<int64_t>(b) * wl, acc[b]);
    }
  }
}

// Column tiles of the MMA path for this shape (bfloat16 maps 8, 16, 32 or
// 64 wide at a 16-byte aligned address, NUM <= 16), or 0.
int mma_tiles(int dtype, const void* corr, int wl) {
  if (NUM > 16 || dtype != 1 || (reinterpret_cast<uintptr_t>(corr) & 15) != 0) return 0;
  return wl == 8 || wl == 16 || wl == 32 || wl == 64 ? wl / 8 : 0;
}

template <typename O>
int launch_mma(int nt, const void* corr, const void* wy, long long q, int hl, void* out,
               cudaStream_t s) {
  const long long blocks = (q + MW - 1) / MW;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int wy_vec = hl % 8 == 0 && (reinterpret_cast<uintptr_t>(wy) & 15) == 0;
  const dim3 grid(static_cast<unsigned int>(blocks));
  const __nv_bfloat16* c = static_cast<const __nv_bfloat16*>(corr);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wy);
  O* o = static_cast<O*>(out);
  switch (nt) {
    case 1: y_contract_mma_kernel<O, 1><<<grid, MW * 32, 0, s>>>(c, w, o, q, hl, wy_vec); break;
    case 2: y_contract_mma_kernel<O, 2><<<grid, MW * 32, 0, s>>>(c, w, o, q, hl, wy_vec); break;
    case 4: y_contract_mma_kernel<O, 4><<<grid, MW * 32, 0, s>>>(c, w, o, q, hl, wy_vec); break;
    case 8: y_contract_mma_kernel<O, 8><<<grid, MW * 32, 0, s>>>(c, w, o, q, hl, wy_vec); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int launch_narrow(const void* corr, const void* wy, long long q, int hl, int wl, void* out,
                  cudaStream_t s) {
  constexpr int QB_FIT = 48 * 1024 / (WS * static_cast<int>(sizeof(float)));  // 42 at NUM = 9
  constexpr int QB_CAP = QB_MAX < QB_FIT ? QB_MAX : QB_FIT;
  static_assert(QB_CAP >= 1, "one query's tent rows outgrow 48 KB of shared memory");
  int qb = THREADS / wl;
  qb = qb < 1 ? 1 : (qb > QB_CAP ? QB_CAP : qb);
  const long long blocks = (q + qb - 1) / qb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(qb) * WS * sizeof(float);  // <= 48 KB
  y_contract_narrow_kernel<T, O><<<dim3(static_cast<unsigned int>(blocks)), THREADS, smem, s>>>(
      static_cast<const T*>(corr), static_cast<const T*>(wy), static_cast<O*>(out), q, hl, wl,
      qb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int launch(const void* corr, const void* wy, long long q, int hl, int wl, void* out,
           cudaStream_t s, int dtype) {
  if constexpr (sizeof(T) == 2) {
    const int nt = mma_tiles(dtype, corr, wl);
    if (nt > 0) return launch_mma<O>(nt, corr, wy, q, hl, out, s);
  }
  return launch_narrow<T, O>(corr, wy, q, hl, wl, out, s);
}

}  // namespace

// The taps per axis this library was built for.
extern "C" int corr_y_contract_num() { return NUM; }

// The path that takes maps of width wl (float32 when dtype is 0, bfloat16
// when 1) at the address corr: 1 MMA, 0 narrow.
extern "C" int corr_y_contract_path(int dtype, const void* corr, int wl) {
  return mma_tiles(dtype, corr, wl) > 0 ? 1 : 0;
}

// C interface (loaded with ctypes). dtype: 0 = float32 operands, 1 =
// bfloat16; out_dtype: 0 = float32 output, 1 = bfloat16. corr: contiguous
// (q, hl, wl); wy: contiguous (q, NUM, hl); out: contiguous (q, NUM, wl).
// Launches on `stream`; returns cudaGetLastError() (0 = success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int corr_y_contract(int dtype, int out_dtype, const void* corr, const void* wy,
                               long long q, int hl, int wl, void* out, void* stream) {
  if (q < 0 || hl < 0 || wl < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0 || wl == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0) return launch<float, float>(corr, wy, q, hl, wl, out, s, dtype);
  if (dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(corr, wy, q, hl, wl, out, s, dtype);
  if (dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(corr, wy, q, hl, wl, out, s, dtype);
  if (dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(corr, wy, q, hl, wl, out, s, dtype);
  return static_cast<int>(cudaErrorInvalidValue);
}
