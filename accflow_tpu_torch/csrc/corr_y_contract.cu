// Per-query y tent contraction for Hopper (sm_90a):
//   tmp[q, b, x] = sum_y wy[q, b, y] * corr[q, y, x]
// for corr (Q, hl, wl) and wy (Q, 9, hl), both float32 or both bfloat16,
// out (Q, 9, wl) float32, accumulated in float32.
//
// Replaces accflow_tpu/ops/corr_pallas.py::y_contract_bd (kernel body
// `kernel`, launched by pl.pallas_call), which the `experimental:fused_bd`
// and `fused_bd2` lookups run on pyramid levels 0 (and 1) in every GRU
// iteration. The TPU kernel packs G = 8 queries block-diagonally into one
// (G*9, G*hl) x (G*hl, wl) dot so that its matrix unit sees a full tile; it
// wastes (G-1)/G of the products on zeros. That packing is a TPU tile-size
// workaround and has no purpose here.
//
// Design. Every corr element is used by exactly the 9 products of its own
// column x, so it is read once from device memory straight into a register
// and never staged: a thread owns one (query, x) column and its 9 sums
// (b = 0..8), and loops over y with float32 FMAs. Neighbouring threads take
// neighbouring x, so each row of corr is one coalesced read and each of the
// 9 output rows one coalesced write. A block of 256 threads takes
// qb = 256 / wl queries (1 <= qb <= 32), so small levels keep the block
// full. The wy rows of the block's queries are staged in shared memory as
// float, YT = 32 values of y at a time (any hl works with the same shared
// memory), laid out [query][y][b] with an odd per-query stride so that the
// threads of one warp that read different queries hit different banks; the
// threads of one query read the same word (a broadcast).
//
// Bound (H100 SXM, 3.35 TB/s): memory. At level 0 of the clip path
// (Q = 22*64*64 = 90,112 queries, 64^2, bfloat16 in) one launch reads
// 738 MB of corr and 104 MB of wy and writes 208 MB: 1.05 GB, 0.313 ms;
// its 6.6 GFLOP are 0.1 ms even on the float32 FMA units (67 TFLOP/s).
// Loads are 2 (bf16) or 4 (f32) bytes a thread, coalesced; 16-byte vector
// loads and the tensor cores (mma.sync with M = 9 padded to 16) are left
// for later. Offsets are 64-bit (Q*hl*wl passes 2^31 at larger inputs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NUM = 9;             // window taps per axis (radius 4)
constexpr int THREADS = 256;
constexpr int YT = 32;             // y values of wy staged per step
constexpr int QB_MAX = 32;         // queries per block at most
constexpr int WS = YT * NUM + 1;   // floats per query in shared memory (odd)

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
y_contract_kernel(const T* __restrict__ corr, const T* __restrict__ wy,
                  float* __restrict__ out, int64_t q_total, int hl, int wl, int qb) {
  extern __shared__ float w_s[];  // [qb][WS]: wy[q0 + qi, b, y0 + y] at qi*WS + y*NUM + b

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
        w_s[qj * WS + y * NUM + b] =
            load_f32(wy + ((q0 + qj) * NUM + b) * static_cast<int64_t>(hl) + y0 + y);
      }
      __syncthreads();
      if (active) {
        const float* ws = w_s + qi * WS;
#pragma unroll 8
        for (int y = 0; y < ny; ++y) {
          const float c = load_f32(col + static_cast<int64_t>(y0 + y) * wl);
#pragma unroll
          for (int b = 0; b < NUM; ++b) acc[b] = fmaf(ws[y * NUM + b], c, acc[b]);
        }
      }
    }
    if (active) {
      float* dst = out + (q0 + qi) * static_cast<int64_t>(NUM) * wl + x;
#pragma unroll
      for (int b = 0; b < NUM; ++b) dst[static_cast<int64_t>(b) * wl] = acc[b];
    }
  }
}

}  // namespace

// C interface (loaded with ctypes). dtype: 0 = float32 operands, 1 =
// bfloat16. corr: contiguous (q, hl, wl); wy: contiguous (q, 9, hl); out:
// contiguous (q, 9, wl) float32. Launches on `stream`; returns
// cudaGetLastError() (0 = success), or cudaErrorInvalidValue for arguments
// the kernel does not take.
extern "C" int corr_y_contract(int dtype, const void* corr, const void* wy, long long q,
                               int hl, int wl, float* out, void* stream) {
  if (q < 0 || hl < 0 || wl < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0 || wl == 0) return 0;
  int qb = THREADS / wl;
  qb = qb < 1 ? 1 : (qb > QB_MAX ? QB_MAX : qb);
  const long long blocks = (q + qb - 1) / qb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(qb) * WS * sizeof(float);  // <= 37 KB
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(blocks));
  if (dtype == 0) {
    y_contract_kernel<float><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(corr), static_cast<const float*>(wy), out, q, hl, wl, qb);
  } else if (dtype == 1) {
    y_contract_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(corr), static_cast<const __nv_bfloat16*>(wy), out,
        q, hl, wl, qb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
