// The correlation window lookup's backward for Hopper (sm_90a): the
// gradient of corr_window.cuh's lookup with respect to its levels, for the
// 4-level radius-4 lookup (kernel #1) and the per-level one of any radius
// and level count (kernel #2). It computes
// ops/corr.py::lookup_corr_plain_backward.
//
// It replaces no TPU kernel: the TPU kernels have no backward
// (accflow_tpu/ops/corr_pallas.py:71-73), and JAX fine-tunes through the
// XLA "fused" lookup (accflow_tpu/ops/corr.py:997-1036), whose gradient
// with respect to the pyramid levels XLA's autodiff derives. This is that
// gradient. The coordinates get none: JAX stops it at the top of every GRU
// iteration (accflow_tpu/models/raft.py:573).
//
// Each query q owns its own (hl, wl) map per level, and its window reads
// only the (2R+2)^2 patch at (floor(x/2^l) - R, floor(y/2^l) - R) with one
// shared fractional offset (fx, fy), as the forward computes them (the same
// clamp of far-off origins). So the gradient of q's map gets contributions
// from q's own window only: patch element (i = y - oy, j = x - ox) gets
//   (1-fx)(1-fy) g[j][i] + fx(1-fy) g[j-1][i] + (1-fx)fy g[j][i-1] + fx fy g[j-1][i-1]
// where g[a][b] is the window gradient at channel a*(2R+1) + b (the outer
// index a is the x offset) and 0 outside the window; elements outside the
// map drop (zeros padding), and every other element of the map is 0. The
// backward is a gather with no atomics: deterministic, one writer per
// element. Each element's sum is v = 0, then the four terms in that order,
// each where its condition holds, as one FMA chain, rounded once to the
// levels' type.
//
// Bound (H100 SXM, 3.35 TB/s): memory, the dense gradient written once. At
// the fine-tune shape (Q = 6*32*32 = 6,144, maps 32^2 .. 4^2, float32
// levels) that is Q * 1,360 * 4 B = 33.4 MB, plus 4.0 MB of bfloat16
// window gradient read: 0.011 ms. Most of it is zeros: at most (2R+2)^2 of
// a level's hl*wl elements are not.
//
// Design. One warp per query, 8 warps a block, on a persistent grid of
// (SMs x resident blocks) whose warps walk the queries by a grid stride;
// no __syncthreads, each warp syncs only itself:
//   1. while a warp writes query q's maps, cp.async copies its next
//      query's window gradient, raw, into the other of its two
//      shared-memory slots (dynamic shared memory, sized by the row), and
//      its coords load into registers. The pieces are 4 values where a
//      query's row of NL*(2R+1)^2 values is a multiple of 4 (16 bytes of
//      float32, 8 of bfloat16: a bfloat16 row of 648 or 392 B is only 8-byte
//      aligned), else 2 or 1 (an odd level count makes the row odd); a
//      piece under 4 bytes (one bfloat16 value) has no cp.async, so such a
//      row is loaded into registers before the warp writes q's maps and
//      stored into the slot after;
//   2. the levels are a compile-time loop, so each level's pointer, shape
//      and patch origin are selected with constant indices (a runtime index
//      into the parameter struct copies it to local memory) and there is no
//      per-element level search;
//   3. a level whose map rows are whole 16-byte vectors (and whose maps are
//      16-byte aligned) is written as 16-byte stores, 4 float32 or 8
//      bfloat16 elements a lane, neighbouring lanes on neighbouring vectors;
//      any other level element by element. The choice is per level, the
//      same for the whole warp. A lane steps its vectors' (row, column) by
//      increments, from two divisions per level by a float reciprocal;
//   4. a vector wholly outside the patch stores zeros without reading
//      shared memory; one inside it reads the V + 1 window columns of its
//      two window rows once and blends all V elements from them (row_sums).
//      Instructions are what bound the time beside the stores: with each
//      element's 4 conditional reads, the 1-3 lanes of a warp's store that
//      held patch elements made all 32 wait through them (PERF.md, Findings).

#pragma once

#include "corr_window.cuh"

namespace {

constexpr int BWD_WARPS = 8;  // queries in flight per block, one warp each
constexpr int BWD_THREADS = 32 * BWD_WARPS;

template <int NL>
struct Grads {
  void* ptr[NL];
  int h[NL];
  int w[NL];
  int vec[NL];  // 1: map rows are whole 16-byte vectors, the maps 16-byte aligned
};

// cp.async of BYTES (16: cached in L2 only; 8: through L1, the only way
// for pieces under 16 bytes), and its group commit and wait.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte vector from 4 float32 or 8 bfloat16 sums, each rounded as put()
// rounds it; the element at the lower address in the lower bits.
__device__ __forceinline__ uint4 pack(const float (&v)[4], const float*) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}
__device__ __forceinline__ uint4 pack(const float (&v)[8], const __nv_bfloat16*) {
  return make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]), bf16_pair(v[4], v[5]),
                    bf16_pair(v[6], v[7]));
}

// Level L's patch origin (ox, oy) and blend weights for coords (cx, cy):
// the forward's, operation for operation.
template <int R, int L>
__device__ __forceinline__ void patch_origin(float cx, float cy, int h, int w, int& ox, int& oy,
                                             float (&wt)[4]) {
  constexpr int P = 2 * R + 2;
  const float s = 1.0f / static_cast<float>(1 << L);
  const float lx = cx * s, ly = cy * s;
  const float fx0 = floorf(lx), fy0 = floorf(ly);
  const float fx = lx - fx0, fy = ly - fy0;
  wt[0] = (1.0f - fx) * (1.0f - fy);
  wt[1] = fx * (1.0f - fy);
  wt[2] = (1.0f - fx) * fy;
  wt[3] = fx * fy;
  // Clamped before the int conversion: beyond the margin the whole patch
  // lies outside the map, as it would unclamped.
  const float mx = static_cast<float>(w + P), my = static_cast<float>(h + P);
  ox = static_cast<int>(fminf(fmaxf(fx0, -2.0f * P), mx)) - R;
  oy = static_cast<int>(fminf(fmaxf(fy0, -2.0f * P), my)) - R;
}

// a / b for 0 <= a < 2^16 and b >= 1, from rb = 1/b rounded: (a + 1/2) / b
// lies at least 1/(2b) from an integer, far beyond the two roundings' error.
__device__ __forceinline__ int small_div(int a, float rb) {
  return static_cast<int>((static_cast<float>(a) + 0.5f) * rb);
}

// V consecutive elements of patch row i (0 <= i < 2R+2), columns j .. j+V-1
// (any j: columns outside the patch give 0). Element (i, c) takes its
// window's terms in this order, each where its condition holds:
//   w0 g[c][i] (c < NUM, i < NUM), w1 g[c-1][i] (c >= 1, i < NUM),
//   w2 g[c][i-1] (c < NUM, i >= 1), w3 g[c-1][i-1] (c >= 1, i >= 1),
// as an FMA chain from v = 0. Here every element takes all four terms,
// with 0 for a term whose window value does not exist: the chain never
// holds -0 (it starts at +0, and a sum is -0 only if both addends are), so
// adding w * 0 (w is finite and >= 0 for a patch on the map) leaves its
// value as it was, bit for bit. So the V + 1 columns of rows i and i - 1
// are read once for all V elements.
template <int R, int V, typename G>
__device__ __forceinline__ void row_sums(int i, int j, const float (&wt)[4], const G* gl,
                                         float (&val)[V]) {
  constexpr int NUM = 2 * R + 1;
  const bool top = i < NUM, bottom = i >= 1;
  float t[V + 1], b[V + 1];  // window rows i and i - 1, columns j - 1 .. j + V - 1
#pragma unroll
  for (int m = 0; m <= V; ++m) {
    const int c = j - 1 + m;
    const bool in = c >= 0 && c < NUM;
    t[m] = in && top ? to_f32(gl[c * NUM + i]) : 0.0f;
    b[m] = in && bottom ? to_f32(gl[c * NUM + i - 1]) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float v = __fmaf_rn(wt[0], t[k + 1], 0.0f);
    v = __fmaf_rn(wt[1], t[k], v);
    v = __fmaf_rn(wt[2], b[k + 1], v);
    val[k] = __fmaf_rn(wt[3], b[k], v);
  }
}

// One query's (h, w) map `out` of level L, V elements a lane per store (V =
// 16 / sizeof(T): 16-byte vectors, whole ones in each row; V = 1: element by
// element), from its window gradient gl (raw, in shared memory).
template <typename T, typename G, int R, int L, int V>
__device__ __forceinline__ void write_map(T* __restrict__ out, int h, int w, float cx, float cy,
                                          const G* gl, int lane) {
  constexpr int P = 2 * R + 2;
  if (h == 0 || w == 0) return;
  int ox, oy;
  float wt[4];
  patch_origin<R, L>(cx, cy, h, w, ox, oy, wt);
  // Vector v is row y = v / vr, columns x .. x + V - 1 with x = (v % vr) * V.
  // A lane starts at vector `lane` and steps 32 vectors: dy rows, dx vectors.
  const int vr = w / V;
  const float rvr = __frcp_rn(static_cast<float>(vr));
  int y = small_div(lane, rvr), vx = lane - y * vr;
  const int dy = small_div(32, rvr), dx = 32 - dy * vr;
  const int nv = h * vr;
  for (int v = lane; v < nv; v += 32) {
    const int i = y - oy, j = vx * V - ox;
    float val[V];
    if (i >= 0 && i < P && j + V > 0 && j < P) {
      row_sums<R, V>(i, j, wt, gl, val);
    } else {  // wholly outside the patch: zeros, no shared memory read
#pragma unroll
      for (int k = 0; k < V; ++k) val[k] = 0.0f;
    }
    if constexpr (V == 1)
      put(out + v, val[0]);
    else
      reinterpret_cast<uint4*>(out)[v] = pack(val, out);
    vx += dx;
    y += dy;
    if (vx >= vr) {
      vx -= vr;
      ++y;
    }
  }
}

// Levels L .. NL-1 of query q.
template <typename T, typename G, int R, int NL, int L = 0>
__device__ __forceinline__ void write_levels(const Grads<NL>& gv, int64_t q, float cx, float cy,
                                             const G* g, int lane) {
  if constexpr (L < NL) {
    constexpr int TAPS = (2 * R + 1) * (2 * R + 1);
    constexpr int VE = 16 / static_cast<int>(sizeof(T));
    const int h = gv.h[L], w = gv.w[L];
    T* out = static_cast<T*>(gv.ptr[L]) + q * h * static_cast<int64_t>(w);
    if (gv.vec[L])
      write_map<T, G, R, L, VE>(out, h, w, cx, cy, g + L * TAPS, lane);
    else
      write_map<T, G, R, L, 1>(out, h, w, cx, cy, g + L * TAPS, lane);
    write_levels<T, G, R, NL, L + 1>(gv, q, cx, cy, g, lane);
  }
}

// How a query's window gradient (NL*(2R+1)^2 values of G) is copied: PV
// values per piece, by cp.async where a piece is 4 bytes or more.
template <typename G, int R, int NL>
struct RowCopy {
  static constexpr int ROW = NL * (2 * R + 1) * (2 * R + 1);  // values per query
  static constexpr int PV = ROW % 4 == 0 ? 4 : (ROW % 2 == 0 ? 2 : 1);
  static constexpr int BYTES = PV * static_cast<int>(sizeof(G));  // bytes per piece
  static constexpr bool ASYNC = BYTES >= 4;
  static constexpr int STAGE = ASYNC ? 1 : (ROW + 31) / 32;  // register-staged values a lane
  static constexpr size_t SMEM = sizeof(G) * BWD_WARPS * 2 * ROW;  // two slots a warp
};

template <typename T, typename G, int R, int NL>
__global__ void __launch_bounds__(BWD_THREADS)
corr_window_backward_kernel(const float* __restrict__ coords, const G* __restrict__ grad_out,
                            Grads<NL> gv, int64_t q_total) {
  using C = RowCopy<G, R, NL>;
  constexpr int ROW = C::ROW, CP = C::BYTES;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int warp = static_cast<int>(threadIdx.x) / 32, lane = static_cast<int>(threadIdx.x) % 32;
  G* slots = reinterpret_cast<G*>(bwd_smem) + warp * 2 * ROW;  // this warp's two slots
  const int64_t stride = static_cast<int64_t>(gridDim.x) * BWD_WARPS;
  int64_t q = static_cast<int64_t>(blockIdx.x) * BWD_WARPS + warp;
  if (q >= q_total) return;

  // Copies query qq's window gradient into slot b, as one group.
  auto fetch = [&](int64_t qq, int b) {
    const char* src = reinterpret_cast<const char*>(grad_out + qq * ROW);
    char* dst = reinterpret_cast<char*>(slots + b * ROW);
    for (int p = lane; p < ROW / C::PV; p += 32) cp_async<CP>(dst + p * CP, src + p * CP);
    cp_async_commit();
  };
  // The register-staged copy (one bfloat16 value a piece): load, then store.
  G stage[C::STAGE];
  auto load_row = [&](int64_t qq) {
#pragma unroll
    for (int k = 0; k < C::STAGE; ++k) {
      const int p = lane + 32 * k;
      if (p < ROW) stage[k] = grad_out[qq * ROW + p];
    }
  };
  auto store_row = [&](int b) {
#pragma unroll
    for (int k = 0; k < C::STAGE; ++k) {
      const int p = lane + 32 * k;
      if (p < ROW) slots[b * ROW + p] = stage[k];
    }
  };
  float cx = coords[q * 2], cy = coords[q * 2 + 1];
  if constexpr (C::ASYNC) {
    fetch(q, 0);
  } else {
    load_row(q);
    store_row(0);
  }
  for (int b = 0;; b ^= 1) {
    const int64_t next = q + stride;
    float nx = 0.0f, ny = 0.0f;
    if (next < q_total) {
      nx = coords[next * 2];
      ny = coords[next * 2 + 1];
      if constexpr (C::ASYNC) {
        fetch(next, b ^ 1);
        cp_async_wait<1>();  // this lane's copies of q are done, next's in flight
      } else {
        load_row(next);  // in registers while the warp writes q's maps
      }
    } else if constexpr (C::ASYNC) {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies of q are visible to the warp
    write_levels<T, G, R, NL>(gv, q, cx, cy, slots + b * ROW, lane);
    if (next >= q_total) break;
    if constexpr (!C::ASYNC) store_row(b ^ 1);
    __syncwarp();  // slot b is read out before the copy after next refills it
    q = next;
    cx = nx;
    cy = ny;
  }
}

// Blocks of one launch: as many as the card holds at once, fewer when the
// queries do not fill them. The SM count and the kernel's resident blocks
// per SM are asked once per device.
template <typename T, typename G, int R, int NL>
int launch_backward(const float* coords, const void* grad_out, const Grads<NL>& gv, long long q,
                    cudaStream_t s) {
  constexpr int DEVICES = 64;
  static int resident[DEVICES];  // SMs x blocks per SM; 0 = not asked yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  constexpr size_t smem = RowCopy<G, R, NL>::SMEM;
  static_assert(smem <= 227 * 1024, "two window-gradient rows a warp outgrow shared memory");
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(corr_window_backward_kernel<T, G, R, NL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, corr_window_backward_kernel<T, G, R, NL>, BWD_THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (q + BWD_WARPS - 1) / BWD_WARPS;
  const unsigned int blocks = static_cast<unsigned int>(need < resident[dev] ? need : resident[dev]);
  corr_window_backward_kernel<T, G, R, NL><<<blocks, BWD_THREADS, smem, s>>>(
      coords, static_cast<const G*>(grad_out), gv, q);
  return static_cast<int>(cudaGetLastError());
}

// The C entries' common part: grads as NL pointers to contiguous (q,
// hw[2l], hw[2l+1]) outputs of type `dtype` (the levels': 0 = float32, 1 =
// bfloat16), grad_out a contiguous (q, NL*(2R+1)^2) window gradient of type
// grad_dtype (0 = float32, 1 = bfloat16) whose address is a multiple of 4
// values (16 bytes float32, 8 bfloat16; the copies need the piece's
// alignment, RowCopy::BYTES, at most that), coords contiguous (q, 2) float32.
// Returns cudaGetLastError() (0 = success), or cudaErrorInvalidValue for
// arguments the kernel does not take.
template <int R, int NL>
int window_backward(int dtype, int grad_dtype, const float* coords, const void* grad_out,
                    void* const* grads, const int* hw, long long q, cudaStream_t s) {
  if (q < 0 || q > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if ((dtype != 0 && dtype != 1) || (grad_dtype != 0 && grad_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(grad_out) % (grad_dtype == 0 ? 16 : 8) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == 0 ? 4 : 2;
  Grads<NL> gv{};
  for (int l = 0; l < NL; ++l) {
    gv.ptr[l] = grads[l];
    gv.h[l] = hw[2 * l];
    gv.w[l] = hw[2 * l + 1];
    if (gv.h[l] < 0 || gv.w[l] < 0) return static_cast<int>(cudaErrorInvalidValue);
    gv.vec[l] = (gv.w[l] * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(grads[l]) % 16 == 0;
  }
  if (q == 0) return 0;
  if (dtype == 0 && grad_dtype == 0) return launch_backward<float, float, R, NL>(coords, grad_out, gv, q, s);
  if (dtype == 0) return launch_backward<float, __nv_bfloat16, R, NL>(coords, grad_out, gv, q, s);
  if (grad_dtype == 0) return launch_backward<__nv_bfloat16, float, R, NL>(coords, grad_out, gv, q, s);
  return launch_backward<__nv_bfloat16, __nv_bfloat16, R, NL>(coords, grad_out, gv, q, s);
}

}  // namespace
