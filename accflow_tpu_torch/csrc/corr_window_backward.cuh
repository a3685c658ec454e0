// The correlation window lookup's backward for Hopper (sm_90a): the
// gradient of corr_window.cuh's lookup with respect to its levels, for the
// 4-level radius-4 lookup (kernel #1) and the per-level one of radius 3 or
// 4 (kernel #2). It computes ops/corr.py::lookup_corr_plain_backward.
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
// element.
//
// Design (simple first). One block of 128 threads per query: the query's
// window gradient (NL*(2R+1)^2 values, float32 or bfloat16) into shared
// memory as float32, its NL patch origins and blend weights beside it;
// then the threads walk the query's dense output, all levels' maps in turn
// as one index range, so neighbouring threads write neighbouring elements
// of one map (coalesced), each element its 4-term sum in float32 rounded
// once to the levels' type. Bound (H100 SXM, 3.35 TB/s): memory, the dense
// gradient written once. At the fine-tune shape (Q = 6*32*32 = 6,144,
// maps 32^2 .. 4^2, float32 levels) that is Q * 1,360 * 4 B = 33.4 MB,
// plus 4.0 MB of bfloat16 window gradient read: 0.011 ms.

#pragma once

#include "corr_window.cuh"

namespace {

constexpr int BWD_THREADS = 128;

template <int NL>
struct Grads {
  void* ptr[NL];
  int h[NL];
  int w[NL];
};

template <typename T, typename G, int R, int NL>
__global__ void __launch_bounds__(BWD_THREADS)
corr_window_backward_kernel(const float* __restrict__ coords, const G* __restrict__ grad_out,
                            Grads<NL> gv) {
  constexpr int NUM = 2 * R + 1, P = 2 * R + 2, TAPS = NUM * NUM;
  __shared__ float g[NL * TAPS];
  __shared__ float weight[NL][4];
  __shared__ int org[NL][2];  // patch origin (x, y)
  const int64_t q = blockIdx.x;

  for (int i = threadIdx.x; i < NL * TAPS; i += BWD_THREADS)
    g[i] = to_f32(grad_out[q * (NL * TAPS) + i]);
  if (threadIdx.x < NL) {
    const int l = threadIdx.x;
    int h = 0, w = 0;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      if (k == l) {
        h = gv.h[k];
        w = gv.w[k];
      }
    }
    // The forward's origin and weights, operation for operation.
    const float s = 1.0f / static_cast<float>(1 << l);
    const float cx = coords[q * 2] * s, cy = coords[q * 2 + 1] * s;
    const float fx0 = floorf(cx), fy0 = floorf(cy);
    const float fx = cx - fx0, fy = cy - fy0;
    weight[l][0] = (1.0f - fx) * (1.0f - fy);
    weight[l][1] = fx * (1.0f - fy);
    weight[l][2] = (1.0f - fx) * fy;
    weight[l][3] = fx * fy;
    const float mx = static_cast<float>(w + P), my = static_cast<float>(h + P);
    org[l][0] = static_cast<int>(fminf(fmaxf(fx0, -2.0f * P), mx)) - R;
    org[l][1] = static_cast<int>(fminf(fmaxf(fy0, -2.0f * P), my)) - R;
  }
  __syncthreads();

  // The query's maps, level after level, as one index range [0, start[NL]).
  int start[NL + 1];
  start[0] = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) start[k + 1] = start[k] + gv.h[k] * gv.w[k];

  for (int e = threadIdx.x; e < start[NL]; e += BWD_THREADS) {
    int l = 0;
#pragma unroll
    for (int k = 1; k < NL; ++k) l += e >= start[k];  // empty levels are skipped
    void* ptr = nullptr;
    int w = 1, s0 = 0, n = 0;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      if (k == l) {
        ptr = gv.ptr[k];
        w = gv.w[k];
        s0 = start[k];
        n = start[k + 1] - start[k];
      }
    }
    const int r = e - s0, y = r / w, x = r - y * w;
    const int i = y - org[l][1], j = x - org[l][0];
    float v = 0.0f;
    if (i >= 0 && i < P && j >= 0 && j < P) {
      const float* gl = g + l * TAPS;
      if (j < NUM && i < NUM) v += weight[l][0] * gl[j * NUM + i];
      if (j >= 1 && i < NUM) v += weight[l][1] * gl[(j - 1) * NUM + i];
      if (j < NUM && i >= 1) v += weight[l][2] * gl[j * NUM + i - 1];
      if (j >= 1 && i >= 1) v += weight[l][3] * gl[(j - 1) * NUM + i - 1];
    }
    put(static_cast<T*>(ptr) + q * static_cast<int64_t>(n) + r, v);
  }
}

template <typename T, typename G, int R, int NL>
int launch_backward(const float* coords, const void* grad_out, const Grads<NL>& gv, long long q,
                    cudaStream_t s) {
  corr_window_backward_kernel<T, G, R, NL><<<static_cast<unsigned int>(q), BWD_THREADS, 0, s>>>(
      coords, static_cast<const G*>(grad_out), gv);
  return static_cast<int>(cudaGetLastError());
}

// The C entries' common part: grads as NL pointers to contiguous (q,
// hw[2l], hw[2l+1]) outputs of type `dtype` (the levels': 0 = float32, 1 =
// bfloat16), grad_out a contiguous (q, NL*(2R+1)^2) window gradient of type
// grad_dtype (0 = float32, 1 = bfloat16), coords contiguous (q, 2) float32.
// Returns cudaGetLastError() (0 = success), or cudaErrorInvalidValue for
// arguments the kernel does not take.
template <int R, int NL>
int window_backward(int dtype, int grad_dtype, const float* coords, const void* grad_out,
                    void* const* grads, const int* hw, long long q, cudaStream_t s) {
  if (q < 0 || q > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if ((dtype != 0 && dtype != 1) || (grad_dtype != 0 && grad_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Grads<NL> gv{};
  for (int l = 0; l < NL; ++l) {
    gv.ptr[l] = grads[l];
    gv.h[l] = hw[2 * l];
    gv.w[l] = hw[2 * l + 1];
    if (gv.h[l] < 0 || gv.w[l] < 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (q == 0) return 0;
  if (dtype == 0 && grad_dtype == 0) return launch_backward<float, float, R, NL>(coords, grad_out, gv, q, s);
  if (dtype == 0) return launch_backward<float, __nv_bfloat16, R, NL>(coords, grad_out, gv, q, s);
  if (grad_dtype == 0) return launch_backward<__nv_bfloat16, float, R, NL>(coords, grad_out, gv, q, s);
  return launch_backward<__nv_bfloat16, __nv_bfloat16, R, NL>(coords, grad_out, gv, q, s);
}

}  // namespace
