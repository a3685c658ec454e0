// Backward of the correlation window lookups for Hopper (sm_90a): the
// gradient of kernel #1 (corr_lookup.cu: 4 levels, radius 4) and of kernel
// #2 (corr_level_lookup.cu) with respect to the pyramid levels. The kernel
// is corr_window_backward.cuh's, whose header says what it computes, what
// it stands for in JAX (XLA's autodiff of the "fused" lookup; the TPU
// kernels have none), how it works and what bounds it; this file is its C
// entries, one library.
//
// Builds, as kernel #2's: the default build has kernel #1's entry and
// kernel #2's at radius 3 or 4 over 4 levels; a build with
// -DCORR_RADIUS=r (and -DCORR_LEVELS=n, default 4) has kernel #2's entry
// alone, at that radius and level count (ops/corr_backward_cuda.py builds
// one per (radius, levels) a config trains at).

#include "corr_window_backward.cuh"

#ifndef CORR_LEVELS
#define CORR_LEVELS 4
#endif

// C interface (loaded with ctypes). dtype: the levels' type, which the
// gradients take (0 = float32, 1 = bfloat16); grad_dtype: the window
// gradient's (0 = float32, 1 = bfloat16). coords: contiguous (q, 2)
// float32; grad_out: contiguous (q, L*(2*radius+1)^2) at an address that
// is a multiple of 4 values (16 bytes float32, 8 bfloat16); grads: L
// pointers to contiguous (q, hw[2l], hw[2l+1]) outputs, every element
// written. Launches on `stream`; returns cudaGetLastError() (0 = success),
// or cudaErrorInvalidValue for arguments the kernel does not take.
#ifndef CORR_RADIUS
extern "C" int corr_lookup_backward(int dtype, int grad_dtype, const float* coords,
                                    const void* grad_out, void* const* grads, const int* hw,
                                    long long q, void* stream) {
  return window_backward<4, 4>(dtype, grad_dtype, coords, grad_out, grads, hw, q,
                               static_cast<cudaStream_t>(stream));
}
#endif

// The level count and the radius (0: 3 and 4) of kernel #2's entry.
extern "C" int corr_level_lookup_backward_levels() { return CORR_LEVELS; }
extern "C" int corr_level_lookup_backward_radius() {
#ifdef CORR_RADIUS
  return CORR_RADIUS;
#else
  return 0;
#endif
}

extern "C" int corr_level_lookup_backward(int dtype, int grad_dtype, int radius,
                                          const float* coords, const void* grad_out,
                                          void* const* grads, const int* hw, long long q,
                                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef CORR_RADIUS
  if (radius == CORR_RADIUS)
    return window_backward<CORR_RADIUS, CORR_LEVELS>(dtype, grad_dtype, coords, grad_out, grads,
                                                     hw, q, s);
#else
  if (radius == 3)
    return window_backward<3, CORR_LEVELS>(dtype, grad_dtype, coords, grad_out, grads, hw, q, s);
  if (radius == 4)
    return window_backward<4, CORR_LEVELS>(dtype, grad_dtype, coords, grad_out, grads, hw, q, s);
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}
