// cvor_core: the native data-path core of the CVOR pipeline, the port's own
// copy of accflow_tpu/native/src/cvor_core.cpp (the same C ABI, version 1),
// with the entry points the port calls: the uint16->float32 flow decode
// ((v - 2^15)/128, data/dataset.py:65-67) over a thread pool, writing
// straight into a caller-owned buffer, and the ABI version. (JAX's copy
// also gathers cropped records and normalises images; no port code calls
// those.) Exposed through a C ABI for ctypes.
//
// Build: accflow_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC, at
// first use, into accflow_tpu_torch/_build/).

#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr float kFlowOffset = 32768.0f;
constexpr float kFlowScale = 1.0f / 128.0f;

// Run fn(i) for i in [0, n) over `threads` std::threads (or inline).
template <typename F>
void parallel_for(int64_t n, int threads, F&& fn) {
  if (threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  std::int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back([lo, hi, &fn] {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Decode uint16-encoded flow to float32: (v - 2^15) / 128.
void cvor_decode_flow_u16(const uint16_t* src, float* dst, int64_t n,
                          int threads) {
  constexpr int64_t kBlock = 1 << 16;
  int64_t blocks = (n + kBlock - 1) / kBlock;
  parallel_for(blocks, threads, [&](int64_t b) {
    int64_t lo = b * kBlock;
    int64_t hi = lo + kBlock < n ? lo + kBlock : n;
    for (int64_t i = lo; i < hi; ++i) {
      dst[i] = (static_cast<float>(src[i]) - kFlowOffset) * kFlowScale;
    }
  });
}

int cvor_abi_version() { return 1; }

}  // extern "C"
