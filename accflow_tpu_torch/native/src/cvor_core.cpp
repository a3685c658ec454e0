// cvor_core: the native data-path core of the CVOR pipeline, the port's own
// copy of accflow_tpu/native/src/cvor_core.cpp (the same C ABI, version 1):
// the uint16->float32 flow decode ((v - 2^15)/128, data/dataset.py:65-67),
// the uint8 image normalisation (2*(x/255)-1), and the cropped gather of a
// batch of records from a column (N, H, W, C), plain or with the flow
// decode fused, over a thread pool, writing straight into caller-owned
// buffers; and the ABI version. Exposed through a C ABI for ctypes.
//
// Build: accflow_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC, at
// first use, into accflow_tpu_torch/_build/).

#include <cstdint>
#include <cstring>
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

// Normalize uint8 images to [-1, 1]: 2*(x/255) - 1.
void cvor_normalize_u8(const uint8_t* src, float* dst, int64_t n,
                       int threads) {
  constexpr int64_t kBlock = 1 << 16;
  int64_t blocks = (n + kBlock - 1) / kBlock;
  parallel_for(blocks, threads, [&](int64_t b) {
    int64_t lo = b * kBlock;
    int64_t hi = lo + kBlock < n ? lo + kBlock : n;
    for (int64_t i = lo; i < hi; ++i) {
      // x/255 rounded once, then the exact doubling and the subtraction:
      // the bits of numpy's 2*(x/255)-1 in float32.
      dst[i] = static_cast<float>(src[i]) / 255.0f * 2.0f - 1.0f;
    }
  });
}

// Gather a cropped batch from a CVOR column.
//   base:       column base pointer (num_records x H x W x C, elem_size B)
//   indices:    [batch] record indices
//   y0/x0:      [batch] per-sample crop origins
//   H, W, C:    stored record spatial dims / channels
//   ch, cw:     crop size
//   out:        [batch x ch x cw x C] contiguous output
// Rows are memcpy'd (C is the fastest axis), batch x rows parallelized.
void cvor_gather_crop(const void* base, const int64_t* indices,
                      const int32_t* y0, const int32_t* x0, int64_t batch,
                      int64_t H, int64_t W, int64_t C, int64_t ch, int64_t cw,
                      int64_t elem_size, void* out, int threads) {
  const auto* src = static_cast<const uint8_t*>(base);
  auto* dst = static_cast<uint8_t*>(out);
  const int64_t rec_stride = H * W * C * elem_size;
  const int64_t row_stride = W * C * elem_size;
  const int64_t crop_row = cw * C * elem_size;
  const int64_t out_rec = ch * crop_row;

  parallel_for(batch * ch, threads, [&](int64_t job) {
    const int64_t b = job / ch;
    const int64_t r = job % ch;
    const uint8_t* rec = src + indices[b] * rec_stride;
    const uint8_t* row =
        rec + (y0[b] + r) * row_stride + x0[b] * C * elem_size;
    std::memcpy(dst + b * out_rec + r * crop_row, row, crop_row);
  });
}

// Fused: gather cropped uint16 flow records and decode to float32.
void cvor_gather_crop_decode_flow(const uint16_t* base,
                                  const int64_t* indices, const int32_t* y0,
                                  const int32_t* x0, int64_t batch, int64_t H,
                                  int64_t W, int64_t C, int64_t ch, int64_t cw,
                                  float* out, int threads) {
  const int64_t rec_stride = H * W * C;
  const int64_t row_stride = W * C;
  const int64_t crop_row = cw * C;
  const int64_t out_rec = ch * crop_row;

  parallel_for(batch * ch, threads, [&](int64_t job) {
    const int64_t b = job / ch;
    const int64_t r = job % ch;
    const uint16_t* row =
        base + indices[b] * rec_stride + (y0[b] + r) * row_stride + x0[b] * C;
    float* drow = out + b * out_rec + r * crop_row;
    for (int64_t i = 0; i < crop_row; ++i) {
      drow[i] = (static_cast<float>(row[i]) - kFlowOffset) * kFlowScale;
    }
  });
}

int cvor_abi_version() { return 1; }

}  // extern "C"
