// Native data-path kernels for the training input pipeline (host code).
//
// The port's own copy of ganlab_tpu/data/_native/gather.cpp, unchanged below
// this comment. The host-side hot loop is "gather B random images out of a
// (possibly memory-mapped) uint8 array and optionally box-downsample them
// for the current progressive phase"; numpy fancy-indexing does this
// single-threaded with an extra materialization. These kernels do it with a
// thread pool and a fused gather+downsample, so a 1024^2 feed keeps up with
// the device step.
//
// Exposed with C linkage and driven via ctypes (data/native.py builds it
// with g++ at first use).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Round-half-up mean of a f*f block, matching pipeline.box_downsample.
inline uint8_t block_mean(const uint8_t* src, int64_t row_stride, int f,
                          int c_stride) {
  int32_t acc = 0;
  for (int dy = 0; dy < f; ++dy) {
    const uint8_t* row = src + dy * row_stride;
    for (int dx = 0; dx < f; ++dx) {
      acc += row[dx * c_stride];
    }
  }
  // mean + 0.5, truncated — identical to float mean then +0.5 cast for
  // values representable exactly (sums of uint8 are exact in int32).
  float mean = static_cast<float>(acc) / static_cast<float>(f * f);
  return static_cast<uint8_t>(mean + 0.5f);
}

void worker_gather(const uint8_t* src, int64_t img_bytes, const int64_t* idx,
                   uint8_t* out, int64_t b_begin, int64_t b_end) {
  for (int64_t b = b_begin; b < b_end; ++b) {
    std::memcpy(out + b * img_bytes, src + idx[b] * img_bytes,
                static_cast<size_t>(img_bytes));
  }
}

void worker_gather_down(const uint8_t* src, int64_t h, int64_t w, int64_t c,
                        int factor, const int64_t* idx, uint8_t* out,
                        int64_t b_begin, int64_t b_end) {
  const int64_t oh = h / factor, ow = w / factor;
  const int64_t img_bytes = h * w * c;
  const int64_t out_bytes = oh * ow * c;
  const int64_t row_stride = w * c;
  for (int64_t b = b_begin; b < b_end; ++b) {
    const uint8_t* img = src + idx[b] * img_bytes;
    uint8_t* dst = out + b * out_bytes;
    for (int64_t oy = 0; oy < oh; ++oy) {
      for (int64_t ox = 0; ox < ow; ++ox) {
        const uint8_t* block =
            img + (oy * factor) * row_stride + (ox * factor) * c;
        uint8_t* px = dst + (oy * ow + ox) * c;
        for (int64_t ch = 0; ch < c; ++ch) {
          px[ch] = block_mean(block + ch, row_stride, factor,
                              static_cast<int>(c));
        }
      }
    }
  }
}

int64_t n_threads_for(int64_t batch) {
  int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 4;
  int64_t n = hw < batch ? hw : batch;
  return n > 0 ? n : 1;
}

template <typename Fn>
void parallel_over_batch(int64_t batch, Fn&& fn) {
  const int64_t nt = n_threads_for(batch);
  if (nt <= 1) {
    fn(0, batch);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(nt));
  const int64_t chunk = (batch + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < batch ? lo + chunk : batch;
    if (lo >= hi) break;
    threads.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// out[b] = src[idx[b]] for b in [0, batch); images are (h*w*c) uint8.
void ganlab_gather_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c,
                      const int64_t* idx, int64_t batch, uint8_t* out) {
  const int64_t img_bytes = h * w * c;
  parallel_over_batch(batch, [&](int64_t lo, int64_t hi) {
    worker_gather(src, img_bytes, idx, out, lo, hi);
  });
}

// out[b] = box_downsample(src[idx[b]], factor); out images are
// (h/factor * w/factor * c) uint8.
void ganlab_gather_down_u8(const uint8_t* src, int64_t h, int64_t w,
                           int64_t c, int factor, const int64_t* idx,
                           int64_t batch, uint8_t* out) {
  parallel_over_batch(batch, [&](int64_t lo, int64_t hi) {
    worker_gather_down(src, h, w, c, factor, idx, out, lo, hi);
  });
}

}  // extern "C"
