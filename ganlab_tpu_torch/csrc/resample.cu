// Fused nearest-2x upsample + [1,2,1] FIR blur, NCHW, for Hopper (sm_90a).
//
// Replaces the TPU kernel ganlab_tpu/ops/pallas/resample.py
// (upsample_blur_2x_pallas -> _up_impl -> _up_kernel). The function is the
// polyphase form of blur(nearest_up(x)), per axis, with a zero halo:
//
//     out[2i]   = 0.25 x[i-1] + 0.75 x[i]
//     out[2i+1] = 0.75 x[i]   + 0.25 x[i+1]
//
// Bound: memory. It reads each input once and writes 4x as many outputs,
// about 30 flops per input pixel, i.e. a few flops per byte moved, far
// below the card's ~295 flop/byte balance point,
// so the least time is (in + out bytes) / 3.35 TB/s.
//
// Design: one thread per input pixel writes the 2x2 output quad that the
// pixel owns, from its 3x3 input neighbourhood (vertical lerps first, then
// horizontal, in float32 whatever the storage type). Neighbouring threads
// take neighbouring columns, so the 9 reads hit the same few cache lines
// across a warp and each output row pair is written as one 2-element
// vector store per thread. A later PR can tile rows through shared memory
// and widen the stores.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success. dtype 0 = float32, 1 = bfloat16.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 make(float a, float b) {
    return make_float2(a, b);
  }
};

template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ __nv_bfloat162 make(float a, float b) {
    return __floats2bfloat162_rn(a, b);  // .x = a at the lower address
  }
};

template <typename T>
__global__ void upsample_blur_2x_kernel(const T* __restrict__ x,
                                        T* __restrict__ o, int64_t total,
                                        int h, int w) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  const int j = static_cast<int>(idx % w);
  const int64_t t = idx / w;
  const int i = static_cast<int>(t % h);
  const int64_t plane = t / h;
  const T* xp = x + plane * h * w;

  float v[3][3];
#pragma unroll
  for (int di = 0; di < 3; ++di) {
    const int r = i + di - 1;
    const bool row_in = r >= 0 && r < h;
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const int c = j + dj - 1;
      v[di][dj] = (row_in && c >= 0 && c < w)
                      ? load_f32(xp + static_cast<int64_t>(r) * w + c)
                      : 0.0f;
    }
  }
  float ve[3], vo[3];
#pragma unroll
  for (int dj = 0; dj < 3; ++dj) {
    ve[dj] = 0.25f * v[0][dj] + 0.75f * v[1][dj];
    vo[dj] = 0.75f * v[1][dj] + 0.25f * v[2][dj];
  }
  using P = Pair<T>;
  const int64_t w2 = 2 * static_cast<int64_t>(w);
  T* op = o + plane * (4 * static_cast<int64_t>(h) * w) + (2 * i) * w2 + 2 * j;
  *reinterpret_cast<typename P::type*>(op) =
      P::make(0.25f * ve[0] + 0.75f * ve[1], 0.75f * ve[1] + 0.25f * ve[2]);
  *reinterpret_cast<typename P::type*>(op + w2) =
      P::make(0.25f * vo[0] + 0.75f * vo[1], 0.75f * vo[1] + 0.25f * vo[2]);
}

constexpr int kThreads = 256;

template <typename T>
int launch(const void* x, void* o, int64_t planes, int h, int w,
           cudaStream_t stream) {
  const int64_t total = planes * h * w;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  upsample_blur_2x_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(static_cast<const T*>(x),
                                         static_cast<T*>(o), total, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ganlab_upsample_blur_2x(const void* x, void* o,
                                       long long planes, int h, int w,
                                       int dtype, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, o, planes, h, w, s);
    case 1: return launch<__nv_bfloat16>(x, o, planes, h, w, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
