// The two resampling kernels of StyleGAN, NCHW, for Hopper (sm_90a):
// nearest-2x upsample + [1,2,1] blur, and [1,2,1] blur + 2x downsample
// (further below). Each is the other's adjoint up to a factor 4.
//
// Fused nearest-2x upsample + [1,2,1] FIR blur.
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

// Fused [1,2,1] blur + 2x2 average pool (replaces blur_downsample_2x_pallas
// -> _down_impl -> _down_kernel). Per axis, with a zero halo
// (x[-1] = x[2H] = 0):
//
//     out[i] = 0.125 x[2i-1] + 0.375 x[2i] + 0.375 x[2i+1] + 0.125 x[2i+2]
//
// Bound: memory. It reads each input once and writes a quarter as many
// outputs, ~21 flops per output, so the least time is (in + out bytes) /
// 3.35 TB/s. Design: one thread per output pixel reads its 4x4 input
// window (vertical taps per column first, then the horizontal taps, in
// float32, the order of the plain version). Neighbouring threads take
// neighbouring output columns, so a warp's reads of one input row span 66
// contiguous elements and its writes are one contiguous run. A later PR
// can stage row tiles in shared memory and vectorize.
__device__ __forceinline__ float tap4(int k) {
  return (k == 0 || k == 3) ? 0.125f : 0.375f;
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void blur_downsample_2x_kernel(const T* __restrict__ x,
                                          T* __restrict__ o, int64_t total,
                                          int ho, int wo) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  const int j = static_cast<int>(idx % wo);
  const int64_t t = idx / wo;
  const int i = static_cast<int>(t % ho);
  const int64_t plane = t / ho;
  const int h = 2 * ho, w = 2 * wo;
  const T* xp = x + plane * h * static_cast<int64_t>(w);

  float col[4];
#pragma unroll
  for (int dc = 0; dc < 4; ++dc) col[dc] = 0.0f;
#pragma unroll
  for (int dr = 0; dr < 4; ++dr) {
    const int r = 2 * i - 1 + dr;
    if (r < 0 || r >= h) continue;
    const T* row = xp + static_cast<int64_t>(r) * w;
#pragma unroll
    for (int dc = 0; dc < 4; ++dc) {
      const int c = 2 * j - 1 + dc;
      const float v = (c >= 0 && c < w) ? load_f32(row + c) : 0.0f;
      col[dc] += tap4(dr) * v;
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int dc = 0; dc < 4; ++dc) acc += tap4(dc) * col[dc];
  store_f32(o + idx, acc);
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

template <typename T>
int launch_down(const void* x, void* o, int64_t planes, int ho, int wo,
                cudaStream_t stream) {
  const int64_t total = planes * ho * wo;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  blur_downsample_2x_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(static_cast<const T*>(x),
                                           static_cast<T*>(o), total, ho, wo);
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

// x (planes, 2*ho, 2*wo) -> o (planes, ho, wo).
extern "C" int ganlab_blur_downsample_2x(const void* x, void* o,
                                         long long planes, int ho, int wo,
                                         int dtype, void* stream) {
  if (planes <= 0 || ho <= 0 || wo <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_down<float>(x, o, planes, ho, wo, s);
    case 1: return launch_down<__nv_bfloat16>(x, o, planes, ho, wo, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
