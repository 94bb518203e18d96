// PixelNorm over the last axis of (rows, C) for Hopper (sm_90a):
//
//     out = x * rsqrt(mean(x^2, last axis) + eps)
//
// float32 arithmetic, output in x's storage type (float32, bfloat16,
// float16). Replaces the TPU kernel ganlab_tpu/ops/pallas/pixelnorm.py
// (pixel_norm_pallas -> _rows_call -> _fwd_kernel).
//
// Bound: memory, one read and one write of (rows, C) at about 3 flops per
// element. At the shapes StyleGAN gives it (the mapping network's z, a few
// dozen rows of 512) that is tens of kilobytes: the card needs a
// microsecond or two, and what a caller waits for is the host's time to
// make the launch. So the design is as much the wrapper's as the
// kernel's: a plain C entry point called through ctypes with nothing to
// specialise or look up per call.
//
// Design: one warp per row, kWarps rows per block, no shared memory and no
// __syncthreads. Where C * itemsize is a multiple of 16 and both pointers
// are 16-byte aligned, each lane loads 16 bytes at a time (4 float32, 8
// bf16/f16), lane l taking vectors l, l + 32, ...; all of a lane's loads
// are started before the first use. For C <= 2048 the row stays in
// registers between the sum of squares and the scaled store (one pass
// over memory); above that the row is read a second time, from L1/L2. The
// sum of squares is reduced across the warp by __shfl_xor_sync. Every
// other (C, pointer) takes the same kernel with one element per load.
//
// C interface (loaded with ctypes): launches on `stream` of `device` and
// returns cudaGetLastError() after the launch, 0 on success. dtype 0 =
// float32, 1 = bfloat16, 2 = float16.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kWarps = 4;          // rows per block
constexpr int kCachedC = 2048;     // widest row kept in registers

// Chunk<T, N>: N elements of T moved as one load/store, and their float32
// values. N is 16 / sizeof(T) (a uint4) or 1 (one element).
template <typename T, int N>
struct Chunk;

template <>
struct Chunk<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ uint32_t pack2(__nv_bfloat162 p) {
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t pack2(__half2 p) {
  return *reinterpret_cast<uint32_t*>(&p);
}

template <>
struct Chunk<__nv_bfloat16, 8> {
  using Raw = uint4;
  // a bf16 is the upper half of a float32; element 0 sits in the low bits
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_uint4(pack2(__floats2bfloat162_rn(f[0], f[1])),
                      pack2(__floats2bfloat162_rn(f[2], f[3])),
                      pack2(__floats2bfloat162_rn(f[4], f[5])),
                      pack2(__floats2bfloat162_rn(f[6], f[7])));
  }
};

template <>
struct Chunk<__half, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return make_uint4(pack2(__floats2half2_rn(f[0], f[1])),
                      pack2(__floats2half2_rn(f[2], f[3])),
                      pack2(__floats2half2_rn(f[4], f[5])),
                      pack2(__floats2half2_rn(f[6], f[7])));
  }
};

template <>
struct Chunk<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = r;
  }
  static __device__ __forceinline__ Raw pack(const float* f) { return f[0]; }
};

template <>
struct Chunk<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = __bfloat162float(r);
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return __float2bfloat16_rn(f[0]);
  }
};

template <>
struct Chunk<__half, 1> {
  using Raw = __half;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = __half2float(r);
  }
  static __device__ __forceinline__ Raw pack(const float* f) {
    return __float2half_rn(f[0]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// One warp per row of n chunks (n * N == C). CACHED: n <= 32 * K, the row
// is held in K chunks per lane between the two phases.
template <typename T, int N, bool CACHED>
__global__ void __launch_bounds__(32 * kWarps)
pixel_norm_kernel(const T* __restrict__ x, T* __restrict__ o, long long rows,
                  int n, float c, float eps) {
  using Ch = Chunk<T, N>;
  using Raw = typename Ch::Raw;
  constexpr int K = CACHED ? kCachedC / (32 * N) : 1;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const Raw* xr = reinterpret_cast<const Raw*>(x) + row * n;
  Raw* orow = reinterpret_cast<Raw*>(o) + row * n;

  float ss = 0.0f;
  float f[N];
  if constexpr (CACHED) {
    Raw v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + 32 * k;
      if (i < n) v[k] = xr[i];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (lane + 32 * k < n) {
        Ch::unpack(v[k], f);
#pragma unroll
        for (int e = 0; e < N; ++e) ss += f[e] * f[e];
      }
    }
    const float scale = rsqrtf(warp_sum(ss) / c + eps);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lane + 32 * k;
      if (i < n) {
        Ch::unpack(v[k], f);
#pragma unroll
        for (int e = 0; e < N; ++e) f[e] *= scale;
        orow[i] = Ch::pack(f);
      }
    }
  } else {
    for (int i = lane; i < n; i += 32) {
      Ch::unpack(xr[i], f);
#pragma unroll
      for (int e = 0; e < N; ++e) ss += f[e] * f[e];
    }
    const float scale = rsqrtf(warp_sum(ss) / c + eps);
    for (int i = lane; i < n; i += 32) {
      Ch::unpack(xr[i], f);
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] *= scale;
      orow[i] = Ch::pack(f);
    }
  }
}

template <typename T, int N, bool CACHED>
void run(const void* x, void* o, long long rows, int c, float eps,
         cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  pixel_norm_kernel<T, N, CACHED><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(o), rows, c / N,
      static_cast<float>(c), eps);
}

template <typename T>
int launch(const void* x, void* o, long long rows, int c, float eps,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t both =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o);
  const bool vec =
      (static_cast<size_t>(c) * sizeof(T)) % 16 == 0 && both % 16 == 0;
  if (vec && c <= kCachedC) {
    run<T, V, true>(x, o, rows, c, eps, stream);
  } else if (vec) {
    run<T, V, false>(x, o, rows, c, eps, stream);
  } else {
    run<T, 1, false>(x, o, rows, c, eps, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, o: (rows, c) contiguous, the same dtype.
extern "C" int ganlab_pixel_norm(const void* x, void* o, long long rows,
                                 int c, float eps, int dtype, int device,
                                 void* stream) {
  if (rows <= 0 || c <= 0 || (rows + kWarps - 1) / kWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, o, rows, c, eps, s);
    case 1: return launch<__nv_bfloat16>(x, o, rows, c, eps, s);
    case 2: return launch<__half>(x, o, rows, c, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
