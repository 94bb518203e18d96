// Vec<T>: 16 bytes of T moved as one uint4 (4 float32, 8 bfloat16 or
// float16), and their float32 values. Element 0 sits at the lowest address.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t f16x2_bits(float lo, float hi) {
  __half2 p = __floats2half2_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&p);
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the upper half of a float32; element 0 sits in the low bits
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(bf16x2_bits(f[0], f[1]), bf16x2_bits(f[2], f[3]),
                      bf16x2_bits(f[4], f[5]), bf16x2_bits(f[6], f[7]));
  }
};

template <>
struct Vec<__half> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p =
          __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(f16x2_bits(f[0], f[1]), f16x2_bits(f[2], f[3]),
                      f16x2_bits(f[4], f[5]), f16x2_bits(f[6], f[7]));
  }
};
