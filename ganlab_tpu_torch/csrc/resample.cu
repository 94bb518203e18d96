// The two resampling kernels of StyleGAN, NCHW, for Hopper (sm_90a):
// nearest-2x upsample + [1,2,1] blur, and [1,2,1] blur + 2x downsample
// (further below). Each is the other's adjoint up to a factor 4, so each
// takes a `gain` that it multiplies into its store: the autograd Functions
// pass 0.25 and 4 there instead of running a separate elementwise pass.
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
// vertical lerps first, then horizontal, in float32 whatever the storage
// type, then `gain *` and one rounding to the storage type.
//
// Bound: memory. It reads each input once and writes 4x as many outputs,
// about 30 flops per input pixel, i.e. a few flops per byte moved, far
// below the card's ~295 flop/byte balance point, so the least time is
// (in + out bytes) / 3.35 TB/s.
//
// What limited the first design (one thread per input pixel, kept below as
// the element path): each thread found (plane, i, j) by 64-bit divisions,
// made nine predicated 2-byte loads with 64-bit addresses and two 4-byte
// stores, some 250 machine operations to move 10 bytes. The SMs'
// schedulers are then saturated long before the memory bandwidth is.
//
// The vector path, taken where W is a multiple of V = 16 / itemsize (8
// bf16, 4 float32) and both pointers are 16-byte aligned:
//  * a thread owns V adjacent columns of one input row. It loads that row
//    and the rows above and below as three independent 16-byte vectors
//    (all three in flight before the first use) and writes the 2V output
//    columns of each of its two output rows as two 16-byte stores: about
//    20 machine operations per 10 bytes.
//  * no division per pixel: threadIdx.x is the column chunk, threadIdx.y
//    and blockIdx.x give the row among all planes' rows, and one 32-bit
//    remainder per thread gives the row inside its plane, which only
//    decides whether the rows above and below exist. NCHW is row-major
//    over (plane, row), so the addresses need no plane at all.
//  * each input element comes from device memory once: the rows above and
//    below are the own rows of the threads beside this one in
//    threadIdx.y, which load them at the same time, so those reads hit in
//    L1/L2. A block covers 256 / (W / V) consecutive rows and so reads and
//    writes one contiguous piece of memory. Walking each thread down a
//    strip of 2 to 16 rows with the three rows kept in registers (fewer
//    loads, no re-read) measured slower at every large shape,
//    the more so the longer the strip: a block then writes many short
//    pieces far apart at any one time.
//  * the halo columns come from the neighbouring lanes: a thread shuffles
//    its vertically-lerped edge columns to the lanes beside it
//    (__shfl_up_sync / __shfl_down_sync, four per thread), which are
//    bit-identical to what that lane would compute itself. A lane whose
//    neighbour chunk lies in another warp (a row of more than 32 chunks,
//    or a chunk count that does not divide 32) reads the three halo
//    elements itself; at a row's first and last chunk the halo is zero,
//    so nothing leaks from the row or plane that the next lane holds.
//    Shared memory is not used: a tile staged there would cost a
//    __syncthreads for the same bytes.
//  * the output is written with streaming stores (__stcs): it is four
//    fifths of the traffic and nothing in this kernel reads it again, and
//    marking it evict-first measured faster than default stores, most of
//    all at the maps that fit in L2.
// The C function picks the path from the shape and the pointers
// (ganlab_upsample_blur_2x_path tells which); both paths evaluate the same
// expressions in the same order and agree bit for bit.
//
// C interface (loaded with ctypes): launches on `stream` of `device` and
// returns cudaGetLastError() after the launch, 0 on success. dtype 0 =
// float32, 1 = bfloat16.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The two polyphase taps, 0.25 a + 0.75 b and 0.75 b + 0.25 c. The product
// by 0.25 is exact, so the one fused multiply-add rounds the sum once, and
// writing it out keeps the compiler from contracting the two paths'
// expressions differently: every path goes through these two functions.
__device__ __forceinline__ float lerp_lo(float a, float b) {
  return __fmaf_rn(0.75f, b, 0.25f * a);
}
__device__ __forceinline__ float lerp_hi(float b, float c) {
  return __fmaf_rn(0.75f, b, 0.25f * c);
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

// One output row's 2V columns from the V lerped columns v and the lerped
// halo columns left and right of them: two 16-byte streaming stores.
template <typename T>
__device__ __forceinline__ void store_up_row(T* orow, const float* v,
                                             float left, float right,
                                             float gain) {
  constexpr int V = Vec<T>::N;
  float e[2 * V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float a = k == 0 ? left : v[k - 1];
    const float c = k == V - 1 ? right : v[k + 1];
    e[2 * k] = gain * lerp_lo(a, v[k]);
    e[2 * k + 1] = gain * lerp_hi(v[k], c);
  }
  __stcs(reinterpret_cast<uint4*>(orow), Vec<T>::pack(e));
  __stcs(reinterpret_cast<uint4*>(orow + V), Vec<T>::pack(e + V));
}

// Vector path. blockDim = (chunks of a row in this block, rows in this
// block); grid = (row blocks, chunk blocks); `rows` counts the rows of all
// planes. Every thread reaches the shuffles, so they are always warp-wide;
// a thread without work (past the last chunk or row) loads zeros and
// stores nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_blur_2x_vec_kernel(const T* __restrict__ x, T* __restrict__ o,
                            int rows, int h, int w, int chunks, float gain) {
  constexpr int V = Vec<T>::N;
  const int tx = threadIdx.x;
  const int lane = (threadIdx.y * blockDim.x + tx) & 31;
  const int chunk = blockIdx.y * blockDim.x + tx;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const bool active = chunk < chunks && row < rows;
  const int i = active ? row % h : 0;  // the row inside its plane
  const bool above = active && i > 0, below = active && i + 1 < h;
  const T* xr = x + (active ? static_cast<size_t>(row) * w + chunk * V : 0);

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4 qa = above ? *reinterpret_cast<const uint4*>(xr - w) : zero;
  const uint4 qb = active ? *reinterpret_cast<const uint4*>(xr) : zero;
  const uint4 qc = below ? *reinterpret_cast<const uint4*>(xr + w) : zero;
  float prev[V], cur[V], nxt[V], ve[V], vo[V];
  Vec<T>::unpack(qa, prev);
  Vec<T>::unpack(qb, cur);
  Vec<T>::unpack(qc, nxt);
#pragma unroll
  for (int c = 0; c < V; ++c) {
    ve[c] = lerp_lo(prev[c], cur[c]);
    vo[c] = lerp_hi(cur[c], nxt[c]);
  }

  // the lerped halo columns: zero at the row's ends, from the neighbouring
  // lane where it holds the neighbouring chunk, else from memory
  float le = __shfl_up_sync(kFullMask, ve[V - 1], 1);
  float lo = __shfl_up_sync(kFullMask, vo[V - 1], 1);
  float re = __shfl_down_sync(kFullMask, ve[0], 1);
  float ro = __shfl_down_sync(kFullMask, vo[0], 1);
  auto halo = [&](int c, float& even, float& odd) {  // c relative to chunk
    const float b = load_f32(xr + c);
    even = lerp_lo(above ? load_f32(xr - w + c) : 0.0f, b);
    odd = lerp_hi(b, below ? load_f32(xr + w + c) : 0.0f);
  };
  if (!active || chunk == 0) {
    le = lo = 0.0f;
  } else if (tx == 0 || lane == 0) {
    halo(-1, le, lo);
  }
  if (!active || chunk + 1 == chunks) {
    re = ro = 0.0f;
  } else if (tx + 1 == blockDim.x || lane == 31) {
    halo(V, re, ro);
  }
  if (active) {
    // plane * 4hw + 2i * 2w = 4w * row: no plane needed here either
    T* orow = o + 4 * static_cast<size_t>(row) * w + 2 * chunk * V;
    store_up_row<T>(orow, ve, le, re, gain);
    store_up_row<T>(orow + 2 * w, vo, lo, ro, gain);
  }
}

// Element path: one thread per input pixel writes the 2x2 output quad that
// the pixel owns, from its 3x3 input neighbourhood. Any shape, any
// alignment; 64-bit indices.
template <typename T>
__global__ void upsample_blur_2x_kernel(const T* __restrict__ x,
                                        T* __restrict__ o, int64_t total,
                                        int h, int w, float gain) {
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
    ve[dj] = lerp_lo(v[0][dj], v[1][dj]);
    vo[dj] = lerp_hi(v[1][dj], v[2][dj]);
  }
  using P = Pair<T>;
  const int64_t w2 = 2 * static_cast<int64_t>(w);
  T* op = o + plane * (4 * static_cast<int64_t>(h) * w) + (2 * i) * w2 + 2 * j;
  *reinterpret_cast<typename P::type*>(op) =
      P::make(gain * lerp_lo(ve[0], ve[1]), gain * lerp_hi(ve[1], ve[2]));
  *reinterpret_cast<typename P::type*>(op + w2) =
      P::make(gain * lerp_lo(vo[0], vo[1]), gain * lerp_hi(vo[1], vo[2]));
}

// Fused [1,2,1] blur + 2x2 average pool (replaces blur_downsample_2x_pallas
// -> _down_impl -> _down_kernel). Per axis, with a zero halo
// (x[-1] = x[2H] = 0):
//
//     out[i] = 0.125 x[2i-1] + 0.375 x[2i] + 0.375 x[2i+1] + 0.125 x[2i+2]
//
// rows first, then columns, in float32, then `gain *` before the one store.
// Bound: memory. It reads each input once and writes a quarter as many
// outputs, ~21 flops per output, so the least time is (in + out bytes) /
// 3.35 TB/s; the input is four fifths of the traffic.
//
// What limited the first design (one thread per output pixel, kept below as
// the element path): two 64-bit divisions, sixteen predicated 2-byte loads
// with 64-bit addresses and one 2-byte store per output. Like up+blur's
// element path it saturates the SMs' schedulers, not the memory.
//
// The vector path, taken where the output width is a multiple of
// V = 16 / itemsize and both pointers are 16-byte aligned, mirrors
// up+blur's:
//  * a thread owns V adjacent output columns of one output row (one 16-byte
//    store) and reads the 2V input columns under them, two 16-byte loads
//    from each of the four input rows 2i-1 .. 2i+2, all eight in flight
//    before the first use;
//  * no division per pixel: threadIdx.x is the chunk, threadIdx.y and
//    blockIdx.x the output row among all planes' rows (input row 2 * row,
//    no plane in any address), one 32-bit remainder gives the row inside
//    its plane, which only decides whether rows 2i-1 and 2i+2 exist;
//  * each input row comes from device memory once: rows 2i-1 and 2i+2 are
//    own rows of the threads beside this one in threadIdx.y, which load
//    them at the same time, so those reads hit in L1/L2, and a block reads
//    one contiguous piece of memory;
//  * the vertical taps first, per column; the two halo columns (2j-1 left
//    of the chunk, 2j+2V right of it) come vertically combined from the
//    neighbouring lanes by __shfl_up_sync / __shfl_down_sync, from memory
//    at a warp's edge or where the neighbour lane holds another row, zero
//    at the row's ends.
// Every tap goes through blur4 below, one fixed order of explicit fused
// multiply-adds with a zero for each tap that falls outside, so the two
// paths agree bit for bit (ganlab_blur_downsample_2x_path tells which path
// a call takes).
__device__ __forceinline__ float blur4(float a, float b, float c, float d) {
  // 0.125 d is exact; each fused multiply-add rounds once
  return __fmaf_rn(
      0.125f, a, __fmaf_rn(0.375f, b, __fmaf_rn(0.375f, c, 0.125f * d)));
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Vector path. Threads are laid out as in upsample_blur_2x_vec_kernel, over
// the output: blockDim = (chunks of an output row in this block, output
// rows in this block); `rows` counts the output rows of all planes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
blur_downsample_2x_vec_kernel(const T* __restrict__ x, T* __restrict__ o,
                              int rows, int ho, int wo, int chunks,
                              float gain) {
  constexpr int V = Vec<T>::N;
  const int tx = threadIdx.x;
  const int lane = (threadIdx.y * blockDim.x + tx) & 31;
  const int chunk = blockIdx.y * blockDim.x + tx;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const bool active = chunk < chunks && row < rows;
  const int i = active ? row % ho : 0;  // the output row inside its plane
  const bool above = active && i > 0, below = active && i + 1 < ho;
  const int w = 2 * wo;
  // input row 2i of this plane is row 2 * row of all planes' input rows
  const T* xr =
      x + (active ? 2 * static_cast<size_t>(row) * w + 2 * chunk * V : 0);

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 q[4][2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    q[0][s] = above ? load16(xr - w + s * V) : zero;
    q[1][s] = active ? load16(xr + s * V) : zero;
    q[2][s] = active ? load16(xr + w + s * V) : zero;
    q[3][s] = below ? load16(xr + 2 * w + s * V) : zero;
  }
  float v[2 * V];  // the 2V input columns, vertically combined
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float a[V], b[V], c[V], d[V];
    Vec<T>::unpack(q[0][s], a);
    Vec<T>::unpack(q[1][s], b);
    Vec<T>::unpack(q[2][s], c);
    Vec<T>::unpack(q[3][s], d);
#pragma unroll
    for (int k = 0; k < V; ++k) v[s * V + k] = blur4(a[k], b[k], c[k], d[k]);
  }

  // the combined halo columns: zero at the row's ends, from the
  // neighbouring lane where it holds the neighbouring chunk, else from
  // memory
  float left = __shfl_up_sync(kFullMask, v[2 * V - 1], 1);
  float right = __shfl_down_sync(kFullMask, v[0], 1);
  auto halo = [&](int c) {  // c relative to the chunk's first input column
    return blur4(above ? load_f32(xr - w + c) : 0.0f, load_f32(xr + c),
                 load_f32(xr + w + c), below ? load_f32(xr + 2 * w + c) : 0.0f);
  };
  if (!active || chunk == 0) {
    left = 0.0f;
  } else if (tx == 0 || lane == 0) {
    left = halo(-1);
  }
  if (!active || chunk + 1 == chunks) {
    right = 0.0f;
  } else if (tx + 1 == blockDim.x || lane == 31) {
    right = halo(2 * V);
  }
  if (active) {
    float e[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float a = k == 0 ? left : v[2 * k - 1];
      const float d = k == V - 1 ? right : v[2 * k + 2];
      e[k] = gain * blur4(a, v[2 * k], v[2 * k + 1], d);
    }
    *reinterpret_cast<uint4*>(o + static_cast<size_t>(row) * wo + chunk * V) =
        Vec<T>::pack(e);
  }
}

// Element path: one thread per output pixel reads its 4x4 input window.
// Any even shape, any alignment; 64-bit indices.
template <typename T>
__global__ void blur_downsample_2x_kernel(const T* __restrict__ x,
                                          T* __restrict__ o, int64_t total,
                                          int ho, int wo, float gain) {
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
  for (int dc = 0; dc < 4; ++dc) {
    const int c = 2 * j - 1 + dc;
    const bool col_in = c >= 0 && c < w;
    float v[4];
#pragma unroll
    for (int dr = 0; dr < 4; ++dr) {
      const int r = 2 * i - 1 + dr;
      v[dr] = (col_in && r >= 0 && r < h)
                  ? load_f32(xp + static_cast<int64_t>(r) * w + c)
                  : 0.0f;
    }
    col[dc] = blur4(v[0], v[1], v[2], v[3]);
  }
  store_f32(o + idx, gain * blur4(col[0], col[1], col[2], col[3]));
}

// How a vector path cuts (planes, h, w) into threads, one per V columns of
// a row: up+blur's input, blur+down's output. ok = false where the shape or
// the pointers leave it to the element path.
struct VecPlan {
  bool ok;
  int chunks, rows;
  dim3 block, grid;
};

template <typename T>
VecPlan plan_vec(const void* x, const void* o, long long planes, int h,
                 int w) {
  constexpr int V = Vec<T>::N;
  VecPlan p{};
  if (w % V != 0) return p;  // also W < V and W * itemsize % 16 != 0
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) % 16)
    return p;
  p.chunks = w / V;
  const int bx = p.chunks < 32 ? p.chunks : 32;
  const int by = kThreads / bx;
  const long long rows = planes * h;
  const long long chunk_blocks = (p.chunks + bx - 1) / bx;
  if (rows > 0x3fffffffLL || chunk_blocks > 65535) return p;
  p.rows = static_cast<int>(rows);
  p.block = dim3(bx, by);
  p.grid = dim3(static_cast<unsigned>((rows + by - 1) / by),
                static_cast<unsigned>(chunk_blocks));
  p.ok = true;
  return p;
}

template <typename T>
int launch_up(const void* x, void* o, long long planes, int h, int w,
              float gain, cudaStream_t stream) {
  const VecPlan p = plan_vec<T>(x, o, planes, h, w);
  if (p.ok) {
    upsample_blur_2x_vec_kernel<T><<<p.grid, p.block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(o), p.rows, h, w, p.chunks,
        gain);
  } else {
    const int64_t total = planes * h * w;
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    upsample_blur_2x_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(static_cast<const T*>(x),
                                           static_cast<T*>(o), total, h, w,
                                           gain);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_down(const void* x, void* o, long long planes, int ho, int wo,
                float gain, cudaStream_t stream) {
  const VecPlan p = plan_vec<T>(x, o, planes, ho, wo);
  if (p.ok) {
    blur_downsample_2x_vec_kernel<T><<<p.grid, p.block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(o), p.rows, ho, wo,
        p.chunks, gain);
  } else {
    const int64_t total = planes * ho * wo;
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    blur_downsample_2x_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                   stream>>>(static_cast<const T*>(x),
                                             static_cast<T*>(o), total, ho,
                                             wo, gain);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (planes, h, w) -> o (planes, 2h, 2w) = gain * up+blur(x).
extern "C" int ganlab_upsample_blur_2x(const void* x, void* o,
                                       long long planes, int h, int w,
                                       float gain, int dtype, int device,
                                       void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_up<float>(x, o, planes, h, w, gain, s);
    case 1: return launch_up<__nv_bfloat16>(x, o, planes, h, w, gain, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The path ganlab_upsample_blur_2x takes for these arguments: 1 = vector,
// 0 = element, -1 = a dtype it does not take. Launches nothing.
extern "C" int ganlab_upsample_blur_2x_path(const void* x, const void* o,
                                            long long planes, int h, int w,
                                            int dtype) {
  switch (dtype) {
    case 0: return plan_vec<float>(x, o, planes, h, w).ok ? 1 : 0;
    case 1: return plan_vec<__nv_bfloat16>(x, o, planes, h, w).ok ? 1 : 0;
    default: return -1;
  }
}

// x (planes, 2*ho, 2*wo) -> o (planes, ho, wo) = gain * blur+down(x).
extern "C" int ganlab_blur_downsample_2x(const void* x, void* o,
                                         long long planes, int ho, int wo,
                                         float gain, int dtype, int device,
                                         void* stream) {
  if (planes <= 0 || ho <= 0 || wo <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_down<float>(x, o, planes, ho, wo, gain, s);
    case 1: return launch_down<__nv_bfloat16>(x, o, planes, ho, wo, gain, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The path ganlab_blur_downsample_2x takes for these arguments, as
// ganlab_upsample_blur_2x_path: 1 = vector, 0 = element, -1 = a dtype it
// does not take. Launches nothing.
extern "C" int ganlab_blur_downsample_2x_path(const void* x, const void* o,
                                              long long planes, int ho,
                                              int wo, int dtype) {
  switch (dtype) {
    case 0: return plan_vec<float>(x, o, planes, ho, wo).ok ? 1 : 0;
    case 1: return plan_vec<__nv_bfloat16>(x, o, planes, ho, wo).ok ? 1 : 0;
    default: return -1;
  }
}
