// The two resampling kernels of StyleGAN, for Hopper (sm_90a): nearest-2x
// upsample + [1,2,1] blur, and [1,2,1] blur + 2x downsample (further
// below), each on NCHW and on NHWC (channels-last) memory. Each kernel is
// a template over the layout (kNhwc), so both layouts' launches carry the
// kernel's one name; the NHWC paths are described after the NCHW ones.
// Each is the other's adjoint up to a factor 4, so each takes a `gain`
// that it multiplies into its store: the autograd Functions pass 0.25 and
// 4 there instead of running a separate elementwise pass.
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

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
// the NHWC blur+down's block: a tile of kTileH x kTileW output pixels, up
// to kTileChunks 16-byte chunks of their channels
constexpr int kTileH = 4, kTileW = 8, kTileChunks = 8;

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

// The NHWC paths, each kernel's kNhwc instance (defined further below).
template <typename T>
__device__ __forceinline__ void up_vec_nhwc(
    const T* __restrict__ x, T* __restrict__ o, int pixels, int h, int w,
    int chunks, float gain);

template <typename T>
__device__ __forceinline__ void up_element_nhwc(
    const T* __restrict__ x, T* __restrict__ o, int64_t total, int c,
    int h, int w, float gain);

template <typename T>
__device__ __forceinline__ void down_vec_nhwc(
    const T* __restrict__ x, T* __restrict__ o, int ho, int wo, int chunks,
    float gain);

template <typename T>
__device__ __forceinline__ void down_element_nhwc(
    const T* __restrict__ x, T* __restrict__ o, int64_t total, int c,
    int ho, int wo, float gain);

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
template <typename T, bool kNhwc>
__global__ void __launch_bounds__(kThreads)
upsample_blur_2x_vec_kernel(const T* __restrict__ x, T* __restrict__ o,
                            int rows, int h, int w, int chunks, float gain) {
  if constexpr (kNhwc) {
    up_vec_nhwc<T>(x, o, rows, h, w, chunks, gain);
    return;
  }
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
template <typename T, bool kNhwc>
__global__ void upsample_blur_2x_kernel(const T* __restrict__ x,
                                        T* __restrict__ o, int64_t total,
                                        int c, int h, int w, float gain) {
  if constexpr (kNhwc) {
    up_element_nhwc<T>(x, o, total, c, h, w, gain);
    return;
  }
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
// rows in this block); `rows` counts the output rows of all planes. (The
// NHWC instance's blocks cover tiles of output pixels: down_vec_nhwc.)
template <typename T, bool kNhwc>
__global__ void __launch_bounds__(kThreads)
blur_downsample_2x_vec_kernel(const T* __restrict__ x, T* __restrict__ o,
                              int rows, int ho, int wo, int chunks,
                              float gain) {
  if constexpr (kNhwc) {
    down_vec_nhwc<T>(x, o, ho, wo, chunks, gain);
    return;
  }
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
template <typename T, bool kNhwc>
__global__ void blur_downsample_2x_kernel(const T* __restrict__ x,
                                          T* __restrict__ o, int64_t total,
                                          int c, int ho, int wo,
                                          float gain) {
  if constexpr (kNhwc) {
    down_element_nhwc<T>(x, o, total, c, ho, wo, gain);
    return;
  }
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

// The NHWC paths. In channels-last memory a pixel's C channels lie
// together, so each kernel works on pixels, not on rows of one plane:
//  * vector path, taken where C is a multiple of V = 16 / itemsize (8 bf16,
//    4 float32) and both pointers are 16-byte aligned: a thread owns V
//    adjacent channels of one pixel (up+blur: an input pixel, which owns
//    its 2x2 output quad; blur+down: an output pixel). Its 3x3 (up) or 4x4
//    (down) input neighbourhood is nine or sixteen 16-byte vectors, the
//    same channels of the neighbouring pixels, all loaded before the first
//    use; it writes four (up, as streaming stores) or one 16-byte vector.
//    threadIdx.x is the channel chunk, so a warp reads and writes
//    contiguous memory. up+blur: threadIdx.y and blockIdx.x give the pixel
//    among all images' pixels; the neighbours left and right of a pixel
//    are loaded by the threads beside it in threadIdx.y (L1 hits), the
//    rows above and below by neighbouring blocks (L2 hits). blur+down,
//    whose windows overlap by half in both directions: a block covers a
//    kTileH x kTileW tile of output pixels (threadIdx.y) and up to
//    kTileChunks chunks of their channels, so most of a window's rows
//    above and below are loaded by the same block too (L1 hits); one
//    output row a block read each input row twice from L2 and ran 5-7%
//    slower at the config F shapes from 32x32 up. The pixel's row and column decide
//    which neighbours exist: a missing one is loaded as zeros.
//  * element path (any C, any alignment, e.g. the 3-channel RGB skip):
//    one thread per input (up) or output (down) element, the same
//    neighbourhood as scalars.
// Every path evaluates the NCHW paths' expressions in their order,
// vertical taps first, then horizontal, in float32, `gain` in the store,
// one rounding: all four paths of a kernel agree bit for bit. A missing
// neighbour's zeros give the same +0 halo that the NCHW paths use.

// One input pixel's 2x2 output quad from the vertically lerped columns
// ve / vo at columns j-1, j, j+1 (index 0..2), V channels each.
template <typename T>
__device__ __forceinline__ void up_vec_nhwc(
    const T* __restrict__ x, T* __restrict__ o, int pixels, int h, int w,
    int chunks, float gain) {
  constexpr int V = Vec<T>::N;
  const int chunk = blockIdx.y * blockDim.x + threadIdx.x;
  const int p = blockIdx.x * blockDim.y + threadIdx.y;
  if (chunk >= chunks || p >= pixels) return;
  const int j = p % w, i = (p / w) % h;
  const size_t c = static_cast<size_t>(chunks) * V;
  const size_t row = static_cast<size_t>(w) * c;
  const T* xp = x + static_cast<size_t>(p) * c + chunk * V;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 q[3][3];  // [row i-1 .. i+1][column j-1 .. j+1]
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const bool in = (r != 0 || i > 0) && (r != 2 || i + 1 < h) &&
                      (s != 0 || j > 0) && (s != 2 || j + 1 < w);
      q[r][s] = in ? *reinterpret_cast<const uint4*>(
                         xp + (r - 1) * static_cast<ptrdiff_t>(row) +
                         (s - 1) * static_cast<ptrdiff_t>(c))
                   : zero;
    }
  }
  float ve[3][V], vo[3][V];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    float a[V], b[V], d[V];
    Vec<T>::unpack(q[0][s], a);
    Vec<T>::unpack(q[1][s], b);
    Vec<T>::unpack(q[2][s], d);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      ve[s][k] = lerp_lo(a[k], b[k]);
      vo[s][k] = lerp_hi(b[k], d[k]);
    }
  }
  // output pixel (2i, 2j) of the same image: 4 p - 2 j among all pixels
  T* op = o + (4 * static_cast<size_t>(p) - 2 * j) * c + chunk * V;
  const size_t orow = 2 * row;
  float e[V];
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = gain * lerp_lo(ve[0][k], ve[1][k]);
  __stcs(reinterpret_cast<uint4*>(op), Vec<T>::pack(e));
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = gain * lerp_hi(ve[1][k], ve[2][k]);
  __stcs(reinterpret_cast<uint4*>(op + c), Vec<T>::pack(e));
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = gain * lerp_lo(vo[0][k], vo[1][k]);
  __stcs(reinterpret_cast<uint4*>(op + orow), Vec<T>::pack(e));
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = gain * lerp_hi(vo[1][k], vo[2][k]);
  __stcs(reinterpret_cast<uint4*>(op + orow + c), Vec<T>::pack(e));
}

template <typename T>
__device__ __forceinline__ void up_element_nhwc(
    const T* __restrict__ x, T* __restrict__ o, int64_t total, int c,
    int h, int w, float gain) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  const int ch = static_cast<int>(idx % c);
  const int64_t p = idx / c;
  const int j = static_cast<int>(p % w);
  const int i = static_cast<int>((p / w) % h);
  const int64_t row = static_cast<int64_t>(w) * c;

  float ve[3], vo[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int cj = j + s - 1;
    const bool col_in = cj >= 0 && cj < w;
    float v[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int ri = i + r - 1;
      v[r] = (col_in && ri >= 0 && ri < h)
                 ? load_f32(x + idx + (r - 1) * row + (s - 1) * c)
                 : 0.0f;
    }
    ve[s] = lerp_lo(v[0], v[1]);
    vo[s] = lerp_hi(v[1], v[2]);
  }
  T* op = o + (4 * p - 2 * j) * c + ch;
  store_f32(op, gain * lerp_lo(ve[0], ve[1]));
  store_f32(op + c, gain * lerp_hi(ve[1], ve[2]));
  store_f32(op + 2 * row, gain * lerp_lo(vo[0], vo[1]));
  store_f32(op + 2 * row + c, gain * lerp_hi(vo[1], vo[2]));
}

// One output pixel from its 4x4 input window: rows 2io-1 .. 2io+2 blurred
// per column first, then the four columns. blockIdx.x is the tile, row-
// major over the tiles of all images, blockIdx.y the block of chunks.
template <typename T>
__device__ __forceinline__ void down_vec_nhwc(
    const T* __restrict__ x, T* __restrict__ o, int ho, int wo, int chunks,
    float gain) {
  constexpr int V = Vec<T>::N;
  const int tiles_w = (wo + kTileW - 1) / kTileW;
  const int tiles_h = (ho + kTileH - 1) / kTileH;
  const int t = blockIdx.x / tiles_w;  // the tile row among all images'
  const int jo = (blockIdx.x - t * tiles_w) * kTileW + threadIdx.y % kTileW;
  const int io = (t % tiles_h) * kTileH + threadIdx.y / kTileW;
  const int chunk = blockIdx.y * blockDim.x + threadIdx.x;
  if (chunk >= chunks || io >= ho || jo >= wo) return;
  const size_t q = (static_cast<size_t>(t / tiles_h) * ho + io) * wo + jo;
  const size_t c = static_cast<size_t>(chunks) * V;
  const size_t row = 2 * static_cast<size_t>(wo) * c;  // an input row
  // input pixel (2io, 2jo) of the same image: 4 q - 2 jo among all pixels
  const T* xp = x + (4 * q - 2 * jo) * c + chunk * V;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 v[4][4];  // [row 2io-1 .. 2io+2][column 2jo-1 .. 2jo+2]
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const bool in = (r != 0 || io > 0) && (r != 3 || io + 1 < ho) &&
                      (s != 0 || jo > 0) && (s != 3 || jo + 1 < wo);
      v[r][s] = in ? load16(xp + (r - 1) * static_cast<ptrdiff_t>(row) +
                            (s - 1) * static_cast<ptrdiff_t>(c))
                   : zero;
    }
  }
  float col[4][V];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    float a[V], b[V], cc[V], d[V];
    Vec<T>::unpack(v[0][s], a);
    Vec<T>::unpack(v[1][s], b);
    Vec<T>::unpack(v[2][s], cc);
    Vec<T>::unpack(v[3][s], d);
#pragma unroll
    for (int k = 0; k < V; ++k) col[s][k] = blur4(a[k], b[k], cc[k], d[k]);
  }
  float e[V];
#pragma unroll
  for (int k = 0; k < V; ++k)
    e[k] = gain * blur4(col[0][k], col[1][k], col[2][k], col[3][k]);
  *reinterpret_cast<uint4*>(o + q * c + chunk * V) = Vec<T>::pack(e);
}

template <typename T>
__device__ __forceinline__ void down_element_nhwc(
    const T* __restrict__ x, T* __restrict__ o, int64_t total, int c,
    int ho, int wo, float gain) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  const int ch = static_cast<int>(idx % c);
  const int64_t q = idx / c;
  const int jo = static_cast<int>(q % wo);
  const int io = static_cast<int>((q / wo) % ho);
  const int h = 2 * ho, w = 2 * wo;
  const int64_t row = static_cast<int64_t>(w) * c;
  const T* xp = x + (4 * q - 2 * jo) * c + ch;  // input pixel (2io, 2jo)

  float col[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int cj = 2 * jo - 1 + s;
    const bool col_in = cj >= 0 && cj < w;
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ri = 2 * io - 1 + r;
      v[r] = (col_in && ri >= 0 && ri < h)
                 ? load_f32(xp + (r - 1) * row + (s - 1) * c)
                 : 0.0f;
    }
    col[s] = blur4(v[0], v[1], v[2], v[3]);
  }
  store_f32(o + idx, gain * blur4(col[0], col[1], col[2], col[3]));
}

// How a vector path cuts its work into threads, one per V columns of a
// row (NCHW: up+blur's input rows, blur+down's output rows, of all planes)
// or per V channels of a pixel (NHWC: up+blur's input pixels, blur+down's
// output pixels, of all images). ok = false where the shape or the
// pointers leave it to the element path.
struct VecPlan {
  bool ok;
  int chunks, rows;
  dim3 block, grid;
};

// `lines` rows or pixels of `width` elements (a row's columns, a pixel's
// channels) each.
template <typename T>
VecPlan plan_vec(const void* x, const void* o, long long lines, int width) {
  constexpr int V = Vec<T>::N;
  VecPlan p{};
  if (width % V != 0) return p;  // also width < V
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) % 16)
    return p;
  p.chunks = width / V;
  const int bx = p.chunks < 32 ? p.chunks : 32;
  const int by = kThreads / bx;
  const long long chunk_blocks = (p.chunks + bx - 1) / bx;
  if (lines > 0x3fffffffLL || chunk_blocks > 65535) return p;
  p.rows = static_cast<int>(lines);
  p.block = dim3(bx, by);
  p.grid = dim3(static_cast<unsigned>((lines + by - 1) / by),
                static_cast<unsigned>(chunk_blocks));
  p.ok = true;
  return p;
}

// The vector plan of one call: NCHW rows of w columns, NHWC pixels of c
// channels, the NHWC blur+down's in tiles of output pixels. (h, w) is
// up+blur's input plane, blur+down's output plane.
template <typename T>
VecPlan plan_call(bool up, const void* x, const void* o, long long n, int c,
                  int h, int w, bool nhwc) {
  if (!nhwc) return plan_vec<T>(x, o, n * c * h, w);
  VecPlan p = plan_vec<T>(x, o, n * h * w, c);
  if (up || !p.ok) return p;
  const int bx = p.chunks < kTileChunks ? p.chunks : kTileChunks;
  const long long chunk_blocks = (p.chunks + bx - 1) / bx;
  p.ok = chunk_blocks <= 65535;
  p.block = dim3(bx, kTileH * kTileW);
  // n * tiles <= n * h * w, which plan_vec held to 2^30
  p.grid = dim3(static_cast<unsigned>(n * ((h + kTileH - 1) / kTileH) *
                                      ((w + kTileW - 1) / kTileW)),
                static_cast<unsigned>(chunk_blocks));
  return p;
}

template <typename T, bool kNhwc>
int launch_up(const void* x, void* o, long long n, int c, int h, int w,
              float gain, cudaStream_t stream) {
  const auto* xt = static_cast<const T*>(x);
  auto* ot = static_cast<T*>(o);
  const VecPlan p = plan_call<T>(true, x, o, n, c, h, w, kNhwc);
  if (p.ok) {
    upsample_blur_2x_vec_kernel<T, kNhwc><<<p.grid, p.block, 0, stream>>>(
        xt, ot, p.rows, h, w, p.chunks, gain);
  } else {
    const int64_t total = n * c * h * w;
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    upsample_blur_2x_kernel<T, kNhwc><<<static_cast<unsigned>(blocks),
                                        kThreads, 0, stream>>>(
        xt, ot, total, c, h, w, gain);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kNhwc>
int launch_down(const void* x, void* o, long long n, int c, int ho, int wo,
                float gain, cudaStream_t stream) {
  const auto* xt = static_cast<const T*>(x);
  auto* ot = static_cast<T*>(o);
  const VecPlan p = plan_call<T>(false, x, o, n, c, ho, wo, kNhwc);
  if (p.ok) {
    blur_downsample_2x_vec_kernel<T, kNhwc><<<p.grid, p.block, 0, stream>>>(
        xt, ot, p.rows, ho, wo, p.chunks, gain);
  } else {
    const int64_t total = n * c * ho * wo;
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    blur_downsample_2x_kernel<T, kNhwc><<<static_cast<unsigned>(blocks),
                                          kThreads, 0, stream>>>(
        xt, ot, total, c, ho, wo, gain);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(bool up, const void* x, void* o, long long n, int c, int h,
           int w, float gain, int nhwc, cudaStream_t s) {
  if (up) {
    return nhwc ? launch_up<T, true>(x, o, n, c, h, w, gain, s)
                : launch_up<T, false>(x, o, n, c, h, w, gain, s);
  }
  return nhwc ? launch_down<T, true>(x, o, n, c, h, w, gain, s)
              : launch_down<T, false>(x, o, n, c, h, w, gain, s);
}

int dispatch(bool up, const void* x, void* o, long long n, int c, int h,
             int w, float gain, int nhwc, int dtype, int device,
             void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(up, x, o, n, c, h, w, gain, nhwc, s);
    case 1:
      return launch<__nv_bfloat16>(up, x, o, n, c, h, w, gain, nhwc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int path(bool up, const void* x, const void* o, long long n, int c, int h,
         int w, int nhwc, int dtype) {
  switch (dtype) {
    case 0: return plan_call<float>(up, x, o, n, c, h, w, nhwc).ok ? 1 : 0;
    case 1:
      return plan_call<__nv_bfloat16>(up, x, o, n, c, h, w, nhwc).ok ? 1
                                                                     : 0;
    default: return -1;
  }
}

}  // namespace

// x (n, c, h, w) -> o (n, c, 2h, 2w) = gain * up+blur(x), both NCHW or
// (nhwc != 0) both NHWC in memory.
extern "C" int ganlab_upsample_blur_2x(const void* x, void* o, long long n,
                                       int c, int h, int w, float gain,
                                       int nhwc, int dtype, int device,
                                       void* stream) {
  return dispatch(true, x, o, n, c, h, w, gain, nhwc, dtype, device, stream);
}

// The path ganlab_upsample_blur_2x takes for these arguments: 1 = vector,
// 0 = element, -1 = a dtype it does not take. Launches nothing.
extern "C" int ganlab_upsample_blur_2x_path(const void* x, const void* o,
                                            long long n, int c, int h,
                                            int w, int nhwc, int dtype) {
  return path(true, x, o, n, c, h, w, nhwc, dtype);
}

// x (n, c, 2*ho, 2*wo) -> o (n, c, ho, wo) = gain * blur+down(x), both
// NCHW or (nhwc != 0) both NHWC in memory.
extern "C" int ganlab_blur_downsample_2x(const void* x, void* o, long long n,
                                         int c, int ho, int wo, float gain,
                                         int nhwc, int dtype, int device,
                                         void* stream) {
  return dispatch(false, x, o, n, c, ho, wo, gain, nhwc, dtype, device,
                  stream);
}

// The path ganlab_blur_downsample_2x takes for these arguments, as
// ganlab_upsample_blur_2x_path: 1 = vector, 0 = element, -1 = a dtype it
// does not take. Launches nothing.
extern "C" int ganlab_blur_downsample_2x_path(const void* x, const void* o,
                                              long long n, int c, int ho,
                                              int wo, int nhwc, int dtype) {
  return path(false, x, o, n, c, ho, wo, nhwc, dtype);
}
