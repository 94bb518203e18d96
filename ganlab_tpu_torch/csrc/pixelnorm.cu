// PixelNorm for Hopper (sm_90a), over the last axis of (rows, C) and (the
// second kernel, below) over the channel axis of NCHW:
//
//     out = x * rsqrt(mean(x^2, C) + eps)
//
// float32 arithmetic, output in x's storage type (float32, bfloat16,
// float16). Replaces the TPU kernel ganlab_tpu/ops/pallas/pixelnorm.py
// (pixel_norm_pallas -> _rows_call -> _fwd_kernel) at both its call
// sites: z (rows) and the ProGAN generator's feature maps (which the TPU
// kernel saw as the (N*H*W, C) rows of NHWC).
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

// ---------------------------------------------------------------------------
// PixelNorm over the channel axis of NCHW: for each image n and pixel p,
//
//     out[n, :, p] = x[n, :, p] * rsqrt(mean_c x[n, c, p]^2 + eps)
//
// The ProGAN generator's feature maps (N, C, H, W), where the channel
// axis is strided by H*W. The TPU kernel flattened NHWC to (N*H*W, C) rows
// (_rows_call); here the planes stay where they are and nothing is
// permuted.
//
// Bound: memory, one read and one write of N*C*H*W elements at about 3
// flops each. At progan-128's 128x128 block, (8, 128, 128, 128) bf16 is
// 33.6 MB each way: about 0.020 ms at 3.35 TB/s. The 4x4 and 8x8 blocks
// move tens of kilobytes: there the host's time to make the launch is
// what a caller waits for.
//
// What limited the first design (the run kernel below, now kept for the
// shapes the tile kernel does not take): R lanes of a warp shared a "run"
// of 16 bytes of pixels and held its C planes in registers, so at C >= 256
// (R = 32) one load instruction of a warp fetched 16 bytes from each of 32
// planes, half a 32-byte sector of each, and the other half came with
// another warp's request later. It ran at 2.2-2.5x its bound there and
// 1.5x at C = 128, where one warp covers two adjacent runs (PERF.md,
// section 6); blocks of 8 or 16 warps were no faster.
//
// Design (the tile kernel): a block of kTileThreads threads takes a tile
// of one image, kTileBytes (128) of each of its C planes, and stages it
// through shared memory with 16-byte cp.async: eight neighbouring threads read one plane's 128 bytes, a
// whole line, so every request is a full line of one plane. Then warp w
// takes the 16-byte pixel vectors w, w + 8, ... of the tile and, as the
// run kernel did, lane l sums the squares of the channel groups l, l + 32,
// ... from shared memory, the butterfly gives the per-pixel sums, and lane
// 0 puts the scales into shared memory. Last the threads take the tile
// in the load's order again, scale each vector and write it, a full line
// of a plane per eight threads. Vector (plane r, column q) sits at column q ^ ((r / NC)
// & 7) of row r, so the eight lanes of a quarter warp, which read eight
// channel groups of one column, hit eight different bank groups. The
// registers hold nothing of the tile: a C of 1000 takes 125 KB of shared
// memory and no second read. It needs vector pixels (H*W * itemsize a
// multiple of 16, both pointers 16-byte aligned), at least one tile of
// pixels a plane and C * tile bytes within kTileSmemMax; the run kernel
// takes the rest (4x4 planes, odd H*W, unaligned pointers, C above 1500).
// Tiles of 64 bytes (half lines) were slower at every ProGAN shape, 512
// no faster, 256 faster at (16, 256, 64, 64) alone and slower at the other
// three, and a grid of resident blocks that loaded the next tile while it
// wrote the current one (two tiles of shared memory) slower than one tile
// a block (PERF.md, section 6).
//
// The order of the sums is the rows kernel's, in both kernels: lane l of a
// pixel sums the channel groups i = l, l + 32, ... of NC channels each, in
// order (NC = the rows kernel's vector: 16 bytes when C * itemsize is a
// multiple of 16, else one channel), then the butterfly over the lanes.
// The tile kernel always reduces over 32 lanes, as the rows kernel does;
// the run kernel takes R, the smallest power of two >= min(groups, 32),
// and the rows kernel's butterfly steps above R add zeros, which change no
// bit. So on the same values the kernels give the same bits (chip_smoke.py
// checks it).
constexpr int kNchwWarps = 4;      // run kernel: warps per block
constexpr int kNchwCached = 16;    // run kernel: plane vectors a lane keeps
constexpr int kTileThreads = 256;  // tile kernel: threads per block
constexpr int kTileBytes = 128;    // tile kernel: bytes of each plane
constexpr int kTileQ = kTileBytes / 16;   // its 16-byte vectors a plane
constexpr int kTileSmemMax = 192 * 1024;  // tile kernel: the largest tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Tile kernel. NC: channels a group sums in order (see above). gridDim.x
// = images * tiles_per_image; H*W is a multiple of V = 16 / sizeof(T).
template <typename T, int NC>
__global__ void __launch_bounds__(kTileThreads)
pixel_norm_nchw_tile_kernel(const T* __restrict__ x, T* __restrict__ o,
                            long long tiles_per_image, long long hw, int c,
                            float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int QP = kTileQ;
  using Ch = Chunk<T, V>;
  static_assert(kTileThreads % QP == 0, "a thread keeps its column");
  extern __shared__ uint4 tile[];            // c rows of QP vectors
  __shared__ float scale[QP * V];
  const long long img = blockIdx.x / tiles_per_image;
  const long long p0 = (blockIdx.x - img * tiles_per_image) * (QP * V);
  const int nq = static_cast<int>(min(static_cast<long long>(QP),
                                      (hw - p0) / V));
  const long long base = img * c * hw + p0;
  // where vector (plane r, column q) sits in the tile
  const auto at = [](int r, int q) {
    return r * QP + (q ^ ((r / NC) & (QP - 1)));
  };

  // 1. the tile, a line of a plane per QP threads (q fixed per thread)
  const int q_own = threadIdx.x % QP;
  if (q_own < nq) {
    for (int r = threadIdx.x / QP; r < c; r += kTileThreads / QP) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(&tile[at(r, q_own)])),
                   "l"(x + base + static_cast<long long>(r) * hw +
                       q_own * V)
                   : "memory");
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2. per-pixel sums of squares in the rows kernel's order
  const int lane = threadIdx.x & 31;
  const int groups = c / NC;
  float f[V];
  for (int q = threadIdx.x >> 5; q < nq; q += kTileThreads / 32) {
    float ss[V];
#pragma unroll
    for (int w = 0; w < V; ++w) ss[w] = 0.0f;
    for (int i = lane; i < groups; i += 32) {
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        Ch::unpack(tile[at(NC * i + e, q)], f);
#pragma unroll
        for (int w = 0; w < V; ++w) ss[w] += f[w] * f[w];
      }
    }
#pragma unroll
    for (int w = 0; w < V; ++w) {
      const float s = warp_sum(ss[w]);
      if (lane == 0) scale[q * V + w] = rsqrtf(s / static_cast<float>(c) + eps);
    }
  }
  __syncthreads();

  // 3. scale and write, in the load's order
  if (q_own >= nq) return;
  float sc[V];
#pragma unroll
  for (int w = 0; w < V; ++w) sc[w] = scale[q_own * V + w];
  for (int r = threadIdx.x / QP; r < c; r += kTileThreads / QP) {
    Ch::unpack(tile[at(r, q_own)], f);
#pragma unroll
    for (int w = 0; w < V; ++w) f[w] *= sc[w];
    *reinterpret_cast<uint4*>(o + base + static_cast<long long>(r) * hw +
                              q_own * V) = Ch::pack(f);
  }
}

// Run kernel: R lanes of a warp own a run of W pixels (16 bytes of each
// plane, or one pixel on the element path) and split its C planes between
// them, each keeping up to kNchwCached of its vectors in registers (above
// that it reads its planes a second time, from L1/L2); the sums are
// reduced across the R lanes by __shfl_xor_sync.
template <typename T, int W, int NC, bool CACHED>
__global__ void __launch_bounds__(32 * kNchwWarps)
pixel_norm_nchw_kernel(const T* __restrict__ x, T* __restrict__ o,
                       long long runs, long long runs_per_image,
                       long long hw, int c, int groups, int r_log2,
                       float eps) {
  using Ch = Chunk<T, W>;
  using Raw = typename Ch::Raw;
  constexpr int K = CACHED ? kNchwCached / NC : 1;   // groups a lane caches
  const int lane = threadIdx.x & 31;
  const int lr = lane & ((1 << r_log2) - 1);         // lane within the run
  const long long run =
      ((static_cast<long long>(blockIdx.x) * kNchwWarps +
        (threadIdx.x >> 5))
       << (5 - r_log2)) + (lane >> r_log2);
  long long img = 0, p0 = 0;
  if (run < runs) {
    img = run / runs_per_image;
    p0 = (run - img * runs_per_image) * W;
  }
  // the whole run lies in its image (W divides H*W on the vector path)
  const bool in = run < runs && p0 < hw;
  const long long base = img * c * hw + p0;

  float ss[W];
  float f[W];
#pragma unroll
  for (int w = 0; w < W; ++w) ss[w] = 0.0f;
  Raw v[K][NC];
  if constexpr (CACHED) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lr + 32 * k;
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        if (in && i < groups) {
          v[k][e] = *reinterpret_cast<const Raw*>(
              x + base + static_cast<long long>(NC * i + e) * hw);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (in && lr + 32 * k < groups) {
#pragma unroll
        for (int e = 0; e < NC; ++e) {
          Ch::unpack(v[k][e], f);
#pragma unroll
          for (int w = 0; w < W; ++w) ss[w] += f[w] * f[w];
        }
      }
    }
  } else {
    for (int i = lr; in && i < groups; i += 32) {
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        Ch::unpack(*reinterpret_cast<const Raw*>(
                       x + base + static_cast<long long>(NC * i + e) * hw),
                   f);
#pragma unroll
        for (int w = 0; w < W; ++w) ss[w] += f[w] * f[w];
      }
    }
  }
  // every lane takes part in the shuffles, also one without a run
  float scale[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    float s = ss[w];
    for (int d = (1 << r_log2) >> 1; d > 0; d >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, d);
    scale[w] = rsqrtf(s / static_cast<float>(c) + eps);
  }
  if (!in) return;
  if constexpr (CACHED) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = lr + 32 * k;
      if (i < groups) {
#pragma unroll
        for (int e = 0; e < NC; ++e) {
          Ch::unpack(v[k][e], f);
#pragma unroll
          for (int w = 0; w < W; ++w) f[w] *= scale[w];
          *reinterpret_cast<Raw*>(
              o + base + static_cast<long long>(NC * i + e) * hw) =
              Ch::pack(f);
        }
      }
    }
  } else {
    for (int i = lr; i < groups; i += 32) {
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        const long long off = base + static_cast<long long>(NC * i + e) * hw;
        Ch::unpack(*reinterpret_cast<const Raw*>(x + off), f);
#pragma unroll
        for (int w = 0; w < W; ++w) f[w] *= scale[w];
        *reinterpret_cast<Raw*>(o + off) = Ch::pack(f);
      }
    }
  }
}

// How a call is cut, as chosen by nchw_plan: the tile kernel's bytes of
// each plane (0: the run kernel), the pixel vector (W > 1), the channel
// grouping of the rows kernel (NC > 1), and for the run kernel the planes
// kept in registers and R = 1 << r_log2 lanes a run.
struct NchwPlan {
  bool ok, pix_vec, chan_vec, cached;
  int r_log2, tile;
};

// tile: 0 chooses (the tile kernel where it takes the call, else the run
// kernel); -1 asks for the run kernel; anything else is refused (ok =
// false).
template <typename T>
NchwPlan nchw_plan(const void* x, const void* o, int c, long long hw,
                   int tile) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t both =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o);
  NchwPlan p;
  p.pix_vec = (hw * static_cast<long long>(sizeof(T))) % 16 == 0 &&
              both % 16 == 0;
  p.chan_vec = (static_cast<size_t>(c) * sizeof(T)) % 16 == 0;
  const int nc = p.chan_vec ? V : 1;
  const int groups = c / nc;
  p.cached = groups <= 32 * (kNchwCached / nc);
  p.r_log2 = 0;
  while ((1 << p.r_log2) < groups && p.r_log2 < 5) ++p.r_log2;
  const bool takes =
      p.pix_vec && static_cast<long long>(c) * kTileBytes <= kTileSmemMax &&
      hw * static_cast<long long>(sizeof(T)) >= kTileBytes;
  p.ok = tile == 0 || tile == -1;
  p.tile = tile == 0 && takes ? kTileBytes : 0;
  return p;
}

template <typename T, int NC>
cudaError_t run_tile(const void* x, void* o, long long n, int c, long long hw,
                     float eps, int device, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  constexpr int QP = kTileQ;
  auto kernel = pixel_norm_nchw_tile_kernel<T, NC>;
  static bool raised[64] = {};      // the shared-memory limit, per device
  if (!raised[device & 63]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmemMax);
    if (err != cudaSuccess) return err;
    raised[device & 63] = true;
  }
  const long long per_image = (hw + QP * V - 1) / (QP * V);
  kernel<<<static_cast<unsigned>(n * per_image), kTileThreads,
           static_cast<size_t>(c) * QP * 16, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(o), per_image, hw, c, eps);
  return cudaSuccess;
}

template <typename T, int W, int NC, bool CACHED>
void run_nchw(const void* x, void* o, long long n, int c, long long hw,
              int r_log2, float eps, cudaStream_t stream) {
  const long long per_image = (hw + W - 1) / W;
  const long long runs = n * per_image;
  const long long per_block = static_cast<long long>(kNchwWarps)
                              << (5 - r_log2);
  const unsigned blocks =
      static_cast<unsigned>((runs + per_block - 1) / per_block);
  pixel_norm_nchw_kernel<T, W, NC, CACHED><<<blocks, 32 * kNchwWarps, 0,
                                              stream>>>(
      static_cast<const T*>(x), static_cast<T*>(o), runs, per_image, hw, c,
      c / NC, r_log2, eps);
}

template <typename T, int W, int NC>
void run_nchw(const NchwPlan& p, const void* x, void* o, long long n, int c,
              long long hw, float eps, cudaStream_t stream) {
  if (p.cached) {
    run_nchw<T, W, NC, true>(x, o, n, c, hw, p.r_log2, eps, stream);
  } else {
    run_nchw<T, W, NC, false>(x, o, n, c, hw, p.r_log2, eps, stream);
  }
}

template <typename T>
int launch_nchw(const void* x, void* o, long long n, int c, long long hw,
                float eps, int tile, int device, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const NchwPlan p = nchw_plan<T>(x, o, c, hw, tile);
  cudaError_t err = cudaSuccess;
  if (!p.ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (p.tile && p.chan_vec) {
    err = run_tile<T, V>(x, o, n, c, hw, eps, device, stream);
  } else if (p.tile) {
    err = run_tile<T, 1>(x, o, n, c, hw, eps, device, stream);
  } else if (p.pix_vec && p.chan_vec) {
    run_nchw<T, V, V>(p, x, o, n, c, hw, eps, stream);
  } else if (p.pix_vec) {
    run_nchw<T, V, 1>(p, x, o, n, c, hw, eps, stream);
  } else if (p.chan_vec) {
    run_nchw<T, 1, V>(p, x, o, n, c, hw, eps, stream);
  } else {
    run_nchw<T, 1, 1>(p, x, o, n, c, hw, eps, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
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

// x, o: (n, c, hw) contiguous (NCHW with hw = H * W), the same dtype;
// normalizes over c for each (image, pixel). tile: 0 (the plan's choice)
// or -1 (the run kernel, to measure the one against the other); any other
// value returns cudaErrorInvalidValue.
extern "C" int ganlab_pixel_norm_nchw(const void* x, void* o, long long n,
                                      int c, long long hw, float eps,
                                      int dtype, int tile, int device,
                                      void* stream) {
  if (n <= 0 || c <= 0 || hw <= 0 || n * hw > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_nchw<float>(x, o, n, c, hw, eps, tile, device, s);
    case 1:
      return launch_nchw<__nv_bfloat16>(x, o, n, c, hw, eps, tile, device, s);
    case 2: return launch_nchw<__half>(x, o, n, c, hw, eps, tile, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan ganlab_pixel_norm_nchw takes for these pointers, sizes and
// `tile`: bit 0 pixel vector, bit 1 channel vector, bit 2 cached, bits 3-5
// the log2 of the lanes a run (run kernel), bits 6-14 the tile kernel's
// bytes of each plane (0: the run kernel); -1 for an unknown dtype or a
// request the kernels cannot take.
extern "C" int ganlab_pixel_norm_nchw_plan(const void* x, const void* o,
                                           int c, long long hw, int dtype,
                                           int tile) {
  NchwPlan p;
  switch (dtype) {
    case 0: p = nchw_plan<float>(x, o, c, hw, tile); break;
    case 1: p = nchw_plan<__nv_bfloat16>(x, o, c, hw, tile); break;
    case 2: p = nchw_plan<__half>(x, o, c, hw, tile); break;
    default: return -1;
  }
  if (!p.ok) return -1;
  return (p.pix_vec ? 1 : 0) | (p.chan_vec ? 2 : 0) | (p.cached ? 4 : 0) |
         (p.r_log2 << 3) | (p.tile << 6);
}
