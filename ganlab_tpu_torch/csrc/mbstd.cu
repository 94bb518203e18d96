// Minibatch standard deviation (whole batch as one group) for Hopper
// (sm_90a), NCHW: x (N, C, H, W) -> o (N, C + 1, H, W), a copy of x with
// one channel appended last that holds, at every pixel of every sample,
//
//     stat = mean over (c, h, w) of sqrt(var over n of x + eps)
//
// with the biased variance taken from deviations (two-pass), float32
// arithmetic, output in x's storage type (float32, bfloat16). Replaces the
// TPU kernel ganlab_tpu/ops/pallas/mbstd.py (minibatch_stddev_pallas ->
// _impl -> _kernel).
//
// Bound: memory by the count of bytes (one read of x, one write of x plus
// the new channel: about 1 MB at the training shape (32, 512, 4, 4) in
// bfloat16, a third of a microsecond at 3.35 TB/s), so in practice launch
// latency: what matters is how many launches and dependent round trips to
// memory one call makes.
//
// What limited the first design (two Triton kernels: per-column partial
// sums into a scratch buffer, then a one-program sum and fill): two
// launches with a dependency between them, a scratch allocation, and
// Triton's Python launcher twice per call on the host.
//
// Design: one launch, no scratch buffer, no atomics. x is an (N, M)
// matrix, M = C*H*W, and o is (N, M + H*W) with the new channel in the last
// H*W columns of each row. One thread block cluster of 8 blocks runs the
// whole call. The columns are cut into chunks (one 16-byte vector of
// adjacent columns on the vector path, one element on the element path),
// strided over all threads of the cluster, so that a warp reads adjacent
// chunks of one row. A thread walks the N rows of its chunk: it copies
// each row's chunk to the output as loaded, sums it, forms the columns'
// means, then the sums of squared deviations, and accumulates
// sqrt(var + eps). With N <= 32 the chunks of all rows stay in registers
// between the two passes, so x is read from memory once; a larger batch
// reads it again (from L2). The per-thread sums go warp shuffle -> block
// (shared memory) -> cluster: every block writes its partial into every
// block's shared memory (distributed shared memory), one cluster barrier,
// and every block adds the partials in rank order, so that all blocks hold
// the same bits and every call gives the same bits. Each block then fills
// its share of the N * H*W elements of the new channel. Remote shared
// memory is written only after a cluster barrier that shows every block
// running and before one that its owner has yet to pass, so no block exits
// under a remote access.
//  * vector path: M and H*W multiples of a 16-byte vector and both
//    pointers 16-byte aligned (then every row of x and o starts aligned);
//  * element path: everything else.
// What a call takes on the device falls with the number of blocks and
// levels off at 8 (1, 2, 4, 8 blocks: 0.022, 0.013, 0.008, 0.007 ms at
// (32, 512, 4, 4) bfloat16 on an H100 80GB HBM3 at 700 W). Dealing the rows
// to more threads, reading the batch twice instead of holding it, and a
// plain grid of 32 one-warp blocks with a "last block done" ticket (a
// counter and partials in device memory, shared by every stream of the
// device) all read 0.007-0.009 ms there, so the design that keeps no state
// beyond the call stays.
// The two paths sum the same columns in another grouping, so they agree to
// rounding (1e-5 of the output scale in float32), not bit for bit.
//
// C interface (loaded with ctypes): launches on `stream` of `device` and
// returns cudaGetLastError() after the launch, 0 on success. dtype 0 =
// float32, 1 = bfloat16.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "vec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxThreads = 256;   // a thread may hold 32 vectors
constexpr int kHeldRows = 32;      // largest batch kept in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// W adjacent columns moved as one Raw: a 16-byte vector or one element.
template <typename T, bool VECTOR>
struct Chunk;

template <typename T>
struct Chunk<T, true> {
  static constexpr int W = Vec<T>::N;
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    Vec<T>::unpack(r, f);
  }
  static __device__ __forceinline__ Raw splat(float v) {
    float f[W];
#pragma unroll
    for (int e = 0; e < W; ++e) f[e] = v;
    return Vec<T>::pack(f);
  }
};

template <typename T>
struct Chunk<T, false> {
  static constexpr int W = 1;
  using Raw = T;
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    f[0] = to_f32(r);
  }
  static __device__ __forceinline__ Raw splat(float v) {
    Raw r;
    from_f32(&r, v);
    return r;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFullMask, v, d);
  return v;
}

// The sum of v over the block, in every thread; `scratch` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < ((blockDim.x + 31) >> 5) ? scratch[lane] : 0.0f;
  return warp_sum(v);
}

// The two halves of a cluster barrier: every thread of the cluster arrives
// once and waits once.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The sum over this thread's chunks of sqrt(var + eps), with every row of
// those chunks copied to o. The chunks `first`, `first + all`, ... < cols
// are this thread's; `orow` = chunks in a row of o. HELD: n <= kHeldRows and
// the rows of a chunk stay in registers between the two passes.
template <typename T, bool VECTOR, bool HELD>
__device__ __forceinline__ float walk_columns(
    const typename Chunk<T, VECTOR>::Raw* __restrict__ xv,
    typename Chunk<T, VECTOR>::Raw* __restrict__ ov, int n, long long cols,
    long long orow, long long first, long long all, float eps) {
  using C = Chunk<T, VECTOR>;
  using Raw = typename C::Raw;
  constexpr int W = C::W;
  const float n_f = static_cast<float>(n);
  float acc = 0.0f;
  for (long long j = first; j < cols; j += all) {
    float sum[W], sq[W], mean[W];
#pragma unroll
    for (int e = 0; e < W; ++e) sum[e] = sq[e] = 0.0f;
    if constexpr (HELD) {
      Raw held[kHeldRows];
#pragma unroll
      for (int r = 0; r < kHeldRows; ++r)
        if (r < n) held[r] = xv[r * cols + j];
#pragma unroll
      for (int r = 0; r < kHeldRows; ++r) {
        if (r < n) {
          ov[r * orow + j] = held[r];
          float f[W];
          C::unpack(held[r], f);
#pragma unroll
          for (int e = 0; e < W; ++e) sum[e] += f[e];
        }
      }
#pragma unroll
      for (int e = 0; e < W; ++e) mean[e] = sum[e] / n_f;
#pragma unroll
      for (int r = 0; r < kHeldRows; ++r) {
        if (r < n) {
          float f[W];
          C::unpack(held[r], f);
#pragma unroll
          for (int e = 0; e < W; ++e) {
            const float d = f[e] - mean[e];
            sq[e] = __fmaf_rn(d, d, sq[e]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        const Raw v = xv[r * cols + j];
        ov[r * orow + j] = v;
        float f[W];
        C::unpack(v, f);
#pragma unroll
        for (int e = 0; e < W; ++e) sum[e] += f[e];
      }
#pragma unroll
      for (int e = 0; e < W; ++e) mean[e] = sum[e] / n_f;
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        float f[W];
        C::unpack(xv[r * cols + j], f);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float d = f[e] - mean[e];
          sq[e] = __fmaf_rn(d, d, sq[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) acc += sqrtf(sq[e] / n_f + eps);
  }
  return acc;
}

// One cluster of gridDim.x blocks. `cols` = M / W chunks in a row of x,
// `hwc` = H*W / W chunks of the new channel in a row of o.
template <typename T, bool VECTOR, bool HELD>
__global__ void __launch_bounds__(kMaxThreads)
mbstd_kernel(const T* __restrict__ x, T* __restrict__ o, int n,
             long long cols, int hwc, float m_f, float eps) {
  using C = Chunk<T, VECTOR>;
  using Raw = typename C::Raw;
  __shared__ float scratch[32];
  __shared__ float partial[kMaxCluster];

  cluster_arrive();  // waited for below, before the first remote write
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long all = static_cast<long long>(ranks) * blockDim.x;
  const long long first =
      static_cast<long long>(rank) * blockDim.x + threadIdx.x;
  const long long orow = cols + hwc;
  Raw* ov = reinterpret_cast<Raw*>(o);

  float acc = walk_columns<T, VECTOR, HELD>(
      reinterpret_cast<const Raw*>(x), ov, n, cols, orow, first, all, eps);
  acc = block_sum(acc, scratch);
  cluster_wait();  // every block of the cluster is running
  if (threadIdx.x < ranks)
    cluster.map_shared_rank(&partial[0], threadIdx.x)[rank] = acc;
  cluster.sync();
  float total = 0.0f;
  for (int r = 0; r < ranks; ++r) total += partial[r];
  const Raw fill = C::splat(total / m_f);
  const long long cells = static_cast<long long>(n) * hwc;
  for (long long i = first; i < cells; i += all) {
    const long long r = i / hwc;
    ov[r * orow + cols + (i - r * hwc)] = fill;
  }
}

// How a call is cut.
struct Plan {
  bool vector;
  bool held;
  int cluster;    // blocks (one cluster)
  int threads;    // per block
  long long cols;
  int hwc;
};

Plan make_plan(const void* x, const void* o, int n, long long m, int hw,
               int itemsize, int cluster) {
  Plan p{};
  const int per = 16 / itemsize;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) % 16 ==
      0;
  p.vector = aligned && m % per == 0 && hw % per == 0;
  const int w = p.vector ? per : 1;
  p.held = n <= kHeldRows;
  p.cols = m / w;
  p.hwc = hw / w;
  p.cluster = cluster == 0 ? kMaxCluster : cluster;
  // one chunk a thread where the cluster is wide enough for that
  long long t = (p.cols + p.cluster - 1) / p.cluster;
  t = (t + 31) / 32 * 32;
  p.threads = static_cast<int>(t < 32 ? 32 : t > kMaxThreads ? kMaxThreads : t);
  return p;
}

template <typename T, bool VECTOR, bool HELD>
void run(const Plan& p, const void* x, void* o, int n, float m_f, float eps,
         cudaStream_t s) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.cluster);
  config.blockDim = dim3(p.threads);
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaLaunchKernelEx(&config, mbstd_kernel<T, VECTOR, HELD>,
                     static_cast<const T*>(x), static_cast<T*>(o), n, p.cols,
                     p.hwc, m_f, eps);
}

template <typename T>
int launch(const void* x, void* o, int n, long long m, int hw, float eps,
           int cluster, cudaStream_t s) {
  const Plan p = make_plan(x, o, n, m, hw, sizeof(T), cluster);
  const float m_f = static_cast<float>(m);
  auto fn = p.vector ? (p.held ? run<T, true, true> : run<T, true, false>)
                     : (p.held ? run<T, false, true> : run<T, false, false>);
  fn(p, x, o, n, m_f, eps, s);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int n, long long m, int hw, int dtype, int cluster) {
  return n > 0 && m > 0 && hw > 0 && m % hw == 0 && dtype >= 0 &&
         dtype <= 1 &&
         (cluster == 0 || cluster == 1 || cluster == 2 || cluster == 4 ||
          cluster == 8);
}

}  // namespace

// x: (n, m) contiguous, o: (n, m + hw) contiguous, m = C*H*W, hw = H*W,
// dtype `dtype`. `cluster` is 0 (the kernel's choice: 8) or the number of
// blocks to run the call with (1, 2, 4, 8), for measurements.
extern "C" int ganlab_mbstd(const void* x, void* o, int n, long long m,
                            int hw, float eps, int dtype, int cluster,
                            int device, void* stream) {
  if (!valid(n, m, hw, dtype, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch<float>(x, o, n, m, hw, eps, cluster, s)
             : launch<__nv_bfloat16>(x, o, n, m, hw, eps, cluster, s);
}

// What ganlab_mbstd does with these arguments, packed into one int:
// (1 = vector path, 0 = element path) + 2 * (rows held in registers)
// + 4 * threads a block; -1 = refused. Launches nothing.
extern "C" int ganlab_mbstd_path(const void* x, const void* o, int n,
                                 long long m, int hw, int dtype) {
  if (!valid(n, m, hw, dtype, 0)) return -1;
  const Plan p = make_plan(x, o, n, m, hw, dtype == 0 ? 4 : 2, 0);
  return (p.vector ? 1 : 0) + (p.held ? 2 : 0) + 4 * p.threads;
}
