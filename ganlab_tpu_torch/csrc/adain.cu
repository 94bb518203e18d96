// AdaIN for Hopper (sm_90a), NCHW: per (n, c) plane of H*W elements
//
//     mean = sum(x) / HW,  var = sum((x - mean)^2) / HW   (two passes)
//     y = (x - mean) * rsqrt(var + eps) * s[n, c] + b[n, c]
//
// float32 arithmetic, output in x's storage type (float32, bfloat16,
// float16). Replaces the TPU kernel ganlab_tpu/ops/pallas/adain.py
// (adain_pallas -> _impl -> _kernel).
//
// Bound: memory. One read and one write of x plus the (N, C) styles, a
// handful of flops per element, so the least time is those bytes over
// 3.35 TB/s.
//
// What limited the first design (a Triton program per plane that looped
// over it three times: sum, squared deviations, write): each pass waited
// for the reduction before it, the second and third reads went through L2,
// and a program held nothing of the plane between passes; and Triton's
// Python launcher cost the host more per call than the small planes cost
// the device.
//
// Design: a plane is one contiguous run of memory. It is loaded once, with
// 16-byte loads that are all in flight before the first use, and stays in
// registers, packed as loaded, through both reductions and the write. The
// variance is two-pass from those registers: at StyleGAN's init the 4x4
// planes are constant, and E[x^2] - mean^2 would leave cancellation noise
// for rsqrt(eps) = 1e4 to multiply. Who holds a plane depends on its size
// (vectors = HW / (16 / itemsize)):
//  * warp path, up to 256 vectors (4x4 .. 32x32): a group of 1 to 32 lanes
//    per plane, so a warp takes 32 planes of 4x4 or one of 32x32, up to 8
//    vectors a lane; reductions by __shfl_xor_sync inside the group, no
//    shared memory;
//  * block path (64x64, 128x128, 256x256 in 16-bit types): one block per
//    plane, up to 8 vectors a thread; a reduction is a warp shuffle, one
//    value per warp through shared memory, one __syncthreads;
//  * cluster path, planes too large for one block's registers (256x256
//    float32) or where it measured faster: a thread block cluster per
//    plane, each block holding a contiguous slice in registers. A block
//    writes its partial sum into every block's shared memory (distributed
//    shared memory), one cluster.sync(), and each block adds the partials
//    in rank order, so all blocks of a cluster get the same bits. Remote
//    shared memory is only ever written before a cluster.sync() that the
//    owner has yet to pass, so no block exits under a remote access;
//  * loop path, everything else (HW * itemsize no multiple of 16, pointers
//    not 16-byte aligned, planes above 65536 vectors): one block per plane
//    loops over it three times, one element per load.
// The order of the sums differs between the paths and from the plain
// version, so the paths agree to rounding (1e-5 of the output scale in
// float32), not bit for bit.
//
// C interface (loaded with ctypes): launches on `stream` of `device` and
// returns cudaGetLastError() after the launch, 0 on success. dtype 0 =
// float32, 1 = bfloat16, 2 = float16, for x/o and for each style tensor.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"
#include "vec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpPathThreads = 128;    // 4 warps a block on the warp path
constexpr int kWarpPathVectors = 256;    // largest plane of the warp path
constexpr int kMaxK = 8;                 // vectors a thread keeps
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int kLoopThreads = 256;

enum Path { kLoop = 0, kWarp = 1, kBlock = 2, kCluster = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_f32(__half* p, float v) {
  *p = __float2half_rn(v);
}

// One style value; `code` is the style tensor's dtype.
__device__ __forceinline__ float load_style(const void* p, long long i,
                                            int code) {
  switch (code) {
    case 0: return static_cast<const float*>(p)[i];
    case 1: return to_f32(static_cast<const __nv_bfloat16*>(p)[i]);
    default: return to_f32(static_cast<const __half*>(p)[i]);
  }
}

struct Styles {
  const void* scale;
  const void* bias;
  int scale_code, bias_code;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFullMask, v, d);
  return v;
}

// The sum of v over the block, in every thread. `scratch` holds 32 floats
// and is not reused before the next __syncthreads.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < ((blockDim.x + 31) >> 5) ? scratch[lane] : 0.0f;
  return warp_sum(v);
}

// K vectors of a plane held by one thread, packed as loaded: vector
// first + k * stride for k < K, those below `n` only.
template <typename T, int K>
struct Held {
  static constexpr int N = Vec<T>::N;
  uint4 v[K];
  bool has[K];

  __device__ __forceinline__ void load(const uint4* p, int first, int stride,
                                       int n) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = first + k * stride;
      has[k] = i < n;
      if (has[k]) v[k] = __ldg(p + i);
    }
  }
  __device__ __forceinline__ float sum() const {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (has[k]) {
        float f[N];
        Vec<T>::unpack(v[k], f);
#pragma unroll
        for (int e = 0; e < N; ++e) t += f[e];
      }
    }
    return t;
  }
  __device__ __forceinline__ float sum_sq_dev(float mean) const {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (has[k]) {
        float f[N];
        Vec<T>::unpack(v[k], f);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float d = f[e] - mean;
          t = __fmaf_rn(d, d, t);
        }
      }
    }
    return t;
  }
  // y = (x - mean) * a + b
  __device__ __forceinline__ void store(uint4* p, int first, int stride,
                                        float mean, float a, float b) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (has[k]) {
        float f[N];
        Vec<T>::unpack(v[k], f);
#pragma unroll
        for (int e = 0; e < N; ++e) f[e] = __fmaf_rn(f[e] - mean, a, b);
        p[first + k * stride] = Vec<T>::pack(f);
      }
    }
  }
};

// Warp path: groups of `1 << log2_lanes` lanes hold one plane of nvec
// vectors each (nvec <= K << log2_lanes). Every lane reaches the shuffles.
template <typename T, int K>
__global__ void __launch_bounds__(kWarpPathThreads)
adain_warp_kernel(const T* __restrict__ x, T* __restrict__ o, Styles st,
                  long long planes, int nvec, int log2_lanes, float hw_f,
                  float eps) {
  const int lanes = 1 << log2_lanes;
  const int lane = threadIdx.x & 31;
  const int l = lane & (lanes - 1);
  const long long warp =
      static_cast<long long>(blockIdx.x) * (kWarpPathThreads / 32) +
      (threadIdx.x >> 5);
  const long long plane = (warp << (5 - log2_lanes)) + (lane >> log2_lanes);
  const bool active = plane < planes;
  const long long base = active ? plane * nvec : 0;

  Held<T, K> held;
  held.load(reinterpret_cast<const uint4*>(x) + base, l, lanes,
            active ? nvec : 0);
  float sum = held.sum();
  for (int d = lanes >> 1; d > 0; d >>= 1)
    sum += __shfl_xor_sync(kFullMask, sum, d);
  const float mean = sum / hw_f;
  float sq = held.sum_sq_dev(mean);
  for (int d = lanes >> 1; d > 0; d >>= 1)
    sq += __shfl_xor_sync(kFullMask, sq, d);
  if (!active) return;
  const float a = rsqrtf(sq / hw_f + eps) *
                  load_style(st.scale, plane, st.scale_code);
  const float b = load_style(st.bias, plane, st.bias_code);
  held.store(reinterpret_cast<uint4*>(o) + base, l, lanes, mean, a, b);
}

// Block and cluster paths: gridDim.x = planes * C blocks, C = 1 or the
// cluster size; block `rank` of a plane holds vectors
// [rank * slice, min((rank + 1) * slice, nvec)), thread t of it vectors
// t, t + blockDim.x, ... of that slice (slice <= K * blockDim.x).
template <typename T, int K, bool CLUSTERED>
__global__ void adain_block_kernel(const T* __restrict__ x, T* __restrict__ o,
                                   Styles st, int nvec, int slice,
                                   float hw_f, float eps) {
  __shared__ float scratch[2][32];
  __shared__ float partial[2][kMaxCluster];
  int ranks = 1, rank = 0;
  if constexpr (CLUSTERED) {
    cg::cluster_group cluster = cg::this_cluster();
    ranks = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
  }
  const long long plane = blockIdx.x / ranks;
  const int first = rank * slice;
  const int n = min(slice, nvec - first);
  const long long base = plane * nvec + first;

  Held<T, K> held;
  held.load(reinterpret_cast<const uint4*>(x) + base, threadIdx.x, blockDim.x,
            n);
  // every block of the cluster runs before any writes into its shared
  // memory; the loads above are already in flight
  if constexpr (CLUSTERED) cg::this_cluster().sync();

  // the block's sum, then the plane's: the same bits in every block
  auto plane_sum = [&](float v, int which) {
    v = block_sum(v, scratch[which]);
    if constexpr (CLUSTERED) {
      cg::cluster_group cluster = cg::this_cluster();
      if (threadIdx.x < ranks)
        cluster.map_shared_rank(&partial[which][0], threadIdx.x)[rank] = v;
      cluster.sync();
      v = 0.0f;
      for (int r = 0; r < ranks; ++r) v += partial[which][r];
    }
    return v;
  };
  const float mean = plane_sum(held.sum(), 0) / hw_f;
  const float var = plane_sum(held.sum_sq_dev(mean), 1) / hw_f;
  const float a =
      rsqrtf(var + eps) * load_style(st.scale, plane, st.scale_code);
  const float b = load_style(st.bias, plane, st.bias_code);
  held.store(reinterpret_cast<uint4*>(o) + base, threadIdx.x, blockDim.x,
             mean, a, b);
}

// Loop path: one block per plane, three loops, one element per load.
template <typename T>
__global__ void __launch_bounds__(kLoopThreads)
adain_loop_kernel(const T* __restrict__ x, T* __restrict__ o, Styles st,
                  long long hw, float hw_f, float eps) {
  __shared__ float scratch[2][32];
  const long long plane = blockIdx.x;
  const T* xp = x + plane * hw;
  T* op = o + plane * hw;
  float t = 0.0f;
  for (long long i = threadIdx.x; i < hw; i += kLoopThreads)
    t += to_f32(xp[i]);
  const float mean = block_sum(t, scratch[0]) / hw_f;
  t = 0.0f;
  for (long long i = threadIdx.x; i < hw; i += kLoopThreads) {
    const float d = to_f32(xp[i]) - mean;
    t = __fmaf_rn(d, d, t);
  }
  const float var = block_sum(t, scratch[1]) / hw_f;
  const float a =
      rsqrtf(var + eps) * load_style(st.scale, plane, st.scale_code);
  const float b = load_style(st.bias, plane, st.bias_code);
  for (long long i = threadIdx.x; i < hw; i += kLoopThreads)
    from_f32(op + i, __fmaf_rn(to_f32(xp[i]) - mean, a, b));
}

// How a call is cut into threads.
struct Plan {
  Path path;
  int nvec;      // vectors per plane
  int k;         // vectors a thread keeps: 1, 2, 4 or 8
  int threads;   // block path: threads per block; warp path: lanes per plane
  int cluster;   // blocks per plane
  int slice;     // vectors per block
};

int round_up_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// `threads` and `cluster` are 0 (chosen here) or what the caller wants for
// the block / cluster paths; a request that cannot hold the plane gives
// path = kLoop with k = 0, which the launch refuses.
Plan make_plan(const void* x, const void* o, long long hw, int itemsize,
               int threads, int cluster) {
  Plan p{kLoop, 0, 0, 0, 1, 0};
  const int per = 16 / itemsize;
  const bool forced = threads != 0 || cluster != 0;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) % 16 ==
      0;
  const long long most =
      static_cast<long long>(kMaxCluster) * kMaxThreads * kMaxK;
  if (hw % per != 0 || !aligned || hw / per > most) {
    p.k = forced ? 0 : 1;
    return p;
  }
  p.nvec = static_cast<int>(hw / per);
  if (!forced && p.nvec <= kWarpPathVectors) {
    p.path = kWarp;
    p.threads = p.nvec < 32 ? round_up_pow2(p.nvec) : 32;
    p.k = round_up_pow2((p.nvec + p.threads - 1) / p.threads);
    return p;
  }
  if (cluster == 0) {
    // the fewest blocks whose registers hold the plane
    cluster = round_up_pow2(
        (p.nvec + kMaxThreads * kMaxK - 1) / (kMaxThreads * kMaxK));
  }
  p.cluster = cluster;
  p.slice = (p.nvec + cluster - 1) / cluster;
  if (threads == 0) {
    // 4 vectors a thread where that fills a block of 256 to 1024 threads
    threads = round_up_pow2((p.slice + 3) / 4);
    threads = threads < 64 ? 64 : threads > kMaxThreads ? kMaxThreads : threads;
  }
  p.threads = threads;
  const int k = round_up_pow2((p.slice + threads - 1) / threads);
  const bool ok = (cluster == 1 || cluster == 2 || cluster == 4 ||
                   cluster == 8) &&
                  threads % 32 == 0 && threads >= 32 &&
                  threads <= kMaxThreads && k <= kMaxK;
  if (!ok) return p;  // k = 0: refused
  p.k = k;
  p.path = cluster > 1 ? kCluster : kBlock;
  return p;
}

template <typename T, int K>
void run_warp(const Plan& p, const void* x, void* o, const Styles& st,
              long long planes, float hw_f, float eps, cudaStream_t s) {
  int log2_lanes = 0;
  while ((1 << log2_lanes) < p.threads) ++log2_lanes;
  const long long per_block =
      static_cast<long long>(kWarpPathThreads / 32) * (32 >> log2_lanes);
  const unsigned blocks =
      static_cast<unsigned>((planes + per_block - 1) / per_block);
  adain_warp_kernel<T, K><<<blocks, kWarpPathThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(o), st, planes, p.nvec,
      log2_lanes, hw_f, eps);
}

template <typename T, int K>
void run_block(const Plan& p, const void* x, void* o, const Styles& st,
               long long planes, float hw_f, float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(o);
  if (p.cluster == 1) {
    adain_block_kernel<T, K, false>
        <<<static_cast<unsigned>(planes), p.threads, 0, s>>>(
            xt, ot, st, p.nvec, p.slice, hw_f, eps);
    return;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(planes * p.cluster));
  config.blockDim = dim3(p.threads);
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaLaunchKernelEx(&config, adain_block_kernel<T, K, true>, xt, ot, st,
                     p.nvec, p.slice, hw_f, eps);
}

template <typename T>
int launch(const void* x, void* o, const Styles& st, long long planes,
           long long hw, float eps, int threads, int cluster,
           cudaStream_t s) {
  const Plan p = make_plan(x, o, hw, sizeof(T), threads, cluster);
  if (p.k == 0 || planes * p.cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float hw_f = static_cast<float>(hw);
  if (p.path == kLoop) {
    adain_loop_kernel<T><<<static_cast<unsigned>(planes), kLoopThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(o), st, hw, hw_f, eps);
  } else {
    auto run = p.path == kWarp
                   ? (p.k == 1   ? run_warp<T, 1>
                      : p.k == 2 ? run_warp<T, 2>
                      : p.k == 4 ? run_warp<T, 4>
                                 : run_warp<T, 8>)
                   : (p.k == 1   ? run_block<T, 1>
                      : p.k == 2 ? run_block<T, 2>
                      : p.k == 4 ? run_block<T, 4>
                                 : run_block<T, 8>);
    run(p, x, o, st, planes, hw_f, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int itemsize_of(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// x, o: (planes, hw) contiguous, dtype `dtype`; scale, bias: (planes,) of
// dtypes `scale_dtype`, `bias_dtype`. `threads` and `cluster` are 0, or
// force the block (cluster 1) or cluster path with that many threads a
// block and blocks a plane, for measurements; a request that cannot hold
// the plane in registers is refused with cudaErrorInvalidValue.
extern "C" int ganlab_adain(const void* x, const void* scale,
                            const void* bias, void* o, long long planes,
                            long long hw, float eps, int dtype,
                            int scale_dtype, int bias_dtype, int threads,
                            int cluster, int device, void* stream) {
  if (planes <= 0 || hw <= 0 || dtype < 0 || dtype > 2 || scale_dtype < 0 ||
      scale_dtype > 2 || bias_dtype < 0 || bias_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  const auto s = static_cast<cudaStream_t>(stream);
  const Styles st{scale, bias, scale_dtype, bias_dtype};
  switch (dtype) {
    case 0:
      return launch<float>(x, o, st, planes, hw, eps, threads, cluster, s);
    case 1:
      return launch<__nv_bfloat16>(x, o, st, planes, hw, eps, threads,
                                   cluster, s);
    default:
      return launch<__half>(x, o, st, planes, hw, eps, threads, cluster, s);
  }
}

// What ganlab_adain does with these arguments, packed into one int:
// path (0 = loop, 1 = warp, 2 = block, 3 = cluster) + 4 * log2(cluster)
// + 16 * log2(vectors a thread) + 64 * threads (block and cluster paths:
// a block's; warp path: lanes a plane; loop path: 0); -1 = refused.
// Launches nothing.
extern "C" int ganlab_adain_path(const void* x, const void* o, long long hw,
                                 int dtype, int threads, int cluster) {
  if (hw <= 0 || dtype < 0 || dtype > 2) return -1;
  const Plan p = make_plan(x, o, hw, itemsize_of(dtype), threads, cluster);
  if (p.k == 0) return -1;
  int log2_cluster = 0, log2_k = 0;
  while ((1 << log2_cluster) < p.cluster) ++log2_cluster;
  while ((1 << log2_k) < p.k) ++log2_k;
  return p.path + 4 * log2_cluster + 16 * log2_k + 64 * p.threads;
}
