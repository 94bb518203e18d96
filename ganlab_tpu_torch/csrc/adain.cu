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
// the device. The second design fixed that up to 512x512 planes, but left
// every plane above 65536 16-byte vectors (stylegan-1024's 1024x1024) to
// one 256-thread block that looped three times with scalar loads: 64
// blocks on 132 SMs at batch 4, and 8.6x the bound.
//
// Design: a plane is one contiguous run of memory. Where it fits, it is
// read once with 16-byte loads that are all in flight before the first
// use, held on chip through both reductions and the write. The variance
// is two-pass: at StyleGAN's init the 4x4 planes are constant, and E[x^2]
// - mean^2 would leave cancellation noise for rsqrt(eps) = 1e4 to
// multiply. Who holds a plane depends on its size (vectors = HW / (16 /
// itemsize)):
//  * warp path, up to 256 vectors (4x4 .. 32x32): a group of 1 to 32 lanes
//    per plane, so a warp takes 32 planes of 4x4 or one of 32x32, up to 8
//    vectors a lane in registers; reductions by __shfl_xor_sync inside the
//    group, no shared memory;
//  * block path, up to 8192 vectors (64x64 .. 256x256 in 16-bit types):
//    one block per plane, up to 8 vectors a thread in registers; a
//    reduction is a warp shuffle, one value per warp through shared memory,
//    one __syncthreads;
//  * cluster path, up to 16 x (4096 + kMaxStaged) vectors (256x256
//    float32 .. 1024x1024 float32): a thread block cluster of 2 to 16
//    blocks of 512 threads per plane (16 is a non-portable size, and the
//    plan takes a cut only where cudaOccupancyMaxActiveClusters says such a
//    cluster fits beside its shared memory). A block holds a contiguous
//    slice: 8 vectors a thread (64 KiB) in registers, the rest in dynamic
//    shared memory (1024x1024: 64 KiB in 16-bit types, so two blocks share
//    an SM and one's reductions overlap the other's copies; 192 KiB in
//    float32), loaded by bulk asynchronous copies (cp.async.bulk, one
//    thread issues kChunks of them, each completing on its own mbarrier, so
//    the sum starts on the first chunk while the others arrive). A block
//    writes its partial sum into every block's shared memory (distributed
//    shared memory), one cluster.sync(), and each block adds the partials
//    in rank order, so all blocks of a cluster get the same bits. Remote
//    shared memory is only ever written before a cluster.sync() that the
//    owner has yet to pass, so no block exits under a remote access;
//  * split path, planes too large for that (or where the device cannot
//    schedule the cluster): each plane is cut into slices of threads x 8
//    vectors, as many as it takes, one block each in registers, over two
//    launches. The first reduces each slice to its mean and M2 (two-pass)
//    into a (planes, slices) scratch of float2. The second loads its slice
//    again, combines its plane's partials in slice order by Chan's formula
//    in delta form (mean += delta * nb / n, M2 += M2b + delta^2 * na * nb
//    / n), the same arithmetic in every block of the plane, and writes; it
//    walks the blocks in reverse order, so that its first blocks re-read
//    what the first launch read last, while the L2 may still hold it.
//    About 1.5x the bytes, every SM busy. A constant plane gives each
//    slice mean = v and M2 = 0, so delta = 0 throughout and the output is
//    the bias bit for bit, as on the other paths;
//  * loop path, everything else (HW * itemsize no multiple of 16, pointers
//    not 16-byte aligned): one block per plane loops over it three times,
//    one element per load.
// The cluster path with the whole slice in shared memory (1024 threads, a
// cluster of 16 with one block an SM) measured 0.16 ms at (4, 16, 1024,
// 1024) bf16 against 0.145 for the split path and 0.123 for this cut
// (PERF.md, section 6).
// The order of the sums differs between the paths and from the plain
// version, so the paths agree to rounding (1e-5 of the output scale in
// float32), not bit for bit.
//
// C interface (loaded with ctypes): launches on `stream` of `device` and
// returns cudaGetLastError() after the launch, 0 on success. dtype 0 =
// float32, 1 = bfloat16, 2 = float16, for x/o and for each style tensor.

#include <algorithm>
#include <cstdint>
#include <mutex>
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
constexpr int kMaxCluster = 16;          // a non-portable cluster size
constexpr int kLoopThreads = 256;
constexpr int kClusterThreads = 512;     // cluster path: 2 blocks an SM
constexpr int kMaxStaged = 14336;        // 224 KiB of shared memory a block
constexpr int kChunks = 8;               // bulk copies (and mbarriers) a block
constexpr int kSplitThreads = 512;       // split path: a slice is 512 x 8
constexpr int kPartsStaged = 256;        // split path: partials a round
// a bulk copy not complete after this many SM cycles (tens of seconds)
// traps; a trap ends the CUDA context of the whole process
constexpr long long kWaitCycles = 1LL << 36;

enum Path { kLoop = 0, kWarp = 1, kBlock = 2, kCluster = 3, kSplit = 4 };

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

// The sum of v over the blocks of the cluster, the same bits in every
// block: the block's sum goes into `partial[rank]` of every block, one
// cluster.sync(), and each block adds the partials in rank order.
__device__ __forceinline__ float cluster_sum(float v, float* scratch,
                                             float* partial, int ranks,
                                             int rank) {
  v = block_sum(v, scratch);
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x < ranks) cluster.map_shared_rank(partial, threadIdx.x)[rank] = v;
  cluster.sync();
  v = 0.0f;
  for (int r = 0; r < ranks; ++r) v += partial[r];
  return v;
}

// One 16-byte vector of T: its sum, its squared deviations from `mean`,
// and (x - mean) * a + b packed back.
template <typename T>
__device__ __forceinline__ float vec_sum(const uint4& v) {
  float f[Vec<T>::N];
  Vec<T>::unpack(v, f);
  float t = 0.0f;
#pragma unroll
  for (int e = 0; e < Vec<T>::N; ++e) t += f[e];
  return t;
}

template <typename T>
__device__ __forceinline__ float vec_sq_dev(const uint4& v, float mean) {
  float f[Vec<T>::N];
  Vec<T>::unpack(v, f);
  float t = 0.0f;
#pragma unroll
  for (int e = 0; e < Vec<T>::N; ++e) {
    const float d = f[e] - mean;
    t = __fmaf_rn(d, d, t);
  }
  return t;
}

template <typename T>
__device__ __forceinline__ uint4 vec_apply(const uint4& v, float mean,
                                           float a, float b) {
  float f[Vec<T>::N];
  Vec<T>::unpack(v, f);
#pragma unroll
  for (int e = 0; e < Vec<T>::N; ++e) f[e] = __fmaf_rn(f[e] - mean, a, b);
  return Vec<T>::pack(f);
}

// K vectors of a plane held by one thread, packed as loaded: vector
// first + k * stride for k < K, those below `n` only.
template <typename T, int K>
struct Held {
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
    for (int k = 0; k < K; ++k)
      if (has[k]) t += vec_sum<T>(v[k]);
    return t;
  }
  __device__ __forceinline__ float sum_sq_dev(float mean) const {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (has[k]) t += vec_sq_dev<T>(v[k], mean);
    return t;
  }
  // y = (x - mean) * a + b
  __device__ __forceinline__ void store(uint4* p, int first, int stride,
                                        float mean, float a, float b) const {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (has[k]) p[first + k * stride] = vec_apply<T>(v[k], mean, a, b);
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

// Block path: one block per plane of nvec vectors, thread t holding
// vectors t, t + blockDim.x, ... (nvec <= K * blockDim.x).
template <typename T, int K>
__global__ void adain_block_kernel(const T* __restrict__ x, T* __restrict__ o,
                                   Styles st, int nvec, float hw_f,
                                   float eps) {
  __shared__ float scratch[2][32];
  const long long plane = blockIdx.x;
  const long long base = plane * nvec;
  Held<T, K> held;
  held.load(reinterpret_cast<const uint4*>(x) + base, threadIdx.x, blockDim.x,
            nvec);
  const float mean = block_sum(held.sum(), scratch[0]) / hw_f;
  const float var = block_sum(held.sum_sq_dev(mean), scratch[1]) / hw_f;
  const float a =
      rsqrtf(var + eps) * load_style(st.scale, plane, st.scale_code);
  const float b = load_style(st.bias, plane, st.bias_code);
  held.store(reinterpret_cast<uint4*>(o) + base, threadIdx.x, blockDim.x,
             mean, a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits for the first phase of an mbarrier; traps (an error that ends the
// process's CUDA context, not a hang) if it has not completed after
// kWaitCycles, which counts time the block spends preempted too.
__device__ __forceinline__ void wait_phase0(uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// Cluster path: gridDim.x = planes * clusters of C blocks; block `rank`
// holds vectors [rank * slice, min((rank + 1) * slice, nvec)) of its
// plane: the first blockDim.x * kMaxK of them in registers (thread t
// vectors t, t + blockDim.x, ...), the rest in dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
adain_cluster_kernel(const T* __restrict__ x, T* __restrict__ o, Styles st,
                     int nvec, int slice, float hw_f, float eps) {
  extern __shared__ uint4 tile[];
  __shared__ float scratch[2][32];
  __shared__ float partial[2][kMaxCluster];
  __shared__ uint64_t bar[kChunks];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long plane = blockIdx.x / ranks;
  const int first = rank * slice;
  const int n = max(0, min(slice, nvec - first));
  const int held_n = min(n, static_cast<int>(blockDim.x) * kMaxK);
  const int staged_n = n - held_n;
  const int chunk = (staged_n + kChunks - 1) / kChunks;
  const long long base = plane * nvec + first;
  const uint4* src = reinterpret_cast<const uint4*>(x) + base;

  if (threadIdx.x == 0) {
    for (int c = 0; c < kChunks; ++c) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&bar[c]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int c = 0; c < kChunks; ++c) {
      const int cn = min(chunk, staged_n - c * chunk);
      if (cn <= 0) break;
      const uint32_t b = smem_u32(&bar[c]);
      const uint32_t bytes = static_cast<uint32_t>(cn) * 16u;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(b), "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(tile + c * chunk)),
          "l"(src + held_n + c * chunk), "r"(bytes), "r"(b)
          : "memory");
    }
  }
  Held<T, kMaxK> held;
  held.load(src, threadIdx.x, blockDim.x, held_n);
  // every block of the cluster runs before any writes into its shared
  // memory; the copies and loads above are already in flight
  cluster.sync();

  float t = held.sum();
  for (int c = 0; c < kChunks; ++c) {
    const int lo = c * chunk, hi = min(lo + chunk, staged_n);
    if (lo >= hi) break;
    wait_phase0(&bar[c]);
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
      t += vec_sum<T>(tile[i]);
  }
  const float mean =
      cluster_sum(t, scratch[0], partial[0], ranks, rank) / hw_f;
  t = held.sum_sq_dev(mean);
  for (int i = threadIdx.x; i < staged_n; i += blockDim.x)
    t += vec_sq_dev<T>(tile[i], mean);
  const float var = cluster_sum(t, scratch[1], partial[1], ranks, rank) / hw_f;
  const float a =
      rsqrtf(var + eps) * load_style(st.scale, plane, st.scale_code);
  const float b = load_style(st.bias, plane, st.bias_code);
  uint4* dst = reinterpret_cast<uint4*>(o) + base;
  held.store(dst, threadIdx.x, blockDim.x, mean, a, b);
  for (int i = threadIdx.x; i < staged_n; i += blockDim.x)
    dst[held_n + i] = vec_apply<T>(tile[i], mean, a, b);
}

// Split path, first launch: gridDim.x = planes * slices; block (plane, s)
// holds vectors [s * slice, min((s + 1) * slice, nvec)) in registers and
// writes their mean and M2 (sum of squared deviations from that mean).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
adain_split_stats_kernel(const T* __restrict__ x, float2* __restrict__ part,
                         int nvec, int slice, int slices) {
  __shared__ float scratch[2][32];
  const long long plane = blockIdx.x / slices;
  const int s = static_cast<int>(blockIdx.x - plane * slices);
  const int first = s * slice;
  const int n = min(slice, nvec - first);
  Held<T, kMaxK> held;
  held.load(reinterpret_cast<const uint4*>(x) + plane * nvec + first,
            threadIdx.x, blockDim.x, n);
  const float count = static_cast<float>(n) * Vec<T>::N;
  const float mean = block_sum(held.sum(), scratch[0]) / count;
  const float m2 = block_sum(held.sum_sq_dev(mean), scratch[1]);
  if (threadIdx.x == 0) part[blockIdx.x] = make_float2(mean, m2);
}

// Split path, second launch: the same blocks in reverse order; each
// combines its plane's partials in slice order (staged through shared
// memory kPartsStaged at a time, so a plane may have any number of
// slices) and writes its slice.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
adain_split_apply_kernel(const T* __restrict__ x, T* __restrict__ o,
                         const float2* __restrict__ part, Styles st, int nvec,
                         int slice, int slices, float hw_f, float eps) {
  constexpr int N = Vec<T>::N;
  __shared__ float2 parts[kPartsStaged];
  __shared__ float stat[2];
  const long long blk = static_cast<long long>(gridDim.x) - 1 - blockIdx.x;
  const long long plane = blk / slices;
  const int s = static_cast<int>(blk - plane * slices);
  const int first = s * slice;
  const int n = min(slice, nvec - first);
  const long long base = plane * nvec + first;
  Held<T, kMaxK> held;
  held.load(reinterpret_cast<const uint4*>(x) + base, threadIdx.x,
            blockDim.x, n);
  float mean = 0.0f, m2 = 0.0f, na = 0.0f;   // thread 0's running values
  for (int j0 = 0; j0 < slices; j0 += kPartsStaged) {
    const int m = min(kPartsStaged, slices - j0);
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      parts[i] = part[plane * slices + j0 + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < m; ++i) {
        const int j = j0 + i;
        const float nb = static_cast<float>(min(slice, nvec - j * slice)) * N;
        if (j == 0) {
          mean = parts[0].x;
          m2 = parts[0].y;
          na = nb;
          continue;
        }
        const float nn = na + nb;
        const float delta = parts[i].x - mean;
        mean += delta * nb / nn;
        m2 += parts[i].y + delta * delta * na * nb / nn;
        na = nn;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    stat[0] = mean;
    stat[1] = rsqrtf(m2 / hw_f + eps);
  }
  __syncthreads();
  const float a = stat[1] * load_style(st.scale, plane, st.scale_code);
  const float b = load_style(st.bias, plane, st.bias_code);
  held.store(reinterpret_cast<uint4*>(o) + base, threadIdx.x, blockDim.x,
             stat[0], a, b);
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

// Whether a cluster of `cluster` blocks of the cluster kernel, `threads`
// each with `smem` bytes of dynamic shared memory, can be scheduled on
// this device (cudaOccupancyMaxActiveClusters > 0). Sets the kernel's
// attributes (non-portable cluster sizes, the shared-memory limit) on the
// way; each answer is kept, per device and configuration.
template <typename T>
bool cluster_fits(int device, int threads, int cluster, int smem) {
  struct Seen { int device, threads, cluster, smem; bool fits; };
  static std::mutex mu;
  static Seen seen[64];
  static int n_seen = 0;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i) {
    const Seen& e = seen[i];
    if (e.device == device && e.threads == threads && e.cluster == cluster &&
        e.smem == smem)
      return e.fits;
  }
  auto kernel = adain_cluster_kernel<T>;
  bool fits =
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) == cudaSuccess &&
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxStaged * 16) == cudaSuccess;
  if (fits) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(cluster);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    int active = 0;
    fits = cudaOccupancyMaxActiveClusters(&active, kernel, &config) ==
               cudaSuccess &&
           active > 0;
  }
  cudaGetLastError();  // a refused query is an answer, not a launch error
  if (n_seen < 64) seen[n_seen++] = {device, threads, cluster, smem, fits};
  return fits;
}

// How a call is cut into threads.
struct Plan {
  Path path;
  int nvec;      // vectors per plane
  int k;         // vectors a thread keeps in registers: 1, 2, 4 or 8
  int threads;   // threads per block; warp path: lanes per plane
  int blocks;    // blocks per plane: the cluster's size or the slices
  int slice;     // vectors per block
  int smem;      // cluster path: bytes of dynamic shared memory a block
  bool ok;       // false: a request the kernels cannot take
};

int round_up_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The cluster path's cut: `blocks` blocks of `threads`, the vectors
// beyond threads x kMaxK a block in shared memory.
template <typename T>
void cut_cluster(Plan& p, int threads, int blocks, int device) {
  p.path = kCluster;
  p.k = kMaxK;
  p.threads = threads ? threads : kClusterThreads;
  // the fewest blocks (a power of two) whose registers hold the plane
  p.blocks = blocks ? blocks
                    : std::min(kMaxCluster, round_up_pow2(ceil_div(
                                                p.nvec, p.threads * kMaxK)));
  p.slice = ceil_div(p.nvec, p.blocks);
  const int staged = std::max(0, p.slice - p.threads * kMaxK);
  p.smem = staged * 16;
  p.ok = (p.blocks == 2 || p.blocks == 4 || p.blocks == 8 ||
          p.blocks == 16) &&
         p.threads % 32 == 0 && p.threads >= 32 &&
         p.threads <= kMaxThreads && staged <= kMaxStaged &&
         cluster_fits<T>(device, p.threads, p.blocks, p.smem);
}

// `path` is -1 (chosen here from the shape, the alignment and, for the
// cluster path, what the device can schedule) or a Path to force, with
// `threads` and `cluster` 0 (chosen here) or forced: kBlock takes the
// plane in one block's registers, kCluster over a cluster of `cluster`
// blocks (registers, then shared memory), kSplit in slices of `threads` x
// 8 vectors. A request that cannot hold the plane gives ok = false, which
// the launch refuses.
template <typename T>
Plan make_plan(bool aligned, long long hw, int path, int threads,
               int cluster, int device) {
  Plan p{kLoop, 0, 1, kLoopThreads, 1, 0, 0, true};
  constexpr int per = Vec<T>::N;
  const bool vector = hw % per == 0 && aligned && hw / per <= 0x7fffffffLL;
  if (path == kLoop || (path < 0 && !vector)) return p;
  if (!vector || path == kWarp || path > kSplit) {
    p.ok = false;
    return p;
  }
  p.nvec = static_cast<int>(hw / per);
  if (path < 0) {
    if (p.nvec <= kWarpPathVectors) {
      p.path = kWarp;
      p.threads = p.nvec < 32 ? round_up_pow2(p.nvec) : 32;
      p.k = round_up_pow2(ceil_div(p.nvec, p.threads));
      return p;
    }
    if (p.nvec <= kMaxThreads * kMaxK) {
      path = kBlock;
    } else {
      cut_cluster<T>(p, 0, 0, device);
      if (p.ok) return p;
      path = kSplit;
    }
  }
  if (path == kCluster) {
    cut_cluster<T>(p, threads, cluster, device);
    return p;
  }
  if (path == kSplit) {
    p.path = kSplit;
    p.k = kMaxK;
    p.smem = 0;
    p.threads = threads ? threads : kSplitThreads;
    p.slice = p.threads * kMaxK;
    p.blocks = ceil_div(p.nvec, p.slice);
    p.ok = p.threads % 32 == 0 && p.threads >= 32 &&
           p.threads <= kMaxThreads;
    return p;
  }
  // kBlock: 4 vectors a thread where that fills a block of 64 to 1024
  p.path = kBlock;
  p.slice = p.nvec;
  if (threads == 0) {
    threads = round_up_pow2(ceil_div(p.nvec, 4));
    threads = threads < 64 ? 64 : threads > kMaxThreads ? kMaxThreads : threads;
  }
  p.threads = threads;
  p.k = round_up_pow2(ceil_div(p.nvec, threads));
  p.ok = threads % 32 == 0 && threads >= 32 && threads <= kMaxThreads &&
         p.k <= kMaxK;
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
  adain_block_kernel<T, K><<<static_cast<unsigned>(planes), p.threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(o), st, p.nvec, hw_f, eps);
}

template <typename T>
int launch(const void* x, void* o, float* scratch, const Styles& st,
           long long planes, long long hw, float eps, int path, int threads,
           int cluster, int device, cudaStream_t s) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) % 16 ==
      0;
  const Plan p = make_plan<T>(aligned, hw, path, threads, cluster, device);
  if (!p.ok || planes * p.blocks > 0x7fffffffLL ||
      (p.path == kSplit && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float hw_f = static_cast<float>(hw);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(o);
  const unsigned blocks = static_cast<unsigned>(planes * p.blocks);
  switch (p.path) {
    case kLoop:
      adain_loop_kernel<T><<<blocks, kLoopThreads, 0, s>>>(xt, ot, st, hw,
                                                           hw_f, eps);
      break;
    case kCluster: {
      cudaLaunchConfig_t config = {};
      config.gridDim = dim3(blocks);
      config.blockDim = dim3(p.threads);
      config.dynamicSmemBytes = p.smem;
      config.stream = s;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = p.blocks;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      config.attrs = attr;
      config.numAttrs = 1;
      cudaLaunchKernelEx(&config, adain_cluster_kernel<T>, xt, ot, st, p.nvec,
                         p.slice, hw_f, eps);
      break;
    }
    case kSplit: {
      float2* part = reinterpret_cast<float2*>(scratch);
      adain_split_stats_kernel<T><<<blocks, p.threads, 0, s>>>(
          xt, part, p.nvec, p.slice, p.blocks);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      adain_split_apply_kernel<T><<<blocks, p.threads, 0, s>>>(
          xt, ot, part, st, p.nvec, p.slice, p.blocks, hw_f, eps);
      break;
    }
    default: {
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
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, o: (planes, hw) contiguous, dtype `dtype`; scale, bias: (planes,) of
// dtypes `scale_dtype`, `bias_dtype`; scratch: planes x blocks x 2 float32
// where the plan is the split path (ganlab_adain_plan), else unused. `path`
// -1 lets the plan choose; a Path (and `threads`, `cluster` nonzero)
// forces one, for measurements (see make_plan); a request that cannot
// hold the plane is refused with cudaErrorInvalidValue.
extern "C" int ganlab_adain(const void* x, const void* scale,
                            const void* bias, void* o, void* scratch,
                            long long planes, long long hw, float eps,
                            int dtype, int scale_dtype, int bias_dtype,
                            int path, int threads, int cluster, int device,
                            void* stream) {
  if (planes <= 0 || hw <= 0 || dtype < 0 || dtype > 2 || scale_dtype < 0 ||
      scale_dtype > 2 || bias_dtype < 0 || bias_dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  const auto s = static_cast<cudaStream_t>(stream);
  const Styles st{scale, bias, scale_dtype, bias_dtype};
  float* part = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      return launch<float>(x, o, part, st, planes, hw, eps, path, threads,
                           cluster, device, s);
    case 1:
      return launch<__nv_bfloat16>(x, o, part, st, planes, hw, eps, path,
                                   threads, cluster, device, s);
    default:
      return launch<__half>(x, o, part, st, planes, hw, eps, path, threads,
                            cluster, device, s);
  }
}

// The plan ganlab_adain takes for these arguments (`aligned`: both
// pointers 16-byte aligned), written to out[0..5]: path (0 loop, 1 warp, 2
// block, 3 cluster, 4 split), threads a block (warp path: lanes a plane),
// vectors a thread keeps in registers, blocks a plane (the cluster's size
// or the slices), vectors a block, bytes of shared memory a block holds of
// the plane (cluster path). Returns 0, or -1 for a request that is
// refused. Launches nothing.
extern "C" int ganlab_adain_plan(int aligned, long long hw, int dtype,
                                 int path, int threads, int cluster,
                                 int device, int* out) {
  if (hw <= 0 || dtype < 0 || dtype > 2) return -1;
  const DeviceGuard guard(device);
  Plan p;
  switch (dtype) {
    case 0:
      p = make_plan<float>(aligned != 0, hw, path, threads, cluster, device);
      break;
    case 1:
      p = make_plan<__nv_bfloat16>(aligned != 0, hw, path, threads, cluster,
                                   device);
      break;
    default:
      p = make_plan<__half>(aligned != 0, hw, path, threads, cluster, device);
  }
  if (!p.ok) return -1;
  out[0] = p.path;
  out[1] = p.threads;
  out[2] = p.k;
  out[3] = p.blocks;
  out[4] = p.slice;
  out[5] = p.smem;
  return 0;
}
