// Per-plane mean / population stddev + normalise, for Hopper (sm_90a),
// with a plain C interface loaded by ctypes
// (vacv_tpu_torch/ops/cuda/normalize.py).
//
// Replaces: vacv_tpu/ops/pallas/normalize.py::_chw_kernel, the TPU kernel
// behind normalize_fused_pallas.  It takes P contiguous planes of h x w, u8
// or f32, and writes (x - mu) * (1 / (sigma + 1e-6)) as f32, each plane with its
// own mean mu and population stddev sigma.
//
// Bound: bytes, the input read once and the f32 output written once (at
// (3, 1080, 1920) f32 49.8 MB, 14.9 us at 3.35 TB/s); a few flops per
// element.  The TPU kernel walks each plane's row chunks in order on one
// core, carries the partials across grid steps and reads the plane a
// second time to scale it.  Here one launch does both passes and the
// second pass never goes back to device memory, because the blocks that
// took the statistics are still resident, with their part of the plane on
// the SM, when the plane's mean and stddev are known.  Two forms, chosen by
// the wrapper's launch plan (normalize.py::launch_plan):
//
// * cluster: a plane of up to 8 x 512 x 16 elements (the (3, 224, 224)
//   images of the pipelines' tails) goes to one thread-block cluster.  Each
//   thread holds 16 elements in registers; each warp reduces its share to
//   four sums with shuffles and writes them into the shared memory of
//   every block of the cluster (distributed shared memory), and after one
//   cluster-wide barrier each block merges the parts in a fixed order and
//   scales its registers.  No scratch memory, no second read.
// * grid: larger planes go to a cooperative launch of at most one block an
//   SM (the grid every block of which is resident: grid-wide barriers need
//   that).  Each plane is cut into equal slices, one a block; a block
//   copies its slice into shared memory while it sums it (up to 226 KB: a
//   (3, 1080, 1920) f32 input is 189 KB a block on 132 SMs), takes the
//   sums about its trial mean from there, writes its part to a small
//   scratch array, and after the grid-wide barrier merges its plane's
//   parts and writes the scaled values from shared memory.  What of a
//   slice does not fit (inputs beyond 132 x 226 KB: f32 above about 7.4 M
//   elements, u8 above 29.8 M) is read through L2 again by the same block,
//   once for the second pass and once for the scale.  More planes than
//   resident blocks run as rounds of the same, a barrier each.
//
// Statistics: a block's part is a corrected two-pass over values it holds
// on the SM (the trial mean m of the f32 sum, then r = sum (x - m) and
// q = sum (x - m)^2); the parts of a plane merge in double, in a fixed
// order, by the n-ary form of Chan's update (merge_parts).  Never
// E[x^2] - mu^2, no atomics: the same bits on every run.
//
// Alignment: the grid form addresses the input in 16-byte units counted
// from the 16-byte boundary at or below a plane's first element (the
// cluster form in quads of four elements, likewise), so every wide load is
// aligned whatever the tensor's offset or the plane size; a unit that the
// plane only partly covers is read element by element.  Outputs are stored
// as float4 where four neighbours share a plane and the store is aligned,
// else one by one.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-6f;
constexpr int kClusterThreads = 512;
constexpr int kClusterItems = 16;  // elements a thread holds in registers
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kGridThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr float kTwo23 = 8388608.0f;  // 2^23, bits 0x4B000000

// A block's share of a plane: n values, their trial mean m (the f32 sum
// over n), r = sum (x - m) and q = sum (x - m)^2.
struct Part {
  double n, m, r, q;
};

// Sums of N floats per thread over the block; every thread gets the totals.
// Deterministic: a fixed shuffle tree, then every thread adds the per-warp
// sums in the same order.  `red` holds N * THREADS / 32 floats.
template <int THREADS, int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* red) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) red[k * (THREADS / 32) + (threadIdx.x >> 5)] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) total += red[k * (THREADS / 32) + i];
    v[k] = total;
  }
}

// The same double in every lane: a butterfly whose two sides add the same
// pair at every step.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Byte e (0..3) of w as a float, through the adder: or it into 2^23's
// mantissa and subtract 2^23.
__device__ __forceinline__ float byte_to_float(uint32_t w, int e) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + e)) - kTwo23;
}

template <typename T>
struct Unit;  // 16 bytes of input
template <>
struct Unit<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
};
template <>
struct Unit<uint8_t> {
  static constexpr int kElems = 16;
  static __device__ __forceinline__ void unpack(const uint4& u, float* v) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = byte_to_float(w[i / 4], i % 4);
  }
};

// Elements the first input element lies above its 16-byte boundary.
template <typename T>
__device__ __forceinline__ int64_t shift_of(const T* x) {
  return static_cast<int64_t>((reinterpret_cast<uintptr_t>(x) & 15u) / sizeof(T));
}

// The 16-byte unit at xa + j (j a multiple of the unit) as floats; the
// elements outside [lo, hi) come back as 0.  `raw` gets the unit's bytes.
template <typename T>
__device__ __forceinline__ void load_unit(const T* xa, int64_t j, int64_t lo, int64_t hi, float* v,
                                          uint4& raw) {
  constexpr int U = Unit<T>::kElems;
  if (j >= lo && j + U <= hi) {
    raw = __ldg(reinterpret_cast<const uint4*>(xa + j));
  } else {
    alignas(16) T tmp[U];
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const bool in = j + e >= lo && j + e < hi;
      tmp[e] = in ? __ldg(xa + (in ? j + e : lo)) : T(0);
    }
    raw = *reinterpret_cast<const uint4*>(tmp);
  }
  Unit<T>::unpack(raw, v);
}

// Add the quad's r = sum (x - m) and q = sum (x - m)^2 to b[0], b[1], over
// the neighbours [e_lo, e_hi) of v[0 .. 3]: a whole quad without a test.
__device__ __forceinline__ void about_mean(const float* v, float m, int e_lo, int e_hi, float* b) {
  if (e_lo <= 0 && e_hi >= 4) {
    const float d0 = v[0] - m, d1 = v[1] - m, d2 = v[2] - m, d3 = v[3] - m;
    b[0] += (d0 + d1) + (d2 + d3);
    b[1] += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float d = v[e] - m;
    if (e >= e_lo && e < e_hi) {
      b[0] += d;
      b[1] += d * d;
    }
  }
}

// Store the scaled neighbours (v - mu) * inv at o[0 .. 3], of which
// [e_lo, e_hi) are wanted: one float4 where all four are and the address
// allows.  STREAM marks the line evict-first in L2: an output too large to
// stay there should not push the input out on its way to memory.
template <bool STREAM>
__device__ __forceinline__ void store4(float* o, int e_lo, int e_hi, const float* v, float mu,
                                       float inv) {
  if (e_lo <= 0 && e_hi >= 4 && (reinterpret_cast<uintptr_t>(o) & 15u) == 0) {
    const float4 f = make_float4((v[0] - mu) * inv, (v[1] - mu) * inv, (v[2] - mu) * inv,
                                 (v[3] - mu) * inv);
    if constexpr (STREAM) {
      __stcs(reinterpret_cast<float4*>(o), f);
    } else {
      *reinterpret_cast<float4*>(o) = f;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e >= e_lo && e < e_hi) o[e] = (v[e] - mu) * inv;
}

// The plane's mean mu and inv = 1 / (stddev + eps) from its blocks' parts,
// the parts taken in index order by `get(i)`, i < count, in double: the
// n-ary form of Chan's update about the trial means,
//   mean = sum (n_i m_i + r_i) / N,
//   M2   = sum (q_i + 2 (m_i - mean) r_i + n_i (m_i - mean)^2).
// Lane l of the calling warp takes parts l, l + 32, ...; warp_sum joins
// the lanes; every lane and every warp gets the same bits.  `inv_n` is
// 1 / N, which the caller works out while its loads are in flight.
template <typename GET>
__device__ __forceinline__ void merge_parts(GET get, int count, double inv_n, float& mu,
                                            float& inv) {
  const int lane = threadIdx.x & 31;
  double s = 0.0;
  for (int i = lane; i < count; i += 32) {
    const Part a = get(i);
    s += a.n * a.m + a.r;
  }
  const double mean = warp_sum(s) * inv_n;
  double m2 = 0.0;
  for (int i = lane; i < count; i += 32) {
    const Part a = get(i);
    const double d = a.m - mean;
    m2 += a.q + 2.0 * d * a.r + a.n * d * d;
  }
  const double var = fmax(warp_sum(m2), 0.0) * inv_n;
  mu = static_cast<float>(mean);
  inv = 1.f / (sqrtf(static_cast<float>(var)) + kEps);
}

// ---- cluster form ---------------------------------------------------------

// Four neighbours at xa + j (j a multiple of 4: 16 bytes of f32, 4 of u8)
// as floats; the elements outside [lo, hi) come back as 0.
template <typename T>
__device__ __forceinline__ void load_quad_global(const T* xa, int64_t j, int64_t lo, int64_t hi,
                                                 float* v) {
  if (j >= lo && j + 4 <= hi) {
    if constexpr (sizeof(T) == 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(xa + j));
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(xa + j));
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = byte_to_float(w, e);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = j + e >= lo && j + e < hi ? static_cast<float>(__ldg(xa + j + e)) : 0.f;
  }
}

// Sums of N floats per lane over the warp, the same in every lane.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
}

// One cluster a plane.  The plane is addressed in quads (four elements)
// from the quad boundary at or below its first element; thread t of block
// `rank` holds quads rank * T + t + i * (cluster * T), i < kQuads, in
// registers.  Every warp reduces its quads to a part (n, m, r, q) with
// shuffles alone and writes it into the shared memory of every block of
// the cluster, so one cluster-wide barrier later each block has all the
// parts locally, warp 0 merges them, and the block scales its registers.
template <typename T>
__global__ void __launch_bounds__(kClusterThreads) normalize_cluster_kernel(
    const T* __restrict__ x, float* __restrict__ out, int64_t plane) {
  constexpr int kQuads = kClusterItems / 4;
  constexpr int kWarps = kClusterThreads / 32;
  __shared__ float4 parts[kMaxCluster * kWarps];  // part of warp w of block r at [r * kWarps + w]
  __shared__ float stat[2];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.barrier_arrive();  // waited for below: a block is written to only once it runs
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t p = blockIdx.x / csize;
  const int64_t shift = static_cast<int64_t>((reinterpret_cast<uintptr_t>(x) / sizeof(T)) & 3u);
  const T* xa = x - shift;  // xa[j]: quad space
  const int64_t lo = p * plane + shift, hi = lo + plane;
  const int64_t j0 = (lo / 4 + rank * kClusterThreads + threadIdx.x) * 4;
  const int64_t step = static_cast<int64_t>(csize) * kClusterThreads * 4;
  const double inv_n = 1.0 / static_cast<double>(plane);

  float v[kQuads][4];
  float a[2] = {0.f, 0.f};  // count, sum
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int64_t j = j0 + i * step;
    load_quad_global(xa, j, lo, hi, v[i]);
    a[0] += static_cast<float>(max(int64_t(0), min(hi, j + 4) - max(lo, j)));
    a[1] += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
  }
  warp_sums(a);
  const float n = a[0], m = n > 0.f ? a[1] / n : 0.f;
  float b[2] = {0.f, 0.f};  // r, q
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int64_t j = j0 + i * step;
    about_mean(v[i], m, static_cast<int>(max(lo - j, int64_t(0))),
               static_cast<int>(max(min(hi - j, int64_t(4)), int64_t(0))), b);
  }
  warp_sums(b);
  cluster.barrier_wait();  // every block of the cluster has started
  if (lane < csize)
    *cluster.map_shared_rank(&parts[rank * kWarps + warp], lane) = make_float4(n, m, b[0], b[1]);
  cluster.sync();  // every warp's part has arrived in every block
  if (warp == 0) {
    float mu, inv;
    merge_parts(
        [&](int i) {
          const float4 f = parts[i];
          return Part{f.x, f.y, f.z, f.w};
        },
        csize * kWarps, inv_n, mu, inv);
    if (lane == 0) stat[0] = mu, stat[1] = inv;
  }
  __syncthreads();
  const float mu = stat[0], inv = stat[1];
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int64_t j = j0 + i * step;
    if (j < hi)
      store4<false>(out + (j - shift), static_cast<int>(max(lo - j, int64_t(0))),
                    static_cast<int>(min(hi - j, int64_t(4))), v[i], mu, inv);
  }
}

// ---- grid form ------------------------------------------------------------

// Four neighbours at local index i (a multiple of 4) of the block's slice,
// as floats: from the shared copy below `cap`, else from memory.
template <typename T>
__device__ __forceinline__ void load_quad(const T* held, const T* xs, int i, int cap, int lo, int hi,
                                          float* v) {
  if (i < cap) {
    if constexpr (sizeof(T) == 4) {
      const float4 f = *reinterpret_cast<const float4*>(held + i);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(held + i);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = byte_to_float(w, e);
    }
  } else if (i >= lo && i + 4 <= hi) {
    if constexpr (sizeof(T) == 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(xs + i));
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(xs + i));
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = byte_to_float(w, e);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = i + e >= lo && i + e < hi ? static_cast<float>(__ldg(xs + i + e)) : 0.f;
  }
}

// Every plane is cut into `per_plane` slices of `slice` elements (a
// multiple of 16), counted from the 16-byte boundary at or below the
// plane's first element; block b of round r takes slice (r gridDim + b) %
// per_plane of plane (r gridDim + b) / per_plane and keeps its first `cap`
// elements in shared memory.  gridDim is a multiple of per_plane, so a
// plane's slices meet at one grid-wide barrier.  `part` holds planes x
// per_plane entries; `stream` stores the output evict-first.
template <typename T>
__global__ void __launch_bounds__(kGridThreads, 1) normalize_grid_kernel(
    const T* __restrict__ x, float* __restrict__ out, int planes, int64_t plane, int per_plane,
    int slice, int cap, int rounds, int stream, Part* part) {
  constexpr int U = Unit<T>::kElems;
  extern __shared__ uint4 held_units[];
  __shared__ float red[2 * kGridThreads / 32];
  __shared__ float stat[2];
  const T* held = reinterpret_cast<const T*>(held_units);
  const int64_t shift = shift_of(x);
  const T* xa = x - shift;
  const double inv_n = 1.0 / static_cast<double>(plane);
  for (int round = 0; round < rounds; ++round) {
    const int64_t item = static_cast<int64_t>(round) * gridDim.x + blockIdx.x;
    const int64_t p = item / per_plane;
    const int64_t plane_lo = p * plane + shift, plane_hi = plane_lo + plane;
    // The slice in unit space, and the part of it inside the plane as
    // local indices [lo, hi).
    const int64_t base = (plane_lo & ~int64_t(15)) + (item % per_plane) * slice;
    int lo = 0, hi = 0;
    if (p < planes) {
      lo = static_cast<int>(min(max(plane_lo - base, int64_t(0)), int64_t(slice)));
      hi = static_cast<int>(min(max(plane_hi - base, int64_t(0)), int64_t(slice)));
    }
    const T* xs = xa + base;  // xs[i]: the slice's local index space

    // Pass 1, from memory: copy the units into shared memory and sum them.
    float a[1] = {0.f};
    if (round > 0) __syncthreads();  // the last round's scale still reads `held`
#pragma unroll 1  // 1024 threads x 16 bytes in flight fill the SM's share; unrolling measured slower
    for (int i = lo / U * U + threadIdx.x * U; i < hi; i += kGridThreads * U) {
      float v[U];
      uint4 raw;
      load_unit(xs, i, lo, hi, v, raw);
      if (i < cap) held_units[i / U] = raw;
#pragma unroll
      for (int e = 0; e < U; ++e) a[0] += v[e];
    }
    block_sums<kGridThreads>(a, red);  // also orders the copy before pass 2
    const float n = static_cast<float>(hi - lo), m = hi > lo ? a[0] / n : 0.f;

    // Pass 2, from shared memory: the sums about the trial mean.
    float b[2] = {0.f, 0.f};
    for (int i = lo / 4 * 4 + threadIdx.x * 4; i < hi; i += kGridThreads * 4) {
      float v[4];
      load_quad(held, xs, i, cap, lo, hi, v);
      about_mean(v, m, lo - i, hi - i, b);
    }
    block_sums<kGridThreads>(b, red);
    if (threadIdx.x == 0 && p < planes)
      part[item] = Part{static_cast<double>(hi - lo), m, b[0], b[1]};
    __threadfence();
    cg::this_grid().sync();

    // Pass 3, from shared memory: the plane's statistics, then the scale.
    // (hi > lo is the same for every thread of the block.)
    if (hi > lo) {
      const Part* mine = part + p * per_plane;
      if (threadIdx.x < 32) {  // one warp: 32 of them would share the fp64 units
        float mu, inv;
        merge_parts([&](int i) { return mine[i]; }, per_plane, inv_n, mu, inv);
        if (threadIdx.x == 0) stat[0] = mu, stat[1] = inv;
      }
      __syncthreads();
      const float mu = stat[0], inv = stat[1];
      float* o = out + (base - shift);
      for (int i = lo / 4 * 4 + threadIdx.x * 4; i < hi; i += kGridThreads * 4) {
        float v[4];
        load_quad(held, xs, i, cap, lo, hi, v);
        if (stream) {
          store4<true>(o + i, lo - i, hi - i, v, mu, inv);
        } else {
          store4<false>(o + i, lo - i, hi - i, v, mu, inv);
        }
      }
    }
  }
}

template <typename T>
int launch_cluster(const T* x, float* out, int planes, int64_t plane, int cluster,
                   cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(planes) * cluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, normalize_cluster_kernel<T>, x, out, plane));
}

// The dynamic shared bytes a grid-form block may ask for on `device`, after
// opting the kernel into them (once per device and type).
template <typename T>
int grid_smem_limit(int device, int* limit) {
  static int known[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && known[device]) {
    *limit = known[device];
    return 0;
  }
  int max_smem = 0;
  cudaError_t e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, normalize_grid_kernel<T>);
  if (e != cudaSuccess) return static_cast<int>(e);
  *limit = max_smem - static_cast<int>(fa.sharedSizeBytes);
  e = cudaFuncSetAttribute(normalize_grid_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 0 && device < kMaxDevices) known[device] = *limit;
  return 0;
}

template <typename T>
int launch_grid(int device, const T* x, float* out, int planes, int64_t plane, int grid,
                int per_plane, int slice, int cap, int rounds, int stream, void* part,
                cudaStream_t s) {
  int limit = 0;
  const int rc = grid_smem_limit<T>(device, &limit);
  if (rc != 0) return rc;
  const int64_t held = static_cast<int64_t>(cap) * sizeof(T);
  if (held > limit) return static_cast<int>(cudaErrorInvalidValue);
  Part* pp = static_cast<Part*>(part);
  void* args[] = {(void*)&x,     (void*)&out, (void*)&planes, (void*)&plane,  (void*)&per_plane,
                  (void*)&slice, (void*)&cap, (void*)&rounds, (void*)&stream, (void*)&pp};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(normalize_grid_kernel<T>), dim3(grid), dim3(kGridThreads), args,
      static_cast<size_t>(held), s));
}

}  // namespace

extern "C" {

// What the wrapper's launch plan needs of the card and the kernels, as 7
// ints at `limits`: [0] SMs, [1] the shared bytes a grid-form block may
// hold (the opt-in limit less the kernel's static use, rounded down to
// 256), [2] grid-form blocks resident on an SM at that size (the occupancy
// query; a grid-wide barrier needs every block resident), [3..6] the
// cluster form's threads, elements a thread, largest cluster, and the grid
// form's threads.  Returns a cudaError_t.
int vacv_normalize_limits(int device, void* limits) {
  int* out = static_cast<int*>(limits);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int lim_f = 0, lim_b = 0, n_f = 0, n_b = 0;
  int rc = grid_smem_limit<float>(device, &lim_f);
  if (rc == 0) rc = grid_smem_limit<uint8_t>(device, &lim_b);
  if (rc != 0) return rc;
  out[1] = (lim_f < lim_b ? lim_f : lim_b) / 256 * 256;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_f, normalize_grid_kernel<float>,
                                                    kGridThreads, out[1]);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_b, normalize_grid_kernel<uint8_t>,
                                                      kGridThreads, out[1]);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[2] = n_f < n_b ? n_f : n_b;
  out[3] = kClusterThreads;
  out[4] = kClusterItems;
  out[5] = kMaxCluster;
  out[6] = kGridThreads;
  return 0;
}

// Normalise `planes` contiguous planes of `plane` elements (u8 when is_u8,
// else f32) from `x` into f32 `out`, each with its own mean and population
// stddev, in one launch.  cluster > 0: the cluster form, one cluster of
// that many blocks a plane (the arguments after it unused).  cluster == 0:
// the grid form, `grid` co-resident blocks (a multiple of `per_plane`), a
// plane cut into `per_plane` slices of `slice` elements (a multiple of 16)
// of which a block keeps `cap` (a multiple of 16) in shared memory,
// `rounds` rounds of planes, `evict_first`: store the output so (one
// too large to stay in L2), and `part`: planes x per_plane x 4 doubles of
// scratch.  Returns a cudaError_t (0 on success).
int vacv_normalize_planes(int device, void* stream, const void* x, int is_u8, void* out,
                          int planes, long long plane, int cluster, int grid, int per_plane,
                          int slice, int cap, int rounds, int evict_first, void* part) {
  cudaGetLastError();  // clear a stale error of an earlier call
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  int rc;
  if (cluster > 0) {
    if (cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
    rc = is_u8 ? launch_cluster(static_cast<const uint8_t*>(x), o, planes, plane, cluster, s)
               : launch_cluster(static_cast<const float*>(x), o, planes, plane, cluster, s);
  } else {
    if (per_plane < 1 || grid < 1 || grid % per_plane || slice < 16 || slice % 16 || cap < 16 ||
        cap % 16 || rounds < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    rc = is_u8 ? launch_grid(device, static_cast<const uint8_t*>(x), o, planes, plane, grid,
                             per_plane, slice, cap, rounds, evict_first, part, s)
               : launch_grid(device, static_cast<const float*>(x), o, planes, plane, grid,
                             per_plane, slice, cap, rounds, evict_first, part, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
