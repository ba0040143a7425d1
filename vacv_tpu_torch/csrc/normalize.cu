// Per-plane mean / population stddev + normalise, for Hopper (sm_90a),
// with a plain C interface loaded by ctypes
// (vacv_tpu_torch/ops/cuda/normalize.py).
//
// Replaces: vacv_tpu/ops/pallas/normalize.py::_chw_kernel, the TPU kernel
// behind normalize_fused_pallas.  It takes P contiguous planes of h x w, u8
// or f32, and writes (x - mu) / (sigma + 1e-6) as f32, each plane with its
// own mean mu and population stddev sigma.
//
// Bound: bytes.  The input is read twice (statistics, then scale) and the
// f32 output written once, as on the TPU; a few flops per element.  At
// (3, 1080, 1920) f32 that is 74.6 MB, about 22 us at 3.35 TB/s, and the
// second read of the 24.9 MB input can come from the 50 MB L2.
//
// The TPU kernel walks each plane's row chunks in order on one core and
// carries the partials across grid steps.  Blocks on the card run in no
// order, so the work is three short launches:
//
// 1. partials_kernel, grid (chunks, P): each block takes a chunk of kChunk
//    elements of one plane, holds it in registers, and does a within-chunk
//    two-pass: the chunk mean first, then M2 = sum (x - mean)^2 around it.
//    It writes (n, mean, M2).  Chunks of 4096 spread a 1080p plane over
//    507 blocks, 1521 for three planes, so all 132 SMs stream; one block
//    per plane would be 3 blocks.
// 2. merge_kernel, one block per plane: Chan's parallel update merges the
//    partials in a fixed order (each thread a strided run of chunks, then
//    a fixed pairwise tree), in double, into (mu, sigma = sqrt(M2 / n)).
//    Deterministic, and never E[x^2] - mu^2.
// 3. scale_kernel, grid (chunks, P): reads each chunk again and writes
//    (x - mu) / (sigma + 1e-6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"

namespace {

constexpr float kEps = 1e-6f;
constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kChunk = kThreads * kItems;

template <typename T>
__global__ void __launch_bounds__(kThreads) partials_kernel(
    const T* __restrict__ x, int64_t plane, int chunks,
    float* __restrict__ part) {
  __shared__ float red[kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kChunk;
  const T* p = x + blockIdx.y * plane + base;
  const int cnt = static_cast<int>(min(static_cast<int64_t>(kChunk), plane - base));
  float v[kItems];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = threadIdx.x + k * kThreads;
    v[k] = i < cnt ? static_cast<float>(__ldg(p + i)) : 0.f;
    s += v[k];
  }
  const float mean = vacv::block_sum<kThreads>(s, red) / cnt;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const float d = v[k] - mean;
    if (i < cnt) q += d * d;
  }
  const float m2 = vacv::block_sum<kThreads>(q, red);
  if (threadIdx.x == 0) {
    float* o = part + (static_cast<int64_t>(blockIdx.y) * chunks + blockIdx.x) * 3;
    o[0] = static_cast<float>(cnt);
    o[1] = mean;
    o[2] = m2;
  }
}

struct Moments {
  double n, mean, m2;
};

// Chan's parallel update of two (n, mean, M2) triples.
__device__ Moments chan_merge(Moments a, Moments b) {
  const double n = a.n + b.n;
  if (n == 0.0) return a;
  const double delta = b.mean - a.mean;
  return {n, a.mean + delta * b.n / n, a.m2 + b.m2 + delta * delta * a.n * b.n / n};
}

__global__ void __launch_bounds__(kThreads) merge_kernel(
    const float* __restrict__ part, int chunks, float* __restrict__ stats) {
  __shared__ Moments m[kThreads];
  const float* pp = part + static_cast<int64_t>(blockIdx.x) * chunks * 3;
  Moments acc = {0.0, 0.0, 0.0};
  for (int j = threadIdx.x; j < chunks; j += kThreads)
    acc = chan_merge(acc, {pp[3 * j], pp[3 * j + 1], pp[3 * j + 2]});
  m[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride)
      m[threadIdx.x] = chan_merge(m[threadIdx.x], m[threadIdx.x + stride]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    stats[2 * blockIdx.x] = static_cast<float>(m[0].mean);
    stats[2 * blockIdx.x + 1] = static_cast<float>(sqrt(m[0].m2 / m[0].n));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) scale_kernel(
    const T* __restrict__ x, int64_t plane, const float* __restrict__ stats,
    float* __restrict__ out) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t off = blockIdx.y * plane + base;
  const int cnt = static_cast<int>(min(static_cast<int64_t>(kChunk), plane - base));
  const float mu = __ldg(stats + 2 * blockIdx.y);
  const float denom = __ldg(stats + 2 * blockIdx.y + 1) + kEps;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < cnt) out[off + i] = (static_cast<float>(__ldg(x + off + i)) - mu) / denom;
  }
}

template <typename T>
int launch(const void* x, void* out, int planes, int64_t plane, void* part,
           void* stats, cudaStream_t s) {
  const int chunks = static_cast<int>((plane + kChunk - 1) / kChunk);
  const dim3 grid(chunks, planes);
  const T* xt = static_cast<const T*>(x);
  float* pf = static_cast<float*>(part);
  float* sf = static_cast<float*>(stats);
  partials_kernel<T><<<grid, kThreads, 0, s>>>(xt, plane, chunks, pf);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  merge_kernel<<<planes, kThreads, 0, s>>>(pf, chunks, sf);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scale_kernel<T><<<grid, kThreads, 0, s>>>(xt, plane, sf, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Elements per chunk: the caller sizes `part` as planes * ceil(plane /
// chunk) * 3 floats.
int vacv_normalize_chunk(void) { return kChunk; }

// Normalise `planes` contiguous planes of `plane` elements (u8 when is_u8,
// else f32) from `x` into f32 `out`, each with its own mean and population
// stddev.  `part` and `stats` (planes * 2 floats) are scratch.  Returns a
// cudaError_t (0 on success).
int vacv_normalize_planes(int device, void* stream, const void* x, int is_u8,
                          void* out, int planes, long long plane, void* part,
                          void* stats) {
  cudaGetLastError();  // clear a stale error of an earlier call
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u8) return launch<uint8_t>(x, out, planes, plane, part, stats, s);
  return launch<float>(x, out, planes, plane, part, stats, s);
}

}  // extern "C"
