// Kernel #1's device code (its notes are at the head of preprocess.cu): the
// sources, the resize, moments, scale and NV one-pass kernels and their
// launches, all templates but the scale kernel, so a source that includes
// this builds only what it launches.  preprocess.cu holds the C interface
// of the BGR, planar and NV forms and normalize_kernel, which only it
// launches; preprocess_warp.cu the warp-sampling source and its entry.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "nv_decode.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNormEps = 1e-6f;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kOnePassThreads = 256;
constexpr int kScaleThreads = 256;
constexpr int kScaleHeld = 8;  // words a scale thread loads before its statistics
constexpr int kMaxDevices = 64;
constexpr float kTwo23 = 8388608.0f;  // 2^23, bits 0x4B000000

struct Stats {
  float mean[3];
  float std[3];
};

// Interleaved (N, h, w, 3) u8 frames; a tap reads its 3 bytes.
struct BgrSource {
  const uint8_t* p;  // frame 0, or frame n after frame(n)
  int h, w;

  __device__ BgrSource frame(int n) const {
    return {p + static_cast<int64_t>(n) * h * w * 3, h, w};
  }
  __device__ void load(int y, int x, float c[3]) const {
    const uint8_t* q = p + (static_cast<int64_t>(y) * w + x) * 3;
    c[0] = __ldg(q);
    c[1] = __ldg(q + 1);
    c[2] = __ldg(q + 2);
  }
};

// Planar (N, 3, h, w) u8 planes, rows w bytes apart (the affine warp's
// output); a tap reads channel c of frame n at ((n 3 + c) h + y) w + x.
struct PlanarSource {
  const uint8_t* p;  // frame 0, or frame n after frame(n)
  int h, w;

  __device__ PlanarSource frame(int n) const {
    return {p + static_cast<int64_t>(n) * 3 * h * w, h, w};
  }
  __device__ void load(int y, int x, float c[3]) const {
    const uint8_t* q = p + static_cast<int64_t>(y) * w + x;
    const int64_t plane = static_cast<int64_t>(h) * w;
    c[0] = __ldg(q);
    c[1] = __ldg(q + plane);
    c[2] = __ldg(q + 2 * plane);
  }
};

// Stacked (N, h * 3 / 2, w) u8 NV buffers (h, w even): h Y rows, then h / 2
// rows of chroma pairs.  A tap reads its Y byte and its pair and decodes
// them to B, G, R (R, G, B with to_rgb).
template <bool IS_NV12>
struct NvSource {
  const uint8_t* p;  // frame 0, or frame n after frame(n)
  int h, w;          // Y plane
  int to_rgb;

  __device__ NvSource frame(int n) const {
    return {p + static_cast<int64_t>(n) * (h / 2 * 3) * w, h, w, to_rgb};
  }
  __device__ void load(int y, int x, float c[3]) const {
    const int yv = __ldg(p + static_cast<int64_t>(y) * w + x);
    const uint8_t* pair = p + static_cast<int64_t>(h + (y >> 1)) * w + (x & ~1);
    int b, g, r;
    vacv::decode_q7<IS_NV12>(yv, __ldg(pair), __ldg(pair + 1), b, g, r);
    c[0] = static_cast<float>(to_rgb ? r : b);
    c[1] = static_cast<float>(g);
    c[2] = static_cast<float>(to_rgb ? b : r);
  }
};

// The runtime top, clamped so that a value out of contract never reads
// outside the frame.
__device__ __forceinline__ int crop_top(const int* top_ptr, int top, int h, int ch) {
  const int t = top_ptr != nullptr ? __ldg(top_ptr) : top;
  return min(max(t, 0), h - ch);
}

// The three channels of output pixel (oy, ox) resized from `frame` in f32,
// in the reference's order: for each horizontal tap the vertical sum, then
// the horizontal sum.  Source rows start at y0, columns at x0.
template <class Source, int KY, int KX>
__device__ __forceinline__ void resample(const Source& frame, int y0, int x0, int oy, int ox,
                                         const float* __restrict__ ywt,
                                         const float* __restrict__ xwt, float acc[3]) {
  float wy[KY];
#pragma unroll
  for (int ky = 0; ky < KY; ++ky) wy[ky] = __ldg(ywt + oy * KY + ky);
  acc[0] = acc[1] = acc[2] = 0.f;
#pragma unroll
  for (int kx = 0; kx < KX; ++kx) {
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
#pragma unroll
    for (int ky = 0; ky < KY; ++ky) {
      float c[3];
      frame.load(y0 + ky, x0 + kx, c);
      v0 += wy[ky] * c[0];
      v1 += wy[ky] * c[1];
      v2 += wy[ky] * c[2];
    }
    const float wx = __ldg(xwt + ox * KX + kx);
    acc[0] += wx * v0;
    acc[1] += wx * v1;
    acc[2] += wx * v2;
  }
}

// The u8 epilogue clip(floor(x + eps), 0, 255), as a float.
__device__ __forceinline__ float truncate_u8(float v, float eps) {
  return fminf(fmaxf(floorf(v + eps), 0.f), 255.f);
}

template <class Source, int KY, int KX>
__global__ void __launch_bounds__(kBlockX * kBlockY) resize_kernel(
    Source source, float* __restrict__ out, int left, int ch, int top,
    const int* __restrict__ top_ptr, int oh, int ow,
    const int* __restrict__ ystart, const float* __restrict__ ywt,
    const int* __restrict__ xstart, const float* __restrict__ xwt,
    int trunc_u8, float eps, int static_norm, Stats st) {
  const int ox = blockIdx.x * kBlockX + threadIdx.x;
  const int oy = blockIdx.y * kBlockY + threadIdx.y;
  const int n = blockIdx.z;
  if (ox >= ow || oy >= oh) return;

  const int t = crop_top(top_ptr, top, source.h, ch);
  const Source frame = source.frame(n);
  float acc[3];
  resample<Source, KY, KX>(frame, t + __ldg(ystart + oy), left + __ldg(xstart + ox), oy, ox, ywt,
                           xwt, acc);

  const int64_t plane = static_cast<int64_t>(oh) * ow;
  float* o = out + static_cast<int64_t>(n) * 3 * plane +
             static_cast<int64_t>(oy) * ow + ox;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = acc[c];
    if (trunc_u8) v = truncate_u8(v, eps);
    if (static_norm) v = (v - st.mean[c]) / (st.std[c] + kNormEps);
    o[c * plane] = v;
  }
}

// Byte e (0..3) of w as a float, through the adder: or it into 2^23's
// mantissa and subtract 2^23.
__device__ __forceinline__ float byte_to_float(uint32_t w, int e) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + e)) - kTwo23;
}

// Bytes [first, first + B) as floats: the aligned 4-byte words that hold
// them read through L1 (only those: an aligned word never crosses a page),
// funnel-shifted so that the stream starts at `first`, each byte turned
// into a float on the adder.
template <int B>
__device__ __forceinline__ void load_bytes(const uint8_t* first, float f[B]) {
  constexpr int M = (B + 6) / 4;  // words that hold B bytes at any offset
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(first) & 3);
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(first - s);
  uint32_t w[M + 1];
#pragma unroll
  for (int i = 0; i < M; ++i) w[i] = 4 * i < s + B ? __ldg(wp + i) : 0u;
  w[M] = 0u;
  uint32_t u[M];
#pragma unroll
  for (int i = 0; i < M; ++i) u[i] = __funnelshift_r(w[i], w[i + 1], 8 * s);
#pragma unroll
  for (int b = 0; b < B; ++b) f[b] = byte_to_float(u[b >> 2], b & 3);
}

// KX taps of row y from column x, all three channels, as the moments form
// reads them (load_bytes): an interleaved frame's 3 KX bytes, or KX bytes
// of each channel's plane.
template <int KX>
__device__ __forceinline__ void load_row(const BgrSource& frame, int y, int x, float c[KX][3]) {
  float f[3 * KX];
  load_bytes<3 * KX>(frame.p + (static_cast<int64_t>(y) * frame.w + x) * 3, f);
#pragma unroll
  for (int kx = 0; kx < KX; ++kx)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[kx][ch] = f[3 * kx + ch];
}

template <int KX>
__device__ __forceinline__ void load_row(const PlanarSource& frame, int y, int x,
                                         float c[KX][3]) {
  const int64_t plane = static_cast<int64_t>(frame.h) * frame.w;
  const uint8_t* q = frame.p + static_cast<int64_t>(y) * frame.w + x;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float f[KX];
    load_bytes<KX>(q + ch * plane, f);
#pragma unroll
    for (int kx = 0; kx < KX; ++kx) c[kx][ch] = f[kx];
  }
}

// The moments form's launch 1 (see the top of the file).  Blocks of 32 x 8
// threads, a thread an output pixel (ox, oy) of frame blockIdx.z, all three
// channels, its taps read as words (load_row): the truncated values as u8
// planes shaped as the output into `planes`, and the block's moments sum
// x[3], sum x^2[3] at slots[(frame parts + blockIdx.y gridDim.x +
// blockIdx.x) 6], parts = gridDim.x gridDim.y.  Source: BgrSource or
// PlanarSource.
template <class Source, int KY, int KX>
__global__ void __launch_bounds__(kBlockX * kBlockY) moments_resize_kernel(
    Source source, uint8_t* __restrict__ planes, unsigned long long* __restrict__ slots,
    int left, int ch, int top, const int* __restrict__ top_ptr, int oh, int ow,
    const int* __restrict__ ystart, const float* __restrict__ ywt,
    const int* __restrict__ xstart, const float* __restrict__ xwt, float eps) {
  // Each warp's sum x[3], sum x^2[3] (the block's are below 2^32: 256 pixels).
  __shared__ uint32_t part[kBlockY][6];
  // The scale launch, a programmatic dependent launch, may be scheduled once
  // every block of this grid has started; it waits for our memory.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int ox = blockIdx.x * kBlockX + threadIdx.x;
  const int oy = blockIdx.y * kBlockY + threadIdx.y;
  const int n = blockIdx.z;
  uint32_t u[3] = {0, 0, 0};
  if (ox < ow && oy < oh) {
    const int t = crop_top(top_ptr, top, source.h, ch);
    const Source frame = source.frame(n);
    const int y0 = t + __ldg(ystart + oy), x0 = left + __ldg(xstart + ox);
    // The order of resample(): for each horizontal tap the vertical sum,
    // each sum taken over ky in order.
    float v[KX][3];
#pragma unroll
    for (int ky = 0; ky < KY; ++ky) {
      float c[KX][3];
      load_row<KX>(frame, y0 + ky, x0, c);
      const float wy = __ldg(ywt + oy * KY + ky);
#pragma unroll
      for (int kx = 0; kx < KX; ++kx)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (ky == 0) v[kx][k] = 0.f;
          v[kx][k] += wy * c[kx][k];
        }
    }
    float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int kx = 0; kx < KX; ++kx) {
      const float wx = __ldg(xwt + ox * KX + kx);
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[k] += wx * v[kx][k];
    }
    const int64_t plane = static_cast<int64_t>(oh) * ow;
    const int64_t o = static_cast<int64_t>(n) * 3 * plane + static_cast<int64_t>(oy) * ow + ox;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // An integer in [0, 255]: added to 2^23 it is the low mantissa byte.
      u[k] = __float_as_uint(truncate_u8(acc[k], eps) + kTwo23) & 0xffu;
      planes[o + k * plane] = static_cast<uint8_t>(u[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const uint32_t v = __reduce_add_sync(0xffffffffu, k < 3 ? u[k] : u[k - 3] * u[k - 3]);
    if (threadIdx.x == k) part[threadIdx.y][k] = v;  // a warp is a row of the block
  }
  __syncthreads();
  if (tid < 6) {
    uint32_t sum = 0;
#pragma unroll
    for (int r = 0; r < kBlockY; ++r) sum += part[r][tid];
    const int64_t parts = static_cast<int64_t>(gridDim.x) * gridDim.y;
    slots[(n * parts + blockIdx.y * gridDim.x + blockIdx.x) * 6 + tid] = sum;
  }
}

// The moments form's launch 2 (see the top of the file).  grid (blocks,
// frames x 3); block b of plane p = 3 n + c adds frame n's `parts` slots of
// channel c, then scales its share of the plane's u8 values into `out`:
// (x - mu) * (1 / (sigma + eps)) in f32, as float4s from 4-byte words when
// the plane is a multiple of 4 values (each plane then starts 16-byte
// aligned), else one value at a time.
__global__ void __launch_bounds__(kScaleThreads) scale_u8_kernel(
    const uint8_t* __restrict__ in, float* __restrict__ out,
    const unsigned long long* __restrict__ slots, int parts, int64_t plane, int have_mean,
    int have_std, Stats st) {
  __shared__ unsigned long long part[2][kScaleThreads / 32];  // each warp's sum x, sum x^2
  __shared__ float stat[2];                                     // mu, 1 / (sigma + eps)
  const int p = blockIdx.y, n = p / 3, c = p % 3;
  const uint8_t* src = in + static_cast<int64_t>(p) * plane;
  float* dst = out + static_cast<int64_t>(p) * plane;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kScaleThreads + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kScaleThreads;
  const bool quads = (plane & 3) == 0;
  const unsigned* words = reinterpret_cast<const unsigned*>(src);
  // Launch 1 may still run: wait until its memory is complete and visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  uint32_t held[kScaleHeld];  // this thread's first words, loaded before the statistics
#pragma unroll
  for (int k = 0; k < kScaleHeld; ++k) {
    const int64_t q = first + k * step;
    held[k] = quads && q < plane / 4 ? __ldcg(words + q) : 0u;
  }
  {
    // The frame's slots of channel c, all loads in flight at once.
    const unsigned long long* mine = slots + static_cast<int64_t>(n) * parts * 6;
    unsigned long long sx = 0, sxx = 0;
    for (int b = threadIdx.x; b < parts; b += kScaleThreads) {
      sx += __ldcg(mine + b * 6 + c);
      sxx += __ldcg(mine + b * 6 + 3 + c);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sx += __shfl_xor_sync(0xffffffffu, sx, o);
      sxx += __shfl_xor_sync(0xffffffffu, sxx, o);
    }
    if ((threadIdx.x & 31) == 0) part[0][threadIdx.x >> 5] = sx, part[1][threadIdx.x >> 5] = sxx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sx = 0, sxx = 0;
#pragma unroll
    for (int w = 0; w < kScaleThreads / 32; ++w) sx += part[0][w], sxx += part[1][w];
    // N^2 var = N sum x^2 - (sum x)^2, exact: the plan keeps a frame under
    // 2^32 / 255 pixels, so both terms stay below 2^64.  The NV one-pass
    // kernel forms its statistics the same way; ops/cuda/preprocess.py's
    // one_pass_stats is the host twin of both.
    const unsigned long long count = static_cast<unsigned long long>(plane);
    const double n_var = static_cast<double>(count * sxx - sx * sx);
    const double inv_n = 1.0 / static_cast<double>(count);
    stat[0] = have_mean ? st.mean[c] : static_cast<float>(static_cast<double>(sx) * inv_n);
    const float sd = have_std ? st.std[c] : static_cast<float>(sqrt(n_var) * inv_n);
    stat[1] = 1.f / (sd + kNormEps);
  }
  __syncthreads();
  const float mu = stat[0], inv = stat[1];
  if (quads) {
    float4* out4 = reinterpret_cast<float4*>(dst);
    auto put = [&](int64_t q, uint32_t word) {
      out4[q] = make_float4(
          (byte_to_float(word, 0) - mu) * inv, (byte_to_float(word, 1) - mu) * inv,
          (byte_to_float(word, 2) - mu) * inv, (byte_to_float(word, 3) - mu) * inv);
    };
#pragma unroll
    for (int k = 0; k < kScaleHeld; ++k)
      if (first + k * step < plane / 4) put(first + k * step, held[k]);
    for (int64_t q = first + kScaleHeld * step; q < plane / 4; q += step) put(q, __ldcg(words + q));
  } else {
    for (int64_t i = first; i < plane; i += step)
      dst[i] = (static_cast<float>(__ldcg(src + i)) - mu) * inv;
  }
}

// The NV one-pass form (see the top of the file).  grid (C, frames), one
// cooperative launch; block r of a frame owns output rows
// [r rows, r rows + rows).  Dynamic shared memory: three channel strips of
// `chan` bytes (a multiple of 16), channel c's value i at byte shift_c + i,
// where shift_c is the output's misalignment below a float4 at the strip's
// start, so that a float4 of output reads one aligned word of the strip.
// `evict_first` marks the output's lines evict-first in L2 (an output too
// large to stay there beside the source).  The launch bounds hold a thread
// to 32 registers, so that registers never keep a block from being
// resident: the wrapper's plan counts the blocks an SM holds from threads
// and shared memory alone, and a cooperative launch needs them all.
template <class Source, int KY, int KX>
__global__ void __launch_bounds__(kOnePassThreads, 2048 / kOnePassThreads) nv_one_pass_kernel(
    Source source, float* __restrict__ out, unsigned long long* __restrict__ slots, int left,
    int ch, int top, const int* __restrict__ top_ptr, int oh, int ow, int rows, int chan,
    const int* __restrict__ ystart, const float* __restrict__ ywt,
    const int* __restrict__ xstart, const float* __restrict__ xwt, float eps,
    int have_mean, int have_std, int evict_first, Stats st) {
  extern __shared__ __align__(16) uint8_t strip[];
  __shared__ unsigned long long part[6];   // this block's sum x[3], sum x^2[3]
  __shared__ unsigned long long total[6];  // the frame's: its blocks' slots added
  __shared__ float stat[6];                // mu[3], 1 / (sigma + eps)[3]
  constexpr int THREADS = kOnePassThreads;
  if (threadIdx.x < 6) part[threadIdx.x] = 0;
  __syncthreads();  // `part` is zero before any warp adds to it
  const int csize = static_cast<int>(gridDim.x);
  const int rank = static_cast<int>(blockIdx.x);
  const int n = blockIdx.y;
  const int r0 = min(rank * rows, oh);
  const int len = (min(r0 + rows, oh) - r0) * ow;
  const int64_t plane = static_cast<int64_t>(oh) * ow;
  const int64_t start = static_cast<int64_t>(n) * 3 * plane + static_cast<int64_t>(r0) * ow;
  int shift[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) shift[c] = static_cast<int>((start + c * plane) & 3);

  const int t = crop_top(top_ptr, top, source.h, ch);
  const Source frame = source.frame(n);
  uint32_t s1[3] = {0, 0, 0}, s2[3] = {0, 0, 0};
  int oy = r0 + static_cast<int>(threadIdx.x) / ow, ox = static_cast<int>(threadIdx.x) % ow;
  const int dy = THREADS / ow, dx = THREADS % ow;
  for (int i = threadIdx.x; i < len; i += THREADS) {
    float acc[3];
    resample<Source, KY, KX>(frame, t + __ldg(ystart + oy), left + __ldg(xstart + ox), oy, ox, ywt,
                             xwt, acc);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // An integer in [0, 255]: added to 2^23 it is the low mantissa byte.
      const uint32_t u = __float_as_uint(truncate_u8(acc[c], eps) + kTwo23) & 0xffu;
      strip[c * chan + shift[c] + i] = static_cast<uint8_t>(u);
      s1[c] += u;
      s2[c] += u * u;
    }
    ox += dx, oy += dy;
    if (ox >= ow) ox -= ow, ++oy;
  }

  // A warp's sums fit 32 bits (the plan keeps a thread under 2064 pixels:
  // 32 x 2064 x 255^2 < 2^32); the block's and the frame's take 64.
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const uint32_t v = __reduce_add_sync(0xffffffffu, k < 3 ? s1[k] : s2[k - 3]);
    if ((threadIdx.x & 31) == 0) atomicAdd(&part[k], static_cast<unsigned long long>(v));
  }
  __syncthreads();  // `part` and the strip are complete
  // Each block's moments to its own slot, then every block of the frame
  // adds the frame's slots up.
  unsigned long long* mine = slots + static_cast<int64_t>(n) * csize * 6;
  if (threadIdx.x < 6) mine[rank * 6 + threadIdx.x] = part[threadIdx.x];
  __threadfence();
  cg::this_grid().sync();
  if (threadIdx.x < 6) {
    unsigned long long sum = 0;
    for (int r = 0; r < csize; ++r) sum += __ldcg(mine + r * 6 + threadIdx.x);
    total[threadIdx.x] = sum;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int c = threadIdx.x;
    const unsigned long long sx = total[c], sxx = total[3 + c];
    const unsigned long long count = static_cast<unsigned long long>(plane);
    // N^2 var = N sum x^2 - (sum x)^2, exact: the plan keeps a frame under
    // 2^32 / 255 pixels, so both terms stay below 2^64.
    const double n_var = static_cast<double>(count * sxx - sx * sx);
    const double inv_n = 1.0 / static_cast<double>(count);
    const float mu = have_mean ? st.mean[c] : static_cast<float>(static_cast<double>(sx) * inv_n);
    const float sd = have_std ? st.std[c] : static_cast<float>(sqrt(n_var) * inv_n);
    stat[c] = mu;
    stat[3 + c] = 1.f / (sd + kNormEps);
  }
  __syncthreads();

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mu = stat[c], inv = stat[3 + c];
    const int s = shift[c];
    const uint8_t* held = strip + c * chan;    // held[s + i]: value i
    float* o = out + (start + c * plane - s);  // 16-byte aligned
    for (int q = threadIdx.x; 4 * q < s + len; q += THREADS) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(held + 4 * q);
      const int lo = max(s - 4 * q, 0), hi = min(s + len - 4 * q, 4);
      if (lo == 0 && hi == 4) {
        const float4 f = make_float4(
            (byte_to_float(word, 0) - mu) * inv, (byte_to_float(word, 1) - mu) * inv,
            (byte_to_float(word, 2) - mu) * inv, (byte_to_float(word, 3) - mu) * inv);
        if (evict_first) {
          __stcs(reinterpret_cast<float4*>(o + 4 * q), f);
        } else {
          *reinterpret_cast<float4*>(o + 4 * q) = f;
        }
      } else {
        for (int e = lo; e < hi; ++e) o[4 * q + e] = (byte_to_float(word, e) - mu) * inv;
      }
    }
  }
}

// Launch 1 for one source kind, tap counts up to MAX_K each way.
template <int MAX_K, class Source>
int launch_resize(int device, void* stream, Source source, void* out, int n,
                  int left, int ch, int top, const void* top_ptr, int oh,
                  int ow, const void* ystart, const void* ywt, int ky,
                  const void* xstart, const void* xwt, int kx, int trunc_u8,
                  float eps, int static_norm, Stats st) {
  cudaGetLastError();  // clear a stale error of an earlier call
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((ow + kBlockX - 1) / kBlockX, (oh + kBlockY - 1) / kBlockY,
                  n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* outf = static_cast<float*>(out);
  const int* tp = static_cast<const int*>(top_ptr);
  const int* ys = static_cast<const int*>(ystart);
  const float* yw = static_cast<const float*>(ywt);
  const int* xs = static_cast<const int*>(xstart);
  const float* xw = static_cast<const float*>(xwt);
#define VACV_RESIZE_CASE(KY, KX)                                             \
  if constexpr (KY <= MAX_K && KX <= MAX_K) {                                \
    if (ky == KY && kx == KX) {                                              \
      resize_kernel<Source, KY, KX><<<grid, block, 0, s>>>(                  \
          source, outf, left, ch, top, tp, oh, ow, ys, yw, xs, xw, trunc_u8, \
          eps, static_norm, st);                                             \
      return static_cast<int>(cudaGetLastError());                           \
    }                                                                        \
  }
  VACV_RESIZE_CASE(2, 2)
  VACV_RESIZE_CASE(4, 4)
  VACV_RESIZE_CASE(1, 1)
  VACV_RESIZE_CASE(1, 2)
  VACV_RESIZE_CASE(2, 1)
  VACV_RESIZE_CASE(1, 4)
  VACV_RESIZE_CASE(4, 1)
  VACV_RESIZE_CASE(2, 4)
  VACV_RESIZE_CASE(4, 2)
#undef VACV_RESIZE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The moments form's two launches for one source kind (see
// vacv_preprocess_moments).
template <class Source>
int launch_moments(cudaStream_t s, Source source, float* out, uint8_t* planes,
                   unsigned long long* slots, int n, int left, int ch, int top,
                   const int* top_ptr, int oh, int ow, const int* ystart, const float* ywt, int ky,
                   const int* xstart, const float* xwt, int kx, float eps, int blocks,
                   int have_mean, int have_std, Stats st) {
  const int64_t plane = static_cast<int64_t>(oh) * ow;
  const int parts = ((ow + kBlockX - 1) / kBlockX) * ((oh + kBlockY - 1) / kBlockY);
  const dim3 grid((ow + kBlockX - 1) / kBlockX, (oh + kBlockY - 1) / kBlockY, n);
  const dim3 block(kBlockX, kBlockY);
  cudaError_t e = cudaErrorInvalidValue;
#define VACV_MOMENTS_CASE(KY, KX)                                                          \
  if (ky == KY && kx == KX) {                                                              \
    moments_resize_kernel<Source, KY, KX><<<grid, block, 0, s>>>(                          \
        source, planes, slots, left, ch, top, top_ptr, oh, ow, ystart, ywt, xstart, xwt, eps); \
    e = cudaGetLastError();                                                                \
  }
  VACV_MOMENTS_CASE(2, 2)
  VACV_MOMENTS_CASE(4, 4)
  VACV_MOMENTS_CASE(1, 1)
  VACV_MOMENTS_CASE(1, 2)
  VACV_MOMENTS_CASE(2, 1)
  VACV_MOMENTS_CASE(1, 4)
  VACV_MOMENTS_CASE(4, 1)
  VACV_MOMENTS_CASE(2, 4)
  VACV_MOMENTS_CASE(4, 2)
#undef VACV_MOMENTS_CASE
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 3 * n);
  cfg.blockDim = dim3(kScaleThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, scale_u8_kernel,
                                             static_cast<const uint8_t*>(planes), out,
                                             static_cast<const unsigned long long*>(slots),
                                             parts, plane, have_mean, have_std, st));
}

// Opt one one-pass kernel into the largest dynamic shared memory the card
// allows (once per device); `limit` gets the dynamic bytes a block may hold.
template <class Source, int KY, int KX>
int one_pass_smem(int device, int* limit) {
  static int known[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!known[device]) {
    auto kernel = nv_one_pass_kernel<Source, KY, KX>;
    int max_smem = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem - static_cast<int>(fa.sharedSizeBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    known[device] = max_smem - static_cast<int>(fa.sharedSizeBytes);
  }
  *limit = known[device];
  return 0;
}

// The arguments of a one-pass launch after the source and the output.
struct OnePassArgs {
  int left, ch, top;
  const int* top_ptr;
  int oh, ow, rows, chan;
  const int* ystart;
  const float* ywt;
  const int* xstart;
  const float* xwt;
  float eps;
  int have_mean, have_std, evict_first;
  Stats st;
};

// A cooperative launch: every block resident at once (a grid-wide barrier
// needs that), or the card refuses it.
template <class Source, int KY, int KX>
int launch_one_pass_kernel(int device, cudaStream_t s, Source source, float* out, int n,
                           int blocks, unsigned long long* slots, const OnePassArgs& a) {
  int limit = 0;
  const int rc = one_pass_smem<Source, KY, KX>(device, &limit);
  if (rc != 0) return rc;
  const int smem = 3 * a.chan;
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {(void*)&source, (void*)&out,       (void*)&slots,  (void*)&a.left,
                  (void*)&a.ch,   (void*)&a.top,     (void*)&a.top_ptr, (void*)&a.oh,
                  (void*)&a.ow,   (void*)&a.rows,    (void*)&a.chan, (void*)&a.ystart,
                  (void*)&a.ywt,  (void*)&a.xstart,  (void*)&a.xwt,  (void*)&a.eps,
                  (void*)&a.have_mean, (void*)&a.have_std, (void*)&a.evict_first,
                  (void*)&a.st};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(nv_one_pass_kernel<Source, KY, KX>), dim3(blocks, n),
      dim3(kOnePassThreads), args, static_cast<size_t>(smem), s));
}

template <class Source>
int launch_one_pass(int device, cudaStream_t s, Source source, float* out, int n, int blocks,
                    int ky, int kx, unsigned long long* slots, const OnePassArgs& a) {
#define VACV_ONE_PASS_CASE(KY, KX) \
  if (ky == KY && kx == KX)        \
    return launch_one_pass_kernel<Source, KY, KX>(device, s, source, out, n, blocks, slots, a);
  VACV_ONE_PASS_CASE(2, 2)
  VACV_ONE_PASS_CASE(1, 2)
  VACV_ONE_PASS_CASE(2, 1)
  VACV_ONE_PASS_CASE(1, 1)
#undef VACV_ONE_PASS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
