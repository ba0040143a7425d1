// Fused [NV decode ->] crop -> resize -> u8 truncation -> planar f32 ->
// normalise, for Hopper (sm_90a), with a plain C interface loaded by ctypes
// (vacv_tpu_torch/ops/cuda/preprocess.py).
//
// Replaces two TPU kernels of vacv_tpu/ops/pallas/preprocess.py: _kernel,
// behind preprocess_fused_batch (BASELINE config 4, interleaved BGR
// frames), and _kernel_nv, behind preprocess_fused_nv_batch (the camera
// form: stacked NV21/NV12 buffers, decoded inside the kernel).  What they
// compute is the same; how is not.  The TPU kernels stream every crop row
// through VMEM and resample with banded bf16 matmuls; the NV one also
// spreads chroma with lane rolls and repeats chroma rows with a 0/1
// matmul, all because the TPU has no fast gather.  Here each thread
// gathers its own taps through L1, and the kernels are templates that
// differ only in how a tap is read (the Source policy below): interleaved
// BGR frames, stacked NV buffers, or planar (N, 3, h, w) u8 planes, the
// affine warp's output, which preprocess_fused_planes takes for BASELINE
// config 5's tail (resize -> truncation -> normalize of the whole warped
// batch in one call, where the JAX package vmaps its per-frame tail).
//
// Bound: bytes.  The source rows that carry a tap are read once and the
// (N, 3, oh, ow) f32 planes are written once.  There are a few dozen flops
// per output pixel, far below what the card could do with the bytes it
// moves.  Only the source rows that carry a nonzero tap are read: at 1080p
// -> 224 the taps touch 448 of the 1036 crop rows, and in those rows the
// 32-byte sectors of nearly every column.  An NV tap reads one Y byte and
// one chroma pair, shared by 2 x 2 Y pixels, so the chroma rows the tapped
// Y rows map to are read once through L1/L2.
//
// Every form computes in f32 in the reference's order: for each horizontal
// tap the vertical sum, then the horizontal sum; then the u8 epilogue
// clip(floor(x + eps), 0, 255); then (x - mean) / (std + 1e-6).  The host
// turns each dense resize weight matrix into a tap table: for every output
// row (column) a start index and K weights (K = 2 linear, 4 cubic, 1
// nearest; the NV form is linear only, as in the JAX package).
//
// Launch 1 (resize_kernel, any source): one thread per output pixel,
// all three channels, 32 x 8 pixels a block, each tap's bytes gathered
// through L1 (resample below); f32 out (static statistics, normalize=False,
// or before the normalize launch for untruncated self statistics).  An NV
// tap is decoded on the fly with the bit-exact Q7 math (nv_decode.cuh); its
// chroma row comes from the absolute Y row, top + ystart[oy] + ky, and its
// pair from the absolute column, x & ~1, so any top and left parity is
// right.  Staging each block's or each warp's BGR tap rows in shared memory
// with 16-byte cp.async measured slower at every batch and interpolation
// on the H100 (it cut the resident warps to what shared memory holds, and a
// warp waited for all its rows before its first tap), and so did reading
// the BGR taps as words for f32 output at 8 frames linear and nearest and
// at 128 cubic (PERF.md).
//
// The moments form (BGR or planar, truncated output, self-computed
// statistics: the config-4 main path and the config-5 tail).  Launch 1
// (moments_resize_kernel) stores the
// truncated planes as u8 (4.8 MB at 32 x 224^2 against 19.3 MB of f32) and
// each block's exact integer moments per channel, sum x and sum x^2, in a
// slot of its own: a warp reduce, then one barrier.  It reads a tap row's
// bytes as the aligned 4-byte words that hold them (load_bytes, through
// L1), funnel-shifted into place and turned into floats on the adder: a BGR
// row's 3 KX interleaved bytes in 2 to 4 words (6 loads a linear pixel and
// 16 a cubic one, where three byte loads a tap take 12 and 48), a planar
// row's KX bytes of each channel's plane in 1 or 2 words a channel (the
// Source's load_row).  Launch 2 (scale_u8_kernel) adds a frame's
// slots, forms mu and sigma from the integers in double, reads the u8
// planes as 4-byte words and stores float4s (evict-first stores measured
// no faster at 32 and 128 frames).  The f32 planes are written once and
// never read back.  Integer sums do not
// depend on order, so the result has the same bits on every run, and
// N sum x^2 - (sum x)^2 in 64-bit integers is exact, not a cancellation
// hazard.  Launch 2 is a programmatic dependent launch: its blocks may take
// the SMs launch 1's last wave frees, issue their loads of the slots and
// of their first u8 words as soon as launch 1's memory is complete
// (griddepcontrol.wait), and form the statistics while those words arrive.
// (Splitting the frames into chunks, each chunk's launch 2 beside the next
// chunk's launch 1, measured no faster at 8, 32 and 128 frames.)
//
// The two-launch form (resize_kernel, then normalize_kernel), where a
// statistic is self-computed and neither the moments nor the NV one-pass
// form serves the call: launch 1, then one block per (frame, channel) plane, a
// two-pass mean and population stddev (the stddev around the plane's own
// mean, also when a static mean is given), then the plane is scaled in
// place.
//
// The NV one-pass form (nv_one_pass_kernel), for truncated NV output with
// a self-computed statistic (the camera main path): one launch.  C
// blocks take a frame; block r owns output rows [r R, r R + R) of all three
// channels (R = ceil(oh / C); the wrapper's launch_plan picks C), so each
// tap is read once.  The strip's truncated values stay in shared memory as
// u8 (3 R ow bytes: 9.4 KB at C = 16, 224 x 224), with the integer moments
// above.  A frame's blocks meet in a cooperative launch: each block's
// moments go to a slot of a small scratch array, one grid-wide barrier,
// then each block adds its frame's slots.  (A thread-block cluster a frame,
// adding the moments through distributed shared memory, holds at most 16
// blocks on one GPC, and the card held only 28 clusters of 16 at once.)
// Then each block forms mu and sigma as above, scales its strip from
// shared memory and stores float4s.
//
// Measured on the H100 (PERF.md): the NV one-pass form takes about as long
// as launch 1 and launch 2 together at 32 frames of 224^2 and less at 1, 8
// and 128.  Built for BGR, it was slower than the moments form in 9 of 12
// cells of 1, 8, 32 and 128 frames x 3 interpolations (1.6 to 2.5x at
// cubic) and faster by 2 to 9% in three (8 frames linear and nearest, 128
// nearest), so BGR keeps the moments form alone.

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
constexpr int kNormThreads = 512;
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

__global__ void __launch_bounds__(kNormThreads) normalize_kernel(
    float* __restrict__ out, int64_t plane, int have_mean, int have_std,
    Stats st) {
  __shared__ float red[kNormThreads / 32];
  float* p = out + static_cast<int64_t>(blockIdx.x) * plane;
  const int c = blockIdx.x % 3;
  const float count = static_cast<float>(plane);

  float s = 0.f;
  for (int64_t i = threadIdx.x; i < plane; i += kNormThreads) s += p[i];
  const float self_mean = vacv::block_sum<kNormThreads>(s, red) / count;

  float sd;
  if (have_std) {
    sd = st.std[c];
  } else {
    float q = 0.f;
    for (int64_t i = threadIdx.x; i < plane; i += kNormThreads) {
      const float d = p[i] - self_mean;
      q += d * d;
    }
    sd = sqrtf(vacv::block_sum<kNormThreads>(q, red) / count);
  }
  const float mu = have_mean ? st.mean[c] : self_mean;
  const float denom = sd + kNormEps;
  for (int64_t i = threadIdx.x; i < plane; i += kNormThreads)
    p[i] = (p[i] - mu) / denom;
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

extern "C" {

// Launch 1 over (n, h, w, 3) u8 BGR frames, or, with `planar`, over (n, 3,
// h, w) u8 planes.  Pointers are device pointers; top_ptr may be null, and
// then `top` is used.  Returns a cudaError_t (0 on success).
int vacv_preprocess_resize(int device, void* stream, const void* src,
                           void* out, int n, int h, int w, int planar, int left, int ch,
                           int top, const void* top_ptr, int oh, int ow,
                           const void* ystart, const void* ywt, int ky,
                           const void* xstart, const void* xwt, int kx,
                           int trunc_u8, float eps, int static_norm, float m0,
                           float m1, float m2, float s0, float s1, float s2) {
  const uint8_t* p = static_cast<const uint8_t*>(src);
  const Stats st = {{m0, m1, m2}, {s0, s1, s2}};
  if (planar) {
    return launch_resize<4>(device, stream, PlanarSource{p, h, w}, out, n, left, ch, top,
                            top_ptr, oh, ow, ystart, ywt, ky, xstart, xwt, kx, trunc_u8, eps,
                            static_norm, st);
  }
  return launch_resize<4>(device, stream, BgrSource{p, h, w}, out, n, left, ch, top,
                          top_ptr, oh, ow, ystart, ywt, ky, xstart, xwt, kx, trunc_u8, eps,
                          static_norm, st);
}

// The moments form over (n, h, w, 3) u8 BGR frames, or, with `planar`, (n,
// 3, h, w) u8 planes: the resize launch (moments_resize_kernel: u8 planes
// into `planes`, (n, 3, oh, ow) u8, and its blocks' moments into `slots`,
// ceil(ow / 32) x ceil(oh / 8) x 6 u64 a frame), then the scale launch
// (scale_u8_kernel, a programmatic dependent launch: `blocks` blocks a plane
// scale the planes into `out`, (n, 3, oh, ow) f32, with per-(frame,
// channel) statistics, a self-computed one where have_mean or have_std is
// 0, the given m*, s* otherwise).  The rest as vacv_preprocess_resize.
// Returns a cudaError_t.
int vacv_preprocess_moments(int device, void* stream, const void* src, void* out, void* planes,
                            void* slots, int n, int h, int w, int planar, int left, int ch,
                            int top, const void* top_ptr, int oh, int ow, const void* ystart,
                            const void* ywt, int ky, const void* xstart, const void* xwt, int kx,
                            float eps, int blocks, int have_mean, int have_std, float m0,
                            float m1, float m2, float s0, float s1, float s2) {
  cudaGetLastError();  // clear a stale error of an earlier call
  if (n < 1 || blocks < 1 || n > 65535 / 3 || planes == nullptr || slots == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Stats st = {{m0, m1, m2}, {s0, s1, s2}};
  const uint8_t* p = static_cast<const uint8_t*>(src);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  uint8_t* p8 = static_cast<uint8_t*>(planes);
  unsigned long long* sl = static_cast<unsigned long long*>(slots);
  const int* tp = static_cast<const int*>(top_ptr);
  const int* ys = static_cast<const int*>(ystart);
  const float* yw = static_cast<const float*>(ywt);
  const int* xs = static_cast<const int*>(xstart);
  const float* xw = static_cast<const float*>(xwt);
  if (planar) {
    return launch_moments(s, PlanarSource{p, h, w}, o, p8, sl, n, left, ch, top, tp, oh, ow, ys,
                          yw, ky, xs, xw, kx, eps, blocks, have_mean, have_std, st);
  }
  return launch_moments(s, BgrSource{p, h, w}, o, p8, sl, n, left, ch, top, tp, oh, ow, ys, yw,
                        ky, xs, xw, kx, eps, blocks, have_mean, have_std, st);
}

// Launch 1 over (n, h * 3 / 2, w) u8 stacked NV buffers; h is the Y
// height, and h and w are even.  Linear taps only (ky, kx <= 2).  The rest
// as vacv_preprocess_resize.
int vacv_preprocess_nv_resize(int device, void* stream, const void* src,
                              void* out, int n, int h, int w, int is_nv12,
                              int to_rgb, int left, int ch, int top,
                              const void* top_ptr, int oh, int ow,
                              const void* ystart, const void* ywt, int ky,
                              const void* xstart, const void* xwt, int kx,
                              int trunc_u8, float eps, int static_norm,
                              float m0, float m1, float m2, float s0, float s1,
                              float s2) {
  const uint8_t* p = static_cast<const uint8_t*>(src);
  const Stats st = {{m0, m1, m2}, {s0, s1, s2}};
  if (is_nv12) {
    return launch_resize<2>(device, stream, NvSource<true>{p, h, w, to_rgb},
                            out, n, left, ch, top, top_ptr, oh, ow, ystart,
                            ywt, ky, xstart, xwt, kx, trunc_u8, eps,
                            static_norm, st);
  }
  return launch_resize<2>(device, stream, NvSource<false>{p, h, w, to_rgb},
                          out, n, left, ch, top, top_ptr, oh, ow, ystart, ywt,
                          ky, xstart, xwt, kx, trunc_u8, eps, static_norm, st);
}

// What the wrapper's launch plan needs of the card and the NV one-pass
// kernel, as 4 ints at `limits`: [0] SMs, [1] threads an SM holds, [2] the
// dynamic shared bytes a one-pass block may hold, [3] the shared bytes an
// SM holds.  Returns a cudaError_t.
int vacv_preprocess_limits(int device, void* limits) {
  int* out = static_cast<int*>(limits);
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxThreadsPerMultiProcessor, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[3], cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return one_pass_smem<NvSource<false>, 2, 2>(device, &out[2]);
}

// The NV one-pass form over (n, h * 3 / 2, w) u8 stacked NV buffers (h, w
// even; linear taps, ky, kx <= 2): truncated output normalized with
// per-(frame, channel) statistics, a self-computed one where have_mean or
// have_std is 0 (the given m*, s* otherwise), in one cooperative launch of
// `blocks` blocks a frame of 256 threads, which the card refuses unless
// every block is resident.  `slots` is 6 x blocks x n u64 of scratch.
// Block r owns output rows [r rows, r rows + rows) (blocks * rows >= oh)
// in 3 * chan bytes of shared memory (chan a multiple of 16, at least
// rows * ow + 3).  `evict_first`: store the output so.  The rest as
// vacv_preprocess_nv_resize.  Returns a cudaError_t.
int vacv_preprocess_nv_one_pass(int device, void* stream, const void* src, void* out, int n,
                                int h, int w, int is_nv12, int to_rgb, int left, int ch,
                                int top, const void* top_ptr, int oh, int ow,
                                const void* ystart, const void* ywt, int ky,
                                const void* xstart, const void* xwt, int kx, float eps,
                                int blocks, int rows, int chan, int have_mean, int have_std,
                                int evict_first, void* slots, float m0, float m1, float m2,
                                float s0, float s1, float s2) {
  cudaGetLastError();  // clear a stale error of an earlier call
  if (blocks < 1 || rows < 1 || static_cast<int64_t>(blocks) * rows < oh || chan % 16 ||
      static_cast<int64_t>(chan) < static_cast<int64_t>(rows) * ow + 3 || slots == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const OnePassArgs a = {left, ch, top, static_cast<const int*>(top_ptr), oh, ow, rows, chan,
                         static_cast<const int*>(ystart), static_cast<const float*>(ywt),
                         static_cast<const int*>(xstart), static_cast<const float*>(xwt), eps,
                         have_mean, have_std, evict_first, Stats{{m0, m1, m2}, {s0, s1, s2}}};
  const uint8_t* p = static_cast<const uint8_t*>(src);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  unsigned long long* sl = static_cast<unsigned long long*>(slots);
  const int rc =
      is_nv12 ? launch_one_pass(device, s, NvSource<true>{p, h, w, to_rgb}, o, n, blocks, ky, kx,
                                sl, a)
              : launch_one_pass(device, s, NvSource<false>{p, h, w, to_rgb}, o, n, blocks, ky,
                                kx, sl, a);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Launch 2: normalise `planes` contiguous planes of `plane` floats in
// place; plane i is channel i % 3.  Returns a cudaError_t.
int vacv_preprocess_normalize(int device, void* stream, void* out, int planes,
                              long long plane, int have_mean, int have_std,
                              float m0, float m1, float m2, float s0, float s1,
                              float s2) {
  cudaGetLastError();
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Stats st = {{m0, m1, m2}, {s0, s1, s2}};
  normalize_kernel<<<planes, kNormThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<int64_t>(plane), have_mean,
      have_std, st);
  return static_cast<int>(cudaGetLastError());
}

const char* vacv_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
