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
// gathers its own taps, and the two kernels are one template that differs
// only in how a tap is read (the Source policy below).
//
// Bound: bytes read.  The source is read once and the (N, 3, oh, ow) f32
// planes are written once (and, with self-computed statistics, read and
// rewritten once more by the second launch).  There are a few dozen flops
// per output pixel, far below what the card could do with the bytes it
// moves.
//
// What the design does about it: it reads only the source rows and columns
// that carry a nonzero tap.  At 1080p -> 224 the taps touch 448 of the 1036
// crop rows, and in those rows the 32-byte sectors of nearly every column,
// so about 43% of the crop's bytes.  An NV frame is 1.5 bytes a pixel
// against BGR's 3: a tap reads one Y byte and one chroma pair, and the
// pair is shared by 2 x 2 Y pixels, so the chroma rows the tapped Y rows
// map to are read once through L1/L2.  A whole block of outputs shares the
// rows it reads through L1/L2.  Nothing is staged in shared memory yet:
// this first version is simple and right; making it fast is later work.
//
// Launch 1 (resize_kernel): one thread per output pixel (n, oy, ox), all
// three channels.  The host turns each dense resize weight matrix into a
// tap table: for every output row (column) a start index and K weights
// (K = 2 linear, 4 cubic, 1 nearest; the NV form is linear only, as in the
// JAX package).  The thread computes in f32 in the reference's order: for
// each horizontal tap the vertical sum, then the horizontal sum; then the
// u8 epilogue clip(floor(x + eps), 0, 255); then, with static statistics,
// (x - mean) / (std + 1e-6).  An NV tap is decoded on the fly with the
// bit-exact Q7 math (nv_decode.cuh); its chroma row comes from the
// absolute Y row, top + ystart[oy] + ky, and its pair from the absolute
// column, x & ~1, so any top and left parity is right.
//
// Launch 2 (normalize_kernel), only when a statistic is self-computed: one
// block per (frame, channel) plane, a two-pass mean and population stddev
// (the stddev around the plane's own mean, also when a static mean is
// given), then the plane is scaled in place.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "nv_decode.cuh"

namespace {

constexpr float kNormEps = 1e-6f;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kNormThreads = 512;

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

  // A runtime top comes from the device; clamp it so that a value out of
  // contract never reads outside the frame.
  int t = top_ptr != nullptr ? __ldg(top_ptr) : top;
  t = min(max(t, 0), source.h - ch);

  const Source frame = source.frame(n);
  const int y0 = t + __ldg(ystart + oy);
  const int x0 = left + __ldg(xstart + ox);

  float wy[KY];
#pragma unroll
  for (int ky = 0; ky < KY; ++ky) wy[ky] = __ldg(ywt + oy * KY + ky);

  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
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
    acc0 += wx * v0;
    acc1 += wx * v1;
    acc2 += wx * v2;
  }

  const int64_t plane = static_cast<int64_t>(oh) * ow;
  float* o = out + static_cast<int64_t>(n) * 3 * plane +
             static_cast<int64_t>(oy) * ow + ox;
  const float acc[3] = {acc0, acc1, acc2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = acc[c];
    if (trunc_u8) v = fminf(fmaxf(floorf(v + eps), 0.f), 255.f);
    if (static_norm) v = (v - st.mean[c]) / (st.std[c] + kNormEps);
    o[c * plane] = v;
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

}  // namespace

extern "C" {

// Launch 1 over (n, h, w, 3) u8 BGR frames.  Pointers are device pointers;
// top_ptr may be null, and then `top` is used.  Returns a cudaError_t (0 on
// success).
int vacv_preprocess_resize(int device, void* stream, const void* src,
                           void* out, int n, int h, int w, int left, int ch,
                           int top, const void* top_ptr, int oh, int ow,
                           const void* ystart, const void* ywt, int ky,
                           const void* xstart, const void* xwt, int kx,
                           int trunc_u8, float eps, int static_norm, float m0,
                           float m1, float m2, float s0, float s1, float s2) {
  const BgrSource source = {static_cast<const uint8_t*>(src), h, w};
  return launch_resize<4>(device, stream, source, out, n, left, ch, top,
                          top_ptr, oh, ow, ystart, ywt, ky, xstart, xwt, kx,
                          trunc_u8, eps, static_norm,
                          Stats{{m0, m1, m2}, {s0, s1, s2}});
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
