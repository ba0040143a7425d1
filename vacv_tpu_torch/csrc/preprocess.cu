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

#include "preprocess.cuh"

namespace {

constexpr int kNormThreads = 512;

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
