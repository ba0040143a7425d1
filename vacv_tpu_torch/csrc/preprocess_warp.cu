// BASELINE config 5 in one pass: the affine warp sampled inside kernel #1's
// moments form, for Hopper (sm_90a), with a plain C interface loaded by
// ctypes (vacv_tpu_torch/ops/cuda/preprocess.py::prepare_fused_warp).
//
// Config 5 warps a crop of each frame (2432 x 1368 of 2560 x 1440) to 1216 x
// 684, then resizes the warped image to 224 x 224.  The two-launch chain
// (warp_kernel_hwc3, then moments_resize_kernel<PlanarSource>) computes and
// stores every warped pixel, 13.3 M a batch of 16, as three u8 planes, and
// reads back only the ones the resize taps: two warped rows and two warped
// columns an output pixel (linear), 448 of 684 rows and 448 of 1216
// columns, a fourth of the pixels.  Here the moments kernel's Source is the
// warp itself (WarpSource below): a tap of the resize is a warped pixel,
// computed where the resize reads it, and nothing else is computed or
// stored.  The moments kernel, its scale launch and their launch code are
// preprocess.cuh's, unchanged; this source only adds the Source.
//
// A warped pixel has the bits warp_kernel_hwc3 gives it (warp_affine.cuh,
// included read-only): its coordinate ((m0 x) + (m1 y)) + m2 in f32 with
// every step rounded, the Q11 bilinear weights, blend4's order and to_byte's
// u8 epilogue.  The warp kernel sorts whole 64 x 16 tiles into interior and
// edge tiles; here each pixel is sorted alone: where all four taps lie
// inside the crop it takes the interior arithmetic (one 32-bit offset, as
// pixel_hwc3 makes it), else the edge path's per-tap constant border (Edge,
// pixel<..., false, 3>).  The two give the same bits wherever both apply:
// the floors are exact below 2^22 either way and a convex mix of bytes needs
// no clamp.  So the output is the two-launch chain's, bit for bit, and with
// it the integer moments.  An interior pixel's two tap rows, six bytes
// each, are read as the aligned words that hold them (load_bytes: 4 to 6
// loads a pixel where pixel_hwc3 makes 12 byte loads); the tap bytes of a
// warp's 32 pixels lie ~18 bytes apart, so each load touches several cache
// lines, and fewer loads measured 44.5 -> 40.9 us a batch of 16 on an H100.
//
// Config 5's map sends the warped image's left and top bands outside the
// crop, so the edge path runs in every batch.  Every tap count of the
// moments form builds (linear, cubic and nearest tails); each tap of the
// resize is one warped pixel.  Tried and left out (H100, 16 frames, timed beside
// this form): every pixel through the interior arithmetic first, reading a
// dummy where a tap lies outside, then the edge path for those pixels, so
// that no branch parts a row's loads: 45.3 to 45.6 us against the byte
// loads' 44.5.

#include "preprocess.cuh"
#include "warp_affine.cuh"

namespace {

// Warped pixels of (n, h_full, w_full, 3) u8 frames read through an HWC
// view (channel stride 1, x stride 3), linear, constant border 0: the
// moments kernel's source.  The moments kernel reads it whole (left 0, top
// 0, ch = its h), so its h and w are the warped image's.
struct WarpSource {
  const uint8_t* p;     // frame 0's crop (its top row, left column), or frame n's after frame(n)
  int64_t sn;           // bytes between frames
  uint32_t sy;          // bytes between rows
  int sh, sw;           // the crop's rows and columns
  const int* row0_ptr;  // null, or the crop's top on the device, in frames of rows_full rows
  int rows_full;
  float x_hi, y_hi;     // all four taps of (fx, fy) lie inside when 0 <= fx < x_hi, 0 <= fy < y_hi
  float m[6];           // the inverse matrix
  int h, w;             // the warped image

  // Frame n, at its crop's top: a device top is read and clamped to [0,
  // rows_full - sh] once, as warp_kernel_hwc3 reads it.
  __device__ WarpSource frame(int n) const {
    WarpSource f = *this;
    f.p = p + n * sn;
    if (row0_ptr != nullptr)
      f.p += static_cast<int64_t>(min(max(__ldg(row0_ptr), 0), rows_full - sh)) * sy;
    return f;
  }
};

// Warped pixel (x, y) of `f`, its three channels as floats of its u8 bytes.
__device__ __forceinline__ void warped_pixel(const WarpSource& f, int x, int y, float c[3]) {
  namespace vw = vacv_warp;
  const float fdx = static_cast<float>(x), fdy = static_cast<float>(y);
  const float fx = __fadd_rn(__fadd_rn(__fmul_rn(f.m[0], fdx), __fmul_rn(f.m[1], fdy)), f.m[2]);
  const float fy = __fadd_rn(__fadd_rn(__fmul_rn(f.m[3], fdx), __fmul_rn(f.m[4], fdy)), f.m[5]);
  uint32_t b[3];  // to_byte's results: 2^23's bits plus the byte
  if (fx >= 0.f && fx < f.x_hi && fy >= 0.f && fy < f.y_hi) {
    // floor(fx) in [0, sw - 2], floor(fy) in [0, sh - 2]: the interior
    // arithmetic.  The floors' bits are 0x4B400000 plus the index, so
    // bits(ty) sy + 3 bits(tx) - bias is, mod 2^32, the offset of tap (tx,
    // ty), which the entry keeps below 2^31.
    const float tx = vw::floor_magic(fx), ty = vw::floor_magic(fy);
    const float ax = __fsub_rn(fx, __fsub_rn(tx, vw::kFloorMagic));
    const float ay = __fsub_rn(fy, __fsub_rn(ty, vw::kFloorMagic));
    float wt[4];
    vw::linear_weights<uint8_t, true>(ax, ay, wt);
    const uint32_t bias = 0x4B400000u * (f.sy + 3u);
    const uint8_t* a = f.p + (__float_as_uint(ty) * f.sy + __float_as_uint(tx) * 3u - bias);
    float ta[6], td[6];  // the two tap rows' six bytes each, read as the words that hold them
    load_bytes<6>(a, ta);
    load_bytes<6>(a + f.sy, td);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      b[k] = vw::to_byte<vw::kLinear, true>(
          vw::blend4([&](int j) { return (j & 1 ? td : ta)[(j & 2 ? 3 : 0) + k]; }, wt));
  } else {
    // A tap outside the crop (or a coordinate past the fast floor's range):
    // the edge path's per-tap rule.
    const vw::Edge<uint8_t> e = {f.p, f.sy, 3, 1, f.sh, f.sw, vw::kConstant, 0.f};
    float acc[vw::kGroup];
    vw::pixel<uint8_t, vw::kLinear, false, 3>(e, fx, fy, 3, false, f.sh, f.sw, 0.f, acc);
#pragma unroll
    for (int k = 0; k < 3; ++k) b[k] = vw::to_byte<vw::kLinear, false>(acc[k]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = __fsub_rn(__uint_as_float(b[k]), kTwo23);
}

// KX taps of warped row y from column x, all three channels (the moments
// kernel's load_row).
template <int KX>
__device__ __forceinline__ void load_row(const WarpSource& frame, int y, int x, float c[KX][3]) {
#pragma unroll
  for (int kx = 0; kx < KX; ++kx) warped_pixel(frame, x + kx, y, c[kx]);
}

// The fused call's fixed arguments, made once a record
// (ops/cuda/preprocess.py::_WarpMomentsArgs lays them out field for field),
// so that a call passes six arguments where it would pass thirty-eight:
// ctypes converts every argument of every call.
struct WarpMomentsArgs {
  void* planes;         // the moments form's scratch: the u8 planes,
  void* slots;          // then each resize block's moments
  const int* ystart;    // the tap tables: over the h_out warped rows,
  const float* ywt;
  const int* xstart;    // and over the w_out warped columns
  const float* xwt;
  long long sn, sy;     // bytes between frames, between rows
  int n, h, w;          // frames, the crop's rows and columns
  int rows_full;        // the frames' rows a device top moves in
  int h_out, w_out;     // the warped image
  int oh, ow, ky, kx;   // the output and the taps a row and a column
  int blocks;           // the scale launch's blocks a plane
  int have_mean, have_std;
  float m[6];           // the inverse matrix
  float eps;
  float mean[3], std[3];
};

}  // namespace

extern "C" {

// The moments form (vacv_preprocess_moments) over the affine warp of n
// frames, sampled where the resize reads it: the warp of the h x w crop
// whose top-left byte is `src` (3 u8 channels a pixel) with the inverse
// matrix m to h_out x w_out, linear, constant border 0, resized to (n, 3,
// oh, ow) f32 in `out`, truncated, then normalized with per-(frame,
// channel) statistics, self-computed where have_mean or have_std is 0; the
// rest of `args` (WarpMomentsArgs) as its fields say.  row0_ptr: null, or
// a device int, the top of the crop in frames of rows_full rows (clamped
// to [0, rows_full - h]); `src` is then the frames' row 0.  Every byte
// offset of a frame must fit 31 bits.  Returns a cudaError_t.
int vacv_preprocess_warp_moments(int device, void* stream, const void* src, void* out,
                                 const void* row0_ptr, const void* args) {
  cudaGetLastError();  // clear a stale error of an earlier call
  const WarpMomentsArgs& a = *static_cast<const WarpMomentsArgs*>(args);
  const int64_t rows = row0_ptr != nullptr ? a.rows_full : a.h;
  if (a.n < 1 || a.blocks < 1 || a.n > 65535 / 3 || a.planes == nullptr || a.slots == nullptr ||
      a.h < 1 || a.w < 1 || a.h_out < 1 || a.w_out < 1 || a.sn < 0 || a.sy < 3LL * a.w ||
      rows < a.h || (rows - 1) * a.sy + 3LL * a.w - 1 >= 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  // The fast floor holds below 2^22 (warp_affine.cuh's fast_ok): past it
  // every pixel takes the edge path.
  const bool fast = a.h < vacv_warp::kFastLimit && a.w < vacv_warp::kFastLimit;
  const WarpSource source = {static_cast<const uint8_t*>(src),
                             a.sn,
                             static_cast<uint32_t>(a.sy),
                             a.h,
                             a.w,
                             static_cast<const int*>(row0_ptr),
                             a.rows_full,
                             fast ? static_cast<float>(a.w - 1) : 0.f,
                             fast ? static_cast<float>(a.h - 1) : 0.f,
                             {a.m[0], a.m[1], a.m[2], a.m[3], a.m[4], a.m[5]},
                             a.h_out,
                             a.w_out};
  const Stats st = {{a.mean[0], a.mean[1], a.mean[2]}, {a.std[0], a.std[1], a.std[2]}};
  return launch_moments(static_cast<cudaStream_t>(stream), source, static_cast<float*>(out),
                        static_cast<uint8_t*>(a.planes),
                        static_cast<unsigned long long*>(a.slots), a.n, 0, a.h_out, 0, nullptr,
                        a.oh, a.ow, a.ystart, a.ywt, a.ky, a.xstart, a.xwt, a.kx, a.eps, a.blocks,
                        a.have_mean, a.have_std, st);
}

}  // extern "C"
