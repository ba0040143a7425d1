// Face alignment for Hopper (sm_90a): every face of a batch of frames warped
// to the network's input in one launch, with a plain C interface loaded by
// ctypes (vacv_tpu_torch/ops/cuda/align.py).
//
// Replaces no TPU kernel.  vacv's warp_affine_normalize (cv.h:172-178) takes
// one image and one matrix a call; a face-recognition front end cuts many
// faces out of each frame, each with its own similarity transform, and
// normalizes them with fixed statistics.  Called once a face, the port's
// chain makes a planar copy of the whole frame, a warp launch, a dtype
// change and a normalize for every face: ~800 launches and ~2.4 GB of copies
// for 16 1080p frames of ~12 faces each, where the work is ~42 MB.
//
// What it computes, for K faces, face k with frame index[k] of n (h, w, 3)
// u8 HWC frames and forward 2 x 3 matrix matrices[k], into (K, 3, oh, ow)
// f32:
//   the inverse of the matrix, as ops/warp_affine.py::invert_affine makes
//   it: in float64 (det = m00 m11 - m01 m10, d = 1 / det or 0 for a
//   singular matrix, a11 = m11 d, a12 = -m01 d, a21 = -m10 d, a22 = m00 d,
//   b1 = -a11 m02 - a12 m12, b2 = -a21 m02 - a22 m12), each step rounded,
//   then stored as float32; by every thread of a face's blocks;
//   each output pixel's three channels by the warp's u8 bilinear arithmetic
//   (warp_affine.cuh, included read-only: the f32 source coordinate, Q11
//   weights, blend4's order, the per-tap constant border 0 and to_byte's
//   clip(floor(v + 1e-4), 0, 255));
//   (v - mean[c]) / (stddev[c] + eps) in f32 for output plane c, which
//   holds source channel c, or 2 - c when to_rgb swaps B and R.
// That is the per-face chain's order of operations (ops/fused.py::
// warp_affine_normalize: the warp kernel on the frame's planes, f32, the
// static normalize), so the output is its bits.  A face whose frame index
// lies outside [0, n) reads nothing and is written as NaN.
//
// Bound: bytes.  The f32 output (150,528 bytes a 112 x 112 face) and, per
// face, the source bytes its taps can reach: ~28.8 + ~13 MB for 16 frames of
// ~12 faces, 12.6 us at 3.35 TB/s.  The taps of a rotated face are gathers
// scattered over its box, so latency and the warp arithmetic (~120
// instructions a pixel) weigh as much as the bytes.  The design:
//
// * A block takes a 64 x 16 output tile of one face, a thread 2 x 2 of its
//   pixels (the warp kernel's tiling, so its tile and slot helpers serve
//   unchanged); 14 blocks a 112 x 112 face.
// * Each warp sorts its tile as warp_kernel_hwc3 does: lane i takes corner
//   i & 3, the warp votes, and an interior tile reads its taps with no
//   border rule (Inside, channels at immediate offsets), an edge tile with
//   the per-tap rule (Edge).  The two give the same bits wherever both apply.
// * No thread waits on another before its taps: each inverts its face's
//   matrix itself (a few dozen float64 instructions, no shared copy and no
//   barrier in front of the gathers) and reads the frame index itself.
// * The normalize is a table: a channel's output is (v - mean) / (stddev +
//   eps) of a byte v, so each block divides 768 times into shared memory,
//   not 12 times a thread, and a pixel's channel is one shared load.  The
//   block's one barrier stands between its taps and its stores.
// * The f32 planes leave by evict-first stores (__stcs): written once,
//   they should not push the frames' bytes out of L2.

#include "warp_affine.cuh"

namespace {

namespace vw = vacv_warp;

constexpr int kLevels = 256;  // u8 values: entries of a channel's table

// The call's fixed arguments, made once a launch record
// (ops/cuda/align.py::_AlignArgs lays them out field for field).
struct AlignArgs {
  long long sn, sy;          // bytes between frames, between rows
  int n, h, w;               // frames, their rows and columns
  int oh, ow;                // a face's output
  int to_rgb;                // output plane c holds source channel 2 - c
  float mean[3], std[3];     // by output plane
  float eps;
};

struct AlignParams {
  const uint8_t* frames;
  const int* index;
  const float* matrices;  // (k, 2, 3), forward
  float* out;             // (k, 3, oh, ow)
  int64_t sn;
  int sy, n, h, w, oh, ow, to_rgb, fast;
  float mean[3], std[3], eps;
};

// ops/warp_affine.py::invert_affine on the float32 forward matrix m, each
// float64 step rounded as numpy rounds it.
__device__ void invert_affine(const float* m, float inv[6]) {
  const double m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[3], m11 = m[4], m12 = m[5];
  const double det = __dsub_rn(__dmul_rn(m00, m11), __dmul_rn(m01, m10));
  const double d = det != 0.0 ? __ddiv_rn(1.0, det) : 0.0;
  const double a11 = __dmul_rn(m11, d), a22 = __dmul_rn(m00, d);
  const double a12 = __dmul_rn(-m01, d), a21 = __dmul_rn(-m10, d);
  const double b1 = __dsub_rn(__dmul_rn(-a11, m02), __dmul_rn(a12, m12));
  const double b2 = __dsub_rn(__dmul_rn(-a21, m02), __dmul_rn(a22, m12));
  inv[0] = __double2float_rn(a11);
  inv[1] = __double2float_rn(a12);
  inv[2] = __double2float_rn(b1);
  inv[3] = __double2float_rn(a21);
  inv[4] = __double2float_rn(a22);
  inv[5] = __double2float_rn(b2);
}

// A thread's four pixels (the warp kernel's slots) through F, each channel's
// byte as to_byte leaves it, in the low bits of bytes[s][k].
template <bool FAST, typename F>
__device__ __forceinline__ void face_pixels(const F& f, const vw::Params& q, int h, int w, int dx,
                                            int dy, uint32_t bytes[vw::kSlots][3]) {
  const vw::SlotCoords xy(q, dx, dy);
#pragma unroll
  for (int s = 0; s < vw::kSlots; ++s) {
    float acc[vw::kGroup] = {0.f, 0.f, 0.f, 0.f};
    if (vw::slot_inside(q, dx, dy, s)) {
      float fx, fy;
      xy.at(q, s, fx, fy);
      vw::pixel<uint8_t, vw::kLinear, FAST, 3>(f, fx, fy, 3, false, h, w, 0.f, acc);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) bytes[s][k] = vw::to_byte<vw::kLinear, FAST>(acc[k]) & 0xffu;
  }
}

__global__ void __launch_bounds__(vw::kThreads, 4) align_kernel(AlignParams a) {
  __shared__ float table[3][kLevels];
  const int tid = threadIdx.y * vw::kBlockX + threadIdx.x;
  const int face = blockIdx.z;
  // What the warp's tile and slot helpers read of their Params: the inverse
  // matrix and the output's size.
  vw::Params q = {};
  invert_affine(a.matrices + 6 * static_cast<int64_t>(face), q.m);
  q.h_out = a.oh;
  q.w_out = a.ow;
  const int f = __ldg(a.index + face);
  for (int i = tid; i < 3 * kLevels; i += vw::kThreads) {  // read after the barrier below
    const int c = i / kLevels;
    table[c][i % kLevels] = __fdiv_rn(__fsub_rn(static_cast<float>(i % kLevels), a.mean[c]),
                                      __fadd_rn(a.std[c], a.eps));
  }
  const int x0 = blockIdx.x * vw::kTileX, y0 = blockIdx.y * vw::kTileY;
  const int dx = x0 + threadIdx.x, dy = y0 + threadIdx.y;
  float* out = a.out + static_cast<int64_t>(face) * 3 * a.oh * a.ow;
  const int plane = a.oh * a.ow;
  if (f < 0 || f >= a.n) {  // the same in every thread of the block: none reaches the barrier
#pragma unroll
    for (int s = 0; s < vw::kSlots; ++s) {
      const int x = dx + vw::kBlockX * (s & 1), y = dy + vw::kBlockY * (s >> 1);
      if (x < a.ow && y < a.oh)
        for (int c = 0; c < 3; ++c) __stcs(out + c * plane + y * a.ow + x, __int_as_float(0x7fc00000));
    }
    return;
  }
  const uint8_t* src = a.frames + f * a.sn;
  float ex[2], ey[2], cx, cy;
  vw::tile_edges(q, x0, y0, ex, ey);
  vw::tile_corner(q, ex[threadIdx.x & 1], ey[(threadIdx.x >> 1) & 1], cx, cy);
  const bool interior =
      a.fast && __all_sync(0xffffffffu, vw::corner_inside<vw::kLinear>(floorf(cx), a.w) &&
                                             vw::corner_inside<vw::kLinear>(floorf(cy), a.h));
  uint32_t bytes[vw::kSlots][3];
  if (interior) {
    const vw::Inside<uint8_t, int, true, true> in = {src, a.sy, 3, 1};
    face_pixels<true>(in, q, a.h, a.w, dx, dy, bytes);
  } else {
    const vw::Edge<uint8_t> e = {src, a.sy, 3, 1, a.h, a.w, vw::kConstant, 0.f};
    face_pixels<false>(e, q, a.h, a.w, dx, dy, bytes);
  }
  __syncthreads();  // the table
#pragma unroll
  for (int s = 0; s < vw::kSlots; ++s) {
    const int x = dx + vw::kBlockX * (s & 1), y = dy + vw::kBlockY * (s >> 1);
    if (x >= a.ow || y >= a.oh) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint32_t v = a.to_rgb ? bytes[s][2 - c] : bytes[s][c];  // static indices: registers
      __stcs(out + c * plane + y * a.ow + x, table[c][v]);
    }
  }
}

}  // namespace

extern "C" {

// Align k faces of args->n (h, w, 3) u8 HWC frames at `frames` (bytes
// between frames sn, between rows sy, 3 between pixels) into `out`, (k, 3,
// oh, ow) f32: face i is frame index[i] (int32) warped by the inverse of its
// forward matrix matrices[i] ((k, 2, 3) f32), bilinear, constant border 0,
// then normalized with args' per-plane statistics (module note).  Every
// byte offset of a frame must fit 31 bits; 1 <= k <= 65535.  Returns a
// cudaError_t.
int vacv_align_faces(int device, void* stream, const void* frames, void* out, const void* index,
                     const void* matrices, int k, const void* args) {
  cudaGetLastError();  // clear a stale error of an earlier call
  const AlignArgs& a = *static_cast<const AlignArgs*>(args);
  if (a.n < 1 || a.h < 1 || a.w < 1 || k < 1 || k > 65535 || a.oh < 1 || a.ow < 1 ||
      (a.oh + vw::kTileY - 1) / vw::kTileY > 65535 || a.sn < 0 || a.sy < 3LL * a.w ||
      (a.h - 1) * a.sy + 3LL * a.w - 1 >= 2147483647LL || frames == nullptr || out == nullptr ||
      index == nullptr || matrices == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  AlignParams p;
  p.frames = static_cast<const uint8_t*>(frames);
  p.index = static_cast<const int*>(index);
  p.matrices = static_cast<const float*>(matrices);
  p.out = static_cast<float*>(out);
  p.sn = a.sn;
  p.sy = static_cast<int>(a.sy);
  p.n = a.n;
  p.h = a.h;
  p.w = a.w;
  p.oh = a.oh;
  p.ow = a.ow;
  p.to_rgb = a.to_rgb;
  p.fast = a.h < vw::kFastLimit && a.w < vw::kFastLimit;  // the exact floor's range
  for (int c = 0; c < 3; ++c) {
    p.mean[c] = a.mean[c];
    p.std[c] = a.std[c];
  }
  p.eps = a.eps;
  const dim3 grid((a.ow + vw::kTileX - 1) / vw::kTileX, (a.oh + vw::kTileY - 1) / vw::kTileY, k);
  align_kernel<<<grid, dim3(vw::kBlockX, vw::kBlockY), 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
