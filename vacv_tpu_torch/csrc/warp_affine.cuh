// Inverse-mapped affine warp of strided planes, for Hopper (sm_90a): the
// kernel, shared by warp_affine.cu (the C interface and the u8 kernels) and
// warp_affine_f32.cu (the f32 kernels), which are two sources only so that
// their compilations run side by side.
//
// Replaces: vacv_tpu/ops/pallas/warp_affine.py::_kernel, the TPU kernel
// behind warp_affine_pallas.  The TPU has no fast gather, so that kernel
// selects its taps with 0/1 selection matmuls over 128-column source
// windows (f32 through a bf16 hi/lo split), keeps planes resident in VMEM
// or streams row bands, and serves the remap borders by pre-padding the
// source.  Here each thread simply loads its taps.
//
// What it computes, for N frames of C planes (any strides: CHW planes, an
// HWC frame, or a crop view of either, with no transpose, pad or copy; or
// h rows of a taller frame from a top that lies on the device, read once by
// each block, so that a moving crop needs no gather):
// for each output pixel (dx, dy) the source coordinate
//   fx = ((m0 dx) + (m1 dy)) + m2,  fy = ((m3 dx) + (m4 dy)) + m5
// in f32, then
//   linear:  4 taps; u8 with Q11 weights floor(w 2048 + 0.5) / 2048, f32
//            with plain weights; p00 w00 + p10 w10 + p01 w01 + p11 w11;
//   nearest: the tap at floor(f + 0.5);
//   cubic:   4 x 4 taps, A = -0.75, rows summed then weighted by row;
// with the border rule folded into each tap's index: REPLICATE clamps,
// REFLECT reflects mod 2n with the edge duplicated, REFLECT_101 mod 2n-2
// (n = 1 -> 0), WRAP mod n, and CONSTANT reads the border value for a tap
// outside the image.  With `vacv` (linear only) a pixel whose 2 x 2 support
// leaves [0, w-2] x [0, h-2] is the border value.  Epilogue: u8 linear
// clip(floor(x + 1e-4), 0, 255), u8 nearest and cubic
// clip(floor(x + 0.5), 0, 255); f32 as computed.
//
// Rounding: nvcc would contract a * b + c into one FMA, which rounds once
// where the plain version (ops/warp_affine.py::warp_planes_torch) rounds
// twice.  At an integer boundary that flips floor() and a Q11 weight, so
// the coordinate, weight and blend arithmetic below is written with
// __fmul_rn / __fadd_rn / __fsub_rn in the plain version's order, every
// pixel's coordinate from its own (dx, dy), and a u8 output is bit-exact to
// it.
//
// Bound: bytes on paper (one source byte read and one written per u8
// output, 3.3 us for BASELINE config 5 with 2 frames), but what limits it
// is the instruction count per output and the latency of the taps' loads:
// in SASS a 3-channel bilinear pixel of an interior tile takes ~158
// instructions in warp_kernel and ~122 in warp_kernel_hwc3 (below), of
// which ~67 are the plain version's f32 rounding steps, 12 the byte loads
// and 24 their conversions.  The design spends as few as it can on
// anything but that arithmetic:
//
// * A block takes a 64 x 16 output tile, a thread 2 x 2 of its pixels (32
//   columns and 8 rows apart) and up to kGroup channels.  The 32 lanes of
//   a warp are 32 neighbours in a row, so a tap load touches neighbouring
//   source bytes (conflict-free in shared memory) and an f32 store is
//   dense; a u8 plane row is packed by a 4 x 4 byte transpose across four
//   lanes (two shuffles) and leaves as one 32-bit store a lane where the
//   output is dense in x and aligned.
// * The coordinate is affine and every rounding step is monotone, so the
//   tile's four corners bound all its coordinates.  A tile whose taps all
//   lie inside the image (the corners' floors, grown by the tap support and
//   one more) is "interior": no border rule, no mask, no skip-edge test.
//   Only the other tiles run the per-tap rule.  In warp_kernel one thread
//   works all this out for its block (plan_tile) and shares it through
//   shared memory.
// * The cubic kernel (16 taps a pixel) first copies an interior tile's
//   source box into shared memory when its rows are dense (an HWC view
//   with channel stride 1: one staged row holds all channels; or planes
//   with x stride 1) and it fits kStageBytes: 16-byte cp.async from the
//   aligned address below each row where the row and channel strides keep
//   that alignment, else element by element.  Taps then come from shared
//   memory with 32-bit indices ("staged").  A box over the budget (strong
//   downscale, steep rotation of f32 pixels) is read directly ("direct").
//   Linear and nearest interior tiles always read directly: measured on an
//   H100 at BASELINE config 5, staging them was 0.4 to 2.7 us slower than
//   the L1 cache serving their 4 taps or 1, source in L2 or not.
//   ops/cuda/warp_affine.py::tile_paths repeats the choice on the host and
//   says which path a call's tiles take.
// * Conversions go through the f32 adder, not the quarter-rate conversion
//   unit: a u8 tap becomes a float by or-ing it into 2^23's mantissa and
//   subtracting 2^23; floor(x) for |x| < 2^22 is (x + 1.5 2^23) rounded
//   down, whose mantissa is also the integer index; the u8 epilogue clamps
//   first and rounds down into 2^23's mantissa.  All exact.
// * A u8 linear call on three channels read through an HWC view (channel
//   stride 1, x stride 3) with every offset within 32 bits, BASELINE config
//   5's warp, launches warp_kernel_hwc3 (warp_affine_hwc3.cu; on the host
//   ops/cuda/warp_affine.py::hwc3_form): the same tiles, tile rule, edge
//   path and arithmetic, with less around the arithmetic.  A tap row is one
//   32-bit offset from the frame's base at its clamped top, made from the
//   floors' float bits with their 0x4B400000 folded into a per-thread bias,
//   so its six bytes are loads at immediate offsets (+0 .. +5) and the next
//   row's are + sy: ~6 address instructions a pixel where warp_kernel's
//   strided taps (a run-time channel stride, 64-bit addresses) take ~37.
//   Each warp classifies its tile itself (lane i takes corner i & 3 and the
//   warp votes), so no thread waits at a barrier for plan_tile.  A tile
//   whole inside the output tests no slot and, where the output's rows and
//   planes are 4-byte aligned (out4), stores each quad unconditionally; each
//   slot's bytes are packed as they are made, so 3 words stay live, not 12
//   floats.  Launch bounds: 4 blocks an SM, 64 registers, no spills (32
//   warps an SM).  Measured on an H100 (700 W) at config 5, device top, the
//   launch alone: 16 frames 100.2 -> 80.4 us, 2 frames 14.5 -> 13.3 us.
//   Tried and left out (16 frames, each timed beside this form): 79
//   registers (3 blocks an SM) 89.8 us; 40-48 registers with spills
//   77.5-80.4; the slots unrolled 1 or 2 at a time 103-118; each tap row
//   as two aligned words and a byte (6 loads a pixel, not 12) 85.1; an
//   integer Q11 sum with a float fallback near a rounding boundary (~30
//   fewer instructions, bit-exact) 81.8; persistent blocks 100.8.  So
//   fewer instructions alone stop paying near 80 us at 16 frames, where
//   the source (177 MB) comes from DRAM; with the source in L2 (2 frames)
//   they still do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vacv_warp {

constexpr int kTileX = 64;       // output tile, pixels
constexpr int kTileY = 16;
constexpr int kGroup = 4;        // channels per thread
constexpr int kStageBytes = 24576;
constexpr int kFastLimit = 4194304;  // 2^22: the exact-floor trick's range
constexpr int kBlockX = 32;      // a warp is 32 neighbouring pixels of a row
constexpr int kBlockY = 8;
constexpr int kSlots = 4;        // pixels a thread: (tx + 32 i, ty + 8 j), slot 2 j + i
constexpr int kThreads = kBlockX * kBlockY;
static_assert(kTileX == 2 * kBlockX && kTileY == 2 * kBlockY, "a thread owns 2 x 2 pixels");
constexpr float kCoordLimit = 1073741824.0f;  // 2^30, as the plain version
constexpr float kFloorMagic = 12582912.0f;    // 1.5 * 2^23, bits 0x4B400000
constexpr float kTwo23 = 8388608.0f;          // 2^23, bits 0x4B000000

// InterMode and BorderMode values (vacv_tpu_torch/core/types.py).
enum { kNearest = 0, kLinear = 1, kCubic = 2 };
enum { kConstant = 0, kReplicate = 1, kReflect = 2, kWrap = 3, kReflect101 = 4 };
// Source layouts a tile can be staged from, and the path switch.
enum { kStrided = 0, kHwc = 1, kPlanar = 2 };
enum { kAuto = 0, kNoStage = 1, kEdgeOnly = 2 };

struct Params {
  const void* src;
  int64_t sn, sc, sy, sx;  // source strides, in elements
  const int* row0_ptr;     // null, or the device top of an h-row crop of rows_full rows
  int rows_full;
  void* out;
  int64_t on, oc, oy, ox;  // output strides, in elements
  int c, h, w, h_out, w_out, groups;
  float m[6];
  int border;
  float bv;
  int vacv;
  int layout;   // kStrided / kHwc / kPlanar
  int vec;      // the row (and plane) strides keep 16-byte alignment
  int idx32;    // every source offset fits 32 bits
  int fast_ok;  // h, w < 2^22
  int mode;     // kAuto / kNoStage / kEdgeOnly
  int out4;     // u8 output of x stride 1, its base, rows, planes and frames 4-byte aligned
};

__device__ __forceinline__ int to_index(float f) {
  return static_cast<int>(fminf(fmaxf(f, -kCoordLimit), kCoordLimit));
}

__device__ __forceinline__ int pmod(int t, int p) {
  const int r = t % p;
  return r < 0 ? r + p : r;
}

// cv::borderInterpolate's index map for the remap borders; CONSTANT
// clamps (its tap is masked by the caller).
__device__ __forceinline__ int remap(int t, int n, int border) {
  switch (border) {
    case kReflect: {
      const int m = pmod(t, 2 * n);
      return m >= n ? 2 * n - 1 - m : m;
    }
    case kReflect101: {
      if (n == 1) return 0;
      const int m = pmod(t, 2 * n - 2);
      return m >= n ? 2 * n - 2 - m : m;
    }
    case kWrap:
      return pmod(t, n);
    default:
      return min(max(t, 0), n - 1);
  }
}

__device__ __forceinline__ float to_float(uint8_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), kTwo23);
}
__device__ __forceinline__ float to_float(float v) { return v; }

// Taps known to lie inside the image: plain strided addressing, of the
// source itself (GLOBAL) or of the tile's staged box in shared memory.
// UNIT_SC: the channel stride is 1 (an HWC box), so a channel is an
// immediate offset of the load.
template <typename T, typename IDX, bool GLOBAL, bool UNIT_SC = false>
struct Inside {
  using Tap = IDX;
  const T* s;
  IDX sy, sx, sc;
  __device__ __forceinline__ Tap tap(int tx, int ty) const {
    return static_cast<IDX>(ty) * sy + static_cast<IDX>(tx) * sx;
  }
  __device__ __forceinline__ float load(Tap t, int k) const {
    const T* a = s + t + (UNIT_SC ? static_cast<IDX>(k) : static_cast<IDX>(k) * sc);
    if constexpr (GLOBAL) {
      return to_float(__ldg(a));
    } else {
      return to_float(*a);
    }
  }
};

// Taps anywhere: the border rule per tap.
template <typename T>
struct Edge {
  struct Tap {
    int64_t off;
    bool ok;
  };
  const T* s;
  int64_t sy, sx, sc;
  int h, w, border;
  float bv;
  __device__ __forceinline__ Tap tap(int tx, int ty) const {
    if (border == kConstant) {
      const bool ok = tx >= 0 && tx <= w - 1 && ty >= 0 && ty <= h - 1;
      return {ok ? ty * sy + tx * sx : 0, ok};
    }
    return {remap(ty, h, border) * sy + remap(tx, w, border) * sx, true};
  }
  __device__ __forceinline__ float load(const Tap& t, int k) const {
    return t.ok ? to_float(__ldg(s + t.off + k * sc)) : bv;
  }
};

// floor(f) + 1.5 2^23, exactly, for |f| < 2^22: rounded down by the adder,
// its bits are 0x4B400000 plus the integer floor(f).
__device__ __forceinline__ float floor_magic(float f) { return __fadd_rd(f, kFloorMagic); }

// floor(f) and its integer index.  FAST (|f| < 2^22, an interior tile):
// through the adder, exactly; else floorf and the plain version's clamp.
template <bool FAST>
__device__ __forceinline__ void floor_index(float f, float& fl, int& idx) {
  if constexpr (FAST) {
    const float t = floor_magic(f);
    idx = __float_as_int(t) - 0x4B400000;
    fl = __fsub_rn(t, kFloorMagic);
  } else {
    fl = floorf(f);
    idx = to_index(fl);
  }
}

// The u8 path's Q11 weight: floor(w 2048 + 0.5) / 2048 for w in [0, 1].
template <bool FAST>
__device__ __forceinline__ float q11(float w) {
  const float t = __fadd_rn(__fmul_rn(w, 2048.f), 0.5f);
  const float fl = FAST ? __fsub_rn(__fadd_rd(t, kTwo23), kTwo23) : floorf(t);
  return __fmul_rn(fl, 1.f / 2048.f);
}

// The bilinear weights w00, w10, w01, w11 (tap (x + i, y + j) is wij) from
// the fractions: Q11 for u8, plain for f32.
template <typename T, bool FAST>
__device__ __forceinline__ void linear_weights(float ax, float ay, float w[4]) {
  float wx0, wx1, wy0, wy1;
  if constexpr (sizeof(T) == 1) {
    wx0 = q11<FAST>(__fsub_rn(1.f, ax));
    wx1 = __fsub_rn(1.f, wx0);
    wy0 = q11<FAST>(__fsub_rn(1.f, ay));
    wy1 = __fsub_rn(1.f, wy0);
  } else {
    wx0 = __fsub_rn(1.f, ax);
    wx1 = ax;
    wy0 = __fsub_rn(1.f, ay);
    wy1 = ay;
  }
  w[0] = __fmul_rn(wx0, wy0);
  w[1] = __fmul_rn(wx0, wy1);
  w[2] = __fmul_rn(wx1, wy0);
  w[3] = __fmul_rn(wx1, wy1);
}

// p00 w00 + p10 w10 + p01 w01 + p11 w11 in the plain version's order, tap j
// (00, 10, 01, 11) read by tap(j) as the sum needs it.
template <typename L>
__device__ __forceinline__ float blend4(const L& tap, const float w[4]) {
  float v = __fmul_rn(tap(0), w[0]);
  v = __fadd_rn(v, __fmul_rn(tap(1), w[1]));
  v = __fadd_rn(v, __fmul_rn(tap(2), w[2]));
  return __fadd_rn(v, __fmul_rn(tap(3), w[3]));
}

// A = -0.75 cubic weights in the plain version's order (_cubic_coefs).
__device__ __forceinline__ void cubic_coefs(float f, float c[4]) {
  const float A = -0.75f;
  const float f0 = __fadd_rn(f, 1.f);
  const float f2 = __fsub_rn(1.f, f);
  const float f0sq = __fmul_rn(f0, f0), fsq = __fmul_rn(f, f), f2sq = __fmul_rn(f2, f2);
  c[0] = __fsub_rn(__fadd_rn(__fsub_rn(__fmul_rn(A, __fmul_rn(f0sq, f0)),
                                       __fmul_rn(5.f * A, f0sq)),
                             __fmul_rn(8.f * A, f0)),
                   4.f * A);
  c[1] = __fadd_rn(__fsub_rn(__fmul_rn(A + 2.f, __fmul_rn(fsq, f)), __fmul_rn(A + 3.f, fsq)), 1.f);
  c[2] = __fadd_rn(__fsub_rn(__fmul_rn(A + 2.f, __fmul_rn(f2sq, f2)), __fmul_rn(A + 3.f, f2sq)),
                   1.f);
  c[3] = __fsub_rn(__fsub_rn(__fsub_rn(1.f, c[0]), c[1]), c[2]);
}

// One output pixel's up to kGroup channels, before the epilogue.  Only the
// edge path (not FAST) applies the skip-edge mask (`vacv`): an interior
// tile cannot need it.
template <typename T, int INTERP, bool FAST, int CN, typename F>
__device__ __forceinline__ void pixel(const F& f, float fx, float fy, int cn, bool vacv, int h,
                                      int w, float bv, float* acc) {
  if constexpr (CN > 0) cn = CN;  // the channel loops below unroll without a test
  if constexpr (INTERP == kNearest) {
    float fl;
    int tx, ty;
    floor_index<FAST>(__fadd_rn(fx, 0.5f), fl, tx);
    floor_index<FAST>(__fadd_rn(fy, 0.5f), fl, ty);
    const typename F::Tap t = f.tap(tx, ty);
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      if (k < cn) acc[k] = f.load(t, k);
  } else {
    float sxf, syf;
    int sx, sy;
    floor_index<FAST>(fx, sxf, sx);
    floor_index<FAST>(fy, syf, sy);
    const float ax = __fsub_rn(fx, sxf), ay = __fsub_rn(fy, syf);
    if constexpr (INTERP == kCubic) {
      float cx[4], cy[4];
      cubic_coefs(ax, cx);
      cubic_coefs(ay, cy);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float row[kGroup] = {};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const typename F::Tap t = f.tap(sx - 1 + j, sy - 1 + i);
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            if (k >= cn) continue;
            const float v = __fmul_rn(f.load(t, k), cx[j]);
            row[k] = j == 0 ? v : __fadd_rn(row[k], v);
          }
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (k >= cn) continue;
          const float v = __fmul_rn(row[k], cy[i]);
          acc[k] = i == 0 ? v : __fadd_rn(acc[k], v);
        }
      }
    } else {
      float wt[4];
      linear_weights<T, FAST>(ax, ay, wt);
      const typename F::Tap t00 = f.tap(sx, sy), t10 = f.tap(sx, sy + 1);
      const typename F::Tap t01 = f.tap(sx + 1, sy), t11 = f.tap(sx + 1, sy + 1);
      const bool masked = !FAST && vacv && !(sx >= 0 && sx < w - 1 && sy >= 0 && sy < h - 1);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (k >= cn) continue;
        const float v = blend4([&](int j) {
          return f.load(j == 0 ? t00 : j == 1 ? t10 : j == 2 ? t01 : t11, k);
        }, wt);
        acc[k] = masked ? bv : v;
      }
    }
  }
}

// The u8 epilogue clip(floor(v + eps), 0, 255), the byte in the low bits
// of the result (the rest is 2^23's bit pattern).  Clamping first gives the
// same value, and rounding down into 2^23's mantissa is its floor.  An
// interior linear or nearest pixel is a convex mix of bytes (the Q11
// weights sum to 1 exactly) and needs no clamp.
template <int INTERP, bool FAST>
__device__ __forceinline__ uint32_t to_byte(float v) {
  float u = __fadd_rn(v, INTERP == kLinear ? 1e-4f : 0.5f);
  if constexpr (!(FAST && INTERP != kCubic)) u = fminf(fmaxf(u, 0.f), 255.f);
  return __float_as_uint(__fadd_rd(u, kTwo23));
}

// The u8 pack: lanes 4q .. 4q+3 hold four neighbouring pixels, each with
// its byte of slot s in byte s of `own`; a 4 x 4 byte transpose by two
// shuffles hands lane 4q + s the four bytes of slot s (byte e from lane
// 4q + e).  Every lane of the warp must call it.
__device__ __forceinline__ uint32_t exchange_quad(uint32_t own) {
  const int lane = threadIdx.x;
  uint32_t o = __shfl_xor_sync(0xffffffffu, own, 1);
  own = __byte_perm(own, o, (lane & 1) ? 0x3715 : 0x6240);
  o = __shfl_xor_sync(0xffffffffu, own, 2);
  return __byte_perm(own, o, (lane & 2) ? 0x3276 : 0x5410);
}

// The same from b[s], slot s's byte in its low bits.
__device__ __forceinline__ uint32_t transpose_quad(const uint32_t b[kSlots]) {
  // Own bytes, slot s in byte s.
  return exchange_quad(__byte_perm(__byte_perm(b[0], b[1], 0x0040),
                                   __byte_perm(b[2], b[3], 0x0040), 0x5410));
}

// Four neighbouring u8 outputs of channel k from (qx, qy): one 32-bit store
// where the output is dense in x and aligned, else byte by byte inside it.
__device__ __forceinline__ void store_quad(const Params& p, uint8_t* out, int qx, int qy, int k,
                                           uint32_t w) {
  if (qy >= p.h_out || qx >= p.w_out) return;
  uint8_t* a = out + qy * p.oy + qx * p.ox + k * p.oc;
  if (qx + 3 < p.w_out && p.ox == 1 && (reinterpret_cast<uintptr_t>(a) & 3u) == 0) {
    *reinterpret_cast<uint32_t*>(a) = w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (qx + e < p.w_out) a[e * p.ox] = static_cast<uint8_t>((w >> (8 * e)) & 0xffu);
  }
}

// The source coordinates of a thread's four pixels (slot s = 2 j + i at
// (dx + 32 i, dy + 8 j)), each from its own (dx, dy) in the plain version's
// order ((m0 dx) + (m1 dy)) + m2, the products shared by the slots.
struct SlotCoords {
  float fx_x[2], fy_x[2], fx_y[2], fy_y[2];
  __device__ __forceinline__ SlotCoords(const Params& p, int dx, int dy) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float fdx = static_cast<float>(dx + kBlockX * i);
      const float fdy = static_cast<float>(dy + kBlockY * i);
      fx_x[i] = __fmul_rn(p.m[0], fdx);
      fy_x[i] = __fmul_rn(p.m[3], fdx);
      fx_y[i] = __fmul_rn(p.m[1], fdy);
      fy_y[i] = __fmul_rn(p.m[4], fdy);
    }
  }
  __device__ __forceinline__ void at(const Params& p, int s, float& fx, float& fy) const {
    fx = __fadd_rn(__fadd_rn(fx_x[s & 1], fx_y[s >> 1]), p.m[2]);
    fy = __fadd_rn(__fadd_rn(fy_x[s & 1], fy_y[s >> 1]), p.m[5]);
  }
};

__device__ __forceinline__ bool slot_inside(const Params& p, int dx, int dy, int s) {
  return dx + kBlockX * (s & 1) < p.w_out && dy + kBlockY * (s >> 1) < p.h_out;
}

// A thread's four pixels, up to cn channels: computed through F and
// stored.  A warp's 32 lanes are 32 neighbouring pixels of a row, so a tap
// load touches neighbouring source bytes (no bank conflicts in a staged
// box) and an f32 store is dense; a u8 plane is packed by transpose_quad.
// Every lane of the warp must call this (the shuffles), whether or not its
// pixels lie inside the output.  CN > 0 is the channel count at compile
// time (0: `cn` at run time).
template <typename T, int INTERP, bool FAST, int CN, typename F>
__device__ __forceinline__ void run_cn(const F& f, const Params& p, T* out, int dx, int dy,
                                       int cn) {
  if constexpr (CN > 0) cn = CN;
  const SlotCoords xy(p, dx, dy);
  float res[kSlots][kGroup];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) res[s][k] = 0.f;
    if (!slot_inside(p, dx, dy, s)) continue;
    float fx, fy;
    xy.at(p, s, fx, fy);
    pixel<T, INTERP, FAST, CN>(f, fx, fy, cn, p.vacv != 0, p.h, p.w, p.bv, res[s]);
  }
  if constexpr (sizeof(T) == 1) {
    const int c = threadIdx.x & 3;
    // After the transpose this lane holds slot c of the quad at dx - c.
    const int qx = dx - c + kBlockX * (c & 1), qy = dy + kBlockY * (c >> 1);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (k >= cn) continue;  // cn is the same in every lane
      uint32_t b[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) b[s] = to_byte<INTERP, FAST>(res[s][k]);
      store_quad(p, out, qx, qy, k, transpose_quad(b));
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int x = dx + kBlockX * (s & 1), y = dy + kBlockY * (s >> 1);
      if (x >= p.w_out || y >= p.h_out) continue;
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        if (k < cn) out[y * p.oy + x * p.ox + k * p.oc] = res[s][k];
    }
  }
}

// Three channels (BGR) are the pipelines' case: it gets a copy of the body
// without the per-channel tests.
template <typename T, int INTERP, bool FAST, typename F>
__device__ __forceinline__ void run(const F& f, const Params& p, T* out, int dx, int dy, int cn) {
  if (cn == 3) {
    run_cn<T, INTERP, FAST, 3>(f, p, out, dx, dy, cn);
  } else {
    run_cn<T, INTERP, FAST, 0>(f, p, out, dx, dy, cn);
  }
}

// The floors of a coordinate at the tile's four corners, as a range, when
// all four allow an interior tile along an axis of n source pixels: every
// tap of the tile then lies in [lo, hi] and that lies in [0, n - 1].
// ops/cuda/warp_affine.py::tile_box is the same rule on the host.
template <int INTERP>
struct Support {  // taps to the left of floor(f), and to the right, plus one
  static constexpr int lo = INTERP == kCubic ? 2 : 1, hi = INTERP == kCubic ? 3 : 2;
};

// Does a corner's floor allow an interior tile?  False for a NaN or an
// out-of-range corner.
template <int INTERP>
__device__ __forceinline__ bool corner_inside(float fl, int n) {
  return fl >= static_cast<float>(Support<INTERP>::lo) &&
         fl <= static_cast<float>(n - 1 - Support<INTERP>::hi);
}

template <int INTERP>
__device__ __forceinline__ bool corner_range(const float c[4], int n, int& lo, int& hi) {
  constexpr int g_lo = Support<INTERP>::lo, g_hi = Support<INTERP>::hi;
  float mn = 0.f, mx = 0.f;
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float fl = floorf(c[i]);
    ok = ok && corner_inside<INTERP>(fl, n);
    mn = i == 0 ? fl : fminf(mn, fl);
    mx = i == 0 ? fl : fmaxf(mx, fl);
  }
  if (!ok) return false;
  lo = static_cast<int>(mn) - g_lo;
  hi = static_cast<int>(mx) + g_hi;
  return true;
}

// The output tile at (x0, y0): its first and last columns (ex) and rows
// (ey), cut at the output's edge; and the source coordinate of the corner
// (ex[i], ey[j]).
__device__ __forceinline__ void tile_edges(const Params& p, int x0, int y0, float ex[2],
                                           float ey[2]) {
  ex[0] = static_cast<float>(x0);
  ex[1] = static_cast<float>(min(x0 + kTileX, p.w_out) - 1);
  ey[0] = static_cast<float>(y0);
  ey[1] = static_cast<float>(min(y0 + kTileY, p.h_out) - 1);
}
__device__ __forceinline__ void tile_corner(const Params& p, float fdx, float fdy, float& cx,
                                            float& cy) {
  cx = __fadd_rn(__fadd_rn(__fmul_rn(p.m[0], fdx), __fmul_rn(p.m[1], fdy)), p.m[2]);
  cy = __fadd_rn(__fadd_rn(__fmul_rn(p.m[3], fdx), __fmul_rn(p.m[4], fdy)), p.m[5]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// What a block's threads share about their tile.  One thread works it out
// (a few hundred instructions that would otherwise be repeated by every
// thread of every tile, as much again as a bilinear pixel's arithmetic).
struct Tile {
  const void* src;  // the frame's channel group
  void* out;
  const void* box;  // staged: the first 16-byte unit (or element) of the box's first row
  int cn;
  int path;         // kEdgePath / kDirectPath / kStagedPath
  int hwc;          // staged: one run a row holds the channels (else one run a row and channel)
  int bh, pitch, per_row;  // staged: box rows, elements a staged run, copies a run
  int xs;           // staged: elements between neighbouring pixels of a run
  int origin;       // staged: where source pixel (0, 0) would lie in the staged array
};
enum { kEdgePath = 0, kDirectPath = 1, kStagedPath = 2 };

template <typename T, int INTERP>
__device__ void plan_tile(const Params& p, Tile& t) {
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const int frame = p.groups == 1 ? blockIdx.z : blockIdx.z / p.groups;
  const int c0 = (blockIdx.z - frame * p.groups) * kGroup;
  const int cn = min(kGroup, p.c - c0);
  const T* src = static_cast<const T*>(p.src) + frame * p.sn + c0 * p.sc;
  if (p.row0_ptr != nullptr)  // the crop's top, clamped so that it stays in the frame
    src += static_cast<int64_t>(min(max(__ldg(p.row0_ptr), 0), p.rows_full - p.h)) * p.sy;
  t.src = src;
  t.out = static_cast<T*>(p.out) + frame * p.on + c0 * p.oc;
  t.cn = cn;
  t.path = kEdgePath;
  if (p.mode == kEdgeOnly || !p.fast_ok) return;
  // The tile's source box, from the coordinates of its four corners.
  float ex[2], ey[2], cx[4], cy[4];
  tile_edges(p, x0, y0, ex, ey);
#pragma unroll
  for (int i = 0; i < 4; ++i) tile_corner(p, ex[i & 1], ey[i >> 1], cx[i], cy[i]);
  int x_lo, x_hi, y_lo, y_hi;
  if (!corner_range<INTERP>(cx, p.w, x_lo, x_hi) || !corner_range<INTERP>(cy, p.h, y_lo, y_hi))
    return;
  t.path = kDirectPath;
  // Only the cubic kernel stages: its 16 taps a pixel read each source byte
  // many times over.  With 4 taps or 1 the copy costs what it saves.
  if (INTERP != kCubic || p.layout == kStrided || p.mode != kAuto) return;
  // Stage the box as dense runs of `run_elems` source elements: bh runs
  // (HWC) or bh x cn (planar).
  constexpr int kPer = 16 / sizeof(T);  // elements in 16 bytes
  const int bw = x_hi - x_lo + 1, bh = y_hi - y_lo + 1;
  const bool hwc = p.layout == kHwc;
  const int xs = hwc ? static_cast<int>(p.sx) : 1;
  const int run_elems = hwc ? (bw - 1) * xs + cn : bw;
  const T* first = src + y_lo * p.sy + x_lo * p.sx;
  const int skew = p.vec ? static_cast<int>((reinterpret_cast<uintptr_t>(first) & 15u) / sizeof(T)) : 0;
  const int pitch = p.vec ? (skew + run_elems + kPer - 1) / kPer * kPer : run_elems;
  if (static_cast<int64_t>(hwc ? bh : bh * cn) * pitch * sizeof(T) > kStageBytes) return;
  t.path = kStagedPath;
  t.box = first - skew;
  t.hwc = hwc;
  t.bh = bh;
  t.pitch = pitch;
  t.per_row = p.vec ? pitch / kPer : run_elems;
  t.xs = xs;
  t.origin = skew - y_lo * pitch - x_lo * xs;
}

template <typename T, int INTERP>
__global__ void __launch_bounds__(kThreads, INTERP == kCubic ? 5 : 1) warp_kernel(Params p) {
  __shared__ uint4 stage[kStageBytes / 16];
  __shared__ Tile tile;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  if (tid == 0) plan_tile<T, INTERP>(p, tile);
  __syncthreads();
  const Tile t = tile;
  const T* src = static_cast<const T*>(t.src);
  T* out = static_cast<T*>(t.out);
  const int dx = blockIdx.x * kTileX + threadIdx.x, dy = blockIdx.y * kTileY + threadIdx.y;

  if (INTERP == kCubic && t.path == kStagedPath) {
    // 16 threads a run, 16 runs at a time: no division in the copy.
    T* st = reinterpret_cast<T*>(stage);
    const T* g0 = static_cast<const T*>(t.box);
    for (int k = 0; k < (t.hwc ? 1 : t.cn); ++k) {
      for (int r = tid >> 4; r < t.bh; r += kThreads / 16) {
        const T* g = g0 + r * p.sy + k * p.sc;
        const int at = (k * t.bh + r) * t.per_row;
        for (int u = tid & 15; u < t.per_row; u += 16) {
          if (p.vec) {
            cp_async16(stage + at + u, reinterpret_cast<const uint4*>(g) + u);
          } else {
            st[at + u] = __ldg(g + u);
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (t.hwc) {
      const Inside<T, int, false, true> f = {st + t.origin, t.pitch, t.xs, 1};
      run<T, INTERP, true>(f, p, out, dx, dy, t.cn);
    } else {
      const Inside<T, int, false> f = {st + t.origin, t.pitch, 1, t.bh * t.pitch};
      run<T, INTERP, true>(f, p, out, dx, dy, t.cn);
    }
  } else if (t.path == kDirectPath) {
    if (p.idx32) {
      const Inside<T, int, true> f = {src, static_cast<int>(p.sy), static_cast<int>(p.sx),
                                      static_cast<int>(p.sc)};
      run<T, INTERP, true>(f, p, out, dx, dy, t.cn);
    } else {
      const Inside<T, int64_t, true> f = {src, p.sy, p.sx, p.sc};
      run<T, INTERP, true>(f, p, out, dx, dy, t.cn);
    }
  } else {
    const Edge<T> f = {src, p.sy, p.sx, p.sc, p.h, p.w, p.border, p.bv};
    run<T, INTERP, false>(f, p, out, dx, dy, t.cn);
  }
}

template <typename T>
void launch(const Params& p, int interp, dim3 grid, cudaStream_t s) {
  const dim3 block(kBlockX, kBlockY);
  if (interp == kNearest) {
    warp_kernel<T, kNearest><<<grid, block, 0, s>>>(p);
  } else if (interp == kCubic) {
    warp_kernel<T, kCubic><<<grid, block, 0, s>>>(p);
  } else {
    warp_kernel<T, kLinear><<<grid, block, 0, s>>>(p);
  }
}

// The f32 kernels' launch, compiled in warp_affine_f32.cu.
void launch_f32(const Params& p, int interp, dim3 grid, cudaStream_t s);

// The 3-channel u8 HWC linear form's launch, compiled in warp_affine_hwc3.cu.
void launch_hwc3(const Params& p, dim3 grid, cudaStream_t s);

}  // namespace vacv_warp
