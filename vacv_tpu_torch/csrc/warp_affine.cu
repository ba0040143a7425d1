// Inverse-mapped affine warp of strided planes, for Hopper (sm_90a), with a
// plain C interface loaded by ctypes (vacv_tpu_torch/ops/cuda/warp_affine.py).
//
// Replaces: vacv_tpu/ops/pallas/warp_affine.py::_kernel, the TPU kernel
// behind warp_affine_pallas.  The TPU has no fast gather, so that kernel
// selects its taps with 0/1 selection matmuls over 128-column source
// windows (f32 through a bf16 hi/lo split), keeps planes resident in VMEM
// or streams row bands, and serves the remap borders by pre-padding the
// source.  Here each thread simply loads its taps.
//
// What it computes, for N frames of C planes (any strides: CHW planes, an
// HWC frame, or a crop view of either, with no transpose, pad or copy):
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
// __fmul_rn / __fadd_rn / __fsub_rn in the plain version's order, and a u8
// output is bit-exact to it.
//
// Bound: bytes.  A few dozen flops per output pixel and channel against at
// least one source byte (u8) or four (f32) read and one written.  One thread
// per output pixel computes the coordinate and the weights once and applies
// them to up to kGroup channels; neighbouring threads read neighbouring
// source pixels, so the taps of a warp come from a few cache lines through
// L1.  Grid z is frames x channel groups: a whole batch is one launch.
// Nothing is staged in shared memory yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kGroup = 4;  // channels per thread
constexpr float kCoordLimit = 1073741824.0f;  // 2^30, as the plain version

// InterMode and BorderMode values (vacv_tpu_torch/core/types.py).
enum { kNearest = 0, kLinear = 1, kCubic = 2 };
enum { kConstant = 0, kReplicate = 1, kReflect = 2, kWrap = 3, kReflect101 = 4 };

struct Params {
  const void* src;
  int64_t sn, sc, sy, sx;  // source strides, in elements
  void* out;
  int64_t on, oc, oy, ox;  // output strides, in elements
  int c, h, w, h_out, w_out, groups;
  float m[6];
  int border;
  float bv;
  int vacv;
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

struct Tap {
  int64_t off;
  bool ok;
};

__device__ __forceinline__ Tap make_tap(int tx, int ty, const Params& p) {
  if (p.border == kConstant) {
    const bool ok = tx >= 0 && tx <= p.w - 1 && ty >= 0 && ty <= p.h - 1;
    return {ok ? ty * p.sy + tx * p.sx : 0, ok};
  }
  return {remap(ty, p.h, p.border) * p.sy + remap(tx, p.w, p.border) * p.sx, true};
}

template <typename T>
__device__ __forceinline__ float load(const T* src, const Tap& t, int64_t ch, float bv) {
  return t.ok ? static_cast<float>(__ldg(src + t.off + ch)) : bv;
}

__device__ __forceinline__ float q11(float w) {
  return __fmul_rn(floorf(__fadd_rn(__fmul_rn(w, 2048.f), 0.5f)), 1.f / 2048.f);
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

template <typename T>
__device__ __forceinline__ void store(T* out, float v, int interp) {
  if constexpr (sizeof(T) == 1) {
    const float eps = interp == kLinear ? 1e-4f : 0.5f;
    *out = static_cast<T>(fminf(fmaxf(floorf(__fadd_rn(v, eps)), 0.f), 255.f));
  } else {
    *out = v;
  }
}

template <typename T, int INTERP>
__global__ void __launch_bounds__(kBlockX* kBlockY) warp_kernel(Params p) {
  const int dx = blockIdx.x * kBlockX + threadIdx.x;
  const int dy = blockIdx.y * kBlockY + threadIdx.y;
  if (dx >= p.w_out || dy >= p.h_out) return;
  const int frame = blockIdx.z / p.groups;
  const int c0 = (blockIdx.z % p.groups) * kGroup;
  const int cn = min(kGroup, p.c - c0);
  const T* src = static_cast<const T*>(p.src) + frame * p.sn + c0 * p.sc;
  T* out = static_cast<T*>(p.out) + frame * p.on + c0 * p.oc + dy * p.oy + dx * p.ox;

  const float fdx = static_cast<float>(dx), fdy = static_cast<float>(dy);
  const float fx = __fadd_rn(__fadd_rn(__fmul_rn(p.m[0], fdx), __fmul_rn(p.m[1], fdy)), p.m[2]);
  const float fy = __fadd_rn(__fadd_rn(__fmul_rn(p.m[3], fdx), __fmul_rn(p.m[4], fdy)), p.m[5]);
  float acc[kGroup] = {};

  if constexpr (INTERP == kNearest) {
    const Tap t = make_tap(to_index(floorf(__fadd_rn(fx, 0.5f))),
                           to_index(floorf(__fadd_rn(fy, 0.5f))), p);
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      if (k < cn) acc[k] = load(src, t, k * p.sc, p.bv);
  } else {
    const float sxf = floorf(fx), syf = floorf(fy);
    const float ax = __fsub_rn(fx, sxf), ay = __fsub_rn(fy, syf);
    const int sx = to_index(sxf), sy = to_index(syf);
    if constexpr (INTERP == kCubic) {
      float cx[4], cy[4];
      cubic_coefs(ax, cx);
      cubic_coefs(ay, cy);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float row[kGroup] = {};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const Tap t = make_tap(sx - 1 + j, sy - 1 + i, p);
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            if (k >= cn) continue;
            const float v = __fmul_rn(load(src, t, k * p.sc, p.bv), cx[j]);
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
      float wx0, wx1, wy0, wy1;
      if constexpr (sizeof(T) == 1) {
        wx0 = q11(__fsub_rn(1.f, ax));
        wx1 = __fsub_rn(1.f, wx0);
        wy0 = q11(__fsub_rn(1.f, ay));
        wy1 = __fsub_rn(1.f, wy0);
      } else {
        wx0 = __fsub_rn(1.f, ax);
        wx1 = ax;
        wy0 = __fsub_rn(1.f, ay);
        wy1 = ay;
      }
      const float w00 = __fmul_rn(wx0, wy0), w10 = __fmul_rn(wx0, wy1);
      const float w01 = __fmul_rn(wx1, wy0), w11 = __fmul_rn(wx1, wy1);
      const Tap t00 = make_tap(sx, sy, p), t10 = make_tap(sx, sy + 1, p);
      const Tap t01 = make_tap(sx + 1, sy, p), t11 = make_tap(sx + 1, sy + 1, p);
      const bool full = sx >= 0 && sx < p.w - 1 && sy >= 0 && sy < p.h - 1;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (k >= cn) continue;
        const int64_t ch = k * p.sc;
        float v = __fmul_rn(load(src, t00, ch, p.bv), w00);
        v = __fadd_rn(v, __fmul_rn(load(src, t10, ch, p.bv), w10));
        v = __fadd_rn(v, __fmul_rn(load(src, t01, ch, p.bv), w01));
        v = __fadd_rn(v, __fmul_rn(load(src, t11, ch, p.bv), w11));
        acc[k] = p.vacv && !full ? p.bv : v;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
    if (k < cn) store(out + k * p.oc, acc[k], INTERP);
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

}  // namespace

extern "C" {

// Channels a thread warps: the caller keeps n * ceil(c / group) <= 65535.
int vacv_warp_affine_group(void) { return kGroup; }

// Warp n frames of c planes (u8 when is_u8, else f32) of h x w at `src`,
// element strides sn/sc/sy/sx, into `out` (the same type), h_out x w_out
// per plane at element strides on/oc/oy/ox, with the inverse matrix m0..m5.
// interp: 0 nearest, 1 linear, 2 cubic; border: 0 constant, 1 replicate,
// 2 reflect, 3 wrap, 4 reflect_101; vacv: the skip-edge mask (linear).
// Returns a cudaError_t (0 on success).
int vacv_warp_affine(int device, void* stream, const void* src, int is_u8, int n, int c,
                     int h, int w, long long sn, long long sc, long long sy, long long sx,
                     void* out, int h_out, int w_out, long long on, long long oc,
                     long long oy, long long ox, float m0, float m1, float m2, float m3,
                     float m4, float m5, int interp, int border, float border_value,
                     int vacv) {
  cudaGetLastError();  // clear a stale error of an earlier call
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p;
  p.src = src;
  p.sn = sn;
  p.sc = sc;
  p.sy = sy;
  p.sx = sx;
  p.out = out;
  p.on = on;
  p.oc = oc;
  p.oy = oy;
  p.ox = ox;
  p.c = c;
  p.h = h;
  p.w = w;
  p.h_out = h_out;
  p.w_out = w_out;
  p.groups = (c + kGroup - 1) / kGroup;
  p.m[0] = m0;
  p.m[1] = m1;
  p.m[2] = m2;
  p.m[3] = m3;
  p.m[4] = m4;
  p.m[5] = m5;
  p.border = border;
  p.bv = border_value;
  p.vacv = vacv && interp == kLinear;
  const dim3 grid((w_out + kBlockX - 1) / kBlockX, (h_out + kBlockY - 1) / kBlockY,
                  n * p.groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u8) {
    launch<uint8_t>(p, interp, grid, s);
  } else {
    launch<float>(p, interp, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
