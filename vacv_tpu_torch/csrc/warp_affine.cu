// Inverse-mapped affine warp of strided planes, for Hopper (sm_90a), with a
// plain C interface loaded by ctypes (vacv_tpu_torch/ops/cuda/warp_affine.py).
// The kernel and its notes are in warp_affine.cuh; this source holds the
// interface and the u8 kernels, warp_affine_f32.cu the f32 kernels and
// warp_affine_hwc3.cu the 3-channel u8 HWC linear form.

#include "warp_affine.cuh"

using namespace vacv_warp;

extern "C" {

// Warp n frames of c planes (u8 when is_u8, else f32) of h x w at `src`,
// element strides sn/sc/sy/sx (none negative), into `out` (the same type),
// h_out x w_out per plane at element strides on/oc/oy/ox, with the inverse
// matrix m0..m5.  interp: 0 nearest, 1 linear, 2 cubic; border: 0 constant,
// 1 replicate, 2 reflect, 3 wrap, 4 reflect_101; vacv: the skip-edge mask
// (linear).  mode: 0 picks each tile's path (staged, direct, edge), 1 never
// stages, 2 runs every tile through the per-tap border rule.  row0_ptr:
// null, or a device int, the top of the h rows to warp in frames of
// rows_full rows (clamped to [0, rows_full - h]); `src` is then the
// frames' row 0.  The caller keeps n * ceil(c / 4) <= 65535 and
// ceil(h_out / 16) <= 65535.  Returns a cudaError_t (0 on success).
int vacv_warp_affine(int device, void* stream, const void* src, int is_u8, int n, int c,
                     int h, int w, long long sn, long long sc, long long sy, long long sx,
                     void* out, int h_out, int w_out, long long on, long long oc,
                     long long oy, long long ox, float m0, float m1, float m2, float m3,
                     float m4, float m5, int interp, int border, float border_value,
                     int vacv, int mode, const void* row0_ptr, int rows_full) {
  cudaGetLastError();  // clear a stale error of an earlier call
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (sn < 0 || sc < 0 || sy < 0 || sx < 0 || (row0_ptr != nullptr && rows_full < h))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.src = src;
  p.sn = sn;
  p.sc = sc;
  p.sy = sy;
  p.sx = sx;
  p.row0_ptr = static_cast<const int*>(row0_ptr);
  p.rows_full = rows_full;
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
  const int es = is_u8 ? 1 : 4;
  p.layout = sx == 1 ? kPlanar : (sc == 1 && sx >= c ? kHwc : kStrided);
  p.vec = (sy * es) % 16 == 0 && (p.layout == kHwc || (sc * es) % 16 == 0);
  // On the whole frame's extent: a block's offsets from a moved top stay inside it.
  p.idx32 = ((row0_ptr != nullptr ? rows_full : h) - 1) * sy + (w - 1) * sx + (c - 1) * sc <
            2147483647LL;
  p.fast_ok = h < kFastLimit && w < kFastLimit;
  p.mode = mode;
  p.out4 = ox == 1 && (oy | oc | on) % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 3u) == 0;
  const dim3 grid((w_out + kTileX - 1) / kTileX, (h_out + kTileY - 1) / kTileY, n * p.groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // ops/cuda/warp_affine.py::hwc3_form is this choice on the host.
  if (is_u8 && interp == kLinear && c == 3 && sc == 1 && sx == 3 && p.idx32) {
    launch_hwc3(p, grid, s);
  } else if (is_u8) {
    launch<uint8_t>(p, interp, grid, s);
  } else {
    launch_f32(p, interp, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
