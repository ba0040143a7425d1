// The affine warp's form for 3-channel u8 HWC sources, linear (its notes at
// the head of warp_affine.cuh), in a source of its own: a kernel added to
// warp_affine.cu changes how the kernels there are compiled.

#include "warp_affine.cuh"

namespace vacv_warp {

// Blocks an SM that the launch bounds ask for: 64 registers a thread, the
// most that 4 blocks of 256 threads allow, and no spills.
constexpr int kHwc3Blocks = 4;

// One pixel of an interior tile of a 3-channel u8 HWC source, before the
// epilogue: the shared pixel() arithmetic with its taps at immediate
// offsets.  The floors' bits are 0x4B400000 plus the index, so
// bits(ty) sy + 3 bits(tx) - bias is, mod 2^32, the offset of tap (x, y),
// which is below 2^31 (idx32); the right-hand neighbour's channels are
// +3 .. +5, the next row is + sy.
__device__ __forceinline__ void pixel_hwc3(const uint8_t* src, uint32_t sy, uint32_t bias,
                                           float fx, float fy, float acc[3]) {
  const float tx = floor_magic(fx), ty = floor_magic(fy);
  const float ax = __fsub_rn(fx, __fsub_rn(tx, kFloorMagic));
  const float ay = __fsub_rn(fy, __fsub_rn(ty, kFloorMagic));
  float wt[4];
  linear_weights<uint8_t, true>(ax, ay, wt);
  const uint8_t* a = src + (__float_as_uint(ty) * sy + __float_as_uint(tx) * 3u - bias);
  const uint8_t* b = a + sy;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    acc[k] = blend4([&](int j) { return to_float(__ldg((j & 1 ? b : a) + (j & 2 ? 3 : 0) + k)); },
                    wt);
}

// A thread's four pixels of an interior tile; FULL: the tile lies whole
// inside the output, so no slot is tested and, with out4, every quad
// leaves as one 32-bit store.  Each slot's bytes go into byte s of own[k]
// as soon as they are known (slot 0 as to_byte leaves it), so three words
// stay live across the slots, not twelve floats.
template <bool FULL>
__device__ __forceinline__ void run_hwc3(const uint8_t* src, const Params& p, uint8_t* out,
                                         int dx, int dy) {
  const uint32_t sy = static_cast<uint32_t>(p.sy);
  const uint32_t bias = 0x4B400000u * (sy + 3u);
  const SlotCoords xy(p, dx, dy);
  uint32_t own[3];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    float acc[3] = {0.f, 0.f, 0.f};
    if (FULL || slot_inside(p, dx, dy, s)) {
      float fx, fy;
      xy.at(p, s, fx, fy);
      pixel_hwc3(src, sy, bias, fx, fy, acc);
    }
    // Byte s from b, the others from own[k].
    const uint32_t into = s == 1 ? 0x3240 : s == 2 ? 0x3410 : 0x4210;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint32_t b = to_byte<kLinear, true>(acc[k]);
      own[k] = s == 0 ? b : __byte_perm(own[k], b, into);
    }
  }
  const int c = threadIdx.x & 3;
  const int qx = dx - c + kBlockX * (c & 1), qy = dy + kBlockY * (c >> 1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint32_t w = exchange_quad(own[k]);
    if (FULL && p.out4) {
      *reinterpret_cast<uint32_t*>(out + qy * p.oy + qx + k * p.oc) = w;
    } else {
      store_quad(p, out, qx, qy, k, w);
    }
  }
}

// The warp kernel for u8 HWC sources of three channels (sc = 1, sx = 3),
// linear, every offset within 32 bits.  Each warp classifies the tile by
// plan_tile's rule itself: lane i takes corner i & 3 and the warp votes,
// so no thread waits at a barrier for another.  Edge tiles take the
// per-tap border rule, as in warp_kernel.
__global__ void __launch_bounds__(kThreads, kHwc3Blocks) warp_kernel_hwc3(Params p) {
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const uint8_t* src = static_cast<const uint8_t*>(p.src) + blockIdx.z * p.sn;
  if (p.row0_ptr != nullptr)  // the crop's top, clamped so that it stays in the frame
    src += static_cast<int64_t>(min(max(__ldg(p.row0_ptr), 0), p.rows_full - p.h)) * p.sy;
  uint8_t* out = static_cast<uint8_t*>(p.out) + blockIdx.z * p.on;
  const int dx = x0 + threadIdx.x, dy = y0 + threadIdx.y;
  float ex[2], ey[2], cx, cy;
  tile_edges(p, x0, y0, ex, ey);
  tile_corner(p, ex[threadIdx.x & 1], ey[(threadIdx.x >> 1) & 1], cx, cy);
  const bool interior =
      p.mode != kEdgeOnly && p.fast_ok &&
      __all_sync(0xffffffffu, corner_inside<kLinear>(floorf(cx), p.w) &&
                                  corner_inside<kLinear>(floorf(cy), p.h));
  if (!interior) {
    const Edge<uint8_t> f = {src, p.sy, p.sx, p.sc, p.h, p.w, p.border, p.bv};
    run_cn<uint8_t, kLinear, false, 3>(f, p, out, dx, dy, 3);
  } else if (x0 + kTileX <= p.w_out && y0 + kTileY <= p.h_out) {
    run_hwc3<true>(src, p, out, dx, dy);
  } else {
    run_hwc3<false>(src, p, out, dx, dy);
  }
}

void launch_hwc3(const Params& p, dim3 grid, cudaStream_t s) {
  warp_kernel_hwc3<<<grid, dim3(kBlockX, kBlockY), 0, s>>>(p);
}

}  // namespace vacv_warp

