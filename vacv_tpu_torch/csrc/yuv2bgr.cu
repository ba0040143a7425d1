// NV12/NV21 -> B, G, R u8 planes, for Hopper (sm_90a), with a plain C
// interface loaded by ctypes (vacv_tpu_torch/ops/cuda/yuv2bgr.py).
//
// Replaces: vacv_tpu/ops/pallas/yuv2bgr.py::_kernel, the TPU kernel behind
// nv_to_bgr_pallas.  The TPU kernel spreads each chroma pair over its two
// lanes with a lane roll and a parity select, and repeats chroma rows with
// a 0/1 matmul on the MXU, because the TPU has no cheap gather.  Here a
// thread reads the bytes it needs as vectors and spreads them in registers.
//
// Bound: bytes.  1.5 bytes in and 3 bytes out per pixel, a few integer
// operations each: 9.3 MB at 1080p, about 2.8 us at 3.35 TB/s.  A thread
// per chroma pair and Y row, with byte loads and 2-byte stores, was bound
// by the count of its memory instructions instead (6.40 us at 1080p).
//
// Design: a thread takes V bytes (V = 8, 4 or 2: the wrapper's
// vector_width picks the widest the widths, strides and base addresses
// allow that still leaves enough threads: 8 at 1080p, 4 at 720p, 2 at
// 144 x 176; 16 left too few threads at every size up to 4K) of the two
// Y rows 2r and 2r + 1 and of chroma row r, which both
// share: two V-byte Y loads and one V-byte chroma load, 2 V decodes in
// registers (one set of chroma adders per pair, for its 2 x 2 pixels), and
// six V-byte stores, one per plane and row.  Bytes are taken out of and
// put into the words by shifts; there is no per-byte load, except at V = 2,
// which takes any base address (a Y view at an odd byte offset) and reads
// its two bytes of each row one by one.  An odd h leaves the last Y row
// without a partner: it pairs with the last chroma row (the reference's
// zerobuf trick, cvt_color.cpp:52-66).  Y and VU are two row-strided views
// of the stacked buffer; nothing is copied.  The decode is bit-exact Q7
// integer math (nv_decode.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "nv_decode.cuh"

namespace {

constexpr int kBlockX = 32;  // vectors along a row
constexpr int kBlockY = 4;   // row pairs

template <int V>
constexpr int kWords = (V + 3) / 4;

template <int V>
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint32_t (&w)[kWords<V>]) {
  if constexpr (V == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x, w[1] = u.y;
  } else if constexpr (V == 4) {
    w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  } else {
    w[0] = static_cast<uint32_t>(__ldg(p)) | (static_cast<uint32_t>(__ldg(p + 1)) << 8);
  }
}

template <int V>
__device__ __forceinline__ void store_bytes(uint8_t* p, const uint32_t (&w)[kWords<V>]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
  }
}

__device__ __forceinline__ int byte_of(const uint32_t* w, int i) {
  return static_cast<int>((w[i >> 2] >> (8 * (i & 3))) & 0xffu);
}

__device__ __forceinline__ void put_byte(uint32_t* w, int i, int v) {
  w[i >> 2] |= static_cast<uint32_t>(v) << (8 * (i & 3));
}

template <bool IS_NV12, int V>
__global__ void __launch_bounds__(kBlockX * kBlockY) yuv2bgr_kernel(
    const uint8_t* __restrict__ y, int64_t y_stride,
    const uint8_t* __restrict__ vu, int64_t vu_stride,
    uint8_t* __restrict__ out, int h, int w) {
  constexpr int N = kWords<V>;
  const int x = (blockIdx.x * kBlockX + threadIdx.x) * V;
  const int pair = blockIdx.y * kBlockY + threadIdx.y;
  const int row = 2 * pair;
  if (x >= w || row >= h) return;
  const bool two = row + 1 < h;
  uint32_t c[N], y0[N], y1[N];
  load_bytes<V>(vu + pair * vu_stride + x, c);
  load_bytes<V>(y + row * y_stride + x, y0);
  if (two) {
    load_bytes<V>(y + (row + 1) * y_stride + x, y1);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) y1[k] = 0;
  }
  uint32_t b0[N], g0[N], r0[N], b1[N], g1[N], r1[N];
#pragma unroll
  for (int k = 0; k < N; ++k) b0[k] = g0[k] = r0[k] = b1[k] = g1[k] = r1[k] = 0;
#pragma unroll
  for (int i = 0; i < V; i += 2) {
    const vacv::ChromaQ7 a = vacv::chroma_q7<IS_NV12>(byte_of(c, i), byte_of(c, i + 1));
#pragma unroll
    for (int e = i; e < i + 2; ++e) {
      int b, g, r;
      vacv::apply_q7(byte_of(y0, e), a, b, g, r);
      put_byte(b0, e, b), put_byte(g0, e, g), put_byte(r0, e, r);
      vacv::apply_q7(byte_of(y1, e), a, b, g, r);
      put_byte(b1, e, b), put_byte(g1, e, g), put_byte(r1, e, r);
    }
  }
  // w and x are multiples of V, and so is the plane size h * w: every
  // store is V-aligned in the fresh `out`.
  const int64_t plane = static_cast<int64_t>(h) * w;
  uint8_t* o = out + static_cast<int64_t>(row) * w + x;
  store_bytes<V>(o, b0);
  store_bytes<V>(o + plane, g0);
  store_bytes<V>(o + 2 * plane, r0);
  if (two) {
    store_bytes<V>(o + w, b1);
    store_bytes<V>(o + w + plane, g1);
    store_bytes<V>(o + w + 2 * plane, r1);
  }
}

template <bool IS_NV12>
int launch(int vec, dim3 grid, cudaStream_t s, const uint8_t* y, int64_t y_stride,
           const uint8_t* vu, int64_t vu_stride, uint8_t* out, int h, int w) {
  const dim3 block(kBlockX, kBlockY);
  switch (vec) {
    case 8:
      yuv2bgr_kernel<IS_NV12, 8><<<grid, block, 0, s>>>(y, y_stride, vu, vu_stride, out, h, w);
      break;
    case 4:
      yuv2bgr_kernel<IS_NV12, 4><<<grid, block, 0, s>>>(y, y_stride, vu, vu_stride, out, h, w);
      break;
    default:
      yuv2bgr_kernel<IS_NV12, 2><<<grid, block, 0, s>>>(y, y_stride, vu, vu_stride, out, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int64_t stride, int vec) {
  return reinterpret_cast<uintptr_t>(p) % vec == 0 && stride % vec == 0;
}

}  // namespace

extern "C" {

// Decode Y (h rows of w bytes, rows y_stride apart) and VU (ceil(h/2)
// rows, vu_stride apart) into `out`, three contiguous (h, w) u8 planes
// B, G, R, `vec` bytes a thread: 2 for any planes (w even, `out` 2-byte
// aligned), 4 or 8 where vec divides w and both strides and the three
// base addresses are vec-aligned.  h <= 8 * 65535.  Returns a cudaError_t
// (0 on success).
int vacv_yuv2bgr(int device, void* stream, const void* y, long long y_stride,
                 const void* vu, long long vu_stride, void* out, int h, int w,
                 int is_nv12, int vec) {
  cudaGetLastError();  // clear a stale error of an earlier call
  if ((vec != 2 && vec != 4 && vec != 8) || w % vec ||
      (vec > 2 && !(aligned(y, y_stride, vec) && aligned(vu, vu_stride, vec))) ||
      !aligned(out, w, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pairs = (h + 1) / 2;
  const dim3 grid((w / vec + kBlockX - 1) / kBlockX, (pairs + kBlockY - 1) / kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* y8 = static_cast<const uint8_t*>(y);
  const uint8_t* vu8 = static_cast<const uint8_t*>(vu);
  uint8_t* o8 = static_cast<uint8_t*>(out);
  return is_nv12 ? launch<true>(vec, grid, s, y8, y_stride, vu8, vu_stride, o8, h, w)
                 : launch<false>(vec, grid, s, y8, y_stride, vu8, vu_stride, o8, h, w);
}

}  // extern "C"
