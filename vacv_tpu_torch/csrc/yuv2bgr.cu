// NV12/NV21 -> B, G, R u8 planes, for Hopper (sm_90a), with a plain C
// interface loaded by ctypes (vacv_tpu_torch/ops/cuda/yuv2bgr.py).
//
// Replaces: vacv_tpu/ops/pallas/yuv2bgr.py::_kernel, the TPU kernel behind
// nv_to_bgr_pallas.  The TPU kernel spreads each chroma pair over its two
// lanes with a lane roll and a parity select, and repeats chroma rows with
// a 0/1 matmul on the MXU, because the TPU has no cheap gather.  Here a
// thread simply reads the bytes it needs.
//
// Bound: bytes.  1.5 bytes in and 3 bytes out per pixel, a few integer
// operations each: 9.3 MB at 1080p, about 3 us at 3.35 TB/s.
//
// Design: one thread per chroma pair and Y row.  It reads its two Y bytes
// and its (V, U) or (U, V) pair, and writes two pixels to each of the
// three planes as 2-byte stores; neighbouring threads touch neighbouring
// bytes.  Y row r reads chroma row r / 2, so an odd h pairs its last row
// with the last chroma row (the reference's zerobuf trick,
// cvt_color.cpp:52-66).  Y and VU are two row-strided views of the
// stacked buffer; nothing is copied.  The decode is bit-exact Q7 integer
// math (nv_decode.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "nv_decode.cuh"

namespace {

constexpr int kThreads = 128;

template <bool IS_NV12>
__global__ void __launch_bounds__(kThreads) yuv2bgr_kernel(
    const uint8_t* __restrict__ y, int64_t y_stride,
    const uint8_t* __restrict__ vu, int64_t vu_stride,
    uint8_t* __restrict__ out, int h, int w) {
  const int x = 2 * (blockIdx.x * kThreads + threadIdx.x);
  const int row = blockIdx.y;
  if (x >= w) return;
  const uint8_t* yp = y + row * y_stride + x;
  const uint8_t* cp = vu + (row >> 1) * vu_stride + x;
  const int first = __ldg(cp), second = __ldg(cp + 1);
  int b0, g0, r0, b1, g1, r1;
  vacv::decode_q7<IS_NV12>(__ldg(yp), first, second, b0, g0, r0);
  vacv::decode_q7<IS_NV12>(__ldg(yp + 1), first, second, b1, g1, r1);
  const int64_t plane = static_cast<int64_t>(h) * w;
  // x and w are even and `out` is a fresh allocation: the stores are
  // 2-byte aligned.
  uchar2* o = reinterpret_cast<uchar2*>(out + static_cast<int64_t>(row) * w + x);
  o[0] = make_uchar2(b0, b1);
  o[plane / 2] = make_uchar2(g0, g1);
  o[plane] = make_uchar2(r0, r1);
}

}  // namespace

extern "C" {

// Decode Y (h rows of w bytes, rows y_stride apart) and VU (ceil(h/2)
// rows, vu_stride apart) into `out`, three contiguous (h, w) u8 planes
// B, G, R.  w is even; h <= 65535.  Returns a cudaError_t (0 on success).
int vacv_yuv2bgr(int device, void* stream, const void* y, long long y_stride,
                 const void* vu, long long vu_stride, void* out, int h, int w,
                 int is_nv12) {
  cudaGetLastError();  // clear a stale error of an earlier call
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w / 2 + kThreads - 1) / kThreads, h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* y8 = static_cast<const uint8_t*>(y);
  const uint8_t* vu8 = static_cast<const uint8_t*>(vu);
  uint8_t* o8 = static_cast<uint8_t*>(out);
  if (is_nv12) {
    yuv2bgr_kernel<true><<<grid, kThreads, 0, s>>>(y8, y_stride, vu8,
                                                    vu_stride, o8, h, w);
  } else {
    yuv2bgr_kernel<false><<<grid, kThreads, 0, s>>>(y8, y_stride, vu8,
                                                     vu_stride, o8, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
