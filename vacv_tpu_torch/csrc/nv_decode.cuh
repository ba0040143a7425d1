// Q7 NV12/NV21 -> BGR decode of one pixel, shared by yuv2bgr.cu and the
// NV source of preprocess.cu.  The integer math is nv_to_bgr_naive's
// (reference cvt_color.cpp:76-94); the port's plain version is
// vacv_tpu_torch/ops/cvt_color.py::yuv_to_bgr_q7.
#pragma once

#include <stdint.h>

namespace vacv {

// The three adders a chroma pair gives the 2 x 2 Y pixels that share it.
struct ChromaQ7 {
  int b, g, r;
};

// `first` and `second` are the two bytes of the pixel's chroma pair, in
// memory order: (V, U) for NV21, (U, V) for NV12.  `>>` on a negative int
// is an arithmetic shift under nvcc, so the adders floor, as C's signed
// shift does in the reference.
template <bool IS_NV12>
__device__ __forceinline__ ChromaQ7 chroma_q7(int first, int second) {
  const int u = (IS_NV12 ? first : second) - 128;
  const int v = (IS_NV12 ? second : first) - 128;
  return {(227 * u) >> 7, (44 * u + 91 * v) >> 7, (179 * v) >> 7};
}

// One Y value under its pair's adders, clamped to [0, 255].
__device__ __forceinline__ void apply_q7(int y, const ChromaQ7& c, int& b, int& g, int& r) {
  b = min(max(y + c.b, 0), 255);
  g = min(max(y - c.g, 0), 255);
  r = min(max(y + c.r, 0), 255);
}

template <bool IS_NV12>
__device__ __forceinline__ void decode_q7(int y, int first, int second,
                                          int& b, int& g, int& r) {
  apply_q7(y, chroma_q7<IS_NV12>(first, second), b, g, r);
}

}  // namespace vacv
