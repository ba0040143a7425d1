// Valid 2-D cross-correlation summed over channels, for Hopper (sm_90a),
// with a plain C interface loaded by ctypes
// (vacv_tpu_torch/ops/cuda/match_template.py).
//
// Replaces: vacv_tpu/ops/pallas/match_template.py::_kernel, the TPU kernel
// behind corr_pallas.  That kernel turns the correlation into MXU matmuls:
// a stack of row-shifted copies of the template, a 3-term bf16 split of the
// template (and a hi/lo split of an f32 image) to stay f32-faithful, and
// lane rolls to add the column shifts.  None of that is needed here: the
// card has f32 FMA units, so each thread accumulates in f32 directly.
//
// What it computes: out[y, x] = sum_c sum_i sum_j img[c, y+i, x+j] k[c, i, j]
// for an image (C, H, W) of any strides and a contiguous template (C, th,
// tw), for any C, th and tw; out is (H-th+1, W-tw+1), contiguous.
//
// Bound: arithmetic.  C th tw multiply-adds per output (6912 for a 3 x 48 x
// 48 template) against 4 bytes written, so the work is the FMAs and the
// shared-memory loads that feed them.
//
// Design: a block of 32 x 8 threads computes a tile of kTileH x kTileW =
// 32 x 128 outputs; each thread kRY = 4 consecutive rows of kRX = 4 columns
// 32 apart (so a warp's shared-memory loads hit 32 banks).  The template
// sits whole in shared memory when C th tw floats fit (kTemplateSmem),
// else it is read through __ldg.  The image is staged per channel in
// chunks of template rows (kTI) and columns (kTJ): the tile's rows plus
// kTI - 1 halo rows by its columns plus kTJ - 1 halo columns, so the
// staged block stays the same size for any template.  For each staged
// image row r and template column j a thread loads 4 image values once and
// applies each to the up to 4 of its outputs whose template row r - q
// lies in the chunk: 16 FMAs per 8 shared loads.  Each chunk sums into a
// fresh f32 partial that is then added to the output's f32 accumulator,
// so no running sum grows over more than kTI x kTJ terms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRX = 4;
constexpr int kRY = 4;
constexpr int kTileW = kThreadsX * kRX;  // 128 output columns
constexpr int kTileH = kThreadsY * kRY;  // 32 output rows
constexpr int kTI = 16;                  // template rows per staged chunk
constexpr int kTJ = 32;                  // template columns per staged chunk
constexpr int kRowsS = kTileH + kTI - 1;
constexpr int kColsS = kTileW + kTJ - 1;
constexpr int kImageSmem = kRowsS * kColsS * 4;
constexpr int kTemplateSmem = 160 * 1024;  // largest template kept in shared memory

template <bool TMPL_SMEM>
__global__ void __launch_bounds__(kThreads) corr_kernel(
    const float* __restrict__ img, int64_t sc, int64_t sy, int64_t sx, int c, int h,
    int w, const float* __restrict__ k, int th, int tw, float* __restrict__ out,
    int h_out, int w_out) {
  extern __shared__ float smem[];
  float* s_img = smem;
  float* s_k = smem + kRowsS * kColsS;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int oy0 = blockIdx.y * kTileH, ox0 = blockIdx.x * kTileW;
  if (TMPL_SMEM) {
    for (int e = tid; e < c * th * tw; e += kThreads) s_k[e] = __ldg(k + e);
  }
  float acc[kRY][kRX] = {};
  for (int ci = 0; ci < c; ++ci) {
    const float* plane = img + ci * sc;
    for (int i0 = 0; i0 < th; i0 += kTI) {
      const int ni = min(kTI, th - i0);
      for (int j0 = 0; j0 < tw; j0 += kTJ) {
        const int nj = min(kTJ, tw - j0);
        const int rows = kTileH + ni - 1, cols = kTileW + nj - 1;
        __syncthreads();  // the previous chunk's reads are done
        for (int e = tid; e < rows * cols; e += kThreads) {
          const int r = e / cols, s = e - r * cols;
          const int y = oy0 + i0 + r, x = ox0 + j0 + s;
          s_img[r * kColsS + s] = (y < h && x < w) ? __ldg(plane + y * sy + x * sx) : 0.f;
        }
        __syncthreads();
        const float* kc = (TMPL_SMEM ? s_k : k) + (static_cast<int64_t>(ci) * th + i0) * tw + j0;
        float part[kRY][kRX] = {};
        for (int r = 0; r < kRY + ni - 1; ++r) {
          const float* srow = s_img + (ty * kRY + r) * kColsS + tx;
          for (int j = 0; j < nj; ++j) {
            float v[kRX];
#pragma unroll
            for (int q = 0; q < kRX; ++q) v[q] = srow[q * kThreadsX + j];
#pragma unroll
            for (int q = 0; q < kRY; ++q) {
              const int i = r - q;  // template row of output row q
              if (i < 0 || i >= ni) continue;
              const float kv = TMPL_SMEM ? kc[i * tw + j] : __ldg(kc + i * tw + j);
#pragma unroll
              for (int p = 0; p < kRX; ++p) part[q][p] = fmaf(v[p], kv, part[q][p]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kRY; ++q)
#pragma unroll
          for (int p = 0; p < kRX; ++p) acc[q][p] += part[q][p];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRY; ++q) {
    const int y = oy0 + ty * kRY + q;
    if (y >= h_out) continue;
#pragma unroll
    for (int p = 0; p < kRX; ++p) {
      const int x = ox0 + tx + p * kThreadsX;
      if (x < w_out) out[static_cast<int64_t>(y) * w_out + x] = acc[q][p];
    }
  }
}

}  // namespace

extern "C" {

// Correlate the (c, h, w) f32 image at `img` (element strides sc, sy, sx)
// with the contiguous (c, th, tw) f32 template `k` into the contiguous
// (h - th + 1, w - tw + 1) f32 `out`.  Returns a cudaError_t (0 on success).
int vacv_match_corr(int device, void* stream, const void* img, int c, int h, int w,
                    long long sc, long long sy, long long sx, const void* k, int th, int tw,
                    void* out) {
  cudaGetLastError();  // clear a stale error of an earlier call
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int h_out = h - th + 1, w_out = w - tw + 1;
  const dim3 grid((w_out + kTileW - 1) / kTileW, (h_out + kTileH - 1) / kTileH);
  const dim3 block(kThreadsX, kThreadsY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* im = static_cast<const float*>(img);
  const float* kt = static_cast<const float*>(k);
  float* o = static_cast<float*>(out);
  const int64_t tmpl_bytes = static_cast<int64_t>(c) * th * tw * 4;
  if (tmpl_bytes <= kTemplateSmem) {
    const int smem = kImageSmem + static_cast<int>(tmpl_bytes);
    e = cudaFuncSetAttribute(corr_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    corr_kernel<true><<<grid, block, smem, s>>>(im, sc, sy, sx, c, h, w, kt, th, tw, o, h_out,
                                                w_out);
  } else {
    corr_kernel<false><<<grid, block, kImageSmem, s>>>(im, sc, sy, sx, c, h, w, kt, th, tw, o,
                                                       h_out, w_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
