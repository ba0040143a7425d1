// Valid 2-D cross-correlation summed over channels, for Hopper (sm_90a),
// with a plain C interface loaded by ctypes
// (vacv_tpu_torch/ops/cuda/match_template.py).
//
// Replaces: vacv_tpu/ops/pallas/match_template.py::_kernel, the TPU kernel
// behind corr_pallas.  That kernel turns the correlation into MXU matmuls:
// a stack of row-shifted copies of the template, a 3-term bf16 split of the
// template (and a hi/lo split of an f32 image) to stay f32-faithful, and
// lane rolls to add the column shifts.
//
// What it computes: out[y, x] = sum_c sum_i sum_j img[c, y+i, x+j] k[c, i, j]
// for an image (C, H, W) of any strides and a contiguous template (C, th,
// tw), for any C, th and tw; out is (H-th+1, W-tw+1), contiguous.
//
// Bound: arithmetic.  C th tw multiply-adds per output (6912 for a 3 x 48 x
// 48 template) against 4 bytes written: 11.47 GFLOP at 720p, 171 us at the
// card's 67 f32 TFLOP/s.  It stays on the f32 units: with one template the
// product has no N dimension for the tensor cores, a Toeplitz-expanded
// template wastes (128 + tw - 1) / tw of their flops (3.6x at tw = 48), and
// TF32 needs a 2-3 term split to stay f32-faithful, which leaves it no
// faster than the f32 units.
//
// Design: a register sliding window.  A block of 16 x 16 threads computes a
// 32 x 128 tile of outputs; each thread kRY = 2 rows of kRX = 8
// consecutive columns.  For every staged image row and kJ = 8 template
// columns, a thread loads the kRX + kJ - 1 image values its 16 outputs need
// once (four float4 shared loads) and applies them to the kRY template rows
// that map that image row onto one of its rows.  The template values are
// warp-uniform: the kRY rows in use sit in registers, and each image row
// brings in one new row (two float4 broadcast loads) in place of the one it
// retires.  That is 128 FFMA per 6 shared-load instructions, 21 FFMA per
// load (the kernel it replaces did about 1.3).  No branch in the inner
// loop: the template chunk is padded in shared memory with zero rows above
// and below (and zero columns to whole kJ), so every (image row, output
// row) pair runs the same code; adding 0 * x is exact for a finite image.
// The padding costs kRY - 1 image rows per chunk, rounded up to whole kRY:
// 50 for a 48-row template (96% of the FFMA useful).
// Staging: the image and the template are staged per chunk of (channel,
// kTI = 48 template rows, kTJ = 24 template columns): the tile's rows plus
// the chunk's halo rows by its columns plus kTJ, and the chunk's template
// rows and columns, by cp.async (4 bytes each, so any image stride), double
// buffered so the next chunk arrives while this one is summed; any template
// size takes the same path.  Each chunk sums into a fresh f32 partial that
// is then added to the accumulator, so no running sum grows past one
// chunk's kTI x kTJ terms.  A stage is 53.5 KB, two blocks an SM.
// Filling the card: at 720p with a 48 x 48 template the 673 x 1233 outputs
// are 22 x 10 = 220 tiles, under two blocks for each of the 132 SMs; the
// wrapper then splits the channels over grid z (3 x 220 = 660 blocks, five
// per SM); split z writes slice z of the output buffer and a second launch
// (split_sum.cuh) adds the slices into slice 0 in channel order.
// Two rows a thread measured faster than four (fewer warps an SM) and one
// (twice the window loads an FFMA).  chip_smoke.py times it: 313-319 us at
// 720p x 48^2 on an NVIDIA H100 80GB HBM3 at 700 W, 54-55% of f32 peak.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_sum.cuh"

namespace {

constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRX = 8;
constexpr int kRY = 2;
constexpr int kJ = 8;                    // template columns per inner step
constexpr int kTileW = kThreadsX * kRX;  // 128 output columns
constexpr int kTileH = kThreadsY * kRY;  // 32 output rows
constexpr int kTI = 48;                  // template rows per staged chunk
constexpr int kTJ = 24;                  // template columns per staged chunk
// A chunk's image rows run in groups of kRY: up to kRY - 1 more than the
// ni + kRY - 1 that meet a template row, with zero template rows there.
constexpr int kRowsS = kTileH + kTI + kRY - 2;    // staged image rows
constexpr int kColsS = kTileW + kTJ;              // staged image row stride
constexpr int kTplRows = kTI + 3 * (kRY - 1);     // zero-padded template rows
constexpr int kStageFloats = kRowsS * kColsS + kTplRows * kTJ;
constexpr int kSmem = 2 * kStageFloats * 4;
static_assert(kTJ % kJ == 0 && kColsS % 4 == 0 && (kRowsS * kColsS) % 4 == 0, "float4 rows");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, or 4 zero bytes when !valid (src-size 0).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void load8(float (&t)[kJ], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  t[0] = a.x, t[1] = a.y, t[2] = a.z, t[3] = a.w, t[4] = b.x, t[5] = b.y, t[6] = b.z, t[7] = b.w;
}

// Stage chunk (ci, i0, j0): image rows [oy0 + i0, + kTileH + ni + kRY - 2)
// by columns [ox0 + j0, + kTileW + njp), zero outside the image; template
// rows i0 .. i0 + ni - 1 at padded rows kRY - 1 .., columns j0 .. j0 + nj - 1,
// zero elsewhere.
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ img, int64_t sc,
                                      int64_t sy, int64_t sx, int h, int w,
                                      const float* __restrict__ k, int th, int tw, int ci, int i0,
                                      int j0, int oy0, int ox0, int tid) {
  const int ni = min(kTI, th - i0), nj = min(kTJ, tw - j0);
  const int njp = (nj + kJ - 1) / kJ * kJ;
  const int rows = kTileH + ni + kRY - 2, cols = kTileW + njp;
  const float* plane = img + ci * sc;
  for (int e = tid; e < rows * cols; e += kThreads) {
    const int r = e / cols, s = e - r * cols;
    const int y = oy0 + i0 + r, x = ox0 + j0 + s;
    const bool in = y < h && x < w;
    cp_async4(buf + r * kColsS + s, in ? plane + y * sy + x * sx : img, in);
  }
  float* tpl = buf + kRowsS * kColsS;
  const float* kc = k + (static_cast<int64_t>(ci) * th + i0) * tw + j0;
  const int trows = ni + 3 * (kRY - 1);
  for (int e = tid; e < trows * njp; e += kThreads) {
    const int r = e / njp, j = e - r * njp;
    const int i = r - (kRY - 1);
    const bool in = i >= 0 && i < ni && j < nj;
    cp_async4(tpl + r * kTJ + j, in ? kc + i * tw + j : k, in);
  }
}

__global__ void __launch_bounds__(kThreads, 2) corr_kernel(
    const float* __restrict__ img, int64_t sc, int64_t sy, int64_t sx, int c, int h, int w,
    const float* __restrict__ k, int th, int tw, float* __restrict__ out, int h_out, int w_out,
    int ch_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int oy0 = blockIdx.y * kTileH, ox0 = blockIdx.x * kTileW;
  const int c0 = blockIdx.z * ch_per_split;
  const int nc = max(0, min(c, c0 + ch_per_split) - c0);
  const int n_i = (th + kTI - 1) / kTI, n_j = (tw + kTJ - 1) / kTJ;
  const int chunks = nc * n_i * n_j;

  float acc[kRY][kRX] = {};
  if (chunks > 0) {
    stage(smem, img, sc, sy, sx, h, w, k, th, tw, c0, 0, 0, oy0, ox0, tid);
  }
  cp_async_commit();
  for (int u = 0; u < chunks; ++u) {
    if (u + 1 < chunks) {
      const int v = u + 1, cv = v / (n_i * n_j), rv = v - cv * (n_i * n_j);
      stage(smem + (v & 1) * kStageFloats, img, sc, sy, sx, h, w, k, th, tw, c0 + cv,
            rv / n_j * kTI, rv % n_j * kTJ, oy0, ox0, tid);
    }
    cp_async_commit();
    cp_async_wait1();  // this thread's copies of chunk u have landed
    __syncthreads();   // and every thread's
    const int ru = u % (n_i * n_j);
    const int ni = min(kTI, th - ru / n_j * kTI), nj = min(kTJ, tw - ru % n_j * kTJ);
    const int njp = (nj + kJ - 1) / kJ * kJ;
    const float* buf = smem + (u & 1) * kStageFloats;
    const float* tpl = buf + kRowsS * kColsS;
    const int n_rho = (ni + 2 * kRY - 2) / kRY * kRY;  // image rows, in groups of kRY
    float part[kRY][kRX] = {};
    for (int jj = 0; jj < njp; jj += kJ) {
      // Image row rho of this thread's band meets template row rho - q for
      // its output row q, which is padded row rho - q + kRY - 1 (a zero row
      // where that is outside the chunk).  Padded row r sits in slot r % kRY
      // of t: each image row loads one new template row and reuses kRY - 1.
      const float* srow = buf + ty * kRY * kColsS + tx * kRX + jj;
      const float* trow = tpl + jj;
      float t[kRY][kJ];
#pragma unroll
      for (int r = 0; r < kRY - 1; ++r) load8(t[r], trow + r * kTJ);
      for (int rho0 = 0; rho0 < n_rho; rho0 += kRY) {
#pragma unroll
        for (int s = 0; s < kRY; ++s) {
          load8(t[(s + kRY - 1) % kRY], trow + (rho0 + s + kRY - 1) * kTJ);
          float v[kRX + kJ];
#pragma unroll
          for (int m4 = 0; m4 < (kRX + kJ) / 4; ++m4) {
            const float4 f = *reinterpret_cast<const float4*>(srow + (rho0 + s) * kColsS + 4 * m4);
            v[4 * m4] = f.x, v[4 * m4 + 1] = f.y, v[4 * m4 + 2] = f.z, v[4 * m4 + 3] = f.w;
          }
#pragma unroll
          for (int q = 0; q < kRY; ++q) {
            const float* tq = t[(s - q + kRY - 1 + kRY) % kRY];
#pragma unroll
            for (int j = 0; j < kJ; ++j)
#pragma unroll
              for (int p = 0; p < kRX; ++p) part[q][p] = fmaf(v[p + j], tq[j], part[q][p]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRY; ++q)
#pragma unroll
      for (int p = 0; p < kRX; ++p) acc[q][p] += part[q][p];
    __syncthreads();  // chunk u's buffer is refilled by the next iteration
  }
  float* dst = out + static_cast<int64_t>(blockIdx.z) * h_out * w_out;
#pragma unroll
  for (int q = 0; q < kRY; ++q) {
    const int y = oy0 + ty * kRY + q;
    if (y >= h_out) continue;
#pragma unroll
    for (int p = 0; p < kRX; ++p) {
      const int x = ox0 + tx * kRX + p;
      if (x < w_out) dst[static_cast<int64_t>(y) * w_out + x] = acc[q][p];
    }
  }
}

}  // namespace

extern "C" {

// Correlate the (c, h, w) f32 image at `img` (element strides sc, sy, sx)
// with the contiguous (c, th, tw) f32 template `k` into the contiguous
// (h - th + 1, w - tw + 1) f32 response.  The channels are split over
// `splits` blocks of each tile: `out` holds (splits, h - th + 1, w - tw + 1)
// floats and the response is its first slice.  Returns a cudaError_t (0 on
// success).
int vacv_match_corr(int device, void* stream, const void* img, int c, int h, int w,
                    long long sc, long long sy, long long sx, const void* k, int th, int tw,
                    void* out, int splits) {
  cudaGetLastError();  // clear a stale error of an earlier call
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int h_out = h - th + 1, w_out = w - tw + 1;
  const dim3 grid((w_out + kTileW - 1) / kTileW, (h_out + kTileH - 1) / kTileH, splits);
  const dim3 block(kThreadsX, kThreadsY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  corr_kernel<<<grid, block, kSmem, s>>>(static_cast<const float*>(img), sc, sy, sx, c, h, w,
                                         static_cast<const float*>(k), th, tw, o, h_out, w_out,
                                         (c + splits - 1) / splits);
  e = cudaGetLastError();
  if (e == cudaSuccess && splits > 1) {
    e = vacv::split_sum<float>(o, o, static_cast<int64_t>(h_out) * w_out, splits, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
