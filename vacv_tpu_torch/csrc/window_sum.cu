// Window sums for template matching, for Hopper (sm_90a), with a plain C
// interface loaded by ctypes (vacv_tpu_torch/ops/cuda/window_sum.py).
//
// No TPU kernel stands behind this one.  vacv_tpu/ops/match_template.py:37
// (_box_sum) takes the windowed sums that the SQDIFF, NORMED and CCOEFF
// modes need as two dense ones-band matrix products, XLA matmuls over 0/1
// selection matrices, because the TPU has no fast gather.  Here, for f32
// planes x (C, H, W) of any strides, one launch writes what the caller asks
// for of
//   sq   (H', W')     the window sum of sum_c x^2, and
//   sums (C, H', W')  the per-channel window sums,
// H' = H - th + 1, W' = W - tw + 1, reading x once.
//
// Each output is a direct sum of its own window's terms: a th-tap vertical
// pass (column sums), then a tw-tap horizontal pass over those, for each
// channel in turn; sq adds its channels' sums in channel order.  No running
// sum: a running sum's f32 error grows along the row.  The R windows of R
// consecutive outputs share terms, so window_runs() sums them as
// (head_r + middle) + tail_r: the middle (the terms all R hold) once, the
// heads and tails as short suffix and prefix sums of the terms only some
// hold; a window is still its own terms added up, within (th + tw + C)
// 2^-24 of the sum of their magnitudes, and about taps + 3 R adds serve R
// windows instead of R taps.  Sums of integers stay exact while they stay
// below 2^24 (u8 images: every per-channel sum of a window under 65 793
// pixels).
//
// Bound: bytes (x read once, the sums written once; at 720p x 48^2 x 3
// channels 11.1 MB in and 13.3 MB out against 3.35 TB/s).  A block owns a
// 32 x 64 tile of outputs.  For each channel, each of its threads walks
// one column the tile needs (64 + tw - 1 of them, at most 127 at a time)
// down its 32 + th - 1 rows, for x or for x^2 (the x^2 walk of a column
// finds its terms in L1), so a block reads each of its terms once from
// memory (a warp: 32 neighbouring columns of a row, coalesced for x
// contiguous along W; every load of a walk independent of the adds, so
// many are in flight); the 32 column sums go to shared memory, and each
// thread then sums 8 consecutive windows of one row of them.  A window
// wider than 64 columns is taken 64 columns at a time, the row sums
// carried in registers.  In the horizontal pass a warp reads 32 rows at
// one column offset (the odd pitch keeps shared memory free of bank
// conflicts); the tile's sums leave through shared memory as whole rows.
// Measured on an H100 (chip_smoke.py, PERF.md): about 45 us at 720p x
// 48^2, both sums, against the bound's 7.3 us, most of it the walks' waits
// on memory; an earlier form, a thread summing 8 rows of a column, read
// each term four times and took 89 us.  Staging the input tile in shared
// memory first measured no faster.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileY = 32;   // output rows a block: the windows of a column walk
constexpr int kTileX = 64;   // output columns a block
constexpr int kRunH = 8;     // row windows a thread sums at once
constexpr int kChunk = 64;   // window columns a horizontal pass
constexpr int kThreads = kTileY * (kTileX / kRunH);
constexpr int kColSlots = 128;  // columns a vertical pass deals out, per quantity
constexpr int kPitch = kColSlots + 1;  // the column sums' row pitch in shared memory: odd
static_assert(kThreads == 2 * kColSlots && kTileX + kChunk - 1 <= kColSlots, "thread layout");
static_assert(kTileY == 32, "a warp of the horizontal pass takes 32 rows");

// The R windows of `taps` terms at 0 .. R - 1 (window r holds terms r ..
// r + taps - 1) into sum[]; load(i) gives term i, and is called once for
// each where taps >= R - 1.  There, window r is (head_r + middle) +
// tail_r: head_r the terms r .. R - 2 summed from R - 2 down, middle the
// terms R - 1 .. taps - 1 (two partial sums, even and odd terms, then their
// sum), tail_r the terms taps .. taps + r - 1 summed up.  Shorter windows
// are summed one by one.
template <int R, class Load>
__device__ __forceinline__ void window_runs(float (&sum)[R], int taps, const Load& load) {
  if (taps >= R - 1) {
#pragma unroll
    for (int r = 0; r < R - 1; ++r) sum[r] = load(r);
    sum[R - 1] = 0.f;
#pragma unroll
    for (int r = R - 3; r >= 0; --r) sum[r] += sum[r + 1];  // the heads
    float m0 = 0.f, m1 = 0.f;  // the middle, as two interleaved partial sums
    int i = R - 1;
#pragma unroll 4
    for (; i + 2 <= taps; i += 2) {
      m0 += load(i);
      m1 += load(i + 1);
    }
    if (i < taps) m0 += load(i);
    const float middle = m0 + m1;
#pragma unroll
    for (int r = 0; r < R; ++r) sum[r] += middle;
    float tail = 0.f;
#pragma unroll
    for (int r = 1; r < R; ++r) {
      tail += load(taps + r - 1);
      sum[r] += tail;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f;
      for (int i = 0; i < taps; ++i) s += load(r + i);
      sum[r] = s;
    }
  }
}

// Term i of a column walk: x (or x^2, rounded before it is added, as the
// plain version rounds it, whichever sums a launch writes) at row y0 + i of
// one column (at: the column's offset in its plane); rows past the image
// feed no output.
struct ColumnLoad {
  const float* __restrict__ plane;
  int64_t at, sy;
  int y0, h;
  bool square;
  __device__ __forceinline__ float operator()(int i) const {
    const int gy = y0 + i;
    const float v = gy < h ? __ldg(plane + at + gy * sy) : 0.f;
    return square ? __fmul_rn(v, v) : v;
  }
};

// Term k of a row walk: column sum k of one tile row.
struct RowLoad {
  const float* row;
  __device__ __forceinline__ float operator()(int k) const { return row[k]; }
};

// Thread t's kRunH sums of tile row t % 32, columns kRunH (t / 32) ..,
// to out[oy wo + ox] through `stage` (kTileY x kPitch floats of shared
// memory, free on entry): each warp then stores whole rows.
__device__ __forceinline__ void store_tile(const float (&sum)[kRunH], float* stage,
                                           float* __restrict__ out, int y0, int x0, int ho,
                                           int wo) {
  const int hr = threadIdx.x % kTileY, hx = kRunH * (threadIdx.x / kTileY);
#pragma unroll
  for (int o = 0; o < kRunH; ++o) stage[hr * kPitch + hx + o] = sum[o];
  __syncthreads();
  const int col = threadIdx.x % kTileX, ox = x0 + col;
  for (int r = threadIdx.x / kTileX; r < kTileY; r += kThreads / kTileX) {
    const int oy = y0 + r;
    if (oy < ho && ox < wo) out[static_cast<int64_t>(oy) * wo + ox] = stage[r * kPitch + col];
  }
  __syncthreads();  // the stage is free again
}

// grid (ceil(W' / 64), ceil(H' / 32)), 256 threads, four blocks an SM (64
// registers a thread: 440 blocks at 720p x 48^2 then run in one wave).  SQ:
// write sq; SUMS: write sums.
template <bool SQ, bool SUMS>
__global__ void __launch_bounds__(kThreads, 4) window_sum_kernel(
    const float* __restrict__ x, int c, int h, int w, int64_t sc, int64_t sy, int64_t sx,
    int th, int tw, float* __restrict__ sq, float* __restrict__ sums) {
  __shared__ float col_sum[SUMS ? kTileY * kPitch : 1];  // a pass's column sums of x
  __shared__ float col_sq[kTileY * kPitch];              // of x^2; the output stage
  const int ho = h - th + 1, wo = w - tw + 1;
  const int y0 = blockIdx.y * kTileY, x0 = blockIdx.x * kTileX;
  // The vertical pass: thread t walks column t % 128 for x (t < 128, where
  // the sums are asked for) or x^2 (t >= 128, where sq is).
  const int j = threadIdx.x % kColSlots;
  const bool square = threadIdx.x >= kColSlots;
  const bool walks = square ? SQ : SUMS;
  float* const col_out = square ? col_sq : col_sum;
  // The horizontal pass: this thread's windows are tile row hr, columns
  // hx .. hx + 7; a warp takes 32 rows at one column offset.
  const int hr = threadIdx.x % kTileY, hx = kRunH * (threadIdx.x / kTileY);
  float total_sq[kRunH] = {};
  for (int ch = 0; ch < c; ++ch) {
    const float* plane = x + ch * sc;
    float total[kRunH] = {};
    for (int s = 0; s < tw; s += kChunk) {
      const int kc = min(kChunk, tw - s);  // window columns in this pass
      const int gx = x0 + s + j;
      if (walks && j < kTileX + kc - 1) {
        float col[kTileY] = {};
        if (gx < w)  // columns past the image feed no output
          window_runs<kTileY>(col, th, ColumnLoad{plane, gx * sx, sy, y0, h, square});
#pragma unroll
        for (int r = 0; r < kTileY; ++r) col_out[r * kPitch + j] = col[r];
      }
      __syncthreads();
      float part[kRunH];
      if (SUMS) {
        window_runs<kRunH>(part, kc, RowLoad{col_sum + hr * kPitch + hx});
#pragma unroll
        for (int o = 0; o < kRunH; ++o) total[o] += part[o];
      }
      if (SQ) {
        window_runs<kRunH>(part, kc, RowLoad{col_sq + hr * kPitch + hx});
#pragma unroll
        for (int o = 0; o < kRunH; ++o) total_sq[o] += part[o];
      }
      __syncthreads();  // the column sums are free for the next pass
    }
    if (SUMS) store_tile(total, col_sq, sums + static_cast<int64_t>(ch) * ho * wo, y0, x0, ho, wo);
  }
  if (SQ) store_tile(total_sq, col_sq, sq, y0, x0, ho, wo);
}

}  // namespace

extern "C" {

// The window sums of f32 planes x (c, h, w), element strides sc, sy, sx
// (any, non-negative), over th x tw windows: `sq` (h - th + 1, w - tw + 1)
// f32 gets the sums of sum_c x^2 and `sums` (c, h - th + 1, w - tw + 1) f32
// the per-channel sums, each contiguous; either may be null, not both.  One
// launch.  Returns a cudaError_t (0 on success).
int vacv_window_sum(int device, void* stream, const void* x, int c, int h, int w, long long sc,
                    long long sy, long long sx, int th, int tw, void* sq, void* sums) {
  cudaGetLastError();  // clear a stale error of an earlier call
  if (c < 1 || th < 1 || tw < 1 || th > h || tw > w || (sq == nullptr && sums == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ho = h - th + 1, wo = w - tw + 1;
  const dim3 grid((wo + kTileX - 1) / kTileX, (ho + kTileY - 1) / kTileY);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* q = static_cast<float*>(sq);
  float* m = static_cast<float*>(sums);
  if (q != nullptr && m != nullptr) {
    window_sum_kernel<true, true><<<grid, kThreads, 0, s>>>(xf, c, h, w, sc, sy, sx, th, tw, q, m);
  } else if (q != nullptr) {
    window_sum_kernel<true, false><<<grid, kThreads, 0, s>>>(xf, c, h, w, sc, sy, sx, th, tw, q, m);
  } else {
    window_sum_kernel<false, true><<<grid, kThreads, 0, s>>>(xf, c, h, w, sc, sy, sx, th, tw, q, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
