// Window sums for template matching, for Hopper (sm_90a), with a plain C
// interface loaded by ctypes (vacv_tpu_torch/ops/cuda/window_sum.py).
//
// No TPU kernel stands behind this one.  vacv_tpu/ops/match_template.py:37
// (_box_sum) takes the windowed sums that the SQDIFF, NORMED and CCOEFF
// modes need as two dense ones-band matrix products, XLA matmuls over 0/1
// selection matrices, because the TPU has no fast gather.  Here, for f32
// planes x (C, H, W) of any strides, one launch writes what the caller asks
// for of
//   sq   (H', W')     the window sum of q = sum_c x^2, and
//   sums (C, H', W')  the per-channel window sums,
// H' = H - th + 1, W' = W - tw + 1.
//
// Bound: bytes (x read once, the sums written once; at 720p x 48^2 x 3
// channels 11.1 MB in and 13.3 MB out, 7.3 us against 3.35 TB/s).  Both
// fit in the 50 MB L2, so what limits a kernel here is the stream of L1 and
// L2 requests, their latency and the instructions around them.  The first
// form of this kernel (~45 us alone on an H100) walked each channel of an HWC
// image on its own (a 12-byte-strided walk fetches all three channels'
// sectors each time), walked x^2 a second time, and re-read a
// (32 + 47) x (64 + 47) halo for each 32 x 64 tile.  This form:
//
// * One walk per pixel.  A block owns a strip of 64 output columns and
//   `rows` output rows; thread j walks input column j of the strip
//   (64 + tw - 1 columns) down the strip's rows, loading the pixel's C
//   values together (a warp: 32 neighbouring pixels x C contiguous floats
//   for an HWC image, the channels at immediate offsets of one address),
//   and forms x and q = sum_c x^2 from those registers.  Each term is
//   loaded once by a block; a batch's loads are issued two batches before
//   it is used, so they are in flight through the barriers in between.
// * Less halo.  The column sums slide: each row adds the entering pixel's
//   quantities and subtracts those of the pixel th rows up, which the same
//   thread kept in a ring in shared memory (th rows deep; no barrier, the
//   ring is the thread's own; the 8 leaving entries of a batch are read
//   before any is overwritten).  A strip reads (rows + th - 1) x
//   (64 + tw - 1) terms once; at 720p x 48^2 with 56-row strips, 3.2x its
//   outputs' terms (the first form: 4.3x, each channel and x^2 apart).
// * Rows of 8 at a time: the 8 rows' column sums go to shared memory, one
//   barrier, then each thread slides one quantity along 16 outputs of one
//   row (every term read first, the first window as four partial sums;
//   then add the entering column and subtract the leaving one), the
//   results go to a stage, one barrier, and the stage leaves as whole rows.
// * No running sum along a whole row or column: the vertical sums restart
//   with each strip (`rows` steps), the horizontal ones every 16 outputs.
//   Sums of integers stay exact below 2^24 (u8 images: every column sum of
//   q and every per-channel window sum under that at 48 x 48), and a
//   sliding f32 sum of other values drifts by a few ulps of its magnitude
//   over those steps, far inside the plain version's bar of 1e-5 of the
//   largest sum.
// * Windows taller than the ring allows, wider than a block's threads can
//   walk (kc columns a pass: 65 at 128 threads, 193 at 256), and more than 4
//   channels run as several passes over the strip, each adding its partial
//   sums into the outputs (the same thread each time).  The main path (3
//   channels, 48 x 48) is one pass.
// ops/cuda/window_sum.py::launch_plan chooses rows, threads and the pass
// sizes on the host, from the same formulas as window_smem() below; the
// strips are those of a both-sums launch whatever is asked for, so each sum
// has the same bits either way.
//
// Measured on an H100 (PERF.md §6; chip_smoke.py times the strip heights,
// profile/window_sum_variants.py at commit bc01e07 the variants): 56-row strips
// make 260 blocks at two an SM, one wave; 32-48 rows make a second wave.
// What holds it: instruction issue and latency at 8 warps an SM (two
// blocks of 4: the 85 KB ring and ~200 registers a thread allow no more).
// Dropping the loads, the row pass, the column-sum updates, the barriers or
// the stores one at a time (the sweep's diagnostic variants) each saves a
// small share: no single part dominates.  The sweep also times 8 or 32
// outputs a row walk and 128-column strips of 256 threads against this form.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 64;   // output columns a block
constexpr int kBatch = 8;    // output rows between two barriers
constexpr int kSeg = 16;     // outputs a thread slides along
constexpr int kMaxDevices = 64;
static_assert(kTileX % kSeg == 0, "segments tile the strip");

constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : 8; }

template <int N>
struct alignas(sizeof(float) * N) Vec {
  float v[N];
};

struct Args {
  const float* x;
  int c, h, w;
  int64_t sc, sy, sx;
  int th, tw;
  int rows;   // output rows a block, a multiple of kBatch
  int kr;     // window rows a pass: the ring's depth
  int kc;     // window columns a pass
  int ncol;   // columns of the ring: kTileX + kc - 1
  int pitch;  // columns of the column-sum stage: ncol rounded up to 1 mod 8
  float* sq;
  float* sums;
};

// The quantities a pixel feeds: q (SQ) first, then its channels (SUMS).
template <int CN, bool SQ, bool SUMS>
struct Q {
  static constexpr int n = (SQ ? 1 : 0) + (SUMS ? CN : 0);
  static constexpr int e = pow2_at_least(n);  // floats a ring or stage entry
};

int stage_pitch(int ncol) { return (ncol + 6) / 8 * 8 + 1; }

// Dynamic shared memory of a launch: the ring (kr rows of ncol entries), the
// column sums of kBatch rows, the stage of kBatch rows of outputs.
int window_smem(int nq, int kr, int kc) {
  const int e = pow2_at_least(nq), ncol = kTileX + kc - 1;
  return 4 * (kr * ncol * e + kBatch * stage_pitch(ncol) * e + kBatch * nq * (kTileX + 1));
}

// One pass over the block's strip: window rows r0 .. r0 + kr - 1 and
// columns c0 .. c0 + kc - 1 of channel group g, into the outputs (written
// on the first pass of each, added to on the others).
template <int CN, bool SQ, bool SUMS, bool HWC>
__device__ __forceinline__ void pass(const Args& a, float* smem, int x0, int y0, int out_cols,
                                     int out_rows, int g, int r0, int c0) {
  constexpr int NQ = Q<CN, SQ, SUMS>::n, E = Q<CN, SQ, SUMS>::e;
  using V = Vec<E>;
  const int kr = min(a.kr, a.th - r0), kc = min(a.kc, a.tw - c0);
  V* const ring = reinterpret_cast<V*>(smem);
  V* const colsum = ring + a.kr * a.ncol;
  float* const stage = reinterpret_cast<float*>(colsum + kBatch * a.pitch);
  const int ho = a.h - a.th + 1, wo = a.w - a.tw + 1;
  const int cols = out_cols + kc - 1;       // input columns walked
  const int in_rows = out_rows + kr - 1;    // input rows read
  // pad zero rows in front, so that the first output row ends a batch of 8.
  const int pad = (kBatch - (kr - 1) % kBatch) % kBatch;
  const int fill = (pad + kr - 1) / kBatch;  // batches before the first output row
  const int batches = fill + (out_rows + kBatch - 1) / kBatch;
  const int ch0 = g * CN, cn = min(CN, a.c - ch0);
  const bool first_sums = r0 == 0 && c0 == 0, first_sq = first_sums && g == 0;
  const int j = threadIdx.x;
  const bool walks = j < cols;
  const float* const src = a.x + ch0 * a.sc + (y0 + r0 - pad) * a.sy +
                           static_cast<int64_t>(x0 + c0 + (walks ? j : 0)) * a.sx;
  // Channel k of a pixel: k elements on (HWC: the channel stride is 1, an
  // immediate offset of the load), else k channel strides on.
  int64_t koff[CN];
#pragma unroll
  for (int k = 0; k < CN; ++k) koff[k] = HWC ? k : (k < cn ? k * a.sc : 0);
  // Rows b * 8 .. b * 8 + 7 of the padded strip into v (zeros outside it;
  // a thread past the strip's columns reads column 0 and drops it).
  auto load = [&](int b, float (&v)[kBatch][CN]) {
    const int lo = pad - b * kBatch, hi = in_rows + pad - b * kBatch;  // rows r in [lo, hi)
    const float* p = src + b * kBatch * a.sy;
    if (lo <= 0 && hi >= kBatch && cn == CN) {  // the same in every thread
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
#pragma unroll
        for (int k = 0; k < CN; ++k) v[r][k] = __ldg(p + koff[k]);
        p += a.sy;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const bool ok = r >= lo && r < hi;
#pragma unroll
        for (int k = 0; k < CN; ++k) v[r][k] = ok && k < cn ? __ldg(p + koff[k]) : 0.f;
        p += a.sy;
      }
    }
  };
  V* const mine = ring + j;  // this column's ring: mine[slot * ncol]
  V* const mine_end = mine + kr * a.ncol;
  if (walks) {  // a row leaves before it entered only as zeros
    V zero;
#pragma unroll
    for (int q = 0; q < E; ++q) zero.v[q] = 0.f;
    for (V* e = mine; e != mine_end; e += a.ncol) *e = zero;
  }
  float s[NQ];  // this column's sums over the last kr rows
#pragma unroll
  for (int q = 0; q < NQ; ++q) s[q] = 0.f;
  V* slot = mine;
  // The stage's rows a thread stores: column xx of rows r0s, r0s + step, ...
  const int xx = threadIdx.x % kTileX, r0s = threadIdx.x / kTileX, step = blockDim.x / kTileX;
  const int nq = (SQ ? 1 : 0) + (SUMS ? cn : 0);  // the quantities stored (channels past C not)
  float* base[NQ];  // each quantity's output at (y0 + r0s, x0 + xx)
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int64_t at = static_cast<int64_t>(y0 + r0s) * wo + x0 + xx;
    if (SQ && q == 0) {
      base[q] = a.sq + at;
    } else {
      const int ch = min(ch0 + q - (SQ ? 1 : 0), a.c - 1);
      base[q] = a.sums + ch * static_cast<int64_t>(ho) * wo + at;
    }
  }
  const bool first_all = first_sq && first_sums;
  // One batch: its rows into the column sums (the buffer then takes the loads
  // of batch b + 2), and from the first output row on, the outputs.
  auto batch = [&](int b, float (&buf)[kBatch][CN]) {
    const bool emits = b >= fill;  // the same in every thread
    if (walks) {
      // The rows leaving with this batch's 8, read before any is overwritten
      // (a ring of at least 8 rows: the reads do not wait on the stores).
      V leaves[kBatch];
      if (kr >= kBatch) {
        V* at = slot;
#pragma unroll
        for (int r = 0; r < kBatch; ++r) {
          leaves[r] = *at;
          at += a.ncol;
          if (at == mine_end) at = mine;
        }
      }
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        V u;
#pragma unroll
        for (int q = 0; q < E; ++q) u.v[q] = 0.f;
        if constexpr (SQ) {
          float sq = __fmul_rn(buf[r][0], buf[r][0]);
#pragma unroll
          for (int k = 1; k < CN; ++k) sq = __fadd_rn(sq, __fmul_rn(buf[r][k], buf[r][k]));
          u.v[0] = sq;
        }
        if constexpr (SUMS) {
#pragma unroll
          for (int k = 0; k < CN; ++k) u.v[(SQ ? 1 : 0) + k] = buf[r][k];
        }
        const V leave = kr >= kBatch ? leaves[r] : *slot;
        *slot = u;
        slot += a.ncol;
        if (slot == mine_end) slot = mine;
        V out;
#pragma unroll
        for (int q = 0; q < E; ++q) {
          if (q < NQ) s[q] = __fsub_rn(__fadd_rn(s[q], u.v[q]), leave.v[q]);
          out.v[q] = q < NQ ? s[q] : 0.f;
        }
        if (emits) colsum[r * a.pitch + j] = out;
      }
    }
    if (b + 2 < batches) load(b + 2, buf);  // in flight through the next batch
    if (!emits) return;
    __syncthreads();  // the batch's column sums are in
    const int y = (b - fill) * kBatch;  // the batch's first output row in the strip
    const int valid = min(kBatch, out_rows - y);
    // Along the rows: thread t takes quantity q of row r, outputs x .. x + 15.
    for (int t = threadIdx.x; t < kBatch * NQ * (kTileX / kSeg); t += blockDim.x) {
      const int q = t % NQ, r = t / NQ % kBatch, x = t / (NQ * kBatch) * kSeg;
      if (r >= valid || x >= out_cols) continue;
      const float* row = reinterpret_cast<const float*>(colsum + r * a.pitch) + q + x * E;
      // Every term is read before any output is written (the loads need not
      // wait on the stores), the first window as four partial sums.
      float in[kSeg - 1], gone[kSeg - 1];
#pragma unroll
      for (int k = 1; k < kSeg; ++k) {
        in[k - 1] = row[(k + kc - 1) * E];
        gone[k - 1] = row[(k - 1) * E];
      }
      float e[4] = {0.f, 0.f, 0.f, 0.f};
      int i = 0;
#pragma unroll 2
      for (; i + 4 <= kc; i += 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) e[k] += row[(i + k) * E];
      }
      for (; i < kc; ++i) e[0] += row[i * E];
      float sum = (e[0] + e[1]) + (e[2] + e[3]);
      float* o = stage + (r * NQ + q) * (kTileX + 1) + x;
      o[0] = sum;
#pragma unroll
      for (int k = 1; k < kSeg; ++k) {
        sum = (sum + in[k - 1]) - gone[k - 1];
        o[k] = sum;
      }
    }
    __syncthreads();  // the stage is full; the column sums are free again
    if (xx < out_cols) {
      const float* st = stage + r0s * NQ * (kTileX + 1) + xx;
      const int64_t row_step = static_cast<int64_t>(step) * wo;
      int64_t off = static_cast<int64_t>(y) * wo;
      for (int r = r0s; r < valid; r += step) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (q >= nq) break;
          const float v = st[q * (kTileX + 1)];
          float* dst = base[q] + off;
          if (first_all) {
            *dst = v;
          } else {
            const bool first = SQ && q == 0 ? first_sq : first_sums;
            *dst = first ? v : *dst + v;
          }
        }
        st += step * NQ * (kTileX + 1);
        off += row_step;
      }
    }
  };
  float buf0[kBatch][CN], buf1[kBatch][CN];
  load(0, buf0);
  if (batches > 1) load(1, buf1);
  for (int b = 0; b < batches; b += 2) {
    batch(b, buf0);
    if (b + 1 < batches) batch(b + 1, buf1);
  }
}

// grid (ceil(W' / 64), ceil(H' / rows)), `threads` threads (>= 64 + kc - 1).
template <int CN, bool SQ, bool SUMS, bool HWC>
__global__ void __launch_bounds__(256) window_sum_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int ho = a.h - a.th + 1, wo = a.w - a.tw + 1;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * a.rows;
  const int out_cols = min(kTileX, wo - x0), out_rows = min(a.rows, ho - y0);
  const int groups = (a.c + CN - 1) / CN;
  for (int g = 0; g < groups; ++g)
    for (int r0 = 0; r0 < a.th; r0 += a.kr)
      for (int c0 = 0; c0 < a.tw; c0 += a.kc)
        pass<CN, SQ, SUMS, HWC>(a, smem, x0, y0, out_cols, out_rows, g, r0, c0);
}

template <int CN, bool SQ, bool SUMS, bool HWC>
cudaError_t launch(const Args& a, int device, dim3 grid, int threads, cudaStream_t s) {
  static int allowed[kMaxDevices] = {};  // dynamic shared memory opted in, per device
  const int smem = window_smem(Q<CN, SQ, SUMS>::n, a.kr, a.kc);
  if (smem > allowed[device]) {
    cudaError_t e = cudaFuncSetAttribute(window_sum_kernel<CN, SQ, SUMS, HWC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed[device] = smem;
  }
  window_sum_kernel<CN, SQ, SUMS, HWC><<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

// An HWC image (channel stride 1) takes its channels at immediate offsets.
template <int CN, bool SQ, bool SUMS>
cudaError_t launch_layout(const Args& a, int device, dim3 grid, int threads, cudaStream_t s) {
  if (a.sc == 1) return launch<CN, SQ, SUMS, true>(a, device, grid, threads, s);
  return launch<CN, SQ, SUMS, false>(a, device, grid, threads, s);
}

template <int CN>
cudaError_t launch_cn(const Args& a, int device, dim3 grid, int threads, cudaStream_t s) {
  if (a.sq != nullptr && a.sums != nullptr)
    return launch_layout<CN, true, true>(a, device, grid, threads, s);
  if (a.sq != nullptr) return launch_layout<CN, true, false>(a, device, grid, threads, s);
  return launch_layout<CN, false, true>(a, device, grid, threads, s);
}

}  // namespace

extern "C" {

// The window sums of f32 planes x (c, h, w), element strides sc, sy, sx
// (any, non-negative), over th x tw windows: `sq` (h - th + 1, w - tw + 1)
// f32 gets the sums of sum_c x^2 and `sums` (c, h - th + 1, w - tw + 1) f32
// the per-channel sums, each contiguous; either may be null, not both.  The
// launch plan (ops/cuda/window_sum.py::launch_plan): `rows` output rows a
// block (a multiple of 8), `threads` (128 or 256) a block, window rows `kr`
// and columns `kc` a pass (64 + kc - 1 <= threads).  One launch.  Returns a
// cudaError_t (0 on success).
int vacv_window_sum(int device, void* stream, const void* x, int c, int h, int w, long long sc,
                    long long sy, long long sx, int th, int tw, void* sq, void* sums, int rows,
                    int threads, int kr, int kc) {
  cudaGetLastError();  // clear a stale error of an earlier call
  if (c < 1 || th < 1 || tw < 1 || th > h || tw > w || (sq == nullptr && sums == nullptr) ||
      sc < 0 || sy < 0 || sx < 0 || rows < kBatch || rows % kBatch != 0 ||
      (threads != 128 && threads != 256) || kr < 1 || kr > th || kc < 1 || kc > tw ||
      kTileX + kc - 1 > threads || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ho = h - th + 1, wo = w - tw + 1;
  const dim3 grid((wo + kTileX - 1) / kTileX, (ho + rows - 1) / rows);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.x = static_cast<const float*>(x);
  a.c = c;
  a.h = h;
  a.w = w;
  a.sc = sc;
  a.sy = sy;
  a.sx = sx;
  a.th = th;
  a.tw = tw;
  a.rows = rows;
  a.kr = kr;
  a.kc = kc;
  a.ncol = kTileX + kc - 1;
  a.pitch = stage_pitch(a.ncol);
  a.sq = static_cast<float*>(sq);
  a.sums = static_cast<float*>(sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1:
      e = launch_cn<1>(a, device, grid, threads, s);
      break;
    case 2:
      e = launch_cn<2>(a, device, grid, threads, s);
      break;
    case 3:
      e = launch_cn<3>(a, device, grid, threads, s);
      break;
    default:  // groups of 4 channels
      e = launch_cn<4>(a, device, grid, threads, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
