// The tensor-core probe for Hopper (sm_90a): a sum of row-shifted matrix
// products, in bf16 -> f32 or int8 -> int32, with a plain C interface loaded
// by ctypes (vacv_tpu_torch/ops/cuda/probe.py).
//
// Replaces: benchmarks/probe_i8.py::_mk.kernel, the TPU probe of the MXU's
// bf16 and int8 rates.  That kernel holds both operands in VMEM and runs
// `reps` dots on static row windows of A so that Mosaic cannot merge them.
//
// What it computes: out[m, n] = sum_{r < reps} sum_k a[r + m, k] b[k, n] for
// a (M + reps, K) row-major (row stride lda elements) and b (K, N) row-major
// (row stride ldb); out (M, N) contiguous, f32 for bf16 operands and s32 for
// int8 ones.
//
// Bound: tensor-core operations.  2 M N K reps of them against
// (M + reps) K + K N operand elements and M N outputs, so the operands are
// tiny next to the work; it is the rate of mma instructions and of the
// shared-memory fragment loads that feed them.
//
// Design: a block of four warps owns a kBM x kBN = 64 x 64 output tile, each
// warp a 32 x 32 quarter of it (2 x 4 mma tiles of 16 x 8), with its sums in
// registers (f32 or s32) for the whole run and written once.  K is walked in
// chunks of kChunk = 128 bytes (64 bf16 or 128 int8 values).  For each chunk
// the block stages the B chunk once, transposed to [n][k] so that both types
// read their "col" B fragment with a plain ldmatrix, and the window of A rows
// [m0 + r0, m0 + r0 + kBM + reps - 1) once (reps in chunks of kRepChunk).
// Rep r then reads the same staged rows shifted by r: ldmatrix takes one row
// address per lane, so any shift works, one staging feeds every rep, and the
// B fragments stay in registers across the reps.  Shared rows are padded to
// 144 bytes so the eight 16-byte rows of an ldmatrix phase fall on distinct
// banks.  Ragged M, N and K edges are zero-filled in shared memory and masked
// at the store; K must be a multiple of one mma step (16 bf16 / 32 int8).
// The fragment layouts are the same in bytes for both types (a k step is 32
// bytes: m16n8k16 for bf16, m16n8k32 for int8), so one kernel body serves both.
// wgmma, TMA and a pipelined ring are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 128;                // bytes of K per staged chunk
constexpr int kStride = kChunk + 16;       // padded shared row, bytes
constexpr int kStep = 32;                  // bytes of K per mma
constexpr int kRepChunk = 64;              // reps served by one A staging
constexpr int kARows = kBM + kRepChunk - 1;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

template <bool I8>
struct Mma;

template <>
struct Mma<false> {  // bf16 x bf16 -> f32
  using Acc = float;
  static constexpr int kElem = 2;
  __device__ __forceinline__ static void run(float (&c)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<true> {  // s8 x s8 -> s32
  using Acc = int;
  static constexpr int kElem = 1;
  __device__ __forceinline__ static void run(int (&c)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <bool I8>
__global__ void __launch_bounds__(kThreads) probe_kernel(
    const uint8_t* __restrict__ a, int64_t lda_bytes, const uint8_t* __restrict__ b,
    int64_t ldb_bytes, typename Mma<I8>::Acc* __restrict__ out, int m, int k_bytes, int n,
    int reps) {
  using Acc = typename Mma<I8>::Acc;
  constexpr int E = Mma<I8>::kElem;
  __shared__ __align__(16) uint8_t s_a[kARows * kStride];
  __shared__ __align__(16) uint8_t s_b[kBN * kStride];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int a_rows = m + reps;

  Acc acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = Acc(0);

  for (int k0 = 0; k0 < k_bytes; k0 += kChunk) {
    const int kc = min(kChunk, k_bytes - k0);  // a multiple of kStep
    for (int r0 = 0; r0 < reps; r0 += kRepChunk) {
      const int rc = min(kRepChunk, reps - r0);
      const int rows = kBM + rc - 1;
      __syncthreads();  // the previous staging's reads are done
      // The B chunk, transposed: s_b[n][k byte], once per K chunk.  Lanes
      // walk n, so the global reads of a k row are coalesced.
      if (r0 == 0) {
        const int kv = kChunk / E;  // values of K in a chunk
        for (int e = tid; e < kv * kBN; e += kThreads) {
          const int kk = e / kBN, nn = e - kk * kBN;
          const int gk = k0 / E + kk, gn = n0 + nn;
          uint8_t* dst = s_b + nn * kStride + kk * E;
          if (kk * E < kc && gn < n) {
            const uint8_t* src = b + gk * ldb_bytes + static_cast<int64_t>(gn) * E;
            if (E == 2) {
              *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
            } else {
              *dst = *src;
            }
          } else {
            if (E == 2) {
              *reinterpret_cast<uint16_t*>(dst) = 0;
            } else {
              *dst = 0;
            }
          }
        }
      }
      // The A window of this rep chunk, 16 bytes a thread.
      for (int e = tid; e < rows * (kChunk / 16); e += kThreads) {
        const int rr = e / (kChunk / 16), cc = (e - rr * (kChunk / 16)) * 16;
        const int g = m0 + r0 + rr;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (g < a_rows && cc < kc) {
          v = *reinterpret_cast<const uint4*>(a + g * lda_bytes + k0 + cc);
        }
        *reinterpret_cast<uint4*>(s_a + rr * kStride + cc) = v;
      }
      __syncthreads();
      for (int ks = 0; ks < kc; ks += kStep) {
        // B fragments of the warp's four n tiles: lanes 0-7 give rows n 0-7 at
        // k byte 0 (b0 of tile 0), 8-15 the same rows at byte 16 (b1), 16-31
        // rows n 8-15 likewise (tile 1).
        unsigned bf[2][4];
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          const int row = wn + nj * 16 + (lane >> 4) * 8 + (lane & 7);
          ldmatrix_x4(bf[nj], s_b + row * kStride + ks + ((lane >> 3) & 1) * 16);
        }
        for (int r = 0; r < rc; ++r) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            // A fragment of rows wm + 16 mi + r ...: lanes 0-15 give rows 0-15
            // at k byte 0, lanes 16-31 the same rows at byte 16.
            unsigned af[4];
            const int row = wm + mi * 16 + (lane & 15) + r;
            ldmatrix_x4(af, s_a + row * kStride + ks + (lane >> 4) * 16);
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
              Mma<I8>::run(acc[mi][2 * nj], af, bf[nj][0], bf[nj][1]);
              Mma<I8>::run(acc[mi][2 * nj + 1], af, bf[nj][2], bf[nj][3]);
            }
          }
        }
      }
    }
  }
  // C fragment: c0, c1 at (row lane/4, cols 2 (lane%4) + {0, 1}); c2, c3 at
  // row + 8.
  const int gr = lane >> 2, gc = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + wm + mi * 16 + gr + (q >> 1) * 8;
        const int col = n0 + wn + ni * 8 + gc + (q & 1);
        if (row < m && col < n) out[static_cast<int64_t>(row) * n + col] = acc[mi][ni][q];
      }
}

}  // namespace

extern "C" {

// out (m, n) = sum_{r < reps} a[r : r + m, :] @ b, with a (m + reps, k) of
// row stride lda elements and b (k, n) of row stride ldb, both with unit
// column stride and 16-byte aligned rows of a; bf16 -> f32 (is_i8 = 0) or
// int8 -> int32 (is_i8 = 1); k a multiple of 16 (bf16) or 32 (int8).
// Returns a cudaError_t (0 on success).
int vacv_probe_mma(int device, void* stream, const void* a, long long lda, const void* b,
                   long long ldb, void* out, int m, int k, int n, int reps, int is_i8) {
  cudaGetLastError();  // clear a stale error of an earlier call
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  if (is_i8) {
    probe_kernel<true><<<grid, kThreads, 0, s>>>(pa, lda, pb, ldb, static_cast<int*>(out), m, k,
                                                 n, reps);
  } else {
    probe_kernel<false><<<grid, kThreads, 0, s>>>(pa, 2 * lda, pb, 2 * ldb,
                                                  static_cast<float*>(out), m, 2 * k, n, reps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
