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
// (M + reps) K + K N operand elements and M N outputs; the operands are tiny
// next to the work, so what counts is how full the tensor cores are kept.
//
// Design.  Warpgroup MMA (wgmma.mma_async m64n128k16 bf16 / m64n128k32 s8,
// the only way to the card's full rate), A from registers and B from shared
// memory by descriptor.
// - A from registers: rep r reads the rows of A shifted by r.  A wgmma
//   descriptor addresses whole 8-row core matrices (or swizzle atoms), so a
//   one-row shift is not expressible; ldmatrix takes one row address per
//   lane, so each warp of a warpgroup loads its 16 rows of the shifted
//   window with one ldmatrix.x4, which is the register-A fragment of wgmma
//   (for bf16 and s8 alike: a k step is 32 bytes).
// - B stays in shared memory across every rep of a K chunk, K-major
//   ([n][k], the only B layout 8-bit wgmma takes), with the 128-byte
//   swizzle named in the descriptor (SBO 1024 bytes between 8-row groups;
//   a k step advances the start address by 32 bytes).
// - A ring of kStages stages, each a 128-byte K chunk: the A window (the
//   tile's 64 rows plus up to 63 shifted rows) by TMA with the 128-byte
//   swizzle (the tensor map is encoded per call: the probe slides A by a
//   row on every call), and B by four producer warps that read it row-major
//   and transpose it in registers into the K-major swizzled layout.  Full
//   and empty mbarriers hand the stages between the producers and the
//   consumer warpgroups, so chunk k+1 lands while chunk k's reps run.
// - A block is one 64 x 128 output tile and kConsumers = 3 warpgroups that
//   take every third rep of it on the same staged chunk; their sums are
//   added in shared memory in warpgroup order.  A warpgroup loads all k
//   steps of a rep's A fragments, then runs the rep's wgmmas as one
//   group behind one wgmma.fence, and loads the next rep's fragments into a
//   second register set while that group runs (a fence and commit for
//   every k step, or two warpgroups, measured slower on the H100).
// - Work units: at 1024^3 the grid is 16 x 8 = 128 tiles on 132 SMs.
//   Where tiles are fewer than SMs (96 x 2048: 2 x 16 = 32 tiles) the
//   wrapper splits the reps of a tile over grid z (4 splits there, 128
//   blocks; 8 at N = 1024); split z writes its partial to slice z of the
//   output buffer and a second launch (split_sum.cuh) adds the slices into
//   slice 0 in split order.  No float atomics: every run gives the same
//   result.  (A thread-block cluster adding the partials through
//   distributed shared memory measured slower at 96 x 128 x 2048 x 64.)
// Ragged M, N and K edges are zero (TMA's out-of-bounds fill for A, zero
// words for B) and masked at the store; K must be a multiple of one k step.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_sum.cuh"

namespace {

constexpr int kBM = 64;                          // rows of a tile (one wgmma)
constexpr int kBN = 128;                         // columns of a tile (wgmma n)
constexpr int kConsumers = 3;                    // warpgroups on a tile
constexpr int kProducers = 4;                    // warps staging the ring
constexpr int kThreads = (kConsumers * 4 + kProducers) * 32;
constexpr int kChunk = 128;                      // bytes of K per stage
constexpr int kStep = 32;                        // bytes of K per wgmma
constexpr int kRepChunk = 64;                    // reps served by one A window
constexpr int kARows = kBM + kRepChunk - 1;      // rows of the A window (TMA box)
constexpr int kABytes = 16384;                   // kARows * kChunk, to 1 KB
constexpr int kBBytes = kBN * kChunk;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kStages = 3;
constexpr int kSmem = kStages * kStageBytes + 1024;  // + slack to align to 1 KB
constexpr unsigned kFullArrivals = kProducers * 32 + 1;  // producer lanes + expect_tx

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Offset of byte `byte` of row `row` in a tile of 128-byte rows with the
// 128-byte swizzle (16-byte chunk index XOR row % 8); base 1 KB aligned.
__device__ __forceinline__ uint32_t swz(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major B tile with the 128-byte
// swizzle: start address >> 4, leading offset 1 (unused by swizzled
// K-major layouts), stride offset 1024 bytes >> 4 between 8-row groups,
// layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define VACV_ACC64                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, " \
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define VACV_D8(c, i)                                                                   \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), \
      c(d[i + 7])
#define VACV_D64(c)                                                                   \
  VACV_D8(c, 0), VACV_D8(c, 8), VACV_D8(c, 16), VACV_D8(c, 24), VACV_D8(c, 32),       \
      VACV_D8(c, 40), VACV_D8(c, 48), VACV_D8(c, 56)

template <bool I8>
struct Tc;

template <>
struct Tc<false> {  // bf16 x bf16 -> f32
  using Acc = float;
  static constexpr int kElem = 2;
  __device__ __forceinline__ static void mma(float (&d)[64], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VACV_ACC64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
        "}\n"
        : VACV_D64("+f")
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Tc<true> {  // s8 x s8 -> s32
  using Acc = int;
  static constexpr int kElem = 1;
  __device__ __forceinline__ static void mma(int (&d)[64], const unsigned (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " VACV_ACC64
        ", {%64, %65, %66, %67}, %68, p;\n"
        "}\n"
        : VACV_D64("+r")
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// Words of 4 bytes of K for 16 bytes of N from G = 4 / E rows of B: word j
// holds the G k values of column j (E-byte elements, row g in bits 8Eg).
template <bool I8>
__device__ __forceinline__ void transpose_rows(const uint4 (&r)[I8 ? 4 : 2],
                                               uint32_t (&w)[I8 ? 16 : 8]) {
  const uint32_t* x0 = reinterpret_cast<const uint32_t*>(&r[0]);
  const uint32_t* x1 = reinterpret_cast<const uint32_t*>(&r[1]);
  if constexpr (I8) {
    const uint32_t* x2 = reinterpret_cast<const uint32_t*>(&r[2]);
    const uint32_t* x3 = reinterpret_cast<const uint32_t*>(&r[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t t0 = __byte_perm(x0[i], x1[i], 0x5140);  // r0 b0, r1 b0, r0 b1, r1 b1
      const uint32_t t1 = __byte_perm(x0[i], x1[i], 0x7362);  // the same for bytes 2, 3
      const uint32_t u0 = __byte_perm(x2[i], x3[i], 0x5140);
      const uint32_t u1 = __byte_perm(x2[i], x3[i], 0x7362);
      w[4 * i] = __byte_perm(t0, u0, 0x5410);
      w[4 * i + 1] = __byte_perm(t0, u0, 0x7632);
      w[4 * i + 2] = __byte_perm(t1, u1, 0x5410);
      w[4 * i + 3] = __byte_perm(t1, u1, 0x7632);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[2 * i] = __byte_perm(x0[i], x1[i], 0x5410);
      w[2 * i + 1] = __byte_perm(x0[i], x1[i], 0x7632);
    }
  }
}

// The producer warps' B chunk: bytes [k0, k0 + 128) of K by the tile's 128
// columns, K-major and swizzled.  Producer warp pw takes every kProducers-th
// 16-byte column group; its lane l makes the 4-byte words of K bytes
// [4l, 4l + 4) for each column, so a store instruction writes 32 distinct
// banks of one row.  Rows past K and columns past N are zero.
template <bool I8>
__device__ __forceinline__ void stage_b(uint8_t* sb, const uint8_t* __restrict__ b,
                                        int64_t ldb_bytes, int k0, int k_bytes, int n0, int n,
                                        int pw, int lane, bool vec) {
  constexpr int E = Tc<I8>::kElem;
  constexpr int G = 4 / E;        // rows of B in a word
  constexpr int NPER = 16 / E;    // columns in 16 bytes of a row
  constexpr int NG = kBN / NPER;  // 16-byte column groups of the tile
  const int kv = k0 / E + G * lane;
  const int k_vals = k_bytes / E;
  const uint32_t base = smem_addr(sb);
  static_assert(NG % kProducers == 0, "column groups per producer warp");
#pragma unroll
  for (int t = 0; t < NG / kProducers; ++t) {
    const int s = pw + t * kProducers;
    const int nb = n0 + s * NPER;
    uint32_t w[NPER];
    if (vec && nb + NPER <= n) {
      uint4 r[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        r[g] = kv + g < k_vals
                   ? __ldg(reinterpret_cast<const uint4*>(b + (kv + g) * ldb_bytes + nb * E))
                   : make_uint4(0, 0, 0, 0);
      }
      transpose_rows<I8>(r, w);
    } else {
#pragma unroll
      for (int j = 0; j < NPER; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (kv + g < k_vals && nb + j < n) {
            const uint8_t* p = b + (kv + g) * ldb_bytes + static_cast<int64_t>(nb + j) * E;
            const uint32_t v = I8 ? *p : *reinterpret_cast<const uint16_t*>(p);
            word |= v << (8 * E * g);
          }
        }
        w[j] = word;
      }
    }
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(base + swz(s * NPER + j, 4 * lane)),
                   "r"(w[j]));
    }
  }
}

template <bool I8>
__global__ void __launch_bounds__(kThreads, 1)
    probe_kernel(const __grid_constant__ CUtensorMap tmap_a, const uint8_t* __restrict__ b,
                 int64_t ldb_bytes, typename Tc<I8>::Acc* __restrict__ out, int m, int k_bytes,
                 int n, int reps, int b_vec) {
  using Acc = typename Tc<I8>::Acc;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int splits = gridDim.z;  // the blocks of a tile
  const int per = (reps + splits - 1) / splits;
  const int rb0 = blockIdx.z * per;
  const int n_rep = max(0, min(reps, rb0 + per) - rb0);
  const int nr = (n_rep + kRepChunk - 1) / kRepChunk;
  const int units = nr * ((k_bytes + kChunk - 1) / kChunk);  // (K chunk, rep chunk)

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kFullArrivals);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {  // the producer warps
    const int pw = warp - kConsumers * 4;
    if (pw == 0 && lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmap_a))
                   : "memory");
    }
    for (int u = 0; u < units; ++u) {
      const int s = u % kStages, kc = u / nr, rc = u - kc * nr;
      uint8_t* sa = ring + s * kStageBytes;
      mbar_wait(&empty[s], ((u / kStages) & 1) ^ 1);
      if (pw == 0 && lane == 0) {
        mbar_arrive_expect_tx(&full[s], kARows * kChunk);
        tma_load_2d(sa, &tmap_a, kc * kChunk, m0 + rb0 + rc * kRepChunk, &full[s]);
      }
      stage_b<I8>(sa + kABytes, b, ldb_bytes, kc * kChunk, k_bytes, n0, n, pw, lane, b_vec != 0);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // st.shared -> wgmma
      mbar_arrive(&full[s]);
    }
    return;
  }

  const int wg = warp >> 2, wi = warp & 3;
  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = Acc(0);
  // A fragments of two reps: one rep's group of wgmmas runs while the
  // next rep's fragments load into the other set.
  unsigned af[2][kChunk / kStep][4];
  for (int u = 0; u < units; ++u) {
    const int s = u % kStages, kc = u / nr, rc = u - kc * nr;
    const uint32_t sa = smem_addr(ring + s * kStageBytes);
    const int steps = min(kChunk, k_bytes - kc * kChunk) / kStep;
    const int rn = min(kRepChunk, n_rep - rc * kRepChunk);
    const uint64_t desc = b_desc(ring + s * kStageBytes + kABytes);
    mbar_wait(&full[s], (u / kStages) & 1);
    for (int r0 = wg; r0 < rn; r0 += 2 * kConsumers) {
#pragma unroll
      for (int set = 0; set < 2; ++set) {
        const int r = r0 + set * kConsumers;
        if (r < rn) {
          // Lanes 0-15 give rows 0-15 of the warp's 16 (shifted by r) at
          // a k step's first 16 bytes, lanes 16-31 the same rows at its
          // second 16.
          const int row = wi * 16 + (lane & 15) + r;
#pragma unroll
          for (int ks = 0; ks < kChunk / kStep; ++ks) {
            if (ks < steps) {
              ldmatrix_x4(af[set][ks], sa + swz(row, ks * kStep + (lane >> 4) * 16));
            }
          }
          wgmma_fence();  // the fragments are written before the wgmmas read them
#pragma unroll
          for (int ks = 0; ks < kChunk / kStep; ++ks) {
            if (ks < steps) Tc<I8>::mma(acc, af[set][ks], desc + 2 * ks);  // + 32 bytes a step
          }
          wgmma_commit();
          wgmma_wait<1>();  // the other set's group is done: it may load again
        }
      }
    }
    wgmma_wait<0>();
    if ((tid & 127) == 0) mbar_arrive(&empty[s]);
  }

  // The warpgroups' sums, added in warpgroup order through the (now idle)
  // ring; thread t of a warpgroup holds the same 64 outputs in each.
  const int t = tid & 127;
  Acc* red = reinterpret_cast<Acc*>(ring);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
  if (wg > 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) red[((wg - 1) * 64 + i) * 128 + t] = acc[i];
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
  if (wg > 0) return;
#pragma unroll
  for (int w = 1; w < kConsumers; ++w)
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = vacv::SplitAdd<Acc>::add(acc[i], red[((w - 1) * 64 + i) * 128 + t]);
    }
  // Accumulator layout: register i = 4j + 2h + e is row 16 warp + lane / 4
  // + 8h, column 8j + 2 (lane % 4) + e.  Split z writes slice z.
  Acc* dst = out + static_cast<int64_t>(blockIdx.z) * m * n;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + wi * 16 + g + 8 * h, col = n0 + 8 * j + c2 + e;
        if (row < m && col < n) dst[static_cast<int64_t>(row) * n + col] = acc[4 * j + 2 * h + e];
      }
}

// cuTensorMapEncodeTiled lives in libcuda: fetch it through the runtime's
// entry-point query so the library links with nvcc alone.
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The tensor map of A as bytes: `rows` rows of `k_bytes` bytes at row
// stride `lda_bytes`, read in boxes of the A window (128 bytes of K by
// kARows rows) with the 128-byte swizzle the ldmatrix reads expect.
bool encode_a_map(CUtensorMap* map, const void* a, int64_t k_bytes, int64_t rows,
                  int64_t lda_bytes) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k_bytes), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(lda_bytes)};
  const cuuint32_t box[2] = {kChunk, kARows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(a), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool I8>
cudaError_t launch(const CUtensorMap& map, const uint8_t* b, int64_t ldb_bytes, void* out, int m,
                   int k_bytes, int n, int reps, int splits, cudaStream_t s) {
  using Acc = typename Tc<I8>::Acc;
  cudaError_t e = cudaFuncSetAttribute(probe_kernel<I8>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, splits);
  const int vec = reinterpret_cast<uintptr_t>(b) % 16 == 0 && ldb_bytes % 16 == 0;
  Acc* o = static_cast<Acc*>(out);
  probe_kernel<I8><<<grid, kThreads, kSmem, s>>>(map, b, ldb_bytes, o, m, k_bytes, n, reps, vec);
  e = cudaGetLastError();
  if (e == cudaSuccess && splits > 1) {
    e = vacv::split_sum<Acc>(o, o, static_cast<int64_t>(m) * n, splits, s);
  }
  return e;
}

}  // namespace

extern "C" {

// out (m, n) = sum_{r < reps} a[r : r + m, :] @ b, with a (m + reps, k) of
// row stride lda elements and b (k, n) of row stride ldb, both with unit
// column stride and 16-byte aligned rows of a; bf16 -> f32 (is_i8 = 0) or
// int8 -> int32 (is_i8 = 1); k a multiple of 16 (bf16) or 32 (int8).  The
// reps of each output tile are split over `splits` blocks: `out` holds
// (splits, m, n) values of the output type and the result is its first
// slice.  Returns a cudaError_t (0 on success).
int vacv_probe_mma(int device, void* stream, const void* a, long long lda, const void* b,
                   long long ldb, void* out, int m, int k, int n, int reps, int splits,
                   int is_i8) {
  cudaGetLastError();  // clear a stale error of an earlier call
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (splits < 1 || reps < 1 || m < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elem = is_i8 ? 1 : 2;
  CUtensorMap map;  // encoded per call: the probe slides A by a row on every call
  if (!encode_a_map(&map, a, static_cast<int64_t>(k) * elem, static_cast<int64_t>(m) + reps,
                    static_cast<int64_t>(lda) * elem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  e = is_i8 ? launch<true>(map, pb, ldb, out, m, k, n, reps, splits, s)
            : launch<false>(map, pb, 2 * ldb, out, m, 2 * k, n, reps, splits, s);
  return static_cast<int>(e);
}

}  // extern "C"
