// Deterministic sum over a 1-D thread block (preprocess.cu).
#pragma once

namespace vacv {

// Sum of one float per thread over a block of THREADS threads (a multiple
// of 32); every thread gets the total.  `red` is THREADS / 32 floats of
// shared memory.  Deterministic: a fixed shuffle tree, then every thread
// adds the per-warp sums in the same order.
template <int THREADS>
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) total += red[i];
  return total;
}

}  // namespace vacv
