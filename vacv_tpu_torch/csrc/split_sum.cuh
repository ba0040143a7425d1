// The second launch of a kernel whose work is split over grid z: the
// partials, (splits, count) contiguous, summed into `out` in split order,
// so a result is the same on every run (no atomics).  `out` may be the
// partials' first slice: each element is read before it is written, by
// the same thread.  Shared by probe_mma.cu and match_template.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vacv {

// Integer sums wrap (as the s32 accumulators of the tensor cores do):
// they add as unsigned, where wrapping is defined.
template <typename T>
struct SplitAdd {
  __device__ __forceinline__ static T add(T a, T b) { return a + b; }
};

template <>
struct SplitAdd<int> {
  __device__ __forceinline__ static int add(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  }
};

template <typename T>
__global__ void split_sum_kernel(const T* part, T* out, int64_t count, int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    T s = part[i];
    for (int z = 1; z < splits; ++z) s = SplitAdd<T>::add(s, part[z * count + i]);
    out[i] = s;
  }
}

template <typename T>
cudaError_t split_sum(const T* part, T* out, int64_t count, int splits, cudaStream_t s) {
  constexpr int kThreads = 256;
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 4096 ? blocks : 4096);
  split_sum_kernel<T><<<grid, kThreads, 0, s>>>(part, out, count, splits);
  return cudaGetLastError();
}

}  // namespace vacv
