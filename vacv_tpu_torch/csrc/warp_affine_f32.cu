// The f32 kernels of the affine warp (warp_affine.cuh), in a source of their
// own so that they compile beside the u8 kernels of warp_affine.cu.

#include "warp_affine.cuh"

namespace vacv_warp {

void launch_f32(const Params& p, int interp, dim3 grid, cudaStream_t s) {
  launch<float>(p, interp, grid, s);
}

}  // namespace vacv_warp
