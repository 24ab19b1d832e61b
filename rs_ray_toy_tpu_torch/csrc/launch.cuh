// The launch shape shared by the kernels (common.cuh's and
// texture_kernel.cu's): the smallest block and the occupancy API's choice of
// a block size.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;

// The block size of a launch: of the multiples of 32 from BLOCK to
// block_max, the one at which the most threads are resident on an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor: registers x block size,
// and the dynamic shared memory smem_of(block size) a block takes), the
// smaller on a tie.  occ gets the block size, blocks resident per SM, the
// kernel's registers per thread and the block's dynamic shared memory.
template <class Kernel, class SmemOf>
cudaError_t choose_block(Kernel kernel, int block_max, SmemOf smem_of, int& block, int* occ) {
  int best = 0;
  block = BLOCK;
  for (int b = BLOCK; b <= block_max; b += 32) {
    int n_blocks = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_blocks, kernel, b, smem_of(b));
    if (err != cudaSuccess) return err;
    if (n_blocks * b > best) best = n_blocks * b, block = b;
  }
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  occ[0] = block;
  occ[1] = best / block;
  occ[2] = attr.numRegs;
  occ[3] = (int)smem_of(block);
  return cudaSuccess;
}

}  // namespace
