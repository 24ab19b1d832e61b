// K7 on its own for Hopper (sm_90a): the EWA texture tap of texture.cuh over
// given lookups, one thread each.  The path kernel's textured instances run
// the same tap (path_megakernel.cu, tex_ewa_lookup, each level's tap called
// out of line); this entry exposes it alone so that it can be held to its
// plain version (scene/mipmap.ewa_lookup) and timed at a batch of lookups
// (ops/texture.py).  Per lookup 20 bytes come in (st, the two footprint
// axes) and 12 go out.  The block is launch.cuh's choose_block up to
// TEX_BLOCK, chosen at the first launch (tex_occupancy reports it).

#include "launch.cuh"
#include "texture.cuh"

namespace {

constexpr int TEX_BLOCK = 256;

__global__ void __launch_bounds__(TEX_BLOCK)
    tex_lookup_kernel(const float* __restrict__ data, const float* __restrict__ st,
                      const float* __restrict__ dst0, const float* __restrict__ dst1,
                      float* __restrict__ out, int n, const __grid_constant__ TexMap tm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[3];
  tex_ewa_lookup(data, tm, __ldg(st + 2 * i), __ldg(st + 2 * i + 1), __ldg(dst0 + 2 * i),
                 __ldg(dst0 + 2 * i + 1), __ldg(dst1 + 2 * i), __ldg(dst1 + 2 * i + 1), v);
  out[3 * i] = v[0];
  out[3 * i + 1] = v[1];
  out[3 * i + 2] = v[2];
}

// the block of tex_lookup_kernel, blocks resident an SM, registers a thread
// and dynamic shared memory bytes (0)
int g_tex_occupancy[4] = {};

cudaError_t tex_block(int& block) {
  if (g_tex_occupancy[0] == 0) {
    const cudaError_t err = choose_block(tex_lookup_kernel, TEX_BLOCK,
                                         [](int) { return (size_t)0; }, block, g_tex_occupancy);
    if (err != cudaSuccess) return err;
  }
  block = g_tex_occupancy[0];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launch n lookups on `stream`: st, dst0, dst1 (n, 2) float32, out (n, 3).
// Returns cudaGetLastError() of the launch (0 when it was accepted); nothing
// is synchronised.
int tex_lookup_launch(const float* data, const TexMap* tm, const float* st, const float* dst0,
                      const float* dst1, float* out, int n, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (n <= 0) return 0;
  if (tm->n_levels < 1 || tm->n_levels > TEX_LEVELS) return (int)cudaErrorInvalidValue;
  int block;
  const cudaError_t err = tex_block(block);
  if (err != cudaSuccess) return (int)err;
  tex_lookup_kernel<<<(n + block - 1) / block, block, 0, static_cast<cudaStream_t>(stream)>>>(
      data, st, dst0, dst1, out, n, *tm);
  return (int)cudaGetLastError();
}

// tex_lookup_kernel's block size, blocks resident per SM, registers per
// thread and dynamic shared memory bytes, into out[0..3] (zeros before the
// first launch)
void tex_occupancy(int* out) {
  for (int k = 0; k < 4; ++k) out[k] = g_tex_occupancy[k];
}

const char* tex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int tex_map_size() { return (int)sizeof(TexMap); }

}  // extern "C"
