// K7 on its own for Hopper (sm_90a): the EWA texture tap of texture.cuh over
// given lookups, one thread each.  The path kernel's textured instances
// inline the same tap (path_megakernel.cu); this entry exposes it alone so
// that it can be held to its plain version (scene/mipmap.ewa_lookup) and
// timed at a batch of lookups (ops/texture.py).  Per lookup 20 bytes come
// in (st, the two footprint axes) and 12 go out.

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
  const int grid = (n + TEX_BLOCK - 1) / TEX_BLOCK;
  tex_lookup_kernel<<<grid, TEX_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      data, st, dst0, dst1, out, n, *tm);
  return (int)cudaGetLastError();
}

const char* tex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int tex_map_size() { return (int)sizeof(TexMap); }

}  // extern "C"
