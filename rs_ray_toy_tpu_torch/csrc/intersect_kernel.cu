// Brute-force closest hit for Hopper (sm_90a), K4: one thread per ray.
//
// Replaces the TPU kernel rs_ray_toy_tpu/ops/intersect_pallas.py · _kernel
// (pallas_call in _run, called by intersect_triangles_pallas), which the
// wavefront loop (integrators/common.SceneCtx) uses for scenes of at most
// BRUTE_FORCE_CUTOFF = 256 primitives: AO camera hits and probes, and the
// Path loop's hits and shadow rays there.  Per ray: Moller-Trumbore against
// every triangle of the packed (T, 12) table [p0, e1, e2, pad] in table
// order, closest hit with t in [TRI_EPS, t_max) and strict < (ties keep the
// lower row, as jnp.argmin does).  Output: t (+inf on a miss) and the
// triangle's row (-1 on a miss).
//
// What bounds it on this card: FP32 ALU work, 45 operations per ray and
// triangle, against 32 bytes in and 8 out per ray; with the fixture's 36
// triangles it is an ALU loop over data in shared memory.  The design: the
// intersect columns (36 B per triangle) staged once per block in shared
// memory, where every lane of a warp reads the same triangle (a broadcast);
// the loop and the Moller-Trumbore test are common.cuh's Geometry<false>,
// the brute-force branch of the camera kernels (the JAX package's epsilons:
// |det| >= 1e-7, u and v in [0, 1], t >= 1e-7).  Built with --fmad=false, so
// t is the plain version's (ops/intersect_kernel.intersect_triangles_reference)
// bit for bit.
//
// The wavefront loop launches intersect_chunk_kernel, the same query over
// common.cuh's chunked walk (ChunkGeometry: a slab test of each chunk's
// padded box against the ray's current best, the hit chunks' rows behind a
// division-free reject; the winner and t as above, bit for bit), with the
// rows and chunk rows in dynamic shared memory sized to the table, so a
// small table leaves the SM's shared memory to more blocks.
// intersect_kernel, the walk over every row, stays for the comparison.

#include "common.cuh"

namespace {

constexpr int K4_TRI_MAX = 1024;  // 36 KB of shared memory, under the static 48 KB
constexpr int PACKED_COLS = 12;

__global__ void __launch_bounds__(BLOCK)
intersect_kernel(const float* __restrict__ tri, int n_tris, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ t_max,
                 float* __restrict__ t_out, int* __restrict__ idx_out, int n) {
  __shared__ float s_geo[K4_TRI_MAX * GEO_COLS];
  for (int k = threadIdx.x; k < n_tris * GEO_COLS; k += blockDim.x)
    s_geo[k] = __ldg(tri + (k / GEO_COLS) * PACKED_COLS + k % GEO_COLS);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Geometry<false> geom{s_geo, n_tris, nullptr, nullptr, nullptr};
  float t_best = fminf(__ldg(t_max + i), BIG_T);
  const int best = geom.walk<false>(__ldg(o + 3 * i), __ldg(o + 3 * i + 1), __ldg(o + 3 * i + 2),
                                    __ldg(d + 3 * i), __ldg(d + 3 * i + 1), __ldg(d + 3 * i + 2),
                                    t_best);
  t_out[i] = best >= 0 ? t_best : __int_as_float(0x7f800000);  // +inf on a miss
  idx_out[i] = best;
}

__global__ void __launch_bounds__(BLOCK)
intersect_chunk_kernel(const float* __restrict__ tri, int n_tris, const float* __restrict__ chunks,
                       int n_chunks, const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ t_max, float* __restrict__ t_out,
                       int* __restrict__ idx_out, int n) {
  extern __shared__ float4 s_dyn[];
  const ChunkGeometry geom =
      load_chunk_geometry<PACKED_COLS>(s_dyn, tri, n_tris, chunks, n_chunks);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t_best = fminf(__ldg(t_max + i), BIG_T);
  const int best = geom.walk<false>(__ldg(o + 3 * i), __ldg(o + 3 * i + 1), __ldg(o + 3 * i + 2),
                                    __ldg(d + 3 * i), __ldg(d + 3 * i + 1), __ldg(d + 3 * i + 2),
                                    t_best);
  t_out[i] = best >= 0 ? t_best : __int_as_float(0x7f800000);  // +inf on a miss
  idx_out[i] = best;
}

// The last chunked launch's block size, blocks resident per SM, registers
// per thread and dynamic shared memory bytes
int g_occupancy[4] = {0, 0, 0, 0};

}  // namespace

extern "C" {

// Launch the closest-hit pass over n rays on `stream`.  Returns
// cudaGetLastError() of the launch (0 when it was accepted); nothing is
// synchronised.
int intersect_launch(const float* tri, int n_tris, const float* o, const float* d,
                     const float* t_max, float* t_out, int* idx_out, int n, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (n <= 0) return 0;
  if (n_tris <= 0 || n_tris > K4_TRI_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (n + BLOCK - 1) / BLOCK;
  intersect_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      tri, n_tris, o, d, t_max, t_out, idx_out, n);
  return (int)cudaGetLastError();
}

// The same over the chunked walk: chunks the (n_chunks, CHUNK_COLS) chunk
// rows that cover the table (ops/path_megakernel.build_tri_chunks).
int intersect_chunk_launch(const float* tri, int n_tris, const float* chunks, int n_chunks,
                           const float* o, const float* d, const float* t_max, float* t_out,
                           int* idx_out, int n, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (n <= 0) return 0;
  if (n_tris <= 0 || n_tris > K4_TRI_MAX || n_chunks <= 0 || n_chunks > K4_TRI_MAX / 4 ||
      chunks == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = chunk_smem(n_tris, n_chunks);  // 44 KB at most: no opt-in
  int n_blocks = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_blocks, intersect_chunk_kernel, BLOCK, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, intersect_chunk_kernel);
  if (err != cudaSuccess) return (int)err;
  g_occupancy[0] = BLOCK;
  g_occupancy[1] = n_blocks;
  g_occupancy[2] = attr.numRegs;
  g_occupancy[3] = (int)smem;
  const int grid = (n + BLOCK - 1) / BLOCK;
  intersect_chunk_kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      tri, n_tris, chunks, n_chunks, o, d, t_max, t_out, idx_out, n);
  return (int)cudaGetLastError();
}

void intersect_occupancy(int* out) {
  for (int k = 0; k < 4; ++k) out[k] = g_occupancy[k];
}

const char* intersect_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int intersect_tri_max() { return K4_TRI_MAX; }

}  // extern "C"
