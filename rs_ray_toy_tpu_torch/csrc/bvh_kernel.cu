// BVH closest hit, any hit and shaded closest hit for Hopper (sm_90a), K3:
// one thread per ray; the closest and any hit (bvh64_kernel, the wavefront
// loop's walk; bvh_kernel's closest and any hit stay for the comparison) and
// the shaded closest hit (bvh_shaded_kernel) over the node64 rows, and the
// BVH4 (bvh4_kernel, below).
//
// Replaces the TPU kernels rs_ray_toy_tpu/ops/bvh_pallas.py · _traverse_kernel
// with fused=True (pallas_call in _call: intersect_bvh_pallas with
// any_hit=False, occluded_bvh_pallas with any_hit=True) and
// _traverse_shaded_kernel (intersect_bvh_pallas_shaded), which the wavefront
// loop (integrators/common.SceneCtx) uses above 256 primitives: every AO
// probe and Path shadow ray is an any-hit query, every AO camera hit and Path
// bounce a shaded closest hit.  The tables are the JAX package's: the
// fused-children node rows (M, 16) with (offset, n_prims, axis, 0), the
// triangles in leaf order as (P, 12) [p0, e1, e2, pad] with (P, 4)
// [original row, material, area light, 0], and for the shaded kernel the
// shade rows in leaf order: flat (P, 15) [uv0, uv1, uv2, dpdu, dpdv, ng], or
// for a mesh with vertex normals (P, 31) [..., n0, n1, n2, dndu, dndv,
// has_n], which the smooth instance (_traverse_shaded_kernel with
// smooth=True) reads; beside them the same tree's node64 rows
// (accel/bvh.pack_node64_tables), which bvh64_kernel and the shaded kernel walk.
//
// Per ray (bvh_kernel): common.cuh's Geometry<true> walk (a per-ray stack of up to 64
// nodes, or 256 in the deep instances for trees of 64 to 255 levels, chosen
// per launch by the tables' depth; at an interior node both child boxes are slab-tested against the
// current best t and only the hit children are pushed, near child last; a
// leaf's triangles in leaf order with strict <), bounded by the ray's t_max.
// A lane with t_max <= 0 (the loop's dead lanes) misses at once.  Closest
// hit: t (t_max on a miss) and the original row (-1).  Any hit: stops at the
// first triangle with t in [1e-7, t_max).  Shaded: the winner's barycentric
// u, v (the Moller-Trumbore values of the walk, recomputed from its row),
// its interpolated uv, ns, ng, dpdu, dpdv, material and area light, as
// _traverse_shaded_kernel's finalize computes them: flat, ns = ng; smooth,
// ns the normalised interpolation of the vertex normals (ng where the row has
// none or they sum to zero), ng faced onto ns, and dndu, dndv after dpdv.
// The TPU kernel carries the winner's 15 or 31 attribute columns through the
// walk; here the walk keeps only the winner's row and reads its columns once
// at the end, so the smooth instance costs no registers in the walk.
//
// What bounds it on this card: latency of the dependent node and triangle
// loads of the walk (read through the read-only cache) and divergence between
// the rays of a warp; per ray only 28 bytes come in and 8 (any hit), 80
// (shaded) or 104 (shaded smooth) go out.  The simple design: no packets (the TPU kernel walks one
// tree per 4096-ray tile, descending where any ray of the tile hits; here each
// ray walks only its own nodes and retires when done), outputs written once.

#include "common.cuh"

namespace {

constexpr int PRIM_COLS = 12;   // p0, e1, e2, pad
constexpr int PRIM_I_COLS = 4;  // original row, material, area light, 0
constexpr int SHADE_COLS_FLAT = 15;    // uv0, uv1, uv2, dpdu, dpdv, ng
constexpr int SHADE_COLS_SMOOTH = 31;  // ... n0, n1, n2, dndu, dndv, has_n
constexpr int ATTR_ROWS = 16;          // u, v, uv, ns, ng, dpdu, dpdv
constexpr int ATTR_ROWS_SMOOTH = 22;   // ... dndu, dndv

template <int kStack>
using Bvh = Geometry<true, PRIM_COLS, kStack>;

template <bool kAny, int kStack = STACK_DEPTH>
__global__ void __launch_bounds__(BLOCK)
bvh_kernel(const float* __restrict__ nodes_f, const int* __restrict__ nodes_i,
           const float* __restrict__ prims_f, const int* __restrict__ prims_i, int n_prims,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_max, float* __restrict__ t_out,
           int* __restrict__ idx_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tm = __ldg(t_max + i);
  float t_bound = tm;
  int best = -1;
  if (tm > 0.0f) {
    const Bvh<kStack> geom{nullptr, n_prims, prims_f, nodes_f, nodes_i};
    best = geom.template walk<kAny>(__ldg(o + 3 * i), __ldg(o + 3 * i + 1), __ldg(o + 3 * i + 2),
                           __ldg(d + 3 * i), __ldg(d + 3 * i + 1), __ldg(d + 3 * i + 2),
                           t_bound);
  }
  t_out[i] = best >= 0 ? t_bound : tm;
  idx_out[i] = best >= 0 ? __ldg(prims_i + PRIM_I_COLS * best) : -1;
}

// ---- the node64 walk (bvh64_kernel), the wavefront loop's closest and any hit ----
//
// Replaces the same TPU kernel (_traverse_kernel, closest and any hit), as
// bvh_kernel does, with a walk redesigned for this card: common.cuh's Bvh64
// over the node64 rows (accel/bvh.pack_node64_tables).  bvh_kernel's walk
// waits on two dependent loads a visited node (its int4, then its child
// boxes as 12 scalar loads), fetches a leaf as a node before its first
// triangle, reads each triangle as 9 scalar loads with a division in every
// Moller-Trumbore test, and pushes and pops the near child at every step.
// Here an interior node is one 64-byte row (four float4 loads, both
// children's references in it), a leaf is known at its parent, a triangle
// row is three float4 loads and meets the division-free reject first (the
// next row's loads in flight meanwhile), the near child is entered without a
// push (a leaf's count rides in its parent's row and on the stack beside its
// reference), and a ray's loads are issued together before its t_max is tested.
// The stack stays a per-thread local array (64 entries, 256 in the deep
// instances for trees of 64 to 255 levels): the card measured it faster than
// one in shared memory laid out thread-interleaved (PERF.md §6 row 13).  The
// hits, t and any hit's row are bvh_kernel's, ray for ray.  What bounds it is
// still the latency of dependent loads and the divergence of a warp's walks:
// per ray 28 bytes in and 8 out, and the tables (a few MB) stay in L2.
constexpr int BVH64_BLOCK_MAX = 256;

template <bool kAny, int kStack>
__global__ void __launch_bounds__(BVH64_BLOCK_MAX)
bvh64_kernel(const float4* __restrict__ nodes64, int root_count,
             const float4* __restrict__ prims_f, const int* __restrict__ prims_i,
             const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ t_max, float* __restrict__ t_out,
             int* __restrict__ idx_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // the ray's loads issued together, ahead of the test of t_max
  const float tm = __ldg(t_max + i);
  const float ox = __ldg(o + 3 * i), oy = __ldg(o + 3 * i + 1), oz = __ldg(o + 3 * i + 2);
  const float dx = __ldg(d + 3 * i), dy = __ldg(d + 3 * i + 1), dz = __ldg(d + 3 * i + 2);
  float t_bound = tm;
  int best = -1;
  if (tm > 0.0f) {
    const Bvh64<kStack> geom{nodes64, prims_f, root_count};
    best = geom.template walk<kAny>(ox, oy, oz, dx, dy, dz, t_bound);
  }
  t_out[i] = best >= 0 ? t_bound : tm;
  idx_out[i] = best >= 0 ? __ldg(prims_i + PRIM_I_COLS * best) : -1;
}

// ---- the BVH4 walk (bvh4_kernel) ----
//
// Replaces _traverse4_kernel (the body of pallas_call in _call under
// RS_BVH_WIDE=1): the binary tree collapsed into 4-wide nodes
// (accel/bvh.pack_bvh4_tables: per node a (24,) float row, child slot c's
// bmin, bmax at 6c, and a (12,) int row, its kind 0 none / 1 interior / 2
// leaf, a (wide node or first triangle) and b (triangle count)).  Per ray:
// pop a wide node, load its rows as six float4 and three int4, test its
// non-empty child slots in order against the ray's best t (an empty slot's
// inverted box spans all of space under the min / max slab test: only its
// kind keeps the walk out), test a hit leaf child's triangles there in leaf
// order with strict < (any hit: return at the first), and push the hit
// interior children far to near by the ray's own entry distance through the
// TPU kernel's compare-swap network (ties keep slot order), so the nearest
// pops next.  The TPU kernel orders a packet's pushes by the packet's
// least entry distance and clamps its 64-entry stack, dropping subtrees
// past it; here each ray orders its own and the stack holds the tree
// (accel/bvh.stack4_for: 3 (levels - 1) + 1 entries, the deep instance past
// 64).  Bound like the binary walk: dependent node and triangle loads and
// divergence; a pop reads 144 bytes and makes up to four slab tests where
// the binary walk's reads 80 and makes two.
__device__ __forceinline__ bool slab_tn(const float* b, float ox, float oy, float oz, float ix,
                                        float iy, float iz, float t_cur, float& tn) {
  const float t0x = (b[0] - ox) * ix, t1x = (b[3] - ox) * ix;
  const float t0y = (b[1] - oy) * iy, t1y = (b[4] - oy) * iy;
  const float t0z = (b[2] - oz) * iz, t1z = (b[5] - oz) * iz;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tf =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)) * SLAB_SLOP;
  return tn <= tf && tf > 0.0f && tn < t_cur && t_cur > 0.0f;
}

// after it, slot i holds the farther entry distance (descending order)
__device__ __forceinline__ void order_pair(float* key, int* id, bool* push, int i, int j) {
  if (key[i] < key[j]) {
    const float k = key[i];
    key[i] = key[j];
    key[j] = k;
    const int d = id[i];
    id[i] = id[j];
    id[j] = d;
    const bool p = push[i];
    push[i] = push[j];
    push[j] = p;
  }
}

// One ray's walk: the winner's leaf-order row (-1 on a miss), its t in t_bound
template <bool kAny, int kStack>
__device__ int walk4(const float* __restrict__ nodes4_f, const int* __restrict__ nodes4_i,
                     const Bvh<kStack>& tris, float ox, float oy, float oz, float dx, float dy,
                     float dz, float& t_bound) {
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  int best = -1;
  int stack[kStack];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    const float4* rf = reinterpret_cast<const float4*>(nodes4_f) + (size_t)node * 6;
    const int4* ri = reinterpret_cast<const int4*>(nodes4_i) + (size_t)node * 3;
    float box[24];
    int slot[12];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float4 v = __ldg(rf + q);
      box[4 * q] = v.x;
      box[4 * q + 1] = v.y;
      box[4 * q + 2] = v.z;
      box[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int4 v = __ldg(ri + q);
      slot[4 * q] = v.x;
      slot[4 * q + 1] = v.y;
      slot[4 * q + 2] = v.z;
      slot[4 * q + 3] = v.w;
    }
    float key[4];
    int id[4];
    bool push[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kind = slot[3 * c], a = slot[3 * c + 1], b = slot[3 * c + 2];
      key[c] = BIG_T;
      id[c] = a;
      push[c] = false;
      float tn;
      if (kind == 0 || !slab_tn(box + 6 * c, ox, oy, oz, ix, iy, iz, t_bound, tn)) continue;
      if (kind == 2) {
        for (int k = 0; k < b; ++k) {
          float t;
          if (tris.tri_hit(a + k, ox, oy, oz, dx, dy, dz, t) && t < t_bound) {
            best = a + k;
            if constexpr (kAny) return best;
            t_bound = t;
          }
        }
      } else {
        key[c] = tn;
        push[c] = true;
      }
    }
    order_pair(key, id, push, 0, 1);
    order_pair(key, id, push, 2, 3);
    order_pair(key, id, push, 0, 2);
    order_pair(key, id, push, 1, 3);
    order_pair(key, id, push, 1, 2);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (push[c]) stack[sp++] = id[c];
  }
  return best;
}

template <bool kAny, int kStack>
__global__ void __launch_bounds__(BLOCK)
bvh4_kernel(const float* __restrict__ nodes4_f, const int* __restrict__ nodes4_i,
            const float* __restrict__ prims_f, const int* __restrict__ prims_i, int n_prims,
            const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_max, float* __restrict__ t_out,
            int* __restrict__ idx_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float tm = __ldg(t_max + i);
  float t_bound = tm;
  int best = -1;
  if (tm > 0.0f) {
    const Bvh<kStack> tris{nullptr, n_prims, prims_f, nullptr, nullptr};
    best = walk4<kAny, kStack>(nodes4_f, nodes4_i, tris, __ldg(o + 3 * i), __ldg(o + 3 * i + 1),
                               __ldg(o + 3 * i + 2), __ldg(d + 3 * i), __ldg(d + 3 * i + 1),
                               __ldg(d + 3 * i + 2), t_bound);
  }
  t_out[i] = best >= 0 ? t_bound : tm;
  idx_out[i] = best >= 0 ? __ldg(prims_i + PRIM_I_COLS * best) : -1;
}

// ---- the shaded closest hit (bvh_shaded_kernel) on the node64 walk ----
//
// Replaces _traverse_shaded_kernel (intersect_bvh_pallas_shaded).  The walk
// is bvh64_kernel's: common.cuh's Bvh64 over the node64 rows and the 48-byte
// leaf rows, the division-free reject before Moller-Trumbore, a
// tree that is one leaf (no node64 row) walked from its root_count rows.
// It visits in Geometry<true>'s order, so the winner and its t are those of
// the fused-children walk that this kernel took before, ray for ray.  The
// block is the occupancy API's choice up to BVH64_BLOCK_MAX (choose_block),
// with no bound for more resident blocks.  The flat instance keeps the next
// leaf row's loads in flight (Bvh64's kPrefetch, as bvh64_kernel); the
// smooth and deep instances load each leaf row when it is tested, which
// ran them 9-10% faster on the card, where the prefetch ran the flat
// batches 1-2% faster (PERF.md §6, `walk_ab --variant`).  A launch
// bound for 5 resident blocks and shade rows padded to 16 / 32 columns for
// float4 loads each lost there too.  Once the walk is done the winner's row
// is read once: its geometry as three float4 (Moller-Trumbore's u, v again,
// the walk's expressions), its shade row, then its original row, material
// and area light as one int4.
template <bool kSmooth, int kStack>
constexpr bool kShadedPrefetch = !kSmooth && kStack == STACK_DEPTH;

// Barycentric u, v of the ray on the leaf row r = (p0, e1, e2, pad) as
// three float4: mt_hit's expressions, so the values are those the walk tested
__device__ __forceinline__ void mt_uv(const float4* r, float ox, float oy, float oz, float dx,
                                      float dy, float dz, float& u, float& v) {
  const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
  const float p0x = a.x, p0y = a.y, p0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv = 1.0f / (fabsf(det) >= TRI_EPS ? det : 1.0f);
  const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (dx * qvx + dy * qvy + dz * qvz) * inv;
}

template <bool kSmooth, int kStack>
__global__ void __launch_bounds__(BVH64_BLOCK_MAX)
bvh_shaded_kernel(const float4* __restrict__ nodes64, int root_count,
                  const float4* __restrict__ prims_f, const int* __restrict__ prims_i,
                  const float* __restrict__ shade_f, const float* __restrict__ o,
                  const float* __restrict__ d, const float* __restrict__ t_max,
                  float* __restrict__ t_out, int* __restrict__ idx_out,
                  int* __restrict__ mat_out, int* __restrict__ al_out,
                  float* __restrict__ attrs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // the ray's loads issued together, ahead of the test of t_max
  const float tm = __ldg(t_max + i);
  const float ox = __ldg(o + 3 * i), oy = __ldg(o + 3 * i + 1), oz = __ldg(o + 3 * i + 2);
  const float dx = __ldg(d + 3 * i), dy = __ldg(d + 3 * i + 1), dz = __ldg(d + 3 * i + 2);
  float t_bound = tm;
  int best = -1;
  if (tm > 0.0f) {
    const Bvh64<kStack, kShadedPrefetch<kSmooth, kStack>> geom{nodes64, prims_f, root_count};
    best = geom.template walk<false>(ox, oy, oz, dx, dy, dz, t_bound);
  }
  constexpr int kCols = kSmooth ? SHADE_COLS_SMOOTH : SHADE_COLS_FLAT;
  constexpr int kRows = kSmooth ? ATTR_ROWS_SMOOTH : ATTR_ROWS;
  float a[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) a[k] = 0.0f;
  int idx = -1, mat = -1, al = -1;
  if (best >= 0) {
    float u, v;
    mt_uv(prims_f + 3 * (size_t)best, ox, oy, oz, dx, dy, dz, u, v);
    const float* s = shade_f + (size_t)kCols * best;
    const float w = 1.0f - u - v;
    a[0] = u;
    a[1] = v;
    a[2] = __ldg(s + 0) * w + __ldg(s + 2) * u + __ldg(s + 4) * v;
    a[3] = __ldg(s + 1) * w + __ldg(s + 3) * u + __ldg(s + 5) * v;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[4 + c] = __ldg(s + 12 + c);   // ns = ng on flat rows
      a[7 + c] = __ldg(s + 12 + c);   // ng
      a[10 + c] = __ldg(s + 6 + c);   // dpdu
      a[13 + c] = __ldg(s + 9 + c);   // dpdv
    }
    if constexpr (kSmooth) {
      const float nx = __ldg(s + 15) * w + __ldg(s + 18) * u + __ldg(s + 21) * v;
      const float ny = __ldg(s + 16) * w + __ldg(s + 19) * u + __ldg(s + 22) * v;
      const float nz = __ldg(s + 17) * w + __ldg(s + 20) * u + __ldg(s + 23) * v;
      const float len2 = nx * nx + ny * ny + nz * nz;
      if (__ldg(s + 30) != 0.0f && len2 > 0.0f) {
        const float rinv = 1.0f / sqrtf(fmaxf(len2, 1e-30f));
        a[4] = nx * rinv;
        a[5] = ny * rinv;
        a[6] = nz * rinv;
      }
      if (a[7] * a[4] + a[8] * a[5] + a[9] * a[6] < 0.0f) {  // ng faced onto ns
        a[7] = -a[7];
        a[8] = -a[8];
        a[9] = -a[9];
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) a[16 + c] = __ldg(s + 24 + c);  // dndu, dndv
    }
    const int4 pi = __ldg(reinterpret_cast<const int4*>(prims_i) + best);
    idx = pi.x;
    mat = pi.y;
    al = pi.z;
  }
  t_out[i] = best >= 0 ? t_bound : tm;
  idx_out[i] = idx;
  mat_out[i] = mat;
  al_out[i] = al;
#pragma unroll
  for (int k = 0; k < kRows; ++k) attrs[(size_t)k * n + i] = a[k];
}

template <int kStack>
void launch_walk(int any_hit, int grid, cudaStream_t st, const float* nodes_f,
                 const int* nodes_i, const float* prims_f, const int* prims_i, int n_prims,
                 const float* o, const float* d, const float* t_max, float* t_out, int* idx_out,
                 int n) {
  if (any_hit) {
    bvh_kernel<true, kStack><<<grid, BLOCK, 0, st>>>(nodes_f, nodes_i, prims_f, prims_i,
                                                    n_prims, o, d, t_max, t_out, idx_out, n);
  } else {
    bvh_kernel<false, kStack><<<grid, BLOCK, 0, st>>>(nodes_f, nodes_i, prims_f, prims_i,
                                                     n_prims, o, d, t_max, t_out, idx_out, n);
  }
}

template <int kStack>
void launch_walk4(int any_hit, int grid, cudaStream_t st, const float* nodes4_f,
                  const int* nodes4_i, const float* prims_f, const int* prims_i, int n_prims,
                  const float* o, const float* d, const float* t_max, float* t_out, int* idx_out,
                  int n) {
  if (any_hit) {
    bvh4_kernel<true, kStack><<<grid, BLOCK, 0, st>>>(nodes4_f, nodes4_i, prims_f, prims_i,
                                                     n_prims, o, d, t_max, t_out, idx_out, n);
  } else {
    bvh4_kernel<false, kStack><<<grid, BLOCK, 0, st>>>(nodes4_f, nodes4_i, prims_f, prims_i,
                                                      n_prims, o, d, t_max, t_out, idx_out, n);
  }
}

// The last bvh64_kernel launch's block size, blocks resident per SM,
// registers per thread and dynamic shared memory (none)
int g_occupancy64[4] = {0, 0, 0, 0};

// One bvh64_kernel launch, its block size chosen by occupancy
template <bool kAny, int kStack>
int launch64(cudaStream_t st, const float4* nodes64, int root_count, const float4* prims_f,
             const int* prims_i, const float* o, const float* d, const float* t_max,
             float* t_out, int* idx_out, int n) {
  const auto kernel = bvh64_kernel<kAny, kStack>;
  int block = BLOCK;
  const cudaError_t err = choose_block(kernel, BVH64_BLOCK_MAX, [](int) { return (size_t)0; },
                                       block, g_occupancy64);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + block - 1) / block, block, 0, st>>>(nodes64, root_count, prims_f, prims_i, o, d,
                                                   t_max, t_out, idx_out, n);
  return (int)cudaGetLastError();
}

template <bool kAny>
int launch64_stack(int deep, cudaStream_t st, const float4* nodes64, int root_count,
                   const float4* prims_f, const int* prims_i, const float* o, const float* d,
                   const float* t_max, float* t_out, int* idx_out, int n) {
  return deep ? launch64<kAny, DEEP_STACK>(st, nodes64, root_count, prims_f, prims_i, o, d,
                                           t_max, t_out, idx_out, n)
              : launch64<kAny, STACK_DEPTH>(st, nodes64, root_count, prims_f, prims_i, o, d,
                                            t_max, t_out, idx_out, n);
}

// A shaded query's arguments
struct ShadedArgs {
  const float4* nodes64;
  int root_count;
  const float4* prims_f;
  const int* prims_i;
  const float* shade_f;
  const float *o, *d, *t_max;
  float* t_out;
  int *idx_out, *mat_out, *al_out;
  float* attrs;
  int n;
};

// The last bvh_shaded_kernel launch's block size, blocks resident per SM,
// registers per thread and dynamic shared memory (none)
int g_occupancy_shaded[4] = {0, 0, 0, 0};

// One bvh_shaded_kernel launch, its block size chosen by occupancy
template <bool kSmooth, int kStack>
int launch_shaded(cudaStream_t st, const ShadedArgs& a) {
  const auto kernel = bvh_shaded_kernel<kSmooth, kStack>;
  int block = BLOCK;
  const cudaError_t err = choose_block(kernel, BVH64_BLOCK_MAX, [](int) { return (size_t)0; },
                                       block, g_occupancy_shaded);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(a.n + block - 1) / block, block, 0, st>>>(
      a.nodes64, a.root_count, a.prims_f, a.prims_i, a.shade_f, a.o, a.d, a.t_max, a.t_out,
      a.idx_out, a.mat_out, a.al_out, a.attrs, a.n);
  return (int)cudaGetLastError();
}

template <bool kSmooth>
int launch_shaded_stack(int deep, cudaStream_t st, const ShadedArgs& a) {
  return deep ? launch_shaded<kSmooth, DEEP_STACK>(st, a)
              : launch_shaded<kSmooth, STACK_DEPTH>(st, a);
}

}  // namespace

extern "C" {

// Launch the closest-hit (any_hit 0) or any-hit (1) walk over n rays on
// `stream`, the deep instance (a DEEP_STACK stack) when `deep`.  Returns
// cudaGetLastError() of the launch (0 when it was accepted); nothing is
// synchronised.
int bvh_launch(int any_hit, int deep, const float* nodes_f, const int* nodes_i,
               const float* prims_f, const int* prims_i, int n_prims, const float* o,
               const float* d, const float* t_max, float* t_out, int* idx_out, int n,
               void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (n <= 0) return 0;
  if (n_prims <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (n + BLOCK - 1) / BLOCK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (deep)
    launch_walk<DEEP_STACK>(any_hit, grid, st, nodes_f, nodes_i, prims_f, prims_i, n_prims, o,
                            d, t_max, t_out, idx_out, n);
  else
    launch_walk<STACK_DEPTH>(any_hit, grid, st, nodes_f, nodes_i, prims_f, prims_i, n_prims, o,
                             d, t_max, t_out, idx_out, n);
  return (int)cudaGetLastError();
}

// Launch the BVH4 closest-hit (any_hit 0) or any-hit (1) walk over n rays,
// the deep instance when `deep`; nodes4_f (W, 24) and nodes4_i (W, 12) as
// accel/bvh.pack_bvh4_tables packs them.  Returns as bvh_launch.
int bvh4_launch(int any_hit, int deep, const float* nodes4_f, const int* nodes4_i,
                const float* prims_f, const int* prims_i, int n_prims, const float* o,
                const float* d, const float* t_max, float* t_out, int* idx_out, int n,
                void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  if (n_prims <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (n + BLOCK - 1) / BLOCK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (deep)
    launch_walk4<DEEP_STACK>(any_hit, grid, st, nodes4_f, nodes4_i, prims_f, prims_i, n_prims, o,
                             d, t_max, t_out, idx_out, n);
  else
    launch_walk4<STACK_DEPTH>(any_hit, grid, st, nodes4_f, nodes4_i, prims_f, prims_i, n_prims,
                              o, d, t_max, t_out, idx_out, n);
  return (int)cudaGetLastError();
}

// Launch the shaded closest-hit walk over the node64 rows nodes64 (I, 16),
// root at row 0 (I = 0: the tree is one leaf of all n_prims rows), and the
// (n_prims, 12) leaf rows; with `smooth` the smooth instance on (n_prims,
// 31) shade rows (flat: (n_prims, 15)), with `deep` the deep one.  attrs is
// (16, n): u, v, uv, ns, ng, dpdu, dpdv, or (22, n) smooth: ..., dndu,
// dndv.  Returns as bvh_launch.
int bvh_shaded_launch(int deep, const float* nodes64, int n_nodes, const float* prims_f,
                      const int* prims_i, const float* shade_f, int smooth, int n_prims,
                      const float* o, const float* d, const float* t_max, float* t_out,
                      int* idx_out, int* mat_out, int* al_out, float* attrs, int n,
                      void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  if (n_prims <= 0 || n_nodes < 0 || (n_nodes > 0 && nodes64 == nullptr) ||
      (n_nodes == 0 && n_prims >= 1 << LEAF_COUNT_BITS))
    return (int)cudaErrorInvalidValue;
  const ShadedArgs a{reinterpret_cast<const float4*>(nodes64), n_nodes > 0 ? 0 : n_prims,
                     reinterpret_cast<const float4*>(prims_f), prims_i, shade_f, o, d, t_max,
                     t_out, idx_out, mat_out, al_out, attrs, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return smooth ? launch_shaded_stack<true>(deep, st, a) : launch_shaded_stack<false>(deep, st, a);
}

// The last bvh_shaded_launch's block size, blocks per SM, registers per
// thread and dynamic shared memory bytes, into out[0..3]
void bvh_shaded_occupancy(int* out) {
  for (int k = 0; k < 4; ++k) out[k] = g_occupancy_shaded[k];
}

// Launch the node64 walk, closest hit (any_hit 0) or any hit (1), over n
// rays: nodes64 the (I, 16) node64 rows, root at row 0 (I = 0: the tree is
// one leaf of all n_prims rows), the deep instance (a DEEP_STACK stack) when
// `deep`.  Returns as bvh_launch.
int bvh64_launch(int any_hit, int deep, const float* nodes64, int n_nodes, const float* prims_f,
                 const int* prims_i, int n_prims, const float* o, const float* d,
                 const float* t_max, float* t_out, int* idx_out, int n, void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  if (n_prims <= 0 || n_nodes < 0 || (n_nodes > 0 && nodes64 == nullptr) ||
      (n_nodes == 0 && n_prims >= 1 << LEAF_COUNT_BITS))
    return (int)cudaErrorInvalidValue;
  const int root_count = n_nodes > 0 ? 0 : n_prims;
  const auto* nodes = reinterpret_cast<const float4*>(nodes64);
  const auto* prims = reinterpret_cast<const float4*>(prims_f);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return any_hit ? launch64_stack<true>(deep, st, nodes, root_count, prims, prims_i, o, d, t_max,
                                        t_out, idx_out, n)
                 : launch64_stack<false>(deep, st, nodes, root_count, prims, prims_i, o, d, t_max,
                                         t_out, idx_out, n);
}

// The last bvh64_launch's block size, blocks per SM, registers per thread
// and dynamic shared memory bytes, into out[0..3]
void bvh64_occupancy(int* out) {
  for (int k = 0; k < 4; ++k) out[k] = g_occupancy64[k];
}

const char* bvh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bvh_deep_stack() { return DEEP_STACK; }

}  // extern "C"
