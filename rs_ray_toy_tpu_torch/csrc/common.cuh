// Device code shared by the kernels (path_megakernel.cu, direct_megakernel.cu,
// volpath_megakernel.cu and sppm_megakernel.cu): the parameter block, the
// counter-based sampler and the Halton slot-matrix reader, the RealisticCamera
// lens trace, Moller-Trumbore over
// the triangle table (brute force from shared memory, or a per-ray stack walk
// of the BVH from global memory), the lobe evaluations, sphere-light sampling
// and the MIS power heuristic.  Everything here follows the plain
// PyTorch versions (ops/*_megakernel.py) expression by expression; the
// kernels are built with --fmad=false so that no product is contracted into
// an FMA, and reciprocal square roots are 1.0f / sqrtf(x).

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int TABLE_COLS = 115;  // per-triangle table width (pack_scene)
constexpr int GEO_COLS = 9;      // p0, e1, e2
constexpr int TRI_MAX = 2048;    // brute force up to this many triangles
constexpr int BVH_TRI_MAX = 65536;
constexpr int STACK_DEPTH = 64;  // BVH traversal stack (ops/bvh_pallas.py)
constexpr int DEEP_STACK = 256;  // the stack of K3's deep instances (accel/bvh.DEEP_STACK)
constexpr int NODE_COLS = 16;    // fused-children node row: both child boxes
constexpr int LIGHT_MAX = 8;
constexpr int ELEM_MAX = 16;
constexpr int BIN_MAX = 64;

constexpr int LOBE_LAMBERT_REFL = 1;
constexpr int LOBE_SPEC_REFL = 4;
constexpr int LOBE_SPEC_TRANS = 5;
constexpr int LOBE_FRESNEL_SPEC = 6;
constexpr int LOBE_MF_REFL = 7;
constexpr int LOBE_DEBUG_DIFFUSE = 10;
constexpr int LOBE_DEBUG_SPECULAR = 11;
constexpr int LOBE_DISNEY_DIFFUSE = 12;
constexpr int LOBE_DISNEY_RETRO = 14;
constexpr int LOBE_DISNEY_SHEEN = 15;
constexpr int LOBE_DISNEY_CLEARCOAT = 16;
constexpr int LOBE_DISNEY_MICROFACET_REFL = 17;
constexpr int FRESNEL_DIELECTRIC = 1;
constexpr int FRESNEL_CONDUCTOR = 2;
constexpr int FRESNEL_DISNEY = 3;

constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = (float)(2.0 * 3.14159265358979323846);
constexpr float PI_OVER_2_F = (float)(3.14159265358979323846 / 2.0);
constexpr float PI_OVER_4_F = (float)(3.14159265358979323846 / 4.0);
constexpr float TRI_EPS = 1e-7f;
constexpr float BIG_T = 3.0e38f;
constexpr float U_TOP = (float)(1.0 - 1e-7);  // sampler clamp
constexpr float ONE_MINUS_EPSILON = 0.99999994f;
constexpr float SHADOW_T_MAX = (float)(1.0 - 1e-4);
constexpr float SLAB_SLOP = 1.0000004f;  // far-plane slop of the slab test

}  // namespace

// Must match ops/path_megakernel._Params field for field (all 4-byte fields).
struct Params {
  int max_depth;
  float rr_threshold;
  int spp, xs, ys, xs_shift, jitter;
  uint32_t seed;
  int n_lights;
  float light_p[LIGHT_MAX * 3];
  float light_emit[LIGHT_MAX * 3];
  int debug;                // direct kernel: Debug integrator (0.1 base)
  int strategy_all;         // direct kernel: sample every light
  int can_chain;            // direct kernel: a reflect child can exist
  int has_st;               // direct kernel: a transmit child can exist
  int n_elem;
  // per element, film side first; element_z, zc, radius^2, aperture^2, the
  // refraction ratio and its square are folded on the host in float64
  float elem_z[ELEM_MAX];
  float radius[ELEM_MAX];
  float zc[ELEM_MAX];
  float radius2[ELEM_MAX];
  float aperture2[ELEM_MAX];
  float eta[ELEM_MAX];
  float eta2[ELEM_MAX];
  int n_bins;
  float bounds[BIN_MAX * 4];
  float half_diag, xres, yres, extent_x, extent_y, rear_z, rear_z_sq, area0, shutter;
  int simple_weighting;
  float cam_to_world[12];
};

namespace {

// ---- counter-based sampler (core/rng.py, sampler/stratified.py) ----

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_combine(uint32_t a, uint32_t b) {
  return hash_u32(a ^ (b + 0x9E3779B9u + (a << 6) + (a >> 2)));
}

__device__ __forceinline__ uint32_t permute_pow2(uint32_t i, uint32_t n, uint32_t p) {
  const uint32_t w = n - 1;
  i ^= p;
  i *= 0xE170893Du;
  i ^= p >> 16;
  i ^= (i & w) >> 4;
  i ^= p >> 8;
  i *= 0x0929EB3Fu;
  i ^= p >> 23;
  i ^= (i & w) >> 1;
  i *= 1u | (p >> 27);
  i *= 0x6935FA69u;
  i ^= (i & w) >> 11;
  i *= 0x74DCCA23u;
  i ^= p >> 2;
  i *= 0x9E501CC3u;
  i ^= (i & w) >> 2;
  i *= 0xC860A3DFu;
  i &= w;
  i ^= i >> 5;
  return (i + p) & w;
}

__device__ __forceinline__ float uniform_float(uint32_t pid, uint32_t sid, uint32_t dim,
                                               uint32_t seed) {
  uint32_t h = hash_combine(pid, sid);
  h = hash_combine(h, dim);
  h = hash_combine(h, seed);
  return (float)(int32_t)(h >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

struct Sampler {
  uint32_t pid, sid;
  const Params* p;

  __device__ uint32_t stratum(uint32_t dim) const {
    uint32_t dk = dim * 2654435761u + p->seed;
    return permute_pow2(sid, (uint32_t)p->spp, hash_combine(pid, dk));
  }
  __device__ float get_1d(uint32_t dim) const {
    uint32_t s = stratum(dim);
    float j = p->jitter ? uniform_float(pid, sid, dim * 64u, p->seed) : 0.5f;
    return fminf(((float)(int32_t)s + j) / (float)p->spp, U_TOP);
  }
  __device__ void get_2d(uint32_t dim, float& u0, float& u1) const {
    uint32_t s = stratum(dim);
    float sx = (float)(int32_t)(s & (uint32_t)(p->xs - 1));
    float sy = (float)(int32_t)(s >> p->xs_shift);
    float jx = 0.5f, jy = 0.5f;
    if (p->jitter) {
      jx = uniform_float(pid, sid, dim * 64u + 1u, p->seed);
      jy = uniform_float(pid, sid, dim * 64u + 2u, p->seed);
    }
    u0 = fminf((sx + jx) / (float)p->xs, U_TOP);
    u1 = fminf((sy + jy) / (float)p->ys, U_TOP);
  }
};

// The Halton sampler's mode: every value is read from the (NC, n) slot matrix
// the host computed for the batch (HaltonSampler.slot_matrix), component-major
// so that a warp's reads of one row coalesce; row[slot] is the first row of
// the slot (ops/path_megakernel.used_slots), two rows for a 2D slot.  A slot
// the host did not list (row -1, a drift of used_slots from the kernel's reads)
// reads row 0 and marks the ray: its radiance is written NaN.
struct SlotSampler {
  const float* u;
  const short* row;  // slot -> row, in the __grid_constant__ parameter block
  int n, i;
  mutable bool unlisted = false;

  __device__ const float* at(uint32_t dim) const {
    const int r = row[dim];
    unlisted |= r < 0;
    return u + (size_t)max(r, 0) * n + i;
  }
  __device__ float get_1d(uint32_t dim) const { return __ldg(at(dim)); }
  __device__ void get_2d(uint32_t dim, float& u0, float& u1) const {
    const float* r = at(dim);
    u0 = __ldg(r);
    u1 = __ldg(r + n);
  }
};

__device__ __forceinline__ float rsqrt_exact(float x) { return 1.0f / sqrtf(x); }

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return ax * bx + ay * by + az * bz;
}

// ---- camera (ops/path_megakernel._raygen) ----

// The lens trace of one camera ray from its film (uf) and lens (ul) uniforms
__device__ void raygen_u(const Params& p, float uf0, float uf1, float ul0, float ul1, float px,
                         float py, float& ox_w, float& oy_w, float& oz_w, float& dx_w,
                         float& dy_w, float& dz_w, float& weight) {
  const float sx = (px + uf0) / p.xres;
  const float sy = (py + uf1) / p.yres;
  const float pfx = -((sx - 0.5f) * p.extent_x);
  const float pfy = (sy - 0.5f) * p.extent_y;

  // exit pupil sample (camera.rs:492-521)
  const float r_film = sqrtf(pfx * pfx + pfy * pfy);
  int r_idx = (int)(r_film / p.half_diag * (float)p.n_bins);
  r_idx = min(max(r_idx, 0), p.n_bins - 1);
  const float b0 = p.bounds[4 * r_idx + 0], b1 = p.bounds[4 * r_idx + 1];
  const float b2 = p.bounds[4 * r_idx + 2], b3 = p.bounds[4 * r_idx + 3];
  const float prx = b0 + ul0 * (b2 - b0);
  const float pry = b1 + ul1 * (b3 - b1);
  const float area = (b2 - b0) * (b3 - b1);
  const float safe_r = r_film == 0.0f ? 1.0f : r_film;
  const float sin_t = r_film != 0.0f ? pfy / safe_r : 0.0f;
  const float cos_t = r_film != 0.0f ? pfx / safe_r : 1.0f;
  const float rearx = cos_t * prx - sin_t * pry;
  const float reary = sin_t * prx + cos_t * pry;

  // dz's square is the host's float64 rear_z^2 until the first refraction
  // (the plain version keeps dz a python float until then)
  const float dx0 = rearx - pfx, dy0 = reary - pfy, dz0 = p.rear_z - 0.0f;
  const float dlen = sqrtf(fmaxf(dx0 * dx0 + dy0 * dy0 + p.rear_z_sq, 1e-30f));
  const float cos_theta = dz0 / dlen;
  const float c2 = cos_theta * cos_theta;
  const float cos4 = c2 * c2;

  // film-side trace through every element, lens space (z flipped)
  float ox = pfx, oy = pfy, oz = 0.0f;
  float dx = dx0, dy = dy0, dz = -dz0;
  bool alive = true;
  bool dz_host = true;
  for (int i = 0; i < p.n_elem; ++i) {
    const float ez = p.elem_z[i];
    const float radius = p.radius[i];
    const bool is_stop = radius == 0.0f;
    float t;
    bool ok;
    float zc = 0.0f;
    if (is_stop) {
      ok = dz < 0.0f;
      t = (ez - oz) / (ok ? dz : -1.0f);
    } else {
      zc = p.zc[i];
      const float ocx = ox, ocy = oy, ocz = oz - zc;
      const float a = dx * dx + dy * dy + (dz_host ? p.rear_z_sq : dz * dz);
      const float bq = 2.0f * (dx * ocx + dy * ocy + dz * ocz);
      const float cq = ocx * ocx + ocy * ocy + ocz * ocz - p.radius2[i];
      const float disc = bq * bq - 4.0f * a * cq;
      ok = disc >= 0.0f;
      const float root = sqrtf(fmaxf(disc, 0.0f));
      const float q = bq < 0.0f ? -0.5f * (bq - root) : -0.5f * (bq + root);
      const float t0 = q / a;
      const float t1 = cq / (q == 0.0f ? 1.0f : q);
      const float lo = fminf(t0, t1), hi = fmaxf(t0, t1);
      const bool use_closer = (dz > 0.0f) != (radius < 0.0f);
      t = use_closer ? lo : hi;
      ok = ok && (t >= 0.0f);
    }
    const float hx = ox + dx * t, hy = oy + dy * t, hz = oz + dz * t;
    const float r2 = hx * hx + hy * hy;
    ok = ok && (r2 < p.aperture2[i]);
    alive = alive && ok;
    if (alive) {
      ox = hx;
      oy = hy;
      oz = hz;
    }
    if (!is_stop) {
      const float pcx = ox, pcy = oy, pcz = oz - zc;
      const float ninv = rsqrt_exact(fmaxf(pcx * pcx + pcy * pcy + pcz * pcz, 1e-30f));
      float nx = pcx * ninv, ny = pcy * ninv, nz = pcz * ninv;
      if (nx * dx + ny * dy + nz * dz > 0.0f) {
        nx = -nx;
        ny = -ny;
        nz = -nz;
      }
      const float eta = p.eta[i];
      const float dinv =
          rsqrt_exact(fmaxf(dx * dx + dy * dy + (dz_host ? p.rear_z_sq : dz * dz), 1e-30f));
      dz_host = false;
      const float wix = -dx * dinv, wiy = -dy * dinv, wiz = -dz * dinv;
      const float cos_i = nx * wix + ny * wiy + nz * wiz;
      const float sin2_i = fmaxf(0.0f, 1.0f - cos_i * cos_i);
      const float sin2_t = p.eta2[i] * sin2_i;
      const bool rok = sin2_t < 1.0f;
      const float cos_tr = sqrtf(fmaxf(0.0f, 1.0f - sin2_t));
      const float fac = eta * cos_i - cos_tr;
      const float wtx = -wix * eta + nx * fac;
      const float wty = -wiy * eta + ny * fac;
      const float wtz = -wiz * eta + nz * fac;
      alive = alive && rok;
      if (alive) {
        dx = wtx;
        dy = wty;
        dz = wtz;
      }
    }
  }
  oz = -oz;  // lens -> camera space
  dz = -dz;

  const float* m = p.cam_to_world;
  ox_w = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
  oy_w = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
  oz_w = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
  float vx = m[0] * dx + m[1] * dy + m[2] * dz;
  float vy = m[4] * dx + m[5] * dy + m[6] * dz;
  float vz = m[8] * dx + m[9] * dy + m[10] * dz;
  const float vinv = 1.0f / fmaxf(sqrtf(vx * vx + vy * vy + vz * vz), 1e-30f);
  dx_w = vx * vinv;
  dy_w = vy * vinv;
  dz_w = vz * vinv;
  if (p.simple_weighting) {
    weight = cos4 * area / p.area0;
  } else {
    weight = p.shutter * (cos4 * area);
  }
  if (!alive) weight = 0.0f;
}

// raygen_u with the film and lens uniforms of sampler slots 0 and 1
template <class Smp>
__device__ __forceinline__ void raygen(const Params& p, const Smp& smp, float px, float py,
                                       float& ox_w, float& oy_w, float& oz_w, float& dx_w,
                                       float& dy_w, float& dz_w, float& weight) {
  float uf0, uf1, ul0, ul1;
  smp.get_2d(0, uf0, uf1);
  smp.get_2d(1, ul0, ul1);
  raygen_u(p, uf0, uf1, ul0, ul1, px, py, ox_w, oy_w, oz_w, dx_w, dy_w, dz_w, weight);
}

// ---- geometry (ops/path_megakernel._closest_hit / _occluded / _bvh_*) ----

// Moller-Trumbore against the row g = (p0, e1, e2); true (and t) when the hit
// passes every test but the caller's t bound
__device__ __forceinline__ bool mt_hit(const float* g, float ox, float oy, float oz, float dx,
                                       float dy, float dz, float& t) {
  const float p0x = g[0], p0y = g[1], p0z = g[2];
  const float e1x = g[3], e1y = g[4], e1z = g[5];
  const float e2x = g[6], e2y = g[7], e2z = g[8];
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok = fabsf(det) >= TRI_EPS;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (dx * qvx + dy * qvy + dz * qvz) * inv;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  return ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t >= TRI_EPS;
}

__device__ __forceinline__ float inv_dir(float d) {
  const float tiny = d < 0.0f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(d) < 1e-20f ? tiny : d);
}

// Slab test of the box at b[0:6] = (min xyz, max xyz) with the traversal's
// t bound (ops/bvh_pallas._slab6)
__device__ __forceinline__ bool slab_hit(const float* b, float ox, float oy, float oz,
                                         float ix, float iy, float iz, float t_cur) {
  const float t0x = (__ldg(b + 0) - ox) * ix, t1x = (__ldg(b + 3) - ox) * ix;
  const float t0y = (__ldg(b + 1) - oy) * iy, t1y = (__ldg(b + 4) - oy) * iy;
  const float t0z = (__ldg(b + 2) - oz) * iz, t1z = (__ldg(b + 5) - oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tf =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)) * SLAB_SLOP;
  return tn <= tf && tf > 0.0f && tn < t_cur && t_cur > 0.0f;
}

// The whole triangle table, one of two ways.  Brute force (kBvh false): the
// intersect columns of every triangle, staged per block in shared memory,
// tested in table order with strict < (ties keep the lower row).  BVH (kBvh
// true): a per-ray stack walk of the fused-children node rows in global
// memory; at an interior node both children's boxes are slab-tested against
// the current best hit and only hit children are pushed, the near child (by
// the sign of this ray's direction on the split axis) last, so it is popped
// first; a leaf tests its triangles in table order with strict <.  Both
// return the winning row of `table` (-1 on a miss).  kCols is the table's
// row width: the packed scene's TABLE_COLS, or the wavefront kernels' 12
// (p0, e1, e2, pad); kStack the walk's stack, which holds a tree of fewer
// than kStack levels (STACK_DEPTH, or DEEP_STACK in K3's deep instances).
template <bool kBvh, int kCols = TABLE_COLS, int kStack = STACK_DEPTH>
struct Geometry {
  const float* s_geo;    // brute force: GEO_COLS per triangle, shared memory
  int n_tris;
  const float* table;    // (T, kCols), BVH leaf order in BVH mode
  const float* nodes_f;  // (M, NODE_COLS): left child box, right child box
  const int* nodes_i;    // (M, 4): offset, n_prims, axis, 0

  __device__ bool tri_hit(int j, float ox, float oy, float oz, float dx, float dy, float dz,
                          float& t) const {
    if constexpr (kBvh) {
      float g[GEO_COLS];
      const float* row = table + (size_t)j * kCols;
#pragma unroll
      for (int c = 0; c < GEO_COLS; ++c) g[c] = __ldg(row + c);
      return mt_hit(g, ox, oy, oz, dx, dy, dz, t);
    } else {
      return mt_hit(s_geo + j * GEO_COLS, ox, oy, oz, dx, dy, dz, t);
    }
  }

  // any_hit: stop at the first hit with t < t_bound (shadow rays)
  template <bool kAny>
  __device__ int walk(float ox, float oy, float oz, float dx, float dy, float dz,
                      float& t_bound) const {
    int best = -1;
    if constexpr (!kBvh) {
      for (int j = 0; j < n_tris; ++j) {
        float t;
        if (tri_hit(j, ox, oy, oz, dx, dy, dz, t) && t < t_bound) {
          best = j;
          if constexpr (kAny) return best;
          t_bound = t;
        }
      }
    } else {
      const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
      int stack[kStack];
      int sp = 0;
      stack[sp++] = 0;
      while (sp > 0) {
        const int node = stack[--sp];
        const int4 ni = __ldg(reinterpret_cast<const int4*>(nodes_i) + node);
        if (ni.y > 0) {
          for (int k = 0; k < ni.y; ++k) {
            float t;
            if (tri_hit(ni.x + k, ox, oy, oz, dx, dy, dz, t) && t < t_bound) {
              best = ni.x + k;
              if constexpr (kAny) return best;
              t_bound = t;
            }
          }
        } else {
          const float* row = nodes_f + (size_t)node * NODE_COLS;
          const bool hit_l = slab_hit(row, ox, oy, oz, ix, iy, iz, t_bound);
          const bool hit_r = slab_hit(row + 6, ox, oy, oz, ix, iy, iz, t_bound);
          const float d_ax = ni.z == 0 ? dx : (ni.z == 1 ? dy : dz);
          const int left = node + 1, right = ni.x;
          if (d_ax >= 0.0f) {  // left is near: push right first
            if (hit_r) stack[sp++] = right;
            if (hit_l) stack[sp++] = left;
          } else {
            if (hit_l) stack[sp++] = left;
            if (hit_r) stack[sp++] = right;
          }
        }
      }
    }
    return best;
  }

  // the closest hit with t < t_lim (the walk's bound from the start): t_best
  // = t_lim and -1 on a miss
  __device__ int closest_below(float ox, float oy, float oz, float dx, float dy, float dz,
                               float t_lim, float& t_best) const {
    t_best = t_lim;
    return walk<false>(ox, oy, oz, dx, dy, dz, t_best);
  }
  __device__ int closest(float ox, float oy, float oz, float dx, float dy, float dz,
                         float& t_best) const {
    return closest_below(ox, oy, oz, dx, dy, dz, BIG_T, t_best);
  }
  // t in [TRI_EPS, t_max) along the caller's unnormalised direction
  __device__ bool occluded(float ox, float oy, float oz, float dx, float dy, float dz,
                           float t_max) const {
    return walk<true>(ox, oy, oz, dx, dy, dz, t_max) >= 0;
  }
};

// ---- the brute-force walk with chunk culling (K1's brute-force instances, K4) ----
//
// The rows are grouped into chunks of consecutive rows, each under a padded
// box (ops/path_megakernel.build_tri_chunks, the JAX package's
// _build_tri_chunks without its 256-row and 24-chunk limits).  The walk
// visits the chunks in table order, slab-tests each box against the ray's
// current bound and runs the chunk's rows only when the box is hit; every
// row first meets a division-free reject, and mt_hit decides the rest.  The
// cull and the reject are conservative, so the winner and its t are
// Geometry<false>'s, bit for bit: a box holds its triangles with a margin of
// 1e-3 + 1e-4 max|coordinate|, and the box's t bound carries a relative slack
// of 2^-7 besides, for mt_hit's t, which near |det| = TRI_EPS can fall short
// of the distance to the plane by more than the margin.

// CHUNK_MAX bounds the chunk rows' shared memory: build_tri_chunks closes a
// chunk at 16 rows, or after 4 rows where its box's surface area would more
// than double, so every chunk but the last holds at least 4 rows and a table
// of TRI_MAX rows makes at most TRI_MAX / 4 chunks, 16 KB beside the rows'
// 72 KB.
constexpr int CHUNK_MAX = TRI_MAX / 4;
constexpr int CHUNK_COLS = 8;             // bmin xyz, bmax xyz, first row, end row
constexpr float CULL_SLOP = 1.0078125f;   // 1 + 2^-7 on a chunk box's t bound
constexpr float REJECT_SLOP = 1.0000153f; // 1 + 2^-16 (0x1.0001p0)
constexpr float REJECT_TINY = 0x1p-100f;  // |det| times this stays normal
constexpr float TRI_EPS_LO = 9.9998e-8f;  // TRI_EPS less 2e-5 of it

// The slab test of a chunk's box b0 = (min x, y, z, max x), b1 = (max y, z,
// first row, end row) against the segment [0, t_bound (1 + 2^-7)] (the JAX
// package's _chunk_box_hit with the slack); i* from inv_dir.
__device__ __forceinline__ bool chunk_hit(float4 b0, float4 b1, float ox, float oy, float oz,
                                          float ix, float iy, float iz, float t_bound) {
  const float t0x = (b0.x - ox) * ix, t1x = (b0.w - ox) * ix;
  const float t0y = (b0.y - oy) * iy, t1y = (b1.x - oy) * iy;
  const float t0z = (b0.z - oz) * iz, t1z = (b1.y - oz) * iz;
  const float tlo = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float thi = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return tlo <= fminf(thi, t_bound * CULL_SLOP) && thi >= 0.0f;
}

// The division-free early reject before mt_hit: true only where mt_hit
// returns false or a t >= t_bound.  det and the u, v and t numerators are
// mt_hit's expressions (the survivor's mt_hit reuses them); flipped by det's
// sign they give u = U * (1 / |det|) exactly, so U < -|det| 2^-100 is u < 0
// past any underflow to -0.0 (which u >= 0 accepts), U > |det| (1 + 2^-16)
// is u > 1 past the reciprocal's and the products' roundings, and so on for
// v, u + v and t in [TRI_EPS, t_bound).  A NaN compares false: mt_hit decides.
__device__ __forceinline__ bool mt_reject(const float* g, float ox, float oy, float oz,
                                          float dx, float dy, float dz, float t_bound) {
  const float p0x = g[0], p0y = g[1], p0z = g[2];
  const float e1x = g[3], e1y = g[4], e1z = g[5];
  const float e2x = g[6], e2y = g[7], e2z = g[8];
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float a = fabsf(det);
  if (!(a >= TRI_EPS)) return true;
  const bool neg = det < 0.0f;
  const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
  const float un = tvx * pvx + tvy * pvy + tvz * pvz;
  const float su = neg ? -un : un;
  const float tiny = a * REJECT_TINY, top = a * REJECT_SLOP;
  if (su < -tiny || su > top) return true;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float vn = dx * qvx + dy * qvy + dz * qvz;
  const float sv = neg ? -vn : vn;
  if (sv < -tiny || su + sv > top) return true;
  const float tn = e2x * qvx + e2y * qvy + e2z * qvz;
  const float st = neg ? -tn : tn;
  return st < a * TRI_EPS_LO || st > a * t_bound * REJECT_SLOP;
}

// The chunked brute-force walk over rows and chunk boxes staged in shared
// memory (load_chunk_geometry), with Geometry's interface: table is the
// packed scene's (T, TABLE_COLS) table (null in K4).
struct ChunkGeometry {
  const float* s_geo;   // GEO_COLS per row
  const float4* s_box;  // CHUNK_COLS / 4 float4 per chunk
  int n_chunks;
  const float* table;

  // any_hit: stop at the first hit with t < t_bound (shadow rays)
  template <bool kAny>
  __device__ int walk(float ox, float oy, float oz, float dx, float dy, float dz,
                      float& t_bound) const {
    const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
    int best = -1;
    for (int c = 0; c < n_chunks; ++c) {
      const float4 b0 = s_box[2 * c], b1 = s_box[2 * c + 1];
      if (!chunk_hit(b0, b1, ox, oy, oz, ix, iy, iz, t_bound)) continue;
      const int end = (int)b1.w;
      for (int j = (int)b1.z; j < end; ++j) {
        const float* g = s_geo + j * GEO_COLS;
        float t;
        if (!mt_reject(g, ox, oy, oz, dx, dy, dz, t_bound) &&
            mt_hit(g, ox, oy, oz, dx, dy, dz, t) && t < t_bound) {
          best = j;
          if constexpr (kAny) return best;
          t_bound = t;
        }
      }
    }
    return best;
  }

  __device__ int closest_below(float ox, float oy, float oz, float dx, float dy, float dz,
                               float t_lim, float& t_best) const {
    t_best = t_lim;
    return walk<false>(ox, oy, oz, dx, dy, dz, t_best);
  }
  __device__ int closest(float ox, float oy, float oz, float dx, float dy, float dz,
                         float& t_best) const {
    return closest_below(ox, oy, oz, dx, dy, dz, BIG_T, t_best);
  }
  __device__ bool occluded(float ox, float oy, float oz, float dx, float dy, float dz,
                           float t_max) const {
    return walk<true>(ox, oy, oz, dx, dy, dz, t_max) >= 0;
  }
};

// Kernel prologue of the chunked walk: the chunk rows, then the rows'
// intersect columns (of a table kCols wide), staged in the dynamic shared
// memory s_dyn, n_chunks * CHUNK_COLS + n_tris * GEO_COLS floats; the whole
// block syncs once.
template <int kCols>
__device__ ChunkGeometry load_chunk_geometry(float4* s_dyn, const float* table, int n_tris,
                                             const float* chunks, int n_chunks) {
  float* s_box = reinterpret_cast<float*>(s_dyn);
  for (int k = threadIdx.x; k < n_chunks * CHUNK_COLS; k += blockDim.x)
    s_box[k] = __ldg(chunks + k);
  float* s_geo = s_box + n_chunks * CHUNK_COLS;
  for (int k = threadIdx.x; k < n_tris * GEO_COLS; k += blockDim.x)
    s_geo[k] = __ldg(table + (k / GEO_COLS) * kCols + k % GEO_COLS);
  __syncthreads();
  return ChunkGeometry{s_geo, s_dyn, n_chunks, table};
}

// The chunked walk's dynamic shared memory
__host__ __device__ constexpr size_t chunk_smem(int n_tris, int n_chunks) {
  return ((size_t)n_chunks * CHUNK_COLS + (size_t)n_tris * GEO_COLS) * sizeof(float);
}

// ---- K3's binary walk for Hopper: one 64-byte fetch per interior node ----
//
// The node64 rows (accel/bvh.pack_node64_tables), one per interior node: both
// children's boxes (the fused-children row's 12 floats, the same values) and,
// as int bits, both children's references, the split axis and both children's
// leaf counts, read as four float4.  A reference >= 0 is an interior row; a
// leaf's is -1 - its first leaf-order row, its count in col 15 (left | right
// << LEAF_COUNT_BITS), so a leaf is known at its parent and never fetched as
// a node.  The walk goes straight into the near hit child (by the sign of the
// ray's direction on the split axis) and pushes the far one only where both
// are hit; a leaf or a row with no child hit pops.  Geometry<true> visits in
// the same order (it pushes the far hit child, then the near one, and pops the
// near one at once), so the winner, its t and an any-hit walk's row are
// Geometry<true>'s.  Each leaf row, 48 bytes in leaf order, is read as three
// float4, the next row's loads issued before it is tested, and meets the
// division-free mt_reject before mt_hit, which leaves the answer as it is.
// The stack, a per-thread array of kStack entries, holds the far children
// still to visit (reference and leaf count): at most one an interior level
// above the current node.  kPrefetch false loads each leaf row when it is
// tested (the direct and Volpath kernels' BVH instances, under their
// 56-register cap, run faster so: PERF.md §6).
constexpr int LEAF_COUNT_BITS = 8;

// slab_hit on the box (x0, y0, z0) - (x1, y1, z1), expression for expression
__device__ __forceinline__ bool slab6_hit(float x0, float y0, float z0, float x1, float y1,
                                          float z1, float ox, float oy, float oz, float ix,
                                          float iy, float iz, float t_cur) {
  const float t0x = (x0 - ox) * ix, t1x = (x1 - ox) * ix;
  const float t0y = (y0 - oy) * iy, t1y = (y1 - oy) * iy;
  const float t0z = (z0 - oz) * iz, t1z = (z1 - oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tf =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)) * SLAB_SLOP;
  return tn <= tf && tf > 0.0f && tn < t_cur && t_cur > 0.0f;
}

template <int kStack, bool kPrefetch = true>
struct Bvh64 {
  const float4* nodes;  // (I, 4) float4: the node64 rows
  const float4* prims;  // (P, 3) float4: p0, e1, e2, pad in leaf order
  int root_count;       // 0: the root is row 0; else a leaf of rows [0, root_count)

  // any_hit: stop at the first hit with t < t_bound (shadow rays)
  template <bool kAny>
  __device__ int walk(float ox, float oy, float oz, float dx, float dy, float dz,
                      float& t_bound) const {
    const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
    int2 stack[kStack];  // (reference, leaf count)
    int sp = 0;
    int best = -1;
    int ref = root_count > 0 ? -1 : 0, count = root_count;
    while (true) {
      if (ref >= 0) {
        const float4* row = nodes + 4 * (size_t)ref;
        const float4 b0 = __ldg(row), b1 = __ldg(row + 1), b2 = __ldg(row + 2);
        const float4 b3 = __ldg(row + 3);
        const bool hit_l =
            slab6_hit(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, ox, oy, oz, ix, iy, iz, t_bound);
        const bool hit_r =
            slab6_hit(b1.z, b1.w, b2.x, b2.y, b2.z, b2.w, ox, oy, oz, ix, iy, iz, t_bound);
        const int axis = __float_as_int(b3.z), counts = __float_as_int(b3.w);
        const float d_ax = axis == 0 ? dx : (axis == 1 ? dy : dz);
        const bool left_near = d_ax >= 0.0f;
        const int left = __float_as_int(b3.x), right = __float_as_int(b3.y);
        const int n_left = counts & ((1 << LEAF_COUNT_BITS) - 1);
        const int n_right = counts >> LEAF_COUNT_BITS;
        const int near = left_near ? left : right, far = left_near ? right : left;
        const int n_near = left_near ? n_left : n_right, n_far = left_near ? n_right : n_left;
        const bool hit_near = left_near ? hit_l : hit_r;
        const bool hit_far = left_near ? hit_r : hit_l;
        if (hit_near) {
          if (hit_far) stack[sp++] = make_int2(far, n_far);
          ref = near, count = n_near;
          continue;
        }
        if (hit_far) {
          ref = far, count = n_far;
          continue;
        }
      } else {
        const int first = -1 - ref;
        const int end = first + count;
        if constexpr (kPrefetch) {
          // each row's loads are issued before the row ahead of it is tested
          const float4* row = prims + 3 * (size_t)first;
          float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
          for (int j = first; j < end; ++j) {
            float4 na = a, nb = b, nc = c;
            if (j + 1 < end) {
              row += 3;
              na = __ldg(row), nb = __ldg(row + 1), nc = __ldg(row + 2);
            }
            const float g[GEO_COLS] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
            float t;
            if (!mt_reject(g, ox, oy, oz, dx, dy, dz, t_bound) &&
                mt_hit(g, ox, oy, oz, dx, dy, dz, t) && t < t_bound) {
              best = j;
              if constexpr (kAny) return best;
              t_bound = t;
            }
            a = na, b = nb, c = nc;
          }
        } else {
          for (int j = first; j < end; ++j) {
            const float4* row = prims + 3 * (size_t)j;
            const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
            const float g[GEO_COLS] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
            float t;
            if (!mt_reject(g, ox, oy, oz, dx, dy, dz, t_bound) &&
                mt_hit(g, ox, oy, oz, dx, dy, dz, t) && t < t_bound) {
              best = j;
              if constexpr (kAny) return best;
              t_bound = t;
            }
          }
        }
      }
      if (sp == 0) break;
      const int2 top = stack[--sp];
      ref = top.x, count = top.y;
    }
    return best;
  }
};

// A Bvh64's walk as a call: one copy of its code for every call site
template <bool kAny, class Walk>
__device__ __noinline__ int bvh64_walk_call(const Walk bvh, float ox, float oy, float oz,
                                            float dx, float dy, float dz, float& t_bound) {
  return bvh.template walk<kAny>(ox, oy, oz, dx, dy, dz, t_bound);
}

// Bvh64 with Geometry's interface (the BVH instances of the path, direct and
// Volpath kernels): the walk over the node64 rows and the 48-byte leaf rows
// (Walk, a Bvh64 of kStack entries), and `table`, the packed scene's (T,
// TABLE_COLS) rows in the same leaf order, where shading reads the winner's
// row.  kCall: the walk is called out of line (bvh64_walk_call) instead of
// inlined at each call site.
template <int kStack, bool kCall = false, class Walk = Bvh64<kStack>>
struct Bvh64Geometry {
  Walk bvh;
  const float* table;

  template <bool kAny>
  __device__ int walk(float ox, float oy, float oz, float dx, float dy, float dz,
                      float& t_bound) const {
    if constexpr (kCall)
      return bvh64_walk_call<kAny>(bvh, ox, oy, oz, dx, dy, dz, t_bound);
    else
      return bvh.template walk<kAny>(ox, oy, oz, dx, dy, dz, t_bound);
  }
  __device__ int closest_below(float ox, float oy, float oz, float dx, float dy, float dz,
                               float t_lim, float& t_best) const {
    t_best = t_lim;
    return walk<false>(ox, oy, oz, dx, dy, dz, t_best);
  }
  __device__ int closest(float ox, float oy, float oz, float dx, float dy, float dz,
                         float& t_best) const {
    return closest_below(ox, oy, oz, dx, dy, dz, BIG_T, t_best);
  }
  __device__ bool occluded(float ox, float oy, float oz, float dx, float dy, float dz,
                           float t_max) const {
    return walk<true>(ox, oy, oz, dx, dy, dz, t_max) >= 0;
  }
};

// The shading normal of a smooth mesh at a triangle hit (accel/geometry.py
// surface_interaction): the barycentrics rebuilt from the winner's row (p0,
// e1, e2 in cols 0-8) with its guards, the raw vertex normals n0, n1, n2 (cols
// nrm_col..nrm_col+8) interpolated and normalised; ng where they sum to zero.
__device__ void smooth_normal(const float* row, int nrm_col, float ox, float oy, float oz,
                              float dx, float dy, float dz, float ngx, float ngy, float ngz,
                              float& nsx, float& nsy, float& nsz) {
  const float p0x = __ldg(row + 0), p0y = __ldg(row + 1), p0z = __ldg(row + 2);
  const float e1x = __ldg(row + 3), e1y = __ldg(row + 4), e1z = __ldg(row + 5);
  const float e2x = __ldg(row + 6), e2y = __ldg(row + 7), e2z = __ldg(row + 8);
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv = 1.0f / (fabsf(det) < TRI_EPS ? 1.0f : det);
  const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
  const float b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float b2 = (dx * qvx + dy * qvy + dz * qvz) * inv;
  const float b0 = 1.0f - b1 - b2;
  const float* nv = row + nrm_col;
  const float nx = b0 * __ldg(nv + 0) + b1 * __ldg(nv + 3) + b2 * __ldg(nv + 6);
  const float ny = b0 * __ldg(nv + 1) + b1 * __ldg(nv + 4) + b2 * __ldg(nv + 7);
  const float nz = b0 * __ldg(nv + 2) + b1 * __ldg(nv + 5) + b2 * __ldg(nv + 8);
  const float len2 = nx * nx + ny * ny + nz * nz;
  if (len2 > 0.0f) {
    const float inv_l = rsqrt_exact(fmaxf(len2, 1e-30f));
    nsx = nx * inv_l;
    nsy = ny * inv_l;
    nsz = nz * inv_l;
  } else {
    nsx = ngx;
    nsy = ngy;
    nsz = ngz;
  }
}

// Kernel prologue: brute force stages the intersect columns in shared memory
// (the whole block syncs once); BVH mode reads global memory and stages
// nothing.
template <bool kBvh>
__device__ Geometry<kBvh> load_geometry(float* s_geo, const float* table, int n_tris,
                                        const float* nodes_f, const int* nodes_i) {
  if constexpr (!kBvh) {
    for (int k = threadIdx.x; k < n_tris * GEO_COLS; k += blockDim.x)
      s_geo[k] = __ldg(table + (k / GEO_COLS) * TABLE_COLS + k % GEO_COLS);
    __syncthreads();
  }
  return Geometry<kBvh>{s_geo, n_tris, table, nodes_f, nodes_i};
}

// Shading frame (bsdf/eval.make_frame) on the flat normal n:
// ss = normalize(dpdu), or coordinate_system(n) for a degenerate dpdu;
// ts = n x ss
__device__ void shading_frame(float nsx, float nsy, float nsz, float dux, float duy, float duz,
                              float& ssx, float& ssy, float& ssz, float& tsx, float& tsy,
                              float& tsz) {
  const float du2 = dux * dux + duy * duy + duz * duz;
  if (du2 < 1e-20f) {
    const bool big_x = fabsf(nsx) > fabsf(nsy);
    const float inv_a =
        rsqrt_exact(fmaxf(big_x ? nsx * nsx + nsz * nsz : nsy * nsy + nsz * nsz, 1e-30f));
    ssx = (big_x ? -nsz : 0.0f) * inv_a;
    ssy = (big_x ? 0.0f : nsz) * inv_a;
    ssz = (big_x ? nsx : -nsy) * inv_a;
  } else {
    const float inv = rsqrt_exact(fmaxf(du2, 1e-30f));
    ssx = dux * inv;
    ssy = duy * inv;
    ssz = duz * inv;
  }
  tsx = nsy * ssz - nsz * ssy;
  tsy = nsz * ssx - nsx * ssz;
  tsz = nsx * ssy - nsy * ssx;
}

// ---- lobes (ops/path_megakernel._lobe_f_k, _lobe_pdf_k, _fresnel_k) ----

struct Lobe {
  int kind;
  float s0[3], s1[3], s2[3];
  float au, av;
  int fres;
  float eta_a, eta_b;
};

__device__ Lobe load_lobe(const float* row, int l) {
  const float* b = row + 16 + 16 * l;
  Lobe lob;
  lob.kind = (int)__ldg(b + 0);
  for (int c = 0; c < 3; ++c) {
    lob.s0[c] = __ldg(b + 1 + c);
    lob.s1[c] = __ldg(b + 4 + c);
    lob.s2[c] = __ldg(b + 7 + c);
  }
  lob.au = __ldg(b + 10);
  lob.av = __ldg(b + 11);
  lob.fres = (int)__ldg(b + 12);
  lob.eta_a = __ldg(b + 13);
  lob.eta_b = __ldg(b + 14);
  return lob;
}

__device__ __forceinline__ bool is_spec_kind(int k) {
  return k == LOBE_SPEC_REFL || k == LOBE_SPEC_TRANS || k == LOBE_FRESNEL_SPEC;
}

__device__ void trig_theta_phi(float x, float y, float z, float& cos2, float& tan2,
                               float& c2p, float& s2p) {
  cos2 = z * z;
  const float sin2 = fmaxf(0.0f, 1.0f - cos2);
  tan2 = sin2 / (cos2 == 0.0f ? 1e-30f : cos2);
  const float sin_t = sqrtf(sin2);
  const float safe = sin_t == 0.0f ? 1.0f : sin_t;
  const float cos_p = sin_t == 0.0f ? 1.0f : fminf(fmaxf(x / safe, -1.0f), 1.0f);
  const float sin_p = sin_t == 0.0f ? 0.0f : fminf(fmaxf(y / safe, -1.0f), 1.0f);
  c2p = cos_p * cos_p;
  s2p = sin_p * sin_p;
}

__device__ float tr_d(float x, float y, float z, float au, float av) {
  float cos2, tan2, c2p, s2p;
  trig_theta_phi(x, y, z, cos2, tan2, c2p, s2p);
  const float c4 = cos2 * cos2;
  const float e = (c2p / (au * au) + s2p / (av * av)) * tan2;
  const float ope = 1.0f + e;
  const float d = 1.0f / (PI_F * au * av * c4 * (ope * ope));
  return (tan2 <= FLT_MAX && c4 > 0.0f) ? d : 0.0f;  // tan2 >= 0: finite test
}

__device__ float tr_lambda(float x, float y, float z, float au, float av) {
  float cos2, tan2, c2p, s2p;
  trig_theta_phi(x, y, z, cos2, tan2, c2p, s2p);
  const float alpha2 = c2p * au * au + s2p * av * av;
  const float lam = (-1.0f + sqrtf(1.0f + alpha2 * tan2)) / 2.0f;
  return tan2 <= FLT_MAX ? lam : 0.0f;
}

__device__ float fr_dielectric(float cos_i, float eta_i, float eta_t) {
  cos_i = fminf(fmaxf(cos_i, -1.0f), 1.0f);
  const bool entering = cos_i > 0.0f;
  const float ei = entering ? eta_i : eta_t;
  const float et = entering ? eta_t : eta_i;
  const float ci = fabsf(cos_i);
  const float sin_i = sqrtf(fmaxf(0.0f, 1.0f - ci * ci));
  const float sin_t = ei / et * sin_i;
  const bool tir = sin_t >= 1.0f;
  const float ct = sqrtf(fmaxf(0.0f, 1.0f - sin_t * sin_t));
  const float r_par = (et * ci - ei * ct) / fmaxf(et * ci + ei * ct, 1e-20f);
  const float r_perp = (ei * ci - et * ct) / fmaxf(ei * ci + et * ct, 1e-20f);
  return tir ? 1.0f : 0.5f * (r_par * r_par + r_perp * r_perp);
}

__device__ float fr_conductor(float ci2, float si2, float eta, float k) {
  const float e2 = eta * eta;
  const float k2 = k * k;
  const float t0 = e2 - k2 - si2;
  const float a2b2 = sqrtf(fmaxf(t0 * t0 + 4.0f * e2 * k2, 0.0f));
  const float t1 = a2b2 + ci2;
  const float a = sqrtf(fmaxf(0.5f * (a2b2 + t0), 0.0f));
  const float t2 = 2.0f * a * sqrtf(ci2);
  const float rs = (t1 - t2) / fmaxf(t1 + t2, 1e-20f);
  const float t3 = a2b2 * ci2 + si2 * si2;
  const float t4 = t2 * si2;
  const float rp = rs * (t3 - t4) / fmaxf(t3 + t4, 1e-20f);
  return 0.5f * (rp + rs);
}

__device__ __forceinline__ float schlick_weight(float cos_t) {
  const float m = fminf(fmaxf(1.0f - cos_t, 0.0f), 1.0f);
  return (m * m) * (m * m) * m;
}

// disney.rs GTR1 with the reference's log10 (PBRT's is ln)
__device__ __forceinline__ float gtr1(float cos_theta, float alpha) {
  const float a2 = alpha * alpha;
  return (a2 - 1.0f) /
         (PI_F * log10f(fmaxf(a2, 1e-9f)) * (1.0f + (a2 - 1.0f) * cos_theta * cos_theta));
}

// Smith G_GGX at the clearcoat's fixed alpha 0.25
__device__ __forceinline__ float cc_g(float cos_theta) {
  const float a2 = 0.0625f;
  const float c2 = cos_theta * cos_theta;
  return 1.0f / fmaxf(cos_theta + sqrtf(fmaxf(a2 + c2 - a2 * c2, 0.0f)), 1e-9f);
}

// The Disney lobes (K5 e: DisneyDiffuse, retro, sheen, clearcoat, and the
// Disney microfacet with its fresnel and separable G) are compiled in only
// where kDisney is set: the path kernel's instances and the SPPM kernels'
// wide ones.  The other instances take none of them and keep their code.
template <bool kDisney = false>
__device__ void fresnel(const Lobe& lob, float cos_i, float fr[3]) {
  if (lob.fres == FRESNEL_DIELECTRIC) {
    const float v = fr_dielectric(cos_i, lob.eta_a, lob.eta_b);
    fr[0] = fr[1] = fr[2] = v;
  } else if (lob.fres == FRESNEL_CONDUCTOR) {
    const float ci = fminf(fmaxf(fabsf(cos_i), 0.0f), 1.0f);
    const float ci2 = ci * ci;
    const float si2 = 1.0f - ci2;
    for (int c = 0; c < 3; ++c) fr[c] = fr_conductor(ci2, si2, lob.s2[c], lob.s1[c]);
  } else if (kDisney && lob.fres == FRESNEL_DISNEY) {
    // disney.rs:310-333: metallic in eta_a, eta in eta_b, c_spec0 in s1
    const float metallic = lob.eta_a;
    const float fr_d1 = fr_dielectric(cos_i, 1.0f, lob.eta_b);
    const float sw = schlick_weight(cos_i);
    for (int c = 0; c < 3; ++c)
      fr[c] = (1.0f - metallic) * fr_d1 + metallic * (lob.s1[c] + (1.0f - lob.s1[c]) * sw);
  } else {
    fr[0] = fr[1] = fr[2] = 1.0f;
  }
}

struct F3 {
  float r, g, b;
};

// f of the Disney diffuse, retro, sheen and clearcoat lobes (disney.rs;
// roughness, or the clearcoat's weight, in au, its gloss in av).  Out of
// line: the path kernel inlines its lobe functions at four call sites; one
// called copy of this code leaves their registers and their other lobes'
// code nearly as they are without it (a call costs some stack).
__device__ __noinline__ F3 disney_f(int kind, float s0r, float s0g, float s0b, float au, float av,
                                    float wox, float woy, float woz, float wix, float wiy,
                                    float wiz) {
  const float whx = wox + wix, why = woy + wiy, whz = woz + wiz;
  const float wh2 = whx * whx + why * why + whz * whz;
  const float wh_len = sqrtf(fmaxf(wh2, 0.0f));
  const bool wh_zero = wh2 == 0.0f;
  const float inv_l = 1.0f / fmaxf(wh_len, 1e-20f);
  const float nhx = whx * inv_l, nhy = why * inv_l, nhz = whz * inv_l;
  const float co = fabsf(woz), ci = fabsf(wiz);
  if (kind == LOBE_DISNEY_CLEARCOAT) {
    // GTR1 D, fixed-alpha Smith G, Schlick 0.04
    const float v = wh_zero ? 0.0f
                            : au * cc_g(co) * cc_g(ci) *
                                  (0.04f + 0.96f * schlick_weight(wox * nhx + woy * nhy + woz * nhz)) *
                                  gtr1(fabsf(nhz), av) / 4.0f;
    return F3{v, v, v};
  }
  const float fo = schlick_weight(co), fi = schlick_weight(ci);
  float fac = 0.0f;
  if (kind == LOBE_DISNEY_DIFFUSE) {
    fac = (1.0f - fo / 2.0f) * (1.0f - fi / 2.0f) / PI_F;
  } else if (!wh_zero) {
    const float cos_d = wix * nhx + wiy * nhy + wiz * nhz;
    if (kind == LOBE_DISNEY_RETRO) {
      const float rr = 2.0f * au * cos_d * cos_d;
      fac = rr * (fo + fi + fo * fi * (rr - 1.0f)) / PI_F;
    } else {  // sheen
      fac = schlick_weight(cos_d);
    }
  }
  return F3{s0r * fac, s0g * fac, s0b * fac};
}

// the clearcoat's pdf: GTR1 D |cos wh| / (4 wo.wh); out of line as disney_f
__device__ __noinline__ float clearcoat_pdf(float av, float wox, float woy, float woz, float wix,
                                            float wiy, float wiz) {
  const bool same = (woz * wiz) > 0.0f;
  const float whx = wox + wix, why = woy + wiy, whz = woz + wiz;
  const float wh2 = whx * whx + why * why + whz * whz;
  const float inv_l = rsqrt_exact(fmaxf(wh2, 1e-30f));
  const float nhx = whx * inv_l, nhy = why * inv_l, nhz = whz * inv_l;
  const float dr = gtr1(fabsf(nhz), av);
  const float dot_owh = wox * nhx + woy * nhy + woz * nhz;
  return (same && wh2 > 0.0f) ? dr * fabsf(nhz) / fmaxf(4.0f * dot_owh, 1e-9f) : 0.0f;
}

// DisneyClearcoat::sample_f's direction, the reference's form without the
// sqrt; out of line as disney_f
__device__ __noinline__ F3 clearcoat_sample(float av, float wol_x, float wol_y, float wo_z,
                                            float u0, float u1) {
  const float a2c = av * av;
  float cc_cos = (1.0f - powf(fmaxf(a2c, 1e-9f), 1.0f - u0)) / sqrtf(fmaxf(1.0f - a2c, 1e-9f));
  cc_cos = fminf(fmaxf(cc_cos, -1.0f), 1.0f);
  const float cc_sin = sqrtf(fmaxf(0.0f, 1.0f - cc_cos * cc_cos));
  const float cc_phi = TWO_PI_F * u1;
  float hx = cc_sin * cosf(cc_phi), hy = cc_sin * sinf(cc_phi), hz = cc_cos;
  if ((wo_z * hz) <= 0.0f) {
    hx = -hx;
    hy = -hy;
    hz = -hz;
  }
  const float dot_ow = wol_x * hx + wol_y * hy + wo_z * hz;
  return F3{2.0f * dot_ow * hx - wol_x, 2.0f * dot_ow * hy - wol_y, 2.0f * dot_ow * hz - wo_z};
}

// lobe_f on local-frame directions; specular kinds evaluate to 0
template <bool kDisney = false>
__device__ void lobe_f(const Lobe& lob, float wox, float woy, float woz, float wix,
                       float wiy, float wiz, float f[3]) {
  f[0] = f[1] = f[2] = 0.0f;
  if (lob.kind == LOBE_LAMBERT_REFL) {
    for (int c = 0; c < 3; ++c) f[c] = lob.s0[c] / PI_F;
  } else if (lob.kind == LOBE_MF_REFL || (kDisney && lob.kind == LOBE_DISNEY_MICROFACET_REFL)) {
    const float whx = wox + wix, why = woy + wiy, whz = woz + wiz;
    const float wh2 = whx * whx + why * why + whz * whz;
    const float wh_len = sqrtf(fmaxf(wh2, 0.0f));
    const float inv_l = 1.0f / fmaxf(wh_len, 1e-20f);
    const float nhx = whx * inv_l, nhy = why * inv_l, nhz = whz * inv_l;
    const float co = fabsf(woz), ci = fabsf(wiz);
    const bool ok = co > 0.0f && ci > 0.0f && wh_len > 0.0f;
    const float s = nhz < 0.0f ? -1.0f : 1.0f;
    float fr[3];
    fresnel<kDisney>(lob, wix * (s * nhx) + wiy * (s * nhy) + wiz * (s * nhz), fr);
    const float d_val = tr_d(nhx, nhy, nhz, lob.au, lob.av);
    const float lam_o = tr_lambda(wox, woy, woz, lob.au, lob.av);
    const float lam_i = tr_lambda(wix, wiy, wiz, lob.au, lob.av);
    float g = 1.0f / (1.0f + lam_o + lam_i);
    if (kDisney && lob.kind == LOBE_DISNEY_MICROFACET_REFL)  // separable Smith G
      g = (1.0f / (1.0f + lam_o)) * (1.0f / (1.0f + lam_i));
    const float scale = d_val * g / fmaxf(4.0f * ci * co, 1e-20f);
    if (ok)
      for (int c = 0; c < 3; ++c) f[c] = lob.s0[c] * fr[c] * scale;
  } else if (kDisney && (lob.kind == LOBE_DISNEY_DIFFUSE || lob.kind == LOBE_DISNEY_RETRO ||
                         lob.kind == LOBE_DISNEY_SHEEN || lob.kind == LOBE_DISNEY_CLEARCOAT)) {
    const F3 v = disney_f(lob.kind, lob.s0[0], lob.s0[1], lob.s0[2], lob.au, lob.av, wox, woy, woz,
                          wix, wiy, wiz);
    f[0] = v.r;
    f[1] = v.g;
    f[2] = v.b;
  }
}

template <bool kDisney = false>
__device__ float lobe_pdf(const Lobe& lob, float wox, float woy, float woz, float wix,
                          float wiy, float wiz) {
  if (is_spec_kind(lob.kind)) return 0.0f;
  const bool same = (woz * wiz) > 0.0f;
  if (kDisney && lob.kind == LOBE_DISNEY_CLEARCOAT)
    return clearcoat_pdf(lob.av, wox, woy, woz, wix, wiy, wiz);
  if (lob.kind != LOBE_MF_REFL && !(kDisney && lob.kind == LOBE_DISNEY_MICROFACET_REFL))
    return same ? fabsf(wiz) / PI_F : 0.0f;
  float whx = wox + wix, why = woy + wiy, whz = woz + wiz;
  const float inv_l = rsqrt_exact(fmaxf(whx * whx + why * why + whz * whz, 1e-30f));
  whx *= inv_l;
  why *= inv_l;
  whz *= inv_l;
  const float d_val = tr_d(whx, why, whz, lob.au, lob.av);
  const float lam_o = tr_lambda(wox, woy, woz, lob.au, lob.av);
  const float dot_owh = wox * whx + woy * why + woz * whz;
  const float pdf_wh = d_val / (1.0f + lam_o) * fabsf(dot_owh) / fmaxf(fabsf(woz), 1e-20f);
  return same ? pdf_wh / fmaxf(4.0f * dot_owh, 1e-20f) : 0.0f;
}

// tr_sample_wh_visible (bsdf/microfacet.py), local frame
__device__ void tr_sample_wh(float wox, float woy, float woz, float au, float av, float u0,
                             float u1, float& hx, float& hy, float& hz) {
  const bool flip = woz < 0.0f;
  const float wx = flip ? -wox : wox, wy = flip ? -woy : woy, wz = flip ? -woz : woz;
  const float sx_ = wx * au, sy_ = wy * av, sz_ = wz;
  const float inv = rsqrt_exact(fmaxf(sx_ * sx_ + sy_ * sy_ + sz_ * sz_, 1e-30f));
  const float wsx = sx_ * inv, wsy = sy_ * inv, wsz = sz_ * inv;

  const float cos_theta = wsz;
  float slope_x, slope_y;
  if (cos_theta > 0.9999f) {
    const float r_spec = sqrtf(u0 / fmaxf(1.0f - u0, 1e-9f));
    const float phi_spec = TWO_PI_F * u1;
    slope_x = r_spec * cosf(phi_spec);
    slope_y = r_spec * sinf(phi_spec);
  } else {
    const float sin_theta = sqrtf(fmaxf(0.0f, 1.0f - cos_theta * cos_theta));
    const float tan_theta = sin_theta / fmaxf(cos_theta, 1e-9f);
    const float a_inv = 1.0f / fmaxf(tan_theta, 1e-9f);
    const float g1v = 2.0f / (1.0f + sqrtf(1.0f + 1.0f / (a_inv * a_inv)));
    const float a = 2.0f * u0 / g1v - 1.0f;
    float tmp = fminf(1.0f / fmaxf(a * a - 1.0f, 1e-12f), 1e10f);
    if (a * a - 1.0f <= 0.0f) tmp = 1e10f;
    const float b = tan_theta;
    const float dsc = fmaxf(b * b * tmp * tmp - (a * a - b * b) * tmp, 0.0f);
    const float dq = sqrtf(dsc);
    const float sx1 = b * tmp - dq;
    const float sx2 = b * tmp + dq;
    slope_x = (a < 0.0f || sx2 > 1.0f / fmaxf(tan_theta, 1e-9f)) ? sx1 : sx2;
    const float sgn = u1 > 0.5f ? 1.0f : -1.0f;
    const float nu2 = u1 > 0.5f ? 2.0f * (u1 - 0.5f) : 2.0f * (0.5f - u1);
    const float z = (nu2 * (nu2 * (nu2 * 0.27385f - 0.73369f) + 0.46341f)) /
                    (nu2 * (nu2 * (nu2 * 0.093073f + 0.309420f) - 1.0f) + 0.597999f);
    slope_y = sgn * z * sqrtf(1.0f + slope_x * slope_x);
  }
  const float s2 = fmaxf(0.0f, 1.0f - wsz * wsz);
  const float sin_t = sqrtf(s2);
  const float safe = sin_t == 0.0f ? 1.0f : sin_t;
  const float cos_p = sin_t == 0.0f ? 1.0f : wsx / safe;
  const float sin_p = sin_t == 0.0f ? 0.0f : wsy / safe;
  const float rx = cos_p * slope_x - sin_p * slope_y;
  const float ry = sin_p * slope_x + cos_p * slope_y;
  hx = -au * rx;
  hy = -av * ry;
  hz = 1.0f;
  const float inv_h = rsqrt_exact(fmaxf(hx * hx + hy * hy + hz * hz, 1e-30f));
  hx *= inv_h;
  hy *= inv_h;
  hz *= inv_h;
  if (flip) {
    hx = -hx;
    hy = -hy;
    hz = -hz;
  }
}

__device__ void concentric_disk(float u0, float u1, float& dxo, float& dyo) {
  const float x = 2.0f * u0 - 1.0f;
  const float y = 2.0f * u1 - 1.0f;
  if (x == 0.0f && y == 0.0f) {
    dxo = dyo = 0.0f;
    return;
  }
  const bool use_x = fabsf(x) > fabsf(y);
  const float safe_x = x == 0.0f ? 1.0f : x;
  const float safe_y = y == 0.0f ? 1.0f : y;
  const float r = use_x ? x : y;
  const float theta =
      use_x ? PI_OVER_4_F * (y / safe_x) : PI_OVER_2_F - PI_OVER_4_F * (x / safe_y);
  dxo = cosf(theta) * r;
  dyo = sinf(theta) * r;
}

// One BSDF sample at a surface vertex (Bsdf::sample_f, reference-quirk exact;
// ops/path_megakernel._bsdf_sample): a lobe picked uniformly by ub0, the
// lobe's direction in the local frame, its f and pdf (divided by the lobe
// count), whether a fresnel-specular lobe transmitted (the etaScale
// factor) and whether the picked lobe is specular.  A zero f or pdf ends the
// path.  kSt (the path kernel's subsurface instances and the SPPM walks' wide
// ones) adds the specular
// transmission lobe: its refraction, f and pdf, and the other lobes' pdfs
// added to a chosen one's, since it does not reflect (reflection.rs:358).
struct BsdfSample {
  float wx, wy, wz;
  float f[3];
  float pdf;
  bool transmitted;
  bool specular;
};

// A specular lobe's transmitted direction (reflection.rs:686-715): wo
// refracted through the eta pair, whether it is not totally reflected and
// the radiance scale (eta_i / eta_t)^2
__device__ __forceinline__ void refract_spec(const Lobe& lc, float wol_x, float wol_y, float wo_z,
                                             BsdfSample& s, bool& st_ok, float& scale_t) {
  const bool entering = wo_z > 0.0f;
  const float ei = entering ? lc.eta_a : lc.eta_b;
  const float et = entering ? lc.eta_b : lc.eta_a;
  const float eta_rel = ei / fmaxf(et, 1e-9f);
  const float abs_cz = fabsf(wo_z);
  const float sin2_t = eta_rel * eta_rel * fmaxf(0.0f, 1.0f - abs_cz * abs_cz);
  st_ok = sin2_t < 1.0f;
  const float cos_t = sqrtf(fmaxf(0.0f, 1.0f - sin2_t));
  const float nz_sign = entering ? 1.0f : -1.0f;
  s.wx = -eta_rel * wol_x;
  s.wy = -eta_rel * wol_y;
  s.wz = -eta_rel * wo_z + (eta_rel * abs_cz - cos_t) * nz_sign;
  scale_t = (ei * ei) / fmaxf(et * et, 1e-20f);
}

template <bool kDisney = false, bool kSt = false>
__device__ BsdfSample bsdf_sample(const float* row, int n_lob, float wol_x, float wol_y,
                                  float wo_z, float ub0, float ub1) {
  const int matching = max(n_lob, 1);
  const int comp = min((int)(ub0 * (float)matching), matching - 1);
  const float u0 = fminf(ub0 * (float)matching - (float)comp, ONE_MINUS_EPSILON);
  const float u1 = ub1;
  const Lobe lc = n_lob > 0 ? load_lobe(row, comp) : Lobe{};
  BsdfSample s;
  s.wx = s.wy = s.wz = 0.0f;
  bool mf_ok = true, fs_reflect = false, st_ok = true;
  float fr_fs = 0.0f, scale_t = 1.0f;
  if (lc.kind == LOBE_MF_REFL || (kDisney && lc.kind == LOBE_DISNEY_MICROFACET_REFL)) {
    float hx, hy, hz;
    tr_sample_wh(wol_x, wol_y, wo_z, lc.au, lc.av, u0, u1, hx, hy, hz);
    const float dot_owh = wol_x * hx + wol_y * hy + wo_z * hz;
    s.wx = 2.0f * dot_owh * hx - wol_x;
    s.wy = 2.0f * dot_owh * hy - wol_y;
    s.wz = 2.0f * dot_owh * hz - wo_z;
    mf_ok = dot_owh >= 0.0f && (wo_z * s.wz) > 0.0f && wo_z != 0.0f;
  } else if (kDisney && lc.kind == LOBE_DISNEY_CLEARCOAT) {
    const F3 w = clearcoat_sample(lc.av, wol_x, wol_y, wo_z, u0, u1);
    s.wx = w.r;
    s.wy = w.g;
    s.wz = w.b;
    mf_ok = (wo_z * s.wz) > 0.0f && wo_z != 0.0f;
  } else if (lc.kind == LOBE_SPEC_REFL) {
    s.wx = -wol_x;
    s.wy = -wol_y;
    s.wz = wo_z;
  } else if (lc.kind == LOBE_FRESNEL_SPEC) {
    fr_fs = fr_dielectric(wo_z, lc.eta_a, lc.eta_b);
    fs_reflect = u0 < fr_fs;
    if (fs_reflect) {
      s.wx = -wol_x;
      s.wy = -wol_y;
      s.wz = wo_z;
    } else {
      refract_spec(lc, wol_x, wol_y, wo_z, s, st_ok, scale_t);
    }
  } else if (kSt && lc.kind == LOBE_SPEC_TRANS) {
    refract_spec(lc, wol_x, wol_y, wo_z, s, st_ok, scale_t);
  } else {  // cosine-weighted hemisphere on wo's side (lambert)
    float dxo, dyo;
    concentric_disk(u0, u1, dxo, dyo);
    float z_cos = sqrtf(fmaxf(0.0f, 1.0f - dxo * dxo - dyo * dyo));
    if (wo_z < 0.0f) z_cos = -z_cos;
    s.wx = dxo;
    s.wy = dyo;
    s.wz = z_cos;
  }
  lobe_f<kDisney>(lc, wol_x, wol_y, wo_z, s.wx, s.wy, s.wz, s.f);
  s.pdf = lobe_pdf<kDisney>(lc, wol_x, wol_y, wo_z, s.wx, s.wy, s.wz);
  if (!mf_ok) s.f[0] = s.f[1] = s.f[2] = 0.0f;  // every caller gates on f
  const float aci = fmaxf(fabsf(s.wz), 1e-20f);
  if (lc.kind == LOBE_SPEC_REFL) {
    float fr[3];
    fresnel(lc, s.wz, fr);
    for (int c = 0; c < 3; ++c) s.f[c] = lc.s0[c] * fr[c] / aci;
    s.pdf = 1.0f;
  } else if (lc.kind == LOBE_FRESNEL_SPEC) {
    for (int c = 0; c < 3; ++c)
      s.f[c] = fs_reflect ? lc.s0[c] * fr_fs / aci
                          : (st_ok ? lc.s1[c] * (1.0f - fr_fs) * scale_t / aci : 0.0f);
    s.pdf = fs_reflect ? fr_fs : 1.0f - fr_fs;
  } else if (kSt && lc.kind == LOBE_SPEC_TRANS) {
    // T (1 - Fr(cos wi)) (eta_i / eta_t)^2 / |cos wi| (radiance mode)
    const float fr_t = fr_dielectric(s.wz, lc.eta_a, lc.eta_b);
    for (int c = 0; c < 3; ++c) s.f[c] = st_ok ? lc.s0[c] * (1.0f - fr_t) * scale_t / aci : 0.0f;
    s.pdf = st_ok ? 1.0f : 0.0f;
    if (matching > 1) {
      float extra = 0.0f;
      for (int j = 0; j < n_lob; ++j)
        if (j != comp)
          extra = extra + lobe_pdf<kDisney>(load_lobe(row, j), wol_x, wol_y, wo_z, s.wx, s.wy, s.wz);
      s.pdf = s.pdf + extra;
    }
  }
  if (matching > 1) s.pdf = s.pdf / (float)matching;
  s.transmitted = (lc.kind == LOBE_FRESNEL_SPEC && !fs_reflect) ||
                  (kSt && lc.kind == LOBE_SPEC_TRANS);
  s.specular = is_spec_kind(lc.kind);
  return s;
}

// ---- lights beyond the point light (lights/lights.py sample_li) ----

// One sample of a diffuse light on a full sphere (lights/diffuse.rs sample_li,
// sphere.rs sample): a uniform point on the sphere, its normal through the
// inverse's transpose, the reference's area pdf dist^2 / |cos| without the
// 1 / area (shape/mod.rs:33-47), emission on the front side only.
// o2w: 12 floats (3x4 rows); w2o: the inverse's 3x3, row major.
__device__ void sample_sphere_light(const float* o2w, const float* w2o, float radius,
                                    const float* emit, float px, float py, float pz, float u0,
                                    float u1, float& wix, float& wiy, float& wiz, float li[3],
                                    float& pdf, float& lpx, float& lpy, float& lpz) {
  const float z = 1.0f - 2.0f * u0;
  const float r_ = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  const float phi = TWO_PI_F * u1;
  const float pox = r_ * cosf(phi) * radius, poy = r_ * sinf(phi) * radius, poz = z * radius;
  lpx = o2w[0] * pox + o2w[1] * poy + o2w[2] * poz + o2w[3];
  lpy = o2w[4] * pox + o2w[5] * poy + o2w[6] * poz + o2w[7];
  lpz = o2w[8] * pox + o2w[9] * poy + o2w[10] * poz + o2w[11];
  float nsx = w2o[0] * pox + w2o[3] * poy + w2o[6] * poz;
  float nsy = w2o[1] * pox + w2o[4] * poy + w2o[7] * poz;
  float nsz = w2o[2] * pox + w2o[5] * poy + w2o[8] * poz;
  const float ninv = rsqrt_exact(fmaxf(nsx * nsx + nsy * nsy + nsz * nsz, 1e-30f));
  nsx = nsx * ninv;
  nsy = nsy * ninv;
  nsz = nsz * ninv;
  const float tsx = lpx - px, tsy = lpy - py, tsz = lpz - pz;
  const float d2 = tsx * tsx + tsy * tsy + tsz * tsz;
  const float dn = sqrtf(fmaxf(d2, 1e-20f));
  wix = tsx / dn;
  wiy = tsy / dn;
  wiz = tsz / dn;
  const float cos_l = fabsf(-(wix * nsx + wiy * nsy + wiz * nsz));
  pdf = d2 / fmaxf(cos_l, 1e-20f);
  if (!(d2 > 0.0f && pdf <= FLT_MAX)) pdf = 0.0f;  // pdf >= 0: the finite test
  const bool front = (nsx * -wix + nsy * -wiy + nsz * -wiz) > 0.0f;
  for (int c = 0; c < 3; ++c) li[c] = front ? emit[c] : 0.0f;
}

// MIS power heuristic with one sample of each strategy (sampling.rs:324-328)
__device__ __forceinline__ float power_heuristic(float f_pdf, float g_pdf) {
  const float f2 = f_pdf * f_pdf;
  const float denom = f2 + g_pdf * g_pdf;
  return denom > 0.0f ? f2 / fmaxf(denom, 1e-30f) : 0.0f;
}

constexpr size_t SMEM_MAX = (size_t)TRI_MAX * GEO_COLS * sizeof(float);
// the chunked walk's largest dynamic shared memory: TRI_MAX rows in chunks
constexpr size_t CHUNK_SMEM_MAX = chunk_smem(TRI_MAX, CHUNK_MAX);

}  // namespace
