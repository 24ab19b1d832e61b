// Volpath-integrator sample pass for Hopper (sm_90a): one thread per camera ray
// (kRaysIn false) or per given ray (kRaysIn true).
//
// Replaces the TPU kernels rs_ray_toy_tpu/ops/volpath_megakernel.py ·
// _kernel_vol_cam (brute force, pallas_call in _run_vol_cam for T <= 2048) and
// _kernel_vol_bvh_cam (the in-kernel BVH, up to 65,536 triangles), and on given
// rays (o, d, weight; li_volpath_mega, every ray starting in the camera medium)
// _kernel_vol and _kernel_vol_bvh (pallas_call in _run_vol), all running
// _vol_bounce_loop, on their subset: one camera medium (homogeneous or
// a density grid) with no per-primitive interfaces, triangles, the path
// kernel's lobes, point lights and, in homogeneous media, diffuse sphere
// lights.  Per ray: the sampler hash for every slot it consumes, the lens trace
// (raygen), then per bounce the closest hit; the medium sampled over the
// segment to it (or over 2 * world_radius + 1000 for a ray that escapes: it
// still scatters in the fog), closed form for a homogeneous medium, delta
// tracking for a grid; at the vertex a power-weighted light pick, a light
// sample, the phase function or the non-specular lobes toward it, the MIS
// power heuristic for a sphere light, an any-hit shadow ray and the fog's
// transmittance along it (closed form, or ratio tracking); then an HG or BSDF
// sample of the next direction, etaScale and Russian roulette after bounce 3.
// The medium's draws come from a per-ray hash chain, hash_combine(pid, sid)
// advanced by hash_u32(state ^ 0x9E3779B9): two draws per bounce in a
// homogeneous medium (channel, distance); in a grid, draws only while the
// ray walks, and ratio tracking runs for every active ray whose shadow
// segment crosses the grid's box, lit or not, so the chain stays in step
// with the plain version.  Output: RGB radiance and the camera weight per ray.
//
// What bounds it on this card: divergent per-thread FP32 work (triangle tests,
// logf / expf, trilinear density taps) over read-only tables: the staged
// triangle columns, the BVH nodes, and a float32 density grid of nz*ny*nx
// values (16 KB at 16^3) read through the read-only cache.  It moves 20 bytes
// in and 16 out per ray (given rays: 36 in, 12 out): latency- and
// occupancy-bound, not bandwidth-bound.
// The design is the path kernel's (path_megakernel.cu): each thread walks its
// own ray to termination, triangles staged in shared memory up to TRI_MAX or
// walked in the BVH above, constants in __grid_constant__ parameter blocks.
// The BVH instances walk the node64 rows and the 48-byte leaf rows (common.cuh
// Bvh64Geometry, the path kernel's BVH walk), through the read-only cache,
// the winner's row of the table, in the same leaf order, read only to shade;
// in blocks of BLOCK under a launch bound of VOL_BVH_MIN_BLOCKS an SM.
// Brute force walks the chunks (kChunk: common.cuh ChunkGeometry, the chunk
// boxes and rows staged in shared memory, a box missed before the ray's best
// t skips its rows, each row meets the division-free reject first), whose
// block size the launch picks by occupancy; it finds Geometry<false>'s hits,
// so the medium's draws, which depend only on the hits, and the radiance are
// those of the walk over every row (kChunk false), which stays launchable
// (a null chunks pointer) for the comparison.
// Tracking loops run until the ray leaves its segment (delta and ratio
// tracking end with probability one; the JAX loops have no step bound
// either); a NaN position ends the walk, since `t < t_max` fails.
//
// Numerics follow the plain PyTorch version (vol_bounce_loop_reference and
// scene/medium.py) expression by expression; see common.cuh.  logf, expf,
// sinf and cosf are CUDA's (not correctly rounded; no fast-math), which
// torch's CUDA kernels also call.

#include <type_traits>

#include "common.cuh"

// Must match ops/volpath_megakernel._VolParams field for field.
struct VolParams {
  int light_kind[LIGHT_MAX];
  float sph_o2w[LIGHT_MAX * 12];  // per light, object-to-world 3x4 rows
  float sph_w2o[LIGHT_MAX * 9];   // per light, the inverse's 3x3
  float sph_radius[LIGHT_MAX];
  float cdf[LIGHT_MAX + 1];  // power distribution, float32 values
  float pick_pdf[LIGHT_MAX];
  int all_point;     // every light a point light: no light sample is drawn
  float seg_escape;  // 2 * world_radius + 1000, folded on the host
  float sigma_s[3], sigma_t[3], g;
  int grid;          // 1: density grid, 0: homogeneous
  int nx, ny, nz;
  float w2m[12];     // world to the grid's [0,1]^3, 3x4 rows
  float inv_max;     // 1 / the largest density
};

namespace {

constexpr int LIGHT_POINT_KIND = 0;
constexpr float INV_4_PI_F = (float)(1.0 / (4.0 * 3.14159265358979323846));

// ---- the per-ray chain of the medium draws (scene/medium._next_u) ----

__device__ __forceinline__ float chain_next(uint32_t& state) {
  state = hash_u32(state ^ 0x9E3779B9u);
  return (float)(int32_t)(state >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

// ---- the medium (scene/medium.py) ----

__device__ __forceinline__ float phase_hg(float cos_theta, float g) {
  const float denom = 1.0f + g * g + 2.0f * g * cos_theta;
  return INV_4_PI_F * (1.0f - g * g) / fmaxf(denom * sqrtf(fmaxf(denom, 1e-12f)), 1e-12f);
}

// HenyeyGreenstein::sample_p around wo with the reference's phi = 2*pi*u0
__device__ void hg_sample(float wx, float wy, float wz, float g, float u0, float& ix, float& iy,
                          float& iz) {
  float cos_theta;
  if (fabsf(g) < 1e-3f) {
    cos_theta = 1.0f - 2.0f * u0;
  } else {
    const float sq_den = 1.0f + g - 2.0f * g * u0;
    const float sq = (1.0f - g * g) / (fabsf(sq_den) < 1e-9f ? 1e-9f : sq_den);
    const float g2_den = fabsf(g) < 1e-9f ? 1e-9f : 2.0f * g;
    cos_theta = -(1.0f + g * g - sq * sq) / g2_den;
  }
  cos_theta = fminf(fmaxf(cos_theta, -1.0f), 1.0f);
  const float sin_theta = sqrtf(fmaxf(1.0f - cos_theta * cos_theta, 0.0f));
  const float phi = TWO_PI_F * u0;
  // core/vec.coordinate_system(wo)
  const bool use_x = fabsf(wx) > fabsf(wy);
  const float inv_a = 1.0f / sqrtf(use_x ? wx * wx + wz * wz : wy * wy + wz * wz);
  const float v1x = (use_x ? -wz : 0.0f) * inv_a;
  const float v1y = (use_x ? 0.0f : wz) * inv_a;
  const float v1z = (use_x ? wx : -wy) * inv_a;
  const float v2x = wy * v1z - wz * v1y;
  const float v2y = wz * v1x - wx * v1z;
  const float v2z = wx * v1y - wy * v1x;
  const float cp = sin_theta * cosf(phi);
  const float sp = sin_theta * sinf(phi);
  ix = v1x * cp + v2x * sp + wx * cos_theta;
  iy = v1y * cp + v2y * sp + wy * cos_theta;
  iz = v1z * cp + v2z * sp + wz * cos_theta;
}

// A world segment in the grid's medium space, clipped to [0,1]^3
// (_to_medium, _unit_box_interval)
struct MediumSegment {
  float ox, oy, oz, dx, dy, dz, scale, tmin, tmax;
  bool overlap;
};

__device__ __forceinline__ float box_inv(float d) {
  const float tiny = d < 0.0f ? -1e-12f : 1e-12f;
  return 1.0f / (fabsf(d) < 1e-12f ? tiny : d);
}

__device__ MediumSegment to_medium(const VolParams& v, float ox, float oy, float oz, float dx,
                                   float dy, float dz, float seg_len) {
  const float* m = v.w2m;
  MediumSegment s;
  s.ox = m[0] * ox + m[1] * oy + m[2] * oz + m[3];
  s.oy = m[4] * ox + m[5] * oy + m[6] * oz + m[7];
  s.oz = m[8] * ox + m[9] * oy + m[10] * oz + m[11];
  const float rx = m[0] * dx + m[1] * dy + m[2] * dz;
  const float ry = m[4] * dx + m[5] * dy + m[6] * dz;
  const float rz = m[8] * dx + m[9] * dy + m[10] * dz;
  s.scale = sqrtf(rx * rx + ry * ry + rz * rz);
  const float sc = fmaxf(s.scale, 1e-20f);
  s.dx = rx / sc;
  s.dy = ry / sc;
  s.dz = rz / sc;
  const float ix = box_inv(s.dx), iy = box_inv(s.dy), iz = box_inv(s.dz);
  const float t0x = (0.0f - s.ox) * ix, t1x = (1.0f - s.ox) * ix;
  const float t0y = (0.0f - s.oy) * iy, t1y = (1.0f - s.oy) * iy;
  const float t0z = (0.0f - s.oz) * iz, t1z = (1.0f - s.oz) * iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  s.tmin = fmaxf(tn, 0.0f);
  s.tmax = fminf(tf, seg_len * s.scale);
  s.overlap = s.tmin <= s.tmax;
  return s;
}

// Trilinear density at a medium-space point (scene/medium._grid_density):
// texel centres at (i + 0.5) / n, zero outside the grid.
__device__ float grid_density(const VolParams& v, const float* __restrict__ dens, float px,
                              float py, float pz) {
  const float psx = px * (float)v.nx - 0.5f;
  const float psy = py * (float)v.ny - 0.5f;
  const float psz = pz * (float)v.nz - 0.5f;
  const float fx = floorf(psx), fy = floorf(psy), fz = floorf(psz);
  const float dx = psx - fx, dy = psy - fy, dz = psz - fz;
  const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
  auto texel = [&](int ox, int oy, int oz) {
    const int x = x0 + ox, y = y0 + oy, z = z0 + oz;
    const bool inside = x >= 0 && x < v.nx && y >= 0 && y < v.ny && z >= 0 && z < v.nz;
    return inside ? __ldg(dens + ((size_t)z * v.ny + y) * v.nx + x) : 0.0f;
  };
  const float d00 = texel(0, 0, 0) * (1.0f - dx) + texel(1, 0, 0) * dx;
  const float d10 = texel(0, 1, 0) * (1.0f - dx) + texel(1, 1, 0) * dx;
  const float d01 = texel(0, 0, 1) * (1.0f - dx) + texel(1, 0, 1) * dx;
  const float d11 = texel(0, 1, 1) * (1.0f - dx) + texel(1, 1, 1) * dx;
  const float d0 = d00 * (1.0f - dy) + d10 * dy;
  const float d1 = d01 * (1.0f - dy) + d11 * dy;
  return d0 * (1.0f - dz) + d1 * dz;
}

// One exponential step of the tracking walks in medium units
__device__ __forceinline__ float track_step(const VolParams& v, float t, float u) {
  return t - logf(fmaxf(1.0f - u, 1e-12f)) * v.inv_max / fmaxf(v.sigma_t[0], 1e-20f);
}

// Delta tracking (grid.rs:162-207): true and the world-space distance when
// the ray scatters before seg_len
__device__ bool delta_track(const VolParams& v, const float* __restrict__ dens, float ox,
                            float oy, float oz, float dx, float dy, float dz, float seg_len,
                            uint32_t& state, float& t_world) {
  const MediumSegment s = to_medium(v, ox, oy, oz, dx, dy, dz, seg_len);
  if (!s.overlap) return false;
  float t = s.tmin;
  for (;;) {
    t = track_step(v, t, chain_next(state));
    if (!(t < s.tmax)) return false;
    const float d = grid_density(v, dens, s.ox + s.dx * t, s.oy + s.dy * t, s.oz + s.dz * t);
    if (d * v.inv_max > chain_next(state)) {
      t_world = t / fmaxf(s.scale, 1e-20f);
      return true;
    }
  }
}

// Ratio tracking (grid.rs:119-160) with its Russian roulette below 0.1
__device__ float ratio_track(const VolParams& v, const float* __restrict__ dens, float ox,
                             float oy, float oz, float dx, float dy, float dz, float seg_len,
                             uint32_t& state) {
  const MediumSegment s = to_medium(v, ox, oy, oz, dx, dy, dz, seg_len);
  float tr = 1.0f;
  if (!s.overlap) return tr;
  float t = s.tmin;
  for (;;) {
    t = track_step(v, t, chain_next(state));
    if (!(t < s.tmax)) return tr;
    const float d = grid_density(v, dens, s.ox + s.dx * t, s.oy + s.dy * t, s.oz + s.dz * t);
    tr = tr * (1.0f - fmaxf(d * v.inv_max, 0.0f));
    if (tr < 0.1f) {
      const float u = chain_next(state);
      const float q = fmaxf(1.0f - tr, 0.05f);
      if (u < q) return 0.0f;
      tr = tr / (1.0f - q);
    }
  }
}

// ---- one sample pass per thread ----

// The chunked instances' largest block (choose_block)
constexpr int VOL_BLOCK_MAX = 256;
// kCapRegs: the chunked instance of homogeneous media, capped by
// __launch_bounds__ to the registers of this many VOL_BLOCK_MAX blocks an SM
// (85: six blocks of 128 where the uncapped instance's 109 fit four); its
// loop spills little under the cap.  Grid media take the uncapped instance:
// under the cap their tracking loops spill more than the warps gain.
constexpr int VOL_CAP_BLOCKS = 3;

// The BVH instances: the walk of the node64 rows, inlined at its two call
// sites (the closest hit and the shadow ray of each bounce), each leaf row
// loaded when it is tested and meeting the division-free reject first, in
// blocks of BLOCK threads under a launch bound that keeps VOL_BVH_MIN_BLOCKS
// of them resident an SM (56 registers, where the occupancy API's choice was
// 4 blocks at 111): the walks wait on dependent loads, and more resident warps
// hide them, in both media.  Each choice won on the card (PERF.md §6:
// `walk_ab --variant call_walks`, `VOL_BVH_MIN_BLOCKS=1`,
// `VOL_LEAF_PREFETCH=true`, `no_reject`).
constexpr int VOL_BVH_MIN_BLOCKS = 9;
constexpr bool VOL_LEAF_PREFETCH = false;

// The triangle walk of an instance: the BVH's node64 rows, the chunked brute
// force, or the brute force over every row
template <bool kBvh, bool kChunk>
using VolGeometry = std::conditional_t<
    kBvh,
    Bvh64Geometry<STACK_DEPTH, false, Bvh64<STACK_DEPTH, VOL_LEAF_PREFETCH>>,
    std::conditional_t<kChunk, ChunkGeometry, Geometry<false>>>;

template <bool kBvh, bool kRaysIn, bool kChunk>
__device__ __forceinline__ void volpath_mega_pass(
    const float* __restrict__ table, int n_tris, const float* __restrict__ chunks, int n_chunks,
    const float4* __restrict__ nodes64, const float4* __restrict__ prims, int root_count,
    const float* __restrict__ in_a, const float* __restrict__ in_d,
    const float* __restrict__ in_w, const int* __restrict__ pid, const int* __restrict__ sid,
    float* __restrict__ out_l, float* __restrict__ out_w, int n, const Params& p,
    const VolParams& v, const float* __restrict__ density) {
  extern __shared__ float4 s_dyn[];  // brute force: (the chunk rows, then) the rows
  const VolGeometry<kBvh, kChunk> geom = [&] {
    if constexpr (kBvh)
      return VolGeometry<true, false>{{nodes64, prims, root_count}, table};
    else if constexpr (kChunk)
      return load_chunk_geometry<TABLE_COLS>(s_dyn, table, n_tris, chunks, n_chunks);
    else
      return load_geometry<false>(reinterpret_cast<float*>(s_dyn), table, n_tris, nullptr,
                                  nullptr);
  }();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Sampler smp{(uint32_t)pid[i], (uint32_t)sid[i], &p};

  float ox, oy, oz, dx, dy, dz, weight;
  if constexpr (kRaysIn) {
    ox = in_a[3 * i], oy = in_a[3 * i + 1], oz = in_a[3 * i + 2];
    dx = in_d[3 * i], dy = in_d[3 * i + 1], dz = in_d[3 * i + 2];
    weight = in_w[i];
  } else {
    raygen(p, smp, in_a[2 * i], in_a[2 * i + 1], ox, oy, oz, dx, dy, dz, weight);
  }

  float Lr = 0.0f, Lg = 0.0f, Lb = 0.0f;
  float br = 1.0f, bg = 1.0f, bb = 1.0f;
  float es = 1.0f;  // etaScale (volpath.rs:180-194)
  uint32_t state = hash_combine(smp.pid, smp.sid);
  bool active = weight > 0.0f;
  for (int bounce = 0; bounce < p.max_depth && active; ++bounce) {
    const int dim0 = 8 + bounce * 8;  // sampler/dims.volpath_dim0
    float t;
    const int best = geom.closest(ox, oy, oz, dx, dy, dz, t);
    const bool found = t < BIG_T;
    const float seg_len = found ? t : v.seg_escape;

    // ---- the medium over the segment (volpath.rs:70-85) ----
    bool in_medium;
    float t_med = seg_len;
    if (!v.grid) {
      const float u_ch = chain_next(state);
      const float u_d = chain_next(state);
      const int channel = min((int)(u_ch * 3.0f), 2);
      const float dist = -logf(fmaxf(1.0f - u_d, 1e-12f)) / fmaxf(v.sigma_t[channel], 1e-20f);
      const float t_h = fminf(dist, seg_len);
      in_medium = dist < seg_len;
      float tr[3], dens[3];
      for (int c = 0; c < 3; ++c) {
        tr[c] = expf(-v.sigma_t[c] * t_h);
        dens[c] = in_medium ? v.sigma_t[c] * tr[c] : tr[c];
      }
      float pdf = (dens[0] + dens[1] + dens[2]) / 3.0f;
      if (pdf == 0.0f) pdf = 1.0f;
      br = br * ((in_medium ? tr[0] * v.sigma_s[0] : tr[0]) / pdf);
      bg = bg * ((in_medium ? tr[1] * v.sigma_s[1] : tr[1]) / pdf);
      bb = bb * ((in_medium ? tr[2] * v.sigma_s[2] : tr[2]) / pdf);
      if (in_medium) t_med = t_h;
    } else {
      in_medium = delta_track(v, density, ox, oy, oz, dx, dy, dz, seg_len, state, t_med);
      if (in_medium) {
        br = br * (v.sigma_s[0] / fmaxf(v.sigma_t[0], 1e-20f));
        bg = bg * (v.sigma_s[1] / fmaxf(v.sigma_t[1], 1e-20f));
        bb = bb * (v.sigma_s[2] / fmaxf(v.sigma_t[2], 1e-20f));
      }
    }
    if (!(br > 0.0f || bg > 0.0f || bb > 0.0f)) break;
    if (!(found || in_medium)) break;

    // the vertex: a medium point, or the surface hit with its frame
    const float tv = in_medium ? t_med : t;
    const float px = ox + dx * tv, py = oy + dy * tv, pz = oz + dz * tv;
    const float wox = -dx, woy = -dy, woz = -dz;
    const float* row = table + (size_t)(best < 0 ? 0 : best) * TABLE_COLS;
    float ngx = 0.0f, ngy = 0.0f, ngz = 0.0f;
    float ssx = 0.0f, ssy = 0.0f, ssz = 0.0f, tsx = 0.0f, tsy = 0.0f, tsz = 0.0f;
    float wol_x = 0.0f, wol_y = 0.0f, wo_z = 0.0f;
    int n_lob = 0;
    if (!in_medium) {
      ngx = __ldg(row + 9);
      ngy = __ldg(row + 10);
      ngz = __ldg(row + 11);
      n_lob = (int)__ldg(row + 15);
      shading_frame(ngx, ngy, ngz, __ldg(row + 12), __ldg(row + 13), __ldg(row + 14), ssx, ssy,
                    ssz, tsx, tsy, tsz);
      wol_x = dot3(wox, woy, woz, ssx, ssy, ssz);
      wol_y = dot3(wox, woy, woz, tsx, tsy, tsz);
      wo_z = dot3(wox, woy, woz, ngx, ngy, ngz);
    }
    const float mag = fabsf(px) + fabsf(py) + fabsf(pz);
    const float eps = 1e-4f + 1e-5f * mag;

    // ---- NEE: power pick + estimate_direct with media (volpath.rs:101-127) ----
    {
      const float u_pick = smp.get_1d(dim0);
      int li = 0;
      for (int k = 1; k < p.n_lights; ++k)
        if (u_pick >= v.cdf[k]) li = k;
      const float ppdf = v.pick_pdf[li];
      float wix, wiy, wiz, lpx, lpy, lpz, ls_pdf;
      float lrad[3];
      bool delta = true;
      const float* lp = p.light_p + 3 * li;
      const float* le = p.light_emit + 3 * li;
      if (v.all_point) {  // delta lights only: no light sample is drawn
        const float tlx = lp[0] - px, tly = lp[1] - py, tlz = lp[2] - pz;
        const float dist2 = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-20f);
        const float inv_d = rsqrt_exact(dist2);
        wix = tlx * inv_d;
        wiy = tly * inv_d;
        wiz = tlz * inv_d;
        for (int c = 0; c < 3; ++c) lrad[c] = le[c] / dist2;
        ls_pdf = 1.0f;
        lpx = lp[0];
        lpy = lp[1];
        lpz = lp[2];
      } else {
        float ul0, ul1;
        smp.get_2d(dim0 + 1, ul0, ul1);
        if (v.light_kind[li] == LIGHT_POINT_KIND) {
          const float tlx = lp[0] - px, tly = lp[1] - py, tlz = lp[2] - pz;
          const float dist2 = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-20f);
          const float sq = sqrtf(dist2);
          wix = tlx / sq;
          wiy = tly / sq;
          wiz = tlz / sq;
          for (int c = 0; c < 3; ++c) lrad[c] = le[c] / dist2;
          ls_pdf = 1.0f;
          lpx = lp[0];
          lpy = lp[1];
          lpz = lp[2];
        } else {
          sample_sphere_light(v.sph_o2w + 12 * li, v.sph_w2o + 9 * li, v.sph_radius[li], le, px,
                              py, pz, ul0, ul1, wix, wiy, wiz, lrad, ls_pdf, lpx, lpy, lpz);
          delta = false;
        }
      }
      // the phase function at a medium point; at a surface the
      // non-specular lobes times |cos|, MIS against their mean pdf
      float f[3];
      float scat_pdf;
      int n_nonspec = 0;
      const float wi_ng = dot3(wix, wiy, wiz, ngx, ngy, ngz);
      if (in_medium) {
        const float ph = phase_hg(dot3(wox, woy, woz, wix, wiy, wiz), v.g);
        f[0] = f[1] = f[2] = ph;
        scat_pdf = ph;
      } else {
        const float wil_x = dot3(wix, wiy, wiz, ssx, ssy, ssz);
        const float wil_y = dot3(wix, wiy, wiz, tsx, tsy, tsz);
        const bool f_gate = (wi_ng * wo_z) > 0.0f && wo_z != 0.0f;
        float fn[3] = {0.0f, 0.0f, 0.0f};
        float pdf_s = 0.0f;
        for (int l = 0; l < n_lob; ++l) {
          const Lobe lob = load_lobe(row, l);
          if (is_spec_kind(lob.kind)) continue;
          ++n_nonspec;
          if (f_gate) {
            float lf[3];
            lobe_f(lob, wol_x, wol_y, wo_z, wil_x, wil_y, wi_ng, lf);
            for (int c = 0; c < 3; ++c) fn[c] = fn[c] + lf[c];
          }
          if (!v.all_point) pdf_s = pdf_s + lobe_pdf(lob, wol_x, wol_y, wo_z, wil_x, wil_y, wi_ng);
        }
        const float cos_ns = fabsf(wi_ng);
        for (int c = 0; c < 3; ++c) f[c] = fn[c] * cos_ns;
        scat_pdf = (wo_z != 0.0f && n_nonspec > 0) ? pdf_s / (float)max(n_nonspec, 1) : 0.0f;
      }
      const float w_mis = delta ? 1.0f : power_heuristic(ls_pdf, scat_pdf);
      const bool any_li = lrad[0] > 0.0f || lrad[1] > 0.0f || lrad[2] > 0.0f;
      const bool any_f = f[0] > 0.0f || f[1] > 0.0f || f[2] > 0.0f;
      const bool live = (in_medium || n_nonspec > 0) && ls_pdf > 0.0f && any_li && any_f;

      // the shadow ray: from a surface offset along ng toward the light,
      // from a medium point in place
      const float off = wi_ng < 0.0f ? -eps : eps;
      const float sox = in_medium ? px : px + ngx * off;
      const float soy = in_medium ? py : py + ngy * off;
      const float soz = in_medium ? pz : pz + ngz * off;
      const float svx = lpx - sox, svy = lpy - soy, svz = lpz - soz;
      const float seg = sqrtf(svx * svx + svy * svy + svz * svz);
      const float inv_seg = 1.0f / fmaxf(seg, 1e-20f);
      const float sdx = svx * inv_seg, sdy = svy * inv_seg, sdz = svz * inv_seg;
      const bool occ = live && geom.occluded(sox, soy, soz, sdx, sdy, sdz, SHADOW_T_MAX * seg);
      float tr[3];
      if (!v.grid) {
        for (int c = 0; c < 3; ++c) tr[c] = expf(-v.sigma_t[c] * seg);
      } else {
        tr[0] = tr[1] = tr[2] =
            ratio_track(v, density, sox, soy, soz, sdx, sdy, sdz, seg, state);
      }
      if (live && !occ) {
        const float inv_pp = 1.0f / fmaxf(ppdf, 1e-20f);
        const float scale = w_mis * inv_pp / fmaxf(ls_pdf, 1e-20f);
        Lr = Lr + br * f[0] * lrad[0] * tr[0] * scale;
        Lg = Lg + bg * f[1] * lrad[1] * tr[1] * scale;
        Lb = Lb + bb * f[2] * lrad[2] * tr[2] * scale;
      }
    }

    // ---- the next direction: HG at a medium point, the BSDF at a surface ----
    float ub0, ub1;
    smp.get_2d(dim0 + 3, ub0, ub1);
    if (in_medium) {
      hg_sample(wox, woy, woz, v.g, ub0, dx, dy, dz);
      ox = px;
      oy = py;
      oz = pz;
    } else {
      const BsdfSample bs = bsdf_sample(row, n_lob, wol_x, wol_y, wo_z, ub0, ub1);
      const float nwx = ssx * bs.wx + tsx * bs.wy + ngx * bs.wz;
      const float nwy = ssy * bs.wx + tsy * bs.wy + ngy * bs.wz;
      const float nwz = ssz * bs.wx + tsz * bs.wy + ngz * bs.wz;
      const float cosw = fabsf(dot3(nwx, nwy, nwz, ngx, ngy, ngz));
      const bool any_fs = bs.f[0] != 0.0f || bs.f[1] != 0.0f || bs.f[2] != 0.0f;
      if (!(n_lob > 0 && wo_z != 0.0f && bs.pdf > 0.0f && any_fs)) break;
      const float inv_pdf = cosw / fmaxf(bs.pdf, 1e-20f);
      br = br * bs.f[0] * inv_pdf;
      bg = bg * bs.f[1] * inv_pdf;
      bb = bb * bs.f[2] * inv_pdf;
      // etaScale: a transmitted fresnel-specular sample, entering test on ng
      if (bs.transmitted) {
        const float e2 = __ldg(row + 31) * __ldg(row + 31);
        es = es * (wo_z > 0.0f ? e2 : 1.0f / fmaxf(e2, 1e-20f));
      }
      // next ray, offset along ng to the sampled side
      const float off2 = dot3(nwx, nwy, nwz, ngx, ngy, ngz) < 0.0f ? -eps : eps;
      ox = px + ngx * off2;
      oy = py + ngy * off2;
      oz = pz + ngz * off2;
      dx = nwx;
      dy = nwy;
      dz = nwz;
    }

    // ---- Russian roulette (volpath.rs:238-250) on beta * etaScale ----
    if (bounce > 3) {
      const float beta_max = fmaxf(br, fmaxf(bg, bb)) * es;
      if (beta_max < p.rr_threshold) {
        const float q = fmaxf(0.05f, 1.0f - beta_max);
        if (smp.get_1d(dim0 + 4) < q) break;
        const float inv_q = 1.0f / fmaxf(1.0f - q, 1e-9f);
        br = br * inv_q;
        bg = bg * inv_q;
        bb = bb * inv_q;
      }
    }
  }
  out_l[3 * i + 0] = Lr;
  out_l[3 * i + 1] = Lg;
  out_l[3 * i + 2] = Lb;
  if constexpr (!kRaysIn) out_w[i] = weight;
}

#define VOL_MEGA_PARAMS                                                                         \
  const float *__restrict__ table, int n_tris, const float *__restrict__ chunks, int n_chunks,  \
      const float4 *__restrict__ nodes64, const float4 *__restrict__ prims, int root_count,     \
      const float *__restrict__ in_a, const float *__restrict__ in_d,                           \
      const float *__restrict__ in_w, const int *__restrict__ pid,                              \
      const int *__restrict__ sid, float *__restrict__ out_l, float *__restrict__ out_w, int n, \
      const __grid_constant__ Params p, const __grid_constant__ VolParams v,                    \
      const float *__restrict__ density
#define VOL_MEGA_ARGS                                                                          \
  table, n_tris, chunks, n_chunks, nodes64, prims, root_count, in_a, in_d, in_w, pid, sid, \
      out_l, out_w, n, p, v, density

// The brute-force instances (kBvh false, kept a template argument so that
// they keep their names)
template <bool kBvh, bool kRaysIn, bool kChunk = false, bool kCapRegs = false>
__global__ void __launch_bounds__(kChunk ? VOL_BLOCK_MAX : BLOCK, kCapRegs ? VOL_CAP_BLOCKS : 1)
    volpath_mega_kernel(VOL_MEGA_PARAMS) {
  static_assert(!kBvh, "the BVH instances are volpath_mega_bvh_kernel");
  volpath_mega_pass<false, kRaysIn, kChunk>(VOL_MEGA_ARGS);
}

// The BVH instances: blocks of BLOCK threads, VOL_BVH_MIN_BLOCKS of them
// resident an SM
template <bool kRaysIn>
__global__ void __launch_bounds__(BLOCK, VOL_BVH_MIN_BLOCKS)
    volpath_mega_bvh_kernel(VOL_MEGA_PARAMS) {
  volpath_mega_pass<true, kRaysIn, false>(VOL_MEGA_ARGS);
}

// The last launch's block size, blocks resident per SM, registers per
// thread and dynamic shared memory bytes: chunked brute force, then BVH
int g_occupancy[2][4] = {};

template <bool kRaysIn>
int launch(const float* table, int n_tris, const float* nodes64, const float* prims,
           int root_count, const Params* params, const float* in_a, const float* in_d,
           const float* in_w, const int* pid, const int* sid, float* out_l, float* out_w, int n,
           void* stream, const VolParams* vol, const float* density, const float* chunks,
           int n_chunks) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (n <= 0) return 0;
  if (params->n_lights < 1 || params->n_lights > LIGHT_MAX) return (int)cudaErrorInvalidValue;
  if (vol->grid && (density == nullptr || vol->nx < 1 || vol->ny < 1 || vol->nz < 1))
    return (int)cudaErrorInvalidValue;
  const int grid = (n + BLOCK - 1) / BLOCK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (prims != nullptr) {
    if (n_tris <= 0 || n_tris > BVH_TRI_MAX || table == nullptr || root_count < 0 ||
        root_count > n_tris || (root_count == 0) != (nodes64 != nullptr))
      return (int)cudaErrorInvalidValue;
    const auto kernel = volpath_mega_bvh_kernel<kRaysIn>;
    // blocks of BLOCK (the launch bound); choose_block measures their occupancy
    int block = BLOCK;
    const cudaError_t err =
        choose_block(kernel, BLOCK, [](int) { return (size_t)0; }, block, g_occupancy[1]);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, BLOCK, 0, st>>>(table, n_tris, nullptr, 0,
                                   reinterpret_cast<const float4*>(nodes64),
                                   reinterpret_cast<const float4*>(prims), root_count, in_a, in_d,
                                   in_w, pid, sid, out_l, out_w, n, *params, *vol, density);
    return (int)cudaGetLastError();
  }
  if (n_tris <= 0 || n_tris > TRI_MAX) return (int)cudaErrorInvalidValue;
  if (chunks != nullptr) {
    if (n_chunks <= 0 || n_chunks > CHUNK_MAX) return (int)cudaErrorInvalidValue;
    const auto kernel = vol->grid ? volpath_mega_kernel<false, kRaysIn, true>
                                  : volpath_mega_kernel<false, kRaysIn, true, true>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)CHUNK_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    // every block stages the whole table: choose_block weighs the threads resident
    const size_t smem = chunk_smem(n_tris, n_chunks);
    int block = BLOCK;
    err = choose_block(kernel, VOL_BLOCK_MAX, [&](int) { return smem; }, block, g_occupancy[0]);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(n + block - 1) / block, block, smem, st>>>(
        table, n_tris, chunks, n_chunks, nullptr, nullptr, 0, in_a, in_d, in_w, pid, sid, out_l,
        out_w, n, *params, *vol, density);
    return (int)cudaGetLastError();
  }
  // the whole TRI_MAX table exceeds the 48 KB default for dynamic shared memory
  const cudaError_t attr =
      cudaFuncSetAttribute(volpath_mega_kernel<false, kRaysIn>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = (size_t)n_tris * GEO_COLS * sizeof(float);
  volpath_mega_kernel<false, kRaysIn><<<grid, BLOCK, smem, st>>>(
      table, n_tris, nullptr, 0, nullptr, nullptr, 0, in_a, in_d, in_w, pid, sid, out_l, out_w, n,
      *params, *vol, density);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one sample pass on `stream`: brute force when prims is null (the
// chunked walk over the (n_chunks, CHUNK_COLS) rows `chunks` that cover the
// table, or the walk over every row where chunks is null), else the walk of
// the BVH's node64 rows `nodes64` (null where the tree is one leaf of
// root_count rows; root_count 0 otherwise) over the (n_tris, 12) float32 leaf
// rows `prims` (p0, e1, e2, pad), the table in the same leaf order;
// `density` is the (nz, ny, nx) grid, null for a homogeneous medium.
// Returns cudaGetLastError() of the launch (0 when it was accepted);
// nothing is synchronised.
int volpath_mega_cam_launch(const float* table, int n_tris, const float* nodes64,
                            const float* prims, const Params* params, const float* pixel_xy,
                            const int* pid, const int* sid, float* out_l, float* out_w, int n,
                            void* stream, const VolParams* vol, const float* density,
                            const float* chunks, int n_chunks, int root_count) {
  return launch<false>(table, n_tris, nodes64, prims, root_count, params, pixel_xy, nullptr,
                       nullptr, pid, sid, out_l, out_w, n, stream, vol, density, chunks,
                       n_chunks);
}

// The same on given rays: o, d (n, 3) and weight (n,), every ray in the
// camera medium; out_l only.
int volpath_mega_rays_launch(const float* table, int n_tris, const float* nodes64,
                             const float* prims, const Params* params, const float* o,
                             const float* d, const float* weight, const int* pid,
                             const int* sid, float* out_l, int n, void* stream,
                             const VolParams* vol, const float* density, const float* chunks,
                             int n_chunks, int root_count) {
  return launch<true>(table, n_tris, nodes64, prims, root_count, params, o, d, weight, pid, sid,
                      out_l, nullptr, n, stream, vol, density, chunks, n_chunks);
}

const char* volpath_mega_cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int volpath_mega_cam_params_size() { return (int)sizeof(Params); }

int volpath_mega_cam_vol_params_size() { return (int)sizeof(VolParams); }

// The last chunked (bvh 0) or BVH (bvh 1) launch's block size, blocks per
// SM, registers per thread and dynamic shared memory bytes, into out[0..3]
void volpath_mega_occupancy(int bvh, int* out) {
  for (int k = 0; k < 4; ++k) out[k] = g_occupancy[bvh != 0][k];
}

}  // extern "C"
