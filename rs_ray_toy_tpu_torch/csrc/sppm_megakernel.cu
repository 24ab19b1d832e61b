// The SPPM iteration's three kernels for Hopper (sm_90a).
//
// K8, sppm_camera_kernel, one thread per pixel: replaces the TPU kernels
// rs_ray_toy_tpu/ops/sppm_megakernel.py · _kernel_cam (brute force,
// pallas_call in _run_cam for T <= 2048) and _kernel_bvh_cam (the in-kernel
// BVH), both running _camera_loop, and (kRaysIn, on given rays o, d, weight:
// sppm_camera_mega) _kernel and _kernel_bvh (pallas_call in _run).  The lens
// trace (raygen_u) from the film and lens slots, or the given ray, then per
// depth the closest hit, one point light picked
// uniformly and its NEE with an any-hit shadow ray (scale cos * n_lights /
// dist^2), the visible point (VP) at the first vertex with a diffuse lobe or
// a glossy vertex at the last depth (beta before the bounce), else a BSDF
// sample and the camera roulette on the new beta's luminance (continue with
// probability min(y, 1) when y < 0.25).  Every sampler value is read from
// the (NC, N) Halton slot matrix (ops/sppm_megakernel.sppm_slots).
//
// K9, sppm_photon_kernel, one thread per photon: replaces _photon_kernel and
// _photon_kernel_bvh (_photon_loop, pallas_call in _photon_run).  From the
// emitted ray, per depth the closest hit; at depth >= 1 a deposit event (the
// hit, -d, beta before this vertex's bounce, and whether the photon is still
// alive after the hit test), depth-major; then a BSDF sample and the photon
// roulette q = max(0, 1 - y(new) / y(old)), killed when u < q.
//
// K10, sppm_deposit_kernel, one thread per VP in pixel order: replaces
// _deposit_kernel (pallas_call in _deposit_run).  The events come
// Morton-sorted from torch (ops/sppm_megakernel.deposit_inputs) with each
// VP's range of sorted events [searchsorted(morton(cmin)),
// searchsorted(morton(cmax), right)): Morton order is monotone, so the range
// holds every event whose cell lies in the VP's p +- r cell box.  The thread
// adds, over its range in order, for an event within the radius (|p_ev -
// p_vp|^2 <= r^2), beta_ev * f(wo, wi) over the VP material's lobes when wi
// lies on wo's side of ng, and one to M; every other event adds 0.  No
// atomics: each VP owns its sums, so they are deterministic.  (The JAX kernel
// walks per-1024-VP tile ranges in chunks of 8192 events, a VMEM limit; the
// per-VP range is a subset of its tile's, and the events outside it add 0.)
// Most VPs have an empty range (95-99% on the SPPM fixtures): such a thread
// writes zeros and leaves before it reads its VP.  A warp's walking lanes
// read the rows of their ranges once, coalesced, into a per-warp tile in
// shared memory; each lane tests the tile's rows of its own range, and the
// lanes then evaluate the lobes of their shaded pairs together.
//
// What bounds them on this card: K8 and K9 are the path kernel's shape,
// divergent per-thread FP32 work over read-only tables (the chunked walk's
// rows staged in shared memory, or the BVH through the read-only cache); K10
// is the bytes of the walking VPs and of the events their ranges hold, about
// 40 bytes an event, and the lobe evaluations of the few near pairs.  The
// events of one iteration fit in L2 (262,144 x 40 B at the fixture).
//
// The lobes: every kernel takes a last template flag kWide.  Without it (the
// base instances) a walk samples and evaluates lambert, the microfacet and
// the specular reflection kinds, and a VP is a lambert (diffuse) or
// microfacet (glossy) vertex.  With it (the wide instances, chosen only for
// a scene with a Disney lobe or specular transmission:
// ops/sppm_megakernel.wide_lobes) the lobe set of the JAX kernels'
// supports_sppm_camera: common.cuh's lobe_f<true> and bsdf_sample<true,
// true> add Disney's diffuse, retro, sheen, clearcoat and microfacet lobes
// and the specular transmission of glass (refraction with the radiance
// scale (eta_i / eta_t)^2, in the photon walk too, as the JAX kernels'
// _bsdf_sample_k scales it), and the VP classes add Disney's diffuse, retro
// and sheen (diffuse) and its clearcoat and microfacet (glossy).  A specular
// vertex makes no VP; the walk goes through it.  The flag leaves the base
// instances' code as it was.
//
// K8's and K9's geometry is their siblings' (the path, direct and Volpath
// kernels'): brute force the chunked walk (common.cuh ChunkGeometry: the chunk
// boxes and the rows' intersect columns staged in shared memory, a chunk's
// rows run only where its box is hit, each behind the division-free reject),
// over a BVH the walk of its node64 rows and 48-byte leaf rows
// (Bvh64Geometry), the any-hit shadow ray stopping at the first row it hits.
// Both visit in the order of the walks they replace (table order; the
// fused-children order), so every hit, and every output, is theirs.  The
// three kernels take no register cap: each launch runs in the block of
// BLOCK..SPPM_BLOCK_MAX that keeps the most threads resident an SM
// (choose_block, at an instance's first launch and again only for a
// brute-force table of another size; a large table's shared memory leaves
// few blocks resident, and there larger blocks keep more threads).
//
// Numerics follow the plain PyTorch versions (ops/sppm_megakernel.py)
// expression by expression; see common.cuh.

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int EV_COLS = 10;                       // p, wi, beta, live
constexpr int MAT_COLS = 16 + 16 * 5;             // a resolved material row
// luminance weights (core/spectrum.luminance), rounded as the plain
// version's python floats are
constexpr float LUM_R = (float)0.212671, LUM_G = (float)0.715160, LUM_B = (float)0.072169;

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return LUM_R * r + LUM_G * g + LUM_B * b;
}

// the VP classes (ops/sppm_megakernel.DIFFUSE_KINDS / GLOSSY_KINDS)
template <bool kWide>
__device__ __forceinline__ bool diffuse_kind(int k) {
  return k == LOBE_LAMBERT_REFL ||
         (kWide && (k == LOBE_DISNEY_DIFFUSE || k == LOBE_DISNEY_RETRO || k == LOBE_DISNEY_SHEEN));
}
template <bool kWide>
__device__ __forceinline__ bool glossy_kind(int k) {
  return k == LOBE_MF_REFL ||
         (kWide && (k == LOBE_DISNEY_CLEARCOAT || k == LOBE_DISNEY_MICROFACET_REFL));
}

// ---- K8: the camera walk ----

// K8's, K9's and K10's largest block.  Without a register cap (~80 registers, 6 blocks of
// 128 an SM) K8 ran 5-15% faster over a BVH and within the noise on brute
// force than under the direct kernel's bound for 9 blocks (56 registers, 200-
// 300 B of spill stores), and the 1,896-row grid's blocks of 320 48% faster
// than its 3 of 128 (PERF.md §6, `walk_ab --variant k8_capped`).  Uncapped,
// the BVH walk keeps the next leaf row's loads in flight (Bvh64's default):
// 6-13% faster than loading each row when tested (`--variant no_prefetch`).
constexpr int SPPM_BLOCK_MAX = 384;

// Brute force: the chunked walk over the n_chunks chunk rows geo_a and the
// n_tris rows of `table`, both staged in shared memory (geo_b null).  BVH
// (kBvh): geo_a holds the node64 rows (null for a tree that is one leaf of
// root_count rows) and geo_b the 48-byte leaf rows, both read as float4 rows.
template <bool kBvh, bool kRaysIn, bool kWide = false>
__global__ void __launch_bounds__(SPPM_BLOCK_MAX)
    sppm_camera_kernel(const float* __restrict__ table, int n_tris,
                       const float* __restrict__ geo_a, const float* __restrict__ geo_b,
                       const float* __restrict__ in_a, const float* __restrict__ in_d,
                       const float* __restrict__ in_w, const float* __restrict__ u,
                       float* __restrict__ out_ld, float* __restrict__ out_p,
                       float* __restrict__ out_wo, float* __restrict__ out_beta,
                       float* __restrict__ out_ng, float* __restrict__ out_dpdu,
                       int* __restrict__ out_mat, int* __restrict__ out_valid, int n,
                       const __grid_constant__ Params p, int root_count, int n_chunks) {
  extern __shared__ float4 s_dyn[];  // brute force: the chunk rows, then the rows
  const auto geom = [&] {
    if constexpr (kBvh)
      return Bvh64Geometry<STACK_DEPTH>{{reinterpret_cast<const float4*>(geo_a),
                                         reinterpret_cast<const float4*>(geo_b), root_count},
                                        table};
    else
      return load_chunk_geometry<TABLE_COLS>(s_dyn, table, n_tris, geo_a, n_chunks);
  }();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // slot matrix rows: film (0, 1), lens (2, 3; unread on given rays), then
  // per depth the light pick, and but at the last depth the BSDF pair and
  // the roulette
  auto uv = [&](int row) { return u[(size_t)row * n + i]; };

  float ox, oy, oz, dx, dy, dz, weight;
  if constexpr (kRaysIn) {
    ox = in_a[3 * i], oy = in_a[3 * i + 1], oz = in_a[3 * i + 2];
    dx = in_d[3 * i], dy = in_d[3 * i + 1], dz = in_d[3 * i + 2];
    weight = in_w[i];
  } else {
    raygen_u(p, uv(0), uv(1), uv(2), uv(3), in_a[2 * i], in_a[2 * i + 1], ox, oy, oz, dx, dy, dz,
             weight);
  }

  bool active = weight > 0.0f;
  float br = active ? weight : 0.0f, bg = br, bb = br;
  float ldr = 0.0f, ldg = 0.0f, ldb = 0.0f;
  float vp[15] = {};  // p, wo, beta, ng, dpdu
  int vp_mat = 0, vp_valid = 0;
  for (int depth = 0; depth < p.max_depth && active; ++depth) {
    const int col = 4 + 4 * depth;
    float t;
    const int best = geom.closest(ox, oy, oz, dx, dy, dz, t);
    if (!(t < BIG_T)) break;
    const float* row = table + (size_t)best * TABLE_COLS;
    const float ngx = __ldg(row + 9), ngy = __ldg(row + 10), ngz = __ldg(row + 11);
    const float dux = __ldg(row + 12), duy = __ldg(row + 13), duz = __ldg(row + 14);
    const int n_lob = (int)__ldg(row + 15);
    const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
    float ssx, ssy, ssz, tsx, tsy, tsz;
    shading_frame(ngx, ngy, ngz, dux, duy, duz, ssx, ssy, ssz, tsx, tsy, tsz);
    const float wox = -dx, woy = -dy, woz = -dz;
    const float wol_x = dot3(wox, woy, woz, ssx, ssy, ssz);
    const float wol_y = dot3(wox, woy, woz, tsx, tsy, tsz);
    const float wo_z = dot3(wox, woy, woz, ngx, ngy, ngz);
    const float mag = fabsf(px) + fabsf(py) + fabsf(pz);
    const float eps = 1e-4f + 1e-5f * mag;

    // ---- NEE: one light picked uniformly (uniform_sample_one_light) ----
    {
      const int li = min((int)(uv(col) * (float)p.n_lights), p.n_lights - 1);
      const float lpx = p.light_p[3 * li], lpy = p.light_p[3 * li + 1],
                  lpz = p.light_p[3 * li + 2];
      const float tlx = lpx - px, tly = lpy - py, tlz = lpz - pz;
      const float dist2 = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-20f);
      const float inv_d = rsqrt_exact(dist2);
      const float wix = tlx * inv_d, wiy = tly * inv_d, wiz = tlz * inv_d;
      const float wil_x = dot3(wix, wiy, wiz, ssx, ssy, ssz);
      const float wil_y = dot3(wix, wiy, wiz, tsx, tsy, tsz);
      const float wi_ng = dot3(wix, wiy, wiz, ngx, ngy, ngz);
      const bool f_gate = (wi_ng * wo_z) > 0.0f && wo_z != 0.0f;
      float fn[3] = {0.0f, 0.0f, 0.0f};
      if (f_gate) {
        for (int l = 0; l < n_lob; ++l) {
          float lf[3];
          lobe_f<kWide>(load_lobe(row, l), wol_x, wol_y, wo_z, wil_x, wil_y, wi_ng, lf);
          for (int c = 0; c < 3; ++c) fn[c] = fn[c] + lf[c];
        }
      }
      const float cos_ns = fabsf(wi_ng);
      const float off = wi_ng < 0.0f ? -eps : eps;
      const float sox = px + ngx * off, soy = py + ngy * off, soz = pz + ngz * off;
      const bool occ =
          geom.occluded(sox, soy, soz, lpx - sox, lpy - soy, lpz - soz, SHADOW_T_MAX);
      const float li_scale = occ ? 0.0f : cos_ns * (float)p.n_lights / dist2;
      ldr = ldr + br * fn[0] * p.light_emit[3 * li] * li_scale;
      ldg = ldg + bg * fn[1] * p.light_emit[3 * li + 1] * li_scale;
      ldb = ldb + bb * fn[2] * p.light_emit[3 * li + 2] * li_scale;
    }

    // ---- the VP (sppm.rs:211-232) ----
    bool diffuse = false, glossy = false;
    for (int l = 0; l < n_lob; ++l) {
      const int kind = (int)__ldg(row + 16 + 16 * l);
      diffuse = diffuse || diffuse_kind<kWide>(kind);
      glossy = glossy || glossy_kind<kWide>(kind);
    }
    if (diffuse || (glossy && depth == p.max_depth - 1)) {
      const float rec[15] = {px, py, pz, wox, woy, woz, br, bg, bb, ngx, ngy, ngz, dux, duy, duz};
      for (int k = 0; k < 15; ++k) vp[k] = rec[k];
      vp_mat = (int)__ldg(row + 47);
      vp_valid = 1;
      break;
    }
    if (depth >= p.max_depth - 1) break;

    // ---- BSDF sample and the camera roulette (sppm.rs:236-253) ----
    const BsdfSample bs =
        bsdf_sample<kWide, kWide>(row, n_lob, wol_x, wol_y, wo_z, uv(col + 1), uv(col + 2));
    const float nwx = ssx * bs.wx + tsx * bs.wy + ngx * bs.wz;
    const float nwy = ssy * bs.wx + tsy * bs.wy + ngy * bs.wz;
    const float nwz = ssz * bs.wx + tsz * bs.wy + ngz * bs.wz;
    const float cosw = fabsf(dot3(nwx, nwy, nwz, ngx, ngy, ngz));
    const bool any_f = bs.f[0] != 0.0f || bs.f[1] != 0.0f || bs.f[2] != 0.0f;
    if (!(n_lob > 0 && wo_z != 0.0f && bs.pdf > 0.0f && any_f)) break;
    const float inv_pdf = cosw / fmaxf(bs.pdf, 1e-20f);
    float bnr = br * bs.f[0] * inv_pdf;
    float bng = bg * bs.f[1] * inv_pdf;
    float bnb = bb * bs.f[2] * inv_pdf;
    const float y = luminance(bnr, bng, bnb);
    if (y < 0.25f) {
      const float cont_p = fminf(y, 1.0f);
      if (uv(col + 3) > cont_p) break;
      const float inv_cont = 1.0f / fmaxf(cont_p, 1e-9f);
      bnr = bnr * inv_cont;
      bng = bng * inv_cont;
      bnb = bnb * inv_cont;
    }
    br = bnr;
    bg = bng;
    bb = bnb;
    const float off2 = dot3(nwx, nwy, nwz, ngx, ngy, ngz) < 0.0f ? -eps : eps;
    ox = px + ngx * off2;
    oy = py + ngy * off2;
    oz = pz + ngz * off2;
    dx = nwx;
    dy = nwy;
    dz = nwz;
  }
  out_ld[3 * i + 0] = ldr;
  out_ld[3 * i + 1] = ldg;
  out_ld[3 * i + 2] = ldb;
  float* outs[5] = {out_p, out_wo, out_beta, out_ng, out_dpdu};
  for (int k = 0; k < 15; ++k) outs[k / 3][3 * i + k % 3] = vp[k];
  out_mat[i] = vp_mat;
  out_valid[i] = vp_valid;
}

// ---- K9: the photon walk ----

// K9's BVH instances keep the next leaf row's loads in flight (Bvh64's
// default) where PHOTON_LEAF_PREFETCH (`walk_ab --variant
// PHOTON_LEAF_PREFETCH=false --only k9` times the other choice).
constexpr bool PHOTON_LEAF_PREFETCH = true;

// geo_a, geo_b, root_count and n_chunks as for sppm_camera_kernel: the
// chunked walk over the chunk rows geo_a (brute force), or the node64 rows
// geo_a and leaf rows geo_b (kBvh).  The walk makes closest hits only.
template <bool kBvh, bool kWide = false>
__global__ void __launch_bounds__(SPPM_BLOCK_MAX)
    sppm_photon_kernel(const float* __restrict__ table, int n_tris,
                       const float* __restrict__ geo_a, const float* __restrict__ geo_b,
                       int max_depth, const float* __restrict__ ro, const float* __restrict__ rd,
                       const float* __restrict__ beta, const int* __restrict__ alive,
                       const float* __restrict__ u, float* __restrict__ ev_p,
                       float* __restrict__ ev_wi, float* __restrict__ ev_beta,
                       int* __restrict__ ev_live, int n, int root_count, int n_chunks) {
  extern __shared__ float4 s_dyn[];  // brute force: the chunk rows, then the rows
  const auto geom = [&] {
    if constexpr (kBvh)
      return Bvh64Geometry<STACK_DEPTH, false, Bvh64<STACK_DEPTH, PHOTON_LEAF_PREFETCH>>{
          {reinterpret_cast<const float4*>(geo_a), reinterpret_cast<const float4*>(geo_b),
           root_count},
          table};
    else
      return load_chunk_geometry<TABLE_COLS>(s_dyn, table, n_tris, geo_a, n_chunks);
  }();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float ox = ro[3 * i], oy = ro[3 * i + 1], oz = ro[3 * i + 2];
  float dx = rd[3 * i], dy = rd[3 * i + 1], dz = rd[3 * i + 2];
  float br = beta[3 * i], bg = beta[3 * i + 1], bb = beta[3 * i + 2];
  bool active = alive[i] != 0;
  for (int depth = 0; depth < max_depth; ++depth) {
    float t = BIG_T;
    int best = -1;
    if (active) best = geom.closest(ox, oy, oz, dx, dy, dz, t);
    active = active && t < BIG_T;
    const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
    if (depth > 0) {  // the deposit event of this vertex; zeros when dead
      const size_t e = (size_t)(depth - 1) * n + i;
      const float rec[9] = {px, py, pz, -dx, -dy, -dz, br, bg, bb};
      for (int k = 0; k < 9; ++k) (k < 3 ? ev_p : k < 6 ? ev_wi : ev_beta)[3 * e + k % 3] =
          active ? rec[k] : 0.0f;
      ev_live[e] = active ? 1 : 0;
    }
    if (depth >= max_depth - 1 || !active) continue;

    const float* row = table + (size_t)best * TABLE_COLS;
    const float ngx = __ldg(row + 9), ngy = __ldg(row + 10), ngz = __ldg(row + 11);
    const int n_lob = (int)__ldg(row + 15);
    float ssx, ssy, ssz, tsx, tsy, tsz;
    shading_frame(ngx, ngy, ngz, __ldg(row + 12), __ldg(row + 13), __ldg(row + 14), ssx, ssy,
                  ssz, tsx, tsy, tsz);
    const float wox = -dx, woy = -dy, woz = -dz;
    const float wol_x = dot3(wox, woy, woz, ssx, ssy, ssz);
    const float wol_y = dot3(wox, woy, woz, tsx, tsy, tsz);
    const float wo_z = dot3(wox, woy, woz, ngx, ngy, ngz);
    const float* ud = u + (size_t)(3 * depth) * n + i;
    const BsdfSample bs = bsdf_sample<kWide, kWide>(row, n_lob, wol_x, wol_y, wo_z, ud[0], ud[n]);
    const float nwx = ssx * bs.wx + tsx * bs.wy + ngx * bs.wz;
    const float nwy = ssy * bs.wx + tsy * bs.wy + ngy * bs.wz;
    const float nwz = ssz * bs.wx + tsz * bs.wy + ngz * bs.wz;
    const float cosw = fabsf(dot3(nwx, nwy, nwz, ngx, ngy, ngz));
    const bool any_f = bs.f[0] != 0.0f || bs.f[1] != 0.0f || bs.f[2] != 0.0f;
    const bool ok = n_lob > 0 && wo_z != 0.0f && bs.pdf > 0.0f && any_f;
    const float inv_pdf = cosw / fmaxf(bs.pdf, 1e-20f);
    const float bnr = br * bs.f[0] * inv_pdf;
    const float bng = bg * bs.f[1] * inv_pdf;
    const float bnb = bb * bs.f[2] * inv_pdf;
    // photon roulette (sppm.rs:497-505)
    const float q =
        fmaxf(0.0f, 1.0f - luminance(bnr, bng, bnb) / fmaxf(luminance(br, bg, bb), 1e-20f));
    active = ok && !(ud[2 * (size_t)n] < q);
    if (!active) continue;
    const float inv_cont = 1.0f / fmaxf(1.0f - q, 1e-9f);
    br = bnr * inv_cont;
    bg = bng * inv_cont;
    bb = bnb * inv_cont;
    const float mag = fabsf(px) + fabsf(py) + fabsf(pz);
    const float eps = 1e-4f + 1e-5f * mag;
    const float off2 = dot3(nwx, nwy, nwz, ngx, ngy, ngz) < 0.0f ? -eps : eps;
    ox = px + ngx * off2;
    oy = py + ngy * off2;
    oz = pz + ngz * off2;
    dx = nwx;
    dy = nwy;
    dz = nwz;
  }
}

// ---- K10: the deposit ----

constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int TILE_WORDS = WARP * EV_COLS / 2;  // a tile: WARP rows as float2 words

// One thread a VP, in pixel order.  A VP whose range is empty writes phi 0
// and M 0 and leaves before it reads its record.  The walking lanes of a
// warp read the rows their ranges hold once, WARP rows at a time, into the
// warp's two tiles in shared memory, by asynchronous copies (cp.async) that
// the walking lanes share, consecutive lanes on consecutive 8-byte words: a
// tile starts at the lowest row past the last tile that some lane's range
// holds (the gaps between the lanes' ranges are not read), and the next
// tile's copies fly while the lanes walk the current one, the first's while
// they read their VPs.  Each lane tests the tile's rows of its own range in
// ascending order (the distance and the side of wi), counts M and adds
// 0 * beta for a pair it does not shade; then the lanes evaluate the lobes
// of the pairs they shade together, each lane its own in ascending order, so
// the warp runs the lobes as often as its busiest lane needs them, not once
// for each row where any lane does.  Every term is the walk's expression,
// and every nonzero term is added in the walk's order: a 0 * beta term
// leaves a sum as it is (the sum is never -0), or makes it NaN in any order.
// Dynamic shared memory: two tiles a warp (deposit_smem).
template <bool kWide = false>
__global__ void __launch_bounds__(SPPM_BLOCK_MAX)
    sppm_deposit_kernel(const float* __restrict__ vp_p, const float* __restrict__ vp_wo,
                        const float* __restrict__ vp_ng, const float* __restrict__ vp_dpdu,
                        const int* __restrict__ vp_mat, const float* __restrict__ vp_r2,
                        const int* __restrict__ start, const int* __restrict__ end,
                        const float* __restrict__ events, const float* __restrict__ mats,
                        float* __restrict__ phi, int* __restrict__ m_out, int n) {
  extern __shared__ float2 s_tiles[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % WARP;
  int first = 0, last = 0;
  if (i < n) first = start[i], last = end[i];
  const bool walking = first < last;
  if (i < n && !walking) {
    phi[3 * i + 0] = 0.0f;
    phi[3 * i + 1] = 0.0f;
    phi[3 * i + 2] = 0.0f;
    m_out[i] = 0;
  }
  const unsigned mask = __ballot_sync(FULL_MASK, walking);
  if (!walking) return;
  const int hi = __reduce_max_sync(mask, last);
  const int rank = __popc(mask & ((1u << lane) - 1u)), n_walk = __popc(mask);
  float2* tiles = s_tiles + (threadIdx.x / WARP) * (2 * TILE_WORDS);
  // this lane's share of the copies of the tile at `base` into `tile`, one
  // commit group (empty past the span)
  const auto fetch = [&](int base, float2* tile) {
    if (base < hi) {
      // a row is 40 bytes, so every row starts 8-byte aligned
      const float2* src = reinterpret_cast<const float2*>(events + (size_t)base * EV_COLS);
      const int n_words = min(WARP, hi - base) * (EV_COLS / 2);
      for (int w = rank; w < n_words; w += n_walk)
        __pipeline_memcpy_async(tile + w, src + w, sizeof(float2));
    }
    __pipeline_commit();
  };
  // the lowest row at or past `row` that some lane's range holds (hi: none)
  const auto next_row = [&](int row) {
    return __reduce_min_sync(mask, last > row ? max(first, row) : hi);
  };
  int base = next_row(0);
  fetch(base, tiles);

  const float px = vp_p[3 * i], py = vp_p[3 * i + 1], pz = vp_p[3 * i + 2];
  const float ngx = vp_ng[3 * i], ngy = vp_ng[3 * i + 1], ngz = vp_ng[3 * i + 2];
  float ssx, ssy, ssz, tsx, tsy, tsz;
  shading_frame(ngx, ngy, ngz, vp_dpdu[3 * i], vp_dpdu[3 * i + 1], vp_dpdu[3 * i + 2], ssx, ssy,
                ssz, tsx, tsy, tsz);
  const float wox = vp_wo[3 * i], woy = vp_wo[3 * i + 1], woz = vp_wo[3 * i + 2];
  const float wol_x = dot3(wox, woy, woz, ssx, ssy, ssz);
  const float wol_y = dot3(wox, woy, woz, tsx, tsy, tsz);
  const float wo_z = dot3(wox, woy, woz, ngx, ngy, ngz);
  const float r2 = vp_r2[i];  // -1 for a VP that is not valid
  const float* mrow = mats + (size_t)vp_mat[i] * MAT_COLS;
  const int n_lob = (int)__ldg(mrow + 15);
  float pr = 0.0f, pg = 0.0f, pb = 0.0f;
  int m = 0;
  for (int cur = 0; base < hi; cur ^= 1) {
    const int next = next_row(base + WARP);
    fetch(next, tiles + (cur ^ 1) * TILE_WORDS);
    __pipeline_wait_prior(1);  // this lane's copies of the current tile have landed
    __syncwarp(mask);          // and every walking lane's
    const float* rows = reinterpret_cast<const float*>(tiles + cur * TILE_WORDS);
    const int k_end = min(last, base + WARP);
    unsigned shade = 0;  // the tile's rows whose lobes this lane evaluates
    for (int k = max(first, base); k < k_end; ++k) {
      const float* ev = rows + (k - base) * EV_COLS;
      const float ddx = px - ev[0], ddy = py - ev[1], ddz = pz - ev[2];
      const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
      const bool near = d2 <= r2 && ev[9] > 0.0f;
      bool gated = false;
      if (near) {
        const float wi_ng = ev[3] * ngx + ev[4] * ngy + ev[5] * ngz;
        gated = (wi_ng * wo_z) > 0.0f && wo_z != 0.0f;
        m = m + 1;
      }
      if (gated) {
        shade |= 1u << (k - base);
      } else {  // f = 0: the walk's term 0 * beta
        pr = pr + 0.0f * ev[6];
        pg = pg + 0.0f * ev[7];
        pb = pb + 0.0f * ev[8];
      }
    }
    while (shade != 0) {
      const int r = __ffs(shade) - 1;
      shade &= shade - 1u;
      const float* ev = rows + r * EV_COLS;
      const float wix = ev[3], wiy = ev[4], wiz = ev[5];
      const float wi_ng = wix * ngx + wiy * ngy + wiz * ngz;
      const float wil_x = wix * ssx + wiy * ssy + wiz * ssz;
      const float wil_y = wix * tsx + wiy * tsy + wiz * tsz;
      float fr[3] = {0.0f, 0.0f, 0.0f};
      for (int l = 0; l < n_lob; ++l) {
        float lf[3];
        lobe_f<kWide>(load_lobe(mrow, l), wol_x, wol_y, wo_z, wil_x, wil_y, wi_ng, lf);
        for (int c = 0; c < 3; ++c) fr[c] = fr[c] + lf[c];
      }
      pr = pr + fr[0] * ev[6];
      pg = pg + fr[1] * ev[7];
      pb = pb + fr[2] * ev[8];
    }
    __syncwarp(mask);  // every walking lane is done with the tile before it is refilled
    base = next;
  }
  phi[3 * i + 0] = pr;
  phi[3 * i + 1] = pg;
  phi[3 * i + 2] = pb;
  m_out[i] = m;
}

// K10's dynamic shared memory in blocks of `block` threads: two tiles a warp
__host__ __device__ constexpr size_t deposit_smem(int block) {
  return (size_t)(block / WARP) * 2 * TILE_WORDS * sizeof(float2);
}

// The last launch's block size, blocks resident per SM, registers per thread
// and dynamic shared memory bytes: K8's by [bvh][rays_in][wide], K9's by
// [bvh][wide], K10's by [wide]
int g_occupancy[2][2][2][4] = {};
int g_photon_occupancy[2][2][4] = {};
int g_deposit_occupancy[2][4] = {};

// The block of a K8 or K9 launch with smem bytes of dynamic shared memory:
// choose_block's, kept in occ and chosen again only when smem differs from
// the last choice's (a brute-force table of another size), so that a launch
// makes no occupancy query on the host while it stays the same
template <class Kernel>
cudaError_t walk_block(Kernel kernel, size_t smem, int* occ, int& block) {
  if (occ[0] == 0 || occ[3] != (int)smem) {
    if (smem > 0) {
      // the whole TRI_MAX table exceeds the 48 KB default for dynamic shared memory
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CHUNK_SMEM_MAX);
      if (err != cudaSuccess) return err;
    }
    const cudaError_t err =
        choose_block(kernel, SPPM_BLOCK_MAX, [&](int) { return smem; }, block, occ);
    if (err != cudaSuccess) return err;
  }
  block = occ[0];
  return cudaSuccess;
}

// 0 where the tables of a K8 or K9 launch are well formed (the extern "C"
// comment below), else cudaErrorInvalidValue
int check_walk(const float* table, int n_tris, const float* nodes64, const float* prims,
               const float* chunks, int n_chunks, int root_count) {
  const bool bad =
      prims != nullptr
          ? n_tris <= 0 || n_tris > BVH_TRI_MAX || table == nullptr || root_count < 0 ||
                root_count > n_tris || (root_count == 0) != (nodes64 != nullptr)
          : n_tris <= 0 || n_tris > TRI_MAX || table == nullptr || chunks == nullptr ||
                n_chunks <= 0 || n_chunks > CHUNK_MAX || root_count != 0;
  return bad ? (int)cudaErrorInvalidValue : 0;
}

template <bool kRaysIn, bool kWide>
int launch_camera(const float* table, int n_tris, const float* nodes64, const float* prims,
                  const Params* params, const float* in_a, const float* in_d, const float* in_w,
                  const float* u, int n_u, float* out_ld, float* out_p, float* out_wo,
                  float* out_beta, float* out_ng, float* out_dpdu, int* out_mat, int* out_valid,
                  int n, void* stream, const float* chunks, int n_chunks, int root_count) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (n <= 0) return 0;
  if (params->n_lights < 1 || params->n_lights > LIGHT_MAX || params->max_depth < 1 ||
      n_u != 4 * params->max_depth + 1)
    return (int)cudaErrorInvalidValue;
  if (const int bad = check_walk(table, n_tris, nodes64, prims, chunks, n_chunks, root_count))
    return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (prims != nullptr) {
    const auto kernel = sppm_camera_kernel<true, kRaysIn, kWide>;
    int block;
    const cudaError_t err = walk_block(kernel, 0, g_occupancy[1][kRaysIn][kWide], block);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(n + block - 1) / block, block, 0, st>>>(
        table, n_tris, nodes64, prims, in_a, in_d, in_w, u, out_ld, out_p, out_wo, out_beta,
        out_ng, out_dpdu, out_mat, out_valid, n, *params, root_count, 0);
    return (int)cudaGetLastError();
  }
  // each block stages the whole table
  const size_t smem = chunk_smem(n_tris, n_chunks);
  const auto kernel = sppm_camera_kernel<false, kRaysIn, kWide>;
  int block;
  const cudaError_t err = walk_block(kernel, smem, g_occupancy[0][kRaysIn][kWide], block);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + block - 1) / block, block, smem, st>>>(
      table, n_tris, chunks, nullptr, in_a, in_d, in_w, u, out_ld, out_p, out_wo, out_beta,
      out_ng, out_dpdu, out_mat, out_valid, n, *params, 0, n_chunks);
  return (int)cudaGetLastError();
}

template <bool kWide>
int launch_photon(const float* table, int n_tris, const float* nodes64, const float* prims,
                  int max_depth, const float* ro, const float* rd, const float* beta,
                  const int* alive, const float* u, float* ev_p, float* ev_wi, float* ev_beta,
                  int* ev_live, int n, void* stream, const float* chunks, int n_chunks,
                  int root_count) {
  cudaGetLastError();
  if (n <= 0) return 0;
  if (max_depth < 2) return (int)cudaErrorInvalidValue;
  if (const int bad = check_walk(table, n_tris, nodes64, prims, chunks, n_chunks, root_count))
    return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (prims != nullptr) {
    const auto kernel = sppm_photon_kernel<true, kWide>;
    int block;
    const cudaError_t err = walk_block(kernel, 0, g_photon_occupancy[1][kWide], block);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(n + block - 1) / block, block, 0, st>>>(table, n_tris, nodes64, prims, max_depth, ro,
                                                      rd, beta, alive, u, ev_p, ev_wi, ev_beta,
                                                      ev_live, n, root_count, 0);
    return (int)cudaGetLastError();
  }
  // each block stages the whole table
  const size_t smem = chunk_smem(n_tris, n_chunks);
  const auto kernel = sppm_photon_kernel<false, kWide>;
  int block;
  const cudaError_t err = walk_block(kernel, smem, g_photon_occupancy[0][kWide], block);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + block - 1) / block, block, smem, st>>>(table, n_tris, chunks, nullptr, max_depth,
                                                       ro, rd, beta, alive, u, ev_p, ev_wi,
                                                       ev_beta, ev_live, n, 0, n_chunks);
  return (int)cudaGetLastError();
}

template <bool kWide>
int launch_deposit(const float* vp_p, const float* vp_wo, const float* vp_ng,
                   const float* vp_dpdu, const int* vp_mat, const float* vp_r2, const int* start,
                   const int* end, const float* events, const float* mats, float* phi, int* m,
                   int n, cudaStream_t st) {
  const auto kernel = sppm_deposit_kernel<kWide>;
  int* occ = g_deposit_occupancy[kWide];
  if (occ[0] == 0) {  // the block is chosen at the instance's first launch
    int block;
    const cudaError_t err = choose_block(kernel, SPPM_BLOCK_MAX, deposit_smem, block, occ);
    if (err != cudaSuccess) return (int)err;
  }
  const int block = occ[0];
  kernel<<<(n + block - 1) / block, block, deposit_smem(block), st>>>(
      vp_p, vp_wo, vp_ng, vp_dpdu, vp_mat, vp_r2, start, end, events, mats, phi, m, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launch returns cudaGetLastError() of the launch (0 when it was
// accepted); nothing is synchronised; the wide instances (kWide) when `wide`
// is not 0.  K8 (the camera walk) and K9 (the photon walk): brute force when
// prims is null (the chunked walk over the (n_chunks, CHUNK_COLS) rows
// `chunks` that cover the table; root_count 0), else the walk of the BVH's
// node64 rows `nodes64` (null where the tree is one leaf of root_count rows;
// root_count 0 otherwise) over the (n_tris, 12) float32 leaf rows `prims`,
// the table in the same leaf order (chunks null, n_chunks 0).

// K8 over n pixels; u is the (n_u, n) Halton slot matrix, n_u = 4 * max_depth + 1
int sppm_camera_launch(int wide, const float* table, int n_tris, const float* nodes64,
                       const float* prims, const Params* params, const float* pixel_xy,
                       const float* u, int n_u, float* out_ld, float* out_p, float* out_wo,
                       float* out_beta, float* out_ng, float* out_dpdu, int* out_mat,
                       int* out_valid, int n, void* stream, const float* chunks, int n_chunks,
                       int root_count) {
  if (wide)
    return launch_camera<false, true>(table, n_tris, nodes64, prims, params, pixel_xy, nullptr,
                                      nullptr, u, n_u, out_ld, out_p, out_wo, out_beta, out_ng,
                                      out_dpdu, out_mat, out_valid, n, stream, chunks, n_chunks,
                                      root_count);
  return launch_camera<false, false>(table, n_tris, nodes64, prims, params, pixel_xy, nullptr,
                                     nullptr, u, n_u, out_ld, out_p, out_wo, out_beta, out_ng,
                                     out_dpdu, out_mat, out_valid, n, stream, chunks, n_chunks,
                                     root_count);
}

// K8 on given rays: o, d (n, 3) and weight (n,); u as above (its film and
// lens rows unread)
int sppm_camera_rays_launch(int wide, const float* table, int n_tris, const float* nodes64,
                            const float* prims, const Params* params, const float* o,
                            const float* d, const float* weight, const float* u, int n_u,
                            float* out_ld, float* out_p, float* out_wo, float* out_beta,
                            float* out_ng, float* out_dpdu, int* out_mat, int* out_valid, int n,
                            void* stream, const float* chunks, int n_chunks, int root_count) {
  if (wide)
    return launch_camera<true, true>(table, n_tris, nodes64, prims, params, o, d, weight, u,
                                     n_u, out_ld, out_p, out_wo, out_beta, out_ng, out_dpdu,
                                     out_mat, out_valid, n, stream, chunks, n_chunks, root_count);
  return launch_camera<true, false>(table, n_tris, nodes64, prims, params, o, d, weight, u, n_u,
                                    out_ld, out_p, out_wo, out_beta, out_ng, out_dpdu, out_mat,
                                    out_valid, n, stream, chunks, n_chunks, root_count);
}

// The last launch of an instance, of K8 (kernel 0: bvh, rays_in, wide), K9
// (kernel 1: bvh, wide) or K10 (kernel 2: wide): its block size, blocks per
// SM, registers per thread and dynamic shared memory bytes, into out[0..3]
// (zeros before its first launch)
void sppm_occupancy(int kernel, int bvh, int rays_in, int wide, int* out) {
  const int b = bvh != 0, r = rays_in != 0, w = wide != 0;
  const int* occ = kernel == 0   ? g_occupancy[b][r][w]
                   : kernel == 1 ? g_photon_occupancy[b][w]
                                 : g_deposit_occupancy[w];
  for (int k = 0; k < 4; ++k) out[k] = occ[k];
}

// K9 over n photons; u is the (3 * (max_depth - 1), n) bounce / roulette
// matrix; the events are ((max_depth - 1) * n, .) depth-major
int sppm_photon_launch(int wide, const float* table, int n_tris, const float* nodes64,
                       const float* prims, int max_depth, const float* ro, const float* rd,
                       const float* beta, const int* alive, const float* u, float* ev_p,
                       float* ev_wi, float* ev_beta, int* ev_live, int n, void* stream,
                       const float* chunks, int n_chunks, int root_count) {
  if (wide)
    return launch_photon<true>(table, n_tris, nodes64, prims, max_depth, ro, rd, beta, alive, u,
                               ev_p, ev_wi, ev_beta, ev_live, n, stream, chunks, n_chunks,
                               root_count);
  return launch_photon<false>(table, n_tris, nodes64, prims, max_depth, ro, rd, beta, alive, u,
                              ev_p, ev_wi, ev_beta, ev_live, n, stream, chunks, n_chunks,
                              root_count);
}

// K10 over n VPs: events is the (E, 10) sorted event table, mats the
// (n_mats, 96) resolved material rows
int sppm_deposit_launch(int wide, const float* vp_p, const float* vp_wo, const float* vp_ng,
                        const float* vp_dpdu, const int* vp_mat, const float* vp_r2,
                        const int* start, const int* end, const float* events, const float* mats,
                        int n_mats, float* phi, int* m, int n, void* stream) {
  cudaGetLastError();
  if (n <= 0) return 0;
  if (n_mats < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide)
    return launch_deposit<true>(vp_p, vp_wo, vp_ng, vp_dpdu, vp_mat, vp_r2, start, end, events,
                                mats, phi, m, n, st);
  return launch_deposit<false>(vp_p, vp_wo, vp_ng, vp_dpdu, vp_mat, vp_r2, start, end, events,
                               mats, phi, m, n, st);
}

const char* sppm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int sppm_params_size() { return (int)sizeof(Params); }

}  // extern "C"
