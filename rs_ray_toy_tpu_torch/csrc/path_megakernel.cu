// Path-integrator sample pass for Hopper (sm_90a): one thread per ray.
//
// Replaces the TPU kernels rs_ray_toy_tpu/ops/path_megakernel.py · _kernel_cam
// (brute force, pallas_call in _run_cam for T <= 2048), _kernel_cam_bvh (the
// in-kernel BVH, up to 65,536 triangles) and their rays-in twins _kernel and
// _kernel_bvh (pallas_call in _run), on their subset with up to 8 full
// spheres, point and sphere-area lights and one constant environment.  Each
// is four template instances: the stratified sampler's in-kernel hash or the
// Halton sampler's slot values read from an (NC, N) matrix the host computes
// per pass (kSlots; _mk_sdim's u_ref branch), and flat or smooth shading
// (kSmooth; the JAX kernel's `smooth`: the winner's barycentrics rebuilt from
// its row, its raw vertex normals interpolated, spheres keeping ns = ng, ng
// faced onto ns, and the reflect / transmit tests, the ray offsets and the
// etaScale entering test on ng's side).  Per ray the camera instances read
// the film and lens slots and trace the lens system (_raygen); the rays-in
// instances load o, d and the weight.  Then the bounce loop
// (_bounce_loop): closest hit over the triangle table min-combined with the
// spheres, NEE (point lights alone: the delta-light form; otherwise the
// generic branch with the power-heuristic MIS weight, a sphere-light or
// environment sample, and for the environment the BSDF sample whose ray
// escapes toward it), an any-hit shadow ray, one BSDF sample over lambert /
// Trowbridge-Reitz microfacet / specular-reflect / fresnel-specular lobes
// and the Disney diffuse, retro, sheen, clearcoat and microfacet lobes
// (common.cuh's lobe functions with kDisney set: K5 e) with the etaScale
// factor, Russian roulette after bounce 3, and for a scene
// with `infinite_lights` the escape radiance at bounce 0 or after a specular
// bounce, one step past max_depth.  Output: RGB radiance (and for the camera
// instances the camera weight) per ray.
//
// What bounds it on this card: divergent per-thread FP32 ALU work over
// read-only tables (a few KB of triangles for the fixture, ~9 MB of table and
// nodes for a 19,200-triangle mesh), spheres, lights and lens constants.  It
// moves 20-32 bytes in and 12-16 bytes out per ray, so it is latency- and
// occupancy-bound, not bandwidth-bound.  The simple design answers that with
// (a) no packets and no padding: each thread walks its own ray to
// termination, so dead rays retire instead of idling in a masked tile;
// (b) brute force (T <= 2048): the intersect-side triangle columns (p0, e1,
// e2: 36 B per triangle, 72 KB at TRI_MAX) staged once per block in shared
// memory, where all lanes of a warp read the same triangle, so loads
// broadcast; BVH mode: a per-ray stack walk with the node rows and the
// triangle table read through the read-only cache (common.cuh, Geometry);
// the spheres' intersect columns (world-to-object rows and radius, 52 B
// each) staged in shared memory in both modes, their lobe rows read through
// the read-only cache; (c) lens, pupil and point-light constants in one
// __grid_constant__ parameter block (Params, constant bank), the other
// lights, the environment's distribution and the escape radiance in a second
// one (WideParams, with the Halton slot-to-row map): both together stay under
// the 4 KB kernel-parameter limit, checked below; (d) the flat and stratified
// instances are separate template instances, so the Halton matrix reads and
// the smooth normals cost them nothing (a smooth hit reads the winner's 9
// intersect and 9 normal columns once, through the read-only cache; nothing
// more is staged in shared memory).  Warp divergence between lobes, light
// kinds, path lengths and BVH walks is accepted for now.
//
// Numerics follow the plain PyTorch version (bounce_loop_reference) expression
// by expression; see common.cuh.  sinf and cosf are CUDA's (not correctly
// rounded; no fast-math).

#include "common.cuh"

constexpr int ENV_BINS = 16;  // rows of a constant map's Distribution2D (8x8 texels)
constexpr int SLOT_MAX = 176;  // sampler slots of the slot-to-row map

// Must match ops/path_megakernel._WideParams field for field.
struct WideParams {
  int light_kind[LIGHT_MAX];
  float area_o2w[LIGHT_MAX * 12];  // per sphere light, object-to-world 3x4 rows
  float area_w2o[LIGHT_MAX * 9];   // per sphere light, the inverse's 3x3
  float area_radius[LIGHT_MAX];
  int all_point;  // every light a point light: no light sample, no MIS
  int has_env;    // one environment light among the lights
  int has_esc;    // infinite_lights: escaped rays collect esc_rgb
  int has_spec;   // a specular lobe is live (escape after a specular bounce)
  int n_sph;
  float esc_rgb[3];
  float world_radius;
  float env_rgb[3];  // the constant map's texel
  int env_nu, env_nv;
  float env_marg_cdf[ENV_BINS + 1];
  float env_marg_pdf[ENV_BINS];
  float env_cond_cdf[ENV_BINS + 1];
  float env_pdf2d[ENV_BINS];     // pdf_2d of each theta row
  float env_cos_bins[ENV_BINS];  // cos(k pi / nv), k = 1..nv-1: the theta rows
  float env_to_world[9];
  float env_to_local[9];
  int smooth;                // the mesh has smooth vertex normals
  short slot_row[SLOT_MAX];  // Halton: slot -> first row of the slot matrix, -1 unused
};

// the kernel's parameters: both blocks and 14 pointer or int arguments
static_assert(sizeof(Params) + sizeof(WideParams) + 16 * 8 <= 4096,
              "kernel parameters exceed the 4 KB limit");

namespace {

constexpr int LIGHT_POINT_KIND = 0;
constexpr int LIGHT_AREA_KIND = 2;
constexpr int LIGHT_ENV_KIND = 3;
constexpr int SPH_MAX = 8;
constexpr int SPH_GEO = 13;       // w2o 3x4 rows and the radius: cols 0..12 of a sphere row
constexpr int SPH_O2W_COL = 96;   // o2w 3x4 rows of a sphere row
constexpr int NRM_COL = 96;       // raw vertex normals n0, n1, n2 of a triangle row
constexpr float SPH_EPS = 1e-4f;
constexpr float TWO_PI2_F = (float)(2.0 * 3.14159265358979323846 * 3.14159265358979323846);

// ---- spheres (_sphere_candidate_t, _spheres_closest, _sphere_shading) ----

// The closest root of a full sphere in (SPH_EPS, t_lim), BIG_T on a miss; the
// ray in object space through oo, od.  g: w2o 3x4 rows and the radius.
__device__ float sphere_candidate(const float* g, float ox, float oy, float oz, float dx,
                                  float dy, float dz, float t_lim, float oo[3], float od[3]) {
  oo[0] = g[0] * ox + g[1] * oy + g[2] * oz + g[3];
  oo[1] = g[4] * ox + g[5] * oy + g[6] * oz + g[7];
  oo[2] = g[8] * ox + g[9] * oy + g[10] * oz + g[11];
  od[0] = g[0] * dx + g[1] * dy + g[2] * dz;
  od[1] = g[4] * dx + g[5] * dy + g[6] * dz;
  od[2] = g[8] * dx + g[9] * dy + g[10] * dz;
  const float r = g[12];
  const float a = od[0] * od[0] + od[1] * od[1] + od[2] * od[2];
  const float b = 2.0f * (od[0] * oo[0] + od[1] * oo[1] + od[2] * oo[2]);
  const float c = oo[0] * oo[0] + oo[1] * oo[1] + oo[2] * oo[2] - r * r;
  const float disc = b * b - 4.0f * a * c;
  const bool ok = disc >= 0.0f;
  const float root = sqrtf(fmaxf(disc, 0.0f));
  const float q = b < 0.0f ? -0.5f * (b - root) : -0.5f * (b + root);
  const float t0 = q / (a == 0.0f ? 1.0f : a);
  const float t1 = c / (q == 0.0f ? 1.0f : q);
  const float lo = ok ? fminf(t0, t1) : 0.0f;
  const float hi = ok ? fmaxf(t0, t1) : 0.0f;
  if (ok && lo > SPH_EPS && lo < t_lim) return lo;
  if (ok && hi > SPH_EPS && hi < t_lim) return hi;
  return BIG_T;
}

// ---- the constant environment (_cdf_scan, _env_sample_k, _env_pdf_dir_k) ----

// sample_continuous_1d over cdf[0..n]: the bin (last entry <= u) and the
// offset in it
__device__ void cdf_scan(const float* cdf, int n, float u, int& idx, float& du) {
  int cnt = 0;
  for (int k = 0; k <= n; ++k) cnt += cdf[k] <= u ? 1 : 0;
  idx = min(max(cnt - 1, 0), n - 1);
  const float c0 = cdf[idx];
  const float dc = cdf[idx + 1] - c0;
  du = dc > 0.0f ? (u - c0) / fmaxf(dc, 1e-30f) : u - c0;
}

__device__ void rot9(const float* m, float x, float y, float z, float& ox, float& oy,
                     float& oz) {
  ox = m[0] * x + m[1] * y + m[2] * z;
  oy = m[3] * x + m[4] * y + m[5] * z;
  oz = m[6] * x + m[7] * y + m[8] * z;
}

// InfiniteAreaLight::sample_li on the constant map: direction, solid-angle
// pdf and the shadow-ray target 2 world radii away
__device__ void env_sample(const WideParams& w, float px, float py, float pz, float u0, float u1,
                           float& wx, float& wy, float& wz, float& pdf, float& lx, float& ly,
                           float& lz) {
  int i1, i0;
  float du1, du0;
  cdf_scan(w.env_marg_cdf, w.env_nv, u1, i1, du1);
  const float d1 = ((float)i1 + du1) / (float)w.env_nv;
  const float pdf1 = w.env_marg_pdf[i1];
  cdf_scan(w.env_cond_cdf, w.env_nu, u0, i0, du0);
  const float d0 = ((float)i0 + du0) / (float)w.env_nu;
  const float theta = d1 * PI_F;
  const float phi = d0 * 2.0f * PI_F;
  const float sin_t = sinf(theta);
  rot9(w.env_to_world, sin_t * cosf(phi), sin_t * sinf(phi), cosf(theta), wx, wy, wz);
  pdf = sin_t > 0.0f ? pdf1 / (TWO_PI2_F * fmaxf(sin_t, 1e-9f)) : 0.0f;
  const float two_r = 2.0f * w.world_radius;
  lx = px + wx * two_r;
  ly = py + wy * two_r;
  lz = pz + wz * two_r;
}

// InfiniteAreaLight::pdf_li along a world direction: the theta row from the
// cos thresholds, no acos
__device__ float env_pdf_dir(const WideParams& w, float wx, float wy, float wz) {
  float lx, ly, lz;
  rot9(w.env_to_local, wx, wy, wz, lx, ly, lz);
  lz = lz * rsqrt_exact(fmaxf(lx * lx + ly * ly + lz * lz, 1e-30f));
  int iv = 0;
  for (int k = 0; k < w.env_nv - 1; ++k) iv += lz <= w.env_cos_bins[k] ? 1 : 0;
  const float sin_t = sqrtf(fmaxf(1.0f - lz * lz, 0.0f));
  return sin_t > 0.0f ? w.env_pdf2d[iv] / (TWO_PI2_F * fmaxf(sin_t, 1e-9f)) : 0.0f;
}

// ---- the bounce loop (_bounce_loop), one ray ----

template <bool kBvh, bool kSmooth, class Smp>
__device__ void bounce_loop(const Geometry<kBvh>& geom, const float* table,
                            const float* sph_rows, const float* s_sph, const Params& p,
                            const WideParams& w, const Smp& smp, float ox, float oy,
                            float oz, float dx, float dy, float dz, bool active, float L[3]) {
  // shadow any-hit over the triangles and the spheres
  auto occluded_all = [&](float sox, float soy, float soz, float sdx, float sdy, float sdz,
                          float t_max) {
    if (geom.occluded(sox, soy, soz, sdx, sdy, sdz, t_max)) return true;
    float oo[3], od[3];
    for (int j = 0; j < w.n_sph; ++j)
      if (sphere_candidate(s_sph + SPH_GEO * j, sox, soy, soz, sdx, sdy, sdz, t_max, oo, od) <
          BIG_T)
        return true;
    return false;
  };

  float Lr = 0.0f, Lg = 0.0f, Lb = 0.0f;
  float br = 1.0f, bg = 1.0f, bb = 1.0f;
  float es = 1.0f;         // etaScale (path.rs:150-163)
  bool spec_prev = false;  // the last BSDF sample was specular
  // an extra step collects the escape radiance after the last bounce
  const int n_iters = p.max_depth + (w.has_esc ? 1 : 0);
  for (int bounce = 0; bounce < n_iters && active; ++bounce) {
    float t;
    const int best = geom.closest(ox, oy, oz, dx, dy, dz, t);
    const float* row = table + (size_t)max(best, 0) * TABLE_COLS;
    float ngx = 0.0f, ngy = 0.0f, ngz = 0.0f, dux = 0.0f, duy = 0.0f, duz = 0.0f;
    float nsx = 0.0f, nsy = 0.0f, nsz = 0.0f;
    if (best >= 0) {
      ngx = __ldg(row + 9), ngy = __ldg(row + 10), ngz = __ldg(row + 11);
      dux = __ldg(row + 12), duy = __ldg(row + 13), duz = __ldg(row + 14);
      if constexpr (kSmooth)
        smooth_normal(row, NRM_COL, ox, oy, oz, dx, dy, dz, ngx, ngy, ngz, nsx, nsy, nsz);
    }
    // spheres, min-combined with the triangle winner (strict <)
    if (w.n_sph > 0) {
      float t_s = BIG_T, po[3] = {0.0f, 0.0f, 0.0f};
      int s_best = 0;
      for (int j = 0; j < w.n_sph; ++j) {
        float oo[3], od[3];
        const float tc =
            sphere_candidate(s_sph + SPH_GEO * j, ox, oy, oz, dx, dy, dz, BIG_T, oo, od);
        if (tc < t_s) {
          t_s = tc;
          s_best = j;
          for (int c = 0; c < 3; ++c) po[c] = oo[c] + od[c] * tc;
        }
      }
      if (t_s < t) {
        t = t_s;
        const float* g = s_sph + SPH_GEO * s_best;
        row = sph_rows + (size_t)s_best * TABLE_COLS;
        const float* o2w = row + SPH_O2W_COL;
        const float plen = sqrtf(po[0] * po[0] + po[1] * po[1] + po[2] * po[2]);
        const float scale = g[12] / fmaxf(plen, 1e-30f);
        const float pox = po[0] * scale, poy = po[1] * scale, poz = po[2] * scale;
        ngx = g[0] * pox + g[4] * poy + g[8] * poz;
        ngy = g[1] * pox + g[5] * poy + g[9] * poz;
        ngz = g[2] * pox + g[6] * poy + g[10] * poz;
        const float ng_len = fmaxf(sqrtf(ngx * ngx + ngy * ngy + ngz * ngz), 1e-30f);
        ngx = ngx / ng_len;
        ngy = ngy / ng_len;
        ngz = ngz / ng_len;
        const float ux = -TWO_PI_F * poy, uy = TWO_PI_F * pox, uz = 0.0f;
        dux = __ldg(o2w + 0) * ux + __ldg(o2w + 1) * uy + __ldg(o2w + 2) * uz;
        duy = __ldg(o2w + 4) * ux + __ldg(o2w + 5) * uy + __ldg(o2w + 6) * uz;
        duz = __ldg(o2w + 8) * ux + __ldg(o2w + 9) * uy + __ldg(o2w + 10) * uz;
        nsx = ngx, nsy = ngy, nsz = ngz;  // spheres shade ns = ng
      }
    }
    if (!(t < BIG_T)) {
      // escaped: the infinite_lights radiance at bounce 0 or after a
      // specular bounce (path.rs:84-87)
      if (w.has_esc && (bounce == 0 || spec_prev)) {
        Lr = Lr + br * w.esc_rgb[0];
        Lg = Lg + bg * w.esc_rgb[1];
        Lb = Lb + bb * w.esc_rgb[2];
      }
      break;
    }
    if (bounce == p.max_depth) break;  // the escape step only
    const int n_lob = (int)__ldg(row + 15);
    const float mat_eta = __ldg(row + 31);
    if constexpr (kSmooth) {
      // ng faced onto ns (surface_interaction's faceforward(ng, ns))
      if (ngx * nsx + ngy * nsy + ngz * nsz < 0.0f) {
        ngx = -ngx;
        ngy = -ngy;
        ngz = -ngz;
      }
    } else {
      // flat shading: the shading normal is the geometric normal
      nsx = ngx, nsy = ngy, nsz = ngz;
    }

    const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;

    float ssx, ssy, ssz, tsx, tsy, tsz;
    shading_frame(nsx, nsy, nsz, dux, duy, duz, ssx, ssy, ssz, tsx, tsy, tsz);

    const float wox = -dx, woy = -dy, woz = -dz;
    const float wol_x = dot3(wox, woy, woz, ssx, ssy, ssz);
    const float wol_y = dot3(wox, woy, woz, tsx, tsy, tsz);
    const float wo_z = dot3(wox, woy, woz, nsx, nsy, nsz);
    const float wo_ng = kSmooth ? dot3(wox, woy, woz, ngx, ngy, ngz) : wo_z;

    const int dim0 = 8 + bounce * 11;  // sampler/dims.path_dim0
    const float mag = fabsf(px) + fabsf(py) + fabsf(pz);
    const float eps = 1e-4f + 1e-5f * mag;

    if (w.all_point) {
      // ---- NEE, point lights only (uniform_sample_one_light) ----
      const float u_pick = smp.get_1d(dim0);
      const int li = min((int)(u_pick * (float)p.n_lights), p.n_lights - 1);
      const float lpx = p.light_p[3 * li], lpy = p.light_p[3 * li + 1],
                  lpz = p.light_p[3 * li + 2];
      const float tlx = lpx - px, tly = lpy - py, tlz = lpz - pz;
      const float dist2 = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-20f);
      const float inv_d = rsqrt_exact(dist2);
      const float wix = tlx * inv_d, wiy = tly * inv_d, wiz = tlz * inv_d;
      const float wil_x = dot3(wix, wiy, wiz, ssx, ssy, ssz);
      const float wil_y = dot3(wix, wiy, wiz, tsx, tsy, tsz);
      const float wil_z = dot3(wix, wiy, wiz, nsx, nsy, nsz);
      const float wi_ng = kSmooth ? dot3(wix, wiy, wiz, ngx, ngy, ngz) : wil_z;
      const bool f_gate = (wi_ng * wo_ng) > 0.0f && wo_z != 0.0f;
      float fn[3] = {0.0f, 0.0f, 0.0f};
      if (f_gate) {
        for (int l = 0; l < n_lob; ++l) {
          float lf[3];
          lobe_f<true>(load_lobe(row, l), wol_x, wol_y, wo_z, wil_x, wil_y, wil_z, lf);
          for (int c = 0; c < 3; ++c) fn[c] = fn[c] + lf[c];
        }
      }
      const float cos_ns = fabsf(wil_z);
      const float off = wi_ng < 0.0f ? -eps : eps;
      const float sox = px + ngx * off, soy = py + ngy * off, soz = pz + ngz * off;
      const bool occ = occluded_all(sox, soy, soz, lpx - sox, lpy - soy, lpz - soz, SHADOW_T_MAX);
      const float li_scale = occ ? 0.0f : cos_ns * (float)p.n_lights / dist2;
      Lr = Lr + br * fn[0] * p.light_emit[3 * li] * li_scale;
      Lg = Lg + bg * fn[1] * p.light_emit[3 * li + 1] * li_scale;
      Lb = Lb + bb * fn[2] * p.light_emit[3 * li + 2] * li_scale;
    } else if (p.n_lights > 0) {
      // ---- NEE with MIS (estimate_direct, integrator/mod.rs:403-558) ----
      const float u_pick = smp.get_1d(dim0);
      const int li = min((int)(u_pick * (float)p.n_lights), p.n_lights - 1);
      float ul0, ul1;
      smp.get_2d(dim0 + 1, ul0, ul1);
      const int kind = w.light_kind[li];
      const float* emit = p.light_emit + 3 * li;
      float wix = 0.0f, wiy = 0.0f, wiz = 0.0f, le[3] = {0.0f, 0.0f, 0.0f}, ls_pdf = 0.0f;
      float plx = p.light_p[3 * li], ply = p.light_p[3 * li + 1], plz = p.light_p[3 * li + 2];
      if (kind == LIGHT_POINT_KIND) {
        const float tlx = plx - px, tly = ply - py, tlz = plz - pz;
        const float dist2 = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-20f);
        const float sq = sqrtf(dist2);
        wix = tlx / sq;
        wiy = tly / sq;
        wiz = tlz / sq;
        for (int c = 0; c < 3; ++c) le[c] = emit[c] / dist2;
        ls_pdf = 1.0f;
      } else if (kind == LIGHT_AREA_KIND) {
        sample_sphere_light(w.area_o2w + 12 * li, w.area_w2o + 9 * li, w.area_radius[li], emit, px,
                            py, pz, ul0, ul1, wix, wiy, wiz, le, ls_pdf, plx, ply, plz);
      } else {
        env_sample(w, px, py, pz, ul0, ul1, wix, wiy, wiz, ls_pdf, plx, ply, plz);
        for (int c = 0; c < 3; ++c) le[c] = w.env_rgb[c];
      }
      const float wil_x = dot3(wix, wiy, wiz, ssx, ssy, ssz);
      const float wil_y = dot3(wix, wiy, wiz, tsx, tsy, tsz);
      const float wil_z = dot3(wix, wiy, wiz, nsx, nsy, nsz);
      const float wi_ng = kSmooth ? dot3(wix, wiy, wiz, ngx, ngy, ngz) : wil_z;
      const bool f_gate = (wi_ng * wo_ng) > 0.0f && wo_z != 0.0f;
      // f and the scattering pdf over the non-specular lobes
      float fn[3] = {0.0f, 0.0f, 0.0f};
      float pdf_scat = 0.0f;
      int cnt = 0;
      for (int l = 0; l < n_lob; ++l) {
        const Lobe lob = load_lobe(row, l);
        if (is_spec_kind(lob.kind)) continue;
        if (f_gate) {
          float lf[3];
          lobe_f<true>(lob, wol_x, wol_y, wo_z, wil_x, wil_y, wil_z, lf);
          for (int c = 0; c < 3; ++c) fn[c] = fn[c] + lf[c];
        }
        pdf_scat = pdf_scat + lobe_pdf<true>(lob, wol_x, wol_y, wo_z, wil_x, wil_y, wil_z);
        ++cnt;
      }
      pdf_scat = (wo_z != 0.0f && cnt > 0) ? pdf_scat / (float)max(cnt, 1) : 0.0f;
      const float cos_ns = fabsf(wil_z);
      const float fc[3] = {fn[0] * cos_ns, fn[1] * cos_ns, fn[2] * cos_ns};
      const float w_mis =
          kind == LIGHT_POINT_KIND ? 1.0f : power_heuristic(ls_pdf, pdf_scat);
      const float off = wi_ng < 0.0f ? -eps : eps;
      const float sox = px + ngx * off, soy = py + ngy * off, soz = pz + ngz * off;
      const bool any_li = le[0] > 0.0f || le[1] > 0.0f || le[2] > 0.0f;
      const bool any_f = fc[0] > 0.0f || fc[1] > 0.0f || fc[2] > 0.0f;
      if (ls_pdf > 0.0f && any_li && any_f &&
          !occluded_all(sox, soy, soz, plx - sox, ply - soy, plz - soz, SHADOW_T_MAX)) {
        const float scale = w_mis * (float)p.n_lights / fmaxf(ls_pdf, 1e-20f);
        Lr = Lr + br * fc[0] * le[0] * scale;
        Lg = Lg + bg * fc[1] * le[1] * scale;
        Lb = Lb + bb * fc[2] * le[2] * scale;
      }
      // the BSDF sample of MIS: only a ray that escapes toward the sampled
      // environment contributes (no emissive primitives)
      if (w.has_env && kind == LIGHT_ENV_KIND && n_lob > 0 && wo_z != 0.0f) {
        float us0, us1;
        smp.get_2d(dim0 + 2, us0, us1);
        const BsdfSample s2 = bsdf_sample<true>(row, n_lob, wol_x, wol_y, wo_z, us0, us1);
        const float w2x = ssx * s2.wx + tsx * s2.wy + nsx * s2.wz;
        const float w2y = ssy * s2.wx + tsy * s2.wy + nsy * s2.wz;
        const float w2z = ssz * s2.wx + tsz * s2.wy + nsz * s2.wz;
        const float cos2 = fabsf(dot3(w2x, w2y, w2z, nsx, nsy, nsz));
        const float f2[3] = {s2.f[0] * cos2, s2.f[1] * cos2, s2.f[2] * cos2};
        const float lpdf2 = env_pdf_dir(w, w2x, w2y, w2z);
        const float w2mis = power_heuristic(s2.pdf, lpdf2);
        const float off2n = dot3(w2x, w2y, w2z, ngx, ngy, ngz) < 0.0f ? -eps : eps;
        const bool any_f2 = f2[0] > 0.0f || f2[1] > 0.0f || f2[2] > 0.0f;
        if (any_f2 && s2.pdf > 0.0f && lpdf2 > 0.0f &&
            !occluded_all(px + ngx * off2n, py + ngy * off2n, pz + ngz * off2n, w2x, w2y, w2z,
                          INFINITY)) {
          const float scale2 = w2mis * (float)p.n_lights / fmaxf(s2.pdf, 1e-20f);
          Lr = Lr + br * f2[0] * w.env_rgb[0] * scale2;
          Lg = Lg + bg * f2[1] * w.env_rgb[1] * scale2;
          Lb = Lb + bb * f2[2] * w.env_rgb[2] * scale2;
        }
      }
    }

    // ---- BSDF sample (Bsdf::sample_f, reference-quirk exact) ----
    float ub0, ub1;
    smp.get_2d(dim0 + 3, ub0, ub1);
    const BsdfSample bs = bsdf_sample<true>(row, n_lob, wol_x, wol_y, wo_z, ub0, ub1);
    const float nwx = ssx * bs.wx + tsx * bs.wy + nsx * bs.wz;
    const float nwy = ssy * bs.wx + tsy * bs.wy + nsy * bs.wz;
    const float nwz = ssz * bs.wx + tsz * bs.wy + nsz * bs.wz;
    const float cosw = fabsf(dot3(nwx, nwy, nwz, nsx, nsy, nsz));
    const bool any_f = bs.f[0] != 0.0f || bs.f[1] != 0.0f || bs.f[2] != 0.0f;
    if (!(n_lob > 0 && wo_z != 0.0f && bs.pdf > 0.0f && any_f)) break;
    const float inv_pdf = cosw / fmaxf(bs.pdf, 1e-20f);
    br = br * bs.f[0] * inv_pdf;
    bg = bg * bs.f[1] * inv_pdf;
    bb = bb * bs.f[2] * inv_pdf;
    spec_prev = w.has_spec && bs.specular;

    // etaScale: a transmitted fresnel-specular sample, entering test on ng
    if (bs.transmitted) {
      const float e2 = mat_eta * mat_eta;
      es = es * (wo_ng > 0.0f ? e2 : 1.0f / fmaxf(e2, 1e-20f));
    }

    // next ray, offset along ng to the sampled side
    const float off2 = dot3(nwx, nwy, nwz, ngx, ngy, ngz) < 0.0f ? -eps : eps;
    ox = px + ngx * off2;
    oy = py + ngy * off2;
    oz = pz + ngz * off2;
    dx = nwx;
    dy = nwy;
    dz = nwz;

    // ---- Russian roulette (path.rs:212-222) on beta * etaScale ----
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
  L[0] = Lr;
  L[1] = Lg;
  L[2] = Lb;
}

// ---- one sample pass per thread: camera rays (kRaysIn false) or given rays ----

template <bool kBvh, bool kRaysIn, bool kSlots, bool kSmooth>
__global__ void __launch_bounds__(BLOCK)
    path_mega_kernel(const float* __restrict__ table, int n_tris,
                     const float* __restrict__ nodes_f, const int* __restrict__ nodes_i,
                     const float* __restrict__ sph_rows, const float* __restrict__ in_a,
                     const float* __restrict__ in_d, const float* __restrict__ in_w,
                     const int* __restrict__ pid, const int* __restrict__ sid,
                     const float* __restrict__ slot_u, float* __restrict__ out_l,
                     float* __restrict__ out_w, int n, const __grid_constant__ Params p,
                     const __grid_constant__ WideParams w) {
  extern __shared__ float s_geo[];
  __shared__ float s_sph[SPH_MAX * SPH_GEO];
  for (int k = threadIdx.x; k < w.n_sph * SPH_GEO; k += blockDim.x)
    s_sph[k] = __ldg(sph_rows + (k / SPH_GEO) * TABLE_COLS + k % SPH_GEO);
  const Geometry<kBvh> geom = load_geometry<kBvh>(s_geo, table, n_tris, nodes_f, nodes_i);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const auto smp = [&] {
    if constexpr (kSlots)
      return SlotSampler{slot_u, w.slot_row, n, i};
    else
      return Sampler{(uint32_t)pid[i], (uint32_t)sid[i], &p};
  }();

  float ox, oy, oz, dx, dy, dz, weight;
  if constexpr (kRaysIn) {
    ox = in_a[3 * i], oy = in_a[3 * i + 1], oz = in_a[3 * i + 2];
    dx = in_d[3 * i], dy = in_d[3 * i + 1], dz = in_d[3 * i + 2];
    weight = in_w[i];
  } else {
    raygen(p, smp, in_a[2 * i], in_a[2 * i + 1], ox, oy, oz, dx, dy, dz, weight);
  }
  float L[3];
  bounce_loop<kBvh, kSmooth>(geom, table, sph_rows, s_sph, p, w, smp, ox, oy, oz, dx, dy, dz,
                             weight > 0.0f, L);
  if constexpr (kSlots) {
    if (smp.unlisted) L[0] = L[1] = L[2] = __int_as_float(0x7fffffff);
  }
  out_l[3 * i + 0] = L[0];
  out_l[3 * i + 1] = L[1];
  out_l[3 * i + 2] = L[2];
  if constexpr (!kRaysIn) out_w[i] = weight;
}

// The arguments of one launch, whichever instance takes them
struct Launch {
  const float* table;
  int n_tris;
  const float *nodes_f;
  const int* nodes_i;
  const Params* params;
  const float *in_a, *in_d, *in_w;
  const int *pid, *sid;
  float *out_l, *out_w;
  int n;
  cudaStream_t stream;
  const float* sph_rows;
  const WideParams* wide;
  const float* slot_u;
};

template <bool kBvh, bool kRaysIn, bool kSlots, bool kSmooth>
int launch_instance(const Launch& a) {
  const int grid = (a.n + BLOCK - 1) / BLOCK;
  size_t smem = 0;
  if constexpr (!kBvh) {
    // the whole TRI_MAX table exceeds the 48 KB default for dynamic shared memory
    const cudaError_t attr = cudaFuncSetAttribute(
        path_mega_kernel<false, kRaysIn, kSlots, kSmooth>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (attr != cudaSuccess) return (int)attr;
    smem = (size_t)a.n_tris * GEO_COLS * sizeof(float);
  }
  path_mega_kernel<kBvh, kRaysIn, kSlots, kSmooth><<<grid, BLOCK, smem, a.stream>>>(
      a.table, a.n_tris, a.nodes_f, a.nodes_i, a.sph_rows, a.in_a, a.in_d, a.in_w, a.pid, a.sid,
      a.slot_u, a.out_l, a.out_w, a.n, *a.params, *a.wide);
  return (int)cudaGetLastError();
}

template <bool kBvh, bool kRaysIn>
int launch_shading(const Launch& a) {
  if (a.slot_u != nullptr)
    return a.wide->smooth ? launch_instance<kBvh, kRaysIn, true, true>(a)
                          : launch_instance<kBvh, kRaysIn, true, false>(a);
  return a.wide->smooth ? launch_instance<kBvh, kRaysIn, false, true>(a)
                        : launch_instance<kBvh, kRaysIn, false, false>(a);
}

template <bool kRaysIn>
int launch(const Launch& a) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (a.n <= 0) return 0;
  const WideParams* w = a.wide;
  if (a.params->n_lights < 0 || a.params->n_lights > LIGHT_MAX || w->n_sph < 0 ||
      w->n_sph > SPH_MAX || (w->n_sph > 0 && a.sph_rows == nullptr) ||
      (w->has_env && (w->env_nu < 1 || w->env_nu > ENV_BINS || w->env_nv < 1 ||
                      w->env_nv > ENV_BINS)) ||
      (w->smooth && a.n_tris <= 0))
    return (int)cudaErrorInvalidValue;
  if (a.nodes_f != nullptr) {
    if (a.n_tris <= 0 || a.n_tris > BVH_TRI_MAX || a.nodes_i == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch_shading<true, kRaysIn>(a);
  }
  if (a.n_tris < 0 || a.n_tris > TRI_MAX || (a.n_tris > 0 && a.table == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_shading<false, kRaysIn>(a);
}

}  // namespace

extern "C" {

// Launch one camera sample pass on `stream`: brute force when nodes_f is
// null, the BVH walk otherwise; sph_rows the (n_sph, TABLE_COLS) sphere rows
// (null without spheres); slot_u the Halton slot matrix, (NC, n) float32 rows
// of the slots wide->slot_row maps, or null for the stratified sampler; the
// smooth instance when wide->smooth.  Returns cudaGetLastError() of the
// launch (0 when it was accepted); nothing is synchronised.
int path_mega_cam_launch(const float* table, int n_tris, const float* nodes_f,
                         const int* nodes_i, const Params* params, const float* pixel_xy,
                         const int* pid, const int* sid, float* out_l, float* out_w, int n,
                         void* stream, const float* sph_rows, const WideParams* wide,
                         const float* slot_u) {
  return launch<false>(Launch{table, n_tris, nodes_f, nodes_i, params, pixel_xy, nullptr,
                              nullptr, pid, sid, out_l, out_w, n,
                              static_cast<cudaStream_t>(stream), sph_rows, wide, slot_u});
}

// The same on given rays: o, d (n, 3) and weight (n,); out_l only.
int path_mega_rays_launch(const float* table, int n_tris, const float* nodes_f,
                          const int* nodes_i, const Params* params, const float* o,
                          const float* d, const float* weight, const int* pid, const int* sid,
                          float* out_l, int n, void* stream, const float* sph_rows,
                          const WideParams* wide, const float* slot_u) {
  return launch<true>(Launch{table, n_tris, nodes_f, nodes_i, params, o, d, weight, pid, sid,
                             out_l, nullptr, n, static_cast<cudaStream_t>(stream), sph_rows,
                             wide, slot_u});
}

const char* path_mega_cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int path_mega_cam_params_size() { return (int)sizeof(Params); }

int path_mega_wide_params_size() { return (int)sizeof(WideParams); }

}  // extern "C"
