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
// e2: 36 B per triangle, 72 KB at TRI_MAX) and the chunk rows (a padded box
// over up to 16 consecutive rows, 32 B each) staged once per block in shared
// memory, where all lanes of a warp read the same row, so loads broadcast;
// a walk slab-tests each chunk's box against its current best t and runs
// only the hit chunks' rows, each behind a division-free reject
// (common.cuh, ChunkGeometry); the block size is the one at which most
// threads are resident for the table's shared memory (choose_block); BVH mode: a per-ray stack walk with the node rows and the
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
// The textured instances (kTex, K5 g; the camera pass, brute force and BVH,
// stratified sampler, flat shading) give a matte's kd from an image texture:
// each ray also traces the lens at film points 0.05 px to the right and below
// through the same lens sample (_raygen_with_diff), and at a textured hit the
// winner's uv is interpolated at its rebuilt barycentrics and mapped to st; at
// bounce 0 the shifted rays meet the tangent plane and their offsets solve to
// uv footprints against dpdu and dpdv (compute_uv_differentials), which K7's
// EWA tap (texture.cuh) filters with; after bounce 0 the differentials are
// dead and the tap is level 0's bilinear one.  The textured lobe is the
// material's only one, a lambert lobe whose s0 the tap replaces.
//
// Numerics follow the plain PyTorch version (bounce_loop_reference) expression
// by expression; see common.cuh.  sinf and cosf are CUDA's (not correctly
// rounded; no fast-math).

#include <type_traits>

#include "common.cuh"
#include "texture.cuh"

// The triangle walk of an instance: the chunked brute force (common.cuh,
// ChunkGeometry) or the BVH walk
template <bool kBvh>
using PathGeometry = std::conditional_t<kBvh, Geometry<true>, ChunkGeometry>;

// The brute-force instances' largest block (see choose_block)
constexpr int CHUNK_BLOCK_MAX = 384;
constexpr size_t CHUNK_SMEM_MAX = chunk_smem(TRI_MAX, CHUNK_MAX);

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
  // the subsurface branch (kBss): the one material's profile, its folded
  // constants (3 d, 8 pi d, 2 pi d, 6 pi d) and the Sw adapter's
  int has_bss;
  float bss_R[3], bss_d[3], bss_d3[3], bss_sr_den[3], bss_pdf1_den[3], bss_pdf3_den[3];
  float bss_eta;
  float bss_sw_den;  // max(c_sw pi, 1e-9)
  float bss_eta2;
  int smooth;                // the mesh has smooth vertex normals
  short slot_row[SLOT_MAX];  // Halton: slot -> first row of the slot matrix, -1 unused
};

// the kernel's parameters: the three blocks and 15 pointer or int arguments
static_assert(sizeof(Params) + sizeof(WideParams) + sizeof(TexMap) + 16 * 8 <= 4096,
              "kernel parameters exceed the 4 KB limit");

namespace {

constexpr int LIGHT_POINT_KIND = 0;
constexpr int LIGHT_AREA_KIND = 2;
constexpr int LIGHT_ENV_KIND = 3;
constexpr int SPH_MAX = 8;
constexpr int SPH_GEO = 13;       // w2o 3x4 rows and the radius: cols 0..12 of a sphere row
constexpr int SPH_O2W_COL = 96;   // o2w 3x4 rows of a sphere row
constexpr int NRM_COL = 96;       // raw vertex normals n0, n1, n2 of a triangle row
constexpr int TEX0 = NRM_COL + 9;  // textured block: dpdv, uv0, uv1, uv2, textured flag
constexpr float FD_EPS = 0.05f;    // the differentials' film offset, px
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

// ---- the subsurface branch (the JAX kernel's BSSRDF flow, _sample_sr_k,
// _pdf_sr_k, _sw_f_k) ----

constexpr int PROBE_SEGMENTS = 4;
constexpr float PROBE_T_SCALE = (float)(1.0 - 1e-4);  // a segment's t limit over its length

__device__ __forceinline__ float sample_sr(float d_ch, float u) {
  const float u1 = fminf(u * 4.0f, ONE_MINUS_EPSILON);
  const float u2 = fminf((u - 0.25f) / 0.75f, ONE_MINUS_EPSILON);
  return u < 0.25f ? d_ch * logf(1.0f / (1.0f - u1)) : 3.0f * d_ch * logf(1.0f / (1.0f - u2));
}

__device__ __forceinline__ float pdf_sr(const WideParams& w, int c, float r) {
  const float rr = fmaxf(r, 1e-6f);
  return 0.25f * expf(-rr / w.bss_d[c]) / (w.bss_pdf1_den[c] * rr) +
         0.75f * expf(-rr / w.bss_d3[c]) / (w.bss_pdf3_den[c] * rr);
}

__device__ __forceinline__ float sw_f(const WideParams& w, float cos_w) {
  return (1.0f - fr_dielectric(cos_w, 1.0f, w.bss_eta)) / w.bss_sw_den * w.bss_eta2;
}

// A ray that specular-transmitted into the subsurface material at pt: the
// projection axis and channel (u[0], with the reference's u * u * 3 - ch
// remap), a radius of the channel's profile (u[1]) and angle (u[2]), the chord
// through the profile's 0.999 radius re-cast as PROBE_SEGMENTS closest hits,
// each limited to the rest of the chord (the one material: every hit counts),
// the uniform pick among the hits, pdf_sp over 3 axes x 3 channels divided by
// their count; beta times Sp / pdf; the point-light NEE at the exit with the
// Sw adapter and a shadow ray (u[3] picks the light); the cosine exit
// direction (u[4], u[5]), beta times Sw pi.  fr holds ss, ts and ng.  Returns
// false where no exit is found (the path ends), else updates beta and L and
// writes the next ray.  Out of line: one copy per instance, called where a
// sample chose the transmission lobe; the arrays live in its frame.
template <bool kBvh>
__device__ __noinline__ bool subsurface(const PathGeometry<kBvh> geom, const Params& p,
                                        const WideParams& w, const float* pt, const float* fr,
                                        const float* u, float* beta, float* L, float* ray) {
  const float px = pt[0], py = pt[1], pz = pt[2];
  // projection axis (bssrdf.rs:118-141): 1/2 the normal, 1/4 each tangent
  const bool sel0 = u[0] < 0.5f;
  const bool sel1 = u[0] >= 0.5f && u[0] < 0.75f;
  float ub = sel0 ? u[0] * 2.0f : (sel1 ? (u[0] - 0.5f) * 4.0f : (u[0] - 0.75f) * 4.0f);
  const int ax = sel0 ? 0 : (sel1 ? 1 : 2);
  const float* vx = fr + 3 * ax;              // ss, ts, ng
  const float* vy = fr + 3 * ((ax + 1) % 3);  // ts, ng, ss
  const float* vz = fr + 3 * ((ax + 2) % 3);  // ng, ss, ts
  const int chb = min(max((int)(ub * 3.0f), 0), 2);
  ub = ub * ub * 3.0f - (float)chb;
  const float d_ch = w.bss_d[chb];
  const float r_b = sample_sr(d_ch, u[1]);
  const float u999 = fminf((0.999f - 0.25f) / 0.75f, ONE_MINUS_EPSILON);
  const float r_mx = 3.0f * d_ch * logf(1.0f / (1.0f - u999));
  if (!(r_b >= 0.0f && r_b < r_mx)) return false;
  const float l_ch = 2.0f * sqrtf(fmaxf(r_mx * r_mx - r_b * r_b, 0.0f));
  const float phi = TWO_PI_F * u[2];
  const float cphi = cosf(phi), sphi = sinf(phi);
  float c[3], tg[3];
  for (int k = 0; k < 3; ++k) {
    c[k] = pt[k] + (vx[k] * cphi + vy[k] * sphi) * r_b - vz[k] * (l_ch * 0.5f);
    tg[k] = c[k] + vz[k] * l_ch;
  }

  // the probe chain: a miss ends it, so the hits are its first nf segments
  float hit_p[PROBE_SEGMENTS][3];
  int hit_row[PROBE_SEGMENTS];
  int nf = 0;
  for (; nf < PROBE_SEGMENTS; ++nf) {
    const float sgx = tg[0] - c[0], sgy = tg[1] - c[1], sgz = tg[2] - c[2];
    const float sl = sqrtf(fmaxf(sgx * sgx + sgy * sgy + sgz * sgz, 0.0f));
    const float inv_sl = 1.0f / fmaxf(sl, 1e-20f);
    const float pdx = sgx * inv_sl, pdy = sgy * inv_sl, pdz = sgz * inv_sl;
    if (!(sl > 1e-9f)) break;
    float t;
    const int best = geom.closest_below(c[0], c[1], c[2], pdx, pdy, pdz, sl * PROBE_T_SCALE, t);
    if (best < 0) break;
    const float* row = geom.table + (size_t)best * TABLE_COLS;
    const float pnx = __ldg(row + 9), pny = __ldg(row + 10), pnz = __ldg(row + 11);
    const float hx = c[0] + pdx * t, hy = c[1] + pdy * t, hz = c[2] + pdz * t;
    hit_p[nf][0] = hx;
    hit_p[nf][1] = hy;
    hit_p[nf][2] = hz;
    hit_row[nf] = best;
    const float eps = 1e-4f + 1e-5f * (fabsf(hx) + fabsf(hy) + fabsf(hz));
    const float off = pdx * pnx + pdy * pny + pdz * pnz < 0.0f ? -eps : eps;
    c[0] = hx + pnx * off;
    c[1] = hy + pny * off;
    c[2] = hz + pnz * off;
  }
  if (nf == 0) return false;
  const int pick = min(max((int)(ub * (float)nf), 0), max(nf - 1, 0));
  const float ex = hit_p[pick][0], ey = hit_p[pick][1], ez = hit_p[pick][2];
  const float* erow = geom.table + (size_t)hit_row[pick] * TABLE_COLS;
  const float enx = __ldg(erow + 9), eny = __ldg(erow + 10), enz = __ldg(erow + 11);

  // pdf_sp (bssrdf.rs:195-232): 3 axes x 3 channels / nf
  const float dvx = px - ex, dvy = py - ey, dvz = pz - ez;
  float dl[3], nl[3];
  for (int k = 0; k < 3; ++k) {
    dl[k] = dot3(fr[3 * k], fr[3 * k + 1], fr[3 * k + 2], dvx, dvy, dvz);
    nl[k] = dot3(fr[3 * k], fr[3 * k + 1], fr[3 * k + 2], enx, eny, enz);
  }
  const float rp[3] = {sqrtf(fmaxf(dl[1] * dl[1] + dl[2] * dl[2], 0.0f)),
                       sqrtf(fmaxf(dl[2] * dl[2] + dl[0] * dl[0], 0.0f)),
                       sqrtf(fmaxf(dl[0] * dl[0] + dl[1] * dl[1], 0.0f))};
  const float aprob[3] = {0.25f, 0.25f, 0.5f};
  float pdf_b = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float anl = fabsf(nl[k]);
    for (int ch = 0; ch < 3; ++ch) pdf_b = pdf_b + pdf_sr(w, ch, rp[k]) * anl * aprob[k];
  }
  pdf_b = pdf_b * (1.0f / 3.0f);
  pdf_b = pdf_b / fmaxf((float)nf, 1.0f);
  if (!(pdf_b > 0.0f)) return false;
  const float dist = sqrtf(fmaxf(dvx * dvx + dvy * dvy + dvz * dvz, 0.0f));
  const float rr = fmaxf(dist, 1e-6f);
  const float inv_pb = 1.0f / fmaxf(pdf_b, 1e-20f);
  for (int ch = 0; ch < 3; ++ch) {
    const float sp = w.bss_R[ch] * (expf(-rr / w.bss_d[ch]) + expf(-rr / w.bss_d3[ch])) /
                     (w.bss_sr_den[ch] * rr);
    beta[ch] = beta[ch] * sp * inv_pb;
  }

  const float eps = 1e-4f + 1e-5f * (fabsf(ex) + fabsf(ey) + fabsf(ez));
  if (p.n_lights > 0) {
    // the exit's direct light: a uniformly picked point light, the Sw adapter
    const int li = min((int)(u[3] * (float)p.n_lights), p.n_lights - 1);
    const float lx = p.light_p[3 * li], ly = p.light_p[3 * li + 1], lz = p.light_p[3 * li + 2];
    const float t2x = lx - ex, t2y = ly - ey, t2z = lz - ez;
    const float d2b = fmaxf(t2x * t2x + t2y * t2y + t2z * t2z, 1e-20f);
    const float inv_db = rsqrt_exact(d2b);
    const float cwi = dot3(t2x * inv_db, t2y * inv_db, t2z * inv_db, enx, eny, enz);
    const float fsw = sw_f(w, cwi) * fabsf(cwi);
    const float off = dot3(t2x, t2y, t2z, enx, eny, enz) < 0.0f ? -eps : eps;
    const float sx = ex + enx * off, sy = ey + eny * off, sz = ez + enz * off;
    if (!geom.occluded(sx, sy, sz, lx - sx, ly - sy, lz - sz, SHADOW_T_MAX)) {
      const float sc2 = fsw * (float)p.n_lights / d2b;
      for (int ch = 0; ch < 3; ++ch) L[ch] = L[ch] + beta[ch] * p.light_emit[3 * li + ch] * sc2;
    }
  }

  // the next direction: the Sw adapter cosine-sampled at the exit
  float dxo, dyo;
  concentric_disk(u[4], u[5], dxo, dyo);
  const float zo = sqrtf(fmaxf(0.0f, 1.0f - dxo * dxo - dyo * dyo));
  const bool use_x = fabsf(enx) > fabsf(eny);
  const float inv_a = 1.0f / sqrtf(use_x ? enx * enx + enz * enz : eny * eny + enz * enz);
  const float a1x = (use_x ? -enz : 0.0f) * inv_a;
  const float a1y = (use_x ? 0.0f : enz) * inv_a;
  const float a1z = (use_x ? enx : -eny) * inv_a;
  const float a2x = eny * a1z - enz * a1y, a2y = enz * a1x - enx * a1z, a2z = enx * a1y - eny * a1x;
  const float wx = a1x * dxo + a2x * dyo + enx * zo;
  const float wy = a1y * dxo + a2y * dyo + eny * zo;
  const float wz = a1z * dxo + a2z * dyo + enz * zo;
  const float swo = sw_f(w, fmaxf(zo, 1e-9f)) * PI_F;
  for (int ch = 0; ch < 3; ++ch) beta[ch] = beta[ch] * swo;
  const float off = dot3(wx, wy, wz, enx, eny, enz) < 0.0f ? -eps : eps;
  ray[0] = ex + enx * off;
  ray[1] = ey + eny * off;
  ray[2] = ez + enz * off;
  ray[3] = wx;
  ray[4] = wy;
  ray[5] = wz;
  return true;
}

// ---- the textured kd (K5 g) ----

// kd of a textured triangle row at the hit p of the ray (o, d): the uv at the
// barycentrics rebuilt from the row (smooth_normal's guards), mapped to st;
// at bounce 0 (fd: the differential rays) the EWA tap over the footprints
// the offset rays give against dpdu and dpdv on ng's tangent plane, after it
// (fd null: dead differentials) level 0's bilinear tap; times the scale.
__device__ void textured_kd(const float* row, const float* tex, const TexMap& tm, float ox,
                            float oy, float oz, float dx, float dy, float dz, float px, float py,
                            float pz, float ngx, float ngy, float ngz, float dux, float duy,
                            float duz, const float* fd, float kd[3]) {
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
  const float* tb = row + TEX0;
  const float uvu = b0 * __ldg(tb + 3) + b1 * __ldg(tb + 5) + b2 * __ldg(tb + 7);
  const float uvv = b0 * __ldg(tb + 4) + b1 * __ldg(tb + 6) + b2 * __ldg(tb + 8);
  const float s = tm.su * uvu + tm.du;
  const float t = tm.sv * uvv + tm.dv;
  if (fd == nullptr) {
    tex_bilerp(tex, tm, 0, s, t, kd);
  } else {
    // compute_uv_differentials: the offset rays on the plane of ng at p
    const float d_plane = ngx * px + ngy * py + ngz * pz;
    float dp[2][3];
    for (int k = 0; k < 2; ++k) {
      const float* r = fd + 6 * k;  // origin, direction
      float den = ngx * r[3] + ngy * r[4] + ngz * r[5];
      den = fabsf(den) < 1e-9f ? 1e-9f : den;
      const float th = (d_plane - (ngx * r[0] + ngy * r[1] + ngz * r[2])) / den;
      dp[k][0] = r[0] + r[3] * th - px;
      dp[k][1] = r[1] + r[4] * th - py;
      dp[k][2] = r[2] + r[5] * th - pz;
    }
    // the two axes other than ng's largest (first of equal ones)
    const float ax0 = fabsf(ngx), ax1 = fabsf(ngy), ax2 = fabsf(ngz);
    const bool k0 = ax0 >= ax1 && ax0 >= ax2;
    const bool kmax2 = !k0 && ax2 > ax1;
    const float dvx = __ldg(tb + 0), dvy = __ldg(tb + 1), dvz = __ldg(tb + 2);
    const float a00 = k0 ? duy : dux, a01 = k0 ? dvy : dvx;
    const float a10 = kmax2 ? duy : duz, a11 = kmax2 ? dvy : dvz;
    const float det_s = a00 * a11 - a01 * a10;
    const bool okd = fabsf(det_s) >= 1e-10f;
    const float invd = 1.0f / (okd ? det_s : 1.0f);
    float duv[4];
    for (int k = 0; k < 2; ++k) {
      const float c0 = k0 ? dp[k][1] : dp[k][0];
      const float c1 = kmax2 ? dp[k][1] : dp[k][2];
      const float du = okd ? (a11 * c0 - a01 * c1) * invd : 0.0f;
      const float dv = okd ? (a00 * c1 - a10 * c0) * invd : 0.0f;
      duv[2 * k] = isfinite(du) ? du : 0.0f;
      duv[2 * k + 1] = isfinite(dv) ? dv : 0.0f;
    }
    tex_ewa_lookup(tex, tm, s, t, duv[0] * tm.su, duv[1] * tm.sv, duv[2] * tm.su,
                   duv[3] * tm.sv, kd);
  }
  for (int c = 0; c < 3; ++c) kd[c] = kd[c] * tm.scale;
}

// ---- the bounce loop (_bounce_loop), one ray ----

template <bool kBvh, bool kSmooth, bool kBss, bool kTex, class Smp>
__device__ void bounce_loop(const PathGeometry<kBvh>& geom, const float* table,
                            const float* sph_rows, const float* s_sph, const Params& p,
                            const WideParams& w, const Smp& smp, float ox, float oy,
                            float oz, float dx, float dy, float dz, bool active, float L[3],
                            const float* tex, const TexMap& tm, const float* fd) {
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
    bool texed = false;  // kTex: a textured triangle won
    float ngx = 0.0f, ngy = 0.0f, ngz = 0.0f, dux = 0.0f, duy = 0.0f, duz = 0.0f;
    float nsx = 0.0f, nsy = 0.0f, nsz = 0.0f;
    if (best >= 0) {
      ngx = __ldg(row + 9), ngy = __ldg(row + 10), ngz = __ldg(row + 11);
      dux = __ldg(row + 12), duy = __ldg(row + 13), duz = __ldg(row + 14);
      if constexpr (kSmooth)
        smooth_normal(row, NRM_COL, ox, oy, oz, dx, dy, dz, ngx, ngy, ngz, nsx, nsy, nsz);
      if constexpr (kTex) texed = __ldg(row + TEX0 + 9) > 0.0f;
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
        texed = false;
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

    // the lobes of the hit; kTex: a textured row's one lambert lobe takes
    // kd from the image texture
    float kd[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (kTex) {
      if (texed)
        textured_kd(row, tex, tm, ox, oy, oz, dx, dy, dz, px, py, pz, ngx, ngy, ngz, dux, duy,
                    duz, bounce == 0 ? fd : nullptr, kd);
    }
    const auto lobe_at = [&](int l) {
      Lobe lob = load_lobe(row, l);
      if constexpr (kTex) {
        if (texed && l == 0)
          for (int c = 0; c < 3; ++c) lob.s0[c] = kd[c];
      }
      return lob;
    };

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
          lobe_f<true>(lobe_at(l), wol_x, wol_y, wo_z, wil_x, wil_y, wil_z, lf);
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
        const Lobe lob = lobe_at(l);
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
        BsdfSample s2 = bsdf_sample<true>(row, n_lob, wol_x, wol_y, wo_z, us0, us1);
        if constexpr (kTex) {  // the textured lambert lobe is the only one
          if (texed) lobe_f<true>(lobe_at(0), wol_x, wol_y, wo_z, s2.wx, s2.wy, s2.wz, s2.f);
        }
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
    BsdfSample bs = bsdf_sample<true, kBss>(row, n_lob, wol_x, wol_y, wo_z, ub0, ub1);
    if constexpr (kTex) {  // the textured lambert lobe is the only one
      if (texed) lobe_f<true>(lobe_at(0), wol_x, wol_y, wo_z, bs.wx, bs.wy, bs.wz, bs.f);
    }
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

    if constexpr (kBss) {
      // ---- the subsurface branch (path.rs:166-210) where the sample chose
      // the transmission lobe of the one (subsurface) material ----
      const int matching = max(n_lob, 1);
      const int comp = min((int)(ub0 * (float)matching), matching - 1);
      if ((int)__ldg(row + 16 + 16 * comp) == LOBE_SPEC_TRANS) {
        float u[6], beta[3] = {br, bg, bb}, Lb3[3] = {Lr, Lg, Lb}, ray[6];
        u[0] = smp.get_1d(dim0 + 5);
        smp.get_2d(dim0 + 6, u[1], u[2]);
        u[3] = smp.get_1d(dim0 + 7);
        smp.get_2d(dim0 + 9, u[4], u[5]);
        const float pt[3] = {px, py, pz};
        const float fr[9] = {ssx, ssy, ssz, tsx, tsy, tsz, ngx, ngy, ngz};
        if (!subsurface<kBvh>(geom, p, w, pt, fr, u, beta, Lb3, ray)) break;
        br = beta[0], bg = beta[1], bb = beta[2];
        Lr = Lb3[0], Lg = Lb3[1], Lb = Lb3[2];
        ox = ray[0], oy = ray[1], oz = ray[2];
        dx = ray[3], dy = ray[4], dz = ray[5];
        spec_prev = false;
      }
    }

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

template <bool kBvh, bool kRaysIn, bool kSlots, bool kSmooth, bool kBss, bool kTex>
__global__ void __launch_bounds__(kBvh ? BLOCK : CHUNK_BLOCK_MAX)
    path_mega_kernel(const float* __restrict__ table, int n_tris,
                     const float* __restrict__ chunks, int n_chunks,
                     const float* __restrict__ nodes_f, const int* __restrict__ nodes_i,
                     const float* __restrict__ sph_rows, const float* __restrict__ in_a,
                     const float* __restrict__ in_d, const float* __restrict__ in_w,
                     const int* __restrict__ pid, const int* __restrict__ sid,
                     const float* __restrict__ slot_u, float* __restrict__ out_l,
                     float* __restrict__ out_w, int n, const __grid_constant__ Params p,
                     const __grid_constant__ WideParams w, const float* __restrict__ tex,
                     const __grid_constant__ TexMap tm) {
  extern __shared__ float4 s_dyn[];  // brute force: the chunk rows, then the rows
  __shared__ float s_sph[SPH_MAX * SPH_GEO];
  for (int k = threadIdx.x; k < w.n_sph * SPH_GEO; k += blockDim.x)
    s_sph[k] = __ldg(sph_rows + (k / SPH_GEO) * TABLE_COLS + k % SPH_GEO);
  const PathGeometry<kBvh> geom = [&] {
    if constexpr (kBvh)
      return load_geometry<true>(nullptr, table, n_tris, nodes_f, nodes_i);
    else
      return load_chunk_geometry<TABLE_COLS>(s_dyn, table, n_tris, chunks, n_chunks);
  }();
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
  float fd[12];  // kTex: the differential rays, origin and direction, x then y
  if constexpr (kRaysIn) {
    ox = in_a[3 * i], oy = in_a[3 * i + 1], oz = in_a[3 * i + 2];
    dx = in_d[3 * i], dy = in_d[3 * i + 1], dz = in_d[3 * i + 2];
    weight = in_w[i];
  } else if constexpr (kTex) {
    // _raygen_with_diff: the film points shifted FD_EPS px in x and in y
    // through the same lens sample, scaled by 1 / sqrt(spp), the ray itself
    // where a shifted trace dies
    float uf0, uf1, ul0, ul1;
    smp.get_2d(0, uf0, uf1);
    smp.get_2d(1, ul0, ul1);
    const float px = in_a[2 * i], py = in_a[2 * i + 1];
    raygen_u(p, uf0, uf1, ul0, ul1, px, py, ox, oy, oz, dx, dy, dz, weight);
    const float base[6] = {ox, oy, oz, dx, dy, dz};
    for (int k = 0; k < 2; ++k) {
      float r[6], wk;
      raygen_u(p, uf0, uf1, ul0, ul1, k == 0 ? px + FD_EPS : px, k == 0 ? py : py + FD_EPS,
               r[0], r[1], r[2], r[3], r[4], r[5], wk);
      for (int c = 0; c < 6; ++c)
        fd[6 * k + c] =
            wk > 0.0f ? base[c] + (r[c] - base[c]) / FD_EPS * tm.fd_scale : base[c];
    }
  } else {
    raygen(p, smp, in_a[2 * i], in_a[2 * i + 1], ox, oy, oz, dx, dy, dz, weight);
  }
  float L[3];
  bounce_loop<kBvh, kSmooth, kBss, kTex>(geom, table, sph_rows, s_sph, p, w, smp, ox, oy, oz, dx,
                                         dy, dz, weight > 0.0f, L, tex, tm, fd);
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
  const float* tex;  // the textured instances: the image's pyramid, else null
  const TexMap* tm;
  const float* chunks;  // brute force: (n_chunks, CHUNK_COLS) chunk rows
  int n_chunks;
};

// The last brute-force launch's block size, its blocks resident per SM, the
// instance's registers per thread and the block's dynamic shared memory
int g_occupancy[4] = {0, 0, 0, 0};

// The block size of a brute-force launch: of the multiples of 32 from BLOCK
// to CHUNK_BLOCK_MAX, the one at which the most threads are resident on an
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor: registers x block size
// and shared memory per block), the smaller on a tie.  Every block stages
// the whole table, so the shared memory per block is the table's whatever the
// block size, and a larger block stages it for more rays.
template <class Kernel>
cudaError_t choose_block(Kernel kernel, size_t smem, int& block) {
  int best = 0;
  block = BLOCK;
  for (int b = BLOCK; b <= CHUNK_BLOCK_MAX; b += 32) {
    int n_blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_blocks, kernel, b, smem);
    if (err != cudaSuccess) return err;
    if (n_blocks * b > best) best = n_blocks * b, block = b;
  }
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  g_occupancy[0] = block;
  g_occupancy[1] = best / block;
  g_occupancy[2] = attr.numRegs;
  g_occupancy[3] = (int)smem;
  return cudaSuccess;
}

template <bool kBvh, bool kRaysIn, bool kSlots, bool kSmooth, bool kBss = false,
          bool kTex = false>
int launch_instance(const Launch& a) {
  const auto kernel = path_mega_kernel<kBvh, kRaysIn, kSlots, kSmooth, kBss, kTex>;
  int block = BLOCK;
  size_t smem = 0;
  if constexpr (!kBvh) {
    // the whole TRI_MAX table exceeds the 48 KB default for dynamic shared memory
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)CHUNK_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    smem = chunk_smem(a.n_tris, a.n_chunks);
    err = choose_block(kernel, smem, block);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (a.n + block - 1) / block;
  kernel<<<grid, block, smem, a.stream>>>(a.table, a.n_tris, a.chunks, a.n_chunks, a.nodes_f,
                                          a.nodes_i, a.sph_rows, a.in_a, a.in_d, a.in_w, a.pid,
                                          a.sid, a.slot_u, a.out_l, a.out_w, a.n, *a.params,
                                          *a.wide, a.tex, *a.tm);
  return (int)cudaGetLastError();
}

template <bool kBvh, bool kRaysIn>
int launch_shading(const Launch& a) {
  if constexpr (!kRaysIn) {  // the textured instances: stratified, flat
    if (a.tex != nullptr) return launch_instance<kBvh, false, false, false, false, true>(a);
  }
  if (a.wide->has_bss)  // the subsurface instances: flat triangles only
    return a.slot_u != nullptr ? launch_instance<kBvh, kRaysIn, true, false, true>(a)
                               : launch_instance<kBvh, kRaysIn, false, false, true>(a);
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
      (w->smooth && a.n_tris <= 0) ||
      (w->has_bss && (w->smooth || w->n_sph > 0 || a.n_tris <= 0)) ||
      (a.tex != nullptr && (kRaysIn || a.slot_u != nullptr || w->smooth || w->has_bss ||
                            a.n_tris <= 0 || a.tm->n_levels < 1 ||
                            a.tm->n_levels > TEX_LEVELS)))
    return (int)cudaErrorInvalidValue;
  if (a.nodes_f != nullptr) {
    if (a.n_tris <= 0 || a.n_tris > BVH_TRI_MAX || a.nodes_i == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch_shading<true, kRaysIn>(a);
  }
  if (a.n_tris < 0 || a.n_tris > TRI_MAX || (a.n_tris > 0 && a.table == nullptr) ||
      a.n_chunks < 0 || a.n_chunks > CHUNK_MAX || (a.n_tris > 0) != (a.n_chunks > 0) ||
      (a.n_chunks > 0 && a.chunks == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_shading<false, kRaysIn>(a);
}

}  // namespace

extern "C" {

// Launch one camera sample pass on `stream`: brute force when nodes_f is
// null (the chunked walk over the (n_chunks, CHUNK_COLS) rows `chunks` that
// cover the table), the BVH walk otherwise; sph_rows the (n_sph, TABLE_COLS) sphere rows
// (null without spheres); slot_u the Halton slot matrix, (NC, n) float32 rows
// of the slots wide->slot_row maps, or null for the stratified sampler; the
// smooth instance when wide->smooth; the textured instance when tex (the
// image's pyramid, tm its TexMap) is not null.  Returns cudaGetLastError() of
// the launch (0 when it was accepted); nothing is synchronised.
int path_mega_cam_launch(const float* table, int n_tris, const float* nodes_f,
                         const int* nodes_i, const Params* params, const float* pixel_xy,
                         const int* pid, const int* sid, float* out_l, float* out_w, int n,
                         void* stream, const float* sph_rows, const WideParams* wide,
                         const float* slot_u, const float* tex, const TexMap* tm,
                         const float* chunks, int n_chunks) {
  return launch<false>(Launch{table, n_tris, nodes_f, nodes_i, params, pixel_xy, nullptr,
                              nullptr, pid, sid, out_l, out_w, n,
                              static_cast<cudaStream_t>(stream), sph_rows, wide, slot_u, tex,
                              tm, chunks, n_chunks});
}

// The same on given rays: o, d (n, 3) and weight (n,); out_l only.
int path_mega_rays_launch(const float* table, int n_tris, const float* nodes_f,
                          const int* nodes_i, const Params* params, const float* o,
                          const float* d, const float* weight, const int* pid, const int* sid,
                          float* out_l, int n, void* stream, const float* sph_rows,
                          const WideParams* wide, const float* slot_u, const float* chunks,
                          int n_chunks) {
  static const TexMap no_tex{};
  return launch<true>(Launch{table, n_tris, nodes_f, nodes_i, params, o, d, weight, pid, sid,
                             out_l, nullptr, n, static_cast<cudaStream_t>(stream), sph_rows,
                             wide, slot_u, nullptr, &no_tex, chunks, n_chunks});
}

const char* path_mega_cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int path_mega_cam_params_size() { return (int)sizeof(Params); }

int path_mega_wide_params_size() { return (int)sizeof(WideParams); }

int path_mega_tex_map_size() { return (int)sizeof(TexMap); }

// The last brute-force launch's block size, blocks per SM, registers per
// thread and dynamic shared memory bytes, into out[0..3]
void path_mega_occupancy(int* out) {
  for (int k = 0; k < 4; ++k) out[k] = g_occupancy[k];
}

int path_mega_chunk_max() { return CHUNK_MAX; }

}  // extern "C"
