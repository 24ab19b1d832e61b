// Debug / DirectLighting sample pass for Hopper (sm_90a): one thread per
// camera ray (kRaysIn false) or per given ray (kRaysIn true).
//
// Replaces the TPU kernels rs_ray_toy_tpu/ops/direct_megakernel.py ·
// _kernel_cam (brute force, pallas_call in _run_cam for T <= 2048) and
// _kernel_bvh_cam (the in-kernel BVH, up to 65,536 triangles): _raygen, then
// _chain_loop; and, on given rays (o, d, weight), _kernel and _kernel_bvh
// (pallas_call in _run, li_levels_mega): _chain_loop alone, the reference's recursive specular tree (intersect_debug.rs,
// directlighting.rs, integrator/mod.rs:150-301).  At every tree node: the
// closest hit, the Debug integrator's flat 0.1 base, point-light NEE (every
// light once, or one light picked by a 1-D sample) with an any-hit
// shadow ray, then a reflect child (DEBUG_SPECULAR cosine sample or
// SPEC_REFL mirror) and a transmit child (SPEC_TRANS refraction).  Output:
// RGB radiance and the camera weight per ray.
//
// The TPU kernel unrolls the tree at trace time with a static branch id per
// node.  Here each thread walks its own tree depth first with a small stack
// of frames (origin, direction, beta, branch, depth); the branch id keeps
// the sampler dimensions of the TPU kernel (dim_base = 8 + branch*257, the
// reflect child 2b+1, the transmit child 2b+2).  A node whose beta is zero
// contributes exactly zero and is not visited, so dead subtrees cost
// nothing.  Radiance is summed in the order the nodes are visited: the node,
// then its reflect subtree, then its transmit subtree (the plain version
// li_levels_mega_cam_reference sums in the same order).
//
// What bounds it on this card: like the path kernel, divergent per-thread
// FP32 ALU work (Moller-Trumbore, slab tests, lobes) over small read-only
// tables; 20 bytes in and 16 bytes out per ray.  Geometry as in
// common.cuh: for brute force the chunked walk (ChunkGeometry, K1's and K6's:
// the chunk boxes and the rows' intersect columns staged in shared memory, a
// chunk's rows run only where its box is hit, each behind the division-free
// reject; the winner and its t are the walk over every row's); over a BVH
// the walk of its node64 rows and 48-byte leaf rows (Bvh64Geometry, the path
// kernel's BVH walk) through the read-only cache, the winner's row of the
// table, in the same leaf order, read only to shade.  The instances run in
// blocks of BLOCK under a launch bound of DIRECT_MIN_BLOCKS an SM, but for
// brute force on a table too large for that many blocks' shared memory
// (kUncap).  Given rays add 28 bytes in (o, d, weight) and write no weight.

#include "common.cuh"

namespace {

constexpr int DEPTH_MAX = 8;  // ops/direct_megakernel.DEPTH_MAX

struct Frame {
  float ox, oy, oz, dx, dy, dz, br, bg, bb;
  uint32_t branch;
  int depth;
};

// _lobe_f_dbg: NEE f over the non-specular lobes; debug-diffuse is the
// constant (0, 1, 0), debug-specular and the specular kinds are 0
__device__ void lobe_f_dbg(const Lobe& lob, float wox, float woy, float woz, float wix,
                           float wiy, float wiz, float f[3]) {
  if (lob.kind == LOBE_DEBUG_DIFFUSE) {
    f[0] = 0.0f;
    f[1] = 1.0f;
    f[2] = 0.0f;
  } else if (lob.kind == LOBE_DEBUG_SPECULAR) {
    f[0] = f[1] = f[2] = 0.0f;
  } else {
    lobe_f(lob, wox, woy, woz, wix, wiy, wiz, f);
  }
}

// The last lobe of the stack whose kind is a or b; false when there is none
__device__ bool select_matching(const float* row, int n_lob, int a, int b, Lobe& out) {
  bool has = false;
  for (int l = 0; l < n_lob; ++l) {
    const int kind = (int)__ldg(row + 16 + 16 * l);
    if (kind == a || kind == b) {
      out = load_lobe(row, l);
      has = true;
    }
  }
  return has;
}

// The BVH instances (kBvh): the walk of the node64 rows, inlined at its call
// sites (the closest hit of a tree node, the shadow ray of each light
// strategy), each leaf row loaded when it is tested and meeting the
// division-free reject first, in blocks of BLOCK threads under a launch
// bound that keeps DIRECT_MIN_BLOCKS of them resident an SM (56 registers,
// where the occupancy API's choice was 4 blocks at 120): the walks wait on
// dependent loads, and more resident warps hide them.  Each choice won on
// the card (PERF.md §6: `walk_ab --variant call_walks`, `DIRECT_MIN_BLOCKS=1`
// (then DIRECT_BVH_MIN_BLOCKS), `DIRECT_LEAF_PREFETCH=true`, `no_reject`).
// The brute-force (chunked) instances take the same bound for the same
// reason where the table's shared memory lets the bound's blocks be
// resident: 9 blocks at 56 registers beat the uncapped 4 at 110 by 14-18% and
// 6 at 80 by 3-4% on the Debug fixture, 8 at 64 and 10 at 48 within 2% on
// its camera pass (10 lost 7% on its rays) (`walk_ab --variant
// DIRECT_MIN_BLOCKS=N --only k2`).  A larger table keeps fewer blocks
// resident whatever their registers, and there the cap only spills: the
// launch takes the instance (kUncap) without it, in blocks of up to
// DIRECT_BLOCK_MAX, wherever that keeps more threads resident (choose_block
// on both): on a grid of 1,896 rows (72 KB a block) 2 blocks of 256 at 110
// registers ran 21% faster than the capped 3 of 128 (`--variant k2_capped`).
constexpr int DIRECT_MIN_BLOCKS = 9;
constexpr int DIRECT_BLOCK_MAX = 384;
constexpr bool DIRECT_LEAF_PREFETCH = false;
using DirectBvhGeometry =
    Bvh64Geometry<STACK_DEPTH, false, Bvh64<STACK_DEPTH, DIRECT_LEAF_PREFETCH>>;

// One sample pass per thread.  Brute force: the chunked walk over the
// n_chunks chunk rows geo_a and the n_tris rows of `table`, both staged in
// shared memory (geo_b null).  BVH (kBvh): geo_a holds the node64 rows (null
// for a tree that is one leaf of root_count rows) and geo_b the 48-byte leaf
// rows, both read as float4 rows.  kUncap: a brute-force instance without the
// register cap (see DIRECT_MIN_BLOCKS).
template <bool kBvh, bool kRaysIn, bool kUncap = false>
__global__ void __launch_bounds__(kUncap ? DIRECT_BLOCK_MAX : BLOCK,
                                  kUncap ? 1 : DIRECT_MIN_BLOCKS)
    direct_mega_kernel(const float* __restrict__ table, int n_tris,
                       const float* __restrict__ geo_a, const float* __restrict__ geo_b,
                       const float* __restrict__ in_a, const float* __restrict__ in_d,
                       const float* __restrict__ in_w, const int* __restrict__ pid,
                       const int* __restrict__ sid, float* __restrict__ out_l,
                       float* __restrict__ out_w, int n, const __grid_constant__ Params p,
                       int root_count, int n_chunks) {
  extern __shared__ float4 s_dyn[];  // brute force: the chunk rows, then the rows
  const auto geom = [&] {
    if constexpr (kBvh)
      return DirectBvhGeometry{{reinterpret_cast<const float4*>(geo_a),
                                reinterpret_cast<const float4*>(geo_b), root_count},
                               table};
    else
      return load_chunk_geometry<TABLE_COLS>(s_dyn, table, n_tris, geo_a, n_chunks);
  }();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Sampler smp{(uint32_t)pid[i], (uint32_t)sid[i], &p};

  float ox, oy, oz, dx, dy, dz, weight;
  if constexpr (kRaysIn) {
    // a given ray's origin is the caller's, offset or not
    ox = in_a[3 * i], oy = in_a[3 * i + 1], oz = in_a[3 * i + 2];
    dx = in_d[3 * i], dy = in_d[3 * i + 1], dz = in_d[3 * i + 2];
    weight = in_w[i];
  } else {
    raygen(p, smp, in_a[2 * i], in_a[2 * i + 1], ox, oy, oz, dx, dy, dz, weight);
  }

  float Lr = 0.0f, Lg = 0.0f, Lb = 0.0f;
  Frame stack[DEPTH_MAX];
  int sp = 0;
  if (weight > 0.0f) stack[sp++] = Frame{ox, oy, oz, dx, dy, dz, 1.0f, 1.0f, 1.0f, 0u, 1};
  while (sp > 0) {
    const Frame f = stack[--sp];
    const uint32_t dim_base = 8u + f.branch * 257u;
    float t;
    const int best = geom.closest(f.ox, f.oy, f.oz, f.dx, f.dy, f.dz, t);
    if (best < 0) continue;  // escaped: no infinite lights in this subset
    const float* row = table + (size_t)best * TABLE_COLS;
    const float ngx = __ldg(row + 9), ngy = __ldg(row + 10), ngz = __ldg(row + 11);
    const int n_lob = (int)__ldg(row + 15);
    float ssx, ssy, ssz, tsx, tsy, tsz;
    shading_frame(ngx, ngy, ngz, __ldg(row + 12), __ldg(row + 13), __ldg(row + 14), ssx, ssy,
                  ssz, tsx, tsy, tsz);
    const float px = f.ox + f.dx * t, py = f.oy + f.dy * t, pz = f.oz + f.dz * t;
    const float wox = -f.dx, woy = -f.dy, woz = -f.dz;
    const float wol_x = dot3(wox, woy, woz, ssx, ssy, ssz);
    const float wol_y = dot3(wox, woy, woz, tsx, tsy, tsz);
    const float wo_z = dot3(wox, woy, woz, ngx, ngy, ngz);

    // flat 0.1 base on any hit (intersect_debug.rs:69-72)
    float lvl_r = 0.0f, lvl_g = 0.0f, lvl_b = 0.0f;
    if (p.debug) lvl_r = lvl_g = lvl_b = 0.1f;
    const float mag = fabsf(px) + fabsf(py) + fabsf(pz);
    const float eps = 1e-4f + 1e-5f * mag;

    // estimate_direct for one point light (integrator/mod.rs:403-470)
    auto estimate = [&](int j, float e[3]) {
      const float lpx = p.light_p[3 * j], lpy = p.light_p[3 * j + 1], lpz = p.light_p[3 * j + 2];
      const float tlx = lpx - px, tly = lpy - py, tlz = lpz - pz;
      const float dist2 = fmaxf(tlx * tlx + tly * tly + tlz * tlz, 1e-20f);
      const float inv_d = rsqrt_exact(dist2);
      const float wix = tlx * inv_d, wiy = tly * inv_d, wiz = tlz * inv_d;
      const float wil_x = dot3(wix, wiy, wiz, ssx, ssy, ssz);
      const float wil_y = dot3(wix, wiy, wiz, tsx, tsy, tsz);
      const float wi_ng = dot3(wix, wiy, wiz, ngx, ngy, ngz);
      float fr[3] = {0.0f, 0.0f, 0.0f};
      if ((wi_ng * wo_z) > 0.0f && wo_z != 0.0f) {
        for (int l = 0; l < n_lob; ++l) {
          float lf[3];
          lobe_f_dbg(load_lobe(row, l), wol_x, wol_y, wo_z, wil_x, wil_y, wi_ng, lf);
          for (int c = 0; c < 3; ++c) fr[c] = fr[c] + lf[c];
        }
      }
      e[0] = e[1] = e[2] = 0.0f;
      // f == 0 contributes exactly 0 whether or not the light is occluded
      if (fr[0] == 0.0f && fr[1] == 0.0f && fr[2] == 0.0f) return;
      const float off = wi_ng < 0.0f ? -eps : eps;
      const float sox = px + ngx * off, soy = py + ngy * off, soz = pz + ngz * off;
      if (geom.occluded(sox, soy, soz, lpx - sox, lpy - soy, lpz - soz, SHADOW_T_MAX)) return;
      const float s = fabsf(wi_ng) / dist2;
      for (int c = 0; c < 3; ++c) e[c] = fr[c] * p.light_emit[3 * j + c] * s;
    };

    uint32_t dim_child;
    if (p.strategy_all) {  // uniform_sample_all_lights (mod.rs:304-355)
      // one sample per light: a point light's n_samples is 1
      uint32_t dim = dim_base;
      for (int j = 0; j < p.n_lights; ++j) {
        float e[3];
        dim += 2;  // (u_light, u_scatter): unread for delta lights
        estimate(j, e);
        lvl_r = lvl_r + e[0];
        lvl_g = lvl_g + e[1];
        lvl_b = lvl_b + e[2];
      }
      dim_child = dim;
    } else {  // uniform_sample_one_light (mod.rs:359-401)
      const float u_pick = smp.get_1d(dim_base);
      const int li = min((int)(u_pick * (float)p.n_lights), p.n_lights - 1);
      float e[3];
      estimate(li, e);
      lvl_r = lvl_r + e[0] * (float)p.n_lights;
      lvl_g = lvl_g + e[1] * (float)p.n_lights;
      lvl_b = lvl_b + e[2] * (float)p.n_lights;
      dim_child = dim_base + 3u;
    }
    Lr = Lr + f.br * lvl_r;
    Lg = Lg + f.bg * lvl_g;
    Lb = Lb + f.bb * lvl_b;

    if (f.depth + 1 >= p.max_depth) continue;

    // child tail (integrator/mod.rs:162-176): beta = f |wi.n| / pdf, origin
    // offset to the sampled side; false when the child's beta is zero
    auto child = [&](float wsx, float wsy, float wsz, const float fs[3], float pdf, int ci,
                     Frame& c) {
      const float nwx = ssx * wsx + tsx * wsy + ngx * wsz;
      const float nwy = ssy * wsx + tsy * wsy + ngy * wsz;
      const float nwz = ssz * wsx + tsz * wsy + ngz * wsz;
      const float dn = dot3(nwx, nwy, nwz, ngx, ngy, ngz);
      const float cosw = fabsf(dn);
      if (!(wo_z != 0.0f && pdf > 0.0f && cosw != 0.0f &&
            (fs[0] != 0.0f || fs[1] != 0.0f || fs[2] != 0.0f)))
        return false;
      const float scale = cosw / fmaxf(pdf, 1e-20f);
      c.br = f.br * fs[0] * scale;
      c.bg = f.bg * fs[1] * scale;
      c.bb = f.bb * fs[2] * scale;
      if (c.br == 0.0f && c.bg == 0.0f && c.bb == 0.0f) return false;
      const float off2 = dn < 0.0f ? -eps : eps;
      c.ox = px + ngx * off2;
      c.oy = py + ngy * off2;
      c.oz = pz + ngz * off2;
      c.dx = nwx;
      c.dy = nwy;
      c.dz = nwz;
      c.branch = f.branch * 2u + 1u + (uint32_t)ci;
      c.depth = f.depth + 1;
      return true;
    };

    Frame refl, trans;
    bool has_refl = false, has_trans = false;
    Lobe lob;
    if (p.can_chain && select_matching(row, n_lob, LOBE_DEBUG_SPECULAR, LOBE_SPEC_REFL, lob)) {
      // reflect child: sample_f over SPECULAR|REFLECTION
      float ub0, ub1;
      smp.get_2d(dim_child, ub0, ub1);
      float fs[3] = {0.0f, 0.0f, 0.0f};
      float wsx, wsy, wsz, pdf;
      if (lob.kind == LOBE_DEBUG_SPECULAR) {  // cosine sample, f = (0, 0, 1)
        float dxo, dyo;
        concentric_disk(fminf(ub0, ONE_MINUS_EPSILON), ub1, dxo, dyo);
        float z_cos = sqrtf(fmaxf(0.0f, 1.0f - dxo * dxo - dyo * dyo));
        if (wo_z < 0.0f) z_cos = -z_cos;
        wsx = dxo;
        wsy = dyo;
        wsz = z_cos;
        fs[2] = 1.0f;
        pdf = (wo_z * wsz) > 0.0f ? fabsf(wsz) / PI_F : 0.0f;
      } else {  // mirror
        wsx = -wol_x;
        wsy = -wol_y;
        wsz = wo_z;
        const float aci = fmaxf(fabsf(wsz), 1e-20f);
        float fr[3];
        fresnel(lob, wsz, fr);
        for (int c = 0; c < 3; ++c) fs[c] = lob.s0[c] * fr[c] / aci;
        pdf = 1.0f;
      }
      has_refl = child(wsx, wsy, wsz, fs, pdf, 0, refl);
    }
    if (p.has_st && select_matching(row, n_lob, LOBE_SPEC_TRANS, LOBE_SPEC_TRANS, lob)) {
      // transmit child: SpecularTransmission::sample_f (reflection.rs:686-715)
      const bool entering = wo_z > 0.0f;
      const float ei = entering ? lob.eta_a : lob.eta_b;
      const float et = entering ? lob.eta_b : lob.eta_a;
      const float eta_rel = ei / fmaxf(et, 1e-9f);
      const float abs_cz = fabsf(wo_z);
      const float sin2_t = eta_rel * eta_rel * fmaxf(0.0f, 1.0f - abs_cz * abs_cz);
      const bool st_ok = sin2_t < 1.0f;  // total internal reflection gate
      const float cos_t = sqrtf(fmaxf(0.0f, 1.0f - sin2_t));
      const float nz_sign = entering ? 1.0f : -1.0f;
      const float wsx = -eta_rel * wol_x;
      const float wsy = -eta_rel * wol_y;
      const float wsz = -eta_rel * wo_z + (eta_rel * abs_cz - cos_t) * nz_sign;
      const float scale_t = (ei * ei) / fmaxf(et * et, 1e-20f);
      const float fr_t = fr_dielectric(wsz, lob.eta_a, lob.eta_b);
      const float aci = fmaxf(fabsf(wsz), 1e-20f);
      const float fac = st_ok ? (1.0f - fr_t) * scale_t / aci : 0.0f;
      const float fs[3] = {lob.s0[0] * fac, lob.s0[1] * fac, lob.s0[2] * fac};
      has_trans = child(wsx, wsy, wsz, fs, st_ok ? 1.0f : 0.0f, 1, trans);
    }
    // the reflect subtree is visited first: push it last
    if (has_trans) stack[sp++] = trans;
    if (has_refl) stack[sp++] = refl;
  }
  out_l[3 * i + 0] = Lr;
  out_l[3 * i + 1] = Lg;
  out_l[3 * i + 2] = Lb;
  if constexpr (!kRaysIn) out_w[i] = weight;
}

// The last launch's block size, blocks resident per SM, registers per
// thread and dynamic shared memory bytes: chunked brute force, then BVH
int g_occupancy[2][4] = {};

template <bool kRaysIn>
int launch(const float* table, int n_tris, const float* nodes64, const float* prims,
           int root_count, const Params* params, const float* in_a, const float* in_d,
           const float* in_w, const int* pid, const int* sid, float* out_l, float* out_w, int n,
           void* stream, const float* chunks, int n_chunks) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (n <= 0) return 0;
  if (params->max_depth < 1 || params->max_depth > DEPTH_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (n + BLOCK - 1) / BLOCK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (prims != nullptr) {
    if (n_tris <= 0 || n_tris > BVH_TRI_MAX || table == nullptr || root_count < 0 ||
        root_count > n_tris || (root_count == 0) != (nodes64 != nullptr))
      return (int)cudaErrorInvalidValue;
    const auto kernel = direct_mega_kernel<true, kRaysIn>;
    // blocks of BLOCK (the launch bound); choose_block measures their occupancy
    int block = BLOCK;
    const cudaError_t err =
        choose_block(kernel, BLOCK, [](int) { return (size_t)0; }, block, g_occupancy[1]);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, BLOCK, 0, st>>>(table, n_tris, nodes64, prims, in_a, in_d, in_w, pid, sid,
                                   out_l, out_w, n, *params, root_count, 0);
    return (int)cudaGetLastError();
  }
  if (n_tris <= 0 || n_tris > TRI_MAX || table == nullptr || chunks == nullptr ||
      n_chunks <= 0 || n_chunks > CHUNK_MAX)
    return (int)cudaErrorInvalidValue;
  // each block stages the whole table: the capped instance in blocks of
  // BLOCK, or the uncapped one where it keeps more threads resident
  const size_t smem = chunk_smem(n_tris, n_chunks);
  const auto capped = direct_mega_kernel<false, kRaysIn>;
  const auto uncapped = direct_mega_kernel<false, kRaysIn, true>;
  int block[2], occ[2][4];
  for (int k = 0; k < 2; ++k) {
    const auto kernel = k ? uncapped : capped;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)CHUNK_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    err = choose_block(kernel, k ? DIRECT_BLOCK_MAX : BLOCK, [&](int) { return smem; }, block[k],
                       occ[k]);
    if (err != cudaSuccess) return (int)err;
  }
  const int k = occ[1][0] * occ[1][1] > occ[0][0] * occ[0][1] ? 1 : 0;
  for (int j = 0; j < 4; ++j) g_occupancy[0][j] = occ[k][j];
  (k ? uncapped : capped)<<<(n + block[k] - 1) / block[k], block[k], smem, st>>>(
      table, n_tris, chunks, nullptr, in_a, in_d, in_w, pid, sid, out_l, out_w, n, *params, 0,
      n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one sample pass on `stream`: brute force when prims is null (the
// chunked walk over the (n_chunks, CHUNK_COLS) rows `chunks` that cover the
// table), else the walk of the BVH's node64 rows `nodes64` (null where the
// tree is one leaf of root_count rows; root_count 0 otherwise) over the
// (n_tris, 12) float32 leaf rows `prims` (p0, e1, e2, pad), the table in the
// same leaf order (chunks null, n_chunks 0).  Returns cudaGetLastError() of
// the launch (0 when it was accepted); nothing is synchronised.
int direct_mega_cam_launch(const float* table, int n_tris, const float* nodes64,
                           const float* prims, const Params* params, const float* pixel_xy,
                           const int* pid, const int* sid, float* out_l, float* out_w, int n,
                           void* stream, const float* chunks, int n_chunks, int root_count) {
  return launch<false>(table, n_tris, nodes64, prims, root_count, params, pixel_xy, nullptr,
                       nullptr, pid, sid, out_l, out_w, n, stream, chunks, n_chunks);
}

// The same on given rays: o, d (n, 3) and weight (n,); out_l only.
int direct_mega_rays_launch(const float* table, int n_tris, const float* nodes64,
                            const float* prims, const Params* params, const float* o,
                            const float* d, const float* weight, const int* pid, const int* sid,
                            float* out_l, int n, void* stream, const float* chunks, int n_chunks,
                            int root_count) {
  return launch<true>(table, n_tris, nodes64, prims, root_count, params, o, d, weight, pid, sid,
                      out_l, nullptr, n, stream, chunks, n_chunks);
}

const char* direct_mega_cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int direct_mega_cam_params_size() { return (int)sizeof(Params); }

// The last chunked (bvh 0) or BVH (bvh 1) launch's block size, blocks per
// SM, registers per thread and dynamic shared memory bytes, into out[0..3]
void direct_mega_occupancy(int bvh, int* out) {
  for (int k = 0; k < 4; ++k) out[k] = g_occupancy[bvh != 0][k];
}

}  // extern "C"
