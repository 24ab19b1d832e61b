// Path-integrator sample pass for Hopper (sm_90a): one thread per camera ray.
//
// Replaces the TPU kernels rs_ray_toy_tpu/ops/path_megakernel.py · _kernel_cam
// (brute force, pallas_call in _run_cam for T <= 2048) and _kernel_cam_bvh
// (the in-kernel BVH, up to 65,536 triangles), on their triangle-only,
// flat-shaded, stratified-sampler, point-light subset.  Per ray it evaluates
// the sampler hash for every slot it consumes, traces the lens system
// (_raygen), and runs the bounce loop (_bounce_loop): closest hit over the
// triangle table, point-light NEE with an any-hit shadow ray, one BSDF sample
// over lambert / Trowbridge-Reitz microfacet / specular-reflect /
// fresnel-specular lobes with the etaScale factor, and Russian roulette after
// bounce 3.  Output: RGB radiance and the camera weight per ray.
//
// What bounds it on this card: divergent per-thread FP32 ALU work over
// read-only tables (a few KB of triangles for the fixture, ~9 MB of table and
// nodes for a 19,200-triangle mesh), lights and lens constants.  It moves 20
// bytes in and 16 bytes out per ray, so it is latency- and occupancy-bound,
// not bandwidth-bound.  The simple design answers that with
// (a) no packets and no padding: each thread walks its own ray to
// termination, so dead rays retire instead of idling in a masked tile;
// (b) brute force (T <= 2048): the intersect-side triangle columns (p0, e1,
// e2: 36 B per triangle, 72 KB at TRI_MAX) staged once per block in shared
// memory, where all lanes of a warp read the same triangle, so loads
// broadcast; BVH mode: a per-ray stack walk with the node rows and the
// triangle table read through the read-only cache (common.cuh, Geometry);
// (c) lens, pupil and light constants in one __grid_constant__ parameter
// block (constant bank).  Warp divergence between lobes, path lengths and
// BVH walks is accepted for now.
//
// Numerics follow the plain PyTorch version (li_path_mega_cam_reference)
// expression by expression; see common.cuh.

#include "common.cuh"

namespace {

// ---- one sample pass per thread ----

template <bool kBvh>
__global__ void __launch_bounds__(BLOCK)
    path_mega_cam_kernel(const float* __restrict__ table, int n_tris,
                         const float* __restrict__ nodes_f, const int* __restrict__ nodes_i,
                         const float* __restrict__ pixel_xy, const int* __restrict__ pid,
                         const int* __restrict__ sid, float* __restrict__ out_l,
                         float* __restrict__ out_w, int n, const __grid_constant__ Params p) {
  extern __shared__ float s_geo[];
  const Geometry<kBvh> geom = load_geometry<kBvh>(s_geo, table, n_tris, nodes_f, nodes_i);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Sampler smp{(uint32_t)pid[i], (uint32_t)sid[i], &p};

  float ox, oy, oz, dx, dy, dz, weight;
  raygen(p, smp, pixel_xy[2 * i], pixel_xy[2 * i + 1], ox, oy, oz, dx, dy, dz, weight);

  float Lr = 0.0f, Lg = 0.0f, Lb = 0.0f;
  float br = 1.0f, bg = 1.0f, bb = 1.0f;
  float es = 1.0f;  // etaScale (path.rs:150-163)
  bool active = weight > 0.0f;
  for (int bounce = 0; bounce < p.max_depth && active; ++bounce) {
    float t;
    const int best = geom.closest(ox, oy, oz, dx, dy, dz, t);
    if (!(t < BIG_T)) break;  // escaped: no infinite lights in this subset
    const float* row = table + (size_t)best * TABLE_COLS;
    const float ngx = __ldg(row + 9), ngy = __ldg(row + 10), ngz = __ldg(row + 11);
    const float dux = __ldg(row + 12), duy = __ldg(row + 13), duz = __ldg(row + 14);
    const int n_lob = (int)__ldg(row + 15);
    const float mat_eta = __ldg(row + 31);
    // flat shading: the shading normal is the geometric normal
    const float nsx = ngx, nsy = ngy, nsz = ngz;

    const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;

    float ssx, ssy, ssz, tsx, tsy, tsz;
    shading_frame(nsx, nsy, nsz, dux, duy, duz, ssx, ssy, ssz, tsx, tsy, tsz);

    const float wox = -dx, woy = -dy, woz = -dz;
    const float wol_x = dot3(wox, woy, woz, ssx, ssy, ssz);
    const float wol_y = dot3(wox, woy, woz, tsx, tsy, tsz);
    const float wo_z = dot3(wox, woy, woz, nsx, nsy, nsz);
    const float wo_ng = wo_z;

    const int dim0 = 8 + bounce * 11;  // sampler/dims.path_dim0
    const float mag = fabsf(px) + fabsf(py) + fabsf(pz);
    const float eps = 1e-4f + 1e-5f * mag;

    // ---- NEE, point lights (uniform_sample_one_light) ----
    {
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
      const float wi_ng = wil_z;
      const bool f_gate = (wi_ng * wo_ng) > 0.0f && wo_z != 0.0f;
      float fn[3] = {0.0f, 0.0f, 0.0f};
      if (f_gate) {
        for (int l = 0; l < n_lob; ++l) {
          float lf[3];
          lobe_f(load_lobe(row, l), wol_x, wol_y, wo_z, wil_x, wil_y, wil_z, lf);
          for (int c = 0; c < 3; ++c) fn[c] = fn[c] + lf[c];
        }
      }
      const float cos_ns = fabsf(wil_z);
      const float off = wi_ng < 0.0f ? -eps : eps;
      const float sox = px + ngx * off, soy = py + ngy * off, soz = pz + ngz * off;
      const bool occ =
          geom.occluded(sox, soy, soz, lpx - sox, lpy - soy, lpz - soz, SHADOW_T_MAX);
      const float li_scale = occ ? 0.0f : cos_ns * (float)p.n_lights / dist2;
      Lr = Lr + br * fn[0] * p.light_emit[3 * li] * li_scale;
      Lg = Lg + bg * fn[1] * p.light_emit[3 * li + 1] * li_scale;
      Lb = Lb + bb * fn[2] * p.light_emit[3 * li + 2] * li_scale;
    }

    // ---- BSDF sample (Bsdf::sample_f, reference-quirk exact) ----
    float ub0, ub1;
    smp.get_2d(dim0 + 3, ub0, ub1);
    const BsdfSample bs = bsdf_sample(row, n_lob, wol_x, wol_y, wo_z, ub0, ub1);
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
  out_l[3 * i + 0] = Lr;
  out_l[3 * i + 1] = Lg;
  out_l[3 * i + 2] = Lb;
  out_w[i] = weight;
}

}  // namespace

extern "C" {

// Launch one sample pass on `stream`: brute force when nodes_f is null, the
// BVH walk otherwise.  Returns cudaGetLastError() of the launch (0 when it
// was accepted); nothing is synchronised.
int path_mega_cam_launch(const float* table, int n_tris, const float* nodes_f,
                         const int* nodes_i, const Params* params, const float* pixel_xy,
                         const int* pid, const int* sid, float* out_l, float* out_w, int n,
                         void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  if (n <= 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nodes_f != nullptr) {
    if (n_tris <= 0 || n_tris > BVH_TRI_MAX || nodes_i == nullptr)
      return (int)cudaErrorInvalidValue;
    path_mega_cam_kernel<true><<<grid, BLOCK, 0, st>>>(
        table, n_tris, nodes_f, nodes_i, pixel_xy, pid, sid, out_l, out_w, n, *params);
    return (int)cudaGetLastError();
  }
  if (n_tris <= 0 || n_tris > TRI_MAX) return (int)cudaErrorInvalidValue;
  // the whole TRI_MAX table exceeds the 48 KB default for dynamic shared memory
  const cudaError_t attr = cudaFuncSetAttribute(
      path_mega_cam_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = (size_t)n_tris * GEO_COLS * sizeof(float);
  path_mega_cam_kernel<false><<<grid, BLOCK, smem, st>>>(
      table, n_tris, nullptr, nullptr, pixel_xy, pid, sid, out_l, out_w, n, *params);
  return (int)cudaGetLastError();
}

const char* path_mega_cam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int path_mega_cam_params_size() { return (int)sizeof(Params); }

}  // extern "C"
