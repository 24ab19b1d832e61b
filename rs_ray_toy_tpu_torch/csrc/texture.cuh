// K7: the image-texture tap for Hopper (sm_90a), the exact EWA filter.
//
// Replaces the TPU kernel pieces rs_ray_toy_tpu/ops/tex_tile.py · tile_lookup,
// lookup_planes, _level_planes and ewa_lod (inside the path kernels #1 and
// #2: the RGB kd of a textured matte).  Those tap a packed coarse pyramid by
// one-hot bf16 matmuls and replace the elliptical Gaussian by a bilerp a
// level, because per-lane gathers serialize on the TPU (scene/mipmap.py
// MIPMap.as_packed, packed_ewa_lookup).  This card loads texels directly, so
// the tap computes the JAX package's exact filter, scene/mipmap.ewa_lookup
// (mipmap.rs lookup_d): the eccentricity clamp to max_aniso, the level from
// the minor axis, at each of the two levels the ellipse with the +1 texel
// blur, its window of up to EWA_WINDOW texels a side scanned texel by texel
// (rows, then columns) with the weights exp(-2 r^2) - exp(-2) inside r^2 < 1,
// the weighted mean, and level 0's bilinear tap for a degenerate footprint.
// The plain version is rs_ray_toy_tpu_torch/scene/mipmap.ewa_lookup: the same
// expressions in the same order, the same sums (it scans the whole window;
// ops/texture.ewa_row_spans is the plain twin of the rows and columns this
// tap visits).
//
// The pyramid is one flat float32 buffer, finest level first, each level's
// rows of RGB texels; TexMap carries the levels' (h, w, offset), the wrap
// mode and the image texture's UV mapping and scale.  Texels are read as
// float32 through the read-only path (__ldg), never through the hardware
// texture units, whose 8-bit filter weights would not give these sums.
//
// What bounds it on this card: a lookup reads the texels of non-zero weight
// (12 B each; a window's rows are contiguous, so neighbouring lanes of a
// warp that look near each other share cache lines) and spends ~10 FP32
// operations on each texel it weighs; a pyramid of a 512x512 image (4 MB)
// stays in L2.  The design: one thread a lookup, the weights computed in
// registers and a texel loaded only where its weight is not zero.  Of the
// window, only the texels that can hold r^2 < 1 are visited: at each level
// the rows whose quadratic in ss can reach r^2 < 1 and in each such row the
// columns between its roots, widened by a texel on each side (ewa_row_span).
// The level is chosen from the minor axis, so the ellipse covers a small
// share of the 16 x 16 window (a thin diagonal one still spans about half
// of it on each axis); the texels left out all have r^2 >= 1 (or NaN) and
// weigh nothing, and the visited ones keep their order, so the sums are the
// full scan's, bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TEX_LEVELS = 16;  // scene/mipmap.LEVELS_MAX
constexpr int EWA_WINDOW = 16;
constexpr int WRAP_REPEAT = 0;
constexpr int WRAP_BLACK = 1;
constexpr int WRAP_CLAMP = 2;
constexpr float EXP_M2 = (float)0.1353352832366127;  // exp(-2)
constexpr float ST_CLAMP_TOP = (float)(1.0 - 1e-7);
// ewa_row_span's margins: the roots are taken at r^2 = 1 + SPAN_MARGIN (|a| +
// |b| + |c|) + SPAN_FLOOR, above the rounding of r^2 as the scan computes it
// over the window (|ss|, |tt| < 16: at most ~2^-14 (|a| + |b| + |c|)); a
// row's discriminant is trusted to SPAN_DISC_ERR of its terms (its rounding
// is ~5 ulp of them) and the roots to SPAN_ROOT_ERR of (|b tt| + sqrt) / a.
constexpr float SPAN_MARGIN = 0x1p-12f;
constexpr float SPAN_FLOOR = 0x1p-20f;
constexpr float SPAN_DISC_ERR = 0x1p-20f;
constexpr float SPAN_ROOT_ERR = 0x1p-21f;

}  // namespace

// Must match ops/texture._TexMap field for field.
struct TexMap {
  int n_levels;
  int wrap;
  float max_aniso;
  float su, sv, du, dv;  // the UV mapping: st = (su u + du, sv v + dv)
  float scale;
  float fd_scale;  // the path kernel's ray differentials: 1 / sqrt(spp)
  int h[TEX_LEVELS], w[TEX_LEVELS], off[TEX_LEVELS];
};

namespace {

__device__ __forceinline__ void st_norm(int wrap, float s, float t, float& sn, float& tn) {
  if (wrap == WRAP_REPEAT) {
    sn = s - floorf(s);
    tn = t - floorf(t);
  } else if (wrap == WRAP_CLAMP) {
    sn = fminf(fmaxf(s, 0.0f), ST_CLAMP_TOP);
    tn = fminf(fmaxf(t, 0.0f), ST_CLAMP_TOP);
  } else {
    sn = fminf(fmaxf(s, -1.5f), 2.5f);
    tn = fminf(fmaxf(t, -1.5f), 2.5f);
  }
}

// texel (si, ti) of level l, wrapped (the sizes are powers of two), clamped,
// or black outside
__device__ __forceinline__ void tex_texel(const float* data, const TexMap& tm, int l, int si,
                                          int ti, float v[3]) {
  const int h = tm.h[l], w = tm.w[l];
  if (tm.wrap == WRAP_REPEAT) {
    si &= w - 1;
    ti &= h - 1;
  } else if (tm.wrap == WRAP_CLAMP) {
    si = min(max(si, 0), w - 1);
    ti = min(max(ti, 0), h - 1);
  } else if (si < 0 || si >= w || ti < 0 || ti >= h) {
    v[0] = v[1] = v[2] = 0.0f;
    return;
  }
  const float* p = data + tm.off[l] + (size_t)(ti * w + si) * 3;
  v[0] = __ldg(p);
  v[1] = __ldg(p + 1);
  v[2] = __ldg(p + 2);
}

// the bilinear tap of level l at continuous st (_bilerp_level)
__device__ void tex_bilerp(const float* data, const TexMap& tm, int l, float s_in, float t_in,
                           float out[3]) {
  float sn, tn;
  st_norm(tm.wrap, s_in, t_in, sn, tn);
  const float s = sn * (float)tm.w[l] - 0.5f;
  const float t = tn * (float)tm.h[l] - 0.5f;
  const float fs = floorf(s), ft = floorf(t);
  const int s0 = (int)fs, t0 = (int)ft;
  const float ds = s - fs, dt = t - ft;
  float v00[3], v10[3], v01[3], v11[3];
  tex_texel(data, tm, l, s0, t0, v00);
  tex_texel(data, tm, l, s0 + 1, t0, v10);
  tex_texel(data, tm, l, s0, t0 + 1, v01);
  tex_texel(data, tm, l, s0 + 1, t0 + 1, v11);
  for (int c = 0; c < 3; ++c)
    out[c] = (1.0f - ds) * (1.0f - dt) * v00[c] + ds * (1.0f - dt) * v10[c] +
             (1.0f - ds) * dt * v01[c] + ds * dt * v11[c];
}

// The columns [j0, j1] of the window row at tt that can hold r^2 < 1, false
// for a row that holds none.  r^2 - r2_top = a ss^2 + (b tt) ss + (c tt^2 -
// r2_top) is a quadratic in ss that opens upward (a > 0): off the real roots
// (of these float coefficients) r^2 >= r2_top exactly, so r^2 as the scan
// rounds it is >= 1.  The discriminant is widened by its rounding bound (a
// row is dropped only where it is negative past it), the roots by theirs and
// by one texel on each side; col0 is column 0's ss.  A non-finite step gives
// the whole row: the span is never narrower than the texels that weigh.
__device__ __forceinline__ bool ewa_row_span(float a, float b, float c, float inv_a,
                                             float r2_top, float tt, float col0, int& j0,
                                             int& j1) {
  const float bt = b * tt;
  const float ct2 = c * (tt * tt);
  const float four_a = 4.0f * a;
  const float disc = bt * bt - four_a * (ct2 - r2_top);
  const float err = SPAN_DISC_ERR * (bt * bt + four_a * (fabsf(ct2) + r2_top));
  if (disc < -err) return false;
  const float sq = sqrtf(fmaxf(disc, 0.0f) + err);
  const float slack = SPAN_ROOT_ERR * (fabsf(bt) + sq) * inv_a + 1.0f;
  const float lo = (-bt - sq) * (0.5f * inv_a) - slack - col0;
  const float hi = (-bt + sq) * (0.5f * inv_a) + slack - col0;
  // fmaxf / fminf take the bound for a NaN: the whole row
  j0 = max((int)ceilf(fminf(fmaxf(lo, -1.0f), (float)EWA_WINDOW)), 0);
  j1 = min((int)floorf(fmaxf(fminf(hi, (float)EWA_WINDOW), -1.0f)), EWA_WINDOW - 1);
  return true;
}

// the elliptical Gaussian tap of level l (_ewa_level); the axes in uv units.
// Called out of line: one copy of the tap with registers of its own (inlined
// into the path kernel's textured BVH instance, under its 56-register bound,
// it cost #2 T 6.6%; PERF.md §6)
__device__ __noinline__ void tex_ewa_level(const float* data, const TexMap& tm, int l,
                                           float s_in, float t_in, float d0s_in, float d0t_in,
                                           float d1s_in, float d1t_in, float out[3]) {
  const float w = (float)tm.w[l], h = (float)tm.h[l];
  float sn, tn;
  st_norm(tm.wrap, s_in, t_in, sn, tn);
  const float s = sn * w - 0.5f;
  const float t = tn * h - 0.5f;
  const float d0s = d0s_in * w, d0t = d0t_in * h, d1s = d1s_in * w, d1t = d1t_in * h;
  float a = d0t * d0t + d1t * d1t + 1.0f;
  float b = -2.0f * (d0s * d0t + d1s * d1t);
  float c = d0s * d0s + d1s * d1s + 1.0f;
  // clamped as torch.clamp does: an overflowed scale (inf - inf) stays NaN,
  // so no texel weighs and the tap gives 0, as the plain version does
  const float f = a * c - b * b * 0.25f;
  const float inv_f = 1.0f / (f < 1e-12f ? 1e-12f : f);
  a = a * inv_f;
  b = b * inv_f;
  c = c * inv_f;
  const float det = fmaxf(-b * b + 4.0f * a * c, 1e-12f);
  const float inv_det = 1.0f / det;
  const float half = (float)(EWA_WINDOW / 2 - 1);
  const float u_rad = fminf(sqrtf(fmaxf(c * inv_det * 4.0f, 0.0f)), half);
  const float v_rad = fminf(sqrtf(fmaxf(a * inv_det * 4.0f, 0.0f)), half);
  const int s0 = (int)ceilf(s - u_rad);
  const int t0 = (int)ceilf(t - v_rad);
  // the spans need finite coefficients with a > 0 (each row's quadratic in
  // ss opens upward) and a finite st; otherwise every row is scanned whole
  const float r2_top = 1.0f + (SPAN_MARGIN * (fabsf(a) + fabsf(b) + fabsf(c)) + SPAN_FLOOR);
  const bool spans = a > 0.0f && isfinite(r2_top) && isfinite(s) && isfinite(t);
  const float inv_a = 1.0f / a;
  const float col0 = (float)s0 - s;
  float acc[3] = {0.0f, 0.0f, 0.0f}, wsum = 0.0f;
  for (int i = 0; i < EWA_WINDOW; ++i) {
    const float tt = (float)(t0 + i) - t;
    int j0 = 0, j1 = EWA_WINDOW - 1;
    if (spans && !ewa_row_span(a, b, c, inv_a, r2_top, tt, col0, j0, j1)) continue;
    for (int j = j0; j <= j1; ++j) {
      const float ss = (float)(s0 + j) - s;
      const float r2 = a * (ss * ss) + b * tt * ss + c * (tt * tt);
      if (!(r2 < 1.0f)) continue;
      const float wgt = fmaxf(expf(-2.0f * r2) - EXP_M2, 0.0f);
      if (wgt > 0.0f) {
        float v[3];
        tex_texel(data, tm, l, s0 + j, t0 + i, v);
        for (int k = 0; k < 3; ++k) acc[k] = acc[k] + wgt * v[k];
      }
      wsum = wsum + wgt;
    }
  }
  const float den = fmaxf(wsum, 1e-9f);
  for (int k = 0; k < 3; ++k) out[k] = acc[k] / den;
}

// The EWA lookup at st with the footprint axes dst0, dst1 (ewa_lookup).
__device__ void tex_ewa_lookup(const float* data, const TexMap& tm, float s, float t,
                               float d0s, float d0t, float d1s, float d1t, float out[3]) {
  const bool swap = d0s * d0s + d0t * d0t < d1s * d1s + d1t * d1t;
  const float mas = swap ? d1s : d0s, mat = swap ? d1t : d0t;
  float mis = swap ? d0s : d1s, mit = swap ? d0t : d1t;
  const float major_len = sqrtf(fmaxf(mas * mas + mat * mat, 1e-20f));
  float minor_len = sqrtf(fmaxf(mis * mis + mit * mit, 0.0f));
  const float scale = (minor_len * tm.max_aniso < major_len && minor_len > 0.0f)
                          ? major_len / fmaxf(minor_len * tm.max_aniso, 1e-20f)
                          : 1.0f;
  mis = mis * scale;
  mit = mit * scale;
  minor_len = minor_len * scale;
  if (minor_len <= 1e-9f) {  // degenerate: level 0's bilinear tap
    tex_bilerp(data, tm, 0, s, t, out);
    return;
  }
  const float top = (float)(tm.n_levels - 1);
  const float lod = fminf(fmaxf(top + log2f(fmaxf(minor_len, 1e-9f)), 0.0f), top);
  const float fl = floorf(lod);
  const int l0 = (int)fl;
  const int l1 = min(l0 + 1, tm.n_levels - 1);
  const float dt = lod - fl;
  float e0[3], e1[3];
  tex_ewa_level(data, tm, l0, s, t, mas, mat, mis, mit, e0);
  tex_ewa_level(data, tm, l1, s, t, mas, mat, mis, mit, e1);
  for (int k = 0; k < 3; ++k) out[k] = (1.0f - dt) * e0[k] + dt * e1[k];
}

}  // namespace
