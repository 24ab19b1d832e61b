"""Shared integrator machinery (rs_ray_toy_tpu/integrators/common.py).

`SceneCtx` holds a triangle scene's device tables and answers the
wavefront loop's queries whatever the accelerator, as the JAX package's
does (:86-165): up to BRUTE_FORCE_CUTOFF primitives every query is the
brute-force kernel K4 (ops/intersect_kernel; occlusion is its hit flag),
above it a BVH with leaves of 16 triangles and kernel K3
(ops/bvh_kernel): closest and any hit, and the shaded closest hit that
returns the winner's surface attributes.  On CPU tensors the kernels'
plain versions answer.

`estimate_direct` and `uniform_sample_one_light` are integrator/mod.rs:
359-558 in batched form for the ported lights (point lights: delta, so
only the light-sampling branch contributes, and the BSDF-sampling branch,
which can only reach infinite lights, is never taken).  `scrub_radiance`
is the film's radiance scrub.
"""

import numpy as np
import torch

from ..accel import geometry as geom
from ..bsdf import eval as beval
from ..config import DTYPE, SHADOW_EPSILON
from ..core.spectrum import luminance
from ..core.vec import dot
from ..lights import lights as lmod
from ..ops import bvh_kernel as bk
from ..ops import intersect_kernel as ik
from ..ops.path_megakernel import LOBES_MAX, _resolve_mat_arrays, fill_lobe_columns
from ..scene.types import LIGHT_POINT

BRUTE_FORCE_CUTOFF = 256  # accel/bvh.py: brute force up to here


def material_rows(materials, device):
    """(M, 16 + 16 * slots) float32: each material's lobe count, lobes and
    Bsdf eta in pack_scene's column layout (bsdf/eval), slots the most
    lobes any material has (at least one)."""
    n_mats = materials["n_lobes"].shape[0]
    r = _resolve_mat_arrays(materials, np.arange(n_mats))
    slots = int(min(LOBES_MAX, max(1, r["n_lobes"].max(initial=1))))
    rows = np.zeros((n_mats, 16 + 16 * slots), np.float32)
    fill_lobe_columns(rows, r, slots)
    return torch.as_tensor(rows, device=device)


class SceneCtx:
    """Device tables of a triangle scene and the wavefront loop's queries.

    tri_packed (T, 12) [p0, e1, e2, pad] (K4's table), shade: the scene-order
    shade rows (accel/geometry.pack_shade_tables), mat_rows: material_rows,
    lights: a point-light LightTable, bvh: K3's tables (ops/bvh_kernel) or
    None for brute force.  `from_scene` builds them from a loaded scene."""

    def __init__(self, tri_packed, shade, mat_rows, lights, bvh=None):
        self.tri_packed = tri_packed
        self.shade = shade
        self.mat_rows = mat_rows
        self.lights = lights
        self.n_lights = int(lights.kind.shape[0])
        self.bvh = bvh

    @classmethod
    def from_scene(cls, scene, device):
        """The tables of a loaded scene: a BVH above BRUTE_FORCE_CUTOFF
        primitives."""
        tri = scene.triangles
        lk = np.asarray(scene.lights.kind)
        if np.any(lk != LIGHT_POINT):
            raise NotImplementedError("lights other than point lights in the wavefront loop")
        return cls(
            tri_packed=torch.as_tensor(ik.pack_triangles(tri.p0, tri.p1, tri.p2), device=device),
            shade=geom.pack_shade_tables(tri, device),
            mat_rows=material_rows(scene.materials, device),
            lights=lmod.point_lights(scene.lights.p, scene.lights.emit, device),
            bvh=bk.pack_bvh(tri, device) if tri.count > BRUTE_FORCE_CUTOFF else None,
        )

    def intersect(self, o, d, t_max):
        if self.bvh is not None:
            return geom.tri_hit(*bk.intersect_bvh(self.bvh, o, d, t_max))
        return geom.tri_hit(*ik.intersect_triangles(self.tri_packed, o, d, t_max))

    def surface(self, hit, o, d):
        return geom.surface_interaction(self.shade, hit, o, d)

    def intersect_shaded(self, o, d, t_max):
        """Closest hit and its surface interaction: the shaded kernel over
        a BVH, else the hit and the gathered shade rows."""
        if self.bvh is None:
            hit = self.intersect(o, d, t_max)
            return hit, self.surface(hit, o, d)
        t, idx, valid, at = bk.intersect_bvh_shaded(self.bvh, o, d, t_max)
        hit = geom.tri_hit(t, idx, valid)
        t_safe = torch.where(valid, t, 0.0)
        si = geom.SurfaceHit(
            p=o + d * t_safe[:, None], ng=at["ng"], ns=at["ns"], uv=at["uv"], dpdu=at["dpdu"],
            dpdv=at["dpdv"], wo=-d, mat=at["mat"], area_light=at["area_light"], valid=valid,
        )
        return hit, si

    def occluded(self, o, d, t_max):
        if self.bvh is not None:
            return bk.occluded_bvh(self.bvh, o, d, t_max)
        return self.intersect(o, d, t_max).valid

    def shade_params(self, si):
        """Each hit's lobe row (material_rows); no lobes where there is no
        hit (untextured: the port has no textures)."""
        rows = self.mat_rows[si.mat.clamp(min=0)]
        return torch.where((si.mat >= 0)[:, None], rows, 0.0)

    def frame(self, si):
        return beval.make_frame(si.ns, si.ng, si.dpdu)


def shadow_unoccluded(ctx, si, p_light):
    """VisibilityTester::unoccluded (lights/mod.rs:63-65): one any-hit ray
    from the offset point to the light, t_max = 1 - SHADOW_EPSILON in
    units of the unnormalised direction; dead lanes get t_max = 0."""
    origin = geom.offset_ray_origin(si.p, si.ng, p_light - si.p)
    t_max = torch.where(si.valid, 1.0 - SHADOW_EPSILON, 0.0).to(DTYPE)
    return ~ctx.occluded(origin, p_light - origin, t_max)


def estimate_direct(ctx, si, params, frame, light_idx, u_light):
    """One light's direct contribution at each shading point, (N, 3)
    (integrator/mod.rs:403-558, no media, bsdf flags ALL & ~SPECULAR).
    Point lights are delta lights: the light sample takes weight 1 and the
    BSDF-sampling branch is skipped (it can only reach infinite lights,
    which the loop does not take)."""
    flags = beval.BXDF_ALL & ~beval.BXDF_SPECULAR
    p = si.p
    wi, li, pdf, p_light, _ = lmod.sample_li(ctx.lights, light_idx, p[:, 0], p[:, 1], p[:, 2],
                                             u_light[:, 0], u_light[:, 1])
    wi = torch.stack(wi, -1)
    li = torch.stack(li, -1)
    f, _ = beval.bsdf_f_pdf(params, frame, si.wo, wi, flags)
    f = f * torch.abs(dot(wi, frame.ns))[:, None]
    live = si.valid & (pdf > 0.0) & torch.any(li > 0.0, -1) & torch.any(f > 0.0, -1)
    unocc = shadow_unoccluded(ctx, si, torch.stack(p_light, -1))
    li = torch.where((live & unocc)[:, None], li, 0.0)
    ld = li * f * (1.0 / torch.clamp(pdf, min=1e-20))[:, None]
    return torch.where(si.valid[:, None], ld, 0.0)


def uniform_sample_one_light(ctx, si, params, frame, sampler, pixel_id, s_idx, dim_base):
    """(integrator/mod.rs:359-401): one light picked uniformly with the
    1D value at dim_base, its sample with the 2D value at dim_base + 1,
    the estimate divided by the pick pdf.  Returns (ld, next dimension)."""
    if ctx.n_lights == 0:
        return torch.zeros_like(si.p), dim_base
    u_pick = sampler.get_1d(pixel_id, s_idx, dim_base)
    idx = torch.clamp((u_pick * ctx.n_lights).to(torch.int64), max=ctx.n_lights - 1)
    pdf = torch.full_like(u_pick, 1.0 / ctx.n_lights)
    u_light = sampler.get_2d(pixel_id, s_idx, dim_base + 1)
    ld = estimate_direct(ctx, si, params, frame, idx, u_light)
    return ld / torch.clamp(pdf, min=1e-20)[:, None], dim_base + 3


def scrub_radiance(l):
    """Zero NaN, infinite or negative-luminance samples
    (integrator/mod.rs:105-122)."""
    y = luminance(l)
    bad = ~torch.isfinite(y) | (y < -1e-5) | ~torch.all(torch.isfinite(l), dim=-1)
    return torch.where(bad[..., None], 0.0, l)
