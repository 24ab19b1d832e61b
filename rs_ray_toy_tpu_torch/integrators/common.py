"""Shared integrator machinery (rs_ray_toy_tpu/integrators/common.py).

`SceneCtx` holds a scene's device tables and answers the wavefront
loop's queries whatever the accelerator, as the JAX package's does
(:86-165): up to BRUTE_FORCE_CUTOFF triangles every triangle query is
the brute-force kernel K4 (ops/intersect_kernel; occlusion is its hit
flag) over the chunked walk, whose chunk rows the context builds from its
table, above it a BVH with leaves of 16 triangles and kernel K3
(ops/bvh_kernel): closest and any hit, and the shaded closest hit that
returns the winner's surface attributes.  Spheres are intersected brute
force in plain torch and min-combined with the triangle winner
(`_combine_spheres` in the JAX package), in `intersect`,
`intersect_shaded` and `occluded` alike.  On CPU tensors the kernels'
plain versions answer.

`estimate_direct`, `uniform_sample_one_light` and
`uniform_sample_all_lights` are integrator/mod.rs:304-558 in batched form: the light-sampling branch with its power-
heuristic MIS weight (1 for delta lights), and for scenes with
environment lights the BSDF-sampling branch, whose escaped rays collect
the sampled environment (the reference's aggregate links no area light to
a primitive, so a BSDF ray never identifies an area light and that
branch adds nothing for one; integrator/mod.rs:540-547).
`scrub_radiance` is the film's radiance scrub.
"""

import numpy as np
import torch

from ..accel import geometry as geom
from ..bsdf import eval as beval
from ..config import DTYPE, SHADOW_EPSILON
from ..core.sampling import power_heuristic
from ..core.spectrum import luminance
from ..core.vec import div, dot
from ..lights import lights as lmod
from ..ops import bvh_kernel as bk
from ..ops import intersect_kernel as ik
from ..bsdf.lobes import MAX_LOBES
from ..ops.path_megakernel import _resolve_mat_arrays, fill_lobe_columns
from ..scene.types import LIGHT_INFINITE

BRUTE_FORCE_CUTOFF = 256  # accel/bvh.py: brute force up to here


def material_rows(materials, device):
    """(M, 16 + (16 + EXTRA_COLS) * slots) float32: each material's lobe
    count, lobes and Bsdf eta in pack_scene's column layout, then each
    lobe's scale and distribution code (bsdf/eval), slots the most lobes
    any material has (at least one, at most MAX_LOBES)."""
    n_mats = materials["n_lobes"].shape[0]
    r = _resolve_mat_arrays(materials, np.arange(n_mats))
    slots = int(min(MAX_LOBES, max(1, r["n_lobes"].max(initial=1))))
    rows = np.zeros((n_mats, 16 + (16 + beval.EXTRA_COLS) * slots), np.float32)
    fill_lobe_columns(rows, r, slots)
    extra = 16 + 16 * slots
    for l in range(min(slots, r["kinds"].shape[1])):
        c = extra + beval.EXTRA_COLS * l
        rows[:, c:c + 3] = r["scale"][:, l]
        rows[:, c + 3] = r["dist"][:, l]
    return torch.as_tensor(rows, device=device)


def bssrdf_tables(materials, device):
    """The materials' BSSRDF profiles as device tensors (has (M,) bool, R
    and d (M, 3), eta (M,)), or None when no material has one."""
    has = np.asarray(materials["has_bssrdf"], bool)
    if not has.any():
        return None
    t = lambda k: torch.as_tensor(np.asarray(materials[k], np.float32), device=device)
    return dict(has=torch.as_tensor(has, device=device), R=t("bssrdf_R"), d=t("bssrdf_d"),
                eta=t("bssrdf_eta"))


class SceneCtx:
    """Device tables of a scene and the wavefront loop's queries.

    tri_packed (T, 12) [p0, e1, e2, pad] (K4's table), shade: the
    scene-order shade rows with the sphere tables (accel/geometry
    .pack_shade_tables), mat_rows: material_rows, lights: a LightTable,
    bvh: K3's tables (ops/bvh_kernel; with the 31 smooth shade columns,
    which the shaded kernel's smooth instance reads, when any triangle has
    vertex normals) or None for brute force, bssrdf: bssrdf_tables or
    None.  `from_scene` builds them from a loaded scene."""

    def __init__(self, tri_packed, shade, mat_rows, lights, bvh=None, bssrdf=None):
        self.tri_packed = tri_packed
        self.bssrdf = bssrdf
        self.shade = shade
        self.sph = shade.get("sph")
        self.mat_rows = mat_rows
        self.lights = lights
        self.n_lights = int(lights.kind.shape[0])
        self.bvh = bvh
        self.n_tris = int(tri_packed.shape[0])
        # brute force: K4's chunk rows (None past its table limit: every row)
        self.chunks = ik.pack_chunks(tri_packed) if bvh is None else None
        # the lobe kinds of the material table (the JAX SceneCtx's
        # static_kinds), which prune the Debug / DirectLighting tree
        slots = beval.lobe_count(mat_rows)
        kinds = mat_rows[:, 16:16 + 16 * slots:16].cpu()
        self.static_kinds = frozenset(int(k) for k in torch.unique(kinds))

    @classmethod
    def from_scene(cls, scene, device):
        """The tables of a loaded scene: a BVH above BRUTE_FORCE_CUTOFF
        triangles."""
        tri = scene.triangles
        sph = geom.sphere_tables(scene.spheres, device)
        return cls(
            tri_packed=torch.as_tensor(ik.pack_triangles(tri.p0, tri.p1, tri.p2), device=device),
            shade=geom.pack_shade_tables(tri, device, sph),
            mat_rows=material_rows(scene.materials, device),
            lights=lmod.scene_lights(scene, device),
            bvh=bk.pack_bvh(tri, device) if tri.count > BRUTE_FORCE_CUTOFF else None,
            bssrdf=bssrdf_tables(scene.materials, device),
        )

    def _no_hit(self, o):
        n = o.shape[0]
        return geom.Hit(
            t=torch.full((n,), torch.inf, dtype=o.dtype, device=o.device),
            kind=torch.full((n,), geom.PRIM_NONE, dtype=torch.int64, device=o.device),
            index=torch.full((n,), -1, dtype=torch.int64, device=o.device),
            valid=torch.zeros(n, dtype=torch.bool, device=o.device),
        )

    def _tri_intersect(self, o, d, t_max):
        if self.n_tris == 0:
            return self._no_hit(o)
        if self.bvh is not None:
            return geom.tri_hit(*bk.intersect_bvh(self.bvh, o, d, t_max))
        return geom.tri_hit(*ik.intersect_triangles(self.tri_packed, o, d, t_max, self.chunks))

    def intersect(self, o, d, t_max):
        hit = self._tri_intersect(o, d, t_max)
        if self.sph is None:
            return hit
        return geom.combine_spheres(hit, self.sph, o, d, t_max)

    def surface(self, hit, o, d):
        return geom.surface_interaction(self.shade, hit, o, d)

    def intersect_shaded(self, o, d, t_max):
        """Closest hit and its surface interaction: the shaded kernel over
        a BVH (sphere winners shaded from the sphere tables), else the hit
        and the gathered shade rows."""
        if self.bvh is None:
            hit = self.intersect(o, d, t_max)
            return hit, self.surface(hit, o, d)
        t, idx, valid, at = bk.intersect_bvh_shaded(self.bvh, o, d, t_max)
        hit = geom.tri_hit(t, idx, valid)
        t_safe = torch.where(valid, t, 0.0)
        si = geom.SurfaceHit(
            p=o + d * t_safe[:, None], ng=at["ng"], ns=at["ns"], uv=at["uv"], dpdu=at["dpdu"],
            dpdv=at["dpdv"], wo=-d, mat=at["mat"], area_light=at["area_light"], valid=valid,
            dndu=at["dndu"], dndv=at["dndv"],
        )
        if self.sph is None:
            return hit, si
        hit2 = geom.combine_spheres(hit, self.sph, o, d, t_max)
        is_s = hit2.kind == geom.PRIM_SPHERE
        si_s = geom.surface_interaction(
            {"tri_f": self.shade["tri_f"][:0], "tri_i": self.shade["tri_i"][:0], "sph": self.sph},
            geom.Hit(hit2.t, torch.where(is_s, geom.PRIM_SPHERE, geom.PRIM_NONE), hit2.index, is_s),
            o, d,
        )
        sel = is_s[:, None]
        si = geom.SurfaceHit(
            p=torch.where(sel, si_s.p, si.p), ng=torch.where(sel, si_s.ng, si.ng),
            ns=torch.where(sel, si_s.ns, si.ns), uv=torch.where(sel, si_s.uv, si.uv),
            dpdu=torch.where(sel, si_s.dpdu, si.dpdu), dpdv=torch.where(sel, si_s.dpdv, si.dpdv),
            wo=si.wo, mat=torch.where(is_s, si_s.mat, si.mat),
            area_light=torch.where(is_s, si_s.area_light, si.area_light), valid=hit2.valid,
            dndu=torch.where(sel, si_s.dndu, si.dndu), dndv=torch.where(sel, si_s.dndv, si.dndv),
        )
        return hit2, si

    def occluded(self, o, d, t_max):
        if self.n_tris == 0:
            occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        elif self.bvh is not None:
            occ = bk.occluded_bvh(self.bvh, o, d, t_max)
        else:
            occ = self._tri_intersect(o, d, t_max).valid
        if self.sph is not None:
            occ = occ | geom.intersect_spheres(self.sph, o, d, t_max)[2]
        return occ

    def shade_params(self, si):
        """Each hit's lobe row (material_rows); no lobes where there is no
        hit (untextured: the loop's gate refuses textured materials, and
        AO reads none)."""
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


def estimate_direct(ctx, si, params, frame, light_idx, u_light, u_scatter):
    """One light's direct contribution at each shading point, (N, 3)
    (integrator/mod.rs:403-558, no media, bsdf flags ALL & ~SPECULAR):
    the light sample weighted by the power heuristic against the BSDF's
    pdf (1 for delta lights), and with environment lights the BSDF sample
    whose ray escapes toward the sampled environment, weighted against
    the light's pdf."""
    flags = beval.BXDF_ALL & ~beval.BXDF_SPECULAR
    p = si.p
    lt = ctx.lights
    wi, li, pdf, p_light, delta = lmod.sample_li(lt, light_idx, p[:, 0], p[:, 1], p[:, 2],
                                                 u_light[:, 0], u_light[:, 1])
    wi = torch.stack(wi, -1)
    li = torch.stack(li, -1)
    f, scattering_pdf = beval.bsdf_f_pdf(params, frame, si.wo, wi, flags)
    f = f * torch.abs(dot(wi, frame.ns))[:, None]
    live = si.valid & (pdf > 0.0) & torch.any(li > 0.0, -1) & torch.any(f > 0.0, -1)
    unocc = shadow_unoccluded(ctx, si, torch.stack(p_light, -1))
    li = torch.where((live & unocc)[:, None], li, 0.0)
    weight = torch.where(delta, 1.0, power_heuristic(pdf, scattering_pdf))
    ld = li * f * (weight / torch.clamp(pdf, min=1e-20))[:, None]

    if lt.envs and bool((lt.kind == LIGHT_INFINITE).any()):
        bs = beval.bsdf_sample(params, frame, si.wo, u_scatter, flags)
        f2 = bs.f * torch.abs(dot(bs.wi_world, frame.ns))[:, None]
        light_pdf2 = lmod.pdf_li(lt, light_idx, p[:, 0], p[:, 1], p[:, 2], *bs.wi_world.unbind(-1))
        w2 = torch.where(bs.specular, 1.0, power_heuristic(bs.pdf, light_pdf2))
        live2 = (si.valid & bs.valid & torch.any(f2 > 0.0, -1) & (bs.pdf > 0.0)
                 & (bs.specular | (light_pdf2 > 0.0)))
        origin = geom.offset_ray_origin(si.p, si.ng, bs.wi_world)
        hit2 = ctx.intersect(origin, bs.wi_world, torch.where(live2, torch.inf, 0.0).to(DTYPE))
        # a hit never identifies the sampled light (no emissive
        # primitives); an escaped ray sees the sampled environment
        li2 = torch.zeros_like(f2)
        kind = lt.kind[light_idx]
        for env_id, env in enumerate(lt.envs):
            sel = (kind == LIGHT_INFINITE) & (lt.shape_index[light_idx] == env_id) & ~hit2.valid
            li2 = torch.where(sel[:, None], env["rgb"], li2)
        ld = ld + torch.where(live2[:, None],
                              li2 * f2 * (w2 / torch.clamp(bs.pdf, min=1e-20))[:, None], 0.0)
    return torch.where(si.valid[:, None], ld, 0.0)


def uniform_sample_one_light(ctx, si, params, frame, sampler, pixel_id, s_idx, dim_base):
    """(integrator/mod.rs:359-401): one light picked uniformly with the
    1D value at dim_base, its sample with the 2D value at dim_base + 1,
    the BSDF sample of MIS with the 2D value at dim_base + 2, the
    estimate divided by the pick pdf.  Returns (ld, next dimension)."""
    if ctx.n_lights == 0:
        return torch.zeros_like(si.p), dim_base
    u_pick = sampler.get_1d(pixel_id, s_idx, dim_base)
    idx = torch.clamp((u_pick * ctx.n_lights).to(torch.int64), max=ctx.n_lights - 1)
    pdf = torch.full_like(u_pick, 1.0 / ctx.n_lights)
    u_light = sampler.get_2d(pixel_id, s_idx, dim_base + 1)
    u_scatter = sampler.get_2d(pixel_id, s_idx, dim_base + 2)
    ld = estimate_direct(ctx, si, params, frame, idx, u_light, u_scatter)
    return ld / torch.clamp(pdf, min=1e-20)[:, None], dim_base + 3


def uniform_sample_all_lights(ctx, si, params, frame, sampler, pixel_id, s_idx, dim_base):
    """(integrator/mod.rs:304-355): every light estimated with its
    round_up_pow2(n_samples) sample pairs, (u_light, u_scatter) on
    consecutive 2D dimensions from dim_base, and averaged over its count.
    dim_base may be a per-ray tensor.  Returns (ld, next dimension)."""
    total = torch.zeros_like(si.p)
    dim = dim_base
    for j in range(ctx.n_lights):
        ns = _round_up_pow2(ctx.lights.n_samples[j])
        idx = torch.full(pixel_id.shape, j, dtype=torch.int64, device=si.p.device)
        acc = torch.zeros_like(total)
        for _ in range(ns):
            u_light = sampler.get_2d(pixel_id, s_idx, dim)
            u_scatter = sampler.get_2d(pixel_id, s_idx, dim + 1)
            dim = dim + 2
            acc = acc + estimate_direct(ctx, si, params, frame, idx, u_light, u_scatter)
        total = total + div(acc, float(ns))
    return total, dim


def _round_up_pow2(n):
    """The sampler's round_count (misc.rs round_up_pow2): the least power
    of two at or above n, 1 for n <= 1."""
    p = 1
    while p < max(n, 1):
        p <<= 1
    return p


def scrub_radiance(l):
    """Zero NaN, infinite or negative-luminance samples
    (integrator/mod.rs:105-122)."""
    y = luminance(l)
    bad = ~torch.isfinite(y) | (y < -1e-5) | ~torch.all(torch.isfinite(l), dim=-1)
    return torch.where(bad[..., None], 0.0, l)
