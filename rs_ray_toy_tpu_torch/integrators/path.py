"""Wavefront unidirectional path tracer (rs_ray_toy_tpu/integrators/path.py,
integrator/path.rs).

The bounce loop of path.rs:51-226 as a masked loop over (N,) rays: every
ray advances one bounce per step under an active mask, max_depth steps
and, with `infinite_lights`, one more.  Per step: the shaded closest hit
(dead lanes carry t_max = 0, so the kernels retire them at once); an
escaped ray collects the radiance of the `infinite_lights` environments
at the first step or after a specular bounce (path.rs:79-88), and the
extra step does nothing else; NEE with one
uniformly picked light unless the BSDF is purely specular (path.rs:
108-122), with MIS for area and environment lights; one BSDF sample for
the next direction (reflection.rs:302-381), the etaScale factor of
specular transmissions, and Russian roulette on beta * etaScale after
bounce 3 (path.rs:212-222).  A bounce whose sample transmits into a
material with a BSSRDF (a Disney material's scatter_distance) takes the
subsurface branch of path.rs:166-210 before the roulette: the probe
(bsdf/bssrdf.sample_bssrdf) picks an exit point and weights beta by Sp /
pdf, one uniformly picked light is sampled at the exit with the Sw
adapter and a shadow ray, and the path leaves the exit in a
cosine-sampled direction with beta times Sw pi.  Surface emission is
identically zero in the reference (its aggregate never links area lights
to primitives).

This is the JAX package's `li_path`, the jnp twin of the path kernel K1;
the render takes it where K1 does not: partial spheres, more than 8
spheres or lights, distant and triangle lights, more than one
environment light, an environment light beside a specular lobe, meshes
past K1's 65,536 triangles, max_depth 0 and above K1's 15, and the
materials K1 does not take: matte with sigma > 0 (Oren-Nayar), rough
glass, TranslucentMaterial, MixMaterial, thin or transmissive
DisneyMaterial, and a subsurface DisneyMaterial among other materials or
beside lights, spheres or smooth meshes K1's subsurface branch does not
take.  It evaluates no texture: a textured scene raises here rather than
render untextured (image-map environments are outside the port's loader).
"""

from typing import Optional

import torch

from ..accel.geometry import offset_ray_origin
from ..bsdf import bssrdf as bss
from ..bsdf import eval as beval
from ..config import DTYPE, PI
from ..core.sampling import cosine_sample_hemisphere
from ..core.vec import coordinate_system, dot
from ..lights.lights import has_escape, le_escape, sample_li
from ..ops.path_megakernel import WAVEFRONT_KINDS, scene_unsupported
from ..sampler.dims import (
    PATH_BSDF,
    PATH_BSS_LIGHT,
    PATH_BSS_OUT,
    PATH_BSS_PICK,
    PATH_BSS_PROBE_1D,
    PATH_BSS_PROBE_2D,
    PATH_RR,
    path_dim0,
)
from .common import shadow_unoccluded, uniform_sample_one_light


def unsupported_feature(scene, spec, sampler) -> Optional[str]:
    """The first feature of the job outside the wavefront Path loop, or
    None: every lobe the loader emits under Path (the path kernel's, and
    Oren-Nayar, lambert and microfacet transmission, Disney's fake
    subsurface, scaled lobes, up to MAX_LOBES a material, fresnel specular
    among others, specular transmission into a subsurface material), the
    stratified or Halton sampler, any number of spheres and lights of
    every loaded kind, any number of triangles, flat or with smooth vertex
    normals, any max_depth >= 0 (the JAX package's li_path has no cap)."""
    if spec.kind != "path":
        return f"{spec.kind} integrator"
    if spec.max_depth < 0:
        return f"max_depth {spec.max_depth}"
    return scene_unsupported(scene, sampler, WAVEFRONT_KINDS, wavefront=True, allow_smooth=True)


def li_path(ctx, o, d, cam_weight, sampler, pixel_id, s_idx, spec):
    """Radiance (N, 3) of camera rays o, d (N, 3) with weights cam_weight."""
    n = o.shape[0]
    L = torch.zeros((n, 3), dtype=DTYPE, device=o.device)
    active = cam_weight > 0.0
    beta = torch.ones((n, 3), dtype=DTYPE, device=o.device) * active[:, None]
    eta_scale = torch.ones(n, dtype=DTYPE, device=o.device)
    specular_bounce = torch.zeros(n, dtype=torch.bool, device=o.device)
    escape = has_escape(ctx.lights)
    ro, rd = o, d
    nonspec = beval.BXDF_ALL & ~beval.BXDF_SPECULAR
    # the last step only collects the escape radiance: without
    # infinite_lights it adds nothing and is not traced
    for bounces in range(spec.max_depth + (1 if escape else 0)):
        dim0 = path_dim0(bounces)
        t_max = torch.where(active, torch.inf, 0.0).to(DTYPE)
        hit, si = ctx.intersect_shaded(ro, rd, t_max)
        found = hit.valid & active
        # escaped rays: the environments at bounce 0 or after a specular
        # bounce (path.rs:79-88); surface emission is zero
        if escape:
            collect = active & ~found
            if bounces > 0:
                collect = collect & specular_bounce
            L = L + torch.where(collect[:, None], beta * le_escape(ctx.lights, n, o.device), 0.0)
        active = found & (bounces < spec.max_depth)
        if bounces == spec.max_depth:
            break
        si = si._replace(valid=si.valid & active)
        params = ctx.shade_params(si)
        frame = ctx.frame(si)

        # NEE unless the BSDF is purely specular (path.rs:108-122)
        n_nonspec = beval.num_components(params, nonspec)
        si_nee = si._replace(valid=si.valid & (n_nonspec > 0))
        ld, _ = uniform_sample_one_light(ctx, si_nee, params, frame, sampler, pixel_id, s_idx, dim0)
        L = L + beta * ld

        # the BSDF sample for the next direction (path.rs:125-148)
        u_bsdf = sampler.get_2d(pixel_id, s_idx, dim0 + PATH_BSDF)
        bs = beval.bsdf_sample(params, frame, si.wo, u_bsdf)
        ok = active & bs.valid & torch.any(bs.f != 0.0, -1) & (bs.pdf > 0.0)
        cos_pdf = torch.abs(dot(bs.wi_world, frame.ns)) / torch.clamp(bs.pdf, min=1e-20)
        beta = torch.where(ok[:, None], beta * bs.f * cos_pdf[:, None], beta)
        active = active & ok
        specular_bounce = bs.specular

        # etaScale (path.rs:150-163)
        eta = params[:, 31]
        entering = dot(si.wo, si.ng) > 0.0
        eta_fac = torch.where(entering, eta * eta, 1.0 / torch.clamp(eta * eta, min=1e-20))
        eta_scale = torch.where(active & bs.transmitted, eta_scale * eta_fac, eta_scale)

        ro = torch.where(active[:, None], offset_ray_origin(si.p, si.ng, bs.wi_world), ro)
        rd = torch.where(active[:, None], bs.wi_world, rd)

        # the subsurface branch (path.rs:166-210) on the lanes that
        # transmitted into a material with a BSSRDF
        if ctx.bssrdf is not None:
            is_trans = bs.transmission & active & ctx.bssrdf["has"][si.mat.clamp(min=0)]
            idx = torch.nonzero(is_trans).squeeze(1)
            if idx.numel():
                sid = s_idx[idx] if torch.is_tensor(s_idx) and s_idx.dim() else s_idx
                got, ld, beta_b, ro_b, rd_b = subsurface(
                    ctx, si._replace(**{k: v[idx] for k, v in si._asdict().items()}),
                    beval.Frame(*(v[idx] for v in frame)), sampler, pixel_id[idx], sid, dim0,
                    beta[idx])
                L = L.index_add(0, idx, ld)
                beta = beta.index_put((idx,), beta_b)
                active = active.index_put((idx,), got)
                ro = ro.index_put((idx,), torch.where(got[:, None], ro_b, ro[idx]))
                rd = rd.index_put((idx,), torch.where(got[:, None], rd_b, rd[idx]))
                specular_bounce = specular_bounce.index_put((idx,), specular_bounce[idx] & ~got)

        # Russian roulette (path.rs:212-222)
        rr_beta_max = torch.amax(beta * eta_scale[:, None], -1)
        do_rr = active & (rr_beta_max < spec.rr_threshold) & (bounces > 3)
        q = torch.clamp(1.0 - rr_beta_max, min=0.05)
        u_rr = sampler.get_1d(pixel_id, s_idx, dim0 + PATH_RR)
        killed = do_rr & (u_rr < q)
        active = active & ~killed
        beta = torch.where((do_rr & ~killed)[:, None],
                           beta / torch.clamp(1.0 - q, min=1e-9)[:, None], beta)
    return L


def subsurface(ctx, si, frame, sampler, pixel_id, s_idx, dim0, beta):
    """The subsurface branch of the JAX li_path (integrators/path.py:
    132-198) on lanes that transmitted into a BSSRDF material: the probe,
    the Sw adapter's one-light NEE at the exit, and the cosine-sampled exit
    direction.  Returns (got: the probe found an exit, the radiance the
    NEE adds, the new beta, and the next ray's origin and direction, valid
    where got)."""
    u1 = sampler.get_1d(pixel_id, s_idx, dim0 + PATH_BSS_PROBE_1D)
    u2 = sampler.get_2d(pixel_id, s_idx, dim0 + PATH_BSS_PROBE_2D)
    bsample = bss.sample_bssrdf(ctx, si, frame, u1, u2)
    got = si.valid & bsample.valid
    beta = torch.where(got[:, None],
                       beta * bsample.sp / torch.clamp(bsample.pdf, min=1e-20)[:, None], beta)
    eta_b = ctx.bssrdf["eta"][si.mat.clamp(min=0)]
    pi = bsample.pi
    ld = torch.zeros_like(beta)
    if ctx.n_lights:
        # the exit's direct light: one uniformly picked light, the Sw adapter
        u_pick = sampler.get_1d(pixel_id, s_idx, dim0 + PATH_BSS_PICK)
        lidx = torch.clamp((u_pick * ctx.n_lights).to(torch.int64), max=ctx.n_lights - 1)
        u_l = sampler.get_2d(pixel_id, s_idx, dim0 + PATH_BSS_LIGHT)
        wi, li, pdf, p_light, _ = sample_li(ctx.lights, lidx, pi.p[:, 0], pi.p[:, 1], pi.p[:, 2],
                                            u_l[:, 0], u_l[:, 1])
        cos_wi = dot(torch.stack(wi, -1), pi.ns)
        f_sw = bss.sw_f(eta_b, cos_wi) * torch.abs(cos_wi)
        unocc = shadow_unoccluded(ctx, pi, torch.stack(p_light, -1))
        nee_ok = got & unocc & (pdf > 0.0)
        inv_pdf = float(ctx.n_lights) / torch.clamp(pdf, min=1e-20)
        ld = torch.where(nee_ok[:, None],
                         beta * torch.stack(li, -1) * f_sw[:, None] * inv_pdf[:, None], 0.0)
    # the next direction: the Sw adapter cosine-sampled at the exit
    w_loc = cosine_sample_hemisphere(sampler.get_2d(pixel_id, s_idx, dim0 + PATH_BSS_OUT))
    a1, a2 = coordinate_system(pi.ns)
    w_out = a1 * w_loc[:, 0:1] + a2 * w_loc[:, 1:2] + pi.ns * w_loc[:, 2:3]
    cos_o = torch.clamp(w_loc[:, 2], min=1e-9)
    # f cos / pdf with pdf = cos / pi: Sw pi
    beta = torch.where(got[:, None], beta * (bss.sw_f(eta_b, cos_o) * PI)[:, None], beta)
    return got, ld, beta, offset_ray_origin(pi.p, pi.ng, w_out), w_out
