"""Wavefront volumetric path tracer (rs_ray_toy_tpu/integrators/volpath.py,
integrator/volpath.rs).

The bounce loop of volpath.rs:48-258 as a masked loop over (N,) rays,
line for line against the JAX package's `li_volpath`: every step takes
the shaded closest hit (dead lanes carry t_max = 0), samples the ray's
current medium over the segment to it (over 2 * world_radius + 1000 for a
ray that hits nothing), and then branches per ray into a medium vertex
(the phase function's NEE and an HG sample of the next direction) or a
surface vertex (the BSDF's NEE and a BSDF sample), with the lights'
power distribution (SceneCtx.light_dist), the etaScale factor of
specular transmissions and Russian roulette on beta * etaScale after
bounce 3.  An escaped ray collects the `infinite_lights` environments off
a surface vertex at bounce 0 or after a specular bounce.

Each ray carries a medium id (-1: vacuum), the camera's at birth.  A ray
that leaves a surface with a medium_interface takes the interface's
inside medium when it crosses to the back of the geometric normal, else
its outside one (PBRT's intent; the reference's inverted
is_medium_transition never changes a ray's medium, docs/PARITY.md).
Homogeneous media sample and attenuate in closed form, grid media track
on each ray's hashed RNG chain (scene/medium.py), which medium_sample and
both medium_tr calls of a step advance on the same lanes, in the same
order, as the JAX loop.

`estimate_direct_volumetric` is estimate_direct with handle_media
(integrator/mod.rs:403-558): the light sample weighed by the phase
function at a medium vertex or the non-specular lobes at a surface, a
shadow ray offset from surfaces only, and the transmittance of the
current medium over the whole segment to the light; when some light is
neither a point nor a distant light, the scattering sample (the phase
function's or the BSDF's) whose ray escapes toward an environment, with
the medium's transmittance over its segment (1e8 units for a ray that
hits nothing).

This is the render's route for Volpath scenes the Volpath kernel K6
refuses (ops/volpath_megakernel.unsupported_feature): no camera medium,
several media, per-primitive interfaces, spheres, any light, grid media
under any light, the HaltonSampler, stratified grids of any size, smooth
normals and every lobe of the wavefront Path loop (a BSSRDF material's
lobes without its subsurface branch, as in the JAX loop).  Its triangle
queries are K4 and K3 (SceneCtx).  It evaluates no texture: a textured
scene raises (`unsupported_feature`).
"""

from typing import Optional

import torch

from ..accel.geometry import offset_ray_origin
from ..bsdf import eval as beval
from ..config import DTYPE
from ..core import rng
from ..core.sampling import power_heuristic, sample_discrete_1d
from ..core.vec import dot, norm3
from ..lights import lights as lmod
from ..ops.path_megakernel import WAVEFRONT_KINDS, scene_unsupported
from ..sampler.dims import VOL_LIGHT, VOL_NEXT, VOL_PICK, VOL_RR, VOL_SCATTER, volpath_dim0
from ..scene import medium as med
from ..scene.types import LIGHT_DISTANT, LIGHT_INFINITE, LIGHT_POINT

MISS_SEGMENT = 1e8  # the scattering sample's segment when its ray hits nothing


def unsupported_feature(scene, spec, sampler) -> Optional[str]:
    """The first feature of the job outside the wavefront Volpath loop, or
    None: the wavefront Path loop's scenes (any spheres, lights, triangles,
    smooth normals, lobes, either sampler, any stratified grid) in any
    media, any max_depth >= 0; no texture."""
    if spec.kind != "volpath":
        return f"{spec.kind} integrator"
    if spec.max_depth < 0:
        return f"max_depth {spec.max_depth}"
    return scene_unsupported(scene, sampler, WAVEFRONT_KINDS, wavefront=True, allow_smooth=True)


def scatter_sampled(lights):
    """Whether estimate_direct_volumetric takes the scattering sample: some
    light is neither a point nor a distant light."""
    return bool(((lights.kind != LIGHT_POINT) & (lights.kind != LIGHT_DISTANT)).any())


def estimate_direct_volumetric(ctx, p, is_medium, si, params, frame, wo, g_med, light_idx,
                               u_light, u_scatter, rng_state, valid, med_id, scatter):
    """One light's contribution (N, 3) at medium points or surface points
    p (the JAX package's _estimate_direct_volumetric), and the advanced
    RNG chain; `scatter`: scatter_sampled(ctx.lights)."""
    flags = beval.BXDF_ALL & ~beval.BXDF_SPECULAR
    lt = ctx.lights
    mediums = ctx.mediums
    px, py, pz = p.unbind(-1)
    wi, li, ls_pdf, p_light, delta = lmod.sample_li(lt, light_idx, px, py, pz, u_light[:, 0],
                                                    u_light[:, 1])
    wi, li, p_light = torch.stack(wi, -1), torch.stack(li, -1), torch.stack(p_light, -1)
    f_surf, pdf_surf = beval.bsdf_f_pdf(params, frame, wo, wi, flags)
    f_surf = f_surf * torch.abs(dot(wi, frame.ns))[:, None]
    p_phase = med.phase_hg(dot(wo, wi), g_med)
    f = torch.where(is_medium[:, None], p_phase[:, None], f_surf)
    scattering_pdf = torch.where(is_medium, p_phase, pdf_surf)
    live = valid & (ls_pdf > 0.0) & torch.any(li > 0.0, -1) & torch.any(f > 0.0, -1)

    # visibility with transmittance: the shadow ray leaves a surface offset
    origin = torch.where(is_medium[:, None], p, offset_ray_origin(p, si.ng, p_light - p))
    delta_vec = p_light - origin
    seg_len = norm3(delta_vec)
    d_unit = delta_vec / torch.clamp(seg_len, min=1e-20)[:, None]
    t_max = torch.where(live, 1.0 - 1e-4, 0.0).to(DTYPE) * seg_len
    occluded = ctx.occluded(origin, d_unit, t_max)
    tr = torch.ones_like(f)
    if mediums is not None:
        tr, rng_state = med.medium_tr(mediums, med_id, origin, d_unit, seg_len, rng_state)
    li = torch.where((live & ~occluded)[:, None], li * tr, 0.0)
    weight = torch.where(delta, 1.0, power_heuristic(ls_pdf, scattering_pdf))
    ld = li * f * (weight / torch.clamp(ls_pdf, min=1e-20))[:, None]
    ld = torch.where(valid[:, None], ld, 0.0)

    # the scattering sample (integrator/mod.rs:483-558): only an escaped
    # ray adds, toward the sampled environment (no emissive primitives)
    if scatter:
        wi_med, p_med = med.hg_sample(wo, g_med, u_scatter)
        bs = beval.bsdf_sample(params, frame, wo, u_scatter, flags)
        f2_surf = bs.f * torch.abs(dot(bs.wi_world, frame.ns))[:, None]
        wi2 = torch.where(is_medium[:, None], wi_med, bs.wi_world)
        f2 = torch.where(is_medium[:, None], p_med[:, None], f2_surf)
        spdf2 = torch.where(is_medium, p_med, bs.pdf)
        sampled_spec = ~is_medium & bs.specular
        light_pdf2 = lmod.pdf_li(lt, light_idx, px, py, pz, *wi2.unbind(-1))
        w2 = torch.where(sampled_spec, 1.0, power_heuristic(spdf2, light_pdf2))
        live2 = (valid & ~delta & (is_medium | bs.valid) & torch.any(f2 > 0.0, -1)
                 & (spdf2 > 0.0) & (sampled_spec | (light_pdf2 > 0.0)))
        origin2 = torch.where(is_medium[:, None], p, offset_ray_origin(p, si.ng, wi2))
        hit2 = ctx.intersect(origin2, wi2, torch.where(live2, torch.inf, 0.0).to(DTYPE))
        tr2 = torch.ones_like(f2)
        if mediums is not None:
            # a finite stand-in for the reference's infinite escape segment:
            # homogeneous tr over it is 0, grid tr bounded by the box
            seg2 = torch.where(hit2.valid, hit2.t, MISS_SEGMENT)
            tr2, rng_state = med.medium_tr(mediums, med_id, origin2, wi2, seg2, rng_state)
        li2 = torch.zeros_like(f2)
        kind = lt.kind[light_idx]
        for env_id, env in enumerate(lt.envs):
            sel = (kind == LIGHT_INFINITE) & (lt.shape_index[light_idx] == env_id) & ~hit2.valid
            li2 = torch.where(sel[:, None], env["rgb"], li2)
        ld = ld + torch.where(live2[:, None],
                              li2 * f2 * tr2 * (w2 / torch.clamp(spdf2, min=1e-20))[:, None], 0.0)
    return ld, rng_state


def li_volpath(ctx, o, d, cam_weight, sampler, pixel_id, s_idx, spec):
    """Radiance (N, 3) of camera rays o, d (N, 3) with weights cam_weight,
    every ray born in the context's camera medium."""
    n = o.shape[0]
    dev = o.device
    mediums = ctx.mediums
    L = torch.zeros((n, 3), dtype=DTYPE, device=dev)
    active = cam_weight > 0.0
    beta = torch.ones((n, 3), dtype=DTYPE, device=dev) * active[:, None]
    specular_bounce = torch.zeros(n, dtype=torch.bool, device=dev)
    eta_scale = torch.ones(n, dtype=DTYPE, device=dev)
    ro, rd = o, d
    med_id = torch.full((n,), ctx.camera_medium, dtype=torch.int64, device=dev)
    rng_state = rng.hash_combine(pixel_id, s_idx)  # the medium draws' chains
    escape = lmod.has_escape(ctx.lights)
    scatter = ctx.n_lights > 0 and scatter_sampled(ctx.lights)
    seg_escape = 2.0 * float(ctx.lights.world_radius) + 1000.0
    nonspec = beval.BXDF_ALL & ~beval.BXDF_SPECULAR

    for bounces in range(spec.max_depth + 1):
        dim0 = volpath_dim0(bounces)
        t_max = torch.where(active, torch.inf, 0.0).to(DTYPE)
        hit, si = ctx.intersect_shaded(ro, rd, t_max)
        found = hit.valid & active

        # the medium over the segment (volpath.rs:70-85)
        seg_len = torch.where(found, hit.t, seg_escape)
        if mediums is not None:
            beta_med, in_medium, t_med, rng_state = med.medium_sample(
                mediums, torch.where(active, med_id, -1), ro, rd, seg_len, rng_state)
            beta = beta * torch.where(active[:, None], beta_med, 1.0)
        else:
            in_medium = torch.zeros(n, dtype=torch.bool, device=dev)
            t_med = seg_len
        p_vertex = torch.where(in_medium[:, None], ro + rd * t_med[:, None], si.p)
        active = active & torch.any(beta > 0.0, -1)

        # escaped rays: the environments, off a surface vertex (volpath.rs:88-99)
        if escape:
            collect = active & ~found & ~in_medium
            if bounces > 0:
                collect = collect & specular_bounce
            L = L + torch.where(collect[:, None], beta * lmod.le_escape(ctx.lights, n, dev), 0.0)

        active = active & (found | in_medium) & (bounces < spec.max_depth)
        if bounces == spec.max_depth:
            break
        surf_valid = active & ~in_medium & found
        si = si._replace(valid=surf_valid)
        params = ctx.shade_params(si)
        frame = ctx.frame(si)
        wo = -rd
        g_med = (mediums["g"][med_id.clamp(min=0)] if mediums is not None
                 else torch.zeros(n, dtype=DTYPE, device=dev))

        # NEE, one light picked by power (volpath.rs:101-127)
        if ctx.n_lights:
            u_pick = sampler.get_1d(pixel_id, s_idx, dim0 + VOL_PICK)
            light_idx, pick_pdf = sample_discrete_1d(ctx.light_dist, u_pick)
            u_light = sampler.get_2d(pixel_id, s_idx, dim0 + VOL_LIGHT)
            u_scatter = sampler.get_2d(pixel_id, s_idx, dim0 + VOL_SCATTER)
            n_nonspec = beval.num_components(params, nonspec)
            nee_valid = active & (in_medium | (surf_valid & (n_nonspec > 0)))
            ld, rng_state = estimate_direct_volumetric(
                ctx, p_vertex, in_medium, si, params, frame, wo, g_med, light_idx, u_light,
                u_scatter, rng_state, nee_valid, med_id, scatter)
            L = L + beta * ld / torch.clamp(pick_pdf, min=1e-20)[:, None]

        # the next direction: HG at a medium vertex (volpath.rs:137-147),
        # the BSDF at a surface (volpath.rs:160-196)
        u_next = sampler.get_2d(pixel_id, s_idx, dim0 + VOL_NEXT)
        wi_med, _ = med.hg_sample(wo, g_med, u_next)
        bs = beval.bsdf_sample(params, frame, wo, u_next)
        ok_surf = surf_valid & bs.valid & torch.any(bs.f != 0.0, -1) & (bs.pdf > 0.0)
        cos_pdf = torch.abs(dot(bs.wi_world, frame.ns)) / torch.clamp(bs.pdf, min=1e-20)
        beta_surf = beta * bs.f * cos_pdf[:, None]
        new_dir = torch.where(in_medium[:, None], wi_med, bs.wi_world)
        beta = torch.where(in_medium[:, None], beta,
                           torch.where(ok_surf[:, None], beta_surf, beta))
        active = active & (in_medium | ok_surf)
        specular_bounce = ~in_medium & bs.specular

        # etaScale (volpath.rs:180-194)
        eta = params[:, 31]
        entering = dot(wo, si.ng) > 0.0
        eta_fac = torch.where(entering, eta * eta, 1.0 / torch.clamp(eta * eta, min=1e-20))
        eta_scale = torch.where(active & bs.transmitted & ~in_medium, eta_scale * eta_fac,
                                eta_scale)

        # the medium transition at a surface with an interface
        crossing = surf_valid & (dot(new_dir, si.ng) < 0.0)
        m_in, m_out = ctx.medium_interfaces(hit)
        has_interface = (m_in >= 0) | (m_out >= 0)
        med_id = torch.where(surf_valid & has_interface, torch.where(crossing, m_in, m_out),
                             med_id)

        ro = torch.where(active[:, None],
                         torch.where(in_medium[:, None], p_vertex,
                                     offset_ray_origin(si.p, si.ng, new_dir)), ro)
        rd = torch.where(active[:, None], new_dir, rd)

        # Russian roulette (volpath.rs:238-250); its value is read only then
        if bounces > 3:
            rr_beta_max = torch.amax(beta * eta_scale[:, None], -1)
            do_rr = active & (rr_beta_max < spec.rr_threshold)
            q = torch.clamp(1.0 - rr_beta_max, min=0.05)
            u_rr = sampler.get_1d(pixel_id, s_idx, dim0 + VOL_RR)
            killed = do_rr & (u_rr < q)
            active = active & ~killed
            beta = torch.where((do_rr & ~killed)[:, None],
                               beta / torch.clamp(1.0 - q, min=1e-9)[:, None], beta)
    return L
