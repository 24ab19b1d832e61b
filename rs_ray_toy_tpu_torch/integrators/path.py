"""Wavefront unidirectional path tracer (rs_ray_toy_tpu/integrators/path.py,
integrator/path.rs).

The bounce loop of path.rs:51-226 as a masked loop over (N,) rays: every
ray advances one bounce per step under an active mask.  Per bounce: the
shaded closest hit (dead lanes carry t_max = 0, so the kernels retire them
at once), NEE with one uniformly picked light unless the BSDF is purely
specular (path.rs:108-122), one BSDF sample for the next direction
(reflection.rs:302-381), the etaScale factor of specular transmissions,
and Russian roulette on beta * etaScale after bounce 3 (path.rs:212-222).
Surface emission is identically zero in the reference (its aggregate never
links area lights to primitives) and the loop takes no infinite lights, so
escaped rays carry nothing.

This is the JAX package's `li_path`, the jnp twin of the path kernel K1;
the render takes it where K1 does not (`unsupported_feature` names what it
does not take either: BSSRDF, textures and environment lights are outside
the port's loader already).
"""

from typing import Optional

import torch

from ..bsdf import eval as beval
from ..config import DTYPE
from ..core.vec import dot
from ..accel.geometry import offset_ray_origin
from ..ops import bvh_kernel as bk
from ..ops.path_megakernel import DEPTH_MAX, PORTED_KINDS, scene_unsupported
from ..sampler.dims import PATH_BSDF, PATH_RR, path_dim0
from .common import uniform_sample_one_light


def unsupported_feature(scene, spec, sampler) -> Optional[str]:
    """The first feature of the job outside the wavefront Path loop, or
    None: the path kernel's subset, up to BVH_PRIM_MAX triangles."""
    if spec.kind != "path":
        return f"{spec.kind} integrator"
    if not 1 <= spec.max_depth <= DEPTH_MAX:
        return f"max_depth {spec.max_depth} outside 1..{DEPTH_MAX}"
    return scene_unsupported(scene, sampler, PORTED_KINDS, tri_max=bk.BVH_PRIM_MAX)


def li_path(ctx, o, d, cam_weight, sampler, pixel_id, s_idx, spec):
    """Radiance (N, 3) of camera rays o, d (N, 3) with weights cam_weight."""
    n = o.shape[0]
    L = torch.zeros((n, 3), dtype=DTYPE, device=o.device)
    active = cam_weight > 0.0
    beta = torch.ones((n, 3), dtype=DTYPE, device=o.device) * active[:, None]
    eta_scale = torch.ones(n, dtype=DTYPE, device=o.device)
    ro, rd = o, d
    nonspec = beval.BXDF_ALL & ~beval.BXDF_SPECULAR
    # bounce max_depth would only collect escaped infinite light: not traced
    for bounces in range(spec.max_depth):
        dim0 = path_dim0(bounces)
        t_max = torch.where(active, torch.inf, 0.0).to(DTYPE)
        hit, si = ctx.intersect_shaded(ro, rd, t_max)
        active = active & hit.valid
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

        # etaScale (path.rs:150-163)
        eta = params[:, 31]
        entering = dot(si.wo, si.ng) > 0.0
        eta_fac = torch.where(entering, eta * eta, 1.0 / torch.clamp(eta * eta, min=1e-20))
        eta_scale = torch.where(active & bs.transmitted, eta_scale * eta_fac, eta_scale)

        ro = torch.where(active[:, None], offset_ray_origin(si.p, si.ng, bs.wi_world), ro)
        rd = torch.where(active[:, None], bs.wi_world, rd)

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
