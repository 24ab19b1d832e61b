"""Debug and DirectLighting as wavefront level loops
(rs_ray_toy_tpu/integrators/direct.py; intersect_debug.rs:56-89,
directlighting.rs:17-133, integrator/mod.rs:150-301).

The reference's recursive li with its specular_reflect / specular_transmit
children becomes a loop over tree levels: each level carries a ray array
with a per-ray throughput beta, and the two specular children double the
next level's array (dead branches keep beta = 0).  At every level: the
shaded closest hit, Debug's flat 0.1 on any hit, DirectLighting's escape
term (only when the first light is an environment, directlighting.rs:
83-88), then every light (`uniform_sample_all_lights`, Debug's strategy
and DirectLighting's "all") or one picked light (`one`).  A child whose
sample_f over SPECULAR | REFLECTION (or TRANSMISSION) can match no lobe of
the material table is pruned statically, and without any specular lobe
the depth is cut to 2.  Every tree node reads its sampler dimensions from
8 + branch * 257 (branch ids: the root 0, children 2b + 1 and 2b + 2), a
per-ray tensor of dimensions, which the Halton sampler answers with its
counter-based hash as the JAX package does for a traced slot.

This is the render's route for Debug and DirectLighting scenes outside
the direct kernel K2 (ops/direct_megakernel): spheres, sphere, area,
distant and environment lights, the HaltonSampler, smooth normals, every
lobe of the wavefront Path loop, deep BVHs and any max_depth.  It
evaluates no texture: a textured scene raises (`unsupported_feature`).
"""

from typing import Optional

import torch

from ..accel.geometry import offset_ray_origin
from ..bsdf import eval as beval
from ..bsdf.lobes import (
    LOBE_DEBUG_DIFFUSE,
    LOBE_DEBUG_SPECULAR,
    LOBE_FRESNEL_SPEC,
    LOBE_SPEC_REFL,
    LOBE_SPEC_TRANS,
)
from ..config import DTYPE
from ..core.vec import dot
from ..ops.path_megakernel import WAVEFRONT_KINDS, scene_unsupported
from ..sampler.dims import INTEGRATOR_DIM0
from ..scene.types import LIGHT_INFINITE
from .common import uniform_sample_all_lights, uniform_sample_one_light

BRANCH_DIMS = 257  # sampler dimensions between two tree nodes' blocks
# the lobes the wavefront tree evaluates: the wavefront Path loop's and the
# Debug material's
KINDS = WAVEFRONT_KINDS + (LOBE_DEBUG_DIFFUSE, LOBE_DEBUG_SPECULAR)
# the kinds that give a reflect (transmit) child a lobe to sample
REFLECT_KINDS = {LOBE_SPEC_REFL, LOBE_FRESNEL_SPEC, LOBE_DEBUG_SPECULAR}
TRANSMIT_KINDS = {LOBE_SPEC_TRANS, LOBE_FRESNEL_SPEC}
CHILD_FLAGS = (beval.BXDF_SPECULAR | beval.BXDF_REFLECTION,
               beval.BXDF_SPECULAR | beval.BXDF_TRANSMISSION)


def unsupported_feature(scene, spec, sampler) -> Optional[str]:
    """The first feature of the job outside the wavefront Debug /
    DirectLighting loop, or None: the wavefront Path loop's scenes (any
    spheres, lights, triangles, smooth normals, either sampler) with the
    Debug material too, any max_depth >= 0; no texture."""
    if spec.kind not in ("debug", "direct"):
        return f"{spec.kind} integrator"
    if spec.max_depth < 0:
        return f"max_depth {spec.max_depth}"
    return scene_unsupported(scene, sampler, KINDS, wavefront=True, allow_smooth=True)


def tree_shape(static_kinds, spec):
    """(levels, (reflect child live, transmit child live)): max_depth - 1
    levels (at least 1) while a child is live, else one (the JAX
    package's cut to depth 2 without specular lobes, and its break when
    both children are pruned)."""
    live = (bool(static_kinds & REFLECT_KINDS), bool(static_kinds & TRANSMIT_KINDS))
    return (max(1, spec.max_depth - 1) if any(live) else 1), live


def rays_per_camera_ray(static_kinds, spec):
    """The deepest level's rays per camera ray: each level multiplies the
    array by its number of live children."""
    levels, live = tree_shape(static_kinds, spec)
    return sum(live) ** (levels - 1)


def _escape_radiance(ctx):
    """DirectLighting's escape radiance (3,): the first light's le when it
    is an environment (the reference returns inside its first light
    iteration, directlighting.rs:83-88), else None."""
    lt = ctx.lights
    if not ctx.n_lights or not lt.envs or int(lt.kind[0]) != LIGHT_INFINITE:
        return None
    return lt.envs[int(lt.shape_index[0])]["rgb"]


def li_levels(ctx, o, d, cam_weight, sampler, pixel_id, s_idx, spec):
    """Radiance (N, 3) of camera rays o, d (N, 3) with weights cam_weight
    under Debug or DirectLighting (spec.kind "debug" or "direct")."""
    n = o.shape[0]
    levels, branch_live = tree_shape(ctx.static_kinds, spec)
    debug = spec.kind == "debug"
    strategy_all = debug or spec.light_strategy == "all"
    env_le = None if debug else _escape_radiance(ctx)
    L = torch.zeros((n, 3), dtype=DTYPE, device=o.device)
    lo, ld_ = o, d
    beta = torch.ones((n, 3), dtype=DTYPE, device=o.device) * (cam_weight > 0.0)[:, None]
    lpix = pixel_id
    lsamp = torch.as_tensor(s_idx, device=o.device).expand(n)
    branch = torch.zeros(n, dtype=torch.int64, device=o.device)
    for depth in range(1, levels + 1):
        dim_base = INTEGRATOR_DIM0 + branch * BRANCH_DIMS
        active = torch.any(beta != 0.0, -1)
        t_max = torch.where(active, torch.inf, 0.0).to(DTYPE)
        hit, si = ctx.intersect_shaded(lo, ld_, t_max)
        si = si._replace(valid=si.valid & active)
        params = ctx.shade_params(si)
        frame = ctx.frame(si)

        level_l = torch.zeros_like(beta)
        if debug:  # the flat base on any hit (intersect_debug.rs:69-72)
            level_l = torch.where(si.valid[:, None], 0.1, level_l)
        elif env_le is not None:
            level_l = torch.where((active & ~hit.valid)[:, None], env_le, level_l)
        sample_lights = uniform_sample_all_lights if strategy_all else uniform_sample_one_light
        s_l, dim_base = sample_lights(ctx, si, params, frame, sampler, lpix, lsamp, dim_base)
        L = _accumulate(L, n, beta * (level_l + s_l))
        if depth == levels:
            break

        # the specular reflect and transmit children (integrator/mod.rs:150-301)
        children = []
        for ci, flags in enumerate(CHILD_FLAGS):
            if not branch_live[ci]:
                continue  # a statically zero subtree
            u = sampler.get_2d(lpix, lsamp, dim_base + ci)
            bs = beval.bsdf_sample(params, frame, si.wo, u, flags)
            cos = torch.abs(dot(bs.wi_world, frame.ns))
            ok = si.valid & bs.valid & (cos != 0.0)
            child_beta = beta * bs.f * (cos / torch.clamp(bs.pdf, min=1e-20))[:, None]
            children.append((offset_ray_origin(si.p, si.ng, bs.wi_world), bs.wi_world,
                             torch.where(ok[:, None], child_beta, 0.0), branch * 2 + 1 + ci))
        lo, ld_, beta, branch = (torch.cat(parts) for parts in zip(*children))
        lpix = torch.cat([lpix] * len(children))
        lsamp = torch.cat([lsamp] * len(children))
    return L


def _accumulate(L, n, contrib):
    """Fold a level's (k n, 3) contributions back onto the n camera rays:
    their sum over the k branches, left to right, added to L."""
    k = contrib.shape[0] // n
    total = contrib[:n]
    for j in range(1, k):
        total = total + contrib[j * n:(j + 1) * n]
    return L + total
