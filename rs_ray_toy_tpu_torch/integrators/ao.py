"""Ambient occlusion (rs_ray_toy_tpu/integrators/ao.py, integrator/ao.rs).

Each camera ray's first hit sends n_samples probe rays over the hemisphere
of the shading normal faced toward the viewer, cosine- or uniformly
distributed (sampler dimensions 8 + k); L = the mean of the unoccluded
probes' cos / pdf, over pi (ao.rs:53-99), the same on every channel.
Under a HaltonSampler the probes read the sampler's hash at slot 8 + k
(HaltonSampler.traced_2d), as the JAX package's li_ao does: it draws the
probes in a fori_loop, where its Halton sampler sees a traced slot and
falls back to the hash.  Every
probe is one occlusion query of SceneCtx (K4 or K3 any hit on the card,
spheres in plain torch).  AO reads no light, no material and no medium:
it takes every scene the loader takes, textured ones too.
"""

import torch

from ..bsdf import eval as beval
from ..config import DTYPE, PI
from ..core.sampling import cosine_sample_hemisphere, uniform_sample_hemisphere
from ..core.vec import dot, faceforward
from ..accel.geometry import offset_ray_origin
from ..sampler.dims import ao_dim
from ..sampler.halton import HaltonSampler


def li_ao(ctx, o, d, cam_weight, sampler, pixel_id, s_idx, spec):
    """Radiance (N, 3) of camera rays o, d (N, 3) with weights cam_weight."""
    n = o.shape[0]
    t_max = torch.full((n,), torch.inf, dtype=DTYPE, device=o.device)
    _, si = ctx.intersect_shaded(o, d, t_max)
    valid = si.valid & (cam_weight > 0.0)
    ns = faceforward(si.ns, si.wo)
    frame = beval.make_frame(ns, si.ng, si.dpdu)
    total = torch.zeros(n, dtype=DTYPE, device=o.device)
    probe_2d = sampler.traced_2d if isinstance(sampler, HaltonSampler) else sampler.get_2d
    for k in range(spec.n_samples):
        u = probe_2d(pixel_id, s_idx, ao_dim(k))
        if spec.cos_sample:
            w_local = cosine_sample_hemisphere(u)
            pdf = w_local[:, 2] * (1.0 / PI)
        else:
            w_local = uniform_sample_hemisphere(u)
            pdf = torch.full((n,), 1.0 / (2.0 * PI), dtype=DTYPE, device=o.device)
        w_world = beval.local_to_world(frame, w_local)
        origin = offset_ray_origin(si.p, si.ng, w_world)
        vis = ~ctx.occluded(origin, w_world, t_max) & (pdf > 0.0)
        total = total + torch.where(vis, dot(w_world, ns) / torch.clamp(pdf, min=1e-20), 0.0)
    l = torch.where(valid, total / (spec.n_samples * PI), 0.0)
    return l[:, None].expand(n, 3).contiguous()
