"""Stochastic progressive photon mapping (rs_ray_toy_tpu/integrators/sppm.py,
integrator/sppm.rs), on the kernels of ops/sppm_megakernel.py.

Per iteration (sppm.rs:105-555):
  1. camera walk: one ray per pixel (Halton, sample_at_center, sample
     index = iteration) to its visible point (VP); direct light adds to
     the pixel's ld;
  2. photon emission here in torch: a light by power, Light::sample_le,
     beta = Le |n.d| / (light_pdf pdf_pos pdf_dir), and the bounce and
     roulette uniforms, all from radical_inverse(dim, it * n_photons + i);
  3. photon walk: the deposit events;
  4. deposit: the events Morton-sorted over the box of the valid VPs +-
     their radii, phi and M per VP;
  5. radius and tau update with gamma = 2/3 and PBRT's sqrt (the
     reference drops it, sppm.rs:508-532; the JAX package keeps it).
L = ld / iters + tau / (iters * n_photons * pi * r^2) is the image.

Pixels stay in raster order (the JAX package's blocked-32 order only
tightens its TPU tiles' event ranges, and changes no sum).
"""

import time
from typing import NamedTuple

import torch

from ..config import PI
from ..core import lowdiscrepancy as ld
from ..core.sampling import Distribution1D, sample_discrete_1d
from ..lights import lights as lmod
from ..ops import sppm_megakernel as smk


class SPPMState(NamedTuple):
    """Per pixel, across iterations; the iteration's visible points are
    ops/sppm_megakernel.VisiblePoints."""

    radius: torch.Tensor  # (P,)
    ld: torch.Tensor  # (P, 3) direct light summed over iterations
    n: torch.Tensor  # (P,) photon count N
    tau: torch.Tensor  # (P, 3)


class PhotonLights(NamedTuple):
    """The point lights and their power distribution on the device."""

    p: torch.Tensor  # (L, 3)
    emit: torch.Tensor  # (L, 3)
    power: dict  # Distribution1D.as_device of Light::power


def photon_lights(packed, lights, device):
    """PhotonLights of pack_sppm's lights; `lights` the scene's LightSoA."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return PhotonLights(f32(packed.light_p), f32(packed.light_emit),
                        Distribution1D(lmod.power(lights)).as_device(device))


def emit_photons(lights, halton_index, max_depth):
    """The photon pass's emission (_emit_photons): the light pick by power
    (dim 0), sample_le (dims 1-4), beta, and the bounce and roulette
    uniforms of each depth d < max_depth - 1 at dims 5 + 2d, 6 + 2d and
    7 + 2d + 2 max_depth.  halton_index (n,) integer.  Returns
    (ro, rd, beta (n, 3), active (n,), u_rows (3 (max_depth - 1), n))."""
    bounce = []
    for depth in range(max_depth - 1):
        bounce += [5 + 2 * depth, 6 + 2 * depth, 7 + 2 * depth + 2 * max_depth]
    u = ld.radical_inverse_rows([0, 1, 2, 3, 4] + bounce, halton_index)
    light_idx, light_pdf = sample_discrete_1d(lights.power, u[0])
    ro, rd, n_l, le, pdf_pos, pdf_dir = lmod.sample_le(
        lights.p, lights.emit, light_idx, u[1], u[2]
    )
    cos = torch.abs(n_l[:, 0] * rd[:, 0] + n_l[:, 1] * rd[:, 1] + n_l[:, 2] * rd[:, 2])
    beta = le * cos[:, None] / torch.clamp(light_pdf * pdf_pos * pdf_dir, min=1e-20)[:, None]
    active = (pdf_pos > 0.0) & (pdf_dir > 0.0) & (le > 0.0).any(-1) & (beta > 0.0).any(-1)
    return ro, rd, beta, active, u[5:].contiguous()


def grid_bounds(vp, radius):
    """(lo, diag) of the deposit grid (sppm.rs:262-292): the box of the
    valid VPs +- their radii in float32, [0, 1]^3 when there is none."""
    valid = (vp.valid & (vp.beta > 0.0).any(-1))[:, None]
    lo = torch.where(valid, vp.p - radius[:, None], 3e38).min(0).values
    hi = torch.where(valid, vp.p + radius[:, None], -3e38).max(0).values
    any_vp = valid.any()
    lo = torch.where(any_vp, lo, 0.0)
    hi = torch.where(any_vp, hi, 1.0)
    return lo, hi - lo


def radius_tau_update(state, vp, phi, m):
    """(sppm.rs:508-532, with PBRT's sqrt): per pixel with M > 0,
    N' = N + 2/3 M, r' = r sqrt(N' / (N + M)), tau' = (tau + beta phi)
    r'^2 / r^2."""
    mf = m.to(torch.float32)
    has_m = m > 0
    n_new = state.n + (2.0 / 3.0) * mf
    r_new = state.radius * torch.sqrt(n_new / torch.clamp(state.n + mf, min=1e-20))
    tau_new = (state.tau + vp.beta * phi) * (r_new * r_new)[:, None] / torch.clamp(
        state.radius * state.radius, min=1e-20
    )[:, None]
    return SPPMState(
        radius=torch.where(has_m, r_new, state.radius),
        ld=state.ld,
        n=torch.where(has_m, n_new, state.n),
        tau=torch.where(has_m[:, None], tau_new, state.tau),
    )


def sppm_image(state, iters_done, n_photons, h, w):
    """(H, W, 3) radiance after `iters_done` iterations (_sppm_image)."""
    np_total = iters_done * n_photons
    rr = state.radius[:, None] ** 2
    l = state.ld / iters_done + state.tau / torch.clamp(np_total * PI * rr, min=1e-20)
    return l.reshape(h, w, 3)


def iteration(state, it, packed, cam_packed, mats, lights, pixel_xy, u_halton, spec,
              mats_wide=None):
    """One SPPM iteration (camera walk, emission, photon walk, deposit,
    update) with sample index `it`: the kernels' wide instances where the
    scene's lobes need them (smk.wide_lobes; the deposit's `mats_wide`,
    smk.mats_wide(mats), taken here when not given).  Returns the new
    state."""
    ld_delta, vp = smk.sppm_camera_mega_cam(packed, cam_packed, pixel_xy, u_halton,
                                            spec.max_depth)
    state = state._replace(ld=state.ld + ld_delta)
    lo, diag = grid_bounds(vp, state.radius)
    n_photons = spec.photons_per_iter
    halton_index = it * n_photons + torch.arange(n_photons, device=pixel_xy.device)
    ro, rd, beta, active, u_rows = emit_photons(lights, halton_index, spec.max_depth)
    events = smk.sppm_photon_mega(packed, ro, rd, beta, active, u_rows, spec.max_depth)
    phi, m = smk.deposit_mega(vp, state.radius, mats, events, lo, diag, mats_wide)
    return radius_tau_update(state, vp, phi, m)


def render_sppm(packed, cam_packed, mats, lights, sampler, film_spec, spec, device,
                write_image_fn=None):
    """Run spec.n_iters iterations on `device`; packed is pack_sppm's,
    mats resolve_mat_tables', lights photon_lights', sampler the Halton
    sampler of the render (nsamp = n_iters, sample_at_center).
    write_image_fn(img, iters_done), when given, gets the image every
    spec.write_freq iterations before the last (sppm.rs:534-555).
    Returns (image (H, W, 3), seconds of the iterations): CUDA events on
    a card, the host clock on the CPU; the image writes fall outside."""
    h, w = film_spec.yres, film_spec.xres
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    pixel_id = (ys * w + xs).reshape(-1)
    pixel_xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(torch.float32)
    slots = smk.sppm_slots(spec.max_depth)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    state = SPPMState(torch.full((h * w,), spec.radius, dtype=torch.float32, device=device),
                      z(h * w, 3), z(h * w), z(h * w, 3))
    wf = max(1, spec.write_freq)
    wide = smk.mats_wide(mats)  # once a render: the material rows stay the same
    elapsed = 0.0
    done = 0
    while done < spec.n_iters:
        nxt = min(done + wf, spec.n_iters)
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for it in range(done, nxt):
            u_halton = sampler.slot_matrix(pixel_id, it, slots)
            state = iteration(state, it, packed, cam_packed, mats, lights, pixel_xy, u_halton,
                              spec, wide)
        if device.type == "cuda":
            end.record()
            torch.cuda.synchronize(device)
            elapsed += start.elapsed_time(end) / 1e3
        else:
            elapsed += time.perf_counter() - t0
        done = nxt
        if write_image_fn is not None and done < spec.n_iters:
            write_image_fn(sppm_image(state, done, spec.photons_per_iter, h, w), done)
    return sppm_image(state, spec.n_iters, spec.photons_per_iter, h, w), elapsed
