"""Render entry points (rs_ray_toy_tpu/render.py), fused-kernel branches.

`deploy_render(scene.json, out.png)` loads the scene, builds the camera,
and renders.  SPPM runs its iterations (integrators/sppm.render_sppm:
per iteration one launch each of the camera, photon and deposit kernels
of ops/sppm_megakernel.py) on the Halton sampler it builds itself.  Every
other integrator renders in sample passes of k_spp = min(16, spp) samples: every
pixel's k samples form one sample-outer batch that a single fused call
traces, and the film adds the batch with the aligned reshape-add.  The
integrator picks the call: Path goes to the path kernel
(`li_path_mega_cam`), Debug and DirectLighting to the direct kernel
(`li_levels_mega_cam`), Volpath to the Volpath kernel
(`li_volpath_mega_cam`); all take the scene packed by `pack_scene` (the
Volpath kernel by `pack_volpath`, which adds the medium and the light
distribution), for the in-kernel BVH above TRI_MAX triangles.  Scenes
outside the chosen kernel's subset raise NotImplementedError
(`select_kernel`); there is no slower fallback loop.

Every tensor lives on the explicit `device`.  On "cuda" the passes run
the CUDA kernel and are timed with CUDA events; on "cpu" they run the
kernel's plain PyTorch version and are timed with the host clock.
"""

import time

import numpy as np
import torch

from .camera.realistic import RealisticCamera
from .film import film as fmod
from .integrators import sppm
from .integrators.common import scrub_radiance
from .ops import direct_megakernel as dmk
from .ops import path_megakernel as pmk
from .ops import sppm_megakernel as smk
from .ops import volpath_megakernel as vmk
from .sampler.halton import HaltonSampler
from .sampler.stratified import StratifiedSampler
from .scene.loader import SamplerSpec, load_scene


def require_device(device):
    """torch.device for `device`; raises when it names an absent card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the renderer needs one")
    return device


def deploy_render(scene_path, save_to, spp_override=None, pupil_samples=1 << 20, device="cuda"):
    """CLI entry (renderprocess.rs:92-105): render `scene_path` to the PNG
    `save_to` on `device`."""
    job = load_scene(scene_path)
    result = render_job(job, device, spp_override=spp_override, pupil_samples=pupil_samples,
                        write_to=save_to)
    colored = fmod.write_png(result["rgb_srgb_input"], save_to)
    print(f"Total pixels: {job.film.xres * job.film.yres}. Colored Pixels: {colored}")
    return result


def sample_batch(film_spec, k_spp, device):
    """One pass's sample-outer batch, ray r = s * (H*W) + y * W + x
    (render.py:353-362): pixel_xy (N, 2) float32 raster coordinates,
    pixel_id (N,) and sample_offset (N,) int64."""
    h, w = film_spec.yres, film_spec.xres
    ys, xs = np.mgrid[0:h, 0:w]
    pixel_xy = torch.as_tensor(
        np.tile(np.stack([xs.ravel(), ys.ravel()], axis=-1), (k_spp, 1)),
        dtype=torch.float32, device=device,
    )
    pixel_id = torch.as_tensor(np.tile((ys * w + xs).ravel(), k_spp), device=device)
    sample_offset = torch.as_tensor(np.repeat(np.arange(k_spp), h * w), device=device)
    return pixel_xy, pixel_id, sample_offset


# integrator kind -> (fused kernel, its module, its packing, its pass function;
# None for SPPM, whose iterations render_sppm drives)
FUSED = {
    "path": ("path", pmk, pmk.pack_scene, pmk.li_path_mega_cam),
    "debug": ("direct", dmk, pmk.pack_scene, dmk.li_levels_mega_cam),
    "direct": ("direct", dmk, pmk.pack_scene, dmk.li_levels_mega_cam),
    "volpath": ("volpath", vmk, vmk.pack_volpath, vmk.li_volpath_mega_cam),
    "sppm": ("sppm", smk, smk.pack_sppm, None),
}


def make_sampler(job, seed=0):
    """The render's sampler: for SPPM a Halton sampler of n_iters samples
    at the pixel centres (sppm.rs:130, render.py:43-48), else the scene's
    stratified one; the other kernels take no HaltonSampler and raise
    NotImplementedError naming it."""
    film = job.film
    if job.integrator.kind == "sppm":
        spec = SamplerSpec("halton", nsamp=job.integrator.n_iters, sample_at_center=True)
        return HaltonSampler(spec, film.xres, film.yres, seed=seed)
    if job.sampler.kind == "halton":
        raise NotImplementedError(f"HaltonSampler under the {job.integrator.kind} integrator "
                                  "(only SPPM renders with it)")
    return StratifiedSampler(job.sampler, seed=seed)


def select_kernel(job, sampler):
    """FUSED's entry for `job`; raises NotImplementedError naming the
    first feature outside the chosen kernel's subset."""
    if job.integrator.kind not in FUSED:
        raise NotImplementedError(f"{job.integrator.kind} integrator")
    entry = FUSED[job.integrator.kind]
    mod = entry[1]
    if mod is smk:  # SPPM reads no stratified sampler
        reason = mod.unsupported_feature(job.scene, job.integrator)
    else:
        reason = mod.unsupported_feature(job.scene, job.integrator, sampler)
    if reason is not None:
        raise NotImplementedError(f"scene outside the {entry[0]}-kernel subset: {reason}")
    return entry


def render_job(job, device, spp_override=None, pupil_samples=1 << 20, seed=0, write_to=None):
    """Render `job` on `device`.  Returns the film, the linear RGB image,
    the timed passes' seconds and camera Mrays/s (render.py:699-703),
    `render_path`, `fused_kernel`, whether the BVH was used and the
    kernel launches it made.  SPPM: see render_sppm_job (spp_override
    does not apply; `write_to` takes the periodic images)."""
    device = require_device(device)
    film_spec = job.film
    sampler = make_sampler(job, seed)
    if job.integrator.kind == "sppm":
        return render_sppm_job(job, device, sampler, pupil_samples, write_to)
    spp = job.sampler.spp
    if spp_override is not None and isinstance(sampler, StratifiedSampler):
        # keep the stratification consistent with the overridden spp
        side = max(1, int(np.sqrt(spp_override)))
        sampler.xs = side
        sampler.ys = max(1, spp_override // side)
        sampler.spp = spp = sampler.xs * sampler.ys
    fused, mod, pack, li_pass = select_kernel(job, sampler)
    cam = RealisticCamera(job.camera, film_spec, pupil_samples=pupil_samples, device=device)
    packed = pack(job.scene, device)
    cam_packed = pmk.pack_camera(cam)
    if device.type == "cuda":
        mod.load_kernel()  # build outside the timed region

    k_spp = min(16, spp)  # divides spp: both kernel subsets need a power of two
    pixel_xy, pixel_id, sample_offset = sample_batch(film_spec, k_spp, device)

    film = fmod.make_film(film_spec, device)
    launches0 = sum(mod.LAUNCHES.values())
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
    else:
        t0 = time.perf_counter()
    for s_base in range(0, spp, k_spp):
        s_idx = sample_offset + s_base
        # the kernel derives each ray's film jitter (sampler slot 0) itself;
        # the aligned film add puts every sample on its own pixel
        l, weight = li_pass(
            packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, job.integrator
        )
        l = scrub_radiance(l)
        l = torch.where((weight > 0.0)[:, None], l, 0.0)
        film = fmod.add_samples(film, film_spec, pixel_xy, l, weight)
    if device.type == "cuda":
        end.record()
        torch.cuda.synchronize(device)
        elapsed = start.elapsed_time(end) / 1e3
    else:
        elapsed = time.perf_counter() - t0
    launches = sum(mod.LAUNCHES.values()) - launches0

    n_rays = film_spec.xres * film_spec.yres * spp
    return {
        "film": film,
        "rgb_srgb_input": fmod.to_rgb(film, film_spec),
        "elapsed_s": elapsed,
        "camera_rays": n_rays,
        "mrays_per_s": n_rays / max(elapsed, 1e-9) / 1e6,
        "device": str(device),
        # the kernel on a card, its plain PyTorch version on the host
        "render_path": "megakernel" if launches else "plain",
        "fused_kernel": fused,
        "bvh": packed.bvh is not None,
        "launches": launches,
        "passes": spp // k_spp,
    }


def render_sppm_job(job, device, sampler, pupil_samples=1 << 20, write_to=None):
    """The SPPM render (render.py:28-106): packing, camera and kernel
    builds as set-up, then the timed iterations; the image goes through
    the film's set_image.  Returns the JAX package's keys (camera and
    photon rays, their Mrays/s over the iterations' seconds) and the
    launches of each SPPM kernel."""
    spec, film_spec = job.integrator, job.film
    select_kernel(job, sampler)
    packed = smk.pack_sppm(job.scene, device)
    cam_packed = pmk.pack_camera(
        RealisticCamera(job.camera, film_spec, pupil_samples=pupil_samples, device=device)
    )
    mats = smk.resolve_mat_tables(job.scene, device)
    lights = sppm.photon_lights(packed, job.scene.lights, device)
    if device.type == "cuda":
        smk.load_kernel()  # build outside the timed iterations

    def to_film(img):
        return fmod.set_image(fmod.make_film(film_spec, device), img)

    write_image_fn = None
    if write_to is not None:
        def write_image_fn(img, _):
            fmod.write_png(fmod.to_rgb(to_film(img), film_spec), write_to)

    launches0 = dict(smk.LAUNCHES)
    img, elapsed = sppm.render_sppm(packed, cam_packed, mats, lights, sampler, film_spec, spec,
                                    device, write_image_fn)
    launches = {k: v - launches0[k] for k, v in smk.LAUNCHES.items()}
    film = to_film(img)
    cam_rays = film_spec.xres * film_spec.yres * spec.n_iters
    photon_rays = spec.n_iters * spec.photons_per_iter
    rate = lambda rays: rays / max(elapsed, 1e-9) / 1e6
    return {
        "film": film,
        "rgb_srgb_input": fmod.to_rgb(film, film_spec),
        "elapsed_s": elapsed,
        "camera_rays": cam_rays,
        "photon_rays": photon_rays,
        "mrays_per_s": rate(cam_rays + photon_rays),
        "camera_mrays_per_s": rate(cam_rays),
        "photon_mrays_per_s": rate(photon_rays),
        "device": str(device),
        "render_path": "megakernel" if sum(launches.values()) else "plain",
        "fused_kernel": "sppm",
        "bvh": packed.bvh is not None,
        "launches": launches,
        "passes": spec.n_iters,
    }
