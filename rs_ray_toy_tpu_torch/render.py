"""Render entry points (rs_ray_toy_tpu/render.py), fused-kernel branches.

`deploy_render(scene.json, out.png)` loads the scene, builds the camera,
and renders.  SPPM runs its iterations (integrators/sppm.render_sppm:
per iteration one launch each of the camera, photon and deposit kernels
of ops/sppm_megakernel.py) on the Halton sampler it builds itself.  Every
other integrator renders, under the scene's stratified sampler or (Path,
AO, Debug, DirectLighting and Volpath) its HaltonSampler, in sample passes of k_spp samples,
the largest divisor of spp up to 16: every pixel's k samples form one
sample-outer batch that a single fused call traces, and the film adds the
batch: with the aligned reshape-add for a box inside one pixel, else at
p_film = pixel + the film jitter (sampler slot 0, drawn by the sampler's
torch ops for a fused pass, whose kernel draws the same value itself) with
the filter's footprint (film/film.py).  The
integrator picks the call: Path goes to the path kernel
(`li_path_mega_cam`), Debug and DirectLighting to the direct kernel
(`li_levels_mega_cam`), Volpath to the Volpath kernel
(`li_volpath_mega_cam`); all take the scene packed by `pack_scene` (the
Volpath kernel by `pack_volpath`, which adds the medium and the light
distribution), for the in-kernel BVH above TRI_MAX triangles.  A textured
scene in the path kernel's textured subset goes to its textured instance
(an image texture's kd, K7's tap inside); outside it, and under every
other integrator but AO, it raises naming the feature.

AO, and Path, Debug, DirectLighting and Volpath on a scene outside the
fused kernel's subset that the wavefront loop takes (partial spheres,
more than 8 spheres or lights, distant and triangle lights, environment
lights, meshes above the kernels' triangle limit or too deep for their
stack, max_depth 0 or past the kernel's range, the HaltonSampler under
Debug, DirectLighting and Volpath, stratified grids that are not a power
of two, smooth normals, Oren-Nayar matte, rough glass, Translucent, Mix
and thin or transmissive Disney materials, a subsurface Disney material
outside the path kernel's subsurface subset, and for Volpath any media:
none, several, per-primitive interfaces, grid media under any light),
render through the wavefront loop instead (`render_wavefront_job`):
raygen on the host (camera/realistic), then integrators/ao.li_ao,
integrators/path.li_path, integrators/direct.li_levels or
integrators/volpath.li_volpath over SceneCtx, whose triangle queries are
kernels K4 and K3 (spheres in plain torch).  Path, Debug, DirectLighting
and Volpath say so on stderr, as the JAX package does.  Scenes outside
every subset raise NotImplementedError (`select_kernel`).

Every tensor lives on the explicit `device`.  On "cuda" the passes run
the CUDA kernel and are timed with CUDA events; on "cpu" they run the
kernel's plain PyTorch version and are timed with the host clock.
"""

import sys
import time

import numpy as np
import torch

from .camera.realistic import RealisticCamera
from .film import film as fmod
from .integrators import direct as wdirect
from .integrators import path as wpath
from .integrators import sppm
from .integrators import volpath as wvol
from .integrators.ao import li_ao
from .integrators.common import SceneCtx, scrub_radiance
from .ops import bvh_kernel as bk
from .ops import direct_megakernel as dmk
from .ops import intersect_kernel as ik
from .ops import path_megakernel as pmk
from .ops import sppm_megakernel as smk
from .ops import volpath_megakernel as vmk
from .sampler.dims import CAMERA_FILM, CAMERA_LENS
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


class PassTimer:
    """The timed window of a render's sample passes: CUDA events around
    them on a card (after a synchronize, ended by one), the host clock on
    the CPU; `seconds` once the window closes.  The window is the
    torch.profiler range RENDER_PASSES (profile_render reads it)."""

    def __init__(self, device):
        self.device = device
        self.seconds = None

    def __enter__(self):
        self.label = torch.profiler.record_function(RENDER_PASSES)
        self.label.__enter__()
        if self.device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(self.device)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self.end.record()
            torch.cuda.synchronize(self.device)
            self.seconds = self.start.elapsed_time(self.end) / 1e3
        else:
            self.seconds = time.perf_counter() - self.t0
        self.label.__exit__(*exc)
        return False


RENDER_PASSES = "render_passes"


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
    at the pixel centres (sppm.rs:130, render.py:43-48), else the scene's:
    its StratifiedSampler or its HaltonSampler (Debug, DirectLighting and
    Volpath then in the wavefront loop)."""
    film = job.film
    if job.integrator.kind == "sppm":
        spec = SamplerSpec("halton", nsamp=job.integrator.n_iters, sample_at_center=True)
        return HaltonSampler(spec, film.xres, film.yres, seed=seed)
    if job.sampler.kind == "halton":
        return HaltonSampler(job.sampler, film.xres, film.yres, seed=seed)
    return StratifiedSampler(job.sampler, seed=seed)


def pass_spp(spp):
    """Samples per pixel of one pass: the largest divisor of spp up to 16
    (render.py:299-300), so that the passes cover every sample once."""
    k = min(16, spp)
    while spp % k:
        k -= 1
    return k


# select_kernel's answer for the wavefront loop
WAVEFRONT = ("wavefront", None, None, None)


# the integrators whose jobs outside their fused kernel the wavefront loop
# renders, announced on stderr
WAVEFRONT_FALLBACK = {"path": wpath.unsupported_feature, "debug": wdirect.unsupported_feature,
                      "direct": wdirect.unsupported_feature, "volpath": wvol.unsupported_feature}


def wavefront_unsupported(job, sampler):
    """The first feature of an AO, Path, Debug, DirectLighting or Volpath
    job outside the wavefront loop, or None.  AO reads no light, material
    or medium: it takes any scene of triangles and spheres, of any size,
    textured or not, under either sampler and any stratified grid."""
    kind = job.integrator.kind
    if kind in WAVEFRONT_FALLBACK:
        return WAVEFRONT_FALLBACK[kind](job.scene, job.integrator, sampler)
    return None


def select_kernel(job, sampler):
    """FUSED's entry for `job`, or WAVEFRONT for AO and for Path, Debug
    and DirectLighting scenes outside their fused kernel that the
    wavefront loop takes (announced on stderr); raises
    NotImplementedError naming the first feature outside the chosen
    path's subset."""
    kind = job.integrator.kind
    if kind == "ao":
        reason = wavefront_unsupported(job, sampler)
        if reason is not None:
            raise NotImplementedError(f"scene outside the AO integrator's subset: {reason}")
        return WAVEFRONT
    if kind not in FUSED:
        raise NotImplementedError(f"{kind} integrator")
    entry = FUSED[kind]
    mod = entry[1]
    if mod is smk:  # SPPM reads no stratified sampler
        reason = mod.unsupported_feature(job.scene, job.integrator)
    else:
        reason = mod.unsupported_feature(job.scene, job.integrator, sampler)
    if reason is not None:
        fallback = kind in WAVEFRONT_FALLBACK
        wreason = wavefront_unsupported(job, sampler) if fallback else None
        if fallback and wreason is None:
            # loud fallback, as the JAX package's render.py:217-224, 236-240
            print(f"rs_ray_toy_tpu_torch: scene outside the {entry[0]}-kernel subset ({reason})"
                  " — using the wavefront loop", file=sys.stderr)
            return WAVEFRONT
        if wreason is not None and wreason != reason:
            reason = f"{reason}; and the wavefront loop's: {wreason}"
        raise NotImplementedError(f"scene outside the {entry[0]}-kernel subset: {reason}")
    return entry


def render_job(job, device, spp_override=None, pupil_samples=1 << 20, seed=0, write_to=None):
    """Render `job` on `device`.  Returns the film, the linear RGB image,
    the timed passes' seconds and camera Mrays/s (render.py:699-703),
    `render_path`, `fused_kernel`, whether the BVH was used and the
    kernel launches it made.  SPPM: see render_sppm_job (spp_override
    does not apply; `write_to` takes the periodic images); AO and the
    Path, Debug and DirectLighting wavefront routes: render_wavefront_job."""
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
    elif spp_override is not None:
        sampler.spp = spp = spp_override  # a Halton sampler takes any count
    fused, mod, pack, li_pass = select_kernel(job, sampler)
    if fused == "wavefront":
        return render_wavefront_job(job, device, sampler, spp, pupil_samples)
    cam = RealisticCamera(job.camera, film_spec, pupil_samples=pupil_samples, device=device)
    packed = pack(job.scene, device)
    cam_packed = pmk.pack_camera(cam)
    if device.type == "cuda":
        mod.load_kernel()  # build outside the timed region

    k_spp = pass_spp(spp)
    pixel_xy, pixel_id, sample_offset = sample_batch(film_spec, k_spp, device)

    film = fmod.make_film(film_spec, device)
    launches0 = sum(mod.LAUNCHES.values())
    with PassTimer(device) as timer:
        for s_base in range(0, spp, k_spp):
            s_idx = sample_offset + s_base
            # the kernel derives each ray's film jitter (sampler slot 0) itself;
            # the aligned film add puts every sample on its own pixel, another
            # filter reads the same jitter drawn here
            l, weight = li_pass(
                packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, job.integrator
            )
            l = scrub_radiance(l)
            l = torch.where((weight > 0.0)[:, None], l, 0.0)
            p_film = pixel_xy if fmod.aligned(film_spec) else film_points(
                sampler, pixel_xy, pixel_id, s_idx)
            film = fmod.add_samples(film, film_spec, p_film, l, weight)
    elapsed = timer.seconds
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


def wavefront_launches():
    return {**ik.LAUNCHES, **bk.LAUNCHES}


def film_points(sampler, pixel_xy, pixel_id, s_idx):
    """The samples' raster positions p_film: each pixel's corner plus the
    film jitter, sampler dim 0 (render.py:461-462)."""
    return pixel_xy + sampler.get_2d(pixel_id, s_idx, CAMERA_FILM)


def camera_rays(cam, sampler, pixel_xy, pixel_id, s_idx, p_film=None):
    """One pass's camera rays as the wavefront render makes them: the film
    and lens values of sampler dims 0 and 1 (p_film, when given, the
    first's raster positions), then the lens trace
    (camera/realistic.generate_rays).  Returns (o, d, weight)."""
    if p_film is None:
        p_film = film_points(sampler, pixel_xy, pixel_id, s_idx)
    u_lens = sampler.get_2d(pixel_id, s_idx, CAMERA_LENS)
    return cam.generate_rays(p_film, u_lens)


# rays a level of the Debug / DirectLighting tree holds at most: a pass
# whose deepest level would hold more is traced in chunks of camera rays
LEVEL_RAYS_MAX = 1 << 22
WAVEFRONT_LI = {"ao": li_ao, "path": wpath.li_path, "debug": wdirect.li_levels,
                "direct": wdirect.li_levels, "volpath": wvol.li_volpath}


def chunked(li, chunk):
    """li traced over consecutive chunks of `chunk` camera rays (every
    ray's radiance is its own: the image is the same), radiance joined."""
    def run(ctx, o, d, weight, sampler, pixel_id, s_idx, spec):
        n = o.shape[0]
        if n <= chunk:
            return li(ctx, o, d, weight, sampler, pixel_id, s_idx, spec)
        return torch.cat([li(ctx, o[a:a + chunk], d[a:a + chunk], weight[a:a + chunk], sampler,
                             pixel_id[a:a + chunk], s_idx[a:a + chunk], spec)
                          for a in range(0, n, chunk)])
    return run


def render_wavefront_job(job, device, sampler, spp, pupil_samples=1 << 20):
    """The wavefront render (render.py:400-457, 508-517): SceneCtx (its BVH
    build) and the camera are set-up; each timed pass of k_spp samples
    per pixel draws the film and lens values (sampler dims 0 and 1),
    generates the camera rays on the host and runs li_ao, li_path,
    li_levels (in chunks of camera rays whose deepest tree level holds up
    to LEVEL_RAYS_MAX rays) or li_volpath (every ray born in the camera
    medium) over them.  Returns render_job's keys, `render_path`
    "wavefront" and the launches of each intersection kernel."""
    film_spec = job.film
    cam = RealisticCamera(job.camera, film_spec, pupil_samples=pupil_samples, device=device)
    ctx = SceneCtx.from_scene(job.scene, device)
    if device.type == "cuda":
        (ik if ctx.bvh is None else bk).load_kernel()  # build outside the timed region
    li = WAVEFRONT_LI[job.integrator.kind]
    if li is wdirect.li_levels:
        width = wdirect.rays_per_camera_ray(ctx.static_kinds, job.integrator)
        li = chunked(li, max(1, LEVEL_RAYS_MAX // width))

    k_spp = pass_spp(spp)
    pixel_xy, pixel_id, sample_offset = sample_batch(film_spec, k_spp, device)
    film = fmod.make_film(film_spec, device)
    launches0 = wavefront_launches()
    with PassTimer(device) as timer:
        for s_base in range(0, spp, k_spp):
            s_idx = sample_offset + s_base
            p_film = film_points(sampler, pixel_xy, pixel_id, s_idx)
            o, d, weight = camera_rays(cam, sampler, pixel_xy, pixel_id, s_idx, p_film)
            l = scrub_radiance(li(ctx, o, d, weight, sampler, pixel_id, s_idx, job.integrator))
            l = torch.where((weight > 0.0)[:, None], l, 0.0)
            film = fmod.add_samples(film, film_spec, p_film, l, weight)
    elapsed = timer.seconds
    launches = {k: v - launches0[k] for k, v in wavefront_launches().items()}
    n_rays = film_spec.xres * film_spec.yres * spp
    return {
        "film": film,
        "rgb_srgb_input": fmod.to_rgb(film, film_spec),
        "elapsed_s": elapsed,
        "camera_rays": n_rays,
        "mrays_per_s": n_rays / max(elapsed, 1e-9) / 1e6,
        "device": str(device),
        "render_path": "wavefront",
        "fused_kernel": None,
        "bvh": ctx.bvh is not None,
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
