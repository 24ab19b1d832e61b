"""The Volpath kernel's plain PyTorch version against the JAX package.

`li_volpath_mega_cam` on CPU tensors runs `li_volpath_mega_cam_reference`,
the line-for-line plain version of csrc/volpath_megakernel.cu: the path
kernel's raygen, then `vol_bounce_loop_reference`.  Scenes: the fixture's
thin fog (samples/scene_fog.json, a homogeneous "Clorox" camera medium),
the same with the JAX bench's `fog_area` sphere light, and an 8^3 grid
plume (`write_grid_fog_scene`).

- Against JAX `li_volpath_mega_cam(..., interpret=True)` on identical
  packed tables (interop.from_jax_volpath), homogeneous fog with and
  without the sphere light, brute force and through the port's BVH
  (`pack_volpath(..., bvh=True)`): every sample of every pixel at 64x36,
  36,864 rays, one interpret call per scene.  Bar of
  tests/test_volpath_megakernel.py: fewer than 0.5% of rays off by more
  than 1e-3 relative, the 99th percentile of the relative difference
  below 1e-5, means within 3e-3.  The fixture's glossy cubes make about
  0.2% of the rays chaotic (the reference's Trowbridge-Reitz sampler,
  ROADMAP Queue 3); 36,864 rays keep them from moving the mean.
- The same with the plain version on the chunked walk (chunks built over
  the JAX table as pack_scene builds them), the brute-force kernel's walk.
- Against JAX `integrators/volpath.li_volpath` (the jnp path): the port's
  bounce loop driven with JAX's camera rays, at the same per-ray bar, on
  the fog scenes with every cube matte (no chaotic sampling, so 4 spp
  suffice) and on the grid plume.  The jnp path is the reference for grid
  media (the TPU kernel rounds its density taps to bf16); the per-ray bar
  holds there, stricter than the image bars (RMSE, bit-close lanes) of
  tests/test_volpath_megakernel.py.
- A render: deploy_render of samples/scene_fog.json at 64x36 (16 spp) on
  the CPU against the JAX render_job image, at the image-mean and
  coloured-pixel bars of the shipped path fixture (tests/test_torch_render.py).
"""

import json
import shutil
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.film import film as jax_film
from rs_ray_toy_tpu.integrators.common import SceneCtx
from rs_ray_toy_tpu.integrators.volpath import li_volpath
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.ops import volpath_megakernel as jvmk
from rs_ray_toy_tpu.render import render_job as jax_render_job
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.interop import camera_from_jax, from_jax_volpath
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.ops import volpath_megakernel as vmk
from rs_ray_toy_tpu_torch.render import deploy_render
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import THIN_FOG, write_fog_scene, write_grid_fog_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
# several pytest workers share the host: cap torch's OpenMP threads
torch.set_num_threads(min(2, torch.get_num_threads()))
PUPIL_SAMPLES = 1 << 12


def _scene(tmp, kind, matte=False, w=64, h=36):
    """fog / fog_area / grid_fog at w x h under out dir `tmp`."""
    if kind == "grid_fog":
        return write_grid_fog_scene(str(tmp), n=8, xres=w, yres=32, max_depth=3, sigma_scale=0.6)
    path = write_fog_scene(str(tmp), area_light=kind == "fog_area",
                           base=str(SAMPLES / "scene_fog.json"), medium=THIN_FOG, xres=w, yres=h)
    if matte:
        cfg = json.loads(Path(path).read_text())
        for prim in cfg["Aggregate"]["primitives"]:
            prim["material_name"] = "mat_matte"
        Path(path).write_text(json.dumps(cfg))
    return path


def _jax(path):
    job = jax_load_scene(path)
    ctx = SceneCtx(job.scene)
    sampler = JaxStratified(job.sampler, seed=0)
    assert jvmk.supports_volpath(ctx, job.integrator, sampler, None)
    return job, ctx, sampler, JaxCamera(job.camera, job.film, pupil_samples=PUPIL_SAMPLES)


def _batch(w, h, spp):
    """Every sample of every pixel, pixels in a seeded order."""
    pid = np.tile(np.random.default_rng(11).permutation(w * h).astype(np.uint32), spp)
    sid = np.repeat(np.arange(spp, dtype=np.uint32), w * h)
    pxy = np.stack([pid % w, pid // w], -1).astype(np.float32)
    return pxy, pid, sid


def _bar(l, l_ref):
    assert np.isfinite(l).all()
    assert l_ref.max() > 0
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    frac_diverged = float((rel.max(-1) > 1e-3).mean())
    assert frac_diverged < 5e-3, f"{frac_diverged:.2%} of rays diverged"
    assert float(np.quantile(rel, 0.99)) < 1e-5, "bulk not bit-level"
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())


@pytest.fixture(scope="module")
def interpret(tmp_path_factory):
    """interpret(kind): the JAX kernel in interpret mode over every sample
    of every pixel of the 64x36 scene (one call, made once), and what the
    port needs to run the same rays."""
    made = {}

    def get(kind):
        if kind not in made:
            path = _scene(tmp_path_factory.mktemp(kind), kind)
            job, ctx, sampler, jcam = _jax(path)
            jpacked = jvmk.pack_volpath(ctx)
            pxy, pid, sid = _batch(64, 36, 16)
            l_ref, w_ref = jvmk.li_volpath_mega_cam(
                ctx, jpacked, jpmk.pack_camera(jcam), jnp.asarray(pxy), jnp.asarray(pid),
                jnp.asarray(sid), sampler, job.integrator, interpret=True,
            )
            made[kind] = dict(
                path=path, jpacked=jpacked, cam=camera_from_jax(jpmk.pack_camera(jcam)),
                args=(torch.as_tensor(pxy), torch.as_tensor(pid.astype(np.int64)),
                      torch.as_tensor(sid.astype(np.int64))),
                l_ref=np.asarray(l_ref), w_ref=np.asarray(w_ref),
            )
        return made[kind]

    return get


@pytest.mark.parametrize("geometry", ["brute", "bvh"])
@pytest.mark.parametrize("kind", ["fog", "fog_area"])
def test_radiance_matches_jax_kernel(interpret, kind, geometry):
    r = interpret(kind)
    job = load_scene(r["path"])
    if geometry == "brute":
        jp = r["jpacked"]
        packed = from_jax_volpath(np.asarray(jp[0]), jp[5].lights, jp[8], None, "cpu")
        assert packed.bvh is None
    else:
        packed = vmk.pack_volpath(job.scene, "cpu", bvh=True)
        assert packed.bvh is not None
    l, w = vmk.li_volpath_mega_cam(packed, r["cam"], *r["args"], StratifiedSampler(job.sampler),
                                   job.integrator)
    _bar(l.numpy(), r["l_ref"])
    assert (r["w_ref"] > 0).sum() > 1000
    np.testing.assert_allclose(w.numpy(), r["w_ref"], rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("kind", ["fog", "fog_area"])
def test_chunked_walk_matches_jax_kernel(interpret, kind):
    """The plain version on the chunked walk (the brute-force kernel's since
    it took it), its chunks built over the JAX package's table as
    pack_scene builds them, against the same JAX kernel run."""
    r = interpret(kind)
    job = load_scene(r["path"])
    jp = r["jpacked"]
    packed = from_jax_volpath(np.asarray(jp[0]), jp[5].lights, jp[8], None, "cpu")
    g = packed.table[:, :9].numpy()
    chunks = pmk.build_tri_chunks(g[:, 0:3], g[:, 3:6], g[:, 6:9], g.shape[0])
    packed = packed._replace(scene=packed.scene._replace(
        chunks=torch.as_tensor(pmk.chunk_rows(chunks))))
    assert packed.chunks.shape[0] > 1
    l, w = vmk.li_volpath_mega_cam(packed, r["cam"], *r["args"], StratifiedSampler(job.sampler),
                                   job.integrator)
    _bar(l.numpy(), r["l_ref"])
    np.testing.assert_allclose(w.numpy(), r["w_ref"], rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("kind", ["fog", "fog_area", "grid_fog"])
def test_bounce_loop_matches_jnp_li_volpath(tmp_path, kind):
    """JAX's camera rays through li_volpath and through the port's bounce
    loop; the fog scenes with matte cubes, 64x36 (grid 64x32) x 4 spp."""
    path = _scene(tmp_path, kind, matte=True)
    job, ctx, sampler, jcam = _jax(path)
    w_, h_ = job.film.xres, job.film.yres
    pxy, pid, sid = _batch(w_, h_, 4)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    o, d, w_ref = jcam.generate_rays(
        jnp.asarray(pxy) + sampler.get_2d(jp, js, 0), sampler.get_2d(jp, js, 1)
    )
    l_ref = np.asarray(li_volpath(ctx, o, d, w_ref, sampler, jp, js, job.integrator,
                                  camera_medium=ctx.camera_medium))
    live = np.asarray(w_ref) > 0
    l_ref = np.where(live[:, None], l_ref, 0.0)

    pjob = load_scene(path)
    packed = vmk.pack_volpath(pjob.scene, "cpu")
    assert packed.grid == (kind == "grid_fog")
    l = vmk.vol_bounce_loop_reference(
        packed, torch.as_tensor(np.asarray(o)), torch.as_tensor(np.asarray(d)),
        torch.as_tensor(live), torch.as_tensor(pid.astype(np.int64)),
        torch.as_tensor(sid.astype(np.int64)), StratifiedSampler(pjob.sampler), pjob.integrator,
    ).numpy()
    _bar(l, l_ref)


def test_render_matches_jax(tmp_path):
    """The CLI's path on the CPU: samples/scene_fog.json at 64x36."""
    cfg = json.loads((SAMPLES / "scene_fog.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 64, 36
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    scene = tmp_path / "scene_fog.json"
    scene.write_text(json.dumps(cfg))
    res = deploy_render(str(scene), str(tmp_path / "port.png"), pupil_samples=PUPIL_SAMPLES,
                        device="cpu")
    ref = jax_render_job(jax_load_scene(str(scene)), pupil_samples=PUPIL_SAMPLES)
    assert res["fused_kernel"] == ref["fused_kernel"] == "volpath"
    assert res["render_path"] == "plain" and res["launches"] == 0 and not res["bvh"]
    assert res["camera_rays"] == ref["camera_rays"] == 64 * 36 * 16 and res["passes"] == 1
    img, ref_img = res["rgb_srgb_input"].numpy(), np.asarray(ref["rgb_srgb_input"])
    assert img.shape == ref_img.shape == (36, 64, 3)
    assert np.isfinite(img).all() and ref_img.mean() > 0
    assert abs(img.mean() - ref_img.mean()) < 3e-3 * ref_img.mean()
    # fog scatters light into most of the frame
    from PIL import Image

    q = np.asarray(Image.open(tmp_path / "port.png").convert("RGB"))
    ref_colored = jax_film.write_png(ref["rgb_srgb_input"], str(tmp_path / "jax.png"))
    colored = int(np.sum(q.sum(-1) > 0))
    assert ref_colored > 0.5 * 64 * 36
    assert abs(colored - ref_colored) <= 0.005 * ref_colored
