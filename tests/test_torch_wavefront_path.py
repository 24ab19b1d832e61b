"""The wavefront Path loop (integrators/path.li_path) against the JAX
package's `li_path`, and the Path route past the path kernel's triangle
limit, on the CPU.

- Per ray, on the same camera rays (JAX's generate_rays) and the same
  stratified sampler: the fixture at 128x72 x 16 spp (147,456 rays, brute
  force: K4's plain version) and a 6x6 grid of cubes at 96x54 x 16 spp
  (82,944 rays; 456 triangles: K3's plain walks on the JAX package's
  kernel tables, while JAX walks its jnp BVH).  The bar of PERF.md section 2: fewer than
  0.5% of rays off by more than 1e-3 relative, the 99th percentile of the
  relative difference below 1e-5, means within 3e-3; at least 1,000 lit
  rays, since the reference's Trowbridge-Reitz sampler makes 1-2% of the
  glossy bounces diverge between any two implementations (ROADMAP Queue 3).
- render_job(device="cpu") on the 6x6 grid with the path kernel's
  triangle limit lowered below its 456 triangles: the route announces the
  wavefront loop on stderr, renders over the BVH, and matches the JAX
  package's render (its path kernel, in interpret mode) with every cube
  matte: image mean within 3e-3 relative, 98% of the lit pixels within
  1e-3 relative.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.accel.bvh import build_bvh as jax_build_bvh
from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.integrators.path import li_path as jax_li_path
from rs_ray_toy_tpu.ops.bvh_pallas import pack_bvh_tables
from rs_ray_toy_tpu.render import render_job as jax_render_job
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu.scene.types import empty_spheres
from rs_ray_toy_tpu_torch.integrators.path import li_path, unsupported_feature
from rs_ray_toy_tpu_torch.interop import from_jax_scene_ctx
from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.render import render_job
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import write_grid_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
PUPIL_SAMPLES = 1 << 12

# The suite runs in several pytest workers on one host: keep torch's
# OpenMP threads from oversubscribing the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))


def _bar(l, l_ref):
    assert np.isfinite(l).all() and l_ref.max() > 0
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    diverged = float((rel.max(-1) > 1e-3).mean())
    assert diverged < 5e-3, f"{diverged:.2%} of rays diverged"
    assert float(np.quantile(rel, 0.99)) < 1e-5, "bulk not bit-level"
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())


@pytest.mark.parametrize("geometry", ["fixture", "grid6"])
def test_li_path_matches_jax(tmp_path, geometry):
    if geometry == "fixture":
        path, (w_, h_) = str(SAMPLES / "scene.json"), (128, 72)
    else:
        path, (w_, h_) = write_grid_scene(str(tmp_path), ny=6, nz=6), (96, 54)
    job = jax_load_scene(path)
    job.film.xres, job.film.yres = w_, h_
    jctx = JaxSceneCtx(job.scene)
    tables = None
    if geometry == "grid6":
        tables = pack_bvh_tables(jax_build_bvh(jctx.tri, empty_spheres(), bk.KERNEL_LEAF), jctx.tri)
    ctx = from_jax_scene_ctx(jctx, "cpu", tables)
    jsampler = JaxStratified(job.sampler, seed=0)
    pid = np.tile(np.arange(w_ * h_, dtype=np.uint32), 16)
    sid = np.repeat(np.arange(16, dtype=np.uint32), w_ * h_)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    pxy = jnp.stack([jp % w_, jp // w_], -1).astype(jnp.float32)
    cam = JaxCamera(job.camera, job.film, pupil_samples=PUPIL_SAMPLES)
    o, d, w = cam.generate_rays(pxy + jsampler.get_2d(jp, js, 0), jsampler.get_2d(jp, js, 1))
    l_ref = np.asarray(jax_li_path(jctx, o, d, w, jsampler, jp, js, job.integrator))
    pjob = load_scene(path)
    assert unsupported_feature(pjob.scene, pjob.integrator, StratifiedSampler(pjob.sampler)) is None
    l = li_path(ctx, torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d)),
                torch.as_tensor(np.array(w)), StratifiedSampler(pjob.sampler, seed=0),
                torch.as_tensor(pid.astype(np.int64)), torch.as_tensor(sid.astype(np.int64)),
                pjob.integrator).numpy()
    assert (l_ref.max(-1) > 0).sum() >= 1000
    _bar(l, l_ref)


def test_path_past_the_kernel_limit_renders_wavefront(tmp_path, monkeypatch, capsys):
    grid = write_grid_scene(str(tmp_path), ny=6, nz=6, xres=64, yres=36)
    cfg = json.loads(Path(grid).read_text())
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_matte"
    Path(grid).write_text(json.dumps(cfg))
    ref = jax_render_job(jax_load_scene(grid), spp_override=4, pupil_samples=PUPIL_SAMPLES)
    monkeypatch.setattr(pmk, "BVH_TRI_MAX", 400)
    job = load_scene(grid)
    assert job.scene.triangles.count == 456
    res = render_job(job, "cpu", spp_override=4, pupil_samples=PUPIL_SAMPLES)
    err = capsys.readouterr().err
    assert "456 triangles" in err and "wavefront loop" in err
    assert res["render_path"] == "wavefront" and res["bvh"] and res["fused_kernel"] is None
    assert res["camera_rays"] == ref["camera_rays"] == 64 * 36 * 4
    img, ref_img = res["rgb_srgb_input"].numpy(), np.asarray(ref["rgb_srgb_input"])
    assert np.isfinite(img).all() and ref_img.mean() > 0
    assert abs(img.mean() - ref_img.mean()) < 3e-3 * ref_img.mean()
    lit = (img.sum(-1) > 0) | (ref_img.sum(-1) > 0)
    assert lit.sum() > 100
    close = np.all(np.abs(img - ref_img) <= 1e-3 * np.abs(ref_img) + 1e-4, axis=-1)
    assert close[lit].mean() >= 0.98


def test_scenes_outside_every_path_raise(tmp_path, monkeypatch):
    """Past the path kernel, a Path scene the wavefront loop does not take
    either raises, naming both features (here a textured grid above a
    lowered kernel limit: the loop evaluates no texture); AO takes any
    number of triangles and textures, and any stratified grid (3x3 too).
    AO reads no light: a sphere light beside
    its scene renders through the wavefront loop."""
    from rs_ray_toy_tpu_torch.render import WAVEFRONT, make_sampler, select_kernel

    grid = write_grid_scene(str(tmp_path), ny=6, nz=6, xres=64, yres=36, textured=True)
    monkeypatch.setattr(pmk, "BVH_TRI_MAX", 400)
    job = load_scene(grid)
    with pytest.raises(NotImplementedError, match="456 triangles.*textured kd"):
        select_kernel(job, make_sampler(job))
    job.integrator.kind = "ao"
    assert select_kernel(job, make_sampler(job)) == WAVEFRONT
    job.sampler.xsamp = 3
    assert select_kernel(job, make_sampler(job)) == WAVEFRONT
    cfg = json.loads((SAMPLES / "scene_ao.json").read_text())
    cfg["lights"].append({"light_type": "diffuse", "spectrum": {"values": [5.0, 5.0, 5.0]},
                          "light_shape": {"shape_type": "sphere", "radius": 0.5,
                                          "world_pos": [33.0, 3.0, 1.0]}})
    (tmp_path / "ao.json").write_text(json.dumps(cfg))
    (tmp_path / "cube.obj").write_bytes((SAMPLES / "cube.obj").read_bytes())
    job = load_scene(str(tmp_path / "ao.json"))
    assert select_kernel(job, make_sampler(job)) == WAVEFRONT
