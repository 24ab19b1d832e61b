"""The AO integrator against the JAX package's, on the CPU.

- The loader: `integrator_type` "AO", and a scene that names none, load
  as AO with the JAX package's defaults (cosine sampling, 64 probes).
- `li_ao` per ray against JAX `li_ao` on the same camera rays (JAX's
  generate_rays on a seeded pixel order, 64x36 x 8 spp = 18,432 rays) and
  the same stratified sampler, cosine and uniform probes, on the fixture
  (brute force: K4's plain version) and on a 6x6 grid of cubes (456
  triangles: K3's plain walks, on the JAX package's kernel tables carried
  over by interop.from_jax_scene_ctx, while JAX walks its jnp BVH).  The
  per-ray bar of PERF.md section 2: fewer than 0.5% of rays off by more
  than 1e-3 relative, means within 3e-3; an AO value is a mean of 64
  probes, so one probe that grazes an edge the other way moves its ray by
  about 1/64.
- The AO render of the fixture through render_job(device="cpu") against
  JAX render_job: the image mean within 3e-3 relative and 98% of the lit
  pixels within 1e-3 relative.
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.accel.bvh import build_bvh as jax_build_bvh
from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators.ao import li_ao as jax_li_ao
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.ops.bvh_pallas import pack_bvh_tables
from rs_ray_toy_tpu.render import render_job as jax_render_job
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu.scene.types import empty_spheres
from rs_ray_toy_tpu_torch.integrators.ao import li_ao
from rs_ray_toy_tpu_torch.interop import from_jax_scene_ctx
from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
from rs_ray_toy_tpu_torch.render import render_job
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import write_grid_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
PUPIL_SAMPLES = 1 << 12
W, H, SPP = 64, 36, 8

# The suite runs in several pytest workers on one host: keep torch's
# OpenMP threads from oversubscribing the cores.
torch.set_num_threads(min(2, torch.get_num_threads()))


def _write(tmp, edit):
    cfg = json.loads((SAMPLES / "scene_ao.json").read_text())
    edit(cfg)
    shutil.copy(SAMPLES / "cube.obj", tmp)
    (tmp / "scene.json").write_text(json.dumps(cfg))
    return str(tmp / "scene.json")


def test_loader_reads_ao_and_defaults_to_it(tmp_path):
    job = load_scene(str(SAMPLES / "scene_ao.json"))
    spec = job.integrator
    assert (spec.kind, spec.cos_sample, spec.n_samples) == ("ao", True, 64)

    def drop(cfg):
        del cfg["Integrator"]

    job = load_scene(_write(tmp_path, drop))
    assert (job.integrator.kind, job.integrator.cos_sample, job.integrator.n_samples) == ("ao", True, 64)

    def uniform(cfg):
        cfg["Integrator"].update(cos_sample=False, n_samples=8)

    spec = load_scene(_write(tmp_path, uniform)).integrator
    jspec = jax_load_scene(_write(tmp_path, uniform)).integrator
    assert (spec.kind, spec.cos_sample, spec.n_samples) == (jspec.kind, False, 8)


def _camera_rays(job, sampler):
    """JAX generate_rays over every sample of every pixel, pixels in a
    numpy-seeded order."""
    cam = JaxCamera(job.camera, job.film, pupil_samples=PUPIL_SAMPLES)
    pid = np.tile(np.random.default_rng(3).permutation(W * H).astype(np.uint32), SPP)
    sid = np.repeat(np.arange(SPP, dtype=np.uint32), W * H)
    jpid, jsid = jnp.asarray(pid), jnp.asarray(sid)
    pxy = jnp.stack([jpid % W, jpid // W], -1).astype(jnp.float32)
    o, d, w = cam.generate_rays(pxy + sampler.get_2d(jpid, jsid, 0), sampler.get_2d(jpid, jsid, 1))
    return o, d, w, pid, sid


def _bar(l, l_ref):
    assert np.isfinite(l).all() and l_ref.max() > 0
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    diverged = float((rel.max(-1) > 1e-3).mean())
    assert diverged < 5e-3, f"{diverged:.2%} of rays diverged"
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())


@pytest.mark.parametrize("cos_sample", [True, False])
@pytest.mark.parametrize("geometry", ["fixture", "grid6"])
def test_li_ao_matches_jax(tmp_path, geometry, cos_sample):
    if geometry == "fixture":
        path = str(SAMPLES / "scene_ao.json")
    else:
        path = write_grid_scene(str(tmp_path), ny=6, nz=6, base=str(SAMPLES / "scene_ao.json"),
                                integrator="AO", xres=W, yres=H)
    job = jax_load_scene(path)
    job.film.xres, job.film.yres = W, H
    job.integrator.cos_sample = cos_sample
    jctx = JaxSceneCtx(job.scene)
    tables = None
    if geometry == "grid6":
        assert jctx.bvh is not None
        tables = pack_bvh_tables(jax_build_bvh(jctx.tri, empty_spheres(), bk.KERNEL_LEAF), jctx.tri)
    ctx = from_jax_scene_ctx(jctx, "cpu", tables)
    assert (ctx.bvh is not None) == (geometry == "grid6")
    jsampler = JaxStratified(job.sampler, seed=0)
    o, d, w, pid, sid = _camera_rays(job, jsampler)
    l_ref = np.asarray(jax_li_ao(jctx, o, d, w, jsampler, jnp.asarray(pid), jnp.asarray(sid),
                                 job.integrator))
    port_spec = load_scene(path).integrator
    port_spec.cos_sample = cos_sample
    l = li_ao(ctx, torch.as_tensor(np.array(o)), torch.as_tensor(np.array(d)),
              torch.as_tensor(np.array(w)), StratifiedSampler(load_scene(path).sampler, seed=0),
              torch.as_tensor(pid.astype(np.int64)), torch.as_tensor(sid.astype(np.int64)),
              port_spec).numpy()
    assert (l_ref.max(-1) > 0).sum() > (400 if geometry == "fixture" else 600)
    _bar(l, l_ref)


def test_ao_render_matches_jax(tmp_path):
    def small(cfg):
        cfg["Film"]["xres"], cfg["Film"]["yres"] = 64, 36

    scene = _write(tmp_path, small)
    ref = jax_render_job(jax_load_scene(scene), spp_override=4, pupil_samples=PUPIL_SAMPLES)
    res = render_job(load_scene(scene), "cpu", spp_override=4, pupil_samples=PUPIL_SAMPLES)
    assert res["render_path"] == "wavefront" and res["fused_kernel"] is None
    assert not res["bvh"] and not any(res["launches"].values())
    assert res["camera_rays"] == 64 * 36 * 4 and res["passes"] == 1
    img, ref_img = res["rgb_srgb_input"].numpy(), np.asarray(ref["rgb_srgb_input"])
    assert np.isfinite(img).all() and ref_img.mean() > 0
    assert abs(img.mean() - ref_img.mean()) < 3e-3 * ref_img.mean()
    lit = (img.sum(-1) > 0) | (ref_img.sum(-1) > 0)
    assert lit.sum() > 50
    close = np.all(np.abs(img - ref_img) <= 1e-3 * np.abs(ref_img) + 1e-4, axis=-1)
    assert close[lit].mean() >= 0.98
