"""The wavefront Debug / DirectLighting loop (integrators/direct.li_levels)
against the JAX package's `li_levels`, its route through render_job, and
its white furnace, on the CPU.

- Per ray, on the same seeded camera rays of a 64x36 film at 4 spp (JAX's
  camera and sampler) and identical scene tables (interop
  .from_jax_scene_ctx): Debug on the sphere-area fixture, DirectLighting
  "all" on the environment fixture, DirectLighting "one" on the materials
  fixture, Debug on the Debug fixture at max_depth 5 (a glass cube: both
  children live, four levels), the Halton fixture under Debug (every tree
  dimension a per-ray tensor: the counter-based hash on both sides) and
  the smooth fixture under DirectLighting (1,956 triangles: K3's plain
  walks on the JAX package's kernel tables, while JAX walks its jnp BVH).
  The bar of PERF.md section 2: under 0.5% of rays off by more than 1e-3
  relative, means within 3e-3.
- The DirectLighting white furnace (tests/test_furnace.py:104-111): the
  "one" strategy at max_depth 2 reflects rho = 0.5 within 0.015 rho +
  0.004, escaped rays read the environment, 1.
- The route: the direct kernel's scenes still go to it; the others to the
  wavefront loop, announced on stderr; the HaltonSampler is taken; a
  textured scene still raises.
- render_job(device="cpu") on the sphere-area fixture under Debug against
  JAX's eager li_levels and film on the same samples (64x36 at 4 spp: the
  first case's array shapes, whose XLA compiles JAX then reuses): image
  mean within 3e-3 relative, 98% of the lit pixels within 1e-3 relative.
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
from rs_ray_toy_tpu.film import film as jax_film
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.integrators.common import scrub_radiance as jax_scrub
from rs_ray_toy_tpu.integrators.direct import li_levels as jax_li_levels
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.ops.bvh_pallas import pack_bvh_tables
from rs_ray_toy_tpu.sampler.halton import HaltonSampler as JaxHalton
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu.scene.types import empty_spheres
from rs_ray_toy_tpu_torch.integrators.common import SceneCtx
from rs_ray_toy_tpu_torch.integrators.direct import li_levels, unsupported_feature
from rs_ray_toy_tpu_torch.interop import from_jax_scene_ctx, sampler_from_jax
from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
from rs_ray_toy_tpu_torch.render import (
    FUSED,
    WAVEFRONT,
    make_sampler,
    render_job,
    select_kernel,
)
from rs_ray_toy_tpu_torch.sampler.halton import HaltonSampler
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.loader import load_scene
from tests.test_torch_furnace import RHO, _furnace_path, _rays

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
PUPIL_SAMPLES = 1 << 12
W, H, SPP = 64, 36, 4

torch.set_num_threads(min(2, torch.get_num_threads()))


def _write(tmp_path, name, integrator, max_depth=None, strategy=None, xres=W, yres=H):
    """A copy of samples/`name` under `integrator` on an xres x yres film."""
    cfg = json.loads((SAMPLES / name).read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = xres, yres
    cfg["Integrator"]["integrator_type"] = integrator
    if max_depth is not None:
        cfg["Integrator"]["max_depth"] = max_depth
    if strategy is not None:
        cfg["Integrator"]["light_strategy"] = strategy
    for f in ("cube.obj", "sphere_smooth.obj", "tex_checker.png"):
        shutil.copy(SAMPLES / f, tmp_path)
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


def _bar(l, l_ref, min_lit=200):
    assert np.isfinite(l).all() and l_ref.max() > 0
    assert (l_ref.max(-1) > 0).sum() >= min_lit
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    diverged = float((rel.max(-1) > 1e-3).mean())
    assert diverged < 5e-3, f"{diverged:.2%} of rays diverged"
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())


# case: (sample file, integrator, max_depth, light strategy, film)
CASES = {
    "debug-sphere-area": ("scene_sphere_area.json", "Debug", None, None, (W, H)),
    "direct-all-env": ("scene_env.json", "DirectLighting", None, "all", (W, H)),
    "direct-one-materials": ("scene_materials.json", "DirectLighting", None, "one", (W, H)),
    "debug-glass-depth5": ("scene_debug.json", "Debug", 5, None, (W, H)),
    "debug-halton": ("scene_halton.json", "Debug", None, None, (W, H)),
    "direct-smooth": ("scene_smooth.json", "DirectLighting", None, "all", (W, H)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_li_levels_matches_jax(tmp_path, case):
    name, integrator, max_depth, strategy, (w_, h_) = CASES[case]
    path = _write(tmp_path, name, integrator, max_depth, strategy, w_, h_)
    job = jax_load_scene(path)
    jctx = JaxSceneCtx(job.scene)
    tables = None
    if jctx.tri.count > 256:
        tables = pack_bvh_tables(jax_build_bvh(jctx.tri, empty_spheres(), bk.KERNEL_LEAF),
                                 jctx.tri)
    rgb = [jpmk._env_constant_rgb(e) for e in jctx.infinite_envs]
    ctx = from_jax_scene_ctx(jctx, "cpu", tables, env_rgb=rgb)
    halton = job.sampler.kind == "halton"
    if halton:
        jsampler = JaxHalton(job.sampler, w_, h_, seed=0)
        sampler = sampler_from_jax(jsampler, w_, h_)
    else:
        jsampler = JaxStratified(job.sampler, seed=0)
        sampler = StratifiedSampler(load_scene(path).sampler, seed=0)
    pid = np.tile(np.arange(w_ * h_, dtype=np.uint32), SPP)
    sid = np.repeat(np.arange(SPP, dtype=np.uint32), w_ * h_)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    pxy = jnp.stack([jp % w_, jp // w_], -1).astype(jnp.float32)
    cam = JaxCamera(job.camera, job.film, pupil_samples=PUPIL_SAMPLES)
    o, d, w = cam.generate_rays(pxy + jsampler.get_2d(jp, js, 0), jsampler.get_2d(jp, js, 1))
    l_ref = np.asarray(jax_li_levels(jctx, o, d, w, jsampler, jp, js, job.integrator))
    pjob = load_scene(path)
    assert isinstance(make_sampler(pjob), HaltonSampler if halton else StratifiedSampler)
    assert unsupported_feature(pjob.scene, pjob.integrator, sampler) is None
    assert ctx.static_kinds == jctx.static_kinds
    T = lambda a: torch.as_tensor(np.array(a))
    l = li_levels(ctx, T(o), T(d), T(w), sampler, T(pid.astype(np.int64)),
                  T(sid.astype(np.int64)), pjob.integrator).numpy()
    _bar(l, l_ref)


def test_white_furnace_direct(tmp_path):
    """tests/test_furnace.py:104-111 on the port: DirectLighting, one light
    picked, max_depth 2, a unit environment about a matte sphere."""
    cfg = json.loads(Path(_furnace_path(tmp_path)).read_text())
    cfg["Integrator"] = {"integrator_type": "DirectLighting", "light_strategy": "one",
                         "max_depth": 2}
    path = tmp_path / "furnace_direct.json"
    path.write_text(json.dumps(cfg))
    job = load_scene(str(path))
    sampler = StratifiedSampler(job.sampler, seed=3)
    assert unsupported_feature(job.scene, job.integrator, sampler) is None
    ctx = SceneCtx.from_scene(job.scene, "cpu")
    o, d, w, pid, sid = _rays((0.0, 0.0, 0.0))
    L = li_levels(ctx, o, d, w, sampler, pid, sid, job.integrator).numpy()
    assert np.isfinite(L).all()
    mean = L.mean(axis=0)
    assert np.all(np.abs(mean - RHO) < 0.015 * RHO + 0.004), mean
    L_esc = li_levels(ctx, o, -d, w, sampler, pid, sid, job.integrator).numpy()
    assert np.abs(L_esc - 1.0).max() <= 1e-6


def test_route(tmp_path, capsys):
    """Debug / DirectLighting on the direct kernel's scenes stay there; the
    others go to the wavefront loop with one stderr line naming the
    kernel's refusal; a textured scene raises."""
    job = load_scene(str(SAMPLES / "scene_debug.json"))
    assert select_kernel(job, make_sampler(job)) == FUSED["debug"]
    assert capsys.readouterr().err == ""
    for name, integrator, what in (
        ("scene_sphere_area.json", "DirectLighting", "sphere primitives"),
        ("scene_materials.json", "Debug", "sphere primitives"),
        ("scene_env.json", "DirectLighting", "infinite lights"),
        ("scene_halton.json", "Debug", "HaltonSampler"),
        ("scene_smooth.json", "Debug", "smooth shading"),
    ):
        job = load_scene(_write(tmp_path, name, integrator))
        assert select_kernel(job, make_sampler(job)) == WAVEFRONT
        err = capsys.readouterr().err.strip().splitlines()
        assert len(err) == 1 and what in err[0], err
        assert "direct-kernel subset" in err[0] and "wavefront loop" in err[0]
    job = load_scene(_write(tmp_path, "scene_textured.json", "DirectLighting"))
    with pytest.raises(NotImplementedError, match="direct-kernel subset: textured kd"):
        select_kernel(job, make_sampler(job))


def test_render_job_matches_jax_li_levels(tmp_path, capsys):
    """render_job on the sphere-area fixture under Debug against JAX's
    camera rays, eager li_levels and film."""
    w_, h_, spp = W, H, SPP
    path = _write(tmp_path, "scene_sphere_area.json", "Debug", xres=w_, yres=h_)
    res = render_job(load_scene(path), "cpu", spp_override=spp, pupil_samples=PUPIL_SAMPLES)
    assert "wavefront loop" in capsys.readouterr().err
    assert res["render_path"] == "wavefront" and res["passes"] == 1
    job = jax_load_scene(path)
    jctx = JaxSceneCtx(job.scene)
    sampler = JaxStratified(job.sampler, seed=0)
    side = int(np.sqrt(spp))
    sampler.xs, sampler.ys = side, spp // side
    sampler.spp = spp = sampler.xs * sampler.ys
    cam = JaxCamera(job.camera, job.film, pupil_samples=PUPIL_SAMPLES)
    ys, xs = np.mgrid[0:h_, 0:w_]
    pid = jnp.asarray(np.tile((ys * w_ + xs).ravel(), spp), jnp.uint32)
    sid = jnp.asarray(np.repeat(np.arange(spp), h_ * w_), jnp.uint32)
    pxy = jnp.asarray(np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (spp, 1)), jnp.float32)
    p_film = pxy + sampler.get_2d(pid, sid, 0)
    o, d, wgt = cam.generate_rays(p_film, sampler.get_2d(pid, sid, 1))
    l = jax_scrub(jax_li_levels(jctx, o, d, wgt, sampler, pid, sid, job.integrator))
    l = jnp.where((wgt > 0.0)[:, None], l, 0.0)
    film = jax_film.add_samples(jax_film.make_film(job.film), job.film, p_film, l, wgt,
                                aligned=True)
    ref_img = np.asarray(jax_film.to_rgb(film, job.film))
    img = res["rgb_srgb_input"].numpy()
    assert np.isfinite(img).all() and ref_img.mean() > 0
    assert abs(img.mean() - ref_img.mean()) < 3e-3 * ref_img.mean()
    lit = (img.sum(-1) > 0) | (ref_img.sum(-1) > 0)
    assert lit.sum() > 50
    close = np.all(np.abs(img - ref_img) <= 1e-3 * np.abs(ref_img) + 1e-4, axis=-1)
    assert close[lit].mean() >= 0.98
