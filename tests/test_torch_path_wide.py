"""The path kernel K1 widened to spheres, sphere-area and constant
environment lights, on the CPU: its plain version, on given rays (the
rays-in instances #3 and #4) and from the camera (render_job), against the
JAX package's kernel (`li_path_mega`, interpret mode) and its wavefront
`li_path`; and the port's wavefront `li_path` on what only the wavefront
loop renders.

The scenes are those of tests/test_megakernel_wide.py on the in-repo
fixture at 64x36: two full spheres among matte cubes under the point
lights (brute force, and over the BVH), with a sphere-area light beside a
point light, the white furnace (a unit matte sphere under a unit constant
environment, sampled and escape-only) with its closure, and a mirror
sphere under an escape-only environment.  The bar is JAX's own
(tests/test_megakernel_wide.py:98-101): under 0.5% of rays off by more
than 1e-3 relative, the 99th percentile of the relative difference below
1e-4, means within 3e-3.  Every hold is on matte objects, as JAX's are:
the reference's Trowbridge-Reitz sampler diverges on 1-2% of glossy
bounces between any two implementations (ROADMAP Queue 3), so the glossy
fixture is held on the card (chip_smoke.py phase 8), and render_job here
renders the sphere-area fixture with matte cubes.
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.integrators.path import li_path as jax_li_path
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.render import render_job as jax_render_job
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.integrators.common import SceneCtx
from rs_ray_toy_tpu_torch.integrators.path import li_path, unsupported_feature
from rs_ray_toy_tpu_torch.interop import from_jax_packed, from_jax_scene_ctx
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.render import render_job
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import write_wavefront_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
PUPIL_SAMPLES = 1 << 10

torch.set_num_threads(min(2, torch.get_num_threads()))


def _write(tmp_path, cfg):
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    path = tmp_path / "s.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _base_cfg(max_depth=5):
    cfg = json.loads((SAMPLES / "scene.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 64, 36
    cfg["Integrator"] = {"integrator_type": "Path", "max_depth": max_depth}
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_matte"
    return cfg


def _add_spheres(cfg):
    cfg["Aggregate"]["primitives"] += [
        {"primitive_type": "sphere", "material_name": "mat_matte", "radius": 1.3,
         "world_pos": [34.0, 0.8, 0.5]},
        {"primitive_type": "sphere", "material_name": "mat_matte", "radius": 0.8,
         "world_pos": [36.0, -1.2, -1.5], "rotation_axis": [0.0, 1.0, 0.0], "rotation_angle": 30},
    ]
    return cfg


def _area_cfg():
    cfg = _add_spheres(_base_cfg())
    cfg["lights"] = [
        {"light_type": "diffuse", "spectrum": {"values": [40.0, 30.0, 20.0]},
         "light_shape": {"shape_type": "sphere", "radius": 0.5, "world_pos": [33.0, 3.0, 1.0]}},
        # one point light, so that the uniform pick mixes kinds
        {"light_type": "point", "world_pos": [30.0, -2.0, 0.0],
         "spectrum": {"values": [10.0, 10.0, 10.0]}},
    ]
    return cfg


def _furnace_cfg(material="MatteMaterial", sampled=True):
    cfg = _base_cfg()
    unit = {"light_type": "infinite", "l": {"values": [1.0, 1.0, 1.0]}}
    cfg["materials"] = [{"material_type": material, "material_name": "mat_m"}]
    cfg["objs"] = []
    cfg["lights"] = [unit] if sampled else []
    cfg["infinite_lights"] = [unit]
    cfg["Aggregate"] = {"primitives": [{"primitive_type": "sphere", "material_name": "mat_m",
                                        "radius": 1.0}]}
    return cfg


def _bar(l, l_ref, q99=1e-4):
    assert np.isfinite(l).all() and l_ref.max() > 0, "scene renders black: the hold is vacuous"
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    diverged = float((rel.max(-1) > 1e-3).mean())
    assert diverged < 5e-3, f"{diverged:.2%} of rays diverged"
    assert float(np.quantile(rel, 0.99)) < q99, "bulk not bit-level"
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())


def _camera_rays(job, seed):
    cam = JaxCamera(job.camera, job.film, pupil_samples=PUPIL_SAMPLES)
    sampler = JaxStratified(job.sampler, seed=seed)
    n = 64 * 36
    pid = jnp.arange(n, dtype=jnp.uint32)
    px = jnp.stack([(pid % 64) + 0.5, (pid // 64) + 0.5], -1).astype(jnp.float32)
    o, d, w = cam.generate_rays(px, sampler.get_2d(pid, jnp.zeros((n,), jnp.uint32), 1))
    return np.asarray(o), np.asarray(d), np.asarray(w)


def _parallel_rays(seed, n_max, n_pool):
    """tests/test_furnace.py's rays: parallel, down +x, through a disk of
    radius 0.6 around the sphere's centre."""
    rng = np.random.default_rng(seed)
    yz = rng.random((n_pool, 2)) * 1.2 - 0.6
    yz = yz[np.hypot(yz[:, 0], yz[:, 1]) < 0.6][:n_max]
    n = yz.shape[0]
    o = np.concatenate([np.full((n, 1), -5.0), yz], axis=1).astype(np.float32)
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    return o, d, np.ones(n, np.float32)


def _run_both(path, o, d, w, seed, bvh=False):
    """(JAX li_path, JAX li_path_mega interpret, the port's K1 plain version
    on its own packing, on JAX's packing through interop, the port's
    wavefront li_path) on the same rays; the wavefront li_path on JAX's
    SceneCtx through interop is held to JAX's li_path here."""
    jjob = jax_load_scene(path)
    jctx = JaxSceneCtx(jjob.scene)
    assert jpmk.supports(jctx, jjob.integrator, None, None)
    n = o.shape[0]
    pid = np.arange(n, dtype=np.uint32)
    sid = np.zeros(n, np.uint32)
    jargs = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(w),
             JaxStratified(jjob.sampler, seed=seed), jnp.asarray(pid), jnp.asarray(sid),
             jjob.integrator)
    l_ref = np.asarray(jax_li_path(jctx, *jargs))
    jpacked = jpmk.pack_scene(jctx)
    l_jk = np.asarray(jpmk.li_path_mega(jctx, jpacked, *jargs, interpret=True))

    job = load_scene(path)
    sampler = StratifiedSampler(job.sampler, seed=seed)
    assert pmk.unsupported_feature(job.scene, job.integrator, sampler) is None
    T = lambda a: torch.as_tensor(np.array(a))
    args = (T(o), T(d), T(w), T(pid.astype(np.int64)), T(sid.astype(np.int64)), sampler,
            job.integrator)
    packed = pmk.pack_scene(job.scene, "cpu", bvh=bvh)
    assert (packed.bvh is not None) == bvh
    l_k = pmk.li_path_mega(packed, *args).numpy()
    l_i = None
    if not bvh:
        via, _ = from_jax_packed(np.array(jpacked[0]), jpacked[5].lights, None, "cpu",
                                 wide=jpacked[5])
        l_i = pmk.li_path_mega(via, *args).numpy()
    l_w = li_path(SceneCtx.from_scene(job.scene, "cpu"), args[0], args[1], args[2], sampler,
                  args[3], args[4], job.integrator).numpy()
    rgb = [jpmk._env_constant_rgb(e) for e in jctx.infinite_envs]
    ctx = from_jax_scene_ctx(jctx, "cpu", env_rgb=rgb)
    _bar(li_path(ctx, args[0], args[1], args[2], sampler, args[3], args[4],
                 job.integrator).numpy(), l_ref)
    return l_ref, l_jk, l_k, l_i, l_w


@pytest.mark.parametrize("case", ["spheres", "spheres_bvh", "area_light"])
def test_kernel_matches_jax_on_camera_rays(tmp_path, monkeypatch, case):
    """Cubes and two transformed full spheres under the point lights (brute
    force, and over the in-kernel BVH, spheres min-combined with its
    triangle winner), and with a sphere light beside a point light (MIS)."""
    cfg = _area_cfg() if case == "area_light" else _add_spheres(_base_cfg())
    path = _write(tmp_path, cfg)
    bvh = case == "spheres_bvh"
    if bvh:
        monkeypatch.setenv("RS_MEGA_BVH", "force")
    o, d, w = _camera_rays(jax_load_scene(path), 0)
    l_ref, l_jk, l_k, l_i, l_w = _run_both(path, o, d, w, 0, bvh)
    _bar(l_jk, l_ref)
    _bar(l_k, l_jk)
    if l_i is not None:
        _bar(l_i, l_jk)
    _bar(l_w, l_ref)


def test_env_furnace_matches_jax_and_closure(tmp_path):
    """The constant environment (NEE with its BSDF sample of MIS, and the
    escape radiance): K1's plain version matches JAX's kernel, and the
    closure holds: a convex Lambertian sphere of albedo 0.5 under unit
    light reflects 0.5; escaped rays read exactly 1."""
    path = _write(tmp_path, _furnace_cfg())
    o, d, w = _parallel_rays(3, 1536, 4000)
    l_ref, l_jk, l_k, l_i, l_w = _run_both(path, o, d, w, 3)
    for l, ref in ((l_jk, l_ref), (l_k, l_jk), (l_i, l_jk), (l_w, l_ref)):
        _bar(l, ref)
    assert abs(float(l_k.mean()) - 0.5) < 0.02, l_k.mean()
    job = load_scene(path)
    sampler = StratifiedSampler(job.sampler, seed=3)
    n = o.shape[0]
    T = torch.as_tensor
    l_esc = pmk.li_path_mega(pmk.pack_scene(job.scene, "cpu"), T(o), T(-d), T(w),
                             torch.arange(n), torch.zeros(n, dtype=torch.int64), sampler,
                             job.integrator).numpy()
    assert np.allclose(l_esc, 1.0, atol=1e-6)


def test_escape_env_with_mirror_matches_jax(tmp_path):
    """A mirror sphere under an escape-only environment: an escaped ray
    collects it at bounce 0 or after a specular bounce (path.rs:84-87)."""
    path = _write(tmp_path, _furnace_cfg("MirrorMaterial", sampled=False))
    o, d, w = _parallel_rays(5, 1024, 2000)
    l_ref, l_jk, l_k, l_i, l_w = _run_both(path, o, d, w, 5)
    assert l_ref.max() > 0.5  # the mirror reflects the environment
    for l, ref in ((l_jk, l_ref), (l_k, l_jk), (l_i, l_jk), (l_w, l_ref)):
        _bar(l, ref)


def test_wavefront_only_scene_matches_jax(tmp_path):
    """A partial sphere, a distant light and a triangle light: outside K1
    in both packages, the port's wavefront li_path against JAX's on the
    same camera rays, 64x36 x 16 spp, every cube matte."""
    from rs_ray_toy_tpu.camera.realistic import RealisticCamera

    path = write_wavefront_scene(str(tmp_path), xres=64, yres=36, matte=True)
    jjob = jax_load_scene(path)
    jctx = JaxSceneCtx(jjob.scene)
    assert not jpmk.supports(jctx, jjob.integrator, None, None)
    job = load_scene(path)
    sampler = StratifiedSampler(job.sampler, seed=0)
    assert pmk.unsupported_feature(job.scene, job.integrator, sampler) == "partial sphere primitives"
    assert unsupported_feature(job.scene, job.integrator, sampler) is None
    w_, h_ = 64, 36
    pid = np.tile(np.arange(w_ * h_, dtype=np.uint32), 16)
    sid = np.repeat(np.arange(16, dtype=np.uint32), w_ * h_)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    jsampler = JaxStratified(jjob.sampler, seed=0)
    cam = RealisticCamera(jjob.camera, jjob.film, pupil_samples=PUPIL_SAMPLES)
    pxy = jnp.stack([jp % w_, jp // w_], -1).astype(jnp.float32)
    o, d, w = cam.generate_rays(pxy + jsampler.get_2d(jp, js, 0), jsampler.get_2d(jp, js, 1))
    l_ref = np.asarray(jax_li_path(jctx, o, d, w, jsampler, jp, js, jjob.integrator))
    T = lambda a: torch.as_tensor(np.array(a))
    l = li_path(SceneCtx.from_scene(job.scene, "cpu"), T(o), T(d), T(w), sampler,
                T(pid.astype(np.int64)), T(sid.astype(np.int64)), job.integrator).numpy()
    assert (l_ref.max(-1) > 0).sum() >= 500
    _bar(l, l_ref)


def test_render_job_sphere_area_matches_jax(tmp_path):
    """render_job(device="cpu") on samples/scene_sphere_area.json at 64x36
    x 4 spp, every cube matte: the camera instance's plain version against
    the JAX render (its camera kernel, interpret mode), image mean within
    3e-3 relative and 98% of the lit pixels within 1e-3 relative.  With
    the plastic and metal cubes the few glossy rays that diverge set the
    mean's noise at about the bar over 9K rays (tests/test_torch_render.py
    explains it); the glossy fixture is held on the card, against the
    wavefront loop at 160x90x16 (chip_smoke.py phase 8g)."""
    cfg = json.loads((SAMPLES / "scene_sphere_area.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 64, 36
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_matte"
    path = _write(tmp_path, cfg)
    ref = jax_render_job(jax_load_scene(path), spp_override=4, pupil_samples=PUPIL_SAMPLES)
    res = render_job(load_scene(path), "cpu", spp_override=4, pupil_samples=PUPIL_SAMPLES)
    assert res["fused_kernel"] == "path" and res["render_path"] == "plain"
    assert res["camera_rays"] == ref["camera_rays"] == 64 * 36 * 4
    img, ref_img = res["rgb_srgb_input"].numpy(), np.asarray(ref["rgb_srgb_input"])
    assert np.isfinite(img).all() and ref_img.mean() > 0
    assert abs(img.mean() - ref_img.mean()) < 3e-3 * ref_img.mean()
    lit = (img.sum(-1) > 0) | (ref_img.sum(-1) > 0)
    assert lit.sum() > 100
    close = np.all(np.abs(img - ref_img) <= 1e-3 * np.abs(ref_img) + 1e-4, axis=-1)
    assert close[lit].mean() >= 0.98


def test_wavefront_only_scene_renders_through_the_wavefront_loop(tmp_path, capsys):
    """render_job sends the partial-sphere, distant and triangle-light
    scene down the wavefront loop and says so on stderr; the image is lit
    and finite."""
    path = write_wavefront_scene(str(tmp_path), xres=64, yres=36)
    res = render_job(load_scene(path), "cpu", spp_override=1, pupil_samples=PUPIL_SAMPLES)
    err = capsys.readouterr().err
    assert "partial sphere primitives" in err and "wavefront loop" in err
    assert res["render_path"] == "wavefront" and res["fused_kernel"] is None
    img = res["rgb_srgb_input"].numpy()
    assert np.isfinite(img).all() and (img.sum(-1) > 0).sum() >= 20


def test_wavefront_bvh_with_spheres_matches_jax(tmp_path):
    """The wavefront li_path over K3's plain walks (a 6x6 grid of cubes, 456
    triangles) with the fixture's two spheres and sphere light min-combined
    and shaded from the sphere tables, against JAX's li_path on the same
    camera rays, 64x36 x 16 spp, every cube matte."""
    from rs_ray_toy_tpu.camera.realistic import RealisticCamera
    from rs_ray_toy_tpu_torch.scene.gen import write_grid_scene

    cfg = json.loads((SAMPLES / "scene_sphere_area.json").read_text())
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_matte"
    base = _write(tmp_path, cfg)
    path = write_grid_scene(str(tmp_path / "grid"), ny=6, nz=6, xres=64, yres=36, base=base)
    job = load_scene(path)
    ctx = SceneCtx.from_scene(job.scene, "cpu")
    assert ctx.bvh is not None and ctx.sph is not None and job.scene.triangles.count == 456
    jjob = jax_load_scene(path)
    w_, h_ = 64, 36
    pid = np.tile(np.arange(w_ * h_, dtype=np.uint32), 16)
    sid = np.repeat(np.arange(16, dtype=np.uint32), w_ * h_)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    jsampler = JaxStratified(jjob.sampler, seed=0)
    cam = RealisticCamera(jjob.camera, jjob.film, pupil_samples=PUPIL_SAMPLES)
    pxy = jnp.stack([jp % w_, jp // w_], -1).astype(jnp.float32)
    o, d, w = cam.generate_rays(pxy + jsampler.get_2d(jp, js, 0), jsampler.get_2d(jp, js, 1))
    l_ref = np.asarray(jax_li_path(JaxSceneCtx(jjob.scene), o, d, w, jsampler, jp, js,
                                   jjob.integrator))
    T = lambda a: torch.as_tensor(np.array(a))
    l = li_path(ctx, T(o), T(d), T(w), StratifiedSampler(job.sampler, seed=0),
                T(pid.astype(np.int64)), T(sid.astype(np.int64)), job.integrator).numpy()
    assert (l_ref.max(-1) > 0).sum() >= 500
    _bar(l, l_ref)
