"""Scenes the JAX package renders and the port once refused, on the CPU.

- A camera medium outside Volpath: JAX's li_path, li_levels, li_ao and
  SPPM never read it.  samples/scene_fog.json under Path goes through the
  path kernel's plain version and under Debug through the direct kernel's,
  each held per ray against JAX's li_path / li_levels on the same rays at
  the JAX bar (fewer than 0.5% of rays off by more than 1e-3 relative,
  the 99th percentile below 1e-5 (1e-4 for Debug, as
  tests/test_torch_direct.py), means within 3e-3, at least 1,000 lit
  rays); AO and SPPM pick their kernels for it.
- max_depth 0 and above the path kernel's 15: the wavefront li_path
  (no cap, as JAX's li_path) per ray against JAX's li_path on the same
  camera rays, and the route announced on stderr.

The per-ray holds run on the pixels that see the cubes, every cube matte
under Path: the reference's Trowbridge-Reitz sampler makes 1-2% of the
glossy bounces diverge between any two implementations (ROADMAP Queue 3),
which over lit rays alone is the whole 0.5% bar.
- Past 120,000 triangles, and a BVH of 64 levels or more: the BVH
  kernels' plain walk (the deep instances' stack for the deep tree) held
  to a brute-force closest hit on 512 seeded rays; such a tree over more
  than the path kernel's brute-force bound of triangles sends Path to the
  wavefront loop and makes Debug raise, each naming the depth.
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
from rs_ray_toy_tpu.integrators.direct import li_levels as jax_li_levels
from rs_ray_toy_tpu.integrators.path import li_path as jax_li_path
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.accel.bvh import DEEP_STACK, STACK_DEPTH
from rs_ray_toy_tpu_torch.integrators.common import SceneCtx
from rs_ray_toy_tpu_torch.integrators.path import li_path
from rs_ray_toy_tpu_torch.interop import camera_from_jax
from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
from rs_ray_toy_tpu_torch.ops import direct_megakernel as dmk
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.render import WAVEFRONT, make_sampler, render_job, select_kernel
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import write_deep_bvh_scene, write_grid_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
PUPIL_SAMPLES = 1 << 12

# several pytest workers share the host: keep torch's threads few
torch.set_num_threads(min(2, torch.get_num_threads()))


def _bar(l, l_ref, q99=1e-5, lit_min=1000):
    assert np.isfinite(l).all() and l_ref.max() > 0
    assert (l_ref.max(-1) > 0).sum() >= lit_min
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    diverged = float((rel.max(-1) > 1e-3).mean())
    assert diverged < 5e-3, f"{diverged:.2%} of rays diverged"
    assert float(np.quantile(rel, 0.99)) < q99, "bulk not bit-level"
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())


def _variant(tmp, name, w, h, matte=False, **integrator):
    """samples/<name> at w x h, its Integrator block updated; with `matte`
    every primitive in mat_matte."""
    cfg = json.loads((SAMPLES / name).read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = w, h
    cfg["Integrator"] = {**cfg["Integrator"], **integrator}
    if matte:
        for prim in cfg["Aggregate"]["primitives"]:
            prim["material_name"] = "mat_matte"
    shutil.copy(SAMPLES / "cube.obj", tmp)
    path = tmp / name
    path.write_text(json.dumps(cfg))
    return str(path)


def _camera_batch(job, jctx, spp, hits_only):
    """`spp` samples in every pixel of the job's film, or with `hits_only`
    in each pixel whose centre ray (through the lens centre) hits the
    scene, which is mostly black: the JAX sampler, camera, pixel ids,
    sample indices, raster coordinates and rays."""
    w, h = job.film.xres, job.film.yres
    jsampler = JaxStratified(job.sampler, seed=0)
    jcam = JaxCamera(job.camera, job.film, pupil_samples=PUPIL_SAMPLES)
    pix = np.arange(w * h, dtype=np.uint32)
    if hits_only:
        centre = np.stack([pix % w, pix // w], -1).astype(np.float32) + 0.5
        o, d, wt = jcam.generate_rays(jnp.asarray(centre), jnp.full((w * h, 2), 0.5, jnp.float32))
        pix = pix[np.asarray(jctx.intersect(o, d, jnp.where(wt > 0.0, jnp.inf, 0.0)).valid)]
    pid = np.tile(pix, spp)
    sid = np.repeat(np.arange(spp, dtype=np.uint32), pix.size)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    pxy = np.stack([pid % w, pid // w], -1).astype(np.float32)
    o, d, wt = jcam.generate_rays(jnp.asarray(pxy) + jsampler.get_2d(jp, js, 0),
                                  jsampler.get_2d(jp, js, 1))
    return jsampler, jcam, pid, sid, pxy, (o, d, wt)


@pytest.mark.parametrize("integ", ["Path", "Debug"])
def test_camera_medium_is_ignored_outside_volpath(tmp_path, integ):
    """The fog fixture under Path (K1's plain version on JAX's camera rays,
    the rays-in entry, against li_path) and Debug (K2's camera pass
    against li_levels) per ray: 4 samples in each pixel of a 160x90 film
    that sees the cubes (more than 1,000 lit rays)."""
    w, h, spp = 160, 90, 4
    path = _variant(tmp_path, "scene_fog.json", w, h, integ == "Path", integrator_type=integ,
                    max_depth=4)
    job = load_scene(path)
    assert job.scene.camera_medium == 0
    sampler = make_sampler(job)
    fused, mod = select_kernel(job, sampler)[:2]
    assert fused == ("path" if integ == "Path" else "direct")
    jjob = jax_load_scene(path)
    jctx = JaxSceneCtx(jjob.scene)
    jsampler, jcam, pid, sid, pxy, (o, d, wt) = _camera_batch(jjob, jctx, spp, True)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    li = jax_li_path if integ == "Path" else jax_li_levels
    l_ref = np.asarray(li(jctx, o, d, wt, jsampler, jp, js, jjob.integrator))
    l_ref = np.where((np.asarray(wt) > 0)[:, None], l_ref, 0.0)
    packed = pmk.pack_scene(job.scene, "cpu")
    ids = torch.as_tensor(pid.astype(np.int64)), torch.as_tensor(sid.astype(np.int64))
    if integ == "Path":
        t = lambda a: torch.as_tensor(np.array(a))
        l = pmk.li_path_mega(packed, t(o), t(d), t(wt), *ids, sampler, job.integrator).numpy()
        l = np.where((np.asarray(wt) > 0)[:, None], l, 0.0)
    else:
        l, w_ = dmk.li_levels_mega_cam(packed, camera_from_jax(jpmk.pack_camera(jcam)),
                                       torch.as_tensor(pxy), *ids, sampler, job.integrator)
        l = np.where((w_.numpy() > 0)[:, None], l.numpy(), 0.0)
    _bar(l, l_ref, q99=1e-5 if integ == "Path" else 1e-4)


@pytest.mark.parametrize("integ", ["AO", "SPPM"])
def test_ao_and_sppm_take_a_camera_medium(tmp_path, integ):
    """The fog fixture renders under AO (the wavefront loop) and SPPM (its
    kernels' plain versions): 32x18, one sample or iteration."""
    path = _variant(tmp_path, "scene_fog.json", 32, 18, integrator_type=integ, max_depth=3,
                    n_iters=1, photons_per_iter=4096)
    job = load_scene(path)
    assert job.scene.camera_medium == 0
    expect = WAVEFRONT if integ == "AO" else "sppm"
    entry = select_kernel(job, make_sampler(job))
    assert (entry if integ == "AO" else entry[0]) == expect
    res = render_job(job, "cpu", spp_override=1, pupil_samples=PUPIL_SAMPLES)
    img = res["rgb_srgb_input"]
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0


@pytest.mark.parametrize("name,depth", [("scene.json", 0), ("scene_env.json", 0),
                                        ("scene.json", 20)])
def test_wavefront_path_takes_any_max_depth(tmp_path, capsys, name, depth):
    """The route past K1's 1..15, then li_path per ray on JAX's camera
    rays, 4 samples a pixel: at max_depth 20 in each pixel of a 160x90
    film that sees the cubes, at 0 over a whole 32x18 film (only the
    escaped rays of an environment carry radiance there)."""
    (w, h), spp = ((32, 18) if depth == 0 else (160, 90)), 4
    path = _variant(tmp_path, name, w, h, depth > 0, max_depth=depth)
    job = load_scene(path)
    sampler = StratifiedSampler(job.sampler, seed=0)
    assert select_kernel(job, sampler) == WAVEFRONT
    assert f"max_depth {depth}" in capsys.readouterr().err
    jjob = jax_load_scene(path)
    jctx = JaxSceneCtx(jjob.scene)
    jsampler, _, pid, sid, _, (o, d, wt) = _camera_batch(jjob, jctx, spp, depth > 0)
    l_ref = np.asarray(jax_li_path(jctx, o, d, wt, jsampler, jnp.asarray(pid), jnp.asarray(sid),
                                   jjob.integrator))
    t = lambda a: torch.as_tensor(np.array(a))
    l = li_path(SceneCtx.from_scene(job.scene, "cpu"), t(o), t(d), t(wt), sampler,
                t(pid.astype(np.int64)), t(sid.astype(np.int64)), job.integrator).numpy()
    if name == "scene.json" and depth == 0:
        assert not l.any() and not l_ref.any()
    else:
        _bar(l, l_ref)


def _closest_vs_brute(tri, tables, o, d):
    """The BVH kernels' plain walk against a brute-force closest hit
    (PlainGeometry without a BVH) on the rays o, d."""
    t, idx, valid = bk.intersect_bvh(tables, o, d, torch.full((o.shape[0],), torch.inf))
    brute = pmk.PlainGeometry(pmk.PackedScene(
        table=torch.as_tensor(np.concatenate([tri.p0, tri.p1 - tri.p0, tri.p2 - tri.p0], 1)),
        light_p=(), light_emit=()), "cpu")
    t_b, row_b = brute.closest(*o.unbind(-1), *d.unbind(-1), torch.ones(o.shape[0], dtype=bool))
    hit_b = row_b >= 0
    assert torch.equal(valid, hit_b)
    assert int(hit_b.sum()) > 100
    assert torch.equal(t[valid], t_b[hit_b])
    # an exact tie at a shared edge may pick the other triangle
    same = idx[valid] == row_b[hit_b]
    assert float(same.float().mean()) > 0.99


def _seeded_rays(n, target, spread, seed):
    rng = np.random.default_rng(seed)
    aim = target + rng.uniform(-1.0, 1.0, (n, 3)) * spread
    o = np.zeros((n, 3)) + rng.uniform(-0.1, 0.1, (n, 3))
    d = aim - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(o, dtype=torch.float32), torch.as_tensor(d, dtype=torch.float32)


def test_bvh_past_120000_triangles(tmp_path):
    """A 112x112 grid of cubes (150,552 triangles) packs for the BVH
    kernels and its walk finds the brute-force closest hit; AO and Path
    (past K1, announced) route to the wavefront loop over it."""
    path = write_grid_scene(str(tmp_path), ny=112, nz=112, xres=32, yres=18)
    job = load_scene(path)
    tri = job.scene.triangles
    assert tri.count == 150_552
    assert select_kernel(job, make_sampler(job)) == WAVEFRONT
    job.integrator.kind = "ao"
    assert select_kernel(job, make_sampler(job)) == WAVEFRONT
    tables = bk.pack_bvh(tri, "cpu")
    assert tables.stack == STACK_DEPTH
    o, d = _seeded_rays(512, np.array([35.2, 0.0, 0.0]), np.array([0.5, 3.0, 2.0]), 7)
    _closest_vs_brute(tri, tables, o, d)


def test_bvh_deeper_than_the_stack(tmp_path):
    """write_deep_bvh_scene's tree has 97 levels: the deep instances'
    stack, and the walk finds the brute-force closest hit."""
    job = load_scene(write_deep_bvh_scene(str(tmp_path)))
    tri = job.scene.triangles
    tables = bk.pack_bvh(tri, "cpu")
    assert STACK_DEPTH <= tables.depth < DEEP_STACK
    assert tables.stack == DEEP_STACK
    assert select_kernel(job, make_sampler(job)) == WAVEFRONT
    o, d = _seeded_rays(512, np.array([35.0, 0.0, 0.0]), np.array([1.0, 1.0, 1.0]), 3)
    _closest_vs_brute(tri, tables, o, d)


@pytest.mark.parametrize("integ", ["Path", "Debug"])
def test_deep_bvh_past_the_brute_force_bound(tmp_path, capsys, integ):
    """A tree of 64 levels or more over more than TRI_MAX triangles, the
    fused kernels' BVH range: their 64-entry stack cannot walk it, so Path
    and Debug go to the wavefront loop (announced, naming the depth) and
    render there over the deep instances' walk."""
    path = write_deep_bvh_scene(str(tmp_path), integrator=integ, n_bulk=2000, xres=32, yres=18)
    job = load_scene(path)
    assert job.scene.triangles.count > pmk.TRI_MAX
    sampler = make_sampler(job)
    assert select_kernel(job, sampler) == WAVEFRONT
    assert "a BVH of depth" in capsys.readouterr().err
    assert bk.pack_bvh(job.scene.triangles, "cpu").stack == DEEP_STACK
    res = render_job(job, "cpu", spp_override=1, pupil_samples=PUPIL_SAMPLES)
    assert res["render_path"] == "wavefront"
    img = res["rgb_srgb_input"]
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0
