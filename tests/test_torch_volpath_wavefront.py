"""The wavefront Volpath loop (integrators/volpath.li_volpath) against the
JAX package's `li_volpath`, its loader and its route, on the CPU.

- Loader parity: the interface scene (`write_interface_scene`: the fog
  fixture's first cube smooth glass holding a homogeneous medium, the
  bench's sphere light among the cubes) with a sphere and its own
  interface added: the medium list in the JAX loader's order (the
  aggregate's, then the camera's), each medium's coefficients, and every
  triangle's and sphere's med_in / med_out equal to JAX's.
- Per ray, on JAX's camera rays of a 64x36 film at 16 samples a pixel and
  identical scene tables (interop.from_jax_scene_ctx), the port's
  li_volpath against JAX's li_volpath, every scene at max_depth 3:
  Volpath in vacuum (the sphere-area fixture: spheres, a sphere light,
  no medium), the interface scene, the camera fog with the sphere light
  and the fixture's spheres, the 8^3 grid plume under the sphere light,
  and the fog under a HaltonSampler.  Every other cube is matte: the
  fixture's glossy cubes make some lanes chaotic (the reference's
  Trowbridge-Reitz sampler, ROADMAP Queue 3).  The bar of
  tests/test_torch_volpath.py: under 0.5% of rays off by more than 1e-3
  relative, the 99th percentile below 1e-5, means within 3e-3.  JAX's
  loop runs eagerly: each call re-traces and compiles its while loops
  (~2 s a bounce here), so the cases share one ray count (the eager
  ops' compiled shapes then serve every case) and a shallow depth.
- The port's own tables (SceneCtx.from_scene) give the same radiance as
  the carried ones on the interface scene.
- The interface scene's first cube as a 6x6 grid of glass cubes (456
  triangles): the loop over K3's plain walks on the port's BVH against
  the same loop over K4's brute force, at the same bar, so that the
  BVH's hit index is the scene-order row the interface ids are read at.
- render_job of the interface scene at 64x36x16 (one pass, the loop over
  K4's plain version, announced on stderr) against the JAX pipeline of
  render_job's compute_pass on the same samples (its camera rays, its
  li_volpath and its film's add), at the image bars of
  tests/test_torch_render.py.  JAX's render_job itself jit-compiles the
  whole loop, 46 s for this scene on the CPU, so its pass is assembled
  from the same functions here.
- The Volpath kernel's gate names "medium_interface"; SPPM ignores the
  interfaces, as the JAX package's SPPM does.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.film import film as jax_film
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.integrators.common import scrub_radiance as jax_scrub
from rs_ray_toy_tpu.integrators.volpath import li_volpath as jax_li_volpath
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.sampler.halton import HaltonSampler as JaxHalton
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
from rs_ray_toy_tpu_torch.integrators import common
from rs_ray_toy_tpu_torch.integrators.common import SceneCtx
from rs_ray_toy_tpu_torch.integrators.volpath import li_volpath, unsupported_feature
from rs_ray_toy_tpu_torch.interop import from_jax_scene_ctx, sampler_from_jax
from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk
from rs_ray_toy_tpu_torch.ops import volpath_megakernel as vmk
from rs_ray_toy_tpu_torch.render import (
    WAVEFRONT,
    camera_rays,
    make_sampler,
    render_job,
    sample_batch,
    select_kernel,
)
from rs_ray_toy_tpu_torch.sampler.halton import HaltonSampler
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import (
    FOG_AREA_LIGHT,
    THIN_FOG,
    write_fog_scene,
    write_grid_fog_scene,
    write_grid_scene,
    write_interface_scene,
    write_variant,
)
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
PUPIL_SAMPLES = 1 << 12
W, H = 64, 36

torch.set_num_threads(min(2, torch.get_num_threads()))


def _edit(path, fn):
    cfg = json.loads(Path(path).read_text())
    fn(cfg)
    Path(path).write_text(json.dumps(cfg))
    return path


def _matte(keep_first=False):
    """Every cube matte (but the first, with keep_first)."""
    def fn(cfg):
        for k, prim in enumerate(cfg["Aggregate"]["primitives"]):
            if prim["primitive_type"] == "triangle" and not (keep_first and k == 0):
                prim["material_name"] = "mat_matte"
    return fn


SPP, DEPTH = 16, 3


def _shallow(cfg):
    cfg["Integrator"]["max_depth"] = DEPTH


def _vacuum(out):
    path = write_variant(str(SAMPLES / "scene_sphere_area.json"), out, W, H)
    return _edit(path, lambda cfg: (cfg.update(Integrator={"integrator_type": "Volpath",
                                                           "max_depth": DEPTH}), _matte()(cfg)))


def _interface(out):
    return _edit(write_interface_scene(out, xres=W, yres=H),
                 lambda cfg: (_matte(keep_first=True)(cfg), _shallow(cfg)))


def _fog_spheres(out):
    path = write_fog_scene(out, area_light=True, base=str(SAMPLES / "scene_sphere_area.json"),
                           medium=THIN_FOG, xres=W, yres=H)
    return _edit(path, lambda cfg: (_matte()(cfg), _shallow(cfg)))


def _plume(out):
    path = write_grid_fog_scene(out, n=8, xres=W, yres=H, max_depth=DEPTH, sigma_scale=0.6)
    return _edit(path, lambda cfg: (cfg["lights"].append(FOG_AREA_LIGHT), _matte()(cfg)))


def _halton(out):
    path = write_variant(str(SAMPLES / "scene_fog.json"), out, W, H,
                         {"sampler_type": "HaltonSampler", "nsamp": SPP})
    return _edit(path, lambda cfg: (_matte()(cfg), _shallow(cfg)))


def _interface_bvh(out):
    path = write_grid_scene(out, ny=6, nz=6, base=_interface(str(Path(out) / "base")),
                            integrator="Volpath", max_depth=DEPTH, xres=W, yres=H)
    return _edit(path, _matte(keep_first=True))


# the cases held against JAX's li_volpath, each at SPP samples a pixel
CASES = {
    "vacuum": _vacuum,
    "interface": _interface,
    "fog-spheres-sphere-light": _fog_spheres,
    "grid-plume-sphere-light": _plume,
    "halton": _halton,
}


def _jax_sampler(job):
    if job.sampler.kind == "halton":
        js = JaxHalton(job.sampler, job.film.xres, job.film.yres, seed=0)
        return js, sampler_from_jax(js, job.film.xres, job.film.yres)
    return JaxStratified(job.sampler, seed=0), None


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """traced(case): the scene of a case and JAX's li_volpath on its
    camera rays (every sample of every pixel, sample-outer), made once."""
    made = {}

    def get(case):
        if case not in made:
            spp = SPP
            path = CASES[case](str(tmp_path_factory.mktemp(case)))
            job = jax_load_scene(path)
            jctx = JaxSceneCtx(job.scene)
            jsampler, sampler = _jax_sampler(job)
            w_, h_ = job.film.xres, job.film.yres
            pid = np.tile(np.arange(w_ * h_, dtype=np.uint32), spp)
            sid = np.repeat(np.arange(spp, dtype=np.uint32), w_ * h_)
            jp, js = jnp.asarray(pid), jnp.asarray(sid)
            pxy = jnp.stack([jp % w_, jp // w_], -1).astype(jnp.float32)
            p_film = pxy + jsampler.get_2d(jp, js, 0)
            cam = JaxCamera(job.camera, job.film, pupil_samples=PUPIL_SAMPLES)
            o, d, w = cam.generate_rays(p_film, jsampler.get_2d(jp, js, 1))
            l_ref = jax_li_volpath(jctx, o, d, w, jsampler, jp, js, job.integrator,
                                   camera_medium=jctx.camera_medium)
            made[case] = dict(path=path, job=job, jctx=jctx, sampler=sampler, pid=pid, sid=sid,
                              o=o, d=d, w=w, p_film=p_film, l_ref=l_ref)
        return made[case]

    return get


def _bar(l, l_ref, min_lit=200):
    assert np.isfinite(l).all() and l_ref.max() > 0
    assert (l_ref.max(-1) > 0).sum() >= min_lit
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    diverged = float((rel.max(-1) > 1e-3).mean())
    assert diverged < 5e-3, f"{diverged:.2%} of rays diverged"
    assert float(np.quantile(rel, 0.99)) < 1e-5, "bulk not bit-level"
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())


def _port_li(r, ctx):
    pjob = load_scene(r["path"])
    sampler = r["sampler"] or StratifiedSampler(pjob.sampler, seed=0)
    assert unsupported_feature(pjob.scene, pjob.integrator, sampler) is None
    T = lambda a: torch.as_tensor(np.array(a))
    return li_volpath(ctx, T(r["o"]), T(r["d"]), T(r["w"]), sampler,
                      T(r["pid"].astype(np.int64)), T(r["sid"].astype(np.int64)),
                      pjob.integrator).numpy()


def _port_rays(job, spp):
    """The port's camera rays of every sample of `job` (sample-outer)."""
    sampler = StratifiedSampler(job.sampler, seed=0)
    pxy, pid, soff = sample_batch(job.film, spp, "cpu")
    cam = RealisticCamera(job.camera, job.film, pupil_samples=PUPIL_SAMPLES, device="cpu")
    o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
    return dict(o=o, d=d, w=w, sampler=sampler, pid=pid, soff=soff)


def test_loader_media_match_jax(tmp_path):
    def add_sphere(cfg):
        cfg["Aggregate"]["primitives"].append(
            {"primitive_type": "sphere", "material_name": "mat_matte", "radius": 0.7,
             "world_pos": [34.0, 0.8, 0.5],
             "medium_interface": {"inside": {"medium_type": "Homogeneous", "preset": "Skin1"},
                                  "outside": dict(THIN_FOG)}})
        # a primitive skipped for its material still appends its media
        cfg["Aggregate"]["primitives"].append(
            {"primitive_type": "sphere", "material_name": "nope",
             "medium_interface": {"outside": {"medium_type": "Homogeneous"}}})

    path = _edit(write_interface_scene(str(tmp_path), area_light=True), add_sphere)
    job, jjob = load_scene(path), jax_load_scene(path)
    ours, theirs = job.scene, jjob.scene
    assert len(ours.mediums) == len(theirs.mediums) == 5
    assert ours.camera_medium == theirs.camera_medium == 4
    for a, b in zip(ours.mediums, theirs.mediums):
        assert a.kind == b.kind and a.g == b.g
        np.testing.assert_array_equal(a.sigma_a, b.sigma_a)
        np.testing.assert_array_equal(a.sigma_s, b.sigma_s)
    for soa, jsoa in ((ours.triangles, theirs.triangles), (ours.spheres, theirs.spheres)):
        np.testing.assert_array_equal(soa.med_in, np.asarray(jsoa.med_in))
        np.testing.assert_array_equal(soa.med_out, np.asarray(jsoa.med_out))
    assert (ours.triangles.med_in[:12] == 0).all() and (ours.triangles.med_in[12:] == -1).all()
    assert ours.spheres.med_in.tolist() == [1] and ours.spheres.med_out.tolist() == [2]


@pytest.mark.parametrize("case", list(CASES))
def test_li_volpath_matches_jax(traced, case):
    r = traced(case)
    jctx = r["jctx"]
    rgb = [jpmk._env_constant_rgb(e) for e in jctx.infinite_envs]
    ctx = from_jax_scene_ctx(jctx, "cpu", env_rgb=rgb)
    own = SceneCtx.from_scene(load_scene(r["path"]).scene, "cpu")
    assert own.bvh is None
    assert (own.prim_media is not None) == (case == "interface")
    assert (own.mediums is None) == (case == "vacuum")
    l_ref = np.where((np.asarray(r["w"]) > 0)[:, None], np.asarray(r["l_ref"]), 0.0)
    l = _port_li(r, ctx)
    _bar(l, l_ref)
    if case == "interface":
        np.testing.assert_array_equal(_port_li(r, own), l)


def test_bvh_hits_read_scene_order_interfaces(tmp_path, monkeypatch):
    """456 triangles, 36 of them glass cubes holding a medium: the loop
    over the port's BVH (K3's plain walks) against the loop over brute
    force (K4's), on the same camera rays."""
    job = load_scene(_interface_bvh(str(tmp_path)))
    assert job.scene.triangles.count == 456
    bvh = SceneCtx.from_scene(job.scene, "cpu")
    monkeypatch.setattr(common, "BRUTE_FORCE_CUTOFF", job.scene.triangles.count)
    brute = SceneCtx.from_scene(job.scene, "cpu")
    assert bvh.bvh is not None and brute.bvh is None and bvh.prim_media is not None
    r = _port_rays(job, 4)
    args = (r["o"], r["d"], r["w"], r["sampler"], r["pid"], r["soff"], job.integrator)
    live = (r["w"] > 0)[:, None]
    l_ref = torch.where(live, li_volpath(brute, *args), 0.0).numpy()
    _bar(torch.where(live, li_volpath(bvh, *args), 0.0).numpy(), l_ref)


def test_render_job_matches_jax(traced, capsys):
    """The interface scene's render on the CPU against JAX's compute_pass
    pipeline on the same samples (one pass of SPP)."""
    r = traced("interface")
    job = load_scene(r["path"])
    res = render_job(job, "cpu", pupil_samples=PUPIL_SAMPLES)
    err = capsys.readouterr().err
    assert "volpath-kernel subset (per-primitive media interfaces (medium_interface))" in err
    assert "wavefront loop" in err
    assert res["render_path"] == "wavefront" and res["passes"] == 1 and not res["bvh"]
    assert res["camera_rays"] == W * H * SPP
    jjob = r["job"]
    wgt = r["w"]
    l = jnp.where((wgt > 0.0)[:, None], jax_scrub(r["l_ref"]), 0.0)
    film = jax_film.add_samples(jax_film.make_film(jjob.film), jjob.film, r["p_film"], l, wgt,
                                aligned=True)
    ref_img = np.asarray(jax_film.to_rgb(film, jjob.film))
    img = res["rgb_srgb_input"].numpy()
    assert img.shape == ref_img.shape == (H, W, 3)
    assert np.isfinite(img).all() and ref_img.mean() > 0
    assert abs(img.mean() - ref_img.mean()) < 3e-3 * ref_img.mean()
    lit = (img.sum(-1) > 0) | (ref_img.sum(-1) > 0)
    assert lit.sum() > 0.5 * W * H  # the fog scatters light into the frame
    close = np.all(np.abs(img - ref_img) <= 1e-3 * np.abs(ref_img) + 1e-4, axis=-1)
    assert close[lit].mean() >= 0.98


def test_halton_is_taken_under_volpath(traced):
    job = load_scene(traced("halton")["path"])
    sampler = make_sampler(job)
    assert isinstance(sampler, HaltonSampler)
    assert select_kernel(job, sampler) == WAVEFRONT


def test_kernel_gates(tmp_path):
    """K6 names the interfaces; the SPPM kernels ignore them."""
    job = load_scene(write_interface_scene(str(tmp_path)))
    sampler = make_sampler(job)
    assert vmk.unsupported_feature(job.scene, job.integrator, sampler) == (
        "per-primitive media interfaces (medium_interface)")
    job.integrator.kind = "sppm"
    job.integrator.max_depth = 3
    assert smk.unsupported_feature(job.scene, job.integrator) is None
