"""The Burley BSSRDF of a subsurface DisneyMaterial (scatter_distance) in the
port, against the JAX package on the CPU.

- (a) fresnel_moment1, sr_profile, sample_sr, pdf_sr and sw_f against JAX
  bsdf/bssrdf on 4,096 seeded inputs, rtol 1e-6.
- (b) Packed material tables equal JAX's, array for array (the BSSRDF
  columns has_bssrdf, bssrdf_R, bssrdf_d and bssrdf_eta among them), for
  the bench's mat_sss, a Mix of mat_sss and matte (its specular
  transmission lobe scaled, no BSSRDF) and a thin Disney material with a
  scatter distance (no BSSRDF).
- (c) sample_bssrdf against JAX's on the one-cube scene of
  tests/test_bssrdf.py:86-113 rebuilt from samples/cube.obj (a cube of
  half-width 6 in mat_sss, entry points on its top face): valid equal on
  99% of the lanes and, on 99% of the lanes valid in both, the exit point,
  Sp and pdf at rtol 1e-5 (a probe chord grazing an edge can take another
  face on a last-bit difference).
- (d) The path kernel's plain version on samples/scene_sss.json,
  stratified and Halton, brute force and over the BVH, against JAX
  li_path at max_depth 5 at 160x90, on every sample of the pixels whose
  centre ray hits the scene (the scene is mostly black; at least 1,000
  lit rays), and against JAX li_path_mega in interpret mode
  (RS_MEGA_CULL=0: the JAX package's cull chunks crash on this scene,
  ROADMAP Queue 3) at max_depth 2 over the whole 64x36 film, the shape
  of JAX's own test: JAX's own bar (tests/test_megakernel.py:472-519),
  under 0.5% of rays off by more than 1e-3 relative, means within 3e-3,
  l_ref.sum() > 10.  Its sampler slots equal JAX's _used_slots with the
  subsurface slots.
- (e) The wavefront li_path against JAX li_path on
  samples/scene_sss_mixed.json (brute force) and its 6x6 grid (over the
  BVH), on the same pixels, at the same bar.
- (f) The routes: scene_sss.json takes the path kernel, scene_sss_mixed
  the wavefront loop (announced on stderr); Debug, DirectLighting,
  Volpath and SPPM on mat_sss raise naming specular transmission
  (DisneyMaterial scatter_distance BSSRDF); AO on scene_sss.json loads
  and renders.
"""

import functools
import json
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.accel.bvh import build_bvh as jax_build_bvh
from rs_ray_toy_tpu.bsdf import bssrdf as jbss
from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.integrators.path import li_path as jax_li_path
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.ops.bvh_pallas import pack_bvh_tables
from rs_ray_toy_tpu.sampler.halton import HaltonSampler as JaxHalton
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import SamplerSpec as JaxSamplerSpec
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu.scene.types import empty_spheres
from rs_ray_toy_tpu_torch.bsdf import bssrdf as bss
from rs_ray_toy_tpu_torch.bsdf.lobes import LOBE_SPEC_TRANS
from rs_ray_toy_tpu_torch.integrators.common import SceneCtx
from rs_ray_toy_tpu_torch.integrators.path import li_path
from rs_ray_toy_tpu_torch.interop import from_jax_scene_ctx, sampler_from_jax
from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.render import (
    FUSED,
    WAVEFRONT,
    make_sampler,
    render_job,
    select_kernel,
)
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import write_grid_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene
from tests.test_torch_disney import TABLE_KEYS, _with_materials, _write

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
SSS = SAMPLES / "scene_sss.json"
SSS_MIXED = SAMPLES / "scene_sss_mixed.json"
MAT_SSS = next(m for m in json.loads(SSS.read_text())["materials"]
               if m["material_name"] == "mat_sss")
BSS_KEYS = ("has_bssrdf", "bssrdf_R", "bssrdf_d", "bssrdf_eta")
FILM = (160, 90)  # the parity batches: every sample of the pixels that see the scene
JAX_FILM = (64, 36)  # the whole film, as JAX's own test holds its kernel
T = lambda a: torch.as_tensor(np.array(a))

torch.set_num_threads(min(2, torch.get_num_threads()))


# ---- (a) the profile functions ----


def _inputs(n=4096, seed=5):
    r = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    return dict(
        eta=f32(r.uniform(0.4, 2.5, n)),
        R=f32(r.uniform(0.0, 1.0, (n, 3))),
        d=f32(r.uniform(0.05, 2.0, (n, 3))),
        # radii past the profile's tail, and some below the 1e-6 clamp
        r=f32(np.where(r.random(n) < 0.05, r.uniform(0.0, 2e-6, n), r.uniform(0.0, 6.0, n))),
        u=f32(r.uniform(0.0, 1.0, n)),
        cos=f32(r.uniform(-1.0, 1.0, n)),
    )


@pytest.mark.parametrize("fn", ["fresnel_moment1", "sr_profile", "sample_sr", "pdf_sr", "sw_f"])
def test_profile_functions_match_jax(fn):
    x = _inputs()
    args = {
        "fresnel_moment1": ("eta",),
        "sr_profile": ("R", "d", "r"),
        "sample_sr": ("d", "u"),
        "pdf_sr": ("d", "r"),
        "sw_f": ("eta", "cos"),
    }[fn]
    vals = [x[k][:, 0] if k == "d" and fn in ("sample_sr", "pdf_sr") else x[k] for k in args]
    ours = getattr(bss, fn)(*(torch.as_tensor(v) for v in vals)).numpy()
    theirs = np.asarray(getattr(jbss, fn)(*(jnp.asarray(v) for v in vals)))
    assert ours.shape == theirs.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)


# ---- (b) material tables ----


TABLE_CASES = {
    "mat_sss": [MAT_SSS],
    "mix_sss_matte": [MAT_SSS, {"material_type": "MixMaterial", "material_name": "mat_mix_sss",
                                "mat1": "mat_sss", "mat2": "mat_matte",
                                "scale": {"values": [0.3, 0.5, 0.7]}}],
    "thin_with_scatter_distance": [{**MAT_SSS, "material_name": "mat_thin", "thin": True}],
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_material_tables_equal_jax(tmp_path, case):
    path = _write(tmp_path, _with_materials(TABLE_CASES[case]))
    ours, theirs = load_scene(path).scene.materials, jax_load_scene(path).scene.materials
    for key in TABLE_KEYS + BSS_KEYS:
        np.testing.assert_array_equal(ours[key], np.asarray(theirs[key]), err_msg=key)
    assert bool(ours["has_bssrdf"][-1]) == (case == "mat_sss")
    assert LOBE_SPEC_TRANS in ours["kind"][-1][: ours["n_lobes"][-1]] or case.startswith("thin")


# ---- (c) the probe chain ----


def _one_cube(tmp_path, scale=6.0):
    """tests/test_bssrdf.py's scene: one cube of half-width `scale` at the
    origin in mat_sss, from samples/cube.obj."""
    cfg = json.loads((SAMPLES / "scene.json").read_text())
    cfg["materials"] = [MAT_SSS]
    cfg["Aggregate"]["primitives"] = [{
        "primitive_type": "triangle", "material_name": "mat_sss", "obj_name": "cube",
        "instances": [{"world_pos": [0.0, 0.0, 0.0], "scale": [scale] * 3}],
    }]
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    path = tmp_path / "cube.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_sample_bssrdf_matches_jax(tmp_path):
    path = _one_cube(tmp_path)
    jctx = JaxSceneCtx(jax_load_scene(path).scene)
    ctx = SceneCtx.from_scene(load_scene(path).scene, "cpu")
    assert ctx.bssrdf is not None and bool(ctx.bssrdf["has"].all())
    n = 4096
    rng = np.random.default_rng(1)
    o = np.stack([rng.uniform(-3.0, 3.0, n), np.full(n, 12.0), rng.uniform(-3.0, 3.0, n)],
                 -1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    u1 = rng.uniform(size=n).astype(np.float32)
    u2 = rng.uniform(size=(n, 2)).astype(np.float32)

    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jhit = jctx.intersect(jo, jd, jnp.full((n,), 1e9, jnp.float32))
    jsi = jctx.surface(jhit, jo, jd)
    ref = jbss.sample_bssrdf(jctx, jsi, jctx.frame(jsi), jnp.asarray(u1), jnp.asarray(u2))
    hit = ctx.intersect(T(o), T(d), torch.full((n,), 1e9))
    si = ctx.surface(hit, T(o), T(d))
    assert bool(hit.valid.all())
    got = bss.sample_bssrdf(ctx, si, ctx.frame(si), T(u1), T(u2))

    valid, jvalid = got.valid.numpy(), np.asarray(ref.valid)
    assert jvalid.mean() > 0.4
    assert (valid == jvalid).mean() >= 0.99
    both = valid & jvalid
    same = np.ones(n, bool)
    for ours, theirs in ((got.pi.p, ref.pi.p), (got.sp, ref.sp), (got.pdf, ref.pdf)):
        ours, theirs = ours.numpy(), np.asarray(theirs)
        close = np.isclose(ours, theirs, rtol=1e-5, atol=1e-6)
        same &= close.all(-1) if close.ndim > 1 else close
    assert same[both].mean() >= 0.99, same[both].mean()
    # every exit lies on the cube's surface and keeps the material
    p_exit = got.pi.p.numpy()[valid]
    assert np.abs(np.abs(p_exit).max(1) - 6.0).max() < 1e-3
    assert bool((got.pi.mat[got.valid] == si.mat[got.valid]).all())


# ---- (d) the path kernel's plain version ----


def _bar(l, l_ref, min_lit=1000):
    """JAX's own bar (tests/test_megakernel.py:509-519), on at least
    `min_lit` lit rays."""
    assert np.isfinite(l).all()
    assert l_ref.sum() > 10, "the subsurface scene is lit"
    lit = int((l_ref.max(-1) > 0).sum())
    assert lit >= min_lit, f"{lit} lit rays"
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    diverged = float((rel.max(-1) > 1e-3).mean())
    assert diverged < 5e-3, f"{diverged:.2%} of rays diverged"
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())


@pytest.mark.parametrize("max_depth", [1, 5])
@pytest.mark.parametrize("n_lights", [0, 3])
def test_used_slots_match_jax(max_depth, n_lights):
    slots = pmk.used_slots(max_depth, n_lights, n_lights > 0, False, True, True)
    assert slots == jpmk._used_slots(max_depth, n_lights, n_lights > 0, False, True, True)
    assert max(s for s, _ in slots) < pmk.SLOT_MAX


def _camera_batch(jjob, jctx, jsampler, spp, whole=False):
    """JAX camera rays of `spp` samples in each pixel of the job's film
    whose centre ray (through the lens centre) hits the scene, the scene
    being mostly black, or with `whole` in every pixel: (rays, pixel ids,
    sample indices)."""
    w_, h_ = jjob.film.xres, jjob.film.yres
    cam = JaxCamera(jjob.camera, jjob.film, pupil_samples=1 << 10)
    pix = np.arange(w_ * h_, dtype=np.uint32)
    if not whole:
        every = jnp.asarray(pix)
        centre = jnp.stack([every % w_, every // w_], -1).astype(jnp.float32) + 0.5
        o, d, w = cam.generate_rays(centre, jnp.full((w_ * h_, 2), 0.5, jnp.float32))
        pix = pix[np.asarray(jctx.intersect(o, d, jnp.where(w > 0.0, jnp.inf, 0.0)).valid)]
    pid = np.tile(pix, spp)
    sid = np.repeat(np.arange(spp, dtype=np.uint32), pix.size)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    pxy = jnp.stack([jp % w_, jp // w_], -1).astype(jnp.float32)
    rays = cam.generate_rays(pxy + jsampler.get_2d(jp, js, 0), jsampler.get_2d(jp, js, 1))
    return rays, pid, sid


def _sss_sampler(jjob, halton):
    if halton:
        return JaxHalton(JaxSamplerSpec(kind="halton", nsamp=6), jjob.film.xres,
                         jjob.film.yres, seed=0)
    return JaxStratified(jjob.sampler, seed=0)


@functools.lru_cache(maxsize=None)
def _sss_batch(halton, whole):
    """_camera_batch of scene_sss.json, at JAX_FILM over the whole film or
    at FILM over the pixels that see the scene: 8 stratified samples, or
    all 6 of a 6-sample HaltonSampler (the camera and the geometry do not
    depend on max_depth, so each batch is made once)."""
    jjob = jax_load_scene(str(SSS))
    jjob.film.xres, jjob.film.yres = JAX_FILM if whole else FILM
    return _camera_batch(jjob, JaxSceneCtx(jjob.scene), _sss_sampler(jjob, halton),
                         6 if halton else 8, whole)


def _sss_rays(tmp_path, halton, max_depth, whole=False):
    """scene_sss.json with `max_depth` at _sss_batch's film: (path, JAX
    job, JAX sampler, _sss_batch's rays, pixel ids, sample indices)."""
    def edit(cfg):
        cfg.update(json.loads(SSS.read_text()))
        cfg["Film"]["xres"], cfg["Film"]["yres"] = JAX_FILM if whole else FILM
        cfg["Integrator"]["max_depth"] = max_depth
        if halton:
            cfg["Sampler"] = {"sampler_type": "HaltonSampler", "nsamp": 6}

    tmp_path.mkdir()
    path = _write(tmp_path, edit)
    jjob = jax_load_scene(path)
    rays, pid, sid = _sss_batch(halton, whole)
    return path, jjob, _sss_sampler(jjob, halton), rays, pid, sid


def _port_k1(path, jsampler, rays, pid, sid, bvh):
    job = load_scene(path)
    sampler = (sampler_from_jax(jsampler, job.film.xres, job.film.yres)
               if isinstance(jsampler, JaxHalton) else StratifiedSampler(job.sampler, seed=0))
    assert pmk.unsupported_feature(job.scene, job.integrator, sampler) is None
    packed = pmk.pack_scene(job.scene, "cpu", bvh=bvh)
    assert packed.bssrdf is not None and (packed.bvh is not None) == bvh
    return pmk.li_path_mega(packed, *(T(r) for r in rays), T(pid.astype(np.int64)),
                            T(sid.astype(np.int64)), sampler, job.integrator).numpy()


@pytest.mark.parametrize("halton", [False, True], ids=["stratified", "halton"])
def test_path_kernel_plain_version_matches_jax_li_path(tmp_path, halton):
    """Brute force and over the BVH, at the fixture's max_depth 5."""
    path, jjob, jsampler, rays, pid, sid = _sss_rays(tmp_path / "d5", halton, 5)
    jctx = JaxSceneCtx(jjob.scene)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    l_ref = np.asarray(jax_li_path(jctx, *rays, jsampler, jp, js, jjob.integrator))
    for bvh in (False, True):
        _bar(_port_k1(path, jsampler, rays, pid, sid, bvh), l_ref)


@pytest.mark.parametrize("halton", [False, True], ids=["stratified", "halton"])
def test_path_kernel_plain_version_matches_the_jax_kernel(tmp_path, monkeypatch, halton):
    """JAX's kernel in interpret mode (RS_MEGA_CULL=0) at max_depth 2: two
    vertices already run the probe chain, the exit's NEE and the exit
    direction, and its interpreted trace grows with the depth.  Its BVH
    body (RS_MEGA_BVH=force) takes minutes to interpret whatever the
    rays, so the port's BVH walk is held to the same JAX kernel through
    its brute-force twin: the two plain versions agree bit for bit here,
    as they must with no tie between triangles.  This case keeps the
    shape of JAX's own test, the whole 64x36 film (a few hundred lit
    rays): over the pixels that see the scene JAX's kernel and JAX's
    li_path themselves part on about the bar's 0.5% of the rays (the TR
    sampler, ROADMAP Queue 3)."""
    monkeypatch.setenv("RS_MEGA_CULL", "0")
    path, jjob, jsampler, rays, pid, sid = _sss_rays(tmp_path / "d2", halton, 2, whole=True)
    jctx = JaxSceneCtx(jjob.scene)
    assert jpmk.supports(jctx, jjob.integrator, jsampler, None)
    jpacked = jpmk.pack_scene(jctx)
    assert jpacked[5].bssrdf is not None and jpacked[6] is None
    l_jk = np.asarray(jpmk.li_path_mega(jctx, jpacked, *rays, jsampler, jnp.asarray(pid),
                                        jnp.asarray(sid), jjob.integrator, interpret=True))
    l = _port_k1(path, jsampler, rays, pid, sid, False)
    _bar(l, l_jk, min_lit=0)
    np.testing.assert_array_equal(_port_k1(path, jsampler, rays, pid, sid, True), l)


# ---- (e) the wavefront loop ----


@pytest.mark.parametrize("geometry", ["fixture", "grid6"])
def test_wavefront_li_path_matches_jax(tmp_path, geometry):
    if geometry == "fixture":
        path = _write(tmp_path, lambda c: c.update(json.loads(SSS_MIXED.read_text())))
    else:
        # max_depth 3: JAX's trace of li_path grows with the depth
        path = write_grid_scene(str(tmp_path), ny=6, nz=6, base=str(SSS_MIXED), max_depth=3)
    jjob = jax_load_scene(path)
    jjob.film.xres, jjob.film.yres = FILM
    jctx = JaxSceneCtx(jjob.scene)
    assert not jpmk.supports(jctx, jjob.integrator, JaxStratified(jjob.sampler, seed=0), None)
    tables = None
    if geometry == "grid6":
        tables = pack_bvh_tables(jax_build_bvh(jctx.tri, empty_spheres(), bk.KERNEL_LEAF), jctx.tri)
    ctx = from_jax_scene_ctx(jctx, "cpu", tables)
    assert ctx.bssrdf is not None and (ctx.bvh is not None) == (geometry == "grid6")
    jsampler = JaxStratified(jjob.sampler, seed=0)
    # the grid's rays nearly all hit, and JAX's BVH walk is slow: 5 samples
    # a pixel leave its 1,000 lit rays
    spp = 8 if geometry == "fixture" else 5
    (o, d, w), pid, sid = _camera_batch(jjob, jctx, jsampler, spp)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    l_ref = np.asarray(jax_li_path(jctx, o, d, w, jsampler, jp, js, jjob.integrator))
    job = load_scene(path)
    l = li_path(ctx, T(o), T(d), T(w), StratifiedSampler(job.sampler, seed=0),
                T(pid.astype(np.int64)), T(sid.astype(np.int64)), job.integrator).numpy()
    _bar(l, l_ref)


# ---- (f) the routes ----


def test_routes(capsys):
    job = load_scene(str(SSS))
    assert select_kernel(job, make_sampler(job)) == FUSED["path"]
    job = load_scene(str(SSS_MIXED))
    assert select_kernel(job, make_sampler(job)) == WAVEFRONT
    err = capsys.readouterr().err
    assert "specular transmission (DisneyMaterial scatter_distance BSSRDF)" in err
    assert "wavefront loop" in err


@pytest.mark.parametrize("integrator", ["Debug", "DirectLighting", "Volpath", "SPPM"])
def test_other_kernels_raise_naming_the_bssrdf(tmp_path, capsys, integrator):
    """The kernels without the subsurface branch name the BSSRDF: SPPM
    raises, Debug, DirectLighting and Volpath announce it and go to the
    wavefront loop, whose tree or bounce loop evaluates the material's BSDF
    lobes as the JAX package's li_levels and li_volpath do."""
    job = load_scene(_write(tmp_path, _with_materials([MAT_SSS], integrator)))
    name = r"specular transmission \(DisneyMaterial scatter_distance BSSRDF\)"
    if integrator in ("Debug", "DirectLighting", "Volpath"):
        assert select_kernel(job, make_sampler(job)) == WAVEFRONT
        err = capsys.readouterr().err
        kernel = "volpath" if integrator == "Volpath" else "direct"
        assert re.search(name, err) and f"{kernel}-kernel subset" in err
        assert "wavefront loop" in err
        return
    with pytest.raises(NotImplementedError, match=name):
        select_kernel(job, make_sampler(job))


def test_ao_renders_a_subsurface_scene(tmp_path):
    def edit(cfg):
        cfg.update(json.loads(SSS.read_text()))
        cfg["Film"]["xres"], cfg["Film"]["yres"] = 32, 18
        cfg["Integrator"] = {"integrator_type": "AO", "n_samples": 4, "cos_sample": True}

    job = load_scene(_write(tmp_path, edit))
    res = render_job(job, "cpu", spp_override=1, pupil_samples=1 << 10)
    assert res["render_path"] == "wavefront"
    assert torch.isfinite(res["rgb_srgb_input"]).all() and float(res["rgb_srgb_input"].max()) > 0
