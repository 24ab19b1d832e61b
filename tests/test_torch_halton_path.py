"""Path and AO under the Halton sampler, on the CPU, against the JAX package.

- The sampler slots the path kernel reads (`used_slots`, `slot_cols`)
  equal JAX's `_used_slots` / `_slot_cols` for max_depth 1-8, point,
  sphere-area, environment and no NEE lights, with and without the
  camera's film and lens slots: the Halton instances read those rows of
  one (NC, N) matrix, so a drifted list shows as per-ray divergence.
- The slot matrix of the port's HaltonSampler (JAX's spec and seed,
  carried by interop.sampler_from_jax) against JAX's `_halton_u` at the
  Path slots, off the pixel centres: a few float32 ulp (the two packages
  sum the radical inverse differently; tests/test_torch_halton.py).
- K1's plain version on given rays (brute force and the in-kernel BVH)
  and from the camera, under a 6-sample HaltonSampler at sample index 3
  (tests/test_megakernel.py:597-690), against JAX `li_path_mega` /
  `li_path_mega_cam` in interpret mode and JAX `li_path`, and the
  wavefront `li_path` and `li_ao` against JAX's, at the per-ray bar:
  under 0.5% of rays off by more than 1e-3 relative, means within 3e-3.
  The cubes are matte: the reference's Trowbridge-Reitz sampler makes 1-2%
  of glossy bounces chaotic between any two implementations (ROADMAP
  Queue 3), and a sampler value a few ulp off is enough to start one.
- render_job of a 64x36 Halton fixture at 6 spp (one pass of 6: not a
  power of two) against JAX render_job, and at 24 spp (two passes of 12):
  every (pixel, sample) traced exactly once.
- Debug, DirectLighting and Volpath still raise under a HaltonSampler,
  naming it.
"""

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators.ao import li_ao as jax_li_ao
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.integrators.path import li_path as jax_li_path
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.render import render_job as jax_render_job
from rs_ray_toy_tpu.sampler.halton import HaltonSampler as JaxHalton
from rs_ray_toy_tpu.scene.loader import SamplerSpec as JaxSamplerSpec
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch import render as rmod
from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
from rs_ray_toy_tpu_torch.integrators.ao import li_ao
from rs_ray_toy_tpu_torch.integrators.common import SceneCtx
from rs_ray_toy_tpu_torch.integrators.path import li_path
from rs_ray_toy_tpu_torch.interop import camera_from_jax, sampler_from_jax
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.render import (
    WAVEFRONT,
    make_sampler,
    pass_spp,
    render_job,
    sample_batch,
    select_kernel,
)
from rs_ray_toy_tpu_torch.sampler.halton import HaltonSampler
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.loader import SamplerSpec, load_scene
from rs_ray_toy_tpu_torch.scene.types import LIGHT_DIFFUSE_AREA, LIGHT_POINT

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
PUPIL_SAMPLES = 1 << 10
W, H = 64, 36

torch.set_num_threads(min(2, torch.get_num_threads()))

# (n_lights, all_point, an environment light among them)
LIGHTS = {"point": (3, True, False), "sphere_area": (2, False, False), "env": (1, False, True),
          "none": (0, False, False)}


@pytest.mark.parametrize("with_cam", [False, True], ids=["rays", "cam"])
@pytest.mark.parametrize("lights", list(LIGHTS))
@pytest.mark.parametrize("max_depth", range(1, 9))
def test_used_slots_match_jax(max_depth, lights, with_cam):
    n, all_point, env = LIGHTS[lights]
    slots = pmk.used_slots(max_depth, n, all_point, env, with_cam)
    assert slots == jpmk._used_slots(max_depth, n, all_point, env, False, with_cam)
    assert pmk.slot_cols(slots) == jpmk._slot_cols(slots)
    assert max(s for s, _ in slots) < pmk.SLOT_MAX


def _write(tmp_path, edit=None, scene="scene.json"):
    """samples/<scene> at 64x36, every cube matte, edited by `edit`."""
    cfg = json.loads((SAMPLES / scene).read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = W, H
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_matte"
    if edit is not None:
        edit(cfg)
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    path = tmp_path / "s.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _halton(cfg, nsamp=6):
    cfg["Sampler"] = {"sampler_type": "HaltonSampler", "nsamp": nsamp}


def _area(cfg):
    """The sphere-area fixture's sphere light beside one point light, so
    that NEE takes the MIS branch and its light-sample slots."""
    _halton(cfg)
    cfg["lights"] = [
        {"light_type": "diffuse", "spectrum": {"values": [40.0, 30.0, 20.0]},
         "light_shape": {"shape_type": "sphere", "radius": 0.5, "world_pos": [33.0, 3.0, 1.0]}},
        {"light_type": "point", "world_pos": [30.0, -2.0, 0.0],
         "spectrum": {"values": [10.0, 10.0, 10.0]}},
    ]


def _bar(l, l_ref):
    assert np.isfinite(l).all() and l_ref.max() > 0, "scene renders black: the hold is vacuous"
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    diverged = float((rel.max(-1) > 1e-3).mean())
    assert diverged < 5e-3, f"{diverged:.2%} of rays diverged"
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())


def _jax_halton(nsamp=6):
    return JaxHalton(JaxSamplerSpec(kind="halton", nsamp=nsamp), W, H, seed=0)


def test_path_slot_matrix_matches_jax():
    """Every slot of a max_depth 5 pass with MIS and the camera, 64x36
    pixels at sample index 3 of 6, off the pixel centres."""
    jsampler = _jax_halton()
    sampler = sampler_from_jax(jsampler, W, H)
    assert (sampler.spp, sampler.sample_at_center, sampler.seed) == (6, False, 0)
    slots = pmk.used_slots(5, 2, False, False, True)
    pid = np.arange(W * H)
    u = sampler.slot_matrix(torch.as_tensor(pid), 3, slots).numpy()
    u_ref = np.asarray(jpmk._halton_u(jsampler, jnp.asarray(pid, jnp.uint32),
                                      jnp.full((W * H,), 3, jnp.uint32), slots))
    assert u.shape == u_ref.shape == (pmk.slot_cols(slots)[1], W * H)
    np.testing.assert_allclose(u, u_ref, rtol=0, atol=3e-7)
    # the reader the kernel and its plain version share returns get_1d /
    # get_2d by slot (a sphere light and a point light: the same slots)
    packed = SimpleNamespace(light_p=((0.0,) * 3,) * 2, env=None,
                             light_kind=(LIGHT_DIFFUSE_AREA, LIGHT_POINT))
    tp, ts = torch.as_tensor(pid), torch.full((W * H,), 3)
    reader = pmk.slot_reader(packed, SimpleNamespace(max_depth=5), sampler, tp, ts, True)
    assert torch.equal(reader.u, torch.as_tensor(u))
    assert torch.equal(reader.get_2d(tp, ts, 1), sampler.get_2d(tp, ts, 1))
    rr = pmk.path_dim0(4) + 4  # bounce 4's roulette slot
    assert torch.equal(reader.get_1d(tp, ts, rr), sampler.get_1d(tp, ts, rr))


def _camera_rays(jjob, jsampler, samples=(3,)):
    """JAX generate_rays of the 64x36 pixels at each sample index of
    `samples`."""
    cam = JaxCamera(jjob.camera, jjob.film, pupil_samples=PUPIL_SAMPLES)
    pid = jnp.asarray(np.tile(np.arange(W * H, dtype=np.uint32), len(samples)))
    sid = jnp.asarray(np.repeat(np.asarray(samples, np.uint32), W * H))
    pxy = jnp.stack([pid % W, pid // W], -1).astype(jnp.float32)
    o, d, w = cam.generate_rays(pxy + jsampler.get_2d(pid, sid, 0), jsampler.get_2d(pid, sid, 1))
    return cam, pxy, pid, sid, o, d, w


T = lambda a: torch.as_tensor(np.array(a))


@pytest.mark.parametrize("lights", ["point", "sphere_area"])
def test_rays_in_matches_jax(tmp_path, lights):
    """#3 and #4's plain version on JAX's camera rays under the Halton
    sampler against JAX li_path_mega (interpret) and li_path; the
    wavefront li_path against JAX li_path."""
    path = _write(tmp_path, _area if lights == "sphere_area" else _halton)
    jjob = jax_load_scene(path)
    jctx = JaxSceneCtx(jjob.scene)
    jsampler = _jax_halton()
    assert jpmk.supports(jctx, jjob.integrator, jsampler, None)
    _, _, pid, sid, o, d, w = _camera_rays(jjob, jsampler)
    jargs = (o, d, w, jsampler, pid, sid, jjob.integrator)
    l_ref = np.asarray(jax_li_path(jctx, *jargs))
    l_jk = np.asarray(jpmk.li_path_mega(jctx, jpmk.pack_scene(jctx), *jargs, interpret=True))
    _bar(l_jk, l_ref)

    job = load_scene(path)
    sampler = make_sampler(job)
    assert isinstance(sampler, HaltonSampler)
    assert pmk.unsupported_feature(job.scene, job.integrator, sampler) is None
    args = (T(o), T(d), T(w), T(np.asarray(pid, np.int64)), T(np.asarray(sid, np.int64)),
            sampler, job.integrator)
    for bvh in (False, True):
        packed = pmk.pack_scene(job.scene, "cpu", bvh=bvh)
        assert (packed.bvh is not None) == bvh
        _bar(pmk.li_path_mega(packed, *args).numpy(), l_jk)
    l_w = li_path(SceneCtx.from_scene(job.scene, "cpu"), *args[:3], sampler, *args[3:5],
                  job.integrator).numpy()
    _bar(l_w, l_ref)


def test_camera_instance_matches_jax(tmp_path):
    """#1's plain version (brute force, and #2's over the BVH) from the
    camera under the Halton sampler, film and lens slots read from the
    slot matrix, against JAX li_path_mega_cam in interpret mode."""
    path = _write(tmp_path, _area)
    jjob = jax_load_scene(path)
    jctx = JaxSceneCtx(jjob.scene)
    jsampler = _jax_halton()
    cam, pxy, pid, sid, _, _, w = _camera_rays(jjob, jsampler)
    l_jk, w_jk = jpmk.li_path_mega_cam(jctx, jpmk.pack_scene(jctx), jpmk.pack_camera(cam), pxy,
                                       pid, sid, jsampler, jjob.integrator, interpret=True)
    l_jk, w_jk = np.asarray(l_jk), np.asarray(w_jk)
    job = load_scene(path)
    sampler = sampler_from_jax(jsampler, W, H)
    for bvh in (False, True):
        l, wt = pmk.li_path_mega_cam_reference(
            pmk.pack_scene(job.scene, "cpu", bvh=bvh), camera_from_jax(jpmk.pack_camera(cam)),
            T(pxy), T(np.asarray(pid, np.int64)), 3, sampler, job.integrator)
        np.testing.assert_allclose(wt.numpy(), w_jk, rtol=2e-5, atol=1e-7)
        live = w_jk > 0
        _bar(l.numpy()[live], l_jk[live])


def test_li_ao_matches_jax(tmp_path):
    """The wavefront li_ao under the Halton sampler, 16 cosine probes,
    against JAX li_ao on the same camera rays, sample indices 0-3 of every
    pixel.  JAX draws probe k in a fori_loop, so its Halton sampler sees
    slot 8 + k as a traced value and answers with the counter hash; the
    port's li_ao reads HaltonSampler.traced_2d to agree."""
    def edit(cfg):
        _halton(cfg)
        cfg["Integrator"] = {"integrator_type": "AO", "n_samples": 16, "cos_sample": True}

    path = _write(tmp_path, edit)
    jjob = jax_load_scene(path)
    jctx = JaxSceneCtx(jjob.scene)
    jsampler = _jax_halton()
    _, _, pid, sid, o, d, w = _camera_rays(jjob, jsampler, range(4))
    l_ref = np.asarray(jax_li_ao(jctx, o, d, w, jsampler, pid, sid, jjob.integrator))
    job = load_scene(path)
    sampler = make_sampler(job)
    assert isinstance(sampler, HaltonSampler)
    assert rmod.select_kernel(job, sampler) == rmod.WAVEFRONT
    l = li_ao(SceneCtx.from_scene(job.scene, "cpu"), T(o), T(d), T(w), sampler,
              T(np.asarray(pid, np.int64)), T(np.asarray(sid, np.int64)), job.integrator).numpy()
    assert (l_ref.max(-1) > 0).sum() > 200
    _bar(l, l_ref)


def test_plain_version_counts_the_slot_values_the_kernel_reads(tmp_path):
    """work["slot"], the sampler values chip_smoke's bound charges: a ray
    into the white furnace's sphere reads at its one vertex the light pick
    and sample (3), the environment's BSDF sample (2) and the BSDF sample
    (2), then escapes; a ray away from it reads none; the stratified
    sampler reads none; from the camera every ray adds its film and lens
    values (4) to what its ray reads given."""
    job = load_scene(str(SAMPLES / "scene_furnace.json"))
    packed = pmk.pack_scene(job.scene, "cpu")
    n = 512
    yz = (np.random.default_rng(7).random((n, 2)) - 0.5) * 1.2  # inside the radius of 1
    o = torch.as_tensor(np.c_[np.full(n, 30.0), yz], dtype=torch.float32)
    d = torch.tensor([1.0, 0.0, 0.0]).expand(n, 3).contiguous()
    pid, w = torch.arange(n), torch.ones(n)
    halton = HaltonSampler(SamplerSpec("halton", nsamp=1), 32, 16)
    for sign, want in ((1.0, 7 * n), (-1.0, 0)):
        work = {}
        pmk.li_path_mega_reference(packed, o, sign * d, w, pid, 0, halton, job.integrator,
                                   work=work)
        assert int(work.get("slot", 0)) == want
    work = {}
    pmk.li_path_mega_reference(packed, o, d, w, pid, 0, StratifiedSampler(job.sampler),
                               job.integrator, work=work)
    assert "slot" not in work and int(work["lobe"]) > 0

    job = load_scene(_write(tmp_path, _area))  # max_depth 5: the roulette slot too
    packed = pmk.pack_scene(job.scene, "cpu")
    sampler = make_sampler(job)
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, pupil_samples=PUPIL_SAMPLES,
                                          device="cpu"))
    pxy, pid, _ = sample_batch(job.film, 1, "cpu")
    n = pid.shape[0]
    sid = torch.full((n,), 3)
    work_cam, work_rays = {}, {}
    pmk.li_path_mega_cam_reference(packed, cam, pxy, pid, sid, sampler, job.integrator,
                                   work=work_cam)
    reader = pmk.slot_reader(packed, job.integrator, sampler, pid, sid, True)
    ox, oy, oz, dx, dy, dz, wt = pmk._raygen(pxy[:, 0], pxy[:, 1], pid, sid, reader, cam)
    pmk.li_path_mega_reference(packed, torch.stack([ox, oy, oz], -1),
                               torch.stack([dx, dy, dz], -1), wt, pid, sid, sampler,
                               job.integrator, work=work_rays)
    assert int(work_rays["slot"]) > 100  # some rays hit the cubes
    assert int(work_cam["slot"]) == 4 * n + int(work_rays["slot"])


def test_traced_slot_falls_back_to_the_hash_as_in_jax():
    jsampler = _jax_halton()
    sampler = sampler_from_jax(jsampler, W, H)
    pid = np.arange(W * H)
    jp, js = jnp.asarray(pid, jnp.uint32), jnp.full((W * H,), 2, jnp.uint32)
    traced = jax.jit(lambda k: jsampler.get_2d(jp, js, 8 + k))(jnp.int32(3))
    np.testing.assert_array_equal(
        sampler.traced_2d(torch.as_tensor(pid), torch.full((W * H,), 2), 11).numpy(),
        np.asarray(traced))


def test_pass_spp_covers_every_sample():
    assert [pass_spp(s) for s in (1, 6, 16, 24, 48, 256, 7, 34)] == [1, 6, 16, 12, 16, 16, 7, 2]


def test_render_job_matches_jax(tmp_path, monkeypatch):
    """render_job(device="cpu") of the Halton fixture at 64x36 x 6 spp (one
    pass of six) against JAX render_job: image mean within 3e-3 relative
    and 98% of the lit pixels within 1e-3 relative; every (pixel, sample)
    traced once, also at 24 spp (two passes of 12)."""
    path = _write(tmp_path, _halton)
    traced = []
    pass_fn = pmk.li_path_mega_cam

    def recording(packed, cam, pxy, pid, s_idx, sampler, spec):
        assert isinstance(sampler, HaltonSampler)
        traced.append(pid * 1000 + s_idx)
        return pass_fn(packed, cam, pxy, pid, s_idx, sampler, spec)

    monkeypatch.setitem(rmod.FUSED, "path", ("path", pmk, pmk.pack_scene, recording))
    ref = jax_render_job(jax_load_scene(path), pupil_samples=PUPIL_SAMPLES)
    res = render_job(load_scene(path), "cpu", pupil_samples=PUPIL_SAMPLES)
    assert res["fused_kernel"] == "path" and res["passes"] == 1 and len(traced) == 1
    assert res["camera_rays"] == ref["camera_rays"] == W * H * 6
    img, ref_img = res["rgb_srgb_input"].numpy(), np.asarray(ref["rgb_srgb_input"])
    assert np.isfinite(img).all() and ref_img.mean() > 0
    assert abs(img.mean() - ref_img.mean()) < 3e-3 * ref_img.mean()
    lit = (img.sum(-1) > 0) | (ref_img.sum(-1) > 0)
    assert lit.sum() > 100
    close = np.all(np.abs(img - ref_img) <= 1e-3 * np.abs(ref_img) + 1e-4, axis=-1)
    assert close[lit].mean() >= 0.98
    job = load_scene(path)
    job.film.xres, job.film.yres = 16, 9
    for spp in (6, 24):
        traced.clear()
        res = render_job(job, "cpu", spp_override=spp, pupil_samples=PUPIL_SAMPLES)
        keys = torch.sort(torch.cat(traced)).values
        want = (torch.arange(16 * 9)[:, None] * 1000 + torch.arange(spp)).flatten()
        assert res["passes"] == len(traced) == spp // pass_spp(spp)
        assert torch.equal(keys, torch.sort(want).values)


@pytest.mark.parametrize("integrator", ["Debug", "DirectLighting", "Volpath"])
def test_other_integrators_raise_under_halton(tmp_path, capsys, integrator):
    """Debug, DirectLighting and Volpath (in a camera fog) take a
    HaltonSampler in the wavefront loop, announced naming it."""
    def edit(cfg):
        _halton(cfg)
        cfg["Integrator"] = {"integrator_type": integrator, "max_depth": 3}
        if integrator == "Volpath":
            cfg["Camera"]["medium"] = {"medium_type": "Homogeneous", "g": 0.0,
                                       "preset": "Clorox"}

    job = load_scene(_write(tmp_path, edit))
    sampler = make_sampler(job)
    assert isinstance(sampler, HaltonSampler)
    assert select_kernel(job, sampler) == WAVEFRONT
    err = capsys.readouterr().err
    assert "(HaltonSampler)" in err and "wavefront loop" in err
