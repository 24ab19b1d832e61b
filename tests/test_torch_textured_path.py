"""The textured path kernel's plain version against the JAX package, on
the CPU (the textured pass's K7 tap: tests/test_torch_texture.py).

- The camera's ray differentials against JAX's generate_ray_differentials
  (rtol 1e-4, atol 2e-5 on live rays).
- The bounce-0 taps, on JAX's own hits of its camera rays (2,418 on
  textured cubes): the port's EWA tap (K7's plain version) on JAX's st
  and footprints against JAX's ewa_lookup, at rtol 1e-5 (measured max
  2.1e-6); and the port's whole textured kd (textured_kd_reference: st
  from the row's uvs, the footprints from the differential rays' plane
  hits, the tap) on JAX's hit points, rows and differential rays against
  JAX's compute_uv_differentials and ewa_lookup: 99th percentile of the
  relative error under 1e-4 and its max under 2e-3 (measured 3.0e-5 and
  8.3e-4: the footprints difference plane hits 0.05 px apart, which
  amplifies the last bits of the two computations, and the level choice
  follows them).
- K1's textured plain version on samples/scene_textured.json per ray
  against JAX's li_path with the camera's differentials under
  RS_TEX_PACKED=0 (tests/test_megakernel_textured.py:121-170 with the
  exact filter), over the lit rays of the 64x36 film at 32 spp (1,696,
  a ray with radiance in either): fewer than 2% of them off by more than
  1e-3 relative, their 90th percentile under 2e-4, means within 3e-3
  (measured 1.24%, 5.4e-5 and 2e-4).  Where they part is the amplified
  last bits above, and after bounce 0 the kernel taps level 0 bilinearly
  (exactly dead differentials) where JAX's li_path derives a footprint
  of rounding size from the dead rays.
- render_job's 64x36 image against JAX's image of the same samples (its
  li_path's radiance on its film: the jnp route of its render_job under
  RS_MEGAKERNEL=0 and RS_TEX_PACKED=0, run eagerly, since the jitted
  render_job takes about 40 s to compile on a CPU).
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.accel import geometry as jgeom
from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.film import film as jax_film
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.integrators.common import scrub_radiance as jax_scrub
from rs_ray_toy_tpu.integrators.path import li_path as jax_li_path
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene import mipmap as jmip
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu.scene.textures import _map_2d
from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
from rs_ray_toy_tpu_torch.film import film
from rs_ray_toy_tpu_torch.interop import camera_from_jax
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.render import render_job, select_kernel
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene import mipmap
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
PUPIL_SAMPLES = 1 << 12

# several pytest workers share the host: keep torch's threads few
torch.set_num_threads(min(2, torch.get_num_threads()))


def _textured_variant(tmp, w, h):
    cfg = json.loads((SAMPLES / "scene_textured.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = w, h
    cfg["Sampler"]["xsamp"], cfg["Sampler"]["ysamp"] = 4, 8
    for aux in ("cube.obj", "tex_checker.png"):
        shutil.copy(SAMPLES / aux, tmp)
    path = tmp / "scene.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _batch(w, h, spp):
    pid = np.tile(np.arange(w * h, dtype=np.uint32), spp)
    sid = np.repeat(np.arange(spp, dtype=np.uint32), w * h)
    return pid, sid, np.stack([pid % w, pid // w], -1).astype(np.float32)


W, H, SPP = 64, 36, 32


@pytest.fixture(scope="module")
def jax_pass(tmp_path_factory):
    """JAX's textured estimator over every sample of the 64x36 fixture at
    32 spp (73,728 rays, 1,696 lit): its camera rays with
    differentials (generate_ray_differentials), its li_path with them
    under RS_TEX_PACKED=0 (JAX reads it at call time,
    scene/textures.py:155-158), eagerly: JAX's render_job jits the same
    calls, whose compile alone takes about 40 s on a CPU; and the
    bounce-0 taps of that li_path: its hits, their st, footprints and
    kd (li_path's compute_uv_differentials and eval_all's ewa_lookup)."""
    path = _textured_variant(tmp_path_factory.mktemp("textured"), W, H)
    jjob = jax_load_scene(path)
    jctx = JaxSceneCtx(jjob.scene)
    jcam = JaxCamera(jjob.camera, jjob.film, pupil_samples=PUPIL_SAMPLES)
    jsampler = JaxStratified(jjob.sampler, seed=0)
    assert jsampler.spp == SPP
    pid, sid, pxy = _batch(W, H, SPP)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    u_film, u_lens = jsampler.get_2d(jp, js, 0), jsampler.get_2d(jp, js, 1)
    o, d, wt, diff = jcam.generate_ray_differentials(jnp.asarray(pxy) + u_film, u_lens, spp=SPP)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RS_TEX_PACKED", "0")
        l_ref = np.asarray(jax_li_path(jctx, o, d, wt, jsampler, jp, js, jjob.integrator,
                                       diff=diff))
    # the bounce-0 taps of li_path: its hits, their footprints and kd
    active = wt > 0.0
    hit, si = jctx.intersect_shaded(o, d, jnp.where(active, jnp.inf, 0.0))
    si = si._replace(valid=si.valid & active)
    duv, _, _ = jgeom.compute_uv_differentials(si, diff)
    (rec,) = jctx.registry.records
    st = _map_2d(rec, si.uv, si.p)
    dst0 = jnp.stack([duv[:, 0] * rec.su, duv[:, 1] * rec.sv], -1)
    dst1 = jnp.stack([duv[:, 2] * rec.su, duv[:, 3] * rec.sv], -1)
    kd = jmip.ewa_lookup(jctx.dev_images[rec.image_id], st, dst0, dst1,
                         jctx.registry.images[rec.image_id].max_aniso) * rec.scale
    taps = dict(valid=np.asarray(si.valid), row=np.asarray(hit.index), p=np.asarray(si.p),
                st=np.asarray(st), dst0=np.asarray(dst0), dst1=np.asarray(dst1),
                kd=np.asarray(kd))
    return dict(path=path, jjob=jjob, jcam=jcam, pid=pid, sid=sid, pxy=pxy,
                film_xy=np.array(jnp.asarray(pxy) + u_film), u_lens=np.array(u_lens),
                weight=np.asarray(wt), o=np.asarray(o), d=np.asarray(d),
                diff=[np.asarray(x) for x in diff], l_ref=l_ref, taps=taps)


def test_ray_differentials_match_jax(jax_pass):
    job = load_scene(jax_pass["path"])
    cam = RealisticCamera(job.camera, job.film, pupil_samples=PUPIL_SAMPLES)
    out = cam.generate_ray_differentials(torch.as_tensor(jax_pass["film_xy"]),
                                         torch.as_tensor(jax_pass["u_lens"]), spp=SPP)
    live = jax_pass["weight"] > 0
    assert live.sum() > 1000 and np.array_equal(out[2].numpy() > 0, live)
    for a, b in zip(out[3], jax_pass["diff"]):
        np.testing.assert_allclose(a.numpy()[live], b[live], rtol=1e-4, atol=2e-5)


def _rel(a, ref):
    return (np.abs(a - ref) / np.maximum(np.abs(ref), 1e-3)).max(-1)


def test_bounce0_taps_match_jax_ewa(jax_pass):
    tp = jax_pass["taps"]
    job = load_scene(jax_pass["path"])
    packed = pmk.pack_scene(job.scene, "cpu")
    assert packed.bvh is None  # table rows in the scene's order, as JAX's hit.index
    t = lambda a: torch.as_tensor(np.array(a))
    row = packed.table[t(np.where(tp["valid"], tp["row"], 0)).long()]
    texed = t(tp["valid"]) & (row[:, pmk.TEX0 + 9] > 0.0)
    m = texed.numpy()
    assert m.sum() >= 1000 and np.array_equal(m, tp["valid"])
    # K7's plain version on JAX's st and footprints
    st, d0, d1 = tp["st"], tp["dst0"], tp["dst1"]
    kd = mipmap.ewa_lookup(packed.tex.pyr, t(st[:, 0]), t(st[:, 1]), t(d0[:, 0]), t(d0[:, 1]),
                           t(d1[:, 0]), t(d1[:, 1])).numpy() * packed.tex.rec.scale
    np.testing.assert_allclose(kd[m], tp["kd"][m], rtol=1e-5, atol=1e-8)
    # the port's textured kd on JAX's hits and differential rays
    cols = lambda a: tuple(t(a[:, k]) for k in range(3))
    fd = [c for a in jax_pass["diff"] for c in cols(a)]
    kd = pmk.textured_kd_reference(row, packed.tex, cols(jax_pass["o"]) + cols(jax_pass["d"]),
                                   cols(tp["p"]), (row[:, 9], row[:, 10], row[:, 11]),
                                   (row[:, 12], row[:, 13], row[:, 14]), fd, texed).numpy()
    rel = _rel(kd[m], tp["kd"][m])
    assert float(np.quantile(rel, 0.99)) < 1e-4 and float(rel.max()) < 2e-3


def test_textured_kernel_plain_version_matches_jax_li_path(jax_pass):
    job = load_scene(jax_pass["path"])
    sampler = StratifiedSampler(job.sampler, seed=0)
    assert select_kernel(job, sampler)[0] == "path"
    packed = pmk.pack_scene(job.scene, "cpu")
    ids = (torch.as_tensor(jax_pass["pid"].astype(np.int64)),
           torch.as_tensor(jax_pass["sid"].astype(np.int64)))
    l, w_ = pmk.li_path_mega_cam(packed, camera_from_jax(jpmk.pack_camera(jax_pass["jcam"])),
                                 torch.as_tensor(jax_pass["pxy"]), *ids, sampler, job.integrator)
    l = np.where((w_.numpy() > 0)[:, None], l.numpy(), 0.0)
    l_ref = np.where((jax_pass["weight"] > 0)[:, None], jax_pass["l_ref"], 0.0)
    assert np.isfinite(l).all()
    lit = (l_ref.max(-1) > 0) | (l.max(-1) > 0)
    assert lit.sum() >= 1000
    l, l_ref = l[lit], l_ref[lit]
    rel = _rel(l, l_ref)
    diverged = float((rel > 1e-3).mean())
    assert diverged < 0.02, f"{diverged:.2%} of the lit rays diverged"
    assert float(np.quantile(rel, 0.9)) < 2e-4, "bulk not bit-level"
    assert abs(l.mean() - l_ref.mean()) < 3e-3 * abs(l_ref.mean())


def test_textured_render_matches_jax(jax_pass, tmp_path):
    """render_job's 64x36 image at 32 spp against JAX's image of the same
    samples: its li_path radiance scrubbed and added to its film
    (JAX's render_job's jnp route under RS_MEGAKERNEL=0, without the jit)."""
    jjob = jax_pass["jjob"]
    l = jnp.asarray(jax_pass["l_ref"])
    wt = jnp.asarray(jax_pass["weight"])
    l = jnp.where((wt > 0.0)[:, None], jax_scrub(l), 0.0)
    jfilm = jax_film.add_samples(jax_film.make_film(jjob.film), jjob.film,
                                 jnp.asarray(jax_pass["film_xy"]), l, wt)
    ref_img = np.asarray(jax_film.to_rgb(jfilm, jjob.film))
    job = load_scene(jax_pass["path"])
    res = render_job(job, "cpu", pupil_samples=PUPIL_SAMPLES)
    assert res["fused_kernel"] == "path" and res["render_path"] == "plain"
    img = res["rgb_srgb_input"].numpy()
    assert img.shape == ref_img.shape == (H, W, 3)
    assert np.isfinite(img).all() and ref_img.mean() > 0
    assert abs(img.mean() - ref_img.mean()) < 3e-3 * ref_img.mean()
    lit = ref_img.sum(-1) > 0
    close = np.all(np.abs(img - ref_img) <= 1e-3 * np.abs(ref_img) + 1e-5, axis=-1)
    assert lit.sum() > 40 and close[lit].mean() >= 0.95
    colored = film.write_png(res["rgb_srgb_input"], str(tmp_path / "port.png"))
    ref_colored = jax_film.write_png(ref_img, str(tmp_path / "jax.png"))
    assert abs(colored - ref_colored) <= 0.01 * ref_colored
