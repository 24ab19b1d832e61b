"""DisneyMaterial in the port (constant parameters, no BSSRDF) against the
JAX package, on the CPU.

- Packed material tables equal JAX's, array for array, for Disney with
  and without sheen and clearcoat, thin, with spec_trans, anisotropic,
  metallic and at its defaults (the loader's recipe, disney.rs:530-676).
- Per lobe, on 4,096 seeded local-frame (wo, wi, u): f and pdf of the
  Disney diffuse, retro, sheen, clearcoat, microfacet and fake-subsurface
  lobes against JAX `bsdf/eval` (lobe_f, lobe_pdf) at rtol 1e-5 (for the
  lobes with a microfacet D, on 99% of the lanes, and every lane at rtol
  1e-4 / atol 1e-6: D is ill-conditioned near its peak), and the lobe's
  sample (_lobe_sample: direction, f, pdf; for the lobes with a D, whose
  samples land on its peak, f / pdf) equal at rtol 1e-5 / atol 1e-5
  (1e-4 for a direction within 0.01 of the horizon) on every lane, or on
  85% of them for the Trowbridge-Reitz-sampled microfacet (or on as
  many as the JAX package's two samplers agree on, where that is less:
  ~80% at an anisotropic alpha): the reference's visible-normal slope
  cancels two ~1e10 terms, so a last-bit difference moves about one
  isotropic sample in six (ROADMAP Queue 3).
- The path kernel's plain version on samples/scene_disney.json (the
  three cubes in the five-lobe stack, a sphere in the anisotropic
  three-lobe one) against JAX `li_path` and JAX `li_path_mega`
  (interpret mode, at max_depth 2) on 80x45 x 16 camera rays, at least
  1,000 of them lit (64x36 x 16 gives ~700): the bar of
  tests/test_megakernel.py:552-591, under 0.5% of rays off by more than
  1e-3 relative, means within 3e-3.
- The routes: the Disney fixture goes to the path kernel, a thin Disney
  material to the wavefront loop, a BSSRDF Disney material (non-zero
  scatter_distance) loads with its BSSRDF and the direct kernel names it
  (tests/test_torch_bssrdf.py holds the rest), and Debug,
  DirectLighting, Volpath and SPPM raise naming the Disney lobes.
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.bsdf import eval as jeval
from rs_ray_toy_tpu.bsdf import microfacet as jmf
from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.integrators.path import li_path as jax_li_path
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.bsdf import eval as beval
from rs_ray_toy_tpu_torch.bsdf.lobes import (
    LOBE_DISNEY_CLEARCOAT,
    LOBE_DISNEY_DIFFUSE,
    LOBE_DISNEY_FAKE_SS,
    LOBE_DISNEY_MICROFACET_REFL,
    LOBE_DISNEY_RETRO,
    LOBE_DISNEY_SHEEN,
    LOBE_MF_REFL,
    LOBE_MF_TRANS,
)
from rs_ray_toy_tpu_torch.integrators.common import material_rows
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.render import FUSED, WAVEFRONT, make_sampler, select_kernel
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import THIN_FOG
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"

torch.set_num_threads(min(2, torch.get_num_threads()))

DISNEY = {"material_type": "DisneyMaterial", "material_name": "mat_d"}
CASES = {
    "plain": dict(color={"values": [0.8, 0.5, 0.3]}, roughness=0.4, metallic=0.3, sheen=0.5,
                  clearcoat=0.6),
    "no_sheen_no_clearcoat": dict(color={"values": [0.3, 0.6, 0.8]}, roughness=0.3,
                                  metallic=0.5),
    "thin": dict(thin=True, color={"values": [0.8, 0.5, 0.3]}, roughness=0.4, flatness=0.5,
                 diff_trans=0.6, sheen=0.3, clearcoat=0.2),
    "thin_spec_trans": dict(thin=True, roughness=0.4, flatness=0.5, diff_trans=0.6,
                            spec_trans=0.3, eta=1.4),
    "spec_trans": dict(color={"values": [0.6, 0.8, 0.7]}, roughness=0.3, spec_trans=0.4),
    "anisotropic": dict(roughness=0.3, metallic=0.5, anisotropic=0.5, specular_tint=0.5,
                        clearcoat_gloss=0.3, clearcoat=1.0),
    "metallic": dict(metallic=1.0, roughness=0.2, color={"values": [0.9, 0.6, 0.2]}),
    "defaults": dict(),
}
# kinds whose f and pdf carry a microfacet distribution D
D_KINDS = (LOBE_DISNEY_CLEARCOAT, LOBE_DISNEY_MICROFACET_REFL, LOBE_MF_REFL, LOBE_MF_TRANS)
TABLE_KEYS = ("kind", "s0", "s1", "s2", "fparams", "fresnel", "dist", "remap", "sample_visible",
              "scale", "n_lobes", "eta")


def _write(tmp_path, edit):
    cfg = json.loads((SAMPLES / "scene.json").read_text())
    edit(cfg)
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    path = tmp_path / "s.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _with_materials(mats, integrator="Path"):
    def edit(cfg):
        cfg["materials"] += mats
        cfg["Aggregate"]["primitives"][0]["material_name"] = mats[0]["material_name"]
        cfg["Integrator"] = {"integrator_type": integrator, "max_depth": 3}
        if integrator == "Volpath":
            cfg["Camera"]["medium"] = THIN_FOG

    return edit


def _tables_equal(path):
    ours, theirs = load_scene(path).scene.materials, jax_load_scene(path).scene.materials
    for key in TABLE_KEYS:
        np.testing.assert_array_equal(ours[key], np.asarray(theirs[key]), err_msg=key)
    return ours


@pytest.mark.parametrize("case", sorted(CASES))
def test_disney_tables_equal_jax(tmp_path, case):
    mats = _tables_equal(_write(tmp_path, _with_materials([{**DISNEY, **CASES[case]}])))
    assert mats["n_lobes"][-1] >= 1


def _local_dirs(n, seed):
    r = np.random.default_rng(seed)
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)
    return unit(r.normal(size=(n, 3))), unit(r.normal(size=(n, 3))), \
        r.uniform(0.0, 1.0, (n, 2)).astype(np.float32)


def lobe_pairs(path, kinds, n):
    """(kind, JAX per-lobe dict, the port's lobe) of every lobe slot of the
    scene's materials whose kind is in `kinds`, each gathered for n lanes."""
    jmats = jax_load_scene(path).scene.materials
    rows = material_rows(load_scene(path).scene.materials, "cpu")
    out = []
    for m in range(rows.shape[0]):
        for j in range(int(rows[m, 15])):
            kind = int(rows[m, 16 + 16 * j])
            if kind not in kinds:
                continue
            jp = jeval._slot(jeval.gather_lobes(jmats, None, jnp.full((n,), m, jnp.int32)), j)
            out.append((kind, jp, beval.row_lobe(rows[torch.full((n,), m)], j)))
    return out


def check_lobe(kind, jp, lob, n, seed, tr_sampled):
    """f, pdf and the lobe's sample against JAX bsdf/eval (the module
    docstring's bars); returns the share of samples that agree."""
    wo, wi, u = _local_dirs(n, seed)
    t = lambda a: torch.as_tensor(a)
    jwo, jwi = jnp.asarray(wo), jnp.asarray(wi)
    for what, ours, theirs in (
            ("f", beval.lobe_f(lob, t(wo), t(wi)), jeval.lobe_f(jp, jwo, jwi)),
            ("pdf", beval.lobe_pdf(lob, t(wo), t(wi)), jeval.lobe_pdf(jp, jwo, jwi))):
        ours, theirs = ours.numpy(), np.asarray(theirs)
        if kind in D_KINDS:
            # a microfacet D is ill-conditioned near its peak (GTR1 at gloss
            # 0.001: its denominator is sin^2 + a^2 cos^2): the kernel forms
            # the half vector as JAX's kernel does (times 1 / |wh|),
            # bsdf/eval by a division, and that last bit moves D by up to
            # ~1e-4 on a few lanes
            close = np.isclose(ours, theirs, rtol=1e-5, atol=1e-7)
            assert close.mean() >= 0.99, (what, close.mean())
            np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-6, err_msg=what)
        else:
            np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what} of kind {kind}")
    jf, jwi_s, jpdf, _ = jeval._lobe_sample(jp, jwo, jnp.asarray(u))
    wx, wy, wz, f, pdf, _ = beval._lobe_sample(lob, t(wo[:, 0]), t(wo[:, 1]), t(wo[:, 2]),
                                               t(u[:, 0]), t(u[:, 1]))
    f, jf = torch.stack(f, -1).numpy(), np.asarray(jf)
    pdf, jpdf = pdf.numpy(), np.asarray(jpdf)
    # atol 1e-5 on the sample, 1e-4 within 0.01 of the horizon: the cosine
    # warp's z = sqrt(1 - x^2 - y^2) magnifies the two packages' last-bit
    # cos / sin differences near the rim (tests/test_torch_intersect.py::
    # test_warps_match_jax)
    jwi_s = np.asarray(jwi_s)
    atol = np.where(np.abs(jwi_s[:, 2:]) < 0.01, 1e-4, 1e-5)
    same = np.isclose(torch.stack([wx, wy, wz], -1).numpy(), jwi_s, rtol=1e-5, atol=atol).all(-1)
    assert jpdf.max() > 0, f"kind {kind}: no valid sample"
    if kind in D_KINDS:
        # a sample lands where D peaks: f and pdf each carry D (GTR1 at
        # gloss 0.001: up to ~7% apart on a fifth of the lanes between any
        # two float32 implementations), but their ratio, what the
        # estimator uses, is well conditioned
        ok = jpdf > 0
        same &= (pdf > 0) == ok
        ratio = f / np.where(pdf > 0, pdf, 1.0)[:, None]
        jratio = jf / np.where(ok, jpdf, 1.0)[:, None]
        same &= np.isclose(ratio, jratio, rtol=1e-5, atol=1e-5).all(-1)
    else:
        same &= np.isclose(f, jf, rtol=1e-5, atol=1e-5).all(-1)
        same &= np.isclose(pdf, jpdf, rtol=1e-5, atol=1e-5)
    if tr_sampled:
        assert same.mean() >= min(0.85, jax_self_agreement(jp, wo, u)), (kind, same.mean())
    else:
        assert same.all(), (kind, np.flatnonzero(~same)[:5])
    return same.mean()


def jax_self_agreement(jp, wo, u):
    """The share of lanes on which the JAX package's two visible-normal
    Trowbridge-Reitz samplers (its kernel's and bsdf/microfacet's) give
    the same half vector at rtol 1e-5: ~80% at these alphas."""
    args = [jnp.asarray(wo[:, i]) for i in range(3)] + [jp["alpha_u"], jp["alpha_v"]]
    k = np.stack([np.asarray(c) for c in jpmk._tr_sample_wh_k(
        *args, jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]))], -1)
    e = np.asarray(jmf.tr_sample_wh_visible(jnp.asarray(wo), jp["alpha_u"], jp["alpha_v"],
                                            jnp.asarray(u)))
    return float(np.isclose(k, e, rtol=1e-5, atol=1e-6).all(-1).mean())


DISNEY_KINDS = (LOBE_DISNEY_DIFFUSE, LOBE_DISNEY_RETRO, LOBE_DISNEY_SHEEN, LOBE_DISNEY_CLEARCOAT,
                LOBE_DISNEY_MICROFACET_REFL, LOBE_DISNEY_FAKE_SS)


@pytest.mark.parametrize("kind", DISNEY_KINDS)
def test_disney_lobe_matches_jax(tmp_path, kind):
    """Every lobe of this kind in the plain, thin and anisotropic cases."""
    mats = [{**DISNEY, "material_name": f"mat_{c}", **CASES[c]}
            for c in ("plain", "thin", "anisotropic")]
    pairs = lobe_pairs(_write(tmp_path, _with_materials(mats)), (kind,), 4096)
    assert pairs
    for i, (k, jp, lob) in enumerate(pairs):
        check_lobe(k, jp, lob, 4096, 7 + i, tr_sampled=k == LOBE_DISNEY_MICROFACET_REFL)


def _bar(l, l_ref):
    assert np.isfinite(l).all() and l_ref.max() > 0
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    diverged = float((rel.max(-1) > 1e-3).mean())
    assert diverged < 5e-3, f"{diverged:.2%} of rays diverged"
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())


def _fixture_rays(tmp_path, max_depth, w_=80, h_=45):
    """The Disney fixture at w_ x h_ with `max_depth`: (path, JAX job, the
    camera rays of all 16 samples of every pixel, pixel ids, sample
    indices)."""
    cfg = json.loads((SAMPLES / "scene_disney.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = w_, h_
    cfg["Integrator"]["max_depth"] = max_depth
    path = _write(tmp_path, lambda c: c.update(cfg))
    jjob = jax_load_scene(path)
    jsampler = JaxStratified(jjob.sampler, seed=0)
    pid = np.tile(np.arange(w_ * h_, dtype=np.uint32), 16)
    sid = np.repeat(np.arange(16, dtype=np.uint32), w_ * h_)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    pxy = jnp.stack([jp % w_, jp // w_], -1).astype(jnp.float32)
    cam = JaxCamera(jjob.camera, jjob.film, pupil_samples=1 << 10)
    rays = cam.generate_rays(pxy + jsampler.get_2d(jp, js, 0), jsampler.get_2d(jp, js, 1))
    return path, jjob, rays, pid, sid


def _port_k1(path, rays, pid, sid):
    job = load_scene(path)
    sampler = StratifiedSampler(job.sampler, seed=0)
    assert pmk.unsupported_feature(job.scene, job.integrator, sampler) is None
    packed = pmk.pack_scene(job.scene, "cpu")
    assert set(pmk.DISNEY_KINDS) <= set(packed.kinds_present)
    T = lambda a: torch.as_tensor(np.array(a))
    return pmk.li_path_mega(packed, *(T(r) for r in rays), T(pid.astype(np.int64)),
                            T(sid.astype(np.int64)), sampler, job.integrator).numpy()


def test_path_kernel_plain_version_matches_jax_li_path_on_the_disney_fixture(tmp_path):
    path, jjob, rays, pid, sid = _fixture_rays(tmp_path, 5)
    jctx = JaxSceneCtx(jjob.scene)
    jsampler = JaxStratified(jjob.sampler, seed=0)
    assert jpmk.supports(jctx, jjob.integrator, jsampler, None)
    l_ref = np.asarray(jax_li_path(jctx, *rays, jsampler, jnp.asarray(pid), jnp.asarray(sid),
                                   jjob.integrator))
    assert (l_ref.max(-1) > 0).sum() >= 1000
    _bar(_port_k1(path, rays, pid, sid), l_ref)


def test_path_kernel_plain_version_matches_the_jax_kernel_on_the_disney_fixture(tmp_path):
    """JAX's kernel in interpret mode, at max_depth 2: its trace at the
    fixture's 5 takes three times as long, and two bounces already run
    every lobe's f, pdf and sample at both vertices."""
    path, jjob, rays, pid, sid = _fixture_rays(tmp_path, 2)
    jctx = JaxSceneCtx(jjob.scene)
    l_jk = np.asarray(jpmk.li_path_mega(jctx, jpmk.pack_scene(jctx), *rays,
                                        JaxStratified(jjob.sampler, seed=0), jnp.asarray(pid),
                                        jnp.asarray(sid), jjob.integrator, interpret=True))
    assert (l_jk.max(-1) > 0).sum() >= 1000
    _bar(_port_k1(path, rays, pid, sid), l_jk)


def test_routes(tmp_path, capsys):
    """The Disney fixture takes the path kernel; a thin Disney material
    (fake subsurface, lambert and microfacet transmission) the wavefront
    loop, announced on stderr."""
    job = load_scene(str(SAMPLES / "scene_disney.json"))
    assert select_kernel(job, make_sampler(job)) == FUSED["path"]
    thin = dict(thin=True, flatness=0.5, diff_trans=0.6)  # five lobes, two K1 lacks
    path = _write(tmp_path, _with_materials([{**DISNEY, **thin}]))
    job = load_scene(path)
    assert select_kernel(job, make_sampler(job)) == WAVEFRONT
    err = capsys.readouterr().err
    assert "Disney fake subsurface (thin DisneyMaterial) lobes" in err and "wavefront" in err


def test_bssrdf_disney_raises_at_load(tmp_path, capsys):
    """A BSSRDF Disney material no longer raises at load: it loads with its
    BSSRDF, and a kernel without the subsurface branch names it (Debug's
    announcing the wavefront loop)."""
    path = _write(tmp_path, _with_materials(
        [{**DISNEY, "scatter_distance": {"values": [0.5, 0.3, 0.2]}}], "Debug"))
    job = load_scene(path)
    assert bool(job.scene.materials["has_bssrdf"][-1])
    assert select_kernel(job, make_sampler(job)) == WAVEFRONT
    assert "specular transmission (DisneyMaterial scatter_distance BSSRDF)" in (
        capsys.readouterr().err)
    # thin: no BSSRDF (disney.rs:585-601)
    path = _write(tmp_path, _with_materials(
        [{**DISNEY, "thin": True, "scatter_distance": {"values": [0.5, 0.3, 0.2]}}]))
    mats = load_scene(path).scene.materials
    assert mats["n_lobes"][-1] > 0 and not mats["has_bssrdf"][-1]


@pytest.mark.parametrize("integrator", ["Debug", "DirectLighting", "Volpath", "SPPM"])
def test_other_kernels_raise_naming_disney(tmp_path, capsys, integrator):
    """Debug, DirectLighting and Volpath name the Disney lobes announcing
    the wavefront loop.  SPPM takes the plain Disney material (the SPPM
    kernels' wide instances) and raises naming the lobes of a transmissive
    one, which the JAX SPPM kernels refuse too."""
    path = _write(tmp_path, _with_materials([{**DISNEY, **CASES["plain"]}], integrator))
    job = load_scene(path)
    if integrator in ("Debug", "DirectLighting", "Volpath"):
        assert select_kernel(job, make_sampler(job)) == WAVEFRONT
        err = capsys.readouterr().err
        assert "Disney diffuse (DisneyMaterial) lobes" in err and "wavefront loop" in err
        return
    if integrator == "SPPM":
        assert select_kernel(job, make_sampler(job))[0] == "sppm"
        path = _write(tmp_path, _with_materials([{**DISNEY, **CASES["spec_trans"]}], integrator))
        with pytest.raises(NotImplementedError,
                           match=r"microfacet transmission \(.*DisneyMaterial spec_trans\) lobes"):
            job = load_scene(path)
            select_kernel(job, make_sampler(job))
