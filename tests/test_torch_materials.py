"""The materials only the wavefront Path loop renders in the port, against
the JAX package on the CPU: Oren-Nayar matte (sigma > 0), rough glass,
TranslucentMaterial, MixMaterial, and thin or transmissive Disney.

- Packed material tables equal JAX's, array for array (the loader's
  recipes, the per-lobe `scale` among them), for each of those, a Mix of
  two 3-lobe materials and a Mix past 8 lobes (cut to the first 8).
- Per lobe, on 4,096 seeded local-frame (wo, wi, u), the bars of
  tests/test_torch_disney.py: Oren-Nayar, lambert transmission,
  microfacet transmission (joint and separable Smith G) and the scaled
  lambert and microfacet reflection of Translucent.
- The Bsdf methods of each new material of samples/scene_materials.json,
  and of a Mix of smooth glass and matte (a fresnel-specular lobe beside
  another, which only the wavefront loop takes), on 2,048 seeded frames: num_components, Bsdf::f and Bsdf::pdf (rtol 1e-4,
  the bar of tests/test_torch_intersect.py) and Bsdf::sample_f, whose pdf
  sums the other lobes' where the chosen lobe does not reflect
  (reflection.rs:358): equal on every lane whose chosen lobe is not a
  Trowbridge-Reitz sample, on 80% of those where it is (the JAX
  package's own two samplers agree on ~80%: ROADMAP Queue 3).
- The wavefront li_path against JAX li_path on samples/scene_materials.json
  at 80x45 x 16 (brute force) and on its 6x6 grid of cubes at 72x41 x 16
  and max_depth 3 (456 triangles, over the BVH), at the per-ray bar: under 0.5% of rays
  off by more than 1e-3 relative, the 99th percentile below 1e-5, means
  within 3e-3, at least 1,000 lit rays.
- The routes: the fixture announces the wavefront loop on stderr; the
  path kernel names what it lacks in each material; Debug,
  DirectLighting, Volpath and SPPM raise naming the lobes or the scale.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.accel.bvh import build_bvh as jax_build_bvh
from rs_ray_toy_tpu.bsdf import eval as jeval
from rs_ray_toy_tpu.bsdf.lobes import BXDF_ALL, BXDF_SPECULAR
from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.integrators.path import li_path as jax_li_path
from rs_ray_toy_tpu.ops.bvh_pallas import pack_bvh_tables
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu.scene.types import empty_spheres
from rs_ray_toy_tpu_torch.bsdf import eval as beval
from rs_ray_toy_tpu_torch.bsdf.lobes import (
    LOBE_DISNEY_MICROFACET_REFL,
    LOBE_LAMBERT_REFL,
    LOBE_LAMBERT_TRANS,
    LOBE_MF_REFL,
    LOBE_MF_TRANS,
    LOBE_OREN_NAYAR,
)
from rs_ray_toy_tpu_torch.integrators.path import li_path
from rs_ray_toy_tpu_torch.interop import from_jax_scene_ctx
from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.render import WAVEFRONT, make_sampler, select_kernel
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import write_grid_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene
from tests.test_torch_disney import (
    _tables_equal,
    _with_materials,
    _write,
    check_lobe,
    lobe_pairs,
)

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
FIXTURE = SAMPLES / "scene_materials.json"

torch.set_num_threads(min(2, torch.get_num_threads()))

MATS = {m["material_name"]: m for m in json.loads(FIXTURE.read_text())["materials"]}
DISNEY3 = {"material_type": "DisneyMaterial", "material_name": "mat_d3", "roughness": 0.3,
           "metallic": 0.5}
DISNEY5 = {"material_type": "DisneyMaterial", "material_name": "mat_d5", "roughness": 0.4,
           "metallic": 0.3, "sheen": 0.5, "clearcoat": 0.6}
TABLE_CASES = {
    "oren_nayar": [MATS["mat_oren_nayar"]],
    "rough_glass": [MATS["mat_rough_glass"]],
    "translucent": [MATS["mat_translucent"]],
    "mix_matte_metal": [MATS["mat_mix"]],
    "mix_of_two_3_lobe": [DISNEY3, MATS["mat_translucent"],
                          {"material_type": "MixMaterial", "material_name": "mat_mix3",
                           "mat1": "mat_d3", "mat2": "mat_translucent",
                           "scale": {"values": [0.2, 0.5, 0.7]}}],
    "mix_past_8_lobes": [DISNEY5, {**DISNEY5, "material_name": "mat_d5b", "clearcoat": 0.3},
                         {"material_type": "MixMaterial", "material_name": "mat_mix10",
                          "mat1": "mat_d5", "mat2": "mat_d5b"}],
    "disney_thin": [MATS["mat_disney_thin"]],
    "disney_spec_trans": [MATS["mat_disney_trans"]],
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_material_tables_equal_jax(tmp_path, case):
    mats = TABLE_CASES[case]

    def edit(cfg):
        cfg["materials"] += mats
        cfg["Aggregate"]["primitives"][0]["material_name"] = mats[-1]["material_name"]

    ours = _tables_equal(_write(tmp_path, edit))
    if case == "mix_past_8_lobes":
        assert ours["n_lobes"][-1] == 8


LOBE_CASES = {
    "oren_nayar": (LOBE_OREN_NAYAR,),
    "lambert_transmission": (LOBE_LAMBERT_TRANS,),
    "microfacet_transmission": (LOBE_MF_TRANS,),
    "scaled_reflection": (LOBE_LAMBERT_REFL, LOBE_MF_REFL),
}


@pytest.mark.parametrize("case", sorted(LOBE_CASES))
def test_lobe_matches_jax(tmp_path, case):
    """Every lobe of these kinds in the fixture's new materials: microfacet
    transmission of rough glass and thin Disney (joint G) and of the
    transmissive Disney material (separable G); Translucent's scaled
    reflection lobes."""
    names = ["mat_oren_nayar", "mat_rough_glass", "mat_translucent", "mat_disney_thin",
             "mat_disney_trans"]
    if case == "scaled_reflection":
        names = ["mat_translucent"]
    path = _write(tmp_path, _with_materials([MATS[n] for n in names]))
    pairs = lobe_pairs(path, LOBE_CASES[case], 4096)
    assert pairs
    for i, (k, jp, lob) in enumerate(pairs):
        check_lobe(k, jp, lob, 4096, 21 + i, tr_sampled=k in (LOBE_MF_TRANS, LOBE_MF_REFL))


def _frames(n, seed):
    r = np.random.default_rng(seed)
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)
    ns = unit(r.normal(size=(n, 3)))
    return ns, r.normal(size=(n, 3)).astype(np.float32), unit(r.normal(size=(n, 3))), \
        unit(r.normal(size=(n, 3))), r.uniform(0.0, 1.0, (n, 2)).astype(np.float32)


TR_SAMPLED = (LOBE_MF_REFL, LOBE_MF_TRANS, LOBE_DISNEY_MICROFACET_REFL)


MIX_GLASS = [{"material_type": "GlassMaterial", "material_name": "mat_glass"},
             {"material_type": "MixMaterial", "material_name": "mat_mix_glass",
              "mat1": "mat_glass", "mat2": "mat_matte", "scale": {"values": [0.5, 0.5, 0.5]}}]
NEW_MATERIALS = {
    "fixture": ["mat_oren_nayar", "mat_rough_glass", "mat_translucent", "mat_mix",
                "mat_disney_thin", "mat_disney_trans"],
    # smooth glass's fresnel-specular lobe beside others: the wavefront loop only
    "mix_with_glass": ["mat_mix_glass"],
}


@pytest.mark.parametrize("scene", sorted(NEW_MATERIALS))
def test_bsdf_methods_match_jax(tmp_path, scene):
    path = str(FIXTURE) if scene == "fixture" else _write(tmp_path, _with_materials(MIX_GLASS))
    jctx = JaxSceneCtx(jax_load_scene(path).scene)
    ctx = from_jax_scene_ctx(jctx, "cpu")
    n = 2048
    ns, dpdu, wo, wi, u = _frames(n, 5)
    t = lambda a: torch.as_tensor(a)
    jfr = jeval.make_frame(jnp.asarray(ns), jnp.asarray(ns), jnp.asarray(dpdu))
    fr = beval.make_frame(t(ns), t(ns), t(dpdu))
    nonspec = BXDF_ALL & ~BXDF_SPECULAR
    names = [m["material_name"] for m in json.loads(Path(path).read_text())["materials"]]
    checked = set()
    for m, name in enumerate(names):
        if name not in NEW_MATERIALS[scene]:
            continue  # the fixture's first three: tests/test_torch_intersect.py
        mat = jnp.full((n,), m, jnp.int32)
        jp = jeval.gather_lobes(jctx.mats, None, mat, static_kinds=jctx.static_kinds)
        p = ctx.mat_rows[torch.full((n,), m)]
        np.testing.assert_array_equal(beval.num_components(p, nonspec).numpy(),
                                      np.asarray(jeval.num_components(jp, nonspec)))
        jf, jpdf = jeval.bsdf_f_pdf(jp, jfr, jnp.asarray(wo), jnp.asarray(wi), nonspec)
        f, pdf = beval.bsdf_f_pdf(p, fr, t(wo), t(wi), nonspec)
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        jbs = jeval.bsdf_sample(jp, jfr, jnp.asarray(wo), jnp.asarray(u), BXDF_ALL)
        bs = beval.bsdf_sample(p, fr, t(wo), t(u))
        same = bs.valid.numpy() == np.asarray(jbs.valid)
        for ours, theirs in ((bs.f, jbs.f), (bs.wi_world, jbs.wi_world),
                             (bs.pdf[:, None], jbs.pdf[:, None])):
            same &= np.isclose(ours.numpy(), np.asarray(theirs), rtol=1e-4, atol=1e-5).all(-1)
        n_lob = int(p[0, 15])
        comp = np.minimum((u[:, 0] * n_lob).astype(np.int64), n_lob - 1)
        tr = np.isin(p[0, 16 + 16 * torch.as_tensor(comp)].numpy(), TR_SAMPLED)
        assert same[~tr].all(), (name, np.flatnonzero(~same & ~tr)[:5])
        if tr.any():
            assert same[tr].mean() >= 0.8, (name, same[tr].mean())
        checked.add(name)
    assert checked == set(NEW_MATERIALS[scene])


def _bar(l, l_ref):
    assert np.isfinite(l).all() and l_ref.max() > 0
    assert (l_ref.max(-1) > 0).sum() >= 1000
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    diverged = float((rel.max(-1) > 1e-3).mean())
    assert diverged < 5e-3, f"{diverged:.2%} of rays diverged"
    assert float(np.quantile(rel, 0.99)) < 1e-5, "bulk not bit-level"
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())


@pytest.mark.parametrize("geometry", ["fixture", "grid6"])
def test_wavefront_li_path_matches_jax(tmp_path, geometry):
    if geometry == "fixture":
        path, (w_, h_) = _write(tmp_path, lambda c: c.update(json.loads(FIXTURE.read_text()))), \
            (80, 45)
    else:
        # max_depth 3: JAX's trace of li_path grows with the depth
        path, (w_, h_) = write_grid_scene(str(tmp_path), ny=6, nz=6, base=str(FIXTURE),
                                          max_depth=3), (72, 41)
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
    cam = JaxCamera(job.camera, job.film, pupil_samples=1 << 10)
    o, d, w = cam.generate_rays(pxy + jsampler.get_2d(jp, js, 0), jsampler.get_2d(jp, js, 1))
    l_ref = np.asarray(jax_li_path(jctx, o, d, w, jsampler, jp, js, job.integrator))
    pjob = load_scene(path)
    T = lambda a: torch.as_tensor(np.array(a))
    l = li_path(ctx, T(o), T(d), T(w), StratifiedSampler(pjob.sampler, seed=0),
                T(pid.astype(np.int64)), T(sid.astype(np.int64)), pjob.integrator).numpy()
    _bar(l, l_ref)


def test_routes(capsys):
    job = load_scene(str(FIXTURE))
    assert select_kernel(job, make_sampler(job)) == WAVEFRONT
    assert "wavefront loop" in capsys.readouterr().err


@pytest.mark.parametrize("name,feature", [
    ("mat_oren_nayar", "Oren-Nayar"),
    ("mat_rough_glass", "microfacet transmission"),
    ("mat_translucent", "TranslucentMaterial"),
    ("mat_mix", "scaled lobes"),
    ("mat_disney_thin", "more than 5 lobes"),
    ("mat_disney_trans", "microfacet transmission"),
])
def test_path_kernel_names_what_it_lacks(tmp_path, name, feature):
    path = _write(tmp_path, _with_materials([MATS[name]]))
    job = load_scene(path)
    reason = pmk.unsupported_feature(job.scene, job.integrator, make_sampler(job))
    assert feature in reason


@pytest.mark.parametrize("integrator,name,feature", [
    ("Debug", "mat_oren_nayar", "Oren-Nayar"),
    ("DirectLighting", "mat_mix", "scaled lobes"),
    ("Volpath", "mat_translucent", "TranslucentMaterial"),
    ("SPPM", "mat_rough_glass", "microfacet transmission"),
])
def test_other_kernels_raise_naming_the_material(tmp_path, capsys, integrator, name, feature):
    """SPPM raises naming the material's lobes; Debug, DirectLighting and
    Volpath name them announcing the wavefront loop."""
    path = _write(tmp_path, _with_materials([MATS[name]], integrator))
    job = load_scene(path)
    if integrator in ("Debug", "DirectLighting", "Volpath"):
        assert select_kernel(job, make_sampler(job)) == WAVEFRONT
        err = capsys.readouterr().err
        assert feature in err and "wavefront loop" in err
        return
    with pytest.raises(NotImplementedError, match=feature):
        select_kernel(job, make_sampler(job))
