"""The wavefront loop's brute-force geometry, surface interaction, BSDF
methods and warps against the JAX package.

K4's plain version (ops/intersect_kernel.intersect_triangles_reference)
is held to the JAX kernel `intersect_triangles_pallas` in interpret mode
on the JAX pallas test's 36 seeded triangles and 1000 seeded rays, aimed
near the triangles, with
infinite and finite t_max: hit and triangle equal, t within rtol 1e-6.
SceneCtx's shaded hits on the fixture, `bsdf/eval` on the fixture's
materials (plus mirror and glass) and the hemisphere warps are held to the
JAX package on the same seeded inputs, carried across as numpy (the
tolerances are stated at each assert).
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.accel import geometry as jgeom
from rs_ray_toy_tpu.bsdf import eval as jeval
from rs_ray_toy_tpu.bsdf.lobes import BXDF_ALL, BXDF_SPECULAR, BXDF_TRANSMISSION
from rs_ray_toy_tpu.core import sampling as jsampling
from rs_ray_toy_tpu.core import vec as jvec
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.ops.intersect_pallas import intersect_triangles_pallas, pack_triangles
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu.scene.types import empty_spheres
from rs_ray_toy_tpu_torch.accel import geometry as geom
from rs_ray_toy_tpu_torch.bsdf import eval as beval
from rs_ray_toy_tpu_torch.bsdf.lobes import LOBE_MF_REFL
from rs_ray_toy_tpu_torch.core import sampling, vec
from rs_ray_toy_tpu_torch.interop import from_jax_scene_ctx
from rs_ray_toy_tpu_torch.ops import intersect_kernel as ik
from tests.test_bvh import _random_rays, _random_tris

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
EXTRA_MATERIALS = [
    {"material_type": "MirrorMaterial", "material_name": "mat_mirror"},
    {"material_type": "GlassMaterial", "material_name": "mat_glass", "eta": 1.5},
]
t32 = lambda a: torch.as_tensor(np.array(a), dtype=torch.float32)


def aimed_rays(tri, n, seed):
    """The JAX test's random origins, each aimed near a random triangle's
    centroid, so that most rays hit something."""
    o, _ = _random_rays(n, seed=seed)
    r = np.random.default_rng(seed)
    c = (np.asarray(tri.p0) + np.asarray(tri.p1) + np.asarray(tri.p2)) / 3.0
    target = c[r.integers(0, c.shape[0], n)] + r.normal(0.0, 0.4, (n, 3))
    d = target - np.asarray(o)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, jnp.asarray(d, jnp.float32)


@pytest.mark.parametrize("capped", [False, True])
def test_plain_k4_matches_jax_kernel(capped):
    tri = _random_tris(36, seed=5)
    o, d = aimed_rays(tri, 1000, 6)
    packed = pack_triangles(np.asarray(tri.p0), np.asarray(tri.p1), np.asarray(tri.p2))
    t_max = jnp.full((1000,), jnp.inf, jnp.float32)
    if capped:  # cut every other hit off with a finite t_max
        t_full, _, hit_full = intersect_triangles_pallas(packed, o, d, t_max, interpret=True)
        keep = np.arange(1000) % 2 == 0
        t_max = jnp.where(hit_full & ~keep, t_full * 0.5, jnp.where(hit_full, t_full * 1.5, 50.0))
    t_j, idx_j, hit_j = (np.asarray(x) for x in
                         intersect_triangles_pallas(packed, o, d, t_max, interpret=True))
    ours = ik.pack_triangles(tri.p0, tri.p1, tri.p2)
    np.testing.assert_array_equal(ours, np.asarray(packed))
    t, idx, hit = ik.intersect_triangles(t32(ours), t32(o), t32(d), t32(t_max))
    assert (50 if capped else 100) < hit_j.sum() < 1000
    np.testing.assert_array_equal(hit.numpy(), hit_j)
    np.testing.assert_array_equal(idx.numpy()[hit_j], idx_j[hit_j])
    np.testing.assert_allclose(t.numpy()[hit_j], t_j[hit_j], rtol=1e-6)
    assert np.isinf(t.numpy()[~hit_j]).all() and (idx.numpy()[~hit_j] == -1).all()
    # accel/geometry's brute-force queries are this plain version, as
    # intersect_brute / occluded_brute are the JAX package's
    jh = jgeom.intersect_brute(tri, empty_spheres(), o, d, t_max)
    h = geom.intersect_brute(t32(ours), t32(o), t32(d), t32(t_max))
    np.testing.assert_array_equal(h.valid.numpy(), np.asarray(jh.valid))
    np.testing.assert_array_equal(h.index.numpy(), np.asarray(jh.index))
    np.testing.assert_array_equal(h.kind.numpy(), np.asarray(jh.kind))
    np.testing.assert_array_equal(geom.occluded_brute(t32(ours), t32(o), t32(d), t32(t_max)).numpy(),
                                  np.asarray(jgeom.occluded_brute(tri, empty_spheres(), o, d, t_max)))


def _scene(tmp_path):
    cfg = json.loads((SAMPLES / "scene.json").read_text())
    cfg["materials"].extend(EXTRA_MATERIALS)
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    (tmp_path / "scene.json").write_text(json.dumps(cfg))
    return str(tmp_path / "scene.json")


def _fixture_rays(n, seed):
    """Seeded rays from near the camera toward the fixture's cubes."""
    r = np.random.default_rng(seed)
    o = r.normal(0.0, 0.3, (n, 3))
    target = np.stack([r.uniform(33.0, 38.0, n), r.uniform(-8.0, 8.0, n),
                       r.uniform(-5.0, 5.0, n)], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_surface_interaction_matches_jax(tmp_path):
    """The fixture's shaded hits: p, ng, ns, uv, dpdu, dpdv within rtol
    1e-5 / atol 1e-5 (uv recomputed from the barycentrics in either
    package), t within rtol 1e-6, triangle and material equal."""
    jctx = JaxSceneCtx(jax_load_scene(_scene(tmp_path)).scene)
    ctx = from_jax_scene_ctx(jctx, "cpu")
    o, d = _fixture_rays(4096, 11)
    t_max = np.full(4096, np.inf, np.float32)
    jhit, jsi = jctx.intersect_shaded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    hit, si = ctx.intersect_shaded(t32(o), t32(d), t32(t_max))
    valid = np.asarray(jhit.valid)
    assert valid.sum() > 400
    np.testing.assert_array_equal(hit.valid.numpy(), valid)
    np.testing.assert_array_equal(hit.index.numpy()[valid], np.asarray(jhit.index)[valid])
    np.testing.assert_allclose(hit.t.numpy()[valid], np.asarray(jhit.t)[valid], rtol=1e-6)
    np.testing.assert_array_equal(si.mat.numpy(), np.asarray(jsi.mat))
    for f in ("p", "ng", "ns", "uv", "dpdu", "dpdv", "wo"):
        np.testing.assert_allclose(getattr(si, f).numpy()[valid], np.asarray(getattr(jsi, f))[valid],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    # spawn offsets along ng
    w = _fixture_rays(4096, 12)[1]
    np.testing.assert_allclose(
        geom.offset_ray_origin(si.p, si.ng, t32(w)).numpy()[valid],
        np.asarray(jgeom.offset_ray_origin(jsi.p, jsi.ng, jnp.asarray(w)))[valid], rtol=1e-6, atol=1e-6)


def _frames(n, seed):
    """Seeded unit normals, tangents and directions on both sides."""
    r = np.random.default_rng(seed)
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)
    ns = unit(r.normal(size=(n, 3)))
    dpdu = r.normal(size=(n, 3)).astype(np.float32)
    dpdu[: n // 16] = 0.0  # degenerate dpdu: the coordinate-system fallback
    return ns, dpdu, unit(r.normal(size=(n, 3))), unit(r.normal(size=(n, 3))), \
        r.uniform(0.0, 1.0, (n, 2)).astype(np.float32)


def test_bsdf_methods_match_jax(tmp_path):
    """Bsdf::f / pdf (flags ALL & ~SPECULAR), num_components and
    Bsdf::sample_f of every fixture material (matte, plastic, metal,
    mirror, glass) on 2048 seeded frames and directions: f and pdf within
    rtol 1e-4 / atol 1e-6; the sample (validity, f, wi, pdf at rtol 1e-4 /
    atol 1e-5, the transmitted flag) equal on every lane whose chosen lobe
    is not a microfacet, and on 85% of those where it is: the reference's
    Trowbridge-Reitz slope cancels two ~1e10 terms (ROADMAP Queue 3), so
    a last-bit difference in the stretched direction moves it, and over
    isotropic seeded directions about one microfacet sample in ten moves
    (the renders' lit rays meet it far less often)."""
    jctx = JaxSceneCtx(jax_load_scene(_scene(tmp_path)).scene)
    ctx = from_jax_scene_ctx(jctx, "cpu")
    n = 2048
    ns, dpdu, wo, wi, u = _frames(n, 3)
    jfr = jeval.make_frame(jnp.asarray(ns), jnp.asarray(ns), jnp.asarray(dpdu))
    fr = beval.make_frame(t32(ns), t32(ns), t32(dpdu))
    np.testing.assert_allclose(fr.ss.numpy(), np.asarray(jfr.ss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fr.ts.numpy(), np.asarray(jfr.ts), rtol=1e-5, atol=1e-6)
    nonspec = BXDF_ALL & ~BXDF_SPECULAR
    n_mf = 0
    for m in range(int(np.asarray(jctx.mats["n_lobes"]).shape[0])):
        mat = jnp.full((n,), m, jnp.int32)
        jp = jeval.gather_lobes(jctx.mats, None, mat, static_kinds=jctx.static_kinds)
        p = ctx.mat_rows[torch.full((n,), m)]
        np.testing.assert_array_equal(beval.num_components(p, nonspec).numpy(),
                                      np.asarray(jeval.num_components(jp, nonspec)))
        jf, jpdf = jeval.bsdf_f_pdf(jp, jfr, jnp.asarray(wo), jnp.asarray(wi), nonspec)
        f, pdf = beval.bsdf_f_pdf(p, fr, t32(wo), t32(wi), nonspec)
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-4, atol=1e-6)
        jbs = jeval.bsdf_sample(jp, jfr, jnp.asarray(wo), jnp.asarray(u), BXDF_ALL)
        bs = beval.bsdf_sample(p, fr, t32(wo), t32(u))
        valid = np.asarray(jbs.valid)
        spec_trans = BXDF_SPECULAR | BXDF_TRANSMISSION
        jtrans = valid & ((np.asarray(jbs.sampled_flags) & spec_trans) == spec_trans)
        same = (bs.valid.numpy() == valid) & (bs.transmitted.numpy() == jtrans)
        for ours, theirs in ((bs.f, jbs.f), (bs.wi_world, jbs.wi_world),
                             (bs.pdf[:, None], jbs.pdf[:, None])):
            same &= np.isclose(ours.numpy(), np.asarray(theirs), rtol=1e-4, atol=1e-5).all(-1)
        n_lob = int(p[0, 15])
        comp = np.minimum((u[:, 0] * n_lob).astype(np.int64), n_lob - 1)
        mf = p[0, 16 + 16 * torch.as_tensor(comp)].numpy() == LOBE_MF_REFL
        assert same[~mf].all(), (m, np.flatnonzero(~same & ~mf)[:5])
        if mf.any():
            n_mf += 1
            assert same[mf].mean() >= 0.85, (m, same[mf].mean())
    assert n_mf == 2  # plastic and metal


def test_warps_match_jax():
    u = np.random.default_rng(4).uniform(0.0, 1.0, (4096, 2)).astype(np.float32)
    for ours, theirs in ((sampling.cosine_sample_hemisphere, jsampling.cosine_sample_hemisphere),
                         (sampling.uniform_sample_hemisphere, jsampling.uniform_sample_hemisphere)):
        # atol 1e-5 on unit vectors: z = sqrt(1 - x^2 - y^2) near the rim
        # magnifies the last-bit differences of the two cos / sin
        np.testing.assert_allclose(ours(t32(u)).numpy(), np.asarray(theirs(jnp.asarray(u))),
                                   rtol=1e-5, atol=1e-5)
    ns, _, wo, _, _ = _frames(4096, 8)
    np.testing.assert_array_equal(vec.faceforward(t32(ns), t32(wo)).numpy(),
                                  np.asarray(jvec.faceforward(jnp.asarray(ns), jnp.asarray(wo))))
    for ours, theirs in zip(vec.coordinate_system(t32(ns)), jvec.coordinate_system(jnp.asarray(ns))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-6)
