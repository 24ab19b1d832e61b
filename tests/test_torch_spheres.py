"""Spheres, every light kind and constant environments: the port's
loader tables, sphere queries, light sampling and Distribution2D against
the JAX package's, on the CPU.

- Loader: a fixture variant with an instanced sphere, a partial sphere,
  and point, distant, sphere, partial-sphere, triangle and two infinite
  lights (one sampled, one escape-only, with l and scale not 1) loads to
  the JAX loader's sphere and light tables (float32, equal or within
  1e-6), world radius and environment distributions; and packs to the
  JAX pack_scene's sphere lobes, light rows and environment constants.
- accel/geometry: intersect_spheres and the sphere branch of
  surface_interaction on 4,096 seeded rays, partial spheres included:
  hit, sphere and t (rtol 1e-6), shading geometry within 1e-5.
- lights/lights: sample_li, pdf_li (for the directions a BSDF might
  draw) and le_escape for each light kind on 4,096 seeded points, within
  rtol 1e-4 / atol 1e-6 (float32 transcendental rounding).
- core/sampling: Distribution2D's sample_continuous_2d and pdf_2d on a
  seeded 12 x 9 function with an empty row, within 1e-6.
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.accel import geometry as jgeom
from rs_ray_toy_tpu.core import sampling as jsampling
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.lights import lights as jlights
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.accel import geometry as geom
from rs_ray_toy_tpu_torch.core import sampling
from rs_ray_toy_tpu_torch.lights import lights as lmod
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
N_RAYS = 4096

torch.set_num_threads(min(2, torch.get_num_threads()))


def _scene(tmp_path, with_triangles=True):
    cfg = json.loads((SAMPLES / "scene.json").read_text())
    cfg["objs"].append({"obj_name": "lamp", "filename": "cube.obj", "world_pos": [33.0, 0.0, 6.0]})
    prims = cfg["Aggregate"]["primitives"] if with_triangles else []
    prims += [
        {"primitive_type": "sphere", "material_name": "mat_plastic", "radius": 0.7,
         "instances": [{"world_pos": [34.0, 1.5, 0.5]},
                       {"world_pos": [35.0, -1.5, -0.5], "rotation_axis": [0.0, 1.0, 0.0],
                        "rotation_angle": 40.0, "scale": [1.0, 1.5, 1.0]}]},
        {"primitive_type": "sphere", "material_name": "mat_matte", "radius": 1.2,
         "world_pos": [34.0, 0.0, 2.0], "z_min": -0.5, "z_max": 0.9, "phi_max": 250.0,
         "rotation_axis": [1.0, 0.0, 0.0], "rotation_angle": 30.0},
        # unknown material: skipped, as in the reference
        {"primitive_type": "sphere", "material_name": "nope", "radius": 3.0},
    ]
    cfg["Aggregate"]["primitives"] = prims
    cfg["lights"] += [
        {"light_type": "distant", "l": {"values": [1.5, 1.2, 1.0]}, "scale": {"values": [2.0] * 3},
         "from": [0.0, 0.0, 0.0], "to": [1.0, 0.3, -0.6], "rotation_axis": [0.0, 0.0, 1.0],
         "rotation_angle": 10.0},
        {"light_type": "diffuse", "spectrum": {"values": [30.0, 25.0, 20.0]},
         "light_shape": {"shape_type": "sphere", "radius": 0.5, "world_pos": [33.0, 3.0, 1.0]}},
        {"light_type": "diffuse", "spectrum": {"values": [10.0, 10.0, 10.0]}, "n_samples": 4,
         "light_shape": {"shape_type": "sphere", "radius": 0.4, "world_pos": [32.0, -3.0, 2.0],
                         "z_max": 0.1}},
        {"light_type": "diffuse", "spectrum": {"values": [20.0, 20.0, 20.0]},
         "light_shape": {"shape_type": "triangle", "obj_name": "lamp", "tri_num": 8}},
        {"light_type": "infinite", "l": {"values": [2.0, 1.5, 0.5]}, "scale": {"values": [2.0] * 3},
         "rotation_axis": [0.0, 1.0, 1.0], "rotation_angle": 25.0},
    ]
    cfg["infinite_lights"] = [{"light_type": "infinite", "l": {"values": [0.7, 0.7, 0.7]}}]
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(port job, JAX job) with and without the cubes."""
    out = {}
    for tris in (True, False):
        path = _scene(tmp_path_factory.mktemp(f"tris{int(tris)}"), tris)
        out[tris] = (load_scene(path), jax_load_scene(path))
    return out


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("tris", [True, False])
def test_loader_tables_equal(scenes, tris):
    job, jjob = scenes[tris]
    sph, jsph = job.scene.spheres, jjob.scene.spheres
    assert sph.count == int(jsph.count) == 3
    for key in ("o2w", "radius", "z_min", "z_max", "theta_min", "theta_max", "phi_max", "mat"):
        assert np.array_equal(getattr(sph, key), np.asarray(getattr(jsph, key))), key
    _close(sph.w2o, jsph.w2o)
    assert job.scene.triangles.count == int(jjob.scene.triangles.count)
    lt, jlt = job.scene.lights, jjob.scene.lights
    for key in ("kind", "shape_kind", "shape_index", "n_samples"):
        assert np.array_equal(getattr(lt, key), np.asarray(getattr(jlt, key))), key
    for key in ("p", "emit", "w_light", "sph_o2w", "sph_w2o", "sph_radius", "tri_p", "area"):
        _close(getattr(lt, key), getattr(jlt, key))
    # the bound of triangles and sphere boxes: distant and environment
    # shadow rays aim at twice this radius
    assert lt.world_radius == np.float32(np.asarray(jlt.world_radius))
    _close(lmod.power(lt), jlights.power(jlt), rtol=1e-6)
    assert len(job.scene.infinite) == len(jjob.scene.infinite) == 2
    for env, jenv in zip(job.scene.infinite, jjob.scene.infinite):
        assert env.escape_le == jenv["escape_le"]
        # the radiance is the map's texel; l and scale reach only `power`
        assert tuple(env.rgb) == jpmk._env_constant_rgb(jenv) == (1.0, 1.0, 1.0)
        _close(env.to_world, jenv["to_world"])
        _close(env.to_local, jenv["to_local"])
        dev, jdev = env.dist.as_device("cpu"), jenv["dist"]
        for key in ("cond_func", "cond_cdf", "cond_int"):
            assert np.array_equal(dev[key].numpy(), np.asarray(jdev[key])), key
        for key in ("func", "cdf", "func_int"):
            assert np.array_equal(dev["marginal"][key].numpy(), np.asarray(jdev["marginal"][key]))


def test_pack_scene_wide_tables_equal(tmp_path):
    """The path kernel's sphere rows, light rows and environment constants
    equal the JAX pack_scene's SceneStatic, on the scene without what the
    kernel does not take (the partial sphere, the distant, triangle and
    partial-sphere lights)."""
    cfg = json.loads(Path(_scene(tmp_path)).read_text())
    cfg["Aggregate"]["primitives"].pop(-2)
    shape = lambda l: l.get("light_shape", {})
    cfg["lights"] = [l for l in cfg["lights"]
                     if l["light_type"] in ("point", "infinite")
                     or shape(l).get("shape_type") == "sphere" and "z_max" not in shape(l)]
    path = tmp_path / "kernel.json"
    path.write_text(json.dumps(cfg))
    job, jjob = load_scene(str(path)), jax_load_scene(str(path))
    ctx = JaxSceneCtx(jjob.scene)
    assert jpmk.supports(ctx, jjob.integrator, None, None)
    assert pmk.unsupported_feature(job.scene, job.integrator, None) is None
    packed = pmk.pack_scene(job.scene, "cpu")
    wide = jpmk.pack_scene(ctx)[5]
    rows = packed.sph_table.numpy()
    assert rows.shape[0] == len(wide.spheres) == 2
    for row, s in zip(rows, wide.spheres):
        assert tuple(row[0:12]) == s.w2o and tuple(row[96:108]) == s.o2w
        assert row[12] == s.radius and row[15] == s.n_lobes and row[31] == s.mat_eta
        for l, lob in enumerate(s.lobes[: s.n_lobes]):
            b = 16 + 16 * l
            assert row[b] == lob.kind and tuple(row[b + 1:b + 10]) == lob.s0 + lob.s1 + lob.s2
            assert tuple(row[b + 10:b + 15]) == (lob.au, lob.av, lob.fres, lob.eta_a, lob.eta_b)
    assert packed.light_kind == tuple(l.kind for l in wide.lights) == (0, 0, 0, 2, 3)
    assert packed.light_emit == tuple(l.emit for l in wide.lights)
    for k, l in enumerate(wide.lights):
        if l.kind == 2:
            assert packed.light_o2w[k] == l.o2w and packed.light_radius[k] == l.radius
            assert packed.light_w2o[k] == tuple(l.w2o[i] for i in (0, 1, 2, 4, 5, 6, 8, 9, 10))
    env = next(l.env for l in wide.lights if l.kind == 3)
    assert packed.env == pmk.EnvC(*(getattr(env, f) for f in pmk.EnvC._fields))
    assert packed.esc_rgb == wide.esc_rgb and packed.world_radius == wide.world_radius


def _rays(seed, n=N_RAYS):
    """Seeded rays from around the camera toward the spheres, and some
    started inside them."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-2.0, -3.0, -3.0], [2.0, 3.0, 3.0], (n, 3))
    o[: n // 8] = rng.uniform([33.5, -1.0, 0.5], [34.5, 1.0, 2.5], (n // 8, 3))
    target = rng.uniform([33.0, -3.0, -2.0], [36.0, 3.0, 3.0], (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.random(n) < 0.2, rng.uniform(1.0, 40.0, n), np.inf)
    return o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)


def test_intersect_spheres_and_surface_match_jax(scenes):
    job, jjob = scenes[False]
    o, d, t_max = _rays(5)
    jsph = jjob.scene.spheres
    jt, ji, jh = (np.asarray(x) for x in jgeom.intersect_spheres(
        jsph, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)))
    sph = geom.sphere_tables(job.scene.spheres, "cpu")
    T = torch.as_tensor
    t, idx, hit = (x.numpy() for x in geom.intersect_spheres(sph, T(o), T(d), T(t_max)))
    assert 0.1 < hit.mean() < 0.9 and np.array_equal(hit, jh) and np.array_equal(idx, ji)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-6)
    # the partial sphere's clip: some rays pass through its cut-away part
    assert (ji == 2).any()
    jhit = jgeom.Hit(t=jnp.asarray(jt), kind=jnp.where(jh, jgeom.PRIM_SPHERE, jgeom.PRIM_NONE),
                     index=jnp.asarray(ji), valid=jnp.asarray(jh))
    jsi = jgeom.surface_interaction(jjob.scene.triangles, jsph, jhit, jnp.asarray(o),
                                    jnp.asarray(d))
    shade = geom.pack_shade_tables(job.scene.triangles, "cpu", sph)
    hit_t = geom.Hit(T(t), torch.where(T(hit), geom.PRIM_SPHERE, geom.PRIM_NONE), T(idx), T(hit))
    si = geom.surface_interaction(shade, hit_t, T(o), T(d))
    for key in ("p", "ng", "ns", "uv", "dpdu", "dpdv"):
        np.testing.assert_allclose(getattr(si, key).numpy()[hit], np.asarray(getattr(jsi, key))[hit],
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert np.array_equal(si.mat.numpy(), np.asarray(jsi.mat))


def test_brute_force_with_spheres_matches_jax(scenes):
    """intersect_brute over the cubes and the spheres: the closest of
    both, kind and index as the JAX package reports them."""
    job, jjob = scenes[True]
    o, d, t_max = _rays(6)
    jh = jgeom.intersect_brute(jjob.scene.triangles, jjob.scene.spheres, jnp.asarray(o),
                               jnp.asarray(d), jnp.asarray(t_max))
    from rs_ray_toy_tpu_torch.ops.intersect_kernel import pack_triangles

    tri = job.scene.triangles
    T = torch.as_tensor
    h = geom.intersect_brute(T(pack_triangles(tri.p0, tri.p1, tri.p2)), T(o), T(d), T(t_max),
                             geom.sphere_tables(job.scene.spheres, "cpu"))
    valid = np.asarray(jh.valid)
    assert np.array_equal(h.valid.numpy(), valid) and valid.mean() > 0.2
    assert np.array_equal(h.kind.numpy(), np.asarray(jh.kind))
    assert np.array_equal(h.index.numpy()[valid], np.asarray(jh.index)[valid])
    assert (np.asarray(jh.kind) == jgeom.PRIM_SPHERE).any() and (np.asarray(jh.kind) == 0).any()
    np.testing.assert_allclose(h.t.numpy()[valid], np.asarray(jh.t)[valid], rtol=1e-6)


def test_lights_match_jax(scenes):
    """sample_li, pdf_li and le_escape for every light of the scene, each
    light picked by about a sixth of the points."""
    job, jjob = scenes[True]
    rng = np.random.default_rng(7)
    n = N_RAYS
    p = rng.uniform([30.0, -4.0, -3.0], [37.0, 4.0, 4.0], (n, 3)).astype(np.float32)
    u = rng.random((n, 2)).astype(np.float32)
    n_lights = job.scene.lights.count
    idx = (np.arange(n) % n_lights).astype(np.int32)
    jls = jlights.sample_li(jjob.scene.lights, jjob.scene.infinite, jnp.asarray(idx),
                            jnp.asarray(p), jnp.asarray(u))
    table = lmod.scene_lights(job.scene, "cpu")
    T = torch.as_tensor
    wi, li, pdf, p_light, delta = lmod.sample_li(table, T(idx.astype(np.int64)), *T(p).unbind(-1),
                                                 *T(u).unbind(-1))
    kinds = job.scene.lights.kind[idx]
    assert np.array_equal(delta.numpy(), np.isin(kinds, (0, 1)))
    for ours, theirs in ((wi, jls.wi), (li, jls.li), (p_light, jls.p_light)):
        np.testing.assert_allclose(torch.stack(ours, -1).numpy(), np.asarray(theirs), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jls.pdf), rtol=1e-4, atol=1e-6)
    assert (pdf.numpy() > 0).mean() > 0.9
    # pdf_li along directions toward each light's neighbourhood (area
    # lights get hits and misses) and uniform ones (environments)
    w = np.asarray(jls.wi) + rng.normal(0.0, 0.05, (n, 3))
    w[kinds == 3] = rng.normal(size=(int((kinds == 3).sum()), 3))
    w = (w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(np.float32)
    jpdf = np.asarray(jlights.pdf_li(jjob.scene.lights, jjob.scene.infinite, jnp.asarray(idx),
                                     jnp.asarray(p), jnp.asarray(w)))
    ours = lmod.pdf_li(table, T(idx.astype(np.int64)), *T(p).unbind(-1), *T(w).unbind(-1)).numpy()
    np.testing.assert_allclose(ours, jpdf, rtol=1e-4, atol=1e-6)
    for k in (2, 3):
        assert (jpdf[kinds == k] > 0).mean() > 0.3, k
    esc = lmod.le_escape(table, n, "cpu").numpy()
    np.testing.assert_allclose(esc, np.asarray(jlights.le_escape(jjob.scene.infinite, jnp.asarray(w))),
                               atol=1e-6)
    assert np.all(esc == np.float32(1.0))


def test_distribution_2d_matches_jax():
    rng = np.random.default_rng(11)
    func = rng.random((9, 12)) * (rng.random((9, 12)) > 0.2)
    func[4] = 0.0  # an empty row: uniform conditional
    dist = sampling.Distribution2D(func.ravel(), 12, 9).as_device("cpu")
    jdist = jsampling.Distribution2D(func.ravel(), 12, 9).as_device()
    u = rng.random((N_RAYS, 2)).astype(np.float32)
    (x, y), pdf = sampling.sample_continuous_2d(dist, *torch.as_tensor(u).unbind(-1))
    jxy, jpdf = jsampling.sample_continuous_2d(jdist, jnp.asarray(u))
    np.testing.assert_allclose(torch.stack([x, y], -1).numpy(), np.asarray(jxy), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-6)
    p = rng.random((N_RAYS, 2)).astype(np.float32)
    np.testing.assert_allclose(sampling.pdf_2d(dist, *torch.as_tensor(p).unbind(-1)).numpy(),
                               np.asarray(jsampling.pdf_2d(jdist, jnp.asarray(p))), rtol=1e-6)
