"""K1's BVH instances on the node64 walk, on the CPU, and the loader's
lights in `infinite_lights`.

- The loader: a point, a distant and a diffuse (sphere) light listed under
  `infinite_lights` load as one more NEE light each, after the `lights`
  section's, and a light of an unknown light_type, or a diffuse light of an
  unknown shape_type, is skipped: the port's LightSoA equals the JAX
  loader's light rows, in order and value (float32, within 1e-6).  A light
  the port then loads but a kernel cannot take is refused by that kernel:
  the distant light sends Path to the wavefront loop, the sphere light is
  refused by SPPM.
- pack_scene(..., bvh=True): the node64 rows read back to the
  fused-children rows (boxes, axis, child references and leaf counts), the
  leaf rows `prims` are the leaf-order table's cols 0:9 and a zero pad,
  the table is the scene-order table in leaf order, and root_count is the
  row count exactly where the tree is one leaf (no node64 row); on the
  fixture, a 4x4 grid of cubes, one cube (one leaf) and a tree of
  STACK_DEPTH - 1 = 63 levels.  geometry_args hands the path kernel these
  tables and the other kernels the fused-children rows.
- The plain walk (PlainGeometry on the node64 rows, walk_node64) on seeded
  rays with infinite, finite and zero t_max: t and row (any hit: the row it
  stopped at) bit-equal to the walk over the fused-children rows, with
  equal slab and Moller-Trumbore counts; and against the JAX package's jnp
  walk (accel/traverse.intersect_bvh, compiled at XLA's backend
  optimisation level 0, as tests/test_torch_chunk_walk.py does): hit or
  miss equal on every ray, where both hit the triangle equal and t within
  rtol 1e-6 (the JAX kernel test's bar; its jnp walk keeps a 48-entry
  stack, so the 63-level tree is held to the fused-children walk only).
- K1's BVH render through the plain version (`li_path_mega` on a BVH
  pack) against JAX `li_path` on the same camera rays, at the parity bar of
  tests/test_megakernel.py:129-130 (under 0.5% of rays past 1e-3 relative,
  the 99th percentile below 1e-5, means within 3e-3), on the rays of the
  pixels that see the scene: a 4x4 grid of matte cubes, the smooth fixture
  in matte, and the subsurface fixture.
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.accel import bvh as jbvh
from rs_ray_toy_tpu.accel import traverse as jtraverse
from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.integrators.path import li_path as jax_li_path
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu.scene.types import empty_spheres
from rs_ray_toy_tpu_torch.accel.bvh import LEAF_COUNT_BITS, build_bvh, tree_depth
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.render import WAVEFRONT, make_sampler, select_kernel
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import write_deep_bvh_scene, write_grid_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene
from rs_ray_toy_tpu_torch.scene.types import LIGHT_DIFFUSE_AREA, LIGHT_DISTANT, LIGHT_POINT

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
N = 3000
T = lambda a: torch.as_tensor(np.array(a))

# the suite runs in several pytest workers on one host (tests/test_torch_direct_bvh.py)
torch.set_num_threads(min(2, torch.get_num_threads()))


def _write(tmp_path, edit, scene="scene.json"):
    """samples/<scene> with `edit` applied, its meshes beside it, in tmp_path."""
    cfg = json.loads((SAMPLES / scene).read_text())
    edit(cfg)
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    path = tmp_path / scene
    path.write_text(json.dumps(cfg))
    return str(path)


# ---- the loader: lights in infinite_lights ----

SPHERE_LIGHT = {"light_type": "diffuse", "spectrum": {"values": [20.0, 18.0, 15.0]},
                "n_samples": 2,
                "light_shape": {"shape_type": "sphere", "radius": 0.5,
                                "world_pos": [33.0, 3.0, 1.0]}}
# case: (the light put into infinite_lights, the kind of the row it adds or None)
INFINITE_SECTION = {
    "point": (None, LIGHT_POINT),  # the fixture's first light, copied
    "distant": ({"light_type": "distant", "l": {"values": [1.5, 1.2, 1.0]},
                 "scale": {"values": [2.0, 2.0, 2.0]}, "from": [0.0, 0.0, 0.0],
                 "to": [1.0, 0.3, -0.6]}, LIGHT_DISTANT),
    "diffuse": (SPHERE_LIGHT, LIGHT_DIFFUSE_AREA),
    "unknown_type": ({"light_type": "spot", "spectrum": {"values": [5.0, 5.0, 5.0]}}, None),
    "unknown_shape": (dict(SPHERE_LIGHT, light_shape={"shape_type": "disk", "radius": 0.5}),
                      None),
}


@pytest.mark.parametrize("case", sorted(INFINITE_SECTION))
def test_lights_in_infinite_lights_load_as_jax(tmp_path, capsys, case):
    light, kind = INFINITE_SECTION[case]

    def edit(cfg):
        cfg["infinite_lights"] = [dict(light if light is not None else cfg["lights"][0])]

    path = _write(tmp_path, edit)
    job, jjob = load_scene(path), jax_load_scene(path)
    lt, jlt = job.scene.lights, jjob.scene.lights
    n_base = len(json.loads((SAMPLES / "scene.json").read_text())["lights"])
    assert lt.count == int(jlt.count) == n_base + (kind is not None)
    for key in ("kind", "shape_kind", "shape_index", "n_samples"):
        assert np.array_equal(getattr(lt, key), np.asarray(getattr(jlt, key))), key
    for key in ("p", "emit", "w_light", "sph_o2w", "sph_w2o", "sph_radius", "tri_p", "area"):
        np.testing.assert_allclose(getattr(lt, key), np.asarray(getattr(jlt, key)), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    assert lt.world_radius == np.float32(np.asarray(jlt.world_radius))
    assert not job.scene.infinite and not jjob.scene.infinite
    if kind is not None:
        assert int(lt.kind[-1]) == kind  # after the lights section's
    # what the port now loads, the kernels hold to their subsets
    route = select_kernel(job, make_sampler(job))
    if kind == LIGHT_DISTANT:
        assert route == WAVEFRONT
        assert "lights other than" in capsys.readouterr().err
    else:
        assert route is not WAVEFRONT and route[0] == "path"
    if kind == LIGHT_DIFFUSE_AREA:
        def sppm(cfg):
            edit(cfg)
            cfg["Integrator"] = {"integrator_type": "SPPM", "max_depth": 3, "n_iters": 1}

        (tmp_path / "sppm").mkdir()
        job = load_scene(_write(tmp_path / "sppm", sppm))
        with pytest.raises(NotImplementedError, match="lights other than up to 8 point lights"):
            select_kernel(job, make_sampler(job))


# ---- pack_scene(..., bvh=True): the node64 rows and the leaf rows ----


def _one_cube(cfg):
    """The fixture's middle cube alone, matte: 12 triangles, one leaf."""
    cfg["Aggregate"]["primitives"] = [dict(cfg["Aggregate"]["primitives"][2],
                                           material_name="mat_matte")]


def _scene(tmp_path, name):
    if name == "fixture":
        return str(SAMPLES / "scene.json")
    if name == "one_cube":
        return _write(tmp_path, _one_cube)
    if name == "deep63":
        # reach 19 over 150 bulk triangles: the SAH builder's tree of 63 levels
        return write_deep_bvh_scene(str(tmp_path), integrator="Path", n_bulk=150, reach=19)
    return write_grid_scene(str(tmp_path), ny=4, nz=4)


@pytest.mark.parametrize("name", ["fixture", "grid4", "one_cube", "deep63"])
def test_pack_scene_node64_tables_read_back(tmp_path, name):
    job = load_scene(_scene(tmp_path, name))
    tri = job.scene.triangles
    flat = build_bvh(tri, pmk.BVH_LEAF)
    assert (tree_depth(flat) == pmk.STACK_DEPTH - 1) == (name == "deep63")
    packed = pmk.pack_scene(job.scene, "cpu", bvh=True)
    bvh, n = packed.bvh, packed.table.shape[0]
    np.testing.assert_array_equal(packed.table.numpy(),
                                  pmk.pack_scene(job.scene, "cpu").table.numpy()[flat.prim_index])
    prims = bvh.prims.numpy()
    assert prims.shape == (n, pmk.PRIM_COLS) and prims.dtype == np.float32
    np.testing.assert_array_equal(prims[:, :9], packed.table.numpy()[:, :9])
    assert not prims[:, 9:].any()
    nodes_f, nodes_i, rows = bvh.nodes_f.numpy(), bvh.nodes_i.numpy(), bvh.nodes64.numpy()
    interior = np.flatnonzero(nodes_i[:, 1] == 0)
    assert rows.shape == (interior.size, 16)
    if name == "one_cube":
        assert interior.size == 0 and bvh.root_count == n == nodes_i[0, 1] == 12
    else:
        assert interior.size > 0 and bvh.root_count == 0
    row_of = {int(b): r for r, b in enumerate(interior)}
    bits = rows.view(np.int32)
    mask = (1 << LEAF_COUNT_BITS) - 1
    for r, b in enumerate(interior):
        np.testing.assert_array_equal(rows[r, :12], nodes_f[b, :12])
        assert bits[r, 14] == nodes_i[b, 2]
        for col, child, count in ((12, b + 1, bits[r, 15] & mask),
                                  (13, nodes_i[b, 0], bits[r, 15] >> LEAF_COUNT_BITS)):
            if nodes_i[child, 1] > 0:  # a leaf: -1 - its first row, its count
                assert bits[r, col] == -1 - nodes_i[child, 0] and count == nodes_i[child, 1]
            else:
                assert bits[r, col] == row_of[int(child)] and count == 0
    # the path kernel's tables, and the other kernels' fused-children rows
    table, n64, pr = pmk.geometry_args(packed, torch.device("cpu"), node64=True)
    assert pr is bvh.prims and (n64 is None) == (name == "one_cube")
    assert pmk.root_count(packed) == bvh.root_count
    _, nf, ni = pmk.geometry_args(packed, torch.device("cpu"))
    assert nf is bvh.nodes_f and ni is bvh.nodes_i
    bad = packed._replace(bvh=bvh._replace(root_count=0 if bvh.root_count else n))
    with pytest.raises(ValueError, match="root_count"):
        pmk.geometry_args(bad, torch.device("cpu"), node64=True)


# ---- the plain node64 walk against the fused-children walk and JAX's ----


def _rays(seed, box):
    """Seeded rays from near the camera into `box` ((x, y, z) ranges), with
    t_max infinite, finite (about half short of their hit) or 0, a third
    each."""
    r = np.random.default_rng(seed)
    o = r.normal(0.0, 0.5, (N, 3))
    target = np.stack([r.uniform(*box[k], N) for k in range(3)], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lane = np.arange(N) % 3
    t_max = np.where(lane == 0, np.inf, np.where(lane == 1, r.uniform(33.5, 36.5, N), 0.0))
    return o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)


BOXES = {"grid4": ((34.5, 36.0), (-3.0, 3.0), (-2.5, 2.5)),
         "one_cube": ((34.0, 35.0), (-1.0, 1.0), (-2.8, -0.8)),
         "deep63": ((34.0, 36.0), (-1.5, 1.5), (-1.5, 1.5))}


def _jax_walk(path, o, d, t_max, any_hit):
    """The JAX package's jnp BVH walk on its own build of the scene,
    compiled at backend optimisation level 0: (t, scene row, valid)."""
    ctx = JaxSceneCtx(jax_load_scene(path).scene)
    flat = jbvh.build_bvh(ctx.tri, empty_spheres(), pmk.BVH_LEAF)
    f = lambda o_, d_, t_: jtraverse.intersect_bvh(flat, ctx.tri, empty_spheres(), o_, d_, t_,
                                                   any_hit=any_hit)
    args = tuple(jnp.asarray(x) for x in (o, d, t_max))
    hit = jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)
    return np.asarray(hit.t), np.asarray(hit.index), np.asarray(hit.valid)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("name", ["grid4", "one_cube", "deep63"])
def test_plain_node64_walk_equals_fused_rows_and_jax(tmp_path, name, any_hit):
    path = _scene(tmp_path, name)
    job = load_scene(path)
    packed = pmk.pack_scene(job.scene, "cpu", bvh=True)
    fused = packed._replace(bvh=packed.bvh._replace(nodes64=None, prims=None))
    o, d, t_max = _rays(5, BOXES[name])
    ray = (*T(o).unbind(-1), *T(d).unbind(-1))
    # the path kernel walks no ray with a bound <= 0 (the node64 walk skips
    # such a lane, the fused-children walk tests its root's children)
    live = T(t_max) > 0
    w64, wf = {}, {}
    t, row = pmk.PlainGeometry(packed, "cpu", w64).walk(*ray, T(t_max), live, any_hit, "k1")
    t_f, row_f = pmk.PlainGeometry(fused, "cpu", wf).walk(*ray, T(t_max), live, any_hit)
    assert torch.equal(row, row_f) and torch.equal(t, t_f)
    assert int((row >= 0).sum()) > 200 and not bool((row[T(t_max) == 0] >= 0).any())
    assert int(w64["slab"]) == int(wf["slab"]) and int(w64["mt"]) == int(wf["mt"])
    # every ray with t_max > 0 walked, a step for each row fetched or leaf tested
    walked = int((T(t_max) > 0).sum())
    assert int(w64["k1_walks"]) == walked == int(live.sum())
    assert int(w64["k1_warps"]) == -(-N // pmk.WARP)
    assert int(w64["k1_steps"]) >= max(walked, int(w64["node"]))
    assert int(w64["k1_warp_steps"]) >= int(w64["k1_steps"]) / pmk.WARP
    if name == "deep63":
        return  # past the jnp walk's 48-entry stack
    order = torch.as_tensor(build_bvh(job.scene.triangles, pmk.BVH_LEAF).prim_index,
                            dtype=torch.int64)
    t_j, idx_j, valid_j = _jax_walk(path, o, d, t_max, any_hit)
    valid = (row >= 0).numpy()
    np.testing.assert_array_equal(valid, valid_j)
    if not any_hit:  # JAX's any hit finishes the leaf: its row is that leaf's closest
        np.testing.assert_array_equal(order[row.clamp(min=0)].numpy()[valid], idx_j[valid])
        np.testing.assert_allclose(t.numpy()[valid], t_j[valid], rtol=1e-6)
        np.testing.assert_array_equal(t.numpy()[~valid], t_max[~valid])


# ---- K1's BVH render through the plain version against JAX li_path ----


def _all_matte(cfg):
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_matte"


def _render_scene(tmp_path, name):
    if name == "grid":
        path = write_grid_scene(str(tmp_path / "g"), ny=4, nz=4, xres=160, yres=90)
        cfg = json.loads(Path(path).read_text())
        _all_matte(cfg)
        Path(path).write_text(json.dumps(cfg))
        return path
    scene = "scene_smooth.json" if name == "smooth" else "scene_sss.json"

    def edit(cfg):
        cfg["Film"]["xres"], cfg["Film"]["yres"] = 160, 90
        if name == "smooth":
            _all_matte(cfg)

    shutil.copy(SAMPLES / "sphere_smooth.obj", tmp_path)
    return _write(tmp_path, edit, scene)


@pytest.mark.parametrize("name", ["grid", "smooth", "sss"])
def test_k1_bvh_render_matches_jax_li_path(tmp_path, name):
    """JAX camera rays, 8 stratified samples in each pixel of a 160x90 film
    whose centre ray hits the scene (the rest of these films is black), at
    least 1,000 of them lit."""
    path = _render_scene(tmp_path, name)
    jjob = jax_load_scene(path)
    jctx = JaxSceneCtx(jjob.scene)
    w_, h_, spp = jjob.film.xres, jjob.film.yres, 8
    cam = JaxCamera(jjob.camera, jjob.film, pupil_samples=1 << 10)
    jsampler = JaxStratified(jjob.sampler, seed=0)
    pix = np.arange(w_ * h_, dtype=np.uint32)
    every = jnp.asarray(pix)
    centre = jnp.stack([every % w_, every // w_], -1).astype(jnp.float32) + 0.5
    o, d, w = cam.generate_rays(centre, jnp.full((w_ * h_, 2), 0.5, jnp.float32))
    pix = pix[np.asarray(jctx.intersect(o, d, jnp.where(w > 0.0, jnp.inf, 0.0)).valid)]
    pid = jnp.asarray(np.tile(pix, spp))
    sid = jnp.asarray(np.repeat(np.arange(spp, dtype=np.uint32), pix.size))
    pxy = jnp.stack([pid % w_, pid // w_], -1).astype(jnp.float32)
    o, d, w = cam.generate_rays(pxy + jsampler.get_2d(pid, sid, 0), jsampler.get_2d(pid, sid, 1))
    l_ref = np.asarray(jax_li_path(jctx, o, d, w, jsampler, pid, sid, jjob.integrator))
    job = load_scene(path)
    sampler = StratifiedSampler(job.sampler, seed=0)
    assert pmk.unsupported_feature(job.scene, job.integrator, sampler) is None
    packed = pmk.pack_scene(job.scene, "cpu", bvh=True)
    assert packed.bvh is not None and packed.bvh.nodes64.shape[0] > 0
    assert packed.smooth == (name == "smooth") and (packed.bssrdf is not None) == (name == "sss")
    l = pmk.li_path_mega(packed, T(o), T(d), T(w), T(np.asarray(pid, np.int64)),
                         T(np.asarray(sid, np.int64)), sampler, job.integrator).numpy()
    assert np.isfinite(l).all() and int((l_ref.max(-1) > 0).sum()) >= 1000
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    assert float((rel.max(-1) > 1e-3).mean()) < 5e-3
    assert float(np.quantile(rel, 0.99)) < 1e-5
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())
