"""The port's BVH: the build and its tables equal the JAX package's, and
the plain stack walk finds the hits brute force finds.

Both packages build with the repository's SAH builder (csrc/
bvh_builder.cpp; the port compiles it with g++ into build/torch_kernels/,
the JAX package loads csrc/libbvh.so), so the node tables, the leaf
order and the leaf-ordered triangle table must be equal array for array.
Scenes: the in-repo fixture (36 triangles) and a 4x4 grid of cubes
(scene/gen.write_grid_scene, 216 triangles).
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.accel import bvh as jbvh
from rs_ray_toy_tpu.integrators.common import SceneCtx
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.ops.bvh_pallas import pack_bvh_tables as jax_pack_bvh_tables
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu.scene.types import empty_spheres
from rs_ray_toy_tpu_torch.accel import bvh
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.scene.gen import write_grid_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"


@pytest.fixture(params=["fixture", "grid4x4"])
def scene_path(request, tmp_path):
    if request.param == "fixture":
        return str(SAMPLES / "scene.json")
    return write_grid_scene(str(tmp_path), ny=4, nz=4)


def test_build_and_tables_equal_jax(scene_path, monkeypatch):
    jjob = jax_load_scene(scene_path)
    ctx = SceneCtx(jjob.scene)
    job = load_scene(scene_path)
    flat = bvh.build_bvh(job.scene.triangles, pmk.BVH_LEAF)
    lo, hi, _, _ = jbvh.primitive_bounds(ctx.tri, empty_spheres())
    native = jbvh._build_flat_native(lo, hi, pmk.BVH_LEAF)
    assert native is not None, "the JAX package's native builder did not load"
    for ours, theirs in zip(
        (flat.bounds_min, flat.bounds_max, flat.offset, flat.n_prims, flat.axis, flat.prim_index),
        native,
    ):
        np.testing.assert_array_equal(ours, theirs)
    jflat = jbvh.build_bvh(ctx.tri, empty_spheres(), pmk.BVH_LEAF)
    jtab = jax_pack_bvh_tables(jflat, ctx.tri)
    nodes_f, nodes_i = bvh.pack_bvh_tables(flat)
    np.testing.assert_array_equal(nodes_f, np.asarray(jtab["nodes2_f"]))
    np.testing.assert_array_equal(nodes_i, np.asarray(jtab["nodes_i"]))
    assert flat.max_leaf == jtab["max_leaf"]
    assert bvh.tree_depth(flat) == jtab["depth"]

    # the packed scene in BVH mode: the same leaf order, and the columns
    # the JAX package keeps equal row for row
    monkeypatch.setenv("RS_MEGA_BVH", "force")
    jtable, _, _, kinds, max_lobes, _, jb, _ = jpmk.pack_scene(ctx)
    packed = pmk.pack_scene(job.scene, "cpu", bvh=True)
    assert packed.kinds_present == tuple(kinds)
    cols = list(range(9)) + list(jpmk._attr_cols(kinds, max_lobes))
    t = job.scene.triangles.count
    np.testing.assert_array_equal(packed.table.numpy()[:, cols], np.asarray(jtable)[:t])
    np.testing.assert_array_equal(packed.bvh.nodes_f.numpy(), np.asarray(jb[0]))
    np.testing.assert_array_equal(packed.bvh.nodes_i.numpy(), np.asarray(jb[1]))
    assert packed.bvh.max_leaf == jb[2]


def _rays(n, seed):
    """Seeded rays from around the camera into the fixture's view volume,
    and shadow segments from each to a seeded point near the cubes."""
    r = np.random.default_rng(seed)
    o = r.normal(0.0, 0.3, (n, 3))
    target = np.stack([r.uniform(33.0, 38.0, n), r.uniform(-8.0, 8.0, n), r.uniform(-5.0, 5.0, n)], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    seg_end = np.stack([r.uniform(28.0, 40.0, n), r.uniform(-8.0, 8.0, n), r.uniform(-8.0, 8.0, n)], -1)
    f = lambda a: [torch.as_tensor(c, dtype=torch.float32) for c in a.T]
    return f(o), f(d), f(seg_end - o)


def test_walk_matches_brute_force(scene_path):
    """4096 seeded rays: the BVH walk's closest hits (t and triangle) and
    occlusion equal brute force's."""
    job = load_scene(scene_path)
    brute = pmk.PlainGeometry(pmk.pack_scene(job.scene, "cpu", bvh=False), "cpu")
    packed = pmk.pack_scene(job.scene, "cpu", bvh=True)
    order = torch.as_tensor(bvh.build_bvh(job.scene.triangles, pmk.BVH_LEAF).prim_index, dtype=torch.int64)
    walk = pmk.PlainGeometry(packed, "cpu")
    o, d, seg = _rays(4096, 7)
    live = torch.ones(4096, dtype=torch.bool)
    t_b, row_b = brute.closest(*o, *d, live)
    t_w, row_w = walk.closest(*o, *d, live)
    assert int((row_b >= 0).sum()) > 400
    assert torch.equal(t_w, t_b)
    assert torch.equal(torch.where(row_w >= 0, order[row_w.clamp(min=0)], -1), row_b)
    occ_b = brute.occluded(*o, *seg, 1.0 - 1e-4, live)
    occ_w = walk.occluded(*o, *seg, 1.0 - 1e-4, live)
    assert 100 < int(occ_b.sum()) < 4000
    assert torch.equal(occ_w, occ_b)
    # a lane that is not live finds nothing
    dead = torch.zeros_like(live)
    assert bool((walk.closest(*o, *d, dead)[1] == -1).all())
    assert not bool(walk.occluded(*o, *seg, 1.0 - 1e-4, dead).any())


@pytest.mark.parametrize("block", [1 << 22, 4096 * 7, 4096])
def test_brute_force_blocks_equal_one_triangle_at_a_time(scene_path, monkeypatch, block):
    """Brute force a block of triangles at a time finds what it finds one
    triangle at a time (PLAIN_BLOCK under the ray count): t, triangle,
    occlusion and the occlusion tests counted; the table is doubled, so
    that every hit ties and keeps the lower row."""
    job = load_scene(scene_path)
    table = pmk.pack_scene(job.scene, "cpu", bvh=False).table
    packed = SimpleNamespace(table=torch.cat([table, table]), bvh=None)
    o, d, seg = _rays(4096, 11)
    live = torch.rand(4096, generator=torch.Generator().manual_seed(0)) < 0.9

    def run(plain_block):
        monkeypatch.setattr(pmk, "PLAIN_BLOCK", plain_block)
        work = {}
        geom = pmk.PlainGeometry(packed, "cpu", work)
        t, row = geom.closest(*o, *d, live)
        work.clear()
        occ = geom.occluded(*o, *seg, 1.0 - 1e-4, live)
        return t, row, occ, int(work["mt"])

    t1, row1, occ1, tests1 = run(1)
    assert int((row1 >= 0).sum()) > 400 and bool((row1 < table.shape[0]).all())
    assert 100 < int(occ1.sum()) < 4000
    t, row, occ, tests = run(block)
    assert torch.equal(t, t1) and torch.equal(row, row1)
    assert torch.equal(occ, occ1) and tests == tests1


def test_work_counts(scene_path):
    """The tallies count what the kernel tests: brute force every triangle
    per live ray, the walk far fewer on the grid."""
    job = load_scene(scene_path)
    o, d, _ = _rays(512, 3)
    live = torch.ones(512, dtype=torch.bool)
    work_b, work_w = {}, {}
    pmk.PlainGeometry(pmk.pack_scene(job.scene, "cpu", bvh=False), "cpu", work_b).closest(*o, *d, live)
    pmk.PlainGeometry(pmk.pack_scene(job.scene, "cpu", bvh=True), "cpu", work_w).closest(*o, *d, live)
    t = job.scene.triangles.count
    assert int(work_b["mt"]) == 512 * t
    assert int(work_w["mt"]) > 0 and int(work_w["slab"]) >= 0
    if t > 100:
        assert int(work_w["mt"]) < int(work_b["mt"]) / 2
