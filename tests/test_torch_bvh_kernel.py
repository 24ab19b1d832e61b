"""K3's plain versions (ops/bvh_kernel: closest hit, any hit, shaded
closest hit) against the JAX package's BVH kernels in interpret mode.

The scene is a 6x6 grid of cubes in front of the fixture's other two
cubes (scene/gen.write_grid_scene, 456 triangles, above the brute-force
cutoff).  The port's tables (pack_bvh: leaf size 16) must equal the JAX
package's pack_bvh_tables array for array; then both walk the same tables
(interop.from_jax_scene_ctx) for 1500 seeded rays (the JAX kernel test's
count) aimed at the grid, with infinite t_max, a finite t_max that cuts
about half of the hits, and t_max = 0 (dead lanes) on every third ray.
Bars: hit or miss (any hit: occluded) equal on every ray, and where both
hit the triangle equal and t within rtol 1e-6; shaded attributes within
rtol 1e-5 / atol 1e-6 (uv within atol 1e-4, see the test), material and
area light equal.  The closest-hit and any-hit queries walk the node64 rows
(accel/bvh.pack_node64_tables, the loop's walk, built from the port's and
from the JAX package's binary tables); the walk over the fused-children
rows (bvh_kernel's) finds the same hits: each other's t and row, any
hit's too, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.accel.bvh import build_bvh as jax_build_bvh
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.ops.bvh_pallas import (
    intersect_bvh_pallas,
    intersect_bvh_pallas_shaded,
    occluded_bvh_pallas,
    pack_bvh_tables,
)
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu.scene.types import empty_spheres
from rs_ray_toy_tpu_torch.accel import bvh as bvh_mod
from rs_ray_toy_tpu_torch.accel import traverse
from rs_ray_toy_tpu_torch.interop import from_jax_scene_ctx
from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
from rs_ray_toy_tpu_torch.scene.gen import write_grid_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene

N = 1500
t32 = lambda a: torch.as_tensor(np.array(a), dtype=torch.float32)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    path = write_grid_scene(str(tmp_path_factory.mktemp("grid6")), ny=6, nz=6)
    jctx = JaxSceneCtx(jax_load_scene(path).scene)
    jtab = pack_bvh_tables(jax_build_bvh(jctx.tri, empty_spheres(), bk.KERNEL_LEAF), jctx.tri)
    return path, jctx, jtab


def _rays(seed):
    """Seeded origins near the camera aimed into the grid's box, and
    t_max: infinite, finite (a third of the rays, about half of them
    short of their hit) or 0 (a third)."""
    r = np.random.default_rng(seed)
    o = r.normal(0.0, 0.5, (N, 3))
    target = np.stack([r.uniform(34.5, 36.0, N), r.uniform(-3.5, 3.5, N),
                       r.uniform(-2.5, 2.5, N)], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lane = np.arange(N) % 3
    t_max = np.where(lane == 0, np.inf, np.where(lane == 1, r.uniform(34.0, 36.5, N), 0.0))
    return o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)


def test_tables_equal_jax(grid):
    path, jctx, jtab = grid
    ours = bk.pack_bvh(load_scene(path).scene.triangles, "cpu")
    assert ours.max_leaf == jtab["max_leaf"] and ours.depth == jtab["depth"]
    for name, theirs in (("nodes_f", "nodes2_f"), ("nodes_i", "nodes_i"), ("prims_f", "prims_f"),
                         ("prims_i", "prims_i")):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(jtab[theirs]),
                                      err_msg=name)
    np.testing.assert_allclose(ours.shade_f.numpy(), np.asarray(jtab["shade_f"]), rtol=1e-6,
                               atol=1e-7)


@pytest.fixture(scope="module")
def jax_hits(grid):
    """The JAX kernels' closest hit (t, idx, valid) and occlusion on the
    seed-5 rays, and the rays."""
    _, jctx, jtab = grid
    o, d, t_max = _rays(5)
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    hits = tuple(np.asarray(x) for x in intersect_bvh_pallas(jtab, jo, jd, jt, interpret=True))
    return (o, d, t_max), hits, np.asarray(occluded_bvh_pallas(jtab, jo, jd, jt, interpret=True))


def test_closest_and_any_hit_match_jax_kernel(grid, jax_hits):
    _, jctx, jtab = grid
    ctx = from_jax_scene_ctx(jctx, "cpu", jtab)
    (o, d, t_max), (t_j, idx_j, valid_j), occ_j = jax_hits
    t, idx, valid = bk.intersect_bvh(ctx.bvh, t32(o), t32(d), t32(t_max))
    assert 300 < valid_j.sum() < 1000
    assert not valid_j[t_max == 0].any()
    np.testing.assert_array_equal(valid.numpy(), valid_j)
    np.testing.assert_array_equal(idx.numpy()[valid_j], idx_j[valid_j])
    np.testing.assert_allclose(t.numpy()[valid_j], t_j[valid_j], rtol=1e-6)
    np.testing.assert_array_equal(t.numpy()[~valid_j], t_max[~valid_j])
    np.testing.assert_array_equal(bk.occluded_bvh(ctx.bvh, t32(o), t32(d), t32(t_max)).numpy(), occ_j)
    np.testing.assert_array_equal(occ_j, valid_j)


def test_both_walks_match_jax_kernel(grid, jax_hits):
    """The node64 walk (bvh64_kernel's plain version, the loop's) and the
    walk over the fused-children rows (bvh_kernel's), on the port's own
    tables and on the JAX package's: the JAX kernel's hits, and each
    other's t, row and any hit's row bit for bit."""
    path, jctx, jtab = grid
    (o, d, t_max), (t_j, idx_j, valid_j), occ_j = jax_hits
    ray = (t32(o), t32(d), t32(t_max))
    for tables in (bk.pack_bvh(load_scene(path).scene.triangles, "cpu"),
                   from_jax_scene_ctx(jctx, "cpu", jtab).bvh):
        assert tables.nodes64 is not None
        for fused_rows in (False, True):
            row = traverse.walk(tables, *ray, False, fused_rows=fused_rows)[1]
            valid = row >= 0
            np.testing.assert_array_equal(valid.numpy(), valid_j)
            idx = tables.prims_i[row.clamp(min=0), 0].numpy()
            np.testing.assert_array_equal(idx[valid_j], idx_j[valid_j])
            occ = traverse.walk(tables, *ray, True, fused_rows=fused_rows)[1] >= 0
            np.testing.assert_array_equal(occ.numpy(), occ_j)
        t, idx, valid = bk.intersect_bvh(tables, *ray)
        np.testing.assert_allclose(t.numpy()[valid_j], t_j[valid_j], rtol=1e-6)
        np.testing.assert_array_equal(bk.occluded_bvh(tables, *ray).numpy(), occ_j)
        for any_hit in (False, True):
            t_n, row_n = traverse.walk(tables, *ray, any_hit)
            t_b, row_b = traverse.walk(tables, *ray, any_hit, fused_rows=True)
            assert torch.equal(row_n, row_b) and torch.equal(t_n, t_b)


def test_shaded_hit_matches_jax_kernel(grid):
    _, jctx, jtab = grid
    ctx = from_jax_scene_ctx(jctx, "cpu", jtab)
    o, d, t_max = _rays(9)
    t_j, idx_j, valid_j, at_j = intersect_bvh_pallas_shaded(
        jtab, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), interpret=True)
    valid_j = np.asarray(valid_j)
    t, idx, valid, at = bk.intersect_bvh_shaded(ctx.bvh, t32(o), t32(d), t32(t_max))
    assert 300 < valid_j.sum() < 1000
    np.testing.assert_array_equal(valid.numpy(), valid_j)
    np.testing.assert_array_equal(idx.numpy()[valid_j], np.asarray(idx_j)[valid_j])
    np.testing.assert_allclose(t.numpy()[valid_j], np.asarray(t_j)[valid_j], rtol=1e-6)
    for k in ("mat", "area_light"):
        np.testing.assert_array_equal(at[k].numpy()[valid_j], np.asarray(at_j[k])[valid_j])
    for k in ("ns", "ng", "dpdu", "dpdv"):
        np.testing.assert_allclose(at[k].numpy()[valid_j], np.asarray(at_j[k])[valid_j],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # uv within atol 1e-4: XLA's CPU code rounds the barycentric dot products
    # differently in the last bits, and uv = uv0 w + uv1 u + uv2 v with
    # w = 1 - u - v magnifies that (no ported shading reads uv)
    np.testing.assert_allclose(at["uv"].numpy()[valid_j], np.asarray(at_j["uv"])[valid_j],
                               rtol=0, atol=1e-4)
    # misses carry no attributes and no material
    assert (at["mat"].numpy()[~valid_j] == -1).all()
    assert not at["ng"].numpy()[~valid_j].any()


def test_a_bvh_deeper_than_the_stack_raises(grid, monkeypatch):
    """The kernels' walk has a 64-entry stack, and deep instances with a
    256-entry one, and no slower walk behind them: a tree too deep for
    the deep stack is refused while packing, a tree too deep for the
    first takes the deep instances (here: both stacks lowered around the
    6x6 grid's depth)."""
    path, _, jtab = grid
    tri = load_scene(path).scene.triangles
    monkeypatch.setattr(bvh_mod, "STACK_DEPTH", jtab["depth"])
    monkeypatch.setattr(bvh_mod, "DEEP_STACK", jtab["depth"])
    with pytest.raises(NotImplementedError, match="traversal stack"):
        bk.pack_bvh(tri, "cpu")
    monkeypatch.setattr(bvh_mod, "DEEP_STACK", jtab["depth"] + 1)
    tables = bk.pack_bvh(tri, "cpu")
    assert tables.depth == jtab["depth"] and tables.stack == jtab["depth"] + 1
    monkeypatch.setattr(bvh_mod, "STACK_DEPTH", jtab["depth"] + 1)
    monkeypatch.setattr(bvh_mod, "DEEP_STACK", jtab["depth"] + 5)
    assert bk.pack_bvh(tri, "cpu").stack == jtab["depth"] + 1
