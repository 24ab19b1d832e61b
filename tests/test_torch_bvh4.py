"""K3's BVH4 walk (ops/bvh_kernel with `wide` tables) against the JAX
package's _traverse4_kernel and against the binary walk.

The scene is tests/test_torch_bvh_kernel.py's 6x6 grid of cubes (456
triangles): the port's BVH4 tables (accel/bvh.pack_bvh4_tables) must equal
the JAX package's pack_bvh4_tables array for array; the plain BVH4 walk
must equal JAX's BVH kernel under RS_BVH_WIDE=1 in interpret mode on that
test's 1500 seeded rays (infinite, finite and zero t_max): hit or miss
equal on every ray, where both hit the triangle equal and t within rtol
1e-6; and the binary plain walk on more rays the same way, any hit
equal.  (Exact ties at shared edges could part the two walks, whose
visit orders differ; these rays have none.)  A tree deeper than the
shallow stack holds takes the deep instances; the binary tables alone
(pack_bvh's default) are packed for a tree whose BVH4 walk no stack
holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.ops import bvh_pallas
from rs_ray_toy_tpu.ops.bvh_pallas import intersect_bvh_pallas, occluded_bvh_pallas
from rs_ray_toy_tpu_torch.accel import bvh as bvh_mod
from rs_ray_toy_tpu_torch.accel import traverse
from rs_ray_toy_tpu_torch.interop import from_jax_scene_ctx
from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
from rs_ray_toy_tpu_torch.scene.gen import write_deep_bvh_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene
from test_torch_bvh_kernel import _rays, grid, t32  # noqa: F401 (the module fixture)

torch.set_num_threads(min(2, torch.get_num_threads()))


def _hits_equal(a, b, t_max):
    """(t, idx, valid) of two closest-hit walks: hit or miss equal on
    every ray, the triangle equal and t within rtol 1e-6 where they hit,
    t_max where they miss."""
    t_a, idx_a, valid_a = (np.asarray(x) for x in a)
    t_b, idx_b, valid_b = (np.asarray(x) for x in b)
    np.testing.assert_array_equal(valid_a, valid_b)
    np.testing.assert_array_equal(idx_a[valid_b], idx_b[valid_b])
    np.testing.assert_allclose(t_a[valid_b], t_b[valid_b], rtol=1e-6)
    np.testing.assert_array_equal(t_a[~valid_b], t_max[~valid_b])


def test_bvh4_tables_equal_jax(grid):
    path, _, jtab = grid
    ours = bk.pack_bvh(load_scene(path).scene.triangles, "cpu", wide=True)
    assert ours.wide
    np.testing.assert_array_equal(ours.nodes4_f.numpy(), np.asarray(jtab["nodes4_f"]))
    np.testing.assert_array_equal(ours.nodes4_i.numpy(), np.asarray(jtab["nodes4_i"]))
    # every wide node but the root is some node's interior child, once
    kind = ours.nodes4_i.numpy()[:, 0::3]
    child = ours.nodes4_i.numpy()[:, 1::3]
    inner = np.sort(child[kind == bvh_mod.CHILD_INTERIOR])
    np.testing.assert_array_equal(inner, np.arange(1, kind.shape[0]))
    # a wide node's interior children are its binary node's grandchildren:
    # a path of D binary nodes (D >= 2) has D // 2 wide ones
    assert ours.depth4 == ours.depth // 2
    assert ours.stack4 == bvh_mod.STACK_DEPTH


def test_empty_slots_hit_their_inverted_box(grid):
    """The JAX docstring says an empty slot's box (bmin 1e30, bmax -1e30)
    never hits; under the min / max slab test it spans all of space, so
    only the slot's kind keeps the walk out of it."""
    path, _, _ = grid
    ours = bk.pack_bvh(load_scene(path).scene.triangles, "cpu", wide=True)
    empty = ours.nodes4_i[:, 0::3] == bvh_mod.CHILD_NONE
    assert bool(empty.any())
    row, slot = (int(x) for x in torch.nonzero(empty)[0])
    box = ours.nodes4_f[row, 6 * slot:6 * slot + 6][None]
    o, d = torch.tensor([[0.0, 0.0, 0.0]]), torch.tensor([[1.0, 0.0, 0.0]])
    inv = tuple(traverse._inv_dir(c) for c in d.unbind(-1))
    hit, _ = traverse._slab_tn(box, *o.unbind(-1), *inv, torch.tensor([1e30]))
    assert bool(hit.all())


def test_plain_bvh4_walk_matches_jax_kernel(grid, monkeypatch):
    _, jctx, jtab = grid
    ctx = from_jax_scene_ctx(jctx, "cpu", jtab)
    tables = ctx.bvh._replace(wide=True)
    o, d, t_max = _rays(5)
    monkeypatch.setenv("RS_BVH_WIDE", "1")
    monkeypatch.setattr(bvh_pallas, "TILE_ROWS", 8)  # 1024-ray packets: a shorter interpret run
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    ref = intersect_bvh_pallas(jtab, jo, jd, jt, interpret=True)
    valid_j = np.asarray(ref[2])
    assert 300 < valid_j.sum() < 1000 and not valid_j[t_max == 0].any()
    _hits_equal(bk.intersect_bvh(tables, t32(o), t32(d), t32(t_max)), ref, t_max)
    occ_j = np.asarray(occluded_bvh_pallas(jtab, jo, jd, jt, interpret=True))
    np.testing.assert_array_equal(occ_j, valid_j)
    np.testing.assert_array_equal(bk.occluded_bvh(tables, t32(o), t32(d), t32(t_max)).numpy(),
                                  occ_j)


def test_bvh4_walk_matches_binary_walk(grid):
    path, _, _ = grid
    tri = load_scene(path).scene.triangles
    wide = bk.pack_bvh(tri, "cpu", wide=True)
    binary = wide._replace(wide=False)
    o, d, t_max = (t32(x) for x in _rays(11))
    o, d, t_max = (torch.cat([x] * 4) for x in (o, d, t_max))
    d = d + 0.02 * torch.randn(d.shape, generator=torch.Generator().manual_seed(3))
    d = d / d.norm(dim=-1, keepdim=True)
    ref = bk.intersect_bvh(binary, o, d, t_max)
    assert 1000 < int(ref[2].sum()) < 5000
    _hits_equal(bk.intersect_bvh(wide, o, d, t_max), ref, t_max.numpy())
    np.testing.assert_array_equal(bk.occluded_bvh(wide, o, d, t_max).numpy(),
                                  bk.occluded_bvh(binary, o, d, t_max).numpy())
    # the counted work: both walks test the leaves their rays' boxes reach
    w_bin, w_wide = {}, {}
    traverse.walk(binary, o, d, t_max, False, w_bin)
    traverse.walk(wide, o, d, t_max, False, w_wide)
    assert 0 < int(w_wide["mt"]) and int(w_wide["slab"]) > 0
    assert int(w_wide["mt"]) <= int(w_bin["mt"]) * 1.2


def test_deep_tree_takes_the_deep_bvh4_instance(tmp_path):
    """write_deep_bvh_scene's 97-level tree is 48 wide levels: its walk
    needs 3 * 47 + 1 = 142 stack entries, past the 64 of the shallow
    instances, so the deep ones (256) walk it; the walk finds the binary
    walk's hits.  A wide tree past DEEP_STACK raises (stack4_for, which
    pack_bvh calls)."""
    tri = load_scene(write_deep_bvh_scene(str(tmp_path))).scene.triangles
    tables = bk.pack_bvh(tri, "cpu", wide=True)
    assert tables.depth4 == tables.depth // 2 == 48
    assert tables.stack4 == bvh_mod.DEEP_STACK
    rng = np.random.default_rng(3)
    aim = np.array([35.0, 0.0, 0.0]) + rng.uniform(-1.0, 1.0, (512, 3))
    o = torch.as_tensor(rng.uniform(-0.1, 0.1, (512, 3)), dtype=torch.float32)
    d = torch.as_tensor(aim, dtype=torch.float32) - o
    d = d / d.norm(dim=-1, keepdim=True)
    t_max = torch.full((512,), float("inf"))
    ref = bk.intersect_bvh(tables._replace(wide=False), o, d, t_max)
    assert int(ref[2].sum()) > 100
    _hits_equal(bk.intersect_bvh(tables, o, d, t_max), ref, t_max.numpy())
    with pytest.raises(NotImplementedError, match="BVH4 of depth"):
        bvh_mod.stack4_for((bvh_mod.DEEP_STACK + 2) // 3 + 1)
    assert bvh_mod.stack4_for((bvh_mod.DEEP_STACK - 1) // 3 + 1) == bvh_mod.DEEP_STACK


def test_binary_tables_take_a_tree_the_bvh4_stack_refuses(tmp_path, monkeypatch):
    """pack_bvh packs the BVH4 only when asked.  With the deep stack
    lowered to 98 entries, write_deep_bvh_scene's 97-level tree still fits
    the binary walk's deep instances while its BVH4 walk (48 wide levels,
    3 * 47 + 1 = 142 entries) fits no stack, as a binary tree of 173-255
    levels does at 256: the binary tables pack and walk, `wide=True`
    raises naming the BVH4, and the BVH4 walk refuses tables without its
    nodes."""
    tri = load_scene(write_deep_bvh_scene(str(tmp_path))).scene.triangles
    monkeypatch.setattr(bvh_mod, "DEEP_STACK", 98)
    tables = bk.pack_bvh(tri, "cpu")
    assert tables.depth == 97 and tables.stack == 98
    assert not tables.wide and tables.nodes4_f is None
    with pytest.raises(NotImplementedError, match="BVH4 of depth 48"):
        bk.pack_bvh(tri, "cpu", wide=True)
    rng = np.random.default_rng(5)
    o = torch.zeros((256, 3))
    d = torch.as_tensor(np.array([35.0, 0.0, 0.0]) + rng.uniform(-1.0, 1.0, (256, 3)),
                        dtype=torch.float32)
    d = d / d.norm(dim=-1, keepdim=True)
    t_max = torch.full((256,), float("inf"))
    assert int(bk.intersect_bvh(tables, o, d, t_max)[2].sum()) > 50
    with pytest.raises(ValueError, match="BVH4"):
        bk.intersect_bvh(tables._replace(wide=True), o, d, t_max)


def test_plain_bvh4_walk_raises_when_its_stack_overflows(grid, monkeypatch):
    """The plain BVH4 walk never drops a subtree: on tables whose stack
    is sized too small for the tree it raises (the JAX kernel clamps and
    overwrites)."""
    path, _, _ = grid
    tables = bk.pack_bvh(load_scene(path).scene.triangles, "cpu", wide=True)
    monkeypatch.setattr(bk.BvhTables, "stack4", property(lambda self: 2))
    o, d, t_max = (t32(x) for x in _rays(5))
    with pytest.raises(RuntimeError, match="stack overflowed"):
        bk.intersect_bvh(tables, o, d, t_max)
