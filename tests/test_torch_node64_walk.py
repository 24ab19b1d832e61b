"""K3's node64 walk (ops/bvh_kernel: bvh64_kernel on the card) on the CPU.

accel/bvh.pack_node64_tables turns pack_bvh_tables' binary tables into one
64-byte row per interior node: its boxes are the fused-children rows' own
float32 values, and its child references decode to nodes_i's rows (an
interior child) or offsets and counts (a leaf child), on the 6x6 grid of
cubes of tests/test_torch_bvh_kernel.py (456 triangles) and on
write_deep_bvh_scene's 97-level tree.  The plain node64 walk
(accel/traverse.walk64) gives the binary walk's t and row bit for bit, and
any hit's row, on seeded rays with infinite, finite and zero t_max, and
makes the same slab and Moller-Trumbore tests; so does a tree whose root is
a leaf, and a tree whose leaves lie past row 2^23 (a reference holds any
int32 row).  (tests/test_torch_bvh_kernel.py holds both walks to the JAX
package's BVH kernel; tests/test_torch_cuda.py holds bvh64_kernel to the
plain walk and to bvh_kernel on the card.)
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from rs_ray_toy_tpu_torch.accel import traverse
from rs_ray_toy_tpu_torch.accel.bvh import LEAF_COUNT_BITS, pack_node64_tables
from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
from rs_ray_toy_tpu_torch.scene.gen import write_deep_bvh_scene, write_grid_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene

N = 3000


@lru_cache(maxsize=None)
def _tables(scene, tmp):
    path = (write_deep_bvh_scene(tmp) if scene == "deep" else write_grid_scene(tmp, ny=6, nz=6))
    return bk.pack_bvh(load_scene(path).scene.triangles, "cpu")


@pytest.fixture(params=["grid6", "deep"])
def tables(request, tmp_path_factory):
    return _tables(request.param, str(tmp_path_factory.mktemp(request.param)))


def _rays(seed, spread):
    """Seeded rays from near the camera into the mesh's box, t_max infinite,
    finite (about half short of their hit) or 0, a third each."""
    r = np.random.default_rng(seed)
    o = r.normal(0.0, 0.5, (N, 3))
    target = np.stack([r.uniform(34.5, 36.0, N), r.uniform(-spread, spread, N),
                       r.uniform(-spread, spread, N)], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lane = np.arange(N) % 3
    t_max = np.where(lane == 0, np.inf, np.where(lane == 1, r.uniform(34.0, 36.5, N), 0.0))
    return tuple(torch.as_tensor(x.astype(np.float32)) for x in (o, d, t_max))


def test_node64_rows_round_trip(tables):
    """Each node64 row is an interior node's, in the binary table's order
    (the binary tree read back through the references)."""
    nodes_f, nodes_i = tables.nodes_f.numpy(), tables.nodes_i.numpy()
    rows = tables.nodes64.numpy()
    bits = rows.view(np.int32)
    interior = np.flatnonzero(nodes_i[:, 1] == 0)
    assert rows.shape == (interior.size, 16)
    mask = (1 << LEAF_COUNT_BITS) - 1
    node = np.full(rows.shape[0], -1)  # each row's binary node
    node[0] = 0
    for r in range(rows.shape[0]):
        b = node[r]
        assert b >= 0, "a row before its parent"
        np.testing.assert_array_equal(rows[r, :12], nodes_f[b, :12])
        assert bits[r, 14] == nodes_i[b, 2]
        for col, child, count in ((12, b + 1, bits[r, 15] & mask),
                                  (13, nodes_i[b, 0], bits[r, 15] >> LEAF_COUNT_BITS)):
            ref = bits[r, col]
            # a leaf child's count, 0 for an interior child
            assert count == nodes_i[child, 1]
            if ref >= 0:
                assert nodes_i[child, 1] == 0 and node[ref] == -1 and ref > r
                node[ref] = child
            else:
                # a leaf child's reference holds its first row
                assert nodes_i[child, 1] > 0 and -1 - int(ref) == nodes_i[child, 0]
    np.testing.assert_array_equal(node, interior)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_node64_walk_equals_binary_walk(tables, any_hit):
    o, d, t_max = _rays(7, 1.5 if tables.depth > 64 else 3.5)
    work_b, work_n = {}, {}
    t_b, row_b = traverse.walk(tables, o, d, t_max, any_hit, work_b, fused_rows=True)
    t_n, row_n, steps = traverse.walk64(tables, o, d, t_max, any_hit, work_n)
    assert int((row_b >= 0).sum()) > 200
    assert torch.equal(row_n, row_b) and torch.equal(t_n, t_b)
    assert not bool(((row_n >= 0) & (t_max == 0)).any()) and not bool(steps[t_max == 0].any())
    for key in ("slab", "mt"):
        assert int(work_n[key]) == int(work_b[key]), key
    assert int(work_n["node"]) == int(work_n["slab"]) // 2
    stats = traverse.step_stats(steps, t_max > 0)
    assert 1 <= stats["mean"] <= stats["warp_max_mean"] <= stats["max"]
    # the loop's queries on CPU tensors run the plain node64 walk
    assert torch.equal(traverse.walk(tables, o, d, t_max, any_hit)[1], row_n)
    if any_hit:
        assert torch.equal(bk.occluded_bvh(tables, o, d, t_max), row_b >= 0)
    else:
        t_w, idx_w, _ = bk.intersect_bvh(tables, o, d, t_max)
        assert torch.equal(t_w, t_b)
        assert torch.equal(idx_w, torch.where(row_b >= 0, tables.prims_i[row_b, 0].long(), -1))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_leaf_root_walk(tables, any_hit):
    """A tree that is one leaf (ten of the mesh's rows): no interior row, the
    root's reference a leaf's; both walks test its rows alone."""
    nodes_f = torch.zeros((1, 16))
    nodes_i = torch.tensor([[0, 10, 0, 0]], dtype=torch.int32)
    rows = pack_node64_tables(nodes_f.numpy(), nodes_i.numpy())
    assert rows.shape == (0, 16)
    leaf = tables._replace(nodes_f=nodes_f, nodes_i=nodes_i, prims_f=tables.prims_f[:10],
                           prims_i=tables.prims_i[:10], shade_f=tables.shade_f[:10], depth=1,
                           nodes64=torch.as_tensor(rows))
    # seeded rays from near the origin at random points of the ten rows
    r = np.random.default_rng(11)
    g = leaf.prims_f[:, :9].double().numpy()[np.arange(N) % 10]
    u, v = r.uniform(0.0, 0.5, (2, N, 1))
    o = r.normal(0.0, 0.5, (N, 3))
    d = g[:, 0:3] + u * g[:, 3:6] + v * g[:, 6:9] - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = torch.as_tensor(o, dtype=torch.float32), torch.as_tensor(d, dtype=torch.float32)
    t_max = torch.where(torch.arange(N) % 3 == 2, 0.0, torch.inf)
    t_b, row_b = traverse.walk(leaf, o, d, t_max, any_hit, fused_rows=True)
    t_n, row_n, steps = traverse.walk64(leaf, o, d, t_max, any_hit)
    assert int((row_b >= 0).sum()) > N // 2
    assert torch.equal(row_n, row_b) and torch.equal(t_n, t_b)
    assert bool((steps[t_max > 0] == 1).all())


def _two_leaf_tree(first_left, first_right, n_left, n_right, box_left, box_right):
    """A root and two leaf children (binary tables), the right child split
    on x."""
    nodes_f = np.zeros((3, 16), np.float32)
    nodes_f[0, 0:6], nodes_f[0, 6:12] = box_left, box_right
    nodes_i = np.array([[2, 0, 0, 0], [first_left, n_left, 0, 0],
                        [first_right, n_right, 0, 0]], np.int32)
    return nodes_f, nodes_i


def test_leaf_reference_limits():
    """A leaf of 2^LEAF_COUNT_BITS triangles does not fit a node64 row's
    count; a leaf's first row may be any int32 row (past 2^23 and 2^30)."""
    nodes_f, nodes_i = _two_leaf_tree(3, 9, 6, 1 << LEAF_COUNT_BITS, np.zeros(6), np.zeros(6))
    with pytest.raises(NotImplementedError, match="node64 row holds"):
        pack_node64_tables(nodes_f, nodes_i)
    for first_right in (9, (1 << 23) + 5, (1 << 30) + 7, (1 << 31) - 1):
        nodes_i[2] = (first_right, (1 << LEAF_COUNT_BITS) - 1, 0, 0)
        bits = pack_node64_tables(nodes_f, nodes_i).view(np.int32)
        assert bits.shape == (1, 16)
        assert bits[0, 12] == -1 - 3 and bits[0, 13] == -1 - first_right
        assert bits[0, 15] == 6 | 255 << LEAF_COUNT_BITS


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_leaf_rows_past_2_23_walk(tables, any_hit):
    """The same two leaves of the mesh's rows at rows 0 and 16 and at rows
    2^23 + 3 and 2^23 + 40 of a table of 2^23 + 64 rows (never written but
    where the leaves lie): the plain node64 walk finds the same hits, at
    the rows past 2^23."""
    geo = tables.prims_f[:32]
    v = geo[:, 0:3].double().numpy()
    corners = np.concatenate([v, v + geo[:, 3:6].numpy(), v + geo[:, 6:9].numpy()])
    box = np.concatenate([corners.min(0) - 1e-3, corners.max(0) + 1e-3]).astype(np.float32)
    shift, far = (1 << 23) + 3, (1 << 23) + 40
    big = torch.empty(((1 << 23) + 64, 12))  # pages untouched stay unmapped
    big[0] = 0.0
    big[shift:shift + 16], big[far:far + 16] = geo[:16], geo[16:32]
    trees = {}
    for name, prims_f, (a, b) in (("low", geo, (0, 16)), ("high", big, (shift, far))):
        nodes_f, nodes_i = _two_leaf_tree(a, b, 16, 16, box, box)
        trees[name] = tables._replace(
            nodes_f=torch.as_tensor(nodes_f), nodes_i=torch.as_tensor(nodes_i), prims_f=prims_f,
            prims_i=None, shade_f=None, max_leaf=16, depth=2,
            nodes64=torch.as_tensor(pack_node64_tables(nodes_f, nodes_i)))
    r = np.random.default_rng(13)
    g = geo[:, :9].double().numpy()[np.arange(N) % 32]
    u, w = r.uniform(0.0, 0.5, (2, N, 1))
    o = r.normal(0.0, 0.5, (N, 3))
    d = g[:, 0:3] + u * g[:, 3:6] + w * g[:, 6:9] - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = torch.as_tensor(o, dtype=torch.float32), torch.as_tensor(d, dtype=torch.float32)
    t_max = torch.where(torch.arange(N) % 3 == 2, 0.0, torch.inf)
    t_lo, row_lo, _ = traverse.walk64(trees["low"], o, d, t_max, any_hit)
    t_hi, row_hi, _ = traverse.walk64(trees["high"], o, d, t_max, any_hit)
    hit = row_lo >= 0
    assert int(hit.sum()) > N // 4 and bool((row_lo[hit] >= 16).any())
    assert torch.equal(t_hi, t_lo) and torch.equal(row_hi >= 0, hit)
    expect = torch.where(row_lo < 16, row_lo + shift, row_lo - 16 + far)
    assert torch.equal(row_hi[hit], expect[hit])
