"""BVH build (host) and the node tables the kernels walk
(rs_ray_toy_tpu/accel/bvh.py and ops/bvh_pallas.pack_bvh_tables,
pack_bvh4_tables): the binary tree's fused-children rows, the same rows
as one 64-byte row per interior node with both children's references in
it (`pack_node64_tables`, K3's walk on the card), and the same tree
collapsed into 4-wide nodes (BVH4).

The build is the repository's binned-SAH C++ builder (csrc/bvh_builder.cpp,
12 buckets), compiled with g++ on first use (ops/_build.load_host) and
called through ctypes.  It emits the flat DFS layout of bvh.rs:103-109:

    node i interior: left child = i+1, right child = offset[i]
    node i leaf:     primitives offset[i] .. offset[i] + n_prims[i]

with the primitives reordered into leaf order.  There is no fallback
builder: another builder would give another leaf order, and so another
winner on exactly tied hits than the JAX package.  Triangles only (the
port has no spheres).
"""

import ctypes
from dataclasses import dataclass

import numpy as np

from ..ops import _build

STACK_DEPTH = 64  # traversal stack (ops/bvh_pallas.STACK_DEPTH)
DEEP_STACK = 256  # the BVH kernels' deep instances: trees of depth 64..255
NODE_COLS = 16  # fused-children row: left box (6), right box (6), 4 zeros
NODE4_COLS = 24  # a wide node's float row: per child slot bmin, bmax
NODE4_I_COLS = 12  # its int row: per child slot kind, a, b
CHILD_NONE, CHILD_INTERIOR, CHILD_LEAF = 0, 1, 2  # a wide child slot's kind
# the bits of one child's leaf count in a node64 row (pack_node64_tables)
LEAF_COUNT_BITS = 8

_LIB = None


@dataclass
class FlatBVH:
    bounds_min: np.ndarray  # (M, 3) float32
    bounds_max: np.ndarray  # (M, 3) float32
    offset: np.ndarray  # (M,) int32: interior -> right child; leaf -> prim start
    n_prims: np.ndarray  # (M,) int32: 0 for interior
    axis: np.ndarray  # (M,) int32 split axis
    prim_index: np.ndarray  # (P,) int32 triangle row of each leaf slot
    max_leaf: int

    @property
    def n_nodes(self):
        return self.offset.shape[0]


def primitive_bounds(tri):
    """World AABB of every triangle: (lo, hi), each (T, 3)."""
    p = np.stack([np.asarray(tri.p0), np.asarray(tri.p1), np.asarray(tri.p2)], axis=1)
    return p.min(axis=1), p.max(axis=1)


def _builder():
    global _LIB
    if _LIB is None:
        lib = _build.load_host("bvh_builder")
        c_dp = np.ctypeslib.ndpointer(np.float64, flags="C")
        c_fp = np.ctypeslib.ndpointer(np.float32, flags="C")
        c_ip = np.ctypeslib.ndpointer(np.int32, flags="C")
        lib.bvh_build_sah.argtypes = [
            c_dp, c_dp, ctypes.c_int, ctypes.c_int, c_fp, c_fp, c_ip, c_ip, c_ip, c_ip,
        ]
        lib.bvh_build_sah.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build_bvh(tri, max_prims_in_node=4) -> FlatBVH:
    """SAH BVH over the triangles (accel/bvh.build_bvh, native builder)."""
    lo, hi = primitive_bounds(tri)
    n = lo.shape[0]
    if n == 0:
        raise ValueError("a BVH needs at least one triangle")
    cap = 2 * n
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    offset = np.zeros(cap, np.int32)
    nprims = np.zeros(cap, np.int32)
    axis = np.zeros(cap, np.int32)
    order = np.zeros(n, np.int32)
    m = _builder().bvh_build_sah(
        np.ascontiguousarray(lo, np.float64), np.ascontiguousarray(hi, np.float64),
        n, max_prims_in_node, node_min, node_max, offset, nprims, axis, order,
    )
    if m <= 0:
        raise RuntimeError(f"the BVH builder failed on {n} triangles ({m})")
    return FlatBVH(
        bounds_min=node_min[:m],
        bounds_max=node_max[:m],
        offset=offset[:m],
        n_prims=nprims[:m],
        axis=axis[:m],
        prim_index=order,
        # the leaves actually built bound the traversal's leaf loop
        max_leaf=max(max_prims_in_node, int(nprims[:m].max(initial=1))),
    )


def stack_for(depth):
    """The traversal stack a walk of a tree of `depth` nodes needs:
    STACK_DEPTH below it, else DEEP_STACK (the BVH kernels' deep
    instances).  A tree of DEEP_STACK levels or more raises
    NotImplementedError."""
    if depth < STACK_DEPTH:
        return STACK_DEPTH
    if depth < DEEP_STACK:
        return DEEP_STACK
    raise NotImplementedError(f"a BVH of depth {depth} (the deepest traversal stack holds "
                              f"{DEEP_STACK} nodes)")


def stack4_for(depth4):
    """The stack the BVH4 walk needs over a wide tree of `depth4` levels:
    a pop takes one entry and pushes up to four, so the stack holds at
    most 3 (depth4 - 1) + 1 entries (three pending siblings a level above
    the four just pushed).  STACK_DEPTH when that fits, else DEEP_STACK
    (the deep instances); past DEEP_STACK it raises NotImplementedError.
    (The JAX kernel clamps its 64-entry stack and drops what does not
    fit.)"""
    need = 3 * (depth4 - 1) + 1
    if need <= STACK_DEPTH:
        return STACK_DEPTH
    if need <= DEEP_STACK:
        return DEEP_STACK
    raise NotImplementedError(f"a BVH4 of depth {depth4} (its walk needs {need} stack entries, "
                              f"the deepest traversal stack holds {DEEP_STACK})")


def tree_depth(bvh: FlatBVH) -> int:
    """Nodes on the longest root-to-leaf path."""
    depth = np.zeros(bvh.n_nodes, np.int64)
    for i in range(bvh.n_nodes - 1, -1, -1):
        if bvh.n_prims[i] > 0:
            depth[i] = 1
        else:
            depth[i] = 1 + max(depth[i + 1], depth[bvh.offset[i]])
    return int(depth[0])


def pack_bvh_tables(bvh: FlatBVH):
    """Fused-children node rows (ops/bvh_pallas.pack_bvh_tables): every
    interior row carries both children's boxes, so a traversal tests the
    boxes at the parent and pushes only the children it hits; leaf rows
    stay zero.

    Returns (nodes2_f (M, 16) float32, nodes_i (M, 4) int32: offset,
    n_prims, axis, 0)."""
    nmin, nmax = bvh.bounds_min, bvh.bounds_max
    m = nmin.shape[0]
    nodes_i = np.zeros((m, 4), np.int32)
    nodes_i[:, 0] = bvh.offset
    nodes_i[:, 1] = bvh.n_prims
    nodes_i[:, 2] = bvh.axis
    nodes2_f = np.zeros((m, NODE_COLS), np.float32)
    interior = nodes_i[:, 1] == 0
    if interior.any():
        c0 = np.arange(m)[interior] + 1
        c1 = nodes_i[interior, 0]
        nodes2_f[interior, 0:3] = nmin[c0]
        nodes2_f[interior, 3:6] = nmax[c0]
        nodes2_f[interior, 6:9] = nmin[c1]
        nodes2_f[interior, 9:12] = nmax[c1]
    return nodes2_f, nodes_i


def child_refs(nodes_i, interior_row, nodes):
    """The node64 references and leaf counts of binary nodes `nodes` (rows
    of nodes_i, pack_bvh_tables'): an interior node's row in the node64
    table (>= 0) and count 0, a leaf's -1 - (its first leaf-order row) and
    its triangle count."""
    nodes = np.asarray(nodes, np.int64)
    first = np.asarray(nodes_i, np.int64)[nodes, 0]
    count = np.asarray(nodes_i, np.int64)[nodes, 1]
    if (count >= 1 << LEAF_COUNT_BITS).any():
        raise NotImplementedError(f"a leaf of {int(count.max())} triangles (a node64 row holds "
                                  f"leaf counts below {1 << LEAF_COUNT_BITS})")
    return np.where(count > 0, -1 - first, interior_row[nodes]), count


def pack_node64_tables(nodes2_f, nodes_i):
    """One 64-byte row per interior node of pack_bvh_tables' binary tables,
    in their order (ops/bvh_kernel's walk on the card): cols 0:12 both
    children's boxes as the fused-children row has them (left min, max,
    right min, max: the same float32 values); as int32 bits, cols 12, 13
    the left and right child's reference (child_refs: a leaf's -1 - its
    first row), col 14 the split axis and col 15 both children's leaf
    counts (left | right << LEAF_COUNT_BITS; 0 for an interior child).  A
    leaf is known at its parent and is never fetched as a node.  A tree
    that is one leaf has no row: its walk starts at the leaf of all rows.

    Returns nodes64 (I, 16) float32."""
    nodes_i = np.asarray(nodes_i, np.int64)
    interior = np.flatnonzero(nodes_i[:, 1] == 0)
    row = np.full(nodes_i.shape[0], -1, np.int64)
    row[interior] = np.arange(interior.size)
    nodes64 = np.zeros((interior.size, NODE_COLS), np.float32)
    nodes64[:, 0:12] = np.asarray(nodes2_f, np.float32)[interior, 0:12]
    bits = nodes64.view(np.int32)
    bits[:, 12], n_left = child_refs(nodes_i, row, interior + 1)
    bits[:, 13], n_right = child_refs(nodes_i, row, nodes_i[interior, 0])
    bits[:, 14] = nodes_i[interior, 2]
    bits[:, 15] = n_left | n_right << LEAF_COUNT_BITS
    return nodes64


SHADE_COLS_FLAT = 15  # uv0, uv1, uv2, dpdu, dpdv, ng
SHADE_COLS_SMOOTH = 31  # ... and n0, n1, n2, dndu, dndv, has_n


def pack_prim_tables(tri, bvh: FlatBVH, tri_f, has_n):
    """The wavefront kernels' triangle rows in leaf order
    (ops/bvh_pallas.pack_bvh_tables): prims_f (P, 12) float32 [p0, e1, e2,
    pad], prims_i (P, 4) int32 [original row, material, area light (-1:
    the port has no triangle area lights), 0], and the shade rows shade_f
    from the scene-order rows tri_f (accel/geometry.shade_rows): (P, 15)
    float32 [uv0, uv1, uv2, dpdu, dpdv, ng], or when any triangle has
    vertex normals (has_n, (T,)) (P, 31) with [n0, n1, n2, dndu, dndv,
    has_n] after them."""
    order = np.asarray(bvh.prim_index, np.int64)
    p0 = np.asarray(tri.p0, np.float32)[order]
    prims_f = np.zeros((order.shape[0], 12), np.float32)
    prims_f[:, 0:3] = p0
    prims_f[:, 3:6] = np.asarray(tri.p1, np.float32)[order] - p0
    prims_f[:, 6:9] = np.asarray(tri.p2, np.float32)[order] - p0
    prims_i = np.zeros((order.shape[0], 4), np.int32)
    prims_i[:, 0] = order
    prims_i[:, 1] = np.asarray(tri.mat, np.int32)[order]
    prims_i[:, 2] = -1
    tf = np.asarray(tri_f, np.float32)[order]
    has_n = np.asarray(has_n, bool)[order]
    smooth = bool(has_n.any())
    shade_f = np.zeros((order.shape[0], SHADE_COLS_SMOOTH if smooth else SHADE_COLS_FLAT),
                       np.float32)
    shade_f[:, 0:6] = tf[:, 9:15]
    shade_f[:, 6:15] = tf[:, 24:33]
    if smooth:
        shade_f[:, 15:24] = tf[:, 15:24]
        shade_f[:, 24:30] = tf[:, 33:39]
        shade_f[:, 30] = has_n
    return prims_f, prims_i, shade_f


def pack_bvh4_tables(bvh: FlatBVH):
    """The binary tree collapsed into 4-wide nodes (ops/bvh_pallas
    .pack_bvh4_tables), in the same breadth-first order: a wide node's
    children are its binary node's grandchildren where they are interior,
    its children where they are leaves (a leaf root is its own only
    child), and each interior child is a wide node of its own.

    Returns nodes4_f (W, 24) float32, per child slot c bmin, bmax in cols
    6c..6c+5, and nodes4_i (W, 12) int32, per slot kind (CHILD_NONE,
    CHILD_INTERIOR, CHILD_LEAF), a (the wide node's row, or the leaf's
    first triangle) and b (0, or the leaf's triangle count).  An empty
    slot carries bmin 1e30 and bmax -1e30, as in the JAX package; its
    docstring says such a box never hits, but under the min / max slab
    test the swapped slabs span all of space and it does: only the kind
    keeps a walk out of it."""
    bmin, bmax = bvh.bounds_min, bvh.bounds_max
    off = np.asarray(bvh.offset, np.int64)
    npr = np.asarray(bvh.n_prims, np.int64)

    def kids(i):
        if npr[i] > 0:
            return [i]
        out = []
        for c in (i + 1, off[i]):
            out.extend([c] if npr[c] > 0 else [c + 1, off[c]])
        return out

    order = [0]  # binary node of each wide node, breadth first
    rows_f, rows_i = [], []
    head = 0
    while head < len(order):
        b = order[head]
        head += 1
        row_f = np.zeros((4, 6), np.float32)
        row_f[:, 0:3], row_f[:, 3:6] = 1e30, -1e30
        row_i = np.zeros((4, 3), np.int32)
        for c, k in enumerate(kids(b)):
            row_f[c, 0:3], row_f[c, 3:6] = bmin[k], bmax[k]
            if npr[k] > 0:
                row_i[c] = (CHILD_LEAF, off[k], npr[k])
            else:
                row_i[c] = (CHILD_INTERIOR, len(order), 0)
                order.append(k)
        rows_f.append(row_f.reshape(-1))
        rows_i.append(row_i.reshape(-1))
    return np.stack(rows_f), np.stack(rows_i)


def tree4_depth(nodes4_i) -> int:
    """Wide nodes on the longest root-to-leaf path of a BVH4 (children
    follow their parent in the breadth-first rows)."""
    kind = np.asarray(nodes4_i)[:, 0::3]
    child = np.asarray(nodes4_i)[:, 1::3]
    depth = np.ones(kind.shape[0], np.int64)
    for i in range(kind.shape[0] - 1, -1, -1):
        inner = child[i][kind[i] == CHILD_INTERIOR]
        if inner.size:
            depth[i] = 1 + depth[inner].max()
    return int(depth[0])
