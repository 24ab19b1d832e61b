"""BVH build (host) and the fused-children node tables the kernels walk
(rs_ray_toy_tpu/accel/bvh.py and ops/bvh_pallas.pack_bvh_tables).

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
