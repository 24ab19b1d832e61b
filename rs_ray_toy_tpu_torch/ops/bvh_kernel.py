"""BVH closest hit, any hit and shaded closest hit, K3
(rs_ray_toy_tpu/ops/bvh_pallas.py: intersect_bvh_pallas, occluded_bvh_pallas,
intersect_bvh_pallas_shaded).

`pack_bvh` builds the wavefront kernels' tables for a triangle scene: the
repository's SAH BVH with leaves of KERNEL_LEAF triangles (SceneCtx's
kernel leaf), its fused-children node rows, and the triangles in leaf
order (intersect rows, original row / material / area light, and the 15
flat shade columns, or 31 with the vertex normals, their partials and
has_n when any triangle has vertex normals), for any number of
triangles.  The closest-hit and any-hit queries walk the binary tree
(the JAX package's default walk, and the faster one on the card than the
BVH4's: PERF.md §6) over the node64 rows (accel/bvh.pack_node64_tables:
one 64-byte fetch per interior node, both children's references in it)
with `bvh64_kernel`, and so does the shaded closest hit
(`bvh_shaded_kernel`).  `bvh_kernel`, the walk over the fused-children rows
that the closest and any hit replaced, finds the same hits in the same
order; it stays launchable (`prepare_launch(..., fused_rows=True)`) for
the comparison on the card.  `pack_bvh(..., wide=True)` also collapses
the tree into 4-wide nodes (BVH4: accel/bvh.pack_bvh4_tables) and has
those queries walk them (`bvh4_kernel`, the JAX package's `RS_BVH_WIDE=1`
kernel).  The shaded walk is the binary one over the node64 rows either
way: the JAX package has no wide one.  A tree of 64 levels or more is
walked by the kernels' deep instances, whose stack holds 256 nodes
(accel/bvh.stack_for; the BVH4 walk's by stack4_for); a tree too deep for
256 raises NotImplementedError: there is no slower walk to fall back to.

- `intersect_bvh(tables, o, d, t_max)`: closest hit with t in
  [TRI_EPS, t_max): (t, idx, valid), t = t_max and idx = -1 on a miss.
- `occluded_bvh(...)`: any hit in the same interval.
- `intersect_bvh_shaded(...)`: the closest hit and the winner's surface
  attributes (barycentric u, v, uv, ns, ng, dpdu, dpdv, material, area
  light): on flat rows ns = ng, on smooth rows (the `bvh_shaded_smooth`
  instance) ns interpolated from the vertex normals and ng faced onto it,
  and dndu, dndv.

A lane with t_max <= 0 misses without walking (the loop's dead lanes).  On
a CUDA tensor each wrapper launches csrc/bvh_kernel.cu (built by
ops/_build.py) or raises; on a CPU tensor it runs the plain version: the
stack walk of accel/traverse (`*_reference`; the shaded one walks the
node64 rows, `traverse.walk64`).
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..accel import traverse
from ..accel.bvh import (
    SHADE_COLS_FLAT,
    SHADE_COLS_SMOOTH,
    DEEP_STACK,
    NODE4_COLS,
    NODE4_I_COLS,
    build_bvh,
    pack_bvh4_tables,
    pack_bvh_tables,
    pack_node64_tables,
    pack_prim_tables,
    stack4_for,
    stack_for,
    tree4_depth,
    tree_depth,
)
from ..accel.geometry import shade_rows
from . import _build
from .intersect_kernel import ray_args

KERNEL_LEAF = 16  # SceneCtx's kernel leaf size (integrators/common.py in the JAX package)
ATTR_ROWS = 16  # u, v, uv (2), ns (3), ng (3), dpdu (3), dpdv (3)
ATTR_ROWS_SMOOTH = 22  # ... and dndu (3), dndv (3)

# Kernel launches, by kernel; the one piece of module state.  bvh_closest
# and bvh_any count the comparison's launches of bvh_kernel (fused_rows).
LAUNCHES = {"bvh64_closest": 0, "bvh64_any": 0, "bvh_shaded": 0, "bvh_shaded_smooth": 0,
            "bvh4_closest": 0, "bvh4_any": 0, "bvh_closest": 0, "bvh_any": 0}


def launch_key(any_hit, wide):
    """The LAUNCHES key of a closest-hit or any-hit query: the BVH4's walk
    where `wide`, else bvh64_kernel's."""
    return ("bvh4_" if wide else "bvh64_") + ("any" if any_hit else "closest")


_LIB = None


class BvhTables(NamedTuple):
    nodes_f: torch.Tensor  # (M, 16) float32 fused-children rows
    nodes_i: torch.Tensor  # (M, 4) int32: offset, n_prims, axis, 0
    prims_f: torch.Tensor  # (P, 12) float32 leaf order: p0, e1, e2, pad
    prims_i: torch.Tensor  # (P, 4) int32: original row, material, area light, 0
    # (P, 15) float32: uv0, uv1, uv2, dpdu, dpdv, ng; smooth (P, 31): and
    # n0, n1, n2, dndu, dndv, has_n
    shade_f: torch.Tensor
    max_leaf: int
    depth: int
    # the BVH4 (pack_bvh(..., wide=True)), None without it
    nodes4_f: torch.Tensor = None  # (W, 24) float32: per child slot bmin, bmax
    nodes4_i: torch.Tensor = None  # (W, 12) int32: per child slot kind, a, b
    depth4: int = 0  # wide nodes on the longest path
    wide: bool = False  # closest and any hit walk the BVH4
    # (I, 16) float32 node64 rows, one per interior node (accel/bvh
    # .pack_node64_tables): the binary closest, any and shaded hit walk them
    nodes64: torch.Tensor = None

    @property
    def smooth(self):
        return self.shade_f.shape[1] == SHADE_COLS_SMOOTH

    @property
    def stack(self):
        """The walk's stack: the deep instances' above 63 levels."""
        return stack_for(self.depth)

    @property
    def stack4(self):
        """The BVH4 walk's stack (accel/bvh.stack4_for)."""
        return stack4_for(self.depth4)


def pack_bvh(tri, device, wide=False) -> BvhTables:
    """The tables of the triangles `tri`, the node64 rows among them.  With
    `wide`, the BVH4's nodes too, and the closest-hit and any-hit queries
    walk them (`_replace(wide=False)` of those tables walks the binary
    tree)."""
    flat = build_bvh(tri, KERNEL_LEAF)
    depth = tree_depth(flat)
    stack_for(depth)  # raises for a tree too deep for every instance
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    wide_rows = ()
    if wide:
        nodes4_f, nodes4_i = pack_bvh4_tables(flat)
        depth4 = tree4_depth(nodes4_i)
        stack4_for(depth4)  # raises for a wide tree too deep for every instance
        wide_rows = (t(nodes4_f), t(nodes4_i), depth4, True)
    nodes_f, nodes_i = pack_bvh_tables(flat)
    tri_f, tri_i = shade_rows(tri)
    prims_f, prims_i, shade_f = pack_prim_tables(tri, flat, tri_f, tri_i[:, 0])
    return BvhTables(t(nodes_f), t(nodes_i), t(prims_f), t(prims_i), t(shade_f), flat.max_leaf,
                     depth, *wide_rows, nodes64=t(pack_node64_tables(nodes_f, nodes_i)))


# ---- the plain PyTorch versions ----


def intersect_bvh_reference(tables, o, d, t_max, work=None):
    return traverse.intersect_bvh(tables, o, d, t_max, work)


def occluded_bvh_reference(tables, o, d, t_max, work=None):
    return traverse.occluded_bvh(tables, o, d, t_max, work)


def intersect_bvh_shaded_reference(tables, o, d, t_max, work=None, fused_rows=False):
    """Plain version of the shaded kernel, with its outputs: (t, idx,
    material, area light, attrs (16, N), or (22, N) on smooth rows);
    misses carry t_max, -1, -1, -1 and zeros.  Its walk is the node64
    walk's (traverse.walk64), whose counts `work` gets; with `fused_rows`
    the walk over the fused-children rows that the kernel took before the
    node64 rows, which finds the same hits (for the comparison)."""
    if fused_rows:
        t, row = traverse.walk(tables, o, d, t_max, False, work, fused_rows=True)
    else:
        t, row, _ = traverse.walk64(tables, o, d, t_max, False, work)
    valid = row >= 0
    r = row.clamp(min=0)
    g = tables.prims_f[r]
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    # Moller-Trumbore's u, v on the winner, the kernel's expressions
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = g[:, :9].unbind(-1)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = 1.0 / torch.where(torch.abs(det) >= 1e-7, det, 1.0)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    s = tables.shade_f[r]
    w = 1.0 - u - v
    uvx = s[:, 0] * w + s[:, 2] * u + s[:, 4] * v
    uvy = s[:, 1] * w + s[:, 3] * u + s[:, 5] * v
    ngx, ngy, ngz = s[:, 12:15].unbind(-1)
    nsx, nsy, nsz = ngx, ngy, ngz
    rows_d = []
    if tables.smooth:
        # _traverse_shaded_kernel's finalize: ns interpolated from the raw
        # vertex normals (ng without them), ng faced onto it
        nx = s[:, 15] * w + s[:, 18] * u + s[:, 21] * v
        ny = s[:, 16] * w + s[:, 19] * u + s[:, 22] * v
        nz = s[:, 17] * w + s[:, 20] * u + s[:, 23] * v
        len2 = nx * nx + ny * ny + nz * nz
        has_n = (s[:, 30] != 0.0) & (len2 > 0.0)
        rinv = 1.0 / torch.sqrt(torch.clamp(len2, min=1e-30))
        nsx = torch.where(has_n, nx * rinv, ngx)
        nsy = torch.where(has_n, ny * rinv, ngy)
        nsz = torch.where(has_n, nz * rinv, ngz)
        flip = ngx * nsx + ngy * nsy + ngz * nsz < 0.0
        ngx, ngy, ngz = (torch.where(flip, -c, c) for c in (ngx, ngy, ngz))
        rows_d = s[:, 24:30].unbind(-1)
    rows = [u, v, uvx, uvy, nsx, nsy, nsz, ngx, ngy, ngz, *s[:, 6:9].unbind(-1),
            *s[:, 9:12].unbind(-1), *rows_d]
    attrs = torch.where(valid, torch.stack(rows), 0.0)
    pi = tables.prims_i[r].to(torch.int64)
    none = torch.full_like(row, -1)
    return (t, torch.where(valid, pi[:, 0], none), torch.where(valid, pi[:, 1], none),
            torch.where(valid, pi[:, 2], none), attrs)


# ---- the CUDA kernels ----


def load_kernel():
    """The K3 library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("bvh_kernel")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bvh_launch.restype = i
        lib.bvh_launch.argtypes = [i, i, p, p, p, p, i, p, p, p, p, p, i, p]
        lib.bvh_shaded_launch.restype = i
        lib.bvh_shaded_launch.argtypes = [i, p, i, p, p, p, i, i, p, p, p, p, p, p, p, p, i, p]
        lib.bvh_shaded_occupancy.restype = None
        lib.bvh_shaded_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.bvh4_launch.restype = i
        lib.bvh4_launch.argtypes = [i, i, p, p, p, p, i, p, p, p, p, p, i, p]
        lib.bvh64_launch.restype = i
        lib.bvh64_launch.argtypes = [i, i, p, i, p, p, i, p, p, p, p, p, i, p]
        lib.bvh64_occupancy.restype = None
        lib.bvh64_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.bvh_error_string.restype = ctypes.c_char_p
        lib.bvh_error_string.argtypes = [i]
        if lib.bvh_deep_stack() != DEEP_STACK:
            raise RuntimeError("bvh_kernel's deep stack differs from accel/bvh.DEEP_STACK")
        _LIB = lib
    return _LIB


def _check_tables(tables, dev, fused_rows=False):
    m, p = tables.nodes_f.shape[0], tables.prims_f.shape[0]
    for name, x, dtype, shape in (
        ("nodes_f", tables.nodes_f, torch.float32, (m, 16)),
        ("nodes_i", tables.nodes_i, torch.int32, (m, 4)),
        ("prims_f", tables.prims_f, torch.float32, (p, 12)),
        ("prims_i", tables.prims_i, torch.int32, (p, 4)),
        ("shade_f", tables.shade_f, torch.float32,
         (p, SHADE_COLS_SMOOTH if tables.smooth else SHADE_COLS_FLAT)),
    ):
        if x.device != dev or x.dtype != dtype or x.shape != shape or not x.is_contiguous():
            raise ValueError(f"BVH table {name} must be contiguous {dtype} {shape} on {dev}")
    if not 0 < p or tables.depth >= DEEP_STACK:
        raise ValueError(f"{p} primitives / depth {tables.depth} outside the kernels' limits")
    if tables.wide:
        w = tables.nodes4_f.shape[0] if tables.nodes4_f is not None else 0
        for name, x, dtype, shape in (
            ("nodes4_f", tables.nodes4_f, torch.float32, (w, NODE4_COLS)),
            ("nodes4_i", tables.nodes4_i, torch.int32, (w, NODE4_I_COLS)),
        ):
            if (x is None or x.device != dev or x.dtype != dtype or x.shape != shape
                    or not x.is_contiguous()):
                raise ValueError(f"BVH4 table {name} must be contiguous {dtype} {shape} on {dev}")
        tables.stack4  # raises for a wide tree too deep for every instance
    elif not fused_rows:
        x = tables.nodes64
        if (x is None or x.device != dev or x.dtype != torch.float32 or x.dim() != 2
                or x.shape[1] != 16 or not x.shape[0] < m or not x.is_contiguous()
                or (x.shape[0] == 0) != (m == 1)):
            raise ValueError(f"BVH table nodes64 must be contiguous float32 (I, 16) on {dev}, "
                             f"a row per interior node")
    return p


def prepare_launch(tables, o, d, t_max, any_hit, fused_rows=False):
    """Check the CUDA inputs, allocate the outputs and return launch(): one
    launch of the closest-hit (any_hit False) or any-hit walk, the BVH4
    walk where the tables are `wide`, else the node64 walk (bvh64_kernel;
    with `fused_rows`, bvh_kernel's walk over the fused-children rows, for
    the comparison), on the current stream returning (t, idx int32);
    relaunching rewrites them."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"the BVH kernel runs on cuda tensors, not {dev}")
    o, d, t_max = ray_args(o, d, t_max)
    if fused_rows and tables.wide:
        raise ValueError("the walk over the fused-children rows is the binary tree's")
    p = _check_tables(tables, dev, fused_rows)
    n = o.shape[0]
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    idx_out = torch.empty(n, dtype=torch.int32, device=dev)
    lib = load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if tables.wide:
        key, fn = launch_key(any_hit, True), lib.bvh4_launch
        args = (int(any_hit), int(tables.stack4 == DEEP_STACK), tables.nodes4_f.data_ptr(),
                tables.nodes4_i.data_ptr())
    elif fused_rows:
        key, fn = "bvh_" + ("any" if any_hit else "closest"), lib.bvh_launch
        args = (int(any_hit), int(tables.stack == DEEP_STACK), tables.nodes_f.data_ptr(),
                tables.nodes_i.data_ptr())
    else:
        key, fn = launch_key(any_hit, False), lib.bvh64_launch
        args = (int(any_hit), int(tables.stack == DEEP_STACK), tables.nodes64.data_ptr(),
                tables.nodes64.shape[0])

    def launch():
        err = fn(*args, tables.prims_f.data_ptr(), tables.prims_i.data_ptr(), p, o.data_ptr(),
                 d.data_ptr(), t_max.data_ptr(), t_out.data_ptr(), idx_out.data_ptr(), n, stream)
        if err != 0:
            msg = lib.bvh_error_string(err).decode()
            raise RuntimeError(f"{key} kernel launch failed: CUDA error {err} ({msg})")
        LAUNCHES[key] += 1
        return t_out, idx_out

    return launch


def occupancy(shaded=False):
    """The last bvh64_kernel launch (with `shaded`, bvh_shaded_kernel's):
    its block size, blocks resident per SM, registers per thread and
    dynamic shared memory bytes (none), as the library chose and measured
    them."""
    out = (ctypes.c_int * 4)()
    lib = load_kernel()
    (lib.bvh_shaded_occupancy if shaded else lib.bvh64_occupancy)(out)
    return dict(zip(("block", "blocks_per_sm", "registers", "smem"), out))


def prepare_shaded_launch(tables, o, d, t_max):
    """As prepare_launch for the shaded kernel (its smooth instance on
    smooth rows), which walks the node64 rows (of the binary tree, also
    where the tables are `wide`); launch() returns (t, idx, material, area
    light (int32), attrs (16, N), or (22, N) smooth)."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"the BVH kernel runs on cuda tensors, not {dev}")
    o, d, t_max = ray_args(o, d, t_max)
    p = _check_tables(tables._replace(wide=False), dev)
    n = o.shape[0]
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    ints = torch.empty((3, n), dtype=torch.int32, device=dev)
    smooth = tables.smooth
    attrs = torch.empty((ATTR_ROWS_SMOOTH if smooth else ATTR_ROWS, n), dtype=torch.float32,
                        device=dev)
    lib = load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = "bvh_shaded_smooth" if smooth else "bvh_shaded"
    deep = int(tables.stack == DEEP_STACK)

    def launch():
        err = lib.bvh_shaded_launch(
            deep, tables.nodes64.data_ptr(), tables.nodes64.shape[0], tables.prims_f.data_ptr(),
            tables.prims_i.data_ptr(), tables.shade_f.data_ptr(), int(smooth), p, o.data_ptr(),
            d.data_ptr(), t_max.data_ptr(), t_out.data_ptr(), ints[0].data_ptr(),
            ints[1].data_ptr(), ints[2].data_ptr(), attrs.data_ptr(), n, stream,
        )
        if err != 0:
            msg = lib.bvh_error_string(err).decode()
            raise RuntimeError(f"{key} kernel launch failed: CUDA error {err} ({msg})")
        LAUNCHES[key] += 1
        return t_out, ints[0], ints[1], ints[2], attrs

    return launch


def intersect_bvh(tables, o, d, t_max):
    """Closest hit: (t, idx int64, valid).  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        return intersect_bvh_reference(tables, o, d, t_max)
    t, idx = prepare_launch(tables, o, d, t_max, False)()
    idx = idx.to(torch.int64)
    return t, idx, idx >= 0


def occluded_bvh(tables, o, d, t_max):
    if o.device.type == "cpu":
        return occluded_bvh_reference(tables, o, d, t_max)
    return prepare_launch(tables, o, d, t_max, True)()[1] >= 0


def intersect_bvh_shaded(tables, o, d, t_max):
    """Closest hit and the winner's attributes: (t, idx, valid, attrs)
    with attrs a dict of uv (N, 2), ns, ng, dpdu, dpdv, dndu, dndv (N, 3;
    the partials zeros on flat rows), mat and area_light (N,) int64, as
    intersect_bvh_pallas_shaded returns them."""
    if o.device.type == "cpu":
        t, idx, mat, al, a = intersect_bvh_shaded_reference(tables, o, d, t_max)
    else:
        t, idx, mat, al, a = prepare_shaded_launch(tables, o, d, t_max)()
    idx = idx.to(torch.int64)
    v3 = lambda k: a[k:k + 3].T
    zeros = torch.zeros_like(a[:3].T)
    attrs = dict(uv=a[2:4].T, ns=v3(4), ng=v3(7), dpdu=v3(10), dpdv=v3(13),
                 dndu=v3(16) if tables.smooth else zeros, dndv=v3(19) if tables.smooth else zeros,
                 mat=mat.to(torch.int64), area_light=al.to(torch.int64))
    return t, idx, idx >= 0, attrs
