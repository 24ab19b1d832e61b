"""Plain per-ray BVH traversal (rs_ray_toy_tpu/accel/traverse.py).

Closest hit and any hit over the wavefront kernels' BVH tables
(ops/bvh_kernel.BvhTables): the stack walk of ops/path_megakernel
.PlainGeometry (the one the camera kernels' plain versions use, and
csrc/common.cuh's Geometry<true> walks on the card) over the leaf-ordered
triangle rows, bounded by each ray's t_max, the leaf-order winner mapped
back to the scene's triangle row.  Lanes with t_max <= 0 miss.  These are
K3's plain versions; the wavefront loop reaches them on CPU tensors.
"""

import torch

from ..ops.path_megakernel import BvhTables, PackedScene, PlainGeometry


def _geometry(tables, work):
    packed = PackedScene(
        table=tables.prims_f, light_p=(), light_emit=(),
        bvh=BvhTables(tables.nodes_f, tables.nodes_i, tables.max_leaf, tables.stack),
    )
    return PlainGeometry(packed, tables.prims_f.device, work)


def walk(tables, o, d, t_max, any_hit, work=None):
    """(t, leaf-order row): t_max and -1 where nothing is hit."""
    geom = _geometry(tables, work)
    return geom.walk(*o.unbind(-1), *d.unbind(-1), t_max, t_max > 0.0, any_hit)


def intersect_bvh(tables, o, d, t_max, work=None):
    """Closest hit with t in [TRI_EPS, t_max): (t, idx, valid), t = t_max
    and idx = -1 on a miss, idx the scene's triangle row."""
    t, row = walk(tables, o, d, t_max, False, work)
    valid = row >= 0
    idx = torch.where(valid, tables.prims_i[row.clamp(min=0), 0].to(torch.int64), -1)
    return t, idx, valid


def occluded_bvh(tables, o, d, t_max, work=None):
    """Any hit with t in [TRI_EPS, t_max)."""
    return walk(tables, o, d, t_max, True, work)[1] >= 0
