"""Plain per-ray BVH traversal (rs_ray_toy_tpu/accel/traverse.py).

Closest hit and any hit over the wavefront kernels' BVH tables
(ops/bvh_kernel.BvhTables): the stack walk of ops/path_megakernel
.PlainGeometry over the fused-children rows (csrc/common.cuh's
Geometry<true> walks them on the card) over the leaf-ordered triangle
rows, bounded by each ray's t_max, the leaf-order winner mapped back to
the scene's triangle row (`fused_rows`: bvh_kernel's walk), and the same
walk over the node64 rows (`walk64`: csrc/common.cuh Bvh64, which finds
the same hits in the same order; the closest and any hit's walk, and
ops/path_megakernel.walk_node64, the path kernel's);
or, where the tables say `wide`, the
BVH4 walk (`walk4`, ops/bvh_pallas._traverse4_kernel for one ray).  Lanes
with t_max <= 0 miss.  These are K3's plain versions; the wavefront loop
reaches them on CPU tensors.
"""

import torch

from ..ops.path_megakernel import (BIG_T, BvhTables, PackedScene, PlainGeometry, _inv_dir, _mt,
                                   _slab_tn, tally, walk_node64)
from .bvh import CHILD_INTERIOR, CHILD_LEAF, CHILD_NONE


def _geometry(tables, work):
    packed = PackedScene(
        table=tables.prims_f, light_p=(), light_emit=(),
        bvh=BvhTables(tables.nodes_f, tables.nodes_i, tables.max_leaf, tables.stack),
    )
    return PlainGeometry(packed, tables.prims_f.device, work)


def walk(tables, o, d, t_max, any_hit, work=None, fused_rows=False):
    """(t, leaf-order row): t_max and -1 where nothing is hit (any hit: the
    first row hit); the walk over the fused-children rows with
    `fused_rows`, else the BVH4 walk where the tables are `wide`, else the
    node64 walk."""
    if fused_rows:
        geom = _geometry(tables, work)
        return geom.walk(*o.unbind(-1), *d.unbind(-1), t_max, t_max > 0.0, any_hit)
    if tables.wide:
        return walk4(tables, o, d, t_max, any_hit, work)
    return walk64(tables, o, d, t_max, any_hit, work)[:2]


def walk64(tables, o, d, t_max, any_hit, work=None):
    """The binary walk over the node64 rows (accel/bvh.pack_node64_tables;
    csrc/common.cuh Bvh64) of one ray per lane: ops/path_megakernel
    .walk_node64 over the tables' leaf-order rows, the path kernel's plain
    walk too.  Returns (t, leaf-order row, steps: the rows fetched and
    leaves tested per ray, 0 where t_max <= 0); `work` gets the slab and
    Moller-Trumbore tests the kernel makes ("slab", "mt") and the interior
    rows it fetches ("node")."""
    if tables.nodes64 is None:
        raise ValueError("tables without the node64 rows (pack_bvh)")
    dev = o.device
    return walk_node64(tables.nodes64.to(dev), tables.prims_f.to(dev)[:, :9], tables.max_leaf,
                       tables.stack, o, d, t_max, t_max > 0.0, any_hit, work)


def step_stats(steps, live, warp=32):
    """Per-ray walk lengths of one batch (walk64's steps over the live
    rays): their mean and 99th percentile, the warps' longest walks (32
    consecutive rays, as the kernel's lanes) averaged over the warps with a
    live ray, and the longest."""
    s = steps.double()
    w = torch.nn.functional.pad(s, (0, -s.numel() % warp)).view(-1, warp)
    lw = torch.nn.functional.pad(live, (0, -live.numel() % warp)).view(-1, warp).any(1)
    sl = s[live]
    return dict(mean=float(sl.mean()), p99=float(torch.quantile(sl[::max(1, sl.numel() >> 24)],
                                                                0.99)),
                warp_max_mean=float(w.amax(1)[lw].mean()), max=float(sl.max()))


# the compare-swap network that orders a wide node's four pushes far to
# near (_traverse4_kernel's): after swap(i, j) slot i holds the farther key
SWAPS = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))


def walk4(tables, o, d, t_max, any_hit, work=None):
    """The BVH4 walk of one ray per lane, the rays still walking compacted
    after every pop: a pop tests the popped wide node's child slots in
    order against the ray's best t (an empty slot is skipped by its kind,
    not by its box), tests a hit leaf child's triangles at once in leaf
    order with strict <, and pushes the hit interior children far to near
    by this ray's entry distance (ties keep slot order), so the nearest
    is popped next.  Any hit stops at the first triangle hit.  The stack
    holds tables.stack4 entries, enough for the tree (accel/bvh
    .stack4_for); a push past it raises rather than drop a subtree.
    Returns (t, leaf-order row) as `walk`; `work` gets the slab tests of
    the non-empty slots and the Moller-Trumbore tests the kernel makes
    ("slab", "mt")."""
    if tables.nodes4_f is None:
        raise ValueError("tables without the BVH4's nodes (pack_bvh(..., wide=True))")
    dev = o.device
    nodes_f, nodes_i = tables.nodes4_f.to(dev), tables.nodes4_i.to(dev).to(torch.int64)
    geo = tables.prims_f.to(dev)[:, :9]
    t_out = t_max.clone()
    row_out = torch.full(t_max.shape, -1, dtype=torch.int64, device=dev)
    idx = torch.nonzero(t_max > 0.0).squeeze(1)
    ro, rd = o[idx].unbind(-1), d[idx].unbind(-1)
    inv = tuple(_inv_dir(c) for c in rd)
    tb = t_max[idx]
    best = torch.full_like(idx, -1)
    m = idx.numel()
    stack = torch.zeros((m, tables.stack4), dtype=torch.int64, device=dev)
    sp = torch.ones_like(idx)
    k = torch.arange(tables.max_leaf, device=dev)
    while m:
        lane = torch.arange(m, device=dev)
        sp = sp - 1
        node = stack[lane, sp]
        row_f, row_i = nodes_f[node], nodes_i[node]
        found = torch.zeros(m, dtype=torch.bool, device=dev)
        ids, keys, push = [], [], []
        for c in range(4):
            kind, a, b = row_i[:, 3 * c], row_i[:, 3 * c + 1], row_i[:, 3 * c + 2]
            live = (kind != CHILD_NONE) & ~found if any_hit else kind != CHILD_NONE
            hit, tn = _slab_tn(row_f[:, 6 * c:6 * c + 6], *ro, *inv, tb)
            hit = hit & live
            tally(work, "slab", live)
            # a hit leaf child: its triangles, now
            leaf = hit & (kind == CHILD_LEAF)
            valid = leaf[:, None] & (k < b[:, None])
            g = geo[torch.where(valid, a[:, None] + k, 0)].unbind(-1)
            tri_hit, t = _mt(g, *(x[:, None] for x in ro + rd))
            tri_hit = valid & tri_hit & (t < tb[:, None])
            any_tri = tri_hit.any(1)
            first = torch.where(tri_hit, k, k.numel()).min(1).values
            if any_hit:
                # the kernel stops at the first hit: it tests the leaf up to it
                tally(work, "mt", torch.where(any_tri, first + 1, valid.sum(1)))
                best = torch.where(any_tri, a + first, best)
                found = found | any_tri
            else:
                tally(work, "mt", valid)
                tm = torch.where(tri_hit, t, BIG_T)
                t_min = tm.min(1).values
                first = torch.where(tri_hit & (tm == t_min[:, None]), k, k.numel()).min(1).values
                tb = torch.where(any_tri, t_min, tb)
                best = torch.where(any_tri, a + first, best)
            inner = hit & (kind == CHILD_INTERIOR)
            ids.append(a)
            keys.append(torch.where(inner, tn, BIG_T))
            push.append(inner)
        for i, j in SWAPS:
            lt = keys[i] < keys[j]
            for v in (ids, keys, push):
                v[i], v[j] = torch.where(lt, v[j], v[i]), torch.where(lt, v[i], v[j])
        for s_ in range(4):
            p = push[s_] & ~found if any_hit else push[s_]
            if bool((p & (sp >= tables.stack4)).any()):
                raise RuntimeError(f"the BVH4 walk's {tables.stack4}-entry stack overflowed")
            slot = torch.where(p, sp, 0)
            stack[lane, slot] = torch.where(p, ids[s_], stack[lane, slot])
            sp = sp + p
        done = (sp == 0) | found
        if bool(done.any()):
            t_out[idx[done]] = tb[done]
            row_out[idx[done]] = best[done]
            keep = ~done
            idx, tb, best, stack, sp = idx[keep], tb[keep], best[keep], stack[keep], sp[keep]
            ro = tuple(c[keep] for c in ro)
            rd = tuple(c[keep] for c in rd)
            inv = tuple(c[keep] for c in inv)
            m = idx.numel()
    return t_out, row_out


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
