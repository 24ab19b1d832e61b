"""Ray-triangle queries and surface interactions for the wavefront loop
(rs_ray_toy_tpu/accel/geometry.py, its triangle branch).

`Hit` and `SurfaceHit` are the JAX package's records, (N,) and (N, 3)
tensors.  Moller-Trumbore keeps the reference's epsilons (triangle.rs:
167-180: |det| >= 1e-7, t >= 1e-7) and honours t_max.  The brute-force
queries (`intersect_triangles`, `intersect_brute`, `occluded_brute`) are
the plain version of kernel K4 (ops/intersect_kernel); `surface_interaction`
gathers a hit's shading geometry from the scene-order shade table
(`pack_shade_tables`), as the JAX package does where no shaded BVH kernel
returns it.  Spheres, smooth normals and ray differentials are not ported.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..core.vec import cross, dot
from ..ops.intersect_kernel import intersect_triangles_reference

PRIM_NONE = -1
PRIM_TRI = 0
TRI_EPS = 1e-7


class Hit(NamedTuple):
    t: torch.Tensor  # (N,) hit distance
    kind: torch.Tensor  # (N,) PRIM_TRI or PRIM_NONE
    index: torch.Tensor  # (N,) int64 triangle row, -1 on a miss
    valid: torch.Tensor  # (N,) bool


class SurfaceHit(NamedTuple):
    """Shading geometry of each hit (interaction.rs SurfaceInteraction)."""

    p: torch.Tensor  # (N, 3)
    ng: torch.Tensor  # geometric normal
    ns: torch.Tensor  # shading normal (= ng: flat triangles)
    uv: torch.Tensor  # (N, 2)
    dpdu: torch.Tensor
    dpdv: torch.Tensor
    wo: torch.Tensor
    mat: torch.Tensor  # (N,) int64, -1 on a miss
    area_light: torch.Tensor  # (N,) int64, -1: no triangle area lights
    valid: torch.Tensor  # (N,) bool


def tri_hit(t, idx, hit):
    """Hit from a triangle query's (t, idx, hit)."""
    return Hit(t=t, kind=torch.where(hit, PRIM_TRI, PRIM_NONE), index=idx, valid=hit)


def intersect_triangles(tri_packed, o, d, t_max):
    """All triangles of the packed (T, 12) table: the closest (t, idx,
    hit), t = +inf on a miss."""
    return intersect_triangles_reference(tri_packed, o, d, t_max)


def intersect_triangles_any(tri_packed, o, d, t_max):
    return intersect_triangles(tri_packed, o, d, t_max)[2]


def intersect_brute(tri_packed, o, d, t_max):
    return tri_hit(*intersect_triangles(tri_packed, o, d, t_max))


def occluded_brute(tri_packed, o, d, t_max):
    return intersect_brute(tri_packed, o, d, t_max).valid


def pack_shade_tables(tri, device):
    """Per-triangle shading rows in scene order: tri_f (T, 24) float32
    [p0, p1, p2, uv0, uv1, uv2, dpdu, dpdv, ng] and tri_i (T, 2) int64
    [material, area light]."""
    f = np.concatenate(
        [np.asarray(a, np.float32)
         for a in (tri.p0, tri.p1, tri.p2, tri.uv0, tri.uv1, tri.uv2, tri.dpdu, tri.dpdv, tri.ng)],
        axis=1,
    )
    i = np.stack([np.asarray(tri.mat, np.int64), np.full(tri.count, -1, np.int64)], axis=1)
    return {"tri_f": torch.as_tensor(f, device=device), "tri_i": torch.as_tensor(i, device=device)}


def surface_interaction(shade_tables, hit, o, d):
    """The hit's shading geometry (triangle.rs:220-320): the barycentrics
    recomputed from the stored triangle, the interpolated uv, the baked
    dpdu, dpdv and ng, and ns = ng."""
    idx = hit.index.clamp(min=0)
    t_safe = torch.where(hit.valid, hit.t, 0.0)
    p_hit = o + d * t_safe[:, None]
    tf = shade_tables["tri_f"][idx]
    ti = shade_tables["tri_i"][idx]
    p0 = tf[:, 0:3]
    e1 = tf[:, 3:6] - p0
    e2 = tf[:, 6:9] - p0
    pv = cross(d, e2)
    det = dot(e1, pv)
    inv = 1.0 / torch.where(torch.abs(det) < TRI_EPS, 1.0, det)
    tv = o - p0
    ub = dot(tv, pv) * inv
    vb = dot(d, cross(tv, e1)) * inv
    w = 1.0 - ub - vb
    uv = tf[:, 9:11] * w[:, None] + tf[:, 11:13] * ub[:, None] + tf[:, 13:15] * vb[:, None]
    ng = tf[:, 21:24]
    return SurfaceHit(
        p=p_hit, ng=ng, ns=ng, uv=uv, dpdu=tf[:, 15:18], dpdv=tf[:, 18:21], wo=-d,
        mat=torch.where(hit.valid, ti[:, 0], -1),
        area_light=torch.where(hit.valid, ti[:, 1], -1),
        valid=hit.valid,
    )


def offset_ray_origin(p, n, w):
    """Spawn-ray origin: p moved along n, to w's side, by 1e-4 + 1e-5 |p|_1
    (the JAX package's robust stand-in for geometry.rs:721-749)."""
    mag = torch.abs(p[:, 0]) + torch.abs(p[:, 1]) + torch.abs(p[:, 2])
    eps = 1e-4 + 1e-5 * mag
    off = torch.where(dot(w, n) < 0.0, -eps, eps)
    return p + n * off[:, None]
