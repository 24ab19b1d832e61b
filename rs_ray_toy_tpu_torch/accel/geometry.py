"""Ray-primitive queries and surface interactions for the wavefront loop
(rs_ray_toy_tpu/accel/geometry.py).

`Hit` and `SurfaceHit` are the JAX package's records, (N,) and (N, 3)
tensors.  Moller-Trumbore keeps the reference's epsilons (triangle.rs:
167-180: |det| >= 1e-7, t >= 1e-7) and honours t_max.  Spheres
(`intersect_spheres`) solve the quadratic in object space and apply the
partial-sphere clip to the near root, then retry it on the far one (the
PBRT-intended clip; the reference tests its clip on uninitialised state,
sphere.rs:50-108).  The brute-force queries (`intersect_triangles`,
`intersect_brute`, `occluded_brute`) are the plain version of kernel K4
(ops/intersect_kernel) min-combined with the spheres, which JAX computes
outside any kernel too; `surface_interaction` gathers a hit's shading
geometry from the scene-order shade tables (`pack_shade_tables`), as the
JAX package does where no shaded BVH kernel returns it: on a triangle with
vertex normals the shading normal is interpolated from them and ng faced
onto it (triangle.rs:301+); the normal partials dndu and dndv are carried
for the texture slice.  `compute_uv_differentials` and
`dead_differentials` are the JAX package's camera-ray differentials at a
hit; the specular-chain differentials are not ported.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..core.vec import coordinate_system, cross, dot, faceforward, norm3, sum3
from ..ops.intersect_kernel import intersect_triangles_reference

PRIM_NONE = -1
PRIM_TRI = 0
PRIM_SPHERE = 1
TRI_EPS = 1e-7
SPH_EPS = 1e-4


class Hit(NamedTuple):
    t: torch.Tensor  # (N,) hit distance
    kind: torch.Tensor  # (N,) PRIM_TRI or PRIM_NONE
    index: torch.Tensor  # (N,) int64 triangle row, -1 on a miss
    valid: torch.Tensor  # (N,) bool


class SurfaceHit(NamedTuple):
    """Shading geometry of each hit (interaction.rs SurfaceInteraction)."""

    p: torch.Tensor  # (N, 3)
    ng: torch.Tensor  # geometric normal, faced onto ns
    ns: torch.Tensor  # shading normal (interpolated vertex normals, or ng)
    uv: torch.Tensor  # (N, 2)
    dpdu: torch.Tensor
    dpdv: torch.Tensor
    wo: torch.Tensor
    mat: torch.Tensor  # (N,) int64, -1 on a miss
    area_light: torch.Tensor  # (N,) int64, -1: no triangle area lights
    valid: torch.Tensor  # (N,) bool
    dndu: torch.Tensor  # (N, 3) shading-normal partials (zeros on flat triangles)
    dndv: torch.Tensor


def tri_hit(t, idx, hit):
    """Hit from a triangle query's (t, idx, hit)."""
    return Hit(t=t, kind=torch.where(hit, PRIM_TRI, PRIM_NONE), index=idx, valid=hit)


def intersect_triangles(tri_packed, o, d, t_max):
    """All triangles of the packed (T, 12) table: the closest (t, idx,
    hit), t = +inf on a miss."""
    return intersect_triangles_reference(tri_packed, o, d, t_max)


def intersect_triangles_any(tri_packed, o, d, t_max):
    return intersect_triangles(tri_packed, o, d, t_max)[2]


def sphere_tables(sph, device):
    """A SphereSoA's columns as float32 tensors on `device` (mat int64),
    or None for a scene without spheres."""
    if sph is None or sph.count == 0:
        return None
    f = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    keys = ("o2w", "w2o", "radius", "z_min", "z_max", "theta_min", "theta_max", "phi_max")
    out = {k: f(getattr(sph, k)) for k in keys}
    out["mat"] = torch.as_tensor(np.array(sph.mat, np.int64), device=device)
    return out


def _sphere_rays(sph, o, d):
    """Rays in each sphere's object space: (N, S, 3) origins and directions."""
    w2o = sph["w2o"]
    oo = torch.einsum("sij,nj->nsi", w2o[:, :3, :3], o) + w2o[None, :, :3, 3]
    od = torch.einsum("sij,nj->nsi", w2o[:, :3, :3], d)
    return oo, od


def quadratic(a, b, c):
    """a t^2 + b t + c = 0 (misc.rs:231-252): (ok, t0 <= t1), zeros where
    no real root."""
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = q / torch.where(a == 0.0, 1.0, a)
    t1 = c / torch.where(q == 0.0, 1.0, q)
    lo = torch.where(ok, torch.minimum(t0, t1), 0.0)
    hi = torch.where(ok, torch.maximum(t0, t1), 0.0)
    return ok, lo, hi


def intersect_spheres(sph, o, d, t_max):
    """Every sphere of the tables `sph` (sphere_tables, or None): the
    closest (t, idx, hit) with t in (SPH_EPS, t_max), t = +inf on a miss."""
    n = o.shape[0]
    if sph is None:
        return (torch.full((n,), torch.inf, dtype=o.dtype, device=o.device),
                torch.full((n,), -1, dtype=torch.int64, device=o.device),
                torch.zeros(n, dtype=torch.bool, device=o.device))
    oo, od = _sphere_rays(sph, o, d)
    radius = sph["radius"][None]
    a = sum3(od * od)
    b = 2.0 * sum3(od * oo)
    c = sum3(oo * oo) - radius**2
    ok, t0, t1 = quadratic(a, b, c)

    def clip_ok(t):
        p = oo + od * t[..., None]
        z = torch.clamp(p[..., 2], -radius, radius)
        phi = torch.atan2(p[..., 1], p[..., 0])
        phi = torch.where(phi < 0.0, phi + 2.0 * np.pi, phi)
        zok = (z >= sph["z_min"][None] - 1e-6) & (z <= sph["z_max"][None] + 1e-6)
        return zok & (phi <= sph["phi_max"][None] + 1e-6)

    tm = t_max[:, None]
    t0_ok = ok & (t0 > SPH_EPS) & (t0 < tm) & clip_ok(t0)
    t1_ok = ok & (t1 > SPH_EPS) & (t1 < tm) & clip_ok(t1)
    t = torch.where(t0_ok, t0, torch.where(t1_ok, t1, torch.inf))
    tbest, idx = t.min(-1)
    hit = torch.isfinite(tbest)
    return tbest, torch.where(hit, idx, -1), hit


def combine_spheres(hit, sph, o, d, t_max):
    """Min-combine the spheres' closest hits with a triangle hit
    (SceneCtx._combine_spheres: primitives.rs intersect semantics)."""
    st, sidx, sh = intersect_spheres(sph, o, d, t_max)
    use_s = sh & (st < torch.where(hit.valid, hit.t, t_max))
    return Hit(
        t=torch.where(use_s, st, hit.t),
        kind=torch.where(use_s, PRIM_SPHERE, hit.kind),
        index=torch.where(use_s, sidx, hit.index),
        valid=hit.valid | sh,
    )


def intersect_brute(tri_packed, o, d, t_max, sph=None):
    hit = tri_hit(*intersect_triangles(tri_packed, o, d, t_max))
    return hit if sph is None else combine_spheres(hit, sph, o, d, t_max)


def occluded_brute(tri_packed, o, d, t_max, sph=None):
    return intersect_brute(tri_packed, o, d, t_max, sph).valid


def _normalize(v):
    return v / torch.clamp(norm3(v), min=1e-30)[..., None]


def _normal_partials(tri):
    """dndu, dndv (T, 3) float32 of the vertex normals (triangle.rs:351-386,
    the JAX package's pack_shade_tables bakes): zero without vertex
    normals; with degenerate uvs a frame about the normals' variation."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    uv0, uv1, uv2, n0, n1, n2 = (t(a) for a in (tri.uv0, tri.uv1, tri.uv2, tri.n0, tri.n1, tri.n2))
    duv02, duv12 = uv0 - uv2, uv1 - uv2
    dn1, dn2 = n0 - n2, n1 - n2
    det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    degen = torch.abs(det) < 1e-8
    i_det = 1.0 / torch.where(degen, 1.0, det)
    dndu = (dn1 * duv12[:, 1:2] - dn2 * duv02[:, 1:2]) * i_det[:, None]
    dndv = (-dn1 * duv12[:, 0:1] + dn2 * duv02[:, 0:1]) * i_det[:, None]
    dnc = cross(n2 - n0, n1 - n0)
    has_dn = sum3(dnc * dnc) > 0.0
    safe = _normalize(torch.where(has_dn[:, None], dnc, torch.tensor([0.0, 0.0, 1.0])))
    dnu_f, dnv_f = coordinate_system(safe)
    dndu = torch.where(degen[:, None], torch.where(has_dn[:, None], dnu_f, 0.0), dndu)
    dndv = torch.where(degen[:, None], torch.where(has_dn[:, None], dnv_f, 0.0), dndv)
    flat = ~torch.as_tensor(np.asarray(tri.has_n, bool))[:, None]
    return torch.where(flat, 0.0, dndu).numpy(), torch.where(flat, 0.0, dndv).numpy()


def shade_rows(tri):
    """The scene-order shading rows of the triangles (the JAX package's
    pack_shade_tables): tri_f (T, 39) float32 [p0, p1, p2 (0:9), uv0, uv1,
    uv2 (9:15), n0, n1, n2 (15:24), dpdu, dpdv, ng (24:33), dndu, dndv
    (33:39)] and tri_i (T, 3) int64 [has_n, material, area light (-1: the
    port has no triangle area lights)]."""
    dndu, dndv = _normal_partials(tri)
    f = np.concatenate(
        [np.asarray(a, np.float32).reshape(-1, k)
         for a, k in ((tri.p0, 3), (tri.p1, 3), (tri.p2, 3), (tri.uv0, 2), (tri.uv1, 2),
                      (tri.uv2, 2), (tri.n0, 3), (tri.n1, 3), (tri.n2, 3), (tri.dpdu, 3),
                      (tri.dpdv, 3), (tri.ng, 3), (dndu, 3), (dndv, 3))],
        axis=1,
    )
    i = np.stack([np.asarray(tri.has_n, np.int64), np.asarray(tri.mat, np.int64),
                  np.full(tri.count, -1, np.int64)], axis=1)
    return f, i


def pack_shade_tables(tri, device, sph=None):
    """shade_rows on `device` as {"tri_f", "tri_i"}; with spheres
    (sphere_tables) also "sph", the tables themselves."""
    f, i = shade_rows(tri)
    out = {"tri_f": torch.as_tensor(f, device=device), "tri_i": torch.as_tensor(i, device=device)}
    if sph is not None:
        out["sph"] = sph
    return out


def _sphere_surface(sph, idx, p_hit):
    """The sphere branch of surface_interaction (sphere.rs Shape::intersect):
    the hit reprojected onto the sphere in object space, ng = ns through
    w2o's transpose, (u, v) from (phi, theta), dpdu = o2w (-phi_max y,
    phi_max x, 0), dpdv along theta, dndu and dndv their object-space
    partials through w2o's transpose over |ng|.  Returns (ng, uv, dpdu,
    dpdv, dndu, dndv, mat)."""
    w2o = sph["w2o"][idx]
    o2w = sph["o2w"][idx]
    radius = sph["radius"][idx]
    po = torch.einsum("nij,nj->ni", w2o[:, :3, :3], p_hit) + w2o[:, :3, 3]
    po = po * (radius / torch.clamp(norm3(po), min=1e-30))[:, None]
    phi = torch.atan2(po[:, 1], po[:, 0])
    phi = torch.where(phi < 0, phi + 2 * np.pi, phi)
    theta = torch.arccos(torch.clamp(po[:, 2] / radius, -1.0, 1.0))
    phi_max = sph["phi_max"][idx]
    th_min, th_max = sph["theta_min"][idx], sph["theta_max"][idx]
    uv = torch.stack([phi / phi_max,
                      (theta - th_min) / torch.where(th_max == th_min, 1.0, th_max - th_min)], -1)
    inv_zr = 1.0 / torch.sqrt(torch.clamp(po[:, 0] ** 2 + po[:, 1] ** 2, min=1e-20))
    cos_phi, sin_phi = po[:, 0] * inv_zr, po[:, 1] * inv_zr
    dpdu_o = torch.stack([-phi_max * po[:, 1], phi_max * po[:, 0], torch.zeros_like(phi)], -1)
    dpdv_o = torch.stack([po[:, 2] * cos_phi, po[:, 2] * sin_phi,
                          -radius * torch.sin(theta)], -1) * (th_max - th_min)[:, None]
    ng = torch.einsum("nji,nj->ni", w2o[:, :3, :3], po)
    ng_len = torch.clamp(norm3(ng), min=1e-30)[:, None]
    ng = ng / ng_len
    dpdu = torch.einsum("nij,nj->ni", o2w[:, :3, :3], dpdu_o)
    dpdv = torch.einsum("nij,nj->ni", o2w[:, :3, :3], dpdv_o)
    dndu = torch.einsum("nji,nj->ni", w2o[:, :3, :3], dpdu_o) / ng_len
    dndv = torch.einsum("nji,nj->ni", w2o[:, :3, :3], dpdv_o) / ng_len
    return ng, uv, dpdu, dpdv, dndu, dndv, sph["mat"][idx]


def surface_interaction(shade_tables, hit, o, d):
    """The hit's shading geometry: for a triangle (triangle.rs:220-320)
    the barycentrics recomputed from the stored triangle, the
    interpolated uv, the baked dpdu, dpdv, ng, dndu and dndv, and ns the
    normalised interpolation of its vertex normals (ng where it has none
    or they sum to zero), ng faced onto ns; for a sphere _sphere_surface
    (ns = ng)."""
    idx = hit.index.clamp(min=0)
    t_safe = torch.where(hit.valid, hit.t, 0.0)
    p_hit = o + d * t_safe[:, None]
    n = o.shape[0]
    if shade_tables["tri_f"].shape[0]:
        tf = shade_tables["tri_f"][idx.clamp(max=shade_tables["tri_f"].shape[0] - 1)]
        ti = shade_tables["tri_i"][idx.clamp(max=shade_tables["tri_f"].shape[0] - 1)]
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
        dpdu, dpdv, ng = tf[:, 24:27], tf[:, 27:30], tf[:, 30:33]
        dndu, dndv = tf[:, 33:36], tf[:, 36:39]
        ns_raw = tf[:, 15:18] * w[:, None] + tf[:, 18:21] * ub[:, None] + tf[:, 21:24] * vb[:, None]
        has_n = (ti[:, 0] != 0) & (sum3(ns_raw * ns_raw) > 0.0)
        ns = torch.where(has_n[:, None], _normalize(ns_raw), ng)
        ng = faceforward(ng, ns)
        mat, al = ti[:, 1], ti[:, 2]
    else:
        ng = ns = dpdu = dpdv = dndu = dndv = torch.zeros_like(o)
        uv = torch.zeros((n, 2), dtype=o.dtype, device=o.device)
        mat = al = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    sph = shade_tables.get("sph")
    if sph is not None:
        is_s = hit.kind == PRIM_SPHERE
        s_ng, s_uv, s_dpdu, s_dpdv, s_dndu, s_dndv, s_mat = _sphere_surface(
            sph, idx.clamp(max=sph["radius"].shape[0] - 1), p_hit)
        sel = is_s[:, None]
        ng, ns, uv = torch.where(sel, s_ng, ng), torch.where(sel, s_ng, ns), torch.where(sel, s_uv, uv)
        dpdu, dpdv = torch.where(sel, s_dpdu, dpdu), torch.where(sel, s_dpdv, dpdv)
        dndu, dndv = torch.where(sel, s_dndu, dndu), torch.where(sel, s_dndv, dndv)
        mat = torch.where(is_s, s_mat, mat)
        al = torch.where(is_s, -1, al)
    return SurfaceHit(
        p=p_hit, ng=ng, ns=ns, uv=uv, dpdu=dpdu, dpdv=dpdv, wo=-d,
        mat=torch.where(hit.valid, mat, -1),
        area_light=torch.where(hit.valid, al, -1),
        valid=hit.valid, dndu=dndu, dndv=dndv,
    )


def compute_uv_differentials(si, diff):
    """Ray-differential UV footprints (interaction.rs:223-284; the JAX
    package's compute_uv_differentials): the auxiliary rays diff = (rx_o,
    rx_d, ry_o, ry_d) meet the tangent plane of ng at p, and their offsets
    from p are solved against (dpdu, dpdv) on the two axes other than
    ng's largest (first of equal ones).  Returns (duv (N, 4) = (dudx,
    dvdx, dudy, dvdy), dpdx, dpdy), zeros where not finite or not valid."""
    rx_o, rx_d, ry_o, ry_d = diff
    n = si.ng
    d_plane = dot(n, si.p)

    def plane_hit(o, dd):
        denom = dot(n, dd)
        t = (d_plane - dot(n, o)) / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
        return o + dd * t[:, None]

    dpdx = plane_hit(rx_o, rx_d) - si.p
    dpdy = plane_hit(ry_o, ry_d) - si.p
    kmax = torch.argmax(torch.abs(n), dim=-1)
    dim0 = torch.where(kmax == 0, 1, 0)[:, None]
    dim1 = torch.where(kmax == 2, 1, 2)[:, None]
    col = lambda v, k: torch.gather(v, 1, k)[:, 0]

    def solve(dp):
        a00, a01 = col(si.dpdu, dim0), col(si.dpdv, dim0)
        a10, a11 = col(si.dpdu, dim1), col(si.dpdv, dim1)
        b0, b1 = col(dp, dim0), col(dp, dim1)
        det = a00 * a11 - a01 * a10
        ok = torch.abs(det) >= 1e-10
        inv = 1.0 / torch.where(ok, det, 1.0)
        du = (a11 * b0 - a01 * b1) * inv
        dv = (a00 * b1 - a10 * b0) * inv
        return torch.where(ok, du, 0.0), torch.where(ok, dv, 0.0)

    dudx, dvdx = solve(dpdx)
    dudy, dvdy = solve(dpdy)
    fin = lambda x: torch.where(torch.isfinite(x) & si.valid, x, 0.0)
    duv = torch.stack([fin(dudx), fin(dvdx), fin(dudy), fin(dvdy)], dim=-1)
    fin3 = lambda x: torch.where(torch.isfinite(x).all(-1, keepdim=True) & si.valid[:, None],
                                 x, 0.0)
    return duv, fin3(dpdx), fin3(dpdy)


def dead_differentials(o, d):
    """Differential rays equal to the main ray: a zero footprint (the
    reference's has_differentials = false)."""
    return (o, d, o, d)


def offset_ray_origin(p, n, w):
    """Spawn-ray origin: p moved along n, to w's side, by 1e-4 + 1e-5 |p|_1
    (the JAX package's robust stand-in for geometry.rs:721-749)."""
    mag = torch.abs(p[:, 0]) + torch.abs(p[:, 1]) + torch.abs(p[:, 2])
    eps = 1e-4 + 1e-5 * mag
    off = torch.where(dot(w, n) < 0.0, -eps, eps)
    return p + n * off[:, None]
