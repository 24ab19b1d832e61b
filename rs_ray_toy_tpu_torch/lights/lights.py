"""Light sampling (rs_ray_toy_tpu/lights/lights.py): point, distant,
diffuse-area (a sphere or one triangle) and constant-environment lights.

`power` weights the Volpath light pick and the SPPM photon emission
(integrator/mod.rs:560-571); `light_table` carries a scene's lights to the
render device (`scene_lights` from a loaded scene).  `sample_li` draws one light sample per ray for the
light each ray picked, componentwise, as the JAX package's sample_li and
its kernels' _nee_light_k do: a point light's I / r^2 toward its
position, a distant light's L along its direction, a uniform point on a
sphere light (sphere.rs sample; the whole sphere, clips or not) or a
uniform barycentric point on a triangle light, with the reference's area
pdf dist^2 / |cos| without the 1 / area (shape/mod.rs:33-47, the
AREA_PDF_QUIRK of the JAX package) and one-sided emission, or an
environment direction from its Distribution2D with the solid-angle pdf
(lights/infinite.rs:140-186).  `pdf_li` is Light::pdf_li for the BSDF
sample of MIS: it does divide by the area (shape/mod.rs:50-66), so the
quirk is one-sided, as in the JAX package.  `le_escape` is the radiance
escaped rays collect from the `infinite_lights` environments.
`sample_le` emits from point lights for the SPPM photon pass
(point.rs:87-113).  Environments are constant maps: their radiance is
the texel, everywhere.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..config import PI
from ..core.sampling import pdf_2d, sample_continuous_2d, uniform_sample_sphere
from ..core.vec import norm3, sum3
from ..scene.types import (
    AREA_SHAPE_TRIANGLE,
    LIGHT_DIFFUSE_AREA,
    LIGHT_DISTANT,
    LIGHT_INFINITE,
    LIGHT_POINT,
)

AREA_PDF_QUIRK = True  # shape/mod.rs:33-47's missing 1 / area, in sample_li only

# lights/point.rs sample_le's pdf_dir is 1 / (2 pi) where PBRT has the
# sphere's 1 / (4 pi); kept, as the JAX package keeps it
# (integrators/sppm.py POINT_LE_PDF_QUIRK): photons carry half the power
POINT_LE_PDF_QUIRK = True

_Y_WEIGHTS = np.array([0.212671, 0.715160, 0.072169], np.float32)


def is_delta(kind):
    return (kind == LIGHT_POINT) | (kind == LIGHT_DISTANT)


def power(lights):
    """Light::power per light, float32: 4 pi I for a point light
    (point.rs:82-84), pi r^2 L for distant and infinite lights with r the
    world radius (distant.rs, infinite.rs:188-191), y(L) * area * pi for
    a diffuse light (diffuse.rs)."""
    e = lights.emit * _Y_WEIGHTS
    y = (e[:, 0] + e[:, 1]) + e[:, 2]
    r = np.float32(lights.world_radius)
    pw = np.float32(4.0 * PI) * y
    far = np.float32(PI) * r * r * y
    pw = np.where((lights.kind == LIGHT_DISTANT) | (lights.kind == LIGHT_INFINITE), far, pw)
    area = y * lights.area * np.float32(PI)
    return np.where(lights.kind == LIGHT_DIFFUSE_AREA, area, pw).astype(np.float32)


class LightTable(NamedTuple):
    """Per-light constants as tensors on the render device."""

    kind: torch.Tensor  # (L,) int64
    p: torch.Tensor  # (L, 3) point position
    emit: torch.Tensor  # (L, 3)
    o2w: torch.Tensor  # (L, 12) rows of the sphere's object-to-world
    w2o: torch.Tensor  # (L, 9) 3x3 part of its inverse, row major
    radius: torch.Tensor  # (L,)
    w: torch.Tensor = None  # (L, 3) distant direction
    shape_kind: torch.Tensor = None  # (L,) int64 AREA_SHAPE_*
    tri_p: torch.Tensor = None  # (L, 9) triangle vertices
    area: torch.Tensor = None  # (L,)
    w2o_t: torch.Tensor = None  # (L, 3) translation of the sphere's inverse
    shape_index: torch.Tensor = None  # (L,) int64 environment of an infinite light
    world_radius: float = 0.0  # float32 value
    envs: tuple = ()  # device environments (env_device), the scene's order
    n_samples: tuple = ()  # python ints, each light's requested samples (all-lights strategy)


def light_table(kind, p, emit, o2w, w2o, radius, device, **more):
    """LightTable from host arrays; `more` takes the other columns as
    host arrays (world_radius and envs as they are, n_samples as ints)."""
    f = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
    cols = {k: v if k in ("world_radius", "envs") else
            tuple(int(x) for x in np.asarray(v)) if k == "n_samples" else
            torch.tensor(np.asarray(v), dtype=torch.int64, device=device)
            if k in ("shape_kind", "shape_index") else f(v) for k, v in more.items()}
    return LightTable(
        torch.tensor(kind, dtype=torch.int64, device=device), f(p), f(emit), f(o2w),
        f(w2o), f(radius), **cols,
    )


def env_device(env, device):
    """An EnvLight's constants on `device`: its texel radiance, the
    Distribution2D's float32 copy, the 3x3 of to_world and to_local."""
    f = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
    return {"rgb": f(env.rgb), "dist": env.dist.as_device(device),
            "to_world": f(env.to_world[:3, :3]), "to_local": f(env.to_local[:3, :3]),
            "escape_le": bool(env.escape_le)}


def scene_lights(scene, device):
    """The LightTable of a loaded scene's `lights`, with its environments."""
    lt = scene.lights
    n = lt.count
    return light_table(
        lt.kind, lt.p, lt.emit, lt.sph_o2w[:, :3, :4].reshape(n, 12),
        lt.sph_w2o[:, :3, :3].reshape(n, 9), lt.sph_radius, device,
        w=lt.w_light, shape_kind=lt.shape_kind, tri_p=lt.tri_p.reshape(n, 9), area=lt.area,
        w2o_t=lt.sph_w2o[:, :3, 3], shape_index=lt.shape_index,
        world_radius=float(lt.world_radius),
        envs=tuple(env_device(e, device) for e in scene.infinite), n_samples=lt.n_samples,
    )


def _env_dir(env, u0, u1):
    """InfiniteAreaLight::sample_li's direction (lights/infinite.rs:140-186):
    (wi, pdf) from the environment's Distribution2D."""
    (x, y), map_pdf = sample_continuous_2d(env["dist"], u0, u1)
    theta = y * PI
    phi = x * 2.0 * PI
    sin_t = torch.sin(theta)
    wl = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.cos(theta)], -1)
    wi = wl @ env["to_world"].T
    pdf = torch.where(sin_t > 0.0, map_pdf / (2.0 * PI * PI * torch.clamp(sin_t, min=1e-9)), 0.0)
    return wi.unbind(-1), pdf


def env_pdf(env, wx, wy, wz):
    """InfiniteAreaLight::pdf_li along world directions (the PBRT-intended
    math, as the JAX package has it)."""
    w = torch.stack([wx, wy, wz], -1) @ env["to_local"].T
    w = w / norm3(w)[:, None]
    theta = torch.arccos(torch.clamp(w[:, 2], -1.0, 1.0))
    phi = torch.atan2(w[:, 1], w[:, 0])
    phi = torch.where(phi < 0, phi + 2 * PI, phi)
    sin_t = torch.sin(theta)
    return torch.where(
        sin_t > 0.0,
        pdf_2d(env["dist"], phi / (2 * PI), theta / PI) / (2.0 * PI * PI * torch.clamp(sin_t, min=1e-9)),
        0.0,
    )


def le_escape(table, n, device):
    """Radiance (n, 3) of escaped rays (path.rs:84-87): the sum of the
    `infinite_lights` environments, constant in every direction."""
    total = torch.zeros((n, 3), dtype=torch.float32, device=device)
    for env in table.envs:
        if env["escape_le"]:
            total = total + env["rgb"]
    return total


def has_escape(table):
    return any(env["escape_le"] for env in table.envs)


def sample_li(table, light_idx, px, py, pz, u0, u1):
    """One sample of light `light_idx` (N,) seen from (px, py, pz) with
    uniforms u0, u1.  Returns (wi, li, pdf, p_light, delta): wi and li
    and p_light as (x, y, z) / (r, g, b) tuples, delta true for point and
    distant lights."""
    kind = table.kind[light_idx]
    emit = table.emit[light_idx]
    lp = table.p[light_idx]
    delta = is_delta(kind)
    present = set(int(k) for k in torch.unique(table.kind).tolist())

    # point light (lights/point.rs:55-79)
    tlx, tly, tlz = lp[:, 0] - px, lp[:, 1] - py, lp[:, 2] - pz
    dist2 = torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=1e-20)
    sq = torch.sqrt(dist2)
    wi = [tlx / sq, tly / sq, tlz / sq]
    li = [emit[:, c] / dist2 for c in range(3)]
    pdf = torch.where(delta, 1.0, 0.0)
    p_light = [lp[:, 0], lp[:, 1], lp[:, 2]]
    two_r = 2.0 * table.world_radius

    # distant light (lights/distant.rs:66-91)
    if LIGHT_DISTANT in present:
        is_dist = kind == LIGHT_DISTANT
        wd = table.w[light_idx]
        wi = [torch.where(is_dist, wd[:, c], wi[c]) for c in range(3)]
        li = [torch.where(is_dist, emit[:, c], li[c]) for c in range(3)]
        p_light = [torch.where(is_dist, pc + wd[:, c] * two_r, p_light[c])
                   for c, pc in enumerate((px, py, pz))]

    # diffuse area light (lights/diffuse.rs sample_li, shape sample_ref)
    if LIGHT_DIFFUSE_AREA in present:
        is_area = kind == LIGHT_DIFFUSE_AREA
        m = table.o2w[light_idx]
        w = table.w2o[light_idx]
        rad = table.radius[light_idx]
        # sphere: a uniform point on the whole sphere (sphere.rs sample)
        z = 1.0 - 2.0 * u0
        r_ = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * PI * u1
        pox, poy, poz = r_ * torch.cos(phi) * rad, r_ * torch.sin(phi) * rad, z * rad
        psx = m[:, 0] * pox + m[:, 1] * poy + m[:, 2] * poz + m[:, 3]
        psy = m[:, 4] * pox + m[:, 5] * poy + m[:, 6] * poz + m[:, 7]
        psz = m[:, 8] * pox + m[:, 9] * poy + m[:, 10] * poz + m[:, 11]
        # the normal through the inverse's transpose
        nsx = w[:, 0] * pox + w[:, 3] * poy + w[:, 6] * poz
        nsy = w[:, 1] * pox + w[:, 4] * poy + w[:, 7] * poz
        nsz = w[:, 2] * pox + w[:, 5] * poy + w[:, 8] * poz
        ninv = 1.0 / torch.sqrt(torch.clamp(nsx * nsx + nsy * nsy + nsz * nsz, min=1e-30))
        nsx, nsy, nsz = nsx * ninv, nsy * ninv, nsz * ninv
        if table.shape_kind is not None and bool((table.shape_kind == AREA_SHAPE_TRIANGLE).any()):
            # triangle: a uniform barycentric point (the PBRT-intended warp)
            is_tri = table.shape_kind[light_idx] == AREA_SHAPE_TRIANGLE
            tp = table.tri_p[light_idx]
            su = torch.sqrt(torch.clamp(u0, min=0.0))
            b0 = 1.0 - su
            b1 = u1 * su
            b2 = 1.0 - b0 - b1
            pt = [tp[:, c] * b0 + tp[:, 3 + c] * b1 + tp[:, 6 + c] * b2 for c in range(3)]
            e1 = tp[:, 3:6] - tp[:, 0:3]
            e2 = tp[:, 6:9] - tp[:, 0:3]
            nt = torch.linalg.cross(e1, e2)
            nt = nt / norm3(nt)[:, None]
            psx, psy, psz = (torch.where(is_tri, a, b) for a, b in zip(pt, (psx, psy, psz)))
            nsx, nsy, nsz = (torch.where(is_tri, nt[:, c], b)
                             for c, b in enumerate((nsx, nsy, nsz)))
        tsx, tsy, tsz = psx - px, psy - py, psz - pz
        d2 = tsx * tsx + tsy * tsy + tsz * tsz
        dn = torch.sqrt(torch.clamp(d2, min=1e-20))
        wax, way, waz = tsx / dn, tsy / dn, tsz / dn
        cos_l = torch.abs(-(wax * nsx + way * nsy + waz * nsz))
        pdf_a = d2 / torch.clamp(cos_l, min=1e-20)
        if not AREA_PDF_QUIRK:
            pdf_a = pdf_a / torch.clamp(table.area[light_idx], min=1e-20)
        pdf_a = torch.where((d2 > 0.0) & torch.isfinite(pdf_a), pdf_a, 0.0)
        front = (nsx * -wax + nsy * -way + nsz * -waz) > 0.0
        wi = [torch.where(is_area, a, b) for a, b in zip((wax, way, waz), wi)]
        li = [torch.where(is_area, torch.where(front, emit[:, c], 0.0), li[c]) for c in range(3)]
        pdf = torch.where(is_area, pdf_a, pdf)
        p_light = [torch.where(is_area, a, b) for a, b in zip((psx, psy, psz), p_light)]

    # environment (lights/infinite.rs:140-186)
    for env_id, env in enumerate(table.envs):
        sel = (kind == LIGHT_INFINITE) & (table.shape_index[light_idx] == env_id)
        if not bool((table.shape_index == env_id).any()):
            continue
        we, pdf_e = _env_dir(env, u0, u1)
        wi = [torch.where(sel, a, b) for a, b in zip(we, wi)]
        li = [torch.where(sel, env["rgb"][c], li[c]) for c in range(3)]
        pdf = torch.where(sel, pdf_e, pdf)
        p_light = [torch.where(sel, pc + a * two_r, b)
                   for pc, a, b in zip((px, py, pz), we, p_light)]
    return tuple(wi), tuple(li), pdf, tuple(p_light), delta


def pdf_li(table, light_idx, px, py, pz, wix, wiy, wiz):
    """Light::pdf_li (lights/mod.rs) of light `light_idx` seen from p along
    wi: 0 for delta lights; for an area light its shape hit along wi
    (Shape::pdf_ref, shape/mod.rs:50-66) at d^2 / (|cos| area); for an
    environment env_pdf."""
    kind = table.kind[light_idx]
    pdf = torch.zeros_like(px)
    p = torch.stack([px, py, pz], -1)
    wi = torch.stack([wix, wiy, wiz], -1)
    if bool((table.kind == LIGHT_DIFFUSE_AREA).any()):
        w2o = table.w2o[light_idx].reshape(-1, 3, 3)
        oo = torch.einsum("nij,nj->ni", w2o, p) + table.w2o_t[light_idx]
        od = torch.einsum("nij,nj->ni", w2o, wi)
        a = sum3(od * od)
        b = 2.0 * sum3(od * oo)
        c = sum3(oo * oo) - table.radius[light_idx] ** 2
        disc = b * b - 4 * a * c
        hit_s = disc > 0.0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        q = torch.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
        t0 = q / torch.clamp(a, min=1e-20)
        t1 = c / torch.where(q == 0, 1.0, q)
        tmin = torch.minimum(t0, t1)
        tt = torch.where(tmin > 1e-4, tmin, torch.maximum(t0, t1))
        hit_s = hit_s & (tt > 1e-4)
        p_hit_o = oo + od * tt[:, None]
        o2w = table.o2w[light_idx].reshape(-1, 3, 4)
        p_hit_s = torch.einsum("nij,nj->ni", o2w[:, :, :3], p_hit_o) + o2w[:, :, 3]
        n_hit_s = torch.einsum("nji,nj->ni", w2o, p_hit_o)
        n_hit_s = n_hit_s / norm3(n_hit_s)[:, None]
        # triangle
        tp = table.tri_p[light_idx]
        p0 = tp[:, 0:3]
        e1 = tp[:, 3:6] - p0
        e2 = tp[:, 6:9] - p0
        pv = torch.linalg.cross(wi, e2)
        det = sum3(e1 * pv)
        inv = 1.0 / torch.where(torch.abs(det) < 1e-9, 1.0, det)
        tv = p - p0
        uu = sum3(tv * pv) * inv
        qv = torch.linalg.cross(tv, e1)
        vv = sum3(wi * qv) * inv
        tt_t = sum3(e2 * qv) * inv
        hit_t = ((torch.abs(det) >= 1e-9) & (uu >= 0) & (uu <= 1) & (vv >= 0) & (uu + vv <= 1)
                 & (tt_t > 1e-4))
        p_hit_t = p + wi * tt_t[:, None]
        n_hit_t = torch.linalg.cross(e1, e2)
        n_hit_t = n_hit_t / norm3(n_hit_t)[:, None]
        is_tri = (table.shape_kind[light_idx] == AREA_SHAPE_TRIANGLE)
        hit = torch.where(is_tri, hit_t, hit_s)
        p_hit = torch.where(is_tri[:, None], p_hit_t, p_hit_s)
        n_hit = torch.where(is_tri[:, None], n_hit_t, n_hit_s)
        d2 = sum3((p - p_hit) ** 2)
        denom = torch.abs(sum3(-wi * n_hit)) * table.area[light_idx]
        pdf_a = torch.where(hit & (denom > 0.0), d2 / torch.clamp(denom, min=1e-20), 0.0)
        pdf = torch.where(kind == LIGHT_DIFFUSE_AREA, pdf_a, pdf)
    for env_id, env in enumerate(table.envs):
        if not bool((table.shape_index == env_id).any()):
            continue
        sel = (kind == LIGHT_INFINITE) & (table.shape_index[light_idx] == env_id)
        pdf = torch.where(sel, env_pdf(env, wix, wiy, wiz), pdf)
    return pdf


def sample_le(light_p, light_emit, light_idx, u0, u1):
    """Light::sample_le of point lights (the point branch of the JAX
    package's integrators/sppm._sample_le): light_p and light_emit (L, 3)
    tensors, light_idx (N,), the direction's uniforms (u0, u1).  Returns
    (origin, direction, light normal, Le, pdf_pos, pdf_dir), the vectors
    as (N, 3)."""
    d = torch.stack(uniform_sample_sphere(u0, u1), -1)
    pdf_dir = 1.0 / (2.0 * PI) if POINT_LE_PDF_QUIRK else 1.0 / (4.0 * PI)
    return (light_p[light_idx], d, d, light_emit[light_idx], torch.ones_like(u0),
            torch.full_like(u0, pdf_dir))
