"""Light sampling for point and diffuse sphere lights (rs_ray_toy_tpu/lights/lights.py).

`power` weights the Volpath light pick (integrator/mod.rs:560-571);
`point_lights` builds the table of a point-light scene, `pdf_li` is the
wavefront loop's (point lights only);
`sample_li` draws one light sample per ray for the light each ray picked,
componentwise as the JAX Volpath kernel does it (ops/path_megakernel.py
_nee_light_k): a point light's I / r^2 toward its position, or a uniform
point on a full sphere light (sphere.rs sample) with the reference's area
pdf, dist^2 / |cos| without the 1 / area (shape/mod.rs:33-47, the
AREA_PDF_QUIRK of the JAX package), and one-sided emission.  `sample_le`
emits from point lights for the SPPM photon pass (point.rs:87-113).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..config import PI
from ..core.sampling import uniform_sample_sphere
from ..scene.types import LIGHT_DIFFUSE_AREA, LIGHT_POINT

# lights/point.rs sample_le's pdf_dir is 1 / (2 pi) where PBRT has the
# sphere's 1 / (4 pi); kept, as the JAX package keeps it
# (integrators/sppm.py POINT_LE_PDF_QUIRK): photons carry half the power
POINT_LE_PDF_QUIRK = True

_Y_WEIGHTS = np.array([0.212671, 0.715160, 0.072169], np.float32)


def power(lights):
    """Light::power per light, float32: 4 pi I for a point light
    (point.rs:82-84), y(L) * area * pi for a diffuse light (diffuse.rs)."""
    e = lights.emit * _Y_WEIGHTS
    y = (e[:, 0] + e[:, 1]) + e[:, 2]
    pw = np.float32(4.0 * PI) * y
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


def light_table(kind, p, emit, o2w, w2o, radius, device):
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return LightTable(
        torch.tensor(kind, dtype=torch.int64, device=device), f(p), f(emit), f(o2w),
        f(w2o), f(radius),
    )


def point_lights(p, emit, device):
    """LightTable of point lights at p (L, 3) with intensities emit."""
    n = len(p)
    return light_table([LIGHT_POINT] * n, p, emit, np.zeros((n, 12)), np.zeros((n, 9)),
                       np.ones(n), device)


def sample_li(table, light_idx, px, py, pz, u0, u1):
    """One sample of light `light_idx` (N,) seen from (px, py, pz) with
    uniforms u0, u1.  Returns (wi, li, pdf, p_light, delta): wi and li
    and p_light as (x, y, z) / (r, g, b) tuples, delta true for point
    lights."""
    kind = table.kind[light_idx]
    emit = table.emit[light_idx]
    lp = table.p[light_idx]
    is_point = kind == LIGHT_POINT
    is_area = kind == LIGHT_DIFFUSE_AREA

    # point light (lights/point.rs:55-79)
    tlx, tly, tlz = lp[:, 0] - px, lp[:, 1] - py, lp[:, 2] - pz
    dist2 = torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=1e-20)
    sq = torch.sqrt(dist2)
    wi = [tlx / sq, tly / sq, tlz / sq]
    li = [emit[:, c] / dist2 for c in range(3)]
    pdf = torch.where(is_point, 1.0, 0.0)
    p_light = [lp[:, 0], lp[:, 1], lp[:, 2]]

    # sphere light (lights/diffuse.rs sample_li, sphere.rs sample)
    if bool(is_area.any()):
        m = table.o2w[light_idx]
        w = table.w2o[light_idx]
        rad = table.radius[light_idx]
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
        tsx, tsy, tsz = psx - px, psy - py, psz - pz
        d2 = tsx * tsx + tsy * tsy + tsz * tsz
        dn = torch.sqrt(torch.clamp(d2, min=1e-20))
        wax, way, waz = tsx / dn, tsy / dn, tsz / dn
        cos_l = torch.abs(-(wax * nsx + way * nsy + waz * nsz))
        pdf_a = d2 / torch.clamp(cos_l, min=1e-20)
        pdf_a = torch.where((d2 > 0.0) & torch.isfinite(pdf_a), pdf_a, 0.0)
        front = (nsx * -wax + nsy * -way + nsz * -waz) > 0.0
        wi = [torch.where(is_area, a, b) for a, b in zip((wax, way, waz), wi)]
        li = [torch.where(is_area, torch.where(front, emit[:, c], 0.0), li[c]) for c in range(3)]
        pdf = torch.where(is_area, pdf_a, pdf)
        p_light = [torch.where(is_area, a, b) for a, b in zip((psx, psy, psz), p_light)]
    return tuple(wi), tuple(li), pdf, tuple(p_light), is_point


def pdf_li(table, light_idx, px, py, pz, wix, wiy, wiz):
    """Light::pdf_li (lights/mod.rs): 0 for point lights, which a direction
    never hits.  Sphere lights (Shape::pdf_ref) are not ported here: the
    wavefront loop takes point lights only, so no caller passes one."""
    if bool((table.kind[light_idx] != LIGHT_POINT).any()):
        raise NotImplementedError("pdf_li of lights other than point lights")
    return torch.zeros_like(px)


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
