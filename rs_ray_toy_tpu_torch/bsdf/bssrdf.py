"""Separable BSSRDF with the Burley diffusion profile
(rs_ray_toy_tpu/bsdf/bssrdf.py; bssrdf.rs, material/disney.rs DisneyBSSRDF).

Wavefront form: a ray that specular-transmits into a subsurface material
importance-samples an exit point by the projection-axis / channel /
radius scheme (bssrdf.rs:107-193).  The probe ray's intersection chain is
a bounded loop of PROBE_SEGMENTS closest-hit re-casts along the probe
chord, each limited to the rest of the chord, keeping the hits of the
entry's material; one is picked uniformly and weighted by pdf_sp
(bssrdf.rs:195-232, the 3-axis x 3-channel MIS) / n_found.

Profile (Burley 2015 eq 5, disney.rs sr / sample_sr):
  Sr(r) = R (e^{-r/d} + e^{-r/(3d)}) / (8 pi d r)
sampled by picking the d or 3d exponential (1:3 split).  The JAX package's
choices are kept: the reference's u * u * C - ch channel remap, the
PBRT-intended pdf_sr (the reference misparenthesises its second term;
docs/PARITY.md), and the exit interaction's shading normal is its face
normal.

The exit ("Sw") adapter BSDF (bssrdf.rs:250-279): f = (1 - Fr(cos w)) /
(c pi), times eta^2 in radiance mode, cosine-sampled.
"""

from typing import NamedTuple

import torch

from ..accel import geometry as geom
from ..config import DTYPE, ONE_MINUS_EPSILON, PI
from ..core.vec import dot, norm3
from .eval import _fr_dielectric

PROBE_SEGMENTS = 4  # the bounded intersection chain


def fresnel_moment1(eta):
    """(bssrdf.rs:443-457) the polynomial fit."""
    eta2 = eta * eta
    eta3 = eta2 * eta
    eta4 = eta3 * eta
    eta5 = eta4 * eta
    lo = (0.45966 - 1.73965 * eta + 3.37668 * eta2 - 3.904945 * eta3
          + 2.49277 * eta4 - 0.68441 * eta5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * eta2 + 5.11455 * eta3
          - 1.27198 * eta4 + 0.12746 * eta5)
    return torch.where(eta < 1.0, lo, hi)


def sr_profile(R, d, r):
    """Sr(r) of albedo R and distance d (N, 3) at radii r (N,): (N, 3)."""
    rr = torch.clamp(r, min=1e-6)[..., None]
    return R * (torch.exp(-rr / d) + torch.exp(-rr / (3.0 * d))) / (8.0 * PI * d * rr)


def sample_sr(d_ch, u):
    """A radius from the channel's profile (disney.rs sample_sr)."""
    first = u < 0.25
    u1 = torch.clamp(u * 4.0, max=ONE_MINUS_EPSILON)
    u2 = torch.clamp((u - 0.25) / 0.75, max=ONE_MINUS_EPSILON)
    r1 = d_ch * torch.log(1.0 / (1.0 - u1))
    r2 = 3.0 * d_ch * torch.log(1.0 / (1.0 - u2))
    return torch.where(first, r1, r2)


def pdf_sr(d_ch, r, folded=None):
    """The pdf of sample_sr (PBRT-intended form).  `folded`: (3 d, 2 pi d,
    6 pi d) where the caller folded them (the path kernel's host
    constants), else computed here."""
    rr = torch.clamp(r, min=1e-6)
    d3, den1, den3 = folded or (3.0 * d_ch, 2.0 * PI * d_ch, 6.0 * PI * d_ch)
    return (0.25 * torch.exp(-rr / d_ch) / (den1 * rr)
            + 0.75 * torch.exp(-rr / d3) / (den3 * rr))


def sw_f(eta, cos_w, folded=None):
    """The Sw adapter's f (bssrdf.rs:103-106, 250-279), eta^2 of radiance
    mode included.  `folded`: (max(c pi, 1e-9), eta^2) where the caller
    folded them (the path kernel's host constants), else computed here."""
    if folded is None:
        c = 1.0 - 2.0 * fresnel_moment1(1.0 / eta)
        return (1.0 - _fr_dielectric(cos_w, 1.0, eta)) / torch.clamp(c * PI, min=1e-9) * eta * eta
    den, eta2 = folded
    return (1.0 - _fr_dielectric(cos_w, 1.0, eta)) / den * eta2


class BssrdfSample(NamedTuple):
    pi: geom.SurfaceHit  # the exit interaction
    sp: torch.Tensor  # (N, 3) spatial term
    pdf: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool


def sample_bssrdf(ctx, si, frame, u1, u2):
    """SeparableBSSRDF::sample_sp (bssrdf.rs:107-193) at the entry points
    `si` (valid where the material has a BSSRDF) with the frame `frame`,
    u1 (N,) and u2 (N, 2): the exit interactions, Sp and pdf.  The probe
    chain re-casts through ctx.intersect (kernels K4 and K3)."""
    bss = ctx.bssrdf
    mat_id = si.mat.clamp(min=0)
    has = bss["has"][mat_id] & si.valid
    R = bss["R"][mat_id]
    d_prof = bss["d"][mat_id]

    # projection axis (bssrdf.rs:118-141): 1/2 the normal, 1/4 each tangent
    ss, ts, ns = frame.ss, frame.ts, frame.ns
    u = u1
    sel0 = u < 0.5
    sel1 = (u >= 0.5) & (u < 0.75)
    u = torch.where(sel0, u * 2.0, torch.where(sel1, (u - 0.5) * 4.0, (u - 0.75) * 4.0))
    pick3 = lambda a, b, c: torch.where(sel0[:, None], a, torch.where(sel1[:, None], b, c))
    vx, vy, vz = pick3(ss, ts, ns), pick3(ts, ns, ss), pick3(ns, ss, ts)

    # channel, with the reference's u * u * C - ch remap (bssrdf.rs:143-145)
    ch = torch.clamp((u * 3).to(torch.int64), 0, 2)
    u = u * u * 3.0 - ch.to(DTYPE)
    d_ch = torch.gather(d_prof, 1, ch[:, None])[:, 0]

    r = sample_sr(d_ch, u2[:, 0])
    r_max = sample_sr(d_ch, torch.full_like(r, 0.999))
    ok = has & (r >= 0.0) & (r < r_max)
    l_chord = 2.0 * torch.sqrt(torch.clamp(r_max * r_max - r * r, min=0.0))
    phi = 2.0 * PI * u2[:, 1]
    base = (si.p + (vx * torch.cos(phi)[:, None] + vy * torch.sin(phi)[:, None]) * r[:, None]
            - vz * (l_chord * 0.5)[:, None])
    target = base + vz * l_chord[:, None]

    # the probe chain: bounded re-casts, the hits of the entry's material kept
    found_p, found_valid, found_kind, found_idx = [], [], [], []
    cur, alive = base, ok
    for _ in range(PROBE_SEGMENTS):
        seg = target - cur
        seg_len = norm3(seg)
        d_unit = seg / torch.clamp(seg_len, min=1e-20)[:, None]
        live = alive & (seg_len > 1e-9)
        hit = ctx.intersect(cur, d_unit, torch.where(live, seg_len * (1.0 - 1e-4), 0.0))
        got = live & hit.valid
        hsi = ctx.surface(hit, cur, d_unit)
        same = got & (hsi.mat == si.mat)
        found_p.append(torch.where(same[:, None], hsi.p, 0.0))
        found_valid.append(same)
        found_kind.append(hit.kind)
        found_idx.append(hit.index)
        cur = torch.where(got[:, None], geom.offset_ray_origin(hsi.p, hsi.ng, d_unit), cur)
        alive = got

    valid_k = torch.stack(found_valid)  # (K, N)
    n_found = valid_k.sum(0)
    ok = ok & (n_found > 0)
    # the pick (bssrdf.rs:177-180) with the remapped u
    pick = torch.minimum(torch.clamp((u * n_found.to(DTYPE)).to(torch.int64), min=0),
                         torch.clamp(n_found - 1, min=0))
    cum = torch.cumsum(valid_k.to(torch.int64), 0)
    slot = torch.argmax(((cum == (pick + 1)[None, :]) & valid_k).to(torch.int64), 0)
    lane = torch.arange(slot.shape[0], device=slot.device)
    hit_sel = geom.Hit(t=torch.zeros_like(r), kind=torch.stack(found_kind)[slot, lane],
                       index=torch.stack(found_idx)[slot, lane], valid=ok)
    p_exit = torch.stack(found_p)[slot, lane]
    # the exit's geometry from its primitive; its shading normal is the
    # face normal (probe hits carry no barycentrics)
    pi = ctx.surface(hit_sel, p_exit, -ns)
    pi = pi._replace(p=p_exit, ns=pi.ng, wo=pi.ng, valid=ok)

    # pdf_sp (bssrdf.rs:195-232) / n_found
    d_vec = si.p - pi.p
    dl = [dot(ss, d_vec), dot(ts, d_vec), dot(ns, d_vec)]
    nl = [dot(ss, pi.ng), dot(ts, pi.ng), dot(ns, pi.ng)]
    r_proj = [torch.sqrt(dl[1] ** 2 + dl[2] ** 2), torch.sqrt(dl[2] ** 2 + dl[0] ** 2),
              torch.sqrt(dl[0] ** 2 + dl[1] ** 2)]
    pdf = torch.zeros_like(r)
    for axis, prob in enumerate((0.25, 0.25, 0.5)):
        for c in range(3):
            pdf = pdf + pdf_sr(d_prof[:, c], r_proj[axis]) * torch.abs(nl[axis]) * prob
    pdf = pdf * (1.0 / 3.0)
    pdf = pdf / torch.clamp(n_found.to(DTYPE), min=1.0)

    dist = norm3(d_vec)
    sp = sr_profile(R, d_prof, dist)
    return BssrdfSample(
        pi=pi,
        sp=torch.where(ok[:, None], sp, 0.0),
        pdf=torch.where(ok, pdf, 0.0),
        valid=ok & (pdf > 0.0),
    )
