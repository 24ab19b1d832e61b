"""BSDF evaluation and sampling over lobe rows (rs_ray_toy_tpu/bsdf/eval.py).

A hit's lobes are one row of the packed layout (ops/path_megakernel
.pack_scene): col 15 the lobe count, col 31 the Bsdf eta, and lobe l in
cols 16 + 16 * l: kind, s0, s1, s2, alpha_u, alpha_v, fresnel code and
the eta pair.  The kernels' plain versions read the per-triangle table
(`_lobe`, `_lobe_f`, `_lobe_pdf`, `_lobe_sample`, `_bsdf_sample` on
local-frame components), the wavefront loop a per-material row
(integrators/common.SceneCtx.shade_params) through the Bsdf methods on
(N, 3) world vectors: `bsdf_f_pdf` (Bsdf::f and Bsdf::pdf, fused as the
JAX package fuses them for NEE), `bsdf_sample` and `num_components`.  A
wavefront row of S lobe slots carries, after the 16 * S lobe columns,
four more per slot: the lobe's RGB scale (ScaledBxdf) and its
microfacet distribution code.

The lobes the port's loader emits are evaluated: lambert reflection and
transmission, Oren-Nayar, visible-normal Trowbridge-Reitz reflection and
transmission (joint or Disney's separable Smith G), specular reflection
and transmission, fresnel specular, and the Disney diffuse, fake subsurface, retro,
sheen, clearcoat and microfacet lobes (disney.rs, with the reference's
log10 in GTR1 and its clearcoat sample form), and the Debug material's
two (debug_material.rs: constant f (0, 1, 0) diffuse and (0, 0, 1)
"specular", both cosine sampled, the second flagged specular); a kind the rows do not
hold costs nothing (`_has`).  Flags follow reflection.rs:
BxDF::match_flags and the geometric-normal reflect / transmit gate of
Bsdf::f.
"""

from typing import NamedTuple

import torch

from ..config import DTYPE, ONE_MINUS_EPSILON, PI
from ..core.sampling import concentric_sample_disk
from ..core.vec import dot, rsqrt
from .lobes import (
    DIST_DISNEY_SEPARABLE_G,
    FRESNEL_CONDUCTOR,
    FRESNEL_DIELECTRIC,
    FRESNEL_DISNEY,
    LOBE_DEBUG_DIFFUSE,
    LOBE_DEBUG_SPECULAR,
    LOBE_DISNEY_CLEARCOAT,
    LOBE_DISNEY_DIFFUSE,
    LOBE_DISNEY_FAKE_SS,
    LOBE_DISNEY_MICROFACET_REFL,
    LOBE_DISNEY_RETRO,
    LOBE_DISNEY_SHEEN,
    LOBE_FRESNEL_SPEC,
    LOBE_LAMBERT_REFL,
    LOBE_LAMBERT_TRANS,
    LOBE_MF_REFL,
    LOBE_MF_TRANS,
    LOBE_OREN_NAYAR,
    LOBE_SPEC_REFL,
    LOBE_SPEC_TRANS,
)

# BxDF type flags (reflection.rs BxDFType)
BXDF_REFLECTION = 1 << 0
BXDF_TRANSMISSION = 1 << 1
BXDF_DIFFUSE = 1 << 2
BXDF_GLOSSY = 1 << 3
BXDF_SPECULAR = 1 << 4
BXDF_ALL = BXDF_REFLECTION | BXDF_TRANSMISSION | BXDF_DIFFUSE | BXDF_GLOSSY | BXDF_SPECULAR
# flags of the ported lobe kinds, by kind code (0: no lobe)
LOBE_FLAGS = {
    LOBE_LAMBERT_REFL: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_OREN_NAYAR: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_LAMBERT_TRANS: BXDF_DIFFUSE | BXDF_TRANSMISSION,
    LOBE_SPEC_REFL: BXDF_SPECULAR | BXDF_REFLECTION,
    LOBE_SPEC_TRANS: BXDF_SPECULAR | BXDF_TRANSMISSION,
    LOBE_FRESNEL_SPEC: BXDF_ALL,  # reflection.rs:801-803
    LOBE_MF_REFL: BXDF_GLOSSY | BXDF_REFLECTION,
    LOBE_MF_TRANS: BXDF_GLOSSY | BXDF_TRANSMISSION,
    LOBE_DISNEY_DIFFUSE: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_DISNEY_FAKE_SS: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_DISNEY_RETRO: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_DISNEY_SHEEN: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_DISNEY_CLEARCOAT: BXDF_GLOSSY | BXDF_REFLECTION,
    LOBE_DISNEY_MICROFACET_REFL: BXDF_GLOSSY | BXDF_REFLECTION,
    LOBE_DEBUG_DIFFUSE: BXDF_DIFFUSE | BXDF_REFLECTION,
    LOBE_DEBUG_SPECULAR: BXDF_SPECULAR | BXDF_REFLECTION,
}
_FLAG_TABLE = [LOBE_FLAGS.get(k, 0) for k in range(32)]
# the microfacet reflection kinds: Trowbridge-Reitz D, visible-normal sampled
MF_KINDS = (LOBE_MF_REFL, LOBE_DISNEY_MICROFACET_REFL)
EXTRA_COLS = 4  # a wavefront row's per-slot scale (3) and distribution code


def shading_frame(nsx, nsy, nsz, dux, duy, duz):
    """(ss, ts) of the shading frame on the normal ns: ss = normalize(dpdu),
    coordinate_system(ns) when dpdu is degenerate; ts = ns x ss."""
    du2 = dux * dux + duy * duy + duz * duz
    inv = rsqrt(torch.clamp(du2, min=1e-30))
    big_x = torch.abs(nsx) > torch.abs(nsy)
    inv_a = rsqrt(
        torch.clamp(torch.where(big_x, nsx * nsx + nsz * nsz, nsy * nsy + nsz * nsz), min=1e-30)
    )
    bad = du2 < 1e-20
    ssx = torch.where(bad, torch.where(big_x, -nsz, 0.0) * inv_a, dux * inv)
    ssy = torch.where(bad, torch.where(big_x, 0.0, nsz) * inv_a, duy * inv)
    ssz = torch.where(bad, torch.where(big_x, nsx, -nsy) * inv_a, duz * inv)
    tsx = nsy * ssz - nsz * ssy
    tsy = nsz * ssx - nsx * ssz
    tsz = nsx * ssy - nsy * ssx
    return ssx, ssy, ssz, tsx, tsy, tsz


def _lobe(row, base, extra=None):
    """Lobe columns starting at `base` of (N, >=base+15) rows; `extra`, the
    column of a wavefront row's scale and distribution code for this slot
    (the kernels' tables hold neither: scale 1, and the distribution the
    kind implies)."""
    lob = dict(
        kind=row[:, base].to(torch.int32),
        s0=(row[:, base + 1], row[:, base + 2], row[:, base + 3]),
        s1=(row[:, base + 4], row[:, base + 5], row[:, base + 6]),
        s2=(row[:, base + 7], row[:, base + 8], row[:, base + 9]),
        au=row[:, base + 10],
        av=row[:, base + 11],
        fres=row[:, base + 12].to(torch.int32),
        eta_a=row[:, base + 13],
        eta_b=row[:, base + 14],
    )
    if extra is not None:
        lob["scale"] = (row[:, extra], row[:, extra + 1], row[:, extra + 2])
        lob["dist"] = row[:, extra + 3].to(torch.int32)
    return lob


def _in(kind, kinds):
    m = kind == kinds[0]
    for k in kinds[1:]:
        m = m | (kind == k)
    return m


def _has(kind, *kinds):
    """(mask, any lane has it): a branch no lane takes is not computed."""
    m = _in(kind, kinds)
    return m, bool(m.any())


def _is_spec(kind):
    return (kind == LOBE_SPEC_REFL) | (kind == LOBE_SPEC_TRANS) | (kind == LOBE_FRESNEL_SPEC)


def _trig_theta_phi(x, y, z):
    cos2 = z * z
    sin2 = torch.clamp(1.0 - cos2, min=0.0)
    tan2 = sin2 / torch.where(cos2 == 0.0, 1e-30, cos2)
    sin_t = torch.sqrt(sin2)
    zs = sin_t == 0.0
    safe = torch.where(zs, 1.0, sin_t)
    cos_p = torch.where(zs, 1.0, torch.clamp(x / safe, -1.0, 1.0))
    sin_p = torch.where(zs, 0.0, torch.clamp(y / safe, -1.0, 1.0))
    return cos2, tan2, cos_p * cos_p, sin_p * sin_p


def _tr_d(x, y, z, au, av):
    cos2, tan2, c2p, s2p = _trig_theta_phi(x, y, z)
    c4 = cos2 * cos2
    e = (c2p / (au * au) + s2p / (av * av)) * tan2
    ope = 1.0 + e
    d = 1.0 / (PI * au * av * c4 * (ope * ope))
    return torch.where(torch.isfinite(tan2) & (c4 > 0.0), d, 0.0)


def _tr_lambda(x, y, z, au, av):
    _, tan2, c2p, s2p = _trig_theta_phi(x, y, z)
    alpha2 = c2p * au * au + s2p * av * av
    lam = (-1.0 + torch.sqrt(1.0 + alpha2 * tan2)) / 2.0
    return torch.where(torch.isfinite(tan2), lam, 0.0)


def _fr_dielectric(cos_i, eta_i, eta_t):
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    sin_i = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_par = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-20)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-20)
    return torch.where(tir, 1.0, 0.5 * (r_par * r_par + r_perp * r_perp))


def _fr_conductor(ci2, si2, eta, k):
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - si2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=0.0))
    t1 = a2b2 + ci2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * torch.sqrt(ci2)
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = a2b2 * ci2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rp + rs)


def _schlick_weight(cos_t):
    m = torch.clamp(1.0 - cos_t, 0.0, 1.0)
    return (m * m) * (m * m) * m


def _fresnel(lob, cos_i):
    """(fr, fg, fb) by the lobe's fresnel code: dielectric, conductor,
    Disney (disney.rs:310-333: lerp(metallic in eta_a, dielectric(1, eta
    in eta_b), Schlick(c_spec0 in s1))), or 1 (no-op)."""
    fr_d = _fr_dielectric(cos_i, lob["eta_a"], lob["eta_b"])
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)
    ci2 = ci * ci
    si2 = 1.0 - ci2
    code = lob["fres"]
    out = [
        torch.where(
            code == FRESNEL_DIELECTRIC,
            fr_d,
            torch.where(
                code == FRESNEL_CONDUCTOR,
                _fr_conductor(ci2, si2, lob["s2"][c], lob["s1"][c]),
                1.0,
            ),
        )
        for c in range(3)
    ]
    dis, any_dis = _has(code, FRESNEL_DISNEY)
    if any_dis:
        metallic = lob["eta_a"]
        fr_d1 = _fr_dielectric(cos_i, torch.ones_like(cos_i), lob["eta_b"])
        sw = _schlick_weight(cos_i)
        s1 = lob["s1"]
        out = [
            torch.where(dis, (1.0 - metallic) * fr_d1 + metallic * (s1[c] + (1.0 - s1[c]) * sw),
                        out[c])
            for c in range(3)
        ]
    return out


def _gtr1(cos_theta, alpha):
    """disney.rs GTR1 with the reference's log10 (PBRT's is ln)."""
    a2 = alpha * alpha
    return (a2 - 1.0) / (PI * torch.log10(torch.clamp(a2, min=1e-9))
                         * (1.0 + (a2 - 1.0) * cos_theta * cos_theta))


def _cc_g(cos_theta):
    """Smith G_GGX at the clearcoat's fixed alpha 0.25."""
    a2 = 0.0625
    c2 = cos_theta * cos_theta
    return 1.0 / torch.clamp(cos_theta + torch.sqrt(torch.clamp(a2 + c2 - a2 * c2, min=0.0)),
                             min=1e-9)


def _sep_g(lob, kind):
    """Lanes whose microfacet G is Disney's separable G1(wo) G1(wi): the
    Disney microfacet kind, and a wavefront row's distribution code."""
    sep = kind == LOBE_DISNEY_MICROFACET_REFL
    if "dist" in lob:
        sep = sep | (lob["dist"] == DIST_DISNEY_SEPARABLE_G)
    return sep


def _eta_t(lob, woz):
    """MF_TRANS's relative eta, eta_b / eta_a entering."""
    return torch.where(woz > 0.0, lob["eta_b"] / lob["eta_a"], lob["eta_a"] / lob["eta_b"])


def _scaled(lob, f):
    if "scale" not in lob:
        return f
    return [f[c] * lob["scale"][c] for c in range(3)]


def _lobe_f(lob, wox, woy, woz, wix, wiy, wiz):
    """lobe_f on local-frame directions by the lobe's kind, times its
    scale; specular (and unported) kinds evaluate to 0."""
    kind = lob["kind"]
    whx, why, whz = wox + wix, woy + wiy, woz + wiz
    wh2 = whx * whx + why * why + whz * whz
    wh_len = torch.sqrt(torch.clamp(wh2, min=0.0))
    wh_zero = wh2 == 0.0
    inv_l = 1.0 / torch.clamp(wh_len, min=1e-20)
    nhx, nhy, nhz = whx * inv_l, why * inv_l, whz * inv_l
    co = torch.abs(woz)
    ci = torch.abs(wiz)
    zero = torch.zeros_like(wox)
    out = [zero, zero, zero]

    def put(mask, v):
        out[:] = [torch.where(mask, v[c], out[c]) for c in range(3)]

    is_lam, any_lam = _has(kind, LOBE_LAMBERT_REFL, LOBE_LAMBERT_TRANS)
    if any_lam:
        put(is_lam, [lob["s0"][c] / PI for c in range(3)])
    is_mf, any_mf = _has(kind, *MF_KINDS)
    if any_mf:
        ok = (co > 0.0) & (ci > 0.0) & (wh_len > 0.0)
        s = torch.where(nhz < 0.0, -1.0, 1.0)
        fr3 = _fresnel(lob, wix * (s * nhx) + wiy * (s * nhy) + wiz * (s * nhz))
        au, av = lob["au"], lob["av"]
        d_val = _tr_d(nhx, nhy, nhz, au, av)
        lam_o = _tr_lambda(wox, woy, woz, au, av)
        lam_i = _tr_lambda(wix, wiy, wiz, au, av)
        g = 1.0 / (1.0 + lam_o + lam_i)
        g = torch.where(_sep_g(lob, kind), (1.0 / (1.0 + lam_o)) * (1.0 / (1.0 + lam_i)), g)
        scale = d_val * g / torch.clamp(4.0 * ci * co, min=1e-20)
        put(is_mf, [torch.where(ok, lob["s0"][c] * fr3[c] * scale, 0.0) for c in range(3)])
    is_dif, any_dif = _has(kind, LOBE_DISNEY_DIFFUSE, LOBE_DISNEY_RETRO, LOBE_DISNEY_SHEEN,
                           LOBE_DISNEY_FAKE_SS)
    if any_dif:
        fo = _schlick_weight(co)
        fi = _schlick_weight(ci)
        cos_d = wix * nhx + wiy * nhy + wiz * nhz
        is_dd, any_dd = _has(kind, LOBE_DISNEY_DIFFUSE)
        if any_dd:
            dfac = (1.0 - fo / 2.0) * (1.0 - fi / 2.0) / PI
            put(is_dd, [lob["s0"][c] * dfac for c in range(3)])
        is_rt, any_rt = _has(kind, LOBE_DISNEY_RETRO)
        if any_rt:
            rr = 2.0 * lob["au"] * cos_d * cos_d
            fac = rr * (fo + fi + fo * fi * (rr - 1.0)) / PI
            put(is_rt, [torch.where(wh_zero, 0.0, lob["s0"][c] * fac) for c in range(3)])
        is_sh, any_sh = _has(kind, LOBE_DISNEY_SHEEN)
        if any_sh:
            swd = _schlick_weight(cos_d)
            put(is_sh, [torch.where(wh_zero, 0.0, lob["s0"][c] * swd) for c in range(3)])
        is_ss, any_ss = _has(kind, LOBE_DISNEY_FAKE_SS)
        if any_ss:
            fss90 = cos_d * cos_d * lob["au"]
            fss = (1.0 + fo * (fss90 - 1.0)) * (1.0 + fi * (fss90 - 1.0))
            ss = 1.25 * (fss * (1.0 / torch.clamp(co + ci, min=1e-9) - 0.5) + 0.5)
            put(is_ss, [torch.where(wh_zero, 0.0, lob["s0"][c] / PI * ss) for c in range(3)])
    is_cc, any_cc = _has(kind, LOBE_DISNEY_CLEARCOAT)
    if any_cc:
        v_cc = torch.where(
            wh_zero,
            0.0,
            lob["au"] * _cc_g(co) * _cc_g(ci)
            * (0.04 + 0.96 * _schlick_weight(wox * nhx + woy * nhy + woz * nhz))
            * _gtr1(torch.abs(nhz), lob["av"]) / 4.0,
        )
        put(is_cc, [v_cc, v_cc, v_cc])
    is_on, any_on = _has(kind, LOBE_OREN_NAYAR)
    if any_on:
        put(is_on, _oren_nayar_f(lob, wox, woy, woz, wix, wiy, wiz))
    is_mt, any_mt = _has(kind, LOBE_MF_TRANS)
    if any_mt:
        put(is_mt, _mf_trans_f(lob, kind, wox, woy, woz, wix, wiy, wiz))
    # the Debug material's constants (debug_material.rs:26-28): even its
    # "specular" lobe returns a nonzero f
    for dbg_kind, c in ((LOBE_DEBUG_DIFFUSE, 1), (LOBE_DEBUG_SPECULAR, 2)):
        is_dbg, any_dbg = _has(kind, dbg_kind)
        if any_dbg:
            put(is_dbg, [torch.full_like(wox, float(k == c)) for k in range(3)])
    return _scaled(lob, out)


def _oren_nayar_f(lob, wox, woy, woz, wix, wiy, wiz):
    """(reflection.rs:916-945), sigma in degrees in alpha_u."""
    sigma2 = (lob["au"] * PI / 180.0) ** 2
    a = 1.0 - sigma2 / (2.0 * (sigma2 + 0.33))
    b = 0.45 * sigma2 / (sigma2 + 0.09)
    sin_i = torch.sqrt(torch.clamp(1.0 - wiz * wiz, min=0.0))
    sin_o = torch.sqrt(torch.clamp(1.0 - woz * woz, min=0.0))
    safe_i = torch.where(sin_i == 0.0, 1.0, sin_i)
    safe_o = torch.where(sin_o == 0.0, 1.0, sin_o)
    d_cos = torch.clamp((wix / safe_i) * (wox / safe_o) + (wiy / safe_i) * (woy / safe_o),
                        min=0.0)
    max_cos = torch.where((sin_i > 1e-4) & (sin_o > 1e-4), d_cos, 0.0)
    aci, aco = torch.abs(wiz), torch.abs(woz)
    use_i = aci > aco
    sin_alpha = torch.where(use_i, sin_o, sin_i)
    tan_beta = torch.where(use_i, sin_i / torch.clamp(aci, min=1e-9),
                           sin_o / torch.clamp(aco, min=1e-9))
    fac = a + b * max_cos * sin_alpha * tan_beta
    return [lob["s0"][c] / PI * fac for c in range(3)]


def _norm3(x, y, z):
    inv = 1.0 / torch.clamp(torch.sqrt(x * x + y * y + z * z), min=1e-30)
    return x * inv, y * inv, z * inv


def _mf_trans_f(lob, kind, wox, woy, woz, wix, wiy, wiz):
    """(reflection.rs:1059-1101), radiance mode."""
    ok = ~((woz * wiz) > 0.0) & (woz != 0.0) & (wiz != 0.0)
    eta = _eta_t(lob, woz)
    hx, hy, hz = _norm3(wox + wix * eta, woy + wiy * eta, woz + wiz * eta)
    flip = hz < 0.0
    hx, hy, hz = (torch.where(flip, -v, v) for v in (hx, hy, hz))
    dot_o = wox * hx + woy * hy + woz * hz
    dot_i = wix * hx + wiy * hy + wiz * hz
    fr = _fr_dielectric(dot_o, lob["eta_a"], lob["eta_b"])
    sqrt_denom = dot_o + eta * dot_i
    factor = 1.0 / eta
    au, av = lob["au"], lob["av"]
    d_val = _tr_d(hx, hy, hz, au, av)
    lam_o = _tr_lambda(wox, woy, woz, au, av)
    lam_i = _tr_lambda(wix, wiy, wiz, au, av)
    g = torch.where(_sep_g(lob, kind), (1.0 / (1.0 + lam_o)) * (1.0 / (1.0 + lam_i)),
                    1.0 / (1.0 + lam_o + lam_i))
    mag = torch.abs(d_val * g * eta * eta * torch.abs(dot_i) * torch.abs(dot_o) * factor * factor
                    / torch.clamp(torch.abs(wiz * woz * sqrt_denom * sqrt_denom), min=1e-20))
    return [torch.where(ok, (1.0 - fr) * lob["s0"][c] * mag, 0.0) for c in range(3)]


def _lobe_pdf(lob, wox, woy, woz, wix, wiy, wiz):
    """Cosine pdf for the diffuse kinds (the opposite hemisphere for
    lambert transmission), visible-normal TR pdf for the microfacets,
    GTR1 for the clearcoat, 0 for specular kinds."""
    kind = lob["kind"]
    same = (woz * wiz) > 0.0
    out = torch.where(same, torch.abs(wiz) / PI, 0.0)
    is_mf, any_mf = _has(kind, *MF_KINDS)
    is_cc, any_cc = _has(kind, LOBE_DISNEY_CLEARCOAT)
    if any_mf or any_cc:
        whx, why, whz = wox + wix, woy + wiy, woz + wiz
        wh2 = whx * whx + why * why + whz * whz
        inv_l = rsqrt(torch.clamp(wh2, min=1e-30))
        whx, why, whz = whx * inv_l, why * inv_l, whz * inv_l
        dot_owh = wox * whx + woy * why + woz * whz
    if any_mf:
        au, av = lob["au"], lob["av"]
        d_val = _tr_d(whx, why, whz, au, av)
        lam_o = _tr_lambda(wox, woy, woz, au, av)
        pdf_wh = d_val / (1.0 + lam_o) * torch.abs(dot_owh) / torch.clamp(torch.abs(woz), min=1e-20)
        out = torch.where(is_mf, torch.where(same, pdf_wh / torch.clamp(4.0 * dot_owh, min=1e-20),
                                             0.0), out)
    if any_cc:
        dr = _gtr1(torch.abs(whz), lob["av"])
        cc = torch.where(same & (wh2 > 0.0),
                         dr * torch.abs(whz) / torch.clamp(4.0 * dot_owh, min=1e-9), 0.0)
        out = torch.where(is_cc, cc, out)
    is_lt, any_lt = _has(kind, LOBE_LAMBERT_TRANS)
    if any_lt:
        out = torch.where(is_lt, torch.where(~same, torch.abs(wiz) / PI, 0.0), out)
    is_mt, any_mt = _has(kind, LOBE_MF_TRANS)
    if any_mt:
        eta = _eta_t(lob, woz)
        hx, hy, hz = _norm3(wox + wix * eta, woy + wiy * eta, woz + wiz * eta)
        dot_o = wox * hx + woy * hy + woz * hz
        dot_i = wix * hx + wiy * hy + wiz * hz
        sq = dot_o + eta * dot_i
        dwh_dwi = torch.abs((eta * eta * dot_i) / torch.clamp(sq * sq, min=1e-20))
        au, av = lob["au"], lob["av"]
        lam_o = _tr_lambda(wox, woy, woz, au, av)
        pdf_wh = (_tr_d(hx, hy, hz, au, av) * (1.0 / (1.0 + lam_o)) * torch.abs(dot_o)
                  / torch.clamp(torch.abs(woz), min=1e-20))
        out = torch.where(is_mt, torch.where(~same, pdf_wh * dwh_dwi, 0.0), out)
    return torch.where(_is_spec(kind), 0.0, out)


def _tr_sample_wh(wox, woy, woz, au, av, u0, u1):
    """tr_sample_wh_visible (bsdf/microfacet.py:108-166), local frame."""
    flip = woz < 0.0
    wx = torch.where(flip, -wox, wox)
    wy = torch.where(flip, -woy, woy)
    wz = torch.where(flip, -woz, woz)
    sx_, sy_, sz_ = wx * au, wy * av, wz
    inv = rsqrt(torch.clamp(sx_ * sx_ + sy_ * sy_ + sz_ * sz_, min=1e-30))
    wsx, wsy, wsz = sx_ * inv, sy_ * inv, sz_ * inv

    cos_theta = wsz
    r_spec = torch.sqrt(u0 / torch.clamp(1.0 - u0, min=1e-9))
    phi_spec = 2.0 * PI * u1
    sx_spec = r_spec * torch.cos(phi_spec)
    sy_spec = r_spec * torch.sin(phi_spec)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    tan_theta = sin_theta / torch.clamp(cos_theta, min=1e-9)
    a_inv = 1.0 / torch.clamp(tan_theta, min=1e-9)
    g1v = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / (a_inv * a_inv)))
    a = 2.0 * u0 / g1v - 1.0
    tmp = torch.clamp(1.0 / torch.clamp(a * a - 1.0, min=1e-12), max=1e10)
    tmp = torch.where(a * a - 1.0 <= 0.0, 1e10, tmp)
    b = tan_theta
    dsc = torch.clamp(b * b * tmp * tmp - (a * a - b * b) * tmp, min=0.0)
    dq = torch.sqrt(dsc)
    sx1 = b * tmp - dq
    sx2 = b * tmp + dq
    slope_x = torch.where((a < 0.0) | (sx2 > 1.0 / torch.clamp(tan_theta, min=1e-9)), sx1, sx2)
    upper = u1 > 0.5
    sgn = torch.where(upper, 1.0, -1.0)
    nu2 = torch.where(upper, 2.0 * (u1 - 0.5), 2.0 * (0.5 - u1))
    z = (nu2 * (nu2 * (nu2 * 0.27385 - 0.73369) + 0.46341)) / (
        nu2 * (nu2 * (nu2 * 0.093073 + 0.309420) - 1.0) + 0.597999
    )
    slope_y = sgn * z * torch.sqrt(1.0 + slope_x * slope_x)
    near_n = cos_theta > 0.9999
    slope_x = torch.where(near_n, sx_spec, slope_x)
    slope_y = torch.where(near_n, sy_spec, slope_y)

    sin_t = torch.sqrt(torch.clamp(1.0 - wsz * wsz, min=0.0))
    zs = sin_t == 0.0
    safe = torch.where(zs, 1.0, sin_t)
    cos_p = torch.where(zs, 1.0, wsx / safe)
    sin_p = torch.where(zs, 0.0, wsy / safe)
    rx = cos_p * slope_x - sin_p * slope_y
    ry = sin_p * slope_x + cos_p * slope_y
    hx, hy, hz = -au * rx, -av * ry, torch.ones_like(rx)
    inv_h = rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-30))
    hx, hy, hz = hx * inv_h, hy * inv_h, hz * inv_h
    return (
        torch.where(flip, -hx, hx),
        torch.where(flip, -hy, hy),
        torch.where(flip, -hz, hz),
    )



def _lobe_sample(lob, wol_x, wol_y, wo_z, u0, u1):
    """sample_f of one chosen lobe (reflection.rs, disney.rs): the cosine
    hemisphere on wo's side for the diffuse kinds (the other side for
    lambert transmission), the visible-normal Trowbridge-Reitz half
    vector reflected (microfacet reflection) or refracted (transmission),
    the clearcoat's GTR1 half vector in the reference's form, specular
    reflection and transmission, fresnel-specular reflect or transmit by
    u0 < Fr.  Returns (wi x, y, z, f (3 channels, times the lobe's scale),
    pdf, transmitted: a specular transmission was sampled)."""
    kind = lob["kind"]
    is_mf = _in(kind, MF_KINDS)
    is_sr = kind == LOBE_SPEC_REFL
    is_st = kind == LOBE_SPEC_TRANS
    is_fs = kind == LOBE_FRESNEL_SPEC

    # cosine hemisphere on wo's side (lambert)
    dxo, dyo = concentric_sample_disk(u0, u1)
    z_cos = torch.sqrt(torch.clamp(1.0 - dxo * dxo - dyo * dyo, min=0.0))
    z_cos = torch.where(wo_z < 0.0, -z_cos, z_cos)
    # microfacet: visible-normal sample, reflect
    hx, hy, hz = _tr_sample_wh(wol_x, wol_y, wo_z, lob["au"], lob["av"], u0, u1)
    dot_owh = wol_x * hx + wol_y * hy + wo_z * hz
    mrx = 2.0 * dot_owh * hx - wol_x
    mry = 2.0 * dot_owh * hy - wol_y
    mrz = 2.0 * dot_owh * hz - wo_z
    mr_ok = (dot_owh >= 0.0) & ((wo_z * mrz) > 0.0) & (wo_z != 0.0)
    # specular reflection and fresnel-specular transmission
    srx, sry, srz = -wol_x, -wol_y, wo_z
    ea, eb = lob["eta_a"], lob["eta_b"]
    entering = wo_z > 0.0
    ei = torch.where(entering, ea, eb)
    et = torch.where(entering, eb, ea)
    eta_rel = ei / torch.clamp(et, min=1e-9)
    abs_cz = torch.abs(wo_z)
    sin2_t = eta_rel * eta_rel * torch.clamp(1.0 - abs_cz * abs_cz, min=0.0)
    st_ok = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    nz_sign = torch.where(entering, 1.0, -1.0)
    stx = -eta_rel * wol_x
    sty = -eta_rel * wol_y
    stz = -eta_rel * wo_z + (eta_rel * abs_cz - cos_t) * nz_sign
    scale_t = (ei * ei) / torch.clamp(et * et, min=1e-20)
    fr_fs = _fr_dielectric(wo_z, ea, eb)
    fs_reflect = u0 < fr_fs

    def pick(cos_v, mf_v, sr_v, st_v):
        v = torch.where(is_mf, mf_v, cos_v)
        v = torch.where(is_sr, sr_v, v)
        v = torch.where(is_st, st_v, v)
        return torch.where(is_fs, torch.where(fs_reflect, sr_v, st_v), v)

    wsx = pick(dxo, mrx, srx, stx)
    wsy = pick(dyo, mry, sry, sty)
    wsz = pick(z_cos, mrz, srz, stz)
    dead = is_mf & ~mr_ok  # a microfacet sample below the surface is no sample

    is_lt, any_lt = _has(kind, LOBE_LAMBERT_TRANS)
    if any_lt:  # the cosine sample flipped to the other side (reflection.rs:857-871)
        wsz = torch.where(is_lt, -z_cos, wsz)
    is_cc, any_cc = _has(kind, LOBE_DISNEY_CLEARCOAT)
    if any_cc:
        # DisneyClearcoat::sample_f, the reference's form without the sqrt
        a2c = lob["av"] * lob["av"]
        cc_cos = ((1.0 - torch.pow(torch.clamp(a2c, min=1e-9), 1.0 - u0))
                  / torch.sqrt(torch.clamp(1.0 - a2c, min=1e-9)))
        cc_cos = torch.clamp(cc_cos, -1.0, 1.0)
        cc_sin = torch.sqrt(torch.clamp(1.0 - cc_cos * cc_cos, min=0.0))
        cc_phi = 2.0 * PI * u1
        whcx, whcy, whcz = cc_sin * torch.cos(cc_phi), cc_sin * torch.sin(cc_phi), cc_cos
        flip_cc = (wo_z * whcz) <= 0.0
        whcx, whcy, whcz = (torch.where(flip_cc, -v, v) for v in (whcx, whcy, whcz))
        dot_ow = wol_x * whcx + wol_y * whcy + wo_z * whcz
        ccx = 2.0 * dot_ow * whcx - wol_x
        ccy = 2.0 * dot_ow * whcy - wol_y
        ccz = 2.0 * dot_ow * whcz - wo_z
        wsx, wsy, wsz = (torch.where(is_cc, a, b) for a, b in zip((ccx, ccy, ccz), (wsx, wsy, wsz)))
        dead = dead | (is_cc & ~(((wo_z * ccz) > 0.0) & (wo_z != 0.0)))
    is_mt, any_mt = _has(kind, LOBE_MF_TRANS)
    if any_mt:
        # the same half vector, faced onto wo and refracted (reflection.rs:1102-1128)
        sgn = torch.where(dot_owh < 0.0, -1.0, 1.0)
        nx, ny, nz = hx * sgn, hy * sgn, hz * sgn
        eta_mt = torch.where(entering, ea / eb, eb / ea)
        cos_i = nx * wol_x + ny * wol_y + nz * wo_z
        sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
        sin2_tt = eta_mt * eta_mt * sin2_i
        cos_tt = torch.sqrt(torch.clamp(1.0 - sin2_tt, min=0.0))
        k = eta_mt * cos_i - cos_tt
        mtx, mty, mtz = -wol_x * eta_mt + nx * k, -wol_y * eta_mt + ny * k, -wo_z * eta_mt + nz * k
        wsx, wsy, wsz = (torch.where(is_mt, a, b) for a, b in zip((mtx, mty, mtz), (wsx, wsy, wsz)))
        dead = dead | (is_mt & ~((dot_owh >= 0.0) & (sin2_tt < 1.0) & (wo_z != 0.0)))

    fs = _lobe_f(lob, wol_x, wol_y, wo_z, wsx, wsy, wsz)
    pdf = _lobe_pdf(lob, wol_x, wol_y, wo_z, wsx, wsy, wsz)
    aci = torch.clamp(torch.abs(wsz), min=1e-20)
    fr3 = _fresnel(lob, wsz)
    one = (1.0, 1.0, 1.0)
    sc = lob.get("scale", one)
    out = []
    # specular transmission (reflection.rs:706-714), radiance mode
    fr_t = _fr_dielectric(wsz, ea, eb)
    for c in range(3):
        f = torch.where(dead, 0.0, fs[c])
        f = torch.where(is_sr, lob["s0"][c] * fr3[c] / aci * sc[c], f)
        f_st = torch.where(st_ok, lob["s0"][c] * (1.0 - fr_t) * scale_t / aci, 0.0)
        f = torch.where(is_st, f_st * sc[c], f)
        f_fs = torch.where(
            fs_reflect,
            lob["s0"][c] * fr_fs / aci,
            torch.where(st_ok, lob["s1"][c] * (1.0 - fr_fs) * scale_t / aci, 0.0),
        )
        out.append(torch.where(is_fs, f_fs * sc[c], f))
    pdf = torch.where(is_sr, 1.0, pdf)
    pdf = torch.where(is_st, torch.where(st_ok, 1.0, 0.0), pdf)
    pdf = torch.where(is_fs, torch.where(fs_reflect, fr_fs, 1.0 - fr_fs), pdf)
    pdf = torch.where(dead, 0.0, pdf)
    return wsx, wsy, wsz, out, pdf, (is_fs & ~fs_reflect) | is_st


def _bsdf_sample(row, n_lob, wol_x, wol_y, wo_z, ub0, ub1):
    """Bsdf::sample_f (reflection.rs:302-381, reference-quirk exact):
    uniform lobe choice among the row's n_lob lobes, the chosen lobe's
    direction, f and pdf, the pdf averaged over the matching lobes.  The
    other lobes' pdfs are added only when the chosen lobe does not reflect
    (reflection.rs:358): of the path kernel's kinds only specular
    transmission (a subsurface Disney material's), `_bsdf_sample_k`'s
    accumulation."""
    matching = torch.clamp(n_lob, min=1)
    comp = torch.minimum((ub0 * matching).to(torch.int64), matching - 1)
    u0 = torch.clamp(ub0 * matching - comp.to(DTYPE), max=ONE_MINUS_EPSILON)
    cols = (16 + 16 * comp)[:, None] + torch.arange(16, device=row.device)
    lob = _lobe(torch.gather(row, 1, cols), 0)
    wsx, wsy, wsz, out, pdf, transmitted = _lobe_sample(lob, wol_x, wol_y, wo_z, u0, ub1)
    is_st = (lob["kind"] == LOBE_SPEC_TRANS) & (matching > 1)
    if bool(is_st.any()):
        extra = torch.zeros_like(pdf)
        for l in range(int(n_lob.max())):
            use = (l < n_lob) & (comp != l)
            lpdf = _lobe_pdf(_lobe(row, 16 + 16 * l), wol_x, wol_y, wo_z, wsx, wsy, wsz)
            extra = extra + torch.where(use, lpdf, 0.0)
        pdf = pdf + torch.where(is_st, extra, 0.0)
    pdf = torch.where(matching > 1, pdf / matching.to(DTYPE), pdf)
    return wsx, wsy, wsz, out, pdf, transmitted


def _chosen_kind(row, n_lob, ub0):
    """The kind of the lobe _bsdf_sample picks with ub0, (N,) int64."""
    matching = torch.clamp(n_lob, min=1)
    comp = torch.minimum((ub0 * matching).to(torch.int64), matching - 1)
    return torch.gather(row, 1, (16 + 16 * comp)[:, None])[:, 0].to(torch.int64)


# ---- the Bsdf methods on (N, 3) world vectors (the wavefront loop) ----


class Frame(NamedTuple):
    """Shading frame (Bsdf::new, reflection.rs:216-227), (N, 3) each."""

    ns: torch.Tensor
    ng: torch.Tensor
    ss: torch.Tensor
    ts: torch.Tensor


class BsdfSample(NamedTuple):
    f: torch.Tensor  # (N, 3)
    wi_world: torch.Tensor  # (N, 3)
    pdf: torch.Tensor  # (N,)
    transmitted: torch.Tensor  # (N,) bool: a specular transmission was sampled
    valid: torch.Tensor  # (N,) bool
    specular: torch.Tensor = None  # (N,) bool: the sampled lobe is specular
    transmission: torch.Tensor = None  # (N,) bool: the sampled flags transmit


def make_frame(ns, ng, dpdu):
    """ss = normalize(dpdu), or coordinate_system(ns) where dpdu is
    degenerate; ts = ns x ss."""
    ss_ts = shading_frame(ns[:, 0], ns[:, 1], ns[:, 2], dpdu[:, 0], dpdu[:, 1], dpdu[:, 2])
    return Frame(ns, ng, torch.stack(ss_ts[:3], -1), torch.stack(ss_ts[3:], -1))


def world_to_local(fr, v):
    return torch.stack([dot(v, fr.ss), dot(v, fr.ts), dot(v, fr.ns)], -1)


def local_to_world(fr, v):
    return fr.ss * v[:, 0:1] + fr.ts * v[:, 1:2] + fr.ns * v[:, 2:3]


def lobe_count(params):
    """Lobe slots of a wavefront row tensor (16 columns each beyond the 16
    of the head, then EXTRA_COLS each)."""
    return (params.shape[1] - 16) // (16 + EXTRA_COLS)


def row_lobe(params, l):
    """Lobe slot l of wavefront rows, its scale and distribution code
    included."""
    return _lobe(params, 16 + 16 * l, 16 + 16 * lobe_count(params) + EXTRA_COLS * l)


def lobe_flags(kind):
    """BxDFType flags of each lobe kind (int64, 0 for no lobe)."""
    return torch.tensor(_FLAG_TABLE, device=kind.device)[kind.long()]


def _matches(lob, l, n_lob, flags):
    """BxDF::match_flags (reflection.rs:490-492) of lobe slot l, live
    below the row's lobe count."""
    lf = lobe_flags(lob["kind"])
    return (l < n_lob) & (lob["kind"] != 0) & ((lf & flags) == lf), lf


def lobe_f(lob, wo, wi):
    """f(wo, wi) of one lobe slot on local (N, 3) directions: (N, 3)."""
    return torch.stack(_lobe_f(lob, *wo.unbind(-1), *wi.unbind(-1)), -1)


def lobe_pdf(lob, wo, wi):
    return _lobe_pdf(lob, *wo.unbind(-1), *wi.unbind(-1))


def num_components(params, flags):
    """Bsdf::num_components: (N,) int64."""
    n_lob = params[:, 15].to(torch.int64)
    count = torch.zeros_like(n_lob)
    for l in range(lobe_count(params)):
        count = count + _matches(row_lobe(params, l), l, n_lob, flags)[0]
    return count


def bsdf_f_pdf(params, fr, wo_w, wi_w, flags):
    """Bsdf::f (reflection.rs:252-268: matching lobes under the
    geometric-normal reflect / transmit gate) and Bsdf::pdf (:382-404:
    the mean over matching lobes) in one sweep.  Returns ((N, 3), (N,))."""
    wo = world_to_local(fr, wo_w)
    wi = world_to_local(fr, wi_w)
    reflect = (dot(wi_w, fr.ng) * dot(wo_w, fr.ng)) > 0.0
    n_lob = params[:, 15].to(torch.int64)
    f_total = torch.zeros_like(wo)
    p_total = torch.zeros_like(wo[:, 0])
    count = torch.zeros_like(n_lob)
    for l in range(lobe_count(params)):
        lob = row_lobe(params, l)
        m, lf = _matches(lob, l, n_lob, flags)
        use_f = m & ((reflect & ((lf & BXDF_REFLECTION) > 0))
                     | (~reflect & ((lf & BXDF_TRANSMISSION) > 0)))
        f_total = f_total + torch.where(use_f[:, None], lobe_f(lob, wo, wi), 0.0)
        p_total = p_total + torch.where(m, lobe_pdf(lob, wo, wi), 0.0)
        count = count + m
    ok = wo[:, 2] != 0.0
    f_total = torch.where(ok[:, None], f_total, 0.0)
    pdf = torch.where(ok & (count > 0), p_total / torch.clamp(count, min=1), 0.0)
    return f_total, pdf


def bsdf_f(params, fr, wo_w, wi_w, flags):
    return bsdf_f_pdf(params, fr, wo_w, wi_w, flags)[0]


def bsdf_pdf(params, fr, wo_w, wi_w, flags):
    return bsdf_f_pdf(params, fr, wo_w, wi_w, flags)[1]


def bsdf_sample(params, fr, wo_w, u, flags=BXDF_ALL):
    """Bsdf::sample_f (reflection.rs:302-381) over the row's lobes that
    match `flags`; `u` (N, 2).  The (comp + 1)-th matching lobe is chosen
    by u[:, 0], its pdf averaged over the matching lobes; the others'
    pdfs are added only when the chosen lobe does not reflect (the
    reference's gate, reflection.rs:358)."""
    wo = world_to_local(fr, wo_w)
    n_lob = params[:, 15].to(torch.int64)
    u0, u1 = u[:, 0], u[:, 1]
    slots = lobe_count(params)
    lobs = [row_lobe(params, l) for l in range(slots)]
    match = torch.stack([_matches(lob, l, n_lob, flags)[0] for l, lob in enumerate(lobs)], -1)
    matching = match.sum(-1)
    comp = torch.minimum((u0 * matching).to(torch.int64), matching)
    # the running count of matching lobes: a scan over the few lobe
    # columns, one add each (a cumsum over a short innermost dim is slow on
    # a card)
    running, cums = torch.zeros_like(n_lob), []
    for l in range(slots):
        running = running + match[:, l]
        cums.append(running)
    cum = torch.stack(cums, -1)
    chosen = torch.argmax(((cum == (comp + 1)[:, None]) & match).to(torch.int64), -1)
    u0r = torch.clamp(u0 * matching - comp.to(DTYPE), max=ONE_MINUS_EPSILON)
    lob = {k: (tuple(_take(c, chosen) for c in zip(*(lb[k] for lb in lobs)))
               if isinstance(v, tuple) else _take(torch.stack([lb[k] for lb in lobs], -1), chosen))
           for k, v in lobs[0].items()}
    wsx, wsy, wsz, fs, pdf, transmitted = _lobe_sample(lob, wo[:, 0], wo[:, 1], wo[:, 2], u0r, u1)
    chosen_kind = lob["kind"]
    accumulate = ((lobe_flags(chosen_kind) & BXDF_REFLECTION) == 0) & (matching > 1)
    if bool(accumulate.any()):
        wi = torch.stack([wsx, wsy, wsz], -1)
        extra = torch.zeros_like(pdf)
        for l, lb in enumerate(lobs):
            use = match[:, l] & (chosen != l)
            extra = extra + torch.where(use, lobe_pdf(lb, wo, wi), 0.0)
        pdf = pdf + torch.where(accumulate, extra, 0.0)
    pdf = torch.where(matching > 1, pdf / torch.clamp(matching, min=1).to(DTYPE), pdf)
    valid = (matching > 0) & (wo[:, 2] != 0.0) & (pdf > 0.0)
    wi_w = local_to_world(fr, torch.stack([wsx, wsy, wsz], -1))
    # a fresnel-specular sample transmits on its transmit branch
    trans_flag = (lobe_flags(chosen_kind) & BXDF_TRANSMISSION) != 0
    return BsdfSample(
        f=torch.where(valid[:, None], torch.stack(fs, -1), 0.0),
        wi_world=wi_w,
        pdf=torch.where(valid, pdf, 0.0),
        transmitted=valid & transmitted,
        valid=valid,
        specular=valid & _is_spec(chosen_kind.to(torch.int64)),
        transmission=valid & torch.where(chosen_kind == LOBE_FRESNEL_SPEC, transmitted,
                                         trans_flag),
    )


def _take(stacked, idx):
    """stacked (N, S)[n, idx[n]]."""
    if not isinstance(stacked, torch.Tensor):
        stacked = torch.stack(stacked, -1)
    return torch.gather(stacked, 1, idx[:, None])[:, 0]
