"""K7's clamps on NaN: a float32 twin of csrc/texture.cuh's tap with C's
fmaxf / fminf (which drop a NaN operand) and the card's float-to-int
conversion (NaN -> 0, saturating), held bit for bit against the plain
version (scene/mipmap.ewa_lookup, torch.clamp, which keeps a NaN) on
walk_ab.k7_footprints' adversarial lookups under the three wraps.

The ellipse's scale F = a c - b^2 / 4 overflows to NaN (inf - inf) past
about 1e11 uv.  The kernel clamps F as torch.clamp does (`f < 1e-12f ?
1e-12f : f`): the coefficients stay NaN, no texel weighs and the tap gives
0, the plain version's answer.  With fmaxf(F, 1e-12f), the kernel's former
clamp, the coefficients become large finite values whose r^2 can
reach -inf, and the tap gives NaN: the twin shows that too.  The tap's
other fmaxf / fminf differ from torch.clamp only on NaN; the twin holds
that no adversarial lookup shows it.  The twin scans the whole window:
tests/test_torch_k7_spans.py holds that the bounded scan visits every
texel that weighs.  No JAX here.

The counts at chip_smoke.py 12a's and tests/test_torch_cuda.py's sizes:

    PYTHONPATH=. python tests/test_torch_k7_clamps.py
"""

import pytest
import torch

from rs_ray_toy_tpu_torch.ops import texture as tex_ops
from rs_ray_toy_tpu_torch.scene import mipmap
from rs_ray_toy_tpu_torch.walk_ab import k7_footprints, k7_pyramid, tex_queries

# several pytest workers share the host: cap torch's OpenMP threads
torch.set_num_threads(min(2, torch.get_num_threads()))
F32 = torch.float32
N = 1 << 11  # an eighth of them past 1e11 uv (k7_footprints' fourth eighth)


def _k(v):
    return torch.tensor(v, dtype=F32)


def _to_int(x):
    """(int)x on the card: NaN -> 0, saturating at int32's range."""
    x = torch.nan_to_num(x, nan=0.0, posinf=2.0**31 - 1, neginf=-(2.0**31))
    return x.clamp(-(2.0**31), 2.0**31 - 1).to(torch.int64)


def _st_norm(wrap, s, t):
    if wrap == mipmap.WRAP_REPEAT:
        return s - torch.floor(s), t - torch.floor(t)
    lo, hi = (_k(0.0), _k(1.0 - 1e-7)) if wrap == mipmap.WRAP_CLAMP else (_k(-1.5), _k(2.5))
    return torch.fmin(torch.fmax(s, lo), hi), torch.fmin(torch.fmax(t, lo), hi)


def _level(pyr, lvl, s_in, t_in, d0s, d0t, d1s, d1t, nan_keeping):
    """texture.cuh tex_ewa_level over the whole window."""
    meta = pyr.meta[lvl]
    h, w = meta[:, 0].to(F32), meta[:, 1].to(F32)
    sn, tn = _st_norm(pyr.wrap, s_in, t_in)
    s, t = sn * w - 0.5, tn * h - 0.5
    d0s, d0t, d1s, d1t = d0s * w, d0t * h, d1s * w, d1t * h
    a = d0t * d0t + d1t * d1t + 1.0
    b = -2.0 * (d0s * d0t + d1s * d1t)
    c = d0s * d0s + d1s * d1s + 1.0
    f = a * c - b * b * 0.25
    f = torch.where(f < 1e-12, _k(1e-12), f) if nan_keeping else torch.fmax(f, _k(1e-12))
    inv_f = 1.0 / f
    a, b, c = a * inv_f, b * inv_f, c * inv_f
    inv_det = 1.0 / torch.fmax(-b * b + 4.0 * a * c, _k(1e-12))
    half = _k(mipmap.EWA_WINDOW / 2 - 1)
    u_rad = torch.fmin(torch.sqrt(torch.fmax(c * inv_det * 4.0, _k(0.0))), half)
    v_rad = torch.fmin(torch.sqrt(torch.fmax(a * inv_det * 4.0, _k(0.0))), half)
    s0, t0 = _to_int(torch.ceil(s - u_rad)), _to_int(torch.ceil(t - v_rad))
    acc = torch.zeros((s.shape[0], 3), dtype=F32)
    wsum = torch.zeros_like(s)
    for i in range(mipmap.EWA_WINDOW):
        tt = (t0 + i).to(F32) - t
        for j in range(mipmap.EWA_WINDOW):
            ss = (s0 + j).to(F32) - s
            r2 = a * (ss * ss) + b * tt * ss + c * (tt * tt)
            wgt = torch.where(r2 < 1.0, torch.fmax(torch.exp(-2.0 * r2) - mipmap.EXP_M2, _k(0.0)),
                              _k(0.0))
            texel = mipmap.texel(pyr, meta, s0 + j, t0 + i)
            acc = acc + torch.where((wgt > 0.0)[:, None], wgt[:, None] * texel, 0.0)
            wsum = wsum + wgt
    return acc / torch.fmax(wsum, _k(1e-9))[:, None]


def kernel_twin(pyr, st, dst0, dst1, nan_keeping=True):
    """texture.cuh tex_ewa_lookup on (N, 2) float32 st, dst0, dst1."""
    s, t = st.unbind(1)
    d0s, d0t = dst0.unbind(1)
    d1s, d1t = dst1.unbind(1)
    swap = d0s * d0s + d0t * d0t < d1s * d1s + d1t * d1t
    mas, mat = torch.where(swap, d1s, d0s), torch.where(swap, d1t, d0t)
    mis, mit = torch.where(swap, d0s, d1s), torch.where(swap, d0t, d1t)
    major = torch.sqrt(torch.fmax(mas * mas + mat * mat, _k(1e-20)))
    minor = torch.sqrt(torch.fmax(mis * mis + mit * mit, _k(0.0)))
    scale = torch.where((minor * pyr.max_aniso < major) & (minor > 0.0),
                        major / torch.fmax(minor * pyr.max_aniso, _k(1e-20)), _k(1.0))
    mis, mit, minor = mis * scale, mit * scale, minor * scale
    top = _k(float(pyr.n_levels - 1))
    lod = torch.fmin(torch.fmax(top + torch.log2(torch.fmax(minor, _k(1e-9))), _k(0.0)), top)
    fl = torch.floor(lod)
    l0 = _to_int(fl)
    l1 = torch.clamp(l0 + 1, max=pyr.n_levels - 1)
    dt = (lod - fl)[:, None]
    e0 = _level(pyr, l0, s, t, mas, mat, mis, mit, nan_keeping)
    e1 = _level(pyr, l1, s, t, mas, mat, mis, mit, nan_keeping)
    out = (1.0 - dt) * e0 + dt * e1
    bilerp = mipmap.bilerp_level(pyr, torch.zeros_like(l0), s, t)
    return torch.where((minor <= 1e-9)[:, None], bilerp, out)


def clamp_counts(pyr, queries):
    """(lookups past 1e11 uv, lookups apart from the plain version with the
    NaN-keeping clamp, with fmaxf's, NaN outputs with fmaxf's)."""
    ref = tex_ops.tex_lookup_reference(pyr, *queries)
    over = (queries[1].abs().amax(-1) > 1e11) | (queries[2].abs().amax(-1) > 1e11)
    found = [int(over.sum())]
    for nan_keeping in (True, False):
        out = kernel_twin(pyr, *queries, nan_keeping)
        same = ((out == ref) | (out.isnan() & ref.isnan())).all(-1)
        found.append(int((~same).sum()))
    found.append(int(out.isnan().any(-1).sum()))
    return tuple(found)


@pytest.mark.parametrize("wrap", ["repeat", "black", "clamp"])
def test_nan_keeping_clamp_matches_plain_version(wrap):
    w = mipmap.WRAP_NAMES[wrap]
    queries = [torch.cat(pair) for pair in zip(k7_footprints(N, 80 + w, "cpu"),
                                                tex_queries(N // 4, 90 + w, "cpu"))]
    over, apart, apart_fmaxf, nan_fmaxf = clamp_counts(k7_pyramid(w, "cpu"), queries)
    assert over > N // 16 and apart == 0
    # fmaxf's clamp gave NaN on overflowed ellipses, where the plain version gives 0
    assert 0 < apart_fmaxf == nan_fmaxf < over


if __name__ == "__main__":
    for w, name in enumerate(("repeat", "black", "clamp")):
        pyr = k7_pyramid(w, "cpu")
        card = [torch.cat(p) for p in zip(k7_footprints(1 << 14, 60 + w, "cpu"),
                                          tex_queries(1 << 14, 70 + w, "cpu"))]
        print(f"{name}, tests/test_torch_cuda.py's lookups: past 1e11 uv, apart with the "
              f"NaN-keeping clamp, apart with fmaxf's, NaN with fmaxf's: {clamp_counts(pyr, card)}")
        if w == mipmap.WRAP_REPEAT:
            print(f"{name}, chip_smoke.py 12a's adversarial lookups: "
                  f"{clamp_counts(pyr, k7_footprints(1 << 16, 19, 'cpu'))}")
