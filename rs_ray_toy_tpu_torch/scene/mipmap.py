"""MIPMap (rs_ray_toy_tpu/scene/mipmap.py; mipmap.rs): the host pyramid
build and the exact EWA lookup, K7's plain version.

`build_mipmap` is the JAX package's: power-of-two resample by separable
linear interpolation, box down-sampling to 1x1, float32 levels, finest
first.  `pyramid` stores the levels in one flat float32 device buffer
(each level's rows of RGB texels, row-major) with their (h, w, offset).

The lookups are the JAX package's exact filter, `ewa_lookup` with
`_ewa_level` and `_bilerp_level` (the one RS_TEX_PACKED=0 selects): the
eccentricity clamp to max_aniso, the level from the minor axis (clamped
to the pyramid), the ellipse of each of the two levels with the +1
texel blur, its window clamped to EWA_WINDOW texels a side (radii at
most EWA_WINDOW / 2 - 1), weights exp(-2 r^2) - exp(-2) inside r^2 < 1,
the weighted mean of the window's texels, and a footprint whose minor
axis is 1e-9 or less (dead or absent differentials) taking the bilinear
tap of level 0.  Texels outside a level wrap (repeat), clamp, or read as
black, whose weight still counts.  The JAX package's packed coarse
pyramid and its bilerp-per-level tap (MIPMap.as_packed, packed_*_lookup,
ops/tex_tile.py) answer the TPU's serialized gathers and are not ported.

`ewa_lookup` on flat (N,) float32 tensors is the plain version of the
CUDA tap (csrc/texture.cuh, ops/texture.py): the same expressions in the
same order, the window scanned texel by texel, row by row, so the sums
are taken in the kernel's order.
"""

import math
from dataclasses import dataclass
from typing import List, NamedTuple

import numpy as np
import torch

from ..config import DTYPE

WRAP_REPEAT = 0
WRAP_BLACK = 1
WRAP_CLAMP = 2
WRAP_NAMES = {"repeat": WRAP_REPEAT, "black": WRAP_BLACK, "clamp": WRAP_CLAMP}
EWA_WINDOW = 16  # texels a side of the ellipse's window (the JAX package's _EWA_WINDOW)
LEVELS_MAX = 16  # pyramid levels the kernel takes: images up to 32768 texels a side
EXP_M2 = math.exp(-2.0)  # the weight's floor, rounded to float32 where it is used


@dataclass
class MIPMap:
    levels: List[np.ndarray]  # finest first, each (H, W, 3) float32
    wrap: int
    do_trilinear: bool
    max_aniso: float


def _next_pow2(x):
    return 1 << (int(x) - 1).bit_length()


def _resample_axis(img, new_n, axis):
    """Separable linear resample to new_n along axis (host)."""
    old_n = img.shape[axis]
    if old_n == new_n:
        return img
    pos = (np.arange(new_n) + 0.5) * old_n / new_n - 0.5
    lo = np.clip(np.floor(pos).astype(int), 0, old_n - 1)
    hi = np.clip(lo + 1, 0, old_n - 1)
    t = (pos - lo).reshape([-1 if i == axis else 1 for i in range(img.ndim)])
    a = np.take(img, lo, axis=axis)
    b = np.take(img, hi, axis=axis)
    return a * (1 - t) + b * t


def build_mipmap(image, wrap=WRAP_REPEAT, do_trilinear=False, max_aniso=8.0):
    """image: (H, W, 3) float in linear space, bottom row = v = 0."""
    img = np.asarray(image, np.float64)
    h, w = img.shape[:2]
    ph, pw = _next_pow2(h), _next_pow2(w)
    if (ph, pw) != (h, w):
        img = _resample_axis(_resample_axis(img, pw, 1), ph, 0)
    levels = [img.astype(np.float32)]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        prev = levels[-1].astype(np.float64)
        if prev.shape[0] > 1 and prev.shape[1] > 1:
            down = 0.25 * (
                prev[0::2, 0::2] + prev[1::2, 0::2] + prev[0::2, 1::2] + prev[1::2, 1::2]
            )
        elif prev.shape[0] > 1:
            down = 0.5 * (prev[0::2] + prev[1::2])
        else:
            down = 0.5 * (prev[:, 0::2] + prev[:, 1::2])
        levels.append(down.astype(np.float32))
    return MIPMap(levels, wrap, do_trilinear, max_aniso)


class Pyramid(NamedTuple):
    """A MIPMap on the device: `data` the flat float32 texels of every
    level, finest first; `meta` (L, 3) int64 (h, w, offset of the level's
    first float in data); `dims` the same as python ints."""

    data: torch.Tensor
    meta: torch.Tensor
    dims: tuple
    wrap: int
    max_aniso: float

    @property
    def n_levels(self):
        return len(self.dims)


def pyramid(mip, device):
    """The device Pyramid of a MIPMap."""
    if len(mip.levels) > LEVELS_MAX:
        raise NotImplementedError(f"image textures of {len(mip.levels)} levels "
                                  f"(up to {LEVELS_MAX})")
    dims, off = [], 0
    for lv in mip.levels:
        dims.append((lv.shape[0], lv.shape[1], off))
        off += lv.size
    data = np.concatenate([lv.reshape(-1) for lv in mip.levels]).astype(np.float32)
    return Pyramid(torch.as_tensor(data, device=device),
                   torch.as_tensor(np.asarray(dims, np.int64), device=device),
                   tuple(dims), mip.wrap, float(mip.max_aniso))


def st_norm(s, t, wrap):
    """Wrap-normalised continuous st (_st_norm)."""
    if wrap == WRAP_REPEAT:
        return s - torch.floor(s), t - torch.floor(t)
    if wrap == WRAP_CLAMP:
        return torch.clamp(s, 0.0, 1.0 - 1e-7), torch.clamp(t, 0.0, 1.0 - 1e-7)
    return torch.clamp(s, -1.5, 2.5), torch.clamp(t, -1.5, 2.5)


def texel(pyr, meta, si, ti):
    """(N, 3) texels (si, ti) (int64) of the levels whose rows of `meta`
    (N, 3) are given: wrapped (power-of-two sizes: a mask), clamped, or
    zero outside the level (black)."""
    h, w, off = meta.unbind(-1)
    if pyr.wrap == WRAP_REPEAT:
        si, ti = si & (w - 1), ti & (h - 1)
        inside = None
    elif pyr.wrap == WRAP_CLAMP:
        si = torch.minimum(torch.clamp(si, min=0), w - 1)
        ti = torch.minimum(torch.clamp(ti, min=0), h - 1)
        inside = None
    else:
        inside = (si >= 0) & (si < w) & (ti >= 0) & (ti < h)
        si = torch.minimum(torch.clamp(si, min=0), w - 1)
        ti = torch.minimum(torch.clamp(ti, min=0), h - 1)
    base = off + (ti * w + si) * 3
    v = pyr.data[base[:, None] + torch.arange(3, device=base.device)]
    return v if inside is None else torch.where(inside[:, None], v, 0.0)


def bilerp_level(pyr, level, s_in, t_in):
    """Bilinear tap at continuous (s, t) on the per-lane levels (_bilerp_level)."""
    meta = pyr.meta[level]
    h, w = meta[:, 0].to(DTYPE), meta[:, 1].to(DTYPE)
    sn, tn = st_norm(s_in, t_in, pyr.wrap)
    s = sn * w - 0.5
    t = tn * h - 0.5
    s0 = torch.floor(s).to(torch.int64)
    t0 = torch.floor(t).to(torch.int64)
    ds = (s - s0.to(DTYPE))[:, None]
    dt = (t - t0.to(DTYPE))[:, None]
    v00 = texel(pyr, meta, s0, t0)
    v10 = texel(pyr, meta, s0 + 1, t0)
    v01 = texel(pyr, meta, s0, t0 + 1)
    v11 = texel(pyr, meta, s0 + 1, t0 + 1)
    return ((1 - ds) * (1 - dt) * v00 + ds * (1 - dt) * v10 + (1 - ds) * dt * v01
            + ds * dt * v11)


def ewa_level(pyr, level, s_in, t_in, d0s_in, d0t_in, d1s_in, d1t_in, live=None, work=None):
    """The elliptical Gaussian tap on the per-lane levels (_ewa_level): st
    in uv units, the axes in uv units.  `work` counts the texels of
    non-zero weight on the `live` lanes ("texel"); a callable under its
    "ewa_scan" (ops/texture.ScanCounter) also gets the lanes, the ellipse
    and window (a, b, c, s, t, s0, t0) and the (N, EWA_WINDOW, EWA_WINDOW)
    texels of non-zero weight."""
    meta = pyr.meta[level]
    h, w = meta[:, 0].to(DTYPE), meta[:, 1].to(DTYPE)
    sn, tn = st_norm(s_in, t_in, pyr.wrap)
    s = sn * w - 0.5
    t = tn * h - 0.5
    d0s, d0t = d0s_in * w, d0t_in * h
    d1s, d1t = d1s_in * w, d1t_in * h
    # ellipse coefficients, +1 texel of blur (mipmap.rs)
    a = d0t * d0t + d1t * d1t + 1.0
    b = -2.0 * (d0s * d0t + d1s * d1t)
    c = d0s * d0s + d1s * d1s + 1.0
    inv_f = 1.0 / torch.clamp(a * c - b * b * 0.25, min=1e-12)
    a, b, c = a * inv_f, b * inv_f, c * inv_f
    det = torch.clamp(-b * b + 4.0 * a * c, min=1e-12)
    inv_det = 1.0 / det
    half = EWA_WINDOW // 2
    u_rad = torch.clamp(torch.sqrt(torch.clamp(c * inv_det * 4.0, min=0.0)), max=half - 1.0)
    v_rad = torch.clamp(torch.sqrt(torch.clamp(a * inv_det * 4.0, min=0.0)), max=half - 1.0)
    s0 = torch.ceil(s - u_rad).to(torch.int64)
    t0 = torch.ceil(t - v_rad).to(torch.int64)
    acc = torch.zeros((s.shape[0], 3), dtype=DTYPE, device=s.device)
    wsum = torch.zeros_like(s)
    count = torch.zeros(s.shape, dtype=torch.int64, device=s.device)
    scan = None if work is None else work.get("ewa_scan")
    weighed = []
    for i in range(EWA_WINDOW):  # window rows (t), then columns (s)
        tt = (t0 + i).to(DTYPE) - t
        for j in range(EWA_WINDOW):
            ss = (s0 + j).to(DTYPE) - s
            r2 = a * (ss * ss) + b * tt * ss + c * (tt * tt)
            inside = r2 < 1.0
            wgt = torch.where(inside, torch.clamp(torch.exp(-2.0 * r2) - EXP_M2, min=0.0), 0.0)
            acc = acc + wgt[:, None] * texel(pyr, meta, s0 + j, t0 + i)
            wsum = wsum + wgt
            count = count + (wgt > 0.0)
            if scan is not None:
                weighed.append(wgt > 0.0)
    if work is not None:
        work["texel"] = work.get("texel", 0) + torch.where(live, count, 0).sum()
    if scan is not None:
        scan(live, a, b, c, s, t, s0, t0, torch.stack(weighed, 1).view(-1, EWA_WINDOW, EWA_WINDOW))
    return acc / torch.clamp(wsum, min=1e-9)[:, None]


def ewa_lookup(pyr, s, t, d0s, d0t, d1s, d1t, live=None, work=None):
    """Anisotropic lookup (mipmap.rs lookup_d; the JAX package's
    ewa_lookup) at st (s, t) with the footprint axes dst0 = (d0s, d0t) and
    dst1 = (d1s, d1t), flat (N,) float32 tensors.  Returns (N, 3).
    `work` counts the texels the tap weighs on the `live` lanes (all when
    None): those of non-zero weight of both levels, or the 4 of the
    bilinear fallback."""
    live = torch.ones_like(s, dtype=torch.bool) if live is None else live
    n_levels = pyr.n_levels
    l0_sq = d0s * d0s + d0t * d0t
    l1_sq = d1s * d1s + d1t * d1t
    swap = l0_sq < l1_sq
    mas, mat_ = torch.where(swap, d1s, d0s), torch.where(swap, d1t, d0t)
    mis, mit = torch.where(swap, d0s, d1s), torch.where(swap, d0t, d1t)
    major_len = torch.sqrt(torch.clamp(mas * mas + mat_ * mat_, min=1e-20))
    minor_len = torch.sqrt(torch.clamp(mis * mis + mit * mit, min=0.0))
    max_aniso = pyr.max_aniso
    scale = torch.where((minor_len * max_aniso < major_len) & (minor_len > 0.0),
                        major_len / torch.clamp(minor_len * max_aniso, min=1e-20), 1.0)
    mis, mit = mis * scale, mit * scale
    minor_len = minor_len * scale
    degenerate = minor_len <= 1e-9
    lod = torch.clamp(n_levels - 1 + torch.log2(torch.clamp(minor_len, min=1e-9)), 0.0,
                      n_levels - 1.0)
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.clamp(l0 + 1, max=n_levels - 1)
    dt = (lod - l0.to(DTYPE))[:, None]
    ewa_live = live & ~degenerate
    e0 = ewa_level(pyr, l0, s, t, mas, mat_, mis, mit, ewa_live, work)
    e1 = ewa_level(pyr, l1, s, t, mas, mat_, mis, mit, ewa_live, work)
    out = (1 - dt) * e0 + dt * e1
    fallback = bilerp_level(pyr, torch.zeros_like(l0), s, t)
    if work is not None:
        work["texel"] = work["texel"] + 4 * (live & degenerate).sum()
    return torch.where(degenerate[:, None], fallback, out)
