"""Film: XYZ accumulation and PNG output (rs_ray_toy_tpu/film/film.py).

The film is two tensors on the render device, xyz (H, W, 3) and weight
(H, W); splats are not ported (nothing in the JAX package adds one).
FilmTile::add_sample (film.rs:77-130): with a box of radius <= 0.5 every
sample lands on its own pixel, so the add of a batch of whole pixel grids
is a reshape-add whose summation order is fixed.  Every other filter (a
wider box, the triangle and the Gaussian, `filter_1d`) weighs each
sample into the pixels of its footprint about its base pixel, the JAX
package's round-half-to-even of p_film - 0.5, with spans of ceil(r - 0.5)
pixels and out-of-film pixels weighted 0.  The add is deterministic, so
that two renders of a scene give the same bits on a card as on the host:
on whole pixel grids, each footprint offset adds the pass's grids summed
over their samples into a shifted slice of the film, offsets in a fixed
order (a sample's base is its own pixel or, with p_film - 0.5 exactly
half-way or a jitter that rounds up to the next pixel in float32, one
next to it, so the offsets run one past the span); any other batch is
summed pixel by pixel after a stable sort of its (sample, pixel) pairs.
Neither reads a tensor back to the host.  `set_image` replaces the
film's contents (the SPPM image).  `write_png` encodes with zlib and
struct from the standard library.
"""

import math
import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

from ..config import DTYPE
from ..core.spectrum import gamma_correct, luminance, rgb_to_xyz, xyz_to_rgb


class FilmState(NamedTuple):
    xyz: torch.Tensor  # (H, W, 3)
    weight: torch.Tensor  # (H, W)


def make_film(spec, device) -> FilmState:
    h, w = spec.yres, spec.xres
    return FilmState(
        xyz=torch.zeros((h, w, 3), dtype=DTYPE, device=device),
        weight=torch.zeros((h, w), dtype=DTYPE, device=device),
    )


def aligned(spec) -> bool:
    """A box inside one pixel: each sample lands on its own pixel (the
    JAX package's aligned_fast_path_ok)."""
    return spec.filter_type == "BoxFilter" and max(spec.filter_radius) <= 0.5


def filter_1d(spec, d, axis):
    """The separable filter's factor at float32 offsets d along `axis` (0:
    x, 1: y), 0 past its radius (the JAX package's _filter_eval per axis):
    a box 1, a triangle max(0, r - |d|), a Gaussian max(0, e^(-a d^2) -
    e^(-a r^2))."""
    r = float(spec.filter_radius[axis])
    if spec.filter_type == "TriangleFilter":
        w = torch.clamp(r - torch.abs(d), min=0.0)
    elif spec.filter_type == "GaussianFilter":
        a = float(spec.gaussian_alpha)
        w = torch.clamp(torch.exp(-a * d * d) - math.exp(-a * r * r), min=0.0)
    else:
        w = torch.ones_like(d)
    return torch.where(torch.abs(d) <= r, w, 0.0)


def footprint(spec):
    """(x offsets, y offsets) of the pixels a sample may weigh about its
    base pixel: -m..m with m = ceil(r - 0.5), or 0 alone for r <= 0.5."""
    def span(r):
        m = int(math.ceil(r - 0.5)) if r > 0.5 else 0
        return tuple(range(-m, m + 1))
    return span(float(spec.filter_radius[0])), span(float(spec.filter_radius[1]))


def add_samples(film: FilmState, spec, p_film, radiance, sample_weight) -> FilmState:
    """Add a batch of samples: p_film (N, 2) raster positions, radiance
    (N, 3) RGB, sample_weight (N,) camera-ray weights.  The aligned box
    takes k whole pixel grids in sample-outer, row-major order and reads
    no p_film; the other filters take such grids with each sample inside
    its own pixel (p_film - pixel in [0, 1]), or any batch that is not
    whole grids."""
    h, w = film.weight.shape
    if np.isfinite(spec.max_sample_luminance):
        y = luminance(radiance)
        s = torch.where(
            y > spec.max_sample_luminance,
            spec.max_sample_luminance / torch.clamp(y, min=1e-20),
            1.0,
        )
        radiance = radiance * s[..., None]
    xyz = rgb_to_xyz(radiance) * sample_weight[..., None]
    if not aligned(spec):
        return _add_filtered(film, spec, p_film, xyz)
    if p_film.shape[0] % (h * w):
        raise ValueError("the aligned add takes whole pixel grids")
    k = p_film.shape[0] // (h * w)
    acc = xyz.reshape(k, h, w, 3).sum(dim=0)
    return FilmState(xyz=film.xyz + acc, weight=film.weight + float(k))


def _add_filtered(film, spec, p_film, contrib):
    """The footprint add of `contrib` (N, 3), each sample's XYZ times its
    weight (film.rs:86-129), on the film's device: each sample's filter
    weight at each pixel of its footprint, contrib times it added to the
    pixel's XYZ and the weight to its weight sum."""
    h, w = film.weight.shape
    pd = p_film - 0.5
    base = torch.round(pd).to(torch.int64)  # half to even, as jnp.round
    c4 = torch.cat([contrib, torch.ones_like(contrib[:, :1])], dim=1)  # XYZ, weight
    n = p_film.shape[0]
    if n % (h * w):
        acc = _pair_sums(spec, h, w, pd, base, c4)
    else:
        acc = _grid_sums(spec, h, w, n // (h * w), pd, base, c4)
    return FilmState(xyz=film.xyz + acc[..., :3], weight=film.weight + acc[..., 3])


def _grid_sums(spec, h, w, k, pd, base, c4):
    """The (H, W, 4) sums of k whole pixel grids, each sample inside its
    own pixel (lane r's is r mod (H W)): its base is that pixel or one
    next to it, so its footprint lies within m + 1 pixels of it.  Offset
    by offset from the own pixel, in a fixed order, each sample's weight
    there (0 outside its base's span), the grids summed and added into a
    shifted slice of the film; one row of offsets at a time."""
    dev = pd.device
    pix = torch.arange(h * w, device=dev).repeat(k)
    own = (pix % w, pix // w)

    def weights(axis, m):
        q = torch.arange(-m - 1, m + 2, device=dev)[:, None]
        d = base[:, axis] - own[axis]
        f = filter_1d(spec, (own[axis] + q).to(DTYPE) - pd[:, axis], axis)
        return q[:, 0].tolist(), torch.where((q - d).abs() <= m, f, 0.0)  # (2m + 3, N)

    span_x, span_y = footprint(spec)
    qx, wx = weights(0, span_x[-1])
    qy, wy = weights(1, span_y[-1])
    acc = torch.zeros((h, w, 4), dtype=DTYPE, device=dev)
    for oy, fy in zip(qy, wy):
        cy = c4 * fy[:, None]
        g = (cy[None] * wx[:, :, None]).reshape(len(qx), k, h, w, 4).sum(dim=1)
        # pixel (y, x)'s sums land on (y + oy, x + ox) when inside
        dy, sy = slice(max(oy, 0), h + min(oy, 0)), slice(max(-oy, 0), h - max(oy, 0))
        for ox, gx in zip(qx, g):
            dx, sx = slice(max(ox, 0), w + min(ox, 0)), slice(max(-ox, 0), w - max(ox, 0))
            acc[dy, dx] += gx[sy, sx]
    return acc


def _pair_sums(spec, h, w, pd, base, c4):
    """The (H, W, 4) sums of any batch: every (sample, footprint pixel)
    pair, stably sorted by pixel, summed pixel by pixel in lane order
    (out-of-film pixels into a spare segment that is dropped)."""
    span_x, span_y = footprint(spec)
    dest, vals = [], []
    for oy in span_y:
        py = base[:, 1] + oy
        fy = filter_1d(spec, py.to(DTYPE) - pd[:, 1], 1)
        for ox in span_x:
            px = base[:, 0] + ox
            fx = filter_1d(spec, px.to(DTYPE) - pd[:, 0], 0)
            ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
            dest.append(torch.where(ok, py * w + px, h * w))
            vals.append(c4 * (fy * fx)[:, None])
    dest, vals = torch.cat(dest), torch.cat(vals)
    order = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest, minlength=h * w + 1)
    sums = torch.segment_reduce(vals[order], "sum", lengths=counts, axis=0)
    return sums[: h * w].reshape(h, w, 4)


def set_image(film: FilmState, rgb) -> FilmState:
    """Film::set_image (film.rs:265-278): the (H, W, 3) linear RGB image
    as the film's XYZ, weight 1 (the SPPM render's output)."""
    return FilmState(xyz=rgb_to_xyz(rgb), weight=torch.ones_like(film.weight))


def to_rgb(film: FilmState, spec):
    """Film::write_image math (film.rs:323-361) without splats: normalise
    by filter weight, apply scale.  (H, W, 3) linear RGB."""
    rgb = xyz_to_rgb(film.xyz)
    wt = film.weight[..., None]
    rgb = torch.where(
        wt != 0.0, torch.clamp(rgb / torch.where(wt == 0, 1.0, wt), min=0.0), rgb
    )
    return rgb * spec.scale


def write_png(rgb, path):
    """8-bit sRGB PNG (renderprocess.rs:1501-1530 gamma and clamp).
    Returns the number of pixels with any non-zero channel."""
    arr = gamma_correct(torch.as_tensor(rgb)).cpu().numpy()
    q = np.clip(255.0 * arr + 0.5, 0.0, 255.0).astype(np.uint8)
    h, w, _ = q.shape
    raw = b"".join(b"\x00" + q[y].tobytes() for y in range(h))  # filter 0 rows

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as fh:
        fh.write(png)
    return int(np.sum(q.sum(axis=-1) > 0))
