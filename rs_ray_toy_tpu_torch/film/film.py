"""Film: XYZ accumulation and PNG output (rs_ray_toy_tpu/film/film.py).

The film is two tensors on the render device, xyz (H, W, 3) and weight
(H, W); splats are not ported.  Only the aligned box-filter add is
ported: with a box of radius <= 0.5 every sample lands on its own pixel,
so FilmTile::add_sample (film.rs:77-130) over a full-grid batch is a
reshape-add whose summation order is fixed.  `set_image` replaces the
film's contents (the SPPM image).  `write_png` encodes with zlib and
struct from the standard library.
"""

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


def add_samples(film: FilmState, spec, p_film, radiance, sample_weight) -> FilmState:
    """Add a batch of k full pixel grids in sample-outer, row-major
    order: p_film (k*H*W, 2) raster positions, radiance (k*H*W, 3) RGB,
    sample_weight (k*H*W,) camera-ray weights."""
    h, w = film.weight.shape
    # a box inside one pixel: each sample lands on its own pixel
    aligned = spec.filter_type == "BoxFilter" and max(spec.filter_radius) <= 0.5
    if not aligned:
        raise NotImplementedError(
            f"film filter {spec.filter_type} with radius "
            f"{tuple(float(r) for r in spec.filter_radius)}"
        )
    if p_film.shape[0] % (h * w):
        raise ValueError("add_samples takes whole pixel grids")
    if np.isfinite(spec.max_sample_luminance):
        y = luminance(radiance)
        s = torch.where(
            y > spec.max_sample_luminance,
            spec.max_sample_luminance / torch.clamp(y, min=1e-20),
            1.0,
        )
        radiance = radiance * s[..., None]
    xyz = rgb_to_xyz(radiance) * sample_weight[..., None]
    k = p_film.shape[0] // (h * w)
    acc = xyz.reshape(k, h, w, 3).sum(dim=0)
    return FilmState(xyz=film.xyz + acc, weight=film.weight + float(k))


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
