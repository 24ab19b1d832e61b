"""PNG decoding for image textures, with zlib and numpy alone.

The JAX package's loader reads an ImageTexture with PIL
(rs_ray_toy_tpu/scene/loader.py:456-466: `Image.open(f).convert("RGB")`,
the sRGB curve in float64, rows flipped so that v = 0 is the bottom row;
renderprocess.rs:535-569).  `read_rgb8` decodes what that path needs from
an 8-bit, non-interlaced PNG: grey, grey + alpha, RGB, RGBA and palette
images, every row filter (None, Sub, Up, Average, Paeth), to the (H, W, 3)
uint8 array PIL's RGB conversion gives (grey replicated, alpha dropped,
palette entries looked up).  Other bit depths and Adam7 interlacing raise
NotImplementedError naming them.  `load_image` applies the loader's
linearisation and row flip.
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha", 6: "RGBA"}


def _chunks(data):
    """(tag, body) of each chunk after the signature."""
    if data[:8] != _SIGNATURE:
        # an OSError, as PIL's UnidentifiedImageError: the loader skips it
        raise OSError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        yield tag, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IEND":
            return


def _unfilter(raw, h, stride, bpp):
    """The (h, stride) uint8 scanlines of the inflated stream `raw`, each
    row's filter (PNG spec 9.2) undone against the row above."""
    rows = np.frombuffer(raw, np.uint8)[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum along each byte of a pixel
            cur = np.empty(stride, np.uint8)
            for k in range(bpp):
                cur[k::bpp] = np.cumsum(line[k::bpp], dtype=np.uint64).astype(np.uint8)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: byte by byte
            cur = bytearray(stride)
            up = prev.tolist()
            for i, x in enumerate(line.tolist()):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (x + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (x + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_rgb8(path):
    """(H, W, 3) uint8 RGB of the PNG at `path`, top row first."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, palette, idat = None, None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {colour}")
    if depth != 8:
        raise NotImplementedError(f"{depth}-bit {_COLOUR_NAMES[colour]} PNG images "
                                  "(8-bit only)")
    if interlace:
        raise NotImplementedError("Adam7-interlaced PNG images")
    n_ch = _CHANNELS[colour]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * n_ch, n_ch).reshape(h, w, n_ch)
    if colour == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without a PLTE chunk")
        return palette[px[..., 0]]
    if colour in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def load_image(path, gamma):
    """The JAX loader's _load_image: (H, W, 3) float64 in [0, 1], the sRGB
    curve undone when `gamma`, rows flipped (v = 0 the bottom row)."""
    img = read_rgb8(path).astype(np.float64) / 255.0
    if gamma:
        img = np.where(img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4)
    return img[::-1]
