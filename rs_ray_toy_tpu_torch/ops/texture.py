"""K7, the EWA image-texture tap (rs_ray_toy_tpu/ops/tex_tile.py:
tile_lookup, lookup_planes, _level_planes, ewa_lod; inside the path
kernels #1 and #2).

`tex_lookup(pyr, st, dst0, dst1)` answers a batch of lookups of a
scene/mipmap Pyramid at st (N, 2) with the footprint axes dst0, dst1
(N, 2), all in uv units: the JAX package's exact filter
(scene/mipmap.ewa_lookup), (N, 3) float32.  On a CUDA tensor it launches
csrc/texture_kernel.cu (texture.cuh's tap, built by ops/_build.py) or
raises; on a CPU tensor it runs the plain version, mipmap.ewa_lookup.
The path kernel's textured instances (ops/path_megakernel.py) run the
same tap inside their bounce loop; `tex_map` builds the parameter block
both read: the levels' (h, w, offset), the wrap mode and max_aniso, and
the image texture's UV mapping and scale.

The tap visits of each level's 16 x 16 window only the rows and, in each,
the columns that can hold r^2 < 1 (texture.cuh ewa_row_span);
`ewa_row_spans` is the plain twin of that arithmetic, in float32 as the
kernel computes it, and `ScanCounter` counts with it, through the plain
version's `work`, the texels a tap scans and weighs and checks that the
spans hold every texel of non-zero weight.
"""

import ctypes

import numpy as np
import torch

from ..scene.mipmap import EWA_WINDOW, LEVELS_MAX, ewa_lookup
from . import _build

# csrc/texture.cuh's span margins (ewa_row_span)
SPAN_MARGIN = 2.0**-12
SPAN_FLOOR = 2.0**-20
SPAN_DISC_ERR = 2.0**-20
SPAN_ROOT_ERR = 2.0**-21
WARP = 32  # a warp's lanes: consecutive lookups

# Kernel launches made by tex_lookup; the one piece of module state.
LAUNCHES = {"tex_lookup": 0}
_LIB = None


class _TexMap(ctypes.Structure):
    """Mirror of `struct TexMap` in csrc/texture.cuh."""

    _fields_ = [
        ("n_levels", ctypes.c_int),
        ("wrap", ctypes.c_int),
        ("max_aniso", ctypes.c_float),
        ("su", ctypes.c_float),
        ("sv", ctypes.c_float),
        ("du", ctypes.c_float),
        ("dv", ctypes.c_float),
        ("scale", ctypes.c_float),
        ("fd_scale", ctypes.c_float),
        ("h", ctypes.c_int * LEVELS_MAX),
        ("w", ctypes.c_int * LEVELS_MAX),
        ("off", ctypes.c_int * LEVELS_MAX),
    ]


def tex_map(pyr, rec=None, spp=1):
    """The kernels' TexMap of the Pyramid `pyr`, with the UV mapping and
    scale of the texture record `rec` (identity without one) and the
    differentials' 1 / sqrt(spp), folded in float64."""
    tm = _TexMap()
    tm.fd_scale = 1.0 / float(np.sqrt(max(spp, 1)))
    tm.n_levels = pyr.n_levels
    tm.wrap = pyr.wrap
    tm.max_aniso = pyr.max_aniso
    tm.su, tm.sv, tm.du, tm.dv, tm.scale = (1.0, 1.0, 0.0, 0.0, 1.0) if rec is None else (
        rec.su, rec.sv, rec.du, rec.dv, rec.scale)
    for k, (h, w, off) in enumerate(pyr.dims):
        tm.h[k], tm.w[k], tm.off[k] = h, w, off
    return tm


def load_kernel():
    """The K7 library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("texture_kernel")
        p = ctypes.c_void_p
        lib.tex_lookup_launch.restype = ctypes.c_int
        lib.tex_lookup_launch.argtypes = [p, ctypes.POINTER(_TexMap), p, p, p, p, ctypes.c_int, p]
        lib.tex_error_string.restype = ctypes.c_char_p
        lib.tex_error_string.argtypes = [ctypes.c_int]
        if lib.tex_map_size() != ctypes.sizeof(_TexMap):
            raise RuntimeError("texture_kernel's TexMap differs from _TexMap")
        lib.tex_occupancy.restype = None
        lib.tex_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)]
        _LIB = lib
    return _LIB


def occupancy():
    """tex_lookup_kernel's launch: its block size, blocks resident per SM,
    registers per thread and dynamic shared memory bytes, as the library
    chose and measured them (zeros before the first launch)."""
    out = (ctypes.c_int * 4)()
    load_kernel().tex_occupancy(out)
    return dict(zip(("block", "blocks_per_sm", "registers", "smem"), out))


def ewa_row_spans(a, b, c, s, t, s0, t0):
    """The columns (j0, j1), each (N, EWA_WINDOW) int64, that the tap
    visits in each row of a level's window (texture.cuh ewa_row_span, in
    float32 expression for expression): a, b, c the ellipse's float32
    coefficients, s, t the texel-space centre and s0, t0 (int64) the
    window's first column and row, as mipmap.ewa_level computes them.  A
    row the tap skips has j1 < j0; without finite coefficients with a > 0
    and a finite centre every row is whole (0, EWA_WINDOW - 1)."""
    r2_top = 1.0 + (SPAN_MARGIN * (a.abs() + b.abs() + c.abs()) + SPAN_FLOOR)
    spans = (a > 0.0) & torch.isfinite(r2_top) & torch.isfinite(s) & torch.isfinite(t)
    inv_a = 1.0 / a
    col0 = s0.to(s.dtype) - s
    zero = torch.zeros_like(s)
    j0s, j1s = [], []
    for i in range(EWA_WINDOW):
        tt = (t0 + i).to(s.dtype) - t
        bt = b * tt
        ct2 = c * (tt * tt)
        four_a = 4.0 * a
        disc = bt * bt - four_a * (ct2 - r2_top)
        err = SPAN_DISC_ERR * (bt * bt + four_a * (ct2.abs() + r2_top))
        sq = torch.sqrt(torch.fmax(disc, zero) + err)
        slack = SPAN_ROOT_ERR * (bt.abs() + sq) * inv_a + 1.0
        lo = (-bt - sq) * (0.5 * inv_a) - slack - col0
        hi = (-bt + sq) * (0.5 * inv_a) + slack - col0
        j0 = torch.ceil(torch.fmin(torch.fmax(lo, zero - 1.0), zero + EWA_WINDOW))
        j1 = torch.floor(torch.fmax(torch.fmin(hi, zero + EWA_WINDOW), zero - 1.0))
        j0 = torch.clamp(j0.to(torch.int64), min=0)
        j1 = torch.clamp(j1.to(torch.int64), max=EWA_WINDOW - 1)
        skip = disc < -err
        j0s.append(torch.where(spans, torch.where(skip, 0, j0), 0))
        j1s.append(torch.where(spans, torch.where(skip, -1, j1), EWA_WINDOW - 1))
    return torch.stack(j0s, 1), torch.stack(j1s, 1)


class ScanCounter:
    """The `work["ewa_scan"]` hook of mipmap.ewa_level: on each level's tap
    of the live lanes it takes the spans (ewa_row_spans) and the window
    texels of non-zero weight, and counts per lane the texels the bounded
    tap scans, those of the whole window and those it weighs, and the
    weighed texels outside the spans ("uncovered", which must be 0).
    `summary()` gives them per lookup, over lookups of both levels (the
    calls come in pairs, level l0 then l1, on the same lanes), with the
    mean over the warps of 32 consecutive lanes of each warp's longest
    scan."""

    def __init__(self):
        self.lanes = []  # per call: (live, scanned, weighed)
        self.uncovered = 0

    def __call__(self, live, a, b, c, s, t, s0, t0, weighed):
        j0, j1 = ewa_row_spans(a, b, c, s, t, s0, t0)
        col = torch.arange(EWA_WINDOW, device=s.device)
        inside = (col >= j0[:, :, None]) & (col <= j1[:, :, None])
        self.uncovered += int((weighed & ~inside & live[:, None, None]).sum())
        scanned = torch.clamp(j1 - j0 + 1, min=0).sum(1)
        self.lanes.append((live, torch.where(live, scanned, 0),
                           torch.where(live, weighed.sum((1, 2)), 0)))

    def summary(self):
        """{"lookups", "scanned", "window", "weighed" (texels a lookup, both
        levels), "warp_longest" (the warps' longest scan, mean over the
        warps with a live lane), "uncovered"}."""
        lookups = scanned = weighed = longest = warps = 0
        for (live, sc0, w0), (_, sc1, w1) in zip(self.lanes[0::2], self.lanes[1::2]):
            lookups += int(live.sum())
            scanned += int((sc0 + sc1).sum())
            weighed += int((w0 + w1).sum())
            pad = -live.numel() % WARP
            per_warp = torch.nn.functional.pad(sc0 + sc1, (0, pad)).view(-1, WARP)
            has = torch.nn.functional.pad(live, (0, pad)).view(-1, WARP).any(1)
            longest += int(per_warp.amax(1)[has].sum())
            warps += int(has.sum())
        n = max(lookups, 1)
        return dict(lookups=lookups, scanned=scanned / n, window=2 * EWA_WINDOW**2,
                    weighed=weighed / n, warp_longest=longest / max(warps, 1),
                    uncovered=self.uncovered)


def tex_lookup_reference(pyr, st, dst0, dst1, work=None):
    """Plain version of tex_lookup (mipmap.ewa_lookup); `work` counts the
    texels of non-zero weight ("texel"; a ScanCounter under "ewa_scan"
    counts the scans)."""
    return ewa_lookup(pyr, st[:, 0], st[:, 1], dst0[:, 0], dst0[:, 1], dst1[:, 0], dst1[:, 1],
                      work=work)


def prepare_launch(pyr, st, dst0, dst1):
    """Check the CUDA inputs, allocate the output and return launch(): one
    launch on the current stream returning (N, 3); relaunching rewrites it."""
    dev = st.device
    if dev.type != "cuda":
        raise ValueError(f"the texture kernel runs on cuda tensors, not {dev}")
    n = st.shape[0]
    for name, x in (("st", st), ("dst0", dst0), ("dst1", dst1)):
        if x.device != dev or x.dtype != torch.float32 or x.shape != (n, 2):
            raise ValueError(f"{name} must be float32 (N, 2) on {dev}")
    if pyr.data.device != dev or pyr.data.dtype != torch.float32 or not pyr.data.is_contiguous():
        raise ValueError(f"the pyramid must be contiguous float32 on {dev}")
    st, dst0, dst1 = st.contiguous(), dst0.contiguous(), dst1.contiguous()
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    tm = tex_map(pyr)
    lib = load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = lib.tex_lookup_launch(pyr.data.data_ptr(), ctypes.byref(tm), st.data_ptr(),
                                    dst0.data_ptr(), dst1.data_ptr(), out.data_ptr(), n, stream)
        if err != 0:
            msg = lib.tex_error_string(err).decode()
            raise RuntimeError(f"tex_lookup kernel launch failed: CUDA error {err} ({msg})")
        LAUNCHES["tex_lookup"] += 1
        return out

    return launch


def tex_lookup(pyr, st, dst0, dst1):
    """(N, 3) EWA lookups; CPU tensors run the plain version, CUDA tensors
    launch the kernel."""
    if st.device.type == "cpu":
        return tex_lookup_reference(pyr, st, dst0, dst1)
    return prepare_launch(pyr, st, dst0, dst1)()
