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
"""

import ctypes

import numpy as np
import torch

from ..scene.mipmap import LEVELS_MAX, ewa_lookup
from . import _build

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
        _LIB = lib
    return _LIB


def tex_lookup_reference(pyr, st, dst0, dst1, work=None):
    """Plain version of tex_lookup (mipmap.ewa_lookup); `work` counts the
    texels of non-zero weight ("texel")."""
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
