"""Brute-force closest hit, K4 (rs_ray_toy_tpu/ops/intersect_pallas.py).

`intersect_triangles(tri_packed, o, d, t_max)` tests every ray against
every triangle of the packed (T, 12) table [p0, e1, e2, pad] (scene
order) with Moller-Trumbore and the JAX package's epsilons, and returns
the closest hit with t in [TRI_EPS, t_max): (t, idx, hit), t = +inf and
idx = -1 on a miss, as `intersect_triangles_pallas` does.  The wavefront
loop takes it for scenes of at most 256 primitives (accel/bvh's
BRUTE_FORCE_CUTOFF), for closest hits and, as `hit`, for occlusion.

On a CUDA tensor the wrapper launches csrc/intersect_kernel.cu (built by
ops/_build.py) or raises; on a CPU tensor it runs
`intersect_triangles_reference`, the plain PyTorch version.
"""

import ctypes

import numpy as np
import torch

from . import _build
from .path_megakernel import BIG_T, _mt, tally

PACKED_COLS = 12
K4_TRI_MAX = 1024  # csrc/intersect_kernel.cu: the triangles in static shared memory

# Kernel launches made by intersect_triangles; the one piece of module state.
LAUNCHES = {"intersect": 0}
_LIB = None


def pack_triangles(p0, p1, p2):
    """(T, 3) x 3 -> (T, 12) float32 [p0, e1 = p1 - p0, e2 = p2 - p0, pad]
    (intersect_pallas.pack_triangles)."""
    p0 = np.asarray(p0, np.float32)
    out = np.zeros((p0.shape[0], PACKED_COLS), np.float32)
    out[:, 0:3] = p0
    out[:, 3:6] = np.asarray(p1, np.float32) - p0
    out[:, 6:9] = np.asarray(p2, np.float32) - p0
    return out


def intersect_triangles_reference(tri_packed, o, d, t_max, work=None):
    """Plain PyTorch version of `intersect_triangles`: every triangle in
    table order, strict < (ties keep the lower row, as argmin does).
    `work`, a dict, gets the Moller-Trumbore tests ("mt")."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    t_best = torch.clamp(t_max, max=BIG_T)
    best = torch.full(ox.shape, -1, dtype=torch.int64, device=o.device)
    for j, g in enumerate(tri_packed[:, :9].tolist()):
        hit, t = _mt(g, ox, oy, oz, dx, dy, dz)
        upd = hit & (t < t_best)
        t_best = torch.where(upd, t, t_best)
        best = torch.where(upd, j, best)
    tally(work, "mt", torch.full_like(best, tri_packed.shape[0]))
    hit = best >= 0
    return torch.where(hit, t_best, torch.inf), best, hit


def load_kernel():
    """The K4 library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("intersect_kernel")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.intersect_launch.restype = i
        lib.intersect_launch.argtypes = [p, i, p, p, p, p, p, i, p]
        lib.intersect_error_string.restype = ctypes.c_char_p
        lib.intersect_error_string.argtypes = [i]
        if lib.intersect_tri_max() != K4_TRI_MAX:
            raise RuntimeError("intersect_kernel's triangle limit differs from K4_TRI_MAX")
        _LIB = lib
    return _LIB


def ray_args(o, d, t_max):
    """(o, d, t_max) checked for a launch: contiguous float32 (N, 3), (N, 3)
    and (N,) on one CUDA device."""
    n = o.shape[0]
    dev = o.device
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("t_max", t_max, (n,))):
        if x.device != dev or x.dtype != torch.float32 or x.shape != shape:
            raise ValueError(f"{name} must be float32 of shape {shape} on {dev}")
    return o.contiguous(), d.contiguous(), t_max.contiguous()


def prepare_launch(tri_packed, o, d, t_max):
    """Check the CUDA inputs, allocate the outputs and return launch(): one
    kernel launch on the current stream returning (t, idx); relaunching
    rewrites the same outputs."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"the intersect kernel runs on cuda tensors, not {dev}")
    o, d, t_max = ray_args(o, d, t_max)
    t_count = tri_packed.shape[0]
    if (tri_packed.device != dev or tri_packed.dtype != torch.float32
            or tri_packed.shape != (t_count, PACKED_COLS) or not 0 < t_count <= K4_TRI_MAX
            or not tri_packed.is_contiguous()):
        raise ValueError(f"tri_packed must be contiguous float32 (T, 12), 0 < T <= {K4_TRI_MAX}")
    n = o.shape[0]
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    idx_out = torch.empty(n, dtype=torch.int32, device=dev)
    lib = load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = lib.intersect_launch(tri_packed.data_ptr(), t_count, o.data_ptr(), d.data_ptr(),
                                   t_max.data_ptr(), t_out.data_ptr(), idx_out.data_ptr(), n,
                                   stream)
        if err != 0:
            msg = lib.intersect_error_string(err).decode()
            raise RuntimeError(f"intersect kernel launch failed: CUDA error {err} ({msg})")
        LAUNCHES["intersect"] += 1
        return t_out, idx_out

    return launch


def intersect_triangles(tri_packed, o, d, t_max):
    """Closest hit against the packed table.  o, d: (N, 3); t_max: (N,).
    Returns (t (N,), idx (N,) int64, hit (N,) bool).  CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        return intersect_triangles_reference(tri_packed, o, d, t_max)
    t, idx = prepare_launch(tri_packed, o, d, t_max)()
    idx = idx.to(torch.int64)
    return t, idx, idx >= 0
