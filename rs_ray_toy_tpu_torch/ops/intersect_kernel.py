"""Brute-force closest hit, K4 (rs_ray_toy_tpu/ops/intersect_pallas.py).

`intersect_triangles(tri_packed, o, d, t_max)` tests every ray against
every triangle of the packed (T, 12) table [p0, e1, e2, pad] (scene
order) with Moller-Trumbore and the JAX package's epsilons, and returns
the closest hit with t in [TRI_EPS, t_max): (t, idx, hit), t = +inf and
idx = -1 on a miss, as `intersect_triangles_pallas` does.  The wavefront
loop takes it for scenes of at most 256 primitives (accel/bvh's
BRUTE_FORCE_CUTOFF), for closest hits and, as `hit`, for occlusion.
With `chunks` (`pack_chunks`: boxes over runs of consecutive rows, which
integrators/common.SceneCtx builds for its table) the query takes the
chunked walk (csrc/common.cuh ChunkGeometry, ops/path_megakernel
.chunk_walk), which skips every chunk whose box a ray misses before its
current best and finds the same hits; without, it tests every row.

On a CUDA tensor the wrapper launches csrc/intersect_kernel.cu (built by
ops/_build.py; `intersect_chunk_kernel` with chunks, `intersect_kernel`
without) or raises; on a CPU tensor it runs
`intersect_triangles_reference`, the plain PyTorch version.
"""

import ctypes

import numpy as np
import torch

from . import _build
from .path_megakernel import BIG_T, CHUNK_COLS, _mt, build_tri_chunks, chunk_rows, chunk_walk, tally

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


def pack_chunks(tri_packed):
    """The chunk rows (C, CHUNK_COLS) float32 over a packed (T, 12) table,
    on its device (ops/path_megakernel.build_tri_chunks), or None for an
    empty table or one past K4_TRI_MAX rows."""
    t_count = tri_packed.shape[0]
    if not 0 < t_count <= K4_TRI_MAX:
        return None
    g = tri_packed[:, :9].cpu().numpy()
    found = build_tri_chunks(g[:, 0:3], g[:, 3:6], g[:, 6:9], t_count, K4_TRI_MAX,
                             K4_TRI_MAX // 4)
    return torch.as_tensor(chunk_rows(found), device=tri_packed.device)


def intersect_triangles_reference(tri_packed, o, d, t_max, work=None, chunks=None):
    """Plain PyTorch version of `intersect_triangles`: every triangle in
    table order, strict < (ties keep the lower row, as argmin does), or
    with `chunks` the chunked walk.  `work`, a dict, gets the
    Moller-Trumbore tests ("mt") and the chunk box tests ("slab")."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    t_best = torch.clamp(t_max, max=BIG_T)
    if chunks is not None:
        live = torch.ones(ox.shape, dtype=torch.bool, device=o.device)
        t_best, best = chunk_walk(tri_packed[:, :9].T.contiguous(), chunks, ox, oy, oz, dx, dy, dz,
                                  t_best, live, False, work)
        hit = best >= 0
        return torch.where(hit, t_best, torch.inf), best, hit
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
        lib.intersect_chunk_launch.restype = i
        lib.intersect_chunk_launch.argtypes = [p, i, p, i, p, p, p, p, p, i, p]
        lib.intersect_occupancy.restype = None
        lib.intersect_occupancy.argtypes = [ctypes.POINTER(i)]
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


def occupancy():
    """The last chunked launch of K4: its block size, blocks resident per
    SM, registers per thread and dynamic shared memory bytes."""
    out = (ctypes.c_int * 4)()
    load_kernel().intersect_occupancy(out)
    return dict(zip(("block", "blocks_per_sm", "registers", "smem"), out))


def prepare_launch(tri_packed, o, d, t_max, chunks=None):
    """Check the CUDA inputs, allocate the outputs and return launch(): one
    kernel launch on the current stream returning (t, idx), the chunked
    walk's with `chunks`; relaunching rewrites the same outputs."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"the intersect kernel runs on cuda tensors, not {dev}")
    o, d, t_max = ray_args(o, d, t_max)
    t_count = tri_packed.shape[0]
    if (tri_packed.device != dev or tri_packed.dtype != torch.float32
            or tri_packed.shape != (t_count, PACKED_COLS) or not 0 < t_count <= K4_TRI_MAX
            or not tri_packed.is_contiguous()):
        raise ValueError(f"tri_packed must be contiguous float32 (T, 12), 0 < T <= {K4_TRI_MAX}")
    if chunks is not None and (chunks.device != dev or chunks.dtype != torch.float32
                               or chunks.dim() != 2 or chunks.shape[1] != CHUNK_COLS
                               or not 0 < chunks.shape[0] <= K4_TRI_MAX // 4
                               or not chunks.is_contiguous()):
        raise ValueError(f"chunks must be contiguous float32 (C, {CHUNK_COLS}) rows on {dev}, "
                         f"0 < C <= {K4_TRI_MAX // 4}")
    n = o.shape[0]
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    idx_out = torch.empty(n, dtype=torch.int32, device=dev)
    lib = load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        if chunks is None:
            err = lib.intersect_launch(tri_packed.data_ptr(), t_count, o.data_ptr(),
                                       d.data_ptr(), t_max.data_ptr(), t_out.data_ptr(),
                                       idx_out.data_ptr(), n, stream)
        else:
            err = lib.intersect_chunk_launch(tri_packed.data_ptr(), t_count, chunks.data_ptr(),
                                             chunks.shape[0], o.data_ptr(), d.data_ptr(),
                                             t_max.data_ptr(), t_out.data_ptr(),
                                             idx_out.data_ptr(), n, stream)
        if err != 0:
            msg = lib.intersect_error_string(err).decode()
            raise RuntimeError(f"intersect kernel launch failed: CUDA error {err} ({msg})")
        LAUNCHES["intersect"] += 1
        return t_out, idx_out

    return launch


def intersect_triangles(tri_packed, o, d, t_max, chunks=None):
    """Closest hit against the packed table.  o, d: (N, 3); t_max: (N,);
    chunks: pack_chunks' rows, or None to test every row.  Returns (t
    (N,), idx (N,) int64, hit (N,) bool).  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        return intersect_triangles_reference(tri_packed, o, d, t_max, chunks=chunks)
    t, idx = prepare_launch(tri_packed, o, d, t_max, chunks)()
    idx = idx.to(torch.int64)
    return t, idx, idx >= 0
