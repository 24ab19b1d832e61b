"""The SPPM iteration's kernels: the camera walk (K8), the photon walk (K9)
and the Morton-sorted deposit (K10), one CUDA source
(rs_ray_toy_tpu/ops/sppm_megakernel.py).

- `sppm_camera_mega_cam`: per pixel, the lens trace and the walk of
  sppm.rs:140-260 to the visible point (VP): point-light NEE with a
  uniform light pick at every vertex (added to the pixel's direct light
  `ld`), the VP at the first vertex with a diffuse lobe or a glossy
  vertex at the last depth, BSDF bounces and the camera roulette between.
  Every sampler value comes from the (NC, N) Halton slot matrix laid out
  by `sppm_slots`.  `sppm_camera_mega` walks given rays (o, d, weight:
  the JAX package's rays-in entry), its slot matrix filled on the host
  from the caller's sampler, Halton or stratified (`slot_values`).
- `sppm_photon_mega`: per photon, from its emitted ray, the walk of
  sppm.rs:346-506 with its bounce and roulette uniforms given, writing a
  deposit event (the hit, -d, beta before the bounce, alive) at every
  depth >= 1, depth-major.
- `deposit_mega`: per VP, phi = sum of beta_ev * f(wo, wi) and M = the
  count over the events within the VP's radius.  `deposit_inputs` keys
  the events by the Morton code of their grid cell, sorts them (stable
  torch.sort) and gives each VP its range of sorted events, which holds
  every event its radius can reach; the kernel walks the range.  A VP
  with an empty range leaves before it reads its record; a warp's walking
  VPs read the rows of their ranges once, and each adds its own events in
  range order (`deposit_warp_walk`, the walk's float32 twin).

Subset (`unsupported_feature`): triangles (brute force up to TRI_MAX,
the BVH above), up to LIGHT_MAX point lights (a camera medium and the
primitives' medium_interfaces are ignored, as in the JAX package, whose
SPPM reads no medium), the lobes of the JAX package's
supports_sppm_camera (SPPM_KINDS: lambert and Disney's diffuse, retro and
sheen, the two visible-normal Trowbridge-Reitz microfacets, Disney's
clearcoat, specular reflection and transmission and fresnel specular;
unscaled), max_depth 2..DEPTH_MAX.  The triangle table is pack_scene's,
whose column 47 carries the material id; the VP's BSDF in the deposit
comes from `resolve_mat_tables`, one row per material in the table's lobe
layout.  A scene whose used lobes are all among pmk.BASE_KINDS takes the
kernels' base instances; one with a Disney lobe or specular transmission
their wide instances (`wide_lobes`: the Disney lobes' f, pdf and samples
and the specular refraction, common.cuh's kDisney and kSt), named with
"_wide" in LAUNCHES.  Specular vertices (a glass's reflection and
transmission) make no VP: the walks go through them.

The camera and photon walks' geometry is the path, direct and Volpath
kernels': the chunked brute-force walk over `packed.chunks`
(pmk.chunk_args), or the walk of the BVH's node64 rows and 48-byte leaf
rows (pmk.geometry_args with `node64`, pmk.root_count); their plain
versions walk the same (PlainGeometry with `cull`).  Each launch runs in
the block the library picks (`occupancy`).

On CUDA tensors each wrapper launches its kernel of
csrc/sppm_megakernel.cu (built by ops/_build.py) or raises; on CPU
tensors it runs its plain PyTorch version (`*_reference`), which mirrors
the kernel expression by expression over flat (N,) tensors with masked
lanes.  Nothing else selects the path.
"""

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..bsdf.lobes import (
    LOBE_DISNEY_CLEARCOAT,
    LOBE_DISNEY_DIFFUSE,
    LOBE_DISNEY_MICROFACET_REFL,
    LOBE_DISNEY_RETRO,
    LOBE_DISNEY_SHEEN,
    LOBE_LAMBERT_REFL,
    LOBE_MF_REFL,
)
from ..config import SHADOW_EPSILON
from ..sampler.dims import CAMERA_FILM, CAMERA_LENS, SPPM_BSDF, SPPM_NEE, SPPM_RR, sppm_dim0
from . import _build
from . import path_megakernel as pmk

DEPTH_MAX = pmk.DEPTH_MAX
# of the kernels' lobe kinds (SPPM_KINDS), those that make a VP
# (bsdf/eval.num_components over DIFFUSE | R | T, resp. GLOSSY | R | T;
# the JAX package's DIFFUSE_KINDS / GLOSSY_KINDS)
DIFFUSE_KINDS = (LOBE_LAMBERT_REFL, LOBE_DISNEY_DIFFUSE, LOBE_DISNEY_RETRO, LOBE_DISNEY_SHEEN)
GLOSSY_KINDS = (LOBE_MF_REFL, LOBE_DISNEY_CLEARCOAT, LOBE_DISNEY_MICROFACET_REFL)
# the kinds supports_sppm_camera takes: COS_KINDS + MF_KINDS + clearcoat +
# SPEC_KINDS (the specular ones make no VP)
SPPM_KINDS = DIFFUSE_KINDS + GLOSSY_KINDS + pmk.SPEC_KINDS
LUM_R, LUM_G, LUM_B = 0.212671, 0.715160, 0.072169  # core/spectrum.luminance
MAT_COL = 47  # the table column with the triangle's material id
MAT_COLS = 16 + 16 * pmk.LOBES_MAX  # a resolved material row
EV_COLS = 10  # a sorted event row: p, wi, beta, live
MORTON_SENTINEL = 0x7FFFFFFF  # the key of a dead or out-of-grid event
GRID_RES_MAX = 1024  # cells per axis of the Morton grid

# Kernel launches by kernel; the one piece of module state.
LAUNCHES = {
    base + bvh + wide: 0
    for wide in ("", "_wide")
    for base, bvh in (("sppm_camera_mega_cam", ""), ("sppm_camera_mega_cam", "_bvh"),
                      ("sppm_camera_mega", ""), ("sppm_camera_mega", "_bvh"),
                      ("sppm_photon_mega", ""), ("sppm_photon_mega", "_bvh"),
                      ("sppm_deposit_mega", ""))
}


class VisiblePoints(NamedTuple):
    """One VP per pixel (integrators/sppm.py VisiblePoints); flat shading,
    so the shading normal is ng."""

    p: torch.Tensor  # (N, 3)
    wo: torch.Tensor  # (N, 3)
    beta: torch.Tensor  # (N, 3)
    mat: torch.Tensor  # (N,) int64 material id
    ng: torch.Tensor  # (N, 3)
    dpdu: torch.Tensor  # (N, 3)
    valid: torch.Tensor  # (N,) bool


def unsupported_feature(scene, spec) -> Optional[str]:
    """Name of the first scene feature outside the kernels' subset, or None
    when they render the job exactly (the SPPM render builds its own
    Halton sampler)."""
    if spec.kind != "sppm":
        return f"{spec.kind} integrator"
    if not 2 <= spec.max_depth <= DEPTH_MAX:
        # max_depth 1 makes no deposit event (sppm.py:426-432)
        return f"max_depth {spec.max_depth} outside 2..{DEPTH_MAX}"
    return pmk.scene_unsupported(scene, None, SPPM_KINDS)


def supports(scene, spec) -> bool:
    return unsupported_feature(scene, spec) is None


def wide_lobes(packed) -> bool:
    """Whether the packed scene's live lobes need the kernels' wide
    instances: a lobe outside pmk.BASE_KINDS (Disney's, or specular
    transmission)."""
    return any(k not in pmk.BASE_KINDS for k in packed.kinds_present)


def pack_sppm(scene, device, bvh=None) -> pmk.PackedScene:
    """pack_scene: the triangle table (its column 47 is the material id)
    and the point lights, in BVH leaf order above TRI_MAX triangles.
    Raises where a triangle's material id is not a row of
    resolve_mat_tables(scene): every VP's id comes from column 47, so the
    deposit's material rows hold every id the render's VPs carry."""
    mat = np.asarray(scene.triangles.mat)
    n_mats = scene.materials["kind"].shape[0]
    if mat.size and (mat.min() < 0 or mat.max() >= n_mats):
        raise ValueError(f"triangle material ids outside the scene's {n_mats} materials")
    return pmk.pack_scene(scene, device, bvh)


def resolve_mat_tables(scene, device):
    """(M, MAT_COLS) float32: per material, its resolved lobe columns in
    the triangle table's layout (col 15 n_lobes, 16 + 16 l lobe l)."""
    mats = scene.materials
    n_mats = mats["kind"].shape[0]
    return mat_table(pmk._resolve_mat_arrays(mats, np.arange(n_mats)), device)


def mat_table(r, device):
    """The MAT_COLS rows from resolved arrays: kinds (M, L), s0 / s1 / s2
    (M, L, 3), au, av, fres, ea, eb (M, L) and n_lobes (M,), in the path
    kernel's row layout: every column common.cuh's lobe_f reads, the
    Disney lobes' too (roughness or the clearcoat's weight in au, its
    gloss in av; the Disney microfacet's metallic and eta in ea / eb, its
    c_spec0 in s1)."""
    kinds = np.asarray(r["kinds"])
    rows = np.zeros((kinds.shape[0], MAT_COLS), np.float32)
    rows[:, 15] = np.asarray(r["n_lobes"])
    for l in range(min(pmk.LOBES_MAX, kinds.shape[1])):
        b = 16 + 16 * l
        rows[:, b] = kinds[:, l]
        for k, key in enumerate(("s0", "s1", "s2")):
            rows[:, b + 1 + 3 * k : b + 4 + 3 * k] = np.asarray(r[key])[:, l]
        for k, key in enumerate(("au", "av", "fres", "ea", "eb")):
            rows[:, b + 10 + k] = np.asarray(r[key])[:, l]
    return torch.as_tensor(rows, device=device)


def sppm_slots(max_depth):
    """(slot, 1 or 2) of every sampler value the camera walk reads, in the
    order of the slot matrix rows (_sppm_slots with the camera): film and
    lens, then per depth the light pick and, below the last depth, the
    BSDF sample and the roulette."""
    slots = [(CAMERA_FILM, 2), (CAMERA_LENS, 2)]
    for depth in range(max_depth):
        d0 = sppm_dim0(depth)
        slots.append((d0 + SPPM_NEE, 1))
        if depth < max_depth - 1:
            slots += [(d0 + SPPM_BSDF, 2), (d0 + SPPM_RR, 1)]
    return tuple(slots)


def slot_values(sampler, pixel_id, s_idx, max_depth):
    """The (4 max_depth + 1, N) float32 slot matrix of sppm_slots from any
    sampler's get_1d / get_2d (a HaltonSampler's slot_matrix)."""
    sid = pmk._sample_indices(s_idx, pixel_id.shape[0], pixel_id.device)
    slots = sppm_slots(max_depth)
    if hasattr(sampler, "slot_matrix"):
        return sampler.slot_matrix(pixel_id, sid, slots).contiguous()
    rows = []
    for slot, k in slots:
        if k == 1:
            rows.append(sampler.get_1d(pixel_id, sid, slot))
        else:
            rows.extend(sampler.get_2d(pixel_id, sid, slot).unbind(-1))
    return torch.stack(rows, 0).to(torch.float32).contiguous()


def _spread10(v):
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton3(c):
    """30-bit Morton code of integer cells c (..., 3), int64; monotone
    under componentwise <=."""
    c = c.to(torch.int64)
    return _spread10(c[..., 0]) | (_spread10(c[..., 1]) << 1) | (_spread10(c[..., 2]) << 2)


# ---- the CUDA kernels ----

def load_kernel():
    """The SPPM kernels' library (built on first use)."""
    lib = _build.load("sppm_megakernel")
    p, i = ctypes.c_void_p, ctypes.c_int
    # each launch's first argument: 1 for the wide instances (wide_lobes);
    # the camera and photon walks' last: the chunk rows, their count and
    # root_count
    lib.sppm_camera_launch.argtypes = ([i, p, i, p, p, ctypes.POINTER(pmk._Params), p, p, i]
                                       + [p] * 8 + [i, p, p, i, i])
    lib.sppm_camera_rays_launch.argtypes = ([i, p, i, p, p, ctypes.POINTER(pmk._Params)] + [p] * 4
                                            + [i] + [p] * 8 + [i, p, p, i, i])
    lib.sppm_occupancy.restype = None
    lib.sppm_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.sppm_camera_rays_launch.restype = ctypes.c_int
    lib.sppm_photon_launch.argtypes = [i, p, i, p, p, i] + [p] * 9 + [i, p, p, i, i]
    lib.sppm_deposit_launch.argtypes = [i] + [p] * 10 + [i, p, p, i, p]
    for fn in (lib.sppm_camera_launch, lib.sppm_photon_launch, lib.sppm_deposit_launch):
        fn.restype = ctypes.c_int
    lib.sppm_error_string.restype = ctypes.c_char_p
    lib.sppm_error_string.argtypes = [ctypes.c_int]
    lib.sppm_params_size.restype = ctypes.c_int
    if lib.sppm_params_size() != ctypes.sizeof(pmk._Params):
        raise RuntimeError("sppm_megakernel parameter block differs from _Params")
    return lib


OCCUPANCY_KERNELS = ("camera", "photon", "deposit")


def occupancy(bvh=False, rays_in=False, wide=False, kernel="camera"):
    """The last launch of an instance of the camera walk (BVH or chunked
    brute force, on given rays or the camera's, wide or base), of the
    photon walk (`kernel` "photon": BVH or brute force, wide or base) or of
    the deposit ("deposit": wide or base): its block size, blocks resident
    per SM, registers per thread and dynamic shared memory bytes, as the
    library chose and measured them (choose_block, at the instance's first
    launch and, for a walk, again for a brute-force table of another
    size)."""
    out = (ctypes.c_int * 4)()
    load_kernel().sppm_occupancy(OCCUPANCY_KERNELS.index(kernel), int(bvh), int(rays_in),
                                 int(wide), out)
    return dict(zip(("block", "blocks_per_sm", "registers", "smem"), out))


def _check(x, shape, dtype, dev, what):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of shape {tuple(shape)} on {dev}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _walk_args(packed, dev):
    """The camera and photon walks' tables of `packed`, checked for a launch
    on `dev`: (the table, then the launch's pointer arguments nodes64 and
    prims, and chunks, their count and root_count; each pointer None where
    the walk has no such table)."""
    table, nodes64, prims = pmk.geometry_args(packed, dev, node64=True)
    chunks, n_chunks = pmk.chunk_args(packed, dev)
    return table, _ptr(nodes64), _ptr(prims), _ptr(chunks), n_chunks, pmk.root_count(packed)


def _launcher(lib, name, fn, args, outs, keep):
    """launch(): one launch of `fn` on the current stream returning
    `outs()`; adds one to LAUNCHES[name] when the launch is accepted.
    `keep` holds the tensors behind the pointers in `args` that nothing
    else keeps alive, for as long as launch() can run.  launch.bare() is
    the ctypes call alone (no count, no outputs, its error code returned),
    for timing the kernel as the card runs it."""

    def launch():
        err = fn(*args)
        if err != 0:
            msg = lib.sppm_error_string(err).decode()
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
        LAUNCHES[name] += 1
        return outs()

    launch.keep = keep
    launch.bare = lambda: fn(*args)
    return launch


def sppm_camera_mega_cam(packed, cam_packed, pixel_xy, u_halton, max_depth):
    """The camera walk of one iteration.  pixel_xy: (N, 2) float32 integer
    raster coordinates; u_halton: the (4 max_depth + 1, N) float32 slot
    matrix (sppm_slots).  Returns (ld (N, 3), VisiblePoints).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if pixel_xy.device.type == "cpu":
        return sppm_camera_mega_cam_reference(packed, cam_packed, pixel_xy, u_halton, max_depth)
    return prepare_camera(packed, cam_packed, pixel_xy, u_halton, max_depth)()


def prepare_camera(packed, cam_packed, pixel_xy, u_halton, max_depth):
    """Check the CUDA inputs, build the parameter block and the outputs,
    and return launch() (sppm_camera_mega_cam's result)."""
    dev = pixel_xy.device
    n = pixel_xy.shape[0]
    _check(pixel_xy, (n, 2), torch.float32, dev, "pixel_xy")
    return _camera_launcher(packed, cam_packed, (pixel_xy,), u_halton, max_depth, n, dev,
                            "sppm_camera_mega_cam")


def sppm_camera_mega(packed, o, d, cam_weight, pixel_id, s_idx, sampler, max_depth):
    """The camera walk on given rays (kernel #10 of the JAX package,
    `sppm_camera_mega`): o, d (N, 3) float32, cam_weight (N,) (a ray with
    weight <= 0 is not traced; beta starts at it), pixel_id (N,) integer
    pixel ids, s_idx (N,) or a scalar, `sampler` Halton or stratified,
    whose values at sppm_slots(max_depth) fill the slot matrix on the host.
    Returns (ld (N, 3), VisiblePoints).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    u = slot_values(sampler, pixel_id, s_idx, max_depth)
    if o.device.type == "cpu":
        return sppm_camera_mega_reference(packed, o, d, cam_weight, u, max_depth)
    return prepare_camera_rays(packed, o, d, cam_weight, u, max_depth)()


def prepare_camera_rays(packed, o, d, cam_weight, u, max_depth):
    """launch() of the rays-in camera walk (sppm_camera_mega's result) on
    the slot matrix u; adds one to LAUNCHES["sppm_camera_mega"] (or its
    "_bvh" / "_wide" instance's) when the launch is accepted."""
    dev = o.device
    n = o.shape[0]
    _check(o, (n, 3), torch.float32, dev, "o")
    _check(d, (n, 3), torch.float32, dev, "d")
    w = cam_weight.to(torch.float32).contiguous()
    _check(w, (n,), torch.float32, dev, "cam_weight")
    return _camera_launcher(packed, None, (o, d, w), u, max_depth, n, dev, "sppm_camera_mega")


def _camera_launcher(packed, cam_packed, rays, u, max_depth, n, dev, prefix):
    """launch() of the camera walk on the pixels (rays = (pixel_xy,)) or on
    given rays (rays = (o, d, weight)); returns (ld, VisiblePoints)."""
    if dev.type != "cuda":
        raise ValueError(f"the SPPM camera kernel runs on cuda tensors, not {dev}")
    if not 2 <= max_depth <= DEPTH_MAX:
        raise ValueError(f"max_depth {max_depth} outside 2..{DEPTH_MAX}")
    if n == 0:
        raise ValueError("no pixels")
    n_u = 4 * max_depth + 1
    _check(u, (n_u, n), torch.float32, dev, "the slot matrix")
    table, *walk = _walk_args(packed, dev)
    prm = pmk._kernel_params(packed, cam_packed, None, None)
    prm.max_depth = max_depth
    v3 = [torch.empty((n, 3), dtype=torch.float32, device=dev) for _ in range(6)]
    mat = torch.empty((n,), dtype=torch.int32, device=dev)
    valid = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = lib.sppm_camera_launch if len(rays) == 1 else lib.sppm_camera_rays_launch
    wide = wide_lobes(packed)
    args = (int(wide), table.data_ptr(), table.shape[0], *walk[:2], ctypes.byref(prm),
            *(r.data_ptr() for r in rays), u.data_ptr(), n_u, *(t.data_ptr() for t in v3),
            mat.data_ptr(), valid.data_ptr(), n, stream, *walk[2:])

    def outs():
        ld, p, wo, beta, ng, dpdu = v3
        return ld, VisiblePoints(p, wo, beta, mat.to(torch.int64), ng, dpdu, valid != 0)

    name = prefix + "_bvh" * (packed.bvh is not None) + "_wide" * wide
    return _launcher(lib, name, fn, args, outs, (packed, rays, u, v3, mat, valid))


def sppm_photon_mega(packed, ro, rd, beta, active, u_rows, max_depth):
    """The photon walk of one iteration.  ro, rd, beta: (n, 3) float32
    emitted rays and powers; active: (n,) bool; u_rows: the
    (3 (max_depth - 1), n) float32 bounce and roulette uniforms.  Returns
    the events (ev_p, ev_wi, ev_beta (E, 3), ev_live (E,) bool), depth-major,
    E = (max_depth - 1) n; a dead event is all zeros.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if ro.device.type == "cpu":
        return sppm_photon_mega_reference(packed, ro, rd, beta, active, u_rows, max_depth)
    return prepare_photon(packed, ro, rd, beta, active, u_rows, max_depth)()


def prepare_photon(packed, ro, rd, beta, active, u_rows, max_depth):
    """Check the CUDA inputs, build the outputs, and return launch()
    (sppm_photon_mega's result)."""
    dev = ro.device
    if dev.type != "cuda":
        raise ValueError(f"the SPPM photon kernel runs on cuda tensors, not {dev}")
    if not 2 <= max_depth <= DEPTH_MAX:
        raise ValueError(f"max_depth {max_depth} outside 2..{DEPTH_MAX}")
    n = ro.shape[0]
    if n == 0:
        raise ValueError("no photons")
    for x, what in ((ro, "ro"), (rd, "rd"), (beta, "beta")):
        _check(x, (n, 3), torch.float32, dev, what)
    if active.shape != (n,) or active.device != dev:
        raise ValueError(f"active must be an (n,) tensor on {dev}")
    _check(u_rows, (3 * (max_depth - 1), n), torch.float32, dev, "u_rows")
    table, *walk = _walk_args(packed, dev)
    alive = active.to(torch.int32).contiguous()
    e = (max_depth - 1) * n
    ev = [torch.empty((e, 3), dtype=torch.float32, device=dev) for _ in range(3)]
    live = torch.empty((e,), dtype=torch.int32, device=dev)
    lib = load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    wide = wide_lobes(packed)
    args = (int(wide), table.data_ptr(), table.shape[0], *walk[:2], max_depth, ro.data_ptr(),
            rd.data_ptr(), beta.data_ptr(), alive.data_ptr(), u_rows.data_ptr(),
            *(t.data_ptr() for t in ev), live.data_ptr(), n, stream, *walk[2:])
    name = "sppm_photon_mega" + "_bvh" * (packed.bvh is not None) + "_wide" * wide
    return _launcher(lib, name, lib.sppm_photon_launch, args, lambda: (*ev, live != 0),
                     (packed, ro, rd, beta, alive, u_rows, ev, live))


class DepositInputs(NamedTuple):
    """The torch half of the deposit (deposit_inputs)."""

    events: torch.Tensor  # (E, EV_COLS) float32, Morton-sorted
    start: torch.Tensor  # (N,) int32: each VP's first sorted event
    end: torch.Tensor  # (N,) int32: one past its last (start == end: none)
    r2: torch.Tensor  # (N,) float32 radius^2, -1 for a VP that is not valid


def deposit_inputs(vp, radius, events, lo, diag):
    """Morton keys, the stable sort and the VP ranges, in float32 as the
    JAX package's deposit_mega computes them: a grid over the box lo +
    diag with cells of about the largest valid radius, at most
    GRID_RES_MAX a side; dead and out-of-grid events take the sentinel key
    and sort last, past every range."""
    ev_p, ev_wi, ev_beta, ev_live = events
    valid = vp.valid & (vp.beta > 0.0).any(-1)
    safe_diag = torch.where(diag == 0.0, 1.0, diag)
    max_diag = torch.clamp(diag.max(), min=1e-20)
    max_radius = torch.clamp(torch.where(valid, radius, 0.0).max(), min=1e-20)
    base_res = max_diag / max_radius
    res = torch.clamp((base_res * diag / max_diag).to(torch.int32), 1, GRID_RES_MAX)

    def cell_of(p):
        c = ((p - lo) / safe_diag * res.to(torch.float32)).to(torch.int32)
        inb = ((c >= 0) & (c < res)).all(-1)
        return torch.minimum(torch.clamp(c, min=0), res - 1), inb

    cell, inb = cell_of(ev_p)
    key = torch.where(ev_live & inb, morton3(cell), MORTON_SENTINEL)
    skey, order = torch.sort(key, stable=True)
    table = torch.cat([ev_p, ev_wi, ev_beta, ev_live[:, None].to(torch.float32)], -1)
    cmin, _ = cell_of(vp.p - radius[:, None])
    cmax, _ = cell_of(vp.p + radius[:, None])
    start = torch.searchsorted(skey, morton3(cmin))
    end = torch.searchsorted(skey, morton3(cmax), right=True)
    return DepositInputs(
        events=table[order].contiguous(),
        start=torch.where(valid, start, 0).to(torch.int32),
        end=torch.where(valid, end, 0).to(torch.int32),
        r2=torch.where(valid, radius * radius, -1.0),
    )


def deposit_mega(vp, radius, mats, events, lo, diag, wide=None):
    """phi (N, 3) and M (N,) int64 of one iteration: vp the VisiblePoints,
    radius (N,) their radii, mats the resolve_mat_tables rows, events the
    photon walk's (ev_p, ev_wi, ev_beta, ev_live), lo / diag (3,) the grid
    box.  The sort runs in torch (deposit_inputs); the range walk is the
    kernel on CUDA tensors (its wide instance, which evaluates the Disney
    lobes, where `mats` holds a lobe outside pmk.BASE_KINDS: mats_wide)
    and its plain version on CPU tensors.  `wide`, mats_wide(mats) taken
    once a render by a caller whose VPs come from a pack_sppm table (whose
    material ids it checked against the rows), spares the kernel's launch
    that choice and the check of the VPs' ids, each a read back to the
    host (prepare_deposit)."""
    inp = deposit_inputs(vp, radius, events, lo, diag)
    if vp.p.device.type == "cpu":
        return deposit_walk_reference(vp, mats, inp)
    return prepare_deposit(vp, mats, inp, wide)()


def mats_wide(mats) -> bool:
    """Whether the resolve_mat_tables rows `mats` hold a lobe outside
    pmk.BASE_KINDS (kind at column 16 + 16 l, l below the row's n_lobes
    at column 15): the deposit's wide instance then evaluates them."""
    rows = mats.detach().cpu()
    kinds = rows[:, 16::16][:, : pmk.LOBES_MAX]
    live = torch.arange(kinds.shape[1]) < rows[:, 15:16]
    base = torch.isin(kinds, torch.tensor(pmk.BASE_KINDS, dtype=kinds.dtype))
    return bool((live & ~base).any())


def prepare_deposit(vp, mats, inp, wide=None):
    """Check the CUDA inputs, build the outputs, and return launch() (the
    range walk's phi and M; the wide instance where `wide`).  With `wide`
    None it is mats_wide(mats), and the VPs' material ids are checked
    against the rows here; a caller that passes `wide` vouches for both
    (deposit_mega), so that the launch reads nothing back to the host."""
    dev = vp.p.device
    if dev.type != "cuda":
        raise ValueError(f"the SPPM deposit kernel runs on cuda tensors, not {dev}")
    n = vp.p.shape[0]
    if n == 0:
        raise ValueError("no visible points")
    for x, what in ((vp.p, "vp.p"), (vp.wo, "vp.wo"), (vp.ng, "vp.ng"), (vp.dpdu, "vp.dpdu")):
        _check(x, (n, 3), torch.float32, dev, what)
    _check(mats, (mats.shape[0], MAT_COLS), torch.float32, dev, "material rows")
    _check(inp.events, (inp.events.shape[0], EV_COLS), torch.float32, dev, "sorted events")
    mat = vp.mat.to(torch.int32).contiguous()
    if wide is None:
        if bool((mat < 0).any()) or bool((mat >= mats.shape[0]).any()):
            raise ValueError("VP material ids outside the material rows")
        wide = mats_wide(mats)
    phi = torch.empty((n, 3), dtype=torch.float32, device=dev)
    m = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = load_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (int(wide), vp.p.data_ptr(), vp.wo.data_ptr(), vp.ng.data_ptr(), vp.dpdu.data_ptr(),
            mat.data_ptr(), inp.r2.data_ptr(), inp.start.data_ptr(), inp.end.data_ptr(),
            inp.events.data_ptr(), mats.data_ptr(), mats.shape[0], phi.data_ptr(), m.data_ptr(), n,
            stream)
    return _launcher(lib, "sppm_deposit_mega" + "_wide" * wide, lib.sppm_deposit_launch, args,
                     lambda: (phi, m.to(torch.int64)), (vp, mat, mats, inp, phi, m))


# ---- the plain PyTorch versions ----


class SlotSampler:
    """get_1d / get_2d of the camera walk's slots, read from the slot
    matrix (the plain camera walk's sampler; pixel and sample ids unused)."""

    def __init__(self, u_halton, max_depth):
        self.u = u_halton
        self.rows = {}
        r = 0
        for slot, n in sppm_slots(max_depth):
            self.rows[slot] = r
            r += n

    def get_1d(self, pixel_id, sample_index, dim):
        return self.u[self.rows[dim]]

    def get_2d(self, pixel_id, sample_index, dim):
        r = self.rows[dim]
        return self.u[r : r + 2].T


def _lum(r, g, b):
    return LUM_R * r + LUM_G * g + LUM_B * b


def _hit_frame(table, best, found, d):
    """The hit row and its frame: (row, ng, dpdu, n_lob, ss, ts, wol)."""
    row = torch.where(found[:, None], table[best.clamp(min=0)], 0.0)
    ng = (row[:, 9], row[:, 10], row[:, 11])
    du = (row[:, 12], row[:, 13], row[:, 14])
    frame = pmk.shading_frame(*ng, *du)
    wo = tuple(-c for c in d)
    wol = (pmk._dot3(*wo, *frame[:3]), pmk._dot3(*wo, *frame[3:]), pmk._dot3(*wo, *ng))
    return row, ng, du, row[:, 15].to(torch.int64), frame, wol


def _bounce(row, n_lob, frame, ng, wol, ub0, ub1, active, work):
    """One BSDF sample: (new direction, f, pdf, ok)."""
    wsx, wsy, wsz, fs, pdf, _ = pmk._bsdf_sample(row, n_lob, *wol, ub0, ub1)
    pmk.tally_lobe(work, active, pmk._chosen_kind(row, n_lob, ub0), pdf=True)
    ssx, ssy, ssz, tsx, tsy, tsz = frame
    nw = (ssx * wsx + tsx * wsy + ng[0] * wsz, ssy * wsx + tsy * wsy + ng[1] * wsz,
          ssz * wsx + tsz * wsy + ng[2] * wsz)
    cosw = torch.abs(pmk._dot3(*nw, *ng))
    any_f = (fs[0] != 0.0) | (fs[1] != 0.0) | (fs[2] != 0.0)
    ok = active & (n_lob > 0) & (wol[2] != 0.0) & (pdf > 0.0) & any_f
    inv_pdf = cosw / torch.clamp(pdf, min=1e-20)
    return nw, [f * inv_pdf for f in fs], ok


def _next_origin(p, ng, nw, eps):
    off2 = torch.where(pmk._dot3(*nw, *ng) < 0.0, -eps, eps)
    return tuple(pc + nc * off2 for pc, nc in zip(p, ng))


def sppm_camera_mega_cam_reference(packed, cam_packed, pixel_xy, u_halton, max_depth, work=None):
    """Plain PyTorch version of `sppm_camera_mega_cam` (same arguments and
    return), on any device.  `work`, a dict, gets the counts of the
    triangle and box tests ("mt", "slab"), lobe evaluations ("lobe"), the
    Disney lobes' operations beyond them ("disney_ops", pmk.tally_lobe)
    and slot values read ("slot") the kernel performs on these inputs."""
    smp = SlotSampler(u_halton, max_depth)
    ray = pmk._raygen(pixel_xy[:, 0], pixel_xy[:, 1], None, None, smp, cam_packed)
    pmk.tally(work, "slot", torch.full_like(ray[0], 4.0))  # film and lens
    return camera_walk_reference(packed, ray[:3], ray[3:6], ray[6], smp, max_depth, work)


def sppm_camera_mega_reference(packed, o, d, cam_weight, u, max_depth, work=None):
    """Plain PyTorch version of `sppm_camera_mega` on its slot matrix u
    (slot_values; `work` as for the camera pass)."""
    return camera_walk_reference(packed, o.unbind(-1), d.unbind(-1), cam_weight.to(o.dtype),
                                 SlotSampler(u, max_depth), max_depth, work)


def camera_walk_reference(packed, o, d, weight, smp, max_depth, work=None):
    """The walk (`_camera_loop`) from rays o, d ((N,) x, y, z each) with
    weights (N,), its values read through the SlotSampler smp, over the
    kernel's geometry: the chunked walk, or the node64 rows (PlainGeometry
    with `cull`).  Returns (ld (N, 3), VisiblePoints)."""
    ox = o[0]
    dev = ox.device
    geom = pmk.PlainGeometry(packed, dev, work, cull=True)
    table = geom.table
    max_lobes = int(table[:, 15].max())
    n_lights = len(packed.light_p)
    light_p = torch.tensor(packed.light_p, dtype=torch.float32, device=dev)
    light_emit = torch.tensor(packed.light_emit, dtype=torch.float32, device=dev)
    active = weight > 0.0
    b0 = torch.where(active, weight, 0.0)
    b = [b0, b0, b0]
    zero = torch.zeros_like(ox)
    ld = [zero, zero, zero]
    vp = [zero] * 15  # p, wo, beta, ng, dpdu
    vp_mat = torch.zeros(ox.shape, dtype=torch.int64, device=dev)
    vp_valid = torch.zeros_like(active)
    for depth in range(max_depth):
        dim0 = sppm_dim0(depth)
        t, best = geom.closest(*o, *d, active)
        found = t < pmk.BIG_T
        active = active & found
        row, ng, du, n_lob, frame, wol = _hit_frame(table, best, found, d)
        p = tuple(oc + dc * t for oc, dc in zip(o, d))
        eps = 1e-4 + 1e-5 * (torch.abs(p[0]) + torch.abs(p[1]) + torch.abs(p[2]))

        # ---- NEE: one light picked uniformly ----
        u_pick = smp.get_1d(None, None, dim0 + SPPM_NEE)
        pmk.tally(work, "slot", active)
        li = torch.clamp((u_pick * n_lights).to(torch.int64), max=n_lights - 1)
        lp, le = light_p[li], light_emit[li]
        tl = (lp[:, 0] - p[0], lp[:, 1] - p[1], lp[:, 2] - p[2])
        dist2 = torch.clamp(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2], min=1e-20)
        inv_d = pmk._rsqrt(dist2)
        wi = tuple(c * inv_d for c in tl)
        wil_x, wil_y = pmk._dot3(*wi, *frame[:3]), pmk._dot3(*wi, *frame[3:])
        wi_ng = pmk._dot3(*wi, *ng)
        f_gate = ((wi_ng * wol[2]) > 0.0) & (wol[2] != 0.0)
        fn = [zero, zero, zero]
        for l in range(max_lobes):
            lob = pmk._lobe(row, 16 + 16 * l)
            lf = pmk._lobe_f(lob, *wol, wil_x, wil_y, wi_ng)
            use = f_gate & (l < n_lob)
            pmk.tally_lobe(work, active & use, lob["kind"], pdf=False)
            fn = [fn[c] + torch.where(use, lf[c], 0.0) for c in range(3)]
        off = torch.where(wi_ng < 0.0, -eps, eps)
        so = tuple(pc + nc * off for pc, nc in zip(p, ng))
        occ = geom.occluded(*so, *(lp[:, c] - so[c] for c in range(3)), 1.0 - SHADOW_EPSILON,
                            active)
        li_scale = torch.where(active & ~occ, torch.abs(wi_ng) * n_lights / dist2, 0.0)
        ld = [ld[c] + b[c] * fn[c] * le[:, c] * li_scale for c in range(3)]

        # ---- the VP: the first diffuse vertex, or glossy at the last depth ----
        diffuse = torch.zeros_like(active)
        glossy = torch.zeros_like(active)
        for l in range(max_lobes):
            kind = row[:, 16 + 16 * l].to(torch.int64)
            live = l < n_lob
            diffuse = diffuse | (live & torch.isin(kind, torch.tensor(DIFFUSE_KINDS, device=dev)))
            glossy = glossy | (live & torch.isin(kind, torch.tensor(GLOSSY_KINDS, device=dev)))
        make_vp = active & (diffuse | (glossy & (depth == max_depth - 1)))
        rec = (*p, *(-c for c in d), *b, *ng, *du)
        vp = [torch.where(make_vp, r, v) for r, v in zip(rec, vp)]
        vp_mat = torch.where(make_vp, row[:, MAT_COL].to(torch.int64), vp_mat)
        vp_valid = vp_valid | make_vp
        active = active & ~make_vp
        if depth >= max_depth - 1:
            break

        # ---- BSDF sample and the camera roulette ----
        ub = smp.get_2d(None, None, dim0 + SPPM_BSDF)
        pmk.tally(work, "slot", 2 * active)
        nw, fw, ok = _bounce(row, n_lob, frame, ng, wol, ub[:, 0], ub[:, 1], active, work)
        bn = [b[c] * fw[c] for c in range(3)]
        y = _lum(*bn)
        u_rr = smp.get_1d(None, None, dim0 + SPPM_RR)
        rr = ok & (y < 0.25)
        pmk.tally(work, "slot", rr)  # the roulette value is read only here
        cont_p = torch.clamp(y, max=1.0)
        killed = rr & (u_rr > cont_p)
        inv_cont = 1.0 / torch.clamp(cont_p, min=1e-9)
        bn = [torch.where(rr, c * inv_cont, c) for c in bn]
        active = active & ok & ~killed
        b = [torch.where(active, bn[c], b[c]) for c in range(3)]
        o = tuple(torch.where(active, a, c) for a, c in zip(_next_origin(p, ng, nw, eps), o))
        d = tuple(torch.where(active, a, c) for a, c in zip(nw, d))
    v3 = lambda k: torch.stack(vp[3 * k : 3 * k + 3], -1)
    return torch.stack(ld, -1), VisiblePoints(v3(0), v3(1), v3(2), vp_mat, v3(3), v3(4), vp_valid)


def sppm_photon_mega_reference(packed, ro, rd, beta, active, u_rows, max_depth, work=None):
    """Plain PyTorch version of `sppm_photon_mega` (same arguments and
    return), on any device, over the kernel's geometry (the chunked walk,
    or the node64 rows: PlainGeometry with `cull`); `work` as for the
    camera walk, "slot" the bounce and roulette uniforms read."""
    geom = pmk.PlainGeometry(packed, ro.device, work, cull=True)
    table = geom.table
    o, d, b = ro.unbind(-1), rd.unbind(-1), list(beta.unbind(-1))
    active = active.clone()
    events = []
    for depth in range(max_depth):
        t, best = geom.closest(*o, *d, active)
        found = t < pmk.BIG_T
        active = active & found
        p = tuple(oc + dc * t for oc, dc in zip(o, d))
        if depth > 0:
            rec = torch.stack([*p, *(-c for c in d), *b], -1)
            events.append((torch.where(active[:, None], rec, 0.0), active))
        if depth >= max_depth - 1:
            break
        row, ng, _, n_lob, frame, wol = _hit_frame(table, best, found, d)
        nw, fw, ok = _bounce(row, n_lob, frame, ng, wol, u_rows[3 * depth],
                             u_rows[3 * depth + 1], active, work)
        pmk.tally(work, "slot", 2 * active + ok)  # the roulette's only where ok
        bn = [b[c] * fw[c] for c in range(3)]
        # photon roulette (sppm.rs:497-505)
        q = torch.clamp(1.0 - _lum(*bn) / torch.clamp(_lum(*b), min=1e-20), min=0.0)
        active = ok & ~(u_rows[3 * depth + 2] < q)
        inv_cont = 1.0 / torch.clamp(1.0 - q, min=1e-9)
        b = [torch.where(active, bn[c] * inv_cont, b[c]) for c in range(3)]
        eps = 1e-4 + 1e-5 * (torch.abs(p[0]) + torch.abs(p[1]) + torch.abs(p[2]))
        o = tuple(torch.where(active, a, c) for a, c in zip(_next_origin(p, ng, nw, eps), o))
        d = tuple(torch.where(active, a, c) for a, c in zip(nw, d))
    rec = torch.cat([e[0] for e in events])
    return rec[:, 0:3], rec[:, 3:6], rec[:, 6:9], torch.cat([e[1] for e in events])


def deposit_mega_reference(vp, radius, mats, events, lo, diag, work=None):
    """Plain PyTorch version of `deposit_mega` (same arguments and
    return): deposit_inputs, then `deposit_walk_reference`."""
    return deposit_walk_reference(vp, mats, deposit_inputs(vp, radius, events, lo, diag), work)


def deposit_walk_reference(vp, mats, inp, work=None):
    """The range walk on DepositInputs, step j adding every VP's j-th event
    of its range: phi accumulates one event at a time in range order, as
    the kernel adds them.  The VPs are ordered by range length, longest
    first, so step j works on the prefix of VPs still walking.  `work`
    gets the (VP, event) pairs walked ("pair") and the lobe evaluations of
    the near pairs ("lobe", and "disney_ops" as for the camera walk)."""
    dev = vp.p.device
    n = vp.p.shape[0]
    length = (inp.end - inp.start).to(torch.int64)
    order = torch.argsort(length, descending=True, stable=True)
    asc = length.sort().values
    k_max = int(asc[-1]) if n else 0
    walking = (n - torch.searchsorted(asc, torch.arange(k_max, device=dev), right=True)).tolist()
    pmk.tally(work, "pair", length)
    # per VP, in that order: its frame, wo in it, material rows, radius^2
    ng = vp.ng[order].unbind(-1)
    ss_ts = pmk.shading_frame(*ng, *vp.dpdu[order].unbind(-1))
    wo = vp.wo[order].unbind(-1)
    wol = (pmk._dot3(*wo, *ss_ts[:3]), pmk._dot3(*wo, *ss_ts[3:]), pmk._dot3(*wo, *ng))
    p = vp.p[order]
    mrow = mats[vp.mat[order]]
    max_lobes = int(mats[:, 15].max())
    start, r2 = inp.start[order].to(torch.int64), inp.r2[order]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    m = torch.zeros((n,), dtype=torch.int64, device=dev)
    for j, w in enumerate(walking):
        ev = inp.events[start[:w] + j]
        dd = [p[:w, c] - ev[:, c] for c in range(3)]
        d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
        near = (d2 <= r2[:w]) & (ev[:, 9] > 0.0)
        g = tuple(c[:w] for c in ng)
        f = tuple(c[:w] for c in ss_ts)
        wl = tuple(c[:w] for c in wol)
        wi = (ev[:, 3], ev[:, 4], ev[:, 5])
        wi_ng = wi[0] * g[0] + wi[1] * g[1] + wi[2] * g[2]
        gate = near & ((wi_ng * wl[2]) > 0.0) & (wl[2] != 0.0)
        m[:w] = m[:w] + near
        # the lobes of the gated pairs alone (the others add nothing)
        v = torch.nonzero(gate).squeeze(1)
        if not v.numel():
            continue
        fr = _lobe_sum(ev[v], tuple(c[v] for c in f), tuple(c[v] for c in wl), wi_ng[v], mrow[v],
                       max_lobes, work)
        acc[v] = acc[v] + torch.stack([fr[c] * ev[v, 6 + c] for c in range(3)], -1)
    phi = torch.empty_like(acc)
    phi[order] = acc
    m_out = torch.empty_like(m)
    m_out[order] = m
    return phi, m_out


def _lobe_sum(ev, frame, wol, wi_ng, rows, max_lobes, work):
    """f(wo, wi) of gated pairs, one a lane: the event rows ev (its wi in
    columns 3-5), the VPs' shading frame (ss, ts), wo in it, wi . ng and
    material rows; summed over each row's lobes in order (the kernel's
    lobe loop)."""
    wi = (ev[:, 3], ev[:, 4], ev[:, 5])
    wil_x = wi[0] * frame[0] + wi[1] * frame[1] + wi[2] * frame[2]
    wil_y = wi[0] * frame[3] + wi[1] * frame[4] + wi[2] * frame[5]
    zero = torch.zeros_like(wil_x)
    fr = [zero, zero, zero]
    for l in range(max_lobes):
        lob = pmk._lobe(rows, 16 + 16 * l)
        lf = pmk._lobe_f(lob, *wol, wil_x, wil_y, wi_ng)
        use = l < rows[:, 15]
        pmk.tally_lobe(work, use, lob["kind"], pdf=False)
        fr = [fr[c] + torch.where(use, lf[c], 0.0) for c in range(3)]
    return fr


def deposit_warp_walk(vp, mats, inp, work=None):
    """The deposit kernel's walk on DepositInputs, warp by warp, in float32
    on any device: its twin for the tests (csrc/sppm_megakernel.cu
    sppm_deposit_kernel).  Lanes are the VPs in pixel order, pmk.WARP to a
    warp, the last warp's lanes past N empty.  A lane whose range is empty
    gets phi 0 and M 0 and reads nothing.  A warp's walking lanes read tiles
    of WARP rows, each starting at the lowest row past the last tile that
    one of their ranges holds.  In a tile each lane first tests the rows of
    its own range in ascending order, counting M and adding 0 * beta for
    each pair it does not shade, then adds f * beta for the pairs it shades,
    in ascending order.  Returns (phi (N, 3), M (N,) int64), which equal
    deposit_walk_reference's wherever the events' beta is finite.  `work`
    gets the VP records read ("vp_read"), the event rows the warps read
    ("row_read"), the (VP, event) pairs walked ("pair") and the lobe
    passes the warps run ("shade_warp": per tile its busiest lane's shaded
    pairs) beside the rows where some lane shades ("shade_union": what
    one lobe pass per walked row would run)."""
    dev = vp.p.device
    n = vp.p.shape[0]
    warp = pmk.WARP
    n_warps = -(-n // warp)
    lane_pad = n_warps * warp - n
    first = torch.nn.functional.pad(inp.start.to(torch.int64), (0, lane_pad))
    last = torch.nn.functional.pad(inp.end.to(torch.int64), (0, lane_pad))
    walking = first < last
    lanes = walking.reshape(n_warps, warp)
    hi = torch.where(lanes, last.reshape(n_warps, warp), 0).amax(1)
    pmk.tally(work, "vp_read", walking)
    pmk.tally(work, "pair", torch.where(walking, last - first, 0))
    w = torch.nonzero(walking).squeeze(1)  # the walking lanes, each a VP below N
    s, e, wid = first[w], last[w], w // warp
    # each walking warp's next tile: the lowest row at or past `row` that a range holds
    big = int(hi.max()) + 1 if w.numel() else 1

    def next_tile(row):
        need = torch.where(e > row[wid], torch.maximum(s, row[wid]), big)
        return torch.full((n_warps,), big, dtype=torch.int64, device=dev).scatter_reduce(
            0, wid, need, "amin")

    base = next_tile(torch.zeros((n_warps,), dtype=torch.int64, device=dev))
    # the walking lanes' records: p, frame, wo in it, material row, radius^2
    p = vp.p[w]
    ng = vp.ng[w].unbind(-1)
    frame = pmk.shading_frame(*ng, *vp.dpdu[w].unbind(-1))
    wo = vp.wo[w].unbind(-1)
    wol = (pmk._dot3(*wo, *frame[:3]), pmk._dot3(*wo, *frame[3:]), pmk._dot3(*wo, *ng))
    mrow, r2 = mats[vp.mat[w]], inp.r2[w]
    max_lobes = int(mats[:, 15].max())
    acc = torch.zeros((w.shape[0], 3), dtype=torch.float32, device=dev)
    m = torch.zeros((w.shape[0],), dtype=torch.int64, device=dev)
    while w.numel():
        live = base < hi
        if not bool(live.any()):
            break
        pmk.tally(work, "row_read", torch.where(live, torch.clamp(hi - base, max=warp), 0))
        shade = []
        for r in range(warp):
            k = base[wid] + r
            v = torch.nonzero((s <= k) & (k < e)).squeeze(1)  # k < hi where a lane holds it
            ev = inp.events[k[v]]
            dd = [p[v, c] - ev[:, c] for c in range(3)]
            d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
            near = (d2 <= r2[v]) & (ev[:, 9] > 0.0)
            g = tuple(c[v] for c in ng)
            wo_z = wol[2][v]
            wi_ng = ev[:, 3] * g[0] + ev[:, 4] * g[1] + ev[:, 5] * g[2]
            gate = near & ((wi_ng * wo_z) > 0.0) & (wo_z != 0.0)
            m[v] = m[v] + near
            zero = v[~gate]
            acc[zero] = acc[zero] + 0.0 * ev[~gate, 6:9]
            shade.append((v[gate], ev[gate], wi_ng[gate]))
        busiest = torch.zeros((w.shape[0],), dtype=torch.int64, device=dev)
        for v, ev, wi_ng in shade:  # ascending rows: each lane's shaded pairs in order
            if not v.numel():
                continue
            busiest[v] += 1
            pmk.tally(work, "shade_union", torch.ones((1,), dtype=torch.int64).expand(
                int(torch.unique(wid[v]).numel())))
            fr = _lobe_sum(ev, tuple(c[v] for c in frame), tuple(c[v] for c in wol), wi_ng,
                           mrow[v], max_lobes, work)
            acc[v] = acc[v] + torch.stack([fr[c] * ev[:, 6 + c] for c in range(3)], -1)
        pmk.tally(work, "shade_warp", torch.zeros((n_warps,), dtype=torch.int64,
                                                  device=dev).scatter_reduce(0, wid, busiest,
                                                                             "amax"))
        base = torch.where(live, next_tile(base + warp), base)
    phi = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    m_out = torch.zeros((n,), dtype=torch.int64, device=dev)
    phi[w], m_out[w] = acc, m
    return phi, m_out
