"""Fused Volpath sample pass: camera raygen + the volumetric bounce loop,
one CUDA kernel (rs_ray_toy_tpu/ops/volpath_megakernel.py, camera
variants: brute force and the in-kernel BVH).

`li_volpath_mega_cam` runs a whole Volpath sample pass per camera ray in
one camera medium (volpath.rs:48-258): the closest hit, then the medium
sampled over the segment to it, or over 2 * world_radius + 1000 for a ray
that hits nothing (such a ray still scatters in the fog); at the vertex,
a medium point or a surface, one light picked by power (its CDF baked at
pack time), a light sample, the phase function or the non-specular
lobes toward it, the MIS power heuristic against the phase / mean lobe
pdf for a sphere light, an any-hit shadow ray and the fog's transmittance
along it; then an HG or BSDF sample of the next direction, the etaScale
factor and Russian roulette after bounce 3.  Homogeneous media sample and
attenuate in closed form; grid media run delta tracking for the vertex and
ratio tracking for the shadow segment on a hashed per-ray RNG chain
(scene/medium.py).  The estimator is the JAX kernel's (`_kernel_vol_cam`
-> `_raygen` + `_vol_bounce_loop`), sample slot for sample slot, on its
subset, which `unsupported_feature` pins: one camera medium, no
per-primitive interfaces, triangles, the path kernel's lobes, point and
(homogeneous media only) sphere lights, the stratified sampler.
`li_volpath_mega` runs the same loop on given rays (o, d, weight: the JAX
package's `li_volpath_mega`, its `_kernel_vol` / `_kernel_vol_bvh`), every
ray starting in the camera medium.  The
scattering-sampling half of estimate_direct is statically zero there (no
emissive primitives, no infinite lights), so neither version draws for it.

On a CUDA tensor the wrapper launches csrc/volpath_megakernel.cu (built
by ops/_build.py) or raises; over a BVH the kernel walks its node64 rows
and 48-byte leaf rows (`BvhTables.nodes64`, `prims`, `root_count`; the
path kernel's BVH walk, csrc/common.cuh Bvh64Geometry), which the plain
version walks too (PlainGeometry); on a brute-force table the kernel takes the
chunked walk (csrc/common.cuh ChunkGeometry over the packed scene's
chunks), which finds the hits of the walk over every row, so the medium's
draws and the radiance are that walk's (`every_row=True` launches it, for
the comparison).  On a CPU tensor it runs
`li_volpath_mega_cam_reference`, the plain PyTorch version: the path
kernel's raygen and then `vol_bounce_loop_reference` on those rays (on
given rays `li_volpath_mega_reference`, the loop alone), over
flat (N,) tensors with masked lanes (the chunked walk, as the kernel, on a
brute-force table: PlainGeometry with cull), with the medium building blocks of
scene/medium.py and the light sampling of lights/lights.py.  The grid
density is read in float32 (the TPU kernel's bf16 hi/lo one-hot taps were
a TPU device; the JAX package's jnp path is the reference for grid media).
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..config import DTYPE
from ..core import rng
from ..core.sampling import Distribution1D, power_heuristic
from ..lights import lights as lmod
from ..sampler.dims import VOL_LIGHT, VOL_NEXT, VOL_PICK, VOL_RR, volpath_dim0
from ..scene import medium as med
from ..scene.types import LIGHT_POINT, has_interfaces
from . import path_megakernel as pmk

DEPTH_MAX = pmk.DEPTH_MAX

# Kernel launches made by li_volpath_mega_cam and li_volpath_mega, by kernel
# (camera or given rays; brute force, BVH); the one piece of module state.
LAUNCHES = {"volpath_mega_cam": 0, "volpath_mega_cam_bvh": 0, "volpath_mega": 0,
            "volpath_mega_bvh": 0}


class PackedVolpath(NamedTuple):
    scene: pmk.PackedScene  # the path kernel's triangle table, lights and BVH
    medium: dict  # scene/medium.pack_mediums of the camera medium, on the device
    light_kind: tuple  # per light, LIGHT_*
    sph_o2w: tuple  # per light, the 12 floats of its sphere's object-to-world rows
    sph_w2o: tuple  # per light, the 9 floats of the inverse's 3x3 part
    sph_radius: tuple  # per light
    cdf: tuple  # the power distribution's CDF, n_lights + 1 float32 values
    pick_pdf: tuple  # per light, its pick probability, float32
    world_radius: float  # float32 value

    # the geometry readers (PlainGeometry, the launcher) take either package
    @property
    def table(self):
        return self.scene.table

    @property
    def bvh(self):
        return self.scene.bvh

    @property
    def chunks(self):
        return self.scene.chunks

    @property
    def grid(self):
        return int(self.medium["kind"][0]) == med.MEDIUM_GRID


def unsupported_feature(scene, spec, sampler):
    """Name of the first scene feature outside the kernel's subset, or
    None when the Volpath kernel renders the job exactly (the JAX
    package's supports_volpath: camera medium 0, the only medium, and no
    per-primitive interface)."""
    if spec.kind != "volpath":
        return f"{spec.kind} integrator"
    if not 1 <= spec.max_depth <= DEPTH_MAX:
        return f"max_depth {spec.max_depth} outside 1..{DEPTH_MAX}"
    if has_interfaces(scene.triangles, scene.spheres):
        return "per-primitive media interfaces (medium_interface)"
    if scene.camera_medium < 0:
        return "Volpath without a camera medium"
    if len(scene.mediums) != 1:
        return "participating media other than one camera medium"
    lk = np.asarray(scene.lights.kind)
    if scene.mediums[0].kind == "grid" and np.any(lk != LIGHT_POINT):
        return "grid media with lights other than point lights"
    return pmk.scene_unsupported(scene, sampler, pmk.BASE_KINDS, volpath=True)


def supports(scene, spec, sampler) -> bool:
    """Static host check: can the Volpath kernel render this job exactly?"""
    return unsupported_feature(scene, spec, sampler) is None


def pack_volpath(scene, device, bvh=None) -> PackedVolpath:
    """pack_scene's table (BVH as there) plus the camera medium, the
    sphere-light constants and the power distribution, whose CDF and pick
    pdfs are computed in float64 and cast to float32 as the JAX package's
    pack_volpath does."""
    lights = scene.lights
    dist = Distribution1D(lmod.power(lights))
    f32 = lambda a: tuple(float(v) for v in np.asarray(a, np.float32).ravel())
    return PackedVolpath(
        scene=pmk.pack_scene(scene, device, bvh),
        medium=med.pack_mediums([scene.mediums[scene.camera_medium]], device),
        light_kind=tuple(int(k) for k in lights.kind),
        sph_o2w=tuple(f32(m[:3, :4]) for m in lights.sph_o2w),
        sph_w2o=tuple(f32(m[:3, :3]) for m in lights.sph_w2o),
        sph_radius=f32(lights.sph_radius),
        cdf=f32(dist.cdf),
        pick_pdf=f32(dist.pick_pdf()),
        world_radius=float(lights.world_radius),
    )


# ---- the CUDA kernel ----


class _VolParams(ctypes.Structure):
    """Mirror of `struct VolParams` in csrc/volpath_megakernel.cu."""

    _fields_ = [
        ("light_kind", ctypes.c_int * pmk.LIGHT_MAX),
        ("sph_o2w", ctypes.c_float * (pmk.LIGHT_MAX * 12)),
        ("sph_w2o", ctypes.c_float * (pmk.LIGHT_MAX * 9)),
        ("sph_radius", ctypes.c_float * pmk.LIGHT_MAX),
        ("cdf", ctypes.c_float * (pmk.LIGHT_MAX + 1)),
        ("pick_pdf", ctypes.c_float * pmk.LIGHT_MAX),
        ("all_point", ctypes.c_int),
        ("seg_escape", ctypes.c_float),
        ("sigma_s", ctypes.c_float * 3),
        ("sigma_t", ctypes.c_float * 3),
        ("g", ctypes.c_float),
        ("grid", ctypes.c_int),
        ("nx", ctypes.c_int),
        ("ny", ctypes.c_int),
        ("nz", ctypes.c_int),
        ("w2m", ctypes.c_float * 12),
        ("inv_max", ctypes.c_float),
    ]


def _vol_params(packed):
    """The kernel's medium and light block; escape length folded in
    float64 (2 * world_radius + 1000) and rounded once, as the plain
    version folds it."""
    v = _VolParams()
    n = len(packed.light_kind)
    for k in range(n):
        v.light_kind[k] = packed.light_kind[k]
        v.sph_radius[k] = packed.sph_radius[k]
        v.pick_pdf[k] = packed.pick_pdf[k]
        for j in range(12):
            v.sph_o2w[12 * k + j] = packed.sph_o2w[k][j]
        for j in range(9):
            v.sph_w2o[9 * k + j] = packed.sph_w2o[k][j]
    for k, c in enumerate(packed.cdf):
        v.cdf[k] = c
    v.all_point = int(all(k == LIGHT_POINT for k in packed.light_kind))
    v.seg_escape = 2.0 * packed.world_radius + 1000.0
    m = {k: packed.medium[k][0].tolist()
         for k in ("sigma_s", "sigma_t", "g", "dims", "w2m", "inv_max_density")}
    for c in range(3):
        v.sigma_s[c] = m["sigma_s"][c]
        v.sigma_t[c] = m["sigma_t"][c]
    v.g = m["g"]
    v.grid = int(packed.grid)
    v.nz, v.ny, v.nx = m["dims"]
    for j in range(12):
        v.w2m[j] = m["w2m"][j // 4][j % 4]
    v.inv_max = m["inv_max_density"]
    return v


def load_kernel():
    """The Volpath kernel's library (built on first use): the camera entry
    `volpath_mega_cam_launch` and the rays-in entry
    `volpath_mega_rays_launch`, both taking after the common arguments the
    medium block, the density grid, the chunk rows of a brute-force table
    and their count, and last the BVH's root_count; over a BVH the common
    arguments' two node tables are the node64 rows (null for a tree that
    is one leaf) and the leaf rows (pmk.geometry_args with `node64`)."""
    vol_args = ((ctypes.POINTER(_VolParams), ctypes.c_void_p) + pmk._CHUNK_ARGS
                + (ctypes.c_int,))
    lib = pmk.load_library("volpath_megakernel", "volpath_mega_cam", vol_args)
    lib.volpath_mega_cam_vol_params_size.restype = ctypes.c_int
    if lib.volpath_mega_cam_vol_params_size() != ctypes.sizeof(_VolParams):
        raise RuntimeError("volpath_megakernel medium block differs from _VolParams")
    lib.volpath_mega_rays_launch.restype = ctypes.c_int
    lib.volpath_mega_rays_launch.argtypes = pmk.RAYS_LAUNCH_ARGS + list(vol_args)
    lib.volpath_mega_occupancy.restype = None
    lib.volpath_mega_occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


def occupancy(bvh=False):
    """The last chunked (or, with `bvh`, BVH) launch of the Volpath
    kernel: its block size, blocks resident per SM, registers per thread
    and dynamic shared memory bytes, as the library chose and measured them
    (choose_block)."""
    out = (ctypes.c_int * 4)()
    load_kernel().volpath_mega_occupancy(int(bvh), out)
    return dict(zip(("block", "blocks_per_sm", "registers", "smem"), out))


def li_volpath_mega_cam(packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec):
    """One fused Volpath sample pass: camera rays + bounce loop.

    packed: pack_volpath's.  pixel_xy: (N, 2) float32 integer raster
    coordinates (the film jitter, sampler slot 0, is applied inside);
    pixel_id: (N,) integer pixel ids; s_idx: sample indices, (N,) or a
    scalar.  Returns (L (N, 3), weight (N,)).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if pixel_xy.device.type == "cpu":
        return li_volpath_mega_cam_reference(
            packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec
        )
    return prepare_launch(packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec)()


def _launch_params(packed, cam_packed, sampler, spec, dev):
    """(Params, VolParams, the grid density or None) of a launch on `dev`."""
    if not 1 <= spec.max_depth <= DEPTH_MAX:
        raise ValueError(f"max_depth {spec.max_depth} outside 1..{DEPTH_MAX}")
    prm = pmk._kernel_params(packed.scene, cam_packed, sampler, spec)
    vprm = _vol_params(packed)
    density = None
    if packed.grid:
        density = packed.medium["density"][0]
        if (
            density.device != dev
            or density.dtype != torch.float32
            or not density.is_contiguous()
            or tuple(density.shape) != (vprm.nz, vprm.ny, vprm.nx)
        ):
            raise ValueError(
                f"grid density must be contiguous float32 ({vprm.nz}, {vprm.ny}, {vprm.nx}) "
                f"on {dev}"
            )
    return prm, vprm, density


def _geometry_extra(packed, dev, every_row):
    """The arguments a launch passes after the density grid: the chunk rows
    and their count (none for the walk over every row, `every_row`, or a
    BVH; pmk.chunk_args checks them) and the BVH's root_count."""
    if every_row:
        if packed.bvh is not None:
            raise ValueError("the walk over every row is brute force's")
        return None, 0, 0
    return (*pmk.chunk_args(packed.scene, dev), pmk.root_count(packed.scene))


def prepare_launch(packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec,
                   every_row=False):
    """Check the CUDA inputs, build the parameter blocks and the outputs,
    and return launch(): one kernel launch on the current stream
    returning (L, weight).  Relaunching rewrites the same outputs.  A
    brute-force table takes the chunked walk, or with `every_row` the walk
    over every row; a BVH the walk of its node64 rows."""
    dev = pixel_xy.device
    prm, vprm, density = _launch_params(packed, cam_packed, sampler, spec, dev)
    return pmk.launcher(
        load_kernel(), "volpath_mega_cam", packed, pixel_xy, pixel_id, s_idx, prm, LAUNCHES,
        extra=(ctypes.byref(vprm), density, *_geometry_extra(packed, dev, every_row)),
        node64=True,
    )


def li_volpath_mega(packed, o, d, cam_weight, pixel_id, s_idx, sampler, spec):
    """The bounce loop on given rays (kernel #8 of the JAX package,
    `li_volpath_mega`): o, d (N, 3) float32 (d unit length), cam_weight
    (N,) (a ray with weight <= 0 is not traced), pixel_id (N,) integer
    pixel ids, s_idx (N,) or a scalar; every ray starts in the camera
    medium.  Returns L (N, 3).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        return li_volpath_mega_reference(packed, o, d, cam_weight, pixel_id, s_idx, sampler,
                                         spec)
    return prepare_rays_launch(packed, o, d, cam_weight, pixel_id, s_idx, sampler, spec)()


def prepare_rays_launch(packed, o, d, cam_weight, pixel_id, s_idx, sampler, spec,
                        every_row=False):
    """launch() of the rays-in kernel on the current stream, returning L;
    every accepted launch adds one to LAUNCHES["volpath_mega"] (or
    ["volpath_mega_bvh"]); `every_row` as for prepare_launch."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"the volpath_mega kernel runs on cuda tensors, not {dev}")
    prm, vprm, density = _launch_params(packed, None, sampler, spec, dev)
    return pmk.rays_launcher(load_kernel(), "volpath_mega", packed.scene, o, d, cam_weight,
                             pixel_id, s_idx, prm, LAUNCHES,
                             extra=(ctypes.byref(vprm), density,
                                    *_geometry_extra(packed, dev, every_row)),
                             node64=True)


# ---- the plain PyTorch version ----


def li_volpath_mega_cam_reference(
    packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec, work=None
):
    """Plain PyTorch version of `li_volpath_mega_cam` (same arguments and
    return), on any device: raygen, then `vol_bounce_loop_reference`.
    `work`, a dict, gets the counts of the triangle and box tests ("mt",
    "slab"), lobe evaluations ("lobe") and tracking steps ("track") that
    the kernel performs on these inputs (0-d tensors)."""
    dev = pixel_xy.device
    n = pixel_xy.shape[0]
    pid = pixel_id.to(torch.int64)
    sid = pmk._sample_indices(s_idx, n, dev)
    ox, oy, oz, dx, dy, dz, weight = pmk._raygen(
        pixel_xy[:, 0], pixel_xy[:, 1], pid, sid, sampler, cam_packed
    )
    o = torch.stack([ox, oy, oz], -1)
    d = torch.stack([dx, dy, dz], -1)
    L = vol_bounce_loop_reference(packed, o, d, weight > 0.0, pid, sid, sampler, spec, work)
    return L, weight


def li_volpath_mega_reference(packed, o, d, cam_weight, pixel_id, s_idx, sampler, spec,
                              work=None):
    """Plain PyTorch version of `li_volpath_mega` (same arguments and
    return; `work` as for the camera pass)."""
    sid = pmk._sample_indices(s_idx, o.shape[0], o.device)
    return vol_bounce_loop_reference(packed, o, d, cam_weight > 0.0, pixel_id, sid, sampler,
                                     spec, work)


def vol_bounce_loop_reference(packed, o, d, active, pid, sid, sampler, spec, work=None):
    """The bounce loop (`_vol_bounce_loop`) on given rays: o, d (N, 3)
    float32 (d unit length), active (N,) bool, pid and sid (N,) integer
    u32 values.  Returns L (N, 3)."""
    dev = o.device
    geom = pmk.PlainGeometry(packed, dev, work, cull=True)
    table = geom.table
    max_lobes = int(table[:, 15].max())
    mediums = {k: (t.to(dev) if isinstance(t, torch.Tensor) else t)
               for k, t in packed.medium.items()}
    g = mediums["g"][0]
    scene = packed.scene
    n_lights = len(packed.light_kind)
    all_point = all(k == LIGHT_POINT for k in packed.light_kind)
    lights = lmod.light_table(
        packed.light_kind, scene.light_p, scene.light_emit, packed.sph_o2w, packed.sph_w2o,
        packed.sph_radius, dev,
    )
    pick_pdf = torch.tensor(packed.pick_pdf, dtype=DTYPE, device=dev)
    seg_escape = 2.0 * packed.world_radius + 1000.0
    pid = pid.to(torch.int64)
    sid = sid.to(torch.int64)

    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    one = torch.ones_like(ox)
    br, bg, bb = one, one, one
    Lr = Lg = Lb = torch.zeros_like(ox)
    es = one  # etaScale (volpath.rs:180-194)
    state = rng.hash_combine(pid, sid)  # the per-ray chain of the medium draws
    for bounce in range(spec.max_depth):
        dim0 = volpath_dim0(bounce)
        t, best = geom.closest(ox, oy, oz, dx, dy, dz, active)
        found = active & (t < pmk.BIG_T)
        row = torch.where(found[:, None], table[best.clamp(min=0)], 0.0)
        ngx, ngy, ngz = row[:, 9], row[:, 10], row[:, 11]
        n_lob = row[:, 15].to(torch.int64)
        mat_eta = row[:, 31]

        # ---- the medium over the segment (volpath.rs:70-85) ----
        seg_len = torch.where(found, t, seg_escape)
        med_id = torch.where(active, 0, -1)
        o3 = torch.stack([ox, oy, oz], -1)
        d3 = torch.stack([dx, dy, dz], -1)
        beta_m, in_medium, t_med, state = med.medium_sample(
            mediums, med_id, o3, d3, seg_len, state, work
        )
        br = torch.where(active, br * beta_m[:, 0], br)
        bg = torch.where(active, bg * beta_m[:, 1], bg)
        bb = torch.where(active, bb * beta_m[:, 2], bb)
        active = active & ((br > 0.0) | (bg > 0.0) | (bb > 0.0))
        active = active & (found | in_medium)

        # the vertex: a medium point or the surface hit
        psx, psy, psz = ox + dx * t, oy + dy * t, oz + dz * t
        px = torch.where(in_medium, ox + dx * t_med, psx)
        py = torch.where(in_medium, oy + dy * t_med, psy)
        pz = torch.where(in_medium, oz + dz * t_med, psz)
        surf_valid = active & ~in_medium & found
        ssx, ssy, ssz, tsx, tsy, tsz = pmk.shading_frame(
            ngx, ngy, ngz, row[:, 12], row[:, 13], row[:, 14]
        )
        wox, woy, woz = -dx, -dy, -dz
        wol_x = pmk._dot3(wox, woy, woz, ssx, ssy, ssz)
        wol_y = pmk._dot3(wox, woy, woz, tsx, tsy, tsz)
        wo_z = pmk._dot3(wox, woy, woz, ngx, ngy, ngz)

        # ---- NEE: power pick + estimate_direct with media (volpath.rs:101-127) ----
        u_pick = sampler.get_1d(pid, sid, dim0 + VOL_PICK)
        li_idx = torch.zeros_like(pid)
        for i in range(1, n_lights):
            li_idx = torch.where(u_pick >= packed.cdf[i], i, li_idx)
        ppdf = pick_pdf[li_idx]
        if all_point:
            # delta lights only: no light sample is drawn, weight 1
            lp = lights.p[li_idx]
            le = lights.emit[li_idx]
            tlx, tly, tlz = lp[:, 0] - px, lp[:, 1] - py, lp[:, 2] - pz
            dist2 = torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=1e-20)
            inv_d = pmk._rsqrt(dist2)
            wix, wiy, wiz = tlx * inv_d, tly * inv_d, tlz * inv_d
            li = [le[:, c] / dist2 for c in range(3)]
            ls_pdf = one
            lpx, lpy, lpz = lp[:, 0], lp[:, 1], lp[:, 2]
        else:
            ul = sampler.get_2d(pid, sid, dim0 + VOL_LIGHT)
            (wix, wiy, wiz), li, ls_pdf, (lpx, lpy, lpz), delta = lmod.sample_li(
                lights, li_idx, px, py, pz, ul[:, 0], ul[:, 1]
            )
        # the phase function at medium vertices, the non-specular lobes
        # times |cos| at surfaces; MIS against the phase pdf or the mean
        # non-specular lobe pdf
        wil_x = pmk._dot3(wix, wiy, wiz, ssx, ssy, ssz)
        wil_y = pmk._dot3(wix, wiy, wiz, tsx, tsy, tsz)
        wi_ng = pmk._dot3(wix, wiy, wiz, ngx, ngy, ngz)
        f_gate = ((wi_ng * wo_z) > 0.0) & (wo_z != 0.0)
        zero = torch.zeros_like(px)
        fn = [zero, zero, zero]
        pdf_scat_s = zero
        n_nonspec = torch.zeros_like(n_lob)
        for l in range(max_lobes):
            lob = pmk._lobe(row, 16 + 16 * l)
            m_l = (l < n_lob) & ~pmk._is_spec(lob["kind"])
            lf = pmk._lobe_f(lob, wol_x, wol_y, wo_z, wil_x, wil_y, wi_ng)
            use = f_gate & m_l
            pmk.tally(work, "lobe", surf_valid & use)
            fn = [fn[c] + torch.where(use, lf[c], 0.0) for c in range(3)]
            if not all_point:
                lpdf = pmk._lobe_pdf(lob, wol_x, wol_y, wo_z, wil_x, wil_y, wi_ng)
                pmk.tally(work, "lobe", surf_valid & m_l)
                pdf_scat_s = pdf_scat_s + torch.where(m_l, lpdf, 0.0)
            n_nonspec = n_nonspec + m_l
        cos_ns = torch.abs(wi_ng)
        p_phase = med.phase_hg(pmk._dot3(wox, woy, woz, wix, wiy, wiz), g)
        f = [torch.where(in_medium, p_phase, fn[c] * cos_ns) for c in range(3)]
        if all_point:
            weight = 1.0
        else:
            pdf_scat_s = torch.where(
                (wo_z != 0.0) & (n_nonspec > 0),
                pdf_scat_s / torch.clamp(n_nonspec, min=1).to(DTYPE),
                0.0,
            )
            scattering_pdf = torch.where(in_medium, p_phase, pdf_scat_s)
            weight = torch.where(delta, 1.0, power_heuristic(ls_pdf, scattering_pdf))
        nee_valid = active & (in_medium | (surf_valid & (n_nonspec > 0)))
        any_li = (li[0] > 0.0) | (li[1] > 0.0) | (li[2] > 0.0)
        any_f = (f[0] > 0.0) | (f[1] > 0.0) | (f[2] > 0.0)
        live = nee_valid & (ls_pdf > 0.0) & any_li & any_f

        # the shadow ray: from a surface offset along ng toward the light,
        # from a medium point in place
        mag = torch.abs(px) + torch.abs(py) + torch.abs(pz)
        eps = 1e-4 + 1e-5 * mag
        off = torch.where(wi_ng < 0.0, -eps, eps)
        sox = torch.where(in_medium, px, px + ngx * off)
        soy = torch.where(in_medium, py, py + ngy * off)
        soz = torch.where(in_medium, pz, pz + ngz * off)
        svx, svy, svz = lpx - sox, lpy - soy, lpz - soz
        seg = torch.sqrt(svx * svx + svy * svy + svz * svz)
        inv_seg = 1.0 / torch.clamp(seg, min=1e-20)
        sdx, sdy, sdz = svx * inv_seg, svy * inv_seg, svz * inv_seg
        t_sh = torch.where(live, 1.0 - 1e-4, 0.0) * seg
        occ = geom.occluded(sox, soy, soz, sdx, sdy, sdz, t_sh, live)
        # the fog's transmittance along the whole segment; grid media track
        # it on every active lane, live or not (the chain stays in step
        # with the JAX package's)
        tr, state = med.medium_tr(
            mediums, torch.where(active, 0, -1), torch.stack([sox, soy, soz], -1),
            torch.stack([sdx, sdy, sdz], -1), seg, state, work,
        )
        vis = live & ~occ
        inv_pp = 1.0 / torch.clamp(ppdf, min=1e-20)
        scale = weight * inv_pp / torch.clamp(ls_pdf, min=1e-20)
        Lr = Lr + torch.where(vis, br * f[0] * li[0] * tr[:, 0] * scale, 0.0)
        Lg = Lg + torch.where(vis, bg * f[1] * li[1] * tr[:, 1] * scale, 0.0)
        Lb = Lb + torch.where(vis, bb * f[2] * li[2] * tr[:, 2] * scale, 0.0)

        # ---- the next direction: HG at medium points, the BSDF at surfaces ----
        ub = sampler.get_2d(pid, sid, dim0 + VOL_NEXT)
        hg, _ = med.hg_sample(torch.stack([wox, woy, woz], -1), g, ub)
        wsx, wsy, wsz, fs, pdf, transmitted = pmk._bsdf_sample(
            row, n_lob, wol_x, wol_y, wo_z, ub[:, 0], ub[:, 1]
        )
        pmk.tally(work, "lobe", surf_valid)
        nwx = ssx * wsx + tsx * wsy + ngx * wsz
        nwy = ssy * wsx + tsy * wsy + ngy * wsz
        nwz = ssz * wsx + tsz * wsy + ngz * wsz
        cosw = torch.abs(pmk._dot3(nwx, nwy, nwz, ngx, ngy, ngz))
        any_fs = (fs[0] != 0.0) | (fs[1] != 0.0) | (fs[2] != 0.0)
        ok_surf = surf_valid & (n_lob > 0) & (wo_z != 0.0) & (pdf > 0.0) & any_fs
        inv_pdf = cosw / torch.clamp(pdf, min=1e-20)
        br = torch.where(ok_surf, br * fs[0] * inv_pdf, br)
        bg = torch.where(ok_surf, bg * fs[1] * inv_pdf, bg)
        bb = torch.where(ok_surf, bb * fs[2] * inv_pdf, bb)
        ndx = torch.where(in_medium, hg[:, 0], nwx)
        ndy = torch.where(in_medium, hg[:, 1], nwy)
        ndz = torch.where(in_medium, hg[:, 2], nwz)
        active = active & (in_medium | ok_surf)
        e2 = mat_eta * mat_eta
        eta_fac = torch.where(wo_z > 0.0, e2, 1.0 / torch.clamp(e2, min=1e-20))
        es = torch.where(active & ~in_medium & transmitted, es * eta_fac, es)

        # the next origin: a medium point in place, a surface offset along
        # ng to the sampled side
        off2 = torch.where(pmk._dot3(ndx, ndy, ndz, ngx, ngy, ngz) < 0.0, -eps, eps)
        ox = torch.where(active, torch.where(in_medium, px, psx + ngx * off2), ox)
        oy = torch.where(active, torch.where(in_medium, py, psy + ngy * off2), oy)
        oz = torch.where(active, torch.where(in_medium, pz, psz + ngz * off2), oz)
        dx = torch.where(active, ndx, dx)
        dy = torch.where(active, ndy, dy)
        dz = torch.where(active, ndz, dz)

        # ---- Russian roulette (volpath.rs:238-250) on beta * etaScale ----
        if bounce > 3:
            beta_max = torch.maximum(br, torch.maximum(bg, bb)) * es
            do_rr = active & (beta_max < spec.rr_threshold)
            q = torch.clamp(1.0 - beta_max, min=0.05)
            u_rr = sampler.get_1d(pid, sid, dim0 + VOL_RR)
            killed = do_rr & (u_rr < q)
            active = active & ~killed
            surv = do_rr & ~killed
            inv_q = 1.0 / torch.clamp(1.0 - q, min=1e-9)
            br = torch.where(surv, br * inv_q, br)
            bg = torch.where(surv, bg * inv_q, bg)
            bb = torch.where(surv, bb * inv_q, bb)

    return torch.stack([Lr, Lg, Lb], dim=-1)
