"""Fused Debug / DirectLighting sample pass: camera raygen + the specular
tree, one CUDA kernel (rs_ray_toy_tpu/ops/direct_megakernel.py, camera
variants: brute force and the in-kernel BVH).

`li_levels_mega_cam` runs the reference's recursive tree per camera ray
(intersect_debug.rs:56-89, directlighting.rs:17-133,
integrator/mod.rs:150-301): at every node the closest hit, the Debug
integrator's flat 0.1 base, point-light NEE with an any-hit shadow ray
(every light once, or one light picked by a 1-D sample), then
a reflect child (DEBUG_SPECULAR cosine sample or SPEC_REFL mirror) and a
transmit child (SPEC_TRANS refraction).  The estimator is the JAX
kernel's (`_kernel_cam` -> `_raygen` + `_chain_loop`), sample slot for
sample slot: a node with branch id b reads its slots from
8 + b*257, its reflect child is 2b+1 and its transmit child 2b+2.
`unsupported_feature` pins the subset (supports_direct).
`li_levels_mega` runs the same tree on given rays (o, d, weight: the JAX
package's `li_levels_mega`, its `_kernel` / `_kernel_bvh`).

On a CUDA tensor the wrapper launches csrc/direct_megakernel.cu (built by
ops/_build.py) or raises; brute force takes the chunked walk over
`PackedScene.chunks` (csrc/common.cuh ChunkGeometry, K1's and K6's brute
force: a chunk's rows are tested only where its padded box is hit), over a
BVH the kernel walks its node64 rows and 48-byte leaf rows
(`BvhTables.nodes64`, `prims`, `root_count`; the path kernel's BVH walk,
csrc/common.cuh Bvh64Geometry); the plain version walks the same
(PlainGeometry with `cull`), and finds the same hits as the walk over
every row.  On a CPU tensor it runs
`li_levels_mega_cam_reference` (`li_levels_mega_reference` on given
rays), the plain PyTorch version: the tree
unrolled over static branch ids on flat (N,) tensors with masked lanes,
radiance summed in the kernel's visiting order (a node, its reflect
subtree, its transmit subtree).  The scene table, the camera bundle, the
parameter block and the geometry (brute force or BVH) are the path
kernel's (ops/path_megakernel.py).
"""

import ctypes
from typing import Optional

import numpy as np
import torch

from ..bsdf.lobes import (
    LOBE_DEBUG_DIFFUSE,
    LOBE_DEBUG_SPECULAR,
    LOBE_LAMBERT_REFL,
    LOBE_MF_REFL,
    LOBE_SPEC_REFL,
    LOBE_SPEC_TRANS,
)
from ..config import ONE_MINUS_EPSILON, PI, SHADOW_EPSILON
from . import path_megakernel as pmk

DEPTH_MAX = 8  # tree levels; branch ids stay inside the u32 sampler dims
TREE_DEPTH_MAX = 6  # with transmission the tree is binary: 2^5 - 1 nodes
# kinds the NEE machinery evaluates (SPEC_TRANS only spawns children)
NEE_KINDS = (
    LOBE_LAMBERT_REFL,
    LOBE_MF_REFL,
    LOBE_DEBUG_DIFFUSE,
    LOBE_DEBUG_SPECULAR,
    LOBE_SPEC_REFL,
)

# Kernel launches made by li_levels_mega_cam and li_levels_mega, by kernel
# (camera or given rays; brute force, BVH); the one piece of module state.
LAUNCHES = {"direct_mega_cam": 0, "direct_mega_cam_bvh": 0, "direct_mega": 0,
            "direct_mega_bvh": 0}


def unsupported_feature(scene, spec, sampler) -> Optional[str]:
    """Name of the first scene feature outside the kernel's subset, or
    None when the direct kernel renders the job exactly."""
    if spec.kind not in ("debug", "direct"):
        return f"{spec.kind} integrator"
    if not 1 <= spec.max_depth <= DEPTH_MAX:
        return f"max_depth {spec.max_depth} outside 1..{DEPTH_MAX}"
    reason = pmk.scene_unsupported(scene, sampler, NEE_KINDS + (LOBE_SPEC_TRANS,))
    if reason is not None:
        return reason
    mats, tri = scene.materials, scene.triangles
    used = np.unique(tri.mat[tri.mat >= 0])
    trans = any(
        mats["kind"][m, l] == LOBE_SPEC_TRANS for m in used for l in range(mats["n_lobes"][m])
    )
    if trans and spec.max_depth > TREE_DEPTH_MAX:
        return f"max_depth {spec.max_depth} with transmission (up to {TREE_DEPTH_MAX})"
    return None


def supports(scene, spec, sampler) -> bool:
    """Static host check: can the direct kernel render this job exactly?"""
    return unsupported_feature(scene, spec, sampler) is None


def tree_shape(packed, spec):
    """(debug, strategy_all, max_depth, can_chain, has_st) of the tree:
    a reflect child exists only with a DEBUG_SPECULAR or SPEC_REFL lobe,
    a transmit child only with SPEC_TRANS, and without a reflect lobe the
    depth is cut to 2 (li_levels_mega_cam)."""
    kinds = set(packed.kinds_present)
    can_chain = bool(kinds & {LOBE_DEBUG_SPECULAR, LOBE_SPEC_REFL})
    has_st = LOBE_SPEC_TRANS in kinds
    max_depth = spec.max_depth if can_chain else min(spec.max_depth, 2)
    debug = spec.kind == "debug"
    strategy_all = debug or spec.light_strategy == "all"
    return debug, strategy_all, max_depth, can_chain, has_st


def load_kernel():
    """The direct kernel's library (built on first use): the camera entry
    `direct_mega_cam_launch` and the rays-in entry `direct_mega_rays_launch`,
    both taking after the common arguments the chunk rows of a brute-force
    table and their count (null and 0 with a BVH), then the BVH's
    root_count; over a BVH the common arguments' two node tables are the
    node64 rows (null for a tree that is one leaf) and the leaf rows
    (pmk.geometry_args with `node64`)."""
    extra = pmk._CHUNK_ARGS + (ctypes.c_int,)
    lib = pmk.load_library("direct_megakernel", "direct_mega_cam", extra)
    lib.direct_mega_rays_launch.restype = ctypes.c_int
    lib.direct_mega_rays_launch.argtypes = pmk.RAYS_LAUNCH_ARGS + list(extra)
    lib.direct_mega_occupancy.restype = None
    lib.direct_mega_occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


def occupancy(bvh=True):
    """The last BVH (or, `bvh` False, chunked brute-force) launch of the
    direct kernel: its block size, blocks resident per SM, registers per
    thread and dynamic shared memory bytes, as the library chose and
    measured them (choose_block)."""
    out = (ctypes.c_int * 4)()
    load_kernel().direct_mega_occupancy(int(bvh), out)
    return dict(zip(("block", "blocks_per_sm", "registers", "smem"), out))


def li_levels_mega_cam(packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec):
    """One fused Debug / DirectLighting sample pass: camera rays + tree.

    packed: pack_scene's.  pixel_xy: (N, 2) float32 integer raster
    coordinates (the film jitter, sampler slot 0, is applied inside);
    pixel_id: (N,) integer pixel ids; s_idx: sample indices, (N,) or a
    scalar.  Returns (L (N, 3), weight (N,)).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if pixel_xy.device.type == "cpu":
        return li_levels_mega_cam_reference(
            packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec
        )
    return prepare_launch(packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec)()


def _tree_params(packed, cam_packed, sampler, spec):
    """The parameter block of a launch (no camera on given rays)."""
    prm = pmk._kernel_params(packed, cam_packed, sampler, spec)
    debug, strategy_all, max_depth, can_chain, has_st = tree_shape(packed, spec)
    if not 1 <= max_depth <= DEPTH_MAX:
        raise ValueError(f"max_depth {max_depth} outside 1..{DEPTH_MAX}")
    prm.max_depth = max_depth
    prm.debug, prm.strategy_all = int(debug), int(strategy_all)
    prm.can_chain, prm.has_st = int(can_chain), int(has_st)
    return prm


def prepare_launch(packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec):
    """Check the CUDA inputs, build the parameter block and the outputs,
    and return launch(): one kernel launch on the current stream
    returning (L, weight).  Relaunching rewrites the same outputs."""
    prm = _tree_params(packed, cam_packed, sampler, spec)
    return pmk.launcher(
        load_kernel(), "direct_mega_cam", packed, pixel_xy, pixel_id, s_idx, prm, LAUNCHES,
        extra=(*pmk.chunk_args(packed, pixel_xy.device), pmk.root_count(packed)), node64=True,
    )


def li_levels_mega(packed, o, d, cam_weight, pixel_id, s_idx, sampler, spec):
    """The tree on given rays (kernel #6 of the JAX package,
    `li_levels_mega`): o, d (N, 3) float32, cam_weight (N,) (a ray with
    weight <= 0 is not traced), pixel_id (N,) integer pixel ids, s_idx (N,)
    or a scalar.  A given ray's origin is used as it is.  Returns L (N, 3).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        return li_levels_mega_reference(packed, o, d, cam_weight, pixel_id, s_idx, sampler, spec)
    return prepare_rays_launch(packed, o, d, cam_weight, pixel_id, s_idx, sampler, spec)()


def prepare_rays_launch(packed, o, d, cam_weight, pixel_id, s_idx, sampler, spec):
    """launch() of the rays-in kernel on the current stream, returning L;
    every accepted launch adds one to LAUNCHES["direct_mega"] (or
    ["direct_mega_bvh"])."""
    if o.device.type != "cuda":
        raise ValueError(f"the direct_mega kernel runs on cuda tensors, not {o.device}")
    prm = _tree_params(packed, None, sampler, spec)
    return pmk.rays_launcher(load_kernel(), "direct_mega", packed, o, d, cam_weight, pixel_id,
                             s_idx, prm, LAUNCHES,
                             extra=(*pmk.chunk_args(packed, o.device), pmk.root_count(packed)),
                             node64=True)


# ---- the plain PyTorch version ----


def _lobe_f_dbg(lob, wo, wi):
    """NEE f of one lobe (_lobe_f_dbg): lambert and TR microfacet as in the
    path kernel, DEBUG_DIFFUSE the constant (0, 1, 0); DEBUG_SPECULAR and
    the specular kinds 0."""
    f = pmk._lobe_f(lob, *wo, *wi)
    is_ds = lob["kind"] == LOBE_DEBUG_SPECULAR
    return [torch.where(is_ds, 0.0, f[c]) for c in range(3)]


def _select_matching(row, n_lob, max_lobes, kinds):
    """The last live lobe whose kind is in `kinds`, and whether there is one
    (fields are zero where there is none)."""
    lob, has = None, torch.zeros_like(n_lob, dtype=torch.bool)
    for l in range(max_lobes):
        cand = pmk._lobe(row, 16 + 16 * l)
        sel = (l < n_lob) & (
            (cand["kind"] == kinds[0]) | (cand["kind"] == kinds[-1])
        )
        if lob is None:
            lob = {k: _pick(sel, v, 0) for k, v in cand.items()}
        else:
            lob = {k: _pick(sel, v, lob[k]) for k, v in cand.items()}
        has = has | sel
    return lob, has


def _pick(sel, v, other):
    if isinstance(v, tuple):
        other = other if isinstance(other, tuple) else (other,) * 3
        return tuple(torch.where(sel, v[c], other[c]) for c in range(3))
    return torch.where(sel, v, other)


def li_levels_mega_cam_reference(
    packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec, work=None
):
    """Plain PyTorch version of `li_levels_mega_cam` (same arguments and
    return), on any device.  `work`, a dict, gets the counts of the
    triangle and box tests ("mt", "slab") and lobe evaluations ("lobe")
    that the kernel performs on these inputs (0-d tensors)."""
    n = pixel_xy.shape[0]
    pid = pixel_id.to(torch.int64)
    sid = pmk._sample_indices(s_idx, n, pixel_xy.device)
    ray = pmk._raygen(pixel_xy[:, 0], pixel_xy[:, 1], pid, sid, sampler, cam_packed)
    return tree_reference(packed, ray[:6], ray[6], pid, sid, sampler, spec, work), ray[6]


def li_levels_mega_reference(packed, o, d, cam_weight, pixel_id, s_idx, sampler, spec,
                             work=None):
    """Plain PyTorch version of `li_levels_mega` (same arguments and
    return; `work` as for the camera pass)."""
    pid = pixel_id.to(torch.int64)
    sid = pmk._sample_indices(s_idx, o.shape[0], o.device)
    return tree_reference(packed, (*o.unbind(-1), *d.unbind(-1)), cam_weight, pid, sid,
                          sampler, spec, work)


def tree_reference(packed, ray, weight, pid, sid, sampler, spec, work=None):
    """The tree (`_chain_loop`) from rays (ox, oy, oz, dx, dy, dz) of
    (N,) float32 with weights (N,); pid and sid (N,) int64.  Returns L
    (N, 3).  Brute force walks the chunks (the kernel's ChunkGeometry), and
    `work` gets that walk's counts beside those of the walk over every row
    (pmk.chunk_walk)."""
    ox, oy, oz, dx, dy, dz = ray
    dev = ox.device
    geom = pmk.PlainGeometry(packed, dev, work, cull=True)
    table = geom.table
    debug, strategy_all, max_depth, can_chain, has_st = tree_shape(packed, spec)
    max_lobes = int(table[:, 15].max())
    n_lights = len(packed.light_p)
    light_p = torch.tensor(packed.light_p, dtype=torch.float32, device=dev)
    light_emit = torch.tensor(packed.light_emit, dtype=torch.float32, device=dev)
    zero = torch.zeros_like(ox)
    L = [zero, zero, zero]

    def visit(ray, beta, branch, depth):
        ox, oy, oz, dx, dy, dz = ray
        br, bg, bb = beta
        dim_base = 8 + branch * 257
        alive = (br != 0.0) | (bg != 0.0) | (bb != 0.0)
        t, best = geom.closest(ox, oy, oz, dx, dy, dz, alive)
        live = alive & (t < pmk.BIG_T)
        row = torch.where(live[:, None], table[best.clamp(min=0)], 0.0)
        ngx, ngy, ngz = row[:, 9], row[:, 10], row[:, 11]
        n_lob = row[:, 15].to(torch.int64)
        ssx, ssy, ssz, tsx, tsy, tsz = pmk.shading_frame(
            ngx, ngy, ngz, row[:, 12], row[:, 13], row[:, 14]
        )
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        wox, woy, woz = -dx, -dy, -dz
        wol_x = pmk._dot3(wox, woy, woz, ssx, ssy, ssz)
        wol_y = pmk._dot3(wox, woy, woz, tsx, tsy, tsz)
        wo_z = pmk._dot3(wox, woy, woz, ngx, ngy, ngz)
        mag = torch.abs(px) + torch.abs(py) + torch.abs(pz)
        eps = 1e-4 + 1e-5 * mag

        def estimate(lp, le):
            """estimate_direct for one point light (mod.rs:403-470)."""
            tlx, tly, tlz = lp[0] - px, lp[1] - py, lp[2] - pz
            dist2 = torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=1e-20)
            inv_d = pmk._rsqrt(dist2)
            wix, wiy, wiz = tlx * inv_d, tly * inv_d, tlz * inv_d
            wil_x = pmk._dot3(wix, wiy, wiz, ssx, ssy, ssz)
            wil_y = pmk._dot3(wix, wiy, wiz, tsx, tsy, tsz)
            wi_ng = pmk._dot3(wix, wiy, wiz, ngx, ngy, ngz)
            gate = ((wi_ng * wo_z) > 0.0) & (wo_z != 0.0)
            fr = [zero, zero, zero]
            for l in range(max_lobes):
                lf = _lobe_f_dbg(
                    pmk._lobe(row, 16 + 16 * l), (wol_x, wol_y, wo_z), (wil_x, wil_y, wi_ng)
                )
                use = gate & (l < n_lob)
                pmk.tally(work, "lobe", live & use)
                fr = [fr[c] + torch.where(use, lf[c], 0.0) for c in range(3)]
            # f == 0 gives 0 whether or not the light is occluded: the
            # kernel casts no shadow ray for it
            lit = live & ((fr[0] != 0.0) | (fr[1] != 0.0) | (fr[2] != 0.0))
            off = torch.where(wi_ng < 0.0, -eps, eps)
            sox, soy, soz = px + ngx * off, py + ngy * off, pz + ngz * off
            occ = geom.occluded(
                sox, soy, soz, lp[0] - sox, lp[1] - soy, lp[2] - soz, 1.0 - SHADOW_EPSILON, lit
            )
            s = torch.where(lit & ~occ, torch.abs(wi_ng) / dist2, 0.0)
            return [fr[c] * le[c] * s for c in range(3)]

        lvl = [torch.full_like(ox, 0.1) if debug else zero] * 3
        if strategy_all:  # uniform_sample_all_lights (mod.rs:304-355)
            # one sample per light: a point light's n_samples is 1; each
            # takes (u_light, u_scatter), unread for delta lights
            for j in range(n_lights):
                e = estimate(packed.light_p[j], packed.light_emit[j])
                lvl = [lvl[c] + e[c] for c in range(3)]
            dim_child = dim_base + 2 * n_lights
        else:  # uniform_sample_one_light (mod.rs:359-401)
            u_pick = sampler.get_1d(pid, sid, dim_base)
            li = torch.clamp((u_pick * n_lights).to(torch.int64), max=n_lights - 1)
            e = estimate(light_p[li].unbind(-1), light_emit[li].unbind(-1))
            lvl = [lvl[c] + e[c] * n_lights for c in range(3)]
            dim_child = dim_base + 3
        L[:] = [L[c] + torch.where(live, (br, bg, bb)[c] * lvl[c], 0.0) for c in range(3)]

        if depth + 1 >= max_depth:
            return

        def child(ws, fs, pdf, has_m, ci):
            """Child tail (integrator/mod.rs:162-176): beta = f |wi.n| /
            pdf, the origin offset to the sampled side."""
            wsx, wsy, wsz = ws
            nwx = ssx * wsx + tsx * wsy + ngx * wsz
            nwy = ssy * wsx + tsy * wsy + ngy * wsz
            nwz = ssz * wsx + tsz * wsy + ngz * wsz
            dn = pmk._dot3(nwx, nwy, nwz, ngx, ngy, ngz)
            cosw = torch.abs(dn)
            any_f = (fs[0] != 0.0) | (fs[1] != 0.0) | (fs[2] != 0.0)
            ok = live & has_m & (wo_z != 0.0) & (pdf > 0.0) & (cosw != 0.0) & any_f
            scale = cosw / torch.clamp(pdf, min=1e-20)
            cb = tuple(torch.where(ok, b * f * scale, 0.0) for b, f in zip(beta, fs))
            off2 = torch.where(dn < 0.0, -eps, eps)
            ray = (px + ngx * off2, py + ngy * off2, pz + ngz * off2, nwx, nwy, nwz)
            return ray, cb, 2 * branch + 1 + ci

        children = []
        if can_chain:  # reflect child: sample_f over SPECULAR|REFLECTION
            lob, has_m = _select_matching(
                row, n_lob, max_lobes, (LOBE_DEBUG_SPECULAR, LOBE_SPEC_REFL)
            )
            pmk.tally(work, "lobe", live & has_m)
            ub = sampler.get_2d(pid, sid, dim_child)
            is_ds = has_m & (lob["kind"] == LOBE_DEBUG_SPECULAR)
            is_sr = has_m & (lob["kind"] == LOBE_SPEC_REFL)
            # DEBUG_SPECULAR: cosine sample, f = (0, 0, 1)
            dxo, dyo = pmk._concentric_disk(torch.clamp(ub[:, 0], max=ONE_MINUS_EPSILON), ub[:, 1])
            z_cos = torch.sqrt(torch.clamp(1.0 - dxo * dxo - dyo * dyo, min=0.0))
            z_cos = torch.where(wo_z < 0.0, -z_cos, z_cos)
            # SPEC_REFL: the mirror direction, f = R Fr / |cos|
            ws = (
                torch.where(is_sr, -wol_x, dxo),
                torch.where(is_sr, -wol_y, dyo),
                torch.where(is_sr, wo_z, z_cos),
            )
            cos_pdf = torch.where((wo_z * ws[2]) > 0.0, torch.abs(ws[2]) / PI, 0.0)
            aci = torch.clamp(torch.abs(ws[2]), min=1e-20)
            fr3 = pmk._fresnel(lob, ws[2])
            fs = [
                torch.where(is_sr, lob["s0"][c] * fr3[c] / aci, 1.0 if c == 2 else 0.0)
                for c in range(3)
            ]
            fs = [torch.where(is_sr | is_ds, f, 0.0) for f in fs]
            pdf = torch.where(is_sr, 1.0, torch.where(is_ds, cos_pdf, 0.0))
            children.append(child(ws, fs, pdf, has_m, 0))
        if has_st:  # transmit child: SpecularTransmission::sample_f
            lob, has_m = _select_matching(row, n_lob, max_lobes, (LOBE_SPEC_TRANS,))
            pmk.tally(work, "lobe", live & has_m)
            ea, eb = lob["eta_a"], lob["eta_b"]
            entering = wo_z > 0.0
            ei = torch.where(entering, ea, eb)
            et = torch.where(entering, eb, ea)
            eta_rel = ei / torch.clamp(et, min=1e-9)
            abs_cz = torch.abs(wo_z)
            sin2_t = eta_rel * eta_rel * torch.clamp(1.0 - abs_cz * abs_cz, min=0.0)
            st_ok = sin2_t < 1.0  # total internal reflection gate
            cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
            nz_sign = torch.where(entering, 1.0, -1.0)
            ws = (
                -eta_rel * wol_x,
                -eta_rel * wol_y,
                -eta_rel * wo_z + (eta_rel * abs_cz - cos_t) * nz_sign,
            )
            scale_t = (ei * ei) / torch.clamp(et * et, min=1e-20)
            fr_t = pmk._fr_dielectric(ws[2], ea, eb)
            aci = torch.clamp(torch.abs(ws[2]), min=1e-20)
            fac = torch.where(st_ok, (1.0 - fr_t) * scale_t / aci, 0.0)
            fs = [lob["s0"][c] * fac for c in range(3)]
            children.append(child(ws, fs, torch.where(st_ok, 1.0, 0.0), has_m, 1))
        for ray, cb, b in children:
            visit(ray, cb, b, depth + 1)

    b0 = torch.where(weight > 0.0, 1.0, 0.0)
    visit((ox, oy, oz, dx, dy, dz), (b0, b0, b0), 0, 1)
    return torch.stack(L, dim=-1)
