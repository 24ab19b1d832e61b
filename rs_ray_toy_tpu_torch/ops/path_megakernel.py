"""Fused Path sample pass: camera raygen (or given rays) + bounce loop, one
CUDA kernel (rs_ray_toy_tpu/ops/path_megakernel.py: the camera variants
_kernel_cam / _kernel_cam_bvh and the rays-in variants _kernel /
_kernel_bvh, brute force and the in-kernel BVH).

`li_path_mega_cam` runs a whole sample pass per camera ray: every
sampler slot (the stratified sampler's hash, or a HaltonSampler's
values, computed per pass by `HaltonSampler.slot_matrix` and read from
an (NC, N) matrix, one row per component of each slot `used_slots`
lists), the lens trace, Moller-Trumbore
closest hit over the triangle table min-combined with up to SPH_MAX full
spheres, NEE with an any-hit shadow ray (point lights alone: the delta
form; with sphere or environment lights the power-heuristic MIS of
estimate_direct and, for the environment, the BSDF sample whose ray
escapes toward it), one BSDF sample (lambert, Trowbridge-Reitz
microfacet, specular reflection, fresnel-specular glass, and the Disney
diffuse, retro, sheen, clearcoat and microfacet lobes of a constant
DisneyMaterial) with the etaScale factor, for a scene in one subsurface
Disney material its specular transmission lobe and the BSSRDF branch
(the probe chain, the exit's NEE and its cosine direction: K5 f,
`subsurface_reference`), for a matte whose kd is an image texture the
textured instances' kd (K5 g: differential lens rays, the first hit's
footprints into K7's EWA tap, level 0's bilinear tap after;
`textured_kd_reference`), Russian roulette after bounce 3, and with
`infinite_lights` the escape radiance at bounce 0 or after a specular
bounce, one step past max_depth.  `li_path_mega` runs the same bounce
loop on given rays.  The estimator is the JAX kernel's (`_raygen` +
`_bounce_loop`), sample slot for sample slot, on its subset of up to 8
full spheres, point and sphere lights and one constant environment,
under the stratified or the Halton sampler; on a mesh with smooth vertex
normals (`mesh_smooth`) the shading normal is interpolated from the
winner's raw vertex normals at its rebuilt barycentrics, and ng is
faced onto it (`supports` pins that subset).  Up to TRI_MAX triangles the
hits are brute force; above it (or when `pack_scene` is asked to) the
table is reordered into the leaf order of a BVH and every hit walks the
tree per ray (accel/bvh.py), up to BVH_TRI_MAX triangles: its node64 rows
and 48-byte leaf rows (`BvhTables.nodes64`, `prims`; csrc/common.cuh
Bvh64, `walk_node64` in the plain version).

On a CUDA tensor the wrappers launch csrc/path_megakernel.cu (built by
ops/_build.py) or raise.  On a CPU tensor they run
`li_path_mega_cam_reference` / `li_path_mega_reference`, the plain
PyTorch version, which mirrors the kernel expression by expression over
flat (N,) tensors with masked lanes.  Nothing else selects the path.

Scene tables are baked per triangle and per sphere (`pack_scene`): the
material indirection collapses to lobe columns on each row, in the JAX
package's (T, 115) layout, so a packed table can be compared column by
column; the light and environment constants ride in the parameter blocks.
The kernel library and its parameter block (`_Params`) are shared with
ops/direct_megakernel.py: the device code lives in csrc/common.cuh.
"""

import ctypes
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..accel.bvh import (LEAF_COUNT_BITS, STACK_DEPTH, build_bvh, pack_bvh_tables,
                         pack_node64_tables, tree_depth)
from ..bsdf.lobes import (
    DIST_DISNEY_SEPARABLE_G,
    DIST_TROWBRIDGE_REITZ,
    FRESNEL_CONDUCTOR,
    FRESNEL_DISNEY,
    LOBE_DEBUG_DIFFUSE,
    LOBE_DEBUG_SPECULAR,
    LOBE_DISNEY_CLEARCOAT,
    LOBE_DISNEY_DIFFUSE,
    LOBE_DISNEY_FAKE_SS,
    LOBE_DISNEY_MICROFACET_REFL,
    LOBE_DISNEY_RETRO,
    LOBE_DISNEY_SHEEN,
    LOBE_FRESNEL_SPEC,
    LOBE_LAMBERT_REFL,
    LOBE_LAMBERT_TRANS,
    LOBE_MF_REFL,
    LOBE_MF_TRANS,
    LOBE_OREN_NAYAR,
    LOBE_SPEC_REFL,
    LOBE_SPEC_TRANS,
    MAX_LOBES,
)
from ..bsdf.eval import (  # noqa: F401 (the lobe helpers, shared with the other kernels)
    _bsdf_sample,
    _chosen_kind,
    _fr_dielectric,
    _fresnel,
    _is_spec,
    _lobe,
    _lobe_f,
    _lobe_pdf,
    shading_frame,
)
from ..bsdf.microfacet import roughness_to_alpha
from ..config import DTYPE, ONE_MINUS_EPSILON, PI, SHADOW_EPSILON
from ..core.sampling import concentric_sample_disk as _concentric_disk  # noqa: F401
from ..core.sampling import power_heuristic
from ..core.vec import div as _div
from ..core.vec import dot3 as _dot3
from ..core.vec import rsqrt as _rsqrt
from ..sampler.dims import (
    CAMERA_FILM,
    CAMERA_LENS,
    PATH_BSDF,
    PATH_BSS_OUT,
    PATH_BSS_PICK,
    PATH_BSS_PROBE_1D,
    PATH_BSS_PROBE_2D,
    PATH_NEE,
    PATH_RR,
    path_dim0,
)
from ..sampler.halton import HaltonSampler
from ..scene.mipmap import bilerp_level, ewa_lookup, pyramid
from ..scene.textures import map_uv
from ..scene.types import AREA_SHAPE_SPHERE, LIGHT_DIFFUSE_AREA, LIGHT_INFINITE, LIGHT_POINT
from . import _build
from .texture import _TexMap, tex_map

TRI_EPS = 1e-7
SPH_EPS = 1e-4
TRI_MAX = 2048  # brute force up to here
BVH_TRI_MAX = 65536  # the in-kernel BVH up to here (MEGA_BVH_TRI_MAX)
BVH_LEAF = 16  # requested leaf size of the kernels' BVH
GEO_COLS = 9  # a triangle row's intersect columns: p0, e1, e2
PRIM_COLS = 12  # a node64 walk's leaf row: p0, e1, e2, pad (48 bytes)
LOBES_MAX = 5
NRM_COL = 16 + 16 * LOBES_MAX  # raw vertex normals n0, n1, n2 (smooth shading)
TEX0 = NRM_COL + 9  # textured-kd block: dpdv, uv0, uv1, uv2, textured flag
TABLE_COLS = TEX0 + 10  # 115
LIGHT_MAX = 8
SPH_MAX = 8  # full spheres the path kernel takes
DEPTH_MAX = 15
ELEM_MAX = 16  # lens elements
BIN_MAX = 64  # exit-pupil bins
BIG_T = 3.0e38
CHUNK_ROWS = 16  # build_tri_chunks closes a chunk at this many rows
CHUNK_MAX = TRI_MAX // 4  # csrc/common.cuh: chunks of TRI_MAX rows, all but the last >= 4 rows
CHUNK_COLS = 8  # a chunk row: bmin xyz, bmax xyz, first row, end row
CULL_SLOP = 1.0 + 2.0**-7  # csrc/common.cuh: the slack of a chunk box's t bound
SPEC_KINDS = (LOBE_SPEC_REFL, LOBE_SPEC_TRANS, LOBE_FRESNEL_SPEC)
# the lobes of the Volpath kernel and of the SPPM kernels' base instances;
# the path kernel adds Disney's (K5 e), the SPPM kernels' wide instances
# Disney's and specular transmission, the wavefront loop every lobe the
# loader emits under Path
BASE_KINDS = (LOBE_LAMBERT_REFL, LOBE_MF_REFL, LOBE_SPEC_REFL, LOBE_FRESNEL_SPEC)
DISNEY_KINDS = (LOBE_DISNEY_DIFFUSE, LOBE_DISNEY_RETRO, LOBE_DISNEY_SHEEN,
                LOBE_DISNEY_CLEARCOAT, LOBE_DISNEY_MICROFACET_REFL)
# the path kernel's: specular transmission too, in a subsurface material only
PORTED_KINDS = BASE_KINDS + DISNEY_KINDS + (LOBE_SPEC_TRANS,)
WAVEFRONT_KINDS = PORTED_KINDS + (LOBE_OREN_NAYAR, LOBE_LAMBERT_TRANS, LOBE_MF_TRANS,
                                  LOBE_DISNEY_FAKE_SS)
# what a kernel without the subsurface branch names for a BSSRDF material
BSSRDF_NAME = "specular transmission (DisneyMaterial scatter_distance BSSRDF)"
# what a renderer without the textured tap names for a textured matte
TEXTURED_KD = "textured kd (ImageTexture)"
# what a kernel that does not take a lobe kind names in its error
LOBE_NAMES = {
    LOBE_OREN_NAYAR: "Oren-Nayar (MatteMaterial sigma > 0)",
    LOBE_LAMBERT_TRANS: "lambert transmission (TranslucentMaterial, thin DisneyMaterial)",
    LOBE_SPEC_TRANS: "specular transmission",
    LOBE_MF_TRANS: "microfacet transmission (rough GlassMaterial, TranslucentMaterial,"
                   " DisneyMaterial spec_trans)",
    LOBE_DEBUG_DIFFUSE: "Debug material",
    LOBE_DEBUG_SPECULAR: "Debug material",
    LOBE_DISNEY_DIFFUSE: "Disney diffuse (DisneyMaterial)",
    LOBE_DISNEY_FAKE_SS: "Disney fake subsurface (thin DisneyMaterial)",
    LOBE_DISNEY_RETRO: "Disney retro-reflection (DisneyMaterial)",
    LOBE_DISNEY_SHEEN: "Disney sheen (DisneyMaterial)",
    LOBE_DISNEY_CLEARCOAT: "Disney clearcoat (DisneyMaterial)",
    LOBE_DISNEY_MICROFACET_REFL: "Disney microfacet (DisneyMaterial)",
    LOBE_MF_REFL: "microfacet (PlasticMaterial, MetalMaterial)",
    LOBE_SPEC_REFL: "specular reflection (MirrorMaterial, GlassMaterial)",
    LOBE_FRESNEL_SPEC: "fresnel specular (GlassMaterial)",
}

ENV_BINS = 16  # theta and phi rows of a constant map's Distribution2D (8x8 texels)
SLOT_MAX = 176  # sampler slots the slot-to-row map covers: path_dim0(DEPTH_MAX), rounded up


def kernel_name(base, bvh=False, halton=False, smooth=False, bss=False, tex=False):
    """The name (and LAUNCHES key) of a kernel instance: the camera
    ("path_mega_cam") or rays-in ("path_mega") kernel, over the BVH, under
    the Halton sampler, with smooth normals, with the subsurface branch or
    with the textured kd (camera, stratified and flat only)."""
    return (base + "_bvh" * bvh + "_halton" * halton + "_smooth" * smooth + "_bss" * bss
            + "_tex" * tex)


# Kernel launches made by li_path_mega_cam and li_path_mega, by kernel
# instance; the one piece of module state.
LAUNCHES = {
    **{kernel_name(base, bvh, halton, smooth, bss): 0
       for base in ("path_mega_cam", "path_mega")
       for bvh in (False, True)
       for halton in (False, True)
       for smooth, bss in ((False, False), (True, False), (False, True))},
    **{kernel_name("path_mega_cam", bvh, tex=True): 0 for bvh in (False, True)},
}


class BvhTables(NamedTuple):
    nodes_f: torch.Tensor  # (M, 16) float32 fused-children rows
    nodes_i: torch.Tensor  # (M, 4) int32: offset, n_prims, axis, 0
    max_leaf: int  # most triangles in one leaf
    stack: int = STACK_DEPTH  # entries of the walk's stack (accel/bvh.stack_for)
    # the same tree as node64 rows, the path, direct and Volpath kernels'
    # walk (csrc/common.cuh Bvh64); None: the plain walk goes over the
    # fused-children rows
    nodes64: Optional[torch.Tensor] = None  # (I, 16) float32, one row per interior node
    prims: Optional[torch.Tensor] = None  # (P, 12) float32 leaf order: p0, e1, e2, pad
    root_count: int = 0  # the tree is one leaf of this many rows (no node64 row)


class EnvC(NamedTuple):
    """A constant environment light as kernel constants (the JAX package's
    _pack_env_static): the texel radiance, the Distribution2D's marginal
    CDF and per-row pdfs, its (shared) conditional CDF, the pdf_2d value
    of each theta row, the cos(theta) thresholds of the rows (no arccos in
    the kernel), the map's (nu, nv) and its 3x3 transforms, float32
    values."""

    rgb: tuple
    marg_cdf: tuple  # nv + 1
    marg_pdf: tuple  # nv
    cond_cdf: tuple  # nu + 1
    pdf2d_bins: tuple  # nv
    cos_bins: tuple  # nv - 1 python floats, rounded to float32 where used
    nu: int
    nv: int
    to_world: tuple  # 9, row major
    to_local: tuple


class BssrdfC(NamedTuple):
    """The one used material's BSSRDF as kernel constants (the JAX
    package's BssrdfC): albedo R and scatter distance d (clamped at 1e-6)
    per channel as float32 values, its eta, and the Sw adapter's
    normalisation c_sw = 1 - 2 fresnel_moment1(1 / eta), folded in
    float64."""

    R: tuple
    d: tuple
    eta: float
    c_sw: float


class TexC(NamedTuple):
    """The one image texture of a textured scene: its pyramid on the
    render device (scene/mipmap.Pyramid) and its record (the UV mapping
    and scale)."""

    pyr: object
    rec: object


class PackedScene(NamedTuple):
    table: torch.Tensor  # (T, 115) float32 on the render device
    light_p: tuple  # per light, (x, y, z) float32 values (point position)
    light_emit: tuple  # per light, (r, g, b): intensity or radiance
    kinds_present: tuple = ()  # lobe kinds live on some triangle or sphere
    bvh: Optional[BvhTables] = None  # BVH mode: table rows in leaf order
    # sphere primitives, (S, 115) rows in the table's layout: cols 0:12
    # the world-to-object 3x4 rows, col 12 the radius, the lobe columns
    # as a triangle's, cols 96:108 the object-to-world rows; None: none
    sph_table: Optional[torch.Tensor] = None
    light_kind: tuple = ()  # per light, LIGHT_*; empty: every light a point light
    light_o2w: tuple = ()  # per light, 12 floats of a sphere light's object-to-world
    light_w2o: tuple = ()  # per light, 9 floats of its inverse's 3x3
    light_radius: tuple = ()
    env: Optional[EnvC] = None  # the environment light NEE samples
    esc_rgb: Optional[tuple] = None  # summed radiance of the infinite_lights environments
    world_radius: float = 0.0  # float32 value
    smooth: bool = False  # mesh_smooth: interpolate the raw vertex normals
    bssrdf: Optional[BssrdfC] = None  # the subsurface branch's constants
    tex: Optional[TexC] = None  # the textured kd's image (TEX0 block filled)
    # brute force: (C, CHUNK_COLS) float32 chunk rows over the table
    # (build_tri_chunks, chunk_rows), which K1's, K2's, K6's and K8's walks cull by; None
    # in BVH mode
    chunks: Optional[torch.Tensor] = None


def _pow2(n):
    return n > 0 and (n & (n - 1)) == 0


def full_spheres(sph):
    """Every sphere unclipped (no z or phi clip: sphere.rs:50-108's clip
    tests are vacuous), the JAX package's _full_spheres."""
    if sph is None or sph.count == 0:
        return True
    r = sph.radius
    return bool(np.all(sph.z_min <= -r + 1e-6 * r) and np.all(sph.z_max >= r - 1e-6 * r)
                and np.all(sph.phi_max >= 2.0 * np.pi - 1e-6))


def mesh_smooth(tri):
    """Does any triangle carry vertex normals that differ in direction
    from its face normal (the JAX package's _mesh_smooth)?  Parallel but
    unnormalised or zero-length normals shade flat and stay in the flat
    subset."""
    if tri.count == 0 or not tri.has_n.any():
        return False
    has_n = tri.has_n
    ng = np.asarray(tri.ng, np.float32)[has_n]
    for vn in (tri.n0, tri.n1, tri.n2):
        v = np.asarray(vn, np.float32)[has_n]
        nrm = np.linalg.norm(v, axis=-1, keepdims=True)
        unit = v / np.maximum(nrm, 1e-20)
        if np.any((nrm[..., 0] > 0) & (np.abs(unit - ng).max(-1) > 1e-5)):
            return True
    return False


def _light_unsupported(scene, volpath, path, wavefront, spec_live):
    """The lights check of scene_unsupported."""
    lk = np.asarray(scene.lights.kind)
    escape = any(e.escape_le for e in scene.infinite)
    if scene.infinite and not (path or wavefront):
        return "infinite lights (environment maps)"
    if lk.size == 0 and not ((path or wavefront) and escape):
        return "unlit scenes"
    if wavefront:
        return None
    if path:
        sk = np.asarray(scene.lights.shape_kind)
        ok = ((lk == LIGHT_POINT) | (lk == LIGHT_INFINITE)
              | ((lk == LIGHT_DIFFUSE_AREA) & (sk == AREA_SHAPE_SPHERE)))
        what = "point, sphere and environment lights"
    else:
        sk = np.asarray(scene.lights.shape_kind)
        ok = (lk == LIGHT_POINT) | ((lk == LIGHT_DIFFUSE_AREA) & (sk == AREA_SHAPE_SPHERE) & volpath)
        what = "point and sphere lights" if volpath else "point lights"
    if lk.size > LIGHT_MAX or not ok.all():
        return f"lights other than up to {LIGHT_MAX} {what}"
    n_env = int(np.sum(lk == LIGHT_INFINITE))
    if n_env > 1:
        return "more than one environment light"
    if n_env and spec_live:
        # the kernel's BSDF sample of MIS draws over every lobe, which is
        # the reference's non-specular draw only without specular lobes
        return "an environment light beside a specular lobe"
    return None


def scene_unsupported(scene, sampler, kinds, volpath=False, tri_max=None, path=False,
                      wavefront=False, allow_smooth=False) -> Optional[str]:
    """The checks the kernels share (common_scene_checks): power-of-two
    stratified grid but in the wavefront loop, which takes any grid (no
    check when `sampler` is None; a HaltonSampler only with `path` or
    `wavefront`), up to tri_max (default BVH_TRI_MAX)
    triangles but in the wavefront loop, flat unless `allow_smooth`, up
    to LIGHT_MAX point lights, and every live lobe of a used material among `kinds` (microfacets:
    visible-normal Trowbridge-Reitz only; unscaled, up to LOBES_MAX of
    them and fresnel specular alone, except in the wavefront loop, which
    takes up to MAX_LOBES).  A camera medium is not read here: outside
    Volpath it is ignored, as the JAX package's integrators ignore it, and
    the Volpath kernel checks it itself.  With `volpath`, sphere lights
    too.
    With `path` (the path kernel) up to SPH_MAX full spheres and point,
    sphere and one environment light, the environment only without
    specular lobes; with `wavefront` (the wavefront Path loop) any
    spheres and lights.  A used material with a BSSRDF only with `path`
    (within _bssrdf_unsupported's subset, and specular transmission only
    there) or `wavefront`.  Textured materials only within the path
    kernel's textured subset (_texture_unsupported).  Above TRI_MAX
    triangles, but in the wavefront loop, a BVH the kernels' stack holds
    (_depth_unsupported).  Returns the first feature outside them, or
    None."""
    if isinstance(sampler, HaltonSampler):
        if not (path or wavefront):
            return "HaltonSampler"
    elif sampler is not None and not wavefront and not (
            _pow2(sampler.spp) and _pow2(sampler.xs) and _pow2(sampler.ys)):
        return f"stratified grid {sampler.xs}x{sampler.ys} (power of two only)"
    tri = scene.triangles
    sph = scene.spheres
    n_sph = 0 if sph is None else sph.count
    tri_max = BVH_TRI_MAX if tri_max is None else tri_max
    if tri.count > tri_max and not wavefront:
        return f"{tri.count} triangles (the BVH kernels take up to {tri_max})"
    if not allow_smooth and mesh_smooth(tri):
        return "smooth shading (vertex normals)"
    if n_sph and not (path or wavefront):
        return "sphere primitives"
    if path and n_sph > SPH_MAX:
        return f"more than {SPH_MAX} sphere primitives"
    if path and not full_spheres(sph):
        return "partial sphere primitives"
    mats = scene.materials
    prim_mat = np.concatenate([tri.mat, sph.mat if n_sph else np.zeros(0, np.int32)])
    used = np.unique(prim_mat[prim_mat >= 0])
    if used.size == 0 and not wavefront:
        return "scenes without materials"
    has_bss = np.asarray(mats["has_bssrdf"], bool)
    if has_bss[used].any():
        if not (path or wavefront):
            return f"{BSSRDF_NAME} of material type DisneyMaterial"
        if path:
            reason = _bssrdf_unsupported(scene, used)
            if reason is not None:
                return reason
    n_lobes = mats["n_lobes"]
    lobes_max = MAX_LOBES if wavefront else LOBES_MAX
    if np.any(n_lobes[used] > lobes_max):
        return f"materials with more than {lobes_max} lobes"
    spec_live = False
    for m in used:
        for l in range(int(n_lobes[m])):
            kind = int(mats["kind"][m, l])
            if kind not in kinds or (path and kind == LOBE_SPEC_TRANS and not has_bss[m]):
                return f"{LOBE_NAMES.get(kind, f'lobe kind {kind}')} lobes"
            spec_live |= kind in SPEC_KINDS
            reason = _lobe_unsupported(mats, m, l, kind, wavefront)
            if reason is not None:
                return reason
            if kind == LOBE_FRESNEL_SPEC and n_lobes[m] > 1 and not wavefront:
                return "fresnel-specular lobes in a multi-lobe material"
    reason = _texture_unsupported(scene, sampler, used, path)
    if reason is not None:
        return reason
    reason = _light_unsupported(scene, volpath, path, wavefront, spec_live)
    if reason is None and not wavefront and tri.count > TRI_MAX:
        reason = _depth_unsupported(tri)
    return reason


def _depth_unsupported(tri):
    """The depth of the BVH pack_scene builds over more than TRI_MAX
    triangles when the kernels' STACK_DEPTH-entry traversal stack cannot
    hold it (the wavefront loop's deep instances can), else None."""
    depth = tree_depth(build_bvh(tri, BVH_LEAF))
    if depth >= STACK_DEPTH:
        return f"a BVH of depth {depth} (the kernels' traversal stack holds {STACK_DEPTH})"
    return None


def textured_lobes(mats, used):
    """(material, lobe) of each live lobe of the `used` materials whose s0
    is a texture."""
    s0_tex, n_lobes = mats["s0_tex"], mats["n_lobes"]
    return [(m, l) for m in used for l in range(int(n_lobes[m])) if s0_tex[m, l] >= 0]


def _texture_unsupported(scene, sampler, used, path):
    """Textured materials: only the path kernel's textured subset (the JAX
    package's _textured_static and common_scene_checks' textured gate)
    takes them, every other renderer but AO names them.  The subset: one
    image texture, the kd of a matte (one lambert lobe: the kernel takes
    no Oren-Nayar lobe, and a Mix's lobes are scaled), every live lobe
    lambert, on triangles, flat shading, the stratified sampler (no
    256-texel width cap: that is the TPU's packed table's).  Another
    textured parameter (the loader's `textured`) is named."""
    mats = scene.materials
    others = [name for m in used for name in mats["textured"][m]]
    if others:
        return f"textured {others[0]}"
    tex_lobes = textured_lobes(mats, used)
    if not tex_lobes:
        return None
    if not path:
        return TEXTURED_KD
    kinds, n_lobes = mats["kind"], mats["n_lobes"]
    for m in used:
        for l in range(int(n_lobes[m])):
            if kinds[m, l] != LOBE_LAMBERT_REFL:
                kind = int(kinds[m, l])
                return f"{TEXTURED_KD} beside {LOBE_NAMES.get(kind, f'kind {kind}')} lobes"
    if len({int(mats["s0_tex"][m, l]) for m, l in tex_lobes}) > 1:
        return f"{TEXTURED_KD} from more than one image texture"
    if isinstance(sampler, HaltonSampler):
        return f"{TEXTURED_KD} under the HaltonSampler"
    if mesh_smooth(scene.triangles):
        return f"{TEXTURED_KD} on smooth shading (vertex normals)"
    sph = scene.spheres
    if sph is not None and sph.count:
        sph_mats = np.unique(sph.mat[sph.mat >= 0])
        if textured_lobes(mats, sph_mats):
            return f"{TEXTURED_KD} on sphere primitives"
    return None


def _bssrdf_unsupported(scene, used):
    """The path kernel's subsurface branch (the JAX package's `supports`,
    path_megakernel.py:439-455): the one used material, point lights only
    (the exit's NEE is the delta form), triangles only, no environment,
    flat shading.  Returns the first feature outside it, or None."""
    lk = np.asarray(scene.lights.kind)
    if used.size != 1:
        return f"{BSSRDF_NAME} beside other materials"
    if lk.size == 0 or np.any(lk != LIGHT_POINT) or scene.infinite:
        return f"{BSSRDF_NAME} under lights other than point lights"
    if scene.spheres is not None and scene.spheres.count:
        return f"{BSSRDF_NAME} on sphere primitives"
    if mesh_smooth(scene.triangles):
        return f"{BSSRDF_NAME} on smooth shading (vertex normals)"
    return None


def _lobe_unsupported(mats, m, l, kind, wavefront):
    """The per-lobe checks of scene_unsupported: microfacets with
    visible-normal Trowbridge-Reitz sampling (the reflection lobe with a
    dielectric or conductor fresnel, Disney's with its fresnel and
    separable G, transmission with either G); a scale other than 1 only
    in the wavefront loop."""
    dist, fres = mats["dist"][m, l], mats["fresnel"][m, l]
    visible = mats["sample_visible"][m, l]
    if kind == LOBE_MF_REFL and (dist != DIST_TROWBRIDGE_REITZ or not visible
                                 or not 0 <= fres <= FRESNEL_CONDUCTOR):
        return "microfacet lobes other than visible-normal Trowbridge-Reitz"
    if kind == LOBE_DISNEY_MICROFACET_REFL and (dist != DIST_DISNEY_SEPARABLE_G or not visible
                                                or fres != FRESNEL_DISNEY):
        return "Disney microfacet lobes other than the separable-G Disney-fresnel form"
    if kind == LOBE_MF_TRANS and (dist not in (DIST_TROWBRIDGE_REITZ, DIST_DISNEY_SEPARABLE_G)
                                  or not visible):
        return "microfacet transmission other than visible-normal Trowbridge-Reitz"
    if not wavefront and np.any(mats["scale"][m, l] != 1.0):
        return "scaled lobes (TranslucentMaterial reflect / transmit, MixMaterial scale)"
    return None


def unsupported_feature(scene, spec, sampler) -> Optional[str]:
    """Name of the first scene feature outside the kernel's subset, or
    None when the path kernel renders the job exactly."""
    if spec.kind != "path":
        return f"{spec.kind} integrator"
    if not 1 <= spec.max_depth <= DEPTH_MAX:
        return f"max_depth {spec.max_depth} outside 1..{DEPTH_MAX}"
    return scene_unsupported(scene, sampler, PORTED_KINDS, path=True, allow_smooth=True)


def supports(scene, spec, sampler) -> bool:
    """Static host check: can the path kernel render this job exactly?"""
    return unsupported_feature(scene, spec, sampler) is None


def _resolve_mat_arrays(m, mat):
    """Per-triangle material constants: kind, s0, s1, s2, alpha after the
    roughness remap, fresnel code, eta pair, n_lobes and the Bsdf eta
    (ops/path_megakernel._resolve_mat_arrays), and for the wavefront rows
    the lobes' scale and distribution code.  The remap runs in the table's
    float32, as in the JAX package."""
    safe = np.maximum(mat, 0)
    kinds = m["kind"][safe]
    fp = m["fparams"][safe]
    remap = m["remap"][safe]
    au = np.where(remap, roughness_to_alpha(fp[..., 0]), fp[..., 0])
    av = np.where(remap, roughness_to_alpha(fp[..., 1]), fp[..., 1])
    # specular lobes keep their eta pair in f0/f1, microfacets in f2/f3
    is_spec = np.isin(kinds, SPEC_KINDS)
    return dict(
        kinds=kinds,
        s0=m["s0"][safe],
        s1=m["s1"][safe],
        s2=m["s2"][safe],
        au=au,
        av=av,
        fres=m["fresnel"][safe],
        ea=np.where(is_spec, fp[..., 0], fp[..., 2]),
        eb=np.where(is_spec, fp[..., 1], fp[..., 3]),
        n_lobes=m["n_lobes"][safe] * (mat >= 0),
        mat_eta=m["eta"][safe],
        scale=m["scale"][safe],
        dist=m["dist"][safe],
    )


def fill_lobe_columns(table, r, slots):
    """Write the lobe count (col 15), up to `slots` lobes (cols 16 + 16 * l:
    kind, s0, s1, s2, alpha_u, alpha_v, fresnel, eta_a, eta_b) and the
    Bsdf eta (col 31) of the resolved materials r (_resolve_mat_arrays)
    into the rows of the float32 numpy `table`."""
    table[:, 15] = r["n_lobes"]
    for l in range(min(slots, r["kinds"].shape[1])):
        base = 16 + 16 * l
        table[:, base + 0] = r["kinds"][:, l]
        table[:, base + 1 : base + 4] = r["s0"][:, l]
        table[:, base + 4 : base + 7] = r["s1"][:, l]
        table[:, base + 7 : base + 10] = r["s2"][:, l]
        table[:, base + 10] = r["au"][:, l]
        table[:, base + 11] = r["av"][:, l]
        table[:, base + 12] = r["fres"][:, l]
        table[:, base + 13] = r["ea"][:, l]
        table[:, base + 14] = r["eb"][:, l]
    table[:, 31] = r["mat_eta"]


def kinds_present(table):
    """Sorted tuple of the lobe kinds live on some row of a (T, 115) numpy
    table (a lobe is live below the row's n_lobes)."""
    n_lob = table[:, 15].astype(np.int64)
    kinds = set()
    for l in range(LOBES_MAX):
        live = n_lob > l
        kinds.update(int(k) for k in np.unique(table[live, 16 + 16 * l]))
    return tuple(sorted(kinds))


SPH_RADIUS_COL = 12
SPH_O2W_COL = NRM_COL


def _rows12(m4):
    return tuple(float(v) for v in np.asarray(m4, np.float32)[:3, :4].ravel())


def pack_env(env):
    """EnvC of a loaded constant environment (scene.types.EnvLight), from
    the float32 copy of its Distribution2D that the wavefront loop
    samples."""
    dist = env.dist
    f32 = lambda a: np.asarray(a, np.float32)
    marg_func, marg_cdf = f32(dist.marginal.func), f32(dist.marginal.cdf)
    marg_int = np.float32(dist.marginal.func_int)
    cond_cdf, cond_func = f32(dist.cond_cdf), f32(dist.cond_func)
    if not (np.all(cond_cdf == cond_cdf[0]) and np.all(cond_func == cond_func[:, :1])):
        raise ValueError("a constant environment with varying conditional rows")
    nv, nu = cond_func.shape
    t = lambda a: tuple(float(v) for v in a)
    return EnvC(
        rgb=t(f32(env.rgb)),
        marg_cdf=t(marg_cdf),
        marg_pdf=t(np.where(marg_int > 0, marg_func / marg_int, np.float32(0))),
        cond_cdf=t(cond_cdf[0]),
        pdf2d_bins=t(np.where(marg_int > 0, cond_func[:, 0] / marg_int, np.float32(0))),
        cos_bins=tuple(float(np.cos(np.pi * k / nv)) for k in range(1, nv)),
        nu=int(nu),
        nv=int(nv),
        to_world=t(f32(env.to_world)[:3, :3].ravel()),
        to_local=t(f32(env.to_local)[:3, :3].ravel()),
    )


def pack_lights(scene):
    """The light constants of PackedScene: kinds, sphere-light rows, the
    sampled environment and the escape radiance (_pack_lights_static)."""
    lt = scene.lights
    kinds = tuple(int(k) for k in lt.kind)
    env = None
    for k, idx in zip(kinds, lt.shape_index):
        if k == LIGHT_INFINITE:
            env = pack_env(scene.infinite[int(idx)])
    esc = [e for e in scene.infinite if e.escape_le]
    esc_rgb = None
    if esc:
        total = np.zeros(3, np.float32)
        for e in esc:
            total = total + np.asarray(e.rgb, np.float32)
        esc_rgb = tuple(float(v) for v in total)
    return dict(
        light_kind=kinds,
        light_o2w=tuple(_rows12(m) for m in lt.sph_o2w),
        light_w2o=tuple(tuple(float(v) for v in np.asarray(m, np.float32)[:3, :3].ravel())
                        for m in lt.sph_w2o),
        light_radius=tuple(float(r) for r in np.asarray(lt.sph_radius, np.float32)),
        env=env,
        esc_rgb=esc_rgb,
        world_radius=float(np.float32(lt.world_radius)),
    )


def pack_spheres(scene):
    """(S, TABLE_COLS) float32 sphere rows (_pack_spheres_static in the
    table's layout), or None without spheres."""
    sph = scene.spheres
    if sph is None or sph.count == 0:
        return None
    rows = np.zeros((sph.count, TABLE_COLS), np.float32)
    rows[:, 0:12] = np.asarray(sph.w2o, np.float32)[:, :3, :4].reshape(-1, 12)
    rows[:, SPH_RADIUS_COL] = sph.radius
    fill_lobe_columns(rows, _resolve_mat_arrays(scene.materials, sph.mat), LOBES_MAX)
    rows[:, 47] = sph.mat
    rows[:, SPH_O2W_COL:SPH_O2W_COL + 12] = np.asarray(sph.o2w, np.float32)[:, :3, :4].reshape(-1, 12)
    return rows


def pack_bssrdf(materials, mat):
    """BssrdfC of the one material the triangles `mat` use when it has a
    BSSRDF (pack_scene's host constants, path_megakernel.py:752-773), else
    None."""
    used = np.unique(mat[mat >= 0])
    if used.size != 1 or not materials["has_bssrdf"][used[0]]:
        return None
    from ..bsdf.bssrdf import fresnel_moment1  # bssrdf -> accel -> ops imports this module

    m = int(used[0])
    eta = float(materials["bssrdf_eta"][m])
    fm1 = float(fresnel_moment1(torch.tensor(1.0 / eta, dtype=torch.float64)))
    f32 = lambda v: tuple(float(x) for x in np.asarray(v, np.float32))
    return BssrdfC(R=f32(materials["bssrdf_R"][m]),
                   d=f32(np.maximum(materials["bssrdf_d"][m], 1e-6)), eta=eta,
                   c_sw=float(1.0 - 2.0 * fm1))


def pack_texture(scene, mat, device):
    """TexC of the one image texture whose kd the materials `mat` of the
    triangles read (the pyramid on `device`), or None without one."""
    mats = scene.materials
    lobes = textured_lobes(mats, np.unique(mat[mat >= 0]))
    if not lobes:
        return None
    ids = {int(mats["s0_tex"][m, l]) for m, l in lobes}
    if len(ids) != 1:
        raise ValueError(f"{TEXTURED_KD} from {len(ids)} textures; the path kernel takes one")
    rec = scene.registry.records[ids.pop()]
    return TexC(pyramid(scene.registry.images[rec.image_id], device), rec)


def build_tri_chunks(p0, e1, e2, t_count, max_tris=TRI_MAX, max_chunks=CHUNK_MAX):
    """Greedy chunks of consecutive triangle rows (the JAX package's
    _build_tri_chunks, path_megakernel.py:919, whose TPU limits were
    max_tris=256, max_chunks=24; here any brute-force table): a chunk
    closes at CHUNK_ROWS rows, or after 4 rows where the next row would
    more than double its box's surface area.  Returns ((lo, hi, bmin,
    bmax), ...) covering [0, t_count), each box padded by 1e-3 + 1e-4
    max|coordinate| (python floats, from float64), or None for an empty
    table, one past max_tris or more than max_chunks chunks."""
    if t_count <= 0 or t_count > max_tris:
        return None
    p0 = np.asarray(p0[:t_count], np.float64)
    v = np.stack([p0, p0 + np.asarray(e1[:t_count], np.float64),
                  p0 + np.asarray(e2[:t_count], np.float64)], 1)
    tlo, thi = v.min(1), v.max(1)

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    raw = []
    lo_i, cur_lo, cur_hi = 0, tlo[0].copy(), thi[0].copy()
    for i in range(1, t_count):
        nlo = np.minimum(cur_lo, tlo[i])
        nhi = np.maximum(cur_hi, thi[i])
        cnt = i - lo_i
        if cnt >= CHUNK_ROWS or (cnt >= 4 and area(nlo, nhi) > 2.0 * area(cur_lo, cur_hi) + 1e-12):
            raw.append((lo_i, i, cur_lo, cur_hi))
            lo_i, cur_lo, cur_hi = i, tlo[i].copy(), thi[i].copy()
        else:
            cur_lo, cur_hi = nlo, nhi
    raw.append((lo_i, t_count, cur_lo, cur_hi))
    if len(raw) > max_chunks:
        return None
    out = []
    for lo_i, hi_i, blo, bhi in raw:
        pad = 1e-3 + 1e-4 * np.maximum(np.abs(blo), np.abs(bhi))
        out.append((int(lo_i), int(hi_i), tuple(float(x) for x in blo - pad),
                    tuple(float(x) for x in bhi + pad)))
    return tuple(out)


def chunk_rows(chunks):
    """(C, CHUNK_COLS) float32 rows of build_tri_chunks' chunks: bmin and
    bmax rounded outward to float32, then the first and end row."""
    rows = np.zeros((len(chunks), CHUNK_COLS), np.float32)
    for c, (lo, hi, bmin, bmax) in enumerate(chunks):
        b64 = np.array(bmin + bmax)
        b32 = b64.astype(np.float32)
        down = np.nextafter(b32, np.float32(-np.inf))
        up = np.nextafter(b32, np.float32(np.inf))
        rows[c, 0:3] = np.where(b32[:3] > b64[:3], down[:3], b32[:3])
        rows[c, 3:6] = np.where(b32[3:] < b64[3:], up[3:], b32[3:])
        rows[c, 6:8] = lo, hi
    return rows


def pack_scene(scene, device, bvh=None) -> PackedScene:
    """(T, 115) float32 per-triangle table, the sphere rows and the lights.

    cols 0:15  p0, e1, e2, ng, dpdu
    col  15    n_lobes
    cols 16+16*l  per lobe l: kind, s0(3), s1(3), s2(3), alpha_u, alpha_v,
                  fresnel, eta_a, eta_b, pad (col 31 = Bsdf eta, col 47 =
                  material id)
    cols 96:105  raw vertex normals n0, n1, n2 (read when `smooth`);
    cols 105:115 the textured-kd block of a textured scene (dpdv, uv0,
                  uv1, uv2, and 1 where the row's material takes kd from the
                  texture, -1 elsewhere), zeros otherwise.

    Brute force: the chunk rows K1's, K2's, K6's and K8's walks cull by
    (build_tri_chunks over the whole table).  BVH mode (bvh=True, or bvh=None and more than
    TRI_MAX triangles): a SAH BVH with leaves of up to BVH_LEAF
    triangles, its fused-children node tables, and the table's rows
    reordered into leaf order (ops/path_megakernel.pack_scene's
    RS_MEGA_BVH mode; all 115 columns are kept), and no chunks; beside
    them the same tree's node64 rows (accel/bvh.pack_node64_tables) and
    the leaf-order rows' cols 0:9 as 48-byte rows (`prims`), which the
    path, direct and Volpath kernels walk (the SPPM kernels walk the
    fused-children rows), and `root_count`, the rows of a tree that is one
    leaf."""
    tri = scene.triangles
    p0 = tri.p0.astype(np.float32)
    r = _resolve_mat_arrays(scene.materials, tri.mat)
    t_count = p0.shape[0]
    table = np.zeros((t_count, TABLE_COLS), np.float32)
    table[:, 0:3] = p0
    table[:, 3:6] = tri.p1 - p0
    table[:, 6:9] = tri.p2 - p0
    table[:, 9:12] = tri.ng
    table[:, 12:15] = tri.dpdu
    fill_lobe_columns(table, r, LOBES_MAX)
    table[:, 47] = tri.mat
    table[:, NRM_COL : NRM_COL + 9] = np.concatenate([tri.n0, tri.n1, tri.n2], axis=1)
    tex = pack_texture(scene, tri.mat, device)
    if tex is not None:
        table[:, TEX0:TEX0 + 3] = tri.dpdv
        table[:, TEX0 + 3:TEX0 + 9] = np.concatenate([tri.uv0, tri.uv1, tri.uv2], axis=1)
        s0_tex = scene.materials["s0_tex"][np.maximum(tri.mat, 0), 0]
        table[:, TEX0 + 9] = np.where((tri.mat >= 0) & (s0_tex >= 0), 1.0, -1.0)
    sph_rows = pack_spheres(scene)
    kinds = kinds_present(table if sph_rows is None else np.concatenate([table, sph_rows]))
    tables, chunks = None, None
    if t_count > 0 and ((t_count > TRI_MAX) if bvh is None else bvh):
        flat = build_bvh(tri, BVH_LEAF)
        if tree_depth(flat) >= STACK_DEPTH:
            raise ValueError(f"BVH deeper than the {STACK_DEPTH}-entry traversal stack")
        nodes_f, nodes_i = pack_bvh_tables(flat)
        table = table[flat.prim_index]
        nodes64 = pack_node64_tables(nodes_f, nodes_i)
        prims = np.zeros((t_count, PRIM_COLS), np.float32)
        prims[:, 0:GEO_COLS] = table[:, 0:GEO_COLS]
        tables = BvhTables(
            torch.as_tensor(nodes_f, device=device),
            torch.as_tensor(nodes_i, device=device),
            flat.max_leaf,
            nodes64=torch.as_tensor(nodes64, device=device),
            prims=torch.as_tensor(prims, device=device),
            root_count=0 if nodes64.shape[0] else t_count,
        )
    elif 0 < t_count <= TRI_MAX:
        found = build_tri_chunks(table[:, 0:3], table[:, 3:6], table[:, 6:9], t_count)
        chunks = torch.as_tensor(chunk_rows(found), device=device)
    lights = scene.lights
    return PackedScene(
        bssrdf=pack_bssrdf(scene.materials, tri.mat),
        table=torch.as_tensor(table, device=device),
        light_p=tuple(tuple(float(v) for v in row) for row in lights.p),
        light_emit=tuple(tuple(float(v) for v in row) for row in lights.emit),
        kinds_present=kinds,
        bvh=tables,
        sph_table=None if sph_rows is None else torch.as_tensor(sph_rows, device=device),
        smooth=mesh_smooth(tri),
        tex=tex,
        chunks=chunks,
        **pack_lights(scene),
    )


def used_slots(max_depth, n_lights, all_point, has_env_nee, with_cam, has_bssrdf=False):
    """The sampler slots the bounce loop (and with `with_cam` the lens
    trace) reads, in order, as (slot, 1 or 2 components) pairs: the JAX
    package's _used_slots, the subsurface branch's with `has_bssrdf`.  It
    mirrors every get_1d / get_2d of bounce_loop_reference and of the
    kernel; a slot left out makes the plain version raise KeyError and
    the kernel write NaN radiance for the rays that read it."""
    slots = [(CAMERA_FILM, 2), (CAMERA_LENS, 2)] if with_cam else []
    for bounce in range(max_depth):
        d0 = path_dim0(bounce)
        if all_point:
            slots.append((d0 + PATH_NEE, 1))
        elif n_lights > 0:
            slots += [(d0 + PATH_NEE, 1), (d0 + PATH_NEE + 1, 2)]
            if has_env_nee:
                slots.append((d0 + PATH_NEE + 2, 2))
        slots.append((d0 + PATH_BSDF, 2))
        if has_bssrdf:
            slots += [(d0 + PATH_BSS_PROBE_1D, 1), (d0 + PATH_BSS_PROBE_2D, 2)]
            if n_lights > 0:
                slots.append((d0 + PATH_BSS_PICK, 1))
            slots.append((d0 + PATH_BSS_OUT, 2))
        if bounce > 3:
            slots.append((d0 + PATH_RR, 1))
    return tuple(slots)


def slot_cols(slots):
    """(slot -> its first row in the slot matrix, the number of rows)."""
    cols, c = {}, 0
    for slot, n in slots:
        cols[slot] = c
        c += n
    return cols, c


def packed_slots(packed, spec, with_cam):
    """used_slots of a packed scene under the integrator spec `spec`."""
    n_lights = len(packed.light_p)
    kinds = packed.light_kind or (LIGHT_POINT,) * n_lights
    all_point = n_lights > 0 and all(k == LIGHT_POINT for k in kinds)
    return used_slots(spec.max_depth, n_lights, all_point, packed.env is not None, with_cam,
                      getattr(packed, "bssrdf", None) is not None)


class SlotReader:
    """A HaltonSampler's values of the slots `packed` and `spec` read, for
    one batch, read back by slot as the kernel reads them (_mk_sdim's
    Halton branch): u, the (NC, N) float32 matrix of
    HaltonSampler.slot_matrix (one row per component, computed once a
    pass), and cols, slot -> its first row."""

    def __init__(self, sampler, packed, spec, pid, sid, with_cam):
        slots = packed_slots(packed, spec, with_cam)
        self.u = sampler.slot_matrix(pid.to(torch.int64), sid, slots).contiguous()
        self.cols = slot_cols(slots)[0]

    def get_1d(self, pid, sid, dim):
        return self.u[self.cols[dim]]

    def get_2d(self, pid, sid, dim):
        c = self.cols[dim]
        return self.u[c:c + 2].T


def tally_slots(work, sampler, count):
    """Count the slot values the kernel reads ("slot", `count` a ray) when
    `sampler` is a SlotReader; the stratified kernel hashes its own."""
    if isinstance(sampler, SlotReader):
        tally(work, "slot", count)


def pack_camera(cam):
    """RealisticCamera -> the constant bundle both kernel versions read
    (same keys and values as the JAX package's pack_camera)."""
    lens = cam.lens
    bounds = np.asarray(cam.exit_pupil_bounds, np.float32)
    m = np.asarray(cam.cam_to_world, np.float64)
    return dict(
        curvature=tuple(float(c) for c in lens.curvature),
        thickness=tuple(float(t) for t in lens.thickness),
        eta=tuple(float(e) for e in lens.eta),
        aperture=tuple(float(a) for a in lens.aperture_radius),
        rear_z=float(lens.rear_z),
        bounds=tuple(tuple(float(v) for v in row) for row in bounds),
        cam_to_world=tuple(float(v) for v in m[:3, :4].ravel()),
        extent=(float(cam.extent[0]), float(cam.extent[1])),
        xres=float(cam.film.xres),
        yres=float(cam.film.yres),
        diagonal=float(cam.diagonal_m),
        area0=float(cam.bin_area(0)),
        simple_weighting=bool(cam.spec.simple_weighting),
        shutter=float(cam.spec.shutter_close - cam.spec.shutter_open),
    )


# ---- the CUDA kernel ----


class _Params(ctypes.Structure):
    """Mirror of `struct Params` in csrc/common.cuh."""

    _fields_ = [
        ("max_depth", ctypes.c_int),
        ("rr_threshold", ctypes.c_float),
        ("spp", ctypes.c_int),
        ("xs", ctypes.c_int),
        ("ys", ctypes.c_int),
        ("xs_shift", ctypes.c_int),
        ("jitter", ctypes.c_int),
        ("seed", ctypes.c_uint32),
        ("n_lights", ctypes.c_int),
        ("light_p", ctypes.c_float * (LIGHT_MAX * 3)),
        ("light_emit", ctypes.c_float * (LIGHT_MAX * 3)),
        ("debug", ctypes.c_int),
        ("strategy_all", ctypes.c_int),
        ("can_chain", ctypes.c_int),
        ("has_st", ctypes.c_int),
        ("n_elem", ctypes.c_int),
        ("elem_z", ctypes.c_float * ELEM_MAX),
        ("radius", ctypes.c_float * ELEM_MAX),
        ("zc", ctypes.c_float * ELEM_MAX),
        ("radius2", ctypes.c_float * ELEM_MAX),
        ("aperture2", ctypes.c_float * ELEM_MAX),
        ("eta", ctypes.c_float * ELEM_MAX),
        ("eta2", ctypes.c_float * ELEM_MAX),
        ("n_bins", ctypes.c_int),
        ("bounds", ctypes.c_float * (BIN_MAX * 4)),
        ("half_diag", ctypes.c_float),
        ("xres", ctypes.c_float),
        ("yres", ctypes.c_float),
        ("extent_x", ctypes.c_float),
        ("extent_y", ctypes.c_float),
        ("rear_z", ctypes.c_float),
        ("rear_z_sq", ctypes.c_float),
        ("area0", ctypes.c_float),
        ("shutter", ctypes.c_float),
        ("simple_weighting", ctypes.c_int),
        ("cam_to_world", ctypes.c_float * 12),
    ]


class _WideParams(ctypes.Structure):
    """Mirror of `struct WideParams` in csrc/path_megakernel.cu: the
    lights beyond the point light, the sampled environment, the escape
    radiance and the subsurface branch's constants."""

    _fields_ = [
        ("light_kind", ctypes.c_int * LIGHT_MAX),
        ("area_o2w", ctypes.c_float * (LIGHT_MAX * 12)),
        ("area_w2o", ctypes.c_float * (LIGHT_MAX * 9)),
        ("area_radius", ctypes.c_float * LIGHT_MAX),
        ("all_point", ctypes.c_int),
        ("has_env", ctypes.c_int),
        ("has_esc", ctypes.c_int),
        ("has_spec", ctypes.c_int),
        ("n_sph", ctypes.c_int),
        ("esc_rgb", ctypes.c_float * 3),
        ("world_radius", ctypes.c_float),
        ("env_rgb", ctypes.c_float * 3),
        ("env_nu", ctypes.c_int),
        ("env_nv", ctypes.c_int),
        ("env_marg_cdf", ctypes.c_float * (ENV_BINS + 1)),
        ("env_marg_pdf", ctypes.c_float * ENV_BINS),
        ("env_cond_cdf", ctypes.c_float * (ENV_BINS + 1)),
        ("env_pdf2d", ctypes.c_float * ENV_BINS),
        ("env_cos_bins", ctypes.c_float * ENV_BINS),
        ("env_to_world", ctypes.c_float * 9),
        ("env_to_local", ctypes.c_float * 9),
        ("has_bss", ctypes.c_int),
        ("bss_R", ctypes.c_float * 3),
        ("bss_d", ctypes.c_float * 3),
        ("bss_d3", ctypes.c_float * 3),
        ("bss_sr_den", ctypes.c_float * 3),
        ("bss_pdf1_den", ctypes.c_float * 3),
        ("bss_pdf3_den", ctypes.c_float * 3),
        ("bss_eta", ctypes.c_float),
        ("bss_sw_den", ctypes.c_float),
        ("bss_eta2", ctypes.c_float),
        ("smooth", ctypes.c_int),
        ("slot_row", ctypes.c_short * SLOT_MAX),
    ]


def bss_constants(bss):
    """WideParams' subsurface constants of the BssrdfC `bss`, float32
    values: the python-float products fold in float64 and round once, as
    the JAX kernel's static floats do (_sample_sr_k, _pdf_sr_k, _sw_f_k)."""
    f32 = lambda v: float(np.float32(v))
    per_c = lambda fn: tuple(f32(fn(c)) for c in range(3))
    return dict(
        bss_R=per_c(lambda c: bss.R[c]), bss_d=per_c(lambda c: bss.d[c]),
        bss_d3=per_c(lambda c: 3.0 * bss.d[c]), bss_sr_den=per_c(lambda c: 8.0 * PI * bss.d[c]),
        bss_pdf1_den=per_c(lambda c: 2.0 * PI * bss.d[c]),
        bss_pdf3_den=per_c(lambda c: 6.0 * PI * bss.d[c]),
        bss_eta=f32(bss.eta), bss_sw_den=f32(max(bss.c_sw * PI, 1e-9)),
        bss_eta2=f32(bss.eta * bss.eta),
    )


def _wide_params(packed, reader=None):
    """The kernel's WideParams of `packed`; a SlotReader `reader` (None:
    the stratified sampler) fills the slot-to-row map."""
    w = _WideParams()
    w.smooth = int(packed.smooth)
    if packed.bssrdf is not None:
        w.has_bss = 1
        for k, v in bss_constants(packed.bssrdf).items():
            if isinstance(v, tuple):
                getattr(w, k)[:] = v
            else:
                setattr(w, k, v)
    for k in range(SLOT_MAX):
        w.slot_row[k] = -1
    if reader is not None:
        for slot, row in reader.cols.items():
            w.slot_row[slot] = row
    n_lights = len(packed.light_p)
    kinds = packed.light_kind or (LIGHT_POINT,) * n_lights
    for k in range(n_lights):
        w.light_kind[k] = kinds[k]
        if kinds[k] == LIGHT_DIFFUSE_AREA:
            for j in range(12):
                w.area_o2w[12 * k + j] = packed.light_o2w[k][j]
            for j in range(9):
                w.area_w2o[9 * k + j] = packed.light_w2o[k][j]
            w.area_radius[k] = packed.light_radius[k]
    w.all_point = int(n_lights > 0 and all(k == LIGHT_POINT for k in kinds))
    w.has_spec = int(any(k in SPEC_KINDS for k in packed.kinds_present))
    w.n_sph = 0 if packed.sph_table is None else int(packed.sph_table.shape[0])
    if packed.esc_rgb is not None:
        w.has_esc = 1
        for c in range(3):
            w.esc_rgb[c] = packed.esc_rgb[c]
    w.world_radius = packed.world_radius
    env = packed.env
    if env is not None:
        if env.nu > ENV_BINS or env.nv > ENV_BINS:
            raise ValueError(f"environment distribution {env.nu}x{env.nv} exceeds {ENV_BINS}")
        w.has_env = 1
        w.env_nu, w.env_nv = env.nu, env.nv
        for c in range(3):
            w.env_rgb[c] = env.rgb[c]
        for k, v in enumerate(env.marg_cdf):
            w.env_marg_cdf[k] = v
        for k, v in enumerate(env.marg_pdf):
            w.env_marg_pdf[k] = v
        for k, v in enumerate(env.cond_cdf):
            w.env_cond_cdf[k] = v
        for k, v in enumerate(env.pdf2d_bins):
            w.env_pdf2d[k] = v
        for k, v in enumerate(env.cos_bins):
            w.env_cos_bins[k] = v
        for k in range(9):
            w.env_to_world[k] = env.to_world[k]
            w.env_to_local[k] = env.to_local[k]
    return w


def _kernel_params(packed, cam, sampler, spec):
    """The kernel's parameter block.  Lens constants are folded in float64
    exactly where the plain version folds python floats (element z,
    sphere centre, squared radius and aperture, the refraction ratio and
    its square) and rounded to float32 once."""
    n_lights = len(packed.light_p)
    n_elem = len(cam["curvature"]) if cam is not None else 0
    n_bins = len(cam["bounds"]) if cam is not None else 0
    if not (0 if packed.esc_rgb is not None else 1) <= n_lights <= LIGHT_MAX:
        raise ValueError(f"{n_lights} lights; the kernel takes 1..{LIGHT_MAX}")
    if n_elem > ELEM_MAX or n_bins > BIN_MAX:
        raise ValueError(f"{n_elem} lens elements / {n_bins} pupil bins exceed the kernel's")
    prm = _Params()
    if spec is not None:  # None: the caller sets what its kernel reads
        prm.max_depth = spec.max_depth
        prm.rr_threshold = spec.rr_threshold
    # None or a HaltonSampler: the kernel reads no stratified sampler
    if sampler is not None and not isinstance(sampler, HaltonSampler):
        prm.spp, prm.xs, prm.ys = sampler.spp, sampler.xs, sampler.ys
        prm.xs_shift = sampler.xs.bit_length() - 1
        prm.jitter = int(bool(sampler.jitter))
        prm.seed = sampler.seed & 0xFFFFFFFF
    prm.n_lights = n_lights
    for k in range(n_lights):
        for c in range(3):
            prm.light_p[3 * k + c] = packed.light_p[k][c]
            prm.light_emit[3 * k + c] = packed.light_emit[k][c]
    if cam is None:  # rays-in: no lens
        return prm
    prm.n_elem = n_elem
    element_z = 0.0
    for k, i in enumerate(reversed(range(n_elem))):  # film side first
        element_z -= cam["thickness"][i]
        radius = cam["curvature"][i]
        eta_t = cam["eta"][i - 1] if (i > 0 and cam["eta"][i - 1] != 0.0) else 1.0
        prm.elem_z[k] = element_z
        prm.radius[k] = radius
        prm.zc[k] = element_z + radius
        prm.radius2[k] = radius * radius
        prm.aperture2[k] = cam["aperture"][i] ** 2
        eta = cam["eta"][i] / eta_t
        prm.eta[k] = eta
        prm.eta2[k] = eta * eta
    prm.n_bins = n_bins
    for k, row in enumerate(cam["bounds"]):
        for c in range(4):
            prm.bounds[4 * k + c] = row[c]
    prm.half_diag = cam["diagonal"] / 2.0
    prm.xres, prm.yres = cam["xres"], cam["yres"]
    prm.extent_x, prm.extent_y = cam["extent"]
    prm.rear_z = cam["rear_z"]
    prm.rear_z_sq = cam["rear_z"] * cam["rear_z"]
    prm.area0 = cam["area0"]
    prm.shutter = cam["shutter"]
    prm.simple_weighting = int(cam["simple_weighting"])
    for k, v in enumerate(cam["cam_to_world"]):
        prm.cam_to_world[k] = v
    return prm


def load_library(name, prefix, extra_argtypes=()):
    """Build (on first use) and load csrc/<name>.cu, whose C interface is
    `<prefix>_launch`, `<prefix>_error_string` and `<prefix>_params_size`;
    checks that the parameter block layout agrees with the compiled one.
    `extra_argtypes` follow the launch's common arguments."""
    lib = _build.load(name)
    launch = getattr(lib, f"{prefix}_launch")
    launch.restype = ctypes.c_int
    launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(_Params), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, *extra_argtypes,
    ]
    getattr(lib, f"{prefix}_error_string").restype = ctypes.c_char_p
    getattr(lib, f"{prefix}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{prefix}_params_size").restype = ctypes.c_int
    if getattr(lib, f"{prefix}_params_size")() != ctypes.sizeof(_Params):
        raise RuntimeError(f"{name} parameter block differs from _Params")
    return lib


_WIDE_ARGS = (ctypes.c_void_p, ctypes.POINTER(_WideParams), ctypes.c_void_p)
_CHUNK_ARGS = (ctypes.c_void_p, ctypes.c_int)  # the chunk rows and their count
# the rays-in entries' common arguments: table, n_tris, nodes_f, nodes_i,
# params, o, d, weight, pid, sid, out_l, n, stream
RAYS_LAUNCH_ARGS = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_Params),
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
]


def load_kernel():
    """The path kernel's library (built on first use): the camera entry
    `path_mega_cam_launch` and the rays-in entry `path_mega_rays_launch`,
    both taking the sphere rows, WideParams and the Halton slot matrix
    (null under the stratified sampler) after the common arguments, the
    camera entry then the textured scene's pyramid (null without one) and
    its TexMap, and both then the chunk rows of a brute-force table and
    their count (null and 0 with a BVH) and last the BVH's root_count.
    Over a BVH the common arguments' two node tables are the node64 rows
    (null for a tree that is one leaf) and the leaf rows `prims`
    (geometry_args with `node64`)."""
    lib = load_library("path_megakernel", "path_mega_cam",
                       _WIDE_ARGS + (ctypes.c_void_p, ctypes.POINTER(_TexMap)) + _CHUNK_ARGS
                       + (ctypes.c_int,))
    if lib.path_mega_wide_params_size() != ctypes.sizeof(_WideParams):
        raise RuntimeError("path_megakernel WideParams differs from _WideParams")
    if lib.path_mega_tex_map_size() != ctypes.sizeof(_TexMap):
        raise RuntimeError("path_megakernel TexMap differs from ops/texture._TexMap")
    if lib.path_mega_chunk_max() != CHUNK_MAX:
        raise RuntimeError("path_megakernel's chunk limit differs from CHUNK_MAX")
    rays = lib.path_mega_rays_launch
    rays.restype = ctypes.c_int
    rays.argtypes = RAYS_LAUNCH_ARGS + list(_WIDE_ARGS) + list(_CHUNK_ARGS) + [ctypes.c_int]
    lib.path_mega_occupancy.restype = None
    lib.path_mega_occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


def occupancy(bvh=False):
    """The last brute-force (or, with `bvh`, BVH) launch of the path
    kernel: its block size, blocks resident per SM, registers per thread
    and dynamic shared memory bytes, as the library chose and measured
    them (choose_block)."""
    out = (ctypes.c_int * 4)()
    load_kernel().path_mega_occupancy(int(bvh), out)
    return dict(zip(("block", "blocks_per_sm", "registers", "smem"), out))


def chunk_args(packed, dev):
    """(chunk rows, count) of a brute-force `packed` for a launch on `dev`:
    contiguous float32 (C, CHUNK_COLS), 0 < C <= CHUNK_MAX, for a non-empty
    table; (None, 0) with a BVH or no triangle."""
    chunks = packed.chunks
    if packed.bvh is not None or packed.table.shape[0] == 0:
        return None, 0
    if (chunks is None or chunks.device != dev or chunks.dtype != torch.float32
            or chunks.dim() != 2 or chunks.shape[1] != CHUNK_COLS
            or not 0 < chunks.shape[0] <= CHUNK_MAX or not chunks.is_contiguous()):
        raise ValueError(f"a brute-force table needs contiguous float32 (C, {CHUNK_COLS}) chunk "
                         f"rows, 0 < C <= {CHUNK_MAX}, on {dev} (pack_scene)")
    return chunks, chunks.shape[0]


def _sphere_arg(packed, dev):
    """The sphere rows of `packed`, checked for a launch on `dev`, or None."""
    sph = packed.sph_table
    if sph is None:
        return None
    if (sph.device != dev or sph.dtype != torch.float32 or sph.dim() != 2
            or sph.shape[1] != TABLE_COLS or not 0 < sph.shape[0] <= SPH_MAX
            or not sph.is_contiguous()):
        raise ValueError(f"sphere rows must be contiguous float32 (S, {TABLE_COLS}), "
                         f"0 < S <= {SPH_MAX}, on {dev}")
    return sph


def _sample_indices(s_idx, n, device):
    return torch.as_tensor(s_idx, device=device).to(torch.int64).expand(n)


def li_path_mega_cam(packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec):
    """One fused sample pass: camera rays + bounce loop.

    pixel_xy: (N, 2) float32 integer raster coordinates; the film jitter
    (sampler slot 0) is applied inside.  pixel_id: (N,) integer pixel ids; s_idx: sample
    indices, (N,) or a scalar.  Returns (L (N, 3), weight (N,)).

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    dev = pixel_xy.device
    if dev.type == "cpu":
        return li_path_mega_cam_reference(
            packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec
        )
    return prepare_launch(packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec)()


def slot_reader(packed, spec, sampler, pixel_id, s_idx, with_cam):
    """The SlotReader of a HaltonSampler on this batch, or None for the
    stratified sampler, whose hash the kernel evaluates itself."""
    if not isinstance(sampler, HaltonSampler):
        return None
    sid = _sample_indices(s_idx, pixel_id.shape[0], pixel_id.device)
    return SlotReader(sampler, packed, spec, pixel_id, sid, with_cam)


def prepare_launch(packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec):
    """Check the CUDA inputs, build the parameter block, the outputs and,
    under a HaltonSampler, the slot matrix, and return launch(): one
    kernel launch on the current stream returning (L, weight).
    Relaunching rewrites the same outputs."""
    prm = _kernel_params(packed, cam_packed, sampler, spec)
    dev = pixel_xy.device
    reader = slot_reader(packed, spec, sampler, pixel_id, s_idx, True)
    wide = _wide_params(packed, reader)
    sph = _sphere_arg(packed, dev)
    tex, tm = packed.tex, _TexMap()
    if tex is not None:
        if reader is not None or packed.smooth or packed.bssrdf is not None:
            raise ValueError("the textured instances take the stratified sampler, flat shading "
                             "and no subsurface branch")
        if tex.pyr.data.device != dev or not tex.pyr.data.is_contiguous():
            raise ValueError(f"the texture's pyramid must be contiguous on {dev}")
        tm = tex_map(tex.pyr, tex.rec, sampler.spp)
    return launcher(load_kernel(), "path_mega_cam", packed, pixel_xy, pixel_id, s_idx, prm,
                    LAUNCHES, extra=(sph, ctypes.byref(wide), reader and reader.u,
                                     None if tex is None else tex.pyr.data, ctypes.byref(tm),
                                     *chunk_args(packed, dev), root_count(packed)),
                    allow_empty=sph is not None, node64=True,
                    variant=kernel_name("", halton=reader is not None, smooth=packed.smooth,
                                        bss=packed.bssrdf is not None, tex=tex is not None))


def li_path_mega(packed, o, d, weight, pixel_id, s_idx, sampler, spec):
    """The bounce loop on given rays (kernels #3 and #4 of the JAX
    package, `li_path_mega`): o, d (N, 3) float32, weight (N,) (a ray with
    weight <= 0 is not traced), pixel_id (N,) integer pixel ids, s_idx
    (N,) or a scalar.  Returns L (N, 3).

    CPU tensors run the plain version; CUDA tensors launch the kernel.  A
    textured scene raises: given rays carry no differentials."""
    if o.device.type == "cpu":
        return li_path_mega_reference(packed, o, d, weight, pixel_id, s_idx, sampler, spec)
    return prepare_rays_launch(packed, o, d, weight, pixel_id, s_idx, sampler, spec)()


def _no_texture_on_given_rays(packed):
    if packed.tex is not None:
        raise NotImplementedError(f"{TEXTURED_KD} on given rays (the rays-in kernels take no "
                                  "ray differentials)")


def prepare_rays_launch(packed, o, d, weight, pixel_id, s_idx, sampler, spec):
    """launch() of the rays-in kernel on the current stream, returning L;
    every accepted launch adds one to LAUNCHES of its instance
    (kernel_name)."""
    if o.device.type != "cuda":
        raise ValueError(f"the path_mega kernel runs on cuda tensors, not {o.device}")
    _no_texture_on_given_rays(packed)
    prm = _kernel_params(packed, None, sampler, spec)
    reader = slot_reader(packed, spec, sampler, pixel_id, s_idx, False)
    u = reader and reader.u
    wide = _wide_params(packed, reader)
    sph = _sphere_arg(packed, o.device)
    return rays_launcher(load_kernel(), "path_mega", packed, o, d, weight, pixel_id, s_idx, prm,
                         LAUNCHES, extra=(sph, ctypes.byref(wide), u,
                                          *chunk_args(packed, o.device), root_count(packed)),
                         allow_empty=sph is not None, node64=True,
                         variant=kernel_name("", halton=u is not None, smooth=packed.smooth,
                                             bss=packed.bssrdf is not None))


def rays_launcher(lib, prefix, packed, o, d, weight, pixel_id, s_idx, prm, launches, extra=(),
                  allow_empty=False, variant="", node64=False):
    """launch() for the rays-in entry `<prefix>_rays_launch` of `lib`
    (errors named by `<prefix>_cam_error_string`) on the current stream,
    returning L (N, 3): o, d (N, 3) float32, weight
    (N,), pixel_id (N,) integer, s_idx (N,) or a scalar; `extra`,
    arguments after the common ones (RAYS_LAUNCH_ARGS), kept alive with
    it (None passes a null pointer); the BVH's tables as geometry_args
    gives them with `node64`.  Every accepted launch adds one to
    `launches[prefix + variant]` (`prefix + "_bvh" + variant` for the BVH
    kernel)."""
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"the {prefix} kernel runs on cuda tensors, not {dev}")
    n = o.shape[0]
    if (o.dtype != torch.float32 or d.dtype != torch.float32 or o.shape != (n, 3)
            or d.shape != (n, 3) or n == 0 or d.device != dev):
        raise ValueError("o and d must be float32 (N, 3) on one device, N > 0")
    if weight.shape != (n,) or weight.device != dev:
        raise ValueError("weight must be an (N,) tensor on o's device")
    if pixel_id.shape != (n,) or pixel_id.is_floating_point() or pixel_id.device != dev:
        raise ValueError("pixel_id must be an integer (N,) tensor on o's device")
    table, nodes_f, nodes_i = geometry_args(packed, dev, allow_empty, node64)
    oc, dc = o.contiguous(), d.contiguous()
    wc = weight.to(torch.float32).contiguous()
    pid32 = pixel_id.to(torch.int32).contiguous()
    sid32 = _sample_indices(s_idx, n, dev).to(torch.int32).contiguous()
    out_l = torch.empty((n, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = getattr(lib, f"{prefix}_rays_launch")
    ptr = lambda t: None if t is None else t.data_ptr()
    extra_args = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in extra)
    name = prefix + ("" if packed.bvh is None else "_bvh") + variant

    def launch():
        err = fn(
            ptr(table) if table.shape[0] else None, table.shape[0], ptr(nodes_f), ptr(nodes_i),
            ctypes.byref(prm), oc.data_ptr(), dc.data_ptr(), wc.data_ptr(), pid32.data_ptr(),
            sid32.data_ptr(), out_l.data_ptr(), n, stream, *extra_args,
        )
        if err != 0:
            msg = getattr(lib, f"{prefix}_cam_error_string")(err).decode()
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
        launches[name] += 1
        return out_l

    launch.keep = (extra, oc, dc, wc, pid32, sid32)
    return launch


def root_count(packed):
    """The rows of a BVH that is one leaf (an argument of the path, direct
    and Volpath kernels); 0 for a tree with interior rows, or brute force."""
    return 0 if packed.bvh is None else packed.bvh.root_count


def geometry_args(packed, dev, allow_empty=False, node64=False):
    """(table, nodes_f, nodes_i) of `packed`, checked for a launch on `dev`:
    a contiguous float32 (T, TABLE_COLS) table with 0 < T <= TRI_MAX
    (BVH_TRI_MAX with a BVH; T = 0 allowed with `allow_empty`) and the
    BVH's node tables, None without.  With `node64` (the path, direct and
    Volpath kernels) the BVH's tables are (nodes64, prims) instead: the node64 rows, None for a
    tree that is one leaf of root_count rows, and the (T, PRIM_COLS) leaf
    rows."""
    table, bvh = packed.table, packed.bvh
    t_max = TRI_MAX if bvh is None else BVH_TRI_MAX
    if (
        table.device != dev
        or table.dtype != torch.float32
        or table.dim() != 2
        or table.shape[1] != TABLE_COLS
        or not (0 if allow_empty else 1) <= table.shape[0] <= t_max
        or not table.is_contiguous()
    ):
        raise ValueError(
            f"packed table must be contiguous float32 (T, {TABLE_COLS}), "
            f"0 < T <= {t_max}, on {dev}"
        )
    if bvh is None:
        return table, None, None
    if node64:
        nodes64, prims, t = bvh.nodes64, bvh.prims, table.shape[0]
        if (
            nodes64 is None or prims is None
            or nodes64.device != dev or prims.device != dev
            or nodes64.dtype != torch.float32 or prims.dtype != torch.float32
            or nodes64.dim() != 2 or nodes64.shape[1] != 16 or prims.shape != (t, PRIM_COLS)
            or not (nodes64.is_contiguous() and prims.is_contiguous())
            or (nodes64.shape[0] == 0) != (bvh.root_count > 0) or not 0 <= bvh.root_count <= t
        ):
            raise ValueError(f"BVH tables must be contiguous float32 node64 rows (I, 16) and leaf "
                             f"rows (T, {PRIM_COLS}) on {dev}, root_count > 0 exactly where I = 0")
        return table, (nodes64 if nodes64.shape[0] else None), prims
    nodes_f, nodes_i = bvh.nodes_f, bvh.nodes_i
    m = nodes_f.shape[0]
    if (
        nodes_f.device != dev or nodes_i.device != dev
        or nodes_f.dtype != torch.float32 or nodes_i.dtype != torch.int32
        or nodes_f.shape != (m, 16) or nodes_i.shape != (m, 4)
        or not (nodes_f.is_contiguous() and nodes_i.is_contiguous())
    ):
        raise ValueError(f"BVH nodes must be contiguous (M, 16) float32 and (M, 4) int32 on {dev}")
    return table, nodes_f, nodes_i


def launcher(lib, prefix, packed, pixel_xy, pixel_id, s_idx, prm, launches, extra=(),
             allow_empty=False, variant="", node64=False):
    """launch() for a camera-fused kernel of `lib` (see prepare_launch);
    `extra`, arguments after the common ones, are kept alive with it
    (None passes a null pointer); the BVH's tables as geometry_args gives
    them with `node64`.  Every accepted launch adds one to
    `launches[prefix + variant]`, or to `launches[prefix + "_bvh" +
    variant]` for the BVH kernel."""
    dev = pixel_xy.device
    if dev.type != "cuda":
        raise ValueError(f"the {prefix} kernel runs on cuda tensors, not {dev}")
    n = pixel_xy.shape[0]
    if pixel_xy.dtype != torch.float32 or pixel_xy.shape != (n, 2) or n == 0:
        raise ValueError("pixel_xy must be float32 of shape (N, 2), N > 0")
    if pixel_id.shape != (n,) or pixel_id.is_floating_point() or pixel_id.device != dev:
        raise ValueError("pixel_id must be an integer (N,) tensor on pixel_xy's device")
    table, nodes_f, nodes_i = geometry_args(packed, dev, allow_empty, node64)
    pxy = pixel_xy.contiguous()
    # u32 ids travel as their int32 bit patterns
    pid32 = pixel_id.to(torch.int32).contiguous()
    sid32 = _sample_indices(s_idx, n, dev).to(torch.int32).contiguous()
    out_l = torch.empty((n, 3), dtype=torch.float32, device=dev)
    out_w = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = getattr(lib, f"{prefix}_launch")
    nf = None if nodes_f is None else nodes_f.data_ptr()
    ni = None if nodes_i is None else nodes_i.data_ptr()
    extra_args = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in extra)
    table_ptr = table.data_ptr() if table.shape[0] else None
    name = prefix + ("" if packed.bvh is None else "_bvh") + variant

    def launch():
        err = fn(
            table_ptr, table.shape[0], nf, ni, ctypes.byref(prm),
            pxy.data_ptr(), pid32.data_ptr(), sid32.data_ptr(),
            out_l.data_ptr(), out_w.data_ptr(), n, stream, *extra_args,
        )
        if err != 0:
            msg = getattr(lib, f"{prefix}_error_string")(err).decode()
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
        launches[name] += 1
        return out_l, out_w

    return launch


# ---- the plain PyTorch version ----
#
# Flat (N,) float32 tensors, masked lanes, the same expressions in the
# same order as the kernel (and as the JAX kernel's jnp code): python
# floats fold in float64 and round once, as weakly typed scalars do in
# JAX.  1 / sqrt stands for every reciprocal square root.


def _where(cond, a, b):
    """torch.where that also takes a python bool condition."""
    if isinstance(cond, bool):
        return a if cond else b
    return torch.where(cond, a, b)


def _raygen(px, py, pid, sid, sampler, cam):
    """Componentwise RealisticCamera ray generation (camera.rs:534-580),
    ops/path_megakernel._raygen.  Returns (ox, oy, oz, dx, dy, dz, weight)
    in world space."""
    uf = sampler.get_2d(pid, sid, CAMERA_FILM)
    ul = sampler.get_2d(pid, sid, CAMERA_LENS)
    # a number divides through vec.div: once rounded, as in the kernel
    sx = _div(px + uf[:, 0], cam["xres"])
    sy = _div(py + uf[:, 1], cam["yres"])
    pfx = -((sx - 0.5) * cam["extent"][0])
    pfy = (sy - 0.5) * cam["extent"][1]

    # exit pupil sample (camera.rs:492-521)
    r_film = torch.sqrt(pfx * pfx + pfy * pfy)
    n_bins = len(cam["bounds"])
    r_idx = torch.clamp(
        (_div(r_film, cam["diagonal"] / 2.0) * n_bins).to(torch.int64), 0, n_bins - 1
    )
    b = torch.tensor(cam["bounds"], dtype=DTYPE, device=px.device)[r_idx]
    b0, b1, b2, b3 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    prx = b0 + ul[:, 0] * (b2 - b0)
    pry = b1 + ul[:, 1] * (b3 - b1)
    area = (b2 - b0) * (b3 - b1)
    nz = r_film != 0.0
    safe_r = torch.where(nz, r_film, 1.0)
    sin_t = torch.where(nz, pfy / safe_r, 0.0)
    cos_t = torch.where(nz, pfx / safe_r, 1.0)
    rearx = cos_t * prx - sin_t * pry
    reary = sin_t * prx + cos_t * pry

    dx0 = rearx - pfx
    dy0 = reary - pfy
    # dz starts as the python float rear_z, as in the JAX kernel: its
    # square folds in float64 until the first refraction makes it a tensor
    dz0 = cam["rear_z"] - 0.0
    # the weight's cos^4 uses the pre-trace direction (camera.rs:569-571)
    dlen = torch.sqrt(torch.clamp(dx0 * dx0 + dy0 * dy0 + dz0 * dz0, min=1e-30))
    cos_theta = _div(dz0, dlen)
    c2 = cos_theta * cos_theta
    cos4 = c2 * c2

    # film-side trace through every element; lens space flips z
    ox, oy, oz = pfx, pfy, torch.zeros_like(pfx)
    dx, dy, dz = dx0, dy0, -dz0
    alive = torch.ones_like(pfx, dtype=torch.bool)
    element_z = 0.0
    n_elem = len(cam["curvature"])
    for i in reversed(range(n_elem)):
        element_z -= cam["thickness"][i]
        radius = cam["curvature"][i]
        is_stop = radius == 0.0
        if is_stop:
            ok = dz < 0.0
            t = (element_z - oz) / _where(ok, dz, -1.0)
        else:
            zc = element_z + radius
            ocx, ocy, ocz = ox, oy, oz - zc
            a = dx * dx + dy * dy + dz * dz
            bq = 2.0 * (dx * ocx + dy * ocy + dz * ocz)
            cq = ocx * ocx + ocy * ocy + ocz * ocz - radius * radius
            disc = bq * bq - 4.0 * a * cq
            ok = disc >= 0.0
            root = torch.sqrt(torch.clamp(disc, min=0.0))
            q = torch.where(bq < 0.0, -0.5 * (bq - root), -0.5 * (bq + root))
            t0 = q / a
            t1 = cq / torch.where(q == 0.0, 1.0, q)
            lo = torch.minimum(t0, t1)
            hi = torch.maximum(t0, t1)
            use_closer = (dz > 0.0) != (radius < 0.0)
            t = _where(use_closer, lo, hi)
            ok = ok & (t >= 0.0)
        hx = ox + dx * t
        hy = oy + dy * t
        hz = oz + dz * t
        ok = ok & (hx * hx + hy * hy < cam["aperture"][i] ** 2)
        alive = alive & ok
        ox = torch.where(alive, hx, ox)
        oy = torch.where(alive, hy, oy)
        oz = torch.where(alive, hz, oz)
        if not is_stop:
            pcx, pcy, pcz = ox, oy, oz - zc
            ninv = _rsqrt(torch.clamp(pcx * pcx + pcy * pcy + pcz * pcz, min=1e-30))
            nx, ny, nz_ = pcx * ninv, pcy * ninv, pcz * ninv
            flip = (nx * dx + ny * dy + nz_ * dz) > 0.0
            nx = torch.where(flip, -nx, nx)
            ny = torch.where(flip, -ny, ny)
            nz_ = torch.where(flip, -nz_, nz_)
            eta_t = cam["eta"][i - 1] if (i > 0 and cam["eta"][i - 1] != 0.0) else 1.0
            eta = cam["eta"][i] / eta_t
            dinv = _rsqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-30))
            wix, wiy, wiz = -dx * dinv, -dy * dinv, -dz * dinv
            cos_i = nx * wix + ny * wiy + nz_ * wiz
            sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
            sin2_t = eta * eta * sin2_i
            rok = sin2_t < 1.0
            cos_tr = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
            fac = eta * cos_i - cos_tr
            alive = alive & rok
            dx = torch.where(alive, -wix * eta + nx * fac, dx)
            dy = torch.where(alive, -wiy * eta + ny * fac, dy)
            dz = torch.where(alive, -wiz * eta + nz_ * fac, dz)
    oz = -oz  # lens -> camera space
    dz = -dz

    m = cam["cam_to_world"]
    wx = m[0] * ox + m[1] * oy + m[2] * oz + m[3]
    wy = m[4] * ox + m[5] * oy + m[6] * oz + m[7]
    wz = m[8] * ox + m[9] * oy + m[10] * oz + m[11]
    vx = m[0] * dx + m[1] * dy + m[2] * dz
    vy = m[4] * dx + m[5] * dy + m[6] * dz
    vz = m[8] * dx + m[9] * dy + m[10] * dz
    vinv = 1.0 / torch.clamp(torch.sqrt(vx * vx + vy * vy + vz * vz), min=1e-30)
    if cam["simple_weighting"]:
        weight = _div(cos4 * area, cam["area0"])
    else:
        weight = cam["shutter"] * (cos4 * area)
    weight = torch.where(alive, weight, 0.0)
    return wx, wy, wz, vx * vinv, vy * vinv, vz * vinv, weight


def _mt(g, ox, oy, oz, dx, dy, dz):
    """Moller-Trumbore against triangle rows g = (p0, e1, e2): nine python
    floats, or nine tensors broadcasting against the ray.  Returns (hit
    before any t_max test, t)."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = g
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) >= TRI_EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    hit = ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= TRI_EPS)
    return hit, t


def _inv_dir(d):
    tiny = torch.where(d < 0.0, -1e-20, 1e-20)
    return 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)


REJECT_SLOP = 1.0 + 2.0**-16  # csrc/common.cuh mt_reject's margins
REJECT_TINY = 2.0**-100
TRI_EPS_LO = 9.9998e-8


def mt_reject(g, ox, oy, oz, dx, dy, dz, t_bound):
    """csrc/common.cuh's division-free early reject before Moller-Trumbore,
    expression for expression (the kernels run it; the plain walks test
    every row with _mt, whose answer it never changes): True only where
    _mt gives no hit or a t >= t_bound."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = g
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    a = torch.abs(det)
    neg = det < 0.0
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    un = tvx * pvx + tvy * pvy + tvz * pvz
    su = torch.where(neg, -un, un)
    tiny, top = a * REJECT_TINY, a * REJECT_SLOP
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vn = dx * qvx + dy * qvy + dz * qvz
    sv = torch.where(neg, -vn, vn)
    tn = e2x * qvx + e2y * qvy + e2z * qvz
    st = torch.where(neg, -tn, tn)
    return (~(a >= TRI_EPS) | (su < -tiny) | (su > top) | (sv < -tiny) | (su + sv > top)
            | (st < a * TRI_EPS_LO) | (st > a * t_bound * REJECT_SLOP))


def _chunk_hit(b, ox, oy, oz, ix, iy, iz, t_bound):
    """csrc/common.cuh chunk_hit: the slab test of the chunk box b (a chunk
    row's python floats) against [0, t_bound (1 + 2^-7)]; fmin / fmax as
    fminf / fmaxf."""
    t0x, t1x = (b[0] - ox) * ix, (b[3] - ox) * ix
    t0y, t1y = (b[1] - oy) * iy, (b[4] - oy) * iy
    t0z, t1z = (b[2] - oz) * iz, (b[5] - oz) * iz
    tlo = torch.fmax(torch.fmax(torch.fmin(t0x, t1x), torch.fmin(t0y, t1y)), torch.fmin(t0z, t1z))
    thi = torch.fmin(torch.fmin(torch.fmax(t0x, t1x), torch.fmax(t0y, t1y)), torch.fmax(t0z, t1z))
    return (tlo <= torch.fmin(thi, t_bound * CULL_SLOP)) & (thi >= 0.0)


WARP = 32  # a warp's lanes: consecutive rays of a batch


def _warps(x):
    """x (N,) as (ceil(N / WARP), WARP): the rays of each warp, the last
    padded with zeros."""
    return torch.nn.functional.pad(x, (0, -x.numel() % WARP)).view(-1, WARP)


def chunk_walk(cols, chunks, ox, oy, oz, dx, dy, dz, t_bound, live, any_hit, work=None):
    """The chunked brute-force walk (csrc/common.cuh ChunkGeometry) of the
    live rays over the (9, T) geometry columns `cols` and the chunk rows
    `chunks` ((C, CHUNK_COLS) float32): each chunk in table order, its box
    slab-tested against the ray's current t bound, its rows tested (table
    order, strict <) where the box is hit.  Returns (t, row): t_bound (a
    per-ray tensor) and -1 where nothing is hit; with any_hit a ray stops at
    its first hit in table order (its row; its t is then t_bound).  `work` gets the slab tests
    ("slab") and the rows tested ("mt"), as the kernel makes them, and the
    rows the walk over every row would test ("mt_brute": all of them, or
    up to the first hit of an any-hit walk, which is the same row); and as
    a warp of WARP consecutive rays runs them, where the rays are the
    kernel's lanes in order: the chunks whose rows a warp runs because any
    of its lanes hits the box ("chunk_warp"), their rows ("mt_warp"), and
    the rows the walk over every row runs a warp, until its last lane is
    done ("mt_brute_warp")."""
    t_best = t_bound.clone()
    best = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
    inv = tuple(_inv_dir(c) for c in (dx, dy, dz))
    ray = (ox, oy, oz, dx, dy, dz)
    slabs = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
    tests = torch.zeros_like(slabs)
    runs = torch.zeros(-(-ox.numel() // WARP), dtype=torch.int64, device=ox.device)
    run_rows = torch.zeros_like(runs)
    for row in chunks.tolist():
        lo, hi = int(row[6]), int(row[7])
        walking = live & (best < 0) if any_hit else live
        slabs = slabs + walking
        box = walking & _chunk_hit(row, ox, oy, oz, *inv, t_best)
        if work is not None:
            run = _warps(box).any(1)
            runs, run_rows = runs + run, run_rows + (hi - lo) * run
        idx = torch.nonzero(box).squeeze(1)
        hit, t = _mt(cols[:, lo:hi], *(c[idx, None] for c in ray))
        hit = hit & (t < t_best[idx, None])
        found = hit.any(1)
        if any_hit:
            # the kernel stops at the first hit: it tests the chunk up to it
            first = hit.int().argmax(1)
            tests[idx] += torch.where(found, first + 1, hi - lo)
            best[idx] = torch.where(found, lo + first, best[idx])
        else:
            tests[idx] += hi - lo
            # min takes the first of equal t: ties keep the lower row
            t_c, j_c = torch.where(hit, t, BIG_T).min(1)
            t_best[idx] = torch.where(found, t_c, t_best[idx])
            best[idx] = torch.where(found, lo + j_c, best[idx])
    tally(work, "slab", slabs)
    tally(work, "mt", tests)
    n_rows = cols.shape[1]
    brute = live * (torch.where(best >= 0, best + 1, n_rows) if any_hit else n_rows)
    tally(work, "mt_brute", brute)
    if work is not None:
        tally(work, "chunk_warp", runs)
        tally(work, "mt_warp", run_rows)
        tally(work, "mt_brute_warp", _warps(brute).amax(1))
    return t_best, best


def _slab(b, ox, oy, oz, ix, iy, iz, t_cur):
    """Slab test of the boxes b[:, 0:6] = (min xyz, max xyz) with the
    traversal's t bound (ops/bvh_pallas._slab6)."""
    return _slab_tn(b, ox, oy, oz, ix, iy, iz, t_cur)[0]


def _slab_tn(b, ox, oy, oz, ix, iy, iz, t_cur):
    """_slab, and each box's entry distance tn (the BVH4 walk orders its
    pushes by it)."""
    t0x, t1x = (b[:, 0] - ox) * ix, (b[:, 3] - ox) * ix
    t0y, t1y = (b[:, 1] - oy) * iy, (b[:, 4] - oy) * iy
    t0z, t1z = (b[:, 2] - oz) * iz, (b[:, 5] - oz) * iz
    tn = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)), torch.minimum(t0z, t1z)
    )
    tf = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)), torch.maximum(t0z, t1z)
    ) * 1.0000004
    return (tn <= tf) & (tf > 0.0) & (tn < t_cur) & (t_cur > 0.0), tn


def tally(work, key, count):
    """work[key] += count.sum(), on the device (no host sync); `work` is
    None when nobody counts."""
    if work is not None:
        work[key] = work.get(key, 0) + count.sum()


# FP32 operations of one Disney lobe's f and pdf, counted from common.cuh's
# lobe_f / lobe_pdf (each add, multiply, divide, square root, min / max,
# abs and compare one; log10f sixteen), beyond the 3 of every lobe
# evaluation ("lobe"): f, then pdf
DISNEY_OPS = {
    LOBE_DISNEY_DIFFUSE: (41 - 3, 10),
    LOBE_DISNEY_RETRO: (50 - 3, 10),
    LOBE_DISNEY_SHEEN: (47 - 3, 10),
    LOBE_DISNEY_CLEARCOAT: (81 - 3, 62),
    LOBE_DISNEY_MICROFACET_REFL: (201 - 3, 100),
}
_OPS_F = torch.zeros(32, dtype=torch.int64)  # by kind code
_OPS_PDF = torch.zeros(32, dtype=torch.int64)
for _k, (_f, _p) in DISNEY_OPS.items():
    _OPS_F[_k], _OPS_PDF[_k] = _f, _p


def tally_lobe(work, mask, kind, pdf):
    """One lobe evaluation on the lanes of `mask` ("lobe"), and for the
    Disney kinds their operations beyond it ("disney_ops"): f, and the
    pdf too where `pdf`."""
    if work is None:
        return
    tally(work, "lobe", mask)
    ops = _OPS_F + _OPS_PDF if pdf else _OPS_F
    tally(work, "disney_ops", torch.where(mask, ops.to(kind.device)[kind.long()], 0))


PLAIN_BLOCK = 1 << 22  # elements of the (rays, triangles) block a brute-force plain test takes


def walk_node64(rows, geo, max_leaf, stack_depth, o, d, t_max, live, any_hit, work=None):
    """The binary walk over the node64 rows `rows` (accel/bvh
    .pack_node64_tables; csrc/common.cuh Bvh64) and the leaf-order rows
    whose cols 0:9 are `geo`, of the live lanes' rays o, d (N, 3), the rays
    still walking compacted after every step.  A step either fetches an
    interior row, slab-tests both children against the ray's best t, goes
    on into the near hit child (by the sign of the ray's direction on the
    split axis) and pushes the far one, with its leaf count, only where
    both are hit; or tests a leaf's rows in leaf order with strict < (any
    hit: stops at the first); a step that hits nothing pops.  That is the
    order of the walk over the fused-children rows (PlainGeometry.walk
    with no node64 rows, which pushes the near child and pops it at once),
    so t, the row and any hit's row are its own.  A tree with no row is
    one leaf of every row of `geo`.  Returns (t, leaf-order row, steps:
    the rows fetched and leaves tested per ray), t_max, -1 and 0 where the
    lane is not live or t_max <= 0; `work` gets the slab and
    Moller-Trumbore tests the kernel makes ("slab", "mt") and the interior
    rows it fetches ("node")."""
    dev = o.device
    count_bits = LEAF_COUNT_BITS
    count_mask = (1 << count_bits) - 1
    leaf_root = rows.shape[0] == 0
    if leaf_root:
        if geo.shape[0] > count_mask:
            raise NotImplementedError(f"a leaf of {geo.shape[0]} triangles (a node64 walk "
                                      f"takes leaf counts below {1 << count_bits})")
        rows = torch.zeros((1, rows.shape[1]), dtype=rows.dtype, device=dev)
    boxes = rows[:, :12]
    refs = rows.view(torch.int32)[:, 12:16].to(torch.int64)  # left, right, axis, counts
    # each child as one key, reference << LEAF_COUNT_BITS | leaf count (the
    # walk's state and its stack entries): (I, 2) left, right
    kids = torch.stack([refs[:, 0] << count_bits | refs[:, 3] & count_mask,
                        refs[:, 1] << count_bits | refs[:, 3] >> count_bits], -1)
    axis = refs[:, 2]
    t_out = t_max.clone()
    row_out = torch.full(t_max.shape, -1, dtype=torch.int64, device=dev)
    steps_out = torch.zeros_like(row_out)
    idx = torch.nonzero(live & (t_max > 0.0)).squeeze(1)
    ro, rd = o[idx].unbind(-1), d[idx].unbind(-1)
    inv = tuple(_inv_dir(c) for c in rd)
    tb = t_max[idx]
    best = torch.full_like(idx, -1)
    key = torch.full_like(idx, (-1 << count_bits | geo.shape[0]) if leaf_root else 0)
    steps = torch.zeros_like(idx)
    m = idx.numel()
    stack = torch.zeros((m, stack_depth), dtype=torch.int64, device=dev)
    sp = torch.zeros_like(idx)
    k = torch.arange(max(max_leaf, geo.shape[0] if leaf_root else 0), device=dev)
    while m:
        lane = torch.arange(m, device=dev)
        steps = steps + 1
        ref, count = key >> count_bits, key & count_mask
        inner = ref >= 0
        # an interior row: both children's boxes against the best t
        r = torch.where(inner, ref, 0)
        b = boxes[r]
        hit_l = inner & _slab(b[:, 0:6], *ro, *inv, tb)
        hit_r = inner & _slab(b[:, 6:12], *ro, *inv, tb)
        tally(work, "slab", 2 * inner)
        tally(work, "node", inner)
        ax = axis[r]
        d_ax = torch.where(ax == 0, rd[0], torch.where(ax == 1, rd[1], rd[2]))
        near_left = d_ax >= 0.0
        kl, kr = kids[r].unbind(-1)
        near, far = torch.where(near_left, kl, kr), torch.where(near_left, kr, kl)
        hit_near = torch.where(near_left, hit_l, hit_r)
        hit_far = torch.where(near_left, hit_r, hit_l)
        push = hit_near & hit_far
        slot = sp.clamp(max=stack_depth - 1)  # the packer sizes the stack
        stack[lane, slot] = torch.where(push, far, stack[lane, slot])
        sp = sp + push
        nxt = torch.where(hit_near, near, far)
        # a leaf: its rows in leaf order
        first_row = -1 - ref
        valid = ~inner[:, None] & (k < count[:, None])
        g = geo[torch.where(valid, first_row[:, None] + k, 0)].unbind(-1)
        hit, t = _mt(g, *(x[:, None] for x in ro + rd))
        hit = valid & hit & (t < tb[:, None])
        found = hit.any(1)
        if any_hit:
            # the kernel stops at the first hit: it tests the leaf up to it
            first = torch.where(hit, k, k.numel()).min(1).values
            tally(work, "mt", torch.where(found, first + 1, valid.sum(1)))
            best = torch.where(found, first_row + first, best)
        else:
            tally(work, "mt", valid)
            tm = torch.where(hit, t, BIG_T)
            t_min = tm.min(1).values
            first = torch.where(hit & (tm == t_min[:, None]), k, k.numel()).min(1).values
            tb = torch.where(found, t_min, tb)
            best = torch.where(found, first_row + first, best)
        # a leaf, or a row with neither child hit: pop
        pop = ~inner | ~(hit_near | hit_far)
        popped = pop & (sp > 0)
        sp = sp - popped.long()
        key = torch.where(popped, stack[lane, sp.clamp(min=0)], nxt)
        done = (pop & ~popped) | (found if any_hit else False)
        if bool(done.any()):
            t_out[idx[done]] = tb[done]
            row_out[idx[done]] = best[done]
            steps_out[idx[done]] = steps[done]
            keep = ~done
            idx, tb, best, steps, key = idx[keep], tb[keep], best[keep], steps[keep], key[keep]
            stack, sp = stack[keep], sp[keep]
            ro = tuple(c[keep] for c in ro)
            rd = tuple(c[keep] for c in rd)
            inv = tuple(c[keep] for c in inv)
            m = idx.numel()
    return t_out, row_out, steps_out


def tally_steps(work, tag, steps, walked):
    """A batch of walks' lengths (walk_node64's steps) under `tag`: the
    walks ("<tag>_walks") and their steps ("<tag>_steps"), and per warp of
    WARP consecutive lanes with a walk ("<tag>_warps") its longest walk
    ("<tag>_warp_steps"), the steps the warp's lanes wait on together."""
    if work is None:
        return
    tally(work, f"{tag}_walks", walked)
    tally(work, f"{tag}_steps", steps)
    tally(work, f"{tag}_warps", _warps(walked.long()).any(1))
    tally(work, f"{tag}_warp_steps", _warps(steps).amax(1))


class PlainGeometry:
    """The kernels' geometry (csrc/common.cuh: Geometry, ChunkGeometry,
    Bvh64) on flat (N,) tensors.  Brute force: every triangle in table
    order, strict < (ties keep the lower row), a block of triangles tested
    at a time.  BVH: the per-ray walk of the node64 rows (walk_node64, the
    Bvh64 walk of the path, direct and Volpath kernels), the rays that
    still walk compacted after every step; or, where the tables have no
    node64 rows, the stack walk of the fused-children rows (Geometry<true>,
    the walk the node64 walk replaced): at an
    interior node both children's boxes are slab-tested against the ray's
    best t and only hit children are pushed, the near child (by the sign
    of the ray's direction on the split axis) last; a leaf tests its
    triangles in table order with strict <.  Both visit in one order and
    make the same tests, so they find the same hits.  `work`, when given,
    counts the Moller-Trumbore ("mt") and slab ("slab") tests of the live
    rays, as the kernel performs them, the interior rows fetched ("node")
    and each walk's steps, the nodes it visits (tally_steps, tagged
    "closest", "any" or the caller's `tag`): equal over both trees' rows.
    With `cull` (K1's, K2's, K6's,
    K8's and K9's plain versions; the other kernels walk every row) brute force
    takes the chunked walk over `packed.chunks` (chunk_walk), which finds
    the same hits."""

    def __init__(self, packed, device, work=None, cull=False):
        self.table = packed.table.to(device)
        self.work = work
        self.bvh = packed.bvh
        self.chunks = None
        if self.bvh is None:
            self.cols = self.table[:, :9].T.contiguous()  # (9, T): p0, e1, e2
            if cull and packed.chunks is not None:
                self.chunks = packed.chunks.to(device)
        elif self.bvh.nodes64 is not None:
            self.nodes64 = self.bvh.nodes64.to(device)
            self.geo = self.bvh.prims.to(device)[:, :GEO_COLS]
        else:
            self.nodes64 = None
            self.geo = self.table[:, :9].contiguous()
            self.nodes_f = self.bvh.nodes_f.to(device)
            self.nodes_i = self.bvh.nodes_i.to(device).to(torch.int64)

    def closest(self, ox, oy, oz, dx, dy, dz, live, t_lim=BIG_T, tag="closest"):
        """(t, row) of the closest hit with t < t_lim (a float or per ray),
        t = t_lim and row -1 on a miss; a lane that is not live reports a
        miss.  `tag` names the walks' steps in `work`."""
        if self.bvh is not None:
            return self.walk(ox, oy, oz, dx, dy, dz, torch.zeros_like(ox) + t_lim, live, False,
                             tag)
        if self.chunks is not None:
            return chunk_walk(self.cols, self.chunks, ox, oy, oz, dx, dy, dz,
                              torch.zeros_like(ox) + t_lim, live, False, self.work)
        t_best = torch.zeros_like(ox) + t_lim
        best = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
        for j, g, ray in self._blocks(ox, oy, oz, dx, dy, dz):
            hit, t = _mt(g, *ray)
            # min takes the first of equal t: ties keep the lower row
            t_c, j_c = torch.where(live[:, None] & hit, t, BIG_T).min(1)
            upd = t_c < t_best
            t_best = torch.where(upd, t_c, t_best)
            best = torch.where(upd, j + j_c, best)
        tally(self.work, "mt", live * self.cols.shape[1])
        return t_best, best

    def _blocks(self, *ray):
        """(first row, its block's 9 geometry columns, the ray as (N, 1)
        columns) of each block of triangles, PLAIN_BLOCK tests at most."""
        n, n_tris = ray[0].shape[0], self.cols.shape[1]
        c = max(1, min(n_tris, PLAIN_BLOCK // max(n, 1)))
        ray = [r[:, None] for r in ray]
        for j in range(0, n_tris, c):
            yield j, self.cols[:, j:j + c], ray

    def occluded(self, ox, oy, oz, dx, dy, dz, t_max, live):
        """Any hit with t in [TRI_EPS, t_max) along the caller's
        direction (t_max a float or per ray); False where not live."""
        if self.bvh is not None or self.chunks is not None:
            t_bound = torch.zeros_like(ox) + t_max
            if self.bvh is not None:
                _, row = self.walk(ox, oy, oz, dx, dy, dz, t_bound, live, True, "any")
            else:
                _, row = chunk_walk(self.cols, self.chunks, ox, oy, oz, dx, dy, dz, t_bound, live,
                                    True, self.work)
            return row >= 0
        occ = torch.zeros_like(ox, dtype=torch.bool)
        tests = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
        t_max = t_max[:, None] if torch.is_tensor(t_max) and t_max.dim() else t_max
        for _, g, ray in self._blocks(ox, oy, oz, dx, dy, dz):
            hit, t = _mt(g, *ray)
            block = hit & (t < t_max)
            found = block.any(1)
            # the kernel stops at the first hit: it tests the block up to it
            n_tested = torch.where(found, block.int().argmax(1) + 1, g.shape[1])
            tests = tests + torch.where(live & ~occ, n_tested, 0)
            occ = occ | (live & found)
        tally(self.work, "mt", tests)
        return occ

    def walk(self, ox, oy, oz, dx, dy, dz, t_bound, live, any_hit, tag=None):
        """The BVH walk of the live rays, bounded by the per-ray t_bound:
        (t, table row), t_bound and -1 where nothing is hit; with any_hit a
        ray stops at its first hit (its row; its t is then t_bound).  Over
        the node64 rows where the tables have them, else over the
        fused-children rows; either walk's interior rows ("node") and, under
        `tag`, its steps (tally_steps: the nodes it visits, a lane with
        t_bound <= 0 none) go to `work`."""
        walked = live & (t_bound > 0.0)
        if self.nodes64 is not None:
            o, d = torch.stack([ox, oy, oz], -1), torch.stack([dx, dy, dz], -1)
            t, row, steps = walk_node64(self.nodes64, self.geo, self.bvh.max_leaf, self.bvh.stack,
                                        o, d, t_bound, live, any_hit, self.work)
            if tag is not None:
                tally_steps(self.work, tag, steps, walked)
            return t, row
        t_out = t_bound.clone()
        row_out = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
        steps_out = torch.zeros_like(row_out)
        idx = torch.nonzero(live).squeeze(1)
        o = (ox[idx], oy[idx], oz[idx])
        d = (dx[idx], dy[idx], dz[idx])
        inv = tuple(_inv_dir(c) for c in d)
        tb = t_bound[idx]
        best = torch.full_like(idx, -1)
        steps = torch.zeros_like(idx)
        m = idx.numel()
        stack = torch.zeros((m, self.bvh.stack), dtype=torch.int64, device=ox.device)
        sp = torch.ones_like(idx)  # the root, node 0, is on the stack
        k = torch.arange(self.bvh.max_leaf, device=ox.device)
        while m:
            lane = torch.arange(m, device=ox.device)
            steps = steps + 1
            sp = sp - 1
            node = stack[lane, sp]
            ni = self.nodes_i[node]
            off, n_prims, axis = ni[:, 0], ni[:, 1], ni[:, 2]
            leaf = n_prims > 0
            # leaf: its triangles in table order
            tri = off[:, None] + k
            valid = leaf[:, None] & (k < n_prims[:, None])
            g = self.geo[torch.where(valid, tri, 0)].unbind(-1)
            hit, t = _mt(g, *(c[:, None] for c in o + d))
            hit = valid & hit & (t < tb[:, None])
            found = hit.any(1)
            if any_hit:
                # the kernel stops at the first hit: it tests the leaf up to it
                first = torch.where(hit, k, k.numel()).min(1).values
                tally(self.work, "mt", torch.where(found, first + 1, valid.sum(1)))
                best = torch.where(found, off + first, best)
            else:
                tally(self.work, "mt", valid)
                tm = torch.where(hit, t, BIG_T)
                t_min = tm.min(1).values
                first = torch.where(hit & (tm == t_min[:, None]), k, k.numel()).min(1).values
                tb = torch.where(found, t_min, tb)
                best = torch.where(found, off + first, best)
            # interior: test both children's boxes, push the hit ones
            interior = ~leaf
            row = self.nodes_f[node]
            hit_l = interior & _slab(row[:, 0:6], *o, *inv, tb)
            hit_r = interior & _slab(row[:, 6:12], *o, *inv, tb)
            tally(self.work, "slab", 2 * interior)
            tally(self.work, "node", interior)
            d_ax = torch.where(axis == 0, d[0], torch.where(axis == 1, d[1], d[2]))
            near_left = d_ax >= 0.0
            left, right = node + 1, off
            for child, push in (
                (torch.where(near_left, right, left), torch.where(near_left, hit_r, hit_l)),
                (torch.where(near_left, left, right), torch.where(near_left, hit_l, hit_r)),
            ):
                slot = sp.clamp(max=self.bvh.stack - 1)  # the packer sizes the stack
                stack[lane, slot] = torch.where(push, child, stack[lane, slot])
                sp = sp + push
            done = (sp == 0) | (found if any_hit else False)
            if bool(done.any()):
                t_out[idx[done]] = tb[done]
                row_out[idx[done]] = best[done]
                steps_out[idx[done]] = steps[done]
                keep = ~done
                idx, tb, best, stack, sp = idx[keep], tb[keep], best[keep], stack[keep], sp[keep]
                steps = steps[keep]
                o = tuple(c[keep] for c in o)
                d = tuple(c[keep] for c in d)
                inv = tuple(c[keep] for c in inv)
                m = idx.numel()
        if tag is not None:
            tally_steps(self.work, tag, torch.where(walked, steps_out, 0), walked)
        return t_out, row_out


def li_path_mega_cam_reference(
    packed, cam_packed, pixel_xy, pixel_id, s_idx, sampler, spec, work=None
):
    """Plain PyTorch version of `li_path_mega_cam` (same arguments and
    return), on any device.  `work`, a dict, gets the counts of the
    triangle, box and sphere tests ("mt", "slab", "sph") and lobe
    evaluations ("lobe") that the kernel performs on these inputs, and
    under a HaltonSampler the slot values it reads ("slot") (0-d
    tensors); a textured scene also the texels its taps weigh ("texel")
    and the lens traces of the differential rays that a textured hit at
    bounce 0 reads ("fd_ray")."""
    dev = pixel_xy.device
    n = pixel_xy.shape[0]
    pid = pixel_id.to(torch.int64)
    sid = _sample_indices(s_idx, n, dev)
    sampler = slot_reader(packed, spec, sampler, pid, sid, True) or sampler
    ray = _raygen(pixel_xy[:, 0], pixel_xy[:, 1], pid, sid, sampler, cam_packed)
    weight = ray[6]
    tally_slots(work, sampler, torch.full_like(weight, 4.0))  # film and lens
    fd = None
    if packed.tex is not None:
        fd = raygen_differentials(pixel_xy, pid, sid, sampler, cam_packed, ray[:6])
    L = bounce_loop_reference(packed, *ray[:6], weight > 0.0, pid, sid, sampler, spec, work, fd)
    return L, weight


FD_EPS = 0.05  # the film offset of the ray differentials, px


def raygen_differentials(pixel_xy, pid, sid, sampler, cam, base):
    """The differential rays of the camera rays `base` (ox, oy, oz, dx, dy,
    dz), the JAX kernel's _raygen_with_diff: the lens traced at film points
    FD_EPS px to the right and below through the same lens sample, scaled
    by 1 / sqrt(spp), the ray itself where the shifted trace dies.
    Returns 12 tensors: the x ray's origin and direction, then the y
    ray's."""
    scale = 1.0 / float(np.sqrt(max(sampler.spp, 1)))
    fd = []
    for sx, sy in ((FD_EPS, 0.0), (0.0, FD_EPS)):
        r = _raygen(pixel_xy[:, 0] + sx, pixel_xy[:, 1] + sy, pid, sid, sampler, cam)
        ok = r[6] > 0.0
        fd += [torch.where(ok, b + _div(c - b, FD_EPS) * scale, b) for b, c in zip(base, r[:6])]
    return fd


def li_path_mega_reference(packed, o, d, weight, pixel_id, s_idx, sampler, spec, work=None):
    """Plain PyTorch version of `li_path_mega` (same arguments and return)."""
    _no_texture_on_given_rays(packed)
    n = o.shape[0]
    pid = pixel_id.to(torch.int64)
    sid = _sample_indices(s_idx, n, o.device)
    sampler = slot_reader(packed, spec, sampler, pid, sid, False) or sampler
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    return bounce_loop_reference(packed, ox, oy, oz, dx, dy, dz, weight > 0.0, pid, sid,
                                 sampler, spec, work)


def _affine12(rows, x, y, z):
    """A 3x4 row-major transform (12 floats, or (N, 12) columns) on a point."""
    return (rows[0] * x + rows[1] * y + rows[2] * z + rows[3],
            rows[4] * x + rows[5] * y + rows[6] * z + rows[7],
            rows[8] * x + rows[9] * y + rows[10] * z + rows[11])


def _rot12(rows, x, y, z):
    return (rows[0] * x + rows[1] * y + rows[2] * z,
            rows[4] * x + rows[5] * y + rows[6] * z,
            rows[8] * x + rows[9] * y + rows[10] * z)


def _rot12_t(rows, x, y, z):
    """The transposed 3x3 of 12 rows: a normal through the inverse."""
    return (rows[0] * x + rows[4] * y + rows[8] * z,
            rows[1] * x + rows[5] * y + rows[9] * z,
            rows[2] * x + rows[6] * y + rows[10] * z)


def _rot9(rows, x, y, z):
    return (rows[0] * x + rows[1] * y + rows[2] * z,
            rows[3] * x + rows[4] * y + rows[5] * z,
            rows[6] * x + rows[7] * y + rows[8] * z)


def _rot9_t(rows, x, y, z):
    return (rows[0] * x + rows[3] * y + rows[6] * z,
            rows[1] * x + rows[4] * y + rows[7] * z,
            rows[2] * x + rows[5] * y + rows[8] * z)


def _sphere_candidate(w2o, radius, ox, oy, oz, dx, dy, dz, t_lim):
    """The closest root of a full sphere along the ray in (SPH_EPS, t_lim)
    (_sphere_candidate_t): (t, BIG_T on a miss; object-space origin and
    direction)."""
    oo = _affine12(w2o, ox, oy, oz)
    od = _rot12(w2o, dx, dy, dz)
    a = od[0] * od[0] + od[1] * od[1] + od[2] * od[2]
    b = 2.0 * (od[0] * oo[0] + od[1] * oo[1] + od[2] * oo[2])
    c = oo[0] * oo[0] + oo[1] * oo[1] + oo[2] * oo[2] - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = q / torch.where(a == 0.0, 1.0, a)
    t1 = c / torch.where(q == 0.0, 1.0, q)
    lo = torch.where(ok, torch.minimum(t0, t1), 0.0)
    hi = torch.where(ok, torch.maximum(t0, t1), 0.0)
    lo_ok = ok & (lo > SPH_EPS) & (lo < t_lim)
    hi_ok = ok & (hi > SPH_EPS) & (hi < t_lim)
    return torch.where(lo_ok, lo, torch.where(hi_ok, hi, BIG_T)), oo, od


class PlainSpheres:
    """The kernel's sphere primitives: every sphere in row order, strict <
    (ties keep the lower row), as _spheres_closest does; shading as
    _sphere_shading."""

    def __init__(self, sph_table, device, work=None):
        self.rows = sph_table.to(device)
        host = sph_table.cpu()
        self.geo = [(tuple(float(v) for v in r[:12]), float(r[SPH_RADIUS_COL])) for r in host]
        self.work = work

    def closest(self, ox, oy, oz, dx, dy, dz, live):
        """(t, BIG_T on a miss; the winner's row; its object-space hit)."""
        t_best = torch.full_like(ox, BIG_T)
        best = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
        po = [torch.zeros_like(ox)] * 3
        for j, (w2o, radius) in enumerate(self.geo):
            t, oo, od = _sphere_candidate(w2o, radius, ox, oy, oz, dx, dy, dz, BIG_T)
            upd = t < t_best
            t_best = torch.where(upd, t, t_best)
            best = torch.where(upd, j, best)
            po = [torch.where(upd, oo[c] + od[c] * t, po[c]) for c in range(3)]
        tally(self.work, "sph", live * len(self.geo))
        return t_best, best, po

    def occluded(self, ox, oy, oz, dx, dy, dz, t_max, live):
        occ = torch.zeros_like(ox, dtype=torch.bool)
        tests = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
        for w2o, radius in self.geo:
            tests = tests + (live & ~occ)  # the kernel stops at the first hit
            t, _, _ = _sphere_candidate(w2o, radius, ox, oy, oz, dx, dy, dz, t_max)
            occ = occ | (t < BIG_T)
        tally(self.work, "sph", tests)
        return occ & live

    def shading(self, row, po):
        """(ng, dpdu) of sphere hits: the object point reprojected onto the
        sphere, the normal through w2o's transpose, dpdu = o2w (-2 pi y,
        2 pi x, 0)."""
        w2o = [row[:, c] for c in range(12)]
        o2w = [row[:, SPH_O2W_COL + c] for c in range(12)]
        radius = row[:, SPH_RADIUS_COL]
        pox, poy, poz = po
        plen = torch.sqrt(pox * pox + poy * poy + poz * poz)
        scale = radius / torch.clamp(plen, min=1e-30)
        pox, poy, poz = pox * scale, poy * scale, poz * scale
        ngx, ngy, ngz = _rot12_t(w2o, pox, poy, poz)
        ng_len = torch.clamp(torch.sqrt(ngx * ngx + ngy * ngy + ngz * ngz), min=1e-30)
        two_pi = 2.0 * PI
        du = _rot12(o2w, -two_pi * poy, two_pi * pox, torch.zeros_like(pox))
        return (ngx / ng_len, ngy / ng_len, ngz / ng_len), du


def _cdf_scan(cdf, u):
    """sample_continuous_1d over a float32 CDF tuple (_cdf_scan): (index,
    its float, the offset in the bin)."""
    n = len(cdf) - 1
    c = torch.tensor(cdf, dtype=DTYPE, device=u.device)
    cnt = (c[None, :] <= u[:, None]).sum(-1)
    idx = torch.clamp(cnt - 1, 0, n - 1)
    c0 = c[idx]
    dc = c[idx + 1] - c0
    du = torch.where(dc > 0.0, (u - c0) / torch.clamp(dc, min=1e-30), u - c0)
    return idx, idx.to(DTYPE), du


def _env_sample(env, px, py, pz, u0, u1, world_radius):
    """InfiniteAreaLight::sample_li on a constant map (_env_sample_k):
    (wi, pdf, p_light)."""
    idx1, idx1f, du1 = _cdf_scan(env.marg_cdf, u1)
    d1 = (idx1f + du1) / env.nv
    pdf1 = torch.tensor(env.marg_pdf, dtype=DTYPE, device=u0.device)[idx1]
    _, idx0f, du0 = _cdf_scan(env.cond_cdf, u0)
    d0 = (idx0f + du0) / env.nu
    theta = d1 * PI
    phi = d0 * 2.0 * PI
    sin_t = torch.sin(theta)
    w = _rot9(env.to_world, sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.cos(theta))
    pdf = torch.where(sin_t > 0.0, pdf1 / (2.0 * PI * PI * torch.clamp(sin_t, min=1e-9)), 0.0)
    two_r = 2.0 * world_radius
    return w, pdf, (px + w[0] * two_r, py + w[1] * two_r, pz + w[2] * two_r)


def _env_pdf_dir(env, wx, wy, wz):
    """InfiniteAreaLight::pdf_li along world directions (_env_pdf_dir_k):
    the theta row from cos thresholds, no arccos."""
    lx, ly, lz = _rot9(env.to_local, wx, wy, wz)
    lz = lz * _rsqrt(torch.clamp(lx * lx + ly * ly + lz * lz, min=1e-30))
    bins = torch.tensor(env.cos_bins, dtype=DTYPE, device=wx.device)
    iv = (lz[:, None] <= bins[None, :]).sum(-1)
    pdf_row = torch.tensor(env.pdf2d_bins, dtype=DTYPE, device=wx.device)[iv]
    sin_t = torch.sqrt(torch.clamp(1.0 - lz * lz, min=0.0))
    return torch.where(sin_t > 0.0, pdf_row / (2.0 * PI * PI * torch.clamp(sin_t, min=1e-9)), 0.0)


def _nee_light(packed, li, px, py, pz, u0, u1):
    """sample_li of each lane's light li (_nee_light_k's generic branch):
    a point light (wi = d / |d|, I / d^2), a sphere light or the
    environment.  Returns (wi, li, pdf, p_light, delta, sel_env)."""
    dev = px.device
    kinds = packed.light_kind
    kind = torch.tensor(kinds, device=dev)[li]
    emit = torch.tensor(packed.light_emit, dtype=DTYPE, device=dev)[li]
    lp = torch.tensor(packed.light_p, dtype=DTYPE, device=dev)[li]
    is_point = kind == LIGHT_POINT
    is_area = kind == LIGHT_DIFFUSE_AREA
    sel_env = kind == LIGHT_INFINITE
    zero = torch.zeros_like(px)
    wi, le, pdf, pl = (zero,) * 3, (zero,) * 3, zero, (lp[:, 0], lp[:, 1], lp[:, 2])
    if LIGHT_POINT in kinds:
        tlx, tly, tlz = lp[:, 0] - px, lp[:, 1] - py, lp[:, 2] - pz
        dist2 = torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=1e-20)
        sq = torch.sqrt(dist2)
        wi = (tlx / sq, tly / sq, tlz / sq)
        le = tuple(emit[:, c] / dist2 for c in range(3))
        pdf = torch.where(is_point, 1.0, 0.0)
    if LIGHT_DIFFUSE_AREA in kinds:
        o2w = torch.tensor(packed.light_o2w, dtype=DTYPE, device=dev)[li]
        w2o = torch.tensor(packed.light_w2o, dtype=DTYPE, device=dev)[li]
        rad = torch.tensor(packed.light_radius, dtype=DTYPE, device=dev)[li]
        z = 1.0 - 2.0 * u0
        r_ = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * PI * u1
        pox, poy, poz = r_ * torch.cos(phi) * rad, r_ * torch.sin(phi) * rad, z * rad
        ps = _affine12(o2w.unbind(-1), pox, poy, poz)
        nsx, nsy, nsz = _rot9_t(w2o.unbind(-1), pox, poy, poz)
        ninv = _rsqrt(torch.clamp(nsx * nsx + nsy * nsy + nsz * nsz, min=1e-30))
        nsx, nsy, nsz = nsx * ninv, nsy * ninv, nsz * ninv
        ts = (ps[0] - px, ps[1] - py, ps[2] - pz)
        d2 = ts[0] * ts[0] + ts[1] * ts[1] + ts[2] * ts[2]
        dn = torch.sqrt(torch.clamp(d2, min=1e-20))
        wa = (ts[0] / dn, ts[1] / dn, ts[2] / dn)
        cos_l = torch.abs(-(wa[0] * nsx + wa[1] * nsy + wa[2] * nsz))
        pdf_a = d2 / torch.clamp(cos_l, min=1e-20)
        pdf_a = torch.where((d2 > 0.0) & torch.isfinite(pdf_a), pdf_a, 0.0)
        front = (nsx * -wa[0] + nsy * -wa[1] + nsz * -wa[2]) > 0.0
        wi = tuple(torch.where(is_area, a, b) for a, b in zip(wa, wi))
        le = tuple(torch.where(is_area, torch.where(front, emit[:, c], 0.0), le[c])
                   for c in range(3))
        pdf = torch.where(is_area, pdf_a, pdf)
        pl = tuple(torch.where(is_area, a, b) for a, b in zip(ps, pl))
    if packed.env is not None:
        we, pdf_e, pe = _env_sample(packed.env, px, py, pz, u0, u1, packed.world_radius)
        wi = tuple(torch.where(sel_env, a, b) for a, b in zip(we, wi))
        le = tuple(torch.where(sel_env, packed.env.rgb[c], le[c]) for c in range(3))
        pdf = torch.where(sel_env, pdf_e, pdf)
        pl = tuple(torch.where(sel_env, a, b) for a, b in zip(pe, pl))
    return wi, le, pdf, pl, is_point, sel_env


def barycentrics(row, ox, oy, oz, dx, dy, dz):
    """(b0, b1, b2) of the rays at the rows' triangles, rebuilt from their
    intersect columns with surface_interaction's guards."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = row[:, 0:9].unbind(-1)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = 1.0 / torch.where(torch.abs(det) < TRI_EPS, 1.0, det)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    b2 = (dx * qvx + dy * qvy + dz * qvz) * inv
    return 1.0 - b1 - b2, b1, b2


def textured_kd_reference(row, tex, ray, p, ng, dpdu, fd, live, work=None):
    """kd (N, 3) of textured rows (the kernel's textured_kd): the uv at the
    rebuilt barycentrics, mapped to st; with the differential rays `fd`
    (bounce 0) K7's EWA tap over the footprints their offsets on ng's
    tangent plane at p solve to against dpdu and dpdv
    (compute_uv_differentials), else (dead differentials) level 0's
    bilinear tap; times the texture's scale.  `work` counts the taps'
    texels on the `live` lanes ("texel")."""
    b0, b1, b2 = barycentrics(row, *ray)
    tb = row[:, TEX0:TEX0 + 10]
    uvu = b0 * tb[:, 3] + b1 * tb[:, 5] + b2 * tb[:, 7]
    uvv = b0 * tb[:, 4] + b1 * tb[:, 6] + b2 * tb[:, 8]
    rec = tex.rec
    s, t = map_uv(rec, uvu, uvv)
    if fd is None:
        kd = bilerp_level(tex.pyr, torch.zeros_like(live, dtype=torch.int64), s, t)
        tally(work, "texel", 4 * live)
        return kd * rec.scale
    px, py, pz = p
    ngx, ngy, ngz = ng
    d_plane = ngx * px + ngy * py + ngz * pz
    dp = []
    for k in range(2):
        rox, roy, roz, rdx, rdy, rdz = fd[6 * k:6 * k + 6]
        den = ngx * rdx + ngy * rdy + ngz * rdz
        den = torch.where(torch.abs(den) < 1e-9, 1e-9, den)
        th = (d_plane - (ngx * rox + ngy * roy + ngz * roz)) / den
        dp.append((rox + rdx * th - px, roy + rdy * th - py, roz + rdz * th - pz))
    ax0, ax1, ax2 = torch.abs(ngx), torch.abs(ngy), torch.abs(ngz)
    k0 = (ax0 >= ax1) & (ax0 >= ax2)
    kmax2 = ~k0 & (ax2 > ax1)
    dux, duy, duz = dpdu
    dvx, dvy, dvz = tb[:, 0], tb[:, 1], tb[:, 2]
    a00, a01 = torch.where(k0, duy, dux), torch.where(k0, dvy, dvx)
    a10, a11 = torch.where(kmax2, duy, duz), torch.where(kmax2, dvy, dvz)
    det = a00 * a11 - a01 * a10
    okd = torch.abs(det) >= 1e-10
    invd = 1.0 / torch.where(okd, det, 1.0)
    duv = []
    for dpx, dpy, dpz in dp:
        c0, c1 = torch.where(k0, dpy, dpx), torch.where(kmax2, dpy, dpz)
        for val in ((a11 * c0 - a01 * c1) * invd, (a00 * c1 - a10 * c0) * invd):
            val = torch.where(okd, val, 0.0)
            duv.append(torch.where(torch.isfinite(val), val, 0.0))
    kd = ewa_lookup(tex.pyr, s, t, duv[0] * rec.su, duv[1] * rec.sv, duv[2] * rec.su,
                    duv[3] * rec.sv, live, work)
    return kd * rec.scale


def smooth_normal(row, ox, oy, oz, dx, dy, dz, ngx, ngy, ngz):
    """The shading normal of a smooth mesh at the rows' hits: the winner's
    barycentrics (`barycentrics`), its raw vertex normals (cols NRM_COL:
    NRM_COL + 9) interpolated and normalised, ng where they sum to zero
    (the JAX kernel's smooth branch)."""
    b0, b1, b2 = barycentrics(row, ox, oy, oz, dx, dy, dz)
    n = row[:, NRM_COL:NRM_COL + 9]
    nx = b0 * n[:, 0] + b1 * n[:, 3] + b2 * n[:, 6]
    ny = b0 * n[:, 1] + b1 * n[:, 4] + b2 * n[:, 7]
    nz = b0 * n[:, 2] + b1 * n[:, 5] + b2 * n[:, 8]
    len2 = nx * nx + ny * ny + nz * nz
    has_vn = len2 > 0.0
    inv_l = _rsqrt(torch.clamp(len2, min=1e-30))
    return (torch.where(has_vn, nx * inv_l, ngx), torch.where(has_vn, ny * inv_l, ngy),
            torch.where(has_vn, nz * inv_l, ngz))


def bounce_loop_reference(packed, ox, oy, oz, dx, dy, dz, active, pid, sid, sampler, spec,
                          work=None, fd=None):
    """The kernel's bounce loop (_bounce_loop) on flat (N,) rays: returns
    L (N, 3).  `active` (N,) bool marks the rays to trace.  With
    `packed.smooth` the shading normal ns is interpolated (smooth_normal;
    a sphere keeps ns = ng), ng is faced onto it, and the reflect and
    transmit tests, the offsets and the etaScale entering test read ng's
    side; flat, ns is ng.  With `packed.bssrdf` a sample that chose the
    specular transmission lobe takes the subsurface branch
    (subsurface_reference) before the roulette.  With `packed.tex` a
    textured row's lobe 0 takes its s0 from textured_kd_reference, at
    bounce 0 over the differential rays `fd`."""
    dev = ox.device
    geom = PlainGeometry(packed, dev, work, cull=True)
    spheres = None if packed.sph_table is None else PlainSpheres(packed.sph_table, dev, work)
    table = geom.table
    rows_all = table if spheres is None else torch.cat([table, spheres.rows])
    max_lobes = int(rows_all[:, 15].max()) if rows_all.shape[0] else 0
    n_lights = len(packed.light_p)
    kinds = packed.light_kind or (LIGHT_POINT,) * n_lights
    all_point = n_lights > 0 and all(k == LIGHT_POINT for k in kinds)
    has_env = packed.env is not None
    esc = packed.esc_rgb
    has_spec = any(k in SPEC_KINDS for k in packed.kinds_present)
    smooth = packed.smooth
    bss = packed.bssrdf
    light_p = torch.tensor(packed.light_p, dtype=DTYPE, device=dev).reshape(-1, 3)
    light_emit = torch.tensor(packed.light_emit, dtype=DTYPE, device=dev).reshape(-1, 3)
    packed = packed._replace(light_kind=kinds)
    if bss is not None and (spheres is not None or smooth):
        raise ValueError("the subsurface branch takes flat triangles only")

    def occluded(sox, soy, soz, sdx, sdy, sdz, t_max, live):
        occ = geom.occluded(sox, soy, soz, sdx, sdy, sdz, t_max, live)
        if spheres is not None:
            occ = occ | spheres.occluded(sox, soy, soz, sdx, sdy, sdz, t_max, live & ~occ)
        return occ

    one = torch.ones_like(ox)
    br, bg, bb = one, one, one
    Lr = Lg = Lb = torch.zeros_like(ox)
    es = one  # etaScale (path.rs:150-163)
    spec_prev = torch.zeros_like(active)
    # an extra step collects the escape radiance of the last bounce
    for bounce in range(spec.max_depth + (1 if esc is not None else 0)):
        t, best = geom.closest(ox, oy, oz, dx, dy, dz, active)
        found = t < BIG_T
        if table.shape[0]:
            row = torch.where(found[:, None], table[best.clamp(min=0)], 0.0)
        else:
            row = torch.zeros((ox.shape[0], TABLE_COLS), dtype=DTYPE, device=dev)
        ngx, ngy, ngz = row[:, 9], row[:, 10], row[:, 11]
        dux, duy, duz = row[:, 12], row[:, 13], row[:, 14]
        if smooth:
            nsx, nsy, nsz = smooth_normal(row, ox, oy, oz, dx, dy, dz, ngx, ngy, ngz)
        if spheres is not None:
            # spheres min-combined with the triangle winner
            t_s, s_best, po = spheres.closest(ox, oy, oz, dx, dy, dz, active)
            use_s = t_s < t
            s_row = spheres.rows[s_best]
            (sgx, sgy, sgz), (sdx_, sdy_, sdz_) = spheres.shading(s_row, po)
            t = torch.where(use_s, t_s, t)
            row = torch.where(use_s[:, None], s_row, row)
            ngx, ngy, ngz = (torch.where(use_s, a, b) for a, b in zip((sgx, sgy, sgz), (ngx, ngy, ngz)))
            dux, duy, duz = (torch.where(use_s, a, b) for a, b in zip((sdx_, sdy_, sdz_), (dux, duy, duz)))
            if smooth:  # spheres shade ns = ng
                nsx, nsy, nsz = (torch.where(use_s, a, b)
                                 for a, b in zip((sgx, sgy, sgz), (nsx, nsy, nsz)))
            found = t < BIG_T
        n_lob = row[:, 15].to(torch.int64)
        mat_eta = row[:, 31]
        if smooth:
            # ng faced onto ns (surface_interaction's faceforward(ng, ns))
            sgn = torch.where(ngx * nsx + ngy * nsy + ngz * nsz < 0.0, -1.0, 1.0)
            ngx, ngy, ngz = ngx * sgn, ngy * sgn, ngz * sgn
        else:
            nsx, nsy, nsz = ngx, ngy, ngz  # flat shading

        # escaped rays collect the infinite_lights radiance at bounce 0 or
        # after a specular bounce (path.rs:84-87)
        if esc is not None:
            collect = active & ~found
            if bounce > 0:
                collect = collect & spec_prev
            Lr = Lr + torch.where(collect, br * esc[0], 0.0)
            Lg = Lg + torch.where(collect, bg * esc[1], 0.0)
            Lb = Lb + torch.where(collect, bb * esc[2], 0.0)
        if bounce == spec.max_depth:
            break
        active = active & found

        px = ox + dx * t
        py = oy + dy * t
        pz = oz + dz * t

        if packed.tex is not None:
            # a textured row's one lambert lobe takes kd from the image
            texed = active & (row[:, TEX0 + 9] > 0.0)
            if fd is not None and bounce == 0:
                tally(work, "fd_ray", 2 * texed)
            kd = textured_kd_reference(row, packed.tex, (ox, oy, oz, dx, dy, dz), (px, py, pz),
                                       (ngx, ngy, ngz), (dux, duy, duz),
                                       fd if bounce == 0 else None, texed, work)
            row = row.clone()
            row[:, 17:20] = torch.where(texed[:, None], kd, row[:, 17:20])

        ssx, ssy, ssz, tsx, tsy, tsz = shading_frame(nsx, nsy, nsz, dux, duy, duz)

        wox, woy, woz = -dx, -dy, -dz
        wol_x = _dot3(wox, woy, woz, ssx, ssy, ssz)
        wol_y = _dot3(wox, woy, woz, tsx, tsy, tsz)
        wo_z = _dot3(wox, woy, woz, nsx, nsy, nsz)
        wo_ng = _dot3(wox, woy, woz, ngx, ngy, ngz) if smooth else wo_z

        dim0 = path_dim0(bounce)
        mag = torch.abs(px) + torch.abs(py) + torch.abs(pz)
        eps = 1e-4 + 1e-5 * mag
        lobes = [_lobe(row, 16 + 16 * l) for l in range(max_lobes)]

        if all_point:
            # ---- NEE, point lights only: no light sample, no MIS ----
            u_pick = sampler.get_1d(pid, sid, dim0 + PATH_NEE)
            tally_slots(work, sampler, active)
            li = torch.clamp((u_pick * n_lights).to(torch.int64), max=n_lights - 1)
            lp = light_p[li]
            le = light_emit[li]
            tlx, tly, tlz = lp[:, 0] - px, lp[:, 1] - py, lp[:, 2] - pz
            dist2 = torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=1e-20)
            inv_d = _rsqrt(dist2)
            wix, wiy, wiz = tlx * inv_d, tly * inv_d, tlz * inv_d
            wil_x = _dot3(wix, wiy, wiz, ssx, ssy, ssz)
            wil_y = _dot3(wix, wiy, wiz, tsx, tsy, tsz)
            wil_z = _dot3(wix, wiy, wiz, nsx, nsy, nsz)
            wi_ng = _dot3(wix, wiy, wiz, ngx, ngy, ngz) if smooth else wil_z
            f_gate = ((wi_ng * wo_ng) > 0.0) & (wo_z != 0.0)
            fn = [torch.zeros_like(px)] * 3
            for l in range(max_lobes):
                lf = _lobe_f(lobes[l], wol_x, wol_y, wo_z, wil_x, wil_y, wil_z)
                use = f_gate & (l < n_lob)
                tally_lobe(work, active & use, lobes[l]["kind"], pdf=False)
                fn = [fn[c] + torch.where(use, lf[c], 0.0) for c in range(3)]
            cos_ns = torch.abs(wil_z)
            off = torch.where(wi_ng < 0.0, -eps, eps)
            sox, soy, soz = px + ngx * off, py + ngy * off, pz + ngz * off
            occ = occluded(
                sox, soy, soz, lp[:, 0] - sox, lp[:, 1] - soy, lp[:, 2] - soz,
                1.0 - SHADOW_EPSILON, active,
            )
            li_scale = torch.where(active & ~occ, cos_ns * n_lights / dist2, 0.0)
            Lr = Lr + br * fn[0] * le[:, 0] * li_scale
            Lg = Lg + bg * fn[1] * le[:, 1] * li_scale
            Lb = Lb + bb * fn[2] * le[:, 2] * li_scale
        elif n_lights > 0:
            # ---- NEE with MIS: sphere and environment lights
            # (estimate_direct, integrator/mod.rs:403-558) ----
            u_pick = sampler.get_1d(pid, sid, dim0 + PATH_NEE)
            li = torch.clamp((u_pick * n_lights).to(torch.int64), max=n_lights - 1)
            ul = sampler.get_2d(pid, sid, dim0 + PATH_NEE + 1)
            tally_slots(work, sampler, 3 * active)
            (wix, wiy, wiz), (lr_, lg_, lb_), ls_pdf, (plx, ply, plz), delta, sel_env = _nee_light(
                packed, li, px, py, pz, ul[:, 0], ul[:, 1])
            wil_x = _dot3(wix, wiy, wiz, ssx, ssy, ssz)
            wil_y = _dot3(wix, wiy, wiz, tsx, tsy, tsz)
            wil_z = _dot3(wix, wiy, wiz, nsx, nsy, nsz)
            wi_ng = _dot3(wix, wiy, wiz, ngx, ngy, ngz) if smooth else wil_z
            f_gate = ((wi_ng * wo_ng) > 0.0) & (wo_z != 0.0)
            fn = [torch.zeros_like(px)] * 3
            pdf_scat = torch.zeros_like(px)
            cnt = torch.zeros_like(n_lob)
            for l in range(max_lobes):
                m_l = (l < n_lob) & ~_is_spec(lobes[l]["kind"])
                lf = _lobe_f(lobes[l], wol_x, wol_y, wo_z, wil_x, wil_y, wil_z)
                use = f_gate & m_l
                fn = [fn[c] + torch.where(use, lf[c], 0.0) for c in range(3)]
                lpdf = _lobe_pdf(lobes[l], wol_x, wol_y, wo_z, wil_x, wil_y, wil_z)
                tally_lobe(work, active & m_l, lobes[l]["kind"], pdf=True)
                pdf_scat = pdf_scat + torch.where(m_l, lpdf, 0.0)
                cnt = cnt + m_l
            pdf_scat = torch.where((wo_z != 0.0) & (cnt > 0),
                                   pdf_scat / torch.clamp(cnt, min=1).to(DTYPE), 0.0)
            cos_ns = torch.abs(wil_z)
            fc = [fn[c] * cos_ns for c in range(3)]
            w_mis = torch.where(delta, 1.0, power_heuristic(ls_pdf, pdf_scat))
            off = torch.where(wi_ng < 0.0, -eps, eps)
            sox, soy, soz = px + ngx * off, py + ngy * off, pz + ngz * off
            any_li = (lr_ > 0.0) | (lg_ > 0.0) | (lb_ > 0.0)
            any_f = (fc[0] > 0.0) | (fc[1] > 0.0) | (fc[2] > 0.0)
            live = active & (ls_pdf > 0.0) & any_li & any_f
            occ = occluded(sox, soy, soz, plx - sox, ply - soy, plz - soz,
                           1.0 - SHADOW_EPSILON, live)
            scale = torch.where(live & ~occ,
                                w_mis * n_lights / torch.clamp(ls_pdf, min=1e-20), 0.0)
            Lr = Lr + br * fc[0] * lr_ * scale
            Lg = Lg + bg * fc[1] * lg_ * scale
            Lb = Lb + bb * fc[2] * lb_ * scale

            if has_env:
                # the BSDF sample of MIS: only an escaped ray toward the
                # sampled environment contributes (no emissive primitives)
                us = sampler.get_2d(pid, sid, dim0 + PATH_NEE + 2)
                tally_slots(work, sampler, 2 * (active & sel_env & (n_lob > 0) & (wo_z != 0.0)))
                w2sx, w2sy, w2sz, f2s, pdf2, _ = _bsdf_sample(row, n_lob, wol_x, wol_y, wo_z,
                                                               us[:, 0], us[:, 1])
                tally_lobe(work, active & sel_env, _chosen_kind(row, n_lob, us[:, 0]), pdf=True)
                w2x = ssx * w2sx + tsx * w2sy + nsx * w2sz
                w2y = ssy * w2sx + tsy * w2sy + nsy * w2sz
                w2z = ssz * w2sx + tsz * w2sy + nsz * w2sz
                cos2 = torch.abs(_dot3(w2x, w2y, w2z, nsx, nsy, nsz))
                f2 = [fc_ * cos2 for fc_ in f2s]
                lpdf2 = _env_pdf_dir(packed.env, w2x, w2y, w2z)
                w2mis = power_heuristic(pdf2, lpdf2)
                off2n = torch.where(_dot3(w2x, w2y, w2z, ngx, ngy, ngz) < 0.0, -eps, eps)
                any_f2 = (f2[0] > 0.0) | (f2[1] > 0.0) | (f2[2] > 0.0)
                live2 = (active & sel_env & (n_lob > 0) & (wo_z != 0.0) & any_f2 & (pdf2 > 0.0)
                         & (lpdf2 > 0.0))
                escaped = ~occluded(px + ngx * off2n, py + ngy * off2n, pz + ngz * off2n,
                                    w2x, w2y, w2z, torch.inf, live2)
                scale2 = torch.where(live2 & escaped,
                                     w2mis * n_lights / torch.clamp(pdf2, min=1e-20), 0.0)
                Lr = Lr + br * f2[0] * packed.env.rgb[0] * scale2
                Lg = Lg + bg * f2[1] * packed.env.rgb[1] * scale2
                Lb = Lb + bb * f2[2] * packed.env.rgb[2] * scale2

        # ---- BSDF sample ----
        ub = sampler.get_2d(pid, sid, dim0 + PATH_BSDF)
        tally_slots(work, sampler, 2 * active)
        wsx, wsy, wsz, fs, pdf, transmitted = _bsdf_sample(
            row, n_lob, wol_x, wol_y, wo_z, ub[:, 0], ub[:, 1]
        )
        tally_lobe(work, active, _chosen_kind(row, n_lob, ub[:, 0]), pdf=True)
        nwx = ssx * wsx + tsx * wsy + nsx * wsz
        nwy = ssy * wsx + tsy * wsy + nsy * wsz
        nwz = ssz * wsx + tsz * wsy + nsz * wsz
        cosw = torch.abs(_dot3(nwx, nwy, nwz, nsx, nsy, nsz))
        any_f = (fs[0] != 0.0) | (fs[1] != 0.0) | (fs[2] != 0.0)
        ok = active & (n_lob > 0) & (wo_z != 0.0) & (pdf > 0.0) & any_f
        inv_pdf = cosw / torch.clamp(pdf, min=1e-20)
        br = torch.where(ok, br * fs[0] * inv_pdf, br)
        bg = torch.where(ok, bg * fs[1] * inv_pdf, bg)
        bb = torch.where(ok, bb * fs[2] * inv_pdf, bb)
        active = active & ok
        if esc is not None and has_spec:
            spec_prev = _is_spec(_chosen_kind(row, n_lob, ub[:, 0]))

        # etaScale: a transmitted fresnel-specular sample, entering test on ng
        e2 = mat_eta * mat_eta
        eta_fac = torch.where(wo_ng > 0.0, e2, 1.0 / torch.clamp(e2, min=1e-20))
        es = torch.where(active & transmitted, es * eta_fac, es)

        # next ray, offset along ng to the sampled side
        off2 = torch.where(_dot3(nwx, nwy, nwz, ngx, ngy, ngz) < 0.0, -eps, eps)
        ox = torch.where(active, px + ngx * off2, ox)
        oy = torch.where(active, py + ngy * off2, oy)
        oz = torch.where(active, pz + ngz * off2, oz)
        dx = torch.where(active, nwx, dx)
        dy = torch.where(active, nwy, dy)
        dz = torch.where(active, nwz, dz)

        if bss is not None:
            # ---- the subsurface branch (path.rs:166-210) where the sample
            # transmitted into the one (subsurface) material ----
            is_trans = active & (_chosen_kind(row, n_lob, ub[:, 0]) == LOBE_SPEC_TRANS)
            us = [sampler.get_1d(pid, sid, dim0 + PATH_BSS_PROBE_1D),
                  *sampler.get_2d(pid, sid, dim0 + PATH_BSS_PROBE_2D).unbind(-1),
                  sampler.get_1d(pid, sid, dim0 + PATH_BSS_PICK),
                  *sampler.get_2d(pid, sid, dim0 + PATH_BSS_OUT).unbind(-1)]
            tally_slots(work, sampler, 6 * is_trans)
            got, add, beta, ray = subsurface_reference(
                geom, bss, (px, py, pz), (ssx, ssy, ssz, tsx, tsy, tsz, ngx, ngy, ngz), us,
                is_trans, (br, bg, bb), light_p, light_emit, occluded)
            Lr, Lg, Lb = Lr + add[0], Lg + add[1], Lb + add[2]
            br, bg, bb = beta
            active = (active & ~is_trans) | got
            ox, oy, oz, dx, dy, dz = (torch.where(got, a, b)
                                      for a, b in zip(ray, (ox, oy, oz, dx, dy, dz)))
            spec_prev = spec_prev & ~got

        # ---- Russian roulette (path.rs:212-222) on beta * etaScale ----
        if bounce > 3:
            beta_max = torch.maximum(br, torch.maximum(bg, bb)) * es
            do_rr = active & (beta_max < spec.rr_threshold)
            q = torch.clamp(1.0 - beta_max, min=0.05)
            u_rr = sampler.get_1d(pid, sid, dim0 + PATH_RR)
            tally_slots(work, sampler, do_rr)
            killed = do_rr & (u_rr < q)
            active = active & ~killed
            surv = do_rr & ~killed
            inv_q = 1.0 / torch.clamp(1.0 - q, min=1e-9)
            br = torch.where(surv, br * inv_q, br)
            bg = torch.where(surv, bg * inv_q, bg)
            bb = torch.where(surv, bb * inv_q, bb)

    return torch.stack([Lr, Lg, Lb], dim=-1)


_U999 = np.float32(min((np.float32(0.999) - np.float32(0.25)) / np.float32(0.75),
                       np.float32(ONE_MINUS_EPSILON)))


def subsurface_reference(geom, bss, p, frame, us, is_trans, beta, light_p, light_emit, occluded):
    """The kernel's subsurface branch (the JAX kernel's, path_megakernel.py:
    3042-3300) at the hits p of the lanes `is_trans`, on their frame (ss,
    ts, ng; flat shading) with the slot values us = (axis and channel,
    radius, angle, light pick, exit direction 2d): the projection axis
    and channel, a radius of the channel's profile, the chord through the
    profile's 0.999 radius and PROBE_SEGMENTS closest-hit re-casts along
    it, each limited to seg_len (1 - 1e-4) (the one material: every hit
    counts), the uniform pick among the hits, pdf_sp over 3 axes x 3
    channels / n_found, beta times Sp / pdf; the point-light NEE at the
    exit with the Sw adapter and a shadow ray; the cosine exit direction,
    beta times Sw pi.  Returns (got, the radiance added (3), the new beta
    (3), the next ray (ox, oy, oz, dx, dy, dz), valid where got)."""
    from ..bsdf import bssrdf  # see pack_bssrdf

    w = SimpleNamespace(**bss_constants(bss))
    sw_folded = (w.bss_sw_den, w.bss_eta2)
    px, py, pz = p
    ssx, ssy, ssz, tsx, tsy, tsz, ngx, ngy, ngz = frame
    u1b, u2b0, u2b1, u_pk, uo0, uo1 = us
    br, bg, bb = beta
    # projection axis (bssrdf.rs:118-141): 1/2 the normal, 1/4 each tangent
    sel0 = u1b < 0.5
    sel1 = (u1b >= 0.5) & (u1b < 0.75)
    ub = torch.where(sel0, u1b * 2.0, torch.where(sel1, (u1b - 0.5) * 4.0, (u1b - 0.75) * 4.0))
    axsel = lambda a, b, c: torch.where(sel0, a, torch.where(sel1, b, c))
    vx = (axsel(ssx, tsx, ngx), axsel(ssy, tsy, ngy), axsel(ssz, tsz, ngz))
    vy = (axsel(tsx, ngx, ssx), axsel(tsy, ngy, ssy), axsel(tsz, ngz, ssz))
    vz = (axsel(ngx, ssx, tsx), axsel(ngy, ssy, tsy), axsel(ngz, ssz, tsz))
    # channel, with the reference's u * u * 3 - ch remap (bssrdf.rs:143-145)
    chb = torch.clamp((ub * 3.0).to(torch.int32), 0, 2)
    ub = ub * ub * 3.0 - chb.to(DTYPE)
    d_ch = torch.where(chb == 0, w.bss_d[0], torch.where(chb == 1, w.bss_d[1], w.bss_d[2]))
    r_b = bssrdf.sample_sr(d_ch, u2b0)
    r_mx = 3.0 * d_ch * torch.log(1.0 / (1.0 - torch.tensor(_U999, device=px.device)))
    ok = is_trans & (r_b >= 0.0) & (r_b < r_mx)
    l_ch = 2.0 * torch.sqrt(torch.clamp(r_mx * r_mx - r_b * r_b, min=0.0))
    phi = 2.0 * PI * u2b1
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    base = [p[c] + (vx[c] * cphi + vy[c] * sphi) * r_b - vz[c] * (l_ch * 0.5) for c in range(3)]
    target = [base[c] + vz[c] * l_ch for c in range(3)]

    # the probe chain
    cx, cy, cz = base
    alive = ok
    found = []  # per segment: (hit, x, y, z, ngx, ngy, ngz)
    for _ in range(bssrdf.PROBE_SEGMENTS):
        sgx, sgy, sgz = target[0] - cx, target[1] - cy, target[2] - cz
        sl = torch.sqrt(torch.clamp(sgx * sgx + sgy * sgy + sgz * sgz, min=0.0))
        inv_sl = 1.0 / torch.clamp(sl, min=1e-20)
        pdx, pdy, pdz = sgx * inv_sl, sgy * inv_sl, sgz * inv_sl
        live = alive & (sl > 1e-9)
        t, best = geom.closest(cx, cy, cz, pdx, pdy, pdz, live, sl * (1.0 - 1e-4), tag="probe")
        gk = live & (best >= 0)
        nrm = geom.table[best.clamp(min=0), 9:12]
        pnx, pny, pnz = (torch.where(gk, nrm[:, c], 0.0) for c in range(3))
        hx, hy, hz = cx + pdx * t, cy + pdy * t, cz + pdz * t
        found.append((gk, hx, hy, hz, pnx, pny, pnz))
        mag = torch.abs(hx) + torch.abs(hy) + torch.abs(hz)
        eps = 1e-4 + 1e-5 * mag
        off = torch.where(pdx * pnx + pdy * pny + pdz * pnz < 0.0, -eps, eps)
        cx = torch.where(gk, hx + pnx * off, cx)
        cy = torch.where(gk, hy + pny * off, cy)
        cz = torch.where(gk, hz + pnz * off, cz)
        alive = gk

    nf = sum(f[0].to(torch.int32) for f in found)
    ok = ok & (nf > 0)
    pick = torch.minimum(torch.clamp((ub * nf.to(DTYPE)).to(torch.int32), min=0),
                         torch.clamp(nf - 1, min=0))
    cum = torch.zeros_like(nf)
    ex = ey = ez = enx = eny = enz = torch.zeros_like(px)
    for gk, hx, hy, hz, pnx, pny, pnz in found:
        cum = cum + gk.to(torch.int32)
        sel = gk & (cum == pick + 1)
        ex, ey, ez = torch.where(sel, hx, ex), torch.where(sel, hy, ey), torch.where(sel, hz, ez)
        enx, eny, enz = (torch.where(sel, a, b) for a, b in zip((pnx, pny, pnz), (enx, eny, enz)))

    # pdf_sp (bssrdf.rs:195-232): 3 axes x 3 channels / n_found
    dvx, dvy, dvz = px - ex, py - ey, pz - ez
    dl = (_dot3(ssx, ssy, ssz, dvx, dvy, dvz), _dot3(tsx, tsy, tsz, dvx, dvy, dvz),
          _dot3(ngx, ngy, ngz, dvx, dvy, dvz))
    nl = (_dot3(ssx, ssy, ssz, enx, eny, enz), _dot3(tsx, tsy, tsz, enx, eny, enz),
          _dot3(ngx, ngy, ngz, enx, eny, enz))
    rp = (torch.sqrt(torch.clamp(dl[1] * dl[1] + dl[2] * dl[2], min=0.0)),
          torch.sqrt(torch.clamp(dl[2] * dl[2] + dl[0] * dl[0], min=0.0)),
          torch.sqrt(torch.clamp(dl[0] * dl[0] + dl[1] * dl[1], min=0.0)))
    pdf_b = torch.zeros_like(px)
    for axis, aprob in enumerate((0.25, 0.25, 0.5)):
        anl = torch.abs(nl[axis])
        for c in range(3):
            folded = (w.bss_d3[c], w.bss_pdf1_den[c], w.bss_pdf3_den[c])
            pdf_b = pdf_b + bssrdf.pdf_sr(w.bss_d[c], rp[axis], folded) * anl * aprob
    pdf_b = pdf_b * (1.0 / 3.0)
    pdf_b = pdf_b / torch.clamp(nf.to(DTYPE), min=1.0)
    dist = torch.sqrt(torch.clamp(dvx * dvx + dvy * dvy + dvz * dvz, min=0.0))
    rr = torch.clamp(dist, min=1e-6)
    sp3 = [w.bss_R[c] * (torch.exp(-rr / w.bss_d[c]) + torch.exp(-rr / w.bss_d3[c]))
           / (w.bss_sr_den[c] * rr) for c in range(3)]
    got = is_trans & ok & (pdf_b > 0.0)
    inv_pb = 1.0 / torch.clamp(pdf_b, min=1e-20)
    br = torch.where(got, br * sp3[0] * inv_pb, br)
    bg = torch.where(got, bg * sp3[1] * inv_pb, bg)
    bb = torch.where(got, bb * sp3[2] * inv_pb, bb)

    # the exit's direct light: a uniformly picked point light, the Sw adapter
    n_lights = light_p.shape[0]
    add = [torch.zeros_like(px)] * 3
    if n_lights > 0:
        li = torch.clamp((u_pk * n_lights).to(torch.int64), max=n_lights - 1)
        lp, le = light_p[li], light_emit[li]
        t2x, t2y, t2z = lp[:, 0] - ex, lp[:, 1] - ey, lp[:, 2] - ez
        d2b = torch.clamp(t2x * t2x + t2y * t2y + t2z * t2z, min=1e-20)
        inv_db = _rsqrt(d2b)
        cwi = _dot3(t2x * inv_db, t2y * inv_db, t2z * inv_db, enx, eny, enz)
        fsw = bssrdf.sw_f(w.bss_eta, cwi, sw_folded) * torch.abs(cwi)
        mag = torch.abs(ex) + torch.abs(ey) + torch.abs(ez)
        eps = 1e-4 + 1e-5 * mag
        off = torch.where(_dot3(t2x, t2y, t2z, enx, eny, enz) < 0.0, -eps, eps)
        sx, sy, sz = ex + enx * off, ey + eny * off, ez + enz * off
        occ = occluded(sx, sy, sz, lp[:, 0] - sx, lp[:, 1] - sy, lp[:, 2] - sz,
                       1.0 - SHADOW_EPSILON, got)
        sc2 = torch.where(got & ~occ, fsw * float(n_lights) / d2b, 0.0)
        add = [b * le[:, c] * sc2 for c, b in enumerate((br, bg, bb))]

    # the next direction: the Sw adapter cosine-sampled at the exit
    dxo, dyo = _concentric_disk(uo0, uo1)
    zo = torch.sqrt(torch.clamp(1.0 - dxo * dxo - dyo * dyo, min=0.0))
    use_x = torch.abs(enx) > torch.abs(eny)
    inv_a = 1.0 / torch.sqrt(torch.where(use_x, enx * enx + enz * enz, eny * eny + enz * enz))
    a1x = torch.where(use_x, -enz, 0.0) * inv_a
    a1y = torch.where(use_x, 0.0, enz) * inv_a
    a1z = torch.where(use_x, enx, -eny) * inv_a
    a2x, a2y, a2z = eny * a1z - enz * a1y, enz * a1x - enx * a1z, enx * a1y - eny * a1x
    wx = a1x * dxo + a2x * dyo + enx * zo
    wy = a1y * dxo + a2y * dyo + eny * zo
    wz = a1z * dxo + a2z * dyo + enz * zo
    swo = bssrdf.sw_f(w.bss_eta, torch.clamp(zo, min=1e-9), sw_folded) * PI
    br, bg, bb = (torch.where(got, b * swo, b) for b in (br, bg, bb))
    mag = torch.abs(ex) + torch.abs(ey) + torch.abs(ez)
    eps = 1e-4 + 1e-5 * mag
    off = torch.where(_dot3(wx, wy, wz, enx, eny, enz) < 0.0, -eps, eps)
    ray = (ex + enx * off, ey + eny * off, ez + enz * off, wx, wy, wz)
    return got, add, (br, bg, bb), ray
