"""Scene JSON loader (rs_ray_toy_tpu/scene/loader.py), main-path subset.

Parses the reference's scene schema with the same typed accessors and
defaults (renderprocess.rs:136-252).  Ported: RGB ImageTextures in
`rgb_texture` (a PNG decoded by scene/png.py, the sRGB curve undone, its
MIPMap built; UV mapping, wrap, scale, gamma and max_aniso; an entry of
an unknown type or whose image cannot be read is skipped, as in the JAX
loader), materials (matte, its kd possibly such a texture, plastic,
metal, mirror, glass, translucent, mix, Disney with its BSSRDF, debug),
`objs`, triangle and sphere primitives with
`instances` (spheres with their z / phi clips), point and distant lights,
diffuse lights on a sphere (a partial one sampled whole, as the JAX
loader does) or one triangle `light_shape`, infinite lights in `lights`
and `infinite_lights` on a constant map (no `mapname`, or one that does
not exist); a point, distant or diffuse light listed in `infinite_lights`
is one more NEE light, and a light of an unknown `light_type` or a
diffuse light of an unknown `shape_type` is skipped, as in the JAX
loader; media (Homogeneous or GridDensity, by preset or the reference's
default coefficients): a primitive's `medium_interface` (each side's
medium appended in file order, a primitive skipped for its material or
mesh included, as in the JAX loader) and the camera's `Camera.medium`,
appended last, so that medium ids agree with the JAX package's; Film with
its box, triangle or Gaussian filter, StratifiedSampler, HaltonSampler,
RealisticCamera and the Path, Debug,
DirectLighting, Volpath, SPPM and AO integrators (any other name is AO,
as in the JAX package).  Every other feature the schema can name raises
NotImplementedError with the feature's name (an existing environment
image among them); beside those lights, nothing is dropped silently.  Host numpy throughout;
`load_scene` returns the same `RenderJob` fields as the JAX package.
"""

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..bsdf import recipes
from ..bsdf.lobes import MaterialTableBuilder
from ..core import spectrum
from ..core.transform import Transform
from . import mipmap, png
from . import textures as tex
from .objparser import parse_obj
from .subsurface_presets import SUBSURFACE_PARAMETER_TABLE
from ..core.sampling import Distribution2D
from .types import (
    AREA_SHAPE_NONE,
    AREA_SHAPE_SPHERE,
    AREA_SHAPE_TRIANGLE,
    LIGHT_DIFFUSE_AREA,
    LIGHT_DISTANT,
    LIGHT_INFINITE,
    LIGHT_POINT,
    EnvLight,
    LightSoA,
    MediumSpec,
    SphereSoA,
    TriangleSoA,
)

# ---- typed accessors (renderprocess.rs:136-240) ----


def read_i64(cfg, key, default):
    v = cfg.get(key)
    return int(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else default


def read_f64(cfg, key, default):
    v = cfg.get(key)
    return float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else default


def read_bool(cfg, key, default):
    v = cfg.get(key)
    return v if isinstance(v, bool) else default


def read_string(cfg, key, default):
    v = cfg.get(key)
    return v if isinstance(v, str) else default


def fetch_xyz(cfg, key, default):
    v = cfg.get(key)
    if isinstance(v, list) and len(v) == 3 and all(isinstance(x, (int, float)) for x in v):
        return np.array(v, dtype=np.float64)
    return np.asarray(default, dtype=np.float64)


def fetch_vector2(cfg, key, default):
    v = cfg.get(key)
    if isinstance(v, list) and len(v) == 2:
        return np.array(v, dtype=np.float64)
    return np.asarray(default, dtype=np.float64)


def make_to_world(cfg) -> Transform:
    """T * R * S (renderprocess.rs:242-252)."""
    world_pos = fetch_xyz(cfg, "world_pos", [0.0, 0.0, 0.0])
    axis = fetch_xyz(cfg, "rotation_axis", [0.0, 0.0, 0.0])
    angle = read_f64(cfg, "rotation_angle", 0.0)
    scale = fetch_xyz(cfg, "scale", [1.0, 1.0, 1.0])
    return (
        Transform.translate(world_pos)
        * Transform.rotate(angle, axis)
        * Transform.scale(scale[0], scale[1], scale[2])
    )


def make_spectrum(cfg, key, default):
    """{"values": [r, g, b]} or the scalar default (renderprocess.rs:1055-1076)."""
    v = cfg.get(key)
    if isinstance(v, dict) and isinstance(v.get("values"), list):
        return np.array(v["values"], dtype=np.float64)
    return np.full(3, float(default))


# ---- render specs ----


@dataclass
class FilmSpec:
    xres: int
    yres: int
    diagonal_mm: float
    scale: float
    max_sample_luminance: float
    filter_type: str
    filter_radius: np.ndarray
    gaussian_alpha: float = 2.0


@dataclass
class SamplerSpec:
    kind: str  # "stratified" or "halton"
    jitter: bool = True
    xsamp: int = 4
    ysamp: int = 4
    # HaltonSampler
    nsamp: int = 16
    sample_at_center: bool = False

    @property
    def spp(self):
        return self.xsamp * self.ysamp if self.kind == "stratified" else self.nsamp


@dataclass
class IntegratorSpec:
    kind: str  # "path", "debug", "direct", "volpath", "ao" or "sppm"
    max_depth: int = 5
    light_strategy: str = "one"  # DirectLighting: "one" or "all"
    rr_threshold: float = 1.0
    # AO (integrator/ao.rs)
    cos_sample: bool = True
    n_samples: int = 64
    # SPPM
    radius: float = 1.0
    n_iters: int = 5
    photons_per_iter: int = 1
    write_freq: int = 1 << 31


@dataclass
class CameraSpec:
    cam_to_world: Transform
    shutter_open: float
    shutter_close: float
    aperture_diameter: float
    focus_distance: float
    simple_weighting: bool
    lens_data: np.ndarray


@dataclass
class SceneBundle:
    triangles: TriangleSoA
    lights: LightSoA
    materials: Dict
    mediums: List[MediumSpec] = field(default_factory=list)
    camera_medium: int = -1  # index into mediums, -1: the camera sits in vacuum
    spheres: Optional[SphereSoA] = None
    # the environments of the infinite lights, `lights` entries first in
    # file order (LightSoA.shape_index points here), then the
    # escape-only `infinite_lights` ones
    infinite: List[EnvLight] = field(default_factory=list)
    # the image textures (materials' s0_tex index its records)
    registry: tex.TextureRegistry = field(default_factory=tex.TextureRegistry)


@dataclass
class RenderJob:
    scene: SceneBundle
    camera: CameraSpec
    film: FilmSpec
    sampler: SamplerSpec
    integrator: IntegratorSpec


# copper spectral data (metal.rs COPPER_*), reduced to RGB like the
# reference's RGB build: the MetalMaterial defaults
_COPPER_WAVELENGTHS = np.array([
    298.7570554, 302.4004341, 306.1337728, 309.960445, 313.8839949,
    317.9081487, 322.036826, 326.2741526, 330.6244747, 335.092373,
    339.6826795, 344.4004944, 349.2512056, 354.2405086, 359.374429,
    364.6593471, 370.1020239, 375.7096303, 381.4897785, 387.4505563,
    393.6005651, 399.9489613, 406.5055016, 413.2805933, 420.2853492,
    427.5316483, 435.0322035, 442.8006357, 450.8515564, 459.2006593,
    467.8648226, 476.8622231, 486.2124627, 495.936712, 506.0578694,
    516.6007417, 527.5922468, 539.0616435, 551.0407911, 563.5644455,
    576.6705953, 590.4008476, 604.8008683, 619.92089, 635.8162974,
    652.5483053, 670.1847459, 688.8009889, 708.4810171, 729.3186941,
    751.4192606, 774.9011125, 799.8979226, 826.5611867, 855.0632966,
    885.6012714])
_COPPER_N = np.array([
    1.400313, 1.38, 1.358438, 1.34, 1.329063, 1.325, 1.3325, 1.34, 1.334375,
    1.325, 1.317812, 1.31, 1.300313, 1.29, 1.281563, 1.27, 1.249062, 1.225,
    1.2, 1.18, 1.174375, 1.175, 1.1775, 1.18, 1.178125, 1.175, 1.172812,
    1.17, 1.165312, 1.16, 1.155312, 1.15, 1.142812, 1.135, 1.131562, 1.12,
    1.092437, 1.04, 0.950375, 0.826, 0.645875, 0.468, 0.35125, 0.272,
    0.230813, 0.214, 0.20925, 0.213, 0.21625, 0.223, 0.2365, 0.25, 0.254188,
    0.26, 0.28, 0.3])
_COPPER_K = np.array([
    1.662125, 1.687, 1.703313, 1.72, 1.744563, 1.77, 1.791625, 1.81,
    1.822125, 1.834, 1.85175, 1.872, 1.89425, 1.916, 1.931688, 1.95,
    1.972438, 2.015, 2.121562, 2.21, 2.177188, 2.13, 2.160063, 2.21,
    2.249938, 2.289, 2.326, 2.362, 2.397625, 2.433, 2.469187, 2.504,
    2.535875, 2.564, 2.589625, 2.605, 2.595562, 2.583, 2.5765, 2.599,
    2.678062, 2.809, 3.01075, 3.24, 3.458187, 3.67, 3.863125, 4.05,
    4.239563, 4.43, 4.619563, 4.817, 5.034125, 5.26, 5.485625, 5.717])

COPPER_N_RGB = spectrum.from_sampled_rgb(_COPPER_WAVELENGTHS, _COPPER_N)
COPPER_K_RGB = spectrum.from_sampled_rgb(_COPPER_WAVELENGTHS, _COPPER_K)

def load_scene(path: str) -> RenderJob:
    """Parse a scene JSON in the reference's schema (renderprocess.rs)."""
    root_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as fh:
        cfg = json.load(fh)
    registry = tex.TextureRegistry()
    rgb_tex = _make_textures(cfg, root_dir, registry)

    integrator = _make_integrator_spec(cfg.get("Integrator", {}))
    # smooth glass is one FresnelSpecular lobe only under Path and Volpath
    # (glass.rs)
    allow_multiple_lobes = integrator.kind in ("path", "volpath")

    mat_builder = MaterialTableBuilder()
    mat_ids: Dict[str, int] = {}
    host_mats = {}  # MixMaterial names materials defined before it
    for mat_cfg in cfg.get("materials", []) or []:
        hm = _make_material(mat_cfg, host_mats, allow_multiple_lobes, rgb_tex)
        if hm is not None:
            mat_ids[hm.name] = mat_builder.add(hm)
            host_mats[hm.name] = hm

    meshes: Dict[str, Dict] = {}
    for obj_cfg in cfg.get("objs", []) or []:
        name = read_string(obj_cfg, "obj_name", "DefaultObjName")
        filename = read_string(obj_cfg, "filename", "DefaultObj")
        meshes[name] = {
            "mesh": parse_obj(os.path.join(root_dir, filename)),
            "to_world": make_to_world(obj_cfg),
        }

    tris, sphs, mediums = _make_aggregate(cfg, meshes, mat_ids)
    lights, infinite = _make_lights(cfg, meshes, _world_radius(tris, sphs), root_dir)
    bundle = SceneBundle(
        triangles=_pack_triangles(tris),
        lights=lights,
        materials=mat_builder.pack(),
        mediums=mediums,
        spheres=_pack_spheres(sphs),
        infinite=infinite,
        registry=registry,
    )
    # the camera medium after the aggregate's (the JAX loader's order)
    cam_medium = _parse_medium((cfg.get("Camera", {}) or {}).get("medium"))
    if cam_medium is not None:
        bundle.mediums.append(cam_medium)
        bundle.camera_medium = len(bundle.mediums) - 1
    return RenderJob(
        bundle,
        _make_camera_spec(cfg.get("Camera", {})),
        _make_film_spec(cfg.get("Film", {})),
        _make_sampler_spec(cfg.get("Sampler", {})),
        integrator,
    )


# ---- textures (renderprocess.rs:298-515) ----

# the texture kinds the JAX package evaluates and the port does not, by section
_UNPORTED_TEXTURES = {
    "float_texture": ("MixTexture", "BilerpTexture", "CheckerBoardTexture", "ScaleTexture",
                      "WindyTexture", "WrinkledTexture"),
    "rgb_texture": ("MixTexture", "BilerpTexture", "CheckerBoardTexture", "ScaleTexture",
                    "WindyTexture", "WrinkledTexture", "UVTexture"),
}


def _make_mapping(rec, cfg):
    """The JAX loader's _make_mapping for the UV mapping (its quirk kept: a
    mapping block defaults du and dv to 1); the other known mappings
    raise, an unknown one is a ValueError as there."""
    mcfg = cfg.get("mapping")
    if not isinstance(mcfg, dict):
        return
    kind = read_string(mcfg, "mapping", "uv")
    if kind == "uv":
        rec.su = read_f64(mcfg, "su", 1.0)
        rec.sv = read_f64(mcfg, "sv", 1.0)
        rec.du = read_f64(mcfg, "du", 1.0)
        rec.dv = read_f64(mcfg, "dv", 1.0)
    elif kind in ("spherical", "cylindrical", "planar"):
        raise NotImplementedError(f"{kind} texture mapping (ImageTexture)")
    else:
        raise ValueError(f"Unsupported mapping type {kind}")


def _make_textures(cfg, root_dir, registry):
    """The JAX loader's _make_textures for RGB ImageTextures: name ->
    record id.  As there, an entry of an unknown texture_type, or whose
    image cannot be read, is skipped; the kinds the JAX package evaluates
    and the port does not, float textures, and trilinear filtering raise
    NotImplementedError naming them."""
    rgb_tex: Dict[str, int] = {}
    for section in ("float_texture", "rgb_texture"):
        for tcfg in cfg.get(section, []) or []:
            ttype = read_string(tcfg, "texture_type", "")
            name = read_string(tcfg, "texture_name", "DefaultTextureName")
            if ttype == "CheckerBoardTexture" and read_i64(tcfg, "dimension", 2) not in (2, 3):
                continue  # the JAX loader skips it
            if ttype in _UNPORTED_TEXTURES[section]:
                raise NotImplementedError(f"{ttype} textures ({section} {name!r})")
            if section == "float_texture" or ttype != "ImageTexture":
                continue  # unknown here: skipped, as in the JAX loader
            rec = tex.TexRecord(kind=tex.TEX_IMAGE, is_rgb=True)
            _make_mapping(rec, tcfg)
            filename = os.path.join(root_dir, read_string(tcfg, "filename", "DefaultTexture"))
            wrap = mipmap.WRAP_NAMES.get(read_string(tcfg, "wrap", "repeat"), mipmap.WRAP_REPEAT)
            rec.scale = read_f64(tcfg, "scale", 1.0)
            gamma = read_bool(tcfg, "gamma", filename.endswith("png"))
            if read_bool(tcfg, "do_trilinear", False):
                raise NotImplementedError(f"trilinear filtering (ImageTexture {name!r} "
                                          "do_trilinear)")
            try:
                img = png.load_image(filename, gamma)
            except OSError:
                continue  # an unreadable image: skipped, as in the JAX loader
            rec.image_id = registry.add_image(mipmap.build_mipmap(
                img, wrap=wrap, do_trilinear=False,
                max_aniso=read_f64(tcfg, "max_aniso", 8.0)))
            rgb_tex[name] = registry.add(rec)
    return rgb_tex


# ---- materials (renderprocess.rs:664-871) ----


def _rgb_param(cfg, key, default, rgb_tex=None):
    """RGB parameter: (constant, texture record id or -1).  A name of a
    loaded RGB texture is that texture (its constant zeros); a number,
    [r, g, b] or {"values": [r, g, b]} is a constant; anything else,
    an unknown name among them, the default (renderprocess.rs:288-294)."""
    v = cfg.get(key)
    if isinstance(v, str) and rgb_tex and v in rgb_tex:
        return np.zeros(3), rgb_tex[v]
    if isinstance(v, dict) and "values" in v:
        v = v["values"]
    if isinstance(v, (int, float, list)):
        return np.asarray(v, np.float64) * np.ones(3), -1
    return np.asarray(default, np.float64) * np.ones(3), -1


def _float_param(cfg, key, default):
    v = cfg.get(key)
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    return default


def _make_material(cfg, host_mats, allow_multiple_lobes, rgb_tex=None):
    """The material of `cfg`: a matte's kd may be a texture; another
    textured RGB parameter is listed in the material's `textured` (its
    constant zeros), which every renderer but AO refuses."""
    hm = _make_material_lobes(cfg, host_mats, allow_multiple_lobes, rgb_tex)
    mtype = read_string(cfg, "material_type", "")
    if hm is not None and mtype != "MixMaterial":
        hm.textured = tuple(f"{key} ({mtype})" for key in cfg
                            if key not in _NOT_PARAMS and (key, mtype) != ("kd", "MatteMaterial")
                            and _rgb_param(cfg, key, 0.0, rgb_tex)[1] >= 0)
    return hm


# material keys that name no RGB parameter (a bump map is a float texture,
# and every float texture kind raises at load)
_NOT_PARAMS = ("material_type", "material_name", "mat1", "mat2", "bump_map")


def _make_material_lobes(cfg, host_mats, allow_multiple_lobes, rgb_tex):
    mtype = read_string(cfg, "material_type", "")
    name = read_string(cfg, "material_name", "DefaultMaterialName")
    remap = read_bool(cfg, "remap_roughness", False)
    R = lambda key, d: _rgb_param(cfg, key, d, rgb_tex)[0]
    F = lambda key, d: _float_param(cfg, key, d)
    if mtype == "MatteMaterial":
        kd, kd_tex = _rgb_param(cfg, "kd", 0.5, rgb_tex)
        return recipes.matte(name, kd, F("sigma", 0.0), kd_tex)
    if mtype == "PlasticMaterial":
        return recipes.plastic(name, R("kd", 0.25), R("ks", 0.25), F("roughness", 0.1), remap)
    if mtype == "MetalMaterial":
        rough = F("roughness", 0.01)
        return recipes.metal(
            name, R("eta", COPPER_N_RGB), R("k", COPPER_K_RGB),
            F("u_roughness", rough), F("v_roughness", rough), remap,
        )
    if mtype == "MirrorMaterial":
        return recipes.mirror(name, R("kr", 0.9))
    if mtype == "GlassMaterial":
        return recipes.glass(
            name, R("kr", 1.0), R("kt", 1.0), F("u_roughness", 0.0),
            F("v_roughness", 0.0), F("eta", 1.5), remap, allow_multiple_lobes,
        )
    if mtype == "TranslucentMaterial":
        return recipes.translucent(
            name, R("kd", 0.25), R("ks", 0.25), F("roughness", 0.1), R("reflect", 0.25),
            R("transmit", 0.25), remap,
        )
    if mtype == "MixMaterial":
        m1 = host_mats.get(read_string(cfg, "mat1", ""))
        m2 = host_mats.get(read_string(cfg, "mat2", ""))
        if m1 is None or m2 is None:
            return None
        return recipes.mix(name, m1, m2, R("scale", 0.5))
    if mtype == "DisneyMaterial":
        return recipes.disney(
            name, R("color", 0.5), F("metallic", 0.0), F("eta", 1.5), F("roughness", 0.5),
            F("specular_tint", 0.0), F("anisotropic", 0.0), F("sheen", 0.0),
            F("sheen_tint", 0.5), F("clearcoat", 0.0), F("clearcoat_gloss", 1.0),
            F("spec_trans", 0.0), read_bool(cfg, "thin", False), F("flatness", 0.0),
            F("diff_trans", 1.0), R("scatter_distance", 0.0),
        )
    if mtype == "Debug":
        return recipes.debug(name)
    return None


# ---- aggregate (renderprocess.rs:1178-1304) ----


def _expand_mesh(mesh_entry, instance_to_world, mat_id):
    """One world-space triangle per face, optionally instanced
    (TransformedPrimitive, primitives.rs:115-140)."""
    mesh = mesh_entry["mesh"]
    xf = mesh_entry["to_world"]
    if instance_to_world is not None:
        xf = instance_to_world * xf
    p = xf.apply_point(mesh.p)
    vi = mesh.vertex_indices.reshape(-1, 3)
    has_n = mesh.normal_indices.size > 0 and mesh.n.size > 0
    n_world = xf.apply_normal(mesh.n) if has_n else None
    ni = mesh.normal_indices.reshape(-1, 3) if has_n else None
    has_uv = mesh.uv_indices.size > 0 and mesh.uv.size > 0
    ti = mesh.uv_indices.reshape(-1, 3) if has_uv else None
    return [
        {
            "p": p[vi[t]],
            "n": n_world[ni[t]] if has_n else None,
            "uv": mesh.uv[ti[t]] if has_uv else None,
            "mat": mat_id,
        }
        for t in range(mesh.n_triangles)
    ]


def _sphere_from_cfg(cfg, extra_to_world=None):
    """A sphere's transform, radius and clips (renderprocess.rs)."""
    to_world = make_to_world(cfg)
    if extra_to_world is not None:
        to_world = extra_to_world * to_world
    radius = read_f64(cfg, "radius", 1.0)
    return {
        "o2w": to_world.m,
        "radius": radius,
        "z_min": read_f64(cfg, "z_min", -radius),
        "z_max": read_f64(cfg, "z_max", radius),
        "phi_max_deg": read_f64(cfg, "phi_max", 360.0),
    }


def _make_aggregate(cfg, meshes, mat_ids):
    """(triangles, spheres, media) of the aggregate; a primitive whose
    material or mesh is unknown is skipped, as in the reference.  A
    primitive's medium_interface (renderprocess.rs:1193-1207) appends its
    inside medium, then its outside one, before that check, as the JAX
    loader's parse_mi does; every triangle and sphere it makes carries
    their ids (med_in, med_out; -1 for a side without a medium)."""
    agg = cfg.get("Aggregate", {}) or {}
    tris: List[Dict] = []
    sphs: List[Dict] = []
    mediums: List[MediumSpec] = []

    def parse_mi(prim):
        ids = []
        mi_cfg = prim.get("medium_interface")
        for side in ("inside", "outside"):
            spec = _parse_medium(mi_cfg.get(side)) if isinstance(mi_cfg, dict) else None
            if spec is not None:
                mediums.append(spec)
            ids.append(len(mediums) - 1 if spec is not None else -1)
        return dict(med_in=ids[0], med_out=ids[1])

    for prim in agg.get("primitives", []) or []:
        ptype = read_string(prim, "primitive_type", "")
        mat_id = mat_ids.get(read_string(prim, "material_name", "DefaultMaterialName"), -1)
        media = parse_mi(prim)
        instances = prim.get("instances")
        if ptype == "sphere":
            if mat_id < 0:
                continue
            xfs = [make_to_world(inst) for inst in instances] if isinstance(instances, list) \
                else [None]
            sphs.extend(dict(_sphere_from_cfg(prim, xf), mat=mat_id, **media) for xf in xfs)
            continue
        if ptype != "triangle":
            continue
        obj_name = read_string(prim, "obj_name", "DefaultObjName")
        if obj_name not in meshes or mat_id < 0:
            continue
        xfs = [make_to_world(inst) for inst in instances] if isinstance(instances, list) \
            else [None]
        for xf in xfs:
            tris.extend(dict(t, **media) for t in _expand_mesh(meshes[obj_name], xf, mat_id))
    return tris, sphs, mediums


def _pack_spheres(sphs) -> SphereSoA:
    """Sphere table, float32: clips ordered and clamped to the radius,
    theta of each z clip, phi_max in radians (the JAX loader's)."""
    radius = np.array([s["radius"] for s in sphs], np.float64)
    zlo = np.array([s["z_min"] for s in sphs], np.float64)
    zhi = np.array([s["z_max"] for s in sphs], np.float64)
    z_min = np.clip(np.minimum(zlo, zhi), -radius, radius)
    z_max = np.clip(np.maximum(zlo, zhi), -radius, radius)
    o2w = np.asarray([s["o2w"] for s in sphs], np.float64).reshape(-1, 4, 4)
    f32 = lambda a: np.asarray(a, np.float32)
    return SphereSoA(
        o2w=f32(o2w),
        w2o=f32(np.linalg.inv(o2w) if sphs else o2w),
        radius=f32(radius),
        z_min=f32(z_min),
        z_max=f32(z_max),
        theta_min=f32(np.arccos(np.clip(z_min / radius, -1, 1))),
        theta_max=f32(np.arccos(np.clip(z_max / radius, -1, 1))),
        phi_max=f32(np.deg2rad(np.clip([s["phi_max_deg"] for s in sphs], 0.0, 360.0))),
        mat=np.asarray([s["mat"] for s in sphs], np.int32),
        med_in=np.asarray([s["med_in"] for s in sphs], np.int32),
        med_out=np.asarray([s["med_out"] for s in sphs], np.int32),
    )


def _pack_triangles(tris) -> TriangleSoA:
    if not tris:
        z3, z2 = np.zeros((0, 3), np.float32), np.zeros((0, 2), np.float32)
        z = np.zeros(0, np.int32)
        return TriangleSoA(z3, z3, z3, z3, z3, z3, z2, z2, z2, z, z3, z3, z3, np.zeros(0, bool),
                           z, z)
    p = np.stack([t["p"] for t in tris])  # (T,3,3)
    default_uv = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]])
    uv = np.stack([t["uv"] if t["uv"] is not None else default_uv for t in tris])
    # ray-independent shading geometry (triangle.rs:276-299) in float64
    dp02 = p[:, 0] - p[:, 2]
    dp12 = p[:, 1] - p[:, 2]
    ng = np.cross(dp02, dp12)
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-30)
    duv02 = uv[:, 0] - uv[:, 2]
    duv12 = uv[:, 1] - uv[:, 2]
    deter = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    degen = np.abs(deter) < 1e-8
    idet = 1.0 / np.where(degen, 1.0, deter)
    dpdu = (dp02 * duv12[:, 1:2] - dp12 * duv02[:, 1:2]) * idet[:, None]
    dpdv = (-dp02 * duv12[:, 0:1] + dp12 * duv02[:, 0:1]) * idet[:, None]
    if degen.any():
        # coordinate_system(ng), in float32 like the JAX loader
        g = ng[degen].astype(np.float32)
        use_x = np.abs(g[:, 0]) > np.abs(g[:, 1])
        inv_a = np.float32(1.0) / np.sqrt(
            np.where(use_x, g[:, 0] ** 2 + g[:, 2] ** 2, g[:, 1] ** 2 + g[:, 2] ** 2)
        )
        zero = np.zeros_like(g[:, 0])
        v2 = np.where(
            use_x[:, None],
            np.stack([-g[:, 2], zero, g[:, 0]], -1) * inv_a[:, None],
            np.stack([zero, g[:, 2], -g[:, 1]], -1) * inv_a[:, None],
        )
        dpdu[degen] = v2
        dpdv[degen] = np.cross(g, v2)
    n = np.stack([t["n"] if t["n"] is not None else np.zeros((3, 3)) for t in tris])
    f32 = lambda a: np.asarray(a, np.float32)
    return TriangleSoA(
        p0=f32(p[:, 0]), p1=f32(p[:, 1]), p2=f32(p[:, 2]),
        n0=f32(n[:, 0]), n1=f32(n[:, 1]), n2=f32(n[:, 2]),
        uv0=f32(uv[:, 0]), uv1=f32(uv[:, 1]), uv2=f32(uv[:, 2]),
        mat=np.asarray([t["mat"] for t in tris], np.int32),
        ng=f32(ng),
        dpdu=f32(dpdu),
        dpdv=f32(dpdv),
        has_n=np.array([t["n"] is not None for t in tris]),
        med_in=np.asarray([t["med_in"] for t in tris], np.int32),
        med_out=np.asarray([t["med_out"] for t in tris], np.int32),
    )


# ---- lights (renderprocess.rs:921-1053) ----


def _world_radius(tris, sphs):
    """Radius of the bounding sphere of the triangles and the spheres'
    object boxes, float32 (the JAX loader's _world_bound / _make_lights,
    float64 until the cast); 0 for an empty aggregate."""
    pts = [t["p"] for t in tris]
    for s in sphs:
        r = s["radius"]
        corners = np.array([[x, y, z] for x in (-r, r) for y in (-r, r) for z in (-r, r)])
        pts.append(corners @ s["o2w"][:3, :3].T + s["o2w"][:3, 3])
    if not pts:
        return np.float32(0.0)
    p = np.concatenate(pts)
    lo, hi = p.min(axis=0), p.max(axis=0)
    center = 0.5 * (lo + hi)
    return np.float32(np.linalg.norm(hi - center))


def _diffuse_shape(lcfg, meshes):
    """A diffuse light's shape (renderprocess.rs:999-1017): (shape kind,
    sphere o2w, sphere radius, triangle vertices, area).  A sphere's area
    is the full sphere's and it is sampled whole, whatever its clips (the
    JAX loader's).  None for a shape_type other than sphere or triangle:
    the JAX loader skips such a light without a word."""
    shape_cfg = lcfg.get("light_shape")
    if not isinstance(shape_cfg, dict):
        raise NotImplementedError("diffuse lights without a light_shape")
    stype = read_string(shape_cfg, "shape_type", "")
    if stype == "sphere":
        sph = _sphere_from_cfg(shape_cfg)
        r = sph["radius"]
        return AREA_SHAPE_SPHERE, sph["o2w"], r, np.zeros((3, 3)), 4.0 * np.pi * r**2
    if stype == "triangle":
        obj_name = read_string(shape_cfg, "obj_name", "")
        if obj_name not in meshes:
            raise NotImplementedError(f"diffuse lights on an unknown mesh ({obj_name!r})")
        tri = _expand_mesh(meshes[obj_name], None, -1)[read_i64(shape_cfg, "tri_num", 0)]
        p = tri["p"]
        area = 0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))
        return AREA_SHAPE_TRIANGLE, np.eye(4), 1.0, p, area
    return None


def _build_env_map(texmap_path, to_world: Transform, escape_le):
    """InfiniteAreaLight construction (lights/infinite.rs:34-112) on the
    constant map the JAX loader builds when the image is absent: 8x8
    texels of 1, and a Distribution2D over luminance * sin(theta) at
    twice the map's resolution.  The radiance is the texel; the light's
    `l` and `scale` reach only its power."""
    if texmap_path and os.path.exists(texmap_path):
        raise NotImplementedError("image-map environment lights")
    base = np.ones((8, 8, 3), np.float64)
    h2, w2 = 2 * base.shape[0], 2 * base.shape[1]
    vs = (np.arange(h2) + 0.5) / h2
    us = (np.arange(w2) + 0.5) / w2
    vi = np.clip((vs * base.shape[0]).astype(int), 0, base.shape[0] - 1)
    ui = np.clip((us * base.shape[1]).astype(int), 0, base.shape[1] - 1)
    lum = 0.212671 * base[..., 0] + 0.715160 * base[..., 1] + 0.072169 * base[..., 2]
    func = lum[np.ix_(vi, ui)] * np.sin(np.pi * vs)[:, None]
    return EnvLight(
        rgb=base[0, 0].astype(np.float32),
        dist=Distribution2D(func.ravel(), w2, h2),
        to_world=np.asarray(to_world.m, np.float32),
        to_local=np.asarray(to_world.m_inv, np.float32),
        escape_le=escape_le,
    )


def _make_lights(cfg, meshes, world_radius, root_dir):
    """(LightSoA, environments).  An infinite light in `lights` is sampled
    by NEE; one in `infinite_lights` is collected by escaped rays only
    (scene.rs keeps the two lists).  As in the JAX loader, a point,
    distant or diffuse light is an NEE light in either section (the
    `infinite_lights` ones after the `lights` ones), and a light of an
    unknown light_type, or a diffuse light of an unknown shape_type, is
    skipped."""
    rows = []
    infinite: List[EnvLight] = []
    escape_only: List[EnvLight] = []

    def row(kind, emit, p=np.zeros(3), w=np.zeros(3), shape=None, env_id=-1, n_samples=1):
        sk, o2w, radius, tri_p, area = shape or (AREA_SHAPE_NONE, np.eye(4), 1.0,
                                                 np.zeros((3, 3)), 1.0)
        rows.append((kind, p, emit, w, sk, env_id, o2w, np.linalg.inv(o2w), radius, tri_p,
                     area, n_samples))

    for section in ("lights", "infinite_lights"):
        escape = section == "infinite_lights"
        for lcfg in cfg.get(section, []) or []:
            ltype = read_string(lcfg, "light_type", "")
            to_world = make_to_world(lcfg)
            if ltype == "infinite":
                texmap = read_string(lcfg, "mapname", "")
                env = _build_env_map(os.path.join(root_dir, texmap) if texmap else "",
                                     to_world, escape)
                if escape:
                    escape_only.append(env)
                    continue
                infinite.append(env)
                row(LIGHT_INFINITE, make_spectrum(lcfg, "l", 1.0) * make_spectrum(lcfg, "scale", 1.0),
                    env_id=len(infinite) - 1, n_samples=read_i64(lcfg, "n_samples", 1))
            elif ltype == "point":
                # PointLight at the light-to-world image of the origin
                row(LIGHT_POINT, make_spectrum(lcfg, "spectrum", 1.0),
                    p=to_world.apply_point(np.zeros(3)))
            elif ltype == "distant":
                # lights/distant.rs: w = normalize(to_world(from - to))
                d = to_world.apply_vector(fetch_xyz(lcfg, "from", [0.0, 0.0, 0.0])
                                          - fetch_xyz(lcfg, "to", [0.0, 0.0, 1.0]))
                row(LIGHT_DISTANT, make_spectrum(lcfg, "l", 1.0) * make_spectrum(lcfg, "scale", 1.0),
                    w=d / np.linalg.norm(d))
            elif ltype == "diffuse":
                shape = _diffuse_shape(lcfg, meshes)
                if shape is not None:
                    row(LIGHT_DIFFUSE_AREA, make_spectrum(lcfg, "spectrum", 1.0),
                        shape=shape, n_samples=read_i64(lcfg, "n_samples", 1))
    n = len(rows)
    col = lambda i, dtype, shape: np.asarray([r[i] for r in rows], dtype).reshape((n,) + shape)
    lights = LightSoA(
        kind=col(0, np.int32, ()),
        p=col(1, np.float32, (3,)),
        emit=col(2, np.float32, (3,)),
        w_light=col(3, np.float32, (3,)),
        shape_kind=col(4, np.int32, ()),
        shape_index=col(5, np.int32, ()),
        sph_o2w=col(6, np.float32, (4, 4)),
        sph_w2o=col(7, np.float32, (4, 4)),
        sph_radius=col(8, np.float32, ()),
        tri_p=col(9, np.float32, (3, 3)),
        area=col(10, np.float32, ()),
        n_samples=col(11, np.int32, ()),
        world_radius=world_radius,
    )
    return lights, infinite + escape_only


# ---- media (renderprocess.rs:1108-1176) ----

# the reference's fallback coefficients when no preset names a medium
# (renderprocess.rs:1126-1131)
_DEFAULT_SIGMA_A = np.array([0.0011, 0.0024, 0.014])
_DEFAULT_SIGMA_S = np.array([2.55, 3.21, 3.77])


def _parse_medium(mcfg) -> Optional[MediumSpec]:
    """(renderprocess.rs:1135-1176).  GridDensity keeps the reference's
    data-to-medium composition as the JAX loader has it (p0 / p1 into a
    translate * scale, composed un-inverted; scene/gen.py notes that it
    is broken)."""
    if not isinstance(mcfg, dict):
        return None
    mtype = read_string(mcfg, "medium_type", "")
    sigma_a, sigma_s = _DEFAULT_SIGMA_A, _DEFAULT_SIGMA_S
    preset = read_string(mcfg, "preset", "")
    if preset in SUBSURFACE_PARAMETER_TABLE:
        ss, sa = SUBSURFACE_PARAMETER_TABLE[preset]
        sigma_s, sigma_a = np.asarray(ss), np.asarray(sa)
    g = read_f64(mcfg, "g", 0.0)
    to_world = make_to_world(mcfg)
    if mtype == "Homogeneous":
        return MediumSpec("homogeneous", sigma_a, sigma_s, g)
    if mtype == "GridDensity":
        nx = read_i64(mcfg, "nx", 1)
        ny = read_i64(mcfg, "ny", nx)
        nz = read_i64(mcfg, "nz", nx)
        d = np.asarray(mcfg.get("d", []), np.float64)
        p0 = fetch_xyz(mcfg, "p0", [0.0, 0.0, 0.0])
        p1 = fetch_xyz(mcfg, "p1", [1.0, 1.0, 1.0])
        data2medium = Transform.translate(p0) * Transform.scale(
            p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]
        )
        w2m = (to_world.inverse() * data2medium).m
        return MediumSpec("grid", sigma_a, sigma_s, g, nx, ny, nz, d.reshape(nz, ny, nx), w2m)
    return None


# ---- film, camera, sampler and integrator specs (renderprocess.rs:1306-1499) ----


def _make_film_spec(fcfg) -> FilmSpec:
    filter_cfg = fcfg.get("Filter", {}) or {}
    ftype = read_string(filter_cfg, "filter_type", "BoxFilter")
    if ftype in ("TriangleFilter", "GaussianFilter"):
        radius = fetch_vector2(filter_cfg, "radius", [2.0, 2.0])
    else:
        ftype = "BoxFilter"
        radius = fetch_vector2(filter_cfg, "radius", [0.5, 0.5])
    return FilmSpec(
        xres=read_i64(fcfg, "xres", 1280),
        yres=read_i64(fcfg, "yres", 720),
        diagonal_mm=read_f64(fcfg, "diagonal", 35.0),
        scale=read_f64(fcfg, "scale", 1.0),
        max_sample_luminance=read_f64(fcfg, "max_sample_luminance", float("inf")),
        filter_type=ftype,
        filter_radius=radius,
        gaussian_alpha=read_f64(filter_cfg, "alpha", 2.0),
    )


def _make_camera_spec(ccfg) -> CameraSpec:
    world_pos = fetch_xyz(ccfg, "world_pos", [0.0, 0.0, 0.0])
    look = fetch_xyz(ccfg, "look", [1.0, 1.0, 1.0])
    up = fetch_xyz(ccfg, "up", [0.0, 0.0, 1.0])
    to_camera = Transform.look_at(world_pos, look, up)
    return CameraSpec(
        cam_to_world=to_camera.inverse(),
        shutter_open=read_f64(ccfg, "shutter_open", 0.0),
        shutter_close=read_f64(ccfg, "shutter_close", 1.0),
        aperture_diameter=read_f64(ccfg, "aperture_diameter", 1.0),
        focus_distance=read_f64(ccfg, "focus_distance", 10.0),
        simple_weighting=read_bool(ccfg, "simple_weighting", True),
        lens_data=np.asarray(ccfg.get("lens_data", []), np.float64),
    )


def _make_sampler_spec(scfg) -> SamplerSpec:
    kind = read_string(scfg, "sampler_type", "")
    if kind == "HaltonSampler":
        return SamplerSpec(
            kind="halton",
            nsamp=read_i64(scfg, "nsamp", 16),
            sample_at_center=read_bool(scfg, "sample_at_center", False),
        )
    return SamplerSpec(
        kind="stratified",
        jitter=read_bool(scfg, "jitter", True),
        xsamp=read_i64(scfg, "xsamp", 4),
        ysamp=read_i64(scfg, "ysamp", 4),
    )


# integrator_type -> IntegratorSpec.kind; every other name is AO, the
# reference's default (the JAX loader's mapping.get(kind, "ao"))
_INTEGRATORS = {
    "Path": "path", "Debug": "debug", "DirectLighting": "direct", "Volpath": "volpath",
    "SPPM": "sppm",
}


def _make_integrator_spec(icfg) -> IntegratorSpec:
    name = read_string(icfg, "integrator_type", "AO")
    return IntegratorSpec(
        kind=_INTEGRATORS.get(name, "ao"),
        max_depth=read_i64(icfg, "max_depth", 5),
        light_strategy=read_string(icfg, "light_strategy", "one"),
        rr_threshold=read_f64(icfg, "rr_threshold", 1.0),
        cos_sample=read_bool(icfg, "cos_sample", True),
        n_samples=read_i64(icfg, "n_samples", 64),
        radius=read_f64(icfg, "radius", 1.0),
        n_iters=read_i64(icfg, "n_iters", 5),
        photons_per_iter=read_i64(icfg, "photons_per_iter", 1),
        write_freq=read_i64(icfg, "write_freq", 1 << 31),
    )
