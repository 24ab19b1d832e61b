"""Procedural scenes (rs_ray_toy_tpu/scene/gen.py and the JAX bench's scene edits).

`write_grid_scene` tiles the fixture's cube mesh into an ny x nz instance
grid about 35 units in front of the camera, through the schema's
`instances` path (renderprocess.rs:1214-1282): the first primitive of the
base scene takes the grid, the others stay.  ny = nz = 40 gives 1,600
cubes, 19,200 triangles of grid: the JAX bench's `grid` row (under SPPM,
the mesh scene of the SPPM kernels' BVH instances).

`write_fog_scene` puts a base scene in a homogeneous camera medium under
Volpath, optionally with the sphere light of the JAX bench's `fog_area`
row (bench.py:103-111, 138-143); `write_grid_fog_scene` gives the fixture
an n^3 GridDensity camera medium, the bench's `grid_fog` row.
`write_interface_scene` makes the fog fixture's first cube smooth glass
holding a homogeneous medium through a per-primitive medium_interface,
which only the wavefront Volpath loop renders.
`write_wavefront_scene` gives a base scene what only the wavefront Path
loop renders: a partial sphere, a distant light and a triangle-area light.
`write_deep_bvh_scene` writes a mesh whose BVH is deeper than the
kernels' 64-entry traversal stack.  `write_smooth_grid_scene` puts a grid
of n smooth-shaded UV spheres (samples/sphere_smooth.obj, 960 triangles
each) behind the fixture's
cubes: n = 20 (19,236 triangles) renders Path through the path kernel's
BVH instances, n = 80 (76,836) past its 65,536 triangles through the
wavefront loop and the shaded BVH kernel's smooth instance.
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np

SAMPLES = Path(__file__).resolve().parents[2] / "samples"
FIXTURE = str(SAMPLES / "scene.json")
TEXTURED = str(SAMPLES / "scene_textured.json")
TEX_IMAGE = "tex_checker.png"  # the textured fixture's image
SMOOTH_SPHERE = "sphere_smooth.obj"  # a 960-triangle UV sphere with vertex normals
SPAN_Y, SPAN_Z = 6.0, 4.0  # extent of the grid, world units
# the JAX bench's fog rows: the reference's default coefficients (sigma_t
# about 2.6-3.8 per unit, a wall of fog over the 35-unit scene)
BENCH_FOG = {"medium_type": "Homogeneous", "g": 0.0}
# samples/scene_fog.json's thin fog
THIN_FOG = {"medium_type": "Homogeneous", "g": 0.0, "preset": "Clorox"}
# the bench's fog_area light
FOG_AREA_LIGHT = {
    "light_type": "diffuse",
    "spectrum": {"values": [60.0, 50.0, 40.0]},
    "light_shape": {"shape_type": "sphere", "radius": 0.6, "world_pos": [33.0, 3.0, 1.0]},
}


def _write(cfg, base, out_dir, name):
    """cfg as out_dir/name, with the base scene's cube.obj (and the fixture's
    smooth sphere and texture image, when cfg names them) beside it."""
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(os.path.dirname(base), "cube.obj")
    if os.path.exists(src):
        shutil.copy(src, out_dir)
    if any(o.get("filename") == SMOOTH_SPHERE for o in cfg.get("objs", [])):
        shutil.copy(SAMPLES / SMOOTH_SPHERE, out_dir)
    if any(t.get("filename") == TEX_IMAGE for t in cfg.get("rgb_texture", [])):
        shutil.copy(SAMPLES / TEX_IMAGE, out_dir)
    path = os.path.join(out_dir, name)
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


def _load(base, xres, yres):
    with open(base) as fh:
        cfg = json.load(fh)
    if xres:
        cfg["Film"]["xres"] = xres
    if yres:
        cfg["Film"]["yres"] = yres
    return cfg


def write_variant(base, out_dir, xres=None, yres=None, sampler=None):
    """Write the scene `base` under out_dir (its meshes beside it) at
    xres x yres and, given `sampler`, with that Sampler block instead of
    its own.  Returns the json path."""
    cfg = _load(base, xres, yres)
    if sampler:
        cfg["Sampler"] = sampler
    return _write(cfg, base, out_dir, os.path.basename(base))


def write_grid_scene(
    out_dir,
    ny=40,
    nz=40,
    base=FIXTURE,
    integrator="Path",
    max_depth=5,
    xres=None,
    yres=None,
    textured=False,
):
    """Write grid.json (+ cube.obj) under out_dir; returns the json path.
    ny*nz cube instances -> 12*ny*nz triangles of grid.  The base's
    Integrator block is kept when it names `integrator` (an SPPM base
    keeps its radius and photon counts).  With `textured` every cube is
    in samples/scene_textured.json's mat_textured (kd from
    tex_checker.png, copied beside it)."""
    cfg = _load(base, xres, yres)
    if textured:
        textured_cfg = _load(TEXTURED, None, None)
        cfg["rgb_texture"] = textured_cfg["rgb_texture"]
        cfg["materials"] = textured_cfg["materials"]
        for prim in cfg["Aggregate"]["primitives"]:
            prim["material_name"] = "mat_textured"
    old = cfg.get("Integrator") or {}
    keep = old if old.get("integrator_type") == integrator else {}
    cfg["Integrator"] = {**keep, "integrator_type": integrator, "max_depth": max_depth}
    prim = cfg["Aggregate"]["primitives"][0]
    # cube.obj spans +-1: scale so neighbours don't touch
    sy = SPAN_Y / ny
    sz = SPAN_Z / nz
    s = 0.4 * min(sy, sz)
    prim["instances"] = [
        {
            "world_pos": [35.2, -SPAN_Y / 2 + (j + 0.5) * sy, -SPAN_Z / 2 + (k + 0.5) * sz],
            "scale": [s, s, s],
            "rotation_axis": [0.0, 0.0, 1.0],
            "rotation_angle": (7 * j + 13 * k) % 90,
        }
        for j in range(ny)
        for k in range(nz)
    ]
    return _write(cfg, base, out_dir, "grid.json")


def write_fog_scene(out_dir, area_light=False, base=FIXTURE, medium=BENCH_FOG, xres=None,
                    yres=None):
    """Write fog.json, or fog_area.json with the bench's sphere light added
    to the base's lights, under out_dir: the base scene under Volpath (its
    other integrator settings kept) in the camera medium `medium`.
    Returns the json path."""
    cfg = _load(base, xres, yres)
    cfg["Integrator"] = {**(cfg.get("Integrator") or {}), "integrator_type": "Volpath"}
    cfg.setdefault("Camera", {})["medium"] = dict(medium)
    if area_light:
        cfg["lights"] = list(cfg.get("lights") or []) + [FOG_AREA_LIGHT]
    return _write(cfg, base, out_dir, "fog_area.json" if area_light else "fog.json")


# a cube's interior medium: sigma_t 0.67-0.71 per unit, albedo 0.82-1, so a
# ray crossing the 2-unit cube scatters about once
INTERFACE_MEDIUM = {"medium_type": "Homogeneous", "g": 0.0, "preset": "Potato"}


def write_interface_scene(out_dir, base=str(SAMPLES / "scene_fog.json"), area_light=False,
                          xres=None, yres=None):
    """Write interface.json under out_dir: the base scene (the fog
    fixture: Volpath in its thin camera fog) with its first primitive, the
    left cube, smooth glass of eta 1.5 whose medium_interface holds
    INTERFACE_MEDIUM inside and none outside, and with `area_light` the
    bench's fog_area sphere light among the cubes.  Its media: the cube's
    (id 0), then the camera's.  Returns the json path."""
    cfg = _load(base, xres, yres)
    cfg["Integrator"] = {**(cfg.get("Integrator") or {}), "integrator_type": "Volpath"}
    cfg["materials"] = list(cfg["materials"]) + [
        {"material_type": "GlassMaterial", "material_name": "mat_glass_medium", "eta": 1.5}]
    prim = cfg["Aggregate"]["primitives"][0]
    prim["material_name"] = "mat_glass_medium"
    prim["medium_interface"] = {"inside": dict(INTERFACE_MEDIUM)}
    if area_light:
        cfg["lights"] = list(cfg.get("lights") or []) + [FOG_AREA_LIGHT]
    return _write(cfg, base, out_dir, "interface.json")


def write_grid_fog_scene(
    out_dir, n=16, base=FIXTURE, max_depth=5, xres=None, yres=None, sigma_scale=1.0
):
    """Write grid_fog.json under out_dir: the base scene under Volpath in
    an n^3 GridDensity camera medium, a smooth gaussian plume of peak
    sigma_scale over the view volume x in [25, 45] (the JAX package's
    write_grid_fog_scene).  The unit density box is placed by world_pos
    and scale alone: the schema's p0 / p1 data-to-medium composition is
    broken in the reference, so portable scenes omit it.  Returns the
    json path."""
    cfg = _load(base, xres, yres)
    cfg["Integrator"] = {"integrator_type": "Volpath", "max_depth": max_depth}
    zi, yi, xi = [(np.arange(n) + 0.5) / n - 0.5 for _ in range(3)]
    r2 = xi[None, None, :] ** 2 + yi[None, :, None] ** 2 + zi[:, None, None] ** 2
    d = sigma_scale * np.exp(-r2 / 0.09)
    cfg.setdefault("Camera", {})["medium"] = {
        "medium_type": "GridDensity",
        "g": 0.0,
        "nx": n, "ny": n, "nz": n,
        "d": [round(float(v), 5) for v in d.ravel()],
        "world_pos": [25.0, -8.0, -6.0],
        "scale": [20.0, 16.0, 12.0],
    }
    return _write(cfg, base, out_dir, "grid_fog.json")


def write_wavefront_scene(out_dir, base=FIXTURE, xres=None, yres=None, matte=False):
    """Write wavefront.json under out_dir: the base scene with a sphere of
    radius 1.2 at (34, 0.8, 0.5) clipped at z_max 0.3 and phi_max 270
    degrees, a distant light of radiance 1.5 from above the camera, and a
    diffuse light of radiance 20 on one triangle of a cube mesh `lamp`
    centred at (33, 0, 6), its downward face (triangle 8 of cube.obj, the
    z = -1 face).  The path kernel takes none of the three: Path renders
    it through the wavefront loop.  `matte` gives every cube the matte
    material."""
    cfg = _load(base, xres, yres)
    cfg["objs"].append({"obj_name": "lamp", "filename": "cube.obj", "world_pos": [33.0, 0.0, 6.0]})
    prims = cfg["Aggregate"]["primitives"]
    if matte:
        for prim in prims:
            prim["material_name"] = "mat_matte"
    prims.append({"primitive_type": "sphere", "material_name": "mat_matte", "radius": 1.2,
                  "world_pos": [34.0, 0.8, 0.5], "z_max": 0.3, "phi_max": 270.0})
    cfg["lights"] += [
        {"light_type": "distant", "l": {"values": [1.5, 1.5, 1.5]}, "from": [0.0, 0.0, 0.0],
         "to": [1.0, 0.3, -0.6]},
        {"light_type": "diffuse", "spectrum": {"values": [20.0, 20.0, 20.0]},
         "light_shape": {"shape_type": "triangle", "obj_name": "lamp", "tri_num": 8}},
    ]
    return _write(cfg, base, out_dir, "wavefront.json")


def write_smooth_grid_scene(out_dir, n=20, xres=None, yres=None):
    """Write smooth_grid.json (+ cube.obj, sphere_smooth.obj) under out_dir:
    the fixture under Path with max_depth 5 and n instances of the smooth
    UV sphere on a grid of columns x rows (about 3 : 2) in the plane
    x = 38 behind the cubes, spanning y in [-8, 8] and z in [-5, 5],
    radius 0.45 of the cell, alternately matte and plastic.  960 n
    triangles of spheres.  Returns the json path."""
    cfg = _load(FIXTURE, xres, yres)
    cfg["Integrator"] = {"integrator_type": "Path", "max_depth": 5}
    cfg["objs"].append({"obj_name": "sphere", "filename": SMOOTH_SPHERE})
    cols = int(np.ceil(np.sqrt(1.5 * n)))
    rows = int(np.ceil(n / cols))
    sy, sz = 16.0 / cols, 10.0 / rows
    r = 0.45 * min(sy, sz)
    cells = [(-8.0 + (k % cols + 0.5) * sy, -5.0 + (k // cols + 0.5) * sz) for k in range(n)]
    for parity, material in ((0, "mat_matte"), (1, "mat_plastic")):
        insts = [{"world_pos": [38.0, y, z], "scale": [r, r, r]}
                 for k, (y, z) in enumerate(cells) if k % 2 == parity]
        if insts:
            cfg["Aggregate"]["primitives"].append({
                "primitive_type": "triangle", "obj_name": "sphere", "material_name": material,
                "instances": insts,
            })
    return _write(cfg, FIXTURE, out_dir, "smooth_grid.json")


def write_deep_bvh_scene(out_dir, integrator="AO", n_bulk=200, reach=30, seed=0, xres=None,
                         yres=None):
    """Write deep.json (+ deep.obj) under out_dir: the fixture's camera and
    lights over one mesh whose SAH BVH is deep.  n_bulk small triangles
    (0.2 units, facing the camera) at seeded points in a 2-unit cube around (35, 0, 0), and
    `reach` lone triangles along each of the six axis directions from it at
    13, 13^2, ..., 13^reach units: each is more than 12 times as far out as
    the next, so a split of the 12-bucket SAH builder peels one of them off
    at a time, and the tree is deep (reach 30: 97 levels over 380
    triangles).  Returns the json path."""
    rng = np.random.default_rng(seed)
    centre = np.array([35.0, 0.0, 0.0])
    pts = [centre + rng.uniform(-1.0, 1.0, (n_bulk, 3))]
    for axis in range(3):
        for sign in (1.0, -1.0):
            far = np.zeros((reach, 3))
            far[:, axis] = sign * 13.0 ** np.arange(1, reach + 1)
            pts.append(centre + far)
    p0 = np.concatenate(pts)
    # facing the camera, which looks down +x
    verts = np.concatenate([p0, p0 + [0.0, 0.2, 0.0], p0 + [0.05, 0.0, 0.2]])
    n = p0.shape[0]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "deep.obj"), "w") as fh:
        fh.writelines(f"v {float(x)!r} {float(y)!r} {float(z)!r}\n" for x, y, z in verts)
        fh.writelines(f"f {k + 1} {n + k + 1} {2 * n + k + 1}\n" for k in range(n))
    cfg = _load(FIXTURE, xres, yres)
    cfg["Integrator"] = {"integrator_type": integrator, "max_depth": 5}
    cfg["objs"] = [{"obj_name": "deep", "filename": "deep.obj"}]
    cfg["Aggregate"]["primitives"] = [
        {"primitive_type": "triangle", "obj_name": "deep", "material_name": "mat_matte"}]
    return _write(cfg, FIXTURE, out_dir, "deep.json")
