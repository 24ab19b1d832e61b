"""Write the in-repo scene fixture: samples/scene.json, samples/scene_debug.json,
samples/scene_fog.json, samples/scene_sppm.json, samples/scene_ao.json,
samples/scene_sphere_area.json, samples/scene_env.json,
samples/scene_furnace.json, samples/scene_halton.json,
samples/scene_smooth.json, samples/scene_disney.json,
samples/scene_materials.json, samples/scene_sss.json,
samples/scene_sss_mixed.json, samples/scene_textured.json, samples/cube.obj,
samples/sphere_smooth.obj and samples/tex_checker.png.

This fixture stands in for the reference renderer's `samples/scene.json`,
which is not part of this repository.  It follows the reference's scene
schema and its documented layout: three instances of a 12-triangle cube
spanning +-1, placed about 35 units down +x in front of a RealisticCamera
at the origin, lit by three coloured point lights, on a 640x360 film with
a 4x4 jittered StratifiedSampler and the Path integrator at max_depth 5.

scene_debug.json is the same geometry, camera, lights, film and sampler
under the reference scene's default integrator, Debug at max_depth 4:
the first cube takes a Debug material (its blue specular lobe runs the
reflect chain), the second smooth glass of eta 1.5 (the reflect and
transmit tree), the third stays metal.

scene_fog.json is scene.json in a thin fog: the Volpath integrator at
max_depth 5 with a homogeneous camera medium of the "Clorox" preset
(sigma_t about 0.006-0.03 per unit, albedo 0.1-0.4), so the ~35-unit
scene is attenuated, not hidden, and the fog itself scatters light.

scene_sppm.json is scene.json under SPPM as the JAX bench's SPPM row sets
it: radius 1.0, 4 iterations of 131,072 photons, max_depth 3.

scene_ao.json is scene.json under the reference's default integrator, AO,
with its defaults written out: 64 cosine-distributed probes per camera
hit.

scene_sphere_area.json is the JAX bench's `sphere_area` row (bench.py:
88-101) on this fixture: two matte spheres (radius 1.2 at (34, 0.8, 0.5),
0.8 at (36, -1.2, -1.5)) among the cubes, and a diffuse sphere light of
radius 0.5 at (33, 3, 1) with radiance (30, 25, 20) beside the three
point lights.

scene_env.json is the bench's `env` row (bench.py:112-120): the point
lights give way to one unit constant environment, listed in `lights`
(sampled by NEE) and in `infinite_lights` (seen by escaped rays).

scene_furnace.json is the white furnace of tests/test_furnace.py:29-58 in
front of this fixture's camera: one unit matte sphere (kd 0.5) at
(35, 0, 0), where the cubes stand, under the same unit environment, no
triangles.  A convex Lambertian body under
constant light L reflects exactly kd * L, so it is an absolute check.

scene_halton.json is the JAX bench's `halton` row (bench.py:144-148,
230-231): scene.json under a HaltonSampler of 256 samples per pixel.

scene_smooth.json is scene.json with two instances of sphere_smooth.obj,
a UV sphere of 32 x 16 segments (960 triangles, unit radius) whose vertex
normals are the vertex directions, so that Path shades it smooth: one
matte of radius 1.2 at (34, 0.8, 0.5), one plastic of radius 0.8 at
(36, -1.2, -1.5), 1,956 triangles in all (under the path kernel's
brute-force limit of 2,048).

scene_disney.json is scene.json with every cube in the JAX package's plain
Disney material (tests/test_megakernel.py:541-549: color (0.8, 0.5, 0.3),
roughness 0.4, metallic 0.3, sheen 0.5, clearcoat 0.6: the five-lobe
stack of diffuse, retro, sheen, Disney microfacet and clearcoat) and a
full sphere of radius 1.2 at (34, 0.8, 0.5) in a second Disney material
(metallic 0.5, anisotropic 0.5, specular_tint 0.5, no sheen or
clearcoat: the three-lobe stack, with ax != ay).  The path kernel takes
it.

scene_materials.json is the same stage in the materials the path kernel
does not take, which Path renders through the wavefront loop: the cubes
in Oren-Nayar matte (sigma 20), a TranslucentMaterial and a MixMaterial
of matte and metal (scale 0.3), and three spheres in rough glass
(u = v = 0.2), a thin Disney material (flatness 0.5, diff_trans 0.6,
spec_trans 0.3) and a Disney material with spec_trans 0.4.

scene_sss.json is the JAX bench's `sss` row (bench.py:47-53, 242; BASELINE
config 5): scene.json with every cube in the subsurface Disney material
mat_sss (color (0.8, 0.6, 0.4), scatter_distance (1.0, 0.8, 0.6),
roughness 0.3: the specular transmission, retro and Disney microfacet
lobes and the Burley BSSRDF), the three point lights, 640x360 at 16 spp.
The path kernel's subsurface branch takes it.

scene_sss_mixed.json puts two of the cubes in mat_sss and the third in
the fixture's matte, and adds scene_sphere_area.json's sphere light:
another material and a sphere light, which the path kernel's subsurface
branch does not take, so Path renders it through the wavefront loop.

scene_textured.json is the JAX bench's `textured` row (bench.py:57-61,
249): scene.json with every cube in mat_textured, a MatteMaterial whose
kd is the ImageTexture `s_01` (defaults: UV mapping, repeat wrap, EWA
filtering, the sRGB curve undone), here on tex_checker.png: a 512x512
RGB image, a checker of 4-texel squares (full and quarter brightness)
over a colour gradient in 16-texel steps (red along x, green down the
rows, blue against red), so that the EWA filter's level choice shows in
the image.  It is written as write_png writes (8-bit RGB, filter 0
rows, zlib level 6).

The scene is synthetic.  In particular its `lens_data` is NOT the
reference's lens prescription: it is the classic 50 mm f/2 double-Gauss
(W. Tronnier, US patent 2,673,491, as tabulated in W. J. Smith, "Modern
Lens Design", p. 312, scaled to 50 mm) typed in by hand.  Rows are
(radius of curvature mm, thickness mm, index of refraction, aperture
diameter mm), scene side first; the row with radius 0 is the stop.

Deterministic: numpy and json only, no random numbers.  Run it from
anywhere; it writes next to itself:

    python samples/make_samples.py
"""

import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# 11 elements: (radius, thickness, eta, aperture diameter), millimetres
DOUBLE_GAUSS_50MM = [
    (29.475, 3.76, 1.67, 25.2),
    (84.83, 0.12, 1.0, 25.2),
    (19.275, 4.025, 1.67, 23.0),
    (40.77, 3.275, 1.699, 23.0),
    (12.75, 5.705, 1.0, 18.0),
    (0.0, 4.5, 0.0, 17.1),
    (-14.495, 1.18, 1.603, 17.0),
    (40.77, 6.065, 1.658, 20.0),
    (-20.385, 0.19, 1.0, 20.0),
    (437.065, 3.22, 1.717, 20.0),
    (-39.73, 5.0, 1.0, 20.0),
]


def cube_obj():
    """12 outward-wound triangles on the cube [-1, 1]^3."""
    v = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
        np.int64,
    )
    # quads as vertex indices (0-based), counter-clockwise seen from outside
    quads = [
        (0, 1, 3, 2),  # x = -1
        (4, 6, 7, 5),  # x = +1
        (0, 4, 5, 1),  # y = -1
        (2, 3, 7, 6),  # y = +1
        (0, 2, 6, 4),  # z = -1
        (1, 5, 7, 3),  # z = +1
    ]
    lines = ["# unit cube spanning -1..1, 8 vertices, 12 triangles"]
    lines += [f"v {a:.1f} {b:.1f} {c:.1f}" for a, b, c in v]
    for a, b, c, d in quads:
        lines.append(f"f {a + 1} {b + 1} {c + 1}")
        lines.append(f"f {a + 1} {c + 1} {d + 1}")
    return "\n".join(lines) + "\n"


def uv_sphere_obj(n_phi=32, n_theta=16):
    """A unit UV sphere, n_phi segments around z and n_theta from pole to
    pole, outward-wound, with one normal per vertex: its direction."""
    verts = [(0.0, 0.0, 1.0)]
    for i in range(1, n_theta):
        theta = np.pi * i / n_theta
        for j in range(n_phi):
            phi = 2.0 * np.pi * j / n_phi
            verts.append((np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)))
    verts.append((0.0, 0.0, -1.0))
    v = np.array([[float(f"{c:.6f}") for c in p] for p in verts])
    ring = lambda i, j: 1 + (i - 1) * n_phi + j % n_phi  # 0-based vertex of ring i
    south = len(verts) - 1
    faces = []
    for j in range(n_phi):
        faces.append((0, ring(1, j), ring(1, j + 1)))
        for i in range(1, n_theta - 1):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j + 1), ring(i + 1, j)
            faces += [(a, d, c), (a, c, b)]
        faces.append((south, ring(n_theta - 1, j + 1), ring(n_theta - 1, j)))
    for f in faces:  # every face wound outward
        p0, p1, p2 = v[list(f)]
        assert np.dot(np.cross(p1 - p0, p2 - p0), p0 + p1 + p2) > 0
    lines = [f"# unit UV sphere, {n_phi} x {n_theta} segments, {len(faces)} triangles, "
             "vertex normals = vertex directions"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
    lines += ["f " + " ".join(f"{k + 1}//{k + 1}" for k in f) for f in faces]
    return "\n".join(lines) + "\n"


def scene():
    def cube(material, pos, angle, axis):
        return {
            "primitive_type": "triangle",
            "obj_name": "cube",
            "material_name": material,
            "instances": [
                {
                    "world_pos": pos,
                    "rotation_axis": axis,
                    "rotation_angle": angle,
                    "scale": [1.0, 1.0, 1.0],
                }
            ],
        }

    def point(pos, rgb):
        return {
            "light_type": "point",
            "world_pos": pos,
            "spectrum": {"values": rgb},
        }

    return {
        "materials": [
            {
                "material_type": "MatteMaterial",
                "material_name": "mat_matte",
                "kd": {"values": [0.6, 0.6, 0.6]},
            },
            {
                "material_type": "PlasticMaterial",
                "material_name": "mat_plastic",
                "kd": {"values": [0.4, 0.3, 0.25]},
                "ks": {"values": [0.35, 0.35, 0.35]},
                "roughness": 0.12,
                "remap_roughness": True,
            },
            {
                # eta / k default to the reference's copper spectra
                "material_type": "MetalMaterial",
                "material_name": "mat_metal",
                "roughness": 0.08,
                "remap_roughness": True,
            },
        ],
        "objs": [{"obj_name": "cube", "filename": "cube.obj"}],
        "lights": [
            point([30.0, -7.0, 7.0], [90.0, 90.0, 90.0]),
            point([31.0, 9.0, 3.0], [110.0, 40.0, 60.0]),
            point([29.0, 1.0, -8.0], [30.0, 80.0, 100.0]),
        ],
        "Aggregate": {
            "primitives": [
                cube("mat_matte", [35.0, -5.5, 2.2], 30.0, [0.3, 0.5, 1.0]),
                cube("mat_plastic", [36.0, 5.5, -0.5], 20.0, [1.0, 0.2, 0.4]),
                cube("mat_metal", [34.5, 0.0, -1.8], 45.0, [0.0, 0.6, 1.0]),
            ]
        },
        "Integrator": {"integrator_type": "Path", "max_depth": 5},
        "Sampler": {
            "sampler_type": "StratifiedSampler",
            "xsamp": 4,
            "ysamp": 4,
            "jitter": True,
        },
        "Film": {"xres": 640, "yres": 360, "diagonal": 35.0},
        "Camera": {
            "world_pos": [0.0, 0.0, 0.0],
            "look": [1.0, 0.0, 0.0],
            "up": [0.0, 0.0, 1.0],
            "lens_data": [x for row in DOUBLE_GAUSS_50MM for x in row],
            "aperture_diameter": 8.0,
            "focus_distance": 35.0,
        },
    }


def scene_debug():
    cfg = scene()
    cfg["materials"] += [
        {"material_type": "Debug", "material_name": "mat_debug"},
        {"material_type": "GlassMaterial", "material_name": "mat_glass", "eta": 1.5},
    ]
    prims = cfg["Aggregate"]["primitives"]
    prims[0]["material_name"] = "mat_debug"
    prims[1]["material_name"] = "mat_glass"
    cfg["Integrator"] = {"integrator_type": "Debug", "max_depth": 4}
    return cfg


def scene_fog():
    cfg = scene()
    cfg["Integrator"] = {"integrator_type": "Volpath", "max_depth": 5}
    cfg["Camera"]["medium"] = {"medium_type": "Homogeneous", "g": 0.0, "preset": "Clorox"}
    return cfg


def scene_sppm():
    """The JAX bench's SPPM row (bench.py:233-235): radius 1.0, 4
    iterations of 2^17 photons, max_depth 3.  The render builds its own
    Halton sampler (n_iters samples at the pixel centres); the Sampler
    block states it."""
    cfg = scene()
    cfg["Integrator"] = {
        "integrator_type": "SPPM",
        "max_depth": 3,
        "radius": 1.0,
        "n_iters": 4,
        "photons_per_iter": 1 << 17,
    }
    cfg["Sampler"] = {"sampler_type": "HaltonSampler", "nsamp": 4, "sample_at_center": True}
    return cfg


def scene_ao():
    cfg = scene()
    cfg["Integrator"] = {"integrator_type": "AO", "n_samples": 64, "cos_sample": True}
    return cfg


UNIT_ENV = {"light_type": "infinite", "l": {"values": [1.0, 1.0, 1.0]}}


def scene_sphere_area():
    cfg = scene()
    cfg["Aggregate"]["primitives"] += [
        {"primitive_type": "sphere", "material_name": "mat_matte", "radius": 1.2,
         "world_pos": [34.0, 0.8, 0.5]},
        {"primitive_type": "sphere", "material_name": "mat_matte", "radius": 0.8,
         "world_pos": [36.0, -1.2, -1.5]},
    ]
    cfg["lights"].append({
        "light_type": "diffuse",
        "spectrum": {"values": [30.0, 25.0, 20.0]},
        "light_shape": {"shape_type": "sphere", "radius": 0.5, "world_pos": [33.0, 3.0, 1.0]},
    })
    return cfg


def scene_env():
    cfg = scene()
    cfg["lights"] = [dict(UNIT_ENV)]
    cfg["infinite_lights"] = [dict(UNIT_ENV)]
    return cfg


def scene_furnace():
    cfg = scene()
    cfg["materials"] = [{"material_type": "MatteMaterial", "material_name": "mat_m"}]
    cfg["objs"] = []
    cfg["lights"] = [dict(UNIT_ENV)]
    cfg["infinite_lights"] = [dict(UNIT_ENV)]
    cfg["Aggregate"] = {
        "primitives": [{"primitive_type": "sphere", "material_name": "mat_m", "radius": 1.0,
                        "world_pos": [35.0, 0.0, 0.0]}]
    }
    return cfg


def scene_halton():
    cfg = scene()
    cfg["Sampler"] = {"sampler_type": "HaltonSampler", "nsamp": 256}
    return cfg


def scene_smooth():
    cfg = scene()
    cfg["objs"].append({"obj_name": "sphere", "filename": "sphere_smooth.obj"})
    for material, radius, pos in (("mat_matte", 1.2, [34.0, 0.8, 0.5]),
                                  ("mat_plastic", 0.8, [36.0, -1.2, -1.5])):
        cfg["Aggregate"]["primitives"].append({
            "primitive_type": "triangle",
            "obj_name": "sphere",
            "material_name": material,
            "instances": [{"world_pos": pos, "scale": [radius] * 3}],
        })
    return cfg


DISNEY_PLAIN = {
    "material_type": "DisneyMaterial",
    "material_name": "mat_disney",
    "color": {"values": [0.8, 0.5, 0.3]},
    "roughness": 0.4,
    "metallic": 0.3,
    "sheen": 0.5,
    "clearcoat": 0.6,
}


def _sphere(material, radius, pos):
    return {"primitive_type": "sphere", "material_name": material, "radius": radius,
            "world_pos": pos}


def scene_disney():
    cfg = scene()
    cfg["materials"] += [
        DISNEY_PLAIN,
        {"material_type": "DisneyMaterial", "material_name": "mat_disney_aniso",
         "color": {"values": [0.3, 0.6, 0.8]}, "roughness": 0.3, "metallic": 0.5,
         "anisotropic": 0.5, "specular_tint": 0.5},
    ]
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_disney"
    cfg["Aggregate"]["primitives"].append(_sphere("mat_disney_aniso", 1.2, [34.0, 0.8, 0.5]))
    return cfg


def scene_materials():
    cfg = scene()
    cfg["materials"] += [
        {"material_type": "MatteMaterial", "material_name": "mat_oren_nayar",
         "kd": {"values": [0.7, 0.6, 0.5]}, "sigma": 20.0},
        {"material_type": "GlassMaterial", "material_name": "mat_rough_glass",
         "u_roughness": 0.2, "v_roughness": 0.2, "eta": 1.5},
        {"material_type": "TranslucentMaterial", "material_name": "mat_translucent",
         "kd": {"values": [0.5, 0.6, 0.4]}, "ks": {"values": [0.3, 0.3, 0.3]},
         "roughness": 0.2, "reflect": {"values": [0.6, 0.6, 0.6]},
         "transmit": {"values": [0.4, 0.4, 0.4]}},
        {"material_type": "MixMaterial", "material_name": "mat_mix", "mat1": "mat_matte",
         "mat2": "mat_metal", "scale": {"values": [0.3, 0.3, 0.3]}},
        {"material_type": "DisneyMaterial", "material_name": "mat_disney_thin", "thin": True,
         "color": {"values": [0.8, 0.5, 0.3]}, "roughness": 0.4, "flatness": 0.5,
         "diff_trans": 0.6, "spec_trans": 0.3},
        {"material_type": "DisneyMaterial", "material_name": "mat_disney_trans",
         "color": {"values": [0.6, 0.8, 0.7]}, "roughness": 0.3, "spec_trans": 0.4},
    ]
    prims = cfg["Aggregate"]["primitives"]
    for prim, material in zip(prims, ("mat_oren_nayar", "mat_translucent", "mat_mix")):
        prim["material_name"] = material
    prims += [
        _sphere("mat_rough_glass", 1.2, [34.0, 0.8, 0.5]),
        _sphere("mat_disney_thin", 0.8, [36.0, -1.2, -1.5]),
        _sphere("mat_disney_trans", 0.9, [33.0, -2.8, 1.6]),
    ]
    return cfg


MAT_SSS = {
    "material_type": "DisneyMaterial",
    "material_name": "mat_sss",
    "color": {"values": [0.8, 0.6, 0.4]},
    "scatter_distance": {"values": [1.0, 0.8, 0.6]},
    "roughness": 0.3,
}


def scene_sss():
    cfg = scene()
    cfg["materials"].append(MAT_SSS)
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_sss"
    return cfg


MAT_TEXTURED = {
    "material_type": "MatteMaterial",
    "material_name": "mat_textured",
    "kd": "s_01",
}
TEX_SIZE = 512


def tex_checker_png():
    """The bytes of tex_checker.png (see the module docstring)."""
    y, x = np.mgrid[0:TEX_SIZE, 0:TEX_SIZE]
    step = lambda a: (a // 16) / (TEX_SIZE // 16 - 1)
    rgb = np.stack([step(x), step(y), 1.0 - step(x)], axis=-1)
    bright = np.where(((x // 4) + (y // 4)) % 2 == 0, 1.0, 0.25)
    q = np.clip(255.0 * rgb * bright[..., None] + 0.5, 0.0, 255.0).astype(np.uint8)
    raw = b"".join(b"\x00" + q[r].tobytes() for r in range(TEX_SIZE))

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", TEX_SIZE, TEX_SIZE, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def scene_textured():
    cfg = scene()
    cfg["rgb_texture"] = [{"texture_type": "ImageTexture", "texture_name": "s_01",
                           "filename": "tex_checker.png"}]
    cfg["materials"].append(MAT_TEXTURED)
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_textured"
    return cfg


def scene_sss_mixed():
    cfg = scene_sss()
    cfg["Aggregate"]["primitives"][2]["material_name"] = "mat_matte"
    cfg["lights"].append(scene_sphere_area()["lights"][-1])
    return cfg


def main(out_dir=HERE):
    with open(os.path.join(out_dir, "cube.obj"), "w") as fh:
        fh.write(cube_obj())
    with open(os.path.join(out_dir, "sphere_smooth.obj"), "w") as fh:
        fh.write(uv_sphere_obj())
    with open(os.path.join(out_dir, "tex_checker.png"), "wb") as fh:
        fh.write(tex_checker_png())
    for name, cfg in (
        ("scene.json", scene()),
        ("scene_debug.json", scene_debug()),
        ("scene_fog.json", scene_fog()),
        ("scene_sppm.json", scene_sppm()),
        ("scene_ao.json", scene_ao()),
        ("scene_sphere_area.json", scene_sphere_area()),
        ("scene_env.json", scene_env()),
        ("scene_furnace.json", scene_furnace()),
        ("scene_halton.json", scene_halton()),
        ("scene_smooth.json", scene_smooth()),
        ("scene_disney.json", scene_disney()),
        ("scene_materials.json", scene_materials()),
        ("scene_sss.json", scene_sss()),
        ("scene_sss_mixed.json", scene_sss_mixed()),
        ("scene_textured.json", scene_textured()),
    ):
        with open(os.path.join(out_dir, name), "w") as fh:
            json.dump(cfg, fh, indent=1)
            fh.write("\n")


if __name__ == "__main__":
    main()
