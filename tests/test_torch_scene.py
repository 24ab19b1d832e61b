"""Scene loading and packing: the port's tables equal the JAX package's.

Both packages load the in-repo fixtures (samples/scene.json,
samples/scene_debug.json, samples/scene_fog.json,
samples/scene_sppm.json, samples/scene_ao.json and the sphere, environment
and furnace fixtures, written by samples/make_samples.py) and pack
them for the camera kernels; the packed triangle table, the point lights
and the camera bundle must agree.
Features outside the ported slice must raise, at load or when the render
picks its kernel, never render silently.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators.common import SceneCtx
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.bsdf.lobes import (
    LOBE_DEBUG_DIFFUSE,
    LOBE_DEBUG_SPECULAR,
    LOBE_FRESNEL_SPEC,
    LOBE_MF_REFL,
    LOBE_SPEC_REFL,
    LOBE_SPEC_TRANS,
)
from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.render import WAVEFRONT, make_sampler, select_kernel
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import FOG_AREA_LIGHT, THIN_FOG
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
EXTRA_MATERIALS = [
    {"material_type": "MirrorMaterial", "material_name": "mat_mirror"},
    {"material_type": "GlassMaterial", "material_name": "mat_glass", "eta": 1.5},
]
PUPIL_SAMPLES = 1 << 12


def write_scene(tmp_path, edit=None):
    cfg = json.loads((SAMPLES / "scene.json").read_text())
    cfg["materials"].extend(EXTRA_MATERIALS)
    if edit is not None:
        edit(cfg)
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_fixture_is_what_make_samples_writes(tmp_path):
    """samples/ holds exactly the generator's output."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_samples", SAMPLES / "make_samples.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(str(tmp_path))
    for name in ("scene.json", "scene_debug.json", "scene_fog.json", "scene_sppm.json",
                 "scene_ao.json", "scene_sphere_area.json", "scene_env.json",
                 "scene_furnace.json", "scene_textured.json", "tex_checker.png", "cube.obj"):
        assert (tmp_path / name).read_bytes() == (SAMPLES / name).read_bytes()


@pytest.mark.parametrize("primary", ["mat_metal", "mat_matte", "mat_plastic", "mat_mirror", "mat_glass"])
def test_pack_scene_table_and_lights_equal(tmp_path, primary):
    def edit(cfg):
        cfg["Aggregate"]["primitives"][2]["material_name"] = primary

    path = write_scene(tmp_path, edit)
    jjob = jax_load_scene(path)
    ctx = SceneCtx(jjob.scene)
    assert jpmk.supports(ctx, jjob.integrator, JaxStratified(jjob.sampler), None)
    jtable, _, _, _, _, wide, _, _ = jpmk.pack_scene(ctx)

    job = load_scene(path)
    assert pmk.supports(job.scene, job.integrator, StratifiedSampler(job.sampler))
    packed = pmk.pack_scene(job.scene, "cpu")
    # identical float32 arithmetic on both sides: exact equality
    assert packed.table.shape == (36, pmk.TABLE_COLS)
    assert np.array_equal(packed.table.numpy(), np.asarray(jtable))
    assert packed.light_p == tuple(l.p for l in wide.lights)
    assert packed.light_emit == tuple(l.emit for l in wide.lights)


def test_pack_camera_equal(tmp_path):
    path = write_scene(tmp_path)
    jjob = jax_load_scene(path)
    jcam = jpmk.pack_camera(JaxCamera(jjob.camera, jjob.film, pupil_samples=PUPIL_SAMPLES))
    job = load_scene(path)
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, pupil_samples=PUPIL_SAMPLES))
    assert cam.keys() == jcam.keys()
    for key in cam:
        if key in ("bounds", "area0"):
            continue
        assert cam[key] == jcam[key], key
    # The exit-pupil bounds are traced in float64 here and in float32 by
    # the JAX package, so the rear-plane sample coordinates that bound
    # each bin differ in float32 rounding (~1e-9 m); 1e-6 m is far below
    # the bound's own sample-spacing margin (~3e-5 m at 2^12 samples).
    np.testing.assert_allclose(np.asarray(cam["bounds"]), np.asarray(jcam["bounds"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(cam["area0"], jcam["area0"], rtol=1e-4)


def _set(section, value):
    def edit(cfg):
        cfg[section] = value

    return edit


def _prim0(**kw):
    def edit(cfg):
        cfg["Aggregate"]["primitives"][0].update(kw)

    return edit


def _volpath(medium=THIN_FOG, light=None, integrator="Volpath", max_depth=3, **prim0):
    """The fixture under `integrator` in the camera medium `medium`, with an
    extra light and primitive-0 keys."""

    def edit(cfg):
        cfg["Integrator"] = {"integrator_type": integrator, "max_depth": max_depth}
        if medium is not None:
            cfg["Camera"]["medium"] = medium
        if light is not None:
            cfg["lights"].append(light)
        cfg["Aggregate"]["primitives"][0].update(prim0)

    return edit


GRID_MEDIUM = {"medium_type": "GridDensity", "nx": 2, "ny": 2, "nz": 2, "d": [0.5] * 8,
               "world_pos": [25.0, -8.0, -6.0], "scale": [20.0, 16.0, 12.0]}
def _sphere_under(integrator):
    """A sphere primitive beside the cubes under `integrator`."""

    def edit(cfg):
        cfg["Integrator"] = {"integrator_type": integrator, "max_depth": 3}
        cfg["Aggregate"]["primitives"].append(
            {"primitive_type": "sphere", "material_name": "mat_matte", "radius": 1.0,
             "world_pos": [34.0, 0.0, 0.0]})

    return edit


def _halton_under(integrator):
    """The fixture under a HaltonSampler and `integrator` (Path, AO, Debug,
    DirectLighting and SPPM render with it; Volpath raises)."""

    def edit(cfg):
        cfg["Integrator"] = {"integrator_type": integrator, "max_depth": 3}
        cfg["Sampler"] = {"sampler_type": "HaltonSampler"}

    return edit


def _texture(**keys):
    """An ImageTexture on samples/tex_checker.png with `keys` (unused by
    any material)."""
    return _set("rgb_texture", [{"texture_type": "ImageTexture", "texture_name": "checker",
                                 "filename": str(SAMPLES / "tex_checker.png"), **keys}])


def _textured(base_edit):
    """`base_edit`, then every cube's kd the checker texture."""

    def edit(cfg):
        base_edit(cfg)
        _texture()(cfg)
        cfg["materials"].append({"material_type": "MatteMaterial", "material_name": "t",
                                 "kd": "checker"})
        for prim in cfg["Aggregate"]["primitives"]:
            prim["material_name"] = "t"

    return edit


def _sppm_area_light(cfg):
    cfg["Integrator"] = {"integrator_type": "SPPM", "max_depth": 3, "n_iters": 1}
    cfg["lights"].append(FOG_AREA_LIGHT)


def _bssrdf_under(integrator):
    """Every cube in a Disney material with a BSSRDF under `integrator`."""

    def edit(cfg):
        cfg["materials"].append({"material_type": "DisneyMaterial", "material_name": "d",
                                 "scatter_distance": {"values": [0.5, 0.3, 0.2]}})
        for prim in cfg["Aggregate"]["primitives"]:
            prim["material_name"] = "d"
        cfg["Integrator"] = {"integrator_type": integrator, "max_depth": 3}

    return edit


UNSUPPORTED = {
    "textures": _set("rgb_texture", [{"texture_type": "UVTexture", "texture_name": "uv"}]),
    # any existing file as the map: image maps are not ported
    "image-map environment lights": _set(
        "infinite_lights", [{"light_type": "infinite", "mapname": "cube.obj"}]),
    # Debug and DirectLighting take spheres in the wavefront loop
    "sphere primitives": _sphere_under("SPPM"),
    # a diffuse light needs a sphere light_shape, and only Volpath renders it
    "diffuse lights": _set("lights", [{"light_type": "diffuse"}]),
    "lights other than up to 8 point lights": _sppm_area_light,
    # the Volpath kernel refuses the scene first for its media, and its
    # wavefront loop evaluates no texture
    "without a camera medium; and the wavefront loop's: textured kd":
        _textured(_volpath(medium=None)),
    "media interfaces \\(medium_interface\\); and the wavefront loop's: textured kd":
        _textured(_volpath(medium_interface={"inside": {"medium_type": "Homogeneous"}})),
    # past the Volpath kernel's depths and below the wavefront loop's
    "max_depth -1": _volpath(max_depth=-1),
    "cylindrical texture mapping": _texture(mapping={"mapping": "cylindrical"}),
    "diffuse lights on an unknown mesh": _set("lights", [
        {"light_type": "diffuse", "light_shape": {"shape_type": "triangle", "obj_name": "nope"}}]),
    # a Disney material with a BSSRDF (non-zero scatter_distance, not thin)
    # under SPPM, whose kernels have no subsurface branch
    "material type DisneyMaterial": _bssrdf_under("SPPM"),
}


@pytest.mark.parametrize("feature", sorted(UNSUPPORTED))
def test_unsupported_features_raise(tmp_path, feature):
    """At load, or where render_job picks the kernel (select_kernel)."""
    path = write_scene(tmp_path, UNSUPPORTED[feature])
    with pytest.raises(NotImplementedError, match=feature):
        job = load_scene(path)
        select_kernel(job, make_sampler(job))


ENV = {"light_type": "infinite", "l": {"values": [1.0, 1.0, 1.0]}}
DISTANT = {"light_type": "distant", "l": {"values": [1.0, 1.0, 1.0]}, "to": [1.0, 0.0, 0.0]}
TRIANGLE_LIGHT = {"light_type": "diffuse", "spectrum": {"values": [5.0, 5.0, 5.0]},
                  "light_shape": {"shape_type": "triangle", "obj_name": "cube", "tri_num": 3}}


@pytest.mark.parametrize("integrator,edit,feature", [
    ("DirectLighting", "sphere", "sphere primitives"),
    ("Volpath", "sphere", "sphere primitives"),
    ("SPPM", "sphere", "sphere primitives"),
    ("Volpath", TRIANGLE_LIGHT, "lights other than up to 8 point and sphere lights"),
    ("Debug", DISTANT, "lights other than up to 8 point lights"),
    ("DirectLighting", ENV, "infinite lights"),
    ("SPPM", ENV, "infinite lights"),
], ids=lambda v: v if isinstance(v, str) else v["light_type"])
def test_other_kernels_raise_on_what_only_path_takes(tmp_path, capsys, integrator, edit, feature):
    """The Debug / DirectLighting, Volpath and SPPM kernels keep their
    subsets: spheres, and lights outside each, raise naming the feature;
    Debug, DirectLighting and Volpath name it announcing the wavefront
    loop, which takes them."""

    def apply(cfg):
        block = {"integrator_type": integrator, "max_depth": 3}
        if integrator == "Volpath":
            cfg["Camera"]["medium"] = THIN_FOG
        cfg["Integrator"] = block
        if edit == "sphere":
            _sphere_under(integrator)(cfg)
            cfg["Integrator"] = block
        else:
            cfg["lights"].append(edit)

    path = write_scene(tmp_path, apply)
    job = load_scene(path)
    if integrator in ("Debug", "DirectLighting", "Volpath"):
        assert select_kernel(job, make_sampler(job)) == WAVEFRONT
        err = capsys.readouterr().err
        kernel = "volpath" if integrator == "Volpath" else "direct"
        assert feature in err and f"{kernel}-kernel subset" in err and "wavefront loop" in err
        return
    with pytest.raises(NotImplementedError, match=feature):
        select_kernel(job, make_sampler(job))


# what the Volpath kernel or the AO loop refused before the wavefront
# Volpath loop and the stratified grids of any size: (edit, the refusal
# announced on stderr, or None for AO, which announces nothing)
WAVEFRONT_TAKES = {
    "medium_interface": (_volpath(medium_interface={"inside": {"medium_type": "Homogeneous"}}),
                         "medium_interface"),
    "grid-media-area-light": (_volpath(GRID_MEDIUM, FOG_AREA_LIGHT),
                              "grid media with lights other than point lights"),
    "volpath-halton": (lambda cfg: (_volpath()(cfg), _halton_under("Volpath")(cfg)),
                       "HaltonSampler"),
    "ao-3x3": (lambda cfg: cfg.update(
        Integrator={"integrator_type": "AO"},
        Sampler={"sampler_type": "StratifiedSampler", "xsamp": 3, "ysamp": 3}), None),
}


@pytest.mark.parametrize("case", list(WAVEFRONT_TAKES))
def test_wavefront_loop_takes_what_the_kernels_refuse(tmp_path, capsys, case):
    """Per-primitive interfaces, grid media under a sphere light and the
    HaltonSampler under Volpath go to the wavefront loop, announced with
    the Volpath kernel's refusal; AO takes a 3x3 stratified grid."""
    edit, refusal = WAVEFRONT_TAKES[case]
    job = load_scene(write_scene(tmp_path, edit))
    assert select_kernel(job, make_sampler(job)) == WAVEFRONT
    err = capsys.readouterr().err
    if refusal is None:
        assert err == ""
    else:
        assert refusal in err and "volpath-kernel subset" in err and "wavefront loop" in err


@pytest.mark.parametrize("name", ["Whitted", "BDPT"])
def test_unknown_integrator_loads_as_ao(tmp_path, name):
    """renderprocess.rs: an integrator_type the reference does not know
    renders AO, in both packages (the JAX loader's mapping.get(kind,
    "ao")), with the same spec."""
    path = write_scene(tmp_path, _set("Integrator", {"integrator_type": name, "n_samples": 8}))
    spec, jspec = load_scene(path).integrator, jax_load_scene(path).integrator
    assert spec.kind == jspec.kind == "ao"
    for key in ("max_depth", "light_strategy", "rr_threshold", "cos_sample", "n_samples",
                "radius", "n_iters", "photons_per_iter", "write_freq"):
        assert getattr(spec, key) == getattr(jspec, key), key


def test_supports_rejects_outside_the_kernel_subset(tmp_path):
    job = load_scene(write_scene(tmp_path))
    sampler = StratifiedSampler(job.sampler)
    assert pmk.unsupported_feature(job.scene, job.integrator, sampler) is None
    job.sampler.xsamp = 3
    assert "power of two" in pmk.unsupported_feature(
        job.scene, job.integrator, StratifiedSampler(job.sampler)
    )
    job.integrator.max_depth = pmk.DEPTH_MAX + 1
    assert not pmk.supports(job.scene, job.integrator, sampler)


def test_debug_fixture_tables_equal():
    """samples/scene_debug.json packs to the JAX package's table: the
    Debug lobes and glass as its two-lobe SPEC_REFL + SPEC_TRANS form."""
    path = str(SAMPLES / "scene_debug.json")
    jjob = jax_load_scene(path)
    jtable = jpmk.pack_scene(SceneCtx(jjob.scene))[0]
    job = load_scene(path)
    assert job.integrator.kind == "debug" and job.integrator.max_depth == 4
    packed = pmk.pack_scene(job.scene, "cpu")
    assert np.array_equal(packed.table.numpy(), np.asarray(jtable))
    assert packed.kinds_present == (
        LOBE_SPEC_REFL, LOBE_SPEC_TRANS, LOBE_MF_REFL, LOBE_DEBUG_DIFFUSE, LOBE_DEBUG_SPECULAR,
    )


@pytest.mark.parametrize("integ", ["Path", "Debug", "DirectLighting", "Volpath"])
def test_glass_lobe_form_follows_the_integrator(tmp_path, integ):
    """glass.rs: smooth glass is one FresnelSpecular lobe under Path and
    Volpath and separate reflect and transmit lobes under the other
    integrators, in both packages."""
    path = write_scene(tmp_path, _set("Integrator", {"integrator_type": integ}))
    job = load_scene(path)
    mats = job.scene.materials
    glass = len(mats["n_lobes"]) - 1  # EXTRA_MATERIALS puts it last
    kinds = list(mats["kind"][glass, : mats["n_lobes"][glass]])
    one_lobe = integ in ("Path", "Volpath")
    assert kinds == ([LOBE_FRESNEL_SPEC] if one_lobe else [LOBE_SPEC_REFL, LOBE_SPEC_TRANS])
    jmats = jax_load_scene(path).scene.materials
    assert list(np.asarray(jmats["kind"])[glass, : int(jmats["n_lobes"][glass])]) == kinds
