"""Image textures in the port against the JAX package, on the CPU.

- scene/png.py against PIL on PNGs written with each row filter and each
  colour type; 16-bit and interlaced images raise naming themselves.
- scene/mipmap.build_mipmap level for level equal to JAX's, and the EWA
  tap (K7's plain version, `ewa_lookup`) and `bilerp_level` held to JAX's
  exact filter (RS_TEX_PACKED=0's ewa_lookup, _bilerp_level) in the three
  wrap modes at rtol 1e-5 (atol 1e-8 on values in [0, 1]: the window's
  sums are taken in another order than XLA's), over seeded lookups with
  anisotropic, clamped and degenerate footprints.
- The loader: the texture record, the image's levels, the material rows
  and the path kernel's table (its textured block) equal JAX's; a missing
  image is skipped as JAX skips it.
- compute_uv_differentials against JAX's (the camera's differentials and
  the textured path kernel: tests/test_torch_textured_path.py).
- Every textured scene outside the path kernel's textured subset raises,
  naming the feature; AO renders textured scenes.
"""

import json
import shutil
import struct
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rs_ray_toy_tpu.accel import geometry as jgeom
from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene import mipmap as jmip
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.accel import geometry as geom
from rs_ray_toy_tpu_torch.integrators.common import SceneCtx
from rs_ray_toy_tpu_torch.interop import registry_from_jax, texture_from_jax
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.ops import texture as tex_ops
from rs_ray_toy_tpu_torch.render import WAVEFRONT, make_sampler, render_job, select_kernel
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene import mipmap, png
from rs_ray_toy_tpu_torch.scene.gen import THIN_FOG
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
TEXTURED = SAMPLES / "scene_textured.json"
PUPIL_SAMPLES = 1 << 12

# several pytest workers share the host: keep torch's threads few
torch.set_num_threads(min(2, torch.get_num_threads()))


# ---- PNG ----


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_png(path, px, colour, filt, palette=None, depth=8, interlace=0):
    """An 8-bit PNG of the (H, W, channels) uint8 samples `px`, every row
    filtered with `filt` (PNG spec 9.2)."""
    h, w, bpp = px.shape
    lines = px.reshape(h, w * bpp).astype(np.int64)
    raw, prev = [], np.zeros(w * bpp, np.int64)
    for line in lines:
        a = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [0, a, prev, (a + prev) // 2, _paeth(a, prev, c)][filt]
        raw.append(bytes([filt]) + ((line - pred) % 256).astype(np.uint8).tobytes())
        prev = line

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if palette is not None:
        body += chunk(b"PLTE", palette.tobytes())
    body += chunk(b"IDAT", zlib.compress(b"".join(raw))) + chunk(b"IEND", b"")
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + body)


COLOURS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("filt", range(5))
@pytest.mark.parametrize("colour", sorted(COLOURS))
def test_png_decode_equals_pil(tmp_path, colour, filt):
    rng = np.random.default_rng(10 * colour + filt)
    px = rng.integers(0, 256, (7, 13, COLOURS[colour]), dtype=np.uint8)
    palette = None
    if colour == 3:
        palette = rng.integers(0, 256, (40, 3), dtype=np.uint8)
        px = px % 40
    path = tmp_path / "t.png"
    _write_png(path, px, colour, filt, palette)
    ref = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(png.read_rgb8(str(path)), ref)


@pytest.mark.parametrize("feature,kw", [("16-bit", dict(depth=16)),
                                        ("Adam7", dict(interlace=1))])
def test_png_outside_the_decoder_raises(tmp_path, feature, kw):
    path = tmp_path / "t.png"
    _write_png(path, np.zeros((2, 2, 3), np.uint8), 2, 0, **kw)
    with pytest.raises(NotImplementedError, match=feature):
        png.read_rgb8(str(path))


def test_fixture_image_loads_as_jax_loads_it():
    """The linear, flipped float64 image of samples/tex_checker.png."""
    from rs_ray_toy_tpu.scene.loader import _load_image

    path = str(SAMPLES / "tex_checker.png")
    assert np.array_equal(png.load_image(path, True), _load_image(path, True))


# ---- MIPMap and the EWA tap ----


@pytest.mark.parametrize("size", [(512, 512), (45, 70)])
def test_build_mipmap_equals_jax(size):
    rng = np.random.default_rng(size[0])
    img = (png.load_image(str(SAMPLES / "tex_checker.png"), True) if size == (512, 512)
           else rng.uniform(0.0, 1.0, size + (3,)))
    levels = mipmap.build_mipmap(img).levels
    jlevels = jmip.build_mipmap(img).levels
    assert len(levels) == len(jlevels) == int(np.log2(max(levels[0].shape[:2]))) + 1
    for a, b in zip(levels, jlevels):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def _lookups(n, seed):
    """st over [-1.2, 2.2)^2 and footprint axes from 1e-4 to 0.3 uv, the
    second often much shorter (the max_aniso clamp), some zero (a
    degenerate footprint: the level-0 bilinear tap)."""
    rng = np.random.default_rng(seed)
    st = rng.uniform(-1.2, 2.2, (n, 2)).astype(np.float32)
    scale = 10 ** rng.uniform(-4.0, -0.5, (n, 1))
    d0 = (rng.normal(size=(n, 2)) * scale).astype(np.float32)
    d1 = (rng.normal(size=(n, 2)) * scale * 10 ** rng.uniform(-2.0, 0.0, (n, 1))).astype(np.float32)
    d1[: n // 16] = 0.0
    d0[: n // 32] = 0.0
    return st, d0, d1


@pytest.fixture(scope="module")
def images():
    return png.load_image(str(SAMPLES / "tex_checker.png"), True)


@pytest.mark.parametrize("wrap", [mipmap.WRAP_REPEAT, mipmap.WRAP_BLACK, mipmap.WRAP_CLAMP])
def test_ewa_lookup_matches_jax(images, wrap):
    jm = jmip.build_mipmap(images, wrap=wrap)
    pyr = mipmap.pyramid(registry_from_jax(_one_image_registry(jm)).images[0], "cpu")
    st, d0, d1 = _lookups(4096, wrap)
    ref = np.asarray(jmip.ewa_lookup(jm.as_device(), jnp.asarray(st), jnp.asarray(d0),
                                     jnp.asarray(d1), jm.max_aniso))
    t = torch.as_tensor
    work = {}
    out = tex_ops.tex_lookup_reference(pyr, t(st), t(d0), t(d1), work).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-8)
    assert ref.max() > 0.1 and int(work["texel"]) > 4096
    # the degenerate footprints are level 0's bilinear taps
    n0 = 4096 // 32
    bl = mipmap.bilerp_level(pyr, torch.zeros(n0, dtype=torch.int64), t(st[:n0, 0]),
                             t(st[:n0, 1])).numpy()
    assert np.array_equal(out[:n0], bl)


@pytest.mark.parametrize("wrap", [mipmap.WRAP_REPEAT, mipmap.WRAP_BLACK, mipmap.WRAP_CLAMP])
def test_bilerp_level_matches_jax(images, wrap):
    jm = jmip.build_mipmap(images, wrap=wrap)
    pyr = mipmap.pyramid(mipmap.build_mipmap(images, wrap=wrap), "cpu")
    st, _, _ = _lookups(2048, 7 + wrap)
    level = np.random.default_rng(wrap).integers(0, pyr.n_levels, 2048)
    ref = np.asarray(jmip._bilerp_level(jm.as_device(), jnp.asarray(level, jnp.int32),
                                        jnp.asarray(st)))
    out = mipmap.bilerp_level(pyr, torch.as_tensor(level), torch.as_tensor(st[:, 0]),
                              torch.as_tensor(st[:, 1])).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-8)


def _one_image_registry(mip):
    from rs_ray_toy_tpu.scene.textures import TEX_IMAGE, TexRecord, TextureRegistry

    reg = TextureRegistry()
    reg.add(TexRecord(kind=TEX_IMAGE, is_rgb=True, image_id=reg.add_image(mip)))
    return reg


# ---- the loader ----


def test_loader_texture_and_tables_equal_jax():
    """samples/scene_textured.json: one TEX_IMAGE record with the
    defaults, its exact levels, the matte's textured kd, and the path
    kernel's table with its textured block."""
    job, jjob = load_scene(str(TEXTURED)), jax_load_scene(str(TEXTURED))
    reg, jreg = job.scene.registry, jjob.scene.registry
    assert len(reg.records) == len(jreg.records) == 1
    for key in ("kind", "mapping", "su", "sv", "du", "dv", "image_id", "scale"):
        assert getattr(reg.records[0], key) == getattr(jreg.records[0], key), key
    jm, m = jreg.images[0], reg.images[0]
    assert (m.wrap, m.do_trilinear, m.max_aniso) == (jm.wrap, jm.do_trilinear, jm.max_aniso)
    assert all(np.array_equal(a, b) for a, b in zip(m.levels, jm.levels))
    mats, jmats = job.scene.materials, jjob.scene.materials
    s0_tex = np.asarray(jmats["packed_i"])[..., 6]
    assert np.array_equal(mats["s0_tex"], s0_tex[:, : mats["s0_tex"].shape[1]])
    assert np.array_equal(mats["s0"], np.asarray(jmats["s0"])[:, : mats["s0"].shape[1]])
    ctx = JaxSceneCtx(jjob.scene)
    assert jpmk.supports(ctx, jjob.integrator, JaxStratified(jjob.sampler), None)
    packed = pmk.pack_scene(job.scene, "cpu")
    jtable = np.asarray(jpmk.pack_scene(ctx)[0])
    assert np.array_equal(packed.table.numpy(), jtable[: packed.table.shape[0]])
    assert (packed.table[:, pmk.TEX0 + 9] == 1.0).all()
    assert packed.tex.rec.image_id == 0 and packed.tex.pyr.n_levels == 10


def test_missing_image_is_skipped_as_jax_skips_it(tmp_path):
    cfg = json.loads(TEXTURED.read_text())
    cfg["rgb_texture"][0]["filename"] = "no_such_image.png"
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    path = tmp_path / "s.json"
    path.write_text(json.dumps(cfg))
    job, jjob = load_scene(str(path)), jax_load_scene(str(path))
    assert not job.scene.registry.records and not jjob.scene.registry.records
    # kd falls back to the matte's default 0.5
    assert (job.scene.materials["s0_tex"] == -1).all()
    assert np.array_equal(job.scene.materials["s0"],
                          np.asarray(jjob.scene.materials["s0"])[:, : job.scene.materials["s0"].shape[1]])


# ---- differentials ----


def _textured_variant(tmp, w, h, edit=None):
    cfg = json.loads(TEXTURED.read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = w, h
    if edit is not None:
        edit(cfg)
    for aux in ("cube.obj", "tex_checker.png"):
        shutil.copy(SAMPLES / aux, tmp)
    path = tmp / "scene.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _batch(w, h, spp):
    pid = np.tile(np.arange(w * h, dtype=np.uint32), spp)
    sid = np.repeat(np.arange(spp, dtype=np.uint32), w * h)
    return pid, sid, np.stack([pid % w, pid // w], -1).astype(np.float32)


def test_uv_differentials_match_jax(tmp_path):
    """compute_uv_differentials on the fixture's primary hits (the same
    rays and differentials into both packages' surface interactions)."""
    path = _textured_variant(tmp_path, 64, 36)
    jjob, job = jax_load_scene(path), load_scene(path)
    jctx, ctx = JaxSceneCtx(jjob.scene), SceneCtx.from_scene(job.scene, "cpu")
    jcam = JaxCamera(jjob.camera, jjob.film, pupil_samples=PUPIL_SAMPLES)
    _, _, pxy = _batch(64, 36, 1)
    o, d, w, diff = jcam.generate_ray_differentials(jnp.asarray(pxy + 0.5),
                                                    jnp.full(pxy.shape, 0.5, jnp.float32), spp=4)
    hit, jsi = jctx.intersect_shaded(o, d, jnp.where(w > 0, jnp.inf, 0.0))
    jsi = jsi._replace(valid=jsi.valid & hit.valid)
    jduv = np.asarray(jgeom.compute_uv_differentials(jsi, diff)[0])
    t = lambda a: torch.as_tensor(np.array(a))
    _, si = ctx.intersect_shaded(t(o), t(d), torch.where(t(w) > 0, torch.inf, 0.0))
    duv = geom.compute_uv_differentials(si, tuple(t(x) for x in diff))[0].numpy()
    valid = np.asarray(jsi.valid)
    assert valid.sum() > 50 and np.abs(jduv[valid]).max() > 1e-3
    np.testing.assert_allclose(duv[valid], jduv[valid], rtol=1e-3, atol=1e-6)
    dead = geom.compute_uv_differentials(si, geom.dead_differentials(t(o), t(d)))[0]
    assert float(dead.abs().max()) < 1e-4


def test_texture_from_jax_is_the_loaders(tmp_path):
    jjob, job = jax_load_scene(str(TEXTURED)), load_scene(str(TEXTURED))
    tc = texture_from_jax(jjob.scene.registry, 0, "cpu")
    packed = pmk.pack_scene(job.scene, "cpu")
    assert torch.equal(tc.pyr.data, packed.tex.pyr.data) and tc.pyr.dims == packed.tex.pyr.dims


# ---- what raises, and what renders ----


def _tex_entry(**kw):
    def edit(cfg):
        cfg["rgb_texture"][0].update(kw)
    return edit


def _add_texture(ttype, section="rgb_texture"):
    def edit(cfg):
        cfg.setdefault(section, []).append({"texture_type": ttype, "texture_name": "other"})
    return edit


def _material(mtype, **kw):
    def edit(cfg):
        cfg["materials"].append({"material_type": mtype, "material_name": "m_other", **kw})
        cfg["Aggregate"]["primitives"][0]["material_name"] = "m_other"
    return edit


def _integrator(kind, camera_medium=False):
    def edit(cfg):
        cfg["Integrator"] = {"integrator_type": kind, "max_depth": 3}
        if camera_medium:
            cfg["Camera"]["medium"] = THIN_FOG
    return edit


def _second_image(cfg):
    cfg["rgb_texture"].append(dict(cfg["rgb_texture"][0], texture_name="s_02", wrap="clamp"))
    _material("MatteMaterial", kd="s_02")(cfg)


def _halton(cfg):
    cfg["Sampler"] = {"sampler_type": "HaltonSampler", "nsamp": 4}


def _smooth(cfg):
    cfg["objs"].append({"obj_name": "sphere", "filename": "sphere_smooth.obj"})
    cfg["Aggregate"]["primitives"].append({"primitive_type": "triangle", "obj_name": "sphere",
                                           "material_name": "mat_matte",
                                           "instances": [{"world_pos": [36.0, 0.0, 3.0]}]})


RAISES = {
    "UVTexture textures": _add_texture("UVTexture"),
    "ScaleTexture textures": _add_texture("ScaleTexture", "float_texture"),
    "trilinear filtering": _tex_entry(do_trilinear=True),
    "spherical texture mapping": _tex_entry(mapping={"mapping": "spherical"}),
    "textured kd \\(ImageTexture\\) under the HaltonSampler": _halton,
    "textured kd \\(ImageTexture\\) on smooth shading": _smooth,
    # K1 takes no Oren-Nayar lobe, and the wavefront loop no texture
    "Oren-Nayar .* lobes; and the wavefront loop's: textured kd":
        _material("MatteMaterial", kd="s_01", sigma=20.0),
    "textured kd \\(PlasticMaterial\\)": _material("PlasticMaterial", kd="s_01"),
    "textured ks \\(PlasticMaterial\\)": _material("PlasticMaterial", ks="s_01"),
    "textured kd \\(ImageTexture\\) beside microfacet": _material("MetalMaterial"),
    "more than one image texture": _second_image,
    "direct-kernel subset: textured kd": _integrator("Debug"),
    "volpath-kernel subset: textured kd": _integrator("Volpath", camera_medium=True),
    "sppm-kernel subset: textured kd": _integrator("SPPM"),
}


@pytest.mark.parametrize("feature", sorted(RAISES))
def test_textured_scenes_outside_the_subset_raise(tmp_path, feature):
    """At load, or where the render picks its route: never untextured."""
    path = _textured_variant(tmp_path, 32, 18, RAISES[feature])
    shutil.copy(SAMPLES / "sphere_smooth.obj", tmp_path)
    with pytest.raises(NotImplementedError, match=feature):
        job = load_scene(path)
        select_kernel(job, make_sampler(job))


def test_given_rays_raise_and_ao_renders(tmp_path):
    path = _textured_variant(tmp_path, 32, 18)
    job = load_scene(path)
    packed = pmk.pack_scene(job.scene, "cpu")
    o = torch.zeros((4, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(4, 1)
    with pytest.raises(NotImplementedError, match="textured kd .* on given rays"):
        pmk.li_path_mega(packed, o, d, torch.ones(4), torch.arange(4), 0,
                         StratifiedSampler(job.sampler), job.integrator)
    job.integrator.kind = "ao"
    assert select_kernel(job, make_sampler(job)) == WAVEFRONT
    res = render_job(job, "cpu", spp_override=1, pupil_samples=PUPIL_SAMPLES)
    assert res["render_path"] == "wavefront" and float(res["rgb_srgb_input"].max()) > 0
