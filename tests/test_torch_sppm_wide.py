"""SPPM on glass and Disney materials: the kernels' wide instances' plain
PyTorch versions against the JAX package.

Scenes: samples/scene_sppm_glass.json (the matte cube a smooth
GlassMaterial: specular reflection and transmission, which make no
visible point) and samples/scene_sppm_disney.json (the matte cube the
five-lobe DisneyMaterial of samples/scene_disney.json), each at 64x36,
2048 photons, max_depth 3.  The JAX kernels run in interpret mode, each
once per scene, on the same inputs, with the bars of
tests/test_torch_sppm.py:

- the camera walk (K8's plain version) against JAX sppm_camera_mega_cam,
  brute force and through the port's BVH: ld off by more than 1e-3
  relative on fewer than 0.5% of the pixels, valid and material equal on
  99.5%, the VP record at rtol 2e-4 / atol 1e-5;
- the photon walk (K9's) against JAX sppm_photon_mega on seeded photons,
  half of them started inside the glass or Disney cube or the plastic one:
  events equal on 99.5% of the photons (the radiance-mode eta^2 scale of
  a refraction included); on the Disney fixture, of the photons that do
  not bounce off the Disney cube through its microfacet lobe, whose
  reference sampler is chaotic (_disney_microfacet_bounce);
- the deposit (K10's) against JAX deposit_mega on the JAX camera's VPs
  and seeded events around them plus the photon walk's: M equal, phi at
  rtol 1e-5;
- the gate (`unsupported_feature`) against JAX's supports_sppm_camera,
  on both fixtures and on every material of samples/scene_materials.json
  that the JAX kernels refuse, and the VP classes kind by kind;
- one render: the glass fixture with its other cubes matte (no chaotic
  glossy sampler) against JAX render_job, RMSE below 1e-4.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.integrators.common import SceneCtx
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.ops import sppm_megakernel as jsmk
from rs_ray_toy_tpu.render import render_job as jax_render_job
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.integrators import sppm
from rs_ray_toy_tpu_torch.interop import camera_from_jax, from_jax_sppm
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk
from rs_ray_toy_tpu_torch.render import make_sampler, render_job, select_kernel
from rs_ray_toy_tpu_torch.scene.loader import load_scene
from test_torch_sppm import CUBES, DEPTH, H, N_PH, PUPIL_SAMPLES, W, JaxSide

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
FIXTURES = {"glass": "scene_sppm_glass.json", "disney": "scene_sppm_disney.json"}
# several pytest workers share the host: cap torch's OpenMP threads
torch.set_num_threads(min(2, torch.get_num_threads()))


def write_scene(tmp, name, edit=None):
    """The fixture at the test size: W x H, 2 iterations of N_PH photons,
    max_depth DEPTH."""
    cfg = json.loads((SAMPLES / FIXTURES[name]).read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = W, H
    cfg["Integrator"].update(n_iters=2, photons_per_iter=N_PH, max_depth=DEPTH)
    if edit is not None:
        edit(cfg)
    shutil.copy(SAMPLES / "cube.obj", tmp)
    path = Path(tmp) / "sppm.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def side(request, tmp_path_factory):
    """(fixture name, its test-size path, the JAX side on it)."""
    name = request.param
    path = write_scene(tmp_path_factory.mktemp(name), name)
    return name, path, JaxSide(path)


def test_fixtures_are_the_sppm_fixture_with_one_material_changed():
    """Both fixtures are samples/scene_sppm.json at its full size (640x360,
    4 iterations of 131,072 photons), mat_matte replaced: by a smooth
    GlassMaterial, and by scene_disney.json's plain mat_disney."""
    base = json.loads((SAMPLES / "scene_sppm.json").read_text())
    disney = {m["material_name"]: m for m in
              json.loads((SAMPLES / "scene_disney.json").read_text())["materials"]}["mat_disney"]
    for name, mat in (("glass", {"material_type": "GlassMaterial", "material_name": "mat_matte"}),
                      ("disney", {**disney, "material_name": "mat_matte"})):
        cfg = json.loads((SAMPLES / FIXTURES[name]).read_text())
        assert cfg["materials"][0] == mat
        assert {**cfg, "materials": base["materials"]} == base
        assert cfg["materials"][1:] == base["materials"][1:]


def test_gate_matches_jax(side):
    name, path, js = side
    job = load_scene(path)
    assert smk.unsupported_feature(job.scene, job.integrator) is None
    assert jsmk.supports_sppm_camera(js.ctx, js.job.integrator, None)
    packed = smk.pack_sppm(job.scene, "cpu")
    assert smk.wide_lobes(packed)
    # the deposit picks its wide instance from the material rows alone
    assert smk.mats_wide(smk.resolve_mat_tables(job.scene, "cpu"))
    base = load_scene(str(SAMPLES / "scene_sppm.json")).scene
    assert not smk.mats_wide(smk.resolve_mat_tables(base, "cpu"))
    assert select_kernel(job, make_sampler(job))[0] == "sppm"
    kinds = set(packed.kinds_present)
    assert kinds & ({5} if name == "glass" else set(pmk.DISNEY_KINDS))


REFUSED = ["mat_oren_nayar", "mat_rough_glass", "mat_translucent", "mat_mix", "mat_disney_thin",
           "mat_disney_trans"]


@pytest.mark.parametrize("material", REFUSED)
def test_gate_names_what_jax_refuses(tmp_path, material):
    """Every material of samples/scene_materials.json that the JAX kernels
    refuse is refused, and named, on the glass fixture's matte cube."""
    mats = {m["material_name"]: m for m in
            json.loads((SAMPLES / "scene_materials.json").read_text())["materials"]}

    def edit(cfg):
        cfg["materials"] += [m for m in mats.values() if m["material_name"] != "mat_matte"]
        cfg["Aggregate"]["primitives"][0]["material_name"] = material

    path = write_scene(tmp_path, "glass", edit)
    jjob = jax_load_scene(path)
    assert not jsmk.supports_sppm_camera(SceneCtx(jjob.scene), jjob.integrator, None)
    job = load_scene(path)
    reason = smk.unsupported_feature(job.scene, job.integrator)
    assert reason is not None
    with pytest.raises(NotImplementedError, match="lobes"):
        select_kernel(job, make_sampler(job))


def test_vp_classes_match_jax():
    """Kind by kind, over every kind the gate takes: diffuse, glossy or
    (the specular kinds) neither, as the JAX kernels classify it."""
    assert set(smk.SPPM_KINDS) == set(jpmk.COS_KINDS + jpmk.MF_KINDS + jpmk.SPEC_KINDS
                                      + (jsmk.LOBE_DISNEY_CLEARCOAT,))
    for kind in smk.SPPM_KINDS:
        assert (kind in smk.DIFFUSE_KINDS) == (kind in jsmk.DIFFUSE_KINDS), kind
        assert (kind in smk.GLOSSY_KINDS) == (kind in jsmk.GLOSSY_KINDS), kind
    assert not set(smk.DIFFUSE_KINDS + smk.GLOSSY_KINDS) & set(pmk.SPEC_KINDS)


def _packed(js, path, geometry):
    if geometry == "brute":
        return from_jax_sppm("cpu", packed=js.packed)["packed"]
    packed = smk.pack_sppm(load_scene(path).scene, "cpu", bvh=True)
    assert packed.bvh is not None
    return packed


@pytest.mark.parametrize("geometry", ["brute", "bvh"])
def test_camera_walk_matches_jax_kernel(side, geometry):
    name, path, js = side
    u, ld_ref, vp_ref = js.camera()
    packed = _packed(js, path, geometry)
    assert smk.wide_lobes(packed)
    ld, vp = smk.sppm_camera_mega_cam(packed, camera_from_jax(js.cam), torch.as_tensor(js.pxy),
                                      torch.as_tensor(u), DEPTH)
    ld = ld.numpy()
    assert np.isfinite(ld).all() and ld_ref.sum() > 1
    rel = np.abs(ld - ld_ref) / np.maximum(np.abs(ld_ref), 1e-3)
    assert float((rel.max(-1) > 1e-3).mean()) < 5e-3
    valid, valid_ref = vp.valid.numpy(), np.asarray(vp_ref.valid)
    # the glass cube makes no VP: 20 at this size on the glass fixture
    assert (valid == valid_ref).mean() >= 0.995 and valid_ref.sum() >= 15
    both = valid & valid_ref & (rel.max(-1) <= 1e-3)
    for fld in ("p", "wo", "beta", "dpdu", "ng"):
        np.testing.assert_allclose(getattr(vp, fld).numpy()[both],
                                   np.asarray(getattr(vp_ref, fld))[both], rtol=2e-4, atol=1e-5,
                                   err_msg=fld)
    mat = vp.mat.numpy()
    assert (mat[both] == np.asarray(vp_ref.mat)[both]).all()
    if name == "glass":
        # glass makes no VP: the walk goes through it to the cubes behind
        assert not (valid & (mat == 0)).any()
    else:
        assert (valid & (mat == 0)).sum() >= 20  # the Disney cube makes VPs


@pytest.mark.parametrize("geometry", ["brute", "bvh"])
def test_photon_walk_matches_jax_kernel(side, geometry):
    name, path, js = side
    ph, ev_ref = js.photons()
    packed = _packed(js, path, geometry)
    ev = smk.sppm_photon_mega(packed, *(torch.as_tensor(x) for x in ph), DEPTH)
    live, live_ref = ev[3].numpy(), ev_ref[3]
    assert live.shape == live_ref.shape == ((DEPTH - 1) * N_PH,)
    # inside the cubes every depth hits (the Disney cube's roulette ends more)
    assert live_ref.sum() > N_PH // 5
    same = (live == live_ref)
    for k in range(3):
        close = np.isclose(ev[k].numpy(), ev_ref[k], rtol=1e-4, atol=1e-5).all(-1)
        same &= close | ~live_ref
    per_photon = same.reshape(DEPTH - 1, N_PH).all(0)
    held = ~_disney_microfacet_bounce(packed, ph, ev_ref) if name == "disney" else True
    assert per_photon[held].mean() >= 0.995
    assert (ev[0].numpy()[~live] == 0).all()


def _disney_microfacet_bounce(packed, ph, ev_ref):
    """(N_PH,) bool: the photons that bounce off the Disney cube through
    its microfacet lobe at either vertex (the lobe the uniform ub0 picks
    among the material's five).  There the reference's visible-normal
    Trowbridge-Reitz sampler is chaotic (ROADMAP Queue 3): at the lobe's
    alpha of 0.16 and a^2 < 1 it clamps 1 / (a^2 - 1) to 1e10 and takes
    the difference of two terms near 1e20, so the float32 rounding of
    either implementation picks the direction (a quarter of such samples
    part between this port and XLA's CPU code, nine in ten between
    float32 and float64).  The JAX events tell where the second vertex
    lies."""
    ro, rd, _, active, u = ph
    geom = pmk.PlainGeometry(packed, "cpu")
    _, best = geom.closest(*torch.as_tensor(ro).unbind(-1), *torch.as_tensor(rd).unbind(-1),
                           torch.as_tensor(active))
    mat = packed.table[best.clamp(min=0), smk.MAT_COL].numpy()
    first = (best.numpy() >= 0) & (mat == 0)  # mat_matte: the Disney cube
    kinds = packed.table[best.clamp(min=0)][:, 16:96:16].numpy()
    lobe = int(np.nonzero(kinds[first][0] == pmk.LOBE_DISNEY_MICROFACET_REFL)[0][0])
    picks = lambda ub0: np.minimum((ub0 * 5).astype(np.int64), 4) == lobe
    p1, live1 = ev_ref[0].reshape(DEPTH - 1, N_PH, 3)[0], ev_ref[3].reshape(DEPTH - 1, N_PH)[0]
    second = live1 & (np.linalg.norm(p1 - CUBES[0], axis=-1) < 2.0)
    return (first & picks(u[0])) | (second & picks(u[3]))


def test_deposit_matches_jax_kernel(side):
    name, path, js = side
    _, _, vp_ref = js.camera()
    radius, ev, phi_ref, m_ref = js.deposit()
    conv = from_jax_sppm("cpu", vp=vp_ref, resolved=js.resolved, photons=ev)
    vp, r = conv["vp"], torch.as_tensor(radius)
    lo, diag = sppm.grid_bounds(vp, r)
    phi, m = smk.deposit_mega(vp, r, conv["resolved"], conv["photons"], lo, diag)
    assert m_ref.sum() > 1000 and (phi_ref > 0).any()
    assert np.array_equal(m.numpy(), m_ref)
    np.testing.assert_allclose(phi.numpy(), phi_ref, rtol=1e-5, atol=1e-6 * phi_ref.max())
    # the resolved rows are the port's own: resolve_mat_tables equals them
    np.testing.assert_array_equal(smk.resolve_mat_tables(load_scene(path).scene, "cpu").numpy(),
                                  conv["resolved"].numpy())


def test_plain_walks_count_the_disney_operations(side):
    """work["disney_ops"]: the Disney lobes' operations beyond the 3 of a
    lobe evaluation, for the camera walk's light and bounce evaluations
    and the deposit's; none on the glass fixture."""
    name, path, js = side
    u, _, vp_ref = js.camera()
    packed = from_jax_sppm("cpu", packed=js.packed)["packed"]
    work = {}
    smk.sppm_camera_mega_cam_reference(packed, camera_from_jax(js.cam), torch.as_tensor(js.pxy),
                                       torch.as_tensor(u), DEPTH, work=work)
    ops = int(work["disney_ops"])
    assert int(work["lobe"]) > 0
    assert (ops > 0) == (name == "disney")


def test_glass_render_matches_jax(tmp_path):
    """The glass fixture with the plastic and metal cubes made matte, 2
    iterations: the caustic-casting glass cube beside matte ones, against
    JAX render_job (its jnp path)."""
    def edit(cfg):
        for prim in cfg["Aggregate"]["primitives"][1:]:
            prim["material_name"] = "mat_diffuse"
        cfg["materials"].append({"material_type": "MatteMaterial", "material_name": "mat_diffuse",
                                 "kd": {"values": [0.6, 0.6, 0.6]}})

    path = write_scene(tmp_path, "glass", edit)
    ref = jax_render_job(jax_load_scene(path), pupil_samples=PUPIL_SAMPLES, seed=0)
    ref_img = np.asarray(ref["rgb_srgb_input"])
    res = render_job(load_scene(path), "cpu", pupil_samples=PUPIL_SAMPLES)
    assert res["fused_kernel"] == "sppm" and res["render_path"] == "plain"
    img = res["rgb_srgb_input"].numpy()
    assert img.shape == ref_img.shape == (H, W, 3)
    assert np.isfinite(img).all() and ref_img.max() > 0
    rmse = float(np.sqrt(np.mean((img - ref_img) ** 2)))
    assert rmse < 1e-4, rmse
