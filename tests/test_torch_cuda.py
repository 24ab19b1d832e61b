"""On the card: the CUDA kernels (the path, direct and Volpath camera
kernels and the SPPM camera and photon walks, brute force and BVH, the
SPPM deposit, and the wavefront loop's intersection kernels K4 and K3;
the path kernel's Halton and smooth instances and K3's smooth shaded
instance; the Disney lobes in the path kernel, and the wavefront loop
on the materials only it takes; the path kernel's subsurface instances
and the wavefront loop's subsurface branch; K7, the EWA texture tap, and
the path kernel's textured instances; K3's deep instances and a mesh past
120,000 triangles; the rays-in instances of the direct and Volpath kernels
and of the SPPM camera walk, and the wavefront Debug / DirectLighting
loop on the card against the CPU; the SPPM kernels' wide instances on
glass and Disney materials and K3's BVH4 walk) against their plain
PyTorch versions.

Marked `cuda`; each test skips without a CUDA device.  Run them on a
machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_cuda.py -q
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
from rs_ray_toy_tpu_torch.integrators import sppm
from rs_ray_toy_tpu_torch.integrators.common import SceneCtx
from rs_ray_toy_tpu_torch.ops import _build
from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
from rs_ray_toy_tpu_torch.ops import direct_megakernel as dmk
from rs_ray_toy_tpu_torch.ops import intersect_kernel as ik
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk
from rs_ray_toy_tpu_torch.ops import texture as tex_ops
from rs_ray_toy_tpu_torch.ops import volpath_megakernel as vmk
from rs_ray_toy_tpu_torch.render import make_sampler, render_job, sample_batch
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import (
    THIN_FOG,
    write_fog_scene,
    write_grid_fog_scene,
    write_deep_bvh_scene,
    write_grid_scene,
    write_variant,
)
from rs_ray_toy_tpu_torch.scene import mipmap
from rs_ray_toy_tpu_torch.scene.loader import SamplerSpec, load_scene
from rs_ray_toy_tpu_torch.scene.png import load_image

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
pytestmark = pytest.mark.cuda


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _job(tmp_path, w=64, h=36, scene="scene.json"):
    cfg = json.loads((SAMPLES / scene).read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = w, h
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    (tmp_path / "scene.json").write_text(json.dumps(cfg))
    return load_scene(str(tmp_path / "scene.json"))


def test_kernel_matches_plain_version(tmp_path):
    dev = _device()
    job = _job(tmp_path)
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, pupil_samples=1 << 16, device=dev))
    sampler = StratifiedSampler(job.sampler)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    args = (pmk.pack_scene(job.scene, dev), cam, pxy, pid, soff, sampler, job.integrator)
    before = pmk.LAUNCHES["path_mega_cam"]
    l, w = pmk.li_path_mega_cam(*args)
    torch.cuda.synchronize()
    assert pmk.LAUNCHES["path_mega_cam"] == before + 1
    l_ref, w_ref = pmk.li_path_mega_cam_reference(*args)
    assert torch.isfinite(l).all()
    torch.testing.assert_close(w, w_ref, rtol=2e-5, atol=1e-7)
    rel = (l - l_ref).abs() / l_ref.abs().clamp(min=1e-3)
    assert float((rel.amax(-1) > 1e-3).float().mean()) < 5e-3
    assert float(torch.quantile(rel.flatten(), 0.99)) < 1e-5
    assert abs(float(l.mean()) - float(l_ref.mean())) < 1e-6 + 3e-3 * abs(float(l_ref.mean()))


def test_render_launches_once_per_pass(tmp_path):
    dev = _device()
    res = render_job(_job(tmp_path), dev, spp_override=16, pupil_samples=1 << 16)
    assert res["render_path"] == "megakernel"
    assert res["launches"] == res["passes"] == 1
    assert torch.isfinite(res["rgb_srgb_input"]).all()
    assert float(res["rgb_srgb_input"].max()) > 0


def test_wrapper_rejects_bad_inputs(tmp_path):
    dev = _device()
    job = _job(tmp_path)
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, pupil_samples=1 << 12, device=dev))
    pxy, pid, soff = sample_batch(job.film, 1, dev)
    packed = pmk.pack_scene(job.scene, dev)
    sampler = StratifiedSampler(job.sampler)
    with pytest.raises(ValueError, match="float32"):
        pmk.li_path_mega_cam(packed, cam, pxy.double(), pid, soff, sampler, job.integrator)
    with pytest.raises(ValueError, match="packed table"):
        cpu_table = packed._replace(table=packed.table.cpu())
        pmk.li_path_mega_cam(cpu_table, cam, pxy, pid, soff, sampler, job.integrator)


@pytest.mark.parametrize("rows", [12, 17])
def test_kernel_matches_plain_version_with_many_triangles(tmp_path, rows):
    """Past 48 KB of staged intersect columns (1365 triangles) the kernel
    asks for more dynamic shared memory: rows x 10 small cubes, 1440 and
    2040 triangles (TRI_MAX is 2048)."""
    dev = _device()
    job = _job(tmp_path, 32, 18)
    cfg = json.loads((tmp_path / "scene.json").read_text())
    prim = cfg["Aggregate"]["primitives"][0]
    prim["instances"] = [
        {"world_pos": [35.0, -6.0 + 1.0 * j, -3.0 + 0.6 * k], "scale": [0.3, 0.3, 0.3],
         "rotation_axis": [0.0, 0.0, 1.0], "rotation_angle": 7.0 * (j + k)}
        for j in range(rows) for k in range(10)
    ]
    cfg["Aggregate"]["primitives"] = [prim]
    cfg["Integrator"]["max_depth"] = 2
    (tmp_path / "scene.json").write_text(json.dumps(cfg))
    job = load_scene(str(tmp_path / "scene.json"))
    assert job.scene.triangles.count == rows * 120
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, pupil_samples=1 << 14, device=dev))
    sampler = StratifiedSampler(job.sampler)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    args = (pmk.pack_scene(job.scene, dev), cam, pxy, pid, soff, sampler, job.integrator)
    l, w = pmk.li_path_mega_cam(*args)
    l_ref, w_ref = pmk.li_path_mega_cam_reference(*args)
    assert float(l_ref.max()) > 0
    torch.testing.assert_close(w, w_ref, rtol=2e-5, atol=1e-7)
    rel = (l - l_ref).abs() / l_ref.abs().clamp(min=1e-3)
    assert float((rel.amax(-1) > 1e-3).float().mean()) < 5e-3
    assert abs(float(l.mean()) - float(l_ref.mean())) < 1e-6 + 3e-3 * abs(float(l_ref.mean()))


PASSES = {  # module: (kernel wrapper, plain version, packing)
    pmk: (pmk.li_path_mega_cam, pmk.li_path_mega_cam_reference, pmk.pack_scene),
    dmk: (dmk.li_levels_mega_cam, dmk.li_levels_mega_cam_reference, pmk.pack_scene),
    vmk: (vmk.li_volpath_mega_cam, vmk.li_volpath_mega_cam_reference, vmk.pack_volpath),
}


def _hold(mod, job, dev, bvh=None):
    """The kernel and its plain version on the same 16-spp batch: launches
    once, equal camera weights, the per-ray bar."""
    fn, ref, pack = PASSES[mod]
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, pupil_samples=1 << 14, device=dev))
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    packed = pack(job.scene, dev, bvh)
    args = (packed, cam, pxy, pid, soff, StratifiedSampler(job.sampler), job.integrator)
    before = sum(mod.LAUNCHES.values())
    l, w = fn(*args)
    torch.cuda.synchronize()
    assert sum(mod.LAUNCHES.values()) == before + 1
    l_ref, w_ref = ref(*args)
    assert torch.isfinite(l).all() and float(l_ref.max()) > 0
    torch.testing.assert_close(w, w_ref, rtol=2e-5, atol=1e-7)
    rel = (l - l_ref).abs() / l_ref.abs().clamp(min=1e-3)
    assert float((rel.amax(-1) > 1e-3).float().mean()) < 5e-3
    assert float(torch.quantile(rel.flatten(), 0.99)) < 1e-5
    assert abs(float(l.mean()) - float(l_ref.mean())) < 1e-6 + 3e-3 * abs(float(l_ref.mean()))
    return packed


@pytest.mark.parametrize("variant", ["debug", "direct-one", "direct-all"])
def test_direct_kernel_matches_plain_version(tmp_path, variant):
    """The Debug fixture (a Debug cube, a glass cube, a metal one), under
    Debug and under DirectLighting with either light strategy."""
    dev = _device()
    job = _job(tmp_path, scene="scene_debug.json")
    if variant != "debug":
        job.integrator.kind = "direct"
        job.integrator.light_strategy = variant.split("-")[1]
    before = dmk.LAUNCHES["direct_mega_cam"]
    assert _hold(dmk, job, dev).bvh is None
    assert dmk.LAUNCHES["direct_mega_cam"] == before + 1


@pytest.mark.parametrize("mod", [pmk, dmk], ids=["path", "direct"])
@pytest.mark.parametrize("grid", [0, 8])
def test_bvh_kernels_match_plain_versions(tmp_path, mod, grid):
    """The BVH branch of each kernel: on the fixture forced into BVH mode
    (grid 0) and on an 8x8 grid of cubes (792 triangles)."""
    dev = _device()
    scene = "scene.json" if mod is pmk else "scene_debug.json"
    if grid:
        path = write_grid_scene(
            str(tmp_path / "grid"), ny=grid, nz=grid, base=str(SAMPLES / scene),
            integrator="Path" if mod is pmk else "Debug", max_depth=5 if mod is pmk else 4,
            xres=64, yres=36,
        )
        job = load_scene(path)
    else:
        job = _job(tmp_path, scene=scene)
    name = "path_mega_cam_bvh" if mod is pmk else "direct_mega_cam_bvh"
    before = mod.LAUNCHES[name]
    assert _hold(mod, job, dev, bvh=True).bvh is not None
    assert mod.LAUNCHES[name] == before + 1


def test_debug_render_launches_once_per_pass(tmp_path):
    dev = _device()
    res = render_job(_job(tmp_path, scene="scene_debug.json"), dev, pupil_samples=1 << 16)
    assert res["fused_kernel"] == "direct" and res["render_path"] == "megakernel"
    assert res["launches"] == res["passes"] == 1 and not res["bvh"]
    assert float(res["rgb_srgb_input"].max()) > 0


def _fog_job(tmp_path, medium):
    """64x36 Volpath scenes: the fixture's thin fog, with the fog_area
    sphere light, or an 8^3 grid plume."""
    if medium == "grid":
        return load_scene(write_grid_fog_scene(str(tmp_path), n=8, xres=64, yres=36,
                                               max_depth=3, sigma_scale=0.6))
    return load_scene(write_fog_scene(str(tmp_path), area_light=medium == "area",
                                      base=str(SAMPLES / "scene_fog.json"), medium=THIN_FOG,
                                      xres=64, yres=36))


@pytest.mark.parametrize("bvh", [False, True], ids=["brute", "bvh"])
@pytest.mark.parametrize("medium", ["homogeneous", "area", "grid"])
def test_volpath_kernel_matches_plain_version(tmp_path, medium, bvh):
    dev = _device()
    job = _fog_job(tmp_path, medium)
    name = "volpath_mega_cam_bvh" if bvh else "volpath_mega_cam"
    before = vmk.LAUNCHES[name]
    packed = _hold(vmk, job, dev, bvh=bvh)
    assert (packed.bvh is not None) == bvh and packed.grid == (medium == "grid")
    assert vmk.LAUNCHES[name] == before + 1


def _volpath_args(tmp_path, dev):
    job = _fog_job(tmp_path, "homogeneous")
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, pupil_samples=1 << 12, device=dev))
    pxy, pid, soff = sample_batch(job.film, 1, dev)
    return (vmk.pack_volpath(job.scene, dev), cam, pxy, pid, soff, StratifiedSampler(job.sampler),
            job.integrator)


def _no_plain_version(*args, **kwargs):
    raise AssertionError("the wrapper fell back to the plain version")


def test_volpath_launch_fault_raises(tmp_path, monkeypatch):
    """A launch the kernel library refuses (a grid medium of no cells)
    raises; the wrapper never runs the plain version instead."""
    dev = _device()
    args = _volpath_args(tmp_path, dev)
    bad = vmk._vol_params(args[0])
    bad.grid, bad.nx = 1, 0
    monkeypatch.setattr(vmk, "_vol_params", lambda packed: bad)
    monkeypatch.setattr(vmk, "li_volpath_mega_cam_reference", _no_plain_version)
    before = dict(vmk.LAUNCHES)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        vmk.li_volpath_mega_cam(*args)
    assert vmk.LAUNCHES == before


def test_volpath_build_fault_raises(tmp_path, monkeypatch):
    """A kernel that does not build raises with nvcc's output."""
    dev = _device()
    args = _volpath_args(tmp_path, dev)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("--no-such-nvcc-flag",))
    monkeypatch.setattr(vmk, "li_volpath_mega_cam_reference", _no_plain_version)
    with pytest.raises(RuntimeError, match="failed to build"):
        vmk.li_volpath_mega_cam(*args)


def test_fog_render_launches_the_volpath_kernel_once_per_pass(tmp_path):
    dev = _device()
    job = _job(tmp_path, scene="scene_fog.json")
    counts = (pmk.LAUNCHES, dmk.LAUNCHES, vmk.LAUNCHES)
    before = [dict(c) for c in counts]
    res = render_job(job, dev, pupil_samples=1 << 16)
    assert res["fused_kernel"] == "volpath" and res["render_path"] == "megakernel"
    assert res["launches"] == res["passes"] == 1 and not res["bvh"]
    assert pmk.LAUNCHES == before[0] and dmk.LAUNCHES == before[1]
    assert vmk.LAUNCHES["volpath_mega_cam"] == before[2]["volpath_mega_cam"] + 1
    assert vmk.LAUNCHES["volpath_mega_cam_bvh"] == before[2]["volpath_mega_cam_bvh"]
    # the fog scatters light into most of the frame
    assert float((res["rgb_srgb_input"].sum(-1) > 0).float().mean()) > 0.5


def _sppm_job(tmp_path, grid=False, scene="scene_sppm.json"):
    """samples/scene_sppm.json (or `scene`) at 64x36, 2 iterations of 4096
    photons; or an 8x8 grid of cubes (792 triangles) in its first
    material under the same SPPM block."""
    cfg = json.loads((SAMPLES / scene).read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 64, 36
    cfg["Integrator"].update(n_iters=2, photons_per_iter=4096)
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    path = tmp_path / "sppm.json"
    path.write_text(json.dumps(cfg))
    if grid:
        path = write_grid_scene(str(tmp_path / "grid"), ny=8, nz=8, base=str(path),
                                integrator="SPPM", max_depth=3)
    return load_scene(str(path))


def _sppm_inputs(job, dev, bvh):
    packed = smk.pack_sppm(job.scene, dev, bvh)
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, pupil_samples=1 << 14, device=dev))
    w, h = job.film.xres, job.film.yres
    pid = torch.arange(w * h, device=dev)
    pxy = torch.stack([pid % w, pid // w], -1).to(torch.float32)
    u = make_sampler(job).slot_matrix(pid, 1, smk.sppm_slots(job.integrator.max_depth))
    return packed, cam, pxy, u


@pytest.mark.parametrize("grid", [False, True], ids=["fixture", "grid"])
@pytest.mark.parametrize("bvh", [False, True], ids=["brute", "bvh"])
def test_sppm_kernels_match_plain_versions(tmp_path, bvh, grid):
    """K8 and K9 (both instances) and K10 against their plain versions on
    one iteration's inputs: ld to the per-ray bar and the VPs, events on
    99.5% of the photons, the deposit's M equal and phi within 1e-5."""
    dev = _device()
    job = _sppm_job(tmp_path, grid)
    depth = job.integrator.max_depth
    packed, cam, pxy, u = _sppm_inputs(job, dev, bvh)
    sfx = "_bvh" if bvh else ""
    before = dict(smk.LAUNCHES)
    ld, vp = smk.sppm_camera_mega_cam(packed, cam, pxy, u, depth)
    torch.cuda.synchronize()
    assert smk.LAUNCHES[f"sppm_camera_mega_cam{sfx}"] == before[f"sppm_camera_mega_cam{sfx}"] + 1
    ld_ref, vp_ref = smk.sppm_camera_mega_cam_reference(packed, cam, pxy, u, depth)
    assert torch.isfinite(ld).all() and float(ld_ref.max()) > 0
    rel = (ld - ld_ref).abs() / ld_ref.abs().clamp(min=1e-3)
    ok = rel.amax(-1) <= 1e-3
    assert float((~ok).float().mean()) < 5e-3
    assert float((vp.valid == vp_ref.valid).float().mean()) >= 0.995
    both = vp.valid & vp_ref.valid & ok
    assert int(both.sum()) > 30 and (vp.mat[both] == vp_ref.mat[both]).all()
    for f in ("p", "wo", "beta", "ng", "dpdu"):
        torch.testing.assert_close(getattr(vp, f)[both], getattr(vp_ref, f)[both], rtol=2e-4,
                                   atol=1e-5)

    lights = sppm.photon_lights(packed, job.scene.lights, dev)
    n_ph = job.integrator.photons_per_iter
    ph = sppm.emit_photons(lights, n_ph + torch.arange(n_ph, device=dev), depth)
    ev = smk.sppm_photon_mega(packed, *ph, depth)
    torch.cuda.synchronize()
    assert smk.LAUNCHES[f"sppm_photon_mega{sfx}"] == before[f"sppm_photon_mega{sfx}"] + 1
    ev_ref = smk.sppm_photon_mega_reference(packed, *ph, depth)
    same = ev[3] == ev_ref[3]
    for k in range(3):
        same &= torch.isclose(ev[k], ev_ref[k], rtol=1e-4, atol=1e-5).all(-1) | ~ev_ref[3]
    assert float(same.reshape(depth - 1, n_ph).all(0).float().mean()) >= 0.995

    radius = torch.full((pxy.shape[0],), job.integrator.radius, device=dev)
    lo, diag = sppm.grid_bounds(vp, radius)
    mats = smk.resolve_mat_tables(job.scene, dev)
    phi, m = smk.deposit_mega(vp, radius, mats, ev, lo, diag)
    torch.cuda.synchronize()
    assert smk.LAUNCHES["sppm_deposit_mega"] == before["sppm_deposit_mega"] + 1
    phi_ref, m_ref = smk.deposit_mega_reference(vp, radius, mats, ev, lo, diag)
    assert torch.equal(m, m_ref)
    torch.testing.assert_close(phi, phi_ref, rtol=1e-5, atol=0.0)


def test_sppm_render_launches_each_kernel_once_per_iteration(tmp_path):
    dev = _device()
    counts = (pmk.LAUNCHES, dmk.LAUNCHES, vmk.LAUNCHES)
    before = [dict(c) for c in counts]
    res = render_job(_sppm_job(tmp_path), dev, pupil_samples=1 << 16)
    assert res["fused_kernel"] == "sppm" and res["render_path"] == "megakernel" and not res["bvh"]
    assert res["launches"] == {
        **{k: 0 for k in smk.LAUNCHES},
        "sppm_camera_mega_cam": 2, "sppm_photon_mega": 2, "sppm_deposit_mega": 2,
    }
    assert [dict(c) for c in counts] == before
    img = res["rgb_srgb_input"]
    assert torch.isfinite(img).all() and float(img.max()) > 0


@pytest.mark.parametrize("grid", [False, True], ids=["fixture", "grid"])
@pytest.mark.parametrize("scene", ["scene_sppm_glass.json", "scene_sppm_disney.json"])
def test_sppm_wide_instances_match_plain_versions(tmp_path, scene, grid):
    """The wide instances of K8, K9 and K10 (glass: specular transmission;
    Disney: its five lobes) on one iteration's inputs, brute force on the
    fixture and over the BVH on its 8x8 grid, against their plain
    versions: ld to the per-ray bar, VP valid and material on 99.5% of the
    pixels and the record where both are valid, events on 99.5% of the
    photons, M equal and phi within 1e-5."""
    dev = _device()
    job = _sppm_job(tmp_path, grid, scene)
    depth = job.integrator.max_depth
    packed, cam, pxy, u = _sppm_inputs(job, dev, grid)
    assert smk.wide_lobes(packed)
    sfx = "_bvh" * grid + "_wide"
    before = dict(smk.LAUNCHES)
    ld, vp = smk.sppm_camera_mega_cam(packed, cam, pxy, u, depth)
    lights = sppm.photon_lights(packed, job.scene.lights, dev)
    n_ph = job.integrator.photons_per_iter
    ph = sppm.emit_photons(lights, n_ph + torch.arange(n_ph, device=dev), depth)
    ev = smk.sppm_photon_mega(packed, *ph, depth)
    radius = torch.full((pxy.shape[0],), job.integrator.radius, device=dev)
    lo, diag = sppm.grid_bounds(vp, radius)
    mats = smk.resolve_mat_tables(job.scene, dev)
    phi, m = smk.deposit_mega(vp, radius, mats, ev, lo, diag)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in smk.LAUNCHES.items() if v != before[k]} == {
        f"sppm_camera_mega_cam{sfx}": 1, f"sppm_photon_mega{sfx}": 1, "sppm_deposit_mega_wide": 1}
    ld_ref, vp_ref = smk.sppm_camera_mega_cam_reference(packed, cam, pxy, u, depth)
    rel = (ld - ld_ref).abs() / ld_ref.abs().clamp(min=1e-3)
    ok = rel.amax(-1) <= 1e-3
    assert float((~ok).float().mean()) < 5e-3 and float(ld_ref.max()) > 0
    assert float((vp.valid == vp_ref.valid).float().mean()) >= 0.995
    both = vp.valid & vp_ref.valid & ok
    assert int(both.sum()) > 10 and (vp.mat[both] == vp_ref.mat[both]).all()
    for f in ("p", "wo", "beta", "ng", "dpdu"):
        torch.testing.assert_close(getattr(vp, f)[both], getattr(vp_ref, f)[both], rtol=2e-4,
                                   atol=1e-5)
    ev_ref = smk.sppm_photon_mega_reference(packed, *ph, depth)
    same = ev[3] == ev_ref[3]
    for k in range(3):
        same &= torch.isclose(ev[k], ev_ref[k], rtol=1e-4, atol=1e-5).all(-1) | ~ev_ref[3]
    assert float(same.reshape(depth - 1, n_ph).all(0).float().mean()) >= 0.995
    phi_ref, m_ref = smk.deposit_mega_reference(vp, radius, mats, ev, lo, diag)
    assert torch.equal(m, m_ref)
    torch.testing.assert_close(phi, phi_ref, rtol=1e-5, atol=0.0)


def test_sppm_glass_render_launches_the_wide_instances(tmp_path):
    """samples/scene_sppm_glass.json through render_job: one launch of each
    wide instance per iteration, none of the base ones."""
    dev = _device()
    res = render_job(_sppm_job(tmp_path, scene="scene_sppm_glass.json"), dev,
                     pupil_samples=1 << 16)
    assert res["fused_kernel"] == "sppm" and res["render_path"] == "megakernel"
    assert res["launches"] == {
        **{k: 0 for k in smk.LAUNCHES},
        "sppm_camera_mega_cam_wide": 2, "sppm_photon_mega_wide": 2, "sppm_deposit_mega_wide": 2,
    }
    img = res["rgb_srgb_input"]
    assert torch.isfinite(img).all() and float(img.max()) > 0


# ---- the wavefront loop's intersection kernels K4 and K3 ----


def _aimed_rays(n, seed, dev, x=(33.0, 38.0), y=(-8.0, 8.0), z=(-5.0, 5.0)):
    """Seeded rays from near the camera toward the cubes, and t_max:
    infinite, finite (short of many hits) or 0, a third each."""
    r = np.random.default_rng(seed)
    o = r.normal(0.0, 0.3, (n, 3))
    target = np.stack([r.uniform(*x, n), r.uniform(*y, n), r.uniform(*z, n)], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lane = np.arange(n) % 3
    t_max = np.where(lane == 0, np.inf, np.where(lane == 1, r.uniform(30.0, 37.0, n), 0.0))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return f(o), f(d), f(t_max)


def test_wavefront_intersect_kernel_matches_plain_version():
    dev = _device()
    ctx = SceneCtx.from_scene(load_scene(str(SAMPLES / "scene.json")).scene, dev)
    o, d, t_max = _aimed_rays(1 << 16, 1, dev)
    assert ctx.chunks is not None  # the loop's walk: the chunked one
    before = ik.LAUNCHES["intersect"]
    t, idx, hit = ik.intersect_triangles(ctx.tri_packed, o, d, t_max, ctx.chunks)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["intersect"] == before + 1
    t_ref, idx_ref, hit_ref = ik.intersect_triangles_reference(ctx.tri_packed, o, d, t_max,
                                                               chunks=ctx.chunks)
    assert int(hit_ref.sum()) > 1000
    assert torch.equal(hit, hit_ref) and torch.equal(idx, idx_ref)
    assert torch.equal(t[hit], t_ref[hit]) and bool(torch.isinf(t[~hit]).all())
    # the walk over every row finds the same hits
    t_e, idx_e, _ = ik.intersect_triangles(ctx.tri_packed, o, d, t_max)
    assert torch.equal(idx_e, idx) and torch.equal(t_e, t)


def test_wavefront_bvh_kernels_match_plain_versions(tmp_path):
    dev = _device()
    job = load_scene(write_grid_scene(str(tmp_path), ny=12, nz=12))
    ctx = SceneCtx.from_scene(job.scene, dev)
    assert ctx.bvh is not None
    o, d, t_max = _aimed_rays(1 << 15, 2, dev, x=(34.5, 36.0), y=(-3.5, 3.5), z=(-2.5, 2.5))
    before = dict(bk.LAUNCHES)
    t, idx, valid = bk.intersect_bvh(ctx.bvh, o, d, t_max)
    occ = bk.occluded_bvh(ctx.bvh, o, d, t_max)
    t_s, idx_s, valid_s, at = bk.intersect_bvh_shaded(ctx.bvh, o, d, t_max)
    torch.cuda.synchronize()
    wide = ctx.bvh.wide
    assert {k: v - before[k] for k, v in bk.LAUNCHES.items()} == {
        **{k: 0 for k in bk.LAUNCHES}, bk.launch_key(False, wide): 1,
        bk.launch_key(True, wide): 1, "bvh_shaded": 1}
    t_ref, idx_ref, valid_ref = bk.intersect_bvh_reference(ctx.bvh, o, d, t_max)
    assert int(valid_ref.sum()) > 5000 and not bool(valid_ref[t_max == 0].any())
    for tt, ii, vv in ((t, idx, valid), (t_s, idx_s, valid_s)):
        assert torch.equal(vv, valid_ref) and torch.equal(ii, idx_ref) and torch.equal(tt, t_ref)
    assert torch.equal(occ, bk.occluded_bvh_reference(ctx.bvh, o, d, t_max))
    _, _, mat, al, a_ref = bk.intersect_bvh_shaded_reference(ctx.bvh, o, d, t_max)
    assert torch.equal(at["mat"], mat) and torch.equal(at["area_light"], al)
    torch.testing.assert_close(at["ng"], a_ref[7:10].T, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(at["uv"], a_ref[2:4].T, rtol=1e-5, atol=1e-6)


def test_wavefront_renders_launch_the_intersection_kernels(tmp_path, monkeypatch):
    dev = _device()
    ao = _job(tmp_path, scene="scene_ao.json")
    res = render_job(ao, dev, spp_override=4, pupil_samples=1 << 16)
    assert res["render_path"] == "wavefront" and not res["bvh"]
    assert res["launches"] == {"intersect": 65, **{k: 0 for k in bk.LAUNCHES}}
    assert torch.isfinite(res["rgb_srgb_input"]).all() and float(res["rgb_srgb_input"].max()) > 0
    monkeypatch.setattr(pmk, "BVH_TRI_MAX", 400)
    grid = load_scene(write_grid_scene(str(tmp_path / "grid"), ny=6, nz=6, xres=64, yres=36))
    before = dict(pmk.LAUNCHES)
    res = render_job(grid, dev, spp_override=4, pupil_samples=1 << 16)
    assert res["render_path"] == "wavefront" and res["bvh"] and dict(pmk.LAUNCHES) == before
    depth = grid.integrator.max_depth
    assert res["launches"] == {"intersect": 0, **{k: 0 for k in bk.LAUNCHES},
                               "bvh_any": depth, "bvh_shaded": depth}
    assert torch.isfinite(res["rgb_srgb_input"]).all() and float(res["rgb_srgb_input"].max()) > 0


def _wide_bar(l, l_ref, q99=1e-5):
    assert torch.isfinite(l).all() and float(l_ref.max()) > 0
    rel = (l - l_ref).abs() / l_ref.abs().clamp(min=1e-3)
    assert float((rel.amax(-1) > 1e-3).float().mean()) < 5e-3
    assert float(torch.quantile(rel.flatten(), 0.99)) < q99
    assert abs(float(l.mean()) - float(l_ref.mean())) < 1e-6 + 3e-3 * abs(float(l_ref.mean()))


@pytest.mark.parametrize("bvh", [False, True], ids=["brute", "bvh"])
@pytest.mark.parametrize("scene", ["scene_sphere_area.json", "scene_env.json",
                                   "scene_disney.json"])
def test_wide_kernel_instances_match_plain_versions(tmp_path, scene, bvh):
    """The widened path kernel on the sphere-area, environment and Disney
    fixtures: the camera instance (#1, #2 with the BVH) and the rays-in
    instance (#3, #4) on the same camera rays, each against its plain
    version."""
    from rs_ray_toy_tpu_torch.render import camera_rays

    dev = _device()
    job = _job(tmp_path, scene=scene)
    camera = RealisticCamera(job.camera, job.film, pupil_samples=1 << 16, device=dev)
    sampler = StratifiedSampler(job.sampler)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    packed = pmk.pack_scene(job.scene, dev, bvh=bvh)
    args = (packed, pmk.pack_camera(camera), pxy, pid, soff, sampler, job.integrator)
    name = "path_mega_cam_bvh" if bvh else "path_mega_cam"
    before = pmk.LAUNCHES[name]
    l, w = pmk.li_path_mega_cam(*args)
    torch.cuda.synchronize()
    assert pmk.LAUNCHES[name] == before + 1
    l_ref, w_ref = pmk.li_path_mega_cam_reference(*args)
    torch.testing.assert_close(w, w_ref, rtol=2e-5, atol=1e-7)
    _wide_bar(l, l_ref)
    o, d, wt = camera_rays(camera, sampler, pxy, pid, soff)
    rays = (packed, o, d, wt, pid, soff, sampler, job.integrator)
    name = "path_mega_bvh" if bvh else "path_mega"
    before = pmk.LAUNCHES[name]
    l = pmk.li_path_mega(*rays)
    torch.cuda.synchronize()
    assert pmk.LAUNCHES[name] == before + 1
    _wide_bar(l, pmk.li_path_mega_reference(*rays))


def test_materials_render_through_the_wavefront_loop(tmp_path):
    """samples/scene_materials.json (Oren-Nayar, Translucent, Mix, rough
    glass, thin and transmissive Disney) renders through the wavefront
    loop's K4, no path-kernel launch; its li_path on the card matches the
    same on the CPU at 80x45x16 (the per-ray bar, 1,000 lit rays)."""
    from rs_ray_toy_tpu_torch.integrators.path import li_path
    from rs_ray_toy_tpu_torch.render import camera_rays

    dev = _device()
    job = _job(tmp_path, scene="scene_materials.json")
    before = dict(pmk.LAUNCHES)
    res = render_job(job, dev, pupil_samples=1 << 16)
    assert res["render_path"] == "wavefront" and dict(pmk.LAUNCHES) == before
    assert res["launches"]["intersect"] > 0
    assert torch.isfinite(res["rgb_srgb_input"]).all() and float(res["rgb_srgb_input"].max()) > 0
    job = _job(tmp_path, 80, 45, scene="scene_materials.json")
    sampler = StratifiedSampler(job.sampler)
    camera = RealisticCamera(job.camera, job.film, pupil_samples=1 << 16, device=dev)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    o, d, w = camera_rays(camera, sampler, pxy, pid, soff)
    l = li_path(SceneCtx.from_scene(job.scene, dev), o, d, w, sampler, pid, soff, job.integrator)
    cpu = torch.device("cpu")
    l_ref = li_path(SceneCtx.from_scene(job.scene, cpu), o.cpu(), d.cpu(), w.cpu(), sampler,
                    pid.cpu(), soff.cpu(), job.integrator)
    assert int((l_ref.amax(-1) > 0).sum()) >= 1000
    _wide_bar(l.cpu(), l_ref)


def test_halton_kernel_marks_a_slot_the_host_did_not_list(monkeypatch):
    """A drift of used_slots from the kernel's reads fails loudly: with the
    bounce-0 BSDF slot left out of the slot matrix, every ray into the
    white furnace's sphere reads NaN radiance, the escaped ones read 1,
    and the plain version raises."""
    from rs_ray_toy_tpu_torch.sampler.halton import HaltonSampler

    dev = _device()
    job = load_scene(str(SAMPLES / "scene_furnace.json"))
    packed = pmk.pack_scene(job.scene, dev)
    bsdf0 = 8 + 3  # sampler/dims.path_dim0(0) + PATH_BSDF
    full = pmk.packed_slots
    monkeypatch.setattr(pmk, "packed_slots",
                        lambda *a: [s for s in full(*a) if s[0] != bsdf0])
    n = 1 << 12
    yz = (np.random.default_rng(5).random((n, 2)) - 0.5) * 1.2  # inside the radius of 1
    o = torch.tensor(np.c_[np.full(n, 30.0), yz], dtype=torch.float32, device=dev)
    d = torch.tensor([[1.0, 0.0, 0.0]], device=dev).expand(n, 3).contiguous()
    w = torch.ones(n, device=dev)
    pid = torch.arange(n, device=dev)
    sampler = HaltonSampler(SamplerSpec("halton", nsamp=1), 64, 64)
    args = (packed, o, d, w, pid, 0, sampler, job.integrator)
    assert torch.isnan(pmk.li_path_mega(*args)).all()
    torch.testing.assert_close(pmk.li_path_mega(packed, o, -d, w, pid, 0, sampler,
                                                job.integrator),
                               torch.ones(n, 3, device=dev), rtol=0, atol=1e-6)
    with pytest.raises(KeyError):
        pmk.li_path_mega_reference(*args)


def test_rays_in_kernel_white_furnace():
    """#3 on 2^18 parallel rays into samples/scene_furnace.json's sphere:
    the mean within 0.015 rho + 0.004 of rho = 0.5, escaped rays 1 within
    1e-6, and the plain version's per-ray bar."""
    dev = _device()
    job = load_scene(str(SAMPLES / "scene_furnace.json"))
    packed = pmk.pack_scene(job.scene, dev)
    sampler = StratifiedSampler(job.sampler, seed=3)
    rng = np.random.default_rng(3)
    n = 1 << 18
    yz = rng.random((2 * n, 2)) * 1.2 - 0.6
    yz = yz[np.hypot(yz[:, 0], yz[:, 1]) < 0.6][:n]
    o = np.concatenate([np.full((n, 1), -5.0), yz], 1) + np.array([35.0, 0.0, 0.0])
    o = torch.tensor(o, dtype=torch.float32, device=dev)
    d = torch.tensor([[1.0, 0.0, 0.0]], device=dev).expand(n, 3).contiguous()
    w = torch.ones(n, device=dev)
    pid = torch.arange(n, device=dev)
    sid = torch.zeros(n, dtype=torch.int64, device=dev)
    l = pmk.li_path_mega(packed, o, d, w, pid, sid, sampler, job.integrator)
    l_esc = pmk.li_path_mega(packed, o, -d, w, pid, sid, sampler, job.integrator)
    assert float((l.mean(0) - 0.5).abs().max()) < 0.015 * 0.5 + 0.004
    assert float((l_esc - 1.0).abs().max()) <= 1e-6
    sub = slice(0, 1 << 14)
    _wide_bar(l[sub], pmk.li_path_mega_reference(packed, o[sub], d[sub], w[sub], pid[sub],
                                                 sid[sub], sampler, job.integrator))


def _fixture(tmp_path, scene, w=64, h=36, halton=False):
    """A samples/ fixture at w x h in tmp_path (its meshes beside it),
    under a 6-sample HaltonSampler with `halton`."""
    sampler = {"sampler_type": "HaltonSampler", "nsamp": 6} if halton else None
    return load_scene(write_variant(str(SAMPLES / scene), str(tmp_path), w, h, sampler))


@pytest.mark.parametrize("bvh", [False, True], ids=["brute", "bvh"])
@pytest.mark.parametrize("halton,smooth", [(True, False), (False, True), (True, True)],
                         ids=["halton", "smooth", "halton-smooth"])
def test_halton_and_smooth_path_instances_match_plain_versions(tmp_path, halton, smooth, bvh):
    """The path kernel's Halton and smooth instances, camera (#1, #2) and
    rays-in (#3, #4) on the same camera rays, against their plain versions
    on the smooth fixture (or the sphere-area one, flat), 6 samples a
    pixel."""
    from rs_ray_toy_tpu_torch.render import camera_rays

    dev = _device()
    job = _fixture(tmp_path, "scene_smooth.json" if smooth else "scene_sphere_area.json",
                   halton=halton)
    camera = RealisticCamera(job.camera, job.film, pupil_samples=1 << 16, device=dev)
    sampler = make_sampler(job)
    pxy, pid, soff = sample_batch(job.film, 6 if halton else 16, dev)
    packed = pmk.pack_scene(job.scene, dev, bvh=bvh)
    assert packed.smooth == smooth
    args = (packed, pmk.pack_camera(camera), pxy, pid, soff, sampler, job.integrator)
    name = pmk.kernel_name("path_mega_cam", bvh, halton, smooth)
    before = dict(pmk.LAUNCHES)
    l, w = pmk.li_path_mega_cam(*args)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in pmk.LAUNCHES.items() if v != before[k]} == {name: 1}
    l_ref, w_ref = pmk.li_path_mega_cam_reference(*args)
    torch.testing.assert_close(w, w_ref, rtol=2e-5, atol=1e-7)
    _wide_bar(l, l_ref)
    o, d, wt = camera_rays(camera, sampler, pxy, pid, soff)
    rays = (packed, o, d, wt, pid, soff, sampler, job.integrator)
    name = pmk.kernel_name("path_mega", bvh, halton, smooth)
    before = pmk.LAUNCHES[name]
    l = pmk.li_path_mega(*rays)
    torch.cuda.synchronize()
    assert pmk.LAUNCHES[name] == before + 1
    _wide_bar(l, pmk.li_path_mega_reference(*rays))


def test_halton_render_launches_once_per_pass(tmp_path):
    """A 24-sample Halton render of the fixture: two passes of 12, one
    launch of the Halton camera instance each."""
    dev = _device()
    job = _fixture(tmp_path, "scene_halton.json")
    res = render_job(job, dev, spp_override=24, pupil_samples=1 << 16)
    assert res["fused_kernel"] == "path" and res["passes"] == 2 and res["launches"] == 2
    assert torch.isfinite(res["rgb_srgb_input"]).all() and float(res["rgb_srgb_input"].max()) > 0


def test_smooth_shaded_bvh_instance_matches_plain_version(tmp_path):
    """K3-shaded's smooth instance on rays aimed at a grid of four smooth
    spheres: hits equal, the 22 attribute rows within rtol 1e-5."""
    from rs_ray_toy_tpu_torch.scene.gen import write_smooth_grid_scene

    dev = _device()
    job = load_scene(write_smooth_grid_scene(str(tmp_path), n=4, xres=64, yres=36))
    ctx = SceneCtx.from_scene(job.scene, dev)
    assert ctx.bvh is not None and ctx.bvh.smooth
    o, d, t_max = _aimed_rays(1 << 15, 2, dev, x=(37.0, 39.0), y=(-7.0, 7.0), z=(-4.5, 4.5))
    before = dict(bk.LAUNCHES)
    t, idx, valid, at = bk.intersect_bvh_shaded(ctx.bvh, o, d, t_max)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in bk.LAUNCHES.items()} == {
        **{k: 0 for k in bk.LAUNCHES}, "bvh_shaded_smooth": 1}
    t_ref, idx_ref, mat, al, a_ref = bk.intersect_bvh_shaded_reference(ctx.bvh, o, d, t_max)
    assert int((idx_ref >= 0).sum()) > 2000
    assert torch.equal(idx, idx_ref) and torch.equal(t, t_ref) and torch.equal(at["mat"], mat)
    for k, key in ((4, "ns"), (7, "ng"), (10, "dpdu"), (16, "dndu"), (19, "dndv")):
        torch.testing.assert_close(at[key], a_ref[k:k + 3].T, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bvh", [False, True], ids=["brute", "bvh"])
@pytest.mark.parametrize("halton", [False, True], ids=["stratified", "halton"])
def test_subsurface_path_instances_match_plain_versions(tmp_path, halton, bvh):
    """The path kernel's subsurface instances (K5 f) on
    samples/scene_sss.json at 160x90: the camera instance (#1, #2 with the
    BVH) and the rays-in instance (#3, #4) on the same camera rays, one
    launch each, against their plain versions."""
    from rs_ray_toy_tpu_torch.render import camera_rays

    dev = _device()
    job = _fixture(tmp_path, "scene_sss.json", 160, 90, halton=halton)
    camera = RealisticCamera(job.camera, job.film, pupil_samples=1 << 16, device=dev)
    sampler = make_sampler(job)
    pxy, pid, soff = sample_batch(job.film, 6 if halton else 16, dev)
    packed = pmk.pack_scene(job.scene, dev, bvh=bvh)
    assert packed.bssrdf is not None
    args = (packed, pmk.pack_camera(camera), pxy, pid, soff, sampler, job.integrator)
    name = pmk.kernel_name("path_mega_cam", bvh, halton, bss=True)
    before = dict(pmk.LAUNCHES)
    l, w = pmk.li_path_mega_cam(*args)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in pmk.LAUNCHES.items() if v != before[k]} == {name: 1}
    l_ref, w_ref = pmk.li_path_mega_cam_reference(*args)
    torch.testing.assert_close(w, w_ref, rtol=2e-5, atol=1e-7)
    assert int((l_ref.amax(-1) > 0).sum()) >= 1000
    _wide_bar(l, l_ref)
    o, d, wt = camera_rays(camera, sampler, pxy, pid, soff)
    rays = (packed, o, d, wt, pid, soff, sampler, job.integrator)
    name = pmk.kernel_name("path_mega", bvh, halton, bss=True)
    before = pmk.LAUNCHES[name]
    l = pmk.li_path_mega(*rays)
    torch.cuda.synchronize()
    assert pmk.LAUNCHES[name] == before + 1
    _wide_bar(l, pmk.li_path_mega_reference(*rays))


def test_subsurface_render_launches_the_path_kernel(tmp_path, capsys):
    """samples/scene_sss.json renders through the subsurface camera
    instance, one launch a pass and no fallback line; its mixed twin
    (another material, a sphere light) through the wavefront loop's K4,
    whose li_path on the card matches the same on the CPU."""
    from rs_ray_toy_tpu_torch.integrators.path import li_path
    from rs_ray_toy_tpu_torch.render import camera_rays

    dev = _device()
    res = render_job(_job(tmp_path, scene="scene_sss.json"), dev, pupil_samples=1 << 16)
    assert res["render_path"] == "megakernel" and res["fused_kernel"] == "path"
    assert res["launches"] == res["passes"] == 1 and "wavefront" not in capsys.readouterr().err
    assert torch.isfinite(res["rgb_srgb_input"]).all() and float(res["rgb_srgb_input"].max()) > 0
    before = dict(pmk.LAUNCHES)
    res = render_job(_job(tmp_path, scene="scene_sss_mixed.json"), dev, pupil_samples=1 << 16)
    assert res["render_path"] == "wavefront" and dict(pmk.LAUNCHES) == before
    assert "wavefront loop" in capsys.readouterr().err
    job = _job(tmp_path, 160, 90, scene="scene_sss_mixed.json")
    sampler = StratifiedSampler(job.sampler)
    camera = RealisticCamera(job.camera, job.film, pupil_samples=1 << 16, device=dev)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    o, d, w = camera_rays(camera, sampler, pxy, pid, soff)
    l = li_path(SceneCtx.from_scene(job.scene, dev), o, d, w, sampler, pid, soff, job.integrator)
    cpu = torch.device("cpu")
    l_ref = li_path(SceneCtx.from_scene(job.scene, cpu), o.cpu(), d.cpu(), w.cpu(), sampler,
                    pid.cpu(), soff.cpu(), job.integrator)
    assert int((l_ref.amax(-1) > 0).sum()) >= 1000
    _wide_bar(l.cpu(), l_ref)


def test_subsurface_grid_wavefront_matches_cpu(tmp_path):
    """scene_sss_mixed.json's grid (its first cube replaced by the cube
    grid in mat_sss) through the wavefront loop over K3: the probe chain's
    segments, each cut off short of the chord's end, are K3 closest-hit
    launches, and the li_path on the card matches the same on the CPU
    over every ray and over the lit rays alone."""
    from rs_ray_toy_tpu_torch.integrators.path import li_path
    from rs_ray_toy_tpu_torch.render import camera_rays

    dev = _device()
    job = load_scene(write_grid_scene(str(tmp_path), base=str(SAMPLES / "scene_sss_mixed.json")))
    job.film.xres, job.film.yres = 80, 45
    sampler = StratifiedSampler(job.sampler)
    camera = RealisticCamera(job.camera, job.film, pupil_samples=1 << 16, device=dev)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    o, d, w = camera_rays(camera, sampler, pxy, pid, soff)
    ctx = SceneCtx.from_scene(job.scene, dev)
    assert ctx.bvh is not None and ctx.bssrdf is not None
    before = bk.LAUNCHES["bvh_closest"]
    l = li_path(ctx, o, d, w, sampler, pid, soff, job.integrator)
    torch.cuda.synchronize()
    assert bk.LAUNCHES["bvh_closest"] > before
    cpu = torch.device("cpu")
    l_ref = li_path(SceneCtx.from_scene(job.scene, cpu), o.cpu(), d.cpu(), w.cpu(), sampler,
                    pid.cpu(), soff.cpu(), job.integrator)
    lit = l_ref.amax(-1) > 0
    assert int(lit.sum()) >= 1000
    _wide_bar(l.cpu(), l_ref)
    _wide_bar(l.cpu()[lit], l_ref[lit])


@pytest.mark.parametrize("wrap", [mipmap.WRAP_REPEAT, mipmap.WRAP_BLACK, mipmap.WRAP_CLAMP])
def test_texture_tap_matches_plain_version(wrap):
    """K7 alone on 2^16 seeded lookups (anisotropic, clamped and
    degenerate footprints) of the fixture's image: the same sums in the
    same order as its plain version, within 1e-5 relative."""
    dev = _device()
    pyr = mipmap.pyramid(mipmap.build_mipmap(load_image(str(SAMPLES / "tex_checker.png"), True),
                                             wrap=wrap), dev)
    rng = np.random.default_rng(wrap)
    n = 1 << 16
    st = rng.uniform(-1.2, 2.2, (n, 2))
    scale = 10 ** rng.uniform(-4.0, -0.5, (n, 1))
    d0 = rng.normal(size=(n, 2)) * scale
    d1 = rng.normal(size=(n, 2)) * scale * 10 ** rng.uniform(-2.0, 0.0, (n, 1))
    d1[: n // 16] = 0.0
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    before = tex_ops.LAUNCHES["tex_lookup"]
    out = tex_ops.tex_lookup(pyr, f(st), f(d0), f(d1))
    torch.cuda.synchronize()
    assert tex_ops.LAUNCHES["tex_lookup"] == before + 1
    ref = tex_ops.tex_lookup_reference(pyr, f(st), f(d0), f(d1))
    assert torch.isfinite(out).all()
    assert float(((out - ref).abs() / ref.abs().clamp(min=1e-6)).max()) < 1e-5


@pytest.mark.parametrize("bvh", [False, True], ids=["brute", "bvh"])
def test_textured_path_instances_match_plain_versions(tmp_path, bvh):
    """samples/scene_textured.json at 160x90x16 through the textured
    camera instance (brute force, or the BVH instance), held to the
    per-ray bar and over its lit rays to under 0.5% diverged."""
    dev = _device()
    cfg = json.loads((SAMPLES / "scene_textured.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 160, 90
    for aux in ("cube.obj", "tex_checker.png"):
        shutil.copy(SAMPLES / aux, tmp_path)
    (tmp_path / "scene.json").write_text(json.dumps(cfg))
    job = load_scene(str(tmp_path / "scene.json"))
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, pupil_samples=1 << 16, device=dev))
    sampler = StratifiedSampler(job.sampler)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    packed = pmk.pack_scene(job.scene, dev, bvh=bvh)
    assert packed.tex is not None
    args = (packed, cam, pxy, pid, soff, sampler, job.integrator)
    name = pmk.kernel_name("path_mega_cam", bvh, tex=True)
    before = pmk.LAUNCHES[name]
    l, w = pmk.li_path_mega_cam(*args)
    torch.cuda.synchronize()
    assert pmk.LAUNCHES[name] == before + 1
    l_ref, _ = pmk.li_path_mega_cam_reference(*args)
    rel = (l - l_ref).abs() / l_ref.abs().clamp(min=1e-3)
    diverged = rel.amax(-1) > 1e-3
    lit = l_ref.amax(-1) > 0
    assert int(lit.sum()) > 1000
    assert float(diverged.float().mean()) < 5e-3
    assert float(diverged[lit].float().mean()) < 5e-3
    assert abs(float(l.mean()) - float(l_ref.mean())) < 1e-6 + 3e-3 * abs(float(l_ref.mean()))


def test_textured_render_launches_once_per_pass(tmp_path, capsys):
    dev = _device()
    cfg = json.loads((SAMPLES / "scene_textured.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 160, 90
    for aux in ("cube.obj", "tex_checker.png"):
        shutil.copy(SAMPLES / aux, tmp_path)
    (tmp_path / "scene.json").write_text(json.dumps(cfg))
    before = dict(pmk.LAUNCHES)
    res = render_job(load_scene(str(tmp_path / "scene.json")), dev)
    launched = {k: v - before[k] for k, v in pmk.LAUNCHES.items() if v != before[k]}
    assert launched == {"path_mega_cam_tex": res["passes"]}
    assert capsys.readouterr().err == ""
    assert float(res["rgb_srgb_input"].max()) > 0


@pytest.mark.parametrize("scene", ["deep", "grid112"])
def test_bvh_kernels_past_the_old_limits(tmp_path, scene):
    """K3's deep instances on a tree of 97 levels, and K3 on 150,552
    triangles, against the plain walk on 2^16 seeded rays."""
    dev = _device()
    path = (write_deep_bvh_scene(str(tmp_path)) if scene == "deep"
            else write_grid_scene(str(tmp_path), ny=112, nz=112))
    tables = bk.pack_bvh(load_scene(path).scene.triangles, dev)
    assert (tables.stack == bk.DEEP_STACK) == (scene == "deep")
    rng = np.random.default_rng(9)
    n = 1 << 16
    aim = np.array([35.0, 0.0, 0.0]) + rng.uniform(-1.0, 1.0, (n, 3)) * np.array([1.0, 3.0, 2.0])
    o = torch.zeros((n, 3), device=dev)
    d = torch.as_tensor((aim / np.linalg.norm(aim, axis=-1, keepdims=True)).astype(np.float32),
                        device=dev)
    t_max = torch.full((n,), torch.inf, device=dev)
    t, idx, valid = bk.intersect_bvh(tables, o, d, t_max)
    t_r, idx_r, valid_r = bk.intersect_bvh_reference(tables, o, d, t_max)
    assert torch.equal(valid, valid_r) and int(valid.sum()) > 1000
    assert torch.equal(t[valid], t_r[valid])
    assert torch.equal(bk.occluded_bvh(tables, o, d, t_max),
                       bk.occluded_bvh_reference(tables, o, d, t_max))


@pytest.mark.parametrize("scene", ["grid40", "deep"])
def test_bvh4_kernels_match_plain_walk_and_binary_kernels(tmp_path, scene):
    """The BVH4 instances (closest and any hit; the deep ones on the 97-level
    tree's 48 wide levels) on 2^16 seeded rays against the plain BVH4 walk
    (equal) and the binary kernels (hit or miss, triangle and t equal
    except on exact ties, which these rays do not meet)."""
    dev = _device()
    path = (write_deep_bvh_scene(str(tmp_path)) if scene == "deep"
            else write_grid_scene(str(tmp_path), ny=40, nz=40))
    wide = bk.pack_bvh(load_scene(path).scene.triangles, dev, wide=True)
    binary = wide._replace(wide=False)
    assert (wide.stack4 == bk.DEEP_STACK) == (scene == "deep")
    # the deep tree's triangles crowd about (35, 0, 0)
    yz = 1.5 if scene == "deep" else 6.0
    o, d, t_max = _aimed_rays(1 << 16, 4, dev, x=(34.5, 36.0), y=(-yz, yz), z=(-yz, yz))
    before = dict(bk.LAUNCHES)
    t, idx, valid = bk.intersect_bvh(wide, o, d, t_max)
    occ = bk.occluded_bvh(wide, o, d, t_max)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in bk.LAUNCHES.items() if v != before[k]} == {
        "bvh4_closest": 1, "bvh4_any": 1}
    t_r, idx_r, valid_r = bk.intersect_bvh_reference(wide, o, d, t_max)
    assert int(valid_r.sum()) > 1000
    assert torch.equal(valid, valid_r) and torch.equal(idx, idx_r) and torch.equal(t, t_r)
    assert torch.equal(occ, bk.occluded_bvh_reference(wide, o, d, t_max))
    t_b, idx_b, valid_b = bk.intersect_bvh(binary, o, d, t_max)
    assert torch.equal(valid, valid_b) and torch.equal(idx, idx_b) and torch.equal(t, t_b)
    assert torch.equal(occ, bk.occluded_bvh(binary, o, d, t_max))


def test_materials_wavefront_card_matches_cpu_over_lit_rays():
    """samples/scene_materials.json's wavefront li_path on the card against
    the same on the CPU at 80x45x16: under 0.5% of the lit rays past 1e-3
    relative.  Its spheres' 3-vector sums once took another order on the
    card, which parted 2% of the lit rays (core/vec.sum3)."""
    dev = _device()
    from rs_ray_toy_tpu_torch.integrators.path import li_path
    from rs_ray_toy_tpu_torch.render import camera_rays

    job = load_scene(str(SAMPLES / "scene_materials.json"))
    job.film.xres, job.film.yres = 80, 45
    sampler = StratifiedSampler(job.sampler)
    cam = RealisticCamera(job.camera, job.film, device=dev)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
    l_card = li_path(SceneCtx.from_scene(job.scene, dev), o, d, w, sampler, pid, soff,
                     job.integrator).cpu()
    cpu = torch.device("cpu")
    l_cpu = li_path(SceneCtx.from_scene(job.scene, cpu), o.cpu(), d.cpu(), w.cpu(), sampler,
                    pid.cpu(), soff.cpu(), job.integrator)
    rel = (l_card - l_cpu).abs() / l_cpu.abs().clamp(min=1e-3)
    lit = l_cpu.amax(-1) > 0
    assert int(lit.sum()) > 1000
    assert float((rel.amax(-1)[lit] > 1e-3).float().mean()) < 5e-3



def _rays_in_bar(l, l_ref):
    assert torch.isfinite(l).all() and float(l_ref.max()) > 0
    rel = (l - l_ref).abs() / l_ref.abs().clamp(min=1e-3)
    assert float((rel.amax(-1) > 1e-3).float().mean()) < 5e-3
    assert float(torch.quantile(rel.flatten(), 0.99)) < 1e-5
    assert abs(float(l.mean()) - float(l_ref.mean())) < 1e-6 + 3e-3 * abs(float(l_ref.mean()))


@pytest.mark.parametrize("bvh", [False, True], ids=["brute", "bvh"])
@pytest.mark.parametrize("kernel", ["direct", "volpath"])
def test_rays_in_direct_and_volpath_kernels_match_plain_versions(tmp_path, kernel, bvh):
    """#6 (the direct tree) and #8 (Volpath) on the host-traced camera
    rays of a 64x36x16 pass, one launch each, against their plain versions
    at the per-ray bar."""
    dev = _device()
    from rs_ray_toy_tpu_torch.render import camera_rays

    if kernel == "direct":
        job = _job(tmp_path, scene="scene_debug.json")
        mod, packed = dmk, pmk.pack_scene(job.scene, dev, bvh)
        fn, ref = dmk.li_levels_mega, dmk.li_levels_mega_reference
    else:
        job = _fog_job(tmp_path, "homogeneous")
        mod, packed = vmk, vmk.pack_volpath(job.scene, dev, bvh)
        fn, ref = vmk.li_volpath_mega, vmk.li_volpath_mega_reference
    sampler = StratifiedSampler(job.sampler)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    o, d, w = camera_rays(RealisticCamera(job.camera, job.film, device=dev), sampler, pxy, pid,
                          soff)
    args = (packed, o, d, w, pid, soff, sampler, job.integrator)
    name = f"{kernel}_mega" + ("_bvh" if bvh else "")
    before = dict(mod.LAUNCHES)
    l = fn(*args)
    torch.cuda.synchronize()
    assert mod.LAUNCHES[name] == before[name] + 1
    assert sum(mod.LAUNCHES.values()) == sum(before.values()) + 1
    _rays_in_bar(l, ref(*args))


@pytest.mark.parametrize("bvh", [False, True], ids=["brute", "bvh"])
def test_rays_in_sppm_camera_walk_matches_plain_version(tmp_path, bvh):
    """#10 on the camera walk's own lens rays and slot values: against its
    plain version (ld at the per-ray bar, VP valid equal on 99.5%)."""
    dev = _device()
    job = _sppm_job(tmp_path)
    depth = job.integrator.max_depth
    packed, cam, pxy, u = _sppm_inputs(job, dev, bvh)
    ox, oy, oz, dx, dy, dz, w = pmk._raygen(pxy[:, 0], pxy[:, 1], None, None,
                                            smk.SlotSampler(u, depth), cam)
    o, d = torch.stack([ox, oy, oz], -1), torch.stack([dx, dy, dz], -1)
    pid = torch.arange(pxy.shape[0], device=dev)
    name = "sppm_camera_mega" + ("_bvh" if bvh else "")
    before = smk.LAUNCHES[name]
    ld, vp = smk.sppm_camera_mega(packed, o, d, w, pid, 1, make_sampler(job), depth)
    torch.cuda.synchronize()
    assert smk.LAUNCHES[name] == before + 1
    ld_ref, vp_ref = smk.sppm_camera_mega_reference(packed, o, d, w, u, depth)
    _rays_in_bar(ld, ld_ref)
    assert float((vp.valid == vp_ref.valid).float().mean()) >= 0.995


@pytest.mark.parametrize("bvh", [False, True], ids=["brute", "bvh"])
def test_rays_in_sppm_wide_instances_match_plain_version(tmp_path, bvh):
    """#10's wide instances on the glass fixture's own lens rays and slot
    values, as the test above holds the base ones."""
    dev = _device()
    job = _sppm_job(tmp_path, scene="scene_sppm_glass.json")
    depth = job.integrator.max_depth
    packed, cam, pxy, u = _sppm_inputs(job, dev, bvh)
    ox, oy, oz, dx, dy, dz, w = pmk._raygen(pxy[:, 0], pxy[:, 1], None, None,
                                            smk.SlotSampler(u, depth), cam)
    o, d = torch.stack([ox, oy, oz], -1), torch.stack([dx, dy, dz], -1)
    pid = torch.arange(pxy.shape[0], device=dev)
    name = "sppm_camera_mega" + ("_bvh" if bvh else "") + "_wide"
    before = smk.LAUNCHES[name]
    ld, vp = smk.sppm_camera_mega(packed, o, d, w, pid, 1, make_sampler(job), depth)
    torch.cuda.synchronize()
    assert smk.LAUNCHES[name] == before + 1
    ld_ref, vp_ref = smk.sppm_camera_mega_reference(packed, o, d, w, u, depth)
    _rays_in_bar(ld, ld_ref)
    assert float((vp.valid == vp_ref.valid).float().mean()) >= 0.995


@pytest.mark.parametrize("case", ["debug-glass", "direct-all-sphere-area"])
def test_wavefront_li_levels_card_matches_cpu(tmp_path, case):
    """The wavefront li_levels on the card (over K4) against the same on
    the CPU on 80x45x16 camera rays: under 0.5% of the lit rays past 1e-3
    relative, at least 1,000 of them."""
    dev = _device()
    from rs_ray_toy_tpu_torch.integrators.direct import li_levels
    from rs_ray_toy_tpu_torch.render import camera_rays

    scene = "scene_debug.json" if case == "debug-glass" else "scene_sphere_area.json"
    job = load_scene(str(SAMPLES / scene))
    if case != "debug-glass":
        job.integrator.kind, job.integrator.light_strategy = "direct", "all"
    job.film.xres, job.film.yres = 80, 45
    sampler = StratifiedSampler(job.sampler)
    cam = RealisticCamera(job.camera, job.film, device=dev)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
    before = ik.LAUNCHES["intersect"]
    l_card = li_levels(SceneCtx.from_scene(job.scene, dev), o, d, w, sampler, pid, soff,
                       job.integrator).cpu()
    assert ik.LAUNCHES["intersect"] > before
    l_cpu = li_levels(SceneCtx.from_scene(job.scene, torch.device("cpu")), o.cpu(), d.cpu(),
                      w.cpu(), sampler, pid.cpu(), soff.cpu(), job.integrator)
    rel = (l_card - l_cpu).abs() / l_cpu.abs().clamp(min=1e-3)
    lit = l_cpu.amax(-1) > 0
    assert int(lit.sum()) > 1000
    assert float((rel.amax(-1)[lit] > 1e-3).float().mean()) < 5e-3
