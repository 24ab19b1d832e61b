"""Smooth shading (interpolated vertex normals) in the port, on the CPU,
against the JAX package.

The scenes: the fixture's three cubes (flat, matte) with the octahedron of
tests/test_megakernel_smooth.py:22-45 (vertex normals = vertex
directions, so every face is smooth), written beside the in-repo fixture
into tmp_path, at 64x36; and scene.gen.write_smooth_grid_scene's grid of
smooth UV spheres (samples/sphere_smooth.obj) for the BVH.

- The loader and the shading tables: n0, n1, n2 and has_n as JAX loads
  them; the (T, 39) shade rows (n0..n2 in 15:24, dndu and dndv in 33:39)
  and the BVH kernels' 31-column smooth rows equal JAX's pack_shade_tables
  and pack_bvh_tables; unnormalised vertex normals parallel to the face
  stay flat for the kernels.
- K1's plain version (brute force and the in-kernel BVH) on JAX's camera
  rays, matte, glass and under a sphere-area light, against JAX
  li_path_mega (interpret mode) and li_path: the bars of
  tests/test_megakernel_smooth.py (under 0.5% of rays off by more than
  1e-3 relative, the 99th percentile below 1e-4, means within 3e-3).
- K3-shaded's smooth plain walk against JAX intersect_bvh_pallas_shaded
  (interpret mode) on the same tables: hits equal, t within rtol 1e-5,
  ng, dpdu, dpdv, dndu, dndv within rtol 1e-5 / atol 1e-6, uv and the
  interpolated ns within atol 5e-4 (XLA's CPU code rounds the
  Moller-Trumbore dot products differently: on the ray whose t differs by
  1.9e-6 relative, uv differs by 1.1e-4; tests/test_torch_bvh_kernel.py).
- The wavefront li_path and li_ao on the smooth meshes (brute force and
  over the BVH) against JAX's.
- K2 (Debug, DirectLighting), K6 (Volpath) and SPPM raise "smooth
  shading" on the smooth scene: they shade ns = ng and would render it
  flat in silence.
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.accel.bvh import build_bvh as jax_build_bvh
from rs_ray_toy_tpu.accel.geometry import pack_shade_tables as jax_pack_shade_tables
from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators.ao import li_ao as jax_li_ao
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.integrators.path import li_path as jax_li_path
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.ops.bvh_pallas import intersect_bvh_pallas_shaded, pack_bvh_tables
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu.scene.types import empty_spheres
from rs_ray_toy_tpu_torch.accel.geometry import shade_rows
from rs_ray_toy_tpu_torch.integrators.ao import li_ao
from rs_ray_toy_tpu_torch.integrators.common import SceneCtx
from rs_ray_toy_tpu_torch.integrators.path import li_path
from rs_ray_toy_tpu_torch.interop import from_jax_packed, from_jax_scene_ctx
from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.render import WAVEFRONT, make_sampler, render_job, select_kernel
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import write_smooth_grid_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
PUPIL_SAMPLES = 1 << 10
W, H = 64, 36

torch.set_num_threads(min(2, torch.get_num_threads()))

OCTA_OBJ = """
v 1 0 0
v -1 0 0
v 0 1 0
v 0 -1 0
v 0 0 1
v 0 0 -1
vn 1 0 0
vn -1 0 0
vn 0 1 0
vn 0 -1 0
vn 0 0 1
vn 0 0 -1
f 1//1 3//3 5//5
f 3//3 2//2 5//5
f 2//2 4//4 5//5
f 4//4 1//1 5//5
f 3//3 1//1 6//6
f 2//2 3//3 6//6
f 4//4 2//2 6//6
f 1//1 4//4 6//6
"""


def _octa_scene(tmp_path, mat="mat_matte", max_depth=5, edit=None, obj=OCTA_OBJ):
    """The fixture at 64x36, cubes matte, with the octahedron (scale 1.3,
    rotated 20 degrees about y) at (34, 0.8, 0.5): tests/
    test_megakernel_smooth.py's _smooth_cfg."""
    cfg = json.loads((SAMPLES / "scene.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = W, H
    cfg["Integrator"] = {"integrator_type": "Path", "max_depth": max_depth}
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_matte"
    cfg["materials"].append({"material_type": "GlassMaterial", "material_name": "mat_glass"})
    cfg["objs"].append({"filename": "octa.obj", "obj_name": "octa_01"})
    cfg["Aggregate"]["primitives"].append({
        "primitive_type": "triangle", "material_name": mat, "obj_name": "octa_01",
        "instances": [{"world_pos": [34.0, 0.8, 0.5], "scale": [1.3, 1.3, 1.3],
                       "rotation_axis": [0.0, 1.0, 0.0], "rotation_angle": 20}],
    })
    if edit is not None:
        edit(cfg)
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    (tmp_path / "octa.obj").write_text(obj)
    path = tmp_path / "s.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _sphere_light(cfg):
    """tests/test_megakernel_smooth.py's sphere light beside the fixture's
    point lights (which light the octahedron's front): NEE's MIS branch."""
    cfg["lights"].append({"light_type": "diffuse", "spectrum": {"values": [40.0, 30.0, 20.0]},
                          "light_shape": {"shape_type": "sphere", "radius": 0.6,
                                          "world_pos": [30.0, 2.5, 2.0]}})


def test_smooth_fixture_is_what_make_samples_writes(tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_samples", SAMPLES / "make_samples.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(str(tmp_path))
    for name in ("scene_smooth.json", "scene_halton.json", "sphere_smooth.obj"):
        assert (tmp_path / name).read_bytes() == (SAMPLES / name).read_bytes()
    job = load_scene(str(SAMPLES / "scene_smooth.json"))
    tri = job.scene.triangles
    assert tri.count == 1956 and int(tri.has_n.sum()) == 1920 and pmk.mesh_smooth(tri)
    assert pmk.unsupported_feature(job.scene, job.integrator, StratifiedSampler(job.sampler)) is None
    assert pmk.pack_scene(job.scene, "cpu").bvh is None  # under TRI_MAX: brute force


@pytest.mark.parametrize("obj", ["octa", "sphere", "flat_vn"])
def test_loader_and_shade_tables_match_jax(tmp_path, obj):
    """Vertex normals as JAX loads them, the 39 shade columns and the 31
    smooth BVH shade columns; `flat_vn` is the octahedron with every
    vertex normal its face's normal times 2: smooth for the wavefront
    loop's has_n, flat for the kernels (mesh_smooth)."""
    text = OCTA_OBJ
    if obj == "sphere":
        text = (SAMPLES / "sphere_smooth.obj").read_text()
    elif obj == "flat_vn":
        lines = [ln for ln in OCTA_OBJ.splitlines() if ln.startswith("v ")]
        p = np.array([[float(x) for x in ln.split()[1:]] for ln in lines])
        faces = [[int(c.split("//")[0]) - 1 for c in ln.split()[1:]]
                 for ln in OCTA_OBJ.splitlines() if ln.startswith("f ")]
        vn = [2.0 * np.cross(p[b] - p[a], p[c] - p[a]) / np.linalg.norm(
            np.cross(p[b] - p[a], p[c] - p[a])) for a, b, c in faces]
        text = "\n".join(lines + [f"vn {x:.9f} {y:.9f} {z:.9f}" for x, y, z in vn]
                         + [f"f {a + 1}//{k + 1} {b + 1}//{k + 1} {c + 1}//{k + 1}"
                            for k, (a, b, c) in enumerate(faces)]) + "\n"
    path = _octa_scene(tmp_path, obj=text)
    jtri = JaxSceneCtx(jax_load_scene(path).scene).tri
    tri = load_scene(path).scene.triangles
    for k in ("n0", "n1", "n2", "ng", "dpdu"):
        np.testing.assert_allclose(getattr(tri, k), np.asarray(getattr(jtri, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(tri.has_n, np.asarray(jtri.has_n))
    assert pmk.mesh_smooth(tri) == jpmk._mesh_smooth(jtri) == (obj != "flat_vn")
    f, i = shade_rows(tri)
    jtab = jax_pack_shade_tables(jtri, empty_spheres())
    np.testing.assert_allclose(f, np.asarray(jtab["tri_f"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i[:, 0], np.asarray(jtab["tri_i"])[:, 0])
    np.testing.assert_array_equal(i[:, 1], np.asarray(jtab["tri_i"])[:, 1])
    assert np.abs(f[36:, 33:39]).max() > 0 if obj == "octa" else True  # the partials are live
    ours = bk.pack_bvh(tri, "cpu")
    jbvh = pack_bvh_tables(jax_build_bvh(jtri, empty_spheres(), bk.KERNEL_LEAF), jtri)
    assert ours.smooth and ours.shade_f.shape[1] == 31
    np.testing.assert_allclose(ours.shade_f.numpy(), np.asarray(jbvh["shade_f"]), rtol=1e-5,
                               atol=1e-6)


def _bar(l, l_ref, q99=1e-4):
    assert np.isfinite(l).all() and l_ref.max() > 0, "scene renders black: the hold is vacuous"
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    diverged = float((rel.max(-1) > 1e-3).mean())
    assert diverged < 5e-3, f"{diverged:.2%} of rays diverged"
    if q99 is not None:
        assert float(np.quantile(rel, 0.99)) < q99, "bulk not bit-level"
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())


def _camera_rays(jjob, spp=1):
    """JAX generate_rays through the pixel centres (tests/
    test_megakernel_smooth.py), spp sample indices a pixel."""
    cam = JaxCamera(jjob.camera, jjob.film, pupil_samples=PUPIL_SAMPLES)
    sampler = JaxStratified(jjob.sampler, seed=0)
    pid = jnp.asarray(np.tile(np.arange(W * H, dtype=np.uint32), spp))
    sid = jnp.asarray(np.repeat(np.arange(spp, dtype=np.uint32), W * H))
    px = jnp.stack([(pid % W) + 0.5, (pid // W) + 0.5], -1).astype(jnp.float32)
    o, d, w = cam.generate_rays(px, sampler.get_2d(pid, sid, 1))
    return sampler, pid, sid, o, d, w


T = lambda a: torch.as_tensor(np.array(a))


@pytest.mark.parametrize("case", ["matte", "glass", "area_light"])
def test_path_kernel_matches_jax(tmp_path, case):
    """K1's plain version with smooth normals, brute force and over the
    BVH, on its own packing and on JAX's (interop), against JAX
    li_path_mega in interpret mode and li_path; glass runs the
    fresnel-specular lobe in the ns frame with the etaScale entering test
    on ng; the sphere-area light the MIS branch's reflect gate on ng."""
    path = _octa_scene(tmp_path, mat="mat_glass" if case == "glass" else "mat_matte",
                       max_depth=4 if case == "glass" else 5,
                       edit=_sphere_light if case == "area_light" else None)
    jjob = jax_load_scene(path)
    jctx = JaxSceneCtx(jjob.scene)
    assert jpmk.supports(jctx, jjob.integrator, None, None)
    jsampler, pid, sid, o, d, w = _camera_rays(jjob)
    jargs = (o, d, w, jsampler, pid, sid, jjob.integrator)
    l_ref = np.asarray(jax_li_path(jctx, *jargs))
    jpacked = jpmk.pack_scene(jctx)
    assert jpacked[5].smooth
    l_jk = np.asarray(jpmk.li_path_mega(jctx, jpacked, *jargs, interpret=True))
    _bar(l_jk, l_ref)

    job = load_scene(path)
    sampler = StratifiedSampler(job.sampler, seed=0)
    args = (T(o), T(d), T(w), T(np.asarray(pid, np.int64)), T(np.asarray(sid, np.int64)),
            sampler, job.integrator)
    via, _ = from_jax_packed(np.array(jpacked[0]), jpacked[5].lights, None, "cpu",
                             wide=jpacked[5])
    assert via.smooth
    for packed in (pmk.pack_scene(job.scene, "cpu"), pmk.pack_scene(job.scene, "cpu", bvh=True),
                   via):
        assert packed.smooth
        _bar(pmk.li_path_mega(packed, *args).numpy(), l_jk)
    # the same scene shaded flat renders otherwise: the holds are not vacuous
    flat = pmk.li_path_mega(pmk.pack_scene(job.scene, "cpu")._replace(smooth=False),
                            *args).numpy()
    assert np.abs(flat - l_jk).max() > 1e-2
    l_w = li_path(SceneCtx.from_scene(job.scene, "cpu"), *args[:3], sampler, *args[3:5],
                  job.integrator).numpy()
    _bar(l_w, l_ref)


@pytest.fixture(scope="module")
def sphere_grid(tmp_path_factory):
    """Two smooth spheres behind the fixture's cubes (1,956 triangles: over
    the wavefront BVH), every cube and sphere matte, 64x36."""
    path = write_smooth_grid_scene(str(tmp_path_factory.mktemp("sg")), n=2, xres=W, yres=H)
    cfg = json.loads(Path(path).read_text())
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_matte"
    Path(path).write_text(json.dumps(cfg))
    jctx = JaxSceneCtx(jax_load_scene(path).scene)
    jtab = pack_bvh_tables(jax_build_bvh(jctx.tri, empty_spheres(), bk.KERNEL_LEAF), jctx.tri)
    return path, jctx, jtab


def test_shaded_smooth_walk_matches_jax_kernel(sphere_grid):
    """The smooth instance's plain walk against JAX's shaded kernel in
    interpret mode on JAX's tables, 1500 seeded rays aimed at the
    spheres (a third with t_max 0, a third cut short)."""
    _, jctx, jtab = sphere_grid
    assert np.asarray(jtab["shade_f"]).shape[1] == 31
    ctx = from_jax_scene_ctx(jctx, "cpu", jtab)
    assert ctx.bvh.smooth
    r = np.random.default_rng(4)
    n = 1500
    o = r.normal(0.0, 0.5, (n, 3))
    target = np.stack([r.uniform(37.0, 39.0, n), r.uniform(-8.0, 8.0, n),
                       r.uniform(-5.0, 5.0, n)], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lane = np.arange(n) % 3
    t_max = np.where(lane == 0, np.inf, np.where(lane == 1, r.uniform(35.0, 38.5, n), 0.0))
    o, d, t_max = (a.astype(np.float32) for a in (o, d, t_max))
    t_j, idx_j, valid_j, at_j = intersect_bvh_pallas_shaded(
        jtab, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), interpret=True)
    valid_j = np.asarray(valid_j)
    t, idx, valid, at = bk.intersect_bvh_shaded(ctx.bvh, T(o), T(d), T(t_max))
    assert valid_j.sum() > 200
    np.testing.assert_array_equal(valid.numpy(), valid_j)
    np.testing.assert_array_equal(idx.numpy()[valid_j], np.asarray(idx_j)[valid_j])
    # t within rtol 1e-5: XLA's CPU code rounds the Moller-Trumbore dot
    # products differently in the last bits (one ray of 536 at 1.9e-6)
    np.testing.assert_allclose(t.numpy()[valid_j], np.asarray(t_j)[valid_j], rtol=1e-5)
    np.testing.assert_array_equal(at["mat"].numpy()[valid_j], np.asarray(at_j["mat"])[valid_j])
    for k in ("ng", "dpdu", "dpdv", "dndu", "dndv"):
        np.testing.assert_allclose(at[k].numpy()[valid_j], np.asarray(at_j[k])[valid_j],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("ns", "uv"):  # interpolated at the barycentrics: see the module docstring
        np.testing.assert_allclose(at[k].numpy()[valid_j], np.asarray(at_j[k])[valid_j],
                                   rtol=0, atol=5e-4, err_msg=k)
    ns, ng = at["ns"].numpy()[valid_j], at["ng"].numpy()[valid_j]
    assert (np.abs(ns - ng).max(-1) > 1e-2).mean() > 0.5  # smooth: ns differs from ng
    assert ((ns * ng).sum(-1) >= 0).all()  # ng faced onto ns


@pytest.mark.parametrize("integrator", ["path", "ao"])
@pytest.mark.parametrize("geometry", ["octa", "sphere_grid"])
def test_wavefront_matches_jax(tmp_path, sphere_grid, geometry, integrator):
    """The wavefront li_path and li_ao on a smooth mesh, brute force (the
    octahedron scene: surface_interaction) and over the BVH (the sphere
    grid: the smooth K3-shaded plain walk), 64x36 x 4 spp, against JAX's
    on the same rays and tables (interop)."""
    if geometry == "octa":
        path, jctx, jtab = _octa_scene(tmp_path), None, None
        jctx = JaxSceneCtx(jax_load_scene(path).scene)
    else:
        path, jctx, jtab = sphere_grid
    jjob = jax_load_scene(path)
    job = load_scene(path)
    if integrator == "ao":
        for spec in (jjob.integrator, job.integrator):
            spec.kind, spec.n_samples, spec.cos_sample = "ao", 16, True
    ctx = from_jax_scene_ctx(jctx, "cpu", jtab)
    assert (ctx.bvh is not None) == (geometry == "sphere_grid")
    own = SceneCtx.from_scene(job.scene, "cpu")
    assert (own.bvh is not None) == (geometry == "sphere_grid")
    jsampler, pid, sid, o, d, w = _camera_rays(jjob, spp=4)
    jli, li = (jax_li_path, li_path) if integrator == "path" else (jax_li_ao, li_ao)
    l_ref = np.asarray(jli(jctx, o, d, w, jsampler, pid, sid, jjob.integrator))
    sampler = StratifiedSampler(job.sampler, seed=0)
    args = (T(o), T(d), T(w), sampler, T(np.asarray(pid, np.int64)),
            T(np.asarray(sid, np.int64)), job.integrator)
    assert (l_ref.max(-1) > 0).sum() > 150
    for c in (ctx, own):
        _bar(li(c, *args).numpy(), l_ref, q99=None)


@pytest.mark.parametrize("integrator", ["Debug", "DirectLighting", "Volpath", "SPPM"])
def test_flat_kernels_raise_on_smooth_meshes(tmp_path, capsys, integrator):
    """SPPM raises on vertex normals; Debug, DirectLighting and Volpath
    name them announcing the wavefront loop, which shades them."""
    def edit(cfg):
        cfg["Integrator"] = {"integrator_type": integrator, "max_depth": 3}
        if integrator == "Volpath":
            cfg["Camera"]["medium"] = {"medium_type": "Homogeneous", "g": 0.0,
                                       "preset": "Clorox"}

    job = load_scene(_octa_scene(tmp_path, edit=edit))
    if integrator in ("Debug", "DirectLighting", "Volpath"):
        assert select_kernel(job, make_sampler(job)) == WAVEFRONT
        err = capsys.readouterr().err
        assert "smooth shading (vertex normals)" in err and "wavefront loop" in err
        return
    with pytest.raises(NotImplementedError, match=r"smooth shading \(vertex normals\)"):
        render_job(job, "cpu", pupil_samples=PUPIL_SAMPLES)
