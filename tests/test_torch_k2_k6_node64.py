"""K2's and K6's BVH instances on the node64 walk, on the CPU.

The direct kernel (K2: Debug / DirectLighting) and the Volpath kernel (K6)
walk a BVH over its node64 rows and 48-byte leaf rows (csrc/common.cuh
Bvh64Geometry), as the path kernel does; their plain versions walk the
same rows (ops/path_megakernel.PlainGeometry, walk_node64).

- Both plain versions against the JAX package's jnp integrators, the
  reference of tests/test_torch_direct_bvh.py and tests/test_torch_volpath.py
  (JAX's BVH kernel bodies take minutes to interpret): JAX `li_levels` for
  K2, JAX `li_volpath` for K6, on the JAX camera's rays of a 64x36 film:
  under Debug 16 (one cube: 8) samples in each pixel whose centre ray hits
  the scene (the rest of the film is black), in a medium 4 (the grid
  medium: 8) samples in every pixel; at least 1,000 lit rays on the grid
  (300 on one cube).  The port runs them
  twice, through the camera pass (`li_levels_mega_cam`,
  `li_volpath_mega_cam`: its raygen on the JAX camera's packed lens, the
  instances #5b and #7b) and through the rays-in pass on JAX's rays
  (`li_levels_mega`, `li_volpath_mega`: #6 and #8), at the parity bar of
  tests/test_megakernel.py:129-130 (under 0.5% of rays past 1e-3
  relative) with the 99th percentile below 1e-5 and the means within 3e-3.
  Scenes, packed with bvh=True: write_grid_scene's 6x6 grid of cubes (456
  triangles) under Debug (the Debug fixture's materials), in the fixture's
  homogeneous fog and in an 8^3 grid medium (every cube matte, so that no
  chaotic glossy sample moves the means), and one cube alone, three times
  the fixture's (12 triangles: the tree is one leaf, `root_count` 12, no
  node64 row), in the Debug material under Debug and matte in the fog.
- geometry_args(..., node64=True) on a K2 and a K6 pack: the node64 rows
  (I, 16) and the leaf rows (T, 12), root_count > 0 exactly where I = 0.
- The plain walk's counts on the K6 fog grid's rays: the node64 rows and
  the fused-children rows give the same radiance and the same slab, MT,
  interior-row and step counts, per closest and any-hit walk and per warp.
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators.common import SceneCtx
from rs_ray_toy_tpu.integrators.direct import li_levels
from rs_ray_toy_tpu.integrators.volpath import li_volpath
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.interop import camera_from_jax
from rs_ray_toy_tpu_torch.ops import direct_megakernel as dmk
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.ops import volpath_megakernel as vmk
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import (THIN_FOG, write_fog_scene, write_grid_fog_scene,
                                            write_grid_scene)
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
W, H = 64, 36
PUPIL_SAMPLES = 1 << 12
T = torch.as_tensor

# the suite runs in several pytest workers on one host (tests/test_torch_direct_bvh.py)
torch.set_num_threads(min(2, torch.get_num_threads()))


def _all_matte(path):
    cfg = json.loads(Path(path).read_text())
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_matte"
    Path(path).write_text(json.dumps(cfg))
    return path


def _one_cube(path, material):
    """The scene at `path` with only the fixture's third cube, in
    `material`, three times as large and in the middle of the view."""
    cfg = json.loads(Path(path).read_text())
    prim = cfg["Aggregate"]["primitives"][2]
    inst = dict(prim["instances"][0], world_pos=[35.0, 0.0, 0.0], scale=[3.0, 3.0, 3.0])
    cfg["Aggregate"]["primitives"] = [dict(prim, material_name=material, instances=[inst])]
    Path(path).write_text(json.dumps(cfg))
    return path


def _scene(tmp, name):
    """(json path, kernel module, samples a pixel) of a case at 64x36."""
    debug = str(SAMPLES / "scene_debug.json")
    fog = str(SAMPLES / "scene_fog.json")
    if name == "debug_grid":
        return write_grid_scene(str(tmp), ny=6, nz=6, base=debug, integrator="Debug",
                                max_depth=4, xres=W, yres=H), dmk, 16
    if name == "fog_grid":
        return _all_matte(write_grid_scene(str(tmp), ny=6, nz=6, base=fog, integrator="Volpath",
                                           xres=W, yres=H)), vmk, 4
    if name == "medium_grid":
        base = write_grid_fog_scene(str(tmp / "medium"), n=8, max_depth=3, sigma_scale=0.6,
                                    xres=W, yres=H)
        return _all_matte(write_grid_scene(str(tmp), ny=6, nz=6, base=base, integrator="Volpath",
                                           max_depth=3)), vmk, 8
    if name == "debug_leaf":
        cfg = json.loads((SAMPLES / "scene_debug.json").read_text())
        cfg["Film"]["xres"], cfg["Film"]["yres"] = W, H
        cfg["Integrator"] = {"integrator_type": "Debug", "max_depth": 4}
        shutil.copy(SAMPLES / "cube.obj", tmp)
        (tmp / "scene.json").write_text(json.dumps(cfg))
        return _one_cube(tmp / "scene.json", "mat_debug"), dmk, 8
    return _one_cube(write_fog_scene(str(tmp), base=fog, medium=THIN_FOG, xres=W, yres=H),
                     "mat_matte"), vmk, 4


CASES = ["debug_grid", "fog_grid", "medium_grid", "debug_leaf", "fog_leaf"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """reference(name): the case's JAX rays and jnp radiance (one call a
    case, made once) and what the port needs to run the same samples."""
    made = {}

    def get(name):
        if name not in made:
            path, mod, spp = _scene(tmp_path_factory.mktemp(name), name)
            jjob = jax_load_scene(str(path))
            ctx = SceneCtx(jjob.scene)
            jcam = JaxCamera(jjob.camera, jjob.film, pupil_samples=PUPIL_SAMPLES)
            jsampler = JaxStratified(jjob.sampler, seed=0)
            pix = np.random.default_rng(11).permutation(W * H).astype(np.uint32)
            if mod is dmk:
                # Debug: the pixels whose centre ray hits the scene (tests/
                # test_torch_k1_node64.py; the rest of these films is black)
                every = jnp.asarray(pix)
                centre = jnp.stack([every % W, every // W], -1).astype(jnp.float32) + 0.5
                o, d, w = jcam.generate_rays(centre, jnp.full((W * H, 2), 0.5, jnp.float32))
                pix = pix[np.asarray(ctx.intersect(o, d, jnp.where(w > 0.0, jnp.inf, 0.0)).valid)]
            pid = np.tile(pix, spp)
            sid = np.repeat(np.arange(spp, dtype=np.uint32), pix.size)
            pxy = np.stack([pid % W, pid // W], -1).astype(np.float32)
            jp, js = jnp.asarray(pid), jnp.asarray(sid)
            o, d, w = jcam.generate_rays(jnp.asarray(pxy) + jsampler.get_2d(jp, js, 0),
                                         jsampler.get_2d(jp, js, 1))
            if mod is dmk:
                l_ref = li_levels(ctx, o, d, w, jsampler, jp, js, jjob.integrator)
            else:
                l_ref = li_volpath(ctx, o, d, w, jsampler, jp, js, jjob.integrator,
                                   camera_medium=ctx.camera_medium)
            live = np.asarray(w) > 0
            made[name] = dict(
                path=str(path), mod=mod, cam=camera_from_jax(jpmk.pack_camera(jcam)),
                pxy=T(pxy), pid=T(pid.astype(np.int64)), sid=T(sid.astype(np.int64)),
                o=T(np.asarray(o)), d=T(np.asarray(d)), w=T(np.asarray(w)),
                l_ref=np.where(live[:, None], np.asarray(l_ref), 0.0),
            )
        return made[name]

    return get


def _pack(mod, job):
    pack = vmk.pack_volpath if mod is vmk else pmk.pack_scene
    return pack(job.scene, "cpu", bvh=True)


def _bar(l, l_ref, lit_min):
    assert np.isfinite(l).all()
    assert int((l_ref.max(-1) > 0).sum()) >= lit_min
    rel = np.abs(l - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
    frac_diverged = float((rel.max(-1) > 1e-3).mean())
    assert frac_diverged < 5e-3, f"{frac_diverged:.2%} of rays diverged"
    assert float(np.quantile(rel, 0.99)) < 1e-5, "bulk not bit-level"
    assert abs(l.mean() - l_ref.mean()) < 1e-6 + 3e-3 * abs(l_ref.mean())


@pytest.mark.parametrize("rays", ["camera", "given"])
@pytest.mark.parametrize("name", CASES)
def test_bvh_plain_versions_match_jax(reference, name, rays):
    r = reference(name)
    mod = r["mod"]
    job = load_scene(r["path"])
    sampler = StratifiedSampler(job.sampler, seed=0)
    assert mod.unsupported_feature(job.scene, job.integrator, sampler) is None
    packed = _pack(mod, job)
    bvh, n = packed.bvh, packed.table.shape[0]
    leaf = name.endswith("_leaf")
    assert n == (12 if leaf else 456)
    assert (bvh.root_count, bvh.nodes64.shape[0] == 0) == ((n, True) if leaf else (0, False))
    if mod is vmk:
        assert packed.grid == (name == "medium_grid")
    if rays == "camera":
        fn = vmk.li_volpath_mega_cam if mod is vmk else dmk.li_levels_mega_cam
        l, w = fn(packed, r["cam"], r["pxy"], r["pid"], r["sid"], sampler, job.integrator)
        # the camera weights are held to the JAX kernel's in
        # tests/test_torch_path_kernel.py; here each side's own weight
        # decides which rays are traced (tests/test_torch_direct.compare_case)
        l = np.where((w.numpy() > 0)[:, None], l.numpy(), 0.0)
    else:
        fn = vmk.li_volpath_mega if mod is vmk else dmk.li_levels_mega
        l = fn(packed, r["o"], r["d"], r["w"], r["pid"], r["sid"], sampler,
               job.integrator).numpy()
    _bar(l, r["l_ref"], 300 if leaf else 1000)


@pytest.mark.parametrize("name", ["debug_grid", "fog_grid", "debug_leaf", "fog_leaf"])
def test_geometry_args_hand_k2_k6_the_node64_tables(tmp_path, name):
    path, mod, _ = _scene(tmp_path, name)
    packed = _pack(mod, load_scene(str(path)))
    bvh, n = packed.bvh, packed.table.shape[0]
    cpu = torch.device("cpu")
    table, nodes64, prims = pmk.geometry_args(packed, cpu, node64=True)
    assert table is packed.table and prims is bvh.prims
    assert prims.shape == (n, pmk.PRIM_COLS) and prims.dtype == torch.float32
    assert pmk.root_count(packed) == bvh.root_count
    if name.endswith("_leaf"):
        assert nodes64 is None and bvh.nodes64.shape == (0, 16) and bvh.root_count == n == 12
    else:
        assert nodes64 is bvh.nodes64 and bvh.root_count == 0
        assert nodes64.shape[1] == 16 and 0 < nodes64.shape[0] < n
    # root_count > 0 exactly where the tree has no node64 row
    bad = packed.bvh._replace(root_count=0 if bvh.root_count else n)
    bad = (packed._replace(scene=packed.scene._replace(bvh=bad)) if mod is vmk
           else packed._replace(bvh=bad))
    with pytest.raises(ValueError, match="root_count"):
        pmk.geometry_args(bad, cpu, node64=True)


def test_plain_walk_counts_equal_over_node64_and_fused_rows(reference):
    """The fog grid's rays (the rays-in pass) through the plain Volpath
    version over the node64 rows and over the fused-children rows."""
    r = reference("fog_grid")
    job = load_scene(r["path"])
    packed = _pack(vmk, job)
    bvh = packed.bvh
    fused = packed._replace(scene=packed.scene._replace(
        bvh=bvh._replace(nodes64=None, prims=None)))
    args = (r["o"], r["d"], r["w"], r["pid"], r["sid"], StratifiedSampler(job.sampler, seed=0),
            job.integrator)
    w64, wf = {}, {}
    l64 = vmk.li_volpath_mega_reference(packed, *args, work=w64)
    lf = vmk.li_volpath_mega_reference(fused, *args, work=wf)
    assert torch.equal(l64, lf)
    # every count: the tests, the lobes, the interior rows and the steps
    assert {k: int(v) for k, v in w64.items()} == {k: int(v) for k, v in wf.items()}
    walks = {f"{tag}_{k}" for tag in ("closest", "any")
             for k in ("walks", "steps", "warps", "warp_steps")}
    assert walks | {"mt", "slab", "node"} <= set(w64)
    rays = r["o"].shape[0]
    assert int(w64["closest_walks"]) >= rays // 2 and int(w64["any_walks"]) > 1000
    assert int(w64["closest_steps"]) > int(w64["closest_walks"])
    assert int(w64["node"]) > 0 and int(w64["mt"]) > 0
