"""The camera kernels' BVH branch, plain PyTorch version against the JAX
package.

The port packs the scene in BVH mode (`pack_scene(..., bvh=True)`: the
triangle table in leaf order, the fused-children node tables) and its
plain versions walk the tree per ray; the JAX package is forced onto its
in-kernel BVH with its own switch, RS_MEGA_BVH=force.
- Debug / DirectLighting, the BVH cases of tests/test_megakernel.py:358-
  379, against JAX `li_levels` (cases and bar as in
  tests/test_torch_direct.py), one also against the JAX kernel's BVH
  branch in interpret mode;
- Path, against the JAX path kernel's BVH branch in interpret mode, at
  the bar of tests/test_torch_path_kernel.py (the 99th percentile of the
  relative difference below 1e-5).
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
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.interop import camera_from_jax
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.loader import load_scene
from test_torch_direct import bar, compare_case

SAMPLES = Path(__file__).resolve().parents[1] / "samples"

# The suite runs in several pytest workers on one host; torch's default of
# one OpenMP thread per core in each of them oversubscribes the cores, and
# spinning threads then stall the plain version for minutes.
torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.mark.parametrize(
    "integ,material",
    [("DirectLighting", "mat_matte"), ("Debug", "mat_glass")],
)
def test_bvh_radiance_matches_jax_li_levels(tmp_path, integ, material):
    l, l_ref, _ = compare_case(tmp_path, integ, material, True)
    bar(l, l_ref)


def test_bvh_debug_matches_jax_kernel_and_li_levels(tmp_path, monkeypatch):
    """Debug, every cube matte: also against the JAX kernel's BVH branch
    (interpret mode), which covers the fused raygen."""
    monkeypatch.setenv("RS_MEGA_BVH", "force")
    l, l_ref, l_kernel = compare_case(tmp_path, "Debug", "mat_matte", True, interpret=True)
    bar(l, l_ref)
    bar(l, l_kernel)


def test_path_bvh_matches_jax_kernel(tmp_path, monkeypatch):
    """The shipped fixture (matte, plastic, metal; Path max_depth 5) at
    64x36 with all 16 spp, 36,864 rays in a numpy-seeded pixel order: the
    port's Path-BVH plain version against the JAX kernel's BVH branch.
    All 16 samples for the reason of test_torch_path_kernel.interpret_pass
    (a few chaotic glossy bounces need ~1000 lit rays to average out)."""
    monkeypatch.setenv("RS_MEGA_BVH", "force")
    w_, h_ = 64, 36
    cfg = json.loads((SAMPLES / "scene.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = w_, h_
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(cfg))
    jjob = jax_load_scene(str(path))
    ctx = SceneCtx(jjob.scene)
    jsampler = JaxStratified(jjob.sampler, seed=0)
    assert jpmk.supports(ctx, jjob.integrator, jsampler, None)
    jpacked = jpmk.pack_scene(ctx)
    assert jpacked[6] is not None  # the JAX kernel takes its BVH branch
    jcam = jpmk.pack_camera(JaxCamera(jjob.camera, jjob.film, pupil_samples=1 << 12))
    r = np.random.default_rng(11)
    pid = np.tile(r.permutation(w_ * h_).astype(np.uint32), 16)
    sid = np.repeat(np.arange(16, dtype=np.uint32), w_ * h_)
    pxy = np.stack([pid % w_, pid // w_], -1).astype(np.float32)
    l_ref, w_ref = jpmk.li_path_mega_cam(
        ctx, jpacked, jcam, jnp.asarray(pxy), jnp.asarray(pid), jnp.asarray(sid),
        jsampler, jjob.integrator, interpret=True,
    )
    job = load_scene(str(path))
    packed = pmk.pack_scene(job.scene, "cpu", bvh=True)
    assert packed.bvh is not None
    l, w = pmk.li_path_mega_cam(
        packed, camera_from_jax(jcam), torch.as_tensor(pxy),
        torch.as_tensor(pid.astype(np.int64)), torch.as_tensor(sid.astype(np.int64)),
        StratifiedSampler(job.sampler, seed=0), job.integrator,
    )
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=2e-5, atol=1e-7)
    bar(l.numpy(), np.asarray(l_ref), q99=1e-5)
