"""The SPPM render on the CPU against JAX render_job.

samples/scene_sppm.json at 64x36, 2 iterations of 2048 photons,
max_depth 3, with every cube matte: no sampler is chaotic there (the
reference's Trowbridge-Reitz sampler makes a glossy bounce chaotic,
ROADMAP Queue 3), so the image holds to RMSE below 1e-4 against JAX
render_job (its jnp path), brute force through render_job and with the
BVH forced through integrators/sppm.render_sppm.  The kernels' plain
versions are held one by one in tests/test_torch_sppm.py.
"""

import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.render import render_job as jax_render_job
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
from rs_ray_toy_tpu_torch.integrators import sppm
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk
from rs_ray_toy_tpu_torch.render import make_sampler, render_job
from rs_ray_toy_tpu_torch.scene.loader import load_scene
from test_torch_sppm import H, PUPIL_SAMPLES, W, write_scene

# several pytest workers share the host: cap torch's OpenMP threads
torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture(scope="module")
def matte(tmp_path_factory):
    """The matte scene and JAX render_job's image of it (its jnp path)."""
    path = write_scene(tmp_path_factory.mktemp("matte"), matte=True)
    ref = jax_render_job(jax_load_scene(path), pupil_samples=PUPIL_SAMPLES, seed=0)
    return path, np.asarray(ref["rgb_srgb_input"]), ref


@pytest.mark.parametrize("geometry", ["brute", "bvh"])
def test_render_matches_jax(matte, geometry):
    path, ref_img, ref = matte
    job = load_scene(path)
    if geometry == "brute":
        res = render_job(job, "cpu", pupil_samples=PUPIL_SAMPLES)
        assert res["fused_kernel"] == "sppm" and res["render_path"] == "plain"
        assert not res["bvh"] and sum(res["launches"].values()) == 0
        assert res["camera_rays"] == ref["camera_rays"] and res["photon_rays"] == ref["photon_rays"]
        img = res["rgb_srgb_input"].numpy()
    else:
        packed = smk.pack_sppm(job.scene, "cpu", bvh=True)
        cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, pupil_samples=PUPIL_SAMPLES))
        lights = sppm.photon_lights(packed, job.scene.lights, "cpu")
        rad, _ = sppm.render_sppm(packed, cam, smk.resolve_mat_tables(job.scene, "cpu"), lights,
                                  make_sampler(job), job.film, job.integrator,
                                  torch.device("cpu"))
        assert packed.bvh is not None
        img = rad.numpy()  # linear radiance; set_image / to_rgb is the identity here
    assert img.shape == ref_img.shape == (H, W, 3)
    assert np.isfinite(img).all() and ref_img.max() > 0
    rmse = float(np.sqrt(np.mean((img - ref_img) ** 2)))
    assert rmse < 1e-4, rmse
