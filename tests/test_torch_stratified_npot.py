"""Stratified grids that are not a power of two (3x3, 5x3, ...).

- The port's StratifiedSampler get_1d / get_2d against the JAX package's
  on the same seeded pixel ids and sample indices: bit-equal for 3x3,
  5x3, 1x3 and 6x6 (the keyed cyclic rotation of JAX's _permute) at
  python-int dimensions and at a per-ray tensor of dimensions, and 4x4
  (Kensler's permutation) beside them.
- Routing: the path, direct and Volpath kernels refuse the grid, as the
  JAX package's common_scene_checks do; the wavefront loops take Path,
  Debug and Volpath (announced) and AO.
- render_job of samples/scene.json (matte cubes) at 64x36x9 through the
  wavefront li_path against JAX render_job (its jnp li_path), at the image
  bars of tests/test_torch_render.py.
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.render import render_job as jax_render_job
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import SamplerSpec as JaxSamplerSpec
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.ops import direct_megakernel as dmk
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.ops import volpath_megakernel as vmk
from rs_ray_toy_tpu_torch.render import WAVEFRONT, make_sampler, render_job, select_kernel
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import THIN_FOG
from rs_ray_toy_tpu_torch.scene.loader import SamplerSpec, load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
PUPIL_SAMPLES = 1 << 12

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.mark.parametrize("grid", [(3, 3), (5, 3), (1, 3), (6, 6), (4, 4)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_values_bit_equal_to_jax(grid):
    xs, ys = grid
    rng = np.random.default_rng(xs * 10 + ys)
    n = 4096
    pid = rng.integers(0, 1 << 20, n).astype(np.uint32)
    sid = rng.integers(0, xs * ys, n).astype(np.uint32)
    dims = rng.integers(0, 300, n).astype(np.uint32)
    for seed in (0, 7):
        jax_s = JaxStratified(JaxSamplerSpec("stratified", True, xs, ys), seed=seed)
        ours = StratifiedSampler(SamplerSpec("stratified", True, xs, ys), seed=seed)
        jp, js = jnp.asarray(pid), jnp.asarray(sid)
        tp, ts = torch.as_tensor(pid.astype(np.int64)), torch.as_tensor(sid.astype(np.int64))
        for dim, jdim in ((0, 0), (9, 9), (61, 61), (torch.as_tensor(dims.astype(np.int64)),
                                                     jnp.asarray(dims))):
            assert np.array_equal(ours.get_1d(tp, ts, dim).numpy(),
                                  np.asarray(jax_s.get_1d(jp, js, jdim)))
            assert np.array_equal(ours.get_2d(tp, ts, dim).numpy(),
                                  np.asarray(jax_s.get_2d(jp, js, jdim)))


def _scene(tmp_path, integrator, fog=False, matte=False, w=64, h=36):
    cfg = json.loads((SAMPLES / "scene.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = w, h
    cfg["Sampler"].update(xsamp=3, ysamp=3)
    cfg["Integrator"] = {**cfg["Integrator"], "integrator_type": integrator}
    if fog:
        cfg["Camera"]["medium"] = THIN_FOG
    if matte:
        for prim in cfg["Aggregate"]["primitives"]:
            prim["material_name"] = "mat_matte"
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    path = tmp_path / f"{integrator}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("integrator,kernel", [("Path", pmk), ("Debug", dmk),
                                               ("Volpath", vmk), ("AO", None)])
def test_kernels_refuse_and_the_wavefront_loop_takes(tmp_path, capsys, integrator, kernel):
    job = load_scene(_scene(tmp_path, integrator, fog=integrator == "Volpath"))
    sampler = make_sampler(job)
    assert isinstance(sampler, StratifiedSampler) and sampler.spp == 9
    assert select_kernel(job, sampler) == WAVEFRONT
    err = capsys.readouterr().err
    if kernel is None:
        assert err == ""
        return
    reason = "stratified grid 3x3 (power of two only)"
    assert kernel.unsupported_feature(job.scene, job.integrator, sampler) == reason
    assert reason in err and "wavefront loop" in err


def test_path_render_matches_jax(tmp_path, capsys):
    """64x36x9 Path, every cube matte: the port's wavefront li_path (K4's
    plain version) against JAX render_job's jnp li_path."""
    path = _scene(tmp_path, "Path", matte=True)
    res = render_job(load_scene(path), "cpu", pupil_samples=PUPIL_SAMPLES)
    assert "power of two only" in capsys.readouterr().err
    ref = jax_render_job(jax_load_scene(path), pupil_samples=PUPIL_SAMPLES)
    assert res["render_path"] == "wavefront" and res["passes"] == 1
    assert res["camera_rays"] == ref["camera_rays"] == 64 * 36 * 9
    img, ref_img = res["rgb_srgb_input"].numpy(), np.asarray(ref["rgb_srgb_input"])
    assert img.shape == ref_img.shape == (36, 64, 3)
    assert np.isfinite(img).all() and ref_img.mean() > 0
    assert abs(img.mean() - ref_img.mean()) < 3e-3 * ref_img.mean()
    lit = (img.sum(-1) > 0) | (ref_img.sum(-1) > 0)
    assert lit.sum() > 20
    close = np.all(np.abs(img - ref_img) <= 1e-3 * np.abs(ref_img) + 1e-4, axis=-1)
    assert close[lit].mean() >= 0.98
