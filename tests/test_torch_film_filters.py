"""The port's filtered film (film/film.add_samples) against the JAX package's.

- add_samples on the same seeded p_film, radiance and weights as JAX's
  add_samples: four whole 64x36 grids whose film jitters are seeded,
  with lanes whose jitter is exactly 0 (their base pixel, p_film - 0.5
  rounded half to even, is the pixel to the left at an odd column), lanes
  whose jitter rounds up to the next pixel in float32, and samples on the
  film's edges; per pixel within 1e-5 relative, XYZ and weight.  The box
  of radius 0.5 takes the aligned reshape-add and is bit-equal; a box of
  1.5, the triangle of 2, the Gaussian of 2 (alpha 2) and of 1.5 (alpha
  1), a luminance clamp, and a batch that is not whole grids.
- The normalization oracle of tests/test_furnace.py:336 with the loader's
  filter names (that test's "triangle" and "gaussian" fall through to the
  box): constant radiance at random positions reconstructs to itself.
- The film jitter the render draws for a fused pass under a HaltonSampler
  is the slot value the path kernel reads (its SlotReader).
- render_job of samples/scene.json with a GaussianFilter of radius 2
  (max_depth 1: the direct variant of tests/test_torch_render.py) at
  64x36x16 against JAX render_job, at that file's image bars.
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.film import film as jax_film
from rs_ray_toy_tpu.render import render_job as jax_render_job
from rs_ray_toy_tpu.scene.loader import FilmSpec as JaxFilmSpec
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.film import film
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.render import film_points, render_job, sample_batch
from rs_ray_toy_tpu_torch.sampler.halton import HaltonSampler
from rs_ray_toy_tpu_torch.scene.loader import FilmSpec, SamplerSpec, load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
W, H, K = 64, 36, 4
PUPIL_SAMPLES = 1 << 12

torch.set_num_threads(min(2, torch.get_num_threads()))


def _specs(ftype, radius, alpha=2.0, max_lum=np.inf, w=W, h=H):
    args = (w, h, 35.0, 1.0, max_lum, ftype, np.array([radius, radius]), alpha)
    return FilmSpec(*args), JaxFilmSpec(*args)


def _batch(seed=0):
    """K whole grids, sample-outer: p_film (N, 2), radiance (N, 3), weight (N,)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    pxy = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (K, 1)).astype(np.float32)
    u = rng.random(pxy.shape).astype(np.float32)
    u[:40] = 0.0  # jitter exactly 0: the base is the pixel to the left at odd columns
    big = np.nonzero(pxy[:, 0] >= 60)[0][:20]
    u[big, 0] = np.float32(1.0 - 2.0**-20)  # rounds up to the next pixel in float32
    p = pxy + u
    rad = (rng.random((p.shape[0], 3)) * 3.0).astype(np.float32)
    weight = rng.random(p.shape[0]).astype(np.float32)
    return p, rad, weight


CASES = {
    "box-0.5-aligned": ("BoxFilter", 0.5, 2.0, np.inf),
    "box-1.5": ("BoxFilter", 1.5, 2.0, np.inf),
    "triangle-2": ("TriangleFilter", 2.0, 2.0, np.inf),
    "gaussian-2-alpha-2": ("GaussianFilter", 2.0, 2.0, np.inf),
    "gaussian-1.5-alpha-1": ("GaussianFilter", 1.5, 1.0, np.inf),
    "gaussian-luminance-clamp": ("GaussianFilter", 2.0, 2.0, 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_add_samples_matches_jax(case):
    ftype, radius, alpha, max_lum = CASES[case]
    spec, jspec = _specs(ftype, radius, alpha, max_lum)
    p, rad, weight = _batch()
    base = np.round(p - 0.5).astype(np.int64)
    pix = np.tile(np.arange(W * H), K)
    assert (base[:, 0] != pix % W).any()  # lanes off their own pixel are exercised
    ref = jax_film.add_samples(jax_film.make_film(jspec), jspec, jnp.asarray(p),
                               jnp.asarray(rad), jnp.asarray(weight), aligned=True)
    out = film.add_samples(film.make_film(spec, "cpu"), spec, torch.as_tensor(p),
                           torch.as_tensor(rad), torch.as_tensor(weight))
    xyz, wt = out.xyz.numpy(), out.weight.numpy()
    ref_xyz, ref_wt = np.asarray(ref.xyz), np.asarray(ref.weight)
    if film.aligned(spec):
        assert np.array_equal(xyz, ref_xyz) and np.array_equal(wt, ref_wt)
        return
    assert ref_wt.min() > 0  # every pixel, the edges' too, weighed
    np.testing.assert_allclose(xyz, ref_xyz, rtol=1e-5, atol=0)
    np.testing.assert_allclose(wt, ref_wt, rtol=1e-5, atol=0)


def test_add_samples_of_a_partial_batch_matches_jax():
    """Samples that are not whole grids all take the host's ordered sum."""
    spec, jspec = _specs("GaussianFilter", 2.0)
    p, rad, weight = (a[:-77] for a in _batch(1))
    ref = jax_film.add_samples(jax_film.make_film(jspec), jspec, jnp.asarray(p),
                               jnp.asarray(rad), jnp.asarray(weight))
    out = film.add_samples(film.make_film(spec, "cpu"), spec, torch.as_tensor(p),
                           torch.as_tensor(rad), torch.as_tensor(weight))
    np.testing.assert_allclose(out.xyz.numpy(), np.asarray(ref.xyz), rtol=1e-5, atol=0)
    np.testing.assert_allclose(out.weight.numpy(), np.asarray(ref.weight), rtol=1e-5, atol=0)


@pytest.mark.parametrize("ftype,radius", [("BoxFilter", 0.5), ("TriangleFilter", 2.0),
                                          ("GaussianFilter", 1.5)])
def test_filter_normalization(ftype, radius):
    """tests/test_furnace.py:336-369 with the loader's filter names:
    constant radiance reconstructs to L on the interior pixels."""
    spec, _ = _specs(ftype, radius, w=16, h=12)
    rng = np.random.default_rng(0)
    lval = np.array([0.7, 0.3, 0.9], np.float32)
    if film.aligned(spec):
        # the aligned add takes whole grids: 42 jittered samples a pixel
        ys, xs = np.mgrid[0:12, 0:16]
        p = np.tile(np.stack([xs.ravel(), ys.ravel()], -1), (42, 1)) + rng.random((8064, 2))
    else:
        p = rng.random((8000, 2)) * np.array([16, 12])
    n = p.shape[0]
    out = film.add_samples(film.make_film(spec, "cpu"), spec,
                           torch.as_tensor(p, dtype=torch.float32),
                           torch.as_tensor(np.tile(lval, (n, 1))), torch.ones(n))
    rgb = film.to_rgb(out, spec).numpy()
    m = int(np.ceil(radius)) + 1
    assert np.allclose(rgb[m:-m, m:-m], lval, atol=2e-3), np.abs(rgb[m:-m, m:-m] - lval).max()


def test_halton_film_jitter_is_the_kernel_slot(tmp_path):
    """Under a HaltonSampler the render's host film jitter equals the
    slot-0 values of the path kernel's slot matrix."""
    job = load_scene(str(SAMPLES / "scene.json"))
    job.film.xres, job.film.yres = 40, 24
    sampler = HaltonSampler(SamplerSpec("halton", nsamp=16), 40, 24)
    packed = pmk.pack_scene(job.scene, "cpu")
    pxy, pid, soff = sample_batch(job.film, 16, "cpu")
    reader = pmk.slot_reader(packed, job.integrator, sampler, pid, soff + 16, True)
    assert reader is not None
    p_film = film_points(sampler, pxy, pid, soff + 16)
    assert torch.equal(p_film, pxy + reader.get_2d(pid, soff + 16, 0))


def test_gaussian_render_matches_jax(tmp_path):
    """samples/scene.json, GaussianFilter radius 2 alpha 2, max_depth 1,
    64x36x16: the port's render_job (the path kernel's plain version and
    the footprint add) against JAX render_job (its kernel in interpret
    mode and its scatter add)."""
    cfg = json.loads((SAMPLES / "scene.json").read_text())
    cfg["Film"].update(xres=W, yres=H, Filter={"filter_type": "GaussianFilter",
                                               "radius": [2.0, 2.0], "alpha": 2.0})
    cfg["Integrator"]["max_depth"] = 1
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    path = tmp_path / "gauss.json"
    path.write_text(json.dumps(cfg))
    job = load_scene(str(path))
    assert job.film.filter_type == "GaussianFilter" and job.film.gaussian_alpha == 2.0
    res = render_job(job, "cpu", pupil_samples=PUPIL_SAMPLES)
    ref = jax_render_job(jax_load_scene(str(path)), pupil_samples=PUPIL_SAMPLES)
    assert res["fused_kernel"] == ref["fused_kernel"] == "path" and res["passes"] == 1
    img, ref_img = res["rgb_srgb_input"].numpy(), np.asarray(ref["rgb_srgb_input"])
    assert img.shape == ref_img.shape == (H, W, 3)
    assert np.isfinite(img).all() and ref_img.mean() > 0
    assert abs(img.mean() - ref_img.mean()) < 3e-3 * ref_img.mean()
    lit = (img.sum(-1) > 0) | (ref_img.sum(-1) > 0)
    assert lit.sum() > 20
    close = np.all(np.abs(img - ref_img) <= 1e-3 * np.abs(ref_img) + 1e-4, axis=-1)
    assert close[lit].mean() >= 0.98
