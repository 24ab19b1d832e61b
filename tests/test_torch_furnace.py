"""The white furnace on the port alone: its first absolute checks.

A convex Lambertian sphere of albedo rho = 0.5 under a unit constant
environment sees the environment from every direction, so its outgoing
radiance is exactly rho; escaped rays read the environment, 1
(tests/test_furnace.py:1-12, :91-101).  Parallel rays down +x through a
disk of radius 0.6 about the sphere's centre, made as
tests/test_furnace.py:62-88 makes them (40,000 drawn, 20,000 kept), go
through the wavefront li_path and through the path kernel's plain
version on given rays, for the sphere at the origin (the JAX test's
scene) and for samples/scene_furnace.json (the sphere at (35, 0, 0)).
Bars: every channel's mean within 0.015 rho + 0.004 of rho; escaped rays
1 within 1e-6.

An environment light with l != 1 renders as with l = 1 in both packages:
its radiance is the map's texel (lights/infinite.rs), and l and scale
reach only its power.
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.integrators.path import li_path as jax_li_path
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.integrators.common import SceneCtx
from rs_ray_toy_tpu_torch.integrators.path import li_path
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
RHO = 0.5  # MatteMaterial's default kd

torch.set_num_threads(min(2, torch.get_num_threads()))


def _furnace_path(tmp_path, l=(1.0, 1.0, 1.0), scale=None):
    """tests/test_furnace.py's scene on the fixture, the sphere at the origin."""
    cfg = json.loads((SAMPLES / "scene.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 40, 24
    cfg["materials"] = [{"material_type": "MatteMaterial", "material_name": "mat_m"}]
    cfg["objs"] = []
    env = {"light_type": "infinite", "l": {"values": list(l)}}
    if scale is not None:
        env["scale"] = {"values": list(scale)}
    cfg["lights"] = [env]
    cfg["infinite_lights"] = [dict(env)]
    cfg["Aggregate"] = {"primitives": [{"primitive_type": "sphere", "material_name": "mat_m",
                                        "radius": 1.0}]}
    cfg["Integrator"] = {"integrator_type": "Path", "max_depth": 5}
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    path = tmp_path / "furnace.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _rays(centre, n=40000, seed=3):
    rng = np.random.default_rng(seed)
    yz = rng.random((n, 2)) * 1.2 - 0.6
    yz = yz[np.hypot(yz[:, 0], yz[:, 1]) < 0.6][: n // 2]
    m = yz.shape[0]
    o = np.concatenate([np.full((m, 1), -5.0), yz], axis=1) + np.asarray(centre)
    d = np.tile([[1.0, 0.0, 0.0]], (m, 1))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return f(o), f(d), torch.ones(m), torch.arange(m), torch.zeros(m, dtype=torch.int64)


def _radiance(job, route, o, d, w, pid, sid, seed=3):
    sampler = StratifiedSampler(job.sampler, seed=seed)
    if route == "wavefront":
        ctx = SceneCtx.from_scene(job.scene, "cpu")
        return li_path(ctx, o, d, w, sampler, pid, sid, job.integrator).numpy()
    packed = pmk.pack_scene(job.scene, "cpu")
    return pmk.li_path_mega(packed, o, d, w, pid, sid, sampler, job.integrator).numpy()


@pytest.mark.parametrize("route", ["wavefront", "kernel"])
@pytest.mark.parametrize("scene", ["origin", "fixture"])
def test_white_furnace(tmp_path, route, scene):
    if scene == "origin":
        job, centre = load_scene(_furnace_path(tmp_path)), (0.0, 0.0, 0.0)
    else:
        job, centre = load_scene(str(SAMPLES / "scene_furnace.json")), (35.0, 0.0, 0.0)
    assert pmk.unsupported_feature(job.scene, job.integrator, None) is None
    o, d, w, pid, sid = _rays(centre)
    L = _radiance(job, route, o, d, w, pid, sid)
    assert np.isfinite(L).all() and L.shape == (o.shape[0], 3)
    mean = L.mean(axis=0)
    assert np.all(np.abs(mean - RHO) < 0.015 * RHO + 0.004), mean
    L_esc = _radiance(job, route, o, -d, w, pid, sid)
    assert np.abs(L_esc - 1.0).max() <= 1e-6


def test_env_radiance_is_the_texel_not_l(tmp_path):
    """l = (3, 2, 1) and scale 2: both packages still render the furnace's
    rho and escaped 1, ray for ray alike (the K1 plain version and the
    wavefront loop against JAX's li_path)."""
    path = _furnace_path(tmp_path, l=(3.0, 2.0, 1.0), scale=(2.0, 2.0, 2.0))
    job = load_scene(path)
    assert tuple(job.scene.lights.emit[0]) == (6.0, 4.0, 2.0)
    o, d, w, pid, sid = _rays((0.0, 0.0, 0.0), n=4000)
    jjob = jax_load_scene(path)
    l_ref = np.asarray(jax_li_path(
        JaxSceneCtx(jjob.scene), jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(w.numpy()), JaxStratified(jjob.sampler, seed=3),
        jnp.asarray(pid.numpy().astype(np.uint32)), jnp.asarray(sid.numpy().astype(np.uint32)),
        jjob.integrator))
    assert abs(float(l_ref.mean()) - RHO) < 0.02
    for route in ("wavefront", "kernel"):
        L = _radiance(job, route, o, d, w, pid, sid)
        rel = np.abs(L - l_ref) / np.maximum(np.abs(l_ref), 1e-3)
        assert float((rel.max(-1) > 1e-3).mean()) < 5e-3 and float(np.quantile(rel, 0.99)) < 1e-4
