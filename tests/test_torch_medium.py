"""The port's medium, light and loader building blocks against the JAX package.

scene/medium.py (phase_hg, hg_sample, the RNG chain, _grid_density,
_unit_box_interval, medium_sample and medium_tr), lights/lights.py
(sample_li, power) and pack_volpath run on the same seeded numpy inputs
as their JAX counterparts.  Bars:
- the RNG chains and every sampling decision (channel, scattered or not,
  tracking steps, ratio-tracking kills) are bit-equal;
- the floats agree to a few ulp (relative 4e-7 on values of order one,
  ~3 float32 ulp): both run the same float32 operations, but XLA's CPU
  log, exp, sin, cos and rsqrt differ from torch's by up to 1-2 ulp and
  its small dot products may contract into FMAs;
- packed tables, light constants, the power CDF, the pick pdfs and the
  world radius are equal, bit for bit.

Then the absolute checks: the single-scatter oracles of
tests/test_furnace.py (a point light in isotropic and in forward
Henyey-Greenstein fog, depth 1), run through the port's bounce loop.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rs_ray_toy_tpu.integrators.common import SceneCtx
from rs_ray_toy_tpu.lights import lights as jlights
from rs_ray_toy_tpu.ops import volpath_megakernel as jvmk
from rs_ray_toy_tpu.scene import medium as jmed
from rs_ray_toy_tpu.scene.loader import MediumSpec as JaxMediumSpec
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.lights import lights
from rs_ray_toy_tpu_torch.ops import direct_megakernel as dmk
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.ops import volpath_megakernel as vmk
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene import medium as med
from rs_ray_toy_tpu_torch.scene.gen import THIN_FOG, write_fog_scene, write_grid_fog_scene
from rs_ray_toy_tpu_torch.scene.loader import load_scene
from rs_ray_toy_tpu_torch.scene.types import MediumSpec
from test_furnace import _single_scatter_quadrature

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
torch.set_num_threads(min(2, torch.get_num_threads()))
ULP_RTOL = 4e-7
N = 4096


def _close(a, b, atol=1e-7):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=ULP_RTOL, atol=atol)


def _grid_density_values(n=8, sigma_scale=0.6):
    """write_grid_fog_scene's plume, as the JSON stores it."""
    zi, yi, xi = [(np.arange(n) + 0.5) / n - 0.5 for _ in range(3)]
    r2 = xi[None, None, :] ** 2 + yi[None, :, None] ** 2 + zi[:, None, None] ** 2
    return np.round(sigma_scale * np.exp(-r2 / 0.09), 5)


def _specs():
    """A homogeneous medium (id 0) and a rotated, scaled 8^3 grid (id 1)."""
    w2m = np.linalg.inv(
        np.array([[12.0, 2.0, 0.0, -4.0], [-1.0, 9.0, 0.5, -3.0], [0.0, 1.0, 7.0, -2.0],
                  [0.0, 0.0, 0.0, 1.0]])
    )
    sa, ss = np.array([0.05, 0.1, 0.2]), np.array([0.4, 0.35, 0.3])
    args = [("homogeneous", sa, ss, 0.3),
            ("grid", sa * 4, ss * 4, 0.0, 8, 8, 8, _grid_density_values(), w2m)]
    return [MediumSpec(*a) for a in args], [JaxMediumSpec(*a) for a in args]


@pytest.fixture(scope="module")
def tables():
    specs, jspecs = _specs()
    return med.pack_mediums(specs), jmed.pack_mediums(jspecs)


def _rays(seed, spread=8.0):
    r = np.random.default_rng(seed)
    o = r.uniform(-spread, spread, (N, 3)).astype(np.float32)
    d = r.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    seg = r.uniform(0.0, 40.0, N).astype(np.float32)
    state = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    med_id = r.integers(-1, 2, N).astype(np.int32)
    return o, d, seg, state, med_id


def test_pack_mediums_equal(tables):
    mediums, jm = tables
    for key in ("kind", "sigma_a", "sigma_s", "sigma_t", "g", "w2m", "inv_max_density", "dims",
                "density"):
        assert np.array_equal(mediums[key].numpy(), np.asarray(jm[key])), key
    assert mediums["n"] == jm["n"] == 2


@pytest.mark.parametrize("g", [0.0, 0.5, -0.3])
def test_phase_and_hg_sample(g):
    r = np.random.default_rng(1)
    wo = r.normal(size=(N, 3))
    wo = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(np.float32)
    u = r.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    cos = r.uniform(-1.0, 1.0, N).astype(np.float32)
    gt = torch.tensor(g, dtype=torch.float32)
    jg = jnp.float32(g)
    _close(med.phase_hg(torch.as_tensor(cos), gt), jmed.phase_hg(jnp.asarray(cos), jg))
    wi, p = med.hg_sample(torch.as_tensor(wo), gt, torch.as_tensor(u))
    jwi, jp = jmed.hg_sample(jnp.asarray(wo), jg, jnp.asarray(u))
    _close(p, jp)
    # wi's components are sums of products near cancellation; 2e-6 absolute
    # is a few ulp of the unit vector
    np.testing.assert_allclose(wi.numpy(), np.asarray(jwi), rtol=0, atol=2e-6)
    assert np.allclose(np.linalg.norm(wi.numpy(), axis=-1), 1.0, atol=1e-5)


def test_rng_chain_bit_equal():
    r = np.random.default_rng(2)
    state = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    mask = r.uniform(size=N) < 0.5
    s, js = torch.as_tensor(state.astype(np.int64)), jnp.asarray(state)
    for _ in range(4):
        s, u = med._next_u(s)
        js, ju = jmed._next_u(js)
        assert np.array_equal(s.numpy(), np.asarray(js).astype(np.int64))
        assert np.array_equal(u.numpy(), np.asarray(ju))
    s, u = med._next_u_masked(s, torch.as_tensor(mask))
    js, ju = jmed._next_u_masked(js, jnp.asarray(mask))
    assert np.array_equal(s.numpy(), np.asarray(js).astype(np.int64))
    assert np.array_equal(u.numpy(), np.asarray(ju))


def test_grid_density(tables):
    mediums, jm = tables
    p = np.random.default_rng(3).uniform(-0.1, 1.1, (N, 3)).astype(np.float32)
    ids = np.ones(N, np.int32)
    d = med._grid_density(mediums, torch.as_tensor(ids.astype(np.int64)), torch.as_tensor(p))
    jd = jmed._grid_density(jm, jnp.asarray(ids), jnp.asarray(p))
    _close(d, jd)
    assert float(d.max()) > 0.3 and float(d.min()) == 0.0


def test_unit_box_interval():
    o, d, seg, _, _ = _rays(4, spread=1.5)
    ok, tmin, tmax = med._unit_box_interval(*(torch.as_tensor(a) for a in (o, d, seg)))
    jok, jtmin, jtmax = jmed._unit_box_interval(*(jnp.asarray(a) for a in (o, d, seg)))
    assert np.array_equal(ok.numpy(), np.asarray(jok)) and 0.05 < ok.numpy().mean() < 0.95
    _close(tmin, jtmin)
    _close(tmax, jtmax)


def _both(fn_t, fn_j, tables, seed, spread):
    mediums, jm = tables
    o, d, seg, state, med_id = _rays(seed, spread)
    work = {}
    out = fn_t(mediums, torch.as_tensor(med_id.astype(np.int64)), torch.as_tensor(o),
               torch.as_tensor(d), torch.as_tensor(seg), torch.as_tensor(state.astype(np.int64)),
               work=work)
    jout = fn_j(jm, jnp.asarray(med_id), jnp.asarray(o), jnp.asarray(d), jnp.asarray(seg),
                jnp.asarray(state))
    return out, jout, med_id, work


@pytest.mark.parametrize("spread", [1.0, 8.0], ids=["near-grid", "wide"])
def test_medium_sample(tables, spread):
    """World points near the grid's box (its [0,1]^3 maps to ~12 x 9 x 7
    units about the origin) and far from it; both media and vacuum."""
    (beta, sampled, t, state), (jbeta, jsampled, jt, jstate), med_id, work = _both(
        med.medium_sample, jmed.medium_sample, tables, 5, spread
    )
    assert np.array_equal(state.numpy(), np.asarray(jstate).astype(np.int64))
    assert np.array_equal(sampled.numpy(), np.asarray(jsampled))
    _close(beta, jbeta)
    _close(t, jt, atol=1e-5)
    for m in (0, 1):
        assert 0.01 < sampled.numpy()[med_id == m].mean() < 0.99
    assert float(work["track"]) > 100


@pytest.mark.parametrize("spread", [1.0, 8.0], ids=["near-grid", "wide"])
def test_medium_tr(tables, spread):
    (tr, state), (jtr, jstate), med_id, work = _both(
        med.medium_tr, jmed.medium_tr, tables, 6, spread
    )
    assert np.array_equal(state.numpy(), np.asarray(jstate).astype(np.int64))
    # ratio tracking multiplies up to tens of factors: a few ulp each
    np.testing.assert_allclose(tr.numpy(), np.asarray(jtr), rtol=4e-6, atol=1e-7)
    grid = tr.numpy()[med_id == 1, 0]
    assert ((grid > 0.0) & (grid < 1.0)).any()
    assert (grid == 0.0).any() or spread > 1.0  # roulette kills near the grid
    assert float(work["track"]) > 100


def _fog_scene(tmp_path, kind):
    if kind == "grid_fog":
        return write_grid_fog_scene(str(tmp_path), n=8, xres=64, yres=32, max_depth=3,
                                    sigma_scale=0.6)
    return write_fog_scene(str(tmp_path), area_light=kind == "fog_area",
                           base=str(SAMPLES / "scene_fog.json"), medium=THIN_FOG)


@pytest.mark.parametrize("kind", ["fog", "fog_area", "grid_fog"])
def test_pack_volpath_equal(tmp_path, kind):
    path = _fog_scene(tmp_path, kind)
    jjob = jax_load_scene(path)
    ctx = SceneCtx(jjob.scene)
    jpacked = jvmk.pack_volpath(ctx)
    vol = jpacked[8]
    job = load_scene(path)
    assert vmk.supports(job.scene, job.integrator, StratifiedSampler(job.sampler))
    packed = vmk.pack_volpath(job.scene, "cpu")
    assert np.array_equal(packed.table.numpy(), np.asarray(jpacked[0]))
    assert packed.cdf == vol.cdf and packed.pick_pdf == vol.pick_pdf
    assert packed.world_radius == vol.world_radius
    assert packed.scene.light_p == tuple(l.p for l in jpacked[5].lights)
    assert packed.scene.light_emit == tuple(l.emit for l in jpacked[5].lights)
    for k, l in enumerate(jpacked[5].lights):
        assert packed.light_kind[k] == l.kind
        if l.o2w is not None:
            assert packed.sph_o2w[k] == l.o2w and packed.sph_radius[k] == l.radius
            assert packed.sph_w2o[k] == tuple(l.w2o[i] for i in (0, 1, 2, 4, 5, 6, 8, 9, 10))
    m = packed.medium
    mc = vol.medium
    for key in ("sigma_a", "sigma_s", "sigma_t"):
        assert tuple(m[key][0].tolist()) == getattr(mc, key), key
    assert float(m["g"][0]) == mc.g
    assert packed.grid == (mc.grid is not None)
    if packed.grid:
        gr = mc.grid
        assert tuple(m["dims"][0].tolist()) == (gr.nz, gr.ny, gr.nx)
        assert tuple(m["w2m"][0, :3, :4].reshape(-1).tolist()) == gr.w2m
        assert float(m["inv_max_density"][0]) == gr.inv_max
        nz, ny, nx = gr.nz, gr.ny, gr.nx
        assert np.array_equal(m["density"][0].numpy(),
                              np.asarray(ctx.mediums["density"])[0, :nz, :ny, :nx])


def test_sample_li_and_power(tmp_path):
    """A point light and a sphere light, each sampled from seeded points."""
    path = _fog_scene(tmp_path, "fog_area")
    jl = jax_load_scene(path).scene.lights
    job = load_scene(path)
    pw = lights.power(job.scene.lights)
    assert np.array_equal(pw, np.asarray(jlights.power(jl)))
    packed = vmk.pack_volpath(job.scene, "cpu")
    table = lights.light_table(packed.light_kind, packed.scene.light_p, packed.scene.light_emit,
                               packed.sph_o2w, packed.sph_w2o, packed.sph_radius, "cpu")
    r = np.random.default_rng(7)
    p = r.uniform([25.0, -6.0, -4.0], [40.0, 6.0, 4.0], (N, 3)).astype(np.float32)
    u = r.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    idx = r.integers(2, 4, N).astype(np.int32)  # the third point light, the sphere light
    wi, li, pdf, pl, delta = lights.sample_li(
        table, torch.as_tensor(idx.astype(np.int64)), *torch.as_tensor(p).unbind(-1),
        *torch.as_tensor(u).unbind(-1),
    )
    js = jlights.sample_li(jl, [], jnp.asarray(idx), jnp.asarray(p), jnp.asarray(u))
    np.testing.assert_allclose(torch.stack(wi, -1).numpy(), np.asarray(js.wi), rtol=0, atol=2e-6)
    np.testing.assert_allclose(torch.stack(pl, -1).numpy(), np.asarray(js.p_light), rtol=1e-6,
                               atol=2e-6)
    # the area pdf, d^2 / |cos|, divides by a cosine that cancels near the
    # sphere's silhouette: compare where |cos| > 0.05
    _close(torch.stack(li, -1), js.li)
    ok = (idx == 2) | (np.asarray(js.pdf) < 400.0 * np.square(p - np.asarray(js.p_light)).sum(-1))
    np.testing.assert_allclose(pdf.numpy()[ok], np.asarray(js.pdf)[ok], rtol=1e-5)
    assert np.array_equal(delta.numpy(), idx == 2)
    assert (idx == 3).sum() > N / 3 and ok.mean() > 0.9


# ---- the single-scatter oracles of tests/test_furnace.py ----

FAR_TRIANGLE = "v 1000 -1 -1\nv 1000 1 -1\nv 1000 0 1\nf 1 2 3\n"


def _oracle_job(tmp_path, sigma_a, sigma_s, g):
    """The fixture reduced to one far triangle across the x axis (the JAX
    oracle's sphere at x = 1000 is outside the kernel's subset; either way
    the medium leaves e^-500 of the ray at t = 1000), a 10-unit point light
    at (5, 3, 0), Volpath at depth 1 in a homogeneous camera medium of
    equal-channel coefficients (the schema's presets have none)."""
    cfg = json.loads((SAMPLES / "scene.json").read_text())
    (tmp_path / "tri.obj").write_text(FAR_TRIANGLE)
    cfg["objs"] = [{"obj_name": "tri", "filename": "tri.obj"}]
    cfg["Aggregate"] = {"primitives": [
        {"primitive_type": "triangle", "obj_name": "tri", "material_name": "mat_matte"}
    ]}
    cfg["lights"] = [
        {"light_type": "point", "spectrum": {"values": [10.0, 10.0, 10.0]},
         "world_pos": [5.0, 3.0, 0.0]}
    ]
    cfg["Integrator"] = {"integrator_type": "Volpath", "max_depth": 1}
    cfg["Camera"]["medium"] = {"medium_type": "Homogeneous", "g": g}
    (tmp_path / "s.json").write_text(json.dumps(cfg))
    job = load_scene(str(tmp_path / "s.json"))
    job.scene.mediums[0] = MediumSpec("homogeneous", np.full(3, sigma_a), np.full(3, sigma_s), g)
    return job


@pytest.mark.parametrize("sigma_a,sigma_s,g,tol", [(0.1, 0.4, 0.0, 0.04), (0.05, 0.45, 0.5, 0.05)],
                         ids=["isotropic", "hg-0.5"])
def test_single_scatter_oracle(tmp_path, sigma_a, sigma_s, g, tol):
    job = _oracle_job(tmp_path, sigma_a, sigma_s, g)
    packed = vmk.pack_volpath(job.scene, "cpu")
    n = 60000
    o = torch.zeros((n, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1)
    pid = torch.arange(n)
    L = vmk.vol_bounce_loop_reference(
        packed, o, d, torch.ones(n, dtype=torch.bool), pid, torch.zeros(n, dtype=torch.int64),
        StratifiedSampler(job.sampler, seed=11), job.integrator,
    ).numpy()
    assert np.isfinite(L).all()
    expect = _single_scatter_quadrature(
        np.zeros(3), np.array([1.0, 0.0, 0.0]), np.array([5.0, 3.0, 0.0]), 10.0, sigma_a,
        sigma_s, g,
    )
    mean = L.mean(axis=0)
    assert np.all(np.abs(mean - expect) < tol * expect), (mean, expect)


@pytest.mark.parametrize("integrator", ["path", "debug", "direct"])
def test_path_and_direct_kernels_still_reject_media_and_sphere_lights(tmp_path, integrator):
    """The loader takes Camera.medium and sphere lights for every
    integrator; only the Volpath kernel renders the medium: the path and
    direct kernels ignore it, as the JAX package's li_path and li_levels
    do, and answer as for the scene without it.  The Volpath and path
    kernels take the sphere light, the direct kernel rejects it."""
    mod = pmk if integrator == "path" else dmk
    for kind in ("fog", "fog_area"):
        job = load_scene(_fog_scene(tmp_path / kind, kind))
        sampler = StratifiedSampler(job.sampler)
        job.integrator.kind = integrator
        with_medium = mod.unsupported_feature(job.scene, job.integrator, sampler)
        job.scene.mediums, job.scene.camera_medium = [], -1
        reason = mod.unsupported_feature(job.scene, job.integrator, sampler)
        assert with_medium == reason
        if kind == "fog" or integrator == "path":
            assert reason is None
        else:
            assert "lights other than" in reason
