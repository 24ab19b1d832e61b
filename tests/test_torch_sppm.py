"""The SPPM render's plain PyTorch versions against the JAX package.

Scene: samples/scene_sppm.json at 64x36, 2 iterations of 2048 photons,
max_depth 3 (the port's kernels' plain versions run on the CPU).  The JAX
kernels run in interpret mode, each once per module, on the same inputs
carried over by interop.from_jax_sppm:

- the camera walk (K8's plain version) against JAX sppm_camera_mega_cam on
  JAX's Halton slot matrix, brute force and through the port's BVH: the
  bars of tests/test_megakernel.py:755-766, ld off by more than 1e-3
  relative on fewer than 0.5% of the pixels, the VP fields at rtol 2e-4 /
  atol 1e-5; valid and the material id equal on 99.5% of the pixels (the
  reference's Trowbridge-Reitz sampler makes a glossy bounce chaotic,
  ROADMAP Queue 3: one pixel of 2304 takes another path here);
- the photon walk (K9's) against JAX sppm_photon_mega on photons made
  from a numpy seed, half of them inside a cube so that every depth
  deposits: events equal on 99.5% of the photons (the same chaotic
  sampler);
- the deposit (K10's) against JAX deposit_mega on the JAX camera's VPs
  with seeded radii and seeded events around them plus the photon walk's:
  M equal, phi at rtol 1e-5 (both sum the same events in Morton order;
  JAX's sort is unstable and it sums per 8192-event chunk);
- the emission, the radius / tau update and the image against their JAX
  functions;
- the loader and the kernels' subset messages.
The whole render is held to JAX render_job in tests/test_torch_sppm_render.py.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators import sppm as jsppm
from rs_ray_toy_tpu.integrators.common import SceneCtx
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.ops import sppm_megakernel as jsmk
from rs_ray_toy_tpu.sampler.halton import HaltonSampler as JaxHalton
from rs_ray_toy_tpu.scene.loader import SamplerSpec as JaxSamplerSpec
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.integrators import sppm
from rs_ray_toy_tpu_torch.interop import camera_from_jax, from_jax_sppm
from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk
from rs_ray_toy_tpu_torch.render import make_sampler, select_kernel
from rs_ray_toy_tpu_torch.scene.gen import FOG_AREA_LIGHT
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
# several pytest workers share the host: cap torch's OpenMP threads
torch.set_num_threads(min(2, torch.get_num_threads()))
W, H, DEPTH, N_PH, IT = 64, 36, 3, 2048, 1
PUPIL_SAMPLES = 1 << 12
CUBES = np.array([[35.0, -5.5, 2.2], [36.0, 5.5, -0.5], [34.5, 0.0, -1.8]], np.float32)


def write_scene(tmp, edit=None, matte=False):
    cfg = json.loads((SAMPLES / "scene_sppm.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = W, H
    cfg["Integrator"].update(n_iters=2, photons_per_iter=N_PH, max_depth=DEPTH)
    if matte:
        for prim in cfg["Aggregate"]["primitives"]:
            prim["material_name"] = "mat_matte"
    if edit is not None:
        edit(cfg)
    shutil.copy(SAMPLES / "cube.obj", tmp)
    path = Path(tmp) / "sppm.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _photons(rng, n):
    """Seeded photons: half start inside the matte or the plastic cube
    (within its inscribed ball, so every depth hits its inner faces), half
    outside aimed at any cube.  Not inside the metal cube: there every
    bounce is the reference's chaotic Trowbridge-Reitz sample (ROADMAP
    Queue 3), and one such photon in nine takes another path.  Returns
    ro, rd, beta, active, u_rows as numpy float32 / bool."""
    inside = np.arange(n) < n // 2
    cube = CUBES[np.where(inside, rng.integers(0, 2, n), rng.integers(0, 3, n))]
    off = rng.normal(size=(n, 3))
    off *= (0.8 * rng.random((n, 1)) ** (1 / 3)) / np.linalg.norm(off, axis=-1, keepdims=True)
    outside = np.array([28.0, 0.0, 0.0]) + rng.uniform(-6.0, 6.0, (n, 3)) * [0.3, 1.0, 1.0]
    ro = np.where(inside[:, None], cube + off, outside)
    target = cube + rng.uniform(-0.9, 0.9, (n, 3))
    rd = np.where(inside[:, None], rng.normal(size=(n, 3)), target - ro)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    beta = rng.uniform(1.0, 50.0, (n, 3))
    active = rng.random(n) < 0.95
    u_rows = rng.random((3 * (DEPTH - 1), n))
    f32 = lambda a: a.astype(np.float32)
    return f32(ro), f32(rd), f32(beta), active, f32(u_rows)


class JaxSide:
    """The JAX package on the test scene; each kernel call made once."""

    def __init__(self, path):
        self.job = jax_load_scene(path)
        self.ctx = SceneCtx(self.job.scene)
        self.sampler = JaxHalton(JaxSamplerSpec(kind="halton", nsamp=2, sample_at_center=True),
                                 W, H, seed=0)
        self.cam = jpmk.pack_camera(JaxCamera(self.job.camera, self.job.film,
                                              pupil_samples=PUPIL_SAMPLES))
        assert jsmk.supports_sppm_camera(self.ctx, self.job.integrator, self.sampler)
        self.packed = jsmk.pack_sppm(self.ctx)
        self.resolved = jsmk.resolve_mat_tables(self.ctx)
        ys, xs = np.mgrid[0:H, 0:W]
        self.pxy = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
        self.pid = (ys * W + xs).ravel().astype(np.uint32)
        self.rng = np.random.default_rng(12)
        self._made = {}

    def _once(self, key, fn):
        if key not in self._made:
            self._made[key] = fn()
        return self._made[key]

    def camera(self):
        def run():
            pid = jnp.asarray(self.pid)
            s_idx = jnp.full((W * H,), IT, jnp.uint32)
            u = jpmk._halton_u(self.sampler, pid, s_idx, jsmk._sppm_slots(DEPTH, with_cam=True))
            ld, vp = jsmk.sppm_camera_mega_cam(
                self.ctx, self.packed, self.cam, jnp.asarray(self.pxy), pid,
                jnp.ones((W * H,), bool), jnp.uint32(IT), self.sampler, DEPTH, interpret=True,
            )
            return np.array(u), np.array(ld), vp

        return self._once("camera", run)

    def photons(self):
        def run():
            ph = _photons(self.rng, N_PH)
            ev = jsmk.sppm_photon_mega(self.packed, *(jnp.asarray(x) for x in ph), DEPTH,
                                       interpret=True)
            return ph, tuple(np.array(e) for e in ev)

        return self._once("photons", run)

    def deposit(self):
        def run():
            _, _, vp = self.camera()
            _, walk = self.photons()
            valid = np.asarray(vp.valid)
            radius = (0.4 + 0.8 * self.rng.random(W * H)).astype(np.float32)
            # 40 seeded events about each VP, out to 1.4 radii (some leave the grid)
            src = np.repeat(np.nonzero(valid)[0], 40)
            d = self.rng.normal(size=(src.size, 3))
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
            p = np.asarray(vp.p)[src] + d * (radius[src] * 1.4 * self.rng.random(src.size))[:, None]
            wi = self.rng.normal(size=(src.size, 3))
            wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
            beta = self.rng.uniform(0.1, 10.0, (src.size, 3))
            live = self.rng.random(src.size) < 0.9
            ev = tuple(np.concatenate([a.astype(b.dtype), b]) for a, b in
                       zip((p, wi, beta, live), walk))
            r = jnp.asarray(radius)
            jvalid = vp.valid & jnp.any(vp.beta > 0.0, axis=-1)
            lo = jnp.min(jnp.where(jvalid[:, None], vp.p - r[:, None], 3e38), axis=0)
            hi = jnp.max(jnp.where(jvalid[:, None], vp.p + r[:, None], -3e38), axis=0)
            phi, m = jsmk.deposit_mega(vp, r, self.resolved, *(jnp.asarray(x) for x in ev), lo,
                                       hi - lo, self.packed[3], self.packed[4], interpret=True)
            return radius, ev, np.array(phi), np.array(m)

        return self._once("deposit", run)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return JaxSide(write_scene(tmp_path_factory.mktemp("sppm")))


@pytest.mark.parametrize("geometry", ["brute", "bvh"])
def test_camera_walk_matches_jax_kernel(jax_side, geometry, tmp_path):
    js = jax_side
    u, ld_ref, vp_ref = js.camera()
    if geometry == "brute":
        packed = from_jax_sppm("cpu", packed=js.packed)["packed"]
    else:
        packed = smk.pack_sppm(load_scene(write_scene(tmp_path)).scene, "cpu", bvh=True)
        assert packed.bvh is not None
    ld, vp = smk.sppm_camera_mega_cam(packed, camera_from_jax(js.cam), torch.as_tensor(js.pxy),
                                      torch.as_tensor(u), DEPTH)
    ld = ld.numpy()
    assert np.isfinite(ld).all() and ld_ref.sum() > 1
    rel = np.abs(ld - ld_ref) / np.maximum(np.abs(ld_ref), 1e-3)
    assert float((rel.max(-1) > 1e-3).mean()) < 5e-3
    valid, valid_ref = vp.valid.numpy(), np.asarray(vp_ref.valid)
    assert (valid == valid_ref).mean() >= 0.995 and valid_ref.sum() > 30
    both = valid & valid_ref & (rel.max(-1) <= 1e-3)
    for fld in ("p", "wo", "beta", "dpdu", "ng"):
        np.testing.assert_allclose(getattr(vp, fld).numpy()[both],
                                   np.asarray(getattr(vp_ref, fld))[both], rtol=2e-4, atol=1e-5,
                                   err_msg=fld)
    assert (vp.mat.numpy()[both] == np.asarray(vp_ref.mat)[both]).all()


@pytest.mark.parametrize("geometry", ["brute", "bvh"])
def test_photon_walk_matches_jax_kernel(jax_side, geometry, tmp_path):
    js = jax_side
    ph, ev_ref = js.photons()
    if geometry == "brute":
        packed = from_jax_sppm("cpu", packed=js.packed)["packed"]
    else:
        packed = smk.pack_sppm(load_scene(write_scene(tmp_path)).scene, "cpu", bvh=True)
    ev = smk.sppm_photon_mega(packed, *(torch.as_tensor(x) for x in ph), DEPTH)
    live, live_ref = ev[3].numpy(), ev_ref[3]
    assert live.shape == live_ref.shape == ((DEPTH - 1) * N_PH,)
    assert live_ref.sum() > N_PH // 4  # the inside photons deposit at every depth
    same = (live == live_ref)
    for k in range(3):
        close = np.isclose(ev[k].numpy(), ev_ref[k], rtol=1e-4, atol=1e-5).all(-1)
        same &= close | ~live_ref
    per_photon = same.reshape(DEPTH - 1, N_PH).all(0)
    assert per_photon.mean() >= 0.995
    assert (ev[0].numpy()[~live] == 0).all()  # a dead event is zeros


def test_plain_walks_count_the_slot_values_they_read(jax_side):
    """work["slot"]: the camera walk reads the film and lens slots of every
    pixel and at least one light pick per VP, never more than its slot
    matrix; the photon walk reads three uniforms at each bounce that a
    live event follows, never more than its rows of active photons."""
    js = jax_side
    u, _, _ = js.camera()
    packed = from_jax_sppm("cpu", packed=js.packed)["packed"]
    work = {}
    _, vp = smk.sppm_camera_mega_cam_reference(packed, camera_from_jax(js.cam),
                                               torch.as_tensor(js.pxy), torch.as_tensor(u),
                                               DEPTH, work=work)
    n = W * H
    assert 4 * n + int(vp.valid.sum()) <= int(work["slot"]) < u.shape[0] * n
    ph, _ = js.photons()
    work = {}
    ev = smk.sppm_photon_mega_reference(packed, *(torch.as_tensor(x) for x in ph), DEPTH,
                                        work=work)
    assert 0 < 3 * int(ev[3].sum()) <= int(work["slot"]) <= 3 * (DEPTH - 1) * int(ph[3].sum())


def test_deposit_matches_jax_kernel(jax_side):
    js = jax_side
    _, _, vp_ref = js.camera()
    radius, ev, phi_ref, m_ref = js.deposit()
    conv = from_jax_sppm("cpu", vp=vp_ref, resolved=js.resolved, photons=ev)
    vp, r = conv["vp"], torch.as_tensor(radius)
    lo, diag = sppm.grid_bounds(vp, r)
    phi, m = smk.deposit_mega(vp, r, conv["resolved"], conv["photons"], lo, diag)
    assert m_ref.sum() > 1000 and (phi_ref > 0).any()
    assert np.array_equal(m.numpy(), m_ref)
    np.testing.assert_allclose(phi.numpy(), phi_ref, rtol=1e-5, atol=1e-6 * phi_ref.max())
    # the walk sums each VP's range in order, whatever the plain version's
    # chunking: the work counts are the pairs of the ranges
    work = {}
    smk.deposit_mega_reference(vp, r, conv["resolved"], conv["photons"], lo, diag, work=work)
    inp = smk.deposit_inputs(vp, r, conv["photons"], lo, diag)
    assert int(work["pair"]) == int((inp.end - inp.start).sum()) > 0


def test_grid_bounds_and_morton_match_jax(jax_side):
    _, _, vp_ref = jax_side.camera()
    vp = from_jax_sppm("cpu", vp=vp_ref)["vp"]
    r = torch.full((W * H,), 1.0)
    lo, diag = sppm.grid_bounds(vp, r)
    valid = np.asarray(vp_ref.valid)
    p = np.asarray(vp_ref.p)[valid]
    np.testing.assert_array_equal(lo.numpy(), (p - 1.0).min(0))
    np.testing.assert_array_equal(diag.numpy(), (p + 1.0).max(0) - (p - 1.0).min(0))
    c = np.random.default_rng(2).integers(0, 1024, (4096, 3))
    ref = np.asarray(jsmk.morton3(*(jnp.asarray(c[:, k]) for k in range(3))))
    assert np.array_equal(smk.morton3(torch.as_tensor(c)).numpy(), ref.astype(np.int64))


def test_emission_matches_jax(jax_side):
    js = jax_side
    hidx = (IT * N_PH + np.arange(N_PH)).astype(np.int32)
    ref = jsppm._emit_photons(js.ctx, js.ctx._power_distribution, jnp.asarray(hidx), DEPTH)
    lights = from_jax_sppm("cpu", packed=js.packed, power=js.ctx._power_distribution)["lights"]
    out = sppm.emit_photons(lights, torch.as_tensor(hidx.astype(np.int64)), DEPTH)
    ro, rd, beta, active, u_rows = (x.numpy() for x in out)
    assert np.array_equal(ro, np.asarray(ref[0]))  # the same light for every photon
    np.testing.assert_allclose(rd, np.asarray(ref[1]), rtol=0, atol=2e-6)
    np.testing.assert_allclose(beta, np.asarray(ref[2]), rtol=1e-5)
    assert np.array_equal(active, np.asarray(ref[3]))
    assert u_rows.shape == (3 * (DEPTH - 1), N_PH)
    np.testing.assert_allclose(u_rows, np.asarray(ref[4]), rtol=0, atol=3e-7)


def test_radius_tau_update_and_image_match_jax():
    rng = np.random.default_rng(4)
    n = 512
    f = lambda *s: rng.random(s).astype(np.float32)
    state = (1.0 + f(n), f(n, 3), 10.0 * f(n), f(n, 3))
    beta, phi = f(n, 3), 5.0 * f(n, 3)
    m = rng.integers(0, 4, n).astype(np.int32)
    jvp = jsppm.VisiblePoints(*(jnp.zeros((n, 3)),) * 2, jnp.asarray(beta), *(None,) * 6)
    ref = jsppm._radius_tau_update(jsppm.SPPMState(*map(jnp.asarray, state)), jvp,
                                   jnp.asarray(phi), jnp.asarray(m))
    pvp = smk.VisiblePoints(None, None, torch.as_tensor(beta), *(None,) * 4)
    out = sppm.radius_tau_update(sppm.SPPMState(*map(torch.as_tensor, state)), pvp,
                                 torch.as_tensor(phi), torch.as_tensor(m))
    for a, b in zip(out, from_jax_sppm("cpu", state=ref)["state"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    img = sppm.sppm_image(out, 2, N_PH, 16, 32)
    img_ref = jsppm._sppm_image(ref, 2, N_PH, 16, 32)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_ref), rtol=1e-6)


def _edit(**integrator):
    def edit(cfg):
        cfg["Integrator"].update(integrator)

    return edit


def _add(section, key, value):
    def edit(cfg):
        if isinstance(cfg[section], list):
            cfg[section].append(value)
        else:
            cfg[section][key] = value

    return edit


def _sphere(cfg):
    cfg["Aggregate"]["primitives"].append(
        {"primitive_type": "sphere", "material_name": "mat_matte", "radius": 1.0})


UNSUPPORTED = {
    "sphere primitives": _sphere,
    "lights other than up to 8 point lights": _add("lights", None, FOG_AREA_LIGHT),
    "max_depth 1 outside 2..15": _edit(max_depth=1),
    "max_depth 16 outside 2..15": _edit(max_depth=16),
    # a smooth mesh (the SPPM kernels shade flat)
    "smooth shading": lambda cfg: (
        cfg["objs"].append({"obj_name": "ball", "filename": str(SAMPLES / "sphere_smooth.obj")}),
        cfg["Aggregate"]["primitives"].append({"primitive_type": "triangle", "obj_name": "ball",
                                               "material_name": "mat_matte"})),
}


@pytest.mark.parametrize("feature", sorted(UNSUPPORTED))
def test_unsupported_features_raise(tmp_path, feature):
    """At load or where the render picks its kernels, never silently."""
    path = write_scene(tmp_path, UNSUPPORTED[feature])
    with pytest.raises(NotImplementedError, match=feature):
        job = load_scene(path)
        select_kernel(job, make_sampler(job))


def test_loader_reads_the_sppm_block():
    job = load_scene(str(SAMPLES / "scene_sppm.json"))
    spec = job.integrator
    assert (spec.kind, spec.max_depth, spec.radius, spec.n_iters) == ("sppm", 3, 1.0, 4)
    assert spec.photons_per_iter == 1 << 17 and spec.write_freq == 1 << 31
    assert job.sampler.kind == "halton" and job.sampler.sample_at_center
    assert smk.supports(job.scene, spec)
    sampler = make_sampler(job)
    assert (sampler.spp, sampler.sample_at_center) == (4, True)
    jjob = jax_load_scene(str(SAMPLES / "scene_sppm.json"))
    for key in ("kind", "max_depth", "radius", "n_iters", "photons_per_iter", "write_freq"):
        assert getattr(spec, key) == getattr(jjob.integrator, key), key
