"""RealisticCamera: lens-element tracing (rs_ray_toy_tpu/camera/realistic.py).

- The lens table build and the thick-lens focus solve run on the host in
  float64 (camera.rs:66-135, 322-379).
- The exit-pupil bounds (64 radial bins, each over n_samples rear-plane
  (0,2)-sequence points, camera.rs:123-133, 442-488) are traced in
  float64 too, on the camera's `device`, since the default is 64 x 2^20
  lens traces.  Construction is set-up, never part of a timed render.
- `generate_rays` (camera.rs:534-580) is float32 torch on its inputs'
  device.  The render's main path does not call it: the path kernel
  generates its own rays (ops/path_megakernel._raygen).

One trace routine serves every precision: it takes (..., 3) tensors of
any dtype.  Lens space flips z relative to camera space.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..config import DTYPE
from ..core.lowdiscrepancy import radical_inverse_base


@dataclass
class LensSystem:
    """Element tables in lens_data row order: index 0 is nearest the
    scene, the last is nearest the film.  Meters."""

    curvature: np.ndarray  # (E,)
    thickness: np.ndarray  # (E,)
    eta: np.ndarray  # (E,)
    aperture_radius: np.ndarray  # (E,)

    @property
    def rear_z(self):
        return float(self.thickness[-1])

    @property
    def front_z(self):
        return float(np.sum(self.thickness))

    @property
    def rear_radius(self):
        return float(self.aperture_radius[-1])


def build_lens_system(lens_data, aperture_diameter_mm):
    """(camera.rs:77-98): rows of (curvature, thickness, eta, aperture
    diameter) in mm -> meters; the stop row clamps to aperture_diameter."""
    rows = np.asarray(lens_data, np.float64).reshape(-1, 4)
    aperture = rows[:, 3].copy()
    stop = rows[:, 0] == 0.0
    aperture[stop & (aperture_diameter_mm <= rows[:, 3])] = aperture_diameter_mm
    return LensSystem(
        curvature=rows[:, 0] * 0.001,
        thickness=rows[:, 1] * 0.001,
        eta=rows[:, 2],
        aperture_radius=aperture * 0.001 / 2.0,
    )


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _zflip(v):
    return v * torch.tensor([1.0, 1.0, -1.0], dtype=v.dtype, device=v.device)


def _refract_dir(wi, n, eta):
    """Batched refract (reflection.rs:122-134); wi points away from the
    surface."""
    cos_i = _dot(n, wi)
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta * eta * sin2_i
    ok = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = -wi * eta + n * (eta * cos_i - cos_t)[..., None]
    return wt, ok


def _sphere_element_t(o, d, radius, z_center):
    """(camera.rs:220-253): ray vs one spherical lens element."""
    oc = o - torch.tensor([0.0, 0.0, z_center], dtype=o.dtype, device=o.device)
    a = _dot(d, d)
    b = 2.0 * _dot(d, oc)
    c = _dot(oc, oc) - radius * radius
    discrim = b * b - 4 * a * c
    ok = discrim >= 0.0
    root = torch.sqrt(torch.clamp(discrim, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = q / a
    t1 = c / torch.where(q == 0.0, torch.ones_like(q), q)
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    use_closer = (d[..., 2] > 0.0) != (radius < 0.0)
    t = torch.where(use_closer, lo, hi)
    ok = ok & (t >= 0.0)
    p = oc + d * t[..., None]
    n = p / torch.sqrt(torch.clamp(_dot(p, p), min=1e-30))[..., None]
    flip = _dot(n, d) > 0.0  # faceforward(n, -d)
    n = torch.where(flip[..., None], -n, n)
    return t, n, ok


def _trace(lens, o, d, steps, film_side):
    """Shared element walk; `steps` yields (i, element_z, eta_ratio).
    A stop passes film-side rays only while they head for the scene;
    scene-side rays cross it unconditionally."""
    o = _zflip(o)
    d = _zflip(d)
    alive = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    for i, element_z, eta_ratio in steps:
        radius = float(lens.curvature[i])
        if radius == 0.0:
            if film_side:
                ok = d[..., 2] < 0.0
                t = (element_z - o[..., 2]) / torch.where(ok, d[..., 2], -1.0)
            else:
                ok = torch.ones_like(alive)
                t = (element_z - o[..., 2]) / d[..., 2]
        else:
            t, n, ok = _sphere_element_t(o, d, radius, element_z + radius)
        p = o + d * t[..., None]
        r2 = p[..., 0] ** 2 + p[..., 1] ** 2
        ok = ok & (r2 < float(lens.aperture_radius[i]) ** 2)
        alive = alive & ok
        o = torch.where(alive[..., None], p, o)
        if radius != 0.0:
            wi = -d / torch.sqrt(torch.clamp(_dot(d, d), min=1e-30))[..., None]
            wt, rok = _refract_dir(wi, n, eta_ratio)
            alive = alive & rok
            d = torch.where(alive[..., None], wt, d)
    return _zflip(o), _zflip(d), alive


def trace_lenses_from_film(lens: LensSystem, o, d):
    """(camera.rs:156-219): film-side rays (camera space) through every
    element, rear to front.  Returns (o_out, d_out, alive)."""

    def steps():
        element_z = 0.0
        for i in reversed(range(len(lens.curvature))):
            element_z -= float(lens.thickness[i])
            eta_t = lens.eta[i - 1] if (i > 0 and lens.eta[i - 1] != 0.0) else 1.0
            yield i, element_z, float(lens.eta[i] / eta_t)

    return _trace(lens, o, d, steps(), film_side=True)


def trace_lenses_from_scene(lens: LensSystem, o, d):
    """(camera.rs:254-312): scene-side rays, front to rear."""

    def steps():
        element_z = -lens.front_z
        for i in range(len(lens.curvature)):
            eta_i = 1.0 if (i == 0 or lens.eta[i - 1] == 0.0) else lens.eta[i - 1]
            eta_t = lens.eta[i] if lens.eta[i] != 0.0 else 1.0
            yield i, element_z, float(eta_i / eta_t)
            element_z += float(lens.thickness[i])

    return _trace(lens, o, d, steps(), film_side=False)


def _cardinal_points(o_in, o_out, d_out):
    """(camera.rs:323-330)"""
    tf = -o_out[0] / d_out[0]
    fz = -(o_out[2] + tf * d_out[2])
    tp = (o_in[0] - o_out[0]) / d_out[0]
    pz = -(o_out[2] + tp * d_out[2])
    return pz, fz


def focus_thick_lens(lens: LensSystem, focus_distance, diagonal_m):
    """(camera.rs:331-379), host float64: the new rear thickness."""
    x = 0.001 * diagonal_m
    f64 = lambda v: torch.tensor([v], dtype=torch.float64)
    o = f64([x, 0.0, lens.front_z + 1.0])
    o_out, d_out, ok = trace_lenses_from_scene(lens, o, f64([0.0, 0.0, -1.0]))
    if not bool(ok[0]):
        raise RuntimeError("thick lens: scene-side ray blocked")
    pz0, fz0 = _cardinal_points(o[0].tolist(), o_out[0].tolist(), d_out[0].tolist())
    o = f64([x, 0.0, lens.rear_z - 1.0])
    o_out, d_out, ok = trace_lenses_from_film(lens, o, f64([0.0, 0.0, 1.0]))
    if not bool(ok[0]):
        raise RuntimeError("thick lens: film-side ray blocked")
    pz1, fz1 = _cardinal_points(o[0].tolist(), o_out[0].tolist(), d_out[0].tolist())

    f = fz0 - pz0
    z = -focus_distance
    c = (pz1 - z - pz0) * (pz1 - z - 4.0 * f - pz0)
    if c <= 0.0:
        raise RuntimeError(f"focus distance {focus_distance} too short for this lens")
    delta = 0.5 * (pz1 - z + pz0 - np.sqrt(c))
    return lens.thickness[-1] + delta


def bound_exit_pupil(lens, diagonal_m, n_bins=64, n_samples=1 << 20, device="cpu"):
    """(camera.rs:123-133, 442-488): per radial bin, the AABB of the rear
    plane points that a film ray survives, grown by the sample spacing.
    float64 on `device`.  Returns (n_bins, 4) [x0, y0, x1, y1] float32."""
    rear_r = lens.rear_radius
    proj = 1.5 * rear_r
    idx = np.arange(n_samples)
    f64 = dict(dtype=torch.float64, device=device)
    rx = torch.as_tensor(-proj + 2.0 * proj * radical_inverse_base(2, idx), **f64)
    ry = torch.as_tensor(-proj + 2.0 * proj * radical_inverse_base(3, idx), **f64)
    p_rear = torch.stack([rx, ry, torch.full_like(rx, lens.rear_z)], dim=-1)
    frac = (torch.arange(n_samples, **f64) + 0.5) / n_samples
    half_diag = diagonal_m / 2.0
    # sample-spacing expansion (camera.rs:484-487)
    expand = 2.0 * np.hypot(2 * proj, 2 * proj) / np.sqrt(n_samples)
    bounds = np.zeros((n_bins, 4), np.float32)
    for i in range(n_bins):
        r0 = i / n_bins * half_diag
        r1 = (i + 1) / n_bins * half_diag
        fx = r0 * (1.0 - frac) + r1 * frac
        o = torch.stack([fx, torch.zeros_like(fx), torch.zeros_like(fx)], dim=-1)
        _, _, alive = trace_lenses_from_film(lens, o, p_rear - o)
        if not bool(alive.any()):
            bounds[i] = (-proj, -proj, proj, proj)
            continue
        ax, ay = rx[alive], ry[alive]
        bounds[i] = (
            float(ax.min()) - expand,
            float(ay.min()) - expand,
            float(ax.max()) + expand,
            float(ay.max()) + expand,
        )
    return bounds


class RealisticCamera:
    """Host-built lens tables, pupil bounds and transforms; generate_rays
    runs on its inputs' device."""

    def __init__(self, spec, film, pupil_samples=1 << 20, pupil_bins=64, device="cpu"):
        self.spec = spec
        self.film = film
        self.diagonal_m = film.diagonal_mm * 0.001  # film.rs:178
        lens = build_lens_system(spec.lens_data, spec.aperture_diameter)
        # the thick-lens focus result is what sticks (camera.rs:110-121)
        lens.thickness[-1] = focus_thick_lens(lens, spec.focus_distance, self.diagonal_m)
        self.lens = lens
        self.exit_pupil_bounds = bound_exit_pupil(
            lens, self.diagonal_m, pupil_bins, pupil_samples, device
        )
        self.pupil_bins = pupil_bins
        self.cam_to_world = np.asarray(spec.cam_to_world.m, np.float32)
        # physical film extent (film.rs:200-208)
        aspect = film.yres / film.xres
        x = np.sqrt(self.diagonal_m**2 / (1.0 + aspect * aspect))
        self.extent = np.array([x, aspect * x])

    def bin_area(self, i):
        b = self.exit_pupil_bounds[i]
        return float((b[2] - b[0]) * (b[3] - b[1]))

    def generate_ray_differentials(self, p_film_raster, u_lens, spp=1):
        """(camera.rs:582-628; the JAX package's generate_ray_differentials):
        the rays of generate_rays and finite-difference differentials from
        film points shifted +0.05 px in x and in y through the same lens
        sample, scaled by 1 / sqrt(spp) (integrator/mod.rs:94-96); where
        a shifted trace dies its differential is the ray itself (the
        reference retries with -0.05).  Returns (o, d, weight, (rx_o,
        rx_d, ry_o, ry_d))."""
        o, d, w = self.generate_rays(p_film_raster, u_lens)
        eps = 0.05
        dev = p_film_raster.device
        ox, dx_, wx = self.generate_rays(
            p_film_raster + torch.tensor([eps, 0.0], dtype=DTYPE, device=dev), u_lens)
        oy, dy_, wy = self.generate_rays(
            p_film_raster + torch.tensor([0.0, eps], dtype=DTYPE, device=dev), u_lens)
        s = 1.0 / float(np.sqrt(max(spp, 1)))
        okx = (wx > 0.0)[:, None]
        oky = (wy > 0.0)[:, None]
        rx_o = torch.where(okx, o + (ox - o) / eps * s, o)
        rx_d = torch.where(okx, d + (dx_ - d) / eps * s, d)
        ry_o = torch.where(oky, o + (oy - o) / eps * s, o)
        ry_d = torch.where(oky, d + (dy_ - d) / eps * s, d)
        return o, d, w, (rx_o, rx_d, ry_o, ry_d)

    def generate_rays(self, p_film_raster, u_lens):
        """p_film_raster: (N, 2) raster film points (x right, y down);
        u_lens: (N, 2) in [0, 1)^2.  Returns (o_world, d_world, weight)."""
        dev = p_film_raster.device
        ext = torch.tensor(self.extent, dtype=DTYPE, device=dev)
        res = torch.tensor([self.film.xres, self.film.yres], dtype=DTYPE, device=dev)
        p_phys = (p_film_raster / res - 0.5) * ext
        # camera.rs:542 pFilm = (-p.x, p.y, 0)
        p_film = torch.stack(
            [-p_phys[..., 0], p_phys[..., 1], torch.zeros_like(p_phys[..., 0])], dim=-1
        )
        p_rear, pupil_area = self._sample_exit_pupil(p_film[..., :2], u_lens)
        d = p_rear - p_film
        o_out, d_out, alive = trace_lenses_from_film(self.lens, p_film, d)

        m = torch.tensor(self.cam_to_world, device=dev)
        o_world = o_out @ m[:3, :3].T + m[:3, 3]
        d_world = d_out @ m[:3, :3].T
        d_world = d_world / torch.clamp(
            torch.linalg.norm(d_world, dim=-1, keepdim=True), min=1e-30
        )
        # weight (camera.rs:569-579)
        dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-30)
        cos_theta = dn[..., 2]
        cos4 = (cos_theta * cos_theta) ** 2
        if self.spec.simple_weighting:
            weight = cos4 * pupil_area / self.bin_area(0)
        else:
            # left-to-right precedence cancels rear_z (docs/PARITY.md)
            shutter = self.spec.shutter_close - self.spec.shutter_open
            weight = shutter * (cos4 * pupil_area) / self.lens.rear_z * self.lens.rear_z
        weight = torch.where(alive, weight, 0.0)
        return o_world, d_world, weight.to(DTYPE)

    def _sample_exit_pupil(self, p_film_xy, u_lens):
        """(camera.rs:492-521) with PBRT's intended bin index
        floor(r_film / (diag/2) * n_bins) (docs/PARITY.md)."""
        bounds = torch.as_tensor(self.exit_pupil_bounds, device=p_film_xy.device)
        x, y = p_film_xy[..., 0], p_film_xy[..., 1]
        r_film = torch.sqrt(x * x + y * y)
        r_index = torch.clamp(
            (r_film / (self.diagonal_m / 2.0) * self.pupil_bins).to(torch.int64),
            0,
            self.pupil_bins - 1,
        )
        b = bounds[r_index]
        px = b[..., 0] + u_lens[..., 0] * (b[..., 2] - b[..., 0])
        py = b[..., 1] + u_lens[..., 1] * (b[..., 3] - b[..., 1])
        area = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
        nz = r_film != 0.0
        safe_r = torch.where(nz, r_film, 1.0)
        sin_t = torch.where(nz, y / safe_r, 0.0)
        cos_t = torch.where(nz, x / safe_r, 1.0)
        p_rear = torch.stack(
            [
                cos_t * px - sin_t * py,
                sin_t * px + cos_t * py,
                torch.full_like(px, self.lens.rear_z),
            ],
            dim=-1,
        )
        return p_rear, area
