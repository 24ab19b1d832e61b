"""Participating media on flat tensors (rs_ray_toy_tpu/scene/medium.py).

The medium table is a dict of tensors (`pack_mediums`); each ray carries a
medium id (-1 = vacuum).  Homogeneous media use the closed-form
Beer-Lambert transmittance and channel-stratified distance sampling
(medium/homogeneous.rs:34-85); grid media run ratio tracking for the
transmittance and delta tracking for sampling (medium/grid.rs:119-207),
per ray, drawing from a hashed RNG chain that only the lanes still
walking advance (`_next_u_masked`).

These are the plain building blocks of the Volpath kernel's plain version
(ops/volpath_megakernel.py) and follow the JAX module expression by
expression, so that the chains are bit-equal and the floats agree to the
ulp.  The tracking loops run until every lane has left its segment, as the
JAX loops do: delta and ratio tracking end with probability one, so the
JAX package's `_MAX_TRACK_STEPS` bound is unused there and here.  A lane
whose position is NaN leaves at once (the `t < t_max` test fails), where
the JAX loop would never end.
"""

import numpy as np
import torch

from ..config import DTYPE, PI
from ..core import rng

MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1
INV_4_PI = 1.0 / (4.0 * PI)
_CHAIN_STEP = 0x9E3779B9


def pack_mediums(specs, device="cpu"):
    """Medium table on `device`: kind (M,), sigma_a / sigma_s / sigma_t
    (M, 3), g (M,), w2m (M, 4, 4), inv_max_density (M,), dims (M, 3) as
    (nz, ny, nx) and density (M, nz, ny, nx) zero-padded to the largest
    grid; `n` the count.  float32 as in the JAX package."""
    m = max(len(specs), 1)
    kind = np.zeros(m, np.int32)
    sigma_a = np.zeros((m, 3), np.float32)
    sigma_s = np.zeros((m, 3), np.float32)
    g = np.zeros(m, np.float32)
    w2m = np.tile(np.eye(4, dtype=np.float32), (m, 1, 1))
    inv_max = np.ones(m, np.float32)
    dims = np.ones((m, 3), np.int32)
    grids = []
    for i, s in enumerate(specs):
        kind[i] = MEDIUM_GRID if s.kind == "grid" else MEDIUM_HOMOGENEOUS
        sigma_a[i] = s.sigma_a
        sigma_s[i] = s.sigma_s
        g[i] = s.g
        if s.kind == "grid":
            w2m[i] = s.world_to_medium
            d = np.asarray(s.density, np.float32)
            dims[i] = (s.nz, s.ny, s.nx)
            inv_max[i] = 1.0 / max(float(d.max()), 1e-20)
        else:
            d = np.zeros((1, 1, 1), np.float32)
        grids.append(d)
    shape = tuple(max(d.shape[k] for d in grids) if grids else 1 for k in range(3))
    density = np.zeros((m,) + shape, np.float32)
    for i, d in enumerate(grids):
        density[i, : d.shape[0], : d.shape[1], : d.shape[2]] = d
    t = lambda a: torch.as_tensor(a, device=device)
    return {
        "kind": t(kind), "sigma_a": t(sigma_a), "sigma_s": t(sigma_s),
        "sigma_t": t(sigma_a + sigma_s), "g": t(g), "w2m": t(w2m),
        "inv_max_density": t(inv_max), "dims": t(dims), "density": t(density),
        "n": len(specs),
    }


# ---- Henyey-Greenstein phase function (medium/mod.rs:12-57) ----


def phase_hg(cos_theta, g):
    """g: a float32 tensor (0-d or per ray), as the medium table holds it."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4_PI * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12
    )


def coordinate_system(x, y, z):
    """core/vec.coordinate_system on a unit vector: its two other axes."""
    use_x = torch.abs(x) > torch.abs(y)
    inv_a = 1.0 / torch.sqrt(torch.where(use_x, x * x + z * z, y * y + z * z))
    v2x = torch.where(use_x, -z, 0.0) * inv_a
    v2y = torch.where(use_x, 0.0, z) * inv_a
    v2z = torch.where(use_x, x, -y) * inv_a
    return (v2x, v2y, v2z), (y * v2z - z * v2y, z * v2x - x * v2z, x * v2y - y * v2x)


def hg_sample(wo, g, u):
    """Sample wi from HG around wo (N, 3) with u (N, 2); returns (wi, p).
    HenyeyGreenstein::sample_p, including the reference's phi = 2*pi*u[0]
    (u[1] is unused)."""
    u0 = u[..., 0]
    small_g = torch.abs(g) < 1e-3
    sq_den = 1.0 + g - 2.0 * g * u0
    sq = (1.0 - g * g) / torch.where(torch.abs(sq_den) < 1e-9, 1e-9, sq_den)
    g2_den = torch.where(torch.abs(g) < 1e-9, 1e-9, 2.0 * g)
    cos_theta = torch.where(small_g, 1.0 - 2.0 * u0, -(1.0 + g * g - sq * sq) / g2_den)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * PI * u0
    wx, wy, wz = wo.unbind(-1)
    (v1x, v1y, v1z), (v2x, v2y, v2z) = coordinate_system(wx, wy, wz)
    cp = sin_theta * torch.cos(phi)
    sp = sin_theta * torch.sin(phi)
    wi = torch.stack(
        [v1x * cp + v2x * sp + wx * cos_theta,
         v1y * cp + v2y * sp + wy * cos_theta,
         v1z * cp + v2z * sp + wz * cos_theta],
        dim=-1,
    )
    return wi, phase_hg(cos_theta, g)


# ---- per-ray RNG chain for the medium draws ----


def _to_u(state):
    return (state >> 8).to(torch.int32).to(DTYPE) * (2.0**-24)


def _next_u(state):
    """Advance every lane's chain; (new state, uniform in [0, 1))."""
    state = rng.hash_u32(state ^ _CHAIN_STEP)
    return state, _to_u(state)


def _next_u_masked(state, mask):
    """_next_u advancing only the lanes in `mask` (grid.rs draws per ray,
    sequentially: a lane that has left its loop draws nothing more)."""
    ns = rng.hash_u32(state ^ _CHAIN_STEP)
    return torch.where(mask, ns, state), _to_u(ns)


def _grid_density(mediums, med_id, p):
    """Trilinear density at medium-space points p (N, 3) in [0,1]^3
    (grid.rs:80-117): texel centres at (i + 0.5) / n, zero outside."""
    dims = mediums["dims"][med_id]
    nz, ny, nx = dims.unbind(-1)
    dens = mediums["density"]
    ps = torch.stack(
        [p[..., 0] * nx.to(DTYPE) - 0.5, p[..., 1] * ny.to(DTYPE) - 0.5,
         p[..., 2] * nz.to(DTYPE) - 0.5],
        dim=-1,
    )
    pf = torch.floor(ps)
    d = ps - pf
    pi = pf.to(torch.int64)

    def texel(ox, oy, oz):
        x, y, z = pi[..., 0] + ox, pi[..., 1] + oy, pi[..., 2] + oz
        inside = (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) & (z < nz)
        v = dens[
            med_id,
            z.clamp(0, dens.shape[1] - 1),
            y.clamp(0, dens.shape[2] - 1),
            x.clamp(0, dens.shape[3] - 1),
        ]
        return torch.where(inside, v, 0.0)

    dx, dy, dz = d.unbind(-1)
    d00 = texel(0, 0, 0) * (1 - dx) + texel(1, 0, 0) * dx
    d10 = texel(0, 1, 0) * (1 - dx) + texel(1, 1, 0) * dx
    d01 = texel(0, 0, 1) * (1 - dx) + texel(1, 0, 1) * dx
    d11 = texel(0, 1, 1) * (1 - dx) + texel(1, 1, 1) * dx
    d0 = d00 * (1 - dy) + d10 * dy
    d1 = d01 * (1 - dy) + d11 * dy
    return d0 * (1 - dz) + d1 * dz


def _unit_box_interval(o, d, seg_len):
    """Ray against [0,1]^3 over [0, seg_len] (grid.rs tr / sample
    preamble); d unit length.  Returns (overlap, t_min, t_max)."""
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)
    t0 = (0.0 - o) * inv
    t1 = (1.0 - o) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    tmin = torch.clamp(tn, min=0.0)
    tmax = torch.minimum(tf, seg_len)
    return tmin <= tmax, tmin, tmax


def _to_medium(mediums, mid, o, d_unit, seg_len):
    """The segment in medium space: origin, unit direction, the world to
    medium length scale, and the [0,1]^3 overlap."""
    w2m = mediums["w2m"][mid]
    m = w2m[:, :3, :3]
    om = torch.stack(
        [m[:, k, 0] * o[:, 0] + m[:, k, 1] * o[:, 1] + m[:, k, 2] * o[:, 2] + w2m[:, k, 3]
         for k in range(3)],
        dim=-1,
    )
    dm_raw = torch.stack(
        [m[:, k, 0] * d_unit[:, 0] + m[:, k, 1] * d_unit[:, 1] + m[:, k, 2] * d_unit[:, 2]
         for k in range(3)],
        dim=-1,
    )
    scale = torch.sqrt(dm_raw[:, 0] * dm_raw[:, 0] + dm_raw[:, 1] * dm_raw[:, 1]
                       + dm_raw[:, 2] * dm_raw[:, 2])
    dm = dm_raw / torch.clamp(scale, min=1e-20)[:, None]
    return om, dm, scale, _unit_box_interval(om, dm, seg_len * scale)


def _tally(work, taps):
    """work["track"] += the density taps of this tracking step."""
    if work is not None:
        work["track"] = work.get("track", 0) + taps.sum()


def medium_tr(mediums, med_id, o, d_unit, seg_len, rng_state, work=None):
    """Beam transmittance over [0, seg_len] (Medium::tr).  Returns (tr
    (N, 3), new state); 1 where med_id is -1.  `work`, when given, counts
    the density taps of the grid lanes' ratio tracking ("track")."""
    mid = torch.clamp(med_id, min=0)
    sigma_t = mediums["sigma_t"][mid]
    kind = mediums["kind"][mid]
    tr_h = torch.exp(-sigma_t * seg_len[:, None])

    om, dm, _, (okb, tmin, tmax) = _to_medium(mediums, mid, o, d_unit, seg_len)
    st = torch.clamp(sigma_t[:, 0], min=1e-20)
    inv_max = mediums["inv_max_density"][mid]
    alive = (kind == MEDIUM_GRID) & (med_id >= 0) & okb
    t = torch.where(alive, tmin, torch.inf)
    tr = torch.ones_like(seg_len)
    state = rng_state
    while bool(alive.any()):
        state, u1 = _next_u_masked(state, alive)
        t = torch.where(alive, t - torch.log(torch.clamp(1.0 - u1, min=1e-12)) * inv_max / st, t)
        inside = alive & (t < tmax)
        _tally(work, inside)
        dens = _grid_density(mediums, mid, om + dm * t[:, None])
        tr = torch.where(inside, tr * (1.0 - torch.clamp(dens * inv_max, min=0.0)), tr)
        # Russian roulette (grid.rs:147-156): draws only when tr < 0.1
        rr = inside & (tr < 0.1)
        state, u2 = _next_u_masked(state, rr)
        q = torch.clamp(1.0 - tr, min=0.05)
        killed = rr & (u2 < q)
        tr = torch.where(killed, 0.0, torch.where(rr, tr / (1.0 - q), tr))
        alive = inside & ~killed
    tr = torch.where((kind == MEDIUM_GRID)[:, None], tr[:, None], tr_h)
    return torch.where((med_id >= 0)[:, None], tr, 1.0), state


def medium_sample(mediums, med_id, o, d_unit, seg_len, rng_state, work=None):
    """Medium::sample over [0, seg_len]: maybe a scattering vertex.
    Returns (beta (N, 3), sampled (N,), t (N,), new state); `work` as in
    medium_tr, for delta tracking."""
    mid = torch.clamp(med_id, min=0)
    kind = mediums["kind"][mid]
    sigma_t = mediums["sigma_t"][mid]
    sigma_s = mediums["sigma_s"][mid]
    grid = kind == MEDIUM_GRID

    # homogeneous (homogeneous.rs:38-85): two draws, the channel and the
    # distance; grid lanes draw only their tracking steps
    rng_state, u_ch = _next_u_masked(rng_state, ~grid)
    rng_state, u_d = _next_u_masked(rng_state, ~grid)
    channel = torch.clamp((u_ch * 3).to(torch.int64), max=2)
    st_ch = torch.gather(sigma_t, 1, channel[:, None])[:, 0]
    dist = -torch.log(torch.clamp(1.0 - u_d, min=1e-12)) / torch.clamp(st_ch, min=1e-20)
    t_h = torch.minimum(dist, seg_len)
    sampled_h = dist < seg_len
    tr_h = torch.exp(-sigma_t * t_h[:, None])
    density = torch.where(sampled_h[:, None], sigma_t * tr_h, tr_h)
    pdf = (density[:, 0] + density[:, 1] + density[:, 2]) / 3.0
    pdf = torch.where(pdf == 0.0, 1.0, pdf)
    beta_h = torch.where(sampled_h[:, None], tr_h * sigma_s, tr_h) / pdf[:, None]

    # grid delta tracking (grid.rs:162-207)
    om, dm, scale, (okb, tmin, tmax) = _to_medium(mediums, mid, o, d_unit, seg_len)
    st = torch.clamp(sigma_t[:, 0], min=1e-20)
    inv_max = mediums["inv_max_density"][mid]
    alive = grid & (med_id >= 0) & okb
    t = torch.where(alive, tmin, torch.inf)
    hit = torch.zeros_like(alive)
    while bool(alive.any()):
        rng_state, u1 = _next_u_masked(rng_state, alive)
        t_new = t - torch.log(torch.clamp(1.0 - u1, min=1e-12)) * inv_max / st
        inside = alive & (t_new < tmax)
        _tally(work, inside)
        dens = _grid_density(mediums, mid, om + dm * t_new[:, None])
        # the acceptance draw only inside the segment (grid.rs:169-176)
        rng_state, u2 = _next_u_masked(rng_state, inside)
        interact = inside & (dens * inv_max > u2)
        hit = hit | interact
        t = torch.where(alive, t_new, t)
        alive = inside & ~interact
    beta_g = torch.where(hit[:, None], sigma_s / torch.clamp(sigma_t, min=1e-20), 1.0)

    beta = torch.where(grid[:, None], beta_g, beta_h)
    sampled = torch.where(grid, hit, sampled_h)
    # grid t is in medium units; back to the world's
    t_out = torch.where(grid, t / torch.clamp(scale, min=1e-20), t_h)
    in_medium = med_id >= 0
    beta = torch.where(in_medium[:, None], beta, 1.0)
    sampled = sampled & in_medium
    return beta, sampled, torch.where(sampled, t_out, seg_len), rng_state
