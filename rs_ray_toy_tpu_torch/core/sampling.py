"""Light-selection and environment distributions, warps and MIS weight
(rs_ray_toy_tpu/core/sampling.py).

`Distribution1D` and `Distribution2D` are built on the host in float64
(sampling.rs:10-177); the Volpath kernel reads the 1D CDF and per-entry
pick pdfs cast to float32 (ops/volpath_megakernel.pack_volpath),
`sample_discrete_1d` picks from its float32 device copy as the JAX
package does (the SPPM photon emission), and `sample_continuous_2d` /
`pdf_2d` sample an environment's float32 device copy (lights/lights).  `power_heuristic` is the nf = ng = 1 form the kernels use.
The hemisphere warps take and return (N, 2) / (N, 3) tensors, as the
wavefront loop holds its vectors; `concentric_sample_disk` works on the
components, as the kernels' plain versions call it.
"""

import numpy as np
import torch

from ..config import PI


class Distribution1D:
    """Piecewise-constant 1D distribution: cdf[0] = 0, cdf[i] the
    normalised running sum, uniform when the integral is zero."""

    def __init__(self, func):
        func = np.asarray(func, dtype=np.float64)
        n = len(func)
        cdf = np.zeros(n + 1)
        cdf[1:] = np.cumsum(func) / n
        func_int = cdf[n]
        if func_int == 0.0:
            cdf[1:] = np.arange(1, n + 1) / n
        else:
            cdf[1:] /= func_int
        self.func = func
        self.cdf = cdf
        self.func_int = func_int
        self.n = n

    def pick_pdf(self):
        """Discrete pdf of each entry, func[i] / (func_int * n), float64."""
        if self.func_int > 0.0:
            return self.func / (self.func_int * self.n)
        return np.zeros(self.n)

    def as_device(self, device):
        """func, cdf and func_int as float32 tensors on `device`."""
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return {"func": f32(self.func), "cdf": f32(self.cdf), "func_int": f32(self.func_int)}


def sample_discrete_1d(dist, u):
    """Distribution1D::sample_discrete (sampling.rs:91-126) on the float32
    device copy `dist` (as_device): the last index with cdf[i] <= u, and
    its pdf func[i] / (func_int * n) in float32.  Returns (index, pdf)."""
    cdf, func, func_int = dist["cdf"], dist["func"], dist["func_int"]
    n = func.shape[0]
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0, n - 1)
    pdf = torch.where(func_int > 0.0, func[idx] / (func_int * n), 0.0)
    return idx, pdf


def sample_continuous_1d(dist, u):
    """Distribution1D::sample_continuous (sampling.rs:46-90) on the float32
    device copy: returns (x in [0, 1), pdf, index)."""
    cdf, func, func_int = dist["cdf"], dist["func"], dist["func_int"]
    n = func.shape[0]
    idx = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True) - 1, 0, n - 1)
    c0 = cdf[idx]
    dc = cdf[idx + 1] - c0
    du = torch.where(dc > 0.0, (u - c0) / torch.clamp(dc, min=1e-30), u - c0)
    pdf = torch.where(func_int > 0.0, func[idx] / torch.clamp(func_int, min=1e-30), 0.0)
    return (idx + du) / n, pdf, idx


class Distribution2D:
    """Conditional rows and their marginal (sampling.rs:130-177), float64:
    cond_func (nv, nu), cond_cdf (nv, nu + 1), cond_int (nv,), marginal a
    Distribution1D over cond_int."""

    def __init__(self, func, nu, nv):
        func = np.asarray(func, dtype=np.float64).reshape(nv, nu)
        cdf = np.zeros((nv, nu + 1))
        cdf[:, 1:] = np.cumsum(func, axis=1) / nu
        func_int = cdf[:, nu].copy()
        zero = func_int == 0.0
        cdf[zero, 1:] = np.arange(1, nu + 1) / nu
        cdf[~zero, 1:] /= func_int[~zero, None]
        self.cond_func = func
        self.cond_cdf = cdf
        self.cond_int = func_int
        self.marginal = Distribution1D(func_int)
        self.nu, self.nv = nu, nv

    def as_device(self, device):
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return {
            "cond_func": f32(self.cond_func),
            "cond_cdf": f32(self.cond_cdf),
            "cond_int": f32(self.cond_int),
            "marginal": self.marginal.as_device(device),
        }


def sample_continuous_2d(dist2, u0, u1):
    """Distribution2D::sample_continuous (sampling.rs:157-167) on the
    float32 device copy: returns ((x, y) in [0, 1)^2, pdf)."""
    d1, pdf1, v = sample_continuous_1d(dist2["marginal"], u1)
    cond_cdf = dist2["cond_cdf"][v]  # (N, nu + 1)
    nu = dist2["cond_func"].shape[1]
    # searchsorted along each row: the entries <= u
    idx = torch.clamp((cond_cdf <= u0[:, None]).sum(-1) - 1, 0, nu - 1)
    c0 = torch.gather(cond_cdf, 1, idx[:, None])[:, 0]
    c1 = torch.gather(cond_cdf, 1, (idx + 1)[:, None])[:, 0]
    dc = c1 - c0
    du = torch.where(dc > 0.0, (u0 - c0) / torch.clamp(dc, min=1e-30), u0 - c0)
    f = dist2["cond_func"][v, idx]
    cond_int = dist2["cond_int"][v]
    pdf0 = torch.where(cond_int > 0.0, f / torch.clamp(cond_int, min=1e-30), 0.0)
    return ((idx + du) / nu, d1), pdf0 * pdf1


def pdf_2d(dist2, x, y):
    """Distribution2D::pdf (sampling.rs:168-177) at (x, y) in [0, 1]^2."""
    nv, nu = dist2["cond_func"].shape
    iu = torch.clamp((x * nu).to(torch.int64), 0, nu - 1)
    iv = torch.clamp((y * nv).to(torch.int64), 0, nv - 1)
    m_int = dist2["marginal"]["func_int"]
    return dist2["cond_func"][iv, iu] / torch.clamp(m_int, min=1e-30)


def uniform_sample_sphere(u0, u1):
    """(sampling.rs:233-244): a uniform direction, as (x, y, z)."""
    z = 1.0 - 2.0 * u0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u1
    return r * torch.cos(phi), r * torch.sin(phi), z


def uniform_sample_hemisphere(u):
    """(sampling.rs:250-256): (N, 2) uniforms -> (N, 3) local directions."""
    z = u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def concentric_sample_disk(u0, u1):
    """sampling.rs:286-311, componentwise: returns (x, y)."""
    x = 2.0 * u0 - 1.0
    y = 2.0 * u1 - 1.0
    zero = (x == 0.0) & (y == 0.0)
    use_x = torch.abs(x) > torch.abs(y)
    safe_x = torch.where(x == 0.0, 1.0, x)
    safe_y = torch.where(y == 0.0, 1.0, y)
    r = torch.where(use_x, x, y)
    theta = torch.where(
        use_x, (PI / 4.0) * (y / safe_x), (PI / 2.0) - (PI / 4.0) * (x / safe_y)
    )
    dxo = torch.cos(theta) * r
    dyo = torch.sin(theta) * r
    return torch.where(zero, 0.0, dxo), torch.where(zero, 0.0, dyo)


def cosine_sample_hemisphere(u):
    """Malley's method (sampling.rs:273-278): (N, 2) -> (N, 3)."""
    x, y = concentric_sample_disk(u[..., 0], u[..., 1])
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return torch.stack([x, y, z], dim=-1)


def power_heuristic(f_pdf, g_pdf):
    """(sampling.rs:324-328) with one sample of each strategy."""
    f2 = f_pdf * f_pdf
    denom = f2 + g_pdf * g_pdf
    return torch.where(denom > 0.0, f2 / torch.clamp(denom, min=1e-30), 0.0)
