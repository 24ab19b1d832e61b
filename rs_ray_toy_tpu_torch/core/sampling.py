"""Light-selection distribution, warps and MIS weight (rs_ray_toy_tpu/core/sampling.py).

`Distribution1D` is built on the host in float64 (sampling.rs:10-127); the
Volpath kernel reads its CDF and per-entry pick pdfs cast to float32
(ops/volpath_megakernel.pack_volpath), and `sample_discrete_1d` picks from
its float32 device copy as the JAX package does (the SPPM photon
emission).  `power_heuristic` is the nf = ng = 1 form the kernels use.
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
