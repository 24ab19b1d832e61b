"""Light-selection distribution and MIS weight (rs_ray_toy_tpu/core/sampling.py).

`Distribution1D` is built on the host in float64 (sampling.rs:10-127); the
Volpath kernel reads its CDF and per-entry pick pdfs cast to float32
(ops/volpath_megakernel.pack_volpath).  `power_heuristic` is the nf = ng
= 1 form the kernels use.
"""

import numpy as np
import torch


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


def power_heuristic(f_pdf, g_pdf):
    """(sampling.rs:324-328) with one sample of each strategy."""
    f2 = f_pdf * f_pdf
    denom = f2 + g_pdf * g_pdf
    return torch.where(denom > 0.0, f2 / torch.clamp(denom, min=1e-30), 0.0)
