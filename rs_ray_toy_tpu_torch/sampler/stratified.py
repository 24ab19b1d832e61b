"""Counter-based stratified sampler (rs_ray_toy_tpu/sampler/stratified.py).

u(pixel_id, sample_index, dimension) in [0, 1): the sample index goes
through a per-(pixel, dimension) permutation of the strata, then is
jittered inside its stratum by a hashed uniform.  The permutation is
Kensler's for a power-of-two spp and, for any other count (a 3x3 or 5x3
grid), the JAX package's keyed cyclic rotation (x + key % n) % n on u32
values.

pixel_id and sample_index are integer tensors holding u32 values; `dim`
is a python int.  The result lies on pixel_id's device.
"""

import numpy as np
import torch

from ..config import DTYPE
from ..core import rng

_TOP = float(np.float32(1.0 - 1e-7))  # the sampler clamp, a float32 value


def _pow2(n):
    return n > 0 and (n & (n - 1)) == 0


def permute(i, n, key):
    """A stateless permutation of [0, n) per key (the JAX package's
    _permute): Kensler's for a power-of-two n, else the rotation by
    key % n.  i and key hold u32 values; int64 out."""
    if _pow2(n):
        return rng.permute_pow2(i, n, key)
    x = rng._u32(i)
    return ((x + rng._u32(key, x.device) % n) & rng.M32) % n


class StratifiedSampler:
    def __init__(self, spec, seed: int = 0):
        self.xs = spec.xsamp
        self.ys = spec.ysamp
        self.spp = spec.xsamp * spec.ysamp
        self.jitter = spec.jitter
        self.seed = seed

    def _u(self, pixel_id, sample_index, dim, salt):
        return rng.uniform_float(pixel_id, sample_index, dim * 64 + salt, self.seed)

    def _stratum(self, pixel_id, sample_index, dim):
        dk = ((dim * 2654435761) & rng.M32) + self.seed
        key = rng.hash_combine(pixel_id, dk & rng.M32)
        return permute(sample_index, self.spp, key)

    def get_1d(self, pixel_id, sample_index, dim):
        s = self._stratum(pixel_id, sample_index, dim)
        j = self._u(pixel_id, sample_index, dim, 0) if self.jitter else 0.5
        return torch.clamp((s.to(DTYPE) + j) / self.spp, max=_TOP)

    def get_2d(self, pixel_id, sample_index, dim):
        """(N, 2) stratified over the xs*ys grid."""
        s = self._stratum(pixel_id, sample_index, dim)
        sx = (s % self.xs).to(DTYPE)
        sy = (s // self.xs).to(DTYPE)
        if self.jitter:
            jx = self._u(pixel_id, sample_index, dim, 1)
            jy = self._u(pixel_id, sample_index, dim, 2)
        else:
            jx = jy = 0.5
        u0 = torch.clamp((sx + jx) / self.xs, max=_TOP)
        u1 = torch.clamp((sy + jy) / self.ys, max=_TOP)
        return torch.stack([u0, u1], dim=-1)
