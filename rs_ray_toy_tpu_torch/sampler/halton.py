"""Halton global sampler (rs_ray_toy_tpu/sampler/halton.py, samplers/halton.rs).

Sample index of (pixel, sample): the CRT offset of the pixel's position
modulo 128 (halton.rs:75-105), held as two host tables off_x[px % 128]
and off_y[py % 128], plus sample * stride.  Dimension 0 is the base-2
radical inverse of index >> exp_x, dimension 1 the base-3 one of
index // scale_y, both pinned at 0.5 with `sample_at_center`; every
higher dimension d is the scrambled radical inverse in the d-th prime
with the global digit permutations (core/lowdiscrepancy).

Slot rule (sampler/dims.py rule 3): slot d owns dimensions (2d, 2d+1);
get_1d reads 2d, get_2d both.  Dimensions past the 1024 primes fall back
to the counter-based hash, as in the JAX package; so does a slot the
JAX package reads as a traced value (`traced_2d`: AO's probes, drawn
inside a fori_loop; a per-ray tensor of slots: the Debug / DirectLighting
tree's branch dimensions).  The JAX package's
`payload_grid` (a gather-free broadcast of the slot values for the TPU)
is not ported: `slot_matrix` evaluates every slot of a batch in one
batched radical inverse.
"""

import numpy as np
import torch

from ..core import lowdiscrepancy as ld
from ..core import rng

K_MAX_RESOLUTION = 128


def _multiplicative_inverse(a, n):
    # extended euclid (halton.rs:131-150)
    def ext_gcd(a, b):
        if b == 0:
            return 1, 1
        d = a // b
        xp, yp = ext_gcd(b, a % b)
        return yp, xp - d * yp

    x, _ = ext_gcd(a, n)
    return x % n


def _inverse_radical_inverse_host(base, inverse, n_digits):
    index = 0
    for _ in range(n_digits):
        digit = inverse % base
        inverse //= base
        index = index * base + digit
    return index


class HaltonSampler:
    def __init__(self, spec, xres, yres, seed=0):
        self.spp = spec.nsamp
        self.sample_at_center = spec.sample_at_center
        self.seed = seed
        self.xres = xres
        scales, exps = [], []
        for i, base in enumerate((2, 3)):
            res = min((xres, yres)[i], K_MAX_RESOLUTION)
            scale, exp = 1, 0
            while scale < res:
                scale *= base
                exp += 1
            scales.append(scale)
            exps.append(exp)
        self.base_scales = scales
        self.base_exponents = exps
        self.sample_stride = scales[0] * scales[1]
        self.offs_x = np.zeros(K_MAX_RESOLUTION, np.int64)
        self.offs_y = np.zeros(K_MAX_RESOLUTION, np.int64)
        if self.sample_stride > 1:
            inv = (
                _multiplicative_inverse(scales[1], scales[0]),
                _multiplicative_inverse(scales[0], scales[1]),
            )
            p = range(K_MAX_RESOLUTION)
            dim_x = np.array([_inverse_radical_inverse_host(2, i, exps[0]) for i in p])
            dim_y = np.array([_inverse_radical_inverse_host(3, i, exps[1]) for i in p])
            self.offs_x = dim_x * (self.sample_stride // scales[0]) * inv[0] % self.sample_stride
            self.offs_y = dim_y * (self.sample_stride // scales[1]) * inv[1] % self.sample_stride
        self.perms = ld.compute_radical_inverse_permutations(seed)
        self._on_device = {}

    def _tables(self, device):
        """(offs_x, offs_y, perms) as int64 tensors on `device`, made once."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = tuple(
                torch.as_tensor(np.asarray(t, np.int64), device=device)
                for t in (self.offs_x, self.offs_y, self.perms)
            )
        return self._on_device[key]

    def index(self, pixel_id, sample_index):
        """Global Halton index of each (pixel, sample), int64."""
        offs_x, offs_y, _ = self._tables(pixel_id.device)
        pid = pixel_id.to(torch.int64)
        px = (pid % self.xres) % K_MAX_RESOLUTION
        py = (pid // self.xres) % K_MAX_RESOLUTION
        off = (offs_x[px] + offs_y[py]) % self.sample_stride
        sid = torch.as_tensor(sample_index, device=pid.device).to(torch.int64)
        return off + sid * self.sample_stride

    def dims_values(self, pixel_id, sample_index, dims):
        """(len(dims), N) float32 values of Halton dimensions `dims`."""
        idx = self.index(pixel_id, sample_index).expand(pixel_id.shape[0])
        rows = [None] * len(dims)
        scrambled = [k for k, d in enumerate(dims) if 2 <= d < ld.N_PRIMES]
        if scrambled:
            vals = ld.radical_inverse_rows(
                [dims[k] for k in scrambled], idx, self._tables(idx.device)[2]
            )
            for j, k in enumerate(scrambled):
                rows[k] = vals[j]
        for k, d in enumerate(dims):
            if d < 2 and self.sample_at_center:
                rows[k] = torch.full(idx.shape, 0.5, dtype=torch.float32, device=idx.device)
            elif d == 0:
                rows[k] = ld.radical_inverse_rows([0], idx >> self.base_exponents[0])[0]
            elif d == 1:
                rows[k] = ld.radical_inverse_rows([1], idx // self.base_scales[1])[0]
            elif d >= ld.N_PRIMES:
                rows[k] = rng.uniform_float(pixel_id, sample_index, d, self.seed)
        return torch.stack(rows, 0)

    def get_1d(self, pixel_id, sample_index, dim):
        """(N,): slot `dim` -> Halton dimension 2 dim; a per-ray tensor of
        slots (the Debug / DirectLighting tree's branch dimensions) the
        counter-based hash at `dim`, as the JAX package answers a traced
        slot."""
        if torch.is_tensor(dim):
            return rng.uniform_float(pixel_id, sample_index, dim, self.seed)
        return self.dims_values(pixel_id, sample_index, [2 * dim])[0]

    def get_2d(self, pixel_id, sample_index, dim):
        """(N, 2): slot `dim` -> Halton dimensions (2 dim, 2 dim + 1), so
        that slots 0 (film) and 1 (lens) are the reference's dims 0-3; a
        per-ray tensor of slots `traced_2d`."""
        if torch.is_tensor(dim):
            return self.traced_2d(pixel_id, sample_index, dim)
        return self.dims_values(pixel_id, sample_index, [2 * dim, 2 * dim + 1]).T

    def traced_2d(self, pixel_id, sample_index, dim):
        """(N, 2): what the JAX package's get_2d returns for a slot that is
        a traced value rather than a python int: the counter-based hash
        at (dim, dim + 7919), not the Halton dimensions."""
        u0 = rng.uniform_float(pixel_id, sample_index, dim, self.seed)
        u1 = rng.uniform_float(pixel_id, sample_index, dim + 7919, self.seed)
        return torch.stack([u0, u1], -1)

    def slot_matrix(self, pixel_id, sample_index, slots):
        """(NC, N) float32 matrix of the values of `slots`, (slot, 1 or 2)
        pairs in order: one row for a 1d slot, two for a 2d slot (the
        layout the SPPM camera kernel reads)."""
        dims = []
        for slot, n in slots:
            dims.extend([2 * slot] if n == 1 else [2 * slot, 2 * slot + 1])
        return self.dims_values(pixel_id, sample_index, dims)
