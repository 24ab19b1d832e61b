"""Radical inverses (rs_ray_toy_tpu/core/lowdiscrepancy.py).

`radical_inverse_base` is the host numpy form the exit-pupil bound
(camera/realistic.bound_exit_pupil) uses for its (0,2)-sequence rear
plane samples.  `radical_inverse_rows` is the device form behind the
Halton sampler and the SPPM photon dimensions: the PBRT-v3 series
(lowdiscrepancy.rs:230-270), unscrambled or with the per-prime digit
permutations, evaluated directly in float64 on the tensor's device and
rounded once to float32.  A scrambled value includes the tail term
perm[0] * inv_base / (1 - inv_base) after the last digit, so it does not
depend on how many digits are taken.  (The JAX package sums grouped-digit
float32 tables instead, a TPU gather workaround; the two agree to a few
float32 ulp.)
"""

import numpy as np
import torch

_TOP = float(np.float32(1.0 - 1e-7))  # the clamp, a float32 value


def _first_primes(n):
    sieve_limit = 10000
    while True:
        sieve = np.ones(sieve_limit, dtype=bool)
        sieve[:2] = False
        for i in range(2, int(sieve_limit**0.5) + 1):
            if sieve[i]:
                sieve[i * i :: i] = False
        primes = np.nonzero(sieve)[0]
        if len(primes) >= n:
            return primes[:n].astype(np.int64)
        sieve_limit *= 2


# PRIME_NUMS (lowdiscrepancy.rs:8-165): the first 1024 primes, and the
# offset of each prime's permutation in the concatenated table
N_PRIMES = 1024
PRIMES = _first_primes(N_PRIMES)
PRIME_SUMS = np.concatenate([[0], np.cumsum(PRIMES)])[:N_PRIMES]


def radical_inverse_base(base, a):
    """Digits of the non-negative integers `a` in `base`, mirrored about
    the radix point (lowdiscrepancy.rs:230-238), clamped below 1 like
    the reference.  Host numpy float64."""
    a = np.asarray(a, dtype=np.int64).copy()
    inv_base = 1.0 / base
    out = np.zeros(a.shape, np.float64)
    scale = inv_base
    while np.any(a > 0):
        digit = a % base
        out += digit * scale
        a //= base
        scale *= inv_base
    return np.minimum(out, 1.0 - 1e-7)


def compute_radical_inverse_permutations(seed=0):
    """Per-prime digit permutations, concatenated in prime order
    (lowdiscrepancy.rs:250-270): np.random.default_rng(seed).permutation(p)
    for each prime p, as the JAX package draws them (seeded, where the
    reference draws from thread_rng)."""
    rng = np.random.default_rng(seed)
    perms = np.zeros(int(PRIME_SUMS[-1] + PRIMES[-1]), dtype=np.int32)
    for off, p in zip(PRIME_SUMS, PRIMES):
        perms[off : off + p] = rng.permutation(p)
    return perms


def radical_inverse_rows(dims, a, perms=None):
    """(len(dims), N) float32: row k is the radical inverse of the
    non-negative integers `a` (N,) in base PRIMES[dims[k]], scrambled by
    that prime's slice of `perms` (the concatenated permutation table as
    an integer tensor on a's device) when it is given.  float64 on a's
    device, rounded once to float32, clamped at 1 - 1e-7."""
    dev = a.device
    base = torch.tensor([int(PRIMES[d]) for d in dims], dtype=torch.int64, device=dev)[:, None]
    inv = 1.0 / base.to(torch.float64)
    a = a.to(torch.int64)[None, :].expand(len(dims), -1)
    n = a.shape[1]
    val = torch.zeros((len(dims), n), dtype=torch.float64, device=dev)
    scale = torch.ones_like(inv)
    # enough digits for the largest index in base 2, so for every base;
    # the extra digits are zeros (perm[0] when scrambled: the series' own
    # terms, of which the tail below is the rest)
    n_digits = max(1, int(a.max()).bit_length()) if n else 1
    off = None
    if perms is not None:
        off = torch.tensor([int(PRIME_SUMS[d]) for d in dims], dtype=torch.int64, device=dev)[:, None]
    for _ in range(n_digits):
        digit = a % base
        if perms is not None:
            digit = perms[off + digit]
        scale = scale * inv
        val = val + digit.to(torch.float64) * scale
        a = a // base
    if perms is not None:
        val = val + perms[off].to(torch.float64) * scale * (inv / (1.0 - inv))
    return torch.clamp(val.to(torch.float32), max=_TOP)
