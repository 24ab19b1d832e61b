"""The port's Halton sampler, radical inverses and light pick against the JAX package.

The port evaluates the radical inverse directly in float64 on the device
and rounds once (core/lowdiscrepancy.radical_inverse_rows); the JAX
package sums grouped-digit float32 tables.  The values agree to a few
float32 ulp: 3e-7, bit for bit in base 2.  The digit permutations are
drawn from the same numpy generator and agree exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rs_ray_toy_tpu.core import lowdiscrepancy as jld
from rs_ray_toy_tpu.core.sampling import Distribution1D as JaxDistribution1D
from rs_ray_toy_tpu.core.sampling import sample_discrete_1d as jax_sample_discrete_1d
from rs_ray_toy_tpu.core.sampling import uniform_sample_sphere as jax_uniform_sample_sphere
from rs_ray_toy_tpu.ops.sppm_megakernel import _sppm_slots
from rs_ray_toy_tpu.sampler.halton import HaltonSampler as JaxHalton
from rs_ray_toy_tpu.scene.loader import SamplerSpec as JaxSamplerSpec
from rs_ray_toy_tpu_torch.core import lowdiscrepancy as ld
from rs_ray_toy_tpu_torch.core.sampling import (
    Distribution1D,
    sample_discrete_1d,
    uniform_sample_sphere,
)
from rs_ray_toy_tpu_torch.ops.sppm_megakernel import sppm_slots
from rs_ray_toy_tpu_torch.sampler.halton import HaltonSampler
from rs_ray_toy_tpu_torch.scene.loader import SamplerSpec

W, H = 64, 36


@pytest.mark.parametrize("seed", [0, 7])
def test_permutations_equal(seed):
    assert np.array_equal(ld.PRIMES, jld.PRIMES)
    assert np.array_equal(ld.PRIME_SUMS, jld.PRIME_SUMS)
    assert np.array_equal(
        ld.compute_radical_inverse_permutations(seed), jld.compute_radical_inverse_permutations(seed)
    )


def _samplers(nsamp, center, seed=0):
    return (
        HaltonSampler(SamplerSpec("halton", nsamp=nsamp, sample_at_center=center), W, H, seed),
        JaxHalton(JaxSamplerSpec(kind="halton", nsamp=nsamp, sample_at_center=center), W, H, seed),
    )


@pytest.mark.parametrize("it", [0, 1])
def test_sppm_slot_values_match_jax(it):
    """Every slot the SPPM camera walk reads (max_depth 3), 64x36 pixels,
    the render's sampler: n_iters samples at the pixel centres."""
    port, ref = _samplers(2, True)
    pid = np.arange(W * H)
    assert sppm_slots(3) == _sppm_slots(3, with_cam=True)
    u = port.slot_matrix(torch.as_tensor(pid), it, sppm_slots(3)).numpy()
    rows = []
    for slot, n in sppm_slots(3):
        jp, js = jnp.asarray(pid, jnp.uint32), jnp.full((W * H,), it, jnp.uint32)
        if n == 1:
            rows.append(np.asarray(ref.get_1d(jp, js, slot)))
        else:
            rows.extend(np.asarray(ref.get_2d(jp, js, slot)).T)
    u_ref = np.stack(rows)
    assert u.shape == u_ref.shape == (13, W * H)
    assert (u[:2] == 0.5).all()  # the film sample at the pixel centre
    np.testing.assert_allclose(u, u_ref, rtol=0, atol=3e-7)


def test_get_1d_get_2d_match_jax_off_centre():
    """A 16-sample sampler without sample_at_center: dims 0 and 1 are the
    base-2 and base-3 radical inverses of the CRT index, the rest
    scrambled; slot d reads dims (2d, 2d+1)."""
    port, ref = _samplers(16, False)
    rng = np.random.default_rng(3)
    pid = rng.integers(0, W * H, 4096)
    sid = rng.integers(0, 16, 4096)
    tp, ts = torch.as_tensor(pid), torch.as_tensor(sid)
    jp, js = jnp.asarray(pid, jnp.uint32), jnp.asarray(sid, jnp.uint32)
    for slot in (0, 1, 2, 9, 40):
        np.testing.assert_allclose(port.get_2d(tp, ts, slot).numpy(),
                                   np.asarray(ref.get_2d(jp, js, slot)), rtol=0, atol=3e-7)
        np.testing.assert_allclose(port.get_1d(tp, ts, slot).numpy(),
                                   np.asarray(ref.get_1d(jp, js, slot)), rtol=0, atol=3e-7)
    assert np.array_equal(port.index(tp, ts).numpy(), np.asarray(ref._index(jp, js)))


def test_photon_dims_match_jax():
    """radical_inverse(dim, it * n + i) at the dims of SPPM photon
    emission and of max_depth 3's bounces, iteration 1 of 2048 photons."""
    idx = 2048 + np.arange(2048)
    dims = [0, 1, 2, 3, 4, 5, 6, 11, 7, 8, 13]
    u = ld.radical_inverse_rows(dims, torch.as_tensor(idx)).numpy()
    for k, d in enumerate(dims):
        ref = np.asarray(jld.radical_inverse(d, jnp.asarray(idx, jnp.int32)))
        if d == 0:
            assert np.array_equal(u[k], ref)  # bit reversal: exact
        np.testing.assert_allclose(u[k], ref, rtol=0, atol=3e-7, err_msg=f"dim {d}")


def test_light_pick_matches_jax():
    """sample_discrete_1d over the float32 CDF picks JAX's light, with its
    pdf, also at u on the CDF's own values."""
    power = np.array([900.0, 0.0, 1130.5, 412.25], np.float32)
    dist = Distribution1D(power).as_device("cpu")
    jdist = JaxDistribution1D(power).as_device()
    u = np.concatenate([np.linspace(0.0, 1.0 - 1e-7, 1001), np.asarray(jdist["cdf"])[:-1]])
    u = u.astype(np.float32)
    idx, pdf = sample_discrete_1d(dist, torch.as_tensor(u))
    jidx, jpdf = jax_sample_discrete_1d(jdist, jnp.asarray(u))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(pdf.numpy(), np.asarray(jpdf))
    assert (idx.numpy() != 1).all()  # the dark light is never picked


def test_uniform_sample_sphere_matches_jax():
    u = np.random.default_rng(5).random((4096, 2), dtype=np.float32)
    x, y, z = uniform_sample_sphere(torch.as_tensor(u[:, 0]), torch.as_tensor(u[:, 1]))
    ref = np.asarray(jax_uniform_sample_sphere(jnp.asarray(u)))
    np.testing.assert_allclose(torch.stack([x, y, z], -1).numpy(), ref, rtol=0, atol=2e-6)
