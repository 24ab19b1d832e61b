"""Counter-based sampling: the PyTorch port is bit-equal to the JAX package.

torch has no wrapping uint32 arithmetic; the port emulates it in int64
(rs_ray_toy_tpu_torch/core/rng.py).  Every uniform downstream depends on
these functions, so the bar is exact equality over >= 1M (pixel, sample,
dim) triples from a numpy seed, with the u32 extremes included.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rs_ray_toy_tpu.core import rng as jrng
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import SamplerSpec as JaxSamplerSpec
from rs_ray_toy_tpu_torch.core import rng
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.loader import SamplerSpec, load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
N = 1 << 20
EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


@pytest.fixture(scope="module")
def triples():
    r = np.random.default_rng(20260)
    pid, sid, dim = (r.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32) for _ in range(3))
    for a in (pid, sid, dim):
        a[: EDGES.size] = EDGES
        a[EDGES.size : 2 * EDGES.size] = EDGES[::-1]
    return pid, sid, dim


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


def _u32(jax_out):
    return np.asarray(jax_out).astype(np.uint32).astype(np.int64)


def test_hash_u32_bit_equal(triples):
    pid, _, _ = triples
    assert np.array_equal(rng.hash_u32(_t(pid)).numpy(), _u32(jrng.hash_u32(jnp.asarray(pid))))


def test_hash_combine_bit_equal(triples):
    pid, sid, _ = triples
    got = rng.hash_combine(_t(pid), _t(sid)).numpy()
    want = _u32(jrng.hash_combine(jnp.asarray(pid), jnp.asarray(sid)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 4, 16, 64, 1 << 16])
def test_permute_pow2_bit_equal(triples, n):
    _, sid, dim = triples
    got = rng.permute_pow2(_t(sid), n, _t(dim)).numpy()
    want = np.asarray(jrng.permute_pow2(jnp.asarray(sid), n, jnp.asarray(dim))).astype(np.int64)
    assert np.array_equal(got, want)
    assert got.min() >= 0 and got.max() < n


def test_uniform_float_bit_equal(triples):
    pid, sid, dim = triples
    got = rng.uniform_float(_t(pid), _t(sid), _t(dim), 7).numpy()
    want = np.asarray(
        jrng.uniform_float(jnp.asarray(pid), jnp.asarray(sid), jnp.asarray(dim), 7)
    )
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("jitter", [True, False])
@pytest.mark.parametrize("dim", [0, 1, 8, 11, 41, 1000003])
def test_stratified_get_1d_get_2d_bit_equal(triples, jitter, dim):
    pid, sid, _ = triples
    sid = sid % 16  # a 4x4 sampler's sample indices
    port = StratifiedSampler(SamplerSpec("stratified", jitter, 4, 4), seed=3)
    ref = JaxStratified(JaxSamplerSpec("stratified", jitter, 4, 4), seed=3)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    got1 = port.get_1d(_t(pid), _t(sid), dim).numpy()
    got2 = port.get_2d(_t(pid), _t(sid), dim).numpy()
    want1 = np.asarray(ref.get_1d(jp, js, dim))
    want2 = np.asarray(ref.get_2d(jp, js, dim))
    assert np.array_equal(got1.view(np.uint32), want1.view(np.uint32))
    assert np.array_equal(got2.view(np.uint32), want2.view(np.uint32))
    assert got1.min() >= 0.0 and got1.max() < 1.0


def test_stratified_rejects_non_power_of_two():
    """The kernels' in-kernel sampler takes only power-of-two grids: their
    shared gate refuses any other grid naming it, and the wavefront
    loop's does not (its sampler, StratifiedSampler, takes any grid)."""
    scene = load_scene(str(SAMPLES / "scene.json")).scene
    for xs, ys in ((3, 3), (4, 3), (1, 5)):
        sampler = StratifiedSampler(SamplerSpec("stratified", True, xs, ys))
        assert pmk.scene_unsupported(scene, sampler, pmk.BASE_KINDS) == (
            f"stratified grid {xs}x{ys} (power of two only)")
        assert pmk.scene_unsupported(scene, sampler, pmk.BASE_KINDS, wavefront=True) is None
    pow2 = StratifiedSampler(SamplerSpec("stratified", True, 4, 2))
    assert pmk.scene_unsupported(scene, pow2, pmk.BASE_KINDS) is None


def test_stratified_non_power_of_two_bit_equal(triples):
    """A 3x3 grid takes the JAX package's keyed rotation: bit-equal over
    the triples' pixels and every sample index, the u32 extremes
    included."""
    pid, sid, _ = triples
    sid = sid % 9
    port = StratifiedSampler(SamplerSpec("stratified", True, 3, 3), seed=3)
    ref = JaxStratified(JaxSamplerSpec("stratified", True, 3, 3), seed=3)
    jp, js = jnp.asarray(pid), jnp.asarray(sid)
    for dim in (0, 8, 41):
        got1 = port.get_1d(_t(pid), _t(sid), dim).numpy()
        got2 = port.get_2d(_t(pid), _t(sid), dim).numpy()
        want1 = np.asarray(ref.get_1d(jp, js, dim))
        want2 = np.asarray(ref.get_2d(jp, js, dim))
        assert np.array_equal(got1.view(np.uint32), want1.view(np.uint32))
        assert np.array_equal(got2.view(np.uint32), want2.view(np.uint32))
