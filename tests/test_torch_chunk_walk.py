"""The chunked brute-force walk (K1's brute-force instances and K4) against
the JAX package.

The port's `build_tri_chunks` is held to the JAX package's
`_build_tri_chunks` under its TPU limits (256 rows, 24 chunks) on the
fixture's and samples/scene_sphere_area.json's tables, tuple for tuple;
on samples/scene_smooth.json's 1,956 rows, past those limits, its chunks
cover every row once in table order and each float32 box holds its
triangles' vertices with the padding.  The culled plain walk
(ops/path_megakernel.chunk_walk) gives the same closest hit (t and row,
bit for bit) on every ray as the JAX kernel's brute-force walk
(`_closest_hit` with chunks=None) on the smooth table with seeded
camera-like, grazing, box-face and shared-edge rays, and the same
occlusion (`_occluded`) for seeded shadow segments, with fewer
Moller-Trumbore tests than the walk over every row.  The JAX walks are
compiled at XLA's backend optimisation level 0: at the default level
LLVM contracts their multiply-adds into FMAs, which on about 2% of these
rays (grazing ones, where |det| is near TRI_EPS, and exact ties at shared
edges) decides differently from the float32 operations the port and its
kernels make one by one (--fmad=false).  The plain
mirror of the kernels' division-free early reject (`mt_reject`) rejects
nothing the exact test accepts on seeded near-edge rays (u, v and u + v
at 0 and 1, t at TRI_EPS and at the bound) and on rays whose u underflows
to -0.0.  (tests/test_torch_cuda.py holds K4's chunked kernel to its
walk over every row on the card.)
"""

from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.ops.path_megakernel import _build_tri_chunks, _closest_hit, _occluded
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"


@lru_cache(maxsize=None)
def _tables(name):
    """(the port's packed scene, JAX's p0, e1, e2 as its pack_scene makes
    them) of a sample scene."""
    tri = JaxSceneCtx(jax_load_scene(str(SAMPLES / name)).scene).tri
    p0 = np.asarray(tri.p0, np.float32)
    e1 = np.asarray(tri.p1, np.float32) - p0
    e2 = np.asarray(tri.p2, np.float32) - p0
    return pmk.pack_scene(load_scene(str(SAMPLES / name)).scene, "cpu"), (p0, e1, e2)


@pytest.mark.parametrize("name", ["scene.json", "scene_sphere_area.json"])
def test_chunks_match_jax(name):
    packed, (p0, e1, e2) = _tables(name)
    g = packed.table[:, :9].numpy()
    np.testing.assert_array_equal(g, np.concatenate([p0, e1, e2], 1))
    want = _build_tri_chunks(p0, e1, e2, p0.shape[0])
    assert want is not None and len(want) > 1
    assert pmk.build_tri_chunks(g[:, 0:3], g[:, 3:6], g[:, 6:9], g.shape[0], 256, 24) == want
    # under the port's limits the same tables chunk the same
    assert pmk.build_tri_chunks(g[:, 0:3], g[:, 3:6], g[:, 6:9], g.shape[0]) == want
    np.testing.assert_array_equal(packed.chunks.numpy(), pmk.chunk_rows(want))


def test_chunks_cover_the_smooth_table():
    packed, (p0, e1, e2) = _tables("scene_smooth.json")
    t_count = p0.shape[0]
    assert t_count == 1956 and _build_tri_chunks(p0, e1, e2, t_count) is None
    chunks = pmk.build_tri_chunks(p0, e1, e2, t_count)
    rows = packed.chunks.numpy()
    np.testing.assert_array_equal(rows, pmk.chunk_rows(chunks))
    assert 1 < rows.shape[0] <= pmk.CHUNK_MAX
    lo, hi = rows[:, 6].astype(int), rows[:, 7].astype(int)
    assert lo[0] == 0 and hi[-1] == t_count and (lo[1:] == hi[:-1]).all()
    size = hi - lo
    assert (size <= pmk.CHUNK_ROWS).all() and (size[:-1] >= 4).all()
    p64 = p0.astype(np.float64)
    v = np.stack([p64, p64 + e1, p64 + e2], 1)
    for c, (a, b, bmin, bmax) in enumerate(chunks):
        verts = v[a:b].reshape(-1, 3)
        pad = 1e-3 + 1e-4 * np.maximum(np.abs(verts.min(0)), np.abs(verts.max(0)))
        np.testing.assert_allclose(np.array(bmin), verts.min(0) - pad, rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.array(bmax), verts.max(0) + pad, rtol=0, atol=1e-12)
        # the float32 rows round outward
        assert (rows[c, 0:3] <= np.array(bmin)).all() and (rows[c, 3:6] >= np.array(bmax)).all()
        assert (rows[c, 0:3] < verts.min(0)).all() and (rows[c, 3:6] > verts.max(0)).all()


def _smooth_rays(p0, e1, e2, rows, n, seed):
    """Seeded rays against the smooth table: camera-like rays toward the
    cubes and spheres, grazing rays (in a triangle's plane, nudged off it),
    rays along chunk-box faces and rays aimed at shared edges and vertices;
    each kind a quarter of `n`."""
    r = np.random.default_rng(seed)
    q = n // 4
    j = r.integers(0, p0.shape[0], (3, q))
    # camera-like
    o1 = r.normal(0.0, 0.3, (q, 3))
    t1 = np.stack([r.uniform(33.0, 38.0, q), r.uniform(-8.0, 8.0, q), r.uniform(-5.0, 5.0, q)], -1)
    # grazing: from a point in a triangle's plane, along an edge direction
    # turned by at most 1e-5 rad out of it
    nrm = np.cross(e1[j[0]], e2[j[0]])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    along = e1[j[0]] / np.linalg.norm(e1[j[0]], axis=-1, keepdims=True)
    o2 = p0[j[0]] - 3.0 * along + r.uniform(-1e-6, 1e-6, (q, 1)) * nrm
    t2 = o2 + along + r.uniform(-1e-5, 1e-5, (q, 1)) * nrm
    # along a chunk box's face: the origin on the face's plane, the
    # direction in it
    c = r.integers(0, rows.shape[0], q)
    face = r.integers(0, 6, q)
    o3 = r.uniform(rows[c, 0:3], rows[c, 3:6]) - 4.0 * r.normal(0.0, 1.0, (q, 3))
    axis = face % 3
    o3[np.arange(q), axis] = rows[c, face]
    d3 = r.normal(0.0, 1.0, (q, 3))
    d3[np.arange(q), axis] = 0.0
    t3 = o3 + d3
    # through the midpoint of an edge or a vertex, which neighbours share
    w = r.integers(0, 4, q)
    tgt = np.where((w == 0)[:, None], p0[j[1]] + 0.5 * e1[j[1]],
                   np.where((w == 1)[:, None], p0[j[1]] + 0.5 * e2[j[1]],
                            np.where((w == 2)[:, None], p0[j[1]] + 0.5 * (e1[j[1]] + e2[j[1]]),
                                     p0[j[1]])))
    o4 = tgt + r.normal(0.0, 3.0, (q, 3))
    o = np.concatenate([o1, o2, o3, o4]).astype(np.float32)
    d = np.concatenate([t1 - o1, t2 - o2, t3 - o3, tgt - o4])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _jax_walk(walk, table, *args):
    """A JAX kernel's walk over every row of `table`, compiled without
    LLVM's FMA contraction (see the module docstring)."""
    f = lambda tab, *a: walk(tab, tab.shape[0], *a)
    args = (jnp.asarray(table), *(jnp.asarray(a) for a in args))
    compiled = jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    out = compiled(*args)
    return [np.asarray(x) for x in (out if isinstance(out, tuple) else (out,))]


def test_culled_walk_matches_jax_brute_force():
    packed, (p0, e1, e2) = _tables("scene_smooth.json")
    rows = packed.chunks
    o, d = _smooth_rays(p0, e1, e2, rows.numpy(), 4096, seed=14)
    n = o.shape[0]
    # the JAX table with the row index as an attribute column
    jtable = np.concatenate([p0, e1, e2, np.arange(n_rows := p0.shape[0])[:, None]], 1)
    t_j, idx_j = _jax_walk(lambda *a: _closest_hit(*a, attr_cols=(9,)), jtable.astype(np.float32),
                           *o.T, *d.T)
    hit_j = t_j < pmk.BIG_T
    idx_j = idx_j.astype(np.int64)
    assert 0.2 * n < hit_j.sum() < 0.9 * n
    cols = packed.table[:, :9].T.contiguous()
    ray = [torch.as_tensor(c) for c in (*o.T, *d.T)]
    live = torch.ones(n, dtype=torch.bool)
    work = {}
    t, row = pmk.chunk_walk(cols, rows, *ray, torch.full((n,), pmk.BIG_T), live, False, work)
    np.testing.assert_array_equal(row.numpy(), np.where(hit_j, idx_j, -1))
    np.testing.assert_array_equal(t.numpy()[hit_j], t_j[hit_j])
    assert work["mt"] < 0.1 * work["mt_brute"] and work["mt_brute"] == n * n_rows
    assert work["slab"] == n * rows.shape[0]
    r = np.random.default_rng(15)
    # shadow segments: t_max a seeded fraction of the closest hit, or past it
    t_max = np.where(hit_j, t_j * r.choice([0.5, 0.999999, 1.000001, 2.0], n),
                     r.uniform(1.0, 50.0, n)).astype(np.float32)
    occ_j = _jax_walk(_occluded, jtable.astype(np.float32), *o.T, *d.T, t_max)[0] > 0
    assert 0.1 * n < occ_j.sum() < hit_j.sum()
    work = {}
    _, first = pmk.chunk_walk(cols, rows, *ray, torch.as_tensor(t_max), live, True, work)
    np.testing.assert_array_equal(first.numpy() >= 0, occ_j)
    assert work["mt"] < work["mt_brute"]
    # the any-hit walk's row is a hit below t_max, the first in table order
    g = cols[:, first.clamp(min=0)]
    hit, t_first = pmk._mt(g, *ray)
    found = first >= 0
    assert bool((hit & (t_first < torch.as_tensor(t_max)))[found].all())


def _near_edge_cases(p0, e1, e2, n, seed):
    """Rays aimed at points whose barycentrics sit on or a few ulps about
    the test's edges (u, v, u + v at 0 and 1), from origins at distances
    of 1e-7 to 10 (t at TRI_EPS), with t bounds on both sides of the
    true t."""
    r = np.random.default_rng(seed)
    j = r.integers(0, p0.shape[0], n)
    edge = np.array([0.0, 1e-7, -1e-7, 1.0, 1.0 - 1e-7, 1.0 + 1e-7, 0.5])
    u = edge[r.integers(0, edge.size, n)] + r.choice([0.0, 1e-9, -1e-9], n)
    v = np.where(r.random(n) < 0.5, edge[r.integers(0, edge.size, n)], 1.0 - u)
    v = v + r.choice([0.0, 3e-8, -3e-8], n)
    p = (p0[j].astype(np.float64) + u[:, None] * e1[j] + v[:, None] * e2[j])
    d = r.normal(0.0, 1.0, (n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dist = 10.0 ** r.uniform(-7.2, 1.0, n)
    o = p - dist[:, None] * d
    t_bound = dist * r.choice([0.9999999, 1.0, 1.0000001, 1e30], n)
    g = [torch.as_tensor(c) for c in np.concatenate([p0[j], e1[j], e2[j]], 1).T]
    return (g, [torch.as_tensor(c, dtype=torch.float32) for c in (*o.T, *d.T)],
            torch.as_tensor(t_bound, dtype=torch.float32))


def test_reject_keeps_every_hit():
    _, (p0, e1, e2) = _tables("scene_smooth.json")
    g, ray, t_bound = _near_edge_cases(p0, e1, e2, 200_000, seed=16)
    hit, t = pmk._mt(g, *ray)
    accepted = hit & (t < t_bound)
    rejected = pmk.mt_reject(g, *ray, t_bound)
    assert int(accepted.sum()) > 10_000
    assert not bool((accepted & rejected).any())
    # and it does reject: most of what the exact test refuses
    assert float(rejected[~accepted].double().mean()) > 0.5

    # u underflows to -0.0 (which u >= 0 accepts): a ray down z onto the
    # triangle (0, 0, 0), (64, 0, 0), (0, 64, 0) from x = a negative
    # denormal, u = x / 64
    w = torch.tensor([-1.4e-45, -1.4e-44, -4.2e-44], dtype=torch.float32)
    k = w.shape[0]
    g = [torch.full((k,), x, dtype=torch.float32) for x in (0, 0, 0, 64, 0, 0, 0, 64, 0)]
    ray = [w, torch.full((k,), 1.0), torch.full((k,), -2.0),
           torch.zeros(k), torch.zeros(k), torch.ones(k)]
    hit, t = pmk._mt(g, *ray)
    assert bool(hit.all()) and bool((t == 2.0).all())
    rejected = pmk.mt_reject(g, *ray, torch.full((k,), pmk.BIG_T))
    assert not bool(rejected.any())
