"""K3-shaded (#14, flat and smooth) on the node64 walk, on the CPU.

The shaded closest hit walks the binary tree over its node64 rows
(accel/bvh.pack_node64_tables; csrc/bvh_kernel.cu bvh_shaded_kernel on
common.cuh's Bvh64), and so does its plain version
(`intersect_bvh_shaded_reference`, accel/traverse.walk64).

- The plain version over the node64 rows against the same over the
  fused-children rows (`fused_rows=True`, the walk the kernel took
  before), every output bit for bit (t, triangle, material, area light and
  every attribute row), on 2,000 seeded rays (t_max infinite, finite or 0):
  a 6x6 grid of cubes (flat, 456 triangles), one smooth UV sphere among the
  fixture's cubes (996 triangles, the smooth rows), write_deep_bvh_scene's
  tree (97 levels, the deep stack) and the fixture's third cube alone (12
  triangles: the tree is one leaf, no node64 row).
- The plain version against the JAX package's `intersect_bvh_pallas_shaded`
  in interpret mode on the smooth scene (the flat grid: tests/
  test_torch_bvh_kernel.py), both walking the JAX package's tables, at
  that file's bars: hit or miss equal, the triangle, material and area
  light equal, t within rtol 1e-6, the attributes (dndu, dndv among them)
  within rtol 1e-5 / atol 1e-6 (uv within atol 1e-4).
- Tables without node64 rows, or with malformed ones, raise.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.accel.bvh import build_bvh as jax_build_bvh
from rs_ray_toy_tpu.integrators.common import SceneCtx as JaxSceneCtx
from rs_ray_toy_tpu.ops.bvh_pallas import intersect_bvh_pallas_shaded, pack_bvh_tables
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu.scene.types import empty_spheres
from rs_ray_toy_tpu_torch.interop import from_jax_scene_ctx
from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
from rs_ray_toy_tpu_torch.scene.gen import (write_deep_bvh_scene, write_grid_scene,
                                            write_smooth_grid_scene)
from rs_ray_toy_tpu_torch.scene.loader import load_scene

N = 2000

torch.set_num_threads(min(2, torch.get_num_threads()))


def _scene(tmp, case):
    """The case's scene json, written under tmp."""
    if case == "smooth":
        return write_smooth_grid_scene(str(tmp), n=1, xres=64, yres=36)
    if case == "deep":
        return write_deep_bvh_scene(str(tmp), xres=64, yres=36)
    path = write_grid_scene(str(tmp), ny=6, nz=6, xres=64, yres=36)
    if case == "one_leaf":
        cfg = json.loads(Path(path).read_text())
        cfg["Aggregate"]["primitives"] = [cfg["Aggregate"]["primitives"][2]]
        Path(path).write_text(json.dumps(cfg))
    return path


def _rays(seed, case):
    """Seeded rays from near the camera at the case's triangles, and t_max:
    infinite, finite (short of some hits) or 0, a third each."""
    r = np.random.default_rng(seed)
    o = r.normal(0.0, 0.3, (N, 3))
    box = {"smooth": ((33.0, 39.0), (-8.0, 8.0), (-5.0, 5.0)),
           "deep": ((34.0, 36.0), (-1.0, 1.0), (-1.0, 1.0))}.get(
        case, ((34.5, 36.0), (-3.5, 3.5), (-2.5, 2.5)))
    target = np.stack([r.uniform(*lim, N) for lim in box], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lane = np.arange(N) % 3
    t_max = np.where(lane == 0, np.inf, np.where(lane == 1, r.uniform(33.0, 37.0, N), 0.0))
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    return f(o), f(d), f(t_max)


@pytest.mark.parametrize("case", ["flat", "smooth", "deep", "one_leaf"])
def test_node64_walk_equals_fused_rows_walk(tmp_path, case):
    tables = bk.pack_bvh(load_scene(_scene(tmp_path, case)).scene.triangles, "cpu")
    assert tables.smooth == (case == "smooth")
    assert (tables.stack == bk.DEEP_STACK) == (case == "deep")
    assert (tables.nodes64.shape[0] == 0) == (case == "one_leaf")
    ray = _rays(3, case)
    work = {}
    new = bk.intersect_bvh_shaded_reference(tables, *ray, work=work)
    old = bk.intersect_bvh_shaded_reference(tables, *ray, fused_rows=True)
    assert int((new[1] >= 0).sum()) > N // 10
    for x, y in zip(new, old):
        assert torch.equal(x, y)
    assert new[4].shape[0] == (bk.ATTR_ROWS_SMOOTH if case == "smooth" else bk.ATTR_ROWS)
    # the node64 walk's counts: no interior row fetched in a one-leaf tree
    assert (float(work["node"]) == 0) == (case == "one_leaf")
    assert float(work["mt"]) > 0
    # the wrapper on CPU tensors runs the same
    t, idx, valid, attrs = bk.intersect_bvh_shaded(tables, *ray)
    assert torch.equal(t, new[0]) and torch.equal(idx, new[1])
    assert torch.equal(attrs["mat"], new[2]) and torch.equal(attrs["ng"], new[4][7:10].T)


def test_smooth_plain_version_matches_jax_kernel(tmp_path):
    case = "smooth"
    path = _scene(tmp_path, case)
    jctx = JaxSceneCtx(jax_load_scene(path).scene)
    jtab = pack_bvh_tables(jax_build_bvh(jctx.tri, empty_spheres(), bk.KERNEL_LEAF), jctx.tri)
    ctx = from_jax_scene_ctx(jctx, "cpu", jtab)
    assert ctx.bvh.smooth and jtab["smooth"]
    o, d, t_max = _rays(9, case)
    t_j, idx_j, valid_j, at_j = intersect_bvh_pallas_shaded(
        jtab, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(t_max.numpy()),
        interpret=True)
    valid_j = np.asarray(valid_j)
    t, idx, valid, at = bk.intersect_bvh_shaded(ctx.bvh, o, d, t_max)
    assert valid_j.sum() > N // 10
    np.testing.assert_array_equal(valid.numpy(), valid_j)
    np.testing.assert_array_equal(idx.numpy()[valid_j], np.asarray(idx_j)[valid_j])
    np.testing.assert_allclose(t.numpy()[valid_j], np.asarray(t_j)[valid_j], rtol=1e-6)
    for k in ("mat", "area_light"):
        np.testing.assert_array_equal(at[k].numpy()[valid_j], np.asarray(at_j[k])[valid_j])
    for k in ("ns", "ng", "dpdu", "dpdv", "dndu", "dndv"):
        np.testing.assert_allclose(at[k].numpy()[valid_j], np.asarray(at_j[k])[valid_j],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # uv within atol 1e-4, as in tests/test_torch_bvh_kernel.py
    np.testing.assert_allclose(at["uv"].numpy()[valid_j], np.asarray(at_j["uv"])[valid_j],
                               rtol=0, atol=1e-4)
    assert (at["mat"].numpy()[~valid_j] == -1).all()


def test_tables_without_node64_rows_raise(tmp_path):
    tables = bk.pack_bvh(load_scene(_scene(tmp_path, "flat")).scene.triangles, "cpu")
    ray = _rays(5, "flat")
    with pytest.raises(ValueError, match="node64"):
        bk.intersect_bvh_shaded(tables._replace(nodes64=None), *ray)
    cpu = torch.device("cpu")
    bk._check_tables(tables, cpu)
    for bad in (None, tables.nodes64[:, :12], tables.nodes64.double(),
                torch.zeros((0, 16))):
        with pytest.raises(ValueError, match="nodes64"):
            bk._check_tables(tables._replace(nodes64=bad), cpu)
