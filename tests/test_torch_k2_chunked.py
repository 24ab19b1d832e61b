"""K2's brute force (#5a camera, #6 given rays) on the chunked walk, on
the CPU.

The direct kernel's brute-force instances walk the table's chunks
(csrc/common.cuh ChunkGeometry, K1's and K6's: a chunk's rows are tested
only where its padded box is hit, each behind the division-free reject),
and so does their plain version (`tree_reference` on
`PlainGeometry(..., cull=True)` over `PackedScene.chunks`).

- The plain version's chunked walk against its walk over every row
  (`chunks` None), bit for bit, on the Debug fixture at 64x36 x 4
  samples: the camera pass (#5a) under Debug and under DirectLighting
  with one light a hit, and the rays-in pass (#6) on the camera pass's
  rays; the chunked walk's counts (fewer MT tests than the walk over
  every row, a chunk box test a chunk a walk, the per-warp rows) beside.
- The camera pass against the JAX package's `li_levels_mega_cam` (its
  `_kernel_cam`, which culls its loops by the same static chunk boxes)
  in interpret mode on the Debug fixture at 64x36, every pixel once, at
  the bar of tests/test_torch_direct.py (under 0.5% of rays past 1e-3
  relative, the 99th percentile below 1e-4, the means within 3e-3), its
  tree cut to max_depth 2 (the hit, its shadow rays and its children):
  the interpret-mode trace grows with the unrolled tree, 9 s at depth 2
  against 52 s at the fixture's 4.  tests/test_torch_direct.py holds the
  same plain version (chunked since this walk) to JAX's `li_levels` at
  max_depth 4 and to the JAX kernel on a glass tree.
- The launch arguments of a brute-force pack: its chunk rows and count
  (`pmk.chunk_args`); a pack without them raises rather than walk every
  row.
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_ray_toy_tpu.camera.realistic import RealisticCamera as JaxCamera
from rs_ray_toy_tpu.integrators.common import SceneCtx
from rs_ray_toy_tpu.ops import direct_megakernel as jdmk
from rs_ray_toy_tpu.ops import path_megakernel as jpmk
from rs_ray_toy_tpu.sampler.stratified import StratifiedSampler as JaxStratified
from rs_ray_toy_tpu.scene.loader import load_scene as jax_load_scene
from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
from rs_ray_toy_tpu_torch.interop import camera_from_jax
from rs_ray_toy_tpu_torch.ops import direct_megakernel as dmk
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.render import camera_rays, sample_batch
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.loader import load_scene

SAMPLES = Path(__file__).resolve().parents[1] / "samples"
W, H = 64, 36

torch.set_num_threads(min(2, torch.get_num_threads()))


def _debug_fixture(tmp, strategy=None, max_depth=None):
    """samples/scene_debug.json at 64x36 (with `strategy`: DirectLighting,
    that light strategy; with `max_depth`, that depth) written under tmp;
    its path."""
    cfg = json.loads((SAMPLES / "scene_debug.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = W, H
    if max_depth is not None:
        cfg["Integrator"]["max_depth"] = max_depth
    if strategy is not None:
        cfg["Integrator"].update(integrator_type="DirectLighting", light_strategy=strategy)
    shutil.copy(SAMPLES / "cube.obj", tmp)
    path = tmp / "scene.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("case", ["debug-camera", "debug-rays", "direct-one-camera"])
def test_chunked_walk_equals_walk_over_every_row(tmp_path, case):
    job = load_scene(_debug_fixture(tmp_path, "one" if case.startswith("direct") else None))
    packed = pmk.pack_scene(job.scene, "cpu")
    assert packed.bvh is None and packed.chunks is not None
    sampler = StratifiedSampler(job.sampler)
    camera = RealisticCamera(job.camera, job.film, pupil_samples=1 << 12)
    pxy, pid, soff = sample_batch(job.film, 4, "cpu")
    if case.endswith("rays"):
        o, d, w = camera_rays(camera, sampler, pxy, pid, soff)
        args = (o, d, w, pid, soff, sampler, job.integrator)
        ref = dmk.li_levels_mega_reference
    else:
        args = (pmk.pack_camera(camera), pxy, pid, soff, sampler, job.integrator)
        ref = lambda p, *a, **k: dmk.li_levels_mega_cam_reference(p, *a, **k)[0]
    work, every_work = {}, {}
    l = ref(packed, *args, work=work)
    l_every = ref(packed._replace(chunks=None), *args, work=every_work)
    assert float(l.max()) > 0
    assert torch.equal(l, l_every)
    # the chunked walk's counts: its MT tests against the walk over every row's
    n = pxy.shape[0]
    assert float(work["mt_brute"]) == float(every_work["mt"])
    assert 0 < float(work["mt"]) < 0.25 * float(work["mt_brute"])
    assert float(work["slab"]) >= float(work["mt"]) / pmk.CHUNK_ROWS
    warps = -(-n // pmk.WARP)
    assert float(work["mt_warp"]) <= float(work["mt_brute_warp"]) <= warps * 4 * 36 * 4
    assert float(work["lobe"]) == float(every_work["lobe"])


def test_camera_pass_matches_jax_kernel(tmp_path):
    """The port's camera pass (plain version, chunked walk) against the
    JAX kernel's in interpret mode, every pixel of the 64x36 Debug fixture
    (max_depth 2) at sample index 0, on the JAX camera's packed lens."""
    path = _debug_fixture(tmp_path, max_depth=2)
    jjob = jax_load_scene(path)
    ctx = SceneCtx(jjob.scene)
    assert jdmk.supports_direct(ctx, jjob.integrator, None, None)
    jcam = JaxCamera(jjob.camera, jjob.film, pupil_samples=1 << 12)
    jsampler = JaxStratified(jjob.sampler, seed=0)
    n = W * H
    pid = np.arange(n, dtype=np.uint32)
    sid = np.zeros(n, np.uint32)
    pxy = np.stack([pid % W, pid // W], -1).astype(np.float32)
    jpacked = jdmk.pack_direct(ctx, jjob.integrator)
    assert jpacked[-1] is not None  # the JAX kernel culls by its chunk boxes
    l_j, w_j = jdmk.li_levels_mega_cam(
        ctx, jpacked, jpmk.pack_camera(jcam), jnp.asarray(pxy), jnp.asarray(pid),
        jnp.asarray(sid), jsampler, jjob.integrator, interpret=True,
    )
    job = load_scene(path)
    sampler = StratifiedSampler(job.sampler, seed=0)
    packed = pmk.pack_scene(job.scene, "cpu")
    l, w = dmk.li_levels_mega_cam(
        packed, camera_from_jax(jpmk.pack_camera(jcam)), torch.as_tensor(pxy),
        torch.as_tensor(pid.astype(np.int64)), torch.as_tensor(sid.astype(np.int64)), sampler,
        job.integrator,
    )
    lit = (np.asarray(w_j) > 0) & (w.numpy() > 0)
    l_j = np.where(lit[:, None], np.asarray(l_j), 0.0)
    l = np.where(lit[:, None], l.numpy(), 0.0)
    assert np.isfinite(l).all() and l_j.max() > 0
    rel = np.abs(l - l_j) / np.maximum(np.abs(l_j), 1e-3)
    assert float((rel.max(-1) > 1e-3).mean()) < 5e-3
    assert float(np.quantile(rel, 0.99)) < 1e-4
    assert abs(l.mean() - l_j.mean()) < 1e-6 + 3e-3 * abs(l_j.mean())


def test_brute_force_launch_takes_the_chunk_rows(tmp_path):
    job = load_scene(_debug_fixture(tmp_path))
    packed = pmk.pack_scene(job.scene, "cpu")
    chunks, count = pmk.chunk_args(packed, torch.device("cpu"))
    assert chunks is packed.chunks and count == packed.chunks.shape[0] == 3
    assert chunks.shape == (count, pmk.CHUNK_COLS)
    # the chunks cover the table's rows in order
    assert chunks[0, 6] == 0 and chunks[-1, 7] == packed.table.shape[0]
    assert torch.equal(chunks[1:, 6], chunks[:-1, 7])
    with pytest.raises(ValueError, match="chunk"):
        pmk.chunk_args(packed._replace(chunks=None), torch.device("cpu"))
    assert pmk.chunk_args(pmk.pack_scene(job.scene, "cpu", bvh=True), torch.device("cpu")) == (
        None, 0)
