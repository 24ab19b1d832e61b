"""K9's photon walk on its siblings' walks, and K10's warp walk.

- The photon walk's plain version (ops/sppm_megakernel
  .sppm_photon_mega_reference) takes the chunked brute-force walk
  (PlainGeometry with `cull`) and, over a BVH, the walk of the node64 rows,
  as the kernel's instances do (csrc/sppm_megakernel.cu on common.cuh's
  ChunkGeometry and Bvh64Geometry).  Each finds the hits of the walk it
  replaces, so every event is the same, bit for bit: on samples/
  scene_sppm.json and its glass and Disney fixtures, seeded photons
  started at the cubes (walk_ab.surface_photons) give the same events with
  the chunks as with the walk over every row (`packed.chunks` None), with
  fewer Moller-Trumbore tests; on the SPPM grid (19,224 triangles) the
  node64 walk gives the fused-children walk's (`bvh.nodes64` None).
- The deposit kernel's walk (a warp's walking lanes read the rows of
  their ranges once, in tiles of 32 rows, and shade their own pairs after
  each tile's tests; a lane with an empty range reads nothing), twinned in
  float32 by smk.deposit_warp_walk, equals
  deposit_walk_reference bit for bit on seeded adversarial inputs: empty
  ranges, disjoint ranges in one warp, one range of 200 events, lanes
  past N, VPs that are not valid.
- pack_sppm refuses material ids outside the material rows, and an SPPM
  render reads the deposit's wide choice back once, not every iteration.

The holds against the JAX package stay in tests/test_torch_sppm.py and
tests/test_torch_sppm_wide.py.
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk
from rs_ray_toy_tpu_torch.render import render_job
from rs_ray_toy_tpu_torch.scene.loader import load_scene
from rs_ray_toy_tpu_torch.walk_ab import (SAMPLES, adversarial_deposit, sppm_job,
                                         surface_photons)

# several pytest workers share the host: cap torch's OpenMP threads
torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.mark.parametrize("scene", ["fixture", "glass", "disney"])
def test_chunked_photon_walk_equals_walk_over_every_row(tmp_path, scene):
    job = sppm_job(scene, Path(tmp_path))
    depth = job.integrator.max_depth
    packed = smk.pack_sppm(job.scene, "cpu")
    assert packed.bvh is None and packed.chunks is not None
    ph = surface_photons(job.scene, 2048, depth, "cpu")
    work, work_rows = {}, {}
    chunked = smk.sppm_photon_mega_reference(packed, *ph, depth, work=work)
    rows = smk.sppm_photon_mega_reference(packed._replace(chunks=None), *ph, depth,
                                          work=work_rows)
    for a, b in zip(chunked, rows):
        assert torch.equal(a, b)
    assert int(chunked[3].sum()) > 2048 // 8  # the photons started at the cubes deposit
    assert float(work["mt"]) < float(work_rows["mt"]) / 2
    assert float(work["mt_brute"]) == float(work_rows["mt"])


def test_node64_photon_walk_equals_fused_children_walk(tmp_path):
    job = sppm_job("grid", Path(tmp_path))
    depth = job.integrator.max_depth
    packed = smk.pack_sppm(job.scene, "cpu")
    assert packed.bvh is not None and packed.bvh.nodes64 is not None
    ph = surface_photons(job.scene, 1024, depth, "cpu")
    work = {}
    node64 = smk.sppm_photon_mega_reference(packed, *ph, depth, work=work)
    fused = smk.sppm_photon_mega_reference(
        packed._replace(bvh=packed.bvh._replace(nodes64=None)), *ph, depth)
    for a, b in zip(node64, fused):
        assert torch.equal(a, b)
    assert int(node64[3].sum()) > 1024 // 4
    assert float(work["node"]) > 0 and float(work["closest_walks"]) > 0
    assert "any_walks" not in work  # the photon walk makes closest hits only


@pytest.mark.parametrize("scene", ["scene_sppm.json", "scene_sppm_disney.json"])
def test_deposit_warp_walk_equals_range_walk(scene):
    mats = smk.resolve_mat_tables(load_scene(str(SAMPLES / scene)).scene, "cpu")
    vp, inp = adversarial_deposit(mats)
    work = {}
    phi, m = smk.deposit_warp_walk(vp, mats, inp, work)
    phi_ref, m_ref = smk.deposit_walk_reference(vp, mats, inp)
    assert torch.equal(phi, phi_ref) and torch.equal(m, m_ref)
    walking = inp.end > inp.start
    assert int(m.sum()) > 100 and float(phi.max()) > 0 and int(m[~walking].abs().sum()) == 0
    # each warp reads the rows its walking lanes' ranges hold once, in tiles
    # of 32 (so no more than the span from the lowest start to the highest
    # end), and runs the lobes as often as its busiest lane shades; only
    # walking lanes read their VP
    first = torch.nn.functional.pad(inp.start, (0, 24)).reshape(-1, pmk.WARP).long()
    last = torch.nn.functional.pad(inp.end, (0, 24)).reshape(-1, pmk.WARP).long()
    rows = torch.arange(inp.events.shape[0])
    held = ((rows >= first[..., None]) & (rows < last[..., None])).any(1)
    lanes = last > first
    span = (torch.where(lanes, last, 0).amax(1)
            - torch.where(lanes, first, 1 << 30).amin(1)).clamp(min=0)
    assert int(held.sum()) <= float(work["row_read"]) <= float(span.sum())
    assert float(work["row_read"]) < float(span.sum())  # the gaps between ranges are skipped
    assert 0 < float(work["shade_warp"]) < float(work["shade_union"])
    assert float(work["vp_read"]) == int(walking.sum())
    assert float(work["pair"]) == float((inp.end - inp.start).sum())


def test_pack_sppm_refuses_material_ids_outside_the_rows():
    job = load_scene(str(SAMPLES / "scene_sppm.json"))
    tri = job.scene.triangles
    tri.mat[5] = job.scene.materials["kind"].shape[0]
    with pytest.raises(ValueError, match="material ids"):
        smk.pack_sppm(job.scene, "cpu")


def test_sppm_render_takes_the_deposit_choice_once(tmp_path, monkeypatch):
    cfg = json.loads((SAMPLES / "scene_sppm.json").read_text())
    cfg["Film"]["xres"], cfg["Film"]["yres"] = 16, 9
    cfg["Integrator"].update(n_iters=3, photons_per_iter=256)
    shutil.copy(SAMPLES / "cube.obj", tmp_path)
    (tmp_path / "sppm.json").write_text(json.dumps(cfg))
    calls = []
    wide = smk.mats_wide
    monkeypatch.setattr(smk, "mats_wide", lambda mats: calls.append(1) or wide(mats))
    res = render_job(load_scene(str(tmp_path / "sppm.json")), torch.device("cpu"),
                     pupil_samples=1 << 10)
    assert res["fused_kernel"] == "sppm" and len(calls) == 1
    assert bool(torch.isfinite(res["rgb_srgb_input"]).all())
