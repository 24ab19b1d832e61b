"""K8's camera walk on its siblings' walks: the plain version
(ops/sppm_megakernel.camera_walk_reference) takes the chunked brute-force
walk (PlainGeometry with `cull`) and, over a BVH, the walk of the node64
rows, as the kernel's instances do (csrc/sppm_megakernel.cu on common.cuh's
ChunkGeometry and Bvh64Geometry).  Each finds the hits of the walk it
replaces, so every output is the same, bit for bit:

- on samples/scene_sppm.json and its glass and Disney fixtures (the wide
  instances' lobes), on every eighth pixel of the 640x360 film's box
  around the cubes, the camera walk and the walk on the same rays given
  (#10) with the chunks equal the walk over every row (`packed.chunks`
  None), with fewer Moller-Trumbore tests;
- on the SPPM grid (19,224 triangles, a BVH) on every sixteenth pixel of
  that box, the node64 walk equals the fused-children walk (`bvh.nodes64`
  None), K9's walk.

The holds against the JAX package stay in tests/test_torch_sppm.py and
tests/test_torch_sppm_wide.py.
"""

from pathlib import Path

import pytest
import torch

from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk
from rs_ray_toy_tpu_torch.render import make_sampler
from rs_ray_toy_tpu_torch.walk_ab import sppm_camera_rays, sppm_job, sppm_outputs

# several pytest workers share the host: cap torch's OpenMP threads
torch.set_num_threads(min(2, torch.get_num_threads()))


def _inputs(job, stride):
    """The camera walk's inputs of `job` on every `stride`-th pixel of the
    640x360 film's box x 120..510, y 80..270 around the cubes, the camera
    traced with 2^12 pupil samples."""
    packed = smk.pack_sppm(job.scene, "cpu")
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, pupil_samples=1 << 12))
    ys, xs = torch.meshgrid(torch.arange(80, 270, stride), torch.arange(120, 510, stride),
                            indexing="ij")
    pid = (ys * job.film.xres + xs).reshape(-1)
    pxy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(torch.float32)
    u = make_sampler(job).slot_matrix(pid, 0, smk.sppm_slots(job.integrator.max_depth))
    return packed, cam, pxy, u


def _both(packed, cam, pxy, u, depth, work=None):
    """(camera walk, the walk on its rays given), each as sppm_outputs rows."""
    cam_out = sppm_outputs(*smk.sppm_camera_mega_cam_reference(packed, cam, pxy, u, depth,
                                                               work=work))
    o, d, w = sppm_camera_rays(cam, pxy, u, depth)
    return cam_out, sppm_outputs(*smk.sppm_camera_mega_reference(packed, o, d, w, u, depth))


@pytest.mark.parametrize("scene", ["fixture", "glass", "disney"])
def test_chunked_camera_walk_equals_walk_over_every_row(tmp_path, scene):
    job = sppm_job(scene, Path(tmp_path))
    depth = job.integrator.max_depth
    packed, cam, pxy, u = _inputs(job, 8)
    assert packed.bvh is None and packed.chunks is not None
    assert smk.wide_lobes(packed) == (scene != "fixture")
    work, work_rows = {}, {}
    chunked = _both(packed, cam, pxy, u, depth, work)
    rows = _both(packed._replace(chunks=None), cam, pxy, u, depth, work_rows)
    for a, b in zip(chunked, rows):
        assert torch.equal(a, b)
    assert int(chunked[0][:, -1].sum()) > pxy.shape[0] // 50  # VPs made
    assert float(work["mt"]) < float(work_rows["mt"]) / 4
    assert float(work["mt_brute"]) == float(work_rows["mt"])


def test_node64_camera_walk_equals_fused_children_walk(tmp_path):
    job = sppm_job("grid", Path(tmp_path))
    depth = job.integrator.max_depth
    packed, cam, pxy, u = _inputs(job, 16)
    assert packed.bvh is not None and packed.bvh.nodes64 is not None
    work = {}
    node64 = _both(packed, cam, pxy, u, depth, work)
    fused = _both(packed._replace(bvh=packed.bvh._replace(nodes64=None)), cam, pxy, u, depth)
    for a, b in zip(node64, fused):
        assert torch.equal(a, b)
    assert int(node64[0][:, -1].sum()) > pxy.shape[0] // 50
    assert float(work["node"]) > 0 and float(work["closest_walks"]) > 0
