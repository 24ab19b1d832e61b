"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  prints the card (nvidia-smi name and power limit), torch and
         nvcc, and builds the six kernel libraries from csrc/ (one nvcc
         each, started together) and the SAH BVH builder (g++), timed as
         set-up.
Phase 1  runs the path kernel and its plain PyTorch version on the same
         CUDA inputs, the fixture at 160x90 with all 16 spp, and holds
         them to the per-ray bar of tests/test_torch_path_kernel.py; both
         timed with CUDA events, median of 3 after one warm-up.
Phase 2  the Path main path: renders samples/scene.json at 640x360, 16
         spp, through deploy_render (the CLI's path) and checks the
         image, the PNG and that every pass launched the path kernel;
         then holds the kernel to the same per-ray bar against its plain
         version on that pass's 3.7M-ray batch, and times both there.
         This and every brute-force hold of the path kernel and K4 also
         print the chunked walk's MT and slab tests a ray, the MT tests
         the walk over every row would make, the bound of that walk
         beside the bound, and the block size, blocks per SM, registers
         and shared memory of the launch (pmk.occupancy, ik.occupancy).
Phase 3  the Debug main path: the same for samples/scene_debug.json
         (Debug, max_depth 4) through the direct kernel; then a 160x90x16
         DirectLighting variant with the one-light strategy, held to the
         same bar.
Phase 4  mesh scenes: the 1,600-cube grid (19,200 triangles of grid, 19,224
         in all, over the in-kernel BVH) written into build/chip_smoke/,
         rendered with Path at 640x360x8 through the path kernel's BVH
         branch and with Debug at 640x360x16 through the direct kernel's;
         each BVH kernel is held to the bar against its plain version (a
         masked torch stack walk) on a seeded random eighth (Path) or
         sixteenth (Debug) of the rays of its main-path batch, 230,400
         rays, so that every lane and pixel column can be among them.
Phase 5  the Volpath main path through the Volpath kernel: (a)
         samples/scene_fog.json (the fixture in a thin homogeneous fog)
         at 640x360x16; (b) the same with the JAX bench's fog_area sphere
         light at 160x90x16; (c) write_grid_fog_scene's 16^3 grid plume
         (sigma_scale 0.5, the bench's grid_fog medium) at 640x360x16;
         (d) the 19,224-triangle grid under the fixture's fog at
         640x360x8, over the BVH.  Each is held to the per-ray bar
         against the plain version, on the whole batch or a seeded random
         subset of it.  Last, the fog fixture with every cube matte at
         160x90x16, held the same way: without the glossy cubes' chaotic
         sampler, what diverges there is CUDA's logf / expf / sinf / cosf.
Phase 6  the SPPM main path through its three kernels: (a)
         samples/scene_sppm.json at 640x360, 4 iterations of 2^17 photons,
         max_depth 3, through deploy_render, one launch of each kernel per
         iteration; (b) on the inputs of that render's first iteration,
         each kernel against its plain version: the camera walk to the
         per-ray bar on ld with VP valid and material equal on 99.5% of
         the pixels and the VP record (p, wo, beta, ng, dpdu) at rtol
         2e-4 / atol 1e-5 on 99.9% of the pixels where both are valid
         and ld agrees; the photon walk's events equal on 99.5% of the
         photons with a live event in either version (at least 5 of
         them), there and on a seeded batch of 2^17 photons aimed at and
         started inside the cubes (a fifth to a third of them deposit; at
         least an eighth must); the deposit (the kernel's VPs and events,
         one sort) with M equal and phi within 1e-5 relative, on the main
         path's events and on those of the batch's first sixteenth; (c) the 19,224-triangle grid
         under the same SPPM block, 2 iterations, through the BVH
         instances of the camera and photon kernels, held the same way on
         all of its pixels and photons: few of its pixels see direct
         light, and a few chaotic glossy walks can move the mean of a
         subset past the bar, so the line also reports the camera walk's
         agreement on a seeded random eighth, there also against the plain
         version run on the CPU, and the plain version's on the card
         against the CPU; (d) the warm render's camera and photon Mrays/s.

Phase 7  the wavefront loop, whose intersection queries are kernels K4
         (brute force) and K3 (BVH closest and any hit, and the shaded
         closest hit): (a) AO on samples/scene_ao.json at 640x360, 16 spp,
         64 probes, through K4 alone (one camera and 64 probe launches a
         pass), whose chunked walk is also timed in turns against its walk
         over every row on a probe batch (t and triangle equal on every
         probe; the chunked walk, the loop's, must be the faster); (b) AO on the 19,224-triangle grid at 640x360x8: the
         shaded kernel for the camera hits, the any-hit kernel for the
         probes; (c) Path on an 80x80 grid of cubes (76,824 triangles,
         above the path kernel's 65,536) at 640x360x8, max_depth 5, which
         the render announces and sends down the wavefront loop: the
         shaded and any-hit kernels, no path-kernel launch; each kernel
         held to its plain version on a seeded sixteenth of one of its
         main-path batches (a probe batch; the camera batch and the
         bounce-0 shadow rays), the BVH closest-hit instance on 7b's probe
         batch: hit or miss equal on all but 1e-5 of the rays, where both
         hit the triangle equal and t within rtol 1e-6, the shaded
         attributes within rtol 1e-5 / atol 1e-6; (d) the wavefront
         li_path (over K4) against the path kernel on samples/scene.json
         at 160x90x16, the same estimator in two implementations, held to
         the per-ray bar (0.5% of rays past 1e-3 relative, means within
         3e-3).
Phase 8  the widened path kernel: (a) samples/scene_sphere_area.json
         (two matte spheres and a sphere light among the cubes) and (b)
         samples/scene_env.json (a unit constant environment, sampled and
         escape-only) at 640x360x16 through deploy_render, one launch of
         the camera instance a pass and no other kernel; (c) the
         19,224-triangle grid with the spheres and the sphere light at
         640x360x8 through the BVH instance; (d) the rays-in instance #3
         on 2^20 parallel rays into samples/scene_furnace.json's sphere,
         made as tests/test_furnace.py:62-88 makes them about its centre:
         every channel's mean within 0.015 rho + 0.004 of rho = 0.5, and
         escaped rays 1 within 1e-6; (e) the rays-in BVH instance #4 on
         (c)'s camera rays (render.camera_rays); (f) Path on
         scene.gen.write_wavefront_scene (a partial sphere, a distant and
         a triangle light) at 320x180x16, announced on stderr and rendered
         through the wavefront loop's K4 alone, no path-kernel launch; (g)
         the wavefront li_path against the path kernel on (a) at
         160x90x16, held as 7d.  Each path-kernel instance is held to the
         per-ray bar against its plain version on a seeded subset of its
         main-path batch.
Phase 9  the path kernel's Halton and smooth instances and K3-shaded's
         smooth instance: (a) samples/scene_halton.json (the fixture under
         a 256-sample HaltonSampler, the JAX bench's `halton` row) at
         640x360 through deploy_render, 16 passes of 3.69M rays, one launch
         of the Halton camera instance each, the slot matrix
         (HaltonSampler.slot_matrix) timed apart; (b) the fixture at
         160x90 x 6 Halton samples, one pass of six; (c) the rays-in
         Halton instance on 8d's 2^20 furnace rays, mean 0.5 within 0.0115
         and escaped rays 1 within 1e-6; (d) AO on samples/scene_ao.json
         under a 16-sample HaltonSampler through the wavefront loop, 65 K4
         launches; (e) samples/scene_smooth.json (the cubes and two smooth
         UV spheres, 1,956 triangles) at 640x360x16 through the smooth
         camera instance, and the smooth rays-in instance on its camera
         rays, then as a yardstick both timed in turns against the BVH
         instances on the same samples (pack_scene(..., bvh=True)); (f) write_smooth_grid_scene's 20 spheres (19,236
         triangles) at 640x360x8 through the smooth BVH camera instance,
         and the smooth rays-in BVH instance on its camera rays; (g) its
         80 spheres (76,836 triangles) at 640x360x8, past the path kernel:
         the wavefront loop, K3-shaded's smooth instance and K3 any hit
         (max_depth launches of each), no path-kernel launch, the smooth
         instance held as 7b holds the flat one; (h) the wavefront li_path
         (over K3, smooth) against the smooth camera instance on (e) at
         160x90x16, held as 7d; (i) the remaining instances at 640x360 x
         6 Halton samples (one pass of 1.38M rays): (e)'s fixture (Halton
         and smooth), the 19,224-triangle cube grid (BVH, Halton) and (f)'s
         grid (BVH, Halton and smooth), each camera instance through
         deploy_render and its rays-in twin on the pass's camera rays.
         Every instance is held to the per-ray bar against its plain
         version on a seeded subset of its batch.
Phase 10 every untextured material of the scene schema: (a)
         samples/scene_disney.json (the cubes in the plain Disney
         material's five lobes, a sphere in the anisotropic three-lobe
         one) at 640x360x16 through deploy_render, one launch of the
         camera instance a pass, every Disney lobe live; (b) the rays-in
         instance #3 on (a)'s camera rays, write_grid_scene's grid of
         Disney cubes (19,224 triangles) at 640x360x8 through the BVH
         instance #2, and #4 on its camera rays; (c) the Halton instance
         on the Disney fixture at 640x360 x 6 Halton samples, and the
         smooth instance on samples/scene_smooth.json in the Disney
         materials at 640x360x16; each held to the per-ray bar against
         its plain version on a seeded subset; (d)
         samples/scene_materials.json (Oren-Nayar matte, Translucent, a
         Mix of matte and metal, rough glass, a thin and a transmissive
         Disney material) at 640x360x16 through deploy_render, announced
         on stderr and rendered through the wavefront loop's K4 alone,
         no path-kernel launch, and its li_path on the card against the
         same on the CPU on 80x45x16 camera rays, held as 7d and over its
         lit rays (at least 1,000, under 0.5% of them past 1e-3).
Phase 11 subsurface Path, the path kernel's BSSRDF instances: (a)
         samples/scene_sss.json (every cube in the bench's mat_sss, the
         JAX bench's `sss` row) at 640x360x16 through deploy_render, one
         launch of the subsurface camera instance a pass; (b) its grid
         (19,224 triangles in mat_sss) at 640x360x8 through the BVH
         instance #2; (c) the rays-in instances #3 and #4 on (a)'s and
         (b)'s camera rays; (d) the Halton instances, camera and rays-in,
         on both at 640x360 x 6 Halton samples; each held to the per-ray
         bar against its plain version on a seeded subset; (e)
         samples/scene_sss_mixed.json (two cubes in mat_sss, one matte,
         a sphere light) at 640x360x16 through deploy_render, announced
         on stderr and rendered through the wavefront loop's K4 alone
         (the probe chain's closest hits among its queries), and its
         li_path on the card against the same on the CPU on 160x90x16
         camera rays, held as 7d; then its grid (the first cube replaced
         by 19,200 triangles in mat_sss) through the wavefront loop over
         K3: shaded, any-hit and, for the probe chain, closest-hit
         launches (the `bvh` entry's `closest_launches`), no other; the
         closest-hit instance held to its plain version as in 7 on the
         chain's first batch (segments cut off at seg_len (1 - 1e-4)), its
         times the `bvh` entry's `closest_ms`, `closest_plain_ms` and
         `closest_bound_ms`; and the grid's li_path on the card against
         the CPU on 80x45x16 camera rays.  Every hold of this phase also
         meets the bar over its lit rays alone (a reference ray with any
         radiance, at least 1,000 of them): under 0.5% of them past 1e-3
         relative and, where kernel and plain version trace the same rays
         (not the camera instances), their 99th percentile under 1e-5.
Phase 12 textured Path and the repairs: (a) K7, the EWA texture tap, alone
         (csrc/texture_kernel.cu) on 2^20 seeded lookups of
         samples/tex_checker.png's pyramid in each of the three wraps, with
         anisotropic, clamped and degenerate footprints, against its plain
         version (scene/mipmap.ewa_lookup): max relative error (floor
         1e-6) under 1e-5; (b, d) samples/scene_textured.json (every cube's
         kd the image) at 640x360x16 through deploy_render, the CLI's path:
         the PNG written, nothing on stderr, one launch of the textured
         camera instance a pass, and that instance held to its plain
         version on a seeded eighth of one pass, also over its lit rays
         (at least 1,000, under 0.5% past 1e-3); (c) write_grid_scene's
         textured grid (19,224 triangles) at 640x360x8 through the textured
         BVH instance, held the same way on a sixteenth; (e) the scenes the
         port once refused, at 160x90: samples/scene_fog.json under Path through the
         path kernel (the camera medium ignored), samples/scene.json at
         max_depth 20 through the wavefront loop (announced), a 112x112
         grid (150,552 triangles) under AO and Path over K3, and
         write_deep_bvh_scene's tree of 101 levels over 2,180 triangles
         under Path, past the path kernel (announced) through K3's deep
         instances, their shaded and any-hit walks held as 7b holds on
         2^17 seeded rays aimed at the tree (the plain version on an
         eighth, at least 1,000 hits each).
Phase 13 Debug and DirectLighting past the direct kernel, and the rays-in
         kernels #6, #8 and #10: (a) samples/scene_materials.json under
         Debug with its rough glass made smooth (both specular children
         live: four tree levels, eight rays a camera ray at the deepest,
         traced in chunks of camera rays) and samples/scene_sphere_area.json
         under DirectLighting ("all"), each written into build/chip_smoke/
         and rendered at 640x360x16 through deploy_render: announced on
         stderr, K4 alone, its launches per pass, coloured pixels, first
         and warm camera Mrays/s and the peak device memory; the wavefront
         li_levels on the card against the same on the CPU on a seeded
         64th of one pass's camera rays, at the per-ray bar (at least
         1,000 lit rays); (b) the DirectLighting white furnace ("one",
         max_depth 2) on 2^20 rays about samples/scene_furnace.json's
         sphere (no triangle: no kernel launch): mean 0.5 within 0.0115,
         escaped rays 1 within 1e-6; (c)
         the direct kernel's rays-in instances #6 on the host-traced camera
         rays (render.camera_rays) of one pass of samples/scene_debug.json
         and of the Debug grid over the BVH, (d) the Volpath kernel's #8 on
         those of samples/scene_fog.json and of the fog grid over the BVH
         (640x360x8), (e) the SPPM camera walk's #10 on the first
         iteration's camera rays of samples/scene_sppm.json and of phase
         6c's grid, its slot matrix filled on the host from the render's
         Halton sampler (equal to K8's); each launched once with the counts
         at 0, held to its plain version at the per-ray bar on a seeded
         subset (#10 on every pixel, VP valid and material equal on 99.5%),
         and its output against the camera instance's on the same samples
         reported (rays apart, relative mean difference).
Phase 14 SPPM on glass and Disney materials, and K3's BVH4 walk: (a)
         samples/scene_sppm_glass.json (the matte cube smooth glass:
         specular reflection and transmission) and (b)
         samples/scene_sppm_disney.json (it the five-lobe Disney material)
         at 640x360, 4 iterations of 2^17 photons, through deploy_render,
         one launch of each SPPM kernel's wide instance per iteration and
         none of the base ones, each kernel held to its plain version as
         in phase 6 (the camera walk, the photon walk on the main path's
         and the seeded surface batch's photons, the deposit); then each
         fixture's grid (its first material's 1,600 cubes, 19,224
         triangles) at 2 iterations over the wide BVH instances, held the
         same way; (c) #10's wide instances on the glass fixture's and the
         Disney grid's first iteration's camera rays, held as in 13e; (d)
         AO on phase 7b's grid, one pass at 8 spp over the BVH4 walk (the
         loop's walk is the binary one; pack_bvh(..., wide=True)), 64
         BVH4 any-hit launches, counts at 0 just before, and on its first
         probe batch the BVH4 any hit held to its plain version as 7b holds
         K3 and to the binary instance (hit or miss equal on all but 1e-5
         of the rays); (e) the same closest and any hit on phase 7c's
         76,824-triangle grid's camera rays and bounce-0 shadow rays; (f)
         on phase 12e's 101-level tree (the BVH4's deep instances) on 2^17
         rays aimed at it; each walk timed against the binary one on the
         same rays, in turns.

Every driven main path starts with all launch counts at 0 and must show
the launches of its kernels (one per pass, or per query of the wavefront
loop) and none of the others.  Every phase
prints one line; any failure raises and exits non-zero.  The
second-to-last line is a JSON record of the 54 kernels (K7's entry names
the textured instance it runs inside, whose launches it carries, and its
launches alone in 12a), the last line
{"ok": true, "device": {...}}.  A fuller record goes to
build/chip_smoke/chip_smoke.json and the images beside it.  Without a
CUDA device, or without the rest of the repository, it exits non-zero
before printing any result.

Each kernel's `bound_ms` is the least time the card could take for the
pass: the larger of its bytes over 3.35 TB/s and its FP32 operations
over 67 TFLOP/s (the H100 SXM data sheet).  The bytes are each ray's 16
in and 16 out, of each BVH node once its two child boxes and its offset,
count and axis, and of each triangle's row once the columns a kernel
reads: the 9 geometry columns, the 7 of normal, dpdu and lobe count, and
16 per lobe of its material; the raw normals are never read, the
texture block only by the textured instances, with the image's texels:
the pyramid once, or the texels the taps weigh (12 bytes each) where
they are fewer; of each sphere row its 13 intersect columns, 12 of
object-to-world, 2 of lobe count and eta and 16 per lobe.  A rays-in
instance moves per ray its origin, direction, weight, pixel id and sample
index in (36 bytes) and L out (12); the SPPM walk's rays-in instance its
origin, direction and weight in (28 bytes) and ld and the VP record out.  Under a HaltonSampler an instance
reads no pixel id or sample index but the values of the slot matrix
(SLOT_BYTES each) that the plain version counts as read ("slot"): the
film and lens values of every camera ray, and per vertex reached the
light pick and light sample, the environment's BSDF sample where the
environment was picked, the BSDF sample, and the roulette value where it
is drawn; on a smooth mesh each triangle row's 9 raw normal columns
count too.  For the Volpath kernel the
density grid is read once too.  The operations are the Moller-Trumbore tests (45 each), slab
tests (27; a brute-force walk's are its chunk box tests, and its MT
tests those its chunked walk makes), sphere tests (30: the object-space quadratic and its roots;
the ray's transform into the sphere is left out), lobe evaluations (3,
lambert's; a floor) and the grid
tracking steps' trilinear density taps (40: the point and its scaled
coordinates, 12, and seven lerps of 4), and for the Disney lobes the
operations of their f and pdf beyond those 3 ("disney_ops",
ops/path_megakernel.DISNEY_OPS, counted from common.cuh: f / pdf 41 / 10
diffuse, 50 / 10 retro, 47 / 10 sheen, 81 / 62 clearcoat with log10f as
16, 201 / 100 microfacet with the Disney fresnel), the textured taps'
weighed texels (10 each) and the two differential rays' lens traces of
each ray whose first hit is textured, the only rays that read them (the
fixture's lens: 110, 94 for each of its 10 refracting surfaces and 15
at its stop, counted from common.cuh's raygen_u) that the plain version
counts on the same inputs, scaled by the batch over the subset where it ran on a
subset; the lens trace, the sampler hashes, the shading, the light
sampling and the medium's closed forms are left out, so the bound is a
lower one.  The SPPM walks count their bytes the same way, with only the
sampler values the plain version counts as read ("slot", 4 bytes each):
per pixel its raster position in, the film and lens slots and per
vertex reached the light pick, the BSDF pair and the roulette value
where it is drawn, and ld and the VP record out; per photon its flag in
and two events out, its ray and power where it is active, and the
bounce and roulette uniforms of the vertices it reaches.  The deposit
reads each VP's range and writes its phi and M, reads the rest of the VP
(p, wo, ng, dpdu, material, r^2) where the range holds events, and reads
once each sorted event that some range holds (40 bytes), not the dead
or out-of-grid ones sorted past every range; its operations are the
(VP, event) pairs its ranges walk (9 each: the distance and its
compare) and 3 per lobe evaluation of the near pairs.  The intersection
kernels move per ray its origin, direction and t_max in (28 bytes) and t
and the triangle out (8; the shaded kernel also material, area light and
16 attribute floats), and read once the triangles' intersect columns (36
bytes, and their original row in BVH mode), the BVH nodes as above and,
for the shaded kernel, the 15 shade floats (31 smooth, which also
writes 6 attribute floats more a ray) and 2 ints of each triangle;
their operations are the Moller-Trumbore and slab tests the plain
version counts.  The BVH4 walk reads each wide node's 144 bytes once
instead of the binary nodes, and its plain version counts a slab test
for each non-empty child slot it tests.  No single PyTorch call computes a sample pass, any of
the SPPM kernels, or a closest hit over a triangle list or a BVH:
`library_ms` is null.  A path-kernel instance held on a subset gives as
`plain_ms` the time of the plain version's one run there, the run that
counts its work.
"""

import contextlib
import copy
import io
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
from rs_ray_toy_tpu_torch.integrators import sppm
from rs_ray_toy_tpu_torch.integrators.ao import li_ao
from rs_ray_toy_tpu_torch.integrators.common import SceneCtx
from rs_ray_toy_tpu_torch.integrators.direct import li_levels
from rs_ray_toy_tpu_torch.integrators.path import li_path
from rs_ray_toy_tpu_torch.ops import _build
from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
from rs_ray_toy_tpu_torch.ops import direct_megakernel as dmk
from rs_ray_toy_tpu_torch.ops import intersect_kernel as ik
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk
from rs_ray_toy_tpu_torch.ops import texture as tex_ops
from rs_ray_toy_tpu_torch.ops import volpath_megakernel as vmk
from rs_ray_toy_tpu_torch.render import (
    camera_rays,
    deploy_render,
    make_sampler,
    pass_spp,
    render_job,
    sample_batch,
)
from rs_ray_toy_tpu_torch.sampler.halton import HaltonSampler
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import (
    THIN_FOG,
    write_fog_scene,
    write_grid_fog_scene,
    write_deep_bvh_scene,
    write_grid_scene,
    write_smooth_grid_scene,
    write_variant,
    write_wavefront_scene,
)
from rs_ray_toy_tpu_torch.scene import mipmap
from rs_ray_toy_tpu_torch.scene.loader import SamplerSpec
from rs_ray_toy_tpu_torch.scene.loader import load_scene
from rs_ray_toy_tpu_torch.scene.png import load_image

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "samples" / "scene.json"
SCENE_DEBUG = ROOT / "samples" / "scene_debug.json"
SCENE_FOG = ROOT / "samples" / "scene_fog.json"
SCENE_SPPM = ROOT / "samples" / "scene_sppm.json"
SCENE_AO = ROOT / "samples" / "scene_ao.json"
SCENE_SPHERE_AREA = ROOT / "samples" / "scene_sphere_area.json"
SCENE_ENV = ROOT / "samples" / "scene_env.json"
SCENE_FURNACE = ROOT / "samples" / "scene_furnace.json"
SCENE_HALTON = ROOT / "samples" / "scene_halton.json"
SCENE_SMOOTH = ROOT / "samples" / "scene_smooth.json"
SCENE_DISNEY = ROOT / "samples" / "scene_disney.json"
SCENE_MATERIALS = ROOT / "samples" / "scene_materials.json"
SCENE_SSS = ROOT / "samples" / "scene_sss.json"
SCENE_SSS_MIXED = ROOT / "samples" / "scene_sss_mixed.json"
SCENE_TEXTURED = ROOT / "samples" / "scene_textured.json"
SCENE_SPPM_GLASS = ROOT / "samples" / "scene_sppm_glass.json"
SCENE_SPPM_DISNEY = ROOT / "samples" / "scene_sppm_disney.json"
HALTON6 = {"sampler_type": "HaltonSampler", "nsamp": 6}
OUT = ROOT / "build" / "chip_smoke"
PATH_SRC = "rs_ray_toy_tpu_torch/csrc/path_megakernel.cu"
DIRECT_SRC = "rs_ray_toy_tpu_torch/csrc/direct_megakernel.cu"
VOLPATH_SRC = "rs_ray_toy_tpu_torch/csrc/volpath_megakernel.cu"
SPPM_SRC = "rs_ray_toy_tpu_torch/csrc/sppm_megakernel.cu"
SPPM_REF = "rs_ray_toy_tpu/ops/sppm_megakernel.py"
INTERSECT_SRC = "rs_ray_toy_tpu_torch/csrc/intersect_kernel.cu"
BVH_SRC = "rs_ray_toy_tpu_torch/csrc/bvh_kernel.cu"
TEX_SRC = "rs_ray_toy_tpu_torch/csrc/texture.cuh"
KERNELS = {
    "path_mega_cam": dict(source=PATH_SRC, replaces="rs_ray_toy_tpu/ops/path_megakernel.py:3814"),
    "path_mega_cam_bvh": dict(
        source=PATH_SRC, replaces="rs_ray_toy_tpu/ops/path_megakernel.py:3843"
    ),
    "path_mega": dict(source=PATH_SRC, replaces="rs_ray_toy_tpu/ops/path_megakernel.py:3352"),
    "path_mega_bvh": dict(source=PATH_SRC, replaces="rs_ray_toy_tpu/ops/path_megakernel.py:3375"),
    "direct_mega_cam": dict(
        source=DIRECT_SRC, replaces="rs_ray_toy_tpu/ops/direct_megakernel.py:678"
    ),
    "direct_mega_cam_bvh": dict(
        source=DIRECT_SRC, replaces="rs_ray_toy_tpu/ops/direct_megakernel.py:706"
    ),
    "volpath_mega_cam": dict(
        source=VOLPATH_SRC, replaces="rs_ray_toy_tpu/ops/volpath_megakernel.py:1111"
    ),
    "volpath_mega_cam_bvh": dict(
        source=VOLPATH_SRC, replaces="rs_ray_toy_tpu/ops/volpath_megakernel.py:1145"
    ),
    "sppm_camera_mega_cam": dict(source=SPPM_SRC, replaces=f"{SPPM_REF}:636"),
    "sppm_camera_mega_cam_bvh": dict(source=SPPM_SRC, replaces=f"{SPPM_REF}:667"),
    "sppm_photon_mega": dict(source=SPPM_SRC, replaces=f"{SPPM_REF}:1391"),
    "sppm_photon_mega_bvh": dict(source=SPPM_SRC, replaces=f"{SPPM_REF}:1407"),
    "sppm_deposit_mega": dict(source=SPPM_SRC, replaces=f"{SPPM_REF}:923"),
    "intersect": dict(source=INTERSECT_SRC, replaces="rs_ray_toy_tpu/ops/intersect_pallas.py:46"),
    # both instances of the walk: closest hit and any hit
    "bvh": dict(source=BVH_SRC, replaces="rs_ray_toy_tpu/ops/bvh_pallas.py:249"),
    "bvh_shaded": dict(source=BVH_SRC, replaces="rs_ray_toy_tpu/ops/bvh_pallas.py:400"),
}
# the path kernel's Halton and smooth instances (phase 9), each replacing
# the JAX body of its (camera or rays-in, brute force or BVH) kernel
for _base, _bvh, _line in (("path_mega_cam", False, 3814), ("path_mega_cam", True, 3843),
                           ("path_mega", False, 3352), ("path_mega", True, 3375)):
    for _halton, _smooth in ((True, False), (False, True), (True, True)):
        KERNELS[pmk.kernel_name(_base, _bvh, _halton, _smooth)] = dict(
            source=PATH_SRC, replaces=f"rs_ray_toy_tpu/ops/path_megakernel.py:{_line}")
# its subsurface instances (phase 11), each replacing the same JAX body
for _base, _bvh, _line in (("path_mega_cam", False, 3814), ("path_mega_cam", True, 3843),
                           ("path_mega", False, 3352), ("path_mega", True, 3375)):
    for _halton in (False, True):
        KERNELS[pmk.kernel_name(_base, _bvh, _halton, bss=True)] = dict(
            source=PATH_SRC, replaces=f"rs_ray_toy_tpu/ops/path_megakernel.py:{_line}")
KERNELS["bvh_shaded_smooth"] = dict(source=BVH_SRC,
                                    replaces="rs_ray_toy_tpu/ops/bvh_pallas.py:400")
# the textured instances (phase 12) and K7, the tap inside them (its own
# entry point: csrc/texture_kernel.cu)
KERNELS["path_mega_cam_tex"] = dict(source=PATH_SRC,
                                    replaces="rs_ray_toy_tpu/ops/path_megakernel.py:3814")
KERNELS["path_mega_cam_bvh_tex"] = dict(source=PATH_SRC,
                                        replaces="rs_ray_toy_tpu/ops/path_megakernel.py:3843")
KERNELS["tex_lookup"] = dict(source=TEX_SRC, replaces="rs_ray_toy_tpu/ops/tex_tile.py:211")
# the rays-in instances of the direct, Volpath and SPPM camera kernels (phase 13)
KERNELS["direct_mega"] = dict(source=DIRECT_SRC,
                              replaces="rs_ray_toy_tpu/ops/direct_megakernel.py:573")
KERNELS["direct_mega_bvh"] = dict(source=DIRECT_SRC,
                                  replaces="rs_ray_toy_tpu/ops/direct_megakernel.py:594")
KERNELS["volpath_mega"] = dict(source=VOLPATH_SRC,
                               replaces="rs_ray_toy_tpu/ops/volpath_megakernel.py:986")
KERNELS["volpath_mega_bvh"] = dict(source=VOLPATH_SRC,
                                   replaces="rs_ray_toy_tpu/ops/volpath_megakernel.py:1015")
KERNELS["sppm_camera_mega"] = dict(source=SPPM_SRC, replaces=f"{SPPM_REF}:437")
KERNELS["sppm_camera_mega_bvh"] = dict(source=SPPM_SRC, replaces=f"{SPPM_REF}:461")
# the SPPM kernels' wide instances (glass and Disney lobes) and K3's BVH4
# walk, closest and any hit (phase 14)
for _name in ("sppm_camera_mega_cam", "sppm_camera_mega_cam_bvh", "sppm_camera_mega",
              "sppm_camera_mega_bvh", "sppm_photon_mega", "sppm_photon_mega_bvh",
              "sppm_deposit_mega"):
    KERNELS[_name + "_wide"] = KERNELS[_name]
KERNELS["bvh4"] = dict(source=BVH_SRC, replaces="rs_ray_toy_tpu/ops/bvh_pallas.py:591")
# FP32 operations per counted test, density tap or walked deposit pair
FLOPS = {"mt": 45, "slab": 27, "sph": 30, "lobe": 3, "track": 40, "pair": 9, "disney_ops": 1,
         "texel": 10, "fd_ray": 110 + 94 * 10 + 15}
# module: (kernel wrapper, plain version, packing)
PASSES = {
    pmk: (pmk.li_path_mega_cam, pmk.li_path_mega_cam_reference, pmk.pack_scene),
    dmk: (dmk.li_levels_mega_cam, dmk.li_levels_mega_cam_reference, pmk.pack_scene),
    vmk: (vmk.li_volpath_mega_cam, vmk.li_volpath_mega_cam_reference, vmk.pack_volpath),
}
PEAK_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
RAY_BYTES = 8 + 4 + 4 + 12 + 4  # pixel_xy, pixel id, sample index in; L, weight out
RAYS_IN_BYTES = 12 + 12 + 4 + 4 + 4 + 12  # o, d, weight, pixel id, sample index in; L out
SPH_ROW_COLS = 13 + 12 + 2  # w2o rows and radius; o2w rows; lobe count and eta
SLOT_BYTES = 4  # a sampler value the plain version counts as read ("slot")
SPPM_CAM_BYTES = 8 + 12 + 5 * 12 + 4 + 4  # pixel_xy in; ld, the VP record, mat, valid out
SPPM_RAYS_BYTES = SPPM_CAM_BYTES - 8 + 12 + 12 + 4  # o, d, weight in instead of pixel_xy
SPPM_PHOTON_BYTES = 4 + 2 * (36 + 4)  # the flag in; two events out
PHOTON_RAY_BYTES = 36  # an active photon's ray and power in
VP_BYTES = 8 + 12 + 4  # every VP: its range in; phi, M out
VP_WALK_BYTES = 4 * 12 + 4 + 4  # a VP with events in its range: p, wo, ng, dpdu, mat, r^2
EVENT_BYTES = 40  # a sorted event row
PHOTON_FLOOR = 5  # photons with a live event the main-path photon hold needs
ROW_HEAD_COLS = 9 + 7  # p0, e1, e2; ng, dpdu, lobe count
NORMAL_COLS = 9  # a smooth mesh's raw vertex normals n0, n1, n2
LOBE_COLS = 16
NODE_READ_COLS = 12 + 3  # both child boxes; offset, n_prims, axis
NODE4_BYTES = (24 + 12) * 4  # a wide node: four child boxes; their kind, a, b
QUERY_BYTES = 28 + 8  # o, d, t_max in; t, triangle out
SHADED_OUT_BYTES = 4 * 4 + 16 * 4  # t, triangle, material, area light; 16 attribute floats
MISS_HOLD = 1e-5  # hit or miss may differ on this share of the held rays (ties)
TEXEL_BYTES = 12  # an RGB float32 texel
TEX_BLOCK_COLS = 10  # a textured row's dpdv, uv0, uv1, uv2 and flag
TEX_QUERY_BYTES = 8 + 16 + 12  # st, the two footprint axes in; RGB out


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def timed_ms(fn, reps=3):
    """Median CUDA-event milliseconds of `reps` runs after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_once(fn):
    """(result, CUDA-event milliseconds) of one run (no warm-up)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def once_ms(fn):
    """CUDA-event milliseconds of one run (no warm-up)."""
    return timed_once(fn)[1]


def q99(rel):
    return float(torch.quantile(rel.flatten()[:: max(1, rel.numel() // 2**24)], 0.99))


def lit_stats(rel, l_ref):
    """The bar's shares over the lit rays alone (a reference ray with any
    radiance): most rays of these scenes are black on both sides."""
    lit = l_ref.amax(-1) > 0
    rel_lit = rel[lit]
    return dict(lit=int(lit.sum()),
                lit_diverged=float((rel_lit.amax(-1) > 1e-3).double().mean()),
                lit_q99=q99(rel_lit) if rel_lit.numel() else float("nan"))


def check_lit(stats, tag, same_rays=True):
    """The per-ray bar over the lit rays alone, on at least 1,000 of them:
    under 0.5% past 1e-3 relative and, where both sides trace the same
    rays (`same_rays`), the 99th percentile under 1e-5.  A camera
    instance traces its own lens rays, which differ from its plain
    version's in the last bits; through the subsurface walk that puts the
    lit rays' 99th percentile at 2-3e-5 (H100), so there only the share
    is held."""
    check(stats["lit"] >= 1000, f"{tag}: {stats['lit']} lit rays")
    check(stats["lit_diverged"] < 5e-3,
          f"{tag}: {stats['lit_diverged']:.2%} of the lit rays diverged")
    if same_rays:
        check(stats["lit_q99"] < 1e-5, f"{tag}: lit 99th percentile {stats['lit_q99']:.3g}")


def per_ray_bar(l, l_ref):
    """tests/test_megakernel.py:127-132; returns the measured numbers, the
    shares over the lit rays among them."""
    l, l_ref = l.double(), l_ref.double()
    check(bool(torch.isfinite(l).all()), "non-finite kernel radiance")
    check(float(l_ref.max()) > 0, "plain version rendered nothing")
    rel = (l - l_ref).abs() / l_ref.abs().clamp(min=1e-3)
    stats = dict(
        diverged=float((rel.amax(-1) > 1e-3).double().mean()),
        q99=q99(rel),
        mean=float(l.mean()),
        mean_ref=float(l_ref.mean()),
        **lit_stats(rel, l_ref),
    )
    check(stats["diverged"] < 5e-3, f"{stats['diverged']:.2%} of rays diverged")
    check(stats["q99"] < 1e-5, f"99th percentile relative difference {stats['q99']:.3g}")
    check(
        abs(stats["mean"] - stats["mean_ref"]) < 1e-6 + 3e-3 * abs(stats["mean_ref"]),
        f"means {stats['mean']:.6g} vs {stats['mean_ref']:.6g}",
    )
    return stats


def bound(work, scale, n_rays, packed, ray_bytes=RAY_BYTES, extra_bytes=0):
    """(bound_ms, bound_by) of one pass over n_rays (see the module
    docstring); `work` is the plain version's counts, `scale` the batch
    over the rays it ran on; `packed` None for no triangle table."""
    flops = scale * sum(FLOPS[k] * float(v) for k, v in work.items() if k in FLOPS)
    nbytes = n_rays * ray_bytes + extra_bytes + scale * SLOT_BYTES * float(work.get("slot", 0))
    if packed is not None:
        head = ROW_HEAD_COLS + (NORMAL_COLS if getattr(packed, "smooth", False) else 0)
        nbytes += int((head + LOBE_COLS * packed.table[:, 15]).sum()) * 4
    sph = getattr(packed, "sph_table", None)
    if sph is not None:
        nbytes += int((SPH_ROW_COLS + LOBE_COLS * sph[:, 15]).sum()) * 4
    tex = getattr(packed, "tex", None)
    if tex is not None:
        nbytes += packed.table.shape[0] * TEX_BLOCK_COLS * 4
        nbytes += tex_bytes(tex.pyr, scale * float(work.get("texel", 0)))
    if packed is not None and packed.bvh is not None:
        nbytes += packed.bvh.nodes_f.shape[0] * NODE_READ_COLS * 4
    if getattr(packed, "grid", False):
        nbytes += packed.medium["density"][0].numel() * 4
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def walk_numbers(work, scale, n_rays, bound_fn):
    """The chunked brute-force walk's counts per ray (MT tests, chunk slab
    tests, and the MT tests the walk over every row would make:
    "mt_brute") and the bound of that walk over every row: `bound_fn`
    (work -> (ms, by)) on the same counts with mt_brute's MT tests and no
    slab test.  Empty for a walk that counts no "mt_brute"."""
    if "mt_brute" not in work:
        return {}
    per_ray = lambda k: scale * float(work.get(k, 0)) / n_rays
    brute = {k: v for k, v in work.items() if k not in ("mt", "slab")}
    brute["mt"] = work["mt_brute"]
    bound_brute_ms, bound_brute_by = bound_fn(brute)
    return dict(mt_per_ray=per_ray("mt"), slab_per_ray=per_ray("slab"),
                mt_brute_per_ray=per_ray("mt_brute"), bound_brute_ms=bound_brute_ms,
                bound_brute_by=bound_brute_by)


def walk_text(held):
    """The walk's counts, brute-force bound and occupancy of a hold, for
    its line (empty for the walks that count none)."""
    if "bound_brute_ms" not in held:
        return ""
    occ = held.get("occupancy")
    occ_s = (f"; block {occ['block']}, {occ['blocks_per_sm']} blocks/SM, {occ['registers']} "
             f"registers, {occ['smem']} B shared" if occ else "")
    return (f"; walk: {held['mt_per_ray']:.2f} MT and {held['slab_per_ray']:.2f} slab tests a ray "
            f"(every row: {held['mt_brute_per_ray']:.2f} MT), bound over every row "
            f"{held['bound_brute_ms']:.4f} ms by {held['bound_brute_by']}{occ_s}")


def tex_bytes(pyr, texels):
    """Texel bytes a tap batch must read: the pyramid once, or where the
    taps weigh fewer texels than it holds, those."""
    return min(pyr.data.numel() * 4, texels * TEXEL_BYTES)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


COUNTS = (pmk.LAUNCHES, dmk.LAUNCHES, vmk.LAUNCHES, smk.LAUNCHES, ik.LAUNCHES, bk.LAUNCHES,
          tex_ops.LAUNCHES)


def zero_counts():
    for counts in COUNTS:
        for k in counts:
            counts[k] = 0


def all_counts():
    return {k: v for counts in COUNTS for k, v in counts.items()}


def drive(scene, png, kernel, fused, spp_override=None):
    """One main path through deploy_render with every count set to 0 just
    before; checks the image and that `kernel`, and no other, launched
    once per pass.  Returns (result, coloured pixels, launches)."""
    zero_counts()
    res = deploy_render(str(scene), str(png), spp_override=spp_override)
    counts = all_counts()
    rgb = res["rgb_srgb_input"]
    check(bool(torch.isfinite(rgb).all()), f"{png.name}: non-finite image")
    check(png.exists() and png.stat().st_size > 0, f"{png.name}: no PNG written")
    colored = int((rgb.sum(-1) > 0).sum())
    check(colored > 0, f"{png.name}: no coloured pixels")
    check(res["fused_kernel"] == fused and res["render_path"] == "megakernel",
          f"{png.name}: wrong path")
    check(counts[kernel] == res["passes"] > 0,
          f"{png.name}: {counts[kernel]} {kernel} launches for {res['passes']} passes")
    check(sum(counts.values()) == counts[kernel], f"{png.name}: other kernels launched: {counts}")
    return res, colored, counts[kernel]


def halton_slots(packed, spec, sampler, with_cam):
    """The used_slots of the Halton slot matrix, or None for the
    stratified sampler."""
    if not isinstance(sampler, HaltonSampler):
        return None
    return pmk.packed_slots(packed, spec, with_cam)


def hold(mod, job, stride, dev):
    """The kernel against its plain version on the main path's batch for
    `job` (one pass): the kernel on the whole batch, the plain version on
    a seeded random 1/`stride` of its rays.  Returns the measured numbers;
    under a HaltonSampler also the slot matrix's ms ("slot_ms")."""
    fn, ref, pack = PASSES[mod]
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, device=dev))
    packed = pack(job.scene, dev)
    sampler = make_sampler(job)
    pxy, pid, soff = sample_batch(job.film, pass_spp(sampler.spp), dev)
    args = (packed, cam, pxy, pid, soff, sampler, job.integrator)
    l, w = fn(*args)
    torch.cuda.synchronize()
    n = pxy.shape[0]
    pick = torch.randperm(n, generator=torch.Generator().manual_seed(stride))[: n // stride]
    sub = pick.sort().values.to(dev)
    scale = n / sub.numel()
    sub_args = (packed, cam, pxy[sub], pid[sub], soff[sub], sampler, job.integrator)
    work = {}
    (l_ref, w_ref), plain_ms = timed_once(lambda: ref(*sub_args, work=work))
    bar = per_ray_bar(l[sub], l_ref)
    max_abs_err = max(float((l[sub] - l_ref).abs().max()), float((w[sub] - w_ref).abs().max()))
    del l, w, l_ref, w_ref
    ms = timed_ms(mod.prepare_launch(*args), reps=10)
    extra = {"occupancy": pmk.occupancy()} if mod is pmk and packed.bvh is None else {}
    wrapper_ms = timed_ms(lambda: fn(*args))
    slots = halton_slots(packed, job.integrator, sampler, True)
    # under Halton the kernel reads no pixel id or sample index, but slot values
    ray_bytes = RAY_BYTES - (8 if slots else 0)
    bound_ms, bound_by = bound(work, scale, n, packed, ray_bytes=ray_bytes)
    extra.update(walk_numbers(work, scale, n,
                              lambda w: bound(w, scale, n, packed, ray_bytes=ray_bytes)))
    if slots is not None:
        extra["slot_ms"] = timed_ms(lambda: sampler.slot_matrix(pid, soff, slots))
        extra["slot_rows"] = pmk.slot_cols(slots)[1]
    return dict(
        rays=n, plain_rays=pxy[sub].shape[0], bvh=packed.bvh is not None,
        grid=getattr(packed, "grid", False),
        max_abs_err=max_abs_err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by,
        work={k: float(v) * scale for k, v in work.items()}, **bar, **extra,
    )


def add_entry(kernels, name, launches, held, extra_err=0.0):
    """kernels[name]: the `kernels` line's entry from a hold's numbers."""
    kernels[name] = dict(
        name=name, route="cuda", **KERNELS[name], launches=launches,
        max_abs_err=max(held["max_abs_err"], extra_err), ms=held["ms"],
        plain_ms=held["plain_ms"], bound_ms=held["bound_ms"], bound_by=held["bound_by"],
        library_ms=None, rays=held["rays"], plain_rays=held["plain_rays"],
    )


def warm_rates(job, dev, n=3):
    return [render_job(job, dev)["mrays_per_s"] for _ in range(n)]


def describe(tag, res, launches, colored, held, warm, card):
    slot = (f"slot matrix {held['slot_ms']:.3f} ms ({held['slot_rows']} rows); "
            if "slot_ms" in held else "")
    return (
        f"{tag}: {res['camera_rays']} rays in {res['passes']} pass(es), {launches} launch(es), "
        f"{colored} coloured px; first render {res['mrays_per_s']:.2f} Mrays/s, warm "
        f"{', '.join(f'{m:.1f}' for m in warm) or '-'} Mrays/s; kernel {held['ms']:.3f} ms "
        f"(wrapper {held['wrapper_ms']:.3f} ms) over {held['rays']} rays, {slot}bound "
        f"{held['bound_ms']:.4f} ms by {held['bound_by']}; plain {held['plain_ms']:.1f} ms over "
        f"{held['plain_rays']} rays; kernel vs plain: diverged {held['diverged']:.2e}, q99 "
        f"{held['q99']:.2e} ({held['lit']} lit: {held['lit_diverged']:.2e}, "
        f"{held['lit_q99']:.2e}), mean {held['mean']:.6g} vs {held['mean_ref']:.6g}, "
        f"max_abs_err {held['max_abs_err']:.3g}{walk_text(held)} [{card}]"
    )


def main():
    record = {}
    # ---- phase 0: the card, the toolchain, the builds ----
    check(torch.cuda.is_available(), "no CUDA device")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    nvcc = run([_build.nvcc_path(), "--version"]).splitlines()[-1]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        builds = {
            name: pool.submit(_build.build, name)
            for name in ("path_megakernel", "direct_megakernel", "volpath_megakernel",
                         "sppm_megakernel", "intersect_kernel", "bvh_kernel", "texture_kernel")
        }
        host = pool.submit(_build.load_host, "bvh_builder")
        logs = {name: f.result()[1] for name, f in builds.items()}
        host.result()
    build_s = time.perf_counter() - t0
    pmk.load_kernel()
    dmk.load_kernel()
    vmk.load_kernel()
    smk.load_kernel()
    ik.load_kernel()
    bk.load_kernel()
    tex_ops.load_kernel()
    ptxas = {name: _build.ptxas_lines(log) for name, log in logs.items()}
    record.update(card=card, torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
                  build_s=build_s, ptxas=ptxas)
    print(f"phase 0: card [{card}] torch {torch.__version__} (CUDA {torch.version.cuda}) "
          f"nvcc [{nvcc}] builds {build_s:.1f}s ptxas {ptxas}")
    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)

    # ---- phase 1: path kernel against its plain version, 160x90 x 16 spp ----
    job = load_scene(str(SCENE))
    job.film.xres, job.film.yres = 160, 90
    t0 = time.perf_counter()
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, device=dev))
    setup_s = time.perf_counter() - t0
    packed = pmk.pack_scene(job.scene, dev)
    sampler = StratifiedSampler(job.sampler)
    check(pmk.supports(job.scene, job.integrator, sampler), "fixture outside the kernel subset")
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    args = (packed, cam, pxy, pid, soff, sampler, job.integrator)
    launches0 = pmk.LAUNCHES["path_mega_cam"]
    l, w = pmk.li_path_mega_cam(*args)
    torch.cuda.synchronize()
    l_ref, w_ref = pmk.li_path_mega_cam_reference(*args)
    check(pmk.LAUNCHES["path_mega_cam"] > launches0, "the wrapper did not launch the kernel")
    bar = per_ray_bar(l, l_ref)
    max_abs_err1 = max(float((l - l_ref).abs().max()), float((w - w_ref).abs().max()))
    ms = timed_ms(pmk.prepare_launch(*args), reps=20)
    wrapper_ms = timed_ms(lambda: pmk.li_path_mega_cam(*args))
    plain_ms = timed_ms(lambda: pmk.li_path_mega_cam_reference(*args))
    n1 = pxy.shape[0]
    record["phase1"] = dict(rays=n1, camera_setup_s=setup_s, max_abs_err=max_abs_err1,
                            ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, **bar)
    print(f"phase 1: 160x90x16 = {n1} rays, kernel {ms:.3f} ms (wrapper call "
          f"{wrapper_ms:.3f} ms), plain {plain_ms:.3f} ms, diverged {bar['diverged']:.2e}, "
          f"q99 {bar['q99']:.2e}, mean {bar['mean']:.6g} vs {bar['mean_ref']:.6g}, "
          f"max_abs_err {max_abs_err1:.3g} [{card}]")

    kernels = {}
    entry = lambda *args: add_entry(kernels, *args)

    # ---- phase 2: the Path main path, 640x360 x 16 spp ----
    res, colored, launches = drive(SCENE, OUT / "chip_smoke_640x360.png", "path_mega_cam", "path")
    full = load_scene(str(SCENE))
    held = hold(pmk, full, 1, dev)
    check(not held["bvh"], "the fixture took the BVH")
    warm = warm_rates(full, dev)
    record["phase2"] = dict(launches=launches, colored=colored, render_mrays_per_s=res["mrays_per_s"],
                            render_s=res["elapsed_s"], warm_render_mrays_per_s=warm, **held)
    entry("path_mega_cam", launches, held, max_abs_err1)
    print(describe("phase 2: Path, samples/scene.json 640x360x16", res, launches, colored,
                   held, warm, card))

    # ---- phase 3: the Debug main path, 640x360 x 16 spp ----
    res, colored, launches = drive(
        SCENE_DEBUG, OUT / "chip_smoke_debug_640x360.png", "direct_mega_cam", "direct"
    )
    full = load_scene(str(SCENE_DEBUG))
    held = hold(dmk, full, 1, dev)
    check(not held["bvh"], "the Debug fixture took the BVH")
    warm = warm_rates(full, dev)
    record["phase3"] = dict(launches=launches, colored=colored, render_mrays_per_s=res["mrays_per_s"],
                            render_s=res["elapsed_s"], warm_render_mrays_per_s=warm, **held)
    # DirectLighting, one light per hit, 160x90 x 16 spp
    small = load_scene(str(SCENE_DEBUG))
    small.film.xres, small.film.yres = 160, 90
    small.integrator.kind, small.integrator.light_strategy = "direct", "one"
    one = hold(dmk, small, 1, dev)
    record["phase3_direct_one"] = one
    entry("direct_mega_cam", launches, held, one["max_abs_err"])
    print(describe("phase 3: Debug, samples/scene_debug.json 640x360x16", res, launches,
                   colored, held, warm, card)
          + f"; DirectLighting one-light 160x90x16: diverged {one['diverged']:.2e}, q99 "
          f"{one['q99']:.2e}, mean {one['mean']:.6g} vs {one['mean_ref']:.6g}, kernel "
          f"{one['ms']:.3f} ms, plain {one['plain_ms']:.1f} ms")

    # ---- phase 4: the 19,224-triangle grid over the in-kernel BVH ----
    grid_path = write_grid_scene(str(OUT / "grid_path"), base=str(SCENE), integrator="Path")
    grid_debug = write_grid_scene(
        str(OUT / "grid_debug"), base=str(SCENE_DEBUG), integrator="Debug", max_depth=4
    )
    for tag, scene, kernel, fused, mod, spp, stride in (
        ("Path", grid_path, "path_mega_cam_bvh", "path", pmk, 8, 8),
        ("Debug", grid_debug, "direct_mega_cam_bvh", "direct", dmk, 16, 16),
    ):
        res, colored, launches = drive(
            scene, OUT / f"chip_smoke_grid_{tag.lower()}_640x360.png", kernel, fused, spp
        )
        check(res["bvh"], f"the {tag} grid did not take the BVH")
        full = load_scene(scene)
        full.sampler.xsamp, full.sampler.ysamp = (2, 4) if spp == 8 else (4, 4)
        held = hold(mod, full, stride, dev)
        warm = warm_rates(full, dev, 2)
        t = full.scene.triangles.count
        record[f"phase4_{tag.lower()}"] = dict(
            triangles=t, launches=launches, colored=colored, render_mrays_per_s=res["mrays_per_s"],
            render_s=res["elapsed_s"], warm_render_mrays_per_s=warm, **held,
        )
        entry(kernel, launches, held)
        print(describe(f"phase 4: {tag}, grid of {t} triangles 640x360x{spp}", res, launches,
                       colored, held, warm, card))

    # ---- phase 5: the Volpath main path ----
    fog_area = write_fog_scene(str(OUT / "fog_area"), area_light=True, base=str(SCENE_FOG),
                               medium=THIN_FOG, xres=160, yres=90)
    grid_fog = write_grid_fog_scene(str(OUT / "grid_fog"), n=16, sigma_scale=0.5)
    grid_bvh = write_grid_scene(str(OUT / "grid_volpath"), base=str(SCENE_FOG),
                                integrator="Volpath")
    held5 = {}
    for step, tag, scene, kernel, spp, stride in (
        ("5a", "fog", SCENE_FOG, "volpath_mega_cam", None, 1),
        ("5b", "fog_area", fog_area, "volpath_mega_cam", None, 1),
        ("5c", "grid_fog", grid_fog, "volpath_mega_cam", None, 4),
        ("5d", "grid_bvh", grid_bvh, "volpath_mega_cam_bvh", 8, 8),
    ):
        res, colored, launches = drive(scene, OUT / f"chip_smoke_{tag}.png", kernel, "volpath", spp)
        check(res["bvh"] == (tag == "grid_bvh"), f"{tag}: BVH {res['bvh']}")
        full = load_scene(str(scene))
        if spp == 8:
            full.sampler.xsamp, full.sampler.ysamp = 2, 4
        held = hold(vmk, full, stride, dev)
        check(held["grid"] == (tag == "grid_fog"), f"{tag}: wrong medium")
        warm = warm_rates(full, dev, 2)
        held5[tag] = dict(launches=launches, **held)
        record[f"phase5_{tag}"] = dict(
            triangles=full.scene.triangles.count, launches=launches, colored=colored,
            render_mrays_per_s=res["mrays_per_s"], render_s=res["elapsed_s"],
            warm_render_mrays_per_s=warm, **held,
        )
        size = f"{full.film.xres}x{full.film.yres}x{full.sampler.spp}"
        print(describe(f"phase {step}: Volpath, {tag} {size}", res, launches, colored, held,
                       warm, card))
    matte_scene = write_fog_scene(str(OUT / "fog_matte"), base=str(SCENE_FOG), medium=THIN_FOG,
                                  xres=160, yres=90)
    cfg = json.loads(Path(matte_scene).read_text())
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_matte"
    Path(matte_scene).write_text(json.dumps(cfg))
    matte = hold(vmk, load_scene(matte_scene), 1, dev)
    record["phase5_fog_matte"] = matte
    print(f"phase 5: Volpath, fog with matte cubes 160x90x16: kernel vs plain diverged "
          f"{matte['diverged']:.2e}, q99 {matte['q99']:.2e}, mean {matte['mean']:.6g} vs "
          f"{matte['mean_ref']:.6g}, max_abs_err {matte['max_abs_err']:.3g}; kernel "
          f"{matte['ms']:.3f} ms, plain {matte['plain_ms']:.1f} ms [{card}]")
    entry("volpath_mega_cam", held5["fog"]["launches"], held5["fog"],
          max([held5[t]["max_abs_err"] for t in ("fog_area", "grid_fog")] + [matte["max_abs_err"]]))
    entry("volpath_mega_cam_bvh", held5["grid_bvh"]["launches"], held5["grid_bvh"])

    # ---- phase 6: the SPPM main path ----
    sppm_phase(record, kernels, card, dev)

    # ---- phase 7: the wavefront loop (AO, and Path past the path kernel) ----
    wavefront_phase(record, kernels, card, dev)

    # ---- phase 8: the widened path kernel ----
    wide_phase(record, kernels, card, dev)

    # ---- phase 9: the Halton sampler and smooth normals ----
    halton_smooth_phase(record, kernels, card, dev)

    # ---- phase 10: every untextured material: Disney through the path kernel ----
    materials_phase(record, kernels, card, dev)

    # ---- phase 11: subsurface Path: the BSSRDF through the path kernel ----
    subsurface_phase(record, kernels, card, dev)

    # ---- phase 12: textured Path (K7 inside the path kernel); the repairs ----
    texture_phase(record, kernels, card, dev)
    repairs_phase(record, card, dev)

    # ---- phase 13: Debug / DirectLighting past K2; the rays-in kernels ----
    direct_wavefront_phase(record, card, dev)
    rays_in_phase(record, kernels, card, dev)

    # ---- phase 14: SPPM on glass and Disney; K3's BVH4 walk ----
    wide_sppm_phase(record, kernels, card, dev)
    bvh4_phase(record, kernels, card, dev)

    lines = [kernels[name] for name in KERNELS]
    record["kernels"] = lines
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(card)
    print(json.dumps({"kernels": lines}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


def sppm_inputs(job, dev, it=0):
    """What one SPPM iteration's kernels take, as render_sppm makes it."""
    packed = smk.pack_sppm(job.scene, dev)
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, device=dev))
    w, h = job.film.xres, job.film.yres
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    pid = (ys * w + xs).reshape(-1)
    pxy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(torch.float32)
    u = make_sampler(job).slot_matrix(pid, it, smk.sppm_slots(job.integrator.max_depth))
    return packed, cam, pxy, u


def agreement(a, b):
    """(rows off by more than 1e-3 relative, relative difference of the
    means) of radiance `a` against `b`."""
    a, b = a.double().cpu(), b.double().cpu()
    rel = (a - b).abs() / b.abs().clamp(min=1e-3)
    return int((rel.amax(-1) > 1e-3).sum()), float((a.mean() - b.mean()) / b.mean())


def surface_photons(scene, n, depth, dev, seed=12):
    """A seeded batch of photons, many of which deposit, made as
    tests/test_torch_sppm.py makes its photons: half start inside a cube
    whose material has a diffuse lobe (within 0.8 of its inscribed ball,
    so each depth hits its inner faces) in a random direction, half
    outside (x in [26.2, 29.8], y and z in [-6, 6]) aimed at a random point
    of any cube; 95% of them active; uniform bounce and roulette values.
    The scene's triangles must be cube.obj instances, 12 rows each.
    Returns (ro, rd, beta, active, u_rows) on `dev`."""
    tri = scene.triangles
    check(tri.count % 12 == 0, "the photon batch needs a scene of cubes")
    verts = np.stack([tri.p0, tri.p1, tri.p2], 1).astype(np.float64).reshape(-1, 36, 3)
    centre = verts.mean(1)
    half = np.abs(((tri.p0[::12] - centre) * tri.ng[::12]).sum(-1))  # centre to a face
    mats = scene.materials
    diffuse = np.array([np.isin(mats["kind"][m, : mats["n_lobes"][m]], smk.DIFFUSE_KINDS).any()
                        for m in tri.mat[::12]])
    rng = np.random.default_rng(seed)
    inside = np.arange(n) < n // 2
    pick = np.where(inside, rng.choice(np.nonzero(diffuse)[0], n), rng.integers(0, len(centre), n))
    c, h = centre[pick], half[pick, None]
    off = rng.normal(size=(n, 3))
    off *= 0.8 * h * rng.random((n, 1)) ** (1 / 3) / np.linalg.norm(off, axis=-1, keepdims=True)
    outside = np.array([28.0, 0.0, 0.0]) + rng.uniform(-6.0, 6.0, (n, 3)) * [0.3, 1.0, 1.0]
    ro = np.where(inside[:, None], c + off, outside)
    target = c + 0.9 * h * rng.uniform(-1.0, 1.0, (n, 3))
    rd = np.where(inside[:, None], rng.normal(size=(n, 3)), target - ro)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    beta = rng.uniform(1.0, 50.0, (n, 3))
    active = rng.random(n) < 0.95
    u_rows = rng.random((3 * (depth - 1), n))
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()
    return f32(ro), f32(rd), f32(beta), torch.as_tensor(active, device=dev), f32(u_rows)


def hold_photons(packed, ph, depth, floor):
    """The photon kernel against its plain version on photons `ph`: the
    events agree (the live flags equal; p, wi and beta at rtol 1e-4, atol
    1e-5 where either is live) on 99.5% of the photons with a live event
    in either version, of which there must be `floor` or more.  Returns
    (numbers, the kernel's events, the plain version's work, launch)."""
    launch = smk.prepare_photon(packed, *ph, depth)
    ev = launch()
    torch.cuda.synchronize()
    work = {}
    ev_ref = smk.sppm_photon_mega_reference(packed, *ph, depth, work=work)
    live = ev[3] | ev_ref[3]
    same = ev[3] == ev_ref[3]
    err = 0.0
    for k in range(3):
        same &= torch.isclose(ev[k], ev_ref[k], rtol=1e-4, atol=1e-5).all(-1) | ~live
        err = max(err, float((ev[k] - ev_ref[k]).abs().max()))
    n = ph[0].shape[0]
    live_photons = live.reshape(depth - 1, n).any(0)
    n_live = int(live_photons.sum())
    check(n_live >= floor, f"{n_live} photons with a live event, fewer than {floor}")
    equal = float(same.reshape(depth - 1, n).all(0)[live_photons].double().mean())
    check(equal >= 0.995, f"photon events equal on {equal:.4f} of the {n_live} live photons")
    check(bool((ev[0][~ev[3]] == 0).all()), "a dead photon event is not zeros")
    numbers = dict(photons=n, live_photons=n_live, live_events=int(ev[3].sum()),
                   live_equal=equal, max_abs_err=err)
    return numbers, ev, work, launch


def hold_sppm_walks(job, dev, cross=False):
    """The camera and photon kernels against their plain versions on the
    first iteration's inputs, and the photon kernel also on a seeded
    batch of surface-started photons (surface_photons).  With `cross`,
    the camera walk's agreement also on a seeded random eighth of the
    pixels, there also against the plain version on the CPU.  Returns (camera
    numbers, photon numbers, the kernels' VPs, the main path's and the
    batch's kernel events, radius, mats)."""
    spec = job.integrator
    depth = spec.max_depth
    packed, cam, pxy, u = sppm_inputs(job, dev)
    n = pxy.shape[0]
    launch = smk.prepare_camera(packed, cam, pxy, u, depth)
    ld, vp = launch()
    torch.cuda.synchronize()
    work = {}
    ld_ref, vp_ref = smk.sppm_camera_mega_cam_reference(packed, cam, pxy, u, depth, work=work)
    bar = per_ray_bar(ld, ld_ref)
    valid_eq = float((vp.valid == vp_ref.valid).double().mean())
    check(valid_eq >= 0.995, f"VP valid equal on {valid_eq:.4f} of the pixels")
    both = vp.valid & vp_ref.valid
    mat_eq = float((vp.mat[both] == vp_ref.mat[both]).double().mean())
    check(mat_eq >= 0.995, f"VP material equal on {mat_eq:.4f} of the valid pixels")
    # the VP record where both are valid and ld agrees, at the bar of
    # tests/test_torch_cuda.py per pixel, on 99.9% of those pixels: the
    # glossy cubes' chaotic sampler moves a rare beta by a few 1e-4
    held = both & (((ld - ld_ref).abs() / ld_ref.abs().clamp(min=1e-3)).amax(-1) <= 1e-3)
    n_held = int(held.sum())
    check(n_held > 30, f"{n_held} VPs held")
    check(bool((vp.mat[held] == vp_ref.mat[held]).all()), "VP material differs on a held pixel")
    err = float((ld - ld_ref).abs().max())
    close = torch.ones((n_held,), dtype=torch.bool, device=dev)
    for f in ("p", "wo", "beta", "ng", "dpdu"):
        a, b = getattr(vp, f)[held], getattr(vp_ref, f)[held]
        close &= torch.isclose(a, b, rtol=2e-4, atol=1e-5).all(-1)
        err = max(err, float((a - b).abs().max()))
    record_eq = float(close.double().mean())
    check(record_eq >= 0.999, f"VP record equal on {record_eq:.5f} of the {n_held} held pixels")
    t_ms = timed_ms(launch, reps=10)
    wrapper_ms = timed_ms(lambda: smk.sppm_camera_mega_cam(packed, cam, pxy, u, depth))
    plain_ms = once_ms(lambda: smk.sppm_camera_mega_cam_reference(packed, cam, pxy, u, depth))
    b_ms, b_by = bound(work, 1.0, n, packed, SPPM_CAM_BYTES)
    camera = dict(rays=n, plain_rays=n, bvh=packed.bvh is not None, max_abs_err=err, ms=t_ms,
                  wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                  valid_equal=valid_eq, mat_equal=mat_eq, vps=int(vp.valid.sum()),
                  vps_held=n_held, vp_record_equal=record_eq,
                  work={k: float(v) for k, v in work.items()}, **bar)
    if cross:
        sub = torch.randperm(n, generator=torch.Generator().manual_seed(8))[: n // 8].to(dev)
        # the plain version on the CPU over the same eighth
        sub_cpu = sub.cpu()
        ld_cpu, _ = smk.sppm_camera_mega_cam_reference(packed, cam, pxy.cpu()[sub_cpu],
                                                       u.cpu()[:, sub_cpu], depth)
        camera["cross"] = dict(eighth=agreement(ld[sub], ld_ref[sub]),
                               kernel_vs_cpu=agreement(ld[sub], ld_cpu),
                               plain_vs_cpu=agreement(ld_ref[sub], ld_cpu))

    radius = torch.full((n,), spec.radius, dtype=torch.float32, device=dev)
    lights = sppm.photon_lights(packed, job.scene.lights, dev)
    n_ph = spec.photons_per_iter
    ph = sppm.emit_photons(lights, torch.arange(n_ph, device=dev), depth)
    main, ev, work, launch = hold_photons(packed, ph, depth, PHOTON_FLOOR)
    batch, ev_batch, _, _ = hold_photons(
        packed, surface_photons(job.scene, n_ph, depth, dev), depth, n_ph // 8
    )
    t_ms = timed_ms(launch, reps=10)
    wrapper_ms = timed_ms(lambda: smk.sppm_photon_mega(packed, *ph, depth))
    plain_ms = once_ms(lambda: smk.sppm_photon_mega_reference(packed, *ph, depth))
    ray_bytes = int(ph[3].sum()) * PHOTON_RAY_BYTES
    b_ms, b_by = bound(work, 1.0, n_ph, packed, SPPM_PHOTON_BYTES, ray_bytes)
    photon = dict(rays=n_ph, plain_rays=n_ph, bvh=packed.bvh is not None,
                  max_abs_err=max(main["max_abs_err"], batch["max_abs_err"]), ms=t_ms,
                  wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                  main=main, surface_batch=batch, work={k: float(v) for k, v in work.items()})
    return camera, photon, vp, ev, ev_batch, radius, smk.resolve_mat_tables(job.scene, dev)


def hold_deposit(vp, ev, radius, mats, timed=True):
    """The deposit kernel (its wide instance on wide rows) against its plain
    version on the same sorted events (the kernel's VPs and events of one
    iteration); with `timed`, its times and bound too."""
    lo, diag = sppm.grid_bounds(vp, radius)
    inp = smk.deposit_inputs(vp, radius, ev, lo, diag)
    launch = smk.prepare_deposit(vp, mats, inp)
    phi, m = launch()
    torch.cuda.synchronize()
    work = {}
    phi_ref, m_ref = smk.deposit_walk_reference(vp, mats, inp, work=work)
    check(bool((m == m_ref).all()), "deposit M differs from its plain version")
    rel = float(((phi - phi_ref).abs() / phi_ref.abs().clamp(min=1e-30)).max())
    check(rel <= 1e-5, f"deposit phi off by {rel:.3g} relative")
    check(int(m_ref.sum()) > 0, "no photon reached a visible point")
    held = dict(max_abs_err=float((phi - phi_ref).abs().max()), phi_rel_err=rel,
                bit_equal=bool((phi == phi_ref).all()), m_total=int(m_ref.sum()),
                live_events=int(ev[3].sum()))
    if not timed:
        return held
    n = vp.p.shape[0]
    t_ms = timed_ms(launch, reps=10)
    wrapper_ms = timed_ms(lambda: smk.deposit_mega(vp, radius, mats, ev, lo, diag))
    plain_ms = once_ms(lambda: smk.deposit_walk_reference(vp, mats, inp))
    # bytes: the VPs with a range, and each sorted event that some range holds once
    walking = inp.end > inp.start
    n_ev = inp.events.shape[0]
    edge = torch.zeros(n_ev + 1, dtype=torch.int64, device=vp.p.device)
    first, last = inp.start[walking].long(), inp.end[walking].long()
    edge.index_add_(0, first, torch.ones_like(first))
    edge.index_add_(0, last, -torch.ones_like(last))
    read_events = int((edge.cumsum(0)[:n_ev] > 0).sum())
    extra = int(walking.sum()) * VP_WALK_BYTES + read_events * EVENT_BYTES + mats.numel() * 4
    b_ms, b_by = bound(work, 1.0, n, None, VP_BYTES, extra)
    return dict(rays=n, plain_rays=n, ms=t_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, walked_pairs=float(work.get("pair", 0)),
                events=n_ev, read_events=read_events, walking_vps=int(walking.sum()), **held)


def first_photons(ev, depth, share):
    """The depth-major events `ev` of the first 1/`share` of the photons."""
    n = ev[3].shape[0] // (depth - 1)
    return tuple(e.reshape(depth - 1, n, -1)[:, : n // share].reshape(-1, *e.shape[1:])
                 for e in ev)


def drive_sppm(scene, png, bvh, wide=False):
    """The SPPM main path through deploy_render with every count at 0 just
    before: one launch of each SPPM kernel (BVH instances when `bvh`, the
    wide ones when `wide`) per iteration and none of the others.  Returns
    (result, coloured pixels)."""
    zero_counts()
    res = deploy_render(str(scene), str(png))
    counts = all_counts()
    rgb = res["rgb_srgb_input"]
    check(bool(torch.isfinite(rgb).all()), f"{png.name}: non-finite image")
    check(png.exists() and png.stat().st_size > 0, f"{png.name}: no PNG written")
    colored = int((rgb.sum(-1) > 0).sum())
    check(colored > 0, f"{png.name}: no coloured pixels")
    check(res["fused_kernel"] == "sppm" and res["render_path"] == "megakernel" and res["bvh"] == bvh,
          f"{png.name}: wrong path")
    sfx, wsfx = "_bvh" * bvh, "_wide" * wide
    want = {f"sppm_camera_mega_cam{sfx}{wsfx}", f"sppm_photon_mega{sfx}{wsfx}",
            f"sppm_deposit_mega{wsfx}"}
    for k, v in counts.items():
        check(v == (res["passes"] if k in want else 0), f"{png.name}: launches {counts}")
    return res, colored


def sppm_phase(record, kernels, card, dev):
    """Phase 6 (see the module docstring)."""
    entry = lambda *args: add_entry(kernels, *args)
    t0 = time.perf_counter()
    res, colored = drive_sppm(SCENE_SPPM, OUT / "chip_smoke_sppm.png", False)
    job = load_scene(str(SCENE_SPPM))
    camera, photon, vp, ev, ev_batch, radius, mats = hold_sppm_walks(job, dev)
    deposit = hold_deposit(vp, ev, radius, mats)
    batch_events = first_photons(ev_batch, job.integrator.max_depth, 16)
    deposit_batch = hold_deposit(vp, batch_events, radius, mats, timed=False)
    warm = [render_job(job, dev) for _ in range(2)]
    rates = [(r["camera_mrays_per_s"], r["photon_mrays_per_s"]) for r in warm]
    iters = res["passes"]
    record["phase6"] = dict(
        iterations=iters, colored=colored, render_s=res["elapsed_s"],
        camera_mrays_per_s=res["camera_mrays_per_s"], photon_mrays_per_s=res["photon_mrays_per_s"],
        warm_camera_photon_mrays_per_s=rates, warm_s=[r["elapsed_s"] for r in warm],
        camera=camera, photon=photon, deposit=deposit, deposit_surface_batch=deposit_batch,
        phase_s=time.perf_counter() - t0,
    )
    entry("sppm_camera_mega_cam", iters, camera)
    entry("sppm_photon_mega", iters, photon)
    entry("sppm_deposit_mega", iters, deposit, deposit_batch["max_abs_err"])
    main, batch = photon["main"], photon["surface_batch"]
    print(
        f"phase 6: SPPM, samples/scene_sppm.json 640x360, {iters} iterations of "
        f"{job.integrator.photons_per_iter} photons, {iters} launch(es) of each kernel, {colored} "
        f"coloured px; first render {res['elapsed_s']:.3f} s ({res['camera_mrays_per_s']:.2f} "
        f"camera / {res['photon_mrays_per_s']:.2f} photon Mrays/s), warm "
        f"{', '.join(f'{c:.1f} / {p:.1f}' for c, p in rates)} Mrays/s; camera kernel "
        f"{camera['ms']:.3f} ms (wrapper {camera['wrapper_ms']:.3f}, plain {camera['plain_ms']:.1f}, "
        f"bound {camera['bound_ms']:.4f} by {camera['bound_by']}), diverged "
        f"{camera['diverged']:.2e}, q99 {camera['q99']:.2e}, VP valid equal "
        f"{camera['valid_equal']:.4f}, {camera['vps']} VPs, record equal on "
        f"{camera['vp_record_equal']:.5f} of {camera['vps_held']}; "
        f"photon kernel {photon['ms']:.3f} ms (wrapper {photon['wrapper_ms']:.3f}, plain "
        f"{photon['plain_ms']:.1f}, bound {photon['bound_ms']:.4f} by {photon['bound_by']}), events "
        f"equal on {main['live_equal']:.4f} of {main['live_photons']} live photons "
        f"({main['live_events']} live events), surface batch {batch['live_equal']:.4f} of "
        f"{batch['live_photons']}; deposit kernel {deposit['ms']:.3f} ms (wrapper with the sort "
        f"{deposit['wrapper_ms']:.3f}, plain {deposit['plain_ms']:.1f}, bound "
        f"{deposit['bound_ms']:.4f} by {deposit['bound_by']}), {deposit['walked_pairs']:.0f} pairs "
        f"walked, {deposit['read_events']} events in ranges, M total {deposit['m_total']}, phi rel "
        f"err {deposit['phi_rel_err']:.2e}, bit-equal {deposit['bit_equal']}; on the surface "
        f"batch's events M total {deposit_batch['m_total']}, phi rel err "
        f"{deposit_batch['phi_rel_err']:.2e}; {record['phase6']['phase_s']:.1f} s [{card}]"
    )

    t0 = time.perf_counter()
    grid = write_grid_scene(str(OUT / "grid_sppm"), base=str(SCENE_SPPM), integrator="SPPM",
                            max_depth=3)
    cfg = json.loads(Path(grid).read_text())
    cfg["Integrator"]["n_iters"] = 2
    Path(grid).write_text(json.dumps(cfg))
    res, colored = drive_sppm(grid, OUT / "chip_smoke_grid_sppm.png", True)
    job = load_scene(grid)
    camera, photon, vp, ev, ev_batch, radius, mats = hold_sppm_walks(job, dev, cross=True)
    deposit = hold_deposit(vp, ev, radius, mats)
    batch_events = first_photons(ev_batch, job.integrator.max_depth, 16)
    deposit_batch = hold_deposit(vp, batch_events, radius, mats, timed=False)
    record["phase6_grid"] = dict(
        triangles=job.scene.triangles.count, iterations=res["passes"], colored=colored,
        render_s=res["elapsed_s"], camera_mrays_per_s=res["camera_mrays_per_s"],
        photon_mrays_per_s=res["photon_mrays_per_s"], camera=camera, photon=photon,
        deposit=deposit, deposit_surface_batch=deposit_batch, phase_s=time.perf_counter() - t0,
    )
    cross = camera["cross"]
    main, batch = photon["main"], photon["surface_batch"]
    entry("sppm_camera_mega_cam_bvh", res["passes"], camera)
    entry("sppm_photon_mega_bvh", res["passes"], photon)
    print(
        f"phase 6c: SPPM, grid of {job.scene.triangles.count} triangles 640x360, "
        f"{res['passes']} iterations over the BVH, {colored} coloured px, "
        f"{res['camera_mrays_per_s']:.2f} camera / {res['photon_mrays_per_s']:.2f} photon Mrays/s; "
        f"camera kernel {camera['ms']:.3f} ms (plain {camera['plain_ms']:.1f}, bound "
        f"{camera['bound_ms']:.4f} by {camera['bound_by']}), diverged {camera['diverged']:.2e}, "
        f"VP valid equal {camera['valid_equal']:.4f}, record equal on "
        f"{camera['vp_record_equal']:.5f} of {camera['vps_held']} "
        f"(diverged px, relative mean difference: on an eighth {cross['eighth']}, kernel vs plain "
        f"on the CPU {cross['kernel_vs_cpu']}, plain on the card vs on the CPU "
        f"{cross['plain_vs_cpu']}); photon kernel {photon['ms']:.3f} ms (plain "
        f"{photon['plain_ms']:.1f}, bound {photon['bound_ms']:.4f} by {photon['bound_by']}), events "
        f"equal on {main['live_equal']:.4f} of {main['live_photons']} live photons, surface batch "
        f"{batch['live_equal']:.4f} of {batch['live_photons']}; deposit {deposit['ms']:.3f} ms, "
        f"M total {deposit['m_total']} (surface batch {deposit_batch['m_total']}), phi rel err "
        f"{deposit['phi_rel_err']:.2e} / {deposit_batch['phi_rel_err']:.2e}; "
        f"{record['phase6_grid']['phase_s']:.1f} s [{card}]"
    )


# ---- phase 7: the wavefront loop ----


class RecordingCtx(SceneCtx):
    """SceneCtx that keeps the inputs of the first call of each of the
    loop's queries, as (o, d, t_max) under "shaded" and "occluded" and,
    over a BVH, "closest" (the subsurface probe chain's re-casts)."""

    def __init__(self, ctx):
        super().__init__(ctx.tri_packed, ctx.shade, ctx.mat_rows, ctx.lights, ctx.bvh,
                         ctx.bssrdf)
        self.batches = {}

    def intersect_shaded(self, o, d, t_max):
        self.batches.setdefault("shaded", (o, d, t_max))
        return super().intersect_shaded(o, d, t_max)

    def occluded(self, o, d, t_max):
        self.batches.setdefault("occluded", (o, d, t_max))
        return super().occluded(o, d, t_max)

    def intersect(self, o, d, t_max):
        if self.bvh is not None:
            self.batches.setdefault("closest", (o, d, t_max))
        return super().intersect(o, d, t_max)


def first_pass_batches(job, dev, spp, wide=False):
    """The first pass of the wavefront render of `job` at `spp` samples per
    pixel, run again with a recording context: its first camera (shaded)
    and occlusion batches, and the context.  With `wide` its closest-hit
    and any-hit queries walk the BVH4 (pack_bvh(..., wide=True)), not the
    loop's binary tree."""
    sampler = make_sampler(job)
    sampler.xs, sampler.ys = (2, 4) if spp == 8 else (4, 4)
    sampler.spp = spp
    cam = RealisticCamera(job.camera, job.film, device=dev)
    ctx = RecordingCtx(SceneCtx.from_scene(job.scene, dev))
    if wide:
        ctx.bvh = bk.pack_bvh(job.scene.triangles, dev, wide=True)
    pxy, pid, soff = sample_batch(job.film, spp, dev)
    o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
    li = li_ao if job.integrator.kind == "ao" else li_path
    li(ctx, o, d, w, sampler, pid, soff, job.integrator)
    torch.cuda.synchronize()
    return ctx, ctx.batches


# query: (prepare_launch, the wrapper, the plain version)
QUERIES = {
    "intersect": (
        lambda ctx, o, d, t: ik.prepare_launch(ctx.tri_packed, o, d, t, ctx.chunks),
        lambda ctx, o, d, t: ik.intersect_triangles(ctx.tri_packed, o, d, t, ctx.chunks),
        lambda ctx, o, d, t, work: ik.intersect_triangles_reference(ctx.tri_packed, o, d, t, work,
                                                                    ctx.chunks),
    ),
    "closest": (
        lambda ctx, o, d, t: bk.prepare_launch(ctx.bvh, o, d, t, False),
        lambda ctx, o, d, t: bk.intersect_bvh(ctx.bvh, o, d, t),
        lambda ctx, o, d, t, work: bk.intersect_bvh_reference(ctx.bvh, o, d, t, work),
    ),
    "any": (
        lambda ctx, o, d, t: bk.prepare_launch(ctx.bvh, o, d, t, True),
        lambda ctx, o, d, t: bk.occluded_bvh(ctx.bvh, o, d, t),
        lambda ctx, o, d, t, work: bk.occluded_bvh_reference(ctx.bvh, o, d, t, work),
    ),
    "shaded": (
        lambda ctx, o, d, t: bk.prepare_shaded_launch(ctx.bvh, o, d, t),
        lambda ctx, o, d, t: bk.intersect_bvh_shaded(ctx.bvh, o, d, t),
        lambda ctx, o, d, t, work: bk.intersect_bvh_shaded_reference(ctx.bvh, o, d, t, work),
    ),
}


def query_bytes(query, ctx, n):
    """Bytes of one query over n rays (see the module docstring)."""
    if query == "intersect":
        return n * QUERY_BYTES + ctx.tri_packed.shape[0] * 9 * 4
    m, p = ctx.bvh.nodes_f.shape[0], ctx.bvh.prims_f.shape[0]
    nbytes = m * NODE_READ_COLS * 4 + p * (9 * 4 + 4)
    if ctx.bvh.wide and query != "shaded":
        nbytes = ctx.bvh.nodes4_f.shape[0] * NODE4_BYTES + p * (9 * 4 + 4)
    if query == "shaded":
        # the smooth instance reads 31 shade floats a triangle and writes 6
        # attribute floats more a ray
        cols = ctx.bvh.shade_f.shape[1]
        out = SHADED_OUT_BYTES + (24 if ctx.bvh.smooth else 0)
        return nbytes + n * (28 + out) + p * (cols * 4 + 2 * 4)
    return nbytes + n * QUERY_BYTES


def hold_query(query, ctx, batch, stride=16):
    """One query kernel on a main-path batch against its plain version on
    a seeded random 1/`stride` of the rays (see the module docstring for
    the bars).  Returns the measured numbers."""
    prepare, wrapper, plain = QUERIES[query]
    o, d, t_max = batch
    n = o.shape[0]
    launch = prepare(ctx, o, d, t_max)
    out = [x.clone() for x in launch()]
    torch.cuda.synchronize()
    pick = torch.randperm(n, generator=torch.Generator().manual_seed(stride))[: n // stride]
    sub = pick.sort().values.to(o.device)
    work = {}
    ref = plain(ctx, o[sub], d[sub], t_max[sub], work)
    if query == "any":
        hit_k, hit_p = out[1][sub] >= 0, ref
    else:
        hit_k, hit_p = out[1][sub] >= 0, ref[1] >= 0
    both = hit_k & hit_p
    stats = dict(rays=n, plain_rays=int(sub.numel()), hits=int(hit_p.sum()),
                 miss_mismatch=float((hit_k != hit_p).double().mean()))
    check(stats["hits"] > 0, f"{query}: the held rays hit nothing")
    check(stats["miss_mismatch"] <= MISS_HOLD,
          f"{query}: hit or miss differs on {stats['miss_mismatch']:.2e} of the rays")
    max_abs_err = 0.0
    if query != "any":
        t_k, t_p = out[0][sub][both], ref[0][both]
        check(bool((out[1][sub][both].long() == ref[1][both]).all()), f"{query}: triangles differ")
        check(bool(torch.isclose(t_k, t_p, rtol=1e-6, atol=0.0).all()), f"{query}: t differs")
        max_abs_err = float((t_k - t_p).abs().max()) if both.any() else 0.0
    if query == "shaded":
        for k, name in ((2, "material"), (3, "area light")):
            check(bool((out[k][sub][both].long() == ref[k][both]).all()), f"shaded: {name} differs")
        a_k, a_p = out[4][:, sub][:, both], ref[4][:, both]
        check(bool(torch.isclose(a_k, a_p, rtol=1e-5, atol=1e-6).all()), "shaded: attributes differ")
        max_abs_err = max(max_abs_err, float((a_k - a_p).abs().max()))
    stats["max_abs_err"] = max_abs_err
    stats["ms"] = timed_ms(launch, reps=10)
    if query == "intersect" and ctx.chunks is not None:
        stats["occupancy"] = ik.occupancy()
    stats["wrapper_ms"] = timed_ms(lambda: wrapper(ctx, o, d, t_max))
    stats["plain_ms"] = once_ms(lambda: plain(ctx, o[sub], d[sub], t_max[sub], None))
    scale = n / sub.numel()

    def query_bound(w):
        flops = scale * sum(FLOPS[k] * float(v) for k, v in w.items() if k in FLOPS)
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, query_bytes(query, ctx, n) / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    stats["bound_ms"], stats["bound_by"] = query_bound(work)
    stats.update(walk_numbers(work, scale, n, query_bound))
    stats["work"] = {k: float(v) * scale for k, v in work.items()}
    return stats


def k4_walks(ctx, batch, turns=3):
    """K4's chunked walk against its walk over every row (intersect_kernel)
    on one batch: both timed in turns (median of each), their t and
    triangle compared on every ray; the decision is the faster walk, and
    the wavefront loop launches the chunked one."""
    o, d, t_max = batch
    chunked = ik.prepare_launch(ctx.tri_packed, o, d, t_max, ctx.chunks)
    every = ik.prepare_launch(ctx.tri_packed, o, d, t_max)
    t_c, i_c = (x.clone() for x in chunked())
    t_e, i_e = every()
    torch.cuda.synchronize()
    check(torch.equal(i_c, i_e) and torch.equal(t_c, t_e), "K4: the chunked walk's hits differ")
    times = [(timed_ms(chunked, reps=10), timed_ms(every, reps=10)) for _ in range(turns)]
    ms_c = statistics.median(t for t, _ in times)
    ms_e = statistics.median(t for _, t in times)
    check(ms_c < ms_e, f"K4: the chunked walk {ms_c:.3f} ms is not faster than {ms_e:.3f} ms")
    return dict(chunked_ms=ms_c, every_row_ms=ms_e, decision="chunked walk")


def drive_wavefront(scene, png, want, spp_override=None):
    """One wavefront render through deploy_render with every count at 0
    just before; `want` maps each kernel count to the launches the render
    must make, every other count must stay 0.  Returns (result, coloured
    pixels, counts)."""
    zero_counts()
    res = deploy_render(str(scene), str(png), spp_override=spp_override)
    counts = all_counts()
    rgb = res["rgb_srgb_input"]
    check(bool(torch.isfinite(rgb).all()), f"{png.name}: non-finite image")
    check(png.exists() and png.stat().st_size > 0, f"{png.name}: no PNG written")
    colored = int((rgb.sum(-1) > 0).sum())
    check(colored > 0, f"{png.name}: no coloured pixels")
    check(res["render_path"] == "wavefront", f"{png.name}: render path {res['render_path']}")
    for k, v in counts.items():
        check(v == want.get(k, 0), f"{png.name}: launches {counts}, want {want}")
    return res, colored, counts


def warm_rates_s(results):
    return ", ".join(f"{r['mrays_per_s']:.1f}" for r in results)


def wavefront_entry(kernels, name, launches, held):
    add_entry(kernels, name, launches, held)
    kernels[name]["library_ms"] = None


def wavefront_phase(record, kernels, card, dev):
    """Phase 7 (see the module docstring)."""
    t0 = time.perf_counter()
    # (a) AO on the fixture through K4
    ao = load_scene(str(SCENE_AO))
    n_probe = ao.integrator.n_samples
    res, colored, counts = drive_wavefront(
        SCENE_AO, OUT / "chip_smoke_ao.png", {"intersect": 1 + n_probe})
    check(not res["bvh"], "the AO fixture took the BVH")
    ctx, batches = first_pass_batches(ao, dev, 16)
    check(ctx.chunks is not None, "7a: no chunk rows for K4")
    k4 = hold_query("intersect", ctx, batches["occluded"])
    k4.update(k4_walks(ctx, batches["occluded"]))
    warm = [render_job(ao, dev) for _ in range(2)]
    rays = res["camera_rays"]
    rate = lambda r, m: (r["camera_rays"] * m) / max(r["elapsed_s"], 1e-9) / 1e6
    record["phase7a"] = dict(colored=colored, launches=counts, camera_rays=rays,
                             camera_mrays_per_s=res["mrays_per_s"],
                             probe_mrays_per_s=rate(res, n_probe),
                             warm_camera_mrays_per_s=[r["mrays_per_s"] for r in warm],
                             warm_probe_mrays_per_s=[rate(r, n_probe) for r in warm],
                             render_s=res["elapsed_s"], k4=k4, phase_s=time.perf_counter() - t0)
    wavefront_entry(kernels, "intersect", counts["intersect"], k4)
    print(f"phase 7a: AO, samples/scene_ao.json {ao.film.xres}x{ao.film.yres}x16, {n_probe} "
          f"probes: {rays} camera and "
          f"{rays * n_probe} probe rays, {counts['intersect']} K4 launches, {colored} coloured px; "
          f"first render {res['mrays_per_s']:.2f} camera / {rate(res, n_probe):.1f} probe Mrays/s, "
          f"warm {warm_rates_s(warm)} camera Mrays/s; "
          f"K4 {k4['ms']:.3f} ms a probe launch (wrapper {k4['wrapper_ms']:.3f}), bound "
          f"{k4['bound_ms']:.4f} ms by {k4['bound_by']}, plain {k4['plain_ms']:.1f} ms over "
          f"{k4['plain_rays']} rays, hits {k4['hits']}, hit/miss differ {k4['miss_mismatch']:.2e}, "
          f"max_abs_err {k4['max_abs_err']:.3g}{walk_text(k4)}; the walk over every row on the "
          f"same probes {k4['every_row_ms']:.3f} ms in turns with the chunked walk's "
          f"{k4['chunked_ms']:.3f} ms, t and triangle equal on every probe: K4 takes the "
          f"{k4['decision']}; {time.perf_counter() - t0:.1f} s [{card}]")

    # (b) AO on the 19,224-triangle grid through K3
    t0 = time.perf_counter()
    grid = write_grid_scene(str(OUT / "grid_ao"), base=str(SCENE_AO), integrator="AO")
    res, colored, counts = drive_wavefront(
        grid, OUT / "chip_smoke_grid_ao.png", {"bvh_shaded": 1, "bvh_any": n_probe}, 8)
    check(res["bvh"], "the AO grid did not take the BVH")
    job = load_scene(grid)
    ctx, batches = first_pass_batches(job, dev, 8)
    shaded = hold_query("shaded", ctx, batches["shaded"])
    any_hit = hold_query("any", ctx, batches["occluded"])
    closest = hold_query("closest", ctx, batches["occluded"])
    wavefront_entry(kernels, "bvh", counts["bvh_any"] + counts["bvh_closest"], any_hit)
    wavefront_entry(kernels, "bvh_shaded", counts["bvh_shaded"], shaded)
    job.sampler.xsamp, job.sampler.ysamp = 2, 4
    warm = [render_job(job, dev) for _ in range(2)]
    rays = res["camera_rays"]
    record["phase7b"] = dict(triangles=job.scene.triangles.count, colored=colored, launches=counts,
                             camera_rays=rays, camera_mrays_per_s=res["mrays_per_s"],
                             probe_mrays_per_s=rate(res, n_probe),
                             warm_camera_mrays_per_s=[r["mrays_per_s"] for r in warm],
                             warm_probe_mrays_per_s=[rate(r, n_probe) for r in warm],
                             render_s=res["elapsed_s"], shaded=shaded, any_hit=any_hit,
                             closest=closest, phase_s=time.perf_counter() - t0)
    print(f"phase 7b: AO, grid of {job.scene.triangles.count} triangles "
          f"{job.film.xres}x{job.film.yres}x8: {rays} camera "
          f"rays, launches {counts}, {colored} coloured px; first render {res['mrays_per_s']:.2f} "
          f"camera / {rate(res, n_probe):.1f} probe Mrays/s, warm "
          f"{', '.join(f'{rate(r, n_probe):.1f}' for r in warm)} probe Mrays/s; "
          + "; ".join(
              f"{tag} {h['ms']:.3f} ms (wrapper {h['wrapper_ms']:.3f}, bound {h['bound_ms']:.4f} by "
              f"{h['bound_by']}, plain {h['plain_ms']:.1f} over {h['plain_rays']} rays, hits "
              f"{h['hits']}, hit/miss differ {h['miss_mismatch']:.2e}, max_abs_err "
              f"{h['max_abs_err']:.3g})"
              for tag, h in (("K3-shaded", shaded), ("K3 any", any_hit), ("K3 closest", closest)))
          + f"; {time.perf_counter() - t0:.1f} s [{card}]")

    # (c) Path past the path kernel's 65,536 triangles
    t0 = time.perf_counter()
    big = write_grid_scene(str(OUT / "grid80_path"), ny=80, nz=80, integrator="Path")
    job = load_scene(big)
    depth = job.integrator.max_depth
    check(job.scene.triangles.count > pmk.BVH_TRI_MAX, "the 80x80 grid fits the path kernel")
    res, colored, counts = drive_wavefront(
        big, OUT / "chip_smoke_grid80_path.png", {"bvh_shaded": depth, "bvh_any": depth}, 8)
    ctx, batches = first_pass_batches(job, dev, 8)
    check(ctx.bvh.depth < pmk.STACK_DEPTH, "the 80x80 grid's BVH is too deep")
    shaded_c = hold_query("shaded", ctx, batches["shaded"])
    any_c = hold_query("any", ctx, batches["occluded"])
    job.sampler.xsamp, job.sampler.ysamp = 2, 4
    warm = [render_job(job, dev) for _ in range(2)]
    rays = res["camera_rays"]
    record["phase7c"] = dict(triangles=job.scene.triangles.count, bvh_depth=ctx.bvh.depth,
                             colored=colored, launches=counts, camera_rays=rays,
                             camera_mrays_per_s=res["mrays_per_s"],
                             shadow_slots_per_s=rate(res, depth),
                             warm_camera_mrays_per_s=[r["mrays_per_s"] for r in warm],
                             render_s=res["elapsed_s"], shaded=shaded_c, any_hit=any_c,
                             phase_s=time.perf_counter() - t0)
    kernels["bvh"]["max_abs_err"] = max(any_c["max_abs_err"], closest["max_abs_err"],
                                       any_hit["max_abs_err"])
    kernels["bvh_shaded"]["max_abs_err"] = max(shaded_c["max_abs_err"], shaded["max_abs_err"])
    print(f"phase 7c: Path, grid of {job.scene.triangles.count} triangles (BVH depth "
          f"{ctx.bvh.depth}) {job.film.xres}x{job.film.yres}x8, max_depth {depth}: {rays} rays, "
          f"launches {counts}, "
          f"{colored} coloured px; first render {res['mrays_per_s']:.2f} camera Mrays/s "
          f"({rate(res, depth):.1f} M shadow-ray slots/s), warm "
          f"{warm_rates_s(warm)}; "
          + "; ".join(
              f"{tag} {h['ms']:.3f} ms (wrapper {h['wrapper_ms']:.3f}, bound {h['bound_ms']:.4f} by "
              f"{h['bound_by']}, plain {h['plain_ms']:.1f} over {h['plain_rays']} rays, hits "
              f"{h['hits']}, hit/miss differ {h['miss_mismatch']:.2e})"
              for tag, h in (("K3-shaded", shaded_c), ("K3 any", any_c)))
          + f"; {time.perf_counter() - t0:.1f} s [{card}]")

    # (d) the wavefront li_path against the path kernel on the fixture
    t0 = time.perf_counter()
    job = load_scene(str(SCENE))
    job.film.xres, job.film.yres = 160, 90
    sampler = StratifiedSampler(job.sampler)
    cam = RealisticCamera(job.camera, job.film, device=dev)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    zero_counts()
    l_k1, w_k1 = pmk.li_path_mega_cam(pmk.pack_scene(job.scene, dev), pmk.pack_camera(cam), pxy,
                                      pid, soff, sampler, job.integrator)
    o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
    l_wf = li_path(SceneCtx.from_scene(job.scene, dev), o, d, w, sampler, pid, soff,
                   job.integrator)
    torch.cuda.synchronize()
    counts = all_counts()
    check(counts["path_mega_cam"] == 1 and counts["intersect"] > 0, f"7d launches {counts}")
    l_wf = torch.where((w > 0.0)[:, None], l_wf, 0.0).double()
    l_k1 = torch.where((w_k1 > 0.0)[:, None], l_k1, 0.0).double()
    rel = (l_wf - l_k1).abs() / l_k1.abs().clamp(min=1e-3)
    bar = dict(rays=int(l_k1.shape[0]), lit=int((l_k1.amax(-1) > 0).sum()),
               diverged=float((rel.amax(-1) > 1e-3).double().mean()),
               q99=float(torch.quantile(rel.flatten(), 0.99)), mean=float(l_wf.mean()),
               mean_ref=float(l_k1.mean()), weight_max_abs_err=float((w - w_k1).abs().max()))
    check(bar["lit"] >= 1000, f"7d: {bar['lit']} lit rays")
    check(bar["diverged"] < 5e-3, f"7d: {bar['diverged']:.2%} of rays diverged")
    check(abs(bar["mean"] - bar["mean_ref"]) < 1e-6 + 3e-3 * abs(bar["mean_ref"]),
          f"7d: means {bar['mean']:.6g} vs {bar['mean_ref']:.6g}")
    record["phase7d"] = dict(launches=counts, phase_s=time.perf_counter() - t0, **bar)
    print(f"phase 7d: wavefront li_path (K4) vs the path kernel, samples/scene.json "
          f"{job.film.xres}x{job.film.yres}x16: "
          f"{bar['rays']} rays, {bar['lit']} lit, diverged {bar['diverged']:.2e}, q99 "
          f"{bar['q99']:.2e}, mean {bar['mean']:.6g} vs {bar['mean_ref']:.6g}, camera weight "
          f"max_abs_err {bar['weight_max_abs_err']:.3g}; {time.perf_counter() - t0:.1f} s [{card}]")


# ---- phase 8: the widened path kernel ----


def hold_rays(job, packed, rays, stride, dev):
    """The rays-in kernel (#3, or #4 over a BVH) against its plain version
    on `rays` = (o, d, weight, pixel_id, s_idx, sampler): the kernel on
    all of them, the plain version on a seeded random 1/`stride`.  Returns
    the measured numbers (with the slot matrix's ms under Halton)."""
    o, d, w, pid, sid, sampler = rays
    args = (packed, o, d, w, pid, sid, sampler, job.integrator)
    l = pmk.li_path_mega(*args)
    torch.cuda.synchronize()
    n = o.shape[0]
    pick = torch.randperm(n, generator=torch.Generator().manual_seed(stride))[: n // stride]
    sub = pick.sort().values.to(dev)
    sub_args = (packed, o[sub], d[sub], w[sub], pid[sub], sid[sub], sampler, job.integrator)
    work = {}
    l_ref, plain_ms = timed_once(lambda: pmk.li_path_mega_reference(*sub_args, work=work))
    bar = per_ray_bar(l[sub], l_ref)
    max_abs_err = float((l[sub] - l_ref).abs().max())
    del l, l_ref
    ms = timed_ms(pmk.prepare_rays_launch(*args), reps=10)
    extra = {"occupancy": pmk.occupancy()} if packed.bvh is None else {}
    wrapper_ms = timed_ms(lambda: pmk.li_path_mega(*args))
    scale = n / sub.numel()
    slots = halton_slots(packed, job.integrator, sampler, False)
    ray_bytes = RAYS_IN_BYTES - (8 if slots else 0)
    bound_ms, bound_by = bound(work, scale, n, packed, ray_bytes=ray_bytes)
    extra.update(walk_numbers(work, scale, n,
                              lambda w: bound(w, scale, n, packed, ray_bytes=ray_bytes)))
    if slots is not None:
        extra["slot_ms"] = timed_ms(lambda: sampler.slot_matrix(pid, sid, slots))
        extra["slot_rows"] = pmk.slot_cols(slots)[1]
    return dict(rays=n, plain_rays=int(sub.numel()), bvh=packed.bvh is not None,
                max_abs_err=max_abs_err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                work={k: float(v) * scale for k, v in work.items()}, **bar, **extra)


def furnace_rays(job, n, dev, seed=3):
    """tests/test_furnace.py:62-88's rays about the furnace sphere's centre:
    n parallel rays down +x through a disk of radius 0.6."""
    centre = job.scene.spheres.o2w[0, :3, 3].astype(np.float64)
    rng = np.random.default_rng(seed)
    yz = rng.random((2 * n, 2)) * 1.2 - 0.6
    yz = yz[np.hypot(yz[:, 0], yz[:, 1]) < 0.6][:n]
    o = np.concatenate([np.full((n, 1), -5.0), yz], 1) + centre
    o = torch.tensor(o, dtype=torch.float32, device=dev)
    d = torch.tensor([[1.0, 0.0, 0.0]], device=dev).expand(n, 3).contiguous()
    return (o, d, torch.ones(n, device=dev), torch.arange(n, device=dev),
            torch.zeros(n, dtype=torch.int64, device=dev), StratifiedSampler(job.sampler, seed=seed))


def wide_entry(kernels, name, tag, held):
    """The widened kernel's numbers on a new fixture, beside the line's."""
    kernels[name].update({f"{tag}_{k}": held[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                          "rays")})
    kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], held["max_abs_err"])


def wide_phase(record, kernels, card, dev):
    """Phase 8 (see the module docstring)."""
    # (a), (b): the sphere-area and environment fixtures through the camera instance
    for tag, scene in (("sphere_area", SCENE_SPHERE_AREA), ("env", SCENE_ENV)):
        t0 = time.perf_counter()
        step = "8a" if tag == "sphere_area" else "8b"
        res, colored, launches = drive(scene, OUT / f"chip_smoke_{tag}.png", "path_mega_cam",
                                       "path")
        job = load_scene(str(scene))
        held = hold(pmk, job, 4, dev)
        warm = warm_rates(job, dev, 2)
        wide_entry(kernels, "path_mega_cam", tag, held)
        record[f"phase{step}"] = dict(launches=launches, colored=colored,
                                      render_mrays_per_s=res["mrays_per_s"], warm_mrays_per_s=warm,
                                      phase_s=time.perf_counter() - t0, **held)
        print(describe(f"phase {step}: Path, {scene.relative_to(ROOT)} 640x360x16", res, launches,
                       colored, held, warm, card))

    # (c) the grid with the spheres and the sphere light over the BVH
    t0 = time.perf_counter()
    grid = write_grid_scene(str(OUT / "grid_spheres"), base=str(SCENE_SPHERE_AREA))
    res, colored, launches = drive(grid, OUT / "chip_smoke_grid_spheres.png", "path_mega_cam_bvh",
                                   "path", 8)
    job = load_scene(grid)
    check(res["bvh"] and job.scene.spheres.count == 2, "8c: not the BVH instance with spheres")
    job.sampler.xsamp, job.sampler.ysamp = 2, 4
    held = hold(pmk, job, 8, dev)
    warm = warm_rates(job, dev, 2)
    wide_entry(kernels, "path_mega_cam_bvh", "grid_spheres", held)
    record["phase8c"] = dict(triangles=job.scene.triangles.count, launches=launches,
                             colored=colored, render_mrays_per_s=res["mrays_per_s"],
                             warm_mrays_per_s=warm, phase_s=time.perf_counter() - t0, **held)
    print(describe(f"phase 8c: Path, grid of {job.scene.triangles.count} triangles, 2 spheres and "
                   f"a sphere light 640x360x8", res, launches, colored, held, warm, card))

    # (d) the rays-in instance on the white furnace
    t0 = time.perf_counter()
    fjob = load_scene(str(SCENE_FURNACE))
    packed = pmk.pack_scene(fjob.scene, dev)
    rays = furnace_rays(fjob, 1 << 20, dev)
    o, d, w, pid, sid, sampler = rays
    zero_counts()
    l = pmk.li_path_mega(packed, o, d, w, pid, sid, sampler, fjob.integrator)
    l_esc = pmk.li_path_mega(packed, o, -d, w, pid, sid, sampler, fjob.integrator)
    torch.cuda.synchronize()
    counts = all_counts()
    check(counts["path_mega"] == 2 and sum(counts.values()) == 2, f"8d launches {counts}")
    mean = l.double().mean(0)
    esc_err = float((l_esc - 1.0).abs().max())
    check(bool(torch.isfinite(l).all()) and l.shape == o.shape, "8d: bad furnace radiance")
    check(float((mean - 0.5).abs().max()) < 0.015 * 0.5 + 0.004, f"8d: furnace mean {mean.tolist()}")
    check(esc_err <= 1e-6, f"8d: escaped rays read {esc_err:.3g} off 1")
    held = hold_rays(fjob, packed, rays, 16, dev)
    add_entry(kernels, "path_mega", counts["path_mega"], held)
    record["phase8d"] = dict(launches=counts, furnace_mean=mean.tolist(),
                             escaped_max_abs_err=esc_err, phase_s=time.perf_counter() - t0, **held)
    print(f"phase 8d: rays-in #3, white furnace on {o.shape[0]} parallel rays: mean "
          f"{', '.join(f'{v:.6f}' for v in mean.tolist())} (rho 0.5, bar 0.0115), escaped max "
          f"|L - 1| {esc_err:.3g}, {counts['path_mega']} launches; kernel {held['ms']:.3f} ms "
          f"(wrapper {held['wrapper_ms']:.3f}), bound {held['bound_ms']:.4f} ms by "
          f"{held['bound_by']}, plain {held['plain_ms']:.1f} ms over {held['plain_rays']} rays, "
          f"diverged {held['diverged']:.2e}, q99 {held['q99']:.2e}, max_abs_err "
          f"{held['max_abs_err']:.3g}; {time.perf_counter() - t0:.1f} s [{card}]")

    # (e) the rays-in BVH instance on (c)'s camera rays
    t0 = time.perf_counter()
    packed = pmk.pack_scene(job.scene, dev)
    sampler = StratifiedSampler(job.sampler)
    cam = RealisticCamera(job.camera, job.film, device=dev)
    pxy, pid, soff = sample_batch(job.film, 8, dev)
    o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
    zero_counts()
    pmk.li_path_mega(packed, o, d, w, pid, soff, sampler, job.integrator)
    torch.cuda.synchronize()
    counts = all_counts()
    check(counts["path_mega_bvh"] == 1 and sum(counts.values()) == 1, f"8e launches {counts}")
    held = hold_rays(job, packed, (o, d, w, pid, soff, sampler), 8, dev)
    add_entry(kernels, "path_mega_bvh", counts["path_mega_bvh"], held)
    record["phase8e"] = dict(launches=counts, phase_s=time.perf_counter() - t0, **held)
    print(f"phase 8e: rays-in #4 over the BVH, 8c's {held['rays']} camera rays: 1 launch; kernel "
          f"{held['ms']:.3f} ms (wrapper {held['wrapper_ms']:.3f}), bound {held['bound_ms']:.4f} ms "
          f"by {held['bound_by']}, plain {held['plain_ms']:.1f} ms over {held['plain_rays']} rays, "
          f"diverged {held['diverged']:.2e}, q99 {held['q99']:.2e}, mean {held['mean']:.6g} vs "
          f"{held['mean_ref']:.6g}, max_abs_err {held['max_abs_err']:.3g}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")

    # (f) Path on what only the wavefront loop renders
    t0 = time.perf_counter()
    scene = write_wavefront_scene(str(OUT / "wavefront"), xres=320, yres=180)
    job = load_scene(scene)
    depth = job.integrator.max_depth
    reason = pmk.unsupported_feature(job.scene, job.integrator, StratifiedSampler(job.sampler))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        res, colored, counts = drive_wavefront(scene, OUT / "chip_smoke_wavefront.png",
                                               {"intersect": 2 * depth})
    line = err.getvalue().strip()
    check("wavefront loop" in line and reason in line, f"8f: stderr {line!r}")
    record["phase8f"] = dict(reason=reason, launches=counts, colored=colored,
                             camera_rays=res["camera_rays"], mrays_per_s=res["mrays_per_s"],
                             render_s=res["elapsed_s"], phase_s=time.perf_counter() - t0)
    print(f"phase 8f: Path, {Path(scene).name} 320x180x16 (a partial sphere, a distant and a "
          f"triangle light): stderr [{line}]; {res['camera_rays']} rays, launches {counts}, "
          f"{colored} coloured px, {res['mrays_per_s']:.2f} Mrays/s; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")

    # (g) the wavefront li_path against the path kernel on (a)
    t0 = time.perf_counter()
    job = load_scene(str(SCENE_SPHERE_AREA))
    job.film.xres, job.film.yres = 160, 90
    sampler = StratifiedSampler(job.sampler)
    cam = RealisticCamera(job.camera, job.film, device=dev)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    zero_counts()
    l_k1, w_k1 = pmk.li_path_mega_cam(pmk.pack_scene(job.scene, dev), pmk.pack_camera(cam), pxy,
                                      pid, soff, sampler, job.integrator)
    o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
    l_wf = li_path(SceneCtx.from_scene(job.scene, dev), o, d, w, sampler, pid, soff,
                   job.integrator)
    torch.cuda.synchronize()
    counts = all_counts()
    check(counts["path_mega_cam"] == 1 and counts["intersect"] > 0, f"8g launches {counts}")
    l_wf = torch.where((w > 0.0)[:, None], l_wf, 0.0).double()
    l_k1 = torch.where((w_k1 > 0.0)[:, None], l_k1, 0.0).double()
    rel = (l_wf - l_k1).abs() / l_k1.abs().clamp(min=1e-3)
    bar = dict(rays=int(l_k1.shape[0]), lit=int((l_k1.amax(-1) > 0).sum()),
               diverged=float((rel.amax(-1) > 1e-3).double().mean()),
               q99=float(torch.quantile(rel.flatten(), 0.99)), mean=float(l_wf.mean()),
               mean_ref=float(l_k1.mean()), weight_max_abs_err=float((w - w_k1).abs().max()))
    check(bar["lit"] >= 1000, f"8g: {bar['lit']} lit rays")
    check(bar["diverged"] < 5e-3, f"8g: {bar['diverged']:.2%} of rays diverged")
    check(abs(bar["mean"] - bar["mean_ref"]) < 1e-6 + 3e-3 * abs(bar["mean_ref"]),
          f"8g: means {bar['mean']:.6g} vs {bar['mean_ref']:.6g}")
    record["phase8g"] = dict(launches=counts, phase_s=time.perf_counter() - t0, **bar)
    print(f"phase 8g: wavefront li_path (K4) vs the path kernel, samples/scene_sphere_area.json "
          f"160x90x16: {bar['rays']} rays, {bar['lit']} lit, diverged {bar['diverged']:.2e}, q99 "
          f"{bar['q99']:.2e}, mean {bar['mean']:.6g} vs {bar['mean_ref']:.6g}, camera weight "
          f"max_abs_err {bar['weight_max_abs_err']:.3g}; {time.perf_counter() - t0:.1f} s [{card}]")



# ---- phase 9: the Halton sampler and smooth normals ----


def launched(counts):
    return {k: v for k, v in counts.items() if v}


def halton6(base, out_dir, xres=640, yres=360):
    """base at xres x yres under a 6-sample HaltonSampler: one pass of six."""
    return Path(write_variant(str(base), str(out_dir), xres, yres, HALTON6))


def drive_rays(job, stride, dev, bvh=None):
    """The rays-in instance on the camera rays of one pass of `job` (its
    sampler), counts set to 0 just before: (kernel name, launches, held)."""
    packed = pmk.pack_scene(job.scene, dev, bvh=bvh)
    sampler = make_sampler(job)
    cam = RealisticCamera(job.camera, job.film, device=dev)
    pxy, pid, soff = sample_batch(job.film, pass_spp(sampler.spp), dev)
    o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
    name = pmk.kernel_name("path_mega", packed.bvh is not None,
                           isinstance(sampler, HaltonSampler), packed.smooth,
                           packed.bssrdf is not None)
    zero_counts()
    pmk.li_path_mega(packed, o, d, w, pid, soff, sampler, job.integrator)
    torch.cuda.synchronize()
    counts = all_counts()
    check(counts[name] == 1 and sum(counts.values()) == 1, f"{name} launches {counts}")
    return name, counts[name], hold_rays(job, packed, (o, d, w, pid, soff, sampler), stride, dev)


def bvh_yardstick(job, dev, turns=2):
    """The BVH instances against the brute-force ones on a brute-force
    scene's pass (pack_scene(..., bvh=True)): the camera instances on one
    pass's samples and the rays-in ones on its camera rays, each pair timed
    in turns (median), and the rays whose radiance is not bit-equal (the
    BVH's leaf order may pick the other triangle of an exact tie)."""
    cam = RealisticCamera(job.camera, job.film, device=dev)
    sampler = make_sampler(job)
    pxy, pid, soff = sample_batch(job.film, pass_spp(sampler.spp), dev)
    o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
    packs = {"brute": pmk.pack_scene(job.scene, dev), "bvh": pmk.pack_scene(job.scene, dev, bvh=True)}
    check(packs["bvh"].bvh is not None and packs["brute"].bvh is None, "yardstick: wrong packs")
    cam_p = pmk.pack_camera(cam)
    out = dict(rays=int(pxy.shape[0]))
    for key, prep, args in (
        ("cam", pmk.prepare_launch, (cam_p, pxy, pid, soff, sampler, job.integrator)),
        ("rays", pmk.prepare_rays_launch, (o, d, w, pid, soff, sampler, job.integrator)),
    ):
        launch = {k: prep(p, *args) for k, p in packs.items()}
        first = lambda r: r[0] if isinstance(r, tuple) else r
        l_b, l_t = first(launch["brute"]()).clone(), first(launch["bvh"]())
        torch.cuda.synchronize()
        out[f"{key}_rays_apart"] = int((l_b != l_t).any(-1).sum())
        times = [{k: timed_ms(f, reps=10) for k, f in launch.items()} for _ in range(turns)]
        for k in packs:
            out[f"{key}_{k}_ms"] = statistics.median(t[k] for t in times)
    return out


def rays_line(tag, name, held, t0, card):
    slot = (f"slot matrix {held['slot_ms']:.3f} ms ({held['slot_rows']} rows), "
            if "slot_ms" in held else "")
    return (f"{tag}: {name}, 1 launch on {held['rays']} rays; kernel {held['ms']:.3f} ms (wrapper "
            f"{held['wrapper_ms']:.3f}), {slot}bound {held['bound_ms']:.4f} ms by "
            f"{held['bound_by']}, plain {held['plain_ms']:.1f} ms over {held['plain_rays']} rays, "
            f"diverged {held['diverged']:.2e}, q99 {held['q99']:.2e} ({held['lit']} lit: "
            f"{held['lit_diverged']:.2e}, {held['lit_q99']:.2e}), mean {held['mean']:.6g} vs "
            f"{held['mean_ref']:.6g}, max_abs_err {held['max_abs_err']:.3g}{walk_text(held)}; "
            f"{time.perf_counter() - t0:.1f} s [{card}]")


def camera_step(record, kernels, card, dev, step, tag, scene, kernel, stride, spp=None,
                warm_n=2, entry=True):
    """One camera-instance main path: deploy_render of `scene` through
    `kernel` (counts at 0 before, read after), the kernel held to its plain
    version on a seeded 1/`stride` of one pass, warm renders; adds the
    kernel's entry (or, when it has one, this scene's numbers beside it)."""
    t0 = time.perf_counter()
    res, colored, launches = drive(scene, OUT / f"chip_smoke_{tag}.png", kernel, "path", spp)
    job = load_scene(str(scene))
    if spp == 8:
        job.sampler.xsamp, job.sampler.ysamp = 2, 4
    held = hold(pmk, job, stride, dev)
    warm = warm_rates(job, dev, warm_n) if warm_n else []
    if kernel in kernels:
        wide_entry(kernels, kernel, tag, held)
    else:
        add_entry(kernels, kernel, launches, held)
    record[f"phase{step}"] = dict(triangles=job.scene.triangles.count, launches=launches,
                                  passes=res["passes"], colored=colored,
                                  render_mrays_per_s=res["mrays_per_s"], warm_mrays_per_s=warm,
                                  phase_s=time.perf_counter() - t0, **held)
    size = f"{job.film.xres}x{job.film.yres}x{res['camera_rays'] // (job.film.xres * job.film.yres)}"
    print(describe(f"phase {step}: Path, {tag} {size} ({job.scene.triangles.count} triangles)",
                   res, launches, colored, held, warm, card))
    return job


def halton_smooth_phase(record, kernels, card, dev):
    """Phase 9 (see the module docstring)."""
    # (a) the bench's halton row: 256 spp, 16 passes of 3.69M rays
    camera_step(record, kernels, card, dev, "9a", "halton", SCENE_HALTON,
                "path_mega_cam_halton", 4)
    check(record["phase9a"]["passes"] == 16, "9a: not 16 passes")
    # (b) 6 spp: one pass of six, not a power of two
    camera_step(record, kernels, card, dev, "9b", "halton6",
                halton6(SCENE, OUT / "halton6", 160, 90),
                "path_mega_cam_halton", 1, warm_n=0)

    # (c) #3 under Halton on the white furnace
    t0 = time.perf_counter()
    fjob = load_scene(str(SCENE_FURNACE))
    packed = pmk.pack_scene(fjob.scene, dev)
    o, d, w, pid, sid, _ = furnace_rays(fjob, 1 << 20, dev)
    sampler = HaltonSampler(SamplerSpec("halton", nsamp=1), 1024, 1024)
    zero_counts()
    l = pmk.li_path_mega(packed, o, d, w, pid, sid, sampler, fjob.integrator)
    l_esc = pmk.li_path_mega(packed, o, -d, w, pid, sid, sampler, fjob.integrator)
    torch.cuda.synchronize()
    counts = all_counts()
    check(counts["path_mega_halton"] == 2 and sum(counts.values()) == 2, f"9c launches {counts}")
    mean = l.double().mean(0)
    esc_err = float((l_esc - 1.0).abs().max())
    check(bool(torch.isfinite(l).all()) and l.shape == o.shape, "9c: bad furnace radiance")
    check(float((mean - 0.5).abs().max()) < 0.015 * 0.5 + 0.004, f"9c: furnace mean {mean.tolist()}")
    check(esc_err <= 1e-6, f"9c: escaped rays read {esc_err:.3g} off 1")
    held = hold_rays(fjob, packed, (o, d, w, pid, sid, sampler), 16, dev)
    add_entry(kernels, "path_mega_halton", counts["path_mega_halton"], held)
    record["phase9c"] = dict(launches=counts, furnace_mean=mean.tolist(),
                             escaped_max_abs_err=esc_err, phase_s=time.perf_counter() - t0, **held)
    print(f"phase 9c: rays-in #3 under Halton, white furnace on {o.shape[0]} rays: mean "
          f"{', '.join(f'{v:.6f}' for v in mean.tolist())} (rho 0.5, bar 0.0115), escaped max "
          f"|L - 1| {esc_err:.3g}; " + rays_line("held", "path_mega_halton", held, t0, card))

    # (d) AO under Halton through the wavefront loop and K4
    t0 = time.perf_counter()
    ao = write_variant(str(SCENE_AO), str(OUT / "ao_halton"),
                       sampler={"sampler_type": "HaltonSampler", "nsamp": 16})
    job = load_scene(str(ao))
    check(isinstance(make_sampler(job), HaltonSampler), "9d: not a Halton sampler")
    n_probe = job.integrator.n_samples
    res, colored, counts = drive_wavefront(ao, OUT / "chip_smoke_ao_halton.png",
                                           {"intersect": 1 + n_probe})
    warm = [render_job(job, dev) for _ in range(2)]
    record["phase9d"] = dict(launches=counts, colored=colored, camera_rays=res["camera_rays"],
                             camera_mrays_per_s=res["mrays_per_s"],
                             warm_camera_mrays_per_s=[r["mrays_per_s"] for r in warm],
                             phase_s=time.perf_counter() - t0)
    print(f"phase 9d: AO under Halton, samples/scene_ao.json 640x360x16, {n_probe} probes: "
          f"{res['camera_rays']} camera rays, launches {launched(counts)}, {colored} coloured px; "
          f"first "
          f"render {res['mrays_per_s']:.2f} camera Mrays/s, warm {warm_rates_s(warm)}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")

    # (e) the smooth fixture through #1
    job = camera_step(record, kernels, card, dev, "9e", "smooth", SCENE_SMOOTH,
                      "path_mega_cam_smooth", 16)
    # and #3 smooth on its 3.69M camera rays (the plain version on 1/64)
    t0 = time.perf_counter()
    name, launches, held = drive_rays(job, 64, dev)
    check(name == "path_mega_smooth", f"9e: {name}")
    add_entry(kernels, name, launches, held)
    record["phase9e_rays"] = dict(launches=launches, phase_s=time.perf_counter() - t0, **held)
    print(rays_line("phase 9e: rays-in #3 smooth on its camera rays", name, held, t0, card))
    t0 = time.perf_counter()
    yard = bvh_yardstick(job, dev)
    record["phase9e_bvh_yardstick"] = yard
    print(f"phase 9e: yardstick, the smooth fixture's pass through the BVH instances "
          f"(pack_scene(..., bvh=True)) in turns with the brute-force ones on the same samples: "
          f"camera {yard['cam_bvh_ms']:.3f} ms against {yard['cam_brute_ms']:.3f}, rays-in "
          f"{yard['rays_bvh_ms']:.3f} against {yard['rays_brute_ms']:.3f} on its camera rays "
          f"({yard['cam_rays_apart']} / {yard['rays_rays_apart']} of {yard['rays']} rays not "
          f"bit-equal); {time.perf_counter() - t0:.1f} s [{card}]")

    # (f) 20 smooth spheres (19,236 triangles) through #2, and #4 on its rays
    grid20 = Path(write_smooth_grid_scene(str(OUT / "smooth_grid20"), n=20))
    job = camera_step(record, kernels, card, dev, "9f", "smooth_grid20", grid20,
                      "path_mega_cam_bvh_smooth", 8, spp=8)
    check(record["phase9f"]["bvh"], "9f: not the BVH instance")
    t0 = time.perf_counter()
    name, launches, held = drive_rays(job, 8, dev)
    check(name == "path_mega_bvh_smooth", f"9f: {name}")
    add_entry(kernels, name, launches, held)
    record["phase9f_rays"] = dict(launches=launches, phase_s=time.perf_counter() - t0, **held)
    print(rays_line("phase 9f: rays-in #4 smooth on the grid's camera rays", name, held, t0, card))

    # (g) 80 smooth spheres (76,836 triangles): the wavefront loop, K3-shaded smooth
    t0 = time.perf_counter()
    grid80 = write_smooth_grid_scene(str(OUT / "smooth_grid80"), n=80)
    job = load_scene(grid80)
    depth = job.integrator.max_depth
    check(job.scene.triangles.count > pmk.BVH_TRI_MAX, "9g: the grid fits the path kernel")
    res, colored, counts = drive_wavefront(
        grid80, OUT / "chip_smoke_smooth_grid80.png",
        {"bvh_shaded_smooth": depth, "bvh_any": depth}, 8)
    ctx, batches = first_pass_batches(job, dev, 8)
    check(ctx.bvh.smooth, "9g: flat shade rows")
    shaded = hold_query("shaded", ctx, batches["shaded"])
    wavefront_entry(kernels, "bvh_shaded_smooth", counts["bvh_shaded_smooth"], shaded)
    record["phase9g"] = dict(triangles=job.scene.triangles.count, launches=counts,
                             colored=colored, camera_rays=res["camera_rays"],
                             camera_mrays_per_s=res["mrays_per_s"], shaded=shaded,
                             phase_s=time.perf_counter() - t0)
    h = shaded
    print(f"phase 9g: Path, {job.scene.triangles.count} smooth triangles 640x360x8 through the "
          f"wavefront loop: launches {launched(counts)}, {colored} coloured px, "
          f"{res['mrays_per_s']:.2f} "
          f"camera Mrays/s; K3-shaded smooth {h['ms']:.3f} ms (wrapper {h['wrapper_ms']:.3f}, "
          f"bound {h['bound_ms']:.4f} by {h['bound_by']}, plain {h['plain_ms']:.1f} over "
          f"{h['plain_rays']} rays, hits {h['hits']}, hit/miss differ {h['miss_mismatch']:.2e}, "
          f"max_abs_err {h['max_abs_err']:.3g}); {time.perf_counter() - t0:.1f} s [{card}]")

    # (h) the wavefront li_path against the path kernel on the smooth fixture
    t0 = time.perf_counter()
    job = load_scene(str(SCENE_SMOOTH))
    job.film.xres, job.film.yres = 160, 90
    sampler = StratifiedSampler(job.sampler)
    cam = RealisticCamera(job.camera, job.film, device=dev)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    zero_counts()
    l_k1, w_k1 = pmk.li_path_mega_cam(pmk.pack_scene(job.scene, dev), pmk.pack_camera(cam), pxy,
                                      pid, soff, sampler, job.integrator)
    o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
    l_wf = li_path(SceneCtx.from_scene(job.scene, dev), o, d, w, sampler, pid, soff,
                   job.integrator)
    torch.cuda.synchronize()
    counts = all_counts()
    check(counts["path_mega_cam_smooth"] == 1 and counts["bvh_shaded_smooth"] > 0,
          f"9h launches {counts}")
    l_wf = torch.where((w > 0.0)[:, None], l_wf, 0.0).double()
    l_k1 = torch.where((w_k1 > 0.0)[:, None], l_k1, 0.0).double()
    rel = (l_wf - l_k1).abs() / l_k1.abs().clamp(min=1e-3)
    bar = dict(rays=int(l_k1.shape[0]), lit=int((l_k1.amax(-1) > 0).sum()),
               diverged=float((rel.amax(-1) > 1e-3).double().mean()),
               q99=float(torch.quantile(rel.flatten(), 0.99)), mean=float(l_wf.mean()),
               mean_ref=float(l_k1.mean()), weight_max_abs_err=float((w - w_k1).abs().max()))
    check(bar["lit"] >= 1000, f"9h: {bar['lit']} lit rays")
    check(bar["diverged"] < 5e-3, f"9h: {bar['diverged']:.2%} of rays diverged")
    check(abs(bar["mean"] - bar["mean_ref"]) < 1e-6 + 3e-3 * abs(bar["mean_ref"]),
          f"9h: means {bar['mean']:.6g} vs {bar['mean_ref']:.6g}")
    record["phase9h"] = dict(launches=counts, phase_s=time.perf_counter() - t0, **bar)
    print(f"phase 9h: wavefront li_path (K3 smooth) vs the path kernel, samples/scene_smooth.json "
          f"160x90x16: {bar['rays']} rays, {bar['lit']} lit, diverged {bar['diverged']:.2e}, q99 "
          f"{bar['q99']:.2e}, mean {bar['mean']:.6g} vs {bar['mean_ref']:.6g}, camera weight "
          f"max_abs_err {bar['weight_max_abs_err']:.3g}; {time.perf_counter() - t0:.1f} s [{card}]")

    # (i) the other Halton instances at 640x360 x 6, one pass of 1.38M
    # rays: smooth brute force, the cube grid and the smooth grid over the
    # BVH, and their rays-in twins.  The brute-force plain version over
    # 1,956 triangles takes ~10 s whatever the rays (a loop of triangles):
    # it runs on a seeded 1/64 there, the BVH ones on 1/16
    grid = write_grid_scene(str(OUT / "grid_halton"), base=str(SCENE))
    for step, tag, scene, kernel, stride in (
        ("9i1", "smooth_halton6", halton6(SCENE_SMOOTH, OUT / "smooth_halton6"),
         "path_mega_cam_halton_smooth", 64),
        ("9i2", "grid_halton6", halton6(grid, OUT / "grid_halton6"), "path_mega_cam_bvh_halton",
         16),
        ("9i3", "smooth_grid_halton6", halton6(grid20, OUT / "smooth_grid_halton6"),
         "path_mega_cam_bvh_halton_smooth", 16),
    ):
        job = camera_step(record, kernels, card, dev, step, tag, scene, kernel, stride, warm_n=0)
        t0 = time.perf_counter()
        name, launches, held = drive_rays(job, stride, dev)
        add_entry(kernels, name, launches, held)
        record[f"phase{step}_rays"] = dict(launches=launches, phase_s=time.perf_counter() - t0,
                                           **held)
        print(rays_line(f"phase {step}: rays-in on its camera rays", name, held, t0, card))


# ---- phase 10: Disney through the path kernel, the rest through the wavefront loop ----


def disney_smooth(out_dir):
    """samples/scene_smooth.json with every primitive in the plain Disney
    material of samples/scene_disney.json (its cubes) or its anisotropic
    one (the two smooth spheres)."""
    cfg = json.loads(SCENE_SMOOTH.read_text())
    cfg["materials"] += json.loads(SCENE_DISNEY.read_text())["materials"][-2:]
    for prim in cfg["Aggregate"]["primitives"]:
        prim["material_name"] = "mat_disney_aniso" if prim["obj_name"] == "sphere" else "mat_disney"
    out_dir.mkdir(parents=True, exist_ok=True)
    for mesh in ("cube.obj", "sphere_smooth.obj"):
        (out_dir / mesh).write_bytes((ROOT / "samples" / mesh).read_bytes())
    path = out_dir / "scene_disney_smooth.json"
    path.write_text(json.dumps(cfg))
    return path


def materials_phase(record, kernels, card, dev):
    """Phase 10 (see the module docstring)."""
    # (a) the Disney fixture through the camera instance, one launch a pass
    job = camera_step(record, kernels, card, dev, "10a", "disney", SCENE_DISNEY,
                      "path_mega_cam", 4)
    check(set(pmk.DISNEY_KINDS) <= set(pmk.pack_scene(job.scene, dev).kinds_present),
          "10a: not every Disney lobe live")
    # (b) #3 on (a)'s camera rays; the grid of Disney cubes over the BVH (#2)
    # and #4 on its camera rays
    t0 = time.perf_counter()
    name, launches, held = drive_rays(job, 4, dev)
    wide_entry(kernels, name, "disney", held)
    record["phase10b_rays"] = dict(launches=launches, phase_s=time.perf_counter() - t0, **held)
    print(rays_line("phase 10b: rays-in #3 on the Disney fixture's camera rays", name, held, t0,
                    card))
    grid = write_grid_scene(str(OUT / "grid_disney"), base=str(SCENE_DISNEY))
    job = camera_step(record, kernels, card, dev, "10b", "grid_disney", grid, "path_mega_cam_bvh",
                      8, spp=8)
    t0 = time.perf_counter()
    name, launches, held = drive_rays(job, 16, dev)
    wide_entry(kernels, name, "grid_disney", held)
    record["phase10b_grid_rays"] = dict(launches=launches, phase_s=time.perf_counter() - t0,
                                        **held)
    print(rays_line("phase 10b: rays-in #4 on the Disney grid's camera rays", name, held, t0, card))
    # (c) the Halton and smooth instances on Disney rays
    camera_step(record, kernels, card, dev, "10c1", "disney_halton6",
                halton6(SCENE_DISNEY, OUT / "disney_halton6"), "path_mega_cam_halton", 4,
                warm_n=0)
    camera_step(record, kernels, card, dev, "10c2", "disney_smooth",
                disney_smooth(OUT / "disney_smooth"), "path_mega_cam_smooth", 64, warm_n=0)

    # (d) the materials only the wavefront loop takes, through it
    t0 = time.perf_counter()
    res, colored, counts = drive_announced(SCENE_MATERIALS, OUT / "chip_smoke_materials.png",
                                           "10d")
    # its li_path on the card (K4) against the same on the CPU (K4's plain
    # version) on the same camera rays, at 80x45x16: the bar of 7d
    bar = card_vs_cpu(SCENE_MATERIALS, 80, 45, dev, "10d")
    # with the 3-vector sums taken in one order on both devices, what
    # still parts card from CPU here starts at atan2's last bits (PERF.md
    # section 7): the lit rays' share is held
    check_lit(bar, "10d", same_rays=False)
    record["phase10d"] = dict(launches=counts, colored=colored, camera_rays=res["camera_rays"],
                              render_mrays_per_s=res["mrays_per_s"],
                              phase_s=time.perf_counter() - t0, **bar)
    print(f"phase 10d: Path, samples/scene_materials.json 640x360x16 through the wavefront loop: "
          f"{res['camera_rays']} rays, launches {launched(counts)}, {colored} coloured px, "
          f"{res['mrays_per_s']:.2f} camera Mrays/s (first render); li_path on the card vs the "
          f"CPU at 80x45x16: {card_cpu_line(bar)}, mean {bar['mean']:.6g} vs "
          f"{bar['mean_ref']:.6g} (CPU {bar['cpu_s']:.1f} s); {time.perf_counter() - t0:.1f} s "
          f"[{card}]")


def drive_announced(scene, png, tag, want=("intersect",)):
    """deploy_render of a Path scene the path kernel rejects, counts at 0
    before: it must announce the wavefront loop on stderr and launch the
    intersection kernels `want`, each at least once, and no other.
    Returns (result, coloured pixels, counts)."""
    zero_counts()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        res = deploy_render(str(scene), str(png))
    counts = all_counts()
    rgb = res["rgb_srgb_input"]
    colored = int((rgb.sum(-1) > 0).sum())
    check(res["render_path"] == "wavefront" and "wavefront loop" in err.getvalue(),
          f"{tag}: not announced on the wavefront loop")
    check(bool(torch.isfinite(rgb).all()) and colored > 0, f"{tag}: image")
    check(all(counts[k] > 0 for k in want) and sum(counts.values()) == sum(counts[k] for k in want),
          f"{tag} launches {counts}")
    return res, colored, counts


def card_vs_cpu(scene, w_, h_, dev, tag, want=("intersect",), lit_bar=False):
    """The wavefront li_path of `scene` on the card (its queries' kernels
    `want`, each launched) against the same on the CPU (their plain
    versions) on its camera rays at w_ x h_ x 16: the bar of 7d, at least
    1,000 lit rays; with `lit_bar` the bar over the lit rays too."""
    job = load_scene(str(scene))
    job.film.xres, job.film.yres = w_, h_
    sampler = StratifiedSampler(job.sampler)
    cam = RealisticCamera(job.camera, job.film, device=dev)
    pxy, pid, soff = sample_batch(job.film, 16, dev)
    o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
    zero_counts()
    l_card = li_path(SceneCtx.from_scene(job.scene, dev), o, d, w, sampler, pid, soff,
                     job.integrator)
    torch.cuda.synchronize()
    counts = all_counts()
    check(all(counts[k] > 0 for k in want), f"{tag}: the card's li_path launches {counts}")
    cpu = torch.device("cpu")
    t_cpu = time.perf_counter()
    l_cpu = li_path(SceneCtx.from_scene(job.scene, cpu), o.cpu(), d.cpu(), w.cpu(), sampler,
                    pid.cpu(), soff.cpu(), job.integrator)
    cpu_s = time.perf_counter() - t_cpu
    l_card, l_cpu = l_card.cpu().double(), l_cpu.double()
    rel = (l_card - l_cpu).abs() / l_cpu.abs().clamp(min=1e-3)
    bar = dict(rays=int(l_cpu.shape[0]), diverged=float((rel.amax(-1) > 1e-3).double().mean()),
               q99=q99(rel), max_abs_err=float((l_card - l_cpu).abs().max()),
               mean=float(l_card.mean()), mean_ref=float(l_cpu.mean()), cpu_s=cpu_s,
               **lit_stats(rel, l_cpu))
    check(bar["lit"] >= 1000, f"{tag}: {bar['lit']} lit rays")
    if lit_bar:
        check_lit(bar, tag)
    check(bar["diverged"] < 5e-3, f"{tag}: {bar['diverged']:.2%} of rays diverged")
    check(abs(bar["mean"] - bar["mean_ref"]) < 1e-6 + 3e-3 * abs(bar["mean_ref"]),
          f"{tag}: means {bar['mean']:.6g} vs {bar['mean_ref']:.6g}")
    return bar


def card_cpu_line(bar):
    return (f"{bar['rays']} rays, diverged {bar['diverged']:.2e}, q99 {bar['q99']:.2e}; "
            f"{bar['lit']} lit: diverged {bar['lit_diverged']:.2e}, q99 {bar['lit_q99']:.2e}; "
            f"max_abs_err {bar['max_abs_err']:.3g}")


# ---- phase 11: subsurface Path ----


def subsurface_phase(record, kernels, card, dev):
    """Phase 11 (see the module docstring)."""
    # (a) the bench's sss row through the camera instance, one launch a pass
    job = camera_step(record, kernels, card, dev, "11a", "sss", SCENE_SSS, "path_mega_cam_bss", 4)
    check(pmk.pack_scene(job.scene, dev).bssrdf is not None, "11a: no subsurface constants")
    check_lit(record["phase11a"], "11a", same_rays=False)
    # (c) #3 on (a)'s camera rays
    t0 = time.perf_counter()
    name, launches, held = drive_rays(job, 4, dev)
    check(name == "path_mega_bss", f"11c: {name}")
    check_lit(held, "11c")
    add_entry(kernels, name, launches, held)
    record["phase11c_rays"] = dict(launches=launches, phase_s=time.perf_counter() - t0, **held)
    print(rays_line("phase 11c: rays-in #3 on the sss fixture's camera rays", name, held, t0,
                    card))
    # (b) the grid in mat_sss over the BVH (#2), and (c) #4 on its camera rays
    grid = write_grid_scene(str(OUT / "grid_sss"), base=str(SCENE_SSS))
    job = camera_step(record, kernels, card, dev, "11b", "grid_sss", grid,
                      "path_mega_cam_bvh_bss", 8, spp=8)
    check_lit(record["phase11b"], "11b", same_rays=False)
    t0 = time.perf_counter()
    name, launches, held = drive_rays(job, 16, dev)
    check(name == "path_mega_bvh_bss", f"11c: {name}")
    check_lit(held, "11c grid")
    add_entry(kernels, name, launches, held)
    record["phase11c_grid_rays"] = dict(launches=launches, phase_s=time.perf_counter() - t0,
                                        **held)
    print(rays_line("phase 11c: rays-in #4 on the sss grid's camera rays", name, held, t0, card))
    # (d) the Halton instances at 640x360 x 6, camera and rays-in
    for step, tag, scene, kernel, stride in (
        ("11d1", "sss_halton6", halton6(SCENE_SSS, OUT / "sss_halton6"),
         "path_mega_cam_halton_bss", 4),
        ("11d2", "grid_sss_halton6", halton6(grid, OUT / "grid_sss_halton6"),
         "path_mega_cam_bvh_halton_bss", 16),
    ):
        job = camera_step(record, kernels, card, dev, step, tag, scene, kernel, stride, warm_n=0)
        check_lit(record[f"phase{step}"], step, same_rays=False)
        t0 = time.perf_counter()
        name, launches, held = drive_rays(job, stride, dev)
        check(name == kernel.replace("_cam", ""), f"{step}: {name}")
        check_lit(held, f"{step} rays-in")
        add_entry(kernels, name, launches, held)
        record[f"phase{step}_rays"] = dict(launches=launches, phase_s=time.perf_counter() - t0,
                                           **held)
        print(rays_line(f"phase {step}: rays-in on its camera rays", name, held, t0, card))

    # (e) a subsurface material among others, beside a sphere light: the
    # wavefront loop over K4, the card against the CPU
    t0 = time.perf_counter()
    res, colored, counts = drive_announced(SCENE_SSS_MIXED, OUT / "chip_smoke_sss_mixed.png",
                                           "11e")
    bar = card_vs_cpu(SCENE_SSS_MIXED, 160, 90, dev, "11e", lit_bar=True)
    record["phase11e"] = dict(launches=counts, colored=colored, camera_rays=res["camera_rays"],
                              render_mrays_per_s=res["mrays_per_s"],
                              phase_s=time.perf_counter() - t0, **bar)
    print(f"phase 11e: Path, samples/scene_sss_mixed.json 640x360x16 through the wavefront loop: "
          f"{res['camera_rays']} rays, launches {launched(counts)}, {colored} coloured px, "
          f"{res['mrays_per_s']:.2f} camera Mrays/s (first render); li_path on the card vs the "
          f"CPU at 160x90x16: {card_cpu_line(bar)}, mean {bar['mean']:.6g} vs "
          f"{bar['mean_ref']:.6g} (CPU {bar['cpu_s']:.1f} s); {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    # and its grid over K3: the probe chain's closest hits are the BVH
    # closest-hit instance's calls on a main path.  That instance is held
    # to its plain version on the chain's first batch (the transmitting
    # lanes' segments, each cut off at seg_len (1 - 1e-4)), and the grid's
    # li_path on the card against the same on the CPU at 80x45x16
    t0 = time.perf_counter()
    grid = write_grid_scene(str(OUT / "grid_sss_mixed"), base=str(SCENE_SSS_MIXED))
    res, colored, counts = drive_announced(grid, OUT / "chip_smoke_grid_sss_mixed.png", "11e",
                                           ("bvh_closest", "bvh_shaded", "bvh_any"))
    job = load_scene(grid)
    ctx, batches = first_pass_batches(job, dev, 16)
    check("closest" in batches, "11e: the grid's probe chain cast no closest-hit batch")
    closest = hold_query("closest", ctx, batches["closest"])
    kernels["bvh"].update(closest_launches=counts["bvh_closest"], closest_ms=closest["ms"],
                          closest_bound_ms=closest["bound_ms"],
                          closest_plain_ms=closest["plain_ms"], closest_rays=closest["rays"],
                          max_abs_err=max(kernels["bvh"]["max_abs_err"], closest["max_abs_err"]))
    grid_bar = card_vs_cpu(grid, 80, 45, dev, "11e grid",
                           ("bvh_closest", "bvh_shaded", "bvh_any"), lit_bar=True)
    record["phase11e_grid"] = dict(launches=counts, colored=colored,
                                   camera_rays=res["camera_rays"],
                                   render_mrays_per_s=res["mrays_per_s"], closest=closest,
                                   card_vs_cpu=grid_bar, phase_s=time.perf_counter() - t0)
    print(f"phase 11e: Path, grid of {job.scene.triangles.count} triangles with "
          f"mat_sss cubes 640x360x16 through the wavefront loop over K3: {res['camera_rays']} "
          f"rays, launches {launched(counts)}, {colored} coloured px, {res['mrays_per_s']:.2f} "
          f"camera Mrays/s (first render); K3 closest on the probe chain's first batch "
          f"{closest['ms']:.3f} ms (wrapper {closest['wrapper_ms']:.3f}, bound "
          f"{closest['bound_ms']:.4f} by {closest['bound_by']}) over {closest['rays']} segments, "
          f"plain {closest['plain_ms']:.1f} over {closest['plain_rays']}, hits {closest['hits']}, "
          f"hit/miss differ {closest['miss_mismatch']:.2e}, max_abs_err "
          f"{closest['max_abs_err']:.3g}; li_path on the card vs the CPU at 80x45x16: "
          f"{card_cpu_line(grid_bar)} (CPU {grid_bar['cpu_s']:.1f} s); "
          f"{time.perf_counter() - t0:.1f} s [{card}]")



# ---- phase 12: textured Path; the repairs ----


def tex_queries(n, seed, dev):
    """n seeded lookups: st over [-1.2, 2.2)^2, footprint axes from 1e-4 to
    0.3 uv, the second often much shorter (the max_aniso clamp), a
    sixteenth with a zero second axis and a thirty-second with both zero
    (degenerate: level 0's bilinear tap)."""
    rng = np.random.default_rng(seed)
    st = rng.uniform(-1.2, 2.2, (n, 2))
    scale = 10 ** rng.uniform(-4.0, -0.5, (n, 1))
    d0 = rng.normal(size=(n, 2)) * scale
    d1 = rng.normal(size=(n, 2)) * scale * 10 ** rng.uniform(-2.0, 0.0, (n, 1))
    d1[: n // 16] = 0.0
    d0[: n // 32] = 0.0
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    return f(st), f(d0), f(d1)


def hold_tex(pyr, n, seed, dev):
    """K7 alone on n seeded lookups against its plain version on the same
    ones: max relative error (floor 1e-6) under 1e-5.  Returns the
    measured numbers and the bound (the lookups' 36 bytes, the texels
    the taps weigh, 10 FP32 operations each)."""
    st, d0, d1 = tex_queries(n, seed, dev)
    launch = tex_ops.prepare_launch(pyr, st, d0, d1)
    out = launch().clone()
    torch.cuda.synchronize()
    work = {}
    ref, plain_ms = timed_once(lambda: tex_ops.tex_lookup_reference(pyr, st, d0, d1, work))
    check(bool(torch.isfinite(out).all()), "12a: non-finite taps")
    rel = float(((out - ref).abs() / ref.abs().clamp(min=1e-6)).max())
    check(rel < 1e-5, f"12a: K7 vs its plain version: max relative error {rel:.3g}")
    texels = float(work["texel"])
    t_ops = FLOPS["texel"] * texels / PEAK_FLOPS * 1e3
    t_bytes = (n * TEX_QUERY_BYTES + tex_bytes(pyr, texels)) / PEAK_BYTES * 1e3
    return dict(rays=n, plain_rays=n, max_rel_err=rel, max_abs_err=float((out - ref).abs().max()),
                ms=timed_ms(launch, reps=10), wrapper_ms=timed_ms(lambda: tex_ops.tex_lookup(
                    pyr, st, d0, d1)), plain_ms=plain_ms, texels=texels,
                bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def texture_phase(record, kernels, card, dev):
    """Phase 12a-d (see the module docstring)."""
    # (a) K7 alone, the fixture's image in the three wraps
    t0 = time.perf_counter()
    image = load_image(str(ROOT / "samples" / "tex_checker.png"), True)
    zero_counts()
    taps = {}
    for wrap, name in ((mipmap.WRAP_REPEAT, "repeat"), (mipmap.WRAP_BLACK, "black"),
                       (mipmap.WRAP_CLAMP, "clamp")):
        pyr = mipmap.pyramid(mipmap.build_mipmap(image, wrap=wrap), dev)
        taps[name] = hold_tex(pyr, 1 << 20, 12 + wrap, dev)
    check(tex_ops.LAUNCHES["tex_lookup"] > 0, "12a: K7 was not launched")
    record["phase12a"] = dict(taps=taps, phase_s=time.perf_counter() - t0)
    print("phase 12a: K7 alone on 2^20 seeded lookups of tex_checker.png's pyramid: " + "; ".join(
        f"{w}: {h['ms']:.3f} ms (wrapper {h['wrapper_ms']:.3f}), {h['texels']:.0f} texels "
        f"weighed, bound {h['bound_ms']:.4f} ms by {h['bound_by']}, plain {h['plain_ms']:.1f} ms, "
        f"max rel err {h['max_rel_err']:.2e}" for w, h in taps.items())
        + f"; {time.perf_counter() - t0:.1f} s [{card}]")

    # (d) the CLI on samples/scene_textured.json: no stderr, one launch of
    # the textured instance a pass; (b) that instance held to its plain
    # version on a quarter of one pass
    t0 = time.perf_counter()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        res, colored, launches = drive(SCENE_TEXTURED, OUT / "chip_smoke_textured.png",
                                       "path_mega_cam_tex", "path")
    check(err.getvalue() == "", f"12d: stderr {err.getvalue()!r}")
    job = load_scene(str(SCENE_TEXTURED))
    held = hold(pmk, job, 8, dev)
    check_lit(held, "12b", same_rays=False)
    warm = warm_rates(job, dev, 1)
    add_entry(kernels, "path_mega_cam_tex", launches, held)
    record["phase12b"] = dict(launches=launches, passes=res["passes"], colored=colored,
                              render_mrays_per_s=res["mrays_per_s"], warm_mrays_per_s=warm,
                              phase_s=time.perf_counter() - t0, **held)
    print(describe("phase 12b/d: Path, samples/scene_textured.json 640x360x16 through the CLI's "
                   "path, empty stderr", res, launches, colored, held, warm, card))
    # K7's entry: the repeat-wrap batch; its tap runs inside every launch of
    # the textured instances
    rep = taps["repeat"]
    kernels["tex_lookup"] = dict(
        name="tex_lookup", route="cuda", **KERNELS["tex_lookup"], launches=launches,
        launched_in="path_mega_cam_tex", standalone_launches=tex_ops.LAUNCHES["tex_lookup"],
        max_abs_err=max(h["max_abs_err"] for h in taps.values()),
        max_rel_err=max(h["max_rel_err"] for h in taps.values()), ms=rep["ms"],
        plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
        library_ms=None, rays=rep["rays"], plain_rays=rep["plain_rays"])

    # (c) the textured grid over the BVH instance, 640x360x8
    grid = write_grid_scene(str(OUT / "grid_tex"), textured=True)
    job = camera_step(record, kernels, card, dev, "12c", "grid_tex", grid,
                      "path_mega_cam_bvh_tex", 16, spp=8, warm_n=1)
    check_lit(record["phase12c"], "12c", same_rays=False)


def repairs_phase(record, card, dev):
    """Phase 12e (see the module docstring)."""
    t0 = time.perf_counter()
    # the fog fixture under Path: the camera medium ignored, K1
    fog = write_variant(str(SCENE_FOG), str(OUT / "fog_path"))
    cfg = json.loads(Path(fog).read_text())
    cfg["Integrator"] = {"integrator_type": "Path", "max_depth": 5}
    Path(fog).write_text(json.dumps(cfg))
    res, colored, launches = drive(fog, OUT / "chip_smoke_fog_path.png", "path_mega_cam", "path")
    fog_held = hold(pmk, load_scene(fog), 16, dev)
    # the fixture at max_depth 20: the wavefront loop over K4
    deep_path = write_variant(str(SCENE), str(OUT / "depth20"), 160, 90)
    cfg = json.loads(Path(deep_path).read_text())
    cfg["Integrator"]["max_depth"] = 20
    Path(deep_path).write_text(json.dumps(cfg))
    res20, colored20, counts20 = drive_announced(deep_path, OUT / "chip_smoke_depth20.png", "12e")
    # past 120,000 triangles: a 112x112 grid under AO and Path, over K3
    big_ao = write_grid_scene(str(OUT / "grid112_ao"), ny=112, nz=112, base=str(SCENE_AO),
                              integrator="AO", xres=160, yres=90)
    n_probe = load_scene(big_ao).integrator.n_samples
    res_ao, _, counts_ao = drive_wavefront(big_ao, OUT / "chip_smoke_grid112_ao.png",
                                           {"bvh_shaded": 1, "bvh_any": n_probe}, 8)
    big_path = write_grid_scene(str(OUT / "grid112_path"), ny=112, nz=112, xres=160, yres=90)
    res_big, _, counts_big = drive_announced(big_path, OUT / "chip_smoke_grid112_path.png",
                                             "12e", ("bvh_shaded", "bvh_any"))
    job = load_scene(big_path)
    check(job.scene.triangles.count > 120_000, "12e: the 112x112 grid")
    # a BVH of 64 levels or more over more triangles than K1's brute force:
    # Path past K1 (announced) through K3's deep instances, each held on
    # seeded rays aimed at the tree's bulk
    deep = write_deep_bvh_scene(str(OUT / "deep_bvh"), integrator="Path", n_bulk=2000,
                                xres=160, yres=90)
    res_deep, _, counts_deep = drive_announced(deep, OUT / "chip_smoke_deep_bvh.png", "12e",
                                               ("bvh_shaded", "bvh_any"))
    deep_job = load_scene(deep)
    check(deep_job.scene.triangles.count > pmk.TRI_MAX, "12e: the deep tree's triangles")
    ctx = SceneCtx.from_scene(deep_job.scene, dev)
    check(ctx.bvh.stack == bk.DEEP_STACK, f"12e: a tree of depth {ctx.bvh.depth}")
    aimed = aimed_rays(1 << 17, (35.0, 0.0, 0.0), 1.0, dev)
    deep_shaded = hold_query("shaded", ctx, aimed, stride=8)
    deep_any = hold_query("any", ctx, aimed, stride=8)
    check(min(deep_shaded["hits"], deep_any["hits"]) >= 1000, "12e: deep holds under 1,000 hits")
    record["phase12e"] = dict(
        fog_path=dict(launches=launches, colored=colored, **fog_held),
        depth20=dict(launches=counts20, colored=colored20, mrays_per_s=res20["mrays_per_s"]),
        grid112_ao=dict(triangles=job.scene.triangles.count, launches=counts_ao,
                        mrays_per_s=res_ao["mrays_per_s"]),
        grid112_path=dict(launches=counts_big, mrays_per_s=res_big["mrays_per_s"]),
        deep=dict(depth=ctx.bvh.depth, triangles=deep_job.scene.triangles.count,
                  launches=counts_deep, mrays_per_s=res_deep["mrays_per_s"],
                  shaded=deep_shaded, any_hit=deep_any),
        phase_s=time.perf_counter() - t0)
    print(f"phase 12e: repairs: fog under Path through K1 {launches} launch(es), {colored} "
          f"coloured px, kernel vs plain diverged {fog_held['diverged']:.2e}; the fixture at "
          f"max_depth 20 through the wavefront loop, launches {launched(counts20)}; "
          f"{job.scene.triangles.count} triangles under AO {launched(counts_ao)} and Path "
          f"{launched(counts_big)}; a BVH of depth {ctx.bvh.depth} over "
          f"{deep_job.scene.triangles.count} triangles under Path {launched(counts_deep)}, on "
          f"{deep_shaded['rays']} aimed rays K3-shaded deep {deep_shaded['ms']:.3f} ms (bound "
          f"{deep_shaded['bound_ms']:.4f} by {deep_shaded['bound_by']}, plain "
          f"{deep_shaded['plain_ms']:.1f} ms on {deep_shaded['plain_rays']}, "
          f"{deep_shaded['hits']} hits), K3 any deep {deep_any['ms']:.3f} ms (bound "
          f"{deep_any['bound_ms']:.4f} by {deep_any['bound_by']}, plain {deep_any['plain_ms']:.1f} "
          f"ms, {deep_any['hits']} hits), each held to its plain version; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")


def aimed_rays(n, target, spread, dev, seed=9):
    """n seeded rays from the origin at points within `spread` of `target`
    on each axis, unbounded: (o, d, t_max) on `dev`."""
    rng = np.random.default_rng(seed)
    aim = np.asarray(target) + rng.uniform(-spread, spread, (n, 3))
    d = (aim / np.linalg.norm(aim, axis=-1, keepdims=True)).astype(np.float32)
    return (torch.zeros((n, 3), device=dev), torch.as_tensor(d, device=dev),
            torch.full((n,), torch.inf, device=dev))

# ---- phase 13: Debug / DirectLighting through the wavefront loop; #6, #8, #10 ----


def integrator_variant(base, out_dir, integrator, edit=None, **block):
    """`base` (its meshes beside it) under `integrator` with `block` in
    its Integrator block, and `edit` applied to the config, written into
    out_dir."""
    path = write_variant(str(base), str(out_dir))
    cfg = json.loads(Path(path).read_text())
    cfg["Integrator"] = {**cfg["Integrator"], "integrator_type": integrator, **block}
    if edit is not None:
        edit(cfg)
    Path(path).write_text(json.dumps(cfg))
    return path


def smooth_glass(cfg):
    """The materials fixture's rough glass made smooth: specular reflect and
    transmit lobes, so that both children of the Debug tree stay live."""
    for mat in cfg["materials"]:
        if mat["material_name"] == "mat_rough_glass":
            mat["u_roughness"] = mat["v_roughness"] = 0.0


def levels_card_vs_cpu(job, dev, stride, tag):
    """The wavefront li_levels on the card against the same on the CPU, on
    a seeded 1/`stride` of one pass's camera rays: the per-ray bar (under
    0.5% past 1e-3 relative, means within 3e-3) on at least 1,000 lit rays,
    the shares over the lit rays reported."""
    sampler = make_sampler(job)
    cam = RealisticCamera(job.camera, job.film, device=dev)
    pxy, pid, soff = sample_batch(job.film, pass_spp(sampler.spp), dev)
    n = pxy.shape[0]
    sub = torch.randperm(n, generator=torch.Generator().manual_seed(stride))[: n // stride]
    sub = sub.sort().values.to(dev)
    o, d, w = camera_rays(cam, sampler, pxy[sub], pid[sub], soff[sub])
    args = (o, d, w, sampler, pid[sub], soff[sub], job.integrator)
    l_card = li_levels(SceneCtx.from_scene(job.scene, dev), *args)
    torch.cuda.synchronize()
    cpu = torch.device("cpu")
    t_cpu = time.perf_counter()
    l_cpu = li_levels(SceneCtx.from_scene(job.scene, cpu), *(
        a.cpu() if torch.is_tensor(a) else a for a in args))
    cpu_s = time.perf_counter() - t_cpu
    l_card, l_cpu = l_card.cpu().double(), l_cpu.double()
    rel = (l_card - l_cpu).abs() / l_cpu.abs().clamp(min=1e-3)
    bar = dict(rays=int(l_cpu.shape[0]), diverged=float((rel.amax(-1) > 1e-3).double().mean()),
               q99=q99(rel), max_abs_err=float((l_card - l_cpu).abs().max()),
               mean=float(l_card.mean()), mean_ref=float(l_cpu.mean()), cpu_s=cpu_s,
               **lit_stats(rel, l_cpu))
    check(bar["lit"] >= 1000, f"{tag}: {bar['lit']} lit rays")
    check(bar["diverged"] < 5e-3, f"{tag}: {bar['diverged']:.2%} of rays diverged")
    check(abs(bar["mean"] - bar["mean_ref"]) < 1e-6 + 3e-3 * abs(bar["mean_ref"]),
          f"{tag}: means {bar['mean']:.6g} vs {bar['mean_ref']:.6g}")
    return bar


def direct_wavefront_phase(record, card, dev):
    """Phase 13a, 13b (see the module docstring)."""
    t0 = time.perf_counter()
    out = {}
    for step, tag, base, integrator, edit, block, stride in (
        ("13a", "materials_debug", SCENE_MATERIALS, "Debug", smooth_glass, {}, 64),
        ("13a", "sphere_area_direct", SCENE_SPHERE_AREA, "DirectLighting", None,
         {"light_strategy": "all"}, 64),
    ):
        t1 = time.perf_counter()
        scene = integrator_variant(base, OUT / tag, integrator, edit, **block)
        torch.cuda.reset_peak_memory_stats(dev)
        res, colored, counts = drive_announced(scene, OUT / f"chip_smoke_{tag}.png", step)
        peak = torch.cuda.max_memory_allocated(dev)
        check(res["fused_kernel"] is None, f"{tag}: {res['fused_kernel']}")
        job = load_scene(scene)
        warm = render_job(job, dev)["mrays_per_s"]
        bar = levels_card_vs_cpu(job, dev, stride, tag)
        out[tag] = dict(passes=res["passes"], launches=counts, colored=colored,
                        first_mrays_per_s=res["mrays_per_s"], warm_mrays_per_s=warm,
                        peak_bytes=peak, card_vs_cpu=bar, phase_s=time.perf_counter() - t1)
        print(f"phase {step}: {integrator}, {Path(base).name} 640x360x16 through the wavefront "
              f"loop (announced): {res['passes']} pass(es), launches {launched(counts)}, "
              f"{colored} coloured px, first {res['mrays_per_s']:.2f} / warm {warm:.2f} camera "
              f"Mrays/s, peak {peak / 2**30:.2f} GiB; li_levels on the card vs the CPU on "
              f"1/{stride} of a pass: {card_cpu_line(bar)}, mean {bar['mean']:.6g} vs "
              f"{bar['mean_ref']:.6g} (CPU {bar['cpu_s']:.1f} s); "
              f"{time.perf_counter() - t1:.1f} s [{card}]")
    # 13b: the DirectLighting white furnace on the card
    job = load_scene(integrator_variant(SCENE_FURNACE, OUT / "furnace_direct", "DirectLighting",
                                        light_strategy="one", max_depth=2))
    o, d, w, pid, sid, sampler = furnace_rays(job, 1 << 20, dev)
    ctx = SceneCtx.from_scene(job.scene, dev)
    zero_counts()
    lit = li_levels(ctx, o, d, w, sampler, pid, sid, job.integrator)
    esc = li_levels(ctx, o, -d, w, sampler, pid, sid, job.integrator)
    counts = all_counts()
    mean = lit.double().mean(0)
    esc_err = float((esc - 1.0).abs().max())
    check(bool(((mean - 0.5).abs() < 0.0115).all()), f"13b: furnace mean {mean.tolist()}")
    check(esc_err <= 1e-6, f"13b: escaped rays off 1 by {esc_err:.3g}")
    # a sphere alone: the loop's sphere tests are plain torch, no kernel runs
    check(sum(counts.values()) == 0, f"13b: launches {launched(counts)}")
    out["furnace"] = dict(rays=int(o.shape[0]), mean=mean.tolist(), escape_err=esc_err)
    out["phase_s"] = time.perf_counter() - t0
    record["phase13ab"] = out
    print(f"phase 13b: DirectLighting white furnace, {o.shape[0]} rays through the wavefront "
          f"li_levels on the card: mean {', '.join(f'{m:.6f}' for m in mean.tolist())} (0.5 "
          f"within 0.0115), escaped rays 1 within {esc_err:.2e}; phase 13a-b "
          f"{out['phase_s']:.1f} s [{card}]")


def given_rays(job, dev):
    """One pass's camera rays of `job`, traced on the host (render.camera_rays):
    (o, d, weight, pixel_id, s_idx, sampler, pixel_xy)."""
    sampler = make_sampler(job)
    cam = RealisticCamera(job.camera, job.film, device=dev)
    pxy, pid, soff = sample_batch(job.film, pass_spp(sampler.spp), dev)
    o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
    return o, d, w, pid, soff, sampler, pxy


def hold_rays_in(job, packed, rays, stride, dev, fns, name):
    """A rays-in kernel (fns: its wrapper, plain version, prepare and the
    camera instance's wrapper) against its plain version on `rays`, counts at 0
    before its main launch; also its output against the camera instance's
    on the same samples.  Returns the measured numbers."""
    fn, ref, prepare, cam_fn = fns
    o, d, w, pid, sid, sampler, pxy = rays
    args = (packed, o, d, w, pid, sid, sampler, job.integrator)
    zero_counts()
    l = fn(*args)
    torch.cuda.synchronize()
    counts = all_counts()
    check(counts[name] == 1 and sum(counts.values()) == 1, f"{name} launches {counts}")
    n = o.shape[0]
    sub = torch.randperm(n, generator=torch.Generator().manual_seed(stride))[: n // stride]
    sub = sub.sort().values.to(dev)
    work = {}
    sub_args = (packed, o[sub], d[sub], w[sub], pid[sub], sid[sub], sampler, job.integrator)
    l_ref, plain_ms = timed_once(lambda: ref(*sub_args, work=work))
    bar = per_ray_bar(l[sub], l_ref)
    max_abs_err = float((l[sub] - l_ref).abs().max())
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, device=dev))
    l_cam, _ = cam_fn(packed, cam, pxy, pid, sid, sampler, job.integrator)
    vs_cam = agreement(l, l_cam)
    del l, l_ref, l_cam
    ms = timed_ms(prepare(*args), reps=10)
    scale = n / sub.numel()
    bound_ms, bound_by = bound(work, scale, n, packed, ray_bytes=RAYS_IN_BYTES)
    return dict(rays=n, plain_rays=int(sub.numel()), bvh=packed.bvh is not None,
                launches=counts[name], max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, vs_camera=vs_cam,
                work={k: float(v) * scale for k, v in work.items()}, **bar)


def hold_sppm_rays_in(job, dev, name):
    """#10 on the first SPPM iteration's host-traced camera rays (its
    Halton slot matrix's film and lens values): against its plain version
    on every pixel (ld at the per-ray bar, VP valid and material equal on
    99.5%), and against the camera walk K8 on the same slots."""
    depth = job.integrator.max_depth
    packed, cam, pxy, u = sppm_inputs(job, dev)
    sampler = make_sampler(job)
    n = pxy.shape[0]
    pid = (pxy[:, 1] * job.film.xres + pxy[:, 0]).to(torch.int64)
    ox, oy, oz, dx, dy, dz, w = pmk._raygen(pxy[:, 0], pxy[:, 1], None, None,
                                            smk.SlotSampler(u, depth), cam)
    o, d = torch.stack([ox, oy, oz], -1), torch.stack([dx, dy, dz], -1)
    zero_counts()
    ld, vp = smk.sppm_camera_mega(packed, o, d, w, pid, 0, sampler, depth)
    torch.cuda.synchronize()
    counts = all_counts()
    check(counts[name] == 1 and sum(counts.values()) == 1, f"{name} launches {counts}")
    u_rays = smk.slot_values(sampler, pid, 0, depth)
    check(torch.equal(u_rays, u), "10: the rays-in slot matrix differs from the camera walk's")
    work = {}
    (ld_ref, vp_ref), plain_ms = timed_once(
        lambda: smk.sppm_camera_mega_reference(packed, o, d, w, u_rays, depth, work=work))
    bar = per_ray_bar(ld, ld_ref)
    valid_eq = float((vp.valid == vp_ref.valid).double().mean())
    both = vp.valid & vp_ref.valid
    mat_eq = float((vp.mat[both] == vp_ref.mat[both]).double().mean())
    check(valid_eq >= 0.995 and mat_eq >= 0.995, f"10: VP valid {valid_eq}, material {mat_eq}")
    ld_cam, vp_cam = smk.sppm_camera_mega_cam(packed, cam, pxy, u, depth)
    vs_cam = agreement(ld, ld_cam)
    ms = timed_ms(smk.prepare_camera_rays(packed, o, d, w, u_rays, depth), reps=10)
    bound_ms, bound_by = bound(work, 1.0, n, packed, SPPM_RAYS_BYTES)
    return dict(rays=n, plain_rays=n, bvh=packed.bvh is not None, launches=counts[name],
                max_abs_err=float((ld - ld_ref).abs().max()), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, valid_equal=valid_eq, mat_equal=mat_eq,
                vs_camera=vs_cam,
                vp_valid_vs_camera=float((vp.valid == vp_cam.valid).double().mean()),
                work={k: float(v) for k, v in work.items()}, **bar)


def rays_in_phase(record, kernels, card, dev):
    """Phase 13c-e (see the module docstring)."""
    t0 = time.perf_counter()
    grid_debug = write_grid_scene(str(OUT / "grid_debug13"), base=str(SCENE_DEBUG),
                                  integrator="Debug", max_depth=4)
    grid_fog = write_grid_scene(str(OUT / "grid_volpath13"), base=str(SCENE_FOG),
                                integrator="Volpath")
    direct_fns = (dmk.li_levels_mega, dmk.li_levels_mega_reference, dmk.prepare_rays_launch,
                  dmk.li_levels_mega_cam)
    vol_fns = (vmk.li_volpath_mega, vmk.li_volpath_mega_reference, vmk.prepare_rays_launch,
               vmk.li_volpath_mega_cam)
    for step, tag, scene, name, fns, pack, spp, stride in (
        ("13c", "debug", SCENE_DEBUG, "direct_mega", direct_fns, pmk.pack_scene, None, 4),
        ("13c", "grid_debug", grid_debug, "direct_mega_bvh", direct_fns, pmk.pack_scene, None,
         16),
        ("13d", "fog", SCENE_FOG, "volpath_mega", vol_fns, vmk.pack_volpath, None, 4),
        ("13d", "grid_fog_bvh", grid_fog, "volpath_mega_bvh", vol_fns, vmk.pack_volpath, 8, 8),
    ):
        t1 = time.perf_counter()
        job = load_scene(str(scene))
        if spp == 8:
            job.sampler.xsamp, job.sampler.ysamp = 2, 4
        packed = pack(job.scene, dev)
        check((packed.bvh is not None) == name.endswith("_bvh"), f"{tag}: BVH {packed.bvh}")
        held = hold_rays_in(job, packed, given_rays(job, dev), stride, dev, fns, name)
        add_entry(kernels, name, held["launches"], held)
        record[f"phase{step}_{tag}"] = dict(phase_s=time.perf_counter() - t1, **held)
        print(f"phase {step}: {name} on {tag}'s host-traced camera rays: "
              + rays_in_line(held, t1, card))
    for tag, scene, name in (
        ("sppm", SCENE_SPPM, "sppm_camera_mega"),
        ("grid_sppm_bvh", OUT / "grid_sppm" / "grid.json", "sppm_camera_mega_bvh"),
    ):
        t1 = time.perf_counter()
        held = hold_sppm_rays_in(load_scene(str(scene)), dev, name)
        add_entry(kernels, name, held["launches"], held)
        record[f"phase13e_{tag}"] = dict(phase_s=time.perf_counter() - t1, **held)
        print(f"phase 13e: {name} on {tag}'s first iteration's camera rays: VP valid equal "
              f"{held['valid_equal']:.4f} (vs K8 {held['vp_valid_vs_camera']:.4f}); "
              + rays_in_line(held, t1, card))
    record["phase13_rays_in_s"] = time.perf_counter() - t0


def rays_in_line(held, t0, card):
    return (f"{held['launches']} launch on {held['rays']} rays; kernel {held['ms']:.3f} ms, bound "
            f"{held['bound_ms']:.4f} ms by {held['bound_by']} "
            f"({held['bound_ms'] / held['ms']:.1%}), plain {held['plain_ms']:.1f} ms over "
            f"{held['plain_rays']} rays, diverged {held['diverged']:.2e}, q99 {held['q99']:.2e} "
            f"({held['lit']} lit: {held['lit_diverged']:.2e}), mean {held['mean']:.6g} vs "
            f"{held['mean_ref']:.6g}, max_abs_err {held['max_abs_err']:.3g}; against the camera "
            f"instance (diverged, relative mean difference) {held['vs_camera']}; "
            f"{time.perf_counter() - t0:.1f} s [{card}]")


# ---- phase 14: SPPM on glass and Disney (the wide instances); K3's BVH4 walk ----


def sppm_grid(scene, tag):
    """write_grid_scene of an SPPM fixture (its first material's 1,600
    cubes, 19,224 triangles) at 2 iterations."""
    grid = write_grid_scene(str(OUT / f"grid_sppm_{tag}"), base=str(scene), integrator="SPPM",
                            max_depth=3)
    cfg = json.loads(Path(grid).read_text())
    cfg["Integrator"]["n_iters"] = 2
    Path(grid).write_text(json.dumps(cfg))
    return grid


def wide_sppm_phase(record, kernels, card, dev):
    """Phase 14a-c (see the module docstring)."""
    held = {}
    for tag, scene in (("glass", SCENE_SPPM_GLASS), ("disney", SCENE_SPPM_DISNEY)):
        t0 = time.perf_counter()
        res, colored = drive_sppm(scene, OUT / f"chip_smoke_sppm_{tag}.png", False, wide=True)
        job = load_scene(str(scene))
        depth = job.integrator.max_depth
        camera, photon, vp, ev, ev_batch, radius, mats = hold_sppm_walks(job, dev)
        deposit = hold_deposit(vp, ev, radius, mats)
        deposit_batch = hold_deposit(vp, first_photons(ev_batch, depth, 16), radius, mats,
                                     timed=False)
        warm = render_job(job, dev)
        grid = sppm_grid(scene, tag)
        res_g, colored_g = drive_sppm(grid, OUT / f"chip_smoke_grid_sppm_{tag}.png", True,
                                      wide=True)
        job_g = load_scene(grid)
        camera_g, photon_g, vp_g, ev_g, _, radius_g, mats_g = hold_sppm_walks(job_g, dev)
        deposit_g = hold_deposit(vp_g, ev_g, radius_g, mats_g, timed=False)
        held[tag] = h = dict(
            iterations=res["passes"], colored=colored, render_s=res["elapsed_s"],
            camera_mrays_per_s=res["camera_mrays_per_s"],
            photon_mrays_per_s=res["photon_mrays_per_s"],
            warm_camera_photon_mrays_per_s=(warm["camera_mrays_per_s"],
                                            warm["photon_mrays_per_s"]),
            camera=camera, photon=photon, deposit=deposit, deposit_surface_batch=deposit_batch,
            grid=dict(triangles=job_g.scene.triangles.count, iterations=res_g["passes"],
                      colored=colored_g, camera_mrays_per_s=res_g["camera_mrays_per_s"],
                      photon_mrays_per_s=res_g["photon_mrays_per_s"], camera=camera_g,
                      photon=photon_g, deposit=deposit_g),
            phase_s=time.perf_counter() - t0)
        record[f"phase14_{tag}"] = h
        main, batch = photon["main"], photon["surface_batch"]
        print(
            f"phase 14{'a' if tag == 'glass' else 'b'}: SPPM, {Path(scene).name} 640x360, "
            f"{h['iterations']} iterations of {job.integrator.photons_per_iter} photons through "
            f"the wide instances, {colored} coloured px; first render {res['elapsed_s']:.3f} s "
            f"({res['camera_mrays_per_s']:.2f} camera / {res['photon_mrays_per_s']:.2f} photon "
            f"Mrays/s), warm {warm['camera_mrays_per_s']:.1f} / {warm['photon_mrays_per_s']:.1f};"
            f" camera kernel {camera['ms']:.3f} ms (plain {camera['plain_ms']:.1f}, bound "
            f"{camera['bound_ms']:.4f} by {camera['bound_by']}), diverged "
            f"{camera['diverged']:.2e}, VP valid equal {camera['valid_equal']:.4f}, {camera['vps']}"
            f" VPs, record equal on {camera['vp_record_equal']:.5f} of {camera['vps_held']}; "
            f"photon kernel {photon['ms']:.3f} ms (plain {photon['plain_ms']:.1f}, bound "
            f"{photon['bound_ms']:.4f} by {photon['bound_by']}), events equal on "
            f"{main['live_equal']:.4f} of {main['live_photons']} live photons, surface batch "
            f"{batch['live_equal']:.4f} of {batch['live_photons']}; deposit kernel "
            f"{deposit['ms']:.3f} ms (plain {deposit['plain_ms']:.1f}, bound "
            f"{deposit['bound_ms']:.4f} by {deposit['bound_by']}), M total {deposit['m_total']}, "
            f"phi rel err {deposit['phi_rel_err']:.2e} (surface batch "
            f"{deposit_batch['phi_rel_err']:.2e}); its grid of {job_g.scene.triangles.count} "
            f"triangles, {res_g['passes']} iterations over the BVH, {colored_g} coloured px: "
            f"camera kernel {camera_g['ms']:.3f} ms (plain {camera_g['plain_ms']:.1f}, bound "
            f"{camera_g['bound_ms']:.4f} by {camera_g['bound_by']}), diverged "
            f"{camera_g['diverged']:.2e}, VP valid equal {camera_g['valid_equal']:.4f}; photon "
            f"kernel {photon_g['ms']:.3f} ms (plain {photon_g['plain_ms']:.1f}, bound "
            f"{photon_g['bound_ms']:.4f} by {photon_g['bound_by']}), events equal on "
            f"{photon_g['main']['live_equal']:.4f} of {photon_g['main']['live_photons']}, surface "
            f"batch {photon_g['surface_batch']['live_equal']:.4f}; deposit M total "
            f"{deposit_g['m_total']}, phi rel err {deposit_g['phi_rel_err']:.2e}; "
            f"{h['phase_s']:.1f} s [{card}]")
    glass, disney = held["glass"], held["disney"]
    err = lambda key, *path: max(_dig(held[t], *path)[key] for t in held)
    for name, path, launches in (
        ("sppm_camera_mega_cam_wide", ("camera",), glass["iterations"]),
        ("sppm_photon_mega_wide", ("photon",), glass["iterations"]),
        ("sppm_deposit_mega_wide", ("deposit",), glass["iterations"]),
        ("sppm_camera_mega_cam_bvh_wide", ("grid", "camera"), glass["grid"]["iterations"]),
        ("sppm_photon_mega_bvh_wide", ("grid", "photon"), glass["grid"]["iterations"]),
    ):
        extra = err("max_abs_err", *path)
        if path == ("deposit",):
            extra = max(extra, err("max_abs_err", "deposit_surface_batch"),
                        err("max_abs_err", "grid", "deposit"))
        add_entry(kernels, name, launches, _dig(glass, *path), extra)
        kernels[name]["disney"] = {k: _dig(disney, *path)[k] for k in
                                   ("ms", "plain_ms", "bound_ms", "bound_by")}

    # (c) the rays-in wide instances: the glass fixture, the Disney grid
    for tag, scene, name in (
        ("glass", SCENE_SPPM_GLASS, "sppm_camera_mega_wide"),
        ("grid_disney_bvh", OUT / "grid_sppm_disney" / "grid.json", "sppm_camera_mega_bvh_wide"),
    ):
        t1 = time.perf_counter()
        h = hold_sppm_rays_in(load_scene(str(scene)), dev, name)
        add_entry(kernels, name, h["launches"], h)
        record[f"phase14c_{tag}"] = dict(phase_s=time.perf_counter() - t1, **h)
        print(f"phase 14c: {name} on {tag}'s first iteration's camera rays: VP valid equal "
              f"{h['valid_equal']:.4f} (vs K8 {h['vp_valid_vs_camera']:.4f}); "
              + rays_in_line(h, t1, card))


def _dig(d, *path):
    for k in path:
        d = d[k]
    return d


def hold_walks(query, ctx, tables4, batch, stride=16):
    """The BVH4 instance of `query` ("closest" or "any") over `ctx`'s
    triangles' BVH4 tables `tables4` held to the plain BVH4 walk
    (hold_query) and to the binary instance on the same rays:
    hit or miss equal on all but MISS_HOLD of them (exact ties can part
    the two visit orders), where both hit the triangle and t equal.  Both
    instances timed, in turns.  Returns (BVH4 numbers, binary numbers)."""
    wide, binary = copy.copy(ctx), copy.copy(ctx)
    wide.bvh, binary.bvh = tables4, tables4._replace(wide=False)
    w = hold_query(query, wide, batch, stride)
    o, d, t_max = batch
    launch_w = bk.prepare_launch(wide.bvh, o, d, t_max, query == "any")
    launch_b = bk.prepare_launch(binary.bvh, o, d, t_max, query == "any")
    t_w, i_w = (x.clone() for x in launch_w())
    t_b, i_b = (x.clone() for x in launch_b())
    hit_w, hit_b = i_w >= 0, i_b >= 0
    apart = float((hit_w != hit_b).double().mean())
    check(apart <= MISS_HOLD, f"BVH4 {query}: hit or miss differs from binary on {apart:.2e}")
    both = hit_w & hit_b
    if query == "closest":
        same = float(((i_w == i_b) & (t_w == t_b))[both].double().mean()) if both.any() else 1.0
        check(same >= 1.0 - MISS_HOLD, f"BVH4 closest: {same:.6f} of the hits equal binary's")
    ms_b = [timed_ms(launch_b, reps=10)]
    ms_w = [w["ms"], timed_ms(launch_w, reps=10)]
    ms_b.append(timed_ms(launch_b, reps=10))
    w.update(vs_binary_apart=apart, ms_turns=ms_w)
    b = dict(ms=statistics.median(ms_b), ms_turns=ms_b, hits=int(hit_b.sum()))
    return w, b


def bvh4_phase(record, kernels, card, dev):
    """Phase 14d-f (see the module docstring)."""
    t0 = time.perf_counter()
    # (d) AO on the 19,224-triangle grid, one pass over the BVH4 walk,
    # counts at 0 just before; both walks on its first probe batch
    job = load_scene(str(OUT / "grid_ao" / "grid.json"))
    n_probe = job.integrator.n_samples
    zero_counts()
    ctx, batches = first_pass_batches(job, dev, 8, wide=True)
    counts = {k: v for k, v in all_counts().items() if v}
    check(counts == {"bvh_shaded": 1, "bvh4_any": n_probe}, f"14d: launches {counts}")
    ao_any = hold_walks("any", ctx, ctx.bvh, batches["occluded"])
    # (e) the 76,824-triangle grid's camera (closest) and bounce-0 shadow rays
    grid80 = load_scene(str(OUT / "grid80_path" / "grid.json"))
    ctx80, batches80 = first_pass_batches(grid80, dev, 8)
    t80 = bk.pack_bvh(grid80.scene.triangles, dev, wide=True)
    p80_closest = hold_walks("closest", ctx80, t80, batches80["shaded"])
    p80_any = hold_walks("any", ctx80, t80, batches80["occluded"])
    # (f) the 101-level tree (50 wide levels: the deep instances), 2^17 aimed rays
    deep = load_scene(str(OUT / "deep_bvh" / "deep.json"))
    ctx_d = SceneCtx.from_scene(deep.scene, dev)
    t_d = bk.pack_bvh(deep.scene.triangles, dev, wide=True)
    check(t_d.stack4 == bk.DEEP_STACK, f"14f: a wide tree of depth {t_d.depth4}")
    aimed = aimed_rays(1 << 17, (35.0, 0.0, 0.0), 1.0, dev)
    deep_closest = hold_walks("closest", ctx_d, t_d, aimed, stride=8)
    deep_any = hold_walks("any", ctx_d, t_d, aimed, stride=8)
    held = dict(ao_grid_any=ao_any, grid80_closest=p80_closest, grid80_any=p80_any,
                deep_closest=deep_closest, deep_any=deep_any)
    record["phase14_bvh4"] = dict(
        launches=counts, nodes=ctx.bvh.nodes_f.shape[0], wide_nodes=ctx.bvh.nodes4_f.shape[0],
        depth=ctx.bvh.depth, depth4=ctx.bvh.depth4, deep_depth=t_d.depth,
        deep_depth4=t_d.depth4,
        **{k: dict(bvh4=w, binary=b) for k, (w, b) in held.items()},
        phase_s=time.perf_counter() - t0)
    wavefront_entry(kernels, "bvh4", counts["bvh4_any"] + counts.get("bvh4_closest", 0), ao_any[0])
    kernels["bvh4"]["max_abs_err"] = max(w["max_abs_err"] for w, _ in held.values())
    kernels["bvh4"].update(
        binary_ms=ao_any[1]["ms"],
        **{f"{k}_ms": w["ms"] for k, (w, _) in held.items() if k != "ao_grid_any"},
        **{f"{k}_binary_ms": b["ms"] for k, (_, b) in held.items() if k != "ao_grid_any"})
    print(f"phase 14d-f: K3's BVH4 walk ({ctx.bvh.nodes4_f.shape[0]} wide nodes of depth "
          f"{ctx.bvh.depth4} for {ctx.bvh.nodes_f.shape[0]} binary of depth {ctx.bvh.depth} on "
          f"the AO grid), AO grid pass launches {counts}; "
          + "; ".join(
              f"{tag} BVH4 {w['ms']:.3f} ms (turns {', '.join(f'{m:.3f}' for m in w['ms_turns'])};"
              f" bound {w['bound_ms']:.4f} by {w['bound_by']}, plain {w['plain_ms']:.1f} over "
              f"{w['plain_rays']} rays, hits {w['hits']}, vs plain hit/miss differ "
              f"{w['miss_mismatch']:.2e}, vs binary {w['vs_binary_apart']:.2e}) against binary "
              f"{b['ms']:.3f} ms (turns {', '.join(f'{m:.3f}' for m in b['ms_turns'])})"
              for tag, (w, b) in held.items())
          + f"; {time.perf_counter() - t0:.1f} s [{card}]")

if __name__ == "__main__":
    sys.exit(main())
