"""The redesigned walks against another revision's, on one NVIDIA GPU: the
path kernel's brute-force instances (K1) and BVH instances (K1 BVH), the
Volpath kernel's brute-force (K6) and BVH instances (K6 BVH), the direct
kernel's brute-force (K2) and BVH instances (K2 BVH), the wavefront
loop's BVH closest and any hit (K3) and shaded closest hit (K3-shaded),
the EWA texture tap (K7) and the SPPM camera walk (K8), photon walk (K9)
and deposit (K10).

    python -m rs_ray_toy_tpu_torch.walk_ab --parent DIR [--reps 10] [--out DIR] [--only k1bvh]
    python -m rs_ray_toy_tpu_torch.walk_ab --variant NAME [--only k3] ...
    python -m rs_ray_toy_tpu_torch.walk_ab --variant CONSTANT=VALUE [--only k2bvh,k6bvh] ...
    python -m rs_ray_toy_tpu_torch.walk_ab --parent DIR --only k2,k3s
    python -m rs_ray_toy_tpu_torch.walk_ab --parent DIR --only k9,k10
    python -m rs_ray_toy_tpu_torch.walk_ab --parent DIR --only host
    python -m rs_ray_toy_tpu_torch.walk_ab --counts [--device cpu] [--scale 4]

DIR is a checkout of the other revision (e.g. `git archive` of the parent
commit unpacked under build/).  `--variant NAME` puts in its place a copy
of this tree (under --out) with one of VARIANTS' source edits, the design
choices of the redesigned walks undone one at a time: `no_prefetch`
(Bvh64's default, the node64 walk of K3 and of K1's and K8's BVH
instances, loads each leaf row when it tests it, not the next row's while
it tests one),
`late_ray_loads` (bvh64_kernel loads a ray's origin and direction after it
tests t_max), `swap_k6_cap` (K6's chunked walk takes
the register-capped instance for grid media and the uncapped one for
homogeneous media, the other way round), `uncap_bvh_regs` (K1's BVH
instances without the launch bound that caps their registers for 9
resident blocks an SM), `inline_bss_walks` (K1's subsurface BVH
instances inline their walks at every call site instead of calling one
copy of each), `no_reject` (Bvh64 tests each leaf row with mt_hit alone,
without the division-free reject first), `call_walks` (K2's and K6's
BVH instances call one out-of-line copy of each walk), `k2_capped`
(K2's brute force takes its register-capped instance on every table),
`shaded_no_prefetch` (K3-shaded's flat instance, too, loads each leaf row
when it tests it), `shaded_min_blocks` (K3-shaded under a launch bound
for 5 resident blocks of 256 an SM), `tex_block256` (K7 alone in blocks of
256, not the occupancy API's block), `tex_rgba` (K7 reads each texel as one
16-byte load from an RGBA copy of the pyramid, alone and inside K1),
`tex_inline` (the tap inlined, not called, alone and inside K1) and
`k8_capped` (K8 under the direct kernel's launch bound, 9 blocks of 128 an
SM, every launch in blocks of 128) and `k10_sync_copies` (K10's tiles
filled by loads that each lane waits for, not by asynchronous copies);
`CONSTANT=VALUE` a
copy whose one `constexpr` of that name, in the one kernel source that has
it, takes VALUE: K2's instances, brute force and BVH, take
`DIRECT_MIN_BLOCKS` (the launch bound's resident blocks), K6's BVH
instances `VOL_BVH_MIN_BLOCKS`, both `_LEAF_PREFETCH` (e.g. `--variant
VOL_BVH_MIN_BLOCKS=1`).  `--only` keeps
the cases of some kernels: k1, k6, k3, k1bvh, k2bvh, k6bvh, k2, k3s, k7,
k8, k9, k10, and `host`, the host's share of the renders (HOST_CASES: the
warm renders of the Path, Debug, fog and SPPM fixtures through their
kernels and of samples/scene_materials.json through the wavefront Path
loop, and the path kernel's wrapper call on the fixture's pass, library
load included).  Each tree builds the kernels
of those cases; then a
worker process runs under each tree in turns (the other revision, this
tree, this tree, the other revision), so that both meet the card in the
same state.  A worker times each case's launch with CUDA events (median of
--reps after one warm-up) and keeps its output.  K1: one sample pass of
each case through `li_path_mega_cam`, and `li_path_mega` on the pass's
camera rays; the cases cover every brute-force instance the fixtures reach
(base, spheres, environment, Halton, smooth, Halton + smooth, Disney,
subsurface, subsurface + Halton, textured) and, as a yardstick, the smooth
fixture through the BVH instances (`pack_scene(..., bvh=True)`).  K1 BVH
(#2, #4): one sample pass of each of K1BVH_CASES through the BVH instances
at chip_smoke.py's sizes (the 19,224-triangle grid of cubes, with the
sphere-area fixture's spheres and light, in the subsurface, Disney and
textured materials, under a 6-sample HaltonSampler, write_smooth_grid_scene's
20 spheres and the smooth fixture packed with bvh=True), 8 stratified
samples a pixel for the grids at 640x360 (1.84M rays), and the rays-in
twin on the pass's camera rays (not the textured grid's).  K2 BVH (#5b,
#6) and K6 BVH (#7b, #8): one sample pass of each of K2BVH_CASES and
K6BVH_CASES at chip_smoke.py's sizes (the 19,224-triangle grid of cubes
under Debug at 640x360x16, 3.69M rays, as phases 4 and 13c write it; the
same grid in the fixture's fog, and in write_grid_fog_scene's 16^3 grid
medium, at 640x360x8, 1.84M rays, as phases 5d and 13d write the first),
and the rays-in twin on the pass's camera rays.  K2 (#5a, #6 brute force,
the chunked walk): one pass of samples/scene_debug.json (Debug) at
640x360x16 (3.69M rays) and its rays-in twin, the one-light
DirectLighting variant at 160x90x16, as chip_smoke.py's phase 3, and a
grid of 1,896 triangles under Debug (brute force near TRI_MAX, where the
table's shared memory leaves few blocks resident) at 640x360x16, with
its rays-in twin.  K6: one
pass of the fog fixture, fog_area and the 16^3 grid fog through
`li_volpath_mega_cam` at chip_smoke.py's sizes, and the fog's camera rays
through `li_volpath_mega`.  K3: the loop's closest-hit or any-hit walk
(`bvh_kernel.prepare_launch` on the loop's tables) on the ao-grid's first
probe batch, path-grid80's camera and bounce-0 shadow rays, the
subsurface probe chain's first closest-hit batch on grid-sss-mixed and
2^17 rays aimed at the 101-level tree.  K3-shaded (#14): the shaded
closest hit (`bvh_kernel.prepare_shaded_launch`) on the first shaded
batch of the ao-grid (its camera rays), of path-grid80 and of
write_smooth_grid_scene's 80 spheres (76,836 triangles, the smooth
instance: each a Path render's first bounce, 640x360x8) and on the 101-level
tree's aimed rays; its outputs t, triangle, material, area light and the
attribute rows compared.  K7: the tap alone (`tex_ops.prepare_launch`) on
chip_smoke.py 12a's 2^20 seeded lookups (tex_queries) in each wrap and on
2^20 of k7_footprints' adversarial ones (repeat), its out compared; and a
pass of the textured fixture (#1 T, 640x360x16) and of the textured grid
over the BVH (#2 T, 640x360x8) through K1 (`li_path_mega_cam`).  K8: the
camera walk (`smk.prepare_camera`, #9) on the first SPPM iteration of
samples/scene_sppm.json, its glass and Disney fixtures (the wide
instances), their 19,224-triangle grids (BVH) and a grid of 1,896
triangles under brute force (sppm_job), and its rays-in twin (#10) on the
walk's own lens rays; ld and every VP output compared.  K9 and K10, on
the SPPM scenes of K8's cases: the photon walk (`smk.prepare_photon`, #11)
on the first iteration's emitted photons, and the deposit
(`smk.prepare_deposit`, #12) on the camera walk's VPs and those photons'
events (deposit_inputs, the fixed radius), each timed as the card runs it
(bare_ms: back-to-back calls of the ctypes entry point alone, queued
behind a sleep of the device, over their count; the wrapper's outputs and
casts stay out of the window), beside the kernel's own time by name from
torch.profiler (profiled_ms) and the old window around the whole launch
closure ("closure_ms"); their events (p, wi, beta, live) and phi and M
compared, and also on surface_photons' seeded batch (the deposit on its
first sixteenth, first_photons), as chip_smoke.py holds them.  The
groups also render warm through render_job (RENDERS: the textured
fixture under k7, the SPPM fixture under k8 and k9; one render, then 5
timed) and compare the images.  The last line of the output is a
JSON object: per case the four times in turn order, the other revision's
output against this tree's (rays whose radiance channels, or whose t and
triangle, are not all bit-equal; NaN equal to NaN), the K3 kernel each
tree launched, and this tree's and the other's occupancy (block size,
blocks per SM, registers, shared memory) where they report one.  Both
workers' records go to --out.

`--counts` runs no kernel: the plain versions, on --device, count what
the redesigned walks do (only the groups of --only).  K6 (fog, fog_area, grid_fog, their films
divided by --scale on each side): per ray the chunked walk's MT and chunk
box tests and the MT tests of the walk over every row, and per warp of 32
consecutive rays (the kernel's lanes) the chunks whose rows it runs and
those rows against the rows the walk over every row runs it (chunk_walk's
"chunk_warp", "mt_warp", "mt_brute_warp").  K3, on a CUDA device only
(the first passes at full size): the node64 walk's steps a ray (interior
rows fetched and leaves tested; accel/traverse.step_stats: mean, 99th
percentile, the warps' longest walks) on the ao-grid's first probe batch
(any hit, and closest hit on the same rays) and on the probe chain's first
batch (closest hit).  K1 BVH, K2 BVH and K6 BVH, on a CUDA device only
(K6 BVH's films divided by --scale on each side): over the first
quarter of each case's pass (consecutive rays, so that 32 of them are
a warp's lanes), the node64 walk's steps per walk and per warp its longest
walk (PlainGeometry's step tallies), apart for the closest hits, the any
hits (shadow rays) and the subsurface probe chain's closest hits, and per
ray its MT and slab tests and interior rows.  K2 (films divided by
--scale): the chunked walk's counts as K6's, over the Debug fixture's
pass and the one-light variant's (every walk of the tree: closest hits
and shadow rays).  K3-shaded, on a CUDA device only: the node64 walk's
steps a ray (mean, 99th percentile, the warps' longest) and MT and slab
tests and interior rows a ray on each of its batches.  K7
(k7_counts; K7 alone on (1 << 20) / --scale^2 lookups, the textured
passes' films divided by --scale): the texels a lookup scans and weighs,
the warps' longest scan, and for #1 T / #2 T the camera rays whose first
hit taps EWA and the differential lens traces of the pass.  K8 (films
divided by --scale): the chunked walk's counts as K2's, or the node64
walk's as K1 BVH's, over the camera walk's plain version on every pixel.
K9: the same over the photon walk's plain version on the first
iteration's emitted photons and on the surface batch.  K10 (films divided
by --scale): over the deposit's warp walk (smk.deposit_warp_walk) on that
iteration's VPs and the emitted photons' events, the walking VPs, the
pairs they walk, the event rows a walking warp reads and the lobe passes
it runs (its busiest lane's shaded pairs a tile) beside one pass for each
row where some lane shades.
The last line is a JSON object of those numbers.
"""

import argparse
import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SAMPLES = ROOT / "samples"
HALTON6 = {"sampler_type": "HaltonSampler", "nsamp": 6}
# case: (scene, Halton 6 spp, BVH, rays-in twin too)
CASES = {
    "fixture": ("scene.json", False, False, True),
    "sphere_area": ("scene_sphere_area.json", False, False, False),
    "env": ("scene_env.json", False, False, False),
    "halton6": ("scene.json", True, False, True),
    "smooth": ("scene_smooth.json", False, False, True),
    "smooth_halton6": ("scene_smooth.json", True, False, True),
    "disney": ("scene_disney.json", False, False, True),
    "sss": ("scene_sss.json", False, False, True),
    "sss_halton6": ("scene_sss.json", True, False, True),
    "textured": ("scene_textured.json", False, False, False),
    "smooth_bvh": ("scene_smooth.json", False, True, True),
}
# K1's BVH instances: case -> (scene, Halton 6 spp, rays-in twin); the
# scenes as k1bvh_job writes them
K1BVH_CASES = {
    "grid": ("grid", False, True),
    "grid_spheres": ("grid_spheres", False, True),
    "grid_sss": ("grid_sss", False, True),
    "smooth_grid20": ("smooth_grid20", False, True),
    "grid_halton6": ("grid", True, True),
    "smooth_grid20_halton6": ("smooth_grid20", True, True),
    "disney_grid": ("grid_disney", False, True),
    "textured_grid": ("grid_tex", False, False),
    "smooth_fixture": ("smooth", False, True),
}
# K2's and K6's BVH instances: case -> scene as bvh_job writes it (each
# with its rays-in twin)
K2BVH_CASES = {"debug_grid": "grid_debug"}
K6BVH_CASES = {"fog_grid": "grid_fog_bvh", "grid_medium_grid": "grid_medium_bvh"}
VOL_CASES = ("fog", "fog_area", "grid_fog")  # K6, the fog's rays-in twin too
# K2's brute-force (chunked) instances: case -> (scene, DirectLighting one
# light at 160x90, rays-in twin too); "grid_brute" is k2_job's grid
K2_CASES = {"debug_fixture": ("scene_debug.json", False, True),
            "direct_one_160x90": ("scene_debug.json", True, False),
            "debug_grid_brute": ("grid_brute", False, True)}
# K3-shaded: case -> first-pass batch
SHADED_CASES = {"ao_grid_shaded": "ao_grid_camera", "grid80_shaded": "grid80_camera",
                "smooth80_shaded": "smooth80_camera", "deep_shaded": "deep"}
# K3: case -> (first-pass batch, any hit)
BVH_CASES = {
    "ao_grid_any": ("ao_grid", True),
    "ao_grid_closest": ("ao_grid", False),
    "grid80_closest": ("grid80_camera", False),
    "grid80_any": ("grid80_shadow", True),
    "probe_chain_closest": ("probe_chain", False),
    "deep_closest": ("deep", False),
    "deep_any": ("deep", True),
}
# K7: case -> the wrap of K7 alone on chip_smoke.py 12a's lookups (or
# "adversarial": k7_footprints' under the repeat wrap), or the textured
# scene of a pass through K1 ("fixture": #1 T, "grid": #2 T); "k7_render"
# the warm render of samples/scene_textured.json (RENDERS)
K7_CASES = {"k7_repeat": 0, "k7_black": 1, "k7_clamp": 2, "k7_adversarial": "adversarial",
            "k7_textured": "fixture", "k7_textured_grid": "grid", "k7_render": "render"}
# K8 (#9, with its rays-in twin #10): case -> the SPPM scene as sppm_job
# writes it; "sppm_render" the warm render of samples/scene_sppm.json
K8_CASES = {"sppm_fixture": "fixture", "sppm_glass": "glass", "sppm_disney": "disney",
            "sppm_grid": "grid", "sppm_glass_grid": "glass_grid",
            "sppm_disney_grid": "disney_grid", "sppm_grid_brute": "grid_brute",
            "sppm_render": "render"}
# K9 (#11) and K10 (#12): case -> the SPPM scene as sppm_job writes it;
# "k9_render" the warm render of samples/scene_sppm.json (both kernels)
K9_CASES = {f"k9_{c[5:]}": s for c, s in K8_CASES.items() if c != "sppm_render"}
K9_CASES["k9_render"] = "render"
K10_CASES = {f"k10_{c[5:]}": s for c, s in K8_CASES.items() if c != "sppm_render"}
# the render cases: case -> the scene rendered warm through render_job
# the host's share: case -> the scene rendered warm, or "wrapper": the path
# kernel's wrapper call on samples/scene.json's pass
HOST_CASES = {"host_fixture": "scene.json", "host_debug": "scene_debug.json",
              "host_fog": "scene_fog.json", "host_sppm": "scene_sppm.json",
              "host_materials": "scene_materials.json", "host_wrapper": "wrapper"}
RENDERS = {"k7_render": "scene_textured.json", "sppm_render": "scene_sppm.json",
           "k9_render": "scene_sppm.json",
           **{c: s for c, s in HOST_CASES.items() if s != "wrapper"}}
# --only: CASES, VOL_CASES, BVH_CASES, K1BVH_CASES, K2BVH_CASES, K6BVH_CASES,
# K2_CASES, SHADED_CASES, K7_CASES, K8_CASES, K9_CASES, K10_CASES, HOST_CASES
GROUPS = ("k1", "k6", "k3", "k1bvh", "k2bvh", "k6bvh", "k2", "k3s", "k7", "k8", "k9", "k10",
          "host")
# the kernel sources each group's cases launch
SOURCES = {"k1": ("path_megakernel",), "k6": ("volpath_megakernel",), "k3": ("bvh_kernel",),
           "k1bvh": ("path_megakernel",), "k2bvh": ("direct_megakernel",),
           "k6bvh": ("volpath_megakernel",), "k2": ("direct_megakernel",),
           "k3s": ("bvh_kernel",), "k7": ("texture_kernel", "path_megakernel"),
           "k8": ("sppm_megakernel",), "k9": ("sppm_megakernel",),
           "k10": ("sppm_megakernel",),
           "host": ("path_megakernel", "direct_megakernel", "volpath_megakernel",
                    "sppm_megakernel", "intersect_kernel")}
_RAY_LOADS = """  // the ray's loads issued together, ahead of the test of t_max
  const float tm = __ldg(t_max + i);
  const float ox = __ldg(o + 3 * i), oy = __ldg(o + 3 * i + 1), oz = __ldg(o + 3 * i + 2);
  const float dx = __ldg(d + 3 * i), dy = __ldg(d + 3 * i + 1), dz = __ldg(d + 3 * i + 2);
  float t_bound = tm;
  int best = -1;
  if (tm > 0.0f) {
"""
_K6_CAP = """    const auto kernel = vol->grid ? volpath_mega_kernel<false, kRaysIn, true>
                                  : volpath_mega_kernel<false, kRaysIn, true, true>;"""
_TEX_LAUNCH = """    def launch():
        err = lib.tex_lookup_launch(pyr.data.data_ptr(),"""
_RGBA = "    rgba = torch.nn.functional.pad(pyr.data.view(-1, 3), (0, 1)).reshape(-1)\n"
# --variant: (file under the package, text found there as many times as the
# edit is listed, its replacement)
VARIANTS = {
    "no_prefetch": [("csrc/common.cuh", "bool kPrefetch = true", "bool kPrefetch = false")],
    "late_ray_loads": [
        ("csrc/bvh_kernel.cu", _RAY_LOADS, """  const float tm = __ldg(t_max + i);
  float t_bound = tm;
  int best = -1;
  if (tm > 0.0f) {
    const float ox = __ldg(o + 3 * i), oy = __ldg(o + 3 * i + 1), oz = __ldg(o + 3 * i + 2);
    const float dx = __ldg(d + 3 * i), dy = __ldg(d + 3 * i + 1), dz = __ldg(d + 3 * i + 2);
"""),
    ],
    "inline_bss_walks": [
        ("csrc/path_megakernel.cu", "Bvh64Geometry<STACK_DEPTH, kBss>",
         "Bvh64Geometry<STACK_DEPTH, false>"),
    ],
    "no_reject": [  # in both leaf loops of Bvh64
        ("csrc/common.cuh", "if (!mt_reject(g, ox, oy, oz, dx, dy, dz, t_bound) &&\n"
                            "                mt_hit(", "if (mt_hit("),
    ] * 2,
    "call_walks": [
        (f"csrc/{src}.cu", "Bvh64Geometry<STACK_DEPTH, false,", "Bvh64Geometry<STACK_DEPTH, true,")
        for src in ("direct_megakernel", "volpath_megakernel")
    ],
    "uncap_bvh_regs": [
        ("csrc/path_megakernel.cu", "__launch_bounds__(BLOCK, BVH_MIN_BLOCKS)",
         "__launch_bounds__(BLOCK, 1)"),
    ],
    "shaded_no_prefetch": [
        ("csrc/bvh_kernel.cu", "Bvh64<kStack, kShadedPrefetch<kSmooth, kStack>>",
         "Bvh64<kStack, false>"),
    ],
    "k2_capped": [
        ("csrc/direct_megakernel.cu",
         "const int k = occ[1][0] * occ[1][1] > occ[0][0] * occ[0][1] ? 1 : 0;",
         "const int k = 0;"),
    ],
    "shaded_min_blocks": [
        ("csrc/bvh_kernel.cu", "__launch_bounds__(BVH64_BLOCK_MAX)\nbvh_shaded_kernel(",
         "__launch_bounds__(BVH64_BLOCK_MAX, 5)\nbvh_shaded_kernel("),
    ],
    "swap_k6_cap": [
        ("csrc/volpath_megakernel.cu", _K6_CAP,
         """    const auto kernel = vol->grid ? volpath_mega_kernel<false, kRaysIn, true, true>
                                  : volpath_mega_kernel<false, kRaysIn, true>;"""),
    ],
    "tex_block256": [("csrc/texture_kernel.cu", "  block = g_tex_occupancy[0];\n",
                      "  block = TEX_BLOCK;\n")],
    "tex_inline": [("csrc/texture.cuh", "__device__ __noinline__ void tex_ewa_level(",
                    "__device__ __forceinline__ void tex_ewa_level(")],
    "tex_rgba": [
        ("csrc/texture.cuh", """  const float* p = data + tm.off[l] + (size_t)(ti * w + si) * 3;
  v[0] = __ldg(p);
  v[1] = __ldg(p + 1);
  v[2] = __ldg(p + 2);""", """  const float4 q = __ldg(reinterpret_cast<const float4*>(data) + tm.off[l] / 3 + ti * w + si);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;"""),
        ("ops/texture.py", _TEX_LAUNCH, _TEX_LAUNCH.replace("pyr.data.data_ptr()", "rgba.data_ptr()")
         .replace("    def launch():", _RGBA + "\n    def launch():")),
        ("ops/path_megakernel.py", "None if tex is None else tex.pyr.data,",
         "None if tex is None else torch.nn.functional.pad(tex.pyr.data.view(-1, 3), "
         "(0, 1)).reshape(-1),"),
    ],
    "k10_sync_copies": [("csrc/sppm_megakernel.cu",
                         "__pipeline_memcpy_async(tile + w, src + w, sizeof(float2));",
                         "tile[w] = __ldg(src + w);")],
    "k8_capped": [("csrc/sppm_megakernel.cu", "__launch_bounds__(SPPM_BLOCK_MAX)",
                   "__launch_bounds__(BLOCK, 9)")]
    + [("csrc/sppm_megakernel.cu", "choose_block(kernel, SPPM_BLOCK_MAX,",
        "choose_block(kernel, BLOCK,")],
}


def aimed_rays(n, target, spread, dev, seed=9):
    """n seeded rays from the origin at points within `spread` of `target`
    on each axis, unbounded: (o, d, t_max) on `dev`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    aim = np.asarray(target) + rng.uniform(-spread, spread, (n, 3))
    d = (aim / np.linalg.norm(aim, axis=-1, keepdims=True)).astype(np.float32)
    return (torch.zeros((n, 3), device=dev), torch.as_tensor(d, device=dev),
            torch.full((n,), torch.inf, device=dev))


def recording_ctx(ctx):
    """A copy of the wavefront loop's SceneCtx `ctx` that keeps the inputs
    of the first call of each of the loop's queries, as (o, d, t_max) in
    its `batches` under "shaded" and "occluded" and, over a BVH, "closest"
    (the subsurface probe chain's re-casts)."""
    base = type(ctx)

    class RecordingCtx(base):
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

    rec = copy.copy(ctx)
    rec.__class__ = RecordingCtx
    rec.batches = {}
    return rec


def first_pass_batches(job, dev, spp, wide=False):
    """The first pass of the wavefront render of `job` at `spp` samples per
    pixel, run again with a recording context (recording_ctx): the
    context and its first batches.  With `wide` its closest-hit and any-hit
    queries walk the BVH4 (pack_bvh(..., wide=True)), not the loop's
    binary tree."""
    import torch

    from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
    from rs_ray_toy_tpu_torch.integrators.ao import li_ao
    from rs_ray_toy_tpu_torch.integrators.common import SceneCtx
    from rs_ray_toy_tpu_torch.integrators.path import li_path
    from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
    from rs_ray_toy_tpu_torch.render import camera_rays, make_sampler, sample_batch

    sampler = make_sampler(job)
    sampler.xs, sampler.ys = (2, 4) if spp == 8 else (4, 4)
    sampler.spp = spp
    cam = RealisticCamera(job.camera, job.film, device=dev)
    ctx = recording_ctx(SceneCtx.from_scene(job.scene, dev))
    if wide:
        ctx.bvh = bk.pack_bvh(job.scene.triangles, dev, wide=True)
    pxy, pid, soff = sample_batch(job.film, spp, dev)
    o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
    li = li_ao if job.integrator.kind == "ao" else li_path
    li(ctx, o, d, w, sampler, pid, soff, job.integrator)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return ctx, ctx.batches


def vol_scene(case, out):
    """The K6 case's scene as chip_smoke.py's phase 5 writes it, under out."""
    from rs_ray_toy_tpu_torch.scene.gen import THIN_FOG, write_fog_scene, write_grid_fog_scene

    if case == "fog":
        return str(SAMPLES / "scene_fog.json")
    if case == "fog_area":
        return write_fog_scene(str(out / "fog_area"), area_light=True,
                               base=str(SAMPLES / "scene_fog.json"), medium=THIN_FOG, xres=160,
                               yres=90)
    return write_grid_fog_scene(str(out / "grid_fog"), n=16, sigma_scale=0.5)


def k1bvh_job(scene, halton, out):
    """The job of a K1BVH_CASES scene, written under out as chip_smoke.py's
    phases 4, 8c, 9f, 9i, 10b, 11b and 12c write it: 640x360, a grid at 8
    stratified samples a pixel (1.84M rays), or with `halton` one pass of
    6 Halton samples (1.38M rays)."""
    from rs_ray_toy_tpu_torch.scene.gen import (write_grid_scene, write_smooth_grid_scene,
                                                write_variant)
    from rs_ray_toy_tpu_torch.scene.loader import load_scene

    bases = {"grid": "scene.json", "grid_spheres": "scene_sphere_area.json",
             "grid_sss": "scene_sss.json", "grid_disney": "scene_disney.json"}
    where = str(out / scene)
    if scene == "smooth":
        path = str(SAMPLES / "scene_smooth.json")
    elif scene == "smooth_grid20":
        path = write_smooth_grid_scene(where, n=20)
    elif scene == "grid_tex":
        path = write_grid_scene(where, textured=True)
    else:
        path = write_grid_scene(where, base=str(SAMPLES / bases[scene]))
    if halton:
        path = write_variant(path, where + "_halton6", 640, 360, HALTON6)
    job = load_scene(path)
    if not halton and scene != "smooth":
        job.sampler.xsamp, job.sampler.ysamp = 2, 4
    return job


def bvh_job(scene, out):
    """The job of a K2BVH_CASES or K6BVH_CASES scene, written under out as
    chip_smoke.py's phases 4, 5d, 13c and 13d write it: write_grid_scene's
    grid of cubes (19,224 triangles, a BVH) at 640x360 under Debug
    (max_depth 4, 16 stratified samples a pixel), or under Volpath in the
    fixture's fog or in write_grid_fog_scene's 16^3 grid medium (sigma
    scale 0.5), 8 samples a pixel."""
    from rs_ray_toy_tpu_torch.scene.gen import write_grid_fog_scene, write_grid_scene
    from rs_ray_toy_tpu_torch.scene.loader import load_scene

    where = str(out / scene)
    if scene == "grid_debug":
        return load_scene(write_grid_scene(where, base=str(SAMPLES / "scene_debug.json"),
                                           integrator="Debug", max_depth=4))
    base = (str(SAMPLES / "scene_fog.json") if scene == "grid_fog_bvh"
            else write_grid_fog_scene(where + "_medium", n=16, sigma_scale=0.5))
    job = load_scene(write_grid_scene(where, base=base, integrator="Volpath"))
    job.sampler.xsamp, job.sampler.ysamp = 2, 4
    return job


def bvh_batches(out, dev, need=None):
    """{batch: (SceneCtx, (o, d, t_max))} of the K3 and K3-shaded cases (or
    of the batches `need`), at chip_smoke.py's sizes (phases 7b, 7c, 9g, 11e
    and 12e)."""
    from rs_ray_toy_tpu_torch.integrators.common import SceneCtx
    from rs_ray_toy_tpu_torch.scene.gen import (write_deep_bvh_scene, write_grid_scene,
                                                write_smooth_grid_scene)
    from rs_ray_toy_tpu_torch.scene.loader import load_scene

    need = set(need or [b for b, _ in BVH_CASES.values()] + list(SHADED_CASES.values()))
    batches = {}
    if need & {"ao_grid", "ao_grid_camera"}:
        grid_ao = write_grid_scene(str(out / "grid_ao"), base=str(SAMPLES / "scene_ao.json"),
                                   integrator="AO")
        ctx, b = first_pass_batches(load_scene(grid_ao), dev, 8)
        batches.update(ao_grid=(ctx, b["occluded"]), ao_grid_camera=(ctx, b["shaded"]))
    if need & {"grid80_camera", "grid80_shadow"}:
        grid80 = write_grid_scene(str(out / "grid80_path"), ny=80, nz=80, integrator="Path")
        ctx, b = first_pass_batches(load_scene(grid80), dev, 8)
        batches.update(grid80_camera=(ctx, b["shaded"]), grid80_shadow=(ctx, b["occluded"]))
    if "smooth80_camera" in need:
        smooth80 = write_smooth_grid_scene(str(out / "smooth_grid80"), n=80)
        ctx, b = first_pass_batches(load_scene(smooth80), dev, 8)
        batches["smooth80_camera"] = (ctx, b["shaded"])
    if "probe_chain" in need:
        sss = write_grid_scene(str(out / "grid_sss_mixed"),
                               base=str(SAMPLES / "scene_sss_mixed.json"))
        ctx, b = first_pass_batches(load_scene(sss), dev, 16)
        batches["probe_chain"] = (ctx, b["closest"])
    if "deep" in need:
        deep = write_deep_bvh_scene(str(out / "deep_bvh"), integrator="Path", n_bulk=2000,
                                    xres=160, yres=90)
        ctx = SceneCtx.from_scene(load_scene(deep).scene, dev)
        batches["deep"] = (ctx, aimed_rays(1 << 17, (35.0, 0.0, 0.0), 1.0, dev))
    return batches


def k2_job(scene, one_light, out):
    """The job of a K2_CASES case: the scene at its 640x360x16, or with
    `one_light` at 160x90 under DirectLighting with one light a hit
    (chip_smoke.py's phase 3); "grid_brute" is write_grid_scene's grid of
    13 x 12 cubes (1,896 triangles, brute force near TRI_MAX) under the
    Debug fixture's integrator, written under out."""
    from rs_ray_toy_tpu_torch.scene.gen import write_grid_scene
    from rs_ray_toy_tpu_torch.scene.loader import load_scene

    if scene == "grid_brute":
        job = load_scene(write_grid_scene(str(out / scene), ny=13, nz=12,
                                          base=str(SAMPLES / "scene_debug.json"),
                                          integrator="Debug", max_depth=4))
    else:
        job = load_scene(str(SAMPLES / scene))
    if one_light:
        job.film.xres, job.film.yres = 160, 90
        job.integrator.kind, job.integrator.light_strategy = "direct", "one"
    return job


def tex_queries(n, seed, dev):
    """n seeded lookups (chip_smoke.py 12a's): st over [-1.2, 2.2)^2,
    footprint axes from 1e-4 to 0.3 uv, the second often much shorter (the
    max_aniso clamp), a sixteenth with a zero second axis and a
    thirty-second with both zero (degenerate: level 0's bilinear tap)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    st = rng.uniform(-1.2, 2.2, (n, 2))
    scale = 10 ** rng.uniform(-4.0, -0.5, (n, 1))
    d0 = rng.normal(size=(n, 2)) * scale
    d1 = rng.normal(size=(n, 2)) * scale * 10 ** rng.uniform(-2.0, 0.0, (n, 1))
    d1[: n // 16] = 0.0
    d0[: n // 32] = 0.0
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    return f(st), f(d0), f(d1)


def k7_footprints(n, seed, dev):
    """n seeded lookups at the edges of K7's spans, in eighths: thin
    ellipses near the diagonals (the major axis up to 0.3 uv, the minor
    1e-4 to 0.3 of it); long ones, 8 : 1 at any angle, whose radii the
    16-texel window clamps at 7; footprints of 1e1 to 1e6 uv (the coarsest
    level, the ellipse's determinant clamped at 1e-12); of 1e12 to 1e20 uv
    (its coefficients past float32's range: infinite or NaN); an infinite
    st (NaN in texel space under the repeat wrap); a minor axis 1e-12 to
    1e-6 of the major (the max_aniso clamp stretches it); a zero minor
    axis, and both axes at most 1e-9 uv (level 0's bilinear tap).  Returns
    (st, dst0, dst1) (n, 2) float32 on `dev`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    k = np.arange(n) * 8 // n  # the eighth
    st = rng.uniform(-1.2, 2.2, (n, 2))
    theta = np.where(k == 1, rng.uniform(0.0, 2.0 * np.pi, n),
                     np.pi / 4 + np.pi / 2 * rng.integers(0, 4, n) + rng.normal(0.0, 0.05, n))
    major = np.select([k == 1, k == 2, k == 3], [10 ** rng.uniform(-1.5, -0.5, n),
                                                 10 ** rng.uniform(1.0, 6.0, n),
                                                 10 ** rng.uniform(12.0, 20.0, n)],
                      10 ** rng.uniform(-3.0, -0.5, n))
    ratio = np.select([k == 1, k == 2, k == 3, k == 5, k == 6],
                      [np.full(n, 0.125), rng.uniform(0.1, 1.0, n), rng.uniform(0.1, 1.0, n),
                       10 ** rng.uniform(-12.0, -6.0, n), np.zeros(n)],
                      10 ** rng.uniform(-4.0, -0.5, n))
    u = np.stack([np.cos(theta), np.sin(theta)], -1)
    d0 = major[:, None] * u
    d1 = (major * ratio)[:, None] * np.stack([-u[:, 1], u[:, 0]], -1)
    bad = k == 4
    st[bad, rng.integers(0, 2, n)[bad]] = np.inf * rng.choice([-1.0, 1.0], int(bad.sum()))
    tiny = k == 7
    d0[tiny] *= 1e-9 / np.abs(d0[tiny]).max(-1, keepdims=True)
    d1[tiny] = 0.0
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    return f(st), f(d0), f(d1)


def k7_pyramid(wrap, dev):
    """samples/tex_checker.png's pyramid under `wrap` (chip_smoke.py 12a's)."""
    from rs_ray_toy_tpu_torch.scene import mipmap
    from rs_ray_toy_tpu_torch.scene.png import load_image

    image = load_image(str(SAMPLES / "tex_checker.png"), True)
    return mipmap.pyramid(mipmap.build_mipmap(image, wrap=wrap), dev)


def k7_job(scene, out):
    """The textured scene of a K7_CASES pass: samples/scene_textured.json at
    640x360x16 (#1 T) or write_grid_scene's textured grid at 640x360x8 (#2
    T), as chip_smoke.py's 12b and 12c write them."""
    from rs_ray_toy_tpu_torch.scene.loader import load_scene

    if scene == "fixture":
        return load_scene(str(SAMPLES / "scene_textured.json"))
    return k1bvh_job("grid_tex", False, out)


def sppm_job(scene, out):
    """The job of a K8_CASES scene, written under out: samples/
    scene_sppm.json, scene_sppm_glass.json or scene_sppm_disney.json at
    640x360; "*grid" write_grid_scene's grid of that fixture's first
    material (19,224 triangles, a BVH) at max_depth 3, as chip_smoke.py's
    phases 6c and 14 write them; "grid_brute" its grid of 13 x 12 cubes
    (1,896 triangles: brute force near TRI_MAX)."""
    from rs_ray_toy_tpu_torch.scene.gen import write_grid_scene
    from rs_ray_toy_tpu_torch.scene.loader import load_scene

    base = {"fixture": "scene_sppm.json", "glass": "scene_sppm_glass.json",
            "disney": "scene_sppm_disney.json"}
    if scene in base:
        return load_scene(str(SAMPLES / base[scene]))
    size = dict(ny=13, nz=12) if scene == "grid_brute" else {}
    fixture = "fixture" if scene in ("grid", "grid_brute") else scene.split("_")[0]
    return load_scene(write_grid_scene(str(out / f"sppm_{scene}"), base=str(SAMPLES / base[fixture]),
                                       integrator="SPPM", max_depth=3, **size))


def sppm_inputs(job, dev, it=0):
    """What the SPPM iteration `it`'s camera walk takes, as render_sppm makes
    it: (packed, camera, pixel_xy, the Halton slot matrix)."""
    import torch

    from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
    from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
    from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk
    from rs_ray_toy_tpu_torch.render import make_sampler

    packed = smk.pack_sppm(job.scene, dev)
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, device=dev))
    w, h = job.film.xres, job.film.yres
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    pid = (ys * w + xs).reshape(-1)
    pxy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(torch.float32)
    u = make_sampler(job).slot_matrix(pid, it, smk.sppm_slots(job.integrator.max_depth))
    return packed, cam, pxy, u


def sppm_camera_rays(cam, pxy, u, depth):
    """The camera rays the walk traces from the slot matrix's film and lens
    values (chip_smoke.py 13e's given rays): (o, d (N, 3), weight (N,))."""
    import torch

    from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
    from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk

    ox, oy, oz, dx, dy, dz, w = pmk._raygen(pxy[:, 0], pxy[:, 1], None, None,
                                            smk.SlotSampler(u, depth), cam)
    return torch.stack([ox, oy, oz], -1), torch.stack([dx, dy, dz], -1), w


def sppm_outputs(ld, vp):
    """The camera walk's outputs as one (N, 20) float32 row a pixel: ld, the
    VP's p, wo, beta, ng, dpdu, material and valid."""
    import torch

    return torch.cat([ld, vp.p, vp.wo, vp.beta, vp.ng, vp.dpdu, vp.mat[:, None].float(),
                      vp.valid[:, None].float()], -1)


def surface_photons(scene, n, depth, dev, seed=12):
    """A seeded batch of photons, many of which deposit, made as
    tests/test_torch_sppm.py makes its photons: half start inside a cube
    whose material has a diffuse lobe (any cube where none has one),
    within 0.8 of its inscribed ball so that each depth hits its inner
    faces, in a random direction, half
    outside (x in [26.2, 29.8], y and z in [-6, 6]) aimed at a random point
    of any cube; 95% of them active; uniform bounce and roulette values.
    The scene's triangles must be cube.obj instances, 12 rows each.
    Returns (ro, rd, beta, active, u_rows) on `dev`."""
    import numpy as np
    import torch

    from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk

    tri = scene.triangles
    if tri.count % 12:
        raise ValueError("the photon batch needs a scene of cubes")
    verts = np.stack([tri.p0, tri.p1, tri.p2], 1).astype(np.float64).reshape(-1, 36, 3)
    centre = verts.mean(1)
    half = np.abs(((tri.p0[::12] - centre) * tri.ng[::12]).sum(-1))  # centre to a face
    mats = scene.materials
    diffuse = np.array([np.isin(mats["kind"][m, : mats["n_lobes"][m]], smk.DIFFUSE_KINDS).any()
                        for m in tri.mat[::12]])
    pool = np.nonzero(diffuse)[0] if diffuse.any() else np.arange(len(centre))
    rng = np.random.default_rng(seed)
    inside = np.arange(n) < n // 2
    pick = np.where(inside, rng.choice(pool, n), rng.integers(0, len(centre), n))
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


def first_photons(ev, depth, share):
    """The depth-major events `ev` of the first 1/`share` of the photons."""
    n = ev[3].shape[0] // (depth - 1)
    return tuple(e.reshape(depth - 1, n, -1)[:, : n // share].reshape(-1, *e.shape[1:])
                 for e in ev)


def adversarial_deposit(mats, n=200, n_events=640, seed=5, dev="cpu"):
    """Seeded adversarial inputs of the deposit's walk (VisiblePoints and
    DepositInputs on `dev`; `mats` the material rows): the VPs and events
    in a unit box, radius 0.35; lanes 0-31 with empty ranges but one;
    lanes 32-63 with disjoint ranges of 1-5 events; lane 64 one range of
    200 events beside short ones in its warp; the rest random ranges of
    0-40 events, a tenth of them not valid (r^2 -1, an empty range); N =
    200, so the last warp's lanes past N hold no VP; every material row
    used; a tenth of the events dead (all zeros)."""
    import numpy as np
    import torch

    from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk

    rng = np.random.default_rng(seed)

    def unit(k):
        v = rng.normal(size=(k, 3))
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    start = rng.integers(0, n_events - 40, n)
    length = rng.integers(0, 41, n)
    length[:32] = 0
    length[17] = 3
    start[32:64] = 5 * np.arange(32) + 10
    length[32:64] = rng.integers(1, 6, 32)
    start[64], length[64] = 300, 200
    valid = rng.random(n) > 0.1
    length[~valid] = 0
    end = start + length
    start, end = np.where(length > 0, start, 0), np.where(length > 0, end, 0)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    vp = smk.VisiblePoints(
        p=f32(rng.random((n, 3))), wo=f32(unit(n)), beta=f32(rng.uniform(0.1, 2.0, (n, 3))),
        mat=torch.as_tensor(rng.integers(0, mats.shape[0], n), device=dev), ng=f32(unit(n)),
        dpdu=f32(np.where(rng.random((n, 1)) < 0.1, 0.0, unit(n))),
        valid=torch.as_tensor(valid, device=dev))
    live = (rng.random(n_events) > 0.1).astype(np.float32)
    ev = np.concatenate([rng.random((n_events, 3)), unit(n_events),
                         rng.uniform(0.5, 20.0, (n_events, 3)), live[:, None]], -1)
    ev[live == 0, :9] = 0.0
    i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
    inp = smk.DepositInputs(events=f32(ev), start=i32(start), end=i32(end),
                            r2=f32(np.where(valid, 0.35 ** 2, -1.0)))
    return vp, inp


def sppm_iteration_inputs(job, dev):
    """The first SPPM iteration of `job` up to the photon walk, as
    render_sppm runs it, on `dev`: (packed, the camera walk's VPs, radius,
    the emitted photons, the surface batch (surface_photons), the material
    rows)."""
    import torch

    from rs_ray_toy_tpu_torch.integrators import sppm
    from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk

    spec = job.integrator
    packed, cam, pxy, u = sppm_inputs(job, dev)
    _, vp = smk.sppm_camera_mega_cam(packed, cam, pxy, u, spec.max_depth)
    radius = torch.full((pxy.shape[0],), spec.radius, dtype=torch.float32, device=dev)
    lights = sppm.photon_lights(packed, job.scene.lights, dev)
    n_ph = spec.photons_per_iter
    ph = sppm.emit_photons(lights, torch.arange(n_ph, device=dev), spec.max_depth)
    batch = surface_photons(job.scene, n_ph, spec.max_depth, dev)
    return packed, vp, radius, ph, batch, smk.resolve_mat_tables(job.scene, dev)


def bare_launch(launch):
    """The ctypes call alone of an SPPM launch closure (ops/sppm_megakernel
    _launcher): its `bare`, or, from a revision without it, its entry
    point `fn` on `args` read from the closure."""
    if hasattr(launch, "bare"):
        return launch.bare
    cells = dict(zip(launch.__code__.co_freevars, (c.cell_contents for c in launch.__closure__)))
    fn, args = cells["fn"], cells["args"]
    return lambda: fn(*args)


def bare_ms(bare, count=200, reps=5):
    """A kernel's device time as the card runs it: `count` back-to-back
    calls of `bare` (the entry point alone, returning its error code)
    between two CUDA events, queued behind a sleep of the device long enough
    that the host's enqueue stays out of the window, over the count; the
    median of `reps` such windows after a warm-up."""
    import torch

    for _ in range(3):
        if bare() != 0:
            raise RuntimeError("walk_ab: a bare launch failed")
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(count * 50_000)  # ~25 us of the device a launch
        start.record()
        for _ in range(count):
            bare()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / count)
    return statistics.median(times)


def profiled_ms(bare, name, count=20):
    """The mean device time of the kernels whose name holds `name` over
    `count` calls of `bare`, by torch.profiler (CUPTI); None where the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(count):
                bare()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if name in e.key]
        n = sum(e.count for e in rows)
        us = sum(getattr(e, "device_time_total", None) or e.cuda_time_total for e in rows)
    except RuntimeError:
        return None
    return us / n / 1e3 if n and us else None


def worker(out, reps, only):
    """Every case of the groups `only` through the `rs_ray_toy_tpu_torch` on
    sys.path: writes <out>/<case>.pt (outputs) and <out>/times.json."""
    import torch

    from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
    from rs_ray_toy_tpu_torch.integrators import sppm
    from rs_ray_toy_tpu_torch.ops import bvh_kernel as bk
    from rs_ray_toy_tpu_torch.ops import direct_megakernel as dmk
    from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
    from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk
    from rs_ray_toy_tpu_torch.ops import texture as tex_ops
    from rs_ray_toy_tpu_torch.ops import volpath_megakernel as vmk
    from rs_ray_toy_tpu_torch.render import (camera_rays, make_sampler, pass_spp, render_job,
                                             sample_batch)
    from rs_ray_toy_tpu_torch.scene.gen import write_variant
    from rs_ray_toy_tpu_torch.scene.loader import load_scene

    def timed_ms(fn):
        fn()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def occupancy(mod, bvh):
        try:  # a revision whose module reports this launch's occupancy
            return mod.occupancy(bvh=bvh)
        except (AttributeError, TypeError, ValueError):
            return None

    dev = torch.device("cuda")
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    record = {}

    def camera_pass(case, mod, packed, job, rays):
        cam = RealisticCamera(job.camera, job.film, device=dev)
        sampler = make_sampler(job)
        pxy, pid, soff = sample_batch(job.film, pass_spp(sampler.spp), dev)
        launch = mod.prepare_launch(packed, pmk.pack_camera(cam), pxy, pid, soff, sampler,
                                    job.integrator)
        rec = {"rays": pxy.shape[0], "ms": timed_ms(launch),
               "occupancy": occupancy(mod, packed.bvh is not None)}
        l, _ = launch()
        saved = {"cam": l.cpu()}
        if rays:
            o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
            launch = mod.prepare_rays_launch(packed, o, d, w, pid, soff, sampler, job.integrator)
            rec["rays_ms"] = timed_ms(launch)
            saved["rays"] = launch().cpu()
        torch.save(saved, out / f"{case}.pt")
        record[case] = rec
        print(f"{case}: {rec}", flush=True)

    for case, (scene, halton, bvh, rays) in (CASES.items() if "k1" in only else ()):
        path = SAMPLES / scene
        if halton:
            path = write_variant(str(path), str(out / "scenes" / case), 640, 360, HALTON6)
        job = load_scene(str(path))
        camera_pass(case, pmk, pmk.pack_scene(job.scene, dev, bvh=bvh or None), job, rays)
    for case, (scene, halton, rays) in (K1BVH_CASES.items() if "k1bvh" in only else ()):
        job = k1bvh_job(scene, halton, out / "scenes")
        camera_pass(case, pmk, pmk.pack_scene(job.scene, dev, bvh=True), job, rays)
    for case, (scene, one_light, rays) in (K2_CASES.items() if "k2" in only else ()):
        job = k2_job(scene, one_light, out / "scenes")
        camera_pass(case, dmk, pmk.pack_scene(job.scene, dev), job, rays)
    for case, scene in (K2BVH_CASES.items() if "k2bvh" in only else ()):
        job = bvh_job(scene, out / "scenes")
        camera_pass(case, dmk, pmk.pack_scene(job.scene, dev), job, True)
    for case, scene in (K6BVH_CASES.items() if "k6bvh" in only else ()):
        job = bvh_job(scene, out / "scenes")
        camera_pass(case, vmk, vmk.pack_volpath(job.scene, dev), job, True)
    for case in (VOL_CASES if "k6" in only else ()):
        job = load_scene(vol_scene(case, out / "scenes"))
        camera_pass(case, vmk, vmk.pack_volpath(job.scene, dev), job, case == "fog")
    need = ([b for b, _ in BVH_CASES.values()] if "k3" in only else []) + (
        list(SHADED_CASES.values()) if "k3s" in only else [])
    batches = bvh_batches(out / "scenes", dev, need) if need else {}
    for case, (batch, any_hit) in (BVH_CASES.items() if "k3" in only else ()):
        ctx, (o, d, t_max) = batches[batch]
        launch = bk.prepare_launch(ctx.bvh, o, d, t_max, any_hit)
        before = dict(bk.LAUNCHES)
        rec = {"rays": o.shape[0], "ms": timed_ms(launch),
               "walk": next(k for k, v in bk.LAUNCHES.items() if v != before[k])}
        if hasattr(bk, "occupancy"):
            rec["occupancy"] = bk.occupancy()
        t, idx = launch()
        torch.save({"hit": torch.stack([t, idx.float()], -1).cpu()}, out / f"{case}.pt")
        record[case] = rec
        print(f"{case}: {rec}", flush=True)
    for case, batch in (SHADED_CASES.items() if "k3s" in only else ()):
        ctx, (o, d, t_max) = batches[batch]
        launch = bk.prepare_shaded_launch(ctx.bvh, o, d, t_max)
        rec = {"rays": o.shape[0], "smooth": bool(ctx.bvh.smooth), "ms": timed_ms(launch)}
        try:  # a revision that reports the shaded launch's occupancy
            rec["occupancy"] = bk.occupancy(shaded=True)
        except TypeError:
            pass
        t, idx, mat, al, attrs = launch()
        torch.save({"hit": torch.stack([t, idx.float(), mat.float(), al.float()], -1).cpu(),
                    "attrs": attrs.T.cpu()}, out / f"{case}.pt")
        record[case] = rec
        print(f"{case}: {rec}", flush=True)
    def warm_render(case):
        """RENDERS[case] through render_job: one render to warm up, then the
        median of 5 renders' wall seconds (its "ms" the median in ms), their
        Mrays/s and the image."""
        job = load_scene(str(SAMPLES / RENDERS[case]))
        render_job(job, dev)
        runs = [render_job(job, dev) for _ in range(5)]
        rates = [[r.get(k) for k in ("mrays_per_s", "camera_mrays_per_s", "photon_mrays_per_s")]
                 for r in runs]
        rec = {"rays": int(runs[0]["rgb_srgb_input"].numel() // 3),
               "ms": 1e3 * statistics.median(r["elapsed_s"] for r in runs), "mrays_per_s": rates}
        torch.save({"image": runs[-1]["rgb_srgb_input"].reshape(-1, 3).cpu()},
                   out / f"{case}.pt")
        record[case] = rec
        print(f"{case}: {rec}", flush=True)

    for case, what in (K7_CASES.items() if "k7" in only else ()):
        if what == "render":
            warm_render(case)
            continue
        if what in ("fixture", "grid"):
            job = k7_job(what, out / "scenes")
            camera_pass(case, pmk, pmk.pack_scene(job.scene, dev, bvh=True if what == "grid"
                                                  else None), job, False)
            continue
        pyr = k7_pyramid(0 if what == "adversarial" else what, dev)
        queries = (k7_footprints(1 << 20, 19, dev) if what == "adversarial"
                   else tex_queries(1 << 20, 12 + what, dev))
        launch = tex_ops.prepare_launch(pyr, *queries)
        rec = {"rays": queries[0].shape[0], "ms": timed_ms(launch)}
        if hasattr(tex_ops, "occupancy"):
            rec["occupancy"] = tex_ops.occupancy()
        torch.save({"out": launch().cpu()}, out / f"{case}.pt")
        record[case] = rec
        print(f"{case}: {rec}", flush=True)
    def sppm_occupancy(**kw):
        try:  # a revision that reports the photon walk's and the deposit's occupancy
            return smk.occupancy(**kw)
        except TypeError:
            return None

    def timed_bare(case, rec, launch, kernel):
        bare = bare_launch(launch)
        rec.update(ms=bare_ms(bare), kernel_ms=profiled_ms(bare, kernel),
                   closure_ms=timed_ms(launch))
        print(f"{case}: {rec}", flush=True)
        record[case] = rec

    def events_rows(ev):
        return torch.cat([*ev[:3], ev[3][:, None].float()], -1).cpu()

    sppm_scenes = dict.fromkeys(
        [s for s in K9_CASES.values() if "k9" in only and s != "render"]
        + [s for s in K10_CASES.values() if "k10" in only])
    for scene in sppm_scenes:
        job = sppm_job(scene, out / "scenes")
        depth = job.integrator.max_depth
        packed, vp, radius, ph, batch, mats = sppm_iteration_inputs(job, dev)
        bvh, wide = packed.bvh is not None, smk.wide_lobes(packed)
        launch = smk.prepare_photon(packed, *ph, depth)
        ev = launch()
        ev_batch = smk.prepare_photon(packed, *batch, depth)()
        if "k9" in only:
            torch.save({"events": events_rows(ev), "surface": events_rows(ev_batch)},
                       out / f"k9_{scene}.pt")
            timed_bare(f"k9_{scene}", dict(rays=ph[0].shape[0], bvh=bvh, live=int(ev[3].sum()),
                                           occupancy=sppm_occupancy(kernel="photon", bvh=bvh,
                                                                    wide=wide)),
                       launch, "sppm_photon_kernel")
        if "k10" not in only:
            continue
        lo, diag = sppm.grid_bounds(vp, radius)
        saved = {}
        for key, events in (("deposit", ev), ("surface", first_photons(ev_batch, depth, 16))):
            inp = smk.deposit_inputs(vp, radius, events, lo, diag)
            phi, m = smk.prepare_deposit(vp, mats, inp)()
            saved[key] = torch.cat([phi, m[:, None].float()], -1).cpu()
        torch.save(saved, out / f"k10_{scene}.pt")
        inp = smk.deposit_inputs(vp, radius, ev, lo, diag)
        walking = inp.end > inp.start
        rec = dict(rays=vp.p.shape[0], walking=int(walking.sum()),
                   pairs=int((inp.end - inp.start)[walking].sum()))
        launch = smk.prepare_deposit(vp, mats, inp)
        launch()
        rec["occupancy"] = sppm_occupancy(kernel="deposit", wide=smk.mats_wide(mats))
        timed_bare(f"k10_{scene}", rec, launch, "sppm_deposit_kernel")
    if "k9" in only:
        warm_render("k9_render")
    for case, scene in (K8_CASES.items() if "k8" in only else ()):
        if scene == "render":
            warm_render(case)
            continue
        job = sppm_job(scene, out / "scenes")
        depth = job.integrator.max_depth
        packed, cam, pxy, u = sppm_inputs(job, dev)
        bvh, wide = packed.bvh is not None, smk.wide_lobes(packed)
        launch = smk.prepare_camera(packed, cam, pxy, u, depth)
        rec = {"rays": pxy.shape[0], "bvh": bvh, "ms": timed_ms(launch)}
        saved = {"cam": sppm_outputs(*launch()).cpu()}
        o, d, w = sppm_camera_rays(cam, pxy, u, depth)
        launch = smk.prepare_camera_rays(packed, o, d, w, u, depth)
        rec["rays_ms"] = timed_ms(launch)
        saved["rays"] = sppm_outputs(*launch()).cpu()
        if hasattr(smk, "occupancy"):
            rec["occupancy"] = smk.occupancy(bvh=bvh, wide=wide)
            rec["rays_occupancy"] = smk.occupancy(bvh=bvh, rays_in=True, wide=wide)
        torch.save(saved, out / f"{case}.pt")
        record[case] = rec
        print(f"{case}: {rec}", flush=True)
    for case, scene in (HOST_CASES.items() if "host" in only else ()):
        if scene != "wrapper":
            warm_render(case)
            continue
        job = load_scene(str(SAMPLES / "scene.json"))
        sampler = make_sampler(job)
        cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, device=dev))
        pxy, pid, soff = sample_batch(job.film, pass_spp(sampler.spp), dev)
        args = (pmk.pack_scene(job.scene, dev), cam, pxy, pid, soff, sampler, job.integrator)
        record[case] = {"rays": pxy.shape[0], "ms": timed_ms(lambda: pmk.li_path_mega_cam(*args))}
        torch.save({"cam": pmk.li_path_mega_cam(*args)[0].cpu()}, out / f"{case}.pt")
        print(f"{case}: {record[case]}", flush=True)
    (out / "times.json").write_text(json.dumps(record))


def chunk_counts(work, n):
    """The chunked walk's counts of a plain run over n consecutive rays
    (chunk_walk's keys): per ray its MT and chunk box tests and the MT tests
    of the walk over every row; per warp the chunks it runs, their rows and
    the rows of the walk over every row; and the share of those rows the
    chunked walk runs."""
    from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk

    w = {k: float(v) for k, v in work.items()}
    warps = -(-n // pmk.WARP)
    return dict(rays=n, mt_per_ray=w["mt"] / n, slab_per_ray=w["slab"] / n,
                mt_brute_per_ray=w["mt_brute"] / n, chunk_warp_per_warp=w["chunk_warp"] / warps,
                mt_warp_per_warp=w["mt_warp"] / warps,
                mt_brute_warp_per_warp=w["mt_brute_warp"] / warps,
                warp_row_share=w["mt_warp"] / w["mt_brute_warp"])


def step_counts(work, n):
    """The node64 walk's counts of a plain K1 run over n consecutive rays
    (PlainGeometry's tallies): per ray its MT and slab tests and interior
    rows; per kind of walk (closest, any, probe) the walks, their mean
    steps and the mean over the warps of each warp's longest walk."""
    w = {k: float(v) for k, v in work.items()}
    out = dict(rays=n, mt_per_ray=w["mt"] / n, slab_per_ray=w["slab"] / n,
               node_per_ray=w["node"] / n)
    for tag in ("closest", "any", "probe"):
        if w.get(f"{tag}_walks"):
            out[tag] = dict(walks=w[f"{tag}_walks"],
                            steps_per_walk=w[f"{tag}_steps"] / w[f"{tag}_walks"],
                            warp_longest=w[f"{tag}_warp_steps"] / w[f"{tag}_warps"])
    return out


def k7_counts(what, dev, scale, out):
    """K7's counts of a K7_CASES case (ops/texture.ScanCounter over the plain
    version): per lookup the texels the tap scans (the spans of both
    levels) against the whole windows', the texels it weighs, the warps'
    longest scan (32 consecutive lookups), and the weighed texels outside
    the spans (0).  K7 alone on (1 << 20) / scale^2 of its lookups; a
    textured pass (its film divided by scale on each side) through K1's
    plain version in quarters of consecutive rays, with the camera rays
    whose bounce-0 hit is textured (each one EWA lookup) and the
    differential lens traces the pass makes (two a camera ray)."""
    from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
    from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
    from rs_ray_toy_tpu_torch.ops import texture as tex_ops
    from rs_ray_toy_tpu_torch.render import make_sampler, pass_spp, sample_batch

    counter = tex_ops.ScanCounter()
    work = {"ewa_scan": counter}
    if what not in ("fixture", "grid"):
        n = (1 << 20) // scale**2
        queries = (k7_footprints(n, 19, dev) if what == "adversarial"
                   else tex_queries(n, 12 + what, dev))
        tex_ops.tex_lookup_reference(k7_pyramid(0 if what == "adversarial" else what, dev),
                                     *queries, work)
        return dict(texel_per_lookup=float(work["texel"]) / n, **counter.summary())
    job = k7_job(what, out)
    job.film.xres, job.film.yres = job.film.xres // scale, job.film.yres // scale
    packed = pmk.pack_scene(job.scene, dev, bvh=True if what == "grid" else None)
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, device=dev))
    sampler = make_sampler(job)
    pxy, pid, soff = sample_batch(job.film, pass_spp(sampler.spp), dev)
    n = pxy.shape[0]
    q = -(-n // 4)
    for k in range(0, n, q):
        pmk.li_path_mega_cam_reference(packed, cam, pxy[k:k + q], pid[k:k + q], soff[k:k + q],
                                       sampler, job.integrator, work=work)
    return dict(film=f"{job.film.xres}x{job.film.yres}x{pass_spp(sampler.spp)}", rays=n,
                textured_first_hits=float(work["fd_ray"]) / 2, differential_traces=2 * n,
                **counter.summary())


def counts(dev, scale, only=GROUPS):
    """The plain versions' counts of the redesigned walks (the module
    docstring's --counts) of the groups `only`; returns them as a dict."""
    import torch

    from rs_ray_toy_tpu_torch.accel import traverse
    from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
    from rs_ray_toy_tpu_torch.integrators import sppm
    from rs_ray_toy_tpu_torch.ops import direct_megakernel as dmk
    from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
    from rs_ray_toy_tpu_torch.ops import sppm_megakernel as smk
    from rs_ray_toy_tpu_torch.ops import volpath_megakernel as vmk
    from rs_ray_toy_tpu_torch.render import make_sampler, pass_spp, sample_batch
    from rs_ray_toy_tpu_torch.scene.loader import load_scene

    out = ROOT / "build" / "walk_counts"
    found = {}
    cuda = torch.device(dev).type == "cuda"
    for case, (scene, halton, _) in (K1BVH_CASES.items() if cuda and "k1bvh" in only else ()):
        job = k1bvh_job(scene, halton, out)
        packed = pmk.pack_scene(job.scene, dev, bvh=True)
        cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, device=dev))
        sampler = make_sampler(job)
        pxy, pid, soff = sample_batch(job.film, pass_spp(sampler.spp), dev)
        part = slice(0, pxy.shape[0] // 4)
        work = {}
        pmk.li_path_mega_cam_reference(packed, cam, pxy[part], pid[part], soff[part], sampler,
                                       job.integrator, work=work)
        found[case] = step_counts(work, pxy[part].shape[0])
        print(f"{case}: {found[case]}", flush=True)
    bvh_cases = ([(c, s, dmk) for c, s in K2BVH_CASES.items()] if "k2bvh" in only else []) + (
        [(c, s, vmk) for c, s in K6BVH_CASES.items()] if "k6bvh" in only else [])
    for case, scene, mod in (bvh_cases if cuda else ()):
        job = bvh_job(scene, out)
        if mod is vmk:
            job.film.xres, job.film.yres = job.film.xres // scale, job.film.yres // scale
        packed = vmk.pack_volpath(job.scene, dev) if mod is vmk else pmk.pack_scene(job.scene, dev)
        cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, device=dev))
        sampler = make_sampler(job)
        pxy, pid, soff = sample_batch(job.film, pass_spp(sampler.spp), dev)
        part = slice(0, pxy.shape[0] // 4)
        ref = (vmk.li_volpath_mega_cam_reference if mod is vmk
               else dmk.li_levels_mega_cam_reference)
        work = {}
        ref(packed, cam, pxy[part], pid[part], soff[part], sampler, job.integrator, work=work)
        found[case] = dict(film=f"{job.film.xres}x{job.film.yres}x{pass_spp(sampler.spp)}",
                           **step_counts(work, pxy[part].shape[0]))
        print(f"{case}: {found[case]}", flush=True)
    for case, (scene, one_light, _) in (K2_CASES.items() if "k2" in only else ()):
        job = k2_job(scene, one_light, out)
        job.film.xres, job.film.yres = job.film.xres // scale, job.film.yres // scale
        packed = pmk.pack_scene(job.scene, dev)
        cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, device=dev))
        sampler = make_sampler(job)
        pxy, pid, soff = sample_batch(job.film, pass_spp(sampler.spp), dev)
        work = {}
        dmk.li_levels_mega_cam_reference(packed, cam, pxy, pid, soff, sampler, job.integrator,
                                         work=work)
        found[case] = dict(film=f"{job.film.xres}x{job.film.yres}x{pass_spp(sampler.spp)}",
                           chunks=int(packed.chunks.shape[0]), rows=int(packed.table.shape[0]),
                           **chunk_counts(work, pxy.shape[0]))
        print(f"{case}: {found[case]}", flush=True)
    for case in (VOL_CASES if "k6" in only else ()):
        job = load_scene(vol_scene(case, out))
        job.film.xres, job.film.yres = job.film.xres // scale, job.film.yres // scale
        packed = vmk.pack_volpath(job.scene, dev)
        cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, device=dev))
        sampler = make_sampler(job)
        pxy, pid, soff = sample_batch(job.film, pass_spp(sampler.spp), dev)
        work = {}
        vmk.li_volpath_mega_cam_reference(packed, cam, pxy, pid, soff, sampler, job.integrator,
                                          work=work)
        found[case] = dict(film=f"{job.film.xres}x{job.film.yres}x{pass_spp(sampler.spp)}",
                           chunks=int(packed.chunks.shape[0]), rows=int(packed.table.shape[0]),
                           **chunk_counts(work, pxy.shape[0]))
        print(f"{case}: {found[case]}", flush=True)
    for case, what in (K7_CASES.items() if "k7" in only else ()):
        if what == "render":
            continue
        found[case] = k7_counts(what, dev, scale, out)
        print(f"{case}: {found[case]}", flush=True)
    for case, scene in (K8_CASES.items() if "k8" in only else ()):
        if scene == "render":
            continue
        job = sppm_job(scene, out)
        job.film.xres, job.film.yres = job.film.xres // scale, job.film.yres // scale
        packed, cam, pxy, u = sppm_inputs(job, dev)
        work = {}
        smk.sppm_camera_mega_cam_reference(packed, cam, pxy, u, job.integrator.max_depth,
                                           work=work)
        n = pxy.shape[0]
        walk = (step_counts(work, n) if packed.bvh is not None else
                dict(chunks=int(packed.chunks.shape[0]), **chunk_counts(work, n)))
        found[case] = dict(film=f"{job.film.xres}x{job.film.yres}",
                           rows=int(packed.table.shape[0]), **walk)
        print(f"{case}: {found[case]}", flush=True)
    sppm_scenes = dict.fromkeys(
        [s for s in K9_CASES.values() if "k9" in only and s != "render"]
        + [s for s in K10_CASES.values() if "k10" in only])
    for scene in sppm_scenes:
        job = sppm_job(scene, out)
        job.film.xres, job.film.yres = job.film.xres // scale, job.film.yres // scale
        depth = job.integrator.max_depth
        packed, vp, radius, ph, batch, mats = sppm_iteration_inputs(job, dev)
        rows = int(packed.table.shape[0])
        for key, photons in (("emitted", ph), ("surface", batch)):
            if "k9" not in only:
                break
            work = {}
            ev = smk.sppm_photon_mega_reference(packed, *photons, depth, work=work)
            n = photons[0].shape[0]
            walk = (step_counts(work, n) if packed.bvh is not None else
                    dict(chunks=int(packed.chunks.shape[0]), **chunk_counts(work, n)))
            found[f"k9_{scene}_{key}"] = dict(rows=rows, live_events=int(ev[3].sum()), **walk)
            print(f"k9_{scene}_{key}: {found[f'k9_{scene}_{key}']}", flush=True)
            if key == "emitted":
                events = ev
        if "k10" not in only:
            continue
        if "k9" not in only:
            events = smk.sppm_photon_mega_reference(packed, *ph, depth)
        lo, diag = sppm.grid_bounds(vp, radius)
        inp = smk.deposit_inputs(vp, radius, events, lo, diag)
        work = {}
        smk.deposit_warp_walk(vp, mats, inp, work)
        walking = inp.end > inp.start
        lanes = torch.nn.functional.pad(walking, (0, -walking.numel() % pmk.WARP))
        n_warps = int(lanes.reshape(-1, pmk.WARP).any(1).sum())
        found[f"k10_{scene}"] = dict(
            film=f"{job.film.xres}x{job.film.yres}", vps=vp.p.shape[0],
            walking=int(walking.sum()), live_events=int(events[3].sum()),
            pairs=float(work.get("pair", 0)), rows_read=float(work.get("row_read", 0)),
            walking_warps=n_warps,
            **{f"{k}_per_walking_warp": float(work.get(key, 0)) / n_warps if n_warps else None
               for k, key in (("rows", "row_read"), ("pairs", "pair"), ("lobe_passes", "shade_warp"),
                              ("lobe_passes_one_a_row", "shade_union"))})
        print(f"k10_{scene}: {found[f'k10_{scene}']}", flush=True)
    walks = ([(c, b, a) for c, (b, a) in BVH_CASES.items() if b in ("ao_grid", "probe_chain")]
             if "k3" in only else []) + (
        [(c, b, False) for c, b in SHADED_CASES.items()] if "k3s" in only else [])
    batches = bvh_batches(out, dev, [b for _, b, _ in walks]) if cuda and walks else {}
    for case, batch, any_hit in (walks if cuda else ()):
        ctx, (o, d, t_max) = batches[batch]
        work = {}
        _, _, steps = traverse.walk64(ctx.bvh, o, d, t_max, any_hit, work)
        found[case] = dict(rays=o.shape[0], **traverse.step_stats(steps, t_max > 0.0),
                           nodes_per_ray=float(work["node"]) / o.shape[0],
                           mt_per_ray=float(work["mt"]) / o.shape[0],
                           slab_per_ray=float(work["slab"]) / o.shape[0])
        print(f"{case}: {found[case]}", flush=True)
    return found


def constant_edit(name):
    """The source edit of a `CONSTANT=VALUE` variant: (file under the
    package, the constant's definition, it with VALUE), the one kernel
    source that defines `constexpr <type> CONSTANT = ...;`."""
    const, value = name.split("=", 1)
    pattern = re.compile(rf"constexpr (?:int|bool|float) {re.escape(const)} = [^;]+;")
    found = [(path, m) for path in sorted((ROOT / "rs_ray_toy_tpu_torch" / "csrc").iterdir())
             for m in pattern.finditer(path.read_text())]
    if len(found) != 1:
        raise SystemExit(f"walk_ab: variant {name}: {const} is not defined once in csrc/")
    path, m = found[0]
    old = m.group(0)
    return [(f"csrc/{path.name}", old, old.split(" = ")[0] + f" = {value};")]


def variant_tree(name, out):
    """A copy of this tree's package, csrc/ and samples/ under `out` with the
    source edits of VARIANTS[name] (or of the `CONSTANT=VALUE` edit)."""
    tree = out / f"variant_{name.replace('=', '_')}"
    shutil.rmtree(tree, ignore_errors=True)
    skip = shutil.ignore_patterns("__pycache__", "*.so")
    for part in ("rs_ray_toy_tpu_torch", "csrc", "samples"):
        shutil.copytree(ROOT / part, tree / part, ignore=skip)
    edits = Counter(constant_edit(name) if "=" in name else VARIANTS[name])
    for (rel, old, new), times in edits.items():
        path = tree / "rs_ray_toy_tpu_torch" / rel
        text = path.read_text()
        if text.count(old) != times:
            raise SystemExit(f"walk_ab: variant {name}: the text to edit is not {times}x in {rel}")
        path.write_text(text.replace(old, new))
    return tree


def run_tree(tree, args):
    env = dict(os.environ, PYTHONPATH=str(tree))
    subprocess.run(args, cwd=tree, env=env, check=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of the other revision")
    ap.add_argument("--variant", help="this tree with one source edit (a name of VARIANTS, "
                                      "or CONSTANT=VALUE) in the other revision's place")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help=f"the kernels' cases: some of {','.join(GROUPS)}")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=str(ROOT / "build" / "walk_ab"))
    ap.add_argument("--counts", action="store_true", help="count with the plain versions")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=1,
                    help="--counts: K6's and K2's films divided by this")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    only = a.only.split(",")
    if not set(only) <= set(GROUPS):
        ap.error(f"--only takes some of {GROUPS}")
    if a.variant is not None and "=" not in a.variant and a.variant not in VARIANTS:
        ap.error(f"--variant takes one of {sorted(VARIANTS)} or CONSTANT=VALUE")
    if a.worker:
        return worker(a.worker, a.reps, only)
    if a.counts:
        print(json.dumps(counts(a.device, a.scale, only)))
        return None
    import torch

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out = Path(a.out).resolve()  # the workers run in their trees
    if (a.parent is None) == (a.variant is None):
        ap.error("give --parent or --variant")
    other = variant_tree(a.variant, out) if a.variant else Path(a.parent).resolve()
    trees = {"parent": other, "change": ROOT}
    sources = sorted({src for g in only for src in SOURCES[g]})
    build = [sys.executable, "-c", "from rs_ray_toy_tpu_torch.ops import _build; "
             f"[_build.build(k) for k in {sources}]"]
    procs = [subprocess.Popen(build, cwd=t, env=dict(os.environ, PYTHONPATH=str(t)))
             for t in trees.values()]
    if any(p.wait() for p in procs):
        raise SystemExit("walk_ab: a build failed")
    turns = [("parent", 0), ("change", 0), ("change", 1), ("parent", 1)]
    for name, k in turns:
        run_tree(trees[name], [sys.executable, str(Path(__file__).resolve()), "--worker",
                               str(out / f"{name}{k}"), "--reps", str(a.reps),
                               "--only", a.only])
    times = {f"{n}{k}": json.loads((out / f"{n}{k}" / "times.json").read_text())
             for n, k in turns}
    summary = {}
    groups = dict(zip(GROUPS, (CASES, VOL_CASES, BVH_CASES, K1BVH_CASES, K2BVH_CASES,
                               K6BVH_CASES, K2_CASES, SHADED_CASES, K7_CASES, K8_CASES,
                               K9_CASES, K10_CASES, HOST_CASES)))
    for case in (c for g in only for c in groups[g]):
        ref = torch.load(out / "parent0" / f"{case}.pt")
        new = torch.load(out / "change0" / f"{case}.pt")
        row = {"rays": times["change0"][case]["rays"],
               "ms": [times[f"{n}{k}"][case]["ms"] for n, k in turns],
               "occupancy": times["change0"][case].get("occupancy"),
               "occupancy_other": times["parent0"][case].get("occupancy")}
        if case in BVH_CASES:
            row["walks"] = [times[f"{n}0"][case]["walk"] for n in ("parent", "change")]
        for key in ref:
            same = (ref[key] == new[key]) | (ref[key].isnan() & new[key].isnan())
            row[f"{key}_rays_apart"] = int((~same.all(-1)).sum())
        for key in ("rays_ms", "kernel_ms", "closure_ms"):
            if key in times["change0"][case]:
                row[key] = [times[f"{n}{k}"][case][key] for n, k in turns]
        if "rays_occupancy" in times["change0"][case]:
            row["rays_occupancy"] = times["change0"][case]["rays_occupancy"]
        summary[case] = row
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
