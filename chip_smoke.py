"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  prints the card (nvidia-smi name and power limit), torch and
         nvcc, and builds the three kernel libraries from csrc/ (one nvcc
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

Every driven main path starts with all launch counts at 0 and must show
one launch of its kernel per pass and none of the others.  Every phase
prints one line; any failure raises and exits non-zero.  The
second-to-last line is a JSON record of the six kernels, the last line
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
16 per lobe of its material; the raw normals and the texture block are
never read.  For the Volpath kernel the density grid is read once
too.  The operations are the Moller-Trumbore tests (45 each), slab
tests (27), lobe evaluations (3, lambert's; a floor) and the grid
tracking steps' trilinear density taps (40: the point and its scaled
coordinates, 12, and seven lerps of 4) that the plain version counts on
the same inputs, scaled by the batch over the subset where it ran on a
subset; the lens trace, the sampler hashes, the shading, the light
sampling and the medium's closed forms are left out, so the bound is a
lower one.  No single
PyTorch call computes a sample pass: `library_ms` is null.
"""

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
from rs_ray_toy_tpu_torch.ops import _build
from rs_ray_toy_tpu_torch.ops import direct_megakernel as dmk
from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
from rs_ray_toy_tpu_torch.ops import volpath_megakernel as vmk
from rs_ray_toy_tpu_torch.render import deploy_render, render_job, sample_batch
from rs_ray_toy_tpu_torch.sampler.stratified import StratifiedSampler
from rs_ray_toy_tpu_torch.scene.gen import (
    THIN_FOG,
    write_fog_scene,
    write_grid_fog_scene,
    write_grid_scene,
)
from rs_ray_toy_tpu_torch.scene.loader import load_scene

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "samples" / "scene.json"
SCENE_DEBUG = ROOT / "samples" / "scene_debug.json"
SCENE_FOG = ROOT / "samples" / "scene_fog.json"
OUT = ROOT / "build" / "chip_smoke"
PATH_SRC = "rs_ray_toy_tpu_torch/csrc/path_megakernel.cu"
DIRECT_SRC = "rs_ray_toy_tpu_torch/csrc/direct_megakernel.cu"
VOLPATH_SRC = "rs_ray_toy_tpu_torch/csrc/volpath_megakernel.cu"
KERNELS = {
    "path_mega_cam": dict(source=PATH_SRC, replaces="rs_ray_toy_tpu/ops/path_megakernel.py:3814"),
    "path_mega_cam_bvh": dict(
        source=PATH_SRC, replaces="rs_ray_toy_tpu/ops/path_megakernel.py:3843"
    ),
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
}
# FP32 operations per counted test or density tap
FLOPS = {"mt": 45, "slab": 27, "lobe": 3, "track": 40}
# module: (kernel wrapper, plain version, packing)
PASSES = {
    pmk: (pmk.li_path_mega_cam, pmk.li_path_mega_cam_reference, pmk.pack_scene),
    dmk: (dmk.li_levels_mega_cam, dmk.li_levels_mega_cam_reference, pmk.pack_scene),
    vmk: (vmk.li_volpath_mega_cam, vmk.li_volpath_mega_cam_reference, vmk.pack_volpath),
}
PEAK_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
RAY_BYTES = 8 + 4 + 4 + 12 + 4  # pixel_xy, pixel id, sample index in; L, weight out
ROW_HEAD_COLS = 9 + 7  # p0, e1, e2; ng, dpdu, lobe count
LOBE_COLS = 16
NODE_READ_COLS = 12 + 3  # both child boxes; offset, n_prims, axis


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


def once_ms(fn):
    """CUDA-event milliseconds of one run (no warm-up)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def per_ray_bar(l, l_ref):
    """tests/test_megakernel.py:127-132; returns the measured numbers."""
    l, l_ref = l.double(), l_ref.double()
    check(bool(torch.isfinite(l).all()), "non-finite kernel radiance")
    check(float(l_ref.max()) > 0, "plain version rendered nothing")
    rel = (l - l_ref).abs() / l_ref.abs().clamp(min=1e-3)
    stats = dict(
        diverged=float((rel.amax(-1) > 1e-3).double().mean()),
        q99=float(torch.quantile(rel.flatten()[:: max(1, rel.numel() // 2**24)], 0.99)),
        mean=float(l.mean()),
        mean_ref=float(l_ref.mean()),
    )
    check(stats["diverged"] < 5e-3, f"{stats['diverged']:.2%} of rays diverged")
    check(stats["q99"] < 1e-5, f"99th percentile relative difference {stats['q99']:.3g}")
    check(
        abs(stats["mean"] - stats["mean_ref"]) < 1e-6 + 3e-3 * abs(stats["mean_ref"]),
        f"means {stats['mean']:.6g} vs {stats['mean_ref']:.6g}",
    )
    return stats


def bound(work, scale, n_rays, packed):
    """(bound_ms, bound_by) of one pass over n_rays (see the module
    docstring); `work` is the plain version's counts, `scale` the batch
    over the rays it ran on."""
    flops = scale * sum(FLOPS[k] * float(v) for k, v in work.items())
    cols = ROW_HEAD_COLS + LOBE_COLS * packed.table[:, 15]
    nbytes = n_rays * RAY_BYTES + int(cols.sum()) * 4
    if packed.bvh is not None:
        nbytes += packed.bvh.nodes_f.shape[0] * NODE_READ_COLS * 4
    if getattr(packed, "grid", False):
        nbytes += packed.medium["density"][0].numel() * 4
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def zero_counts():
    for counts in (pmk.LAUNCHES, dmk.LAUNCHES, vmk.LAUNCHES):
        for k in counts:
            counts[k] = 0


def all_counts():
    return {**pmk.LAUNCHES, **dmk.LAUNCHES, **vmk.LAUNCHES}


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


def hold(mod, job, stride, dev):
    """The kernel against its plain version on the main path's batch for
    `job` (one pass): the kernel on the whole batch, the plain version on
    a seeded random 1/`stride` of its rays.  Returns the measured numbers."""
    fn, ref, pack = PASSES[mod]
    cam = pmk.pack_camera(RealisticCamera(job.camera, job.film, device=dev))
    packed = pack(job.scene, dev)
    sampler = StratifiedSampler(job.sampler)
    pxy, pid, soff = sample_batch(job.film, min(16, sampler.spp), dev)
    args = (packed, cam, pxy, pid, soff, sampler, job.integrator)
    l, w = fn(*args)
    torch.cuda.synchronize()
    n = pxy.shape[0]
    pick = torch.randperm(n, generator=torch.Generator().manual_seed(stride))[: n // stride]
    sub = pick.sort().values.to(dev)
    scale = n / sub.numel()
    sub_args = (packed, cam, pxy[sub], pid[sub], soff[sub], sampler, job.integrator)
    work = {}
    l_ref, w_ref = ref(*sub_args, work=work)
    bar = per_ray_bar(l[sub], l_ref)
    max_abs_err = max(float((l[sub] - l_ref).abs().max()), float((w[sub] - w_ref).abs().max()))
    del l, w, l_ref, w_ref
    ms = timed_ms(mod.prepare_launch(*args), reps=10)
    wrapper_ms = timed_ms(lambda: fn(*args))
    plain_ms = once_ms(lambda: ref(*sub_args))
    bound_ms, bound_by = bound(work, scale, n, packed)
    return dict(
        rays=n, plain_rays=pxy[sub].shape[0], bvh=packed.bvh is not None,
        grid=getattr(packed, "grid", False),
        max_abs_err=max_abs_err, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by,
        work={k: float(v) * scale for k, v in work.items()}, **bar,
    )


def warm_rates(job, dev, n=3):
    return [render_job(job, dev)["mrays_per_s"] for _ in range(n)]


def describe(tag, res, launches, colored, held, warm, card):
    return (
        f"{tag}: {res['camera_rays']} rays in {res['passes']} pass(es), {launches} launch(es), "
        f"{colored} coloured px; first render {res['mrays_per_s']:.2f} Mrays/s, warm "
        f"{', '.join(f'{m:.1f}' for m in warm)} Mrays/s; kernel {held['ms']:.3f} ms "
        f"(wrapper {held['wrapper_ms']:.3f} ms) over {held['rays']} rays, bound "
        f"{held['bound_ms']:.4f} ms by {held['bound_by']}; plain {held['plain_ms']:.1f} ms over "
        f"{held['plain_rays']} rays; kernel vs plain: diverged {held['diverged']:.2e}, q99 "
        f"{held['q99']:.2e}, mean {held['mean']:.6g} vs {held['mean_ref']:.6g}, max_abs_err "
        f"{held['max_abs_err']:.3g} [{card}]"
    )


def main():
    record = {}
    # ---- phase 0: the card, the toolchain, the builds ----
    check(torch.cuda.is_available(), "no CUDA device")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    nvcc = run([_build.nvcc_path(), "--version"]).splitlines()[-1]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        builds = {
            name: pool.submit(_build.build, name)
            for name in ("path_megakernel", "direct_megakernel", "volpath_megakernel")
        }
        host = pool.submit(_build.load_host, "bvh_builder")
        logs = {name: f.result()[1] for name, f in builds.items()}
        host.result()
    build_s = time.perf_counter() - t0
    pmk.load_kernel()
    dmk.load_kernel()
    vmk.load_kernel()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in logs.items()
    }
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

    def entry(name, launches, held, extra_err=0.0):
        kernels[name] = dict(
            name=name, route="cuda", **KERNELS[name], launches=launches,
            max_abs_err=max(held["max_abs_err"], extra_err), ms=held["ms"],
            plain_ms=held["plain_ms"], bound_ms=held["bound_ms"], bound_by=held["bound_by"],
            library_ms=None, rays=held["rays"], plain_rays=held["plain_rays"],
        )

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


if __name__ == "__main__":
    sys.exit(main())
