"""The path kernel's brute-force instances against another revision's, on
one NVIDIA GPU.

    python -m rs_ray_toy_tpu_torch.walk_ab --parent DIR [--reps 10] [--out DIR]

DIR is a checkout of the other revision (e.g. `git archive` of the parent
commit unpacked under build/).  Each tree builds its own kernels; then a
worker process runs under each tree in turns (the other revision, this
tree, this tree, the other revision), so that both meet the card in the
same state.  A worker renders one sample pass of each case through the
path kernel's brute-force instances (`li_path_mega_cam`, and
`li_path_mega` on the pass's camera rays), times each launch with CUDA
events (median of --reps after one warm-up) and keeps its radiance; the
cases cover every brute-force instance the fixtures reach (base, spheres,
environment, Halton, smooth, Halton + smooth, Disney, subsurface,
subsurface + Halton, textured) and, as a yardstick, the smooth fixture
through the BVH instances (`pack_scene(..., bvh=True)`).  The last line of
the output is a JSON object: per case the four times in turn order, the
other revision's radiance against this tree's (rays whose three channels
are not all bit-equal; NaN equal to NaN), and this tree's occupancy
(block size, blocks per SM, registers, shared memory) where it reports one.
Both workers' records go to --out.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
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


def worker(out, reps):
    """Every case through the `rs_ray_toy_tpu_torch` on sys.path: writes
    <out>/<case>.pt (radiance) and <out>/times.json."""
    import torch

    from rs_ray_toy_tpu_torch.camera.realistic import RealisticCamera
    from rs_ray_toy_tpu_torch.ops import path_megakernel as pmk
    from rs_ray_toy_tpu_torch.render import camera_rays, make_sampler, pass_spp, sample_batch
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

    dev = torch.device("cuda")
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    record = {}
    for case, (scene, halton, bvh, rays) in CASES.items():
        path = SAMPLES / scene
        if halton:
            path = write_variant(str(path), str(out / "scenes" / case), 640, 360, HALTON6)
        job = load_scene(str(path))
        packed = pmk.pack_scene(job.scene, dev, bvh=bvh or None)
        cam = RealisticCamera(job.camera, job.film, device=dev)
        sampler = make_sampler(job)
        pxy, pid, soff = sample_batch(job.film, pass_spp(sampler.spp), dev)
        args = (packed, pmk.pack_camera(cam), pxy, pid, soff, sampler, job.integrator)
        launch = pmk.prepare_launch(*args)
        rec = {"rays": pxy.shape[0], "ms": timed_ms(launch)}
        if hasattr(pmk, "occupancy") and not bvh:
            rec["occupancy"] = pmk.occupancy()
        l, _ = launch()
        saved = {"cam": l.cpu()}
        if rays:
            o, d, w = camera_rays(cam, sampler, pxy, pid, soff)
            launch = pmk.prepare_rays_launch(packed, o, d, w, pid, soff, sampler, job.integrator)
            rec["rays_ms"] = timed_ms(launch)
            saved["rays"] = launch().cpu()
        torch.save(saved, out / f"{case}.pt")
        record[case] = rec
        print(f"{case}: {rec}", flush=True)
    (out / "times.json").write_text(json.dumps(record))


def run_tree(tree, args):
    env = dict(os.environ, PYTHONPATH=str(tree))
    subprocess.run(args, cwd=tree, env=env, check=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout of the other revision")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=str(ROOT / "build" / "walk_ab"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        return worker(a.worker, a.reps)
    import torch

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    trees = {"parent": Path(a.parent).resolve(), "change": ROOT}
    build = [sys.executable, "-c", "from rs_ray_toy_tpu_torch.ops import _build; "
             "_build.build('path_megakernel')"]
    procs = [subprocess.Popen(build, cwd=t, env=dict(os.environ, PYTHONPATH=str(t)))
             for t in trees.values()]
    if any(p.wait() for p in procs):
        raise SystemExit("walk_ab: a build failed")
    out = Path(a.out).resolve()  # the workers run in their trees
    turns = [("parent", 0), ("change", 0), ("change", 1), ("parent", 1)]
    for name, k in turns:
        run_tree(trees[name], [sys.executable, str(Path(__file__).resolve()), "--worker",
                               str(out / f"{name}{k}"), "--reps", str(a.reps)])
    times = {f"{n}{k}": json.loads((out / f"{n}{k}" / "times.json").read_text())
             for n, k in turns}
    summary = {}
    for case in CASES:
        ref = torch.load(out / "parent0" / f"{case}.pt")
        new = torch.load(out / "change0" / f"{case}.pt")
        row = {"rays": times["change0"][case]["rays"],
               "ms": [times[f"{n}{k}"][case]["ms"] for n, k in turns],
               "occupancy": times["change0"][case].get("occupancy")}
        for key in ref:
            same = (ref[key] == new[key]) | (ref[key].isnan() & new[key].isnan())
            row[f"{key}_rays_apart"] = int((~same.all(-1)).sum())
        if "rays_ms" in times["change0"][case]:
            row["rays_ms"] = [times[f"{n}{k}"][case]["rays_ms"] for n, k in turns]
        summary[case] = row
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
