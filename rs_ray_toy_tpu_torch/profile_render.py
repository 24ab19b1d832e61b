"""Where a render's device time goes, on the card.

    python -m rs_ray_toy_tpu_torch.profile_render scene.json [--spp N] [--top K]

Renders the scene once to warm up (kernel builds, allocator, caches),
once timed (render_job's CUDA-event window, `elapsed_s`), and once more
under torch.profiler (CPU and CUDA activities), and prints one JSON
object: the card (nvidia-smi name and power limit), both windows (the
profiler slows the host), the summed time of every kernel the card ran in
the profiled render's passes (render.PassTimer's range) and their count,
that sum over the unprofiled window (the device's busy share; one stream,
so kernels do not overlap), and the top K kernels by device time with
their launches.  Needs a CUDA device.
"""

import argparse
import json
import subprocess
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .render import RENDER_PASSES, render_job
from .scene.loader import load_scene


def device_kernels(prof):
    """{kernel name: [launches, device microseconds]} of the kernels that
    ran inside the profile's RENDER_PASSES range (the set-up's are left
    out)."""
    events = prof.events()
    window = [e.time_range for e in events
              if e.name == RENDER_PASSES and e.device_type == torch.autograd.DeviceType.CPU]
    if len(window) != 1:
        raise RuntimeError(f"{len(window)} {RENDER_PASSES} ranges in the profile")
    lo, hi = window[0].start, window[0].end
    out = defaultdict(lambda: [0, 0.0])
    for evt in events:
        if (evt.device_type == torch.autograd.DeviceType.CUDA and evt.device_time_total > 0
                and evt.name != RENDER_PASSES  # the range's own device-side annotation
                and lo <= evt.time_range.start <= hi):
            out[evt.name][0] += 1
            out[evt.name][1] += evt.device_time_total
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_render needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    job = load_scene(args.scene)
    render_job(job, "cuda", spp_override=args.spp)
    window_ms = render_job(job, "cuda", spp_override=args.spp)["elapsed_s"] * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = render_job(job, "cuda", spp_override=args.spp)
    kernels = device_kernels(prof)
    busy_ms = sum(us for _, us in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[: args.top]
    print(json.dumps({
        "card": card, "scene": args.scene, "camera_rays": res["camera_rays"],
        "render_ms": window_ms, "profiled_render_ms": res["elapsed_s"] * 1e3,
        "device_busy_ms": busy_ms, "busy_share": busy_ms / window_ms,
        "device_launches": sum(n for n, _ in kernels.values()),
        "launches": res["launches"], "render_path": res["render_path"],
        "top": [{"kernel": name[:120], "launches": n, "ms": us / 1e3} for name, (n, us) in top],
    }, indent=1))


if __name__ == "__main__":
    main()
