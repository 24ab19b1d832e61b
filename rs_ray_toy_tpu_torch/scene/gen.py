"""Procedural mesh scenes (rs_ray_toy_tpu/scene/gen.py, grid scene).

`write_grid_scene` tiles the fixture's cube mesh into an ny x nz instance
grid about 35 units in front of the camera, through the schema's
`instances` path (renderprocess.rs:1214-1282): the first primitive of the
base scene takes the grid, the others stay.  ny = nz = 40 gives 1,600
cubes, 19,200 triangles of grid: the JAX bench's `grid` row.
"""

import json
import os
import shutil
from pathlib import Path

FIXTURE = str(Path(__file__).resolve().parents[2] / "samples" / "scene.json")
SPAN_Y, SPAN_Z = 6.0, 4.0  # extent of the grid, world units


def write_grid_scene(
    out_dir,
    ny=40,
    nz=40,
    base=FIXTURE,
    integrator="Path",
    max_depth=5,
    xres=None,
    yres=None,
):
    """Write grid.json (+ cube.obj) under out_dir; returns the json path.
    ny*nz cube instances -> 12*ny*nz triangles of grid."""
    with open(base) as fh:
        cfg = json.load(fh)
    if xres:
        cfg["Film"]["xres"] = xres
    if yres:
        cfg["Film"]["yres"] = yres
    cfg["Integrator"] = {"integrator_type": integrator, "max_depth": max_depth}
    prim = cfg["Aggregate"]["primitives"][0]
    # cube.obj spans +-1: scale so neighbours don't touch
    sy = SPAN_Y / ny
    sz = SPAN_Z / nz
    s = 0.4 * min(sy, sz)
    prim["instances"] = [
        {
            "world_pos": [35.2, -SPAN_Y / 2 + (j + 0.5) * sy, -SPAN_Z / 2 + (k + 0.5) * sz],
            "scale": [s, s, s],
            "rotation_axis": [0.0, 0.0, 1.0],
            "rotation_angle": (7 * j + 13 * k) % 90,
        }
        for j in range(ny)
        for k in range(nz)
    ]
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(os.path.dirname(base), "cube.obj")
    if os.path.exists(src):
        shutil.copy(src, out_dir)
    path = os.path.join(out_dir, "grid.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path
