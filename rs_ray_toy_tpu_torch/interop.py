"""Carry the JAX package's packed scene and camera into the port.

`from_jax_packed` takes what `rs_ray_toy_tpu.ops.path_megakernel`'s
`pack_scene` / `pack_camera` return, as numpy arrays and python tuples
(no JAX object crosses over), and builds this package's PackedScene and
camera bundle.  Tests use it to feed both kernels identical tables, so a
kernel comparison does not depend on the two loaders agreeing.
"""

import numpy as np
import torch

from .ops.path_megakernel import TABLE_COLS, PackedScene
from .scene.types import LIGHT_POINT


def from_jax_packed(table_np, wide_lights, cam_packed, device):
    """table_np: the (T, 115) float32 table; wide_lights: the `lights`
    tuple of the JAX SceneStatic payload (items with .kind, .p, .emit);
    cam_packed: the JAX pack_camera dict.  Returns (PackedScene, camera
    bundle)."""
    table = np.asarray(table_np, np.float32)
    if table.ndim != 2 or table.shape[1] != TABLE_COLS:
        raise ValueError(f"expected a (T, {TABLE_COLS}) table, got {table.shape}")
    if any(int(l.kind) != LIGHT_POINT for l in wide_lights):
        raise NotImplementedError("lights other than point lights")
    packed = PackedScene(
        table=torch.as_tensor(table, device=device),
        light_p=tuple(tuple(float(v) for v in l.p) for l in wide_lights),
        light_emit=tuple(tuple(float(v) for v in l.emit) for l in wide_lights),
    )
    return packed, camera_from_jax(cam_packed)


def camera_from_jax(cam_packed):
    """The JAX pack_camera dict as this package's camera bundle."""
    return {
        k: (tuple(tuple(r) for r in v) if k == "bounds" else v)
        for k, v in dict(cam_packed).items()
    }
