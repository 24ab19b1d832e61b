"""Texture records (rs_ray_toy_tpu/scene/textures.py): the loader's
registry and the UV mapping of an image texture.

The JAX package evaluates nine texture kinds over a registry; the port
loads the two the path kernel's textured subset reads, an RGB
`ImageTexture` (TEX_IMAGE, its MIPMap in `TextureRegistry.images`) and
TEX_CONSTANT, and the loader raises on the other kinds, naming them.  The
kind and mapping codes are the JAX package's.  `map_uv` is `_map_2d`'s
UV mapping (texture/mod.rs:206-366): st = (su u + du, sv v + dv).
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np

from .mipmap import MIPMap

# texture kind codes (the JAX package's)
TEX_CONSTANT = 0
TEX_SCALE = 1
TEX_MIX = 2
TEX_BILERP = 3
TEX_IMAGE = 4
TEX_UV = 5
TEX_CHECKER2D = 6
TEX_CHECKER3D = 7
TEX_WINDY = 8
TEX_WRINKLED = 9

# 2D mapping codes (texture/mod.rs:206-366)
MAP_UV = 0
MAP_SPHERICAL = 1
MAP_CYLINDRICAL = 2
MAP_PLANAR = 3


@dataclass
class TexRecord:
    kind: int
    is_rgb: bool
    value: np.ndarray = field(default_factory=lambda: np.zeros(3))  # constant
    mapping: int = MAP_UV
    su: float = 1.0
    sv: float = 1.0
    du: float = 0.0
    dv: float = 0.0
    image_id: int = -1
    scale: float = 1.0


class TextureRegistry:
    """The loaded texture records and image MIPMaps (the JAX package's
    registry: float and RGB textures in one list, named through the
    loader's name -> id maps)."""

    def __init__(self):
        self.records: List[TexRecord] = []
        self.images: List[MIPMap] = []

    def add(self, rec: TexRecord) -> int:
        self.records.append(rec)
        return len(self.records) - 1

    def add_image(self, mip: MIPMap) -> int:
        self.images.append(mip)
        return len(self.images) - 1


def map_uv(rec, u, v):
    """(s, t) of the UV mapping at the surface uv (tensors or arrays)."""
    return rec.su * u + rec.du, rec.sv * v + rec.dv
