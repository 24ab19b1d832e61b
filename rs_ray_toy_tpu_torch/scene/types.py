"""Scene data model (rs_ray_toy_tpu/scene/types.py), host numpy SoA tables.

Triangles are instance-expanded and baked to world space at load; lights
are a typed table.  Only the slice's kinds are ported (triangles, point
lights, diffuse lights on a full sphere, homogeneous and grid media); the
constants keep the JAX package's codes.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np

# light type codes (the JAX package's; distant and infinite lights are not
# ported)
LIGHT_POINT = 0
LIGHT_DIFFUSE_AREA = 2  # on a full sphere; the triangle shape is not ported


@dataclass
class TriangleSoA:
    p0: np.ndarray  # (T,3) float32 world-space vertices
    p1: np.ndarray
    p2: np.ndarray
    # raw vertex normals, zeros where the mesh has none; flat meshes only
    # (smooth shading is not ported), carried so the packed table matches
    n0: np.ndarray  # (T,3) float32
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray  # (T,2) float32 vertex uvs, (0,0), (1,0), (1,1) by default
    uv1: np.ndarray
    uv2: np.ndarray
    mat: np.ndarray  # (T,) int32 material ids
    # ray-independent shading geometry, baked in float64 then cast
    ng: np.ndarray  # (T,3) geometric normal
    dpdu: np.ndarray  # (T,3)
    dpdv: np.ndarray  # (T,3)

    @property
    def count(self):
        return self.p0.shape[0]


@dataclass
class LightSoA:
    kind: np.ndarray  # (L,) int32 LIGHT_*
    p: np.ndarray  # (L,3) float32 point-light position (zeros for area lights)
    emit: np.ndarray  # (L,3) float32 point intensity I / area radiance L
    # diffuse sphere lights own their shape (lights/diffuse.rs); identity
    # and radius 1 on the other rows
    sph_o2w: np.ndarray  # (L,4,4) float32 object-to-world
    sph_w2o: np.ndarray  # (L,4,4) float32 its inverse
    sph_radius: np.ndarray  # (L,) float32
    area: np.ndarray  # (L,) float32 full-sphere area; 1 on the other rows
    n_samples: np.ndarray  # (L,) int32, the schema's (1 by default); no ported kernel reads it
    world_radius: np.float32  # bounding sphere of the triangles

    @property
    def count(self):
        return self.kind.shape[0]


@dataclass
class MediumSpec:
    """A participating medium as the schema states it
    (rs_ray_toy_tpu/scene/loader.py MediumSpec)."""

    kind: str  # "homogeneous" | "grid"
    sigma_a: np.ndarray  # (3,) float64
    sigma_s: np.ndarray
    g: float
    # grid only
    nx: int = 1
    ny: int = 1
    nz: int = 1
    density: Optional[np.ndarray] = None  # (nz, ny, nx)
    world_to_medium: Optional[np.ndarray] = None  # (4, 4) float64
