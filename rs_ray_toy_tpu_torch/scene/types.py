"""Scene data model (rs_ray_toy_tpu/scene/types.py), host numpy SoA tables.

Triangles are instance-expanded and baked to world space at load;
spheres keep their object-to-world transforms, since partial-sphere clips
(z_min, z_max, phi_max) happen in object space (shape/sphere.rs); lights
are a typed table.  The kinds are the JAX package's: triangles, spheres,
point, distant, diffuse (on a sphere or one triangle) and infinite lights,
homogeneous and grid media; the constants keep its codes.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np

# light type codes (the JAX package's)
LIGHT_POINT = 0
LIGHT_DISTANT = 1
LIGHT_DIFFUSE_AREA = 2
LIGHT_INFINITE = 3

# area-light shape codes (diffuse lights sample a sphere or one triangle,
# renderprocess.rs:999-1017)
AREA_SHAPE_NONE = -1
AREA_SHAPE_SPHERE = 0
AREA_SHAPE_TRIANGLE = 1


@dataclass
class TriangleSoA:
    p0: np.ndarray  # (T,3) float32 world-space vertices
    p1: np.ndarray
    p2: np.ndarray
    # raw vertex normals (world space, unnormalised), zeros where the mesh
    # has none; shading interpolates them where has_n
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
    has_n: np.ndarray  # (T,) bool: the mesh gave vertex normals
    # the primitive's medium_interface: medium ids inside and outside, -1
    # for none
    med_in: np.ndarray  # (T,) int32
    med_out: np.ndarray  # (T,) int32

    @property
    def count(self):
        return self.p0.shape[0]


@dataclass
class SphereSoA:
    o2w: np.ndarray  # (S,4,4) float32 object-to-world
    w2o: np.ndarray  # (S,4,4) float32 its inverse
    radius: np.ndarray  # (S,) float32
    z_min: np.ndarray  # (S,) float32, clipped to [-radius, radius]
    z_max: np.ndarray
    theta_min: np.ndarray  # (S,) float32 arccos(z_min / radius)
    theta_max: np.ndarray
    phi_max: np.ndarray  # (S,) float32 radians
    mat: np.ndarray  # (S,) int32 material ids
    med_in: np.ndarray  # (S,) int32, as TriangleSoA's
    med_out: np.ndarray  # (S,) int32

    @property
    def count(self):
        return self.radius.shape[0]


def media_rows(soa):
    """(n, 2) int64 [med_in, med_out] of a triangle or sphere table; (0, 2)
    for None (no spheres)."""
    if soa is None:
        return np.full((0, 2), -1, np.int64)
    return np.stack([soa.med_in, soa.med_out], -1).astype(np.int64).reshape(-1, 2)


def has_interfaces(tri, sph):
    """Whether some triangle or sphere has a medium_interface."""
    return any(bool((media_rows(soa) >= 0).any()) for soa in (tri, sph))


@dataclass
class LightSoA:
    kind: np.ndarray  # (L,) int32 LIGHT_*
    p: np.ndarray  # (L,3) float32 point-light position (zeros for the others)
    # point intensity I / distant, area or infinite radiance L (* scale)
    emit: np.ndarray  # (L,3) float32
    w_light: np.ndarray  # (L,3) float32 distant-light direction (normalized)
    shape_kind: np.ndarray  # (L,) int32 AREA_SHAPE_* of diffuse lights
    # (L,) int32: an infinite light's entry in the scene's environment list
    shape_index: np.ndarray
    # diffuse lights own their shape (lights/diffuse.rs); identity and
    # radius 1 (zeros for tri_p) on the other rows
    sph_o2w: np.ndarray  # (L,4,4) float32 object-to-world
    sph_w2o: np.ndarray  # (L,4,4) float32 its inverse
    sph_radius: np.ndarray  # (L,) float32
    tri_p: np.ndarray  # (L,3,3) float32 a triangle light's world vertices
    area: np.ndarray  # (L,) float32 the shape's area (a sphere's full area); 1 elsewhere
    n_samples: np.ndarray  # (L,) int32, the schema's (1 by default); the all-lights strategy reads it
    world_radius: np.float32  # bounding sphere of the triangles and spheres

    @property
    def count(self):
        return self.kind.shape[0]


@dataclass
class EnvLight:
    """An infinite light's environment (lights/infinite.rs:34-112) on a
    constant map: the texel radiance (the map's, not the light's `l`),
    its Distribution2D over luminance * sin(theta) (core/sampling), the
    light-to-world transform and its inverse, and whether escaped rays
    collect it (it stood in `infinite_lights`)."""

    rgb: np.ndarray  # (3,) float32 texel radiance
    dist: object  # core.sampling.Distribution2D
    to_world: np.ndarray  # (4,4) float32
    to_local: np.ndarray  # (4,4) float32
    escape_le: bool


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
