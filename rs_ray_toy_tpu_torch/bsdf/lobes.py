"""Material -> lobe-table compilation (rs_ray_toy_tpu/bsdf/lobes.py).

Each material compiles at load time to a static recipe of up to
MAX_LOBES lobe rows: a kind code, three RGB spectra and four scalars.
The codes and the packed layout are the JAX package's, so a packed table
can be compared column by column, the per-lobe RGB `scale` (ScaledBxdf,
reflection.rs:516-563: Translucent's reflect / transmit, MixMaterial's
s and 1 - s) among them, and a Disney material's BSSRDF profile
(`has_bssrdf`, `bssrdf_R`, `bssrdf_d`, `bssrdf_eta`).  A lobe whose
s0 is a texture carries its record id (`s0_tex`, -1 for the constant; the
JAX package's packed_i column 6); a material's other textured parameters
are listed by name (`textured`), since no renderer of the port evaluates
them.
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np

MAX_LOBES = 8  # reference MAX_BXDFS (reflection.rs:202)

# lobe type codes
LOBE_NONE = 0
LOBE_LAMBERT_REFL = 1
LOBE_OREN_NAYAR = 2
LOBE_LAMBERT_TRANS = 3
LOBE_SPEC_REFL = 4
LOBE_SPEC_TRANS = 5
LOBE_FRESNEL_SPEC = 6
LOBE_MF_REFL = 7
LOBE_MF_TRANS = 8
LOBE_FRESNEL_BLEND = 9  # emitted by no recipe of the loader
LOBE_DEBUG_DIFFUSE = 10  # debug_material.rs: constant green diffuse
LOBE_DEBUG_SPECULAR = 11  # debug_material.rs: constant blue specular
# Disney lobes (material/disney.rs)
LOBE_DISNEY_DIFFUSE = 12
LOBE_DISNEY_FAKE_SS = 13
LOBE_DISNEY_RETRO = 14
LOBE_DISNEY_SHEEN = 15
LOBE_DISNEY_CLEARCOAT = 16
LOBE_DISNEY_MICROFACET_REFL = 17

# fresnel codes (reflection.rs:565-619)
FRESNEL_NOOP = 0
FRESNEL_DIELECTRIC = 1
FRESNEL_CONDUCTOR = 2
FRESNEL_DISNEY = 3  # disney.rs:310-333: metallic in f2, eta in f3, c_spec0 in s1

# microfacet distribution codes (microfacet.rs)
DIST_TROWBRIDGE_REITZ = 0
# TR D and lambda with Disney's separable masking-shadowing G = G1(wo) G1(wi)
# (DisneyMicrofacetDistribution, disney.rs:345-360)
DIST_DISNEY_SEPARABLE_G = 3


@dataclass
class Lobe:
    """One host-side lobe row before packing.

    Scalars by kind -- specular: f0=eta_a, f1=eta_b; microfacet:
    f0=rough_u, f1=rough_v (pre-remap), f2=eta_a, f3=eta_b; Oren-Nayar:
    f0=sigma (degrees); Disney retro and fake subsurface: f0=roughness;
    Disney clearcoat: f0=weight, f1=gloss; Disney microfacet: f0=ax,
    f1=ay, f2=metallic, f3=eta, s1=c_spec0.  `scale` multiplies the
    lobe's f (ScaledBxdf)."""

    kind: int
    s0: np.ndarray = field(default_factory=lambda: np.zeros(3))  # R/T/Rd
    s1: np.ndarray = field(default_factory=lambda: np.zeros(3))  # T/k
    s2: np.ndarray = field(default_factory=lambda: np.zeros(3))  # conductor eta
    f0: float = 0.0
    f1: float = 0.0
    f2: float = 0.0
    f3: float = 0.0
    fresnel: int = FRESNEL_NOOP
    dist: int = DIST_TROWBRIDGE_REITZ
    remap_roughness: bool = False
    sample_visible: bool = True
    scale: np.ndarray = field(default_factory=lambda: np.ones(3))
    s0_tex: int = -1  # texture record of s0, -1: the constant s0


@dataclass
class HostMaterial:
    name: str
    eta: float  # Bsdf::eta (reflection.rs:205-216); 1.0 for opaque
    lobes: List[Lobe]
    # Disney BSSRDF profile (disney.rs:585-601): albedo R and scatter
    # distance d per channel, and its eta; None without one
    bssrdf_R: object = None
    bssrdf_d: object = None
    bssrdf_eta: float = 1.0
    # textured parameters other than a lobe's s0, e.g. "ks (PlasticMaterial)"
    textured: tuple = ()


class MaterialTableBuilder:
    def __init__(self):
        self.materials: List[HostMaterial] = []

    def add(self, mat: HostMaterial) -> int:
        if len(mat.lobes) > MAX_LOBES:
            raise ValueError(f"material {mat.name}: more than {MAX_LOBES} lobes")
        self.materials.append(mat)
        return len(self.materials) - 1

    def pack(self):
        """Dict of (M, L, ...) numpy tables, L trimmed to the scene's
        deepest lobe stack (bsdf/lobes.py MaterialTableBuilder.pack)."""
        m = max(1, len(self.materials))
        n_l = max([1] + [len(mat.lobes) for mat in self.materials])
        kind = np.zeros((m, n_l), np.int32)
        s0 = np.zeros((m, n_l, 3), np.float32)
        s1 = np.zeros((m, n_l, 3), np.float32)
        s2 = np.zeros((m, n_l, 3), np.float32)
        fparams = np.zeros((m, n_l, 4), np.float32)
        fresnel = np.zeros((m, n_l), np.int32)
        dist = np.zeros((m, n_l), np.int32)
        remap = np.zeros((m, n_l), bool)
        sample_vis = np.zeros((m, n_l), bool)
        scale = np.ones((m, n_l, 3), np.float32)
        s0_tex = np.full((m, n_l), -1, np.int32)
        n_lobes = np.zeros((m,), np.int32)
        eta = np.ones((m,), np.float32)
        has_bssrdf = np.zeros((m,), bool)
        bssrdf_R = np.zeros((m, 3), np.float32)
        bssrdf_d = np.ones((m, 3), np.float32)
        bssrdf_eta = np.ones((m,), np.float32)
        for i, mat in enumerate(self.materials):
            n_lobes[i] = len(mat.lobes)
            eta[i] = mat.eta
            if mat.bssrdf_R is not None:
                has_bssrdf[i] = True
                bssrdf_R[i] = mat.bssrdf_R
                bssrdf_d[i] = np.maximum(mat.bssrdf_d, 1e-6)
                bssrdf_eta[i] = mat.bssrdf_eta
            for j, lb in enumerate(mat.lobes):
                kind[i, j] = lb.kind
                s0[i, j] = lb.s0
                s1[i, j] = lb.s1
                s2[i, j] = lb.s2
                fparams[i, j] = [lb.f0, lb.f1, lb.f2, lb.f3]
                fresnel[i, j] = lb.fresnel
                dist[i, j] = lb.dist
                remap[i, j] = lb.remap_roughness
                sample_vis[i, j] = lb.sample_visible
                scale[i, j] = lb.scale
                s0_tex[i, j] = lb.s0_tex
        return {
            "kind": kind,
            "s0": s0,
            "s1": s1,
            "s2": s2,
            "fparams": fparams,
            "fresnel": fresnel,
            "dist": dist,
            "remap": remap,
            "sample_visible": sample_vis,
            "scale": scale,
            "n_lobes": n_lobes,
            "eta": eta,
            "has_bssrdf": has_bssrdf,
            "bssrdf_R": bssrdf_R,
            "bssrdf_d": bssrdf_d,
            "bssrdf_eta": bssrdf_eta,
            "s0_tex": s0_tex,
            "textured": [mat.textured for mat in self.materials],
        }
