"""Material recipes: JSON material parameters -> lobe rows
(rs_ray_toy_tpu/bsdf/recipes.py, constant-parameter subset).

Mirrors the lobe assembly of matte.rs:35-61, plastic.rs:46-77,
metal.rs:47-95, mirror.rs:29-49, glass.rs:52-113 and
debug_material.rs:36-49.  Parameters are
constants (RGB arrays or floats); a black spectrum drops its lobe at
build time, as the reference's `!r.is_black()` gate does.  Plastic gates
its specular lobe on ks, fixing the reference's kd gate (docs/PARITY.md).
"""

import numpy as np

from .lobes import (
    DIST_TROWBRIDGE_REITZ,
    FRESNEL_CONDUCTOR,
    FRESNEL_DIELECTRIC,
    FRESNEL_NOOP,
    HostMaterial,
    Lobe,
    LOBE_DEBUG_DIFFUSE,
    LOBE_DEBUG_SPECULAR,
    LOBE_FRESNEL_SPEC,
    LOBE_LAMBERT_REFL,
    LOBE_MF_REFL,
    LOBE_MF_TRANS,
    LOBE_OREN_NAYAR,
    LOBE_SPEC_REFL,
    LOBE_SPEC_TRANS,
)


def _black(rgb):
    return bool(np.all(np.asarray(rgb) == 0.0))


def matte(name, kd, sigma) -> HostMaterial:
    """Lambert for sigma == 0, else Oren-Nayar."""
    lobes = []
    if not _black(kd):
        if sigma == 0.0:
            lobes.append(Lobe(LOBE_LAMBERT_REFL, s0=kd))
        else:
            lobes.append(Lobe(LOBE_OREN_NAYAR, s0=kd, f0=np.clip(sigma, 0.0, 90.0)))
    return HostMaterial(name, 1.0, lobes)


def plastic(name, kd, ks, roughness, remap) -> HostMaterial:
    """Lambert(kd) + TR microfacet(ks, FresnelDielectric(1.5, 1.0))."""
    lobes = []
    if not _black(kd):
        lobes.append(Lobe(LOBE_LAMBERT_REFL, s0=kd))
    if not _black(ks):
        lobes.append(
            Lobe(
                LOBE_MF_REFL,
                s0=ks,
                f0=roughness,
                f1=roughness,
                f2=1.5,
                f3=1.0,
                fresnel=FRESNEL_DIELECTRIC,
                dist=DIST_TROWBRIDGE_REITZ,
                remap_roughness=remap,
            )
        )
    return HostMaterial(name, 1.0, lobes)


def metal(name, eta, k, u_roughness, v_roughness, remap) -> HostMaterial:
    """Single TR microfacet conductor lobe with R = 1."""
    lobe = Lobe(
        LOBE_MF_REFL,
        s0=np.ones(3),
        s1=k,  # conductor k
        s2=eta,  # conductor eta_t (eta_i = 1)
        f0=u_roughness,
        f1=v_roughness,
        fresnel=FRESNEL_CONDUCTOR,
        dist=DIST_TROWBRIDGE_REITZ,
        remap_roughness=remap,
    )
    return HostMaterial(name, 1.0, [lobe])


def mirror(name, kr) -> HostMaterial:
    """Specular reflection with FresnelNoOp."""
    lobes = []
    if not _black(kr):
        lobes.append(Lobe(LOBE_SPEC_REFL, s0=kr, fresnel=FRESNEL_NOOP))
    return HostMaterial(name, 1.0, lobes)


def glass(name, kr, kt, u_roughness, v_roughness, eta, remap, allow_multiple_lobes):
    """glass.rs:52-113: one FresnelSpecular lobe for smooth glass under
    the Path integrator, else separate reflect / transmit lobes."""
    lobes = []
    is_specular = u_roughness == 0.0 and v_roughness == 0.0
    if _black(kr) and _black(kt):
        return HostMaterial(name, eta, [])
    if is_specular and allow_multiple_lobes:
        lobes.append(Lobe(LOBE_FRESNEL_SPEC, s0=kr, s1=kt, f0=1.0, f1=eta))
        return HostMaterial(name, eta, lobes)
    if not _black(kr):
        if is_specular:
            lobes.append(
                Lobe(LOBE_SPEC_REFL, s0=kr, fresnel=FRESNEL_DIELECTRIC, f0=1.0, f1=eta)
            )
        else:
            lobes.append(
                Lobe(
                    LOBE_MF_REFL, s0=kr, f0=u_roughness, f1=v_roughness,
                    f2=1.0, f3=eta, fresnel=FRESNEL_DIELECTRIC,
                    remap_roughness=remap,
                )
            )
    if not _black(kt):
        if is_specular:
            lobes.append(Lobe(LOBE_SPEC_TRANS, s0=kt, f0=1.0, f1=eta))
        else:
            lobes.append(
                Lobe(
                    LOBE_MF_TRANS, s0=kt, f0=u_roughness, f1=v_roughness,
                    f2=1.0, f3=eta, remap_roughness=remap,
                )
            )
    return HostMaterial(name, eta, lobes)


def debug(name) -> HostMaterial:
    """debug_material.rs:36-49: fixed green-diffuse + blue-specular lobes."""
    return HostMaterial(
        name,
        1.0,
        [
            Lobe(LOBE_DEBUG_DIFFUSE, s0=np.array([0.0, 1.0, 0.0])),
            Lobe(LOBE_DEBUG_SPECULAR, s0=np.array([0.0, 0.0, 1.0])),
        ],
    )
