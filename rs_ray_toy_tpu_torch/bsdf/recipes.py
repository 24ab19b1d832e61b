"""Material recipes: JSON material parameters -> lobe rows
(rs_ray_toy_tpu/bsdf/recipes.py, constant-parameter subset).

Mirrors the lobe assembly of matte.rs:35-61, plastic.rs:46-77,
metal.rs:47-95, mirror.rs:29-49, glass.rs:52-113, translucent.rs:52-108,
mixmat.rs:33-61, disney.rs:530-676 and debug_material.rs:36-49.  Parameters are
constants (RGB arrays or floats), but for a matte's kd, which may be a
texture record (`kd_tex`); a black spectrum drops its lobe at
build time, as the reference's `!r.is_black()` gate does.  Plastic gates
its specular lobe on ks, fixing the reference's kd gate (docs/PARITY.md).
"""

import copy

import numpy as np

from .lobes import (
    DIST_DISNEY_SEPARABLE_G,
    DIST_TROWBRIDGE_REITZ,
    FRESNEL_CONDUCTOR,
    FRESNEL_DIELECTRIC,
    FRESNEL_DISNEY,
    FRESNEL_NOOP,
    MAX_LOBES,
    HostMaterial,
    Lobe,
    LOBE_DEBUG_DIFFUSE,
    LOBE_DEBUG_SPECULAR,
    LOBE_DISNEY_CLEARCOAT,
    LOBE_DISNEY_DIFFUSE,
    LOBE_DISNEY_FAKE_SS,
    LOBE_DISNEY_MICROFACET_REFL,
    LOBE_DISNEY_RETRO,
    LOBE_DISNEY_SHEEN,
    LOBE_FRESNEL_SPEC,
    LOBE_LAMBERT_REFL,
    LOBE_LAMBERT_TRANS,
    LOBE_MF_REFL,
    LOBE_MF_TRANS,
    LOBE_OREN_NAYAR,
    LOBE_SPEC_REFL,
    LOBE_SPEC_TRANS,
)


def _black(rgb):
    return bool(np.all(np.asarray(rgb) == 0.0))


def matte(name, kd, sigma, kd_tex=-1) -> HostMaterial:
    """Lambert for sigma == 0, else Oren-Nayar; kd_tex >= 0: kd is that
    texture record (its constant then zeros, never black)."""
    lobes = []
    if kd_tex >= 0 or not _black(kd):
        if sigma == 0.0:
            lobes.append(Lobe(LOBE_LAMBERT_REFL, s0=kd, s0_tex=kd_tex))
        else:
            lobes.append(Lobe(LOBE_OREN_NAYAR, s0=kd, f0=np.clip(sigma, 0.0, 90.0),
                              s0_tex=kd_tex))
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


def translucent(name, kd, ks, roughness, reflect, transmit, remap) -> HostMaterial:
    """translucent.rs:52-108: eta fixed at 1.5; reflect and transmit ride
    in the lobes' scale."""
    lobes = []
    e = 1.5
    if _black(reflect) and _black(transmit):
        return HostMaterial(name, e, [])
    if not _black(kd):
        if not _black(reflect):
            lobes.append(Lobe(LOBE_LAMBERT_REFL, s0=kd, scale=reflect))
        if not _black(transmit):
            lobes.append(Lobe(LOBE_LAMBERT_TRANS, s0=kd, scale=transmit))
    if not _black(ks):
        if not _black(reflect):
            lobes.append(
                Lobe(
                    LOBE_MF_REFL, s0=ks, f0=roughness, f1=roughness, f2=1.0, f3=e,
                    fresnel=FRESNEL_DIELECTRIC, remap_roughness=remap, scale=reflect,
                )
            )
        if not _black(transmit):
            lobes.append(
                Lobe(
                    LOBE_MF_TRANS, s0=ks, f0=roughness, f1=roughness, f2=1.0, f3=e,
                    remap_roughness=remap, scale=transmit,
                )
            )
    return HostMaterial(name, e, lobes)


def mix(name, m1, m2, scale) -> HostMaterial:
    """mixmat.rs:33-61: m1's lobes scaled by s, m2's by 1 - s (each clamped
    at 0), the first MAX_LOBES kept."""
    lobes = []
    for mat, s in ((m1, scale), (m2, 1.0 - scale)):
        for lb in mat.lobes:
            lb = copy.deepcopy(lb)
            lb.scale = lb.scale * np.clip(s, 0.0, np.inf)
            lobes.append(lb)
    return HostMaterial(name, 1.0, lobes[:MAX_LOBES], textured=m1.textured + m2.textured)


def disney(name, color, metallic, eta, roughness, specular_tint, anisotropic, sheen,
           sheen_tint, clearcoat, clearcoat_gloss, spec_trans, thin, flatness,
           diff_trans, scatter_distance) -> HostMaterial:
    """Disney BSDF lobe assembly (disney.rs:530-676), constant parameters.
    A material that is not thin and has a positive scatter distance
    carries the Burley BSSRDF (disney.rs:585-601): a specular transmission
    lobe takes the diffuse lobe's place, and the material keeps the
    profile's albedo (the color times the diffuse weight), scatter
    distance (a fifth of scatter_distance) and eta."""
    lobes = []
    c = np.clip(color, 0.0, np.inf)
    mw, e, strans, dt, rough = metallic, eta, spec_trans, diff_trans, roughness
    # diff_trans defaults to 1 (renderprocess.rs:836)
    diffuse_weight = (1.0 - mw) * (1.0 - strans)
    lum = float(0.212671 * c[0] + 0.715160 * c[1] + 0.072169 * c[2])
    c_tint = c / lum if lum > 0 else np.ones(3)
    c_sheen = (1.0 - sheen_tint) * np.ones(3) + sheen_tint * c_tint if sheen > 0 else np.zeros(3)
    sd = np.clip(scatter_distance, 0.0, np.inf)
    has_bssrdf = (not thin) and bool(np.any(sd > 0.0))

    if diffuse_weight > 0:
        if thin:
            lobes.append(Lobe(LOBE_DISNEY_DIFFUSE,
                              s0=c * diffuse_weight * (1 - flatness) * (1 - dt)))
            lobes.append(Lobe(LOBE_DISNEY_FAKE_SS, s0=c * diffuse_weight * flatness * (1 - dt),
                              f0=rough))
        elif has_bssrdf:
            lobes.append(Lobe(LOBE_SPEC_TRANS, s0=np.ones(3), f0=1.0, f1=e))
        else:
            lobes.append(Lobe(LOBE_DISNEY_DIFFUSE, s0=c * diffuse_weight))
        lobes.append(Lobe(LOBE_DISNEY_RETRO, s0=c * diffuse_weight, f0=rough))
        if sheen > 0:
            lobes.append(Lobe(LOBE_DISNEY_SHEEN, s0=c_sheen * sheen * diffuse_weight))

    aspect = np.sqrt(1.0 - anisotropic * 0.9)
    ax = max(rough**2 / aspect, 0.001)
    ay = max(rough**2 * aspect, 0.001)
    r0_eta = ((e - 1.0) / (e + 1.0)) ** 2
    c_spec0 = (1.0 - mw) * (((1.0 - specular_tint) * np.ones(3) + specular_tint * c_tint)
                            * r0_eta) + mw * c
    lobes.append(
        Lobe(
            LOBE_DISNEY_MICROFACET_REFL, s0=np.ones(3), s1=c_spec0, f0=ax, f1=ay, f2=mw, f3=e,
            fresnel=FRESNEL_DISNEY, dist=DIST_DISNEY_SEPARABLE_G,
        )
    )
    if clearcoat > 0:
        gloss = (1.0 - clearcoat_gloss) * 0.1 + clearcoat_gloss * 0.001
        lobes.append(Lobe(LOBE_DISNEY_CLEARCOAT, f0=clearcoat, f1=gloss))
    if strans > 0:
        t = np.sqrt(np.maximum(c, 0.0)) * strans
        if thin:
            rs = (0.65 * e - 0.35) * rough
            axs = max(rs**2 / aspect, 0.001)
            ays = max(rs**2 * aspect, 0.001)
            lobes.append(Lobe(LOBE_MF_TRANS, s0=t, f0=axs, f1=ays, f2=1.0, f3=e,
                              dist=DIST_TROWBRIDGE_REITZ))
        else:
            lobes.append(Lobe(LOBE_MF_TRANS, s0=t, f0=ax, f1=ay, f2=1.0, f3=e,
                              dist=DIST_DISNEY_SEPARABLE_G))
    if thin:
        lobes.append(Lobe(LOBE_LAMBERT_TRANS, s0=c * dt))
    if not has_bssrdf:
        return HostMaterial(name, 1.0, lobes)
    return HostMaterial(name, 1.0, lobes, bssrdf_R=c * diffuse_weight, bssrdf_d=sd * 0.2,
                        bssrdf_eta=e)


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
