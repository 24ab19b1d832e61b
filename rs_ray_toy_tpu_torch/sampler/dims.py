"""Sampler dimension layout (rs_ray_toy_tpu/sampler/dims.py).

Slots 0-7 belong to the camera sample (0: film jitter 2d, 1: lens 2d);
the Path integrator uses a block of PATH_DPB slots per bounce starting at
path_dim0(bounce), Volpath a block of VOLPATH_DPB at volpath_dim0(bounce),
the SPPM camera walk a block of SPPM_DPB at sppm_dim0(depth); AO's probe
k reads ao_dim(k).
Only the slots of the ported integrators are listed.
"""

INTEGRATOR_DIM0 = 8  # dims 0-7 reserved for the camera sample
CAMERA_FILM = 0  # 2d
CAMERA_LENS = 1  # 2d

PATH_DPB = 11
PATH_NEE = 0  # +0 light pick (1d); +1/+2 light and counter samples (2d)
PATH_BSDF = 3  # 2d
PATH_RR = 4  # 1d
# the BSSRDF branch of a bounce that transmits into a subsurface material
PATH_BSS_PROBE_1D = 5  # projection axis, channel and pick (1d)
PATH_BSS_PROBE_2D = 6  # radius and angle of the probe (2d)
PATH_BSS_PICK = 7  # the exit point's light pick (1d)
PATH_BSS_LIGHT = 8  # the exit point's light sample (2d)
PATH_BSS_OUT = 9  # the exit direction (2d)


def path_dim0(bounce: int) -> int:
    return INTEGRATOR_DIM0 + bounce * PATH_DPB


VOLPATH_DPB = 8
VOL_PICK = 0  # light pick (1d)
VOL_LIGHT = 1  # light sample (2d)
VOL_SCATTER = 2  # the scattering sample of NEE (2d; read when some light is not delta)
VOL_NEXT = 3  # phase or BSDF sample of the next direction (2d)
VOL_RR = 4  # Russian roulette (1d)


def volpath_dim0(bounce: int) -> int:
    return INTEGRATOR_DIM0 + bounce * VOLPATH_DPB


SPPM_DPB = 8
SPPM_NEE = 0  # light pick (1d); +1/+2 are unread (delta lights only)
SPPM_BSDF = 5  # BSDF sample of the next direction (2d)
SPPM_RR = 6  # camera-path Russian roulette (1d)


def sppm_dim0(depth: int) -> int:
    return INTEGRATOR_DIM0 + depth * SPPM_DPB


def ao_dim(k: int) -> int:
    """AO's probe k reads its 2D value here (ao.rs: dims 8 + k, k < n_samples)."""
    return INTEGRATOR_DIM0 + k
