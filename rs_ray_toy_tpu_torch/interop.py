"""Carry the JAX package's packed scene and camera into the port.

`from_jax_packed` takes what `rs_ray_toy_tpu.ops.path_megakernel`'s
`pack_scene` / `pack_camera` return, as numpy arrays and python tuples
(no JAX object crosses over), and builds this package's PackedScene
(with the sphere rows, sphere-light rows, environment constants,
escape radiance and subsurface constants of the JAX SceneStatic when it
is given) and camera
bundle; `from_jax_volpath` does the same for the Volpath kernel's
`pack_volpath` (its light constants, medium and power distribution, and
the grid density as numpy); `from_jax_sppm` carries the SPPM pieces (the
packed table, the resolved material tables, visible points, state,
photon lights and rays); `from_jax_scene_ctx` builds the wavefront
loop's SceneCtx from a JAX SceneCtx's triangle and sphere SoAs (smooth
vertex normals included), packed triangles, material table (with each
lobe's scale and distribution code, and the BSSRDF profiles), lights,
environments, media (its packed medium table, camera medium, each
triangle's and sphere's interface ids and the lights' power
distribution) and (optionally) its BVH kernel tables; `sampler_from_jax`
builds the port's HaltonSampler with a JAX HaltonSampler's spec and
seed; `registry_from_jax` the texture registry of a JAX loader's (its
records' kinds, UV mapping and scale, and each image's exact MIPMap
levels, not the packed coarse pyramid), and `texture_from_jax` the
path kernel's TexC of one of its records.  Tests use
them to feed both packages identical tables, so a comparison does not
depend on the two loaders agreeing.
"""

from types import SimpleNamespace

import numpy as np
import torch

from .accel.bvh import pack_node64_tables, tree4_depth
from .accel.geometry import pack_shade_tables, sphere_tables
from .integrators.common import SceneCtx, bssrdf_tables, material_rows, prim_media
from .integrators.sppm import PhotonLights, SPPMState
from .lights.lights import light_table
from .ops import bvh_kernel as bk
from .ops import sppm_megakernel as smk
from .ops.path_megakernel import (
    SPH_O2W_COL,
    SPH_RADIUS_COL,
    TABLE_COLS,
    BssrdfC,
    EnvC,
    PackedScene,
    TexC,
    kinds_present,
)
from .ops.volpath_megakernel import PackedVolpath
from .sampler.halton import HaltonSampler
from .scene.loader import SamplerSpec
from .scene.mipmap import MIPMap, pyramid
from .scene.textures import TEX_CONSTANT, TEX_IMAGE, TexRecord, TextureRegistry
from .scene.types import LIGHT_DIFFUSE_AREA, LIGHT_INFINITE, LIGHT_POINT, MediumSpec
from .scene import medium as med

_ROT9 = (0, 1, 2, 4, 5, 6, 8, 9, 10)  # the 3x3 of 12 rows


def _sphere_rows(spheres):
    """(S, TABLE_COLS) rows of the JAX SphereC tuple (w2o / o2w 12 rows,
    radius, n_lobes, mat_eta, LobeC lobes), or None."""
    if not spheres:
        return None
    rows = np.zeros((len(spheres), TABLE_COLS), np.float32)
    for i, s in enumerate(spheres):
        rows[i, 0:12] = s.w2o
        rows[i, SPH_RADIUS_COL] = s.radius
        rows[i, 15] = s.n_lobes
        rows[i, 31] = s.mat_eta
        for l, lob in enumerate(s.lobes):
            b = 16 + 16 * l
            rows[i, b] = lob.kind
            rows[i, b + 1:b + 4], rows[i, b + 4:b + 7], rows[i, b + 7:b + 10] = lob.s0, lob.s1, lob.s2
            rows[i, b + 10:b + 15] = lob.au, lob.av, lob.fres, lob.eta_a, lob.eta_b
        rows[i, SPH_O2W_COL:SPH_O2W_COL + 12] = s.o2w
    return rows


def from_jax_packed(table_np, wide_lights, cam_packed, device, wide=None):
    """table_np: the (T, 115) float32 table; wide_lights: the `lights`
    tuple of the JAX SceneStatic payload (items with .kind, .p, .emit,
    and for sphere lights .o2w / .w2o 12 rows and .radius, for the
    environment .env, an EnvC); cam_packed: the JAX pack_camera dict or
    None; wide: the whole SceneStatic (its spheres, escape radiance and
    world radius), or None for a point-light scene.  Returns (PackedScene,
    camera bundle)."""
    table = np.asarray(table_np, np.float32)
    if table.ndim != 2 or table.shape[1] != TABLE_COLS:
        raise ValueError(f"expected a (T, {TABLE_COLS}) table, got {table.shape}")
    kinds = tuple(int(l.kind) for l in wide_lights)
    if wide is None and any(k != LIGHT_POINT for k in kinds):
        raise NotImplementedError("lights other than point lights without the SceneStatic")
    eye12 = (1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)
    more = {}
    if wide is not None:
        env = next((l.env for l in wide_lights if int(l.kind) == LIGHT_INFINITE), None)
        sph = _sphere_rows(wide.spheres)
        rows_all = table if sph is None else np.concatenate([table, sph])
        more = dict(
            sph_table=None if sph is None else torch.as_tensor(sph, device=device),
            kinds_present=kinds_present(rows_all),
            light_kind=kinds,
            light_o2w=tuple(tuple(l.o2w) if l.o2w is not None else eye12 for l in wide_lights),
            light_w2o=tuple(tuple(l.w2o[i] for i in _ROT9) if l.w2o is not None
                            else (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
                            for l in wide_lights),
            light_radius=tuple(float(l.radius) for l in wide_lights),
            env=None if env is None else EnvC(*(getattr(env, f) for f in EnvC._fields)),
            esc_rgb=None if wide.esc_rgb is None else tuple(wide.esc_rgb),
            world_radius=float(wide.world_radius),
            smooth=bool(wide.smooth),
            bssrdf=None if wide.bssrdf is None else BssrdfC(*wide.bssrdf),
        )
    packed = PackedScene(
        table=torch.as_tensor(table, device=device),
        light_p=tuple(tuple(float(v) for v in l.p) for l in wide_lights),
        light_emit=tuple(tuple(float(v) for v in l.emit) for l in wide_lights),
        **more,
    )
    return packed, None if cam_packed is None else camera_from_jax(cam_packed)


def registry_from_jax(registry):
    """The port's TextureRegistry of a JAX TextureRegistry: TEX_IMAGE and
    TEX_CONSTANT records (kind, value, mapping, su, sv, du, dv, image id,
    scale) and every image's MIPMap levels, wrap and filter settings."""
    out = TextureRegistry()
    for m in registry.images:
        out.add_image(MIPMap([np.asarray(lv, np.float32) for lv in m.levels], int(m.wrap),
                             bool(m.do_trilinear), float(m.max_aniso)))
    for r in registry.records:
        if r.kind not in (TEX_IMAGE, TEX_CONSTANT):
            raise NotImplementedError(f"texture kind {r.kind}")
        out.add(TexRecord(kind=int(r.kind), is_rgb=bool(r.is_rgb), value=np.asarray(r.value),
                          mapping=int(r.mapping), su=float(r.su), sv=float(r.sv),
                          du=float(r.du), dv=float(r.dv), image_id=int(r.image_id),
                          scale=float(r.scale)))
    return out


def texture_from_jax(registry, record_id, device):
    """The path kernel's TexC (ops/path_megakernel) of record `record_id`
    of a JAX TextureRegistry, the pyramid on `device`."""
    reg = registry_from_jax(registry)
    rec = reg.records[record_id]
    return TexC(pyramid(reg.images[rec.image_id], device), rec)


def sampler_from_jax(sampler, xres, yres):
    """The port's HaltonSampler with a JAX HaltonSampler's sample count,
    sample_at_center and seed (the same digit permutations) on an xres x
    yres film."""
    spec = SamplerSpec("halton", nsamp=int(sampler.spp),
                       sample_at_center=bool(sampler.sample_at_center))
    return HaltonSampler(spec, xres, yres, seed=int(sampler.seed))


def camera_from_jax(cam_packed):
    """The JAX pack_camera dict as this package's camera bundle."""
    return {
        k: (tuple(tuple(r) for r in v) if k == "bounds" else v)
        for k, v in dict(cam_packed).items()
    }


def from_jax_volpath(table_np, wide_lights, vol_static, density_np, device):
    """table_np and wide_lights as for from_jax_packed (point and sphere
    lights; a sphere light's o2w / w2o are 12-float 3x4 rows, its radius
    a float); vol_static: the JAX VolStatic (medium = MediumC, with GridC
    for a grid), density_np: the (nz, ny, nx) grid or None.  Returns the
    port's PackedVolpath."""
    table = np.array(table_np, np.float32)  # a writable copy of the JAX buffer
    if table.ndim != 2 or table.shape[1] != TABLE_COLS:
        raise ValueError(f"expected a (T, {TABLE_COLS}) table, got {table.shape}")
    kinds =tuple(int(l.kind) for l in wide_lights)
    if any(k not in (LIGHT_POINT, LIGHT_DIFFUSE_AREA) for k in kinds):
        raise NotImplementedError("lights other than point and sphere lights")
    eye12 = (1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)
    rows12 = [tuple(l.o2w) if l.o2w is not None else eye12 for l in wide_lights]
    w2o9 = [
        tuple(l.w2o[i] for i in (0, 1, 2, 4, 5, 6, 8, 9, 10)) if l.w2o is not None
        else (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
        for l in wide_lights
    ]
    m = vol_static.medium
    gr = m.grid
    spec = MediumSpec("homogeneous", np.asarray(m.sigma_a), np.asarray(m.sigma_s), m.g)
    if gr is not None:
        w2m = np.eye(4)
        w2m[:3, :4] = np.asarray(gr.w2m).reshape(3, 4)
        spec = MediumSpec(
            "grid", spec.sigma_a, spec.sigma_s, m.g, gr.nx, gr.ny, gr.nz,
            np.asarray(density_np, np.float32).reshape(gr.nz, gr.ny, gr.nx), w2m,
        )
    return PackedVolpath(
        scene=PackedScene(
            table=torch.as_tensor(table, device=device),
            light_p=tuple(tuple(float(v) for v in l.p) for l in wide_lights),
            light_emit=tuple(tuple(float(v) for v in l.emit) for l in wide_lights),
            kinds_present=kinds_present(table),
        ),
        medium=med.pack_mediums([spec], device),
        light_kind=kinds,
        sph_o2w=tuple(rows12),
        sph_w2o=tuple(w2o9),
        sph_radius=tuple(float(l.radius) for l in wide_lights),
        cdf=tuple(vol_static.cdf),
        pick_pdf=tuple(vol_static.pick_pdf),
        world_radius=float(vol_static.world_radius),
    )


def from_jax_sppm(device, packed=None, resolved=None, vp=None, state=None, power=None,
                  photons=None):
    """The JAX SPPM pieces that are given, as numpy, into the port: packed
    (JAX pack_sppm(ctx): its table and point lights), resolved
    (resolve_mat_tables(ctx), a dict of arrays), vp (a JAX VisiblePoints;
    ns is ng in the kernels' flat subset), state (an SPPMState), power
    (ctx._power_distribution, with packed's lights), photons (a tuple of
    arrays, kept in order).  Returns a dict of the port's counterparts
    under the same keys ("lights" for power)."""
    t = lambda a: torch.as_tensor(np.array(a), device=device)
    out = {}
    if packed is not None:
        table = np.array(packed[0], np.float32)
        out["packed"] = PackedScene(
            table=t(table),
            light_p=tuple(tuple(float(v) for v in p) for p in packed[1]),
            light_emit=tuple(tuple(float(v) for v in e) for e in packed[2]),
            kinds_present=kinds_present(table),
        )
    if resolved is not None:
        out["resolved"] = smk.mat_table({k: np.asarray(v) for k, v in resolved.items()}, device)
    if vp is not None:
        out["vp"] = smk.VisiblePoints(t(vp.p), t(vp.wo), t(vp.beta), t(vp.mat).to(torch.int64),
                                      t(vp.ng), t(vp.dpdu), t(vp.valid))
    if state is not None:
        out["state"] = SPPMState(*(t(x) for x in state))
    if power is not None:
        lp = out["packed"]
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        out["lights"] = PhotonLights(f32(lp.light_p), f32(lp.light_emit),
                                     {k: t(v) for k, v in power.items()})
    if photons is not None:
        out["photons"] = tuple(t(x) for x in photons)
    return out


MAT_KEYS = ("kind", "s0", "s1", "s2", "fparams", "remap", "fresnel", "n_lobes", "eta", "scale",
            "dist", "has_bssrdf", "bssrdf_R", "bssrdf_d", "bssrdf_eta")


def _env_from_jax(env, rgb, device):
    """The port's device environment of a JAX infinite_envs entry (its
    `dist` device dict, to_world, to_local, escape_le) with the constant
    texel `rgb`."""
    f = lambda v: torch.tensor(np.array(v, np.float32), device=device)
    dist = env["dist"]
    return {
        "rgb": f(rgb),
        "dist": {k: f(dist[k]) for k in ("cond_func", "cond_cdf", "cond_int")}
        | {"marginal": {k: f(v) for k, v in dist["marginal"].items()}},
        "to_world": f(np.asarray(env["to_world"])[:3, :3]),
        "to_local": f(np.asarray(env["to_local"])[:3, :3]),
        "escape_le": bool(env.get("escape_le", False)),
    }


def from_jax_scene_ctx(ctx, device, bvh_tables=None, env_rgb=()):
    """The port's SceneCtx on a JAX SceneCtx's tables, read as numpy: its
    triangle and sphere SoAs (ctx.tri, ctx.sph), packed triangles
    (ctx.tri_packed), material table (ctx.mats), lights (ctx.lights) and
    environments (ctx.infinite_envs, with env_rgb the constant texel of
    each).  bvh_tables: the dict of the JAX package's pack_bvh_tables
    (nodes2_f, nodes_i, prims_f, prims_i, shade_f with flat or smooth
    rows, max_leaf, depth, and the BVH4's nodes4_f, nodes4_i) for a BVH
    context, None for brute force; its closest-hit and any-hit queries
    walk the binary tree as the loop does (over the node64 rows built from
    nodes2_f and nodes_i; `_replace(wide=True)`: the BVH4)."""
    a = np.asarray
    tri = ctx.tri
    if len(env_rgb) != len(ctx.infinite_envs):
        raise ValueError("env_rgb needs the constant texel of every environment")
    soa = SimpleNamespace(
        **{k: a(getattr(tri, k)) for k in ("p0", "p1", "p2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                                           "dpdu", "dpdv", "ng", "mat")},
        has_n=a(tri.has_n).astype(bool),
        count=int(tri.count),
    )
    sph = ctx.sph
    sph_ns = SimpleNamespace(
        **{k: a(getattr(sph, k)) for k in ("o2w", "w2o", "radius", "z_min", "z_max", "theta_min",
                                           "theta_max", "phi_max", "mat")},
        count=int(sph.count),
    )
    shade = pack_shade_tables(soa, device, sphere_tables(sph_ns, device))
    shade["tri_i"][:, 2] = torch.as_tensor(np.array(tri.area_light, np.int64), device=device)
    bvh = None
    if bvh_tables is not None:
        t = lambda k, dt: torch.as_tensor(np.array(a(bvh_tables[k]), dt), device=device)
        nodes64 = pack_node64_tables(a(bvh_tables["nodes2_f"]), a(bvh_tables["nodes_i"]))
        bvh = bk.BvhTables(
            t("nodes2_f", np.float32), t("nodes_i", np.int32), t("prims_f", np.float32),
            t("prims_i", np.int32), t("shade_f", np.float32), int(bvh_tables["max_leaf"]),
            int(bvh_tables["depth"]), t("nodes4_f", np.float32), t("nodes4_i", np.int32),
            tree4_depth(np.asarray(bvh_tables["nodes4_i"])),
            nodes64=torch.as_tensor(nodes64, device=device),
        )
    mats = {k: a(ctx.mats[k]) for k in MAT_KEYS}
    lt = ctx.lights
    n = int(lt.count)
    lights = light_table(
        a(lt.kind), a(lt.p), a(lt.emit), a(lt.sph_o2w)[:, :3, :4].reshape(n, 12),
        a(lt.sph_w2o)[:, :3, :3].reshape(n, 9), a(lt.sph_radius), device,
        w=a(lt.w_light), shape_kind=a(lt.shape_kind), tri_p=a(lt.tri_p).reshape(n, 9),
        area=a(lt.area), w2o_t=a(lt.sph_w2o)[:, :3, 3], shape_index=a(lt.shape_index),
        world_radius=float(a(lt.world_radius)), n_samples=a(lt.n_samples),
        envs=tuple(_env_from_jax(e, rgb, device) for e, rgb in zip(ctx.infinite_envs, env_rgb)),
    )
    for ns, src in ((soa, tri), (sph_ns, sph)):
        ns.med_in, ns.med_out = a(src.med_in), a(src.med_out)
    mediums = None
    if ctx.mediums is not None:
        mediums = {k: v if isinstance(v, int) else torch.as_tensor(np.array(a(v)), device=device)
                   for k, v in ctx.mediums.items()}
    dist = ctx._power_distribution
    return SceneCtx(
        tri_packed=torch.as_tensor(np.array(a(ctx.tri_packed), np.float32).reshape(-1, 12)
                                   if tri.count else np.zeros((0, 12), np.float32), device=device),
        shade=shade,
        mat_rows=material_rows(mats, device),
        lights=lights,
        bvh=bvh,
        bssrdf=bssrdf_tables(mats, device),
        mediums=mediums,
        camera_medium=int(ctx.camera_medium),
        prim_media=prim_media(soa, sph_ns, device),
        light_dist=None if dist is None else {
            k: torch.as_tensor(np.array(a(v), np.float32), device=device)
            for k, v in dist.items()},
    )
