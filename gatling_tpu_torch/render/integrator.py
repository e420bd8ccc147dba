"""Render configuration, per-frame uniforms, the wavefront integrator and
progressive accumulation.

RenderConfig (the reference's structural shader #defines,
GlslShaderGen.cpp:79-91) and Uniforms (the UniformData analog,
rp_main.h:25-55) serve both render paths. `blend_aovs` blends a frame into
every AOV buffer (rp_main.rgen:506-515).

The wavefront integrator is the port of the JAX package's
render/integrator.py: a batched bounce loop over one sample of every pixel
(reference: rp_main.rgen main:185-521, rp_main.chit main:132-493). Each
bounce traces every ray (dead ones with tmax = 0), shades the hits with the
uber-BSDF (render/bsdf.py) from the packed geometry and material rows, runs
the NEE shadow rays and russian roulette. The RNG draw order is the
reference shader's (pixel jitter, lens, BSDF xi4, NEE k4, roulette), so a
pixel's samples equal the JAX package's up to the last bits of cos/sin/log.
Rays are traced by K5 (closest hit) and K6 (shadow rays) of ops/trace.py
(`tracer="matrix"`, scenes of at most 8192 triangles), by B1 and B2, the
walks of the JAX package's threaded BVH (`tracer="bvh"`, above: Accel.bvh
over the soup in the tree's order, the packed rows reordered with it), or
by the plain Moller-Trumbore of ops/intersect.py (`tracer="brute"`, the
JAX package's CPU tracer).

The JAX `while_loop` stops when no ray is alive; here a Python loop asks
the device once a bounce (`alive.any()`), one host sync a bounce. Cutout
(`has_cutout`) draws one decision at each hit from the path's PCG stream
and passes a rejected hit straight through; shadow rays walk their hits
one at a time (`_trace_occluded_cutout`, K5 re-launched until no ray is
unresolved, at most MAX_SHADOW_CUTOUT_HOPS). The volume branches carry the
absorbing medium flag and the medium stack; a miss adds the dome light's
equirect radiance (`has_dome`). A material with an MDL backface surface
(`has_backface`) shades a back-facing hit with its appended row
(MI_BACKFACE_ID); view-, normal- and primvar-dependent inputs
(`dynamic_params`) are evaluated at every hit (shadergraph
eval_dynamic_expr, with displayColor and the instance primvar tables) and
replace the material's constant where the hit's material is theirs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gatling_tpu_torch.interface import (
    BSDF_EVENT_ABSORB,
    BSDF_EVENT_DIFFUSE,
    BSDF_EVENT_GLOSSY,
    BSDF_EVENT_TRANSMISSION,
    FLOAT_MAX,
    LightArrays,
    MESH_FLAG_DOUBLE_SIDED,
    MESH_FLAG_FLIP_FACING,
    AovId,
    aov_bit,
    f32,
)
from gatling_tpu_torch.ops import sampling as smp
from gatling_tpu_torch.ops.geometry import (
    PF_BSIGN,
    PF_C0,
    PF_E1,
    PF_E2,
    PF_N0,
    PF_T0,
    PF_UV0,
    PF_V0,
    PackedGeometry,
    SceneGeometry,
)
from gatling_tpu_torch.ops.bvh import ThreadedBvh
from gatling_tpu_torch.ops.intersect import Hit, intersect_brute, occluded_brute
from gatling_tpu_torch.ops.trace import (
    TraceTables,
    intersect_matrix,
    intersect_threaded,
    occluded_matrix,
    occluded_threaded,
)
from gatling_tpu_torch.render import bsdf as bsdf_mod
from gatling_tpu_torch.render.camera import CameraUniforms, generate_primary_rays
from gatling_tpu_torch.render.lights import sample_light
from gatling_tpu_torch.render.shadergraph import eval_dynamic_expr
from gatling_tpu_torch.render.material import (
    MF_VCOLOR_MUL,
    MI_BACKFACE_ID,
    MaterialTable,
    _gather_rows,
    apply_textures,
    gather_params,
    perturb_normal,
)
from gatling_tpu_torch.render.texture import TexturePool


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration."""

    width: int
    height: int
    spp: int = 1
    max_bounces: int = 13
    rr_bounce_offset: int = 3
    jittered: bool = True
    fis: bool = True
    nee: bool = False
    depth_of_field: bool = False
    clipping_planes: bool = False
    progressive: bool = True
    aov_mask: int = aov_bit(AovId.COLOR)
    dome_light_camera_visible: bool = True
    # a dome light is set: misses add its radiance (the render paths read
    # no dome texture without it)
    has_dome: bool = False
    # textured scenes: bounces at or after this index (> 0) shade from the
    # texture means (render setting textureLodBounces; the fused path)
    tex_lod_bounces: int = 0
    # the wavefront's tracer: "matrix" (K5/K6, ops/trace.py), "bvh" (B1/B2,
    # the threaded BVH) or "brute"
    tracer: str = "brute"
    # some material has volume coefficients: the medium branches; the
    # medium stack's depth (render setting mediumStackSize): 0 toggles an
    # absorbing medium flag, >= 1 keeps a stack of media with free-flight
    # sampling and Henyey-Greenstein walk steps
    has_volumes: bool = False
    medium_stack_size: int = 0
    # some material has cutout opacity (MaterialTraits.has_cutout)
    has_cutout: bool = False
    # view-, normal- and primvar-dependent inputs: (material index,
    # parameter, shadergraph.Expr) evaluated per hit
    dynamic_params: tuple = ()
    # some material has a distinct MDL backface surface: back-facing hits
    # shade with its appended row (MaterialTable packed_i MI_BACKFACE_ID)
    has_backface: bool = False


class Uniforms(NamedTuple):
    """Per-frame values (python floats; the kernels see them as f32)."""

    camera: CameraUniforms
    sample_offset: int
    inv_total_sample_count: float
    max_sample_value: float
    rr_inv_min_term_prob: float
    light_intensity_multiplier: float
    meters_per_scene_unit: float
    max_volume_walk_length: int
    # the dome's quaternion (x, y, z, w) and emission multiplier: floats, or
    # f32 tensors on the device (gi's: a copy from the host each sample
    # wave would wait for the device)
    dome_rotation: tuple[float, ...] | torch.Tensor = (0.0, 0.0, 0.0, 1.0)
    dome_emission_multiplier: tuple[float, ...] | torch.Tensor = (1.0, 1.0, 1.0)
    # stored for parity: the reference packs it into its uniforms and no
    # shader reads it (gatling_tpu/render/integrator.py:194-198)
    dome_diffuse_specular: tuple[float, ...] = (1.0, 1.0)


class DomeLightData(NamedTuple):
    """The equirectangular dome texture and the background a camera ray
    sees when the dome is invisible to the camera (reference:
    Gi.cpp:2183-2238, rp_main.miss:46-53)."""

    texture: torch.Tensor   # [H, W, 3] f32 (1x1 black when absent)
    fallback: torch.Tensor  # [1, 1, 3] f32


def default_dome(device="cpu") -> DomeLightData:
    z = torch.zeros((1, 1, 3), dtype=torch.float32, device=device)
    return DomeLightData(texture=z, fallback=z.clone())


def _quat_rotate(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """GLM-style quaternion rotate of directions d [R, 3] by q [4]
    (reference: rp_main.miss:38-44)."""
    qv = q[:3].expand_as(d)
    a = torch.linalg.cross(qv, d)
    b = torch.linalg.cross(qv, a)
    return d + (a * q[3] + b) * 2.0


def _sample_equirect(tex: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bilinear equirect lookup of unit directions d [R, 3] in tex
    [H, W, 3] (reference: rp_main.miss sampleDomeLight:46-53, GL repeat-wrap
    sampling of u = (atan(z, x) + pi/2) / 2pi, v = 1 - acos(y) / pi)."""
    h, w = tex.shape[0], tex.shape[1]
    u = (torch.atan2(d[:, 2], d[:, 0]) + 0.5 * np.pi) / (2.0 * np.pi)
    v = 1.0 - torch.acos(torch.clamp(d[:, 1], -1.0, 1.0)) / np.pi
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    xi0 = torch.remainder(x0.to(torch.int32), w).long()
    xi1 = torch.remainder(xi0 + 1, w)
    yi0 = torch.clamp(y0.to(torch.int32), 0, h - 1).long()
    yi1 = torch.clamp(yi0 + 1, 0, h - 1)
    c00 = tex[yi0, xi0]
    c01 = tex[yi0, xi1]
    c10 = tex[yi1, xi0]
    c11 = tex[yi1, xi1]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def dome_radiance(dome: DomeLightData, uniforms: Uniforms, directions: torch.Tensor,
                  primary: torch.Tensor, camera_visible: bool) -> torch.Tensor:
    """[R, 3] the dome's radiance seen along `directions` (rp_main.miss:55-87):
    rotated by the dome's quaternion, normalised, looked up and scaled by its
    emission multiplier; where `primary` (camera rays) the fallback instead
    when the dome is invisible to the camera."""
    def vector(v):  # a tensor on the device already (gi's) is not copied
        return torch.as_tensor(v, dtype=torch.float32, device=directions.device)

    sample_dir = _quat_rotate(vector(uniforms.dome_rotation), directions)
    sample_dir = sample_dir / torch.clamp(
        torch.linalg.vector_norm(sample_dir, dim=-1, keepdim=True), min=1e-20)
    rad = _sample_equirect(dome.texture, sample_dir) * vector(uniforms.dome_emission_multiplier)
    if not camera_visible:
        rad = torch.where(primary[:, None], dome.fallback[0, 0].expand_as(rad), rad)
    return rad


class Accel(NamedTuple):
    """The tracer's data: the coefficient tables of K5/K6, the threaded BVH
    of B1/B2 (its rows hold the soup in the tree's order, which the packed
    shading rows follow), or for the brute tracer the soup itself."""

    tables: TraceTables | None = None
    soup: SceneGeometry | None = None
    bvh: ThreadedBvh | None = None


def _trace_closest(config: RenderConfig, accel: Accel, origins, dirs, tmin, tmax) -> Hit:
    if config.tracer == "matrix":
        return intersect_matrix(origins, dirs, tmin, tmax, accel.tables)
    if config.tracer == "bvh":
        return intersect_threaded(origins, dirs, tmin, tmax, accel.bvh)
    if config.tracer == "brute":
        return intersect_brute(origins, dirs, tmin, tmax, accel.soup)
    raise ValueError(f"unknown tracer {config.tracer!r}")


def _trace_occluded(config: RenderConfig, accel: Accel, origins, dirs, tmin, tmax):
    if config.tracer == "matrix":
        return occluded_matrix(origins, dirs, tmin, tmax, accel.tables)
    if config.tracer == "bvh":
        return occluded_threaded(origins, dirs, tmin, tmax, accel.bvh)
    if config.tracer == "brute":
        return occluded_brute(origins, dirs, tmin, tmax, accel.soup)
    raise ValueError(f"unknown tracer {config.tracer!r}")


MAX_SHADOW_CUTOUT_HOPS = 8


def _trace_occluded_cutout(config: RenderConfig, accel: Accel, geom: PackedGeometry,
                           materials: MaterialTable, textures: TexturePool, origins, dirs,
                           tmin, tmax, rng):
    """Occlusion through stochastic cutout (integrator.py
    _trace_occluded_cutout; rp_main.ahit:27-61): the closest hits along
    each shadow ray are walked one at a time, each drawing one decision
    from the ray's PCG stream against its material's cutout opacity
    (textured too); an accepted hit occludes, an ignored one moves tmin
    past the surface. Rays still unresolved after MAX_SHADOW_CUTOUT_HOPS
    count as occluded. Returns (occluded, rng)."""
    unresolved = tmax > tmin
    occl = torch.zeros_like(unresolved)
    for _hop in range(MAX_SHADOW_CUTOUT_HOPS):
        if not bool(unresolved.any()):  # one host sync a hop
            break
        hit = _trace_closest(config, accel, origins, dirs, tmin,
                             torch.where(unresolved, tmax, 0.0))
        is_hit = unresolved & (hit.tri >= 0)
        st = _shading_state(geom, hit, dirs)
        mid = st["material_id"]
        params = apply_textures(materials, textures, gather_params(materials, mid), mid, st["uv"])
        rng_after, xi = smp.rng_next1f(rng)
        rng = torch.where(is_hit, rng_after, rng)
        accepted = is_hit & (xi < bsdf_mod.cutout_opacity(params))
        occl = occl | accepted
        # misses resolve as unoccluded; ignored hits continue past the surface
        unresolved = unresolved & is_hit & ~accepted
        tmin = torch.where(unresolved, hit.t * (1.0 + 1e-4) + 1e-5, tmin)
    return occl | unresolved, rng


class FirstHitInfo(NamedTuple):
    """Per-pixel first-bounce data of the debug and auxiliary AOVs
    (written where bounce == 0, rp_main.chit:191-290)."""

    normal: torch.Tensor  # [N, 3]
    albedo: torch.Tensor  # [N, 3]
    barycentrics: torch.Tensor  # [N, 3]
    texcoords: torch.Tensor  # [N, 3]
    tangents: torch.Tensor  # [N, 3]
    bitangents: torch.Tensor  # [N, 3]
    depth: torch.Tensor  # [N]
    object_id: torch.Tensor  # [N] int32
    face_id: torch.Tensor  # [N] int32
    instance_id: torch.Tensor  # [N] int32
    thin_walled: torch.Tensor  # [N, 3]
    double_sided: torch.Tensor  # [N, 3]
    opacity: torch.Tensor  # [N, 3]
    nee: torch.Tensor  # [N, 3]
    hit: torch.Tensor  # [N] bool


class SampleResult(NamedTuple):
    color: torch.Tensor  # [N, 3]
    bounces: torch.Tensor  # [N] int32
    first: FirstHitInfo | None = None


def empty_first_hit(n: int, device) -> FirstHitInfo:
    """First-hit data of pixels no ray has hit yet."""
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
    ids = torch.full((n,), -1, dtype=torch.int32, device=device)
    return FirstHitInfo(
        normal=z3, albedo=z3, barycentrics=z3, texcoords=z3, tangents=z3, bitangents=z3,
        depth=torch.ones((n,), dtype=torch.float32, device=device), object_id=ids,
        face_id=ids, instance_id=ids, thin_walled=z3, double_sided=z3, opacity=z3, nee=z3,
        hit=torch.zeros((n,), dtype=torch.bool, device=device))


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-20)


def _shading_state(geom: PackedGeometry, hit: Hit, ray_dir: torch.Tensor) -> dict:
    """Interpolated hit attributes (mdl_shading_state.glsl:4-98, on the
    world-space soup) from two row gathers of the packed rows."""
    tri = torch.clamp(hit.tri, min=0).long()
    u, v = hit.u, hit.v
    bc = torch.stack([1.0 - u - v, u, v], dim=-1)
    pf = geom.packed_f[tri]
    pi = geom.packed_i[tri]

    def c3(off):
        return pf[:, off:off + 3]

    def interp(off, width=3):  # the three corners' columns, weighted by bc
        w = width
        return (bc[:, 0:1] * pf[:, off:off + w] + bc[:, 1:2] * pf[:, off + w:off + 2 * w]
                + bc[:, 2:3] * pf[:, off + 2 * w:off + 3 * w])

    e1, e2 = c3(PF_E1), c3(PF_E2)
    pos = c3(PF_V0) + u[:, None] * e1 + v[:, None] * e2
    flags = pi[:, 4]
    geom_n = _normalize(torch.linalg.cross(e1, e2))
    geom_n = torch.where(((flags & MESH_FLAG_FLIP_FACING) != 0)[:, None], -geom_n, geom_n)
    nrm = _normalize(interp(PF_N0))
    front = (geom_n * (-ray_dir)).sum(-1) >= 0.0
    geom_n = torch.where(front[:, None], geom_n, -geom_n)
    nrm = torch.where(front[:, None], nrm, -nrm)
    tan = interp(PF_T0)
    tan = _normalize(tan - nrm * (tan * nrm).sum(-1, keepdim=True))
    bsign = (bc * c3(PF_BSIGN)).sum(-1)
    bitan = torch.linalg.cross(nrm, tan) * bsign[:, None]
    return dict(
        pos=pos, geom_normal=geom_n, normal=nrm, tangent=tan, bitangent=bitan,
        uv=interp(PF_UV0, 2), bc=bc, front=front,
        double_sided=(flags & MESH_FLAG_DOUBLE_SIDED) != 0, vcolor=interp(PF_C0),
        material_id=pi[:, 0], object_id=pi[:, 1], face_id=pi[:, 2], instance_id=pi[:, 3])


_RGB_PARAMS = ("base_color", "emissive", "specular_color")


def _substitute_dynamic(config: RenderConfig, params, mid, direction, st, instance_primvars):
    """The dynamic inputs of config.dynamic_params evaluated over the wave
    (gatling_tpu/render/integrator.py:501-521) and substituted where the
    hit's material is theirs: primvars are displayColor (the interpolated
    vertex colours) and each instance table at the hit's instance id; an
    RGB parameter takes x, y, z, the others x."""
    pv = {"displayColor": st["vcolor"]}
    for name, table in (instance_primvars or {}).items():
        pv[name] = table[torch.clamp(st["instance_id"], 0, table.shape[0] - 1).long()]
    for mat_idx, pname, expr in config.dynamic_params:
        val = eval_dynamic_expr(expr, direction, st["normal"], primvars=pv)
        sel = mid == mat_idx
        cur = getattr(params, pname)
        if pname in _RGB_PARAMS:
            params = params._replace(**{pname: torch.where(sel[:, None], val[:, :3], cur)})
        else:
            params = params._replace(**{pname: torch.where(sel, val[:, 0], cur)})
    return params


_FIRST_HIT_AOVS = (
    AovId.NORMAL, AovId.ALBEDO, AovId.BARYCENTRICS, AovId.TEXCOORDS,
    AovId.TANGENTS, AovId.BITANGENTS, AovId.DEPTH, AovId.OBJECT_ID,
    AovId.FACE_ID, AovId.INSTANCE_ID, AovId.THIN_WALLED, AovId.DOUBLE_SIDED,
    AovId.OPACITY, AovId.NEE,
)


def _needs_first_hit(aov_mask: int) -> bool:
    return any(aov_mask & aov_bit(a) for a in _FIRST_HIT_AOVS)


def _where3(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, None], a, b)


def trace_sample(config: RenderConfig, uniforms: Uniforms, geom: PackedGeometry,
                 materials: MaterialTable, lights: LightArrays, pixel_index: torch.Tensor,
                 sample_index: int, textures: TexturePool, accel: Accel,
                 dome: DomeLightData | None = None,
                 instance_primvars: dict[str, torch.Tensor] | None = None) -> SampleResult:
    """Trace one sample of each pixel of `pixel_index` through the bounce
    loop (integrator.py trace_sample). `lights` holds tensors
    (render/lights.py light_tensors), `materials` the device table, `dome`
    the dome light that misses see (with config.has_dome; black when
    None), `instance_primvars` {name: [num_instances, 3]} the tables the
    dynamic inputs' primvar leaves read through the hit's instance id
    (ops/geometry.py build_instance_primvar_tables)."""
    device = pixel_index.device
    if config.has_dome and dome is None:
        dome = default_dome(device)
    n = pixel_index.shape[0]
    pixel_index = pixel_index.to(torch.int64)
    cam = uniforms.camera
    exposure = float(np.exp2(np.float32(cam.sensor_exposure)))

    rng = smp.rng_init(pixel_index, sample_index)
    origin, direction, rng = generate_primary_rays(
        cam, config.width, config.height, pixel_index % config.width,
        pixel_index // config.width, rng, config.jittered, config.fis, config.depth_of_field)
    if config.clipping_planes:  # the clip-plane correction (rp_main.rgen:283-285)
        cos_cone = torch.clamp((direction * cam.forward).sum(-1), min=1e-5)
        clip_lo, clip_hi = f32(cam.clip_start) / cos_cone, f32(cam.clip_end) / cos_cone

    want_first = _needs_first_hit(config.aov_mask)
    first = empty_first_hit(n, device)
    if want_first:
        # the log depth's scale (chit:191-290)
        cs, ce = np.float32(cam.clip_start), np.float32(cam.clip_end)
        log_span = float(np.log(np.maximum(ce / cs, np.float32(1.0 + 1e-6)))) if cs > 0 else 1.0
        red = torch.tensor([1.0, 0.0, 0.0], device=device)
        green = torch.tensor([0.0, 1.0, 0.0], device=device)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=device)
    alive = torch.ones((n,), dtype=torch.bool, device=device)
    bounces = torch.zeros((n,), dtype=torch.int32, device=device)
    zeros = torch.zeros((n,), dtype=torch.float32, device=device)
    stack = config.medium_stack_size
    rows = torch.arange(n, device=device)
    if config.has_volumes:
        # the medium stack (rp_main_payload.glsl Medium / mediumIdx bits):
        # the depth, and per level sigma_s, sigma_t and the HG bias
        medium_idx = torch.zeros((n,), dtype=torch.int32, device=device)
        if stack > 0:
            med_sigma_s = torch.zeros((n, stack, 3), dtype=torch.float32, device=device)
            med_sigma_t = torch.zeros((n, stack, 3), dtype=torch.float32, device=device)
            med_bias = torch.zeros((n, stack), dtype=torch.float32, device=device)
            walk = torch.zeros((n,), dtype=torch.int32, device=device)

    for bounce in range(config.max_bounces):
        if not bool(alive.any()):  # one host sync a bounce
            break
        if config.clipping_planes and bounce == 0:
            tmin, tmax = clip_lo, clip_hi
        else:
            tmin, tmax = zeros, torch.full_like(zeros, float(FLOAT_MAX))
        tmax = torch.where(alive, tmax, 0.0)  # dead rays do no work

        # free-flight distance sampling inside a scattering medium
        # (rgen:317-346): the segment ends at t_sample
        in_medium = None
        walk_pdf = torch.ones((n, 3), dtype=torch.float32, device=device)
        if config.has_volumes:
            in_medium = medium_idx > 0
            if stack > 0:
                cur = torch.clamp(medium_idx - 1, 0, stack - 1).long()
                sigma_s_c = med_sigma_s[rows, cur]
                sigma_t_c = med_sigma_t[rows, cur]
                has_scat = (sigma_s_c > 0.0).any(dim=-1)
                do_dist = alive & in_medium & has_scat & (
                    walk <= uniforms.max_volume_walk_length)
                rng_after, xi2 = smp.rng_next2f(rng)
                rng = torch.where(do_dist, rng_after, rng)
                # spectral single-channel MIS select (rgen sampleDistance:49-69)
                weights = throughput * smp.safe_div(sigma_s_c, sigma_t_c)
                wsum = weights.sum(-1)
                pdf3 = torch.where((wsum > 1e-9)[:, None],
                                   weights / torch.clamp(wsum, min=1e-9)[:, None],
                                   torch.full_like(weights, 1.0 / 3.0))
                x0 = xi2[:, 0]
                chan = torch.where(x0 < pdf3[:, 0], 0,
                                   torch.where(x0 < pdf3[:, 0] + pdf3[:, 1], 1, 2))
                sel_sigma = torch.gather(sigma_t_c, 1, chan[:, None])[:, 0]
                s_coef = torch.clamp(sel_sigma * f32(uniforms.meters_per_scene_unit), min=1e-20)
                t_sample = -torch.log(torch.clamp(1.0 - xi2[:, 1], min=1e-20)) / s_coef
                tmax = torch.where(do_dist, t_sample, tmax)
                walk_pdf = _where3(do_dist, pdf3, walk_pdf)

        hit = _trace_closest(config, accel, origin, direction, tmin, tmax)
        missed = hit.tri < 0
        is_hit = ~missed & alive
        is_miss = missed & alive
        # a miss inside a medium is a walk step, not the background
        # (rp_main.miss:16-34)
        vol_miss = torch.zeros_like(is_miss)
        if config.has_volumes and stack > 0:
            vol_miss = is_miss & in_medium
            is_miss = is_miss & ~in_medium

        # miss: the dome light (rp_main.miss:55-87)
        if config.has_dome:
            rad = dome_radiance(dome, uniforms, direction,
                                torch.full_like(is_miss, bounce == 0),
                                config.dome_light_camera_visible)
            radiance = radiance + _where3(is_miss, throughput * rad, 0.0)

        # hit shading (rp_main.chit)
        st = _shading_state(geom, hit, direction)
        mid = st["material_id"]
        if config.has_backface:  # a back-facing hit shades with the backface row
            mid = torch.where(st["front"], mid,
                              _gather_rows(materials.packed_i, mid)[:, MI_BACKFACE_ID])
        params = apply_textures(materials, textures, gather_params(materials, mid), mid, st["uv"])
        # the vertex-colour multiply, on the displayColor fallback material only
        vmul = _gather_rows(materials.packed_f, mid)[:, MF_VCOLOR_MUL]
        params = params._replace(
            base_color=params.base_color * (1.0 + (st["vcolor"] - 1.0) * vmul[:, None]))
        if config.dynamic_params:
            params = _substitute_dynamic(config, params, mid, direction, st, instance_primvars)
        normal = perturb_normal(materials, textures, mid, st["uv"], st["normal"],
                                st["tangent"], st["bitangent"])
        n_x_t = torch.linalg.cross(normal, st["tangent"])
        bitangent = n_x_t * torch.sign((n_x_t * st["bitangent"]).sum(-1, keepdim=True) + 1e-20)
        tangent = st["tangent"]

        # stochastic cutout (rp_main.ahit:35-61): a rejected hit passes the
        # ray straight through the surface and is not shaded
        if config.has_cutout:
            rng_after, xi_c = smp.rng_next1f(rng)
            rng = torch.where(is_hit, rng_after, rng)
            cut = is_hit & (xi_c >= bsdf_mod.cutout_opacity(params))
            is_hit = is_hit & ~cut

        # transmittance of the segment into a surface hit inside a medium
        # (chit:160-186): the current medium's sigma_t, or at stack 0 the
        # hit material's sigma_a
        if config.has_volumes:
            dist_m = hit.t * f32(uniforms.meters_per_scene_unit)
            sigma = sigma_t_c if stack > 0 else params.volume_absorption
            throughput = _where3(is_hit & in_medium, throughput * torch.exp(-sigma * dist_m[:, None]),
                                 throughput)

        # emission (chit:292-343): front faces, back faces of single-sided
        # geometry, and double-sided back faces of thin-walled materials with
        # a backface EDF
        emission_ok = st["front"] | ~st["double_sided"] | (
            params.thin_walled & (params.backface_edf > 0.5))
        radiance = radiance + _where3(is_hit & emission_ok,
                                      throughput * bsdf_mod.edf_emission(params) * exposure, 0.0)

        if want_first:  # first-bounce AOVs (chit:191-290)
            wr = is_hit if bounce == 0 else torch.zeros_like(is_hit)
            if cs > 0:
                depth = 2.0 * torch.log(torch.clamp(hit.t, min=1e-20) / cs) / log_span - 1.0
            else:
                depth = hit.t
            first = FirstHitInfo(
                normal=_where3(wr, normal, first.normal),
                albedo=_where3(wr, bsdf_mod.auxiliary(params, -direction, normal), first.albedo),
                barycentrics=_where3(wr, st["bc"], first.barycentrics),
                texcoords=_where3(wr, torch.nn.functional.pad(st["uv"], (0, 1)),
                                  first.texcoords),
                tangents=_where3(wr, (tangent + 1.0) * 0.5, first.tangents),
                bitangents=_where3(wr, (bitangent + 1.0) * 0.5, first.bitangents),
                depth=torch.where(wr, depth, first.depth),
                object_id=torch.where(wr, st["object_id"], first.object_id),
                face_id=torch.where(wr, st["face_id"], first.face_id),
                instance_id=torch.where(wr, st["instance_id"], first.instance_id),
                thin_walled=_where3(wr, _where3(params.thin_walled, red.expand(n, 3),
                                                green.expand(n, 3)), first.thin_walled),
                double_sided=_where3(wr, _where3(st["double_sided"], green.expand(n, 3),
                                                 red.expand(n, 3)), first.double_sided),
                opacity=_where3(wr, bsdf_mod.cutout_opacity(params)[:, None].expand(n, 3),
                                first.opacity),
                nee=first.nee,
                hit=first.hit | wr)

        # BSDF importance sampling (chit:345-389)
        rng_after, xi4 = smp.rng_next4f(rng)
        rng = torch.where(is_hit, rng_after, rng)
        k2, bsdf_over_pdf, event, _pdf = bsdf_mod.sample(
            params, -direction, normal, tangent, bitangent, xi4, front=st["front"])
        throughput = _where3(is_hit, throughput * bsdf_over_pdf, throughput)
        new_dir = _where3(is_hit, k2, direction)
        is_transmission = (event & BSDF_EVENT_TRANSMISSION) != 0
        offset_n = _where3(is_transmission, -st["geom_normal"], st["geom_normal"])
        new_origin = _where3(is_hit, smp.offset_ray_origin(st["pos"], offset_n), origin)
        if config.has_cutout:  # the pass-through continues from just past the surface
            new_origin = _where3(cut, smp.offset_ray_origin(st["pos"], -st["geom_normal"]),
                                 new_origin)

        if config.has_volumes:  # the medium stack on transmission (chit:446-480)
            med_change = is_hit & is_transmission & ~params.thin_walled
            if stack == 0:
                new_m_idx = torch.where(med_change, 1 - medium_idx, medium_idx)
            else:
                push = med_change & st["front"]
                pop = med_change & ~st["front"] & (medium_idx > 0)
                new_m_idx = medium_idx + push.to(torch.int32) - pop.to(torch.int32)
                slot = torch.clamp(new_m_idx - 1, 0, stack - 1)
                store = ((torch.arange(stack, device=device)[None, :] == slot[:, None])
                         & (push & (new_m_idx <= stack))[:, None])
                sigma_t_mat = params.volume_absorption + params.volume_scattering
                med_sigma_s = torch.where(store[:, :, None], params.volume_scattering[:, None, :],
                                          med_sigma_s)
                med_sigma_t = torch.where(store[:, :, None], sigma_t_mat[:, None, :],
                                          med_sigma_t)
                med_bias = torch.where(store, params.volume_bias[:, None], med_bias)
                # a medium change resets the walk (chit:478); a step counts
                # (rp_main.miss stepVolume)
                walk = torch.where(vol_miss, walk + 1, torch.where(med_change, 0, walk))
                dist_m2 = tmax * f32(uniforms.meters_per_scene_unit)
                trans = torch.exp(-sigma_t_c * dist_m2[:, None])
                pdf_w = torch.clamp((walk_pdf * (sigma_t_c * trans)).sum(-1), min=1e-20)
                throughput = _where3(vol_miss, throughput * (sigma_s_c * trans / pdf_w[:, None]),
                                     throughput)
                new_origin = _where3(vol_miss, origin + direction * tmax[:, None], new_origin)
            hg_idx = medium_idx  # the HG bias is the medium the step was taken in
            medium_idx = new_m_idx

        if config.nee:  # NEE (chit:393-444, rgen:397-438)
            nee_able = is_hit & ((event & (BSDF_EVENT_DIFFUSE | BSDF_EVENT_GLOSSY)) != 0)
            rng_after, k4 = smp.rng_next4f(rng)
            rng = torch.where(nee_able, rng_after, rng)
            dir_to_light, light_dist, light_power, inv_pdf, diff_spec = sample_light(
                lights, k4, st["pos"], uniforms.light_intensity_multiplier,
                cam.sensor_exposure)
            nee_valid = nee_able & (light_dist > 0.0) & (
                (dir_to_light * st["geom_normal"]).sum(-1) > 0.0)
            f_diff, f_glossy, eval_pdf = bsdf_mod.evaluate(
                params, -direction, dir_to_light, normal, tangent, bitangent)
            nee_valid = nee_valid & (eval_pdf > 0.0)
            # the reference's order: this bounce's bsdf_over_pdf is already in
            # the throughput
            weight = throughput * (light_power * inv_pdf[:, None])
            contrib = weight * (f_diff * diff_spec[:, 0:1] + f_glossy * diff_spec[:, 1:2])
            contrib = _where3(nee_valid, contrib, 0.0)
            do_trace = (smp.luminance(contrib) > 1e-6) & (light_dist > 1e-9)
            sh_tmin = torch.where(do_trace, 0.01, 0.0)
            sh_tmax = torch.where(do_trace, light_dist, 0.0)
            if config.has_cutout:  # the shadow stream's cutout (rp_main.ahit SHADOW_TEST)
                shadowed, rng = _trace_occluded_cutout(config, accel, geom, materials, textures,
                                                       new_origin, dir_to_light, sh_tmin,
                                                       sh_tmax, rng)
            else:
                shadowed = _trace_occluded(config, accel, new_origin, dir_to_light, sh_tmin,
                                           sh_tmax)
            radiance = radiance + _where3(do_trace & ~shadowed, contrib, 0.0)
            if want_first and config.aov_mask & aov_bit(AovId.NEE) and bounce == 0:
                nee_color = _where3(shadowed, red.expand(n, 3), green.expand(n, 3))
                first = first._replace(nee=_where3(is_hit, nee_color, first.nee))

        # termination (chit:482-486, rgen:440-459)
        terminate = is_miss | (is_hit & (event == BSDF_EVENT_ABSORB))
        terminate = terminate | (alive & (torch.linalg.vector_norm(throughput, dim=-1) < 1e-9))
        if config.max_bounces > config.rr_bounce_offset:
            do_rr = alive & (bounce > config.rr_bounce_offset)
            rng_after, k1 = smp.rng_next1f(rng)
            rng = torch.where(do_rr, rng_after, rng)
            p = torch.clamp(throughput.max(dim=-1).values, max=uniforms.rr_inv_min_term_prob)
            rr_kill = do_rr & (k1 > p)
            throughput = _where3(do_rr & ~rr_kill, throughput / torch.clamp(p, min=1e-20)[:, None],
                                 throughput)
            terminate = terminate | rr_kill

        if config.has_volumes and stack > 0:
            # the walk step's direction (rgen:461-477): a Henyey-Greenstein
            # phase around the current direction
            rng_after, xi_hg = smp.rng_next2f(rng)
            rng = torch.where(vol_miss, rng_after, rng)
            g = med_bias[rows, torch.clamp(hg_idx - 1, 0, stack - 1).long()]
            iso = torch.abs(g) < 1e-3
            sq = (1.0 - g * g) / torch.clamp(1.0 - g + 2.0 * g * xi_hg[:, 0], min=1e-9)
            g_safe = torch.where(torch.abs(g) < 1e-9, 1.0, g)
            cos_hg = torch.where(iso, 1.0 - 2.0 * xi_hg[:, 0],
                                 (1.0 + g * g - sq * sq) / torch.where(iso, 1.0, 2.0 * g_safe))
            sin_hg = torch.sqrt(torch.clamp(1.0 - cos_hg * cos_hg, min=0.0))
            phi = 2.0 * np.pi * xi_hg[:, 1]
            t_b, b_b = smp.orthonormal_basis(new_dir)
            scattered = (t_b * (sin_hg * torch.cos(phi))[:, None]
                         + b_b * (sin_hg * torch.sin(phi))[:, None] + new_dir * cos_hg[:, None])
            new_dir = _where3(vol_miss, scattered, new_dir)

        new_alive = alive & ~terminate
        bounces = bounces + new_alive.to(torch.int32) + (alive & terminate).to(torch.int32)
        origin, direction, alive = new_origin, new_dir, new_alive

    # the radiance clamp (rgen:488-494)
    max_v = radiance.max(dim=-1).values
    scale = torch.where(max_v > uniforms.max_sample_value,
                        uniforms.max_sample_value / torch.clamp(max_v, min=1e-20), 1.0)
    color = torch.clamp(radiance * scale[:, None], min=0.0)
    return SampleResult(color=color, bounces=bounces, first=first)


def render_pixels(config: RenderConfig, uniforms: Uniforms, geom: PackedGeometry,
                  materials: MaterialTable, lights: LightArrays, pixel_index: torch.Tensor,
                  spp: int, sample_offset: int, textures: TexturePool,
                  accel: Accel, dome: DomeLightData | None = None,
                  instance_primvars: dict[str, torch.Tensor] | None = None) -> SampleResult:
    """`spp` samples of the pixels `pixel_index`: the mean colour, the
    longest path and the first-hit data (normal and albedo averaged over
    the samples, the rest from the last sample that hit)."""
    n = pixel_index.shape[0]
    inv_spp = 1.0 / spp
    color = torch.zeros((n, 3), dtype=torch.float32, device=pixel_index.device)
    bounces = torch.zeros((n,), dtype=torch.int32, device=pixel_index.device)
    first = empty_first_hit(n, pixel_index.device)
    for s in range(spp):
        res = trace_sample(config, uniforms, geom, materials, lights, pixel_index,
                           sample_offset + s, textures, accel, dome, instance_primvars)
        color = color + res.color * inv_spp
        bounces = torch.maximum(bounces, res.bounces)
        first = res.first._replace(normal=first.normal + res.first.normal * inv_spp,
                                   albedo=first.albedo + res.first.albedo * inv_spp)
    return SampleResult(color=color, bounces=bounces, first=first)


def blend_aovs(config: RenderConfig, uniforms: Uniforms, aovs: dict[str, torch.Tensor],
               result: SampleResult) -> dict[str, torch.Tensor]:
    """Blend one frame's result into the AOV buffers of `aovs`, with
    progressive accumulation for the averaged ones (rp_main.rgen:506-515).
    A COLOR-only frame may carry no first-hit data."""
    color, bounces, first = result.color, result.bounces, result.first
    out = dict(aovs)
    offset = float(uniforms.sample_offset)
    spp = float(config.spp)
    inv_total = uniforms.inv_total_sample_count

    def accum(prev, new):
        prev_used = prev if config.progressive and offset > 0.0 else new
        return (prev_used * offset + new * spp) * inv_total

    def latest(key, value):
        hit = first.hit if value.dim() == 1 else first.hit[:, None]
        out[key] = torch.where(hit, value, aovs[key])

    mask = config.aov_mask
    if mask & aov_bit(AovId.COLOR):
        out["color"] = accum(aovs["color"], torch.cat([color, torch.ones_like(color[:, :1])], -1))
    if mask & aov_bit(AovId.NORMAL):
        blended = accum(aovs["normal"], (first.normal + 1.0) * 0.5)
        ren = _normalize(blended * 2.0 - 1.0)  # renormalised (rgen:517-520)
        out["normal"] = _where3(first.hit, (ren + 1.0) * 0.5, blended)
    if mask & aov_bit(AovId.ALBEDO):
        out["albedo"] = accum(aovs["albedo"], first.albedo)
    for aov, key in ((AovId.BARYCENTRICS, "barycentrics"), (AovId.TEXCOORDS, "texcoords"),
                     (AovId.TANGENTS, "tangents"), (AovId.BITANGENTS, "bitangents"),
                     (AovId.DEPTH, "depth"), (AovId.OBJECT_ID, "object_id"),
                     (AovId.FACE_ID, "face_id"), (AovId.INSTANCE_ID, "instance_id"),
                     (AovId.THIN_WALLED, "thin_walled"), (AovId.DOUBLE_SIDED, "double_sided"),
                     (AovId.OPACITY, "opacity"), (AovId.NEE, "nee")):
        if mask & aov_bit(aov):
            latest(key, getattr(first, key))
    if mask & aov_bit(AovId.BOUNCES):
        out["bounces"] = _inferno(bounces.to(torch.float32) / config.max_bounces)
    if mask & aov_bit(AovId.CLOCK_CYCLES):
        # no clock counter on the device: the path length is the cost proxy
        # (reference heatmap: rp_main.rgen:187-189, Gi.cpp:327-343)
        out["clock_cycles"] = bounces
    return out


def render_frame(config: RenderConfig, uniforms: Uniforms, geom: PackedGeometry,
                 materials: MaterialTable, lights: LightArrays, aovs: dict[str, torch.Tensor],
                 textures: TexturePool, accel: Accel,
                 dome: DomeLightData | None = None,
                 instance_primvars: dict[str, torch.Tensor] | None = None
                 ) -> dict[str, torch.Tensor]:
    """One frame of every pixel through the wavefront integrator, blended
    into `aovs` (the giRender dispatch, Gi.cpp:2437)."""
    pixel_index = torch.arange(config.width * config.height, device=geom.packed_f.device)
    res = render_pixels(config, uniforms, geom, materials, lights, pixel_index, config.spp,
                        uniforms.sample_offset, textures, accel, dome, instance_primvars)
    return blend_aovs(config, uniforms, aovs, res)


_INFERNO = (
    (0.0002189403, 0.001651004, -0.01948089), (0.1065134, 0.5639564, 3.932712),
    (11.60249, -3.972853, -15.9424), (-41.70399, 17.43639, 44.35414),
    (77.162935, -33.40235, -81.80731), (-71.31942, 32.62606, 73.20951),
    (25.13112, -12.24266, -23.07032),
)


def _inferno(t: torch.Tensor) -> torch.Tensor:
    """Polynomial fit of the matplotlib inferno colormap
    (reference: colormap.glsl colormap_inferno)."""
    t = torch.clamp(t, 0.0, 1.0)[:, None]
    c = [torch.tensor(row, dtype=torch.float32, device=t.device) for row in _INFERNO]
    return c[0] + t * (c[1] + t * (c[2] + t * (c[3] + t * (c[4] + t * (c[5] + t * c[6])))))
