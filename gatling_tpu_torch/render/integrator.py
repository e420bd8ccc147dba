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
Rays are traced by the brute-force kernels K5 (closest hit) and K6 (shadow
rays) of ops/trace.py (`tracer="matrix"`), or by the plain Moller-Trumbore
of ops/intersect.py (`tracer="brute"`, the JAX package's CPU tracer).

The JAX `while_loop` stops when no ray is alive; here a Python loop asks
the device once a bounce (`alive.any()`), one host sync a bounce. Cutout
(`has_cutout`) draws one decision at each hit from the path's PCG stream
and passes a rejected hit straight through; shadow rays walk their hits
one at a time (`_trace_occluded_cutout`, K5 re-launched until no ray is
unresolved, at most MAX_SHADOW_CUTOUT_HOPS). The volume, medium-stack and
dome branches are not ported: their flags raise. Nor are the backface and
dynamic-input ones, whose materials the port's front end does not produce
yet.
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
from gatling_tpu_torch.ops.intersect import Hit, intersect_brute, occluded_brute
from gatling_tpu_torch.ops.trace import TraceTables, intersect_matrix, occluded_matrix
from gatling_tpu_torch.render import bsdf as bsdf_mod
from gatling_tpu_torch.render.camera import CameraUniforms, generate_primary_rays
from gatling_tpu_torch.render.lights import sample_light
from gatling_tpu_torch.render.material import (
    MF_VCOLOR_MUL,
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
    has_dome: bool = False
    # textured scenes: bounces at or after this index (> 0) shade from the
    # texture means (render setting textureLodBounces; the fused path)
    tex_lod_bounces: int = 0
    # the wavefront's tracer: "matrix" (K5/K6, ops/trace.py) or "brute"
    tracer: str = "brute"
    # some material has volume coefficients: the JAX wavefront's volume
    # branches, not ported yet (trace_sample raises)
    has_volumes: bool = False
    # some material has cutout opacity (MaterialTraits.has_cutout)
    has_cutout: bool = False


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


class Accel(NamedTuple):
    """The tracer's data: the coefficient tables of K5/K6, or for the brute
    tracer the soup itself."""

    tables: TraceTables | None = None
    soup: SceneGeometry | None = None


def _trace_closest(config: RenderConfig, accel: Accel, origins, dirs, tmin, tmax) -> Hit:
    if config.tracer == "matrix":
        return intersect_matrix(origins, dirs, tmin, tmax, accel.tables)
    if config.tracer == "brute":
        return intersect_brute(origins, dirs, tmin, tmax, accel.soup)
    raise NotImplementedError(f"tracer {config.tracer!r} is not ported yet "
                              "(ROADMAP: 'Wavefront integrator')")


def _trace_occluded(config: RenderConfig, accel: Accel, origins, dirs, tmin, tmax):
    if config.tracer == "matrix":
        return occluded_matrix(origins, dirs, tmin, tmax, accel.tables)
    if config.tracer == "brute":
        return occluded_brute(origins, dirs, tmin, tmax, accel.soup)
    raise NotImplementedError(f"tracer {config.tracer!r} is not ported yet "
                              "(ROADMAP: 'Wavefront integrator')")


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


def _check_branches(config: RenderConfig) -> None:
    if config.has_dome:
        raise NotImplementedError("dome lights are not ported yet (ROADMAP: 'Dome lights')")
    if config.has_volumes:
        raise NotImplementedError("volumes in the wavefront integrator are not ported yet "
                                  "(ROADMAP: 'USD content', with the MDL front end that "
                                  "produces them)")


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
                 sample_index: int, textures: TexturePool, accel: Accel) -> SampleResult:
    """Trace one sample of each pixel of `pixel_index` through the bounce
    loop (integrator.py trace_sample). `lights` holds tensors
    (render/lights.py light_tensors), `materials` the device table."""
    _check_branches(config)
    device = pixel_index.device
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

    for bounce in range(config.max_bounces):
        if not bool(alive.any()):  # one host sync a bounce
            break
        if config.clipping_planes and bounce == 0:
            tmin, tmax = clip_lo, clip_hi
        else:
            tmin, tmax = zeros, torch.full_like(zeros, float(FLOAT_MAX))
        tmax = torch.where(alive, tmax, 0.0)  # dead rays do no work

        hit = _trace_closest(config, accel, origin, direction, tmin, tmax)
        missed = hit.tri < 0
        is_hit = ~missed & alive
        is_miss = missed & alive

        # hit shading (rp_main.chit)
        st = _shading_state(geom, hit, direction)
        mid = st["material_id"]
        params = apply_textures(materials, textures, gather_params(materials, mid), mid, st["uv"])
        # the vertex-colour multiply, on the displayColor fallback material only
        vmul = _gather_rows(materials.packed_f, mid)[:, MF_VCOLOR_MUL]
        params = params._replace(
            base_color=params.base_color * (1.0 + (st["vcolor"] - 1.0) * vmul[:, None]))
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
                  accel: Accel) -> SampleResult:
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
                           sample_offset + s, textures, accel)
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
                 textures: TexturePool, accel: Accel) -> dict[str, torch.Tensor]:
    """One frame of every pixel through the wavefront integrator, blended
    into `aovs` (the giRender dispatch, Gi.cpp:2437)."""
    pixel_index = torch.arange(config.width * config.height, device=geom.packed_f.device)
    res = render_pixels(config, uniforms, geom, materials, lights, pixel_index, config.spp,
                        uniforms.sample_offset, textures, accel)
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
