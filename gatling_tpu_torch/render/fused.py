"""Fused render path: the sample loop around the bounce kernels.

Port of the JAX package's render/fused.py `render_pixels_fused`: camera
rays for a batch of samples, packed into the [16, R] ray state; every
bounce advances every ray (closest hit, shading, NEE shadow ray, russian
roulette) until `max_bounces` or until no ray is alive; then the
per-sample radiance clamp and the accumulation. Per-sample RNG streams
equal the JAX package's. An untextured scene runs one kernel a bounce,
`bounce_step` (K1 or K2). A textured one splits the bounce: `trace_step`
(K3) writes the hit buffer and `shade_step` (K4) samples the textured
parameters, perturbs the shading normal of normal-mapped scenes and
shades. The JAX package runs an XLA texture stage between its two
kernels (`_material_rows`); its port, ops/split_ref.py `material_rows`,
is the plain twin of K4's taps (shade_step runs it on a CPU state) and
never runs on the card's main path. With textureLodBounces = k, bounces
k and later run `bounce_step` on the kernels' material table, which
holds the texture means.

A dead ray costs the kernels one load of its alive row, so the port keeps
no alive-ray partition between bounces (the TPU path partitions 128-ray
chunks, and runs the texture stage over the live prefix only, because
each kernel block there has a fixed cost). Clustered and
instanced scenes keep the JAX path's coherence measures: a full frame's
pixels go in 32x32 tiles, and the rays are sorted after every bounce by
direction octant and origin Morton cell (dead rays last), which puts rays
that walk the same boxes side by side in a warp. Neither changes a ray's
result: the RNG state rides in the ray's own row.

Camera clipping planes and the first-hit AOVs (NORMAL, ALBEDO, DEPTH,
TEXCOORDS) peel bounce 0 off the loop, as the JAX package does
(gatling_tpu/render/fused.py:446-527): the origin advances to the near plane, K3
traces, hits beyond the far plane become misses, the AOVs are read from
the hit buffer and from K4's taps alone (ops/bounce.py tap_rows, K4t:
the rows the AOVs read, the tapped base colour and metallic and the
normal-mapped normal), and K4 shades; the loop goes on at bounce 1. A
first-hit frame traces one sample a wave. A scene with an opacity texture
re-traces the rays its textured cutout rejects, up to TEX_CUTOUT_ROUNDS - 1
times a split bounce (gatling_tpu/render/fused.py:299-359): each round is one
kernel, K4r (ops/bounce.py retrace_round), which draws against the
opacity tapped at the hit, moves a rejected ray's origin past the surface
and masks the other rays' alive row in a copy of the state made once a
bounce; K3 traces the rejected rays alone.

A dome light adds its radiance after the bounce loop, as the JAX package
does (gatling_tpu/render/fused.py:666-681): the kernels record in state row
14 the bounce at which a ray missed, and `dome_pass` looks up the dome
along the direction rows at that miss, weighted by the throughput rows,
before the radiance clamp. It is PyTorch ops on every route: the JAX
package computes it in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from gatling_tpu_torch.interface import AovId, aov_bit, f32
from gatling_tpu_torch.ops import sampling as smp
from gatling_tpu_torch.ops.bounce import (  # noqa: F401 (retrace_draws: re-exported)
    TAP_BASE_ROW,
    TAP_METAL_ROW,
    TAP_N_ROW,
    VOL_ABSORB,
    VOL_SCATTER,
    FusedScene,
    bounce_step,
    make_params,
    pack_state,
    retrace_draws,
    retrace_round,
    shade_step,
    tap_rows,
    trace_step,
    unpack_radiance,
    unpack_rows,
)
from gatling_tpu_torch.ops.split_ref import H_HIT, H_MAT, H_T, H_UVX, H_UVY
from gatling_tpu_torch.render import bsdf
from gatling_tpu_torch.render.camera import generate_primary_rays
from gatling_tpu_torch.render.integrator import (
    DomeLightData,
    RenderConfig,
    Uniforms,
    default_dome,
    dome_radiance,
)
from gatling_tpu_torch.render.material import MaterialTable, gather_params
from gatling_tpu_torch.render.texture import TexturePool

# samples of one pixel traced together in one ray wave, up to this many rays
SPP_BATCH_RAYS = 4194304
# the AOVs the fused path writes (gatling_tpu/render/fused.py:116-118): COLOR and the
# first-hit AOVs of the bounce-0 peel; a request of others renders through
# the wavefront integrator
FUSED_AOV_MASK = (aov_bit(AovId.COLOR) | aov_bit(AovId.NORMAL) | aov_bit(AovId.ALBEDO)
                  | aov_bit(AovId.DEPTH) | aov_bit(AovId.TEXCOORDS))
# textured-cutout surfaces a split bounce passes through before it takes
# the hit (gatling_tpu/render/fused.py:299): TEX_CUTOUT_ROUNDS - 1 re-traces
TEX_CUTOUT_ROUNDS = 4


def spp_batch_size(r: int, spp: int, want_first_hit: bool = False) -> int:
    """Largest divisor of spp whose wave stays within SPP_BATCH_RAYS rays;
    1 for a first-hit frame, whose peel traces one sample a wave
    (gatling_tpu/render/fused.py:391)."""
    if spp <= 1 or r < 128 or want_first_hit:
        return 1
    cap = max(1, SPP_BATCH_RAYS // r)
    return max(d for d in range(1, min(spp, cap) + 1) if spp % d == 0)


def tile_order(width: int, height: int) -> np.ndarray:
    """Pixel permutation putting 32x32 image tiles contiguous
    (render/fused.py _tile_order)."""
    idx = np.arange(width * height, dtype=np.int64)
    iy, ix = idx // width, idx % width
    tiles_x = -(-width // 32)
    key = (((iy >> 5) * tiles_x + (ix >> 5)) << 10) | ((iy & 31) << 5) | (ix & 31)
    return np.argsort(key, kind="stable")


def _spread10(x: torch.Tensor) -> torch.Tensor:
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def coherence_keys(state: torch.Tensor, scene_lo: torch.Tensor,
                   scene_inv_span: torch.Tensor) -> torch.Tensor:
    """Per-ray sort key (render/fused.py _coherence_keys): direction octant,
    then the origin's Morton cell on a 32^3 grid over the scene box; dead
    rays get 0xFFFFFFFF and sort last. uint32 values in int64."""
    octant = ((state[3] >= 0).long() + 2 * (state[4] >= 0).long()
              + 4 * (state[5] >= 0).long())
    q = [(torch.clamp((state[a] - scene_lo[a]) * scene_inv_span[a], 0.0, 1.0) * 31.0).long()
         for a in range(3)]
    morton = _spread10(q[0]) | (_spread10(q[1]) << 1) | (_spread10(q[2]) << 2)
    return torch.where(state[13] > 0.5, (octant << 15) | morton, 0xFFFFFFFF)


def _hit_materials(hitbuf: torch.Tensor, materials: MaterialTable) -> torch.Tensor:
    return torch.clamp(torch.round(hitbuf[H_MAT]).long(), 0, materials.packed_f.shape[0] - 1)


def textured_cutout_retrace(params: torch.Tensor, scene: FusedScene, state: torch.Tensor,
                            hitbuf: torch.Tensor, materials: MaterialTable,
                            textures: TexturePool, textured_params) -> torch.Tensor:
    """The stochastic textured-opacity cutout of a split bounce
    (gatling_tpu/render/fused.py:302-359): TEX_CUTOUT_ROUNDS - 1 rounds, each
    (retrace_round, K4r) drawing against the opacity tapped at every alive
    ray's hit where the material binds an opacity texture, moving a
    rejected ray's origin just past the surface (state rows 0-2, in place)
    and masking the others' alive row in a copy of the state made once a
    bounce; K3 re-traces the masked state, and the rejected rays take its
    hits. Returns the merged hit buffer. The in-walk untextured cutout is
    separate: opacity-textured materials pass there with probability 1."""
    masked = state.clone()
    for rnd in range(TEX_CUTOUT_ROUNDS - 1):
        retrace_round(state, masked, hitbuf, materials, textures, textured_params, rnd)
        hitbuf = torch.where(masked[13] > 0.5, trace_step(params, scene, masked), hitbuf)
    return hitbuf


class FirstHit:
    """The first-hit AOV sums of a frame (gatling_tpu/render/fused.py:497-523): NORMAL
    and ALBEDO summed over the samples' hits / spp, DEPTH and TEXCOORDS the
    last hit sample's, `hit` where any sample hit."""

    def __init__(self, r: int, device) -> None:
        self.normal = torch.zeros((r, 3), dtype=torch.float32, device=device)
        self.albedo = torch.zeros_like(self.normal)
        self.texcoords = torch.zeros_like(self.normal)
        self.depth = torch.ones((r,), dtype=torch.float32, device=device)
        self.hit = torch.zeros((r,), dtype=torch.bool, device=device)

    def add(self, hitbuf: torch.Tensor, taps: torch.Tensor, materials: MaterialTable,
            dirs: torch.Tensor, camera, spp: int) -> None:
        """One sample's peel: hitbuf after the far-plane filter and the
        re-trace (its H_N rows the geometric shading normal; the taps'
        normal rows normal-mapped), the taps of those hits, the primary
        directions [r, 3]."""
        r = dirs.shape[0]
        hit = hitbuf[H_HIT, :r] > 0.5
        normal = taps[TAP_N_ROW:TAP_N_ROW + 3, :r].T
        p = gather_params(materials, _hit_materials(hitbuf[:, :r], materials))._replace(
            base_color=taps[TAP_BASE_ROW:TAP_BASE_ROW + 3, :r].T, metallic=taps[TAP_METAL_ROW, :r])
        albedo = bsdf.auxiliary(p, -dirs, normal)
        t_hit = hitbuf[H_T, :r]
        cs, ce = f32(camera.clip_start), f32(camera.clip_end)
        if cs > 0.0:
            # the log depth between the clipping planes
            span = np.log(np.float32(max(f32(ce / cs), f32(1.0 + 1e-6))))
            depth = 2.0 * torch.log(torch.clamp(t_hit, min=1e-20) / float(cs)) / float(span) - 1.0
        else:
            depth = t_hit
        uv = torch.stack([hitbuf[H_UVX, :r], hitbuf[H_UVY, :r], torch.zeros_like(t_hit)], -1)
        self.normal = self.normal + torch.where(hit[:, None], normal, 0.0) / spp
        self.albedo = self.albedo + torch.where(hit[:, None], albedo, 0.0) / spp
        self.depth = torch.where(hit, depth, self.depth)
        self.texcoords = torch.where(hit[:, None], uv, self.texcoords)
        self.hit = self.hit | hit

    def unswizzle(self, tile_perm: torch.Tensor) -> None:
        """Undo the 32x32 tile order: row i holds pixel tile_perm[i]."""
        for key in ("normal", "albedo", "texcoords", "depth", "hit"):
            v = getattr(self, key)
            setattr(self, key, torch.zeros_like(v).index_copy_(0, tile_perm, v))

    def as_dict(self) -> dict[str, torch.Tensor]:
        return dict(normal=self.normal, albedo=self.albedo, depth=self.depth,
                    texcoords=self.texcoords, hit=self.hit)


def dome_pass(radiance: torch.Tensor, state: torch.Tensor, dome: DomeLightData,
              uniforms: Uniforms, camera_visible: bool) -> torch.Tensor:
    """The radiance [R, 3] of the final state [16, R] (after the unsort)
    with the dome's added over the kernels' miss records
    (gatling_tpu/render/fused.py:666-681): row 14 the bounce + 1 at which
    the ray missed (0: no miss), rows 6-8 its throughput and 3-5 its
    direction there; a camera ray's miss is record 1."""
    r = radiance.shape[0]
    miss_rec = unpack_rows(state, 14, 1, r)[:, 0]
    rad = dome_radiance(dome, uniforms, unpack_rows(state, 3, 3, r), miss_rec == 1.0,
                        camera_visible)
    return radiance + torch.where((miss_rec > 0.0)[:, None], unpack_rows(state, 6, 3, r) * rad,
                                  0.0)


def render_pixels_fused(config: RenderConfig, uniforms: Uniforms, scene: FusedScene,
                        pixel_index: torch.Tensor, spp: int, sample_offset: int,
                        with_stats: bool = False, materials: MaterialTable | None = None,
                        textures: TexturePool | None = None,
                        textured_params: tuple[str, ...] = (), want_first_hit: bool = False,
                        split: bool | None = None, cutout_textured: bool = False,
                        dome: DomeLightData | None = None, spp_batch: int | None = None):
    """Mean color [R,3] over spp samples of the pixels `pixel_index`; with
    with_stats also the mean traced-segment count per sample [R] (path
    segments + NEE shadow rays: the Mray/s accounting source); with
    want_first_hit (color, segments, the first-hit AOVs as a dict: normal,
    albedo, depth, texcoords, hit). `materials` (the raw device table) and
    `textures` serve the split bounce, the peel and the re-trace: with
    `split` (by default, whether `textures` is given) every bounce splits
    into trace and shade, tapping the parameters `textured_params`;
    `cutout_textured` re-traces the rays an opacity texture rejects; with
    config.has_dome the misses see `dome` (black when None). `spp_batch`
    (a divisor of spp) sets the samples a wave, spp_batch_size's choice by
    default: a tile of a frame keeps the whole frame's waves with it
    (parallel/sharding.py)."""
    split = textures is not None if split is None else split
    peel = want_first_hit or config.clipping_planes
    if (peel or cutout_textured or split) and (materials is None or textures is None):
        raise ValueError("render_pixels_fused: the split bounce, the bounce-0 peel and the "
                         "textured-cutout re-trace take the material table and the texture pool")
    device = pixel_index.device
    r = pixel_index.shape[0]
    pixel_index = pixel_index.to(torch.int64)
    # several samples per pixel in one wave: the sample index of replica k
    # in step s is offset + s * batch + k, the same stream as one sample
    # per step
    if spp_batch is None:
        spp_batch = spp_batch_size(r, spp, want_first_hit)
    rb = r * spp_batch
    sort_rays = scene.walk is not None
    tile_perm = None
    if sort_rays:
        box = scene.walk.l1
        scene_lo = box[:, 0:3].min(dim=0).values
        scene_inv = 1.0 / torch.clamp(box[:, 3:6].max(dim=0).values - scene_lo, min=1e-12)
        if r == config.width * config.height:
            # full frame: 32x32 pixel tiles side by side, undone on return
            tile_perm = torch.as_tensor(tile_order(config.width, config.height), device=device)
            pixel_index = pixel_index[tile_perm]
    # replica-major tiling after the tile swizzle
    pixel_index = pixel_index.repeat(spp_batch)
    px = pixel_index % config.width
    py = pixel_index // config.width
    replica = torch.arange(spp_batch, device=device).repeat_interleave(r)
    params = make_params(config, uniforms, max(config.max_bounces, 1), device)
    nee = bool(config.nee)
    # textureLodBounces gives way to the textured cutout (gatling_tpu/render/fused.py:640-642)
    lod_k = config.tex_lod_bounces if split and not cutout_textured else 0
    # the peel shades the depth-1 medium stack's rays as the JAX shade_step
    # does: in the absorption mode (its shade kernel has no scatter branch)
    peel_scene = scene._replace(volumes=VOL_ABSORB) if scene.volumes == VOL_SCATTER else scene
    cam = uniforms.camera
    first = FirstHit(r, device) if want_first_hit else None
    if config.has_dome and dome is None:
        dome = default_dome(device)

    def split_bounce(p, fs, st):
        hitbuf = trace_step(p, fs, st)
        if cutout_textured:
            hitbuf = textured_cutout_retrace(p, fs, st, hitbuf, materials, textures,
                                             textured_params)
        shade_step(p, fs, st, hitbuf, materials, textures, textured_params, nee)

    acc = torch.zeros((r, 3), dtype=torch.float32, device=device)
    segs = torch.zeros((r,), dtype=torch.float32, device=device)
    for s in range(spp // spp_batch):
        sidx = sample_offset + s * spp_batch + replica
        rng = smp.rng_init(pixel_index, sidx)
        origins, dirs, rng = generate_primary_rays(
            cam, config.width, config.height, px, py, rng,
            config.jittered, config.fis, config.depth_of_field)
        if config.clipping_planes:
            # camera clipping (rp_main.rgen:283-285): the origin on the near
            # plane; the far plane's distance along the ray for the peel
            cosc = torch.clamp((dirs * cam.forward).sum(dim=-1), min=1e-5)
            c_lo = torch.tensor(f32(cam.clip_start), device=device) / cosc
            clip_rem = torch.tensor(f32(cam.clip_end), device=device) / cosc - c_lo
            origins = origins + dirs * c_lo[:, None]
        state = pack_state(origins, dirs, rng, rb)
        orig = None
        start = 0
        if peel:
            # bounce 0 through the split kernels: the hit buffer carries the
            # far-plane filter and the first-hit AOVs (chit:191-290)
            hitbuf = trace_step(params[0], peel_scene, state)
            if config.clipping_planes:
                hitbuf[H_HIT] = torch.where(hitbuf[H_T] <= clip_rem, hitbuf[H_HIT], 0.0)
            if cutout_textured:
                hitbuf = textured_cutout_retrace(params[0], peel_scene, state, hitbuf,
                                                 materials, textures, textured_params)
            if first is not None:
                taps = tap_rows(hitbuf, materials, textures, textured_params)
                first.add(hitbuf, taps, materials, dirs, cam, spp)
            shade_step(params[0], peel_scene, state, hitbuf, materials, textures,
                       textured_params, nee)
            start = 1
        for bounce in range(start, config.max_bounces):
            if not bool((state[13] > 0.5).any()):
                break
            if split and (lod_k <= 0 or bounce < lod_k):
                split_bounce(params[bounce], scene, state)
            else:
                bounce_step(params[bounce], scene, state, nee)
            if sort_rays:
                order = torch.argsort(coherence_keys(state, scene_lo, scene_inv), stable=True)
                state = state[:, order]
                orig = order if orig is None else orig[order]
        if orig is not None:
            state = state[:, torch.argsort(orig)]

        radiance = unpack_radiance(state, rb)
        if config.has_dome:
            radiance = dome_pass(radiance, state, dome, uniforms,
                                 config.dome_light_camera_visible)
        # radiance clamp (rgen:488-494), per sample, before the replica sum
        max_v = radiance.max(dim=-1).values
        scale = torch.where(max_v > uniforms.max_sample_value,
                            uniforms.max_sample_value / torch.clamp(max_v, min=1e-20), 1.0)
        contrib = torch.clamp(radiance * scale[:, None], min=0.0)
        seg_rows = unpack_rows(state, 15, 1, rb)[:, 0]
        if spp_batch > 1:
            contrib = contrib.reshape(spp_batch, r, 3).sum(0)
            seg_rows = seg_rows.reshape(spp_batch, r).sum(0)
        acc = acc + contrib / spp
        segs = segs + seg_rows / spp
    if tile_perm is not None:
        # row i holds pixel tile_perm[i]
        acc = torch.zeros_like(acc).index_copy_(0, tile_perm, acc)
        segs = torch.zeros_like(segs).index_copy_(0, tile_perm, segs)
        if first is not None:
            first.unswizzle(tile_perm)
    if first is not None:
        return acc, segs, first.as_dict()
    if with_stats:
        return acc, segs
    return acc
