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
"""

from __future__ import annotations

import numpy as np
import torch

from gatling_tpu_torch.interface import AovId, aov_bit
from gatling_tpu_torch.ops import sampling as smp
from gatling_tpu_torch.ops.bounce import (
    FusedScene,
    bounce_step,
    make_params,
    pack_state,
    shade_step,
    trace_step,
    unpack_radiance,
    unpack_rows,
)
from gatling_tpu_torch.render.camera import generate_primary_rays
from gatling_tpu_torch.render.integrator import RenderConfig, Uniforms
from gatling_tpu_torch.render.material import MaterialTable
from gatling_tpu_torch.render.texture import TexturePool

# samples of one pixel traced together in one ray wave, up to this many rays
SPP_BATCH_RAYS = 4194304
# the AOVs the JAX package's fused kernels write (render/fused.py:116-118);
# a request of others renders through the wavefront integrator. The port's
# fused path writes COLOR only so far (ROADMAP item 5b).
FUSED_AOV_MASK = (aov_bit(AovId.COLOR) | aov_bit(AovId.NORMAL) | aov_bit(AovId.ALBEDO)
                  | aov_bit(AovId.DEPTH) | aov_bit(AovId.TEXCOORDS))


def spp_batch_size(r: int, spp: int) -> int:
    """Largest divisor of spp whose wave stays within SPP_BATCH_RAYS rays."""
    if spp <= 1 or r < 128:
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


def render_pixels_fused(config: RenderConfig, uniforms: Uniforms, scene: FusedScene,
                        pixel_index: torch.Tensor, spp: int, sample_offset: int,
                        with_stats: bool = False, materials: MaterialTable | None = None,
                        textures: TexturePool | None = None,
                        textured_params: tuple[str, ...] = ()):
    """Mean color [R,3] over spp samples of the pixels `pixel_index`; with
    with_stats also the mean traced-segment count per sample [R] (path
    segments + NEE shadow rays: the Mray/s accounting source). With
    `textures` (and the raw device `materials` and the textured parameter
    names) the bounces split into trace and shade."""
    if config.has_dome:
        raise NotImplementedError("dome lights are not ported yet (ROADMAP: 'Dome lights')")
    if config.clipping_planes:
        raise NotImplementedError(
            "camera clipping planes are not ported yet "
            "(ROADMAP: 'First-hit AOVs, clipping and textured cutout')")
    device = pixel_index.device
    r = pixel_index.shape[0]
    pixel_index = pixel_index.to(torch.int64)
    # several samples per pixel in one wave: the sample index of replica k
    # in step s is offset + s * batch + k, the same stream as one sample
    # per step
    spp_batch = spp_batch_size(r, spp)
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
    lod_k = config.tex_lod_bounces if textures is not None else 0

    acc = torch.zeros((r, 3), dtype=torch.float32, device=device)
    segs = torch.zeros((r,), dtype=torch.float32, device=device)
    for s in range(spp // spp_batch):
        sidx = sample_offset + s * spp_batch + replica
        rng = smp.rng_init(pixel_index, sidx)
        origins, dirs, rng = generate_primary_rays(
            uniforms.camera, config.width, config.height, px, py, rng,
            config.jittered, config.fis, config.depth_of_field)
        state = pack_state(origins, dirs, rng, rb)
        orig = None
        for bounce in range(config.max_bounces):
            if not bool((state[13] > 0.5).any()):
                break
            if textures is not None and (lod_k <= 0 or bounce < lod_k):
                hitbuf = trace_step(params[bounce], scene, state)
                shade_step(params[bounce], scene, state, hitbuf, materials, textures,
                           textured_params, nee)
            else:
                bounce_step(params[bounce], scene, state, nee)
            if sort_rays:
                order = torch.argsort(coherence_keys(state, scene_lo, scene_inv), stable=True)
                state = state[:, order]
                orig = order if orig is None else orig[order]
        if orig is not None:
            state = state[:, torch.argsort(orig)]

        # radiance clamp (rgen:488-494), per sample, before the replica sum
        radiance = unpack_radiance(state, rb)
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
    if with_stats:
        return acc, segs
    return acc
