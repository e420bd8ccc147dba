"""Render configuration, per-frame uniforms and progressive accumulation.

The parts of the JAX package's render/integrator.py that the fused render
path uses: RenderConfig (the reference's structural shader #defines,
GlslShaderGen.cpp:79-91), Uniforms (the UniformData analog, rp_main.h:25-55)
and blend_aovs for the COLOR AOV (rp_main.rgen:506-515). The dome-light
data arrives with dome lights (ROADMAP: 'Dome lights').
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gatling_tpu_torch.interface import AovId, aov_bit
from gatling_tpu_torch.render.camera import CameraUniforms


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
    # texture means (render setting textureLodBounces)
    tex_lod_bounces: int = 0


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


def blend_aovs(config: RenderConfig, uniforms: Uniforms,
               aovs: dict[str, torch.Tensor], color: torch.Tensor) -> dict[str, torch.Tensor]:
    """Blend one frame's mean color [N,3] into the COLOR AOV with
    progressive accumulation (reference: rp_main.rgen:506-515)."""
    rgba = torch.cat([color, torch.ones_like(color[:, :1])], dim=-1)
    offset = float(uniforms.sample_offset)
    prev_used = aovs["color"] if config.progressive and offset > 0.0 else rgba
    out = dict(aovs)
    out["color"] = (prev_used * offset + rgba * float(config.spp)) * uniforms.inv_total_sample_count
    return out
