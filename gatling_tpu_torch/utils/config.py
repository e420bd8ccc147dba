"""Render-settings registry.

Reimplements the reference's triple-use setting descriptor pattern
(reference: src/hdGatling/renderDelegate.cpp:93-115 — HdRenderSettingDescriptors
drive the usdview UI, the Houdini DS file, the Blender addon properties AND
the auto-generated CLI flags in src/gatling/Argparse.cpp:150-159). Here a
single `SETTING_DESCRIPTORS` table feeds `RenderSettings` defaults, the CLI
argument parser, and per-scene UsdRenderSettings overrides in tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class SettingDescriptor:
    name: str  # camelCase setting token (matches reference tokens.h names)
    type: type  # bool | int | float
    default: Any
    help: str
    debug_only: bool = False  # locked in release builds (renderDelegate.cpp:145-158)


# Defaults mirror renderDelegate.cpp:93-110.
SETTING_DESCRIPTORS: list[SettingDescriptor] = [
    SettingDescriptor("spp", int, 1, "samples per pixel"),
    SettingDescriptor("maxBounces", int, 13, "max path bounces"),
    SettingDescriptor("rrBounceOffset", int, 3, "russian roulette bounce offset"),
    SettingDescriptor("rrInvMinTermProb", float, 0.95, "russian roulette inverted min. termination probability"),
    SettingDescriptor("maxSampleValue", float, 10.0, "max luminance of a radiance sample"),
    SettingDescriptor("maxVolumeWalkLength", int, 7, "max number of volume scattering events"),
    SettingDescriptor("mediumStackSize", int, 0, "nested volume stack size (0 disables volumes)"),
    SettingDescriptor("filterImportanceSampling", bool, True, "filter importance sampling (Gauss kernel)"),
    SettingDescriptor("jitteredSampling", bool, True, "jittered pixel sampling", debug_only=False),
    SettingDescriptor("nextEventEstimation", bool, False, "next event estimation (explicit light sampling)"),
    SettingDescriptor("depthOfField", bool, False, "depth of field"),
    SettingDescriptor("clippingPlanes", bool, False, "camera clipping planes"),
    SettingDescriptor("lightIntensityMultiplier", float, 1.0, "multiplier on all light intensities"),
    SettingDescriptor("metersPerSceneUnit", float, 1.0, "meters per scene unit"),
    SettingDescriptor("progressiveAccumulation", bool, True, "progressive sample accumulation", debug_only=True),
    SettingDescriptor("domeLightCameraVisible", bool, True, "dome light visible to camera"),
    # no reference counterpart: shard a fused COLOR frame's pixels across N
    # devices (parallel/sharding.py), clamped to the devices present
    SettingDescriptor("parallelDevices", int, 1, "shard the frame across N devices (1 = single device)"),
    SettingDescriptor("frame", float, 0.0,
                      "USD timecode to render: resolves authored "
                      "timeSamples (nearest sample) and animated "
                      "frame/time material nodes"),
    SettingDescriptor("textureLodBounces", int, 0,
                      "texture LOD: bounces >= N shade with texture means "
                      "(top mip; 0 = exact taps every bounce; measured "
                      "recommendation 2: 2.1x textured throughput at mean "
                      "FLIP 0.00018 vs exact — see PERF.md)"),
]


def default_settings() -> dict[str, Any]:
    return {d.name: d.default for d in SETTING_DESCRIPTORS}


def descriptor(name: str) -> SettingDescriptor:
    for d in SETTING_DESCRIPTORS:
        if d.name == name:
            return d
    raise KeyError(name)
