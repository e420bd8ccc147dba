"""Shared host/kernel interface constants.

The port's copy of the reference package's interface module: AOV
identifiers and channel counts, mesh flag bits, intersection constants and
the packed analytic-light arrays. Host code builds these with NumPy; the
kernels receive them as tensors.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np


class AovId(enum.IntEnum):
    """AOV identifiers (reference: src/gi/gtl/gi/Gi.h GiAovId and aovs.glsl:5-23)."""

    COLOR = 0
    NORMAL = 1
    NEE = 2
    BARYCENTRICS = 3
    TEXCOORDS = 4
    BOUNCES = 5
    CLOCK_CYCLES = 6
    OPACITY = 7
    TANGENTS = 8
    BITANGENTS = 9
    THIN_WALLED = 10
    OBJECT_ID = 11
    DEPTH = 12
    FACE_ID = 13
    INSTANCE_ID = 14
    DOUBLE_SIDED = 15
    ALBEDO = 16


def aov_bit(aov: AovId) -> int:
    """Mask bit for an AOV (reference: aovs.glsl:25-41)."""
    return 1 << int(aov)


# Per-AOV channel count of the framebuffer storage (renderBuffer.cpp:30-35).
AOV_CHANNELS: dict[AovId, int] = {
    AovId.COLOR: 4,
    AovId.NORMAL: 3,
    AovId.NEE: 3,
    AovId.BARYCENTRICS: 3,
    AovId.TEXCOORDS: 3,
    AovId.BOUNCES: 3,
    AovId.CLOCK_CYCLES: 1,
    AovId.OPACITY: 3,
    AovId.TANGENTS: 3,
    AovId.BITANGENTS: 3,
    AovId.THIN_WALLED: 3,
    AovId.OBJECT_ID: 1,
    AovId.DEPTH: 1,
    AovId.FACE_ID: 1,
    AovId.INSTANCE_ID: 1,
    AovId.DOUBLE_SIDED: 3,
    AovId.ALBEDO: 3,
}

# The id AOVs are int32 buffers (renderBuffer.cpp:30-35: Int32).
AOV_IS_INT: dict[AovId, bool] = {
    a: a in (AovId.OBJECT_ID, AovId.FACE_ID, AovId.INSTANCE_ID) for a in AovId}

# BSDF event types (reference: mdl_types.glsl BSDF_EVENT_*).
BSDF_EVENT_ABSORB = 0
BSDF_EVENT_DIFFUSE = 1
BSDF_EVENT_GLOSSY = 1 << 1
BSDF_EVENT_SPECULAR = 1 << 2
BSDF_EVENT_REFLECTION = 1 << 3
BSDF_EVENT_TRANSMISSION = 1 << 4
BSDF_EVENT_DIFFUSE_REFLECTION = BSDF_EVENT_DIFFUSE | BSDF_EVENT_REFLECTION
BSDF_EVENT_GLOSSY_REFLECTION = BSDF_EVENT_GLOSSY | BSDF_EVENT_REFLECTION
BSDF_EVENT_SPECULAR_TRANSMISSION = BSDF_EVENT_SPECULAR | BSDF_EVENT_TRANSMISSION

# Mesh flags (reference: rp_main.h BLAS_PAYLOAD_BITFLAG_*).
MESH_FLAG_FLIP_FACING = 1 << 0
MESH_FLAG_DOUBLE_SIDED = 1 << 1

FLOAT_MAX = np.float32(3.402823466e38)
FLOAT_MIN = np.float32(1.175494351e-38)

# barycentric edge slack: rays through a shared triangle edge must hit at
# least one of the adjacent triangles. Applied as u >= -eps, v >= -eps,
# u + v <= 1 + eps in every intersector.
BARY_EPS = np.float32(1e-6)

# Maximum number of texture slots (reference: rp_main.h MAX_TEXTURE_COUNT).
MAX_TEXTURE_COUNT = 65535


def f32(x: float) -> float:
    """Round a Python float to the nearest f32 value (what a kernel sees)."""
    return float(np.float32(x))


class LightArrays(NamedTuple):
    """Packed analytic light arrays, struct-of-arrays, NumPy.

    One fixed-capacity dense array per light type (the four light tables of
    the reference, Gi.cpp:211-232, and the structs of rp_main.h). Elements
    [0, count) are valid; remaining slots are zero.
    """

    sphere_pos: np.ndarray  # [S,3] f32
    sphere_radius: np.ndarray  # [S,3] f32 (ellipsoid radii xyz)
    sphere_emission: np.ndarray  # [S,3] f32 base emission
    sphere_area: np.ndarray  # [S] f32 surface area (0 => point light)
    sphere_diff_spec: np.ndarray  # [S,2] f32 diffuse/specular multipliers
    sphere_count: int

    distant_dir: np.ndarray  # [D,3] f32 (direction light travels)
    distant_angle: np.ndarray  # [D] f32 half-cone angle in radians
    distant_emission: np.ndarray  # [D,3] f32
    distant_inv_pdf: np.ndarray  # [D] f32
    distant_diff_spec: np.ndarray  # [D,2] f32
    distant_count: int

    rect_origin: np.ndarray  # [R,3] f32
    rect_t0: np.ndarray  # [R,3] f32 tangent frame
    rect_t1: np.ndarray  # [R,3] f32
    rect_size: np.ndarray  # [R,2] f32 width/height
    rect_emission: np.ndarray  # [R,3] f32
    rect_diff_spec: np.ndarray  # [R,2] f32
    rect_count: int

    disk_origin: np.ndarray  # [K,3] f32
    disk_t0: np.ndarray  # [K,3] f32
    disk_t1: np.ndarray  # [K,3] f32
    disk_radius: np.ndarray  # [K,2] f32 radiusX/radiusY
    disk_emission: np.ndarray  # [K,3] f32
    disk_diff_spec: np.ndarray  # [K,2] f32
    disk_count: int


def empty_light_arrays(capacity: int = 8) -> LightArrays:
    """All-empty light tables with the given per-type slot capacity."""
    c = capacity

    def f(*shape):
        return np.zeros((c,) + shape, np.float32)

    return LightArrays(
        sphere_pos=f(3), sphere_radius=f(3), sphere_emission=f(3),
        sphere_area=f(), sphere_diff_spec=f(2), sphere_count=0,
        distant_dir=f(3), distant_angle=f(), distant_emission=f(3),
        distant_inv_pdf=f(), distant_diff_spec=f(2), distant_count=0,
        rect_origin=f(3), rect_t0=f(3), rect_t1=f(3), rect_size=f(2),
        rect_emission=f(3), rect_diff_spec=f(2), rect_count=0,
        disk_origin=f(3), disk_t0=f(3), disk_t1=f(3), disk_radius=f(2),
        disk_emission=f(3), disk_diff_spec=f(2), disk_count=0,
    )
