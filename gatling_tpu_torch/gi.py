"""Public render-engine API ("gi" layer) of the port.

Pythonic mirror of the reference's C API surface (reference:
src/gi/gtl/gi/Gi.h:199-261): scenes, render buffers, AOV bindings and
giRender with the dirty-flag engine and the progressive accumulation
contract (sampleOffset persists across renders and resets when the
framebuffer is invalidated, Gi.cpp:2125-2129,2515).

The port renders on one device through one of two paths, chosen as the
JAX package chooses (gatling_tpu/gi.py:650-700):

* the fused bounce kernels, for a request of COLOR and the first-hit AOVs
  of FUSED_AOV_MASK (NORMAL, ALBEDO, DEPTH, TEXCOORDS) of a scene of any
  size, instanced or not, untextured or with UsdUVTexture textures (8-bit
  PNG, or EXR and Radiance HDR in a float pool) and normal maps, under a
  dome light or not, with the full lobe set (refraction, clearcoat,
  anisotropy), cutout opacity (textured too) and camera clipping planes.
  Above 4096 triangles a scene takes the two-level walk, in instance
  tables when the JAX package's rule picks them (ops/bounce.py MIN_GAIN),
  else in flattened clustered tables. An untextured scene runs one kernel
  a bounce (K1 resident, K2 walk); a textured or anisotropic one the split
  bounce (K3 trace, K4 shade with its own texture taps: anisotropy's frame
  is the mesh tangent of the hit buffer's tangent rows). First-hit AOVs
  and clipping planes peel bounce 0 off through K3 and K4 (render/fused.py),
  an opacity texture re-traces what its cutout rejects;
* the wavefront integrator (render/integrator.py) when an AOV outside
  FUSED_AOV_MASK is bound, a material reads per-vertex colours or has
  view-, normal- or primvar-dependent inputs (evaluated per hit) or an MDL
  backface surface (its appended row shades back-facing hits), or the
  media need a stack of 2 or more: every AOV and cutout (textured too),
  traced by K5 (closest hit) and K6 (shadow rays) for scenes of at most
  8192 triangles and above that by B1 and B2, the walks of the JAX
  package's threaded BVH (`_choose_tracer`; the tree is built at the first
  wavefront frame, over the soup it reorders, and a fused frame never
  builds it).

Scene content reaches both paths as plain tables: a UsdSkel mesh is
skinned at load (scene/skel.py), a binary .usdc or a .usdz reads through
scene/crate.py, a MaterialX document through render/mtlx.py
(`giCreateMaterialFromMtlxStr`, `giCreateMaterialFromMtlxDoc`), and a
shader graph that is not affine in one texture (two textures in a node,
clamp or texcoord math, the procedural generators) is baked into a slot
of the texture pool. Frame and time nodes fold at the `frame` setting;
when it changes, `render` lowers the animated materials anew
(`_relower_animated`) and keeps the pool and the fused tables where it can.

The front ends of the JAX package are ported: the C-style `gi*` surface
(meshes registered in a versioned handle store, whose slot is the mesh's
stable OBJECT_ID, and compressed at registration; the analytic lights'
create, destroy and setter calls; materials), the accumulation
checkpoints (`giSaveCheckpoint` / `giLoadCheckpoint`, the JAX package's
file format), the validation layer (GATLING_VALIDATE=1, ops/validate.py)
and `parallelDevices`: a fused COLOR frame shards its pixels over that many
cards (parallel/sharding.py), clamped to the cards present. A variant the
port does not read raises NotImplementedError naming its ROADMAP item; the
port never renders something else.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import math
import os
import time
import weakref
from typing import Any

import numpy as np
import torch

from gatling_tpu_torch import imgio
from gatling_tpu_torch.interface import AOV_CHANNELS, AOV_IS_INT, AovId, aov_bit, f32
from gatling_tpu_torch.ops.bounce import (
    MAX_SCATTER_MATS,
    FusedScene,
    FusedStatic,
    UniqueClusters,
    _material_pass,
    advanced_from_table,
    aniso_from_table,
    build_fused_scene_instanced,
    build_fused_scene_with_order,
    has_scattering,
    refit_instanced,
    with_volumes,
)
from gatling_tpu_torch.ops.bvh import build_bvh, reorder_geometry, threaded_bvh
from gatling_tpu_torch.ops.geometry import (
    build_geometry_cached,
    build_instance_primvar_tables,
    pack_geometry,
    update_instance_transforms,
)
from gatling_tpu_torch.ops import validate
from gatling_tpu_torch.ops.trace import build_trace_tables
from gatling_tpu_torch.render.assets import gi_register_asset_reader  # noqa: F401
from gatling_tpu_torch.render.camera import camera_uniforms
from gatling_tpu_torch.render.fused import FUSED_AOV_MASK, render_pixels_fused
from gatling_tpu_torch.render.integrator import (
    Accel,
    DomeLightData,
    RenderConfig,
    SampleResult,
    Uniforms,
    blend_aovs,
    default_dome,
    empty_first_hit,
    render_frame,
)
from gatling_tpu_torch.render.lights import build_light_arrays, light_tensors
from gatling_tpu_torch.render.material import (
    MaterialTable,
    build_material_table,
    build_materials,
    lower_material,
    substitute_texture_means,
    texture_slots,
    textured_params,
)
from gatling_tpu_torch.render.shadergraph import expr_dynamic_beyond, expr_reads_primvar
from gatling_tpu_torch.render.texture import TextureManager
from gatling_tpu_torch.scene import meshproc
from gatling_tpu_torch.scene.stage import CameraDesc, LightDesc, MaterialDesc, MeshDesc
from gatling_tpu_torch.utils.config import default_settings
from gatling_tpu_torch.utils.handles import LinearDataStore
from gatling_tpu_torch.utils.log import get_logger, init_logging


class DirtyFlags(enum.IntFlag):
    """Reference: Gi.cpp:195-209."""

    CLEAN = 0
    GEOMETRY = 1 << 0
    FRAMEBUFFER = 1 << 1
    MATERIALS = 1 << 2
    LIGHTS = 1 << 4
    TRANSFORMS = 1 << 5  # transform-only edits: refit, no geometry rebuild
    ALL = GEOMETRY | FRAMEBUFFER | MATERIALS | LIGHTS


class GiRenderBuffer:
    """Host render target (reference: renderBuffer.cpp, giCreateRenderBuffer)."""

    def __init__(self, width: int, height: int, channels: int = 4, is_int: bool = False) -> None:
        self.width = width
        self.height = height
        self.channels = channels
        self.data = np.zeros((height, width, channels), np.int32 if is_int else np.float32)


@dataclasses.dataclass
class GiAovBinding:
    aov_id: AovId
    render_buffer: GiRenderBuffer
    clear_value: Any = None


@dataclasses.dataclass
class GiDomeLight:
    file_path: str | None = None
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 0, 0, 1.0], np.float32))  # quaternion (x, y, z, w)
    base_emission: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))
    diffuse: float = 1.0
    specular: float = 1.0


class GiScene:
    """Mutable scene container (reference: struct GiScene, Gi.cpp:211-232),
    whose device tables live on `device`.

    Meshes register in a versioned LinearDataStore (the gb HandleStore
    pattern, HandleStore.h:28-42; gatling_tpu/gi.py:100-215): a removed
    mesh's handle goes stale, and the handle's slot is the mesh's
    OBJECT_ID, so removing a mesh does not renumber the survivors."""

    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = torch.device(device)
        self.meshes: list[MeshDesc] = []
        self._mesh_store = LinearDataStore()
        self._mesh_handles: dict[int, int] = {}  # id(mesh desc) -> handle
        self._compress_cache: dict[int, meshproc.CompressedMesh] = {}  # id(source) -> payload
        self.materials: dict[str, MaterialDesc] = {}
        self.lights: list[LightDesc] = []
        self.dome_light: GiDomeLight | None = None
        self.sample_offset = 0
        self.dirty = DirtyFlags.ALL
        self._geom = None
        self._geom_cache = None
        self._pending_transforms: list[MeshDesc] = []
        self._material_index: dict[str | None, int] = {}
        self._lowered_materials: list = []
        self._lowered_frame = 0.0  # the frame value the materials were lowered at
        self._material_table = None
        self._texture_manager = TextureManager()  # decoded textures, by path
        self._texture_pool = None
        self._material_dev = None  # the material table on the device, for the texture stage
        self._light_arrays = None
        self._light_dev = None  # the light tables on the device, for the wavefront
        self._tracer = "matrix"  # the wavefront's tracer (_choose_tracer)
        self._accel: Accel | None = None  # its tables, built at the first wavefront frame
        self._packed = None  # the soup's packed rows on the device (wavefront shading)
        self._fused: FusedScene | None = None
        self._fused_static: FusedStatic | None = None
        self._fused_order: np.ndarray | None = None  # flattened clustered order
        self._clusters: UniqueClusters | None = None  # instanced: the unique clusters
        self._aov_state: dict[str, torch.Tensor] | None = None  # accumulated AOVs
        self._fb_shape: tuple[int, int] | None = None
        self._restored_checkpoint = False  # giLoadCheckpoint's state awaits its first render
        self._last_params_key = None
        self.last_segments: float = 0.0  # traced segments of the last render

    def add_mesh(self, mesh: MeshDesc) -> MeshDesc:
        """Register a mesh: its OBJECT_ID is its handle's slot, and its
        buffers are compressed (byteshuffle + deflate, the giProcessMeshData
        analog, MeshProcessing.cpp:144-212) until the geometry build;
        GATLING_COMPRESS_MESHES=0 keeps them raw."""
        handle = self._mesh_store.allocate(mesh)
        self._mesh_handles[id(mesh)] = handle
        mesh.object_id = handle & 0xFFFFFFFF
        if (os.environ.get("GATLING_COMPRESS_MESHES", "1") != "0"
                and not isinstance(mesh.mesh, meshproc.CompressedMesh)):
            # one payload a source: descs that share a mesh (instances,
            # sphere fields) keep sharing one object, on which the instanced
            # builder dedups. The id() key goes when the source dies: a
            # recycled id once served a dead mesh's payload to a new mesh
            # (gatling_tpu/gi.py:155-162)
            src = mesh.mesh
            cached = self._compress_cache.get(id(src))
            if cached is None:
                cached = meshproc.compress_mesh(src)
                self._compress_cache[id(src)] = cached
                weakref.finalize(src, self._compress_cache.pop, id(src), None)
            mesh.mesh = cached
        self.meshes.append(mesh)
        self.dirty |= DirtyFlags.GEOMETRY | DirtyFlags.FRAMEBUFFER
        return mesh

    def remove_mesh(self, mesh: MeshDesc) -> None:
        """Unregister a mesh; its slot is reused by the next one. A mesh
        this scene does not hold (a stale handle) raises KeyError."""
        handle = self._mesh_handles.pop(id(mesh), None)
        if handle is None or not self._mesh_store.is_valid(handle):
            raise KeyError("mesh is not registered with this scene (stale handle)")
        self._mesh_store.free(handle)
        self.meshes.remove(mesh)
        self.dirty |= DirtyFlags.GEOMETRY | DirtyFlags.FRAMEBUFFER

    def set_mesh_transform(self, mesh: MeshDesc, transform: np.ndarray) -> None:
        """Move a mesh. Once its geometry is built, only its placements are
        re-transformed at the next render and the fused tables refit."""
        mesh.transform = np.asarray(transform, np.float64)
        if self._geom_cache is not None and not (self.dirty & DirtyFlags.GEOMETRY):
            self._pending_transforms.append(mesh)
            self.dirty |= DirtyFlags.TRANSFORMS | DirtyFlags.FRAMEBUFFER
        else:
            self.dirty |= DirtyFlags.GEOMETRY | DirtyFlags.FRAMEBUFFER

    def set_mesh_material(self, mesh: MeshDesc, material_path: str) -> None:
        mesh.material = material_path
        self.dirty |= DirtyFlags.GEOMETRY | DirtyFlags.MATERIALS | DirtyFlags.FRAMEBUFFER

    def add_material(self, mat: MaterialDesc) -> None:
        self.materials[mat.path] = mat
        self.dirty |= DirtyFlags.MATERIALS | DirtyFlags.FRAMEBUFFER

    def add_light(self, light: LightDesc) -> None:
        self.lights.append(light)
        self.dirty |= DirtyFlags.LIGHTS | DirtyFlags.FRAMEBUFFER

    def remove_light(self, light: LightDesc) -> None:
        self.lights.remove(light)
        self.dirty |= DirtyFlags.LIGHTS | DirtyFlags.FRAMEBUFFER

    def set_dome_light(self, dome: GiDomeLight | None) -> None:
        self.dome_light = dome
        self.dirty |= DirtyFlags.LIGHTS | DirtyFlags.FRAMEBUFFER


@dataclasses.dataclass
class GiRenderParams:
    """Reference: struct GiRenderParams (Gi.h)."""

    scene: GiScene
    camera: CameraDesc
    aov_bindings: list[GiAovBinding]
    render_settings: dict[str, Any] = dataclasses.field(default_factory=default_settings)
    dome_light: GiDomeLight | None = None


def gi_initialize() -> None:
    """giInitialize (Gi.cpp:362-441): logging."""
    init_logging()


def gi_terminate() -> None:
    """giTerminate: nothing to release; the kernels' builds stay loaded."""


def create_scene(device: str | torch.device = "cuda") -> GiScene:
    """giCreateScene. A CUDA device must exist: the port never falls back
    to the CPU on its own."""
    gi_initialize()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to render with the plain twin")
    if device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"device {device} is not supported")
    return GiScene(device)


def _params_key(params: GiRenderParams, width: int, height: int):
    """Camera + settings fingerprint for dirty detection
    (reference: _CalcDirtyFlagsForRenderParams Gi.cpp:1859-1987)."""
    c = params.camera
    dome = params.dome_light or params.scene.dome_light
    return (
        tuple(np.asarray(c.position, np.float32)), tuple(np.asarray(c.forward, np.float32)),
        tuple(np.asarray(c.up, np.float32)), c.vfov, c.f_stop, c.focus_distance,
        c.focal_length, c.clip_start, c.clip_end, c.exposure,
        tuple(sorted((k, str(v)) for k, v in params.render_settings.items())),
        width, height,
        (dome.file_path, tuple(np.asarray(dome.rotation, np.float32).tolist()),
         tuple(np.asarray(dome.base_emission, np.float32).tolist())) if dome else None,
    )


# the largest scene the brute-force kernels K5/K6 trace (gatling_tpu/gi.py:269)
MATRIX_MAX_TRIS = 8192


def _choose_tracer(geom) -> str:
    """The wavefront's tracer (gatling_tpu/gi.py:272-286, with the TPU's
    rule on either device): the brute-force kernels up to MATRIX_MAX_TRIS
    triangles, the threaded BVH above. GATLING_TRACER forces one, as in
    the JAX package: "pallas" (the port's K5/K6, "matrix"), "bvh" (B1/B2)
    or "brute" (the plain Moller-Trumbore of ops/intersect.py, which runs
    no kernel of the port's on either device: a request, not a fallback)."""
    forced = os.environ.get("GATLING_TRACER")
    if forced in ("brute", "pallas", "bvh"):
        return "matrix" if forced == "pallas" else forced
    return "matrix" if geom.num_triangles <= MATRIX_MAX_TRIS else "bvh"


def _build_accel(scene: GiScene) -> None:
    """The wavefront's tracer data and packed shading rows on the device
    (gatling_tpu/gi.py:289-303, :350-360): K5/K6's trace tables, or the
    threaded BVH of B1/B2 over the soup in the tree's order, which the
    packed rows (every table the wavefront reads by triangle index) follow.
    The fused tables keep the soup's own order (scene._geom)."""
    t0 = time.monotonic()
    geom = scene._geom
    if scene._tracer == "matrix":
        scene._accel = Accel(tables=build_trace_tables(geom, scene.device))
    elif scene._tracer == "brute":
        scene._accel = Accel(soup=geom)
    else:
        arrays, order = build_bvh(geom.v0, geom.e1, geom.e2)
        geom = reorder_geometry(geom, order)
        scene._accel = Accel(bvh=threaded_bvh(arrays, geom, scene.device))
    scene._packed = pack_geometry(geom, scene.device)
    get_logger().info("built the %s tracer's data over %d triangles in %.1f ms", scene._tracer,
                      geom.num_triangles, 1e3 * (time.monotonic() - t0))


def _resolvable_primvars(scene: GiScene) -> set:
    """The primvars a hit can read (gatling_tpu/gi.py:363-373): the
    interpolated displayColor and every mesh's instance-rate primvars."""
    out = {"displayColor"}
    for m in scene.meshes:
        out.update(getattr(m, "instance_primvars", None) or {})
    return out


def _dynamic_params(scene: GiScene) -> tuple:
    """(material index, parameter, Expr) of every dynamic input that needs
    per-hit evaluation (gatling_tpu/gi.py:402-406); one whose only dynamic
    leaves are primvars no hit carries keeps its fallback constant."""
    resolvable = _resolvable_primvars(scene)
    return tuple((idx, pname, expr) for idx, m in enumerate(scene._lowered_materials)
                 for pname, expr in sorted(m.dynamic.items())
                 if expr_dynamic_beyond(expr, resolvable))


def _build_config(params: GiRenderParams, width: int, height: int, aov_mask: int) -> RenderConfig:
    s = params.render_settings
    scene = params.scene
    return RenderConfig(
        width=width,
        height=height,
        spp=int(s.get("spp", 1)),
        max_bounces=int(s.get("maxBounces", 13)),
        rr_bounce_offset=int(s.get("rrBounceOffset", 3)),
        jittered=bool(s.get("jitteredSampling", True)),
        fis=bool(s.get("filterImportanceSampling", True)),
        nee=bool(s.get("nextEventEstimation", False)),
        depth_of_field=bool(s.get("depthOfField", False)),
        clipping_planes=bool(s.get("clippingPlanes", False)),
        progressive=bool(s.get("progressiveAccumulation", True)),
        aov_mask=aov_mask,
        dome_light_camera_visible=bool(s.get("domeLightCameraVisible", True)),
        has_dome=(params.dome_light or scene.dome_light) is not None,
        tex_lod_bounces=int(s.get("textureLodBounces", 0)),
        tracer=scene._tracer,
        has_volumes=any(any(c > 0.0 for c in m.params["volume_absorption"])
                        or any(c > 0.0 for c in m.params["volume_scattering"])
                        for m in scene._lowered_materials),
        medium_stack_size=int(s.get("mediumStackSize", 0)),
        has_cutout=any(m.traits.has_cutout for m in scene._lowered_materials),
        dynamic_params=_dynamic_params(scene),
        has_backface=any(m.backface for m in scene._lowered_materials),
    )


_AOV_KEYS = {
    AovId.COLOR: "color", AovId.NORMAL: "normal", AovId.NEE: "nee",
    AovId.BARYCENTRICS: "barycentrics", AovId.TEXCOORDS: "texcoords",
    AovId.BOUNCES: "bounces", AovId.CLOCK_CYCLES: "clock_cycles",
    AovId.OPACITY: "opacity", AovId.TANGENTS: "tangents",
    AovId.BITANGENTS: "bitangents", AovId.THIN_WALLED: "thin_walled",
    AovId.OBJECT_ID: "object_id", AovId.DEPTH: "depth",
    AovId.FACE_ID: "face_id", AovId.INSTANCE_ID: "instance_id",
    AovId.DOUBLE_SIDED: "double_sided", AovId.ALBEDO: "albedo",
}


def _init_aov_state(bindings: list[GiAovBinding], n: int, device) -> dict[str, torch.Tensor]:
    """One buffer a bound AOV ([n] or [n, channels], int32 for the ids),
    holding the binding's clear value (zeros without one)."""
    state = {}
    for b in bindings:
        ch = AOV_CHANNELS[b.aov_id]
        dtype = torch.int32 if AOV_IS_INT[b.aov_id] else torch.float32
        shape = (n,) if ch == 1 else (n, ch)
        cv = 0 if b.clear_value is None else np.asarray(b.clear_value).reshape(-1)[:ch]
        state[_AOV_KEYS[b.aov_id]] = torch.broadcast_to(
            torch.as_tensor(cv, dtype=dtype, device=device), shape).clone()
    return state


def _uses_vertex_colours(scene: GiScene) -> bool:
    """A material reads per-vertex displayColor (multiplies it into its
    base colour, or a dynamic input reads a primvar) and a mesh carries
    such colours (gatling_tpu/gi.py:670-679)."""
    vcolor = any(m.params.get("vcolor_mul", 0.0)
                 or any(expr_reads_primvar(e) for e in m.dynamic.values())
                 for m in scene._lowered_materials)
    return vcolor and any(getattr(m.mesh, "colors", None) is not None for m in scene.meshes)


def _parallel_devices(settings: dict, device: torch.device) -> int:
    """The parallelDevices setting clamped to the cards present
    (gatling_tpu/gi.py:440-449): 1 on the CPU or on a one-card host, where
    the frame renders on the scene's device. Never a CPU render."""
    want = int(settings.get("parallelDevices", 1) or 1)
    if want <= 1:
        return 1
    have = torch.cuda.device_count() if device.type == "cuda" else 1
    if want > have:
        get_logger().info("parallelDevices=%d clamped to the %d %s device(s) present", want,
                          have, device.type)
    return max(1, min(want, have))


def _opacity_textures(lowered: list) -> bool:
    return any("opacity" in m.textures for m in lowered)


def shadow_cutout_pass(lowered: list, manager: TextureManager) -> np.ndarray | None:
    """[M] the NEE shadow walk's cutout pass probability per material
    (gatling_tpu/gi.py:306-333): an opacity texture's UV-mean pass rate
    (the share of its texels at or above the opacity threshold, or its
    mean opacity without one), else the untextured rule. The walk cannot
    tap textures, so it draws against the mean. None when no material has
    an opacity texture: the camera values serve both walks."""
    if not _opacity_textures(lowered):
        return None
    out = np.ones(len(lowered), np.float32)
    for i, m in enumerate(lowered):
        th = float(m.params.get("opacity_threshold", 0.0) or 0.0)
        ref = m.textures.get("opacity")
        if ref is not None:
            out[i] = manager.pass_rate(ref, th)
        else:
            op = float(m.params.get("opacity", 1.0))
            out[i] = float(op >= th) if th > 0.0 else op
    return np.clip(out, 0.0, 1.0)


def _textured(scene: GiScene) -> bool:
    """The scene's pool holds textures, 8-bit or float (gatling_tpu/gi.py
    :345-346, :656-658)."""
    pool = scene._texture_pool
    return pool is not None and pool.has_texels


def _split(scene: GiScene) -> bool:
    """The scene renders through the split bounce: it is textured, or
    anisotropic (the hit buffer's tangent rows frame the lobe)."""
    return _textured(scene) or aniso_from_table(scene._material_table)


def _volumes_fused(scene: GiScene, config: RenderConfig) -> bool:
    """The fused kernels render the scene's media (gatling_tpu/gi.py
    :687-698, render/fused.py :142-143): absorption at mediumStackSize 0,
    the depth-1 medium stack at 1 with at most 63 materials and no
    scattering in a textured or anisotropic scene (the split bounce has no
    free flight); deeper stacks take the wavefront."""
    if not config.has_volumes:
        return True
    if config.medium_stack_size >= 2:
        return False
    return config.medium_stack_size == 0 or (
        len(scene._lowered_materials) <= MAX_SCATTER_MATS
        and not (has_scattering(scene._material_table) and _split(scene)))


def _fused_volumes(scene: GiScene, config: RenderConfig) -> tuple[FusedScene, FusedStatic]:
    """The fused tables with the frame's volume mode (gatling_tpu/gi.py
    :739-747), set anew every frame: absorption, or the scatter mode at
    mediumStackSize 1 for an untextured, isotropic scene."""
    fused, static = scene._fused, scene._fused_static
    if not config.has_volumes:
        return fused, static
    return with_volumes(fused, static, config.medium_stack_size == 1 and not _split(scene))


def _with_split(scene: GiScene, static: FusedStatic) -> FusedStatic:
    """The static of a textured or anisotropic scene names its textured
    parameters: it renders through the split bounce, whose hit buffer
    carries the mesh tangents that frame anisotropy (gatling_tpu/gi.py
    :681-686, :748-756; an untextured one with the empty texture pool)."""
    if not _split(scene):
        return static
    return dataclasses.replace(static, textured=True,
                               textured_params=textured_params(scene._lowered_materials),
                               cutout_textured=_opacity_textures(scene._lowered_materials))


def _fused_mat_table(scene: GiScene) -> MaterialTable:
    """The kernels' material table (gatling_tpu/gi.py:336-349): in a
    textured scene the textured columns hold the texture means, which K4
    never reads (the texture stage's rows override them) and the
    textureLodBounces bounces shade with."""
    if _textured(scene):
        return substitute_texture_means(scene._material_table, scene._texture_pool)
    return scene._material_table


def _build_fused(scene: GiScene) -> None:
    """The fused tables (gatling_tpu/gi.py:706-756): instance tables
    first, the flattened build when the scene does not take them."""
    table = _fused_mat_table(scene)
    shadow_pass = shadow_cutout_pass(scene._lowered_materials, scene._texture_manager)
    scene._clusters = UniqueClusters()
    res = build_fused_scene_instanced(scene.meshes, scene._material_index, table,
                                      scene._light_arrays, scene.device,
                                      clusters=scene._clusters, shadow_pass=shadow_pass)
    scene._fused_order = None
    if res is not None:
        scene._fused, scene._fused_static = res
        get_logger().info("instanced fused scene: %d instances x %d unique clusters "
                          "(flattened would be %d triangles)", scene._fused_static.n_instances,
                          scene._fused_static.n_clusters, scene._fused_static.n_tris)
    else:
        scene._fused, scene._fused_static, scene._fused_order = build_fused_scene_with_order(
            scene._geom, table, scene._light_arrays, scene.device, shadow_pass=shadow_pass)
        get_logger().info("flattened fused scene: %d triangles, %s", scene._fused_static.n_tris,
                          "clustered" if scene._fused_static.clustered else "resident")
    scene._fused_static = _with_split(scene, scene._fused_static)


def _refit_fused(scene: GiScene) -> None:
    """Transform-only refresh (gatling_tpu/gi.py:518-564): instanced scenes
    rebuild only their instance tables over the cached unique clusters,
    which do not move; flattened ones refit their rows and boxes under the
    cached triangle order. A refit that leaves the instanced route drops
    the tables, to be built anew."""
    table = _fused_mat_table(scene)
    shadow_pass = shadow_cutout_pass(scene._lowered_materials, scene._texture_manager)
    if scene._fused_static.instanced:
        scene._fused = refit_instanced(scene._fused, scene._clusters, scene.meshes,
                                       scene._material_index, table, shadow_pass)
    else:
        scene._fused, static, scene._fused_order = build_fused_scene_with_order(
            scene._geom, table, scene._light_arrays, scene.device,
            reuse_order=scene._fused_order, shadow_pass=shadow_pass)
        scene._fused_static = _with_split(scene, static)


def _relower_animated(scene: GiScene, frame: float) -> None:
    """A frame change under animated materials (frame and time nodes;
    gatling_tpu/gi.py:566-579, which lowers every material anew): only the
    animated ones are lowered again at `frame`. While their texture requests
    stay the same the pool stays, and the material table is packed anew
    under the same slots; while the columns the fused tables derive from
    (the cutout pass, the lobe set, the shadow pass) stay the same too, the
    fused tables take the new material rows in place. Anything else
    rebuilds what depends on it, as a material edit does."""
    old_rows = scene._lowered_materials
    rows = list(old_rows)
    for path, idx in scene._material_index.items():
        if rows[idx].traits.is_animated:
            rows[idx] = lower_material(scene.materials.get(path) if path else None, frame)
    scene._lowered_frame = frame
    scene._lowered_materials = rows
    if [m.textures for m in rows] != [m.textures for m in old_rows]:
        scene._material_table, scene._texture_pool = build_materials(
            rows, scene._texture_manager, scene.device)
        scene._material_dev = scene._material_table.to(scene.device)
        scene._fused = None
        return
    old_fused = _fused_mat_table(scene)
    scene._material_table = build_material_table(rows, texture_slots(rows)[1])
    scene._material_dev = scene._material_table.to(scene.device)
    new_fused = _fused_mat_table(scene)
    same_shape = (np.array_equal(_material_pass(old_fused), _material_pass(new_fused))
                  and advanced_from_table(old_fused) == advanced_from_table(new_fused)
                  and aniso_from_table(old_fused) == aniso_from_table(new_fused)
                  and np.array_equal(shadow_cutout_pass(old_rows, scene._texture_manager),
                                     shadow_cutout_pass(rows, scene._texture_manager)))
    if scene._fused is not None and same_shape:
        scene._fused = scene._fused._replace(
            mats=torch.tensor(new_fused.packed_f, dtype=torch.float32, device=scene.device))
    else:
        scene._fused = None


def render(params: GiRenderParams) -> None:
    """giRender analog (reference: Gi.cpp:1989-2524): resolve dirty state,
    rebuild device tables, render the frame through the fused bounce
    kernels or the wavefront integrator, blend it into the AOV buffers and
    copy them to the host buffers.

    GATLING_VALIDATE=1 turns the validation layer on (gatling_tpu/gi.py
    :451-474): the card is synchronised after every kernel launch, whose
    outputs must be finite (ops/validate.py), and every AOV must be finite
    before the host copy. It changes no value of the frame."""
    if os.environ.get("GATLING_VALIDATE") == "1":
        with validate.validating():
            _render_impl(params, check=True)
        return
    _render_impl(params)


def _render_impl(params: GiRenderParams, check: bool = False) -> None:
    log = get_logger()
    scene = params.scene
    if not params.aov_bindings:
        raise ValueError("no AOV bindings")
    width = params.aov_bindings[0].render_buffer.width
    height = params.aov_bindings[0].render_buffer.height
    for b in params.aov_bindings:
        if (b.render_buffer.width, b.render_buffer.height) != (width, height):
            raise ValueError("all AOV buffers must have identical dimensions")
    n = width * height
    aov_mask = 0
    for b in params.aov_bindings:
        aov_mask |= aov_bit(b.aov_id)

    key = _params_key(params, width, height)
    if key != scene._last_params_key:
        scene.dirty |= DirtyFlags.FRAMEBUFFER
        scene._last_params_key = key

    if scene.dirty & DirtyFlags.GEOMETRY or scene._geom is None:
        t0 = time.monotonic()
        mat_paths = sorted({m.material for m in scene.meshes if m.material})
        scene._material_index = {p: i for i, p in enumerate(mat_paths)}
        scene._material_index[None] = len(mat_paths)
        scene._geom, scene._geom_cache = build_geometry_cached(scene.meshes,
                                                               scene._material_index)
        scene._tracer = _choose_tracer(scene._geom)
        scene._accel = None  # built at the first wavefront frame
        scene._fused = None
        scene._pending_transforms.clear()
        scene.dirty |= DirtyFlags.MATERIALS
        log.info("built geometry: %d triangles in %.1f ms", scene._geom.num_triangles,
                 1e3 * (time.monotonic() - t0))
    elif scene.dirty & DirtyFlags.TRANSFORMS and scene._pending_transforms:
        t0 = time.monotonic()
        pending = scene._pending_transforms
        scene._geom = update_instance_transforms(scene._geom_cache, pending,
                                                 scene._material_index)
        if scene._fused is not None:
            _refit_fused(scene)
        if scene._accel is not None:  # the trace tables follow (gatling_tpu/gi.py:532-534)
            _build_accel(scene)
        scene._pending_transforms = []
        log.info("refreshed %d transform(s) in %.1f ms (no geometry rebuild)", len(pending),
                 1e3 * (time.monotonic() - t0))
    frame = float(params.render_settings.get("frame", 0.0) or 0.0)
    if scene.dirty & DirtyFlags.MATERIALS or scene._material_table is None:
        rows = [None] * len(scene._material_index)
        for path, idx in scene._material_index.items():
            rows[idx] = lower_material(scene.materials.get(path) if path else None, frame)
        scene._lowered_frame = frame
        scene._lowered_materials = rows
        scene._material_table, scene._texture_pool = build_materials(
            rows, scene._texture_manager, scene.device)
        scene._material_dev = scene._material_table.to(scene.device)
        scene._fused = None
    elif frame != scene._lowered_frame and any(
            m.traits.is_animated for m in scene._lowered_materials):
        _relower_animated(scene, frame)
    if scene.dirty & DirtyFlags.LIGHTS or scene._light_arrays is None:
        scene._light_arrays = build_light_arrays(scene.lights)
        scene._light_dev = light_tensors(scene._light_arrays, scene.device)
        scene._fused = None
    if scene.dirty & DirtyFlags.FRAMEBUFFER or scene._fb_shape != (width, height):
        if scene._restored_checkpoint and scene._fb_shape == (width, height):
            # a restored checkpoint outlives the first render's framebuffer
            # reset (a fresh scene has every flag set; gatling_tpu/gi.py:595-605)
            scene._restored_checkpoint = False
        else:
            if scene._restored_checkpoint:
                log.error("checkpoint resolution %s does not match the framebuffer %s; "
                          "accumulation reset", scene._fb_shape, (width, height))
                scene._restored_checkpoint = False
            scene.sample_offset = 0
            scene._fb_shape = (width, height)
            scene._aov_state = None
    if scene._aov_state is None or set(scene._aov_state) != {
            _AOV_KEYS[b.aov_id] for b in params.aov_bindings}:
        scene._aov_state = _init_aov_state(params.aov_bindings, n, scene.device)
    scene.dirty = DirtyFlags.CLEAN

    config = _build_config(params, width, height, aov_mask)
    # the JAX package's route (gatling_tpu/gi.py:650-700): AOVs the fused
    # kernels do not write, vertex colours, dynamic inputs, backface
    # surfaces, or media the fused kernels do not carry take the wavefront
    # integrator; GATLING_FUSED=0 sends every frame there (gatling_tpu/gi.py:649-651)
    wavefront = (os.environ.get("GATLING_FUSED", "1") == "0"
                 or bool(aov_mask & ~FUSED_AOV_MASK) or _uses_vertex_colours(scene)
                 or bool(config.dynamic_params) or config.has_backface
                 or not _volumes_fused(scene, config))
    s = params.render_settings
    dome_obj = params.dome_light or scene.dome_light
    uniforms = frame_uniforms(params, config)
    dome = _load_dome(dome_obj, scene.device) if config.has_dome else None
    if wavefront:
        if scene._accel is None:
            _build_accel(scene)
        inst_pv = {name: torch.as_tensor(table, device=scene.device)
                   for name, table in build_instance_primvar_tables(scene.meshes).items()}
        if _parallel_devices(s, scene.device) > 1:
            # the JAX package shards the wavefront only for its brute tracer
            # (gatling_tpu/gi.py:822-836), which the port's routing never picks
            log.warning("parallelDevices: the wavefront integrator renders on one device")
        scene._aov_state = render_frame(config, uniforms, scene._packed, scene._material_dev,
                                        scene._light_dev, scene._aov_state,
                                        scene._texture_pool, scene._accel, dome,
                                        inst_pv or None)
        scene.last_segments = 0.0  # the wavefront does not count its segments
    else:
        if scene._fused is None:
            _build_fused(scene)
        pix = torch.arange(n, dtype=torch.int64, device=scene.device)
        scene._fused, scene._fused_static = _fused_volumes(scene, config)
        static = scene._fused_static
        # the first-hit AOVs, the clipping planes' peel and the re-trace
        # read the raw material table and the pool (gatling_tpu/gi.py:757-760)
        want_first = aov_mask != aov_bit(AovId.COLOR)
        tables = static.textured or want_first or config.clipping_planes
        materials = scene._material_dev if tables else None
        textures = scene._texture_pool if tables else None
        n_par = _parallel_devices(s, scene.device)
        if n_par > 1 and not want_first and n % n_par == 0:
            # the frame's pixels in n_par tiles, one a card (gatling_tpu/gi.py
            # :762-779); the JAX package also needs whole 128-ray Mosaic
            # blocks a tile (n % (n_par * 128)), a kernel here takes any count
            from gatling_tpu_torch.parallel.sharding import make_mesh, render_fused_sharded

            out = render_fused_sharded(config, uniforms, scene._fused, static, dome,
                                       make_mesh(n_tiles=n_par), materials, textures)
        else:
            if n_par > 1:
                log.warning("parallelDevices=%d requested but rendering on one device: %s",
                            n_par, "first-hit AOVs requested" if want_first
                            else f"pixel count {n} not divisible into {n_par} tiles")
            out = render_pixels_fused(
                config, uniforms, scene._fused, pix, config.spp, scene.sample_offset,
                with_stats=True, materials=materials, textures=textures,
                textured_params=static.textured_params, want_first_hit=want_first,
                split=static.textured, cutout_textured=static.cutout_textured, dome=dome)
        color, segs = out[0], out[1]
        first = empty_first_hit(n, scene.device)
        if want_first:
            # ids -1 and zeros where the peel has no data (gatling_tpu/gi.py:797-817)
            fh = out[2]
            first = first._replace(normal=fh["normal"], albedo=fh["albedo"],
                                   texcoords=fh["texcoords"], depth=fh["depth"], hit=fh["hit"])
        scene.last_segments = float(segs.sum()) * config.spp
        scene._aov_state = blend_aovs(config, uniforms, scene._aov_state,
                                      SampleResult(color, torch.zeros_like(pix), first))

    if check:
        # every AOV finite before the host copy: a NaN names its AOV
        for key2, arr in scene._aov_state.items():
            if arr.is_floating_point() and not bool(torch.isfinite(arr).all()):
                raise FloatingPointError(
                    f"GATLING_VALIDATE: AOV {key2!r} contains "
                    f"{int((~torch.isfinite(arr)).sum())} non-finite values")
    # device -> host copies of every bound AOV (Gi.cpp:2439-2502)
    for b in params.aov_bindings:
        arr = scene._aov_state[_AOV_KEYS[b.aov_id]].cpu().numpy()
        if arr.ndim == 1:
            arr = arr[:, None]
        buf = b.render_buffer
        if b.aov_id == AovId.CLOCK_CYCLES and buf.channels >= 3:
            arr = _turbo_heatmap(arr[:, 0])  # the per-pixel cost heatmap (Gi.cpp:327-343)
        ch = min(buf.channels, arr.shape[1])
        out = buf.data.reshape(n, buf.channels)
        out[:, :ch] = arr[:, :ch].astype(out.dtype)
        if buf.channels == 4 and arr.shape[1] == 3:
            out[:, 3] = 1
    scene.sample_offset += config.spp  # Gi.cpp:2515


def frame_uniforms(params: GiRenderParams, config: RenderConfig) -> Uniforms:
    """The frame's uniforms on the scene's device: the camera, the
    accumulation's sample offset and weight, the settings' scalars and the
    dome's rotation and emission."""
    scene, s = params.scene, params.render_settings
    return Uniforms(
        camera=camera_uniforms(params.camera, config.depth_of_field, scene.device),
        sample_offset=scene.sample_offset,
        inv_total_sample_count=f32(1.0 / (scene.sample_offset + config.spp)),
        max_sample_value=f32(s.get("maxSampleValue", 10.0)),
        rr_inv_min_term_prob=f32(s.get("rrInvMinTermProb", 0.95)),
        light_intensity_multiplier=f32(s.get("lightIntensityMultiplier", 1.0)),
        meters_per_scene_unit=f32(s.get("metersPerSceneUnit", 1.0)),
        max_volume_walk_length=int(s.get("maxVolumeWalkLength", 7)),
        **_dome_uniforms(params.dome_light or scene.dome_light, scene.device),
    )


def _dome_uniforms(dome: GiDomeLight | None, device) -> dict:
    """The dome's uniforms (gatling_tpu/gi.py:641-645), its rotation and
    emission on `device`: identity rotation, unit emission and
    diffuse/specular without a dome."""
    if dome is None:
        return {}

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return dict(dome_rotation=f32(dome.rotation), dome_emission_multiplier=f32(dome.base_emission),
                dome_diffuse_specular=(float(dome.diffuse), float(dome.specular)))


# decoded dome textures on their devices, by file path (gatling_tpu/gi.py:888)
_dome_cache: dict[tuple[str, str], DomeLightData] = {}


def _load_dome(dome: GiDomeLight | None, device) -> DomeLightData:
    """The dome's equirect texture on `device`, decoded once a path
    (gatling_tpu/gi.py:891-904); a dome without a file, or whose file fails
    to decode, is black (logged)."""
    if dome is None or dome.file_path is None:
        return default_dome(device)
    key = (dome.file_path, str(torch.device(device)))
    cached = _dome_cache.get(key)
    if cached is None:
        try:
            tex = imgio.as_float_rgba(imgio.load_image_file(dome.file_path))[:, :, :3]
        except NotImplementedError:
            raise  # a variant the port does not read yet: never render something else
        except Exception:  # noqa: BLE001
            get_logger().error("failed to load dome light texture %s", dome.file_path)
            tex = np.zeros((1, 1, 3), np.float32)
        cached = DomeLightData(
            texture=torch.as_tensor(np.ascontiguousarray(tex), device=device),
            fallback=torch.zeros((1, 1, 3), dtype=torch.float32, device=device))
        _dome_cache[key] = cached
    return cached


def _turbo_heatmap(values: np.ndarray) -> np.ndarray:
    """Normalise per-pixel costs and map them through the Turbo colormap
    (reference: src/gi/impl/Turbo.h, _EncodeRenderBufferAsHeatmap)."""
    v = values.astype(np.float64)
    vmax = v.max()
    t = (v / vmax if vmax > 0 else v).clip(0.0, 1.0)
    r = np.polyval([-3.8268, 9.6180, -8.2527, 2.1903, 0.9967, 0.1357][::-1], t)
    g = np.polyval([-5.9311, 11.6060, -8.5590, 2.7747, 0.2484, 0.0914][::-1], t)
    bl = np.polyval([13.6217, -34.5806, 28.8827, -9.0252, 1.2897, 0.1067][::-1], t)
    return np.clip(np.stack([r, g, bl], axis=1), 0.0, 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# the reference's C-style surface (Gi.h:199-261; gatling_tpu/gi.py:911-1194)
# ---------------------------------------------------------------------------

giInitialize = gi_initialize
giTerminate = gi_terminate
giCreateScene = create_scene
giRender = render
# texture bytes come through the registered readers (render/assets.py)
giRegisterAssetReader = gi_register_asset_reader


def giCreateRenderBuffer(width: int, height: int, channels: int = 4,
                         is_int: bool = False) -> GiRenderBuffer:
    return GiRenderBuffer(width, height, channels, is_int)


def giCreateMesh(scene: GiScene, mesh_desc: MeshDesc) -> MeshDesc:
    return scene.add_mesh(mesh_desc)


def giDestroyMesh(scene: GiScene, mesh: MeshDesc) -> None:
    scene.remove_mesh(mesh)


def giSetMeshTransform(scene: GiScene, mesh: MeshDesc, mat: np.ndarray) -> None:
    scene.set_mesh_transform(mesh, mat)


def giSetMeshMaterial(scene: GiScene, mesh: MeshDesc, material_path: str) -> None:
    scene.set_mesh_material(mesh, material_path)


# The analytic lights (Gi.h:223-257): each handle is a LightDesc whose
# params carry `explicit_frame` (positions, tangents and radii given as
# they are, not read off a USD transform; render/lights.py), created with
# Gi.cpp's defaults: unit emission, diffuse = specular = 1.
_light_ids = itertools.count(1)


def _gi_make_light(scene: GiScene, light_type: str, **extra) -> LightDesc:
    params = dict(intensity=1.0, exposure=0.0, color=np.ones(3, np.float32), normalize=False,
                  diffuse=1.0, specular=1.0, enableColorTemperature=False,
                  colorTemperature=6500.0, explicit_frame=True)
    params.update(extra)
    light = LightDesc(path=f"/__gi_light_{next(_light_ids)}", light_type=light_type,
                      transform=np.eye(4), params=params)
    light._gi_scene = scene  # type: ignore[attr-defined]
    scene.add_light(light)
    return light


def _gi_light_dirty(light: LightDesc) -> None:
    light._gi_scene.dirty |= DirtyFlags.LIGHTS | DirtyFlags.FRAMEBUFFER  # type: ignore[attr-defined]


def _gi_destroy_light(scene: GiScene, light: LightDesc) -> None:
    scene.remove_light(light)


def _gi_set_origin(light: LightDesc, origin) -> None:
    light.transform = np.eye(4)
    light.transform[3, :3] = np.asarray(origin, np.float64)
    _gi_light_dirty(light)


def _gi_set_emission(light: LightDesc, rgb) -> None:
    # the base emission is the final product (the Hydra layer folds in
    # intensity, exposure and normalisation, light.cpp:59-90): a colour
    # under unit multipliers
    light.params.update(color=np.asarray(rgb, np.float32), intensity=1.0, exposure=0.0,
                        normalize=False)
    _gi_light_dirty(light)


def _gi_set_tangents(light: LightDesc, t0, t1) -> None:
    light.params.update(t0=tuple(t0), t1=tuple(t1))
    _gi_light_dirty(light)


def _gi_set_diff_spec(light: LightDesc, diffuse: float, specular: float) -> None:
    light.params.update(diffuse=float(diffuse), specular=float(specular))
    _gi_light_dirty(light)


def giCreateSphereLight(scene: GiScene) -> LightDesc:
    return _gi_make_light(scene, "sphere", radius=0.5, radius_xyz=(0.5, 0.5, 0.5),
                          treatAsPoint=False)


def giSetSphereLightRadius(light: LightDesc, rx: float, ry: float, rz: float) -> None:
    light.params.update(radius_xyz=(rx, ry, rz), radius=max(rx, ry, rz))
    _gi_light_dirty(light)


def giCreateDistantLight(scene: GiScene) -> LightDesc:
    return _gi_make_light(scene, "distant", angle=0.0, direction=(0.0, 0.0, -1.0))


def giSetDistantLightDirection(light: LightDesc, direction) -> None:
    light.params["direction"] = np.asarray(direction, np.float64)
    _gi_light_dirty(light)


def giSetDistantLightAngle(light: LightDesc, angle: float) -> None:
    # radians here, as in the reference; the light tables read the USD
    # layer's degrees
    light.params["angle"] = math.degrees(float(angle))
    _gi_light_dirty(light)


def giCreateRectLight(scene: GiScene) -> LightDesc:
    return _gi_make_light(scene, "rect", width=1.0, height=1.0, t0=(1.0, 0.0, 0.0),
                          t1=(0.0, 1.0, 0.0))


def giSetRectLightDimensions(light: LightDesc, width: float, height: float) -> None:
    light.params.update(width=float(width), height=float(height))
    _gi_light_dirty(light)


def giCreateDiskLight(scene: GiScene) -> LightDesc:
    return _gi_make_light(scene, "disk", radius=0.5, radius_xy=(0.5, 0.5), t0=(1.0, 0.0, 0.0),
                          t1=(0.0, 1.0, 0.0))


def giSetDiskLightRadius(light: LightDesc, rx: float, ry: float) -> None:
    light.params.update(radius_xy=(rx, ry), radius=max(rx, ry))
    _gi_light_dirty(light)


giDestroySphereLight = giDestroyDistantLight = _gi_destroy_light
giDestroyRectLight = giDestroyDiskLight = _gi_destroy_light
giSetSphereLightPosition = giSetRectLightOrigin = giSetDiskLightOrigin = _gi_set_origin
giSetSphereLightBaseEmission = giSetDistantLightBaseEmission = _gi_set_emission
giSetRectLightBaseEmission = giSetDiskLightBaseEmission = _gi_set_emission
giSetRectLightTangents = giSetDiskLightTangents = _gi_set_tangents
giSetSphereLightDiffuseSpecular = giSetDistantLightDiffuseSpecular = _gi_set_diff_spec
giSetRectLightDiffuseSpecular = giSetDiskLightDiffuseSpecular = _gi_set_diff_spec


# the dome light's calls (gatling_tpu/gi.py:939-942, :1111-1123)

def giCreateDomeLight(scene: GiScene, file_path: str) -> GiDomeLight:
    dome = GiDomeLight(file_path=file_path)
    scene.set_dome_light(dome)
    return dome


def giSetDomeLightRotation(light: GiDomeLight, quat) -> None:
    light.rotation = np.asarray(quat, np.float32)


def giSetDomeLightBaseEmission(light: GiDomeLight, rgb) -> None:
    light.base_emission = np.asarray(rgb, np.float32)


def giSetDomeLightDiffuseSpecular(light: GiDomeLight, diffuse: float, specular: float) -> None:
    # stored for parity: the reference packs it into its uniforms and no
    # shader reads it (Gi.cpp:2386, rp_main.h:29)
    light.diffuse = float(diffuse)
    light.specular = float(specular)


def giCreateMaterialFromMtlxStr(scene: GiScene, name: str, mtlx_src: str) -> MaterialDesc:
    """Reference: Gi.h giCreateMaterialFromMtlxStr (gatling_tpu/gi.py:1127)."""
    from gatling_tpu_torch.render.mtlx import parse_mtlx

    mat = parse_mtlx(mtlx_src, name=name)
    scene.add_material(mat)
    return mat


def giCreateMaterialFromMtlxDoc(scene: GiScene, name: str, path: str) -> MaterialDesc:
    """Reference: Gi.h giCreateMaterialFromMtlxDoc (the document is a file
    here; gatling_tpu/gi.py:1136)."""
    from gatling_tpu_torch.render.mtlx import load_mtlx

    mat = load_mtlx(path)
    scene.add_material(mat)
    return mat


def giCreateMaterialFromMdlFile(scene: GiScene, name: str, file_path: str,
                                sub_identifier: str | None = None,
                                params: dict | None = None) -> MaterialDesc:
    """Reference: Gi.h giCreateMaterialFromMdlFile (gatling_tpu/gi.py:1145)."""
    from gatling_tpu_torch.render.mdl import load_mdl_material

    mat = load_mdl_material(file_path, sub_identifier, params, name=name)
    scene.add_material(mat)
    return mat


def giDestroyMaterial(scene: GiScene, mat: MaterialDesc) -> None:
    scene.materials.pop(mat.path, None)
    scene.dirty |= DirtyFlags.MATERIALS | DirtyFlags.FRAMEBUFFER


# ---------------------------------------------------------------------------
# the accumulation state on disk (gatling_tpu/gi.py:1162-1194): the AOV
# buffers and sampleOffset, so a long render resumes in another process.
# The JAX package's np.savez_compressed layout: __sample_offset__ (int64),
# __fb_shape__ (int64 [2]: width, height) and one array per bound AOV under
# its _AOV_KEYS name ([n] or [n, channels], f32 or int32 for the ids); a
# file either package writes loads into the other.
# ---------------------------------------------------------------------------

def giSaveCheckpoint(scene: GiScene, path: str) -> None:
    """Write the scene's accumulation state to `path` (the AOVs leave the
    device only here)."""
    if scene._aov_state is None or scene._fb_shape is None:
        raise ValueError("nothing to checkpoint: no frame rendered yet")
    arrays = {k: v.cpu().numpy() for k, v in scene._aov_state.items()}
    np.savez_compressed(path, __sample_offset__=np.int64(scene.sample_offset),
                        __fb_shape__=np.asarray(scene._fb_shape, np.int64), **arrays)


def giLoadCheckpoint(scene: GiScene, path: str) -> int:
    """Restore a checkpoint onto the scene's device; the next render
    accumulates on from its sampleOffset, which is returned. A framebuffer
    of another size resets it at that render (logged)."""
    with np.load(path) as data:
        fb = tuple(int(x) for x in data["__fb_shape__"])
        aovs = {k: torch.as_tensor(v, device=scene.device) for k, v in data.items()
                if not k.startswith("__")}
        offset = int(data["__sample_offset__"])
    scene._aov_state = aovs
    scene._fb_shape = fb
    scene.sample_offset = offset
    scene.dirty &= ~DirtyFlags.FRAMEBUFFER
    scene._restored_checkpoint = True
    return offset
