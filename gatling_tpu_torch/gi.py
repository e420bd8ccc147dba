"""Public render-engine API ("gi" layer) of the port.

Pythonic mirror of the reference's C API surface (reference:
src/gi/gtl/gi/Gi.h:199-261): scenes, render buffers, AOV bindings and
giRender with the dirty-flag engine and the progressive accumulation
contract (sampleOffset persists across renders and resets when the
framebuffer is invalidated, Gi.cpp:2125-2129,2515).

The port renders on one device through one of two paths, chosen as the
JAX package chooses (gatling_tpu/gi.py:650-700):

* the fused bounce kernels, for a COLOR request of a scene of any size,
  instanced or not, untextured or with 8-bit UsdUVTexture textures and
  normal maps, with the full lobe set (refraction, clearcoat, anisotropy)
  and untextured cutout opacity. Above 4096 triangles a scene takes the
  two-level walk, in instance tables when the JAX package's rule picks
  them (ops/bounce.py MIN_GAIN), else in flattened clustered tables. An
  untextured scene runs one kernel a bounce (K1 resident, K2 walk); a
  textured or anisotropic one the split bounce (K3 trace, the texture
  stage, K4 shade: anisotropy's frame is the mesh tangent of the hit
  buffer's tangent rows);
* the wavefront integrator (render/integrator.py) when an AOV outside
  FUSED_AOV_MASK is bound, or a material reads per-vertex colours: every
  AOV and cutout (textured too), traced by the brute-force kernels K5
  (closest hit) and K6 (shadow rays) for scenes of at most 8192 triangles
  (`_choose_tracer`).

`render` raises NotImplementedError, naming the ROADMAP item, for anything
else; it never renders something else.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any

import numpy as np
import torch

from gatling_tpu_torch.interface import AOV_CHANNELS, AOV_IS_INT, AovId, aov_bit, f32
from gatling_tpu_torch.ops.bounce import (
    FusedScene,
    FusedStatic,
    UniqueClusters,
    aniso_from_table,
    build_fused_scene_instanced,
    build_fused_scene_with_order,
    check_slice,
    refit_instanced,
)
from gatling_tpu_torch.ops.geometry import (
    build_geometry_cached,
    pack_geometry,
    update_instance_transforms,
)
from gatling_tpu_torch.ops.trace import build_trace_tables
from gatling_tpu_torch.render.camera import camera_uniforms
from gatling_tpu_torch.render.fused import FUSED_AOV_MASK, render_pixels_fused
from gatling_tpu_torch.render.integrator import (
    Accel,
    RenderConfig,
    SampleResult,
    Uniforms,
    blend_aovs,
    render_frame,
)
from gatling_tpu_torch.render.lights import build_light_arrays, light_tensors
from gatling_tpu_torch.render.material import (
    MaterialTable,
    build_materials,
    lower_material,
    substitute_texture_means,
    textured_params,
)
from gatling_tpu_torch.render.texture import TextureManager
from gatling_tpu_torch.scene.stage import CameraDesc, LightDesc, MaterialDesc, MeshDesc
from gatling_tpu_torch.utils.config import default_settings
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


class GiScene:
    """Mutable scene container (reference: struct GiScene, Gi.cpp:211-232),
    whose device tables live on `device`."""

    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = torch.device(device)
        self.meshes: list[MeshDesc] = []
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
        self._last_params_key = None
        self.last_segments: float = 0.0  # traced segments of the last render

    def add_mesh(self, mesh: MeshDesc) -> MeshDesc:
        mesh.object_id = len(self.meshes)
        self.meshes.append(mesh)
        self.dirty |= DirtyFlags.GEOMETRY | DirtyFlags.FRAMEBUFFER
        return mesh

    def set_mesh_transform(self, mesh: MeshDesc, transform: np.ndarray) -> None:
        """Move a mesh. Once its geometry is built, only its placements are
        re-transformed at the next render and the fused tables refit."""
        mesh.transform = np.asarray(transform, np.float64)
        if self._geom_cache is not None and not (self.dirty & DirtyFlags.GEOMETRY):
            self._pending_transforms.append(mesh)
            self.dirty |= DirtyFlags.TRANSFORMS | DirtyFlags.FRAMEBUFFER
        else:
            self.dirty |= DirtyFlags.GEOMETRY | DirtyFlags.FRAMEBUFFER

    def add_material(self, mat: MaterialDesc) -> None:
        self.materials[mat.path] = mat
        self.dirty |= DirtyFlags.MATERIALS | DirtyFlags.FRAMEBUFFER

    def add_light(self, light: LightDesc) -> None:
        self.lights.append(light)
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


def create_scene(device: str | torch.device = "cuda") -> GiScene:
    """giCreateScene. A CUDA device must exist: the port never falls back
    to the CPU on its own."""
    init_logging()
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
    return (
        tuple(np.asarray(c.position, np.float32)), tuple(np.asarray(c.forward, np.float32)),
        tuple(np.asarray(c.up, np.float32)), c.vfov, c.f_stop, c.focus_distance,
        c.focal_length, c.clip_start, c.clip_end, c.exposure,
        tuple(sorted((k, str(v)) for k, v in params.render_settings.items())),
        width, height,
    )


# the largest scene the brute-force kernels K5/K6 trace (gatling_tpu/gi.py:269)
MATRIX_MAX_TRIS = 8192


def _choose_tracer(geom) -> str:
    """The wavefront's tracer (gatling_tpu/gi.py:272-286, with the TPU's
    rule on either device): the brute-force kernels up to MATRIX_MAX_TRIS
    triangles, the threaded BVH above."""
    return "matrix" if geom.num_triangles <= MATRIX_MAX_TRIS else "bvh"


def _build_accel(scene: GiScene) -> None:
    """The wavefront's trace tables and packed shading rows on the device
    (gatling_tpu/gi.py:289-303)."""
    if scene._tracer != "matrix":
        raise NotImplementedError(
            f"{scene._geom.num_triangles} triangles: the wavefront integrator traces scenes "
            f"above {MATRIX_MAX_TRIS} triangles with the threaded BVH tracer, which is not "
            "ported yet (ROADMAP: 'Wavefront integrator')")
    t0 = time.monotonic()
    scene._accel = Accel(tables=build_trace_tables(scene._geom, scene.device))
    scene._packed = pack_geometry(scene._geom, scene.device)
    get_logger().info("built the %s trace tables in %.1f ms", scene._tracer,
                      1e3 * (time.monotonic() - t0))


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
        has_dome=(params.dome_light or scene.dome_light) is not None,
        tex_lod_bounces=int(s.get("textureLodBounces", 0)),
        tracer=scene._tracer,
        has_volumes=any(any(c > 0.0 for c in m.params["volume_absorption"])
                        or any(c > 0.0 for c in m.params["volume_scattering"])
                        for m in scene._lowered_materials),
        has_cutout=any(m.traits.has_cutout for m in scene._lowered_materials),
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
    """A material multiplies per-vertex displayColor into its base colour
    and a mesh carries such colours (gatling_tpu/gi.py:673-679)."""
    vcolor = any(m.params.get("vcolor_mul", 0.0) for m in scene._lowered_materials)
    return vcolor and any(getattr(m.mesh, "colors", None) is not None for m in scene.meshes)


def _check_route(params: GiRenderParams, config: RenderConfig, wavefront: bool) -> None:
    """Raise for what the chosen route of the port does not render."""
    scene = params.scene
    if int(params.render_settings.get("parallelDevices", 1) or 1) > 1:
        raise NotImplementedError(
            "parallelDevices > 1 is not ported yet (ROADMAP: 'Multi-GPU and front ends')")
    if config.has_volumes:
        raise NotImplementedError(
            "volume absorption and scattering are not ported yet (ROADMAP: 'USD content', "
            "with the MDL front end that produces them)")
    if wavefront:
        return
    opacity_textures = any("opacity" in m.textures for m in scene._lowered_materials)
    if config.aov_mask != aov_bit(AovId.COLOR):
        raise NotImplementedError(
            "the fused path renders the COLOR AOV only; its first-hit AOVs ride the split "
            "kernels (ROADMAP: 'First-hit AOVs, clipping and textured cutout')")
    if opacity_textures:
        raise NotImplementedError(
            "textured opacity (cutout) is not ported yet "
            "(ROADMAP: 'First-hit AOVs, clipping and textured cutout')")


def _textured(scene: GiScene) -> bool:
    pool = scene._texture_pool
    return pool is not None and pool.packed


def _with_split(scene: GiScene, static: FusedStatic) -> FusedStatic:
    """The static of a textured or anisotropic scene names its textured
    parameters: it renders through the split bounce, whose hit buffer
    carries the mesh tangents that frame anisotropy (gatling_tpu/gi.py
    :681-686, :748-756; an untextured one with the empty texture pool)."""
    if not (_textured(scene) or aniso_from_table(scene._material_table)):
        return static
    return dataclasses.replace(static, textured=True,
                               textured_params=textured_params(scene._lowered_materials))


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
    check_slice(table)
    scene._clusters = UniqueClusters()
    res = build_fused_scene_instanced(scene.meshes, scene._material_index, table,
                                      scene._light_arrays, scene.device,
                                      clusters=scene._clusters)
    scene._fused_order = None
    if res is not None:
        scene._fused, scene._fused_static = res
        get_logger().info("instanced fused scene: %d instances x %d unique clusters "
                          "(flattened would be %d triangles)", scene._fused_static.n_instances,
                          scene._fused_static.n_clusters, scene._fused_static.n_tris)
    else:
        scene._fused, scene._fused_static, scene._fused_order = build_fused_scene_with_order(
            scene._geom, table, scene._light_arrays, scene.device)
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
    if scene._fused_static.instanced:
        scene._fused = refit_instanced(scene._fused, scene._clusters, scene.meshes,
                                       scene._material_index, table)
    else:
        scene._fused, static, scene._fused_order = build_fused_scene_with_order(
            scene._geom, table, scene._light_arrays, scene.device,
            reuse_order=scene._fused_order)
        scene._fused_static = _with_split(scene, static)


def render(params: GiRenderParams) -> None:
    """giRender analog (reference: Gi.cpp:1989-2524): resolve dirty state,
    rebuild device tables, render the frame through the fused bounce
    kernels or the wavefront integrator, blend it into the AOV buffers and
    copy them to the host buffers."""
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
    if scene.dirty & DirtyFlags.MATERIALS or scene._material_table is None:
        rows = [None] * len(scene._material_index)
        for path, idx in scene._material_index.items():
            rows[idx] = lower_material(scene.materials.get(path) if path else None)
        scene._lowered_materials = rows
        scene._material_table, scene._texture_pool = build_materials(
            rows, scene._texture_manager, scene.device)
        scene._material_dev = scene._material_table.to(scene.device)
        scene._fused = None
    if scene.dirty & DirtyFlags.LIGHTS or scene._light_arrays is None:
        scene._light_arrays = build_light_arrays(scene.lights)
        scene._light_dev = light_tensors(scene._light_arrays, scene.device)
        scene._fused = None
    if scene.dirty & DirtyFlags.FRAMEBUFFER or scene._fb_shape != (width, height):
        scene.sample_offset = 0
        scene._fb_shape = (width, height)
        scene._aov_state = None
    if scene._aov_state is None or set(scene._aov_state) != {
            _AOV_KEYS[b.aov_id] for b in params.aov_bindings}:
        scene._aov_state = _init_aov_state(params.aov_bindings, n, scene.device)
    scene.dirty = DirtyFlags.CLEAN

    config = _build_config(params, width, height, aov_mask)
    # the JAX package's route (gatling_tpu/gi.py:650-700): AOVs the fused
    # kernels do not write, or vertex colours, take the wavefront integrator
    wavefront = bool(aov_mask & ~FUSED_AOV_MASK) or _uses_vertex_colours(scene)
    _check_route(params, config, wavefront)
    s = params.render_settings
    uniforms = Uniforms(
        camera=camera_uniforms(params.camera, config.depth_of_field, scene.device),
        sample_offset=scene.sample_offset,
        inv_total_sample_count=f32(1.0 / (scene.sample_offset + config.spp)),
        max_sample_value=f32(s.get("maxSampleValue", 10.0)),
        rr_inv_min_term_prob=f32(s.get("rrInvMinTermProb", 0.95)),
        light_intensity_multiplier=f32(s.get("lightIntensityMultiplier", 1.0)),
        meters_per_scene_unit=f32(s.get("metersPerSceneUnit", 1.0)),
        max_volume_walk_length=int(s.get("maxVolumeWalkLength", 7)),
    )
    if wavefront:
        if scene._accel is None:
            _build_accel(scene)
        scene._aov_state = render_frame(config, uniforms, scene._packed, scene._material_dev,
                                        scene._light_dev, scene._aov_state,
                                        scene._texture_pool, scene._accel)
        scene.last_segments = 0.0  # the wavefront does not count its segments
    else:
        if scene._fused is None:
            _build_fused(scene)
        pix = torch.arange(n, dtype=torch.int64, device=scene.device)
        static = scene._fused_static
        split = dict(materials=scene._material_dev, textures=scene._texture_pool,
                     textured_params=static.textured_params) if static.textured else {}
        color, segs = render_pixels_fused(config, uniforms, scene._fused, pix, config.spp,
                                          scene.sample_offset, with_stats=True, **split)
        scene.last_segments = float(segs.sum()) * config.spp
        scene._aov_state = blend_aovs(config, uniforms, scene._aov_state,
                                      SampleResult(color, torch.zeros_like(pix)))

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
