"""Material front end: shader networks -> packed parameter rows and textures.

UsdPreviewSurface networks are lowered into rows of the packed [M, 30] f32
table that the kernels read (the mc layer analog, reference:
src/mc/impl/Frontend.cpp), plus per-parameter texture requests: a
connected input folds through render/shadergraph.py into a constant and
at most one texture under an affine scale and bias. `build_materials`
loads the textures into the device pool and records each material's slot
and channel per parameter in the [M, 10] int32 `packed_i` rows.

The fused path's texture stage and the wavefront integrator read them
per ray: `gather_params` (the uber-BSDF's parameters, render/bsdf.py
BsdfParams), `apply_textures` (the taps of the textured parameters laid
over them), `perturb_normal` (tangent-space normal maps); and
`substitute_texture_means` builds the kernels' own table, whose textured
columns hold the textures' means. Besides UsdPreviewSurface, the MaterialX
surfaces authored inline in USD (open_pbr_surface, standard_surface,
gltf_pbr) map onto the same parameters; MDL and other surface shaders are
not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gatling_tpu_torch.render.bsdf import BsdfParams
from gatling_tpu_torch.render.shadergraph import GraphLowering
from gatling_tpu_torch.render.texture import TextureManager, TexturePool, TextureRef, \
    empty_pool, sample_pool
from gatling_tpu_torch.scene.stage import MaterialDesc

# packed_f column offsets
MF_BASE, MF_METAL, MF_ROUGH, MF_IOR, MF_OPACITY = 0, 3, 4, 5, 6
MF_EMISSIVE, MF_USW, MF_SPEC, MF_TRANS, MF_THIN = 7, 10, 11, 14, 15
MF_VOL_A, MF_VOL_S, MF_VOL_BIAS, MF_OPACITY_THRESH = 16, 19, 22, 23
MF_BACKFACE_EDF = 24
MF_VCOLOR_MUL = 25
MF_COAT, MF_COAT_ROUGH, MF_ANISO, MF_ANISO_ROT = 26, 27, 28, 29
PF_COLS = 30
# packed_i columns: texture slot per parameter (-1 = constant), the
# channel of single-channel reads, and (column 9) the backface row
MI_BASE_TEX, MI_EMISSIVE_TEX, MI_METAL_TEX, MI_ROUGH_TEX = 0, 1, 2, 3
MI_OPACITY_TEX, MI_NORMAL_TEX = 4, 5
MI_METAL_CH, MI_ROUGH_CH, MI_OPACITY_CH = 6, 7, 8
MI_BACKFACE_ID = 9


class MaterialTable(NamedTuple):
    """Packed per-material rows: NumPy on the host, or torch tensors on a
    device (`to`)."""

    packed_f: np.ndarray  # [M, PF_COLS] f32, columns MF_*
    packed_i: np.ndarray  # [M, 10] int32, columns MI_*

    @property
    def count(self) -> int:
        return self.packed_f.shape[0]

    @property
    def normal_tex(self):
        return self.packed_i[:, MI_NORMAL_TEX]

    @property
    def opacity_tex(self):
        return self.packed_i[:, MI_OPACITY_TEX]

    def to(self, device) -> "MaterialTable":
        return MaterialTable(torch.tensor(np.asarray(self.packed_f), device=device),
                             torch.tensor(np.asarray(self.packed_i), device=device))


@dataclasses.dataclass
class MaterialTraits:
    """Host-side material traits (reference: mc/Material.h McMaterial)."""

    has_backface_edf: bool = False
    # an opacity below 1, an opacity threshold or an opacity texture: the
    # wavefront integrator draws a cutout decision at every hit
    has_cutout: bool = False


@dataclasses.dataclass
class LoweredMaterial:
    """One lowered material: constant uber-BSDF parameters and texture
    requests."""

    params: dict
    traits: MaterialTraits
    textures: dict[str, TextureRef] = dataclasses.field(default_factory=dict)


_DEFAULTS = {
    "base_color": (0.18, 0.18, 0.18),
    "metallic": 0.0,
    "roughness": 0.5,
    "ior": 1.5,
    "opacity": 1.0,
    "opacity_threshold": 0.0,
    "emissive": (0.0, 0.0, 0.0),
    "use_specular_workflow": 0.0,
    "specular_color": (0.0, 0.0, 0.0),
    "transmission": 0.0,
    "thin_walled": 0,
    "volume_absorption": (0.0, 0.0, 0.0),
    "volume_scattering": (0.0, 0.0, 0.0),
    "volume_bias": 0.0,
    # 1.0 only on the displayColor fallback material: multiplies the
    # interpolated per-corner vcolor rows into base_color
    "vcolor_mul": 0.0,
    "clearcoat": 0.0,
    "clearcoat_roughness": 0.1,
    "anisotropy": 0.0,
    "anisotropy_rotation": 0.0,
}

# UsdPreviewSurface input -> (uber-BSDF parameter, is a colour)
_PREVIEW_INPUTS = (
    ("diffuseColor", "base_color", True),
    ("normal", "normal", False),
    ("metallic", "metallic", False),
    ("roughness", "roughness", False),
    ("ior", "ior", False),
    ("opacity", "opacity", False),
    ("opacityThreshold", "opacity_threshold", False),
    ("emissiveColor", "emissive", True),
    ("useSpecularWorkflow", "use_specular_workflow", False),
    ("specularColor", "specular_color", False),
    ("clearcoat", "clearcoat", False),
    ("clearcoatRoughness", "clearcoat_roughness", False),
)
_CH_INDEX = {"r": 0, "g": 1, "b": 2, "a": 3, "rgb": 0}


def _vec3(v) -> tuple[float, float, float]:
    if isinstance(v, (int, float)):
        return (float(v),) * 3
    v = tuple(float(x) for x in v)
    return v[:3] if len(v) >= 3 else (v + (0.0,) * 3)[:3]


def lower_material(desc: MaterialDesc | None) -> LoweredMaterial:
    """Lower one UsdPreviewSurface, open_pbr_surface, standard_surface or
    gltf_pbr network to uber-BSDF parameters and texture requests (the JAX
    package's render/material.py lower_material)."""
    params = dict(_DEFAULTS)
    textures: dict[str, TextureRef] = {}
    traits = MaterialTraits()
    node = None
    if desc is not None and desc.surface_node is not None:
        node = desc.nodes.get(desc.surface_node)
    if node is None:
        return LoweredMaterial(params=params, traits=traits, textures=textures)

    graph = GraphLowering(desc)

    def constant(input_name: str, default):
        """An input's constant part (a connected texture is dropped)."""
        gv = graph.eval_input(node, input_name, default, False)
        if isinstance(default, tuple):
            return _vec3(gv.constant[:3])
        return float(gv.constant[0])

    def grab(input_name: str, param: str, color: bool = False, conv=None) -> None:
        default = (0.0, 0.0, 1.0) if param == "normal" else _DEFAULTS[param]
        gv = graph.eval_input(node, input_name, default, color)
        if isinstance(default, tuple):
            params[param] = _vec3(gv.constant[:3])
        else:
            params[param] = float(gv.constant[0])
        if conv is not None:
            params[param] = conv(params[param])
        if gv.texture is not None:
            textures[param] = gv.texture

    sid = node.shader_id
    if sid == "UsdPreviewSurface":
        for input_name, param, color in _PREVIEW_INPUTS:
            grab(input_name, param, color)
    elif sid in ("ND_standard_surface_surfaceshader", "standard_surface"):
        grab("base_color", "base_color", True)
        grab("metalness", "metallic")
        grab("specular_roughness", "roughness")
        grab("coat", "clearcoat")
        grab("coat_roughness", "clearcoat_roughness")
        grab("specular_anisotropy", "anisotropy")
        grab("specular_rotation", "anisotropy_rotation")
        grab("specular_IOR", "ior")
        grab("transmission", "transmission")
        grab("opacity", "opacity", conv=lambda v: float(np.mean(_vec3(v))))
        scale = constant("emission", 0.0)
        params["emissive"] = tuple(float(scale) * c for c in constant("emission_color",
                                                                       (1.0, 1.0, 1.0)))
        params["thin_walled"] = int(bool(node.inputs.get("thin_walled", False)))
    elif sid in ("ND_open_pbr_surface_surfaceshader", "open_pbr_surface"):
        grab("base_color", "base_color", True)
        grab("base_metalness", "metallic")
        grab("specular_roughness", "roughness")
        grab("specular_ior", "ior")
        grab("transmission_weight", "transmission")
        grab("coat_weight", "clearcoat")
        grab("coat_roughness", "clearcoat_roughness")
        grab("specular_roughness_anisotropy", "anisotropy")
        grab("geometry_opacity", "opacity")
        lum = constant("emission_luminance", 0.0)
        params["emissive"] = tuple(float(lum) * c for c in constant("emission_color",
                                                                     (1.0, 1.0, 1.0)))
        params["thin_walled"] = int(bool(node.inputs.get("geometry_thin_walled", False)))
    elif sid in ("ND_gltf_pbr_surfaceshader", "gltf_pbr"):
        grab("base_color", "base_color", True)
        grab("metallic", "metallic")
        grab("roughness", "roughness")
        grab("transmission", "transmission")
        grab("alpha", "opacity")
        grab("emissive", "emissive")
        if str(node.inputs.get("alpha_mode", "")).upper() == "MASK":
            params["opacity_threshold"] = float(node.inputs.get("alpha_cutoff", 0.5))
    else:
        raise NotImplementedError(
            f"{desc.path}: surface shader {sid!r} is not ported yet (ROADMAP: 'USD content', "
            "the MDL and MaterialX front ends)")

    # normal-map scale/bias defaults: authors often omit the required
    # scale=2 bias=-1 mapping (reference: previewSurfaceNetworkPatcher.cpp)
    nref = textures.get("normal")
    if nref is not None and nref.scale == (1.0, 1.0, 1.0, 1.0) \
            and nref.bias == (0.0, 0.0, 0.0, 0.0):
        textures["normal"] = dataclasses.replace(
            nref, scale=(2.0, 2.0, 2.0, 1.0), bias=(-1.0, -1.0, -1.0, 0.0), is_srgb=False)
    params["vcolor_mul"] = float(bool(node.inputs.get("_vcolor_multiply", False)))
    traits.has_backface_edf = bool(node.inputs.get("has_backface_edf", False))
    traits.has_cutout = (params["opacity_threshold"] > 0.0 or params["opacity"] < 1.0
                         or "opacity" in textures)
    return LoweredMaterial(params=params, traits=traits, textures=textures)


def build_materials(lowered: list[LoweredMaterial], texture_manager: TextureManager | None = None,
                    device="cpu") -> tuple[MaterialTable, TexturePool]:
    """(MaterialTable, TexturePool): the texture requests deduplicated,
    loaded through the TextureManager into a pool on `device`, and each
    material's slot recorded per parameter (Gi.cpp:1446-1490)."""
    if not lowered:
        lowered = [lower_material(None)]
    refs: list[TextureRef] = []
    ref_slot: dict[TextureRef, int] = {}
    texture_slots: dict[int, dict[str, int]] = {}
    for i, m in enumerate(lowered):
        for param, ref in m.textures.items():
            if ref not in ref_slot:
                ref_slot[ref] = len(refs)
                refs.append(ref)
            texture_slots.setdefault(i, {})[param] = ref_slot[ref]
    pool = (texture_manager or TextureManager()).build_pool(refs, device) if refs \
        else empty_pool(device)
    return build_material_table(lowered, texture_slots), pool


def build_material_table(lowered: list[LoweredMaterial],
                         texture_slots: dict[int, dict[str, int]] | None = None
                         ) -> MaterialTable:
    """Pack lowered materials into the [M, 30] f32 and [M, 10] int32 rows,
    column for column as the JAX package's _pack_material_table lays them
    out. texture_slots maps a material row to {parameter: pool slot}."""
    if not lowered:
        lowered = [lower_material(None)]
    texture_slots = texture_slots or {}

    def col(name, dtype=np.float32):
        vals = [m.params[name] for m in lowered]
        if isinstance(_DEFAULTS[name], tuple):
            vals = [_vec3(v) for v in vals]
        arr = np.array(vals, dtype)
        return arr if arr.ndim == 2 else arr[:, None]

    backface_edf = np.array(
        [float(m.traits.has_backface_edf) for m in lowered], np.float32)[:, None]
    packed_f = np.concatenate([
        col("base_color"), col("metallic"), col("roughness"), col("ior"),
        col("opacity"), col("emissive"), col("use_specular_workflow"),
        col("specular_color"), col("transmission"),
        col("thin_walled", np.int32).astype(np.float32),
        col("volume_absorption"), col("volume_scattering"), col("volume_bias"),
        col("opacity_threshold"), backface_edf, col("vcolor_mul"),
        col("clearcoat"), col("clearcoat_roughness"), col("anisotropy"),
        col("anisotropy_rotation"),
    ], axis=1)
    assert packed_f.shape[1] == PF_COLS

    def slot(param):
        return [texture_slots.get(i, {}).get(param, -1) for i in range(len(lowered))]

    def channel(param):
        return [_CH_INDEX.get(m.textures[param].channel, 0) if param in m.textures else 0
                for m in lowered]

    packed_i = np.stack([
        slot("base_color"), slot("emissive"), slot("metallic"), slot("roughness"),
        slot("opacity"), slot("normal"), channel("metallic"), channel("roughness"),
        channel("opacity"), list(range(len(lowered))),
    ], axis=1).astype(np.int32)
    return MaterialTable(packed_f=packed_f.astype(np.float32), packed_i=packed_i)


def textured_params(lowered: list[LoweredMaterial]) -> tuple[str, ...]:
    """The uber-BSDF parameters with a texture anywhere in the scene."""
    names = ("base_color", "emissive", "metallic", "roughness", "opacity")
    return tuple(n for n in names if any(n in m.textures for m in lowered))


def substitute_texture_means(table: MaterialTable, pool: TexturePool) -> MaterialTable:
    """The kernels' material table: each textured parameter's constant
    replaced by its texture's mean (the "top mip", pool.mean). The shade
    kernel K4 takes the textured columns from the texture stage's rows and
    the others from here; bounces at or after textureLodBounces run the
    untextured kernels K1 and K2 on this table alone."""
    mean = pool.mean.cpu().numpy()
    pf = np.array(table.packed_f, np.float32)
    pi = np.asarray(table.packed_i)
    for col, width, tex_col, ch_col in ((MF_BASE, 3, MI_BASE_TEX, None),
                                        (MF_EMISSIVE, 3, MI_EMISSIVE_TEX, None),
                                        (MF_METAL, 1, MI_METAL_TEX, MI_METAL_CH),
                                        (MF_ROUGH, 1, MI_ROUGH_TEX, MI_ROUGH_CH)):
        sel = pi[:, tex_col] >= 0
        if ch_col is None:
            pf[sel, col:col + width] = mean[pi[sel, tex_col], :3]
        else:
            pf[sel, col] = mean[pi[sel, tex_col], pi[sel, ch_col]]
    return MaterialTable(packed_f=pf, packed_i=np.array(pi))


def _gather_rows(table2d: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows [R, C] of a device table by id (the JAX package's one-hot matrix
    product is a TPU gather workaround; here it is plain indexing). Ids
    beyond the table read its last row."""
    return table2d[torch.clamp(ids, max=table2d.shape[0] - 1).long()]


def gather_params(table: MaterialTable, material_ids: torch.Tensor) -> BsdfParams:
    """The per-ray BSDF parameters of a device table (render/material.py
    gather_params): one row gather and column slices. The texture taps go
    on top (apply_textures)."""
    pf = _gather_rows(table.packed_f, material_ids)
    return BsdfParams(
        base_color=pf[:, MF_BASE:MF_BASE + 3], metallic=pf[:, MF_METAL],
        roughness=pf[:, MF_ROUGH], ior=pf[:, MF_IOR], opacity=pf[:, MF_OPACITY],
        opacity_threshold=pf[:, MF_OPACITY_THRESH],
        emissive=pf[:, MF_EMISSIVE:MF_EMISSIVE + 3], use_specular_workflow=pf[:, MF_USW],
        specular_color=pf[:, MF_SPEC:MF_SPEC + 3], transmission=pf[:, MF_TRANS],
        thin_walled=pf[:, MF_THIN] > 0, volume_absorption=pf[:, MF_VOL_A:MF_VOL_A + 3],
        volume_scattering=pf[:, MF_VOL_S:MF_VOL_S + 3], volume_bias=pf[:, MF_VOL_BIAS],
        backface_edf=pf[:, MF_BACKFACE_EDF], clearcoat=pf[:, MF_COAT],
        clearcoat_roughness=pf[:, MF_COAT_ROUGH], anisotropy=pf[:, MF_ANISO],
        anisotropy_rotation=pf[:, MF_ANISO_ROT])


def _has_textures(pool: TexturePool) -> bool:
    return pool.count > 1 or pool.packed


def apply_textures(table: MaterialTable, pool: TexturePool, params: BsdfParams,
                   material_ids: torch.Tensor, uv: torch.Tensor,
                   active: tuple[str, ...] | None = None) -> BsdfParams:
    """The texture taps of the parameters in `active` (all five when None)
    laid over the gathered constants where a material binds a slot."""
    if not _has_textures(pool):
        return params
    pi = _gather_rows(table.packed_i, material_ids)

    def rgb(col, constant):
        slot = pi[:, col]
        val = sample_pool(pool, slot, uv)
        return torch.where((slot >= 0)[:, None], val[:, :3], constant)

    def scalar(col, ch_col, constant):
        slot = pi[:, col]
        val = sample_pool(pool, slot, uv)
        picked = torch.gather(val, 1, pi[:, ch_col].long()[:, None])[:, 0]
        return torch.where(slot >= 0, picked, constant)

    updates = {}
    if active is None or "base_color" in active:
        updates["base_color"] = rgb(MI_BASE_TEX, params.base_color)
    if active is None or "emissive" in active:
        updates["emissive"] = rgb(MI_EMISSIVE_TEX, params.emissive)
    if active is None or "metallic" in active:
        updates["metallic"] = scalar(MI_METAL_TEX, MI_METAL_CH, params.metallic)
    if active is None or "roughness" in active:
        updates["roughness"] = scalar(MI_ROUGH_TEX, MI_ROUGH_CH, params.roughness)
    if active is None or "opacity" in active:
        updates["opacity"] = scalar(MI_OPACITY_TEX, MI_OPACITY_CH, params.opacity)
    return params._replace(**updates)


def perturb_normal(table: MaterialTable, pool: TexturePool, material_ids: torch.Tensor,
                   uv: torch.Tensor, n: torch.Tensor, t: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Tangent-space normal mapping (UsdPreviewSurface `normal` input)."""
    if not _has_textures(pool):
        return n
    slot = _gather_rows(table.packed_i, material_ids)[:, MI_NORMAL_TEX]
    nm = sample_pool(pool, slot, uv)[:, :3]
    mapped = nm[:, 0:1] * t + nm[:, 1:2] * b + torch.clamp(nm[:, 2:3], min=1e-3) * n
    mapped = mapped / torch.clamp(torch.linalg.vector_norm(mapped, dim=-1, keepdim=True),
                                  min=1e-20)
    return torch.where((slot >= 0)[:, None], mapped, n)
