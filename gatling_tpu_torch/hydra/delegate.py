"""Render delegate, render pass and renderer plugin of the port
(gatling_tpu/hydra/delegate.py).

Mirrors the reference's Hydra plugin classes:
* HdGatlingRendererPlugin (rendererPlugin.cpp:45-230) -> HdRendererPlugin:
  one-time engine init and delegate construction; supported where a CUDA
  device is;
* HdGatlingRenderDelegate (renderDelegate.cpp:40-384) -> HdRenderDelegate:
  supported prim types, render-setting descriptors, the scene, on CUDA
  unless the host asks for the CPU (`device="cpu"`: the kernels' twins);
* HdGatlingRenderPass (renderPass.cpp:41-308) -> HdRenderPass: AOV token
  binding, GiRenderParams assembly, convergence (a non-interactive render
  is converged after one execution, an interactive one accumulates);
* HdGatlingRenderBuffer (renderBuffer.cpp) -> HdRenderBuffer.

A host (a DCC bridge, a test, the CLI) drives it with the scene
descriptions of gatling_tpu_torch.scene.stage in place of Hydra prims.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from gatling_tpu_torch import gi
from gatling_tpu_torch.interface import AovId
from gatling_tpu_torch.scene.stage import CameraDesc, LightDesc, MaterialDesc, MeshDesc
from gatling_tpu_torch.utils.config import SETTING_DESCRIPTORS, default_settings, descriptor
from gatling_tpu_torch.utils.log import get_logger

# Hydra AOV token -> AovId (reference: renderPass.cpp:41-59)
AOV_TOKEN_MAP = {
    "color": AovId.COLOR,
    "normal": AovId.NORMAL,
    "albedo": AovId.ALBEDO,
    "depth": AovId.DEPTH,
    "primId": AovId.OBJECT_ID,
    "objectId": AovId.OBJECT_ID,
    "element": AovId.FACE_ID,
    "faceId": AovId.FACE_ID,
    "instanceId": AovId.INSTANCE_ID,
    "barycentrics": AovId.BARYCENTRICS,
    "texcoords": AovId.TEXCOORDS,
    "bounces": AovId.BOUNCES,
    "clockCycles": AovId.CLOCK_CYCLES,
    "opacity": AovId.OPACITY,
    "tangents": AovId.TANGENTS,
    "bitangents": AovId.BITANGENTS,
    "thinWalled": AovId.THIN_WALLED,
    "doubleSided": AovId.DOUBLE_SIDED,
    "nee": AovId.NEE,
}

SUPPORTED_RPRIM_TYPES = ("Mesh",)
SUPPORTED_SPRIM_TYPES = (
    "Camera", "Material", "SphereLight", "DistantLight", "RectLight",
    "DiskLight", "DomeLight", "SimpleLight", "ExtComputation",
)
SUPPORTED_BPRIM_TYPES = ("RenderBuffer",)

# the printLicenses payload (renderDelegate.cpp:160-195): what the port uses
THIRD_PARTY = (
    ("PyTorch", "BSD 3-Clause", "https://pytorch.org"),
    ("NumPy", "BSD 3-Clause", "https://numpy.org"),
    ("NVIDIA CUDA Toolkit (nvcc, runtime)", "NVIDIA CUDA Toolkit EULA",
     "https://docs.nvidia.com/cuda/eula"),
    ("zlib", "zlib License", "https://zlib.net"),
    ("MaterialX (node definitions)", "Apache License 2.0", "https://materialx.org"),
    ("NVIDIA MDL specification (interface compatibility)", "CC BY 4.0 (spec)",
     "https://raytracing-docs.nvidia.com/mdl"),
    ("Pixar USD (file-format specifications)", "TOST 1.0 / Apache 2.0", "https://openusd.org"),
)


class HdRenderBuffer:
    """Reference: renderBuffer.cpp; formats Int32, Float32, Float32Vec3 and
    Float32Vec4."""

    def __init__(self, width: int, height: int, fmt: str = "Float32Vec4") -> None:
        self.format = fmt
        channels = {"Int32": 1, "Float32": 1, "Float32Vec3": 3, "Float32Vec4": 4}[fmt]
        self._gi = gi.GiRenderBuffer(width, height, channels, fmt == "Int32")
        self.converged = False

    @property
    def width(self) -> int:
        return self._gi.width

    @property
    def height(self) -> int:
        return self._gi.height

    def map(self) -> np.ndarray:
        """The host pixels (renderBuffer.cpp Map)."""
        return self._gi.data


@dataclasses.dataclass
class HdAovBinding:
    aov_name: str
    render_buffer: HdRenderBuffer
    clear_value: Any = None


class HdRenderPass:
    """AOV bindings, camera and settings onto giRender (reference:
    renderPass.cpp:230-308)."""

    def __init__(self, delegate: HdRenderDelegate) -> None:
        self._delegate = delegate

    def execute(self, camera: CameraDesc, aov_bindings: list[HdAovBinding],
                interactive: bool = False) -> None:
        gi_bindings = []
        for b in aov_bindings:
            aov = AOV_TOKEN_MAP.get(b.aov_name)
            if aov is None:
                raise ValueError(f"unsupported AOV token {b.aov_name!r}")
            gi_bindings.append(gi.GiAovBinding(aov, b.render_buffer._gi, b.clear_value))
        scene = self._delegate.scene
        gi.render(gi.GiRenderParams(scene=scene, camera=camera, aov_bindings=gi_bindings,
                                    render_settings=dict(self._delegate.render_settings),
                                    dome_light=scene.dome_light))
        # a non-interactive render is converged once its samples are in
        # (renderPass.cpp:93-129 '!interactive')
        for b in aov_bindings:
            b.render_buffer.converged = not interactive


def third_party_licenses() -> str:
    lines = ["gatling_tpu_torch third-party components:"]
    lines += [f"  {name}: {lic} ({url})" for name, lic, url in THIRD_PARTY]
    return "\n".join(lines)


class HdRenderDelegate:
    """Reference: renderDelegate.cpp. The scene lives on `device` (CUDA by
    default; gi.create_scene raises without a card)."""

    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.scene = gi.create_scene(device)
        self.render_settings = default_settings()

    # the capability queries (renderDelegate.cpp:40-61)

    def supported_rprim_types(self) -> tuple[str, ...]:
        return SUPPORTED_RPRIM_TYPES

    def supported_sprim_types(self) -> tuple[str, ...]:
        return SUPPORTED_SPRIM_TYPES

    def supported_bprim_types(self) -> tuple[str, ...]:
        return SUPPORTED_BPRIM_TYPES

    def render_setting_descriptors(self):
        """The descriptor table behind the UI, the DS files and the CLI
        flags (renderDelegate.cpp:93-115)."""
        return SETTING_DESCRIPTORS

    def set_render_setting(self, name: str, value: Any) -> None:
        """Change a setting (a change resets the accumulation); debug-only
        settings stay locked unless GATLING_DEBUG=1 (renderDelegate.cpp
        :145-158 locks them in release builds)."""
        try:
            d = descriptor(name)
        except KeyError:
            d = None
        if d is not None and d.debug_only and os.environ.get("GATLING_DEBUG") != "1":
            get_logger().warning("render setting %r is debug-only and locked "
                                 "(set GATLING_DEBUG=1 to change it)", name)
            return
        if name in self.render_settings and self.render_settings[name] != value:
            self.render_settings[name] = value
            self.scene.dirty |= gi.DirtyFlags.FRAMEBUFFER

    # the renderer commands (renderDelegate.cpp:160-195)

    def get_renderer_command_descriptors(self):
        return ({"commandName": "printLicenses",
                 "commandDescription": "Print third-party licenses"},)

    def invoke_renderer_command(self, command: str) -> bool:
        if command == "printLicenses":
            print(third_party_licenses())
            return True
        return False

    # prim sync (the HdGatlingMesh / Light / Material::Sync analogs)

    def sync_mesh(self, mesh: MeshDesc) -> MeshDesc:
        return self.scene.add_mesh(mesh)

    def sync_material(self, mat: MaterialDesc) -> None:
        self.scene.add_material(mat)

    def sync_light(self, light: LightDesc) -> None:
        if light.light_type == "dome":
            # the last dome synced wins (renderParam.cpp:18-52)
            self.scene.set_dome_light(gi.GiDomeLight(file_path=light.params.get("texture")))
        else:
            self.scene.add_light(light)

    def create_render_pass(self) -> HdRenderPass:
        return HdRenderPass(self)

    def create_render_buffer(self, width: int, height: int,
                             fmt: str = "Float32Vec4") -> HdRenderBuffer:
        return HdRenderBuffer(width, height, fmt)


class HdRendererPlugin:
    """Reference: rendererPlugin.cpp: one-time init and delegate factory."""

    _instance: HdRendererPlugin | None = None

    def __init__(self) -> None:
        gi.gi_initialize()

    def is_supported(self) -> bool:
        """The capability check (rendererPlugin.cpp:212-230): a CUDA device."""
        return torch.cuda.is_available()

    def create_render_delegate(self, device: str | torch.device = "cuda") -> HdRenderDelegate:
        return HdRenderDelegate(device)


def get_renderer_plugin() -> HdRendererPlugin:
    """HdRendererPluginRegistry::GetOrCreateRendererPlugin analog."""
    if HdRendererPlugin._instance is None:
        HdRendererPlugin._instance = HdRendererPlugin()
    return HdRendererPlugin._instance
