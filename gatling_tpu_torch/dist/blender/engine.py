# The render engine (reference: dist/blender/engine.py GatlingHydraRenderEngine).
#
# The reference plugs hdGatling into Blender's HydraRenderEngine; the port
# has no pxr plugin, so this engine exports the depsgraph scene with
# Blender's bundled USD exporter and drives the port's CLI
# (gatling_tpu_torch.cli, the same gi pipeline its Hydra-shaped delegate
# drives).

import os
import subprocess
import sys
import tempfile

import bpy


def _settings_to_flags(s) -> list[str]:
    """Map the property group onto the CLI's descriptor-generated flags
    (gatling_tpu_torch/cli.py builds them from the same SettingDescriptors
    as the reference's Argparse.cpp:150-159), and the device."""
    flags = [
        "--spp", str(s.spp),
        "--max-bounces", str(s.max_bounces),
        "--rr-bounce-offset", str(s.rr_bounce_offset),
        "--rr-inv-min-term-prob", str(s.rr_inv_min_term_prob),
        "--max-sample-value", str(s.max_sample_value),
        "--medium-stack-size", str(s.medium_stack_size),
        "--max-volume-walk-length", str(s.max_volume_walk_length),
        "--device", s.device,
    ]
    def onoff(name, value):
        flags.append(("--" if value else "--no-") + name)
    onoff("next-event-estimation", s.next_event_estimation)
    onoff("jittered-sampling", s.jittered_sampling)
    onoff("filter-importance-sampling", s.filter_importance_sampling)
    onoff("depth-of-field", s.depth_of_field)
    onoff("clipping-planes", s.clipping_planes)
    onoff("progressive-accumulation", s.progressive_accumulation)
    return flags


class GatlingTorchRenderEngine(bpy.types.RenderEngine):
    bl_idname = "GATLING_TORCH"
    bl_label = "Gatling (CUDA)"
    bl_use_preview = False
    bl_use_eevee_viewport = True  # viewport shading falls back to EEVEE

    def render(self, depsgraph):
        scene = depsgraph.scene
        scale = scene.render.resolution_percentage / 100.0
        width = int(scene.render.resolution_x * scale)
        height = int(scene.render.resolution_y * scale)
        settings = scene.gatling_torch

        tmp = tempfile.mkdtemp(prefix="gatling_torch_")
        usd_path = os.path.join(tmp, "scene.usda")
        out_path = os.path.join(tmp, "out.png")

        self.update_stats("Gatling (CUDA)", "Exporting USD")
        bpy.ops.wm.usd_export(
            filepath=usd_path, export_lights=True, export_materials=True,
            export_textures=True, evaluation_mode="RENDER")

        python = settings.python_executable or sys.executable
        cmd = [python, "-m", "gatling_tpu_torch.cli", usd_path, out_path,
               "--image-width", str(width), "--image-height", str(height),
               *_settings_to_flags(settings)]
        self.update_stats("Gatling (CUDA)", f"Rendering on {settings.device}")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            self.report({"ERROR"}, f"gatling_tpu_torch failed:\n{proc.stderr[-2000:]}")
            return

        result = self.begin_result(0, 0, width, height)
        layer = result.layers[0].passes["Combined"]
        img = bpy.data.images.load(out_path)
        try:
            pixels = list(img.pixels[:])
            layer.rect = [pixels[i:i + 4] for i in range(0, len(pixels), 4)]
        finally:
            bpy.data.images.remove(img)
        self.end_result(result)

    def update_render_passes(self, scene=None, render_layer=None):
        if render_layer and render_layer.use_pass_combined:
            self.register_pass(scene, render_layer, "Combined", 4, "RGBA", "COLOR")


def _panel_poll_compat():
    """Enable the standard cycles-agnostic UI panels for this engine."""
    import bl_ui

    panels = []
    for module in (bl_ui.properties_render, bl_ui.properties_output):
        for name in dir(module):
            cls = getattr(module, name)
            if hasattr(cls, "COMPAT_ENGINES") and "BLENDER_RENDER" in getattr(
                    cls, "COMPAT_ENGINES", ()):
                panels.append(cls)
    return panels


_registered_panels = []


def register():
    bpy.utils.register_class(GatlingTorchRenderEngine)
    for panel in _panel_poll_compat():
        panel.COMPAT_ENGINES.add("GATLING_TORCH")
        _registered_panels.append(panel)


def unregister():
    for panel in _registered_panels:
        panel.COMPAT_ENGINES.discard("GATLING_TORCH")
    _registered_panels.clear()
    bpy.utils.unregister_class(GatlingTorchRenderEngine)
