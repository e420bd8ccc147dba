# The render engine add-on for Blender of the PyTorch + CUDA port (the port
# of the root dist/blender add-on).
#
# Structural mirror of the reference's add-on split (reference:
# dist/blender/__init__.py registering engine + properties + ui). The
# reference subclasses bpy.types.HydraRenderEngine and loads the hdGatling
# pxr plugin (dist/blender/engine.py:12-54); the port is a Python renderer
# without a pxr plugin, so this engine is a classic bpy.types.RenderEngine
# that exports the scene through Blender's bundled USD exporter and renders
# it with `python -m gatling_tpu_torch.cli` on the card.

bl_info = {
    "name": "Gatling (CUDA)",
    "description": "USD path tracer on NVIDIA GPUs (gatling_tpu_torch) render engine",
    "author": "gatling_tpu_torch",
    "version": (0, 2, 0),
    "blender": (4, 0, 0),
    "category": "Render",
}

from . import engine, properties, ui  # noqa: E402


def register():
    engine.register()
    properties.register()
    ui.register()


def unregister():
    ui.unregister()
    properties.unregister()
    engine.unregister()
