# Render settings property group (reference: dist/blender/properties.py —
# same setting set and defaults as the HdGatlingRenderDelegate descriptors,
# renderDelegate.cpp:93-110).

import bpy


class GatlingTorchRenderProperties(bpy.types.PropertyGroup):
    spp: bpy.props.IntProperty(
        name="Samples per pixel", default=64, min=1)
    max_bounces: bpy.props.IntProperty(
        name="Max bounces", default=13, min=1)
    rr_bounce_offset: bpy.props.IntProperty(
        name="Russian roulette bounce offset", default=3, min=1)
    rr_inv_min_term_prob: bpy.props.FloatProperty(
        name="Russian roulette inverse min terminate probability",
        default=0.95, min=0.0, max=1.0)
    max_sample_value: bpy.props.FloatProperty(
        name="Max sample value", default=10.0, min=0.0)
    next_event_estimation: bpy.props.BoolProperty(
        name="Next event estimation", default=True)
    jittered_sampling: bpy.props.BoolProperty(
        name="Jittered sampling", default=True)
    filter_importance_sampling: bpy.props.BoolProperty(
        name="Filter importance sampling", default=True)
    depth_of_field: bpy.props.BoolProperty(
        name="Depth of field", default=False)
    clipping_planes: bpy.props.BoolProperty(
        name="Clipping planes", default=False)
    medium_stack_size: bpy.props.IntProperty(
        name="Medium stack size", default=0, min=0)
    max_volume_walk_length: bpy.props.IntProperty(
        name="Max volume walk length", default=7, min=1)
    progressive_accumulation: bpy.props.BoolProperty(
        name="Progressive accumulation", default=True)
    device: bpy.props.StringProperty(
        name="Device", description="cuda (the card) or cpu (the kernels' plain twins)",
        default="cuda")
    python_executable: bpy.props.StringProperty(
        name="Renderer python",
        description="Python interpreter with gatling_tpu_torch importable "
                    "(empty: Blender's own interpreter)",
        default="", subtype="FILE_PATH")

    @classmethod
    def register(cls):
        bpy.types.Scene.gatling_torch = bpy.props.PointerProperty(
            name="Gatling (CUDA)", description="Gatling (CUDA) render settings",
            type=cls)

    @classmethod
    def unregister(cls):
        del bpy.types.Scene.gatling_torch


register, unregister = bpy.utils.register_classes_factory((
    GatlingTorchRenderProperties,
))
