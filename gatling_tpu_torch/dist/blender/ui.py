# Render-settings panels (reference: dist/blender/ui.py — viewport/final
# panels grouping sampling, path and volume settings).

import bpy


class GATLING_TORCH_PT_sampling(bpy.types.Panel):
    bl_idname = "GATLING_TORCH_PT_sampling"
    bl_label = "Sampling"
    bl_space_type = "PROPERTIES"
    bl_region_type = "WINDOW"
    bl_context = "render"
    COMPAT_ENGINES = {"GATLING_TORCH"}

    @classmethod
    def poll(cls, context):
        return context.engine in cls.COMPAT_ENGINES

    def draw(self, context):
        layout = self.layout
        layout.use_property_split = True
        s = context.scene.gatling_torch
        layout.prop(s, "spp")
        layout.prop(s, "max_sample_value")
        layout.prop(s, "jittered_sampling")
        layout.prop(s, "filter_importance_sampling")
        layout.prop(s, "progressive_accumulation")


class GATLING_TORCH_PT_path(bpy.types.Panel):
    bl_idname = "GATLING_TORCH_PT_path"
    bl_label = "Path Tracing"
    bl_space_type = "PROPERTIES"
    bl_region_type = "WINDOW"
    bl_context = "render"
    COMPAT_ENGINES = {"GATLING_TORCH"}

    @classmethod
    def poll(cls, context):
        return context.engine in cls.COMPAT_ENGINES

    def draw(self, context):
        layout = self.layout
        layout.use_property_split = True
        s = context.scene.gatling_torch
        layout.prop(s, "max_bounces")
        layout.prop(s, "next_event_estimation")
        layout.prop(s, "rr_bounce_offset")
        layout.prop(s, "rr_inv_min_term_prob")
        layout.prop(s, "depth_of_field")
        layout.prop(s, "clipping_planes")


class GATLING_TORCH_PT_volumes(bpy.types.Panel):
    bl_idname = "GATLING_TORCH_PT_volumes"
    bl_label = "Volumes"
    bl_space_type = "PROPERTIES"
    bl_region_type = "WINDOW"
    bl_context = "render"
    bl_options = {"DEFAULT_CLOSED"}
    COMPAT_ENGINES = {"GATLING_TORCH"}

    @classmethod
    def poll(cls, context):
        return context.engine in cls.COMPAT_ENGINES

    def draw(self, context):
        layout = self.layout
        layout.use_property_split = True
        s = context.scene.gatling_torch
        layout.prop(s, "medium_stack_size")
        layout.prop(s, "max_volume_walk_length")


class GATLING_TORCH_PT_runtime(bpy.types.Panel):
    bl_idname = "GATLING_TORCH_PT_runtime"
    bl_label = "Runtime"
    bl_space_type = "PROPERTIES"
    bl_region_type = "WINDOW"
    bl_context = "render"
    bl_options = {"DEFAULT_CLOSED"}
    COMPAT_ENGINES = {"GATLING_TORCH"}

    @classmethod
    def poll(cls, context):
        return context.engine in cls.COMPAT_ENGINES

    def draw(self, context):
        layout = self.layout
        layout.use_property_split = True
        layout.prop(context.scene.gatling_torch, "device")
        layout.prop(context.scene.gatling_torch, "python_executable")


register, unregister = bpy.utils.register_classes_factory((
    GATLING_TORCH_PT_sampling,
    GATLING_TORCH_PT_path,
    GATLING_TORCH_PT_volumes,
    GATLING_TORCH_PT_runtime,
))
