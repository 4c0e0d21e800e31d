"""Render-settings panel (the JAX add-on's
``plugins/blender/phosphorus_tpu/ui.py``; reference
plugins/blender/phosphoros/ui.py), shown for this add-on's engine."""
try:
    import bpy
except ImportError:  # imported outside Blender (tests, docs)
    bpy = None


if bpy is not None:

    class PHOSPHORUS_TORCH_RENDER_PT_sampling(bpy.types.Panel):
        bl_label = "Sampling"
        bl_space_type = "PROPERTIES"
        bl_region_type = "WINDOW"
        bl_context = "render"
        COMPAT_ENGINES = {"PHOSPHORUS_TPU_TORCH"}

        @classmethod
        def poll(cls, context):
            return context.engine in cls.COMPAT_ENGINES

        def draw(self, context):
            settings = context.scene.phosphorus_tpu_torch
            col = self.layout.column()
            col.prop(settings, "samples_per_pixel")
            col.prop(settings, "max_depth")
            col.prop(settings, "samples_per_pass")
            col.prop(settings, "use_bvh")
            col.prop(settings, "normal_pass")
