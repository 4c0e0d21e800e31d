"""RNA property group: the render settings, the JAX add-on's six with
its defaults (``plugins/blender/phosphorus_tpu/properties.py``; reference
plugins/blender/phosphoros/properties.py:14: spp / paths-per-sample /
max depth)."""
try:
    import bpy
except ImportError:  # imported outside Blender (tests, docs)
    bpy = None


if bpy is not None:

    class PhosphorusTorchRenderSettings(bpy.types.PropertyGroup):
        samples_per_pixel: bpy.props.IntProperty(
            name="Samples", description="Samples per pixel", default=16, min=1
        )
        paths_per_sample: bpy.props.IntProperty(
            name="Paths per sample", default=1, min=1
        )
        max_depth: bpy.props.IntProperty(
            name="Max path depth", default=9, min=1
        )
        samples_per_pass: bpy.props.IntProperty(
            name="Samples per pass",
            description="Progressive update granularity",
            default=4,
            min=1,
        )
        use_bvh: bpy.props.BoolProperty(name="Use BVH", default=True)
        normal_pass: bpy.props.BoolProperty(
            name="Normal pass",
            description="Render a Normal AOV pass alongside Combined",
            default=False,
        )
