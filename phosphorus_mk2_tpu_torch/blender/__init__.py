"""Blender add-on: the phosphorus_mk2_tpu_torch render engine.

The port's counterpart of the JAX add-on (``plugins/blender/phosphorus_tpu/``),
module for module: ``exporter`` turns the evaluated depsgraph into a
``phosphorus_mk2_tpu_torch`` Scene, ``engine`` streams the ``Renderer``'s
progressive passes into Blender's RenderResult from a CUDA card,
``properties`` and ``ui`` are the render settings and their panel. The
engine, the settings and the panel carry this add-on's own names (engine
``PHOSPHORUS_TPU_TORCH``, ``Scene.phosphorus_tpu_torch``), so the JAX
add-on can be enabled beside it.

Install: link this directory into Blender's ``scripts/addons`` as
``phosphorus_tpu_torch`` (any folder name works: the add-on imports its
own modules relatively). Blender's Python needs ``torch`` built for CUDA
and ``phosphorus_mk2_tpu_torch`` on its path.

Importing this package imports nothing of ``bpy``; ``register()``, which
Blender calls, does.
"""

bl_info = {
    "name": "Phosphorus TPU (PyTorch/CUDA)",
    "author": "phosphorus_mk2_tpu",
    "version": (0, 1, 0),
    "blender": (3, 0, 0),
    "category": "Render",
    "description": "Differentiable path tracer on an NVIDIA GPU "
                   "(the PyTorch/CUDA port of phosphorus_mk2_tpu)",
}


def _classes():
    from .engine import PhosphorusRenderEngine
    from .properties import PhosphorusTorchRenderSettings
    from .ui import PHOSPHORUS_TORCH_RENDER_PT_sampling

    return (
        PhosphorusTorchRenderSettings,
        PhosphorusRenderEngine,
        PHOSPHORUS_TORCH_RENDER_PT_sampling,
    )


def register():
    import bpy

    classes = _classes()
    for cls in classes:
        bpy.utils.register_class(cls)
    bpy.types.Scene.phosphorus_tpu_torch = bpy.props.PointerProperty(type=classes[0])


def unregister():
    import bpy

    del bpy.types.Scene.phosphorus_tpu_torch
    for cls in reversed(_classes()):
        bpy.utils.unregister_class(cls)
