"""RenderEngine: progressive wavefront rendering into Blender, on the card.

The JAX add-on's render loop (``plugins/blender/phosphorus_tpu/engine.py``)
on the port's ``Renderer``, and through it the reference's session/render
path (reference plugins/blender/session.cpp:211: determine passes
Combined/Normal, build tiles + sink + sampler + frame state, start/join
devices): the Renderer session streams whole progressive passes into the
RenderResult (update_result per pass), with Combined + Normal passes like
the reference (session.cpp:135-155). Every view of a multiview result is
rendered, each from its eye's camera (session.cpp:223-227), and
``test_break`` is polled between passes and between wavefront chunks.

The render runs on ``device`` (a class attribute, "cuda" unless a caller
sets it); without a card the Renderer raises.
"""
from __future__ import annotations

import copy

import numpy as np

try:
    import bpy
except ImportError:  # imported outside Blender (tests, docs)
    bpy = None


if bpy is not None:

    class PhosphorusRenderEngine(bpy.types.RenderEngine):
        bl_idname = "PHOSPHORUS_TPU_TORCH"
        bl_label = "Phosphorus TPU (PyTorch/CUDA)"
        bl_use_preview = False
        device = "cuda"

        def render(self, depsgraph):
            from phosphorus_mk2_tpu_torch.core.options import Options
            from phosphorus_mk2_tpu_torch.renderer import Renderer

            from .exporter import camera_to_world, export_scene

            bl_scene = depsgraph.scene
            settings = bl_scene.phosphorus_tpu_torch

            scene = export_scene(depsgraph, bl_scene)
            w, h = scene.camera.width, scene.camera.height

            options = Options(
                samples_per_pixel=settings.samples_per_pixel,
                paths_per_sample=settings.paths_per_sample,
                path_depth=settings.max_depth,
                samples_per_pass=settings.samples_per_pass,
                use_bvh=settings.use_bvh,
            )

            if settings.normal_pass:
                self.add_pass("Normal", 3, "XYZ")
            result = self.begin_result(0, 0, w, h)
            layer = result.layers[0]

            # multi-view: render EVERY RenderResult view, like the reference
            # session loop (reference plugins/blender/session.cpp:223-227),
            # each from the eye matrix of the RenderEngine multiview API. A
            # view's scene is a shallow copy with its own camera: building
            # and rendering change nothing that differs between the eyes
            # (Scene.build may give a normal-mapped mesh its tangents, the
            # same for every eye)
            views = [v.name for v in result.views] or [None]
            n_views = len(views)
            for vi, view_name in enumerate(views):
                view_scene = scene
                if view_name:
                    self.active_view_set(view_name)
                    view_scene = copy.copy(scene)
                    view_scene.camera = copy.copy(scene.camera)
                    view_scene.camera.to_world = camera_to_world(
                        self.camera_model_matrix(bl_scene.camera)
                    )
                renderer = Renderer(view_scene, options, device=self.device)

                for film, done in renderer.passes(cancel=self.test_break):
                    if self.test_break():
                        break
                    combined = np.ones((h, w, 4), np.float32)
                    combined[..., :3] = film["color"]
                    combined[..., 3] = film["alpha"]
                    # y-flip into Blender's bottom-up convention
                    # (reference sink.cpp:95-118 does the same flip)
                    _set_rect(
                        _find_pass(layer, "Combined", view_name),
                        combined[::-1].reshape(-1, 4),
                    )
                    npass = _find_pass(layer, "Normal", view_name)
                    if npass is not None:
                        _set_rect(npass, film["normal"][::-1].reshape(-1, 3))
                    self.update_result(result)
                    self.update_progress(
                        (vi + done / options.samples_per_pixel) / n_views
                    )
                if self.test_break():
                    break

            self.end_result(result)


def _find_pass(layer, name: str, view_name):
    """RenderPass for (name, view): multiview results key passes by
    (name, view); single-view falls back to the plain mapping. Returns
    None when the pass wasn't registered (e.g. Normal off)."""
    if view_name and hasattr(layer.passes, "find_by_name"):
        return layer.passes.find_by_name(name, view_name)
    try:
        return layer.passes[name]
    except (KeyError, IndexError, TypeError):
        return None


def _set_rect(render_pass, arr: np.ndarray) -> None:
    """Write pixels into a RenderPass: foreach_set takes the flat float
    buffer directly, without a Python list per pixel."""
    if render_pass is None:
        return
    render_pass.rect.foreach_set(np.ascontiguousarray(arr, np.float32).reshape(-1))
