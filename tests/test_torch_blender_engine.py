"""The port's Blender render engine (phosphorus_mk2_tpu_torch/blender/)
on a stubbed bpy, on the CPU.

The scene is the JAX add-on test's two-view quad (tests/test_blender_engine.py
``_depsgraph``: a diffuse quad under a sky, 16x12, 2 spp, depth 2, the
brute tracer). Each pass the engine writes must equal, bit for bit after
the y-flip, the film of the port's own ``Renderer`` on that eye's camera
(the same code on the same inputs), and the JAX engine's pass on the
same depsgraph within tests/test_torch_render.py's rule for depth > 1
(rtol 1e-3, atol 1e-6 on >= 99% of the pixels, means within 1e-3: past
the first bounce the two packages' last-bit differences move a few
paths).
"""
import copy
import sys
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu_torch.tools import blender_stub

bpy = blender_stub.install()

import phosphorus_mk2_tpu_torch.blender as addon  # noqa: E402
from phosphorus_mk2_tpu_torch.blender.engine import PhosphorusRenderEngine  # noqa: E402
from phosphorus_mk2_tpu_torch.blender.exporter import export_scene  # noqa: E402
from phosphorus_mk2_tpu_torch.core.options import Options  # noqa: E402
from phosphorus_mk2_tpu_torch.renderer import Renderer  # noqa: E402

sys.path.insert(0, "plugins/blender")

from phosphorus_tpu.engine import PhosphorusRenderEngine as JaxEngine  # noqa: E402

from tests.test_blender_engine import _depsgraph  # noqa: E402

torch.set_num_threads(1)

W, H = 16, 12
EYE_OFFSET = 0.35  # the JAX test's stereo offset


class _Engine(blender_stub.EngineHarness, PhosphorusRenderEngine):
    device = "cpu"


class _JaxEngine(blender_stub.EngineHarness, JaxEngine):
    pass


def _graph(**settings):
    """The JAX test's depsgraph, its settings also under the port's name."""
    dg = _depsgraph()
    s = vars(dg.scene.phosphorus_tpu) | settings
    dg.scene.phosphorus_tpu = NS(**s)
    dg.scene.phosphorus_tpu_torch = NS(**s)
    return dg


def _eye_scene(dg, view):
    """The port export with the eye's camera set independently of the
    engine: the camera's world matrix, moved for the right eye, as the
    row-vector to_world; a deep copy, so nothing is shared."""
    scene = copy.deepcopy(export_scene(dg, dg.scene))
    m = np.array(dg.scene.camera.matrix_world, np.float32)
    if view == "right":
        m[0, 3] += EYE_OFFSET
    scene.camera.to_world = m.T.copy()
    return scene


def _options(s):
    return Options(samples_per_pixel=s.samples_per_pixel, paths_per_sample=s.paths_per_sample,
                   path_depth=s.max_depth, samples_per_pass=s.samples_per_pass,
                   use_bvh=s.use_bvh)


def _rects(eng, name):
    return {v: eng.rect(name, v) for v in (eng.views or [None])}


def _flipped(film, key):
    return np.ascontiguousarray(film[key][::-1], np.float32).reshape(-1)


@pytest.mark.parametrize("views", [["left", "right"], []], ids=["stereo", "single"])
def test_passes_equal_the_renderer_films(views):
    """Combined (colour and alpha) and Normal of every view equal the last
    film of Renderer on that eye's camera, y-flipped, bit for bit; the
    eyes differ; one update a pass; progress rises to 1."""
    dg = _graph(normal_pass=True, samples_per_pixel=4)
    eng = _Engine(views)
    eng.render(dg)
    s = dg.scene.phosphorus_tpu_torch
    assert eng.active_views == views and eng.ended
    combined, normal = _rects(eng, "Combined"), _rects(eng, "Normal")
    for view in views or [None]:
        film = list(Renderer(_eye_scene(dg, view), _options(s), device="cpu").passes())[-1][0]
        want = np.ones((H, W, 4), np.float32)
        want[..., :3] = film["color"]
        want[..., 3] = film["alpha"]
        np.testing.assert_array_equal(combined[view], want[::-1].reshape(-1), err_msg=view)
        np.testing.assert_array_equal(normal[view], _flipped(film, "normal"), err_msg=view)
        assert combined[view].max() > 0
    if views:
        assert not np.allclose(combined["left"], combined["right"])
    n_views = max(1, len(views))
    assert eng.updates == n_views * 2
    assert eng.progress == sorted(eng.progress) and eng.progress[-1] == 1.0
    assert len(eng.progress) == n_views * 2


@pytest.mark.parametrize("views", [["left", "right"], []], ids=["stereo", "single"])
def test_passes_hold_to_the_jax_engine(views):
    """The port engine's passes against the JAX engine's on one depsgraph,
    both render loops on the same harness."""
    dg = _graph(normal_pass=True)
    port, jax_ = _Engine(views), _JaxEngine(views)
    port.render(dg)
    jax_.render(dg)
    assert port.progress == jax_.progress and port.updates == jax_.updates
    for name, ch in (("Combined", 4), ("Normal", 3)):
        got, ref = _rects(port, name), _rects(jax_, name)
        for view in views or [None]:
            g, r = got[view].reshape(-1, ch), ref[view].reshape(-1, ch)
            per_pixel = np.isclose(g, r, rtol=1e-3, atol=1e-6).all(axis=-1)
            assert per_pixel.mean() >= 0.99, (name, view, per_pixel.mean())
            np.testing.assert_allclose(g.mean(), r.mean(), rtol=1e-3)
            np.testing.assert_allclose(g.mean(axis=0), r.mean(axis=0), rtol=1e-3, atol=1e-7)


def test_normal_pass_off_registers_no_pass():
    eng = _Engine(["left", "right"])
    eng.render(_graph())
    assert eng.pass_names == ["Combined"]
    assert eng.rect("Normal", "left") is None and eng.rect("Combined", "left") is not None


@pytest.mark.parametrize("views", [["left", "right"], []], ids=["stereo", "single"])
def test_test_break_mid_render(views):
    """test_break answering True after the first pass (polls: before the
    pass, after it) leaves that pass written and returns normally, with
    the result ended and no later view begun."""
    dg = _graph(samples_per_pixel=4)
    eng = _Engine(views, break_after=2)
    eng.render(dg)
    assert eng.updates == 1 and eng.ended
    first = (views or [None])[0]
    assert eng.result.layers[0].passes.find_by_name("Combined", first).rect.writes == 1
    assert eng.progress == [0.5 / max(1, len(views))]
    if views:
        assert eng.active_views == ["left"] and eng.rect("Combined", "right") is None
    # the pass written is the uninterrupted render's first pass
    film = next(iter(Renderer(_eye_scene(dg, first), _options(dg.scene.phosphorus_tpu_torch),
                              device="cpu").passes()))[0]
    np.testing.assert_array_equal(eng.rect("Combined", first).reshape(-1, 4)[:, :3],
                                  _flipped(film, "color").reshape(-1, 3))


def test_render_on_the_default_device_needs_a_card():
    """The engine renders on cuda unless told otherwise: without a card
    the Renderer raises, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert PhosphorusRenderEngine.device == "cuda"

    class Engine(blender_stub.EngineHarness, PhosphorusRenderEngine):
        pass

    eng = Engine(["left", "right"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eng.render(_graph())
    assert eng.updates == 0 and eng.rect("Combined", "left") is None


def test_register_and_unregister(monkeypatch):
    """register() registers the settings, the engine and the panel (the
    port's names) and the port's Scene property; unregister() takes them
    away again and leaves the JAX add-on's property alone."""
    registered = []
    monkeypatch.setattr(bpy.utils, "register_class", registered.append)
    monkeypatch.setattr(bpy.utils, "unregister_class", registered.remove)
    monkeypatch.setattr(bpy.props, "PointerProperty", lambda type: ("pointer", type))
    jax_prop = object()
    monkeypatch.setattr(bpy.types.Scene, "phosphorus_tpu", jax_prop, raising=False)
    addon.register()
    names = [c.__name__ for c in registered]
    assert names == ["PhosphorusTorchRenderSettings", "PhosphorusRenderEngine",
                     "PHOSPHORUS_TORCH_RENDER_PT_sampling"]
    assert registered[1].bl_idname == "PHOSPHORUS_TPU_TORCH"
    assert registered[2].COMPAT_ENGINES == {"PHOSPHORUS_TPU_TORCH"}
    assert bpy.types.Scene.phosphorus_tpu_torch == ("pointer", registered[0])
    assert bpy.types.Scene.phosphorus_tpu is jax_prop
    addon.unregister()
    assert registered == [] and not hasattr(bpy.types.Scene, "phosphorus_tpu_torch")
    assert bpy.types.Scene.phosphorus_tpu is jax_prop
    assert addon.bl_info["name"] != "Phosphorus TPU"


def test_panel_draws_the_port_settings():
    from phosphorus_mk2_tpu_torch.blender.ui import PHOSPHORUS_TORCH_RENDER_PT_sampling as Panel

    drawn = []
    settings = blender_stub.default_settings()
    panel = Panel()
    panel.layout = NS(column=lambda: NS(prop=lambda s, name: drawn.append((s, name))))
    panel.draw(NS(scene=NS(phosphorus_tpu_torch=settings)))
    assert drawn == [(settings, n) for n in ("samples_per_pixel", "max_depth",
                                             "samples_per_pass", "use_bvh", "normal_pass")]
    assert Panel.poll(NS(engine="PHOSPHORUS_TPU_TORCH"))
    assert not Panel.poll(NS(engine="PHOSPHORUS_TPU"))


def test_settings_are_the_jax_add_on_s():
    """The same six settings with the same defaults, names and bounds
    (read from both sources, so under any bpy stub)."""
    import ast

    def props(path):
        tree = ast.parse(open(path).read())
        return {n.target.id: (n.annotation.func.attr,
                              {k.arg: ast.literal_eval(k.value) for k in n.annotation.keywords})
                for n in ast.walk(tree) if isinstance(n, ast.AnnAssign)}

    port = props("phosphorus_mk2_tpu_torch/blender/properties.py")
    assert port == props("plugins/blender/phosphorus_tpu/properties.py")
    assert vars(blender_stub.default_settings()) == {
        "samples_per_pixel": 16, "paths_per_sample": 1, "max_depth": 9,
        "samples_per_pass": 4, "use_bvh": True, "normal_pass": False}
