"""The port stands alone: it never imports JAX or the JAX package, and
its entry points never move to the CPU behind the caller's back."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import phosphorus_mk2_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "phosphorus_mk2_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "phosphorus_mk2_tpu", "phosphorus_tpu")  # the last: the JAX add-on


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            phosphorus_mk2_tpu_torch.__path__, "phosphorus_mk2_tpu_torch."
        )
    )


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {['phosphorus_mk2_tpu_torch'] + _modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]", out


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from phosphorus_mk2_tpu_torch.core.options import Options
    from phosphorus_mk2_tpu_torch.renderer import Renderer
    from phosphorus_mk2_tpu_torch.scenes import cornell_box

    scene = cornell_box(8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scene.build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(scene, Options(use_bvh=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scene.build(device="cpu").to("cuda")
    from phosphorus_mk2_tpu_torch.io.yaml_scene import import_scene
    from phosphorus_mk2_tpu_torch.parallel import make_render_mesh, make_wave_mesh

    for make in (make_wave_mesh, make_render_mesh, lambda: make_wave_mesh(2, "cuda:0")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(scene, Options(use_bvh=False), n_devices=2)
    # an imported scene builds on the card by default, as a built-in one does
    with pytest.raises(RuntimeError, match="no CUDA device"):
        import_scene(str(ROOT / "examples" / "cornell.yaml")).build()


def test_the_new_modules_are_walked():
    mods = _modules()
    for name in ("accel.bvh_builder", "accel.native_bvh", "accel.cluster_traverse",
                 "accel.front", "accel.build", "accel.wave", "tools.row_gather_probe",
                 "io.ogawa", "io.abc", "io.alembic", "io.obj", "io.ply", "io.exr",
                 "io.yaml_scene", "parallel.distributed", "parallel.sharding",
                 "tools.bmw_asset", "tools.rank_parity", "blender", "blender.exporter",
                 "blender.properties", "blender.engine", "blender.ui", "tools.blender_stub"):
        assert f"phosphorus_mk2_tpu_torch.{name}" in mods, name
    sources = {p.name for p in (PACKAGE / "csrc").iterdir()}
    assert {"mt.cu", "front.cu", "wave.cu", "bvh_builder.cpp"} <= sources


def test_default_options_render_a_scene_above_1024_triangles():
    """Options() has use_bvh=True: the cluster tracer, not an error."""
    from phosphorus_mk2_tpu_torch.accel import cluster_traverse
    from phosphorus_mk2_tpu_torch.core.options import Options
    from phosphorus_mk2_tpu_torch.renderer import Renderer
    from phosphorus_mk2_tpu_torch.scenes import multi_bsdf_scene

    opts = Options()
    assert opts.use_bvh is True and opts.tracer_tune is None
    opts.samples_per_pixel, opts.path_depth = 1, 2
    r = Renderer(multi_bsdf_scene(8, 8), opts, device="cpu")
    assert r.data.num_tris > 1024
    assert r.tracer[0].func is cluster_traverse.intersect_clusters
    film = r.render()["color"]
    assert film.shape == (8, 8, 3) and (film > 0).any()


def test_kernels_are_never_built_at_import():
    """Importing the port compiles nothing: there is no nvcc where the
    tests run, and the libraries are built at first use on the card."""
    from phosphorus_mk2_tpu_torch.accel import front, mt, wave

    assert front._lib is None and mt._lib is None and wave._lib is None
    if not torch.cuda.is_available():
        for mod in (front, wave):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                mod.build()


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
