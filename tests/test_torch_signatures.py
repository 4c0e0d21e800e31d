"""Every JAX module's top-level public constants, and the parameter names
of every public function and method it defines, have their counterparts
in the port's module of the same path, but for an allow-list with a
reason each; an allow-list entry that no longer applies fails.

tests/test_torch_public_names.py holds the names of functions and
classes; this file holds what that walk does not see: module constants
(a threshold such as integrator/path.py's HIT_ROW_MAX_TRIS) and
parameters (a form of a function the port left out). The port may add
parameters of its own (device=, plain=); a JAX parameter must be there
under its name, or under the name the allow-list gives.
"""
import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "phosphorus_mk2_tpu"

# JAX modules whose Pallas kernels the port has in csrc/ (no module of the
# same path; tests/test_torch_public_names.py holds that)
NO_COUNTERPART = ("accel/pallas_mt.py", "accel/pallas_front.py")
ONE_DISPATCH = ("the port has one eager lobe dispatch (bsdf/lobes.py, dense), and the tests "
                "hold it against both of JAX's, so there is nothing to select")
# (module, function, JAX parameter): (the port's parameter or None, why)
RENAMED = {
    ("core/camera.py", "generate_rays", "camera_params"):
        ("cam", "the port's camera dict is cam in every integrator function"),
    ("integrator/path.py", "trace_sample", "key"):
        ("seed", "an integer seed: torch has no jax.random key; its low 32 bits key the "
                 "counter-based RNG as jax.random.key(seed) does"),
    ("integrator/path.py", "render_pass_pixels", "key"): ("seed", "as trace_sample's key"),
    ("integrator/path.py", "render_pass", "key"): ("seed", "as trace_sample's key"),
    ("integrator/path.py", "render_aovs", "key"): ("seed", "as trace_sample's key"),
    ("math/sampling.py", "stratified_2d", "key"):
        ("seed", "an integer seed for the port's counter-based RNG"),
    ("parallel/sharding.py", "make_sharded_render", "scene"):
        ("data", "the SceneData the render function is built for, as the port's "
                 "Renderer passes it"),
    ("integrator/path.py", "trace_sample", "depth_unroll"):
        (None, "the bounce scan's unroll: the port's bounce loop is eager Python, with no "
               "scan to unroll (Options and render_pass_pixels accept it and ignore it)"),
    **{(module, name, "sorted_dispatch"): (None, ONE_DISPATCH) for module, name in (
        ("integrator/path.py", "trace_sample"), ("integrator/path.py", "render_pass_pixels"),
        ("integrator/path.py", "render_pass"), ("optim.py", "InverseRenderer.__init__"))},
}


def _modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                  if str(p.relative_to(JAX_PKG)) not in NO_COUNTERPART)


def _params(fn: ast.FunctionDef):
    a = fn.args
    names = [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _jax_api(module):
    """(public constants, {qualified function name: parameter names})."""
    tree = ast.parse((JAX_PKG / module).read_text(), filename=module)
    consts, funcs = [], {}
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for x in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(x, ast.Name) and not x.id.startswith("_"):
                        consts.append(x.id)
        elif isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            funcs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if isinstance(m, ast.FunctionDef) and (
                        not m.name.startswith("_") or m.name == "__init__"):
                    funcs[f"{node.name}.{m.name}"] = _params(m)
    return consts, funcs


def _port(module):
    return importlib.import_module(
        "phosphorus_mk2_tpu_torch." + module[:-3].replace("/", ".").removesuffix(".__init__"))


def _port_params(port, qualname):
    """The port's parameter names of qualname, or None where the port has
    no such function (tests/test_torch_public_names.py's concern)."""
    obj = port
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    try:
        return list(inspect.signature(obj).parameters)
    except (TypeError, ValueError):  # a builtin or a class without a Python __init__
        return None


@pytest.mark.parametrize("module", _modules())
def test_constants_ported(module):
    consts, _ = _jax_api(module)
    port = _port(module)
    assert [c for c in consts if not hasattr(port, c)] == [], module


@pytest.mark.parametrize("module", _modules())
def test_parameters_ported(module):
    _, funcs = _jax_api(module)
    port = _port(module)
    missing = []
    for name, params in funcs.items():
        have = _port_params(port, name)
        if have is None:
            continue
        for p in params:
            if p in have or p in ("self", "cls"):  # a classmethod's signature has no cls
                continue
            renamed = RENAMED.get((module, name, p))
            if renamed is None or (renamed[0] is not None and renamed[0] not in have):
                missing.append(f"{name}({p})")
    assert missing == [], module


@pytest.mark.parametrize("entry", sorted(RENAMED))
def test_allow_list_is_current(entry):
    """Each entry still names a JAX parameter the port lacks under that
    name, and the port's replacement where it gives one; and has a reason."""
    module, name, param = entry
    port_name, why = RENAMED[entry]
    assert why
    _, funcs = _jax_api(module)
    assert param in funcs.get(name, ()), f"{entry}: no longer a JAX parameter"
    have = _port_params(_port(module), name)
    assert have is not None, f"{entry}: the port has no {name}"
    assert param not in have, f"{entry}: the port now has {param}"
    assert port_name is None or port_name in have, f"{entry}: the port has no {port_name}"


def test_the_walk_sees_constants_and_parameters():
    """The walk finds what the public-names walk could not: the hit-row
    threshold and sample_lights' optional tables."""
    consts, _ = _jax_api("integrator/path.py")
    assert "HIT_ROW_MAX_TRIS" in consts and "SCOPABLE_FIELDS" in consts
    _, funcs = _jax_api("core/lights.py")
    assert funcs["sample_lights"][4:] == ["attr", "meta", "lt_table", "attr_w"]
    assert _port_params(_port("core/lights.py"), "sample_lights") == [
        "scene", "u_pick", "u_tri", "u_uv", "attr", "meta", "lt_table", "attr_w"]
