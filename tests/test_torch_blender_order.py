"""The two Blender add-ons' tests share one process in either order.

The JAX add-on's engine test (tests/test_blender_engine.py) and the
port's add-on tests each install a stub ``bpy`` with
``sys.modules.setdefault``, so whichever runs first provides the stub the
other runs on; under ``--dist loadfile`` a worker may run the files in
any order. Each order runs in a pytest process of its own.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_TEST = "tests/test_blender_engine.py"
PORT_TESTS = ["tests/test_torch_blender_exporter.py", "tests/test_torch_blender_engine.py"]


@pytest.mark.parametrize("files", [[JAX_TEST, *PORT_TESTS], [*PORT_TESTS, JAX_TEST]],
                         ids=["jax_stub_first", "port_stub_first"])
def test_add_on_tests_pass_in_one_process(files):
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-p", "no:xdist", *files],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-2000:]
    assert " passed" in run.stdout and "failed" not in run.stdout, run.stdout[-2000:]
