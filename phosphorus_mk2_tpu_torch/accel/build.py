"""Compile one source of ``csrc/`` into a shared library at first use.

The libraries go into ``build/torch_kernels/`` at the root of the
checkout, named by a hash of the source and the flags, so a changed
source or flag builds anew and an unchanged one is loaded as it is.
Nothing here swallows a failure: a missing compiler or a compiler error
raises ``RuntimeError`` with the compiler's output. Each build counts in
``utils.profiling.COUNTERS["kernels.builds"]``, and each library's
first-use load (``load_shared``) is a ``setup.kernels`` span.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from phosphorus_mk2_tpu_torch.utils.profiling import COUNTERS, span

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def compile_shared(source: Path, compiler: str, flags: tuple, stem: str):
    """Build ``source`` with ``compiler flags -o <lib> source`` unless the
    library for this source and these flags exists. Returns (path of the
    library, the compiler's output; "" when nothing was compiled)."""
    tag = hashlib.sha1(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{stem}_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # built under a temporary name and renamed, so that a second process
    # never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run([compiler, *flags, "-o", tmp, str(source)],
                         capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{compiler} failed ({res.returncode}) on {source.name}:\n{log}")
    os.replace(tmp, out)
    COUNTERS["kernels.builds"] += 1
    return out, log


def load_shared(source: Path, compiler: str, flags: tuple, stem: str):
    """``compile_shared``, then the library loaded through ctypes, inside
    one ``setup.kernels`` span whose args hold the library's stem and
    whether it was built. Returns (the library, the compiler's output)."""
    with span("setup.kernels", {"lib": stem}) as sp:
        builds = COUNTERS["kernels.builds"]
        out, log = compile_shared(source, compiler, flags, stem)
        sp.args["built"] = COUNTERS["kernels.builds"] > builds
        return ctypes.CDLL(str(out)), log
