"""Seconds the run's first-use loads of the kernel libraries took: the
program's ``setup.kernels`` spans summed (each a library's build, where
``build/torch_kernels/`` lacks it, and its ctypes load)."""

from harness import spans


def read(ctx):
    return spans.setup_s("setup.kernels")
