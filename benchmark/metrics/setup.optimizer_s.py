"""Seconds the optimizer's construction in ``InverseRenderer`` took: the
program's ``setup.optimizer`` span."""

from harness import spans


def read(ctx):
    return spans.setup_s("setup.optimizer")
