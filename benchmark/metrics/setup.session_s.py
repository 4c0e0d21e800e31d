"""Seconds to build the session (``Renderer`` or ``InverseRenderer``:
Scene.build, the native BVH and its tables), host clock, synchronised."""


def read(ctx):
    return ctx.get("session_s")
