"""Calls of the session's sharded render function a pass (the wavefront
chunks), counted by the entry's wrapper around ``Renderer.fn``."""


def read(ctx):
    if not ctx.get("passes"):
        return None
    return ctx["chunks"] / ctx["passes"]
