"""Device operations in the traced passes over the frame samples they
completed (one frame sample = one sample of every pixel)."""


def read(ctx):
    if not ctx.get("spp"):
        return None
    return ctx["trace"].kernel_count() / ctx["spp"]
