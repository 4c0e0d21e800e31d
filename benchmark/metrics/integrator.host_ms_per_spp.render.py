"""The traced passes' ``integrator.sample`` spans summed, ms, over the
frame samples they completed (one frame sample = one sample of every
pixel): the integrator's host time, launches and waits, a frame sample."""

from harness import spans


def read(ctx):
    got = spans.named("integrator.sample", ctx["trace"].window)
    if got is None or not ctx.get("spp"):
        return None
    return 1e3 * spans.seconds(got) / ctx["spp"]
