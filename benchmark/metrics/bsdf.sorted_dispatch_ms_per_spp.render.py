"""The traced passes' ``bsdf.sorted_dispatch`` spans summed, ms, over the
frame samples they completed: the host time of the type-sorted lobe
dispatch, its per-type counts read on the host included, a frame sample."""

from harness import spans


def read(ctx):
    got = spans.named("bsdf.sorted_dispatch", ctx["trace"].window)
    if got is None or not ctx.get("spp"):
        return None
    return 1e3 * spans.seconds(got) / ctx["spp"]
