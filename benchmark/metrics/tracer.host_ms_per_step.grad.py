"""The traced steps' ``tracer.trace`` spans summed, ms, a step: the host
time of the cluster tracer's traces (closest and any-hit) in the forward,
their launches and syncs."""

from harness import spans


def read(ctx):
    got = spans.named("tracer.trace", ctx["trace"].window)
    if got is None or not ctx.get("steps"):
        return None
    return 1e3 * spans.seconds(got) / ctx["steps"]
