"""The traced passes' ``tracer.trace`` spans, mean ms: the host time of one
cluster-tracer trace (closest or any-hit), its launches and syncs."""

from harness import spans


def read(ctx):
    return spans.mean_ms(ctx, "tracer.trace")
