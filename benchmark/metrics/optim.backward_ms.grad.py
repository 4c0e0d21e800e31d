"""The mean ``optim.backward`` span of the traced steps, ms: the host's
time in ``loss.backward()`` (its launches, and any wait they meet)."""

from harness import spans


def read(ctx):
    return spans.mean_ms(ctx, "optim.backward")
