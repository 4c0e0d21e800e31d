"""The mean ``renderer.film_gather`` span of the traced passes, ms: the
sums copied to the host and normalised, where a pass waits for the card."""

from harness import spans


def read(ctx):
    return spans.mean_ms(ctx, "renderer.film_gather")
