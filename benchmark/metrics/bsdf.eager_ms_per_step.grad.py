"""The traced steps' ``bsdf.eager`` spans summed, ms, a step: the host time
of the lobe container's calls under autograd (the eager dense dispatch of
every present lobe type), their launches and any wait they meet."""

from harness import spans


def read(ctx):
    got = spans.named("bsdf.eager", ctx["trace"].window)
    if got is None or not ctx.get("steps"):
        return None
    return 1e3 * spans.seconds(got) / ctx["steps"]
