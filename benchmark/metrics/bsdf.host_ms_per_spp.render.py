"""The traced passes' lobe container calls summed, ms, over the frame
samples they completed: the ``bsdf.kernel`` and ``bsdf.eager`` spans (one
a call of ``bsdf_f``, ``bsdf_pdf`` or ``bsdf_sample``), the host time of
the bsdf layer a frame sample, launches and host reads included."""

from harness import spans


def read(ctx):
    got = [s for name in ("bsdf.kernel", "bsdf.eager")
           for s in spans.named(name, ctx["trace"].window) or ()]
    if not got or not ctx.get("spp"):
        return None
    return 1e3 * spans.seconds(got) / ctx["spp"]
