"""The traced steps' lobe container calls under autograd summed, ms, a
step: the ``bsdf.kernel_grad`` and ``bsdf.eager`` spans (one a call of
``bsdf_f`` or ``bsdf_sample`` whose lobe weights require grad, by either
route), the host time of the bsdf layer in a gradient step, launches and
any wait they meet included."""

from harness import spans


def read(ctx):
    got = [s for name in ("bsdf.kernel_grad", "bsdf.eager")
           for s in spans.named(name, ctx["trace"].window) or ()]
    if not got or not ctx.get("steps"):
        return None
    return 1e3 * spans.seconds(got) / ctx["steps"]
