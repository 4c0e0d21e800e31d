"""The share of the traced steps' lobe container calls under autograd that
took the weight-gradient kernels: ``bsdf.kernel_grad`` spans over
``bsdf.kernel_grad`` and ``bsdf.eager`` spans together, by count (1.0:
every such call was one forward launch and one backward launch; 0: every
one ran the eager lobe code)."""

from harness import spans


def read(ctx):
    window = ctx["trace"].window
    kernel_grad = len(spans.named("bsdf.kernel_grad", window) or ())
    eager = len(spans.named("bsdf.eager", window) or ())
    if not kernel_grad + eager:
        return None
    return kernel_grad / (kernel_grad + eager)
