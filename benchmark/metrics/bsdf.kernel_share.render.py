"""The share of the traced passes' lobe container calls that took the
CUDA kernel: ``bsdf.kernel`` spans over ``bsdf.kernel`` and ``bsdf.eager``
spans together, by count (1.0: every call was one launch)."""

from harness import spans


def read(ctx):
    window = ctx["trace"].window
    kernel = len(spans.named("bsdf.kernel", window) or ())
    eager = len(spans.named("bsdf.eager", window) or ())
    if not kernel + eager:
        return None
    return kernel / (kernel + eager)
