"""Of the traced window's idle device time (the window less the union of
device intervals), the share that falls inside the program's
``integrator.sample`` spans: spans and device events share the clock."""

from harness import spans


def read(ctx):
    tr = ctx["trace"]
    samples = spans.named("integrator.sample", tr.window)
    idle = spans.idle_intervals(tr)
    total = sum(e - s for s, e in idle)
    if samples is None or total <= 0:
        return None
    return 100.0 * spans.overlap_ns(idle, samples) / total
