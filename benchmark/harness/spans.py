"""The program's own spans, for the per-layer readers of ``program_span``
metrics: the port records them in memory (``utils/profiling.py``
``RECORDER``), stamped with ``time.time_ns()``, the clock of the
profiler's events, so they lie on the traced window's timeline. Set-up
spans (``setup.*``) are kept whatever the tracing state and are read over
the whole run; the others only inside the window. A program that records
no spans reads as None everywhere, never as an error."""
from __future__ import annotations


def recorded():
    """Every span the program kept, or None where it keeps none."""
    try:
        from phosphorus_mk2_tpu_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "RECORDER", None)
    return None if rec is None else list(rec.spans)


def named(name: str, window=None):
    """[(start ns, end ns)] of the spans called ``name`` (inside
    ``window``, a (start, end) in ns, when given), by start; None where
    the program keeps no spans or none of that name."""
    spans = recorded()
    if spans is None:
        return None
    out = sorted((s.start, s.end) for s in spans if s.name == name and (
        window is None or (window[0] <= s.start and s.end <= window[1])))
    return out or None


def seconds(intervals) -> float:
    return sum(e - s for s, e in intervals) * 1e-9


def mean_ms(ctx, name: str):
    """The mean duration, ms, of the spans called ``name`` in the window."""
    got = named(name, ctx["trace"].window)
    return None if got is None else 1e3 * seconds(got) / len(got)


def setup_s(name: str):
    """Summed seconds of the set-up spans called ``name`` in this run."""
    got = named(name)
    return None if got is None else seconds(got)


def idle_intervals(trace) -> list:
    """[(start, end)] of the window where no device interval runs."""
    w0, w1 = trace.window
    out, prev = [], w0
    for s, e in trace.busy_intervals():
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        out.append((prev, w1))
    return out


def overlap_ns(a, b) -> int:
    """The time two sorted lists of disjoint intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
