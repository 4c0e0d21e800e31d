"""The cluster tracer's host syncs a trace in the traced passes: what its
``STATS`` counters (``syncs``, ``traces``) gained in the session's calls
made inside the traced window."""


def read(ctx):
    stats = ctx.get("tracer_stats")
    if not stats or not stats.get("traces"):
        return None
    return stats["syncs"] / stats["traces"]
