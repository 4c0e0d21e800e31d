"""Device ms of the cluster tracer's kernels (``wave_mt``, ``wave_sweep``,
``front_*``) in the traced passes, over the traces the tracer's ``STATS``
counted there."""


def match(name: str) -> bool:
    return "wave_mt_kernel" in name or "wave_sweep" in name or "front_kernel" in name


def read(ctx):
    stats = ctx.get("tracer_stats")
    if not stats or not stats.get("traces"):
        return None
    return 1e3 * ctx["trace"].device_s(match) / stats["traces"]
