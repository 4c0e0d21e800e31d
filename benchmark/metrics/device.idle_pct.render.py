"""The device's idle share of a pass: 1 minus the traced passes' device
busy time (the union of device intervals) a pass over the mean wall time of
as many passes run untraced just before them, since tracing slows the
host's launches and so the traced passes' wall time."""


def read(ctx):
    untraced = ctx.get("untraced_pass_s") or []
    if not ctx.get("passes") or not untraced:
        return None
    busy = ctx["trace"].busy_s() / ctx["passes"]
    return 100.0 * (1.0 - busy / (sum(untraced) / len(untraced)))
