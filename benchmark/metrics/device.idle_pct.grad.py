"""The device's idle share of an optimizer step: 1 minus the traced steps'
device busy time (the union of device intervals) a step over the mean wall
time of as many steps taken untraced just before them, since tracing slows
the host's launches and so the traced steps' wall time."""


def read(ctx):
    untraced = ctx.get("untraced_step_s") or []
    if not ctx.get("steps") or not untraced:
        return None
    busy = ctx["trace"].busy_s() / ctx["steps"]
    return 100.0 * (1.0 - busy / (sum(untraced) / len(untraced)))
