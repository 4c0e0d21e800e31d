"""Share of the traced steps' device busy time spent in PyTorch's index
backward kernels (the scatter of gathered rows' gradients), matched by
name: ``indexing_backward`` and ``index_put``."""

NAMES = ("indexing_backward", "index_put")


def match(name: str) -> bool:
    return any(k in name for k in NAMES)


def read(ctx):
    tr = ctx["trace"]
    busy = tr.busy_s()
    spent = tr.device_s(match)
    if busy <= 0.0 or spent <= 0.0:
        return None
    return 100.0 * spent / busy
