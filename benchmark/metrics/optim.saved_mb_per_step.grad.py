"""Megabytes (1e6 B) that autograd saved for the backward in a step's
forward: the program's ``optim.SAVED`` counter, its bytes over the forwards
it counted (one a step, those taken while a torch.profiler session was
active: the traced window's). None where the program keeps no such counter."""


def read(ctx):
    try:
        from phosphorus_mk2_tpu_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "RECORDER", None)
    saved = rec.read()["counters"].get("optim.SAVED") if rec is not None else None
    if not saved or not saved.get("scopes"):
        return None
    return saved["bytes"] / saved["scopes"] / 1e6
