"""What every entry shares: seeds, the device record, freeing the program's
state before the reference runs, the forbidden-module check and the
per-layer readers, each found by its metric's name under ``metrics/``."""
from __future__ import annotations

import gc
import importlib.util
import os
import sys
import time

import numpy as np
import torch

from .data import BENCH

FORBIDDEN = ("jax", "jaxlib", "flax", "phosphorus_mk2_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per purpose, from the run's seed."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), stream])


def now() -> float:
    return time.perf_counter()


def synced(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def device_record(device, count: int = 1) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reader(name: str):
    """The module ``metrics/<name>.py``: its ``read(ctx)`` and, for a reader
    of kernels by name, its ``match(kernel name)``."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(names: list, ctx: dict) -> tuple:
    """({name: value} of each per-layer reader that finds something to read,
    {name: [kernel names it matched]} of the readers that match by name)."""
    out, matched = {}, {}
    for name in names:
        mod = reader(name)
        value = mod.read(ctx)
        if value is not None:
            out[name] = float(value)
        if hasattr(mod, "match"):
            matched[name] = ctx["trace"].names(mod.match)
    return out, matched


def p95(values) -> float:
    """The 95th percentile, linear between closest ranks (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))
