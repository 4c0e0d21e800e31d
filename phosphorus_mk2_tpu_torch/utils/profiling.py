"""Profiling and metrics.

Counterpart of ``phosphorus_mk2_tpu/utils/profiling.py``. The reference
has almost none of this (SURVEY.md §5.1: a gettimeofday wall clock
around start/join, src/core.cpp:158-177, and a commented-out stats
thread). Designed in here:

* StageTimer — named wall-clock stages with device synchronization
  (``torch.cuda.synchronize`` of the devices the ``sync`` tensors live
  on), so numbers mean device time, not dispatch time;
* RenderMeter — rays/sec accounting for the dense wavefront (every lane
  issues closest+shadow rays per bounce, so nominal rays = N*depth*2);
* trace() — context manager around ``torch.profiler`` that writes a
  Chrome trace into a profile directory when one is given.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def synchronize(sync) -> None:
    """Wait for the devices of every CUDA tensor in ``sync`` (a tensor,
    or a list, tuple or dict of them, nested); CPU tensors are done when
    their operation returns."""
    devices = set()

    def visit(x):
        if torch.is_tensor(x):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(sync)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulating named wall-clock timers with device sync."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total:8.3f}s  ({n}x, {total / n * 1e3:.1f} ms/call)")
        return "\n".join(lines)


class RenderMeter:
    """rays/sec accounting for dense wavefront renders."""

    def __init__(self, width: int, height: int, max_depth: int):
        self.per_sample_rays = width * height * max_depth * 2
        self.rays = 0
        self.seconds = 0.0

    def add_pass(self, n_samples: int, seconds: float) -> None:
        self.rays += self.per_sample_rays * n_samples
        self.seconds += seconds

    @property
    def rays_per_sec(self) -> float:
        return self.rays / self.seconds if self.seconds > 0 else 0.0


@contextlib.contextmanager
def trace(profile_dir: str | None):
    """torch.profiler scope over the CPU and, where torch sees a card, the
    CUDA activities; on exit the Chrome trace is written into
    ``profile_dir`` as ``trace_<pid>_<ns>.json`` (no-op when profile_dir
    is None)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )
