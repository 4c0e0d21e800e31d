"""A traced window: torch.profiler over whole passes or steps, reduced in
memory to device intervals, host spans and the numbers the per-layer
readers take. No trace file is written.

On a card only CUDA activity is recorded (kernels, copies and the CUDA
runtime's calls), not every host operator, so the traced window runs close
to the untraced speed; the window is bounded by the two device-wide
synchronisations that open and close it. Without a card (the CPU tests) the
host operators are recorded and the window is the ``bench.window`` span."""
from __future__ import annotations

import bisect
import contextlib

import torch

WINDOW = "bench.window"
SYNC = "cudaDeviceSynchronize"


def _ns(ev, what):
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, what + "_us")() * 1000)


def _is_device(ev) -> bool:
    return str(ev.device_type()).split(".")[-1].upper() == "CUDA"


class Trace:
    """Device events (name, start ns, end ns) and host spans of one window."""

    def __init__(self):
        self.device = []
        self.host = []
        self.window = None
        self.prof = None

    @contextlib.contextmanager
    def record(self):
        card = torch.cuda.is_available()
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[act.CUDA] if card else [act.CPU])
        self.prof.start()
        try:
            if card:
                torch.cuda.synchronize()
            with torch.profiler.record_function(WINDOW):
                yield self
            if card:
                torch.cuda.synchronize()
        finally:
            self.prof.stop()
            self._reduce()

    def _reduce(self):
        syncs = []
        for ev in self.prof.profiler.kineto_results.events():
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            name = ev.name()
            if getattr(ev, "is_user_annotation", lambda: False)() or name == WINDOW:
                if name == WINDOW and not _is_device(ev):
                    self.window = (start, end)
                continue  # annotations are spans, not device work
            if _is_device(ev):
                self.device.append((name, start, end))
            else:
                if name == SYNC:
                    syncs.append(end)
                self.host.append((name, start, end))
        self.prof = None
        self.device.sort(key=lambda e: e[1])
        if len(syncs) >= 2:  # the synchronisations that open and close the window
            self.window = (min(syncs), max(syncs))
        if self.window is None:
            raise RuntimeError("the profiler recorded no window")

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self):
        """The union of device intervals inside the window, merged."""
        w0, w1 = self.window
        out = []
        for _, s, e in self.device:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_count(self) -> int:
        w0, w1 = self.window
        return sum(1 for _, s, _ in self.device if w0 <= s < w1)

    def device_s(self, match) -> float:
        """Summed device seconds of events whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) * 1e-9

    def names(self, match) -> list:
        return sorted({n for n, _, _ in self.device if match(n)})

    def breakdown(self, top: int = 10) -> dict:
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0) + (e - s)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v * 1e-9] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in self.idle_gaps(top)]}

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time in the window, summed by the innermost host span
        running at each gap's middle (on a card, the CUDA runtime call in
        flight; "host" where the host runs Python and operators)."""
        w0, w1 = self.window
        gaps, prev = [], w0
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if w1 > prev:
            gaps.append((prev, w1))
        gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
        host = sorted((h for h in self.host if h[0] != WINDOW), key=lambda h: h[1])
        starts = [h[1] for h in host]

        by = {}
        for g0, g1 in gaps[:2000]:
            mid = (g0 + g1) // 2
            name = "host"
            i = bisect.bisect_right(starts, mid)
            best = None
            for j in range(i - 1, max(-1, i - 400), -1):
                n, s, e = host[j]
                if s <= mid < e and (best is None or s > best[1]):
                    best = (n, s)
                    break
            if best is not None:
                name = best[0]
            by[name] = by.get(name, 0.0) + (g1 - g0) * 1e-9
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]
