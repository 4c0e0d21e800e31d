"""Profiling: the program's spans and counters, StageTimer, trace().

Counterpart of ``phosphorus_mk2_tpu/utils/profiling.py``. The reference
has almost none of this (SURVEY.md §5.1: a gettimeofday wall clock
around start/join, src/core.cpp:158-177, and a commented-out stats
thread). Designed in here:

* spans — named intervals of the program (set-up; a ``Renderer`` pass,
  its chunks and its film gather; a sample and its bounce stages; an
  optimizer step and its phases), kept in memory in one bounded store,
  ``RECORDER``, until someone reads it. A span holds its name, its start
  and end in ``time.time_ns()`` (the clock torch.profiler's kineto
  stamps its events with, so spans and a profiler trace share one
  timeline), the index of its parent span and the index of its root:
  the pass, the step or the set-up, so that every span of one pass
  shares it. Spans named ``setup.*`` are always kept; the others only
  while a torch.profiler session is active in the process (``tracing``).
  Otherwise ``span`` returns one shared no-op context, which reads no
  clock and allocates nothing. A span adds no device operation and no
  host sync;
* counters — plain module-level dicts of ints: this module's
  ``COUNTERS`` (``kernels.builds``: the CUDA/C++ libraries compiled in
  this process) and, by reference, the ``LAUNCHES`` / ``STATS`` dicts
  that the accel modules register with ``counted`` (and ``optim.SAVED``,
  filled through ``count_saved`` while tracing); ``RECORDER.read()``
  gathers them with the spans;
* StageTimer — named wall-clock stages, each a span of the same store
  kept whatever the tracing state, with device synchronization
  (``torch.cuda.synchronize`` of the devices the ``sync`` tensors live
  on, at the stage's close), so numbers mean device time, not dispatch
  time;
* trace() — context manager around ``torch.profiler`` that writes a
  Chrome trace into a profile directory when one is given, with the
  program's spans of the scope on the kernels' timeline.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time

import torch

SPAN_CAP = 1 << 20   # the newest spans the store keeps
SETUP = "setup."     # spans named so are kept whatever the tracing state
SPAN_TID = 0         # the Chrome trace's thread of the program's spans

COUNTERS = {"kernels.builds": 0}
_COUNTED = {"utils.profiling": COUNTERS}  # group -> its module's dict, by reference

_profiler_enabled = torch._C._autograd._profiler_enabled


def tracing() -> bool:
    """Whether a torch.profiler session is active in this process."""
    return _profiler_enabled()


def counted(group: str, table: dict) -> dict:
    """Register a module's counter dict (by reference, under ``group``)
    for ``RECORDER.read()``; returns the dict."""
    _COUNTED[group] = table
    return table


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


class Span:
    """One recorded interval: ``name``, ``start`` and ``end`` (ns of
    ``time.time_ns()``), ``index`` (spans are numbered as they open),
    ``parent`` (the index of the span open around it, -1 for none),
    ``root`` (the index of the outermost one) and ``args`` (a dict, for
    example a library's stem). ``sync``: tensors whose devices are
    synchronised before the span closes (StageTimer's stages only)."""

    __slots__ = ("name", "args", "start", "end", "index", "parent", "root", "sync")

    def __init__(self, name: str, args: dict | None = None, sync=None):
        self.name = name
        self.args = {} if args is None else args
        self.sync = sync
        self.start = self.end = 0
        self.index = self.parent = self.root = -1

    def __enter__(self):
        RECORDER.open(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            synchronize(self.sync)
            self.sync = None  # a kept span holds no tensor
        self.end = time.time_ns()
        RECORDER.close(self)
        return False


class Recorder:
    """The bounded store of closed spans (the newest ``cap``; ``dropped``
    counts the older ones let go) and, per thread, the stack of open
    ones that gives a new span its parent and root."""

    def __init__(self, cap: int = SPAN_CAP):
        self.spans = collections.deque(maxlen=cap)
        self.dropped = 0
        self._numbers = itertools.count()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, sp: Span) -> None:
        stack = self._stack()
        sp.index = next(self._numbers)
        if stack:
            sp.parent, sp.root = stack[-1].index, stack[-1].root
        else:
            sp.parent, sp.root = -1, sp.index
        stack.append(sp)

    def close(self, sp: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        else:
            stack.remove(sp)
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append(sp)

    def read(self) -> dict:
        """{"spans": the kept spans in the order they closed, "dropped": n,
        "counters": {group: its dict, by reference}}."""
        return {"spans": list(self.spans), "dropped": self.dropped,
                "counters": dict(_COUNTED)}

    def clear(self) -> None:
        self.spans.clear()
        self.dropped = 0


RECORDER = Recorder()


class _NoSpan:
    """The shared context of a span that is not kept."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, name: str) -> None:  # a stage of ``stages()``
        return None


NO_SPAN = _NoSpan()


def span(name: str, args: dict | None = None):
    """A context recording the span ``name`` (``args``: a dict kept with
    it) when it is kept: always for ``setup.*``, otherwise only while a
    torch.profiler session is active; else the shared no-op context."""
    if _profiler_enabled() or name.startswith(SETUP):
        return Span(name, args)
    return NO_SPAN


def _unpack(t):
    return t


def count_saved(table: dict):
    """While a torch.profiler session is active, a context whose
    ``saved_tensors_hooks`` add each tensor autograd saves to
    ``table["tensors"]`` and its bytes (elements x element size, as the
    saved view holds them) to ``table["bytes"]``, the scope itself counted
    in ``table["scopes"]``; otherwise the shared no-op context, which
    installs no hook. A hook reads shapes only: no device operation, no
    host sync. It keeps a detached alias of the tensor, so that a saved
    output holds no reference to its own graph."""
    if not _profiler_enabled():
        return NO_SPAN
    table["scopes"] += 1

    def pack(t):
        table["tensors"] += 1
        table["bytes"] += t.numel() * t.element_size()
        return t.detach()

    return torch.autograd.graph.saved_tensors_hooks(pack, _unpack)


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Stages:
    """Consecutive spans under one context: ``stage(name)`` closes the
    stage open (if any) and opens the next; the context's exit closes
    the last one, also on an exception."""

    __slots__ = ("open",)

    def __init__(self):
        self.open = None

    def __call__(self, name: str) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
        self.open = Span(name).__enter__()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.open is not None:
            self.open.__exit__(*exc)
            self.open = None
        return False


def stages():
    """A context whose calls open consecutive sibling spans (the stages
    of a bounce), kept only while a torch.profiler session is active:
    else the shared no-op context, whose calls do nothing."""
    return _Stages() if _profiler_enabled() else NO_SPAN


class StageTimer:
    """Accumulating named wall-clock timers with device sync: each stage
    is a span of ``RECORDER``, kept whatever the tracing state, that
    synchronises the devices of its ``sync`` tensors before it closes."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        sp = Span(name, sync=sync)
        try:
            with sp:
                yield
        finally:
            dt = (sp.end - sp.start) * 1e-9
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total:8.3f}s  ({n}x, {total / n * 1e3:.1f} ms/call)")
        return "\n".join(lines)


def _add_spans(path: str, spans) -> None:
    """Append ``spans`` to the Chrome trace at ``path`` as complete events
    of category ``program_span`` on a thread of their own, on the trace's
    timeline (its ``ts`` are microseconds after ``baseTimeNanoseconds``
    where the file gives it, else since the epoch)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID,
                   "args": {"name": "program spans"}})
    for s in spans:
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": SPAN_TID, "ts": (s.start - base) / 1e3,
                       "dur": (s.end - s.start) / 1e3,
                       "args": {"index": s.index, "parent": s.parent, "root": s.root,
                                **s.args}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(profile_dir: str | None):
    """torch.profiler scope over the CPU and, where torch sees a card, the
    CUDA activities; on exit the Chrome trace is written into
    ``profile_dir`` as ``trace_<pid>_<ns>.json``, holding the program's
    spans that opened and closed inside the scope (no-op when
    profile_dir is None)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        yield
        t1 = time.time_ns()
    path = os.path.join(profile_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in RECORDER.spans if t0 <= s.start and s.end <= t1])
