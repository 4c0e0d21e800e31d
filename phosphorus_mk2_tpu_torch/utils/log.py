"""Structured logging + render metrics.

A copy of ``phosphorus_mk2_tpu/utils/log.py``. The reference has no
logging system — `std::cout`/`cerr` prints scattered through import/boot
paths and a literal "TODO: do proper logging" (reference
src/codecs/scene/alembic.hpp:38; SURVEY.md §5.5). This is the
designed-in replacement:

* leveled, timestamped loggers (`get_logger`), level set per-process via
  the ``PHOSPHORUS_LOG`` env var or ``set_level()``;
* ``Metrics`` — named counters/gauges for a render or training run that
  emit ONE machine-parseable JSON line (the same contract as the bench),
  so fleet tooling can scrape rays/s, pass counts and wall-clock without
  parsing prose.
"""
from __future__ import annotations

import json
import os
import sys
import time

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}
_level = LEVELS.get(os.environ.get("PHOSPHORUS_LOG", "info").lower(), 20)
_t0 = time.time()


def set_level(name: str) -> None:
    global _level
    _level = LEVELS[name.lower()]


class Logger:
    """Leveled stderr logger: `[  12.3s] level name: message`."""

    def __init__(self, name: str):
        self.name = name

    def _emit(self, level: str, msg: str) -> None:
        if LEVELS[level] < _level:
            return
        print(
            f"[{time.time() - _t0:7.1f}s] {level:5s} {self.name}: {msg}",
            file=sys.stderr,
            flush=True,
        )

    def debug(self, msg: str) -> None:
        self._emit("debug", msg)

    def info(self, msg: str) -> None:
        self._emit("info", msg)

    def warn(self, msg: str) -> None:
        self._emit("warn", msg)

    def error(self, msg: str) -> None:
        self._emit("error", msg)


_loggers: dict[str, Logger] = {}


def get_logger(name: str) -> Logger:
    if name not in _loggers:
        _loggers[name] = Logger(name)
    return _loggers[name]


class Metrics:
    """Named counters/gauges with a single-JSON-line emitter.

    counters accumulate (`inc`), gauges overwrite (`set`); `lap(name)`
    records wall-clock since construction or the previous lap under a
    gauge. `emit()` prints `{"event": ..., **values}` as one line on
    stdout and returns the dict.
    """

    def __init__(self, event: str):
        self.event = event
        self.values: dict = {}
        self._t0 = time.time()
        self._last = self._t0

    def inc(self, name: str, by=1):
        self.values[name] = self.values.get(name, 0) + by
        return self

    def set(self, name: str, value):
        self.values[name] = value
        return self

    def lap(self, name: str):
        now = time.time()
        self.values[name] = round(now - self._last, 4)
        self._last = now
        return self

    def elapsed(self) -> float:
        return time.time() - self._t0

    def emit(self, out=None) -> dict:
        rec = {"event": self.event, "wall_s": round(self.elapsed(), 4)}
        rec.update(self.values)
        print(json.dumps(rec), file=out or sys.stdout, flush=True)
        return rec
