"""The port's utils/profiling.py against the JAX package's on the same
calls: StageTimer's stages, counts and report, and trace() writing a
Chrome trace on the CPU (tests/test_torch_spans.py holds the spans).

Tolerances: StageTimer's totals are wall-clock times of two different
runs: only their order and the report's format are compared.
"""
import json
import os
import re

import jax.numpy as jnp
import pytest
import torch

from phosphorus_mk2_tpu.utils import profiling as jprof
from phosphorus_mk2_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

LINE = re.compile(r"^(\S+)\s+\d+\.\d{3}s  \((\d+)x, \d+\.\d ms/call\)$")


def _drive(mod, sync):
    t = mod.StageTimer()
    for _ in range(2):
        with t.stage("render", sync=sync):
            sum(range(20000))
    with t.stage("write"):
        pass
    return t


def test_stage_timer_matches_jax():
    jt = _drive(jprof, jnp.ones(4))
    tt = _drive(tprof, torch.ones(4))
    assert tt.counts == jt.counts == {"render": 2, "write": 1}
    assert set(tt.totals) == set(jt.totals)
    jl, tl = jt.report().splitlines(), tt.report().splitlines()
    assert len(jl) == len(tl) == 2
    for a, b in zip(jl, tl):
        ma, mb = LINE.match(a), LINE.match(b)
        assert ma and mb, (a, b)
        assert ma.groups() == mb.groups()


def test_stage_timer_sync_accepts_nested_tensors():
    t = tprof.StageTimer()
    with t.stage("x", sync={"a": [torch.ones(2), (torch.zeros(1),)], "b": 3}):
        pass
    assert t.counts == {"x": 1}


def test_stage_timer_counts_a_raising_stage():
    t = tprof.StageTimer()
    with pytest.raises(ValueError):
        with t.stage("bad", sync=torch.ones(1)):
            raise ValueError
    assert t.counts == {"bad": 1}


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    d = tmp_path / "prof"
    with tprof.trace(str(d)):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = list(d.glob("*.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)


def test_trace_without_a_directory_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with tprof.trace(None):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []
