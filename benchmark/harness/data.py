"""The benchmark's data, found by name: BENCHMARK.json at the root of the
checkout, each configuration's file, each cell's traffic file, and the scene
arrays a configuration names."""
from __future__ import annotations

import importlib
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(name: str) -> dict:
    """The cell of BENCHMARK.json with its traffic file's parameters."""
    cells = {w["name"]: w for w in spec()["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    with open(os.path.join(BENCH, "workloads", name + ".json")) as f:
        traffic = json.load(f)
    return {**cells[name], **traffic}


def config(name: str) -> dict:
    entry = {c["name"]: c for c in spec()["configs"]}[name]
    with open(os.path.join(ROOT, entry["file"])) as f:
        return {**json.load(f), "name": name}


def scene_arrays(cfg: dict, width: int, height: int) -> dict:
    """{"meshes": [...], "camera": {...}} of the configuration's generator."""
    mod = importlib.import_module(f"scenes.{cfg['scene']}")
    return mod.build(width, height, cfg.get("scale", 1.0))


def metrics_of(cell: str, kind: str) -> list:
    """The BENCHMARK.json entries of one kind ("end_to_end" or "per_layer")
    that this cell reports."""
    out = []
    for m in spec()[kind]:
        if "workloads" not in m or cell in m["workloads"]:
            out.append(m)
    return out
