"""Render and differentiate with the pixels sharded over ranks, and
write what each rank holds, so that it can be held against one process.

    python -m phosphorus_mk2_tpu_torch.tools.rank_parity JOB.json OUT_DIR \\
        [--ranks 2] [--backend gloo] [--timeout 600]

JOB.json: {"device": "cpu" or "cuda:k" (every rank on that device),
"renders": [{"scene": a builder of ``scenes`` (e.g. "cornell_box"),
"scene_kw": its keyword arguments, "options": Options fields}, ...],
"grad": {"scene", "scene_kw", "fields": [...], "spp", "depth", "seed"}
or null}.

``spawn`` starts the ranks (one process each, a ``file://`` store in
OUT_DIR, a timeout on the group and on the wait): each rank initialises
the group through ``parallel.initialize``, renders each scene through
``Renderer(mesh=make_wave_mesh(ranks, device))`` (``render``: the film
all-gathered, so that every rank holds all of it) and takes the gradient
of color.sum() over its own pixels, all-reduced across ranks (``grad``);
rank r writes ``rank{r}.npz``. With ``--ranks 1`` and no backend no
group is made: the one-process reference, which ``render`` and ``grad``
also give in the calling process. A rank that fails or outlives the
timeout fails the whole run: the others are killed and ``spawn`` raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def _failures(procs, out: Path) -> list:
    return [f"rank {r} exited {p.returncode}: {(out / f'rank{r}.log').read_text()[-2000:]}"
            for r, p in enumerate(procs) if p.poll() not in (None, 0)]


def spawn(job: dict, out_dir, ranks: int = 2, backend: str | None = "gloo",
          timeout: float = 600.0, env: dict | None = None) -> list:
    """Run ``job`` on ``ranks`` processes; returns each rank's npz as a
    dict of arrays. Raises RuntimeError if a rank fails or times out."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "job.json").write_text(json.dumps(job))
    store = out / "store"
    if store.exists():
        store.unlink()
    procs, logs = [], []
    for r in range(ranks):
        cmd = [sys.executable, "-m", "phosphorus_mk2_tpu_torch.tools.rank_parity", "--worker",
               str(out / "job.json"), str(out), "--ranks", str(ranks), "--rank", str(r),
               "--timeout", str(timeout)]
        if backend:
            cmd += ["--backend", backend]
        logs.append(open(out / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env={**os.environ, **(env or {})},
                                      stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = []
    try:
        while not failed and any(p.poll() is None for p in procs):
            # a rank that failed leaves the others waiting in a collective:
            # stop at the first failure, not at the timeout
            failed = _failures(procs, out)
            if not failed and time.monotonic() > deadline:
                failed = [f"the ranks outlived {timeout} s"]
            time.sleep(0.05)
        failed = failed or _failures(procs, out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if failed:
        raise RuntimeError("; ".join(failed))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(ranks)]


def _scene(spec):
    from phosphorus_mk2_tpu_torch import scenes

    return getattr(scenes, spec["scene"])(**spec.get("scene_kw", {}))


def render(spec: dict, mesh) -> dict:
    """The film of one entry of the job's "renders" on ``mesh``."""
    import phosphorus_mk2_tpu_torch as pt

    return pt.Renderer(_scene(spec), pt.Options(**spec["options"]), mesh=mesh).render()


def grad(spec: dict, mesh) -> dict:
    """d color.sum() / d field for the job's "grad" on ``mesh`` (brute
    tracer), all-reduced across ranks: host arrays by field."""
    from phosphorus_mk2_tpu_torch.parallel import make_sharded_render
    from phosphorus_mk2_tpu_torch.parallel.distributed import all_reduce_grads, rank_and_world

    scene = _scene(spec)
    data = scene.build(mesh.devices[0])
    leaves = {f: getattr(data, f).detach().clone().requires_grad_() for f in spec["fields"]}
    fn, _, _, _ = make_sharded_render(mesh, data, scene.camera, max_depth=spec["depth"],
                                      use_bvh=False, trainable=tuple(spec["fields"]))
    outs = fn(dataclasses.replace(data, **leaves), spec.get("seed", 0), 0, spec["spp"])
    loss = outs[0]["color"].sum()
    for o in outs[1:]:
        loss = loss + o["color"].sum().to(loss.device)
    loss.backward()
    if rank_and_world()[1] > 1:
        all_reduce_grads(list(leaves.values()))
    return {f: p.grad.cpu().numpy() for f, p in leaves.items()}


def _worker(job: dict, out: Path, ranks: int, rank: int, backend, timeout: float) -> None:
    from phosphorus_mk2_tpu_torch.parallel import initialize, make_wave_mesh

    if backend:
        got = initialize(f"file://{out / 'store'}", ranks, rank, backend=backend,
                         timeout=timeout)
        assert got == (rank, ranks), got
    mesh = make_wave_mesh(ranks, job["device"])
    res = {}
    for i, spec in enumerate(job.get("renders", [])):
        res.update({f"film{i}_{k}": v for k, v in render(spec, mesh).items()})
    if job.get("grad"):
        res.update({f"grad_{f}": g for f, g in grad(job["grad"], mesh).items()})
    if backend == "nccl":  # the collectives on the card, checked directly
        from phosphorus_mk2_tpu_torch.parallel.distributed import all_gather_rows, all_reduce_sum

        x = torch.arange(8, dtype=torch.float32, device=mesh.devices[0]) + rank
        res["nccl_sum"] = all_reduce_sum(x).cpu().numpy()
        res["nccl_gather"] = all_gather_rows(x).cpu().numpy()
    np.savez(out / f"rank{rank}.npz", **res)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("job")
    ap.add_argument("out")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    job = json.loads(Path(args.job).read_text())
    if args.worker:
        _worker(job, Path(args.out), args.ranks, args.rank, args.backend, args.timeout)
        return 0
    res = spawn(job, args.out, args.ranks, args.backend, args.timeout)
    print(json.dumps({f"rank{r}": sorted(v) for r, v in enumerate(res)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
