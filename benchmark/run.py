"""The benchmark of phosphorus_mk2_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's traffic file (workloads/<cell>.json) names its entry
(entries/<entry>.py) and parameters, its configuration file
(configs/<config>.json) the scene. With --trace 0 the last line of standard
output is the cell's end-to-end metrics, with --trace 1 its per-layer
metrics (metrics/<metric>.py each), read from a torch.profiler window; both
carry ``correct`` from the comparison with the plain reference
(reference/), whose numbers and limits are also the last lines of standard
error. A run needs a CUDA device and refuses to run without one.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, device="cuda", overrides=None, config_overrides=None):
    """One run in this process: the result dict (the JSON line's keys, the
    compared numbers under "checked"). The overrides change the cell's and
    the configuration's parameters (the CPU tests' small sizes)."""
    import torch

    from harness import common, data

    cell = data.workload(args.workload)
    cell.update(overrides or {})
    cfg = data.config(cell["config"])
    cfg.update(config_overrides or {})
    ctx = {"cell": cell, "config": cfg, "seed": args.seed, "seconds": args.seconds,
           "trace": bool(args.trace), "t_start": T_START, "device": torch.device(device)}
    entry = importlib.import_module("entries." + cell["entry"])
    result = entry.run(ctx)
    if not args.trace:  # the end-to-end metrics this cell reports
        names = {m["name"] for m in data.metrics_of(args.workload, "end_to_end")}
        result["metrics"] = {k: v for k, v in result["metrics"].items() if k in names}
    else:
        names = [m["name"] for m in data.metrics_of(args.workload, "per_layer")]
        units = {m["name"]: m["unit"] for m in data.spec()["per_layer"]}
        values, matched = common.read_metrics(names, result.pop("reader_ctx"))
        result.setdefault("info", {}).update({f"matched {k}": v for k, v in matched.items()})
        trace = result.pop("trace")
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()}
        result["device"]["busy_s"] = trace.busy_s()
        result["device"]["window_s"] = trace.window_s()
        result["breakdown"] = trace.breakdown()
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from harness import common, data

    cell = data.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = execute(args)
    bad = common.forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark may not load: {bad}", file=sys.stderr)
        return 3
    from harness import peaks

    dev = torch.device("cuda")
    floor_ms, sync_ms = peaks.launch_floor(dev)
    print(f"device: {peaks.device_label(dev)}", file=sys.stderr)
    print(f"launch floor: {floor_ms:.6f} ms a launch, {sync_ms:.6f} ms a launch and sync",
          file=sys.stderr)
    print(f"memory peak: {result['device']['memory_peak_bytes']} B", file=sys.stderr)
    rows = result.pop("checked")
    for k, v in sorted(result.pop("info", {}).items()):
        print(f"{k}: {v}", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    order = ["correct", "attempted", "failed", "metrics", "device", "breakdown",
             "films_checked", "checks"]
    line = {k: result[k] for k in order if k in result}
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
