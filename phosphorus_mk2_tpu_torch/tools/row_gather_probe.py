"""What does it cost a kernel to fetch R cluster rows by index?

Counterpart of ``tools/tpu_r4q_dma.py``: R = 4,096 rows of 9 x 128
float32 (4,608 bytes, one cluster's triangle rows) are copied out of a
(K = 10,987, 9, 128) table by an index vector inside one kernel
(accel/wave.py ``row_gather``), in two variants:
  direct: a warp loads its row and stores it;
  staged: NBUF bulk asynchronous copies in flight per warp through a
          ring of shared-memory slots.
The table and the indices are the TPU probe's (numpy ``default_rng(0)``).
Reported per variant as ms per launch, ns per row and GB/s of rows
fetched, with the checksum the TPU probe printed (the sum of the first
128 floats of every fetched row), twice: "warm", launch after launch on
the same indices, where the fetched rows and the output (38 MB) stay in
the card's L2 cache, as a trace's cluster rows do from wave to wave; and
"cold", each launch after a 256 MB write that empties the L2, where
every row comes from device memory. The fused wave kernels run the same
row fetch, so these are the rates their gather can reach.

    python -m phosphorus_mk2_tpu_torch.tools.row_gather_probe

Times are taken with CUDA events and exist only on a card: with
``--device cpu`` the rows and the checksum are computed and the times
are null.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from phosphorus_mk2_tpu_torch.accel import wave
from phosphorus_mk2_tpu_torch.device import resolve_device

K, W = 10987, 9 * 128  # the cluster-row table the TPU probe took its geometry from
R = 4096               # rows copied per launch


def inputs(device, k: int = K, r: int = R, seed: int = 0):
    """(idx (r,) int32, table (k, 9, 128) float32) on the device."""
    rng = np.random.default_rng(seed)
    table = rng.random((k, 1, W)).astype(np.float32).reshape(k, 9, 128)
    idx = rng.integers(0, k, size=(r,)).astype(np.int32)
    return torch.from_numpy(idx).to(device), torch.from_numpy(table).to(device)


SPIN_CYCLES = 4_000_000  # of torch.cuda._sleep: ~2 ms of the card spinning


def launch_ms(fn, reps: int = 20, warmup: int = 3, before=None) -> float:
    """ms per call of fn on the current CUDA device, by CUDA events, in
    device time: the card spins first, so that the host has queued the
    work before it starts (a launch costs the host longer than these
    kernels run). Without ``before`` the calls run back to back between
    one pair of events after ~2 ms of spinning. With ``before`` (a
    callable that puts back state fn updates in place, or empties the L2:
    ``l2_flush()``) it runs ahead of every call, outside that call's own
    pair of events, and the mean over the pairs is returned."""
    for _ in range(warmup):
        if before is not None:
            before()
        fn()
    if before is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    pairs = []
    for _ in range(reps):
        before()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES // 8)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def l2_flush():
    """A callable that empties the card's L2 cache: a 256 MB write (the
    cache holds 50 MB)."""
    return torch.empty(64 << 20, dtype=torch.float32, device="cuda").zero_


def per_row(ms: float, r: int = R) -> dict:
    """ns per row and GB/s of rows fetched at ms per launch of r rows."""
    return {"ns_per_row": ms * 1e6 / r, "eff_gbps": r * W * 4 / (ms * 1e-3) / 1e9}


def probe(variant: str, device="cuda", k: int = K, r: int = R, seed: int = 0, reps: int = 20):
    """One variant of the probe: the fetched rows' checksum and, on a
    card, ms per launch, ns per row and GB/s of rows fetched, warm (the
    keys as the TPU probe named them) and cold (under "cold")."""
    dev = resolve_device(device)
    idx, table = inputs(dev, k, r, seed)
    out = wave.row_gather(idx, table, variant)
    res = {"variant": variant, "rows": r, "row_bytes": W * 4,
           "checksum": float(out[:, 0, :].double().sum()),
           "ms": None, "ns_per_row": None, "eff_gbps": None, "cold": None}
    if dev.type == "cuda":
        def fn():
            return wave.row_gather(idx, table, variant)

        ms, cold = launch_ms(fn, reps), launch_ms(fn, reps, before=l2_flush())
        res.update(ms=ms, **per_row(ms, r), cold={"ms": cold, **per_row(cold, r)})
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for variant in wave.VARIANTS:
        print(json.dumps(probe(variant, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
