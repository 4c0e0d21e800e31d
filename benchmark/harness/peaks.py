"""The card's peaks and the arithmetic of a kernel's bound, kept with the
benchmark (copied from the port's chip_smoke.py and bench.py of this
revision), and the device's label and launch floor, printed beside every
run's numbers."""
from __future__ import annotations

import subprocess
import time

import torch

H100_FP32_OPS = 67e12    # FP32 operations/s outside the tensor cores (H100 SXM, at 700 W)
MT_OPS_PER_TEST = 46     # FP32 arithmetic of one Moller-Trumbore ray-triangle test


def device_label(device) -> str:
    """"<name>, <power limit>" as nvidia-smi gives them for a card."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def launch_floor(device, k: int = 256) -> tuple:
    """(ms a launch of k back-to-back one-element adds, synchronised before
    and after the k; ms of one add and its synchronise), best of 3."""
    x = torch.zeros(1, device=device)

    def best(fn, reps):
        out = []
        for _ in range(3):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
            out.append((time.perf_counter() - t0) / reps)
        return min(out)

    many = best(lambda: [x.add_(1.0) for _ in range(k)], 1) / k

    def one():
        x.add_(1.0)
        torch.cuda.synchronize(device)

    return many * 1e3, best(one, k) * 1e3
