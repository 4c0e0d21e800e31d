"""wave_mt's share of its memory roofline: the least bytes its launches in
the traced passes move, from the program's ``accel.wave.WORK`` counters,
at 3.35 TB/s, over the device time of ``wave_mt_kernel``. A launch moves
at least 28 B a live (ray, column) pair (the ray's origin and direction
and the column's cluster id), 8 B a ray (its tnear and best t at the
gate), 12 B a winner (t, cluster and lane written) and each distinct
cluster row once (9 x 128 values: 4,608 B in float32, 2,304 B in bf16).
Its arithmetic (46 operations a test, 128 tests a pair) bounds it less
than the latency of the sparse waves."""

H100_HBM_BYTES = 3.35e12  # bytes/s of one H100 SXM's HBM3 (NVIDIA's data sheet, 700 W)
PAIR_BYTES, RAY_BYTES, WINNER_BYTES = 28, 8, 12
ROW_BYTES = {"float32": 9 * 128 * 4, "bf16": 9 * 128 * 2}


def wave_mt_bytes(key: str, pairs: int, rays: int, winners: int, rows: int) -> int:
    """The least bytes of the launches counted under LAUNCHES key ``key``."""
    row = ROW_BYTES["bf16" if "bf16" in key else "float32"]
    return PAIR_BYTES * pairs + RAY_BYTES * rays + WINNER_BYTES * winners + row * rows


def match(name: str) -> bool:
    return "wave_mt_kernel" in name


def read(ctx):
    work = ctx.get("wave_work")
    spent = ctx["trace"].device_s(match)
    if not work or spent <= 0.0:
        return None
    moved = sum(wave_mt_bytes(key[0], *fields) for key, fields in work.items()
                if key[0].startswith("wave_mt"))
    return 100.0 * (moved / H100_HBM_BYTES) / spent
