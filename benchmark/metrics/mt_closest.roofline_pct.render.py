"""mt_closest's share of its FP32 roofline: the sum over launches of rays x
live triangles x 46 operations (one Moller-Trumbore test) at 67 TFLOP/s,
over the device time of ``mt_closest_kernel`` and
``mt_closest_finish_kernel``. Its bytes (the rays, the table once, the
results) bound it far less, so operations decide."""

from harness.peaks import H100_FP32_OPS, MT_OPS_PER_TEST


def match(name: str) -> bool:
    return "mt_closest_kernel" in name or "mt_closest_finish_kernel" in name


def read(ctx):
    calls = ctx.get("mt_calls") or []
    spent = ctx["trace"].device_s(match)
    if not calls or spent <= 0.0:
        return None
    ops = sum(n * cols * MT_OPS_PER_TEST for n, cols in calls)
    return 100.0 * (ops / H100_FP32_OPS) / spent
