"""BASELINE config 5 on the multi_bsdf scene, on the CPU: the port's
``InverseRenderer`` (the cluster tracer, six lobe types under autograd)
against the benchmark's plain reference (benchmark/reference_lobes/
inverse.py) at 40x32, 2 spp, depth 3, two steps from a seeded start; and
the ``optim.SAVED`` counter, which counts only while a profiler session is
active and changes no step."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from entries import inverse_lobes  # noqa: E402
from entries.inverse import steps_from  # noqa: E402
from harness import check, data  # noqa: E402

from phosphorus_mk2_tpu_torch import optim  # noqa: E402
from phosphorus_mk2_tpu_torch.utils import profiling  # noqa: E402

CELL = "multi_bsdf.inverse"
SEED = 2 ** 31 + 11
STEPS = 2
FIELDS = ("emission", "lobe_weight")


def _ctx(width=40, height=32, spp=2):
    cell = data.workload(CELL)
    cell.update(width=width, height=height, spp=spp,
                check={**cell["check"], "block": width * height // 2})
    return {"cell": cell, "config": data.config(cell["config"]), "seed": SEED,
            "device": torch.device("cpu")}


def _session(ctx):
    lobes, materials = inverse_lobes._lobes_used(ctx["config"])
    target, factors = inverse_lobes.inputs(ctx, lobes, materials)
    inv, _ = inverse_lobes.session(ctx, target, factors)
    return inv, target, factors, lobes, materials


@pytest.fixture(scope="module")
def steps():
    """(the port's answers, the reference's) of two steps from the seeded
    start: losses, the first gradient, the change after both."""
    ctx = _ctx()
    inv, target, factors, lobes, materials = _session(ctx)
    _, prog = steps_from(inv, STEPS, lobes, materials, grad=True)
    ref = inverse_lobes.reference(ctx)
    want, _, _ = inverse_lobes.reference_steps(ctx, ref, target,
                                               inverse_lobes.seeded_start(ref, factors), 0, STEPS)
    return prog, want


def test_the_losses_are_the_references(steps):
    # the same float32 arithmetic on both sides; they part where ATen's
    # vectorised and scalar loops round a transcendental apart and in the
    # order of the float32 pixel sums (seen: 5e-8 relative)
    prog, want = steps
    np.testing.assert_allclose(prog["losses"], want["losses"], rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("field", FIELDS)
def test_the_first_gradient_is_the_references(steps, field):
    # Adam's first moment over (1 - beta1) against the reference's float64
    # sums: float32 forward values as above, the port's row sums in float64
    # (rows_backward) or float32 (index backward) (seen: 3.2e-7 of the
    # entry, 1.8e-7 of the field's largest)
    prog, want = steps
    g, gr = prog["grad"][field], want["grad"][field]
    assert np.abs(gr).max() > 0.0
    np.testing.assert_allclose(g, gr, rtol=2e-6, atol=1e-6 * np.abs(gr).max())


@pytest.mark.parametrize("field", FIELDS)
def test_the_change_is_the_references(steps, field):
    # two Adam steps of about lr = 0.05 each: the port's Adam runs in
    # float32, the reference's in float64 with float32 parameters after
    # each update (seen: 6e-8)
    prog, want = steps
    c, cr = prog["change"][field], want["change"][field]
    assert np.abs(cr).max() > 0.05
    np.testing.assert_allclose(c, cr, rtol=0.0, atol=1e-6)


def test_the_cells_numbers_lie_far_under_its_limits(steps):
    prog, want = steps
    numbers = check.step_numbers(prog, want)
    limits = data.workload(CELL)["check"]["limits"]
    for k, v in numbers.items():
        assert v <= limits[k] / 10.0, (k, v, limits[k])


def test_the_step_takes_the_cluster_tracer():
    from phosphorus_mk2_tpu_torch.accel import cluster_traverse

    inv, *_ = _session(_ctx(width=8, height=8, spp=1))
    assert inv.data.num_tris == 4812 and inv.data.bvh is not None
    traces = cluster_traverse.STATS["traces"]
    inv.step()
    assert cluster_traverse.STATS["traces"] > traces


@pytest.mark.parametrize("field", FIELDS)
def test_counting_what_autograd_saves_changes_no_step(field):
    # the hooks hand autograd a detached alias of each tensor: the same
    # values, so a step taken while profiling is the step taken without
    plain, *_ = _session(_ctx(width=16, height=16, spp=1))
    counted, *_ = _session(_ctx(width=16, height=16, spp=1))
    loss = plain.step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        loss_counted = counted.step()
    assert loss_counted == loss
    assert torch.equal(counted.params[field], plain.params[field])
    assert torch.equal(counted.opt.state[counted.params[field]]["exp_avg"],
                       plain.opt.state[plain.params[field]]["exp_avg"])


def test_saved_counts_only_while_profiling():
    inv, *_ = _session(_ctx(width=16, height=16, spp=1))
    before = dict(optim.SAVED)
    inv.step()
    assert optim.SAVED == before  # no hook, nothing counted
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        inv.step()
    gained = {k: optim.SAVED[k] - before[k] for k in before}
    assert gained["scopes"] == 1 and gained["tensors"] > 0
    assert gained["bytes"] >= 4 * 16 * 16 * gained["tensors"] // 100
    assert profiling.RECORDER.read()["counters"]["optim.SAVED"] is optim.SAVED
    after = dict(optim.SAVED)
    inv.step()
    assert optim.SAVED == after


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = {[BENCH, ROOT]!r}; import reference_lobes.inverse; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    mods = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "phosphorus_mk2_tpu", "phosphorus_mk2_tpu_torch"}


def test_the_reference_runs_with_tf32_off():
    from reference_lobes import inverse

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        inverse.run(None, None, None, None, None, None, {}, [], spp=1, max_depth=1, lr=0.05,
                    block=1)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
