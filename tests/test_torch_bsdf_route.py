"""The lobe container's route (bsdf/bsdf.py): which calls take the CUDA
kernels of bsdf/kernel.py, which the weight-gradient route (kernel_grad)
and which the eager lobe code, how each is counted in ``bsdf.LAUNCHES``,
and the ``bsdf.kernel`` / ``bsdf.kernel_grad`` / ``bsdf.eager`` spans.
CPU tensors take the eager code; on the card, a call whose only input
that requires grad is the lobe weight takes kernel_grad (``bsdf_pdf``,
which reads no weight, the kernel), and a call whose directions,
uniforms or lobe parameters require grad the eager code. There is no
card here, so a test that needs a call to look like the card's hands
over a normal that says it is a CUDA tensor (``_card_typed``) and puts a
recorder (or a trap) in place of the kernel module's handles: a call
that reaches a trap is a wrong route."""
import pytest
import torch

from phosphorus_mk2_tpu_torch.bsdf import bsdf, kernel
from phosphorus_mk2_tpu_torch.core.material import LOBE_FLAGS
from phosphorus_mk2_tpu_torch.utils import profiling

ENTRIES = ("bsdf_f", "bsdf_pdf", "bsdf_sample")
# each call's inputs that may require grad
GRAD_INPUTS = [(e, x) for e in ENTRIES for x in
               ("n", "wi", "u2" if e == "bsdf_sample" else "wo", "weight", "param")]


def _case(seed=0, lanes=64, slots=2):
    g = torch.Generator().manual_seed(seed)
    types = torch.tensor(sorted(LOBE_FLAGS))[torch.randint(0, len(LOBE_FLAGS), (lanes, slots),
                                                           generator=g)]
    flags = torch.tensor([LOBE_FLAGS.get(k, 0) for k in range(max(LOBE_FLAGS) + 1)])[types]
    lobes = {"type": types, "flags": flags,
             "n": torch.randint(0, slots + 1, (lanes,), generator=g),
             "weight": torch.rand((lanes, slots, 3), generator=g),
             "param": torch.rand((lanes, slots, 6), generator=g) * 0.9 + 0.05,
             "present": tuple(sorted(LOBE_FLAGS)), "max_lobes": slots}

    def unit():
        x = torch.randn((lanes, 3), generator=g)
        return x / x.norm(dim=-1, keepdim=True)

    return lobes, {"n": unit(), "wi": unit(), "wo": unit(),
                   "u2": torch.rand((lanes, 2), generator=g)}


class _CardTyped(torch.Tensor):
    """A CPU tensor whose ``is_cuda`` reads True; what is computed from it
    is a plain tensor."""
    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True


def _card_typed(t):
    t["n"] = t["n"].as_subclass(_CardTyped)
    return t


def _call(entry, lobes, t):
    last = t["u2"] if entry == "bsdf_sample" else t["wo"]
    return getattr(bsdf, entry)(lobes, t["n"], t["wi"], last)


def _trap(monkeypatch):
    def trap(*args):
        raise AssertionError("the kernel route was taken")

    for entry in ENTRIES:
        monkeypatch.setattr(kernel, entry, trap)


def _plain_saving(monkeypatch):
    """The kernel_grad route's forward handles replaced by recorders that
    run their plain versions (a card-typed normal would take the kernel);
    returns the calls they saw."""
    seen = []

    def recorder(sample):
        def call(*args):
            seen.append(("bsdf_sample" if sample else "bsdf_f", args))
            return kernel.saving_plain(sample, *args)
        return call

    monkeypatch.setattr(kernel, "bsdf_f_saving", recorder(False))
    monkeypatch.setattr(kernel, "bsdf_sample_saving", recorder(True))
    return seen


def _counts(n0):
    return {k: bsdf.LAUNCHES[k] - n0[k] for k in n0}


def _routed(route):
    return {"bsdf_kernel": 0, "bsdf_kernel_grad": 0, "bsdf_eager": 0, f"bsdf_{route}": 1}


@pytest.mark.parametrize("entry", ENTRIES)
def test_cpu_calls_take_the_eager_code(monkeypatch, entry):
    _trap(monkeypatch)
    lobes, t = _case()
    n0 = dict(bsdf.LAUNCHES)
    _call(entry, lobes, t)
    with torch.no_grad():
        _call(entry, lobes, t)
    assert _counts(n0) == {"bsdf_kernel": 0, "bsdf_kernel_grad": 0, "bsdf_eager": 2}


@pytest.mark.parametrize("entry", ENTRIES)
def test_cpu_calls_with_a_weight_that_requires_grad_take_the_eager_code(monkeypatch, entry):
    _trap(monkeypatch)
    seen = _plain_saving(monkeypatch)
    lobes, t = _case(seed=7)
    lobes["weight"] = lobes["weight"].clone().requires_grad_()
    n0 = dict(bsdf.LAUNCHES)
    _call(entry, lobes, t)
    assert _counts(n0) == _routed("eager") and seen == []


@pytest.mark.parametrize("entry,grad_input", GRAD_INPUTS)
def test_inputs_that_require_grad_stay_eager_on_the_card(monkeypatch, entry, grad_input):
    """Directions, uniforms or lobe parameters that require grad: the eager
    code. The lobe weight alone: ``bsdf_f`` and ``bsdf_sample`` take
    kernel_grad, whose forward handle gets the call's own arguments once
    and whose value carries the weight's gradient; ``bsdf_pdf`` takes the
    kernel, and its pdf needs no grad."""
    _trap(monkeypatch)
    seen = _plain_saving(monkeypatch)
    lobes, t = _case(seed=1)
    if grad_input in ("weight", "param"):
        lobes[grad_input] = lobes[grad_input].clone().requires_grad_()
    else:
        t[grad_input] = t[grad_input].clone().requires_grad_()
    _card_typed(t)
    assert t["n"].is_cuda and {**lobes, **t}[grad_input].requires_grad
    pdfs = []
    if grad_input == "weight" and entry == "bsdf_pdf":
        monkeypatch.setattr(kernel, "bsdf_pdf", lambda *args: pdfs.append(args) or
                            bsdf._bsdf_pdf_eager(*args))
    n0 = dict(bsdf.LAUNCHES)
    out = _call(entry, lobes, t)
    if grad_input != "weight":
        assert _counts(n0) == _routed("eager") and seen == []
    elif entry == "bsdf_pdf":
        assert _counts(n0) == _routed("kernel") and len(pdfs) == 1 and seen == []
        assert not out.requires_grad
    else:
        assert _counts(n0) == _routed("kernel_grad")
        last = t["u2"] if entry == "bsdf_sample" else t["wo"]
        assert [(e, tuple(map(id, a[1:]))) for e, a in seen] == [
            (entry, (id(t["n"]), id(t["wi"]), id(last)))]
        f = out[0] if entry == "bsdf_sample" else out
        assert f.requires_grad
        f.sum().backward()
        assert lobes["weight"].grad is not None and lobes["weight"].grad.shape == (64, 2, 3)


@pytest.mark.parametrize("entry", ENTRIES)
def test_card_calls_without_autograd_take_the_kernel(monkeypatch, entry):
    """No input requires grad, or grad mode is off: the kernel's handle
    gets the call's own arguments, once."""
    seen = []
    monkeypatch.setattr(kernel, entry, lambda *args: seen.append(args) or "from the kernel")
    lobes, t = _case(seed=2)
    _card_typed(t)
    n0 = dict(bsdf.LAUNCHES)
    assert _call(entry, lobes, t) == "from the kernel"
    lobes["weight"] = lobes["weight"].clone().requires_grad_()
    with torch.no_grad():
        assert _call(entry, lobes, t) == "from the kernel"
    assert _counts(n0) == {"bsdf_kernel": 2, "bsdf_kernel_grad": 0, "bsdf_eager": 0}
    last = t["u2"] if entry == "bsdf_sample" else t["wo"]
    want = (id(lobes), id(t["n"]), id(t["wi"]), id(last))
    assert [tuple(map(id, a)) for a in seen] == [want] * 2


def _spans(names):
    return [s for s in profiling.RECORDER.read()["spans"] if s.name in names]


def test_spans_only_under_a_profiler_session(monkeypatch):
    lobes, t = _case(seed=3)
    names = ("bsdf.kernel", "bsdf.eager")
    profiling.RECORDER.clear()
    bsdf.bsdf_f(lobes, t["n"], t["wi"], t["wo"])
    assert _spans(names) == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        bsdf.bsdf_f(lobes, t["n"], t["wi"], t["wo"])
        monkeypatch.setattr(kernel, "bsdf_pdf", lambda *args: None)
        bsdf.bsdf_pdf(lobes, _card_typed(dict(t))["n"], t["wi"], t["wo"])
    got = _spans(names)
    assert [s.name for s in got] == ["bsdf.eager", "bsdf.kernel"]
    assert [s.parent for s in got] == [-1, -1]  # one span a call, nothing inside
    profiling.RECORDER.clear()


@pytest.mark.parametrize("entry", ("bsdf_f", "bsdf_sample"))
def test_kernel_grad_span_only_under_a_profiler_session(monkeypatch, entry):
    _plain_saving(monkeypatch)
    lobes, t = _case(seed=5)
    lobes["weight"] = lobes["weight"].clone().requires_grad_()
    _card_typed(t)
    names = ("bsdf.kernel", "bsdf.kernel_grad", "bsdf.eager")
    profiling.RECORDER.clear()
    _call(entry, lobes, t)
    assert _spans(names) == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _call(entry, lobes, t)
    got = _spans(names)
    assert [s.name for s in got] == ["bsdf.kernel_grad"] and got[0].parent == -1
    profiling.RECORDER.clear()


@pytest.mark.parametrize("weight_kind", ("leaf", "fresnel_weighted"))
def test_pdf_with_only_the_weight_requiring_grad_takes_the_kernel(monkeypatch, weight_kind):
    """bsdf_pdf reads no weight: under grad mode, a call whose only input
    that requires grad is the weight gets the plain kernel handle, counts
    as the kernel route, is spanned ``bsdf.kernel`` and gives a pdf without
    grad."""
    seen = []
    monkeypatch.setattr(kernel, "bsdf_pdf", lambda *args: seen.append(args) or
                        bsdf._bsdf_pdf_eager(*args))
    lobes, t = _case(seed=6)
    weight = lobes["weight"].clone().requires_grad_()
    lobes["weight"] = weight if weight_kind == "leaf" else weight * 0.5
    _card_typed(t)
    n0 = dict(bsdf.LAUNCHES)
    profiling.RECORDER.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pdf = bsdf.bsdf_pdf(lobes, t["n"], t["wi"], t["wo"])
    assert [s.name for s in _spans(("bsdf.kernel", "bsdf.kernel_grad", "bsdf.eager"))] == [
        "bsdf.kernel"]
    profiling.RECORDER.clear()
    assert _counts(n0) == _routed("kernel")
    assert [tuple(map(id, a)) for a in seen] == [(id(lobes), id(t["n"]), id(t["wi"]), id(t["wo"]))]
    assert not pdf.requires_grad and pdf.grad_fn is None


def test_launches_registered_with_the_recorder():
    counters = profiling.RECORDER.read()["counters"]
    assert counters["bsdf.LAUNCHES"] is bsdf.LAUNCHES
    assert counters["bsdf.kernel.LAUNCHES"] is kernel.LAUNCHES


@pytest.mark.parametrize("entry", ENTRIES)
def test_a_call_that_raises_is_not_counted(monkeypatch, entry):
    """A kernel call refused by its wrapper counts neither its route nor a
    launch."""
    def refuse(*args):
        raise ValueError("refused")

    monkeypatch.setattr(kernel, entry, refuse)
    lobes, t = _case(seed=4)
    _card_typed(t)
    n0, k0 = dict(bsdf.LAUNCHES), dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match="refused"):
        _call(entry, lobes, t)
    assert dict(bsdf.LAUNCHES) == n0 and dict(kernel.LAUNCHES) == k0
