"""The lobe container's kernels (bsdf/kernel.py, csrc/bsdf.cu) on a CUDA
card against the eager lobe code, lane by lane: ``bsdf_f``, ``bsdf_pdf``
and ``bsdf_sample`` bit-equal to the eager dense dispatch, for each lobe
type alone and all mixed, at 1, 2 and 8 slots, on edge lanes (grazing
and back-facing directions, a degenerate frame, the eta = 1
passthrough, total internal reflection, no lobes, a pdf of 0) and on
strided views; bit-equal twice; one count a call. Under autograd, a call
whose only input that requires grad is the lobe weight (the kernel_grad
route): its values and the weight's gradient bit-equal to eager
autograd's (signed zeros included), its saved values to the plain
version's, and a whole ``InverseRenderer`` step bit-equal to the same
step on the eager code. Two NaNs count as equal whatever their payloads.
Needs a card: the ``card`` fixture skips without one (``python -m pytest
tests/test_torch_bsdf_kernel_card.py`` on the card's machine). No JAX
here: the eager code is the reference."""
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu_torch.bsdf import bsdf, kernel
from phosphorus_mk2_tpu_torch.core.material import LOBE_FLAGS

TYPES = tuple(sorted(LOBE_FLAGS))  # the eight lobe types
LANES = 8192  # lanes a case


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _unit(x):
    return x / x.norm(dim=-1, keepdim=True)


def _case(seed, lanes, slots, types, dev, present=None):
    """Seeded lobes and directions, with edge lanes at the front."""
    g = torch.Generator().manual_seed(seed)
    pick = torch.randint(0, len(types), (lanes, slots), generator=g)
    t = torch.tensor(types)[pick]
    flags = torch.tensor([LOBE_FLAGS.get(k, 0) for k in range(max(TYPES) + 1)])[t]
    n_lobes = torch.randint(0, slots + 1, (lanes,), generator=g)
    param = torch.rand((lanes, slots, 6), generator=g) * 0.9 + 0.05
    param[..., 2] = 1.0 + torch.rand((lanes, slots), generator=g)
    param[::7, :, 2] = 1.0                  # the refractive GGX passthrough
    param[3::11, :, 2] = 0.5                # eta < 1 for the refractions
    weight = torch.rand((lanes, slots, 3), generator=g)
    n = _unit(torch.randn((lanes, 3), generator=g))
    wi = _unit(torch.randn((lanes, 3), generator=g))
    wo = _unit(torch.randn((lanes, 3), generator=g))
    u2 = torch.rand((lanes, 2), generator=g)
    if lanes >= 16:  # edge lanes
        n[0:6] = torch.tensor([0.0, 1.0, 0.0])
        wi[0] = torch.tensor([1.0, 0.0, 0.0])           # grazing wi
        wo[1] = torch.tensor([0.0, 0.0, 1.0])           # grazing wo
        wi[2] = torch.tensor([0.0, -1.0, 0.0])          # wi back-facing, along -n
        wo[3], wi[3] = torch.tensor([0.0, -1.0, 0.0]), torch.tensor([0.0, 1.0, 0.0])
        wi[4] = _unit(torch.tensor([1.0, 0.02, 0.0]))   # near grazing: total internal reflection
        param[4, :, 2] = 2.0
        wi[5] = _unit(torch.tensor([1.0, -0.02, 0.0]))
        param[5, :, 2] = 2.0
        n[6] = _unit(torch.tensor([1.0, 1.0, 1.0]))     # the frame's fallback (nx == ny == nz)
        n_lobes[7] = 0                                  # no lobes
        u2[8] = torch.tensor([0.0, 0.0])
        u2[9] = torch.tensor([1.0 - 2.0 ** -24, 0.5])
        u2[10] = torch.tensor([0.5, 1.0 - 2.0 ** -24])
        wi[11] = n[11]                                  # along n: GGX's near-normal branch
    lobes = {"type": t, "flags": flags, "n": n_lobes, "weight": weight, "param": param,
             "present": tuple(present if present is not None else sorted(set(types))),
             "max_lobes": slots}
    on = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in lobes.items()}
    return on, n.to(dev), wi.to(dev), wo.to(dev), u2.to(dev)


def _strided(lobes, n, wi, wo, u2):
    """The same values as column blocks of wider tensors."""
    def block(x, extra=3):
        wide = torch.full(x.shape[:-1] + (x.shape[-1] + 2 * extra,), float("nan")
                          if x.is_floating_point() else -7, dtype=x.dtype, device=x.device)
        wide[..., extra:extra + x.shape[-1]] = x
        return wide[..., extra:extra + x.shape[-1]]

    out = dict(lobes)
    for k in ("type", "flags"):
        out[k] = block(lobes[k])
    out["weight"] = block(lobes["weight"])
    out["param"] = block(lobes["param"])
    out["n"] = block(lobes["n"][:, None])[:, 0]
    return out, block(n), block(wi), block(wo), block(u2)


def _diff(a, b):
    """Lanes where a and b differ in their bits (two NaNs agree)."""
    if a.is_floating_point():
        same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
    else:
        same = a == b
    same = same.reshape(same.shape[0], -1).all(dim=1)
    return (~same).nonzero().flatten().tolist()


def _assert_same(got, want, what, lobes):
    for name, a, b in zip(("f", "wo", "pdf", "flags"), got, want):
        bad = _diff(a, b)
        if bad:
            i = bad[0]
            types = lobes["type"][i].tolist()
            raise AssertionError(
                f"{what}: {name} differs on {len(bad)} of {a.shape[0]} lanes; lane {i} "
                f"(types {types}, n_lobes {int(lobes['n'][i])}): kernel {a[i].tolist()} "
                f"eager {b[i].tolist()}")


def _eager(entry, lobes, args):
    fn = {"bsdf_f": bsdf._bsdf_f_eager, "bsdf_pdf": bsdf._bsdf_pdf_eager,
          "bsdf_sample": bsdf._bsdf_sample_eager}[entry]
    out = fn(lobes, *args)
    return out if isinstance(out, tuple) else (out,)


def _kernel(entry, lobes, args):
    out = getattr(kernel, entry)(lobes, *args)
    return out if isinstance(out, tuple) else (out,)


def _check_all(lobes, n, wi, wo, u2, what):
    for entry in ("bsdf_f", "bsdf_pdf", "bsdf_sample"):
        args = (n, wi, u2) if entry == "bsdf_sample" else (n, wi, wo)
        _assert_same(_kernel(entry, lobes, args), _eager(entry, lobes, args),
                     f"{what} {entry}", lobes)


@pytest.mark.card
@pytest.mark.parametrize("slots", [1, 2, 8])
@pytest.mark.parametrize("lobe_type", TYPES)
def test_each_type_alone(card, lobe_type, slots):
    case = _case(100 * lobe_type + slots, LANES, slots, (lobe_type,), card)
    _check_all(*case, f"type {lobe_type} x {slots} slots")


@pytest.mark.card
@pytest.mark.parametrize("slots", [1, 2, 3, 5, 8])
def test_all_types_mixed(card, slots):
    case = _case(7 + slots, LANES, slots, TYPES, card)
    _check_all(*case, f"mixed x {slots} slots")


@pytest.mark.card
def test_absent_types_evaluate_to_zero(card):
    """Lanes whose type the scene does not list as present read zeros,
    as in the eager dispatch."""
    case = _case(31, LANES, 2, TYPES, card, present=(1, 3, 5, 6))
    _check_all(*case, "present (1, 3, 5, 6)")


@pytest.mark.card
@pytest.mark.parametrize("slots", [1, 2, 8])
def test_strided_views(card, slots):
    lobes, n, wi, wo, u2 = _strided(*_case(41 + slots, LANES, slots, TYPES, card))
    assert not lobes["type"].is_contiguous() and not lobes["weight"].is_contiguous()
    assert not n.is_contiguous() and not u2.is_contiguous()
    _check_all(lobes, n, wi, wo, u2, f"strided x {slots} slots")


@pytest.mark.card
def test_path_shapes_and_small_batches(card):
    """The integrator's own shapes (few lanes, one lane) and the
    benchmark scenes' slot counts."""
    for lanes, slots in ((1, 1), (3, 2), (257, 2), (131072, 2), (65536, 1)):
        _check_all(*_case(lanes + slots, lanes, slots, TYPES, card), f"{lanes} lanes")


@pytest.mark.card
def test_twice_bit_equal_and_counted(card):
    lobes, n, wi, wo, u2 = _case(53, LANES, 2, TYPES, card)
    n0, k0 = dict(bsdf.LAUNCHES), dict(kernel.LAUNCHES)
    with torch.no_grad():
        a = (bsdf.bsdf_f(lobes, n, wi, wo), bsdf.bsdf_pdf(lobes, n, wi, wo),
             *bsdf.bsdf_sample(lobes, n, wi, u2))
        b = (bsdf.bsdf_f(lobes, n, wi, wo), bsdf.bsdf_pdf(lobes, n, wi, wo),
             *bsdf.bsdf_sample(lobes, n, wi, u2))
    torch.cuda.synchronize()
    assert {k: bsdf.LAUNCHES[k] - n0[k] for k in n0} == {
        "bsdf_kernel": 6, "bsdf_kernel_grad": 0, "bsdf_eager": 0}
    assert {k: kernel.LAUNCHES[k] - k0[k] for k in k0} == {
        "bsdf_eval": 4, "bsdf_sample": 2, "bsdf_weight_grad": 0}
    for x, y in zip(a, b):
        assert not _diff(x, y)


@pytest.mark.card
def test_grad_inputs_stay_eager(card):
    """A call whose lobe parameters or directions autograd has to record
    runs the eager code, on the card too."""
    lobes, n, wi, wo, u2 = _case(59, 512, 2, TYPES, card)
    lobes["param"] = lobes["param"].clone().requires_grad_()
    wi = wi.clone().requires_grad_()
    n0 = dict(bsdf.LAUNCHES)
    bsdf.bsdf_f(lobes, n, wi, wo).sum().backward()
    bsdf.bsdf_sample(dict(lobes, param=lobes["param"].detach()), n, wi, u2)[0].sum().backward()
    assert {k: bsdf.LAUNCHES[k] - n0[k] for k in n0} == {
        "bsdf_kernel": 0, "bsdf_kernel_grad": 0, "bsdf_eager": 2}
    assert lobes["param"].grad is not None and wi.grad is not None


@pytest.mark.card
def test_weight_grad_takes_kernel_grad(card):
    """A call whose only input that requires grad is the lobe weight takes
    kernel_grad: one forward launch a call, one backward launch, a
    gradient at the weight's shape; bsdf_pdf takes the kernel."""
    lobes, n, wi, wo, u2 = _case(59, 512, 2, TYPES, card)
    lobes["weight"] = lobes["weight"].clone().requires_grad_()
    n0, k0 = dict(bsdf.LAUNCHES), dict(kernel.LAUNCHES)
    (bsdf.bsdf_f(lobes, n, wi, wo).sum() + bsdf.bsdf_sample(lobes, n, wi, u2)[0].sum()).backward()
    assert not bsdf.bsdf_pdf(lobes, n, wi, wo).requires_grad
    torch.cuda.synchronize()
    assert {k: bsdf.LAUNCHES[k] - n0[k] for k in n0} == {
        "bsdf_kernel": 1, "bsdf_kernel_grad": 2, "bsdf_eager": 0}
    assert {k: kernel.LAUNCHES[k] - k0[k] for k in k0} == {
        "bsdf_eval": 2, "bsdf_sample": 1, "bsdf_weight_grad": 2}
    assert lobes["weight"].grad.shape == lobes["weight"].shape


def _grad_out(lanes, dev, seed):
    """An incoming gradient with zeros of both signs."""
    g = torch.randn((lanes, 3), generator=torch.Generator().manual_seed(seed))
    g[::7] = 0.0
    g[3::11] = -0.0
    return g.to(dev)


def _leaf(lobes, strided=False):
    """A weight that requires grad and the leaf its gradient lands in: the
    weight itself, or a column block of a wider leaf."""
    w = lobes["weight"].detach()
    if not strided:
        leaf = w.clone().requires_grad_()
        return leaf, leaf
    wide = torch.full(w.shape[:-1] + (w.shape[-1] + 6,), float("nan"), device=w.device)
    wide[..., 3:6] = w
    wide.requires_grad_()
    return wide, wide[..., 3:6]


def _check_grads(lobes, n, wi, wo, u2, what, strided=False, fresnel=False, seed=0):
    """Each weight-reading entry by the route bsdf/bsdf.py picks against
    eager autograd: the outputs, the leaf's gradient and (unweighted)
    the saved values against saving_plain's."""
    eager = {"bsdf_f": bsdf._bsdf_f_eager, "bsdf_sample": bsdf._bsdf_sample_eager}
    g = _grad_out(n.shape[0], n.device, seed)
    for entry in ("bsdf_f", "bsdf_sample"):
        sample = entry == "bsdf_sample"
        args = (n, wi, u2) if sample else (n, wi, wo)
        res = {}
        for route in ("kernel_grad", "eager"):
            leaf, weight = _leaf(lobes, strided)
            lb = dict(lobes, weight=weight)
            if fresnel:
                lb = bsdf.apply_fresnel(_FRESNEL, lb, n, wi)
            n0 = bsdf.LAUNCHES["bsdf_kernel_grad"]
            out = getattr(bsdf, entry)(lb, *args) if route == "kernel_grad" else (
                eager[entry](lb, *args))
            assert bsdf.LAUNCHES["bsdf_kernel_grad"] - n0 == (route == "kernel_grad")
            outs = out if sample else (out,)
            res[route] = outs, torch.autograd.grad(outs[0], leaf, g)[0]
        (got, g_got), (want, g_want) = res["kernel_grad"], res["eager"]
        _assert_same(tuple(x.detach() for x in got), tuple(x.detach() for x in want),
                     f"{what} {entry}", lobes)
        bad = _diff(g_got, g_want)
        if bad:
            i = bad[0]
            raise AssertionError(f"{what} {entry}: the weight gradient differs on {len(bad)} "
                                 f"lanes; lane {i}: {g_got[i].tolist()} against "
                                 f"{g_want[i].tolist()}")
        if fresnel:
            continue
        saving = kernel.bsdf_sample_saving if sample else kernel.bsdf_f_saving
        _, (e, scale, bits) = saving(lobes, *args)
        _, (e_p, scale_p, bits_p) = kernel.saving_plain(sample, lobes, *args)
        L = lobes["max_lobes"]
        saved = [("scale", scale, scale_p), ("bits", bits, bits_p)]
        if not sample or L > 1:
            saved.append(("e", e, e_p))
        for name, a, b in saved:
            bad = _diff(a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1))
            assert not bad, (f"{what} {entry}: saved {name} differs on {len(bad)} lanes; lane "
                             f"{bad[0]}: {a[bad[0]].tolist()} against {b[bad[0]].tolist()}")


class _Fresnel:
    has_fresnel = True


_FRESNEL = _Fresnel()


@pytest.mark.card
@pytest.mark.parametrize("slots", [1, 2, 8])
@pytest.mark.parametrize("lobe_type", TYPES)
def test_weight_grad_each_type_alone(card, lobe_type, slots):
    case = _case(300 * lobe_type + slots, LANES, slots, (lobe_type,), card)
    _check_grads(*case, f"type {lobe_type} x {slots} slots", seed=slots)


@pytest.mark.card
@pytest.mark.parametrize("slots", range(1, 9))
def test_weight_grad_all_types_mixed(card, slots):
    case = _case(17 + slots, LANES, slots, TYPES, card)
    _check_grads(*case, f"mixed x {slots} slots", seed=slots)


@pytest.mark.card
@pytest.mark.parametrize("slots", [1, 2, 8])
def test_weight_grad_through_fresnel_weighting(card, slots):
    lobes, n, wi, wo, u2 = _case(23 + slots, LANES, slots, TYPES, card)
    mode = torch.randint(0, 3, lobes["param"].shape[:2], generator=torch.Generator().manual_seed(5))
    lobes["param"][..., 4] = mode.to(card).float()
    lobes["param"][..., 5] = 1.45
    _check_grads(lobes, n, wi, wo, u2, f"Fresnel-weighted x {slots} slots", fresnel=True)


@pytest.mark.card
@pytest.mark.parametrize("slots", [1, 2, 8])
def test_weight_grad_strided_views(card, slots):
    lobes, n, wi, wo, u2 = _strided(*_case(47 + slots, LANES, slots, TYPES, card))
    _check_grads(lobes, n, wi, wo, u2, f"strided x {slots} slots", strided=True)


@pytest.mark.card
def test_weight_grad_path_shapes_and_a_whole_frame(card):
    """The integrator's own shapes, the benchmark scenes' slot counts and
    multi_bsdf.inverse's 262,144 lanes of a whole 512x512 frame."""
    for lanes, slots in ((1, 1), (3, 2), (257, 2), (65536, 1), (262144, 2)):
        _check_grads(*_case(lanes + slots + 1, lanes, slots, TYPES, card), f"{lanes} lanes",
                     seed=lanes)


@pytest.mark.card
def test_inverse_step_bit_equal_to_the_eager_route(card, monkeypatch):
    """Two InverseRenderer steps on multi_bsdf_scene 64x64 (emission and
    lobe_weight, the cluster tracer, depth 3) give the same losses, the
    same gradients and the same parameters, bit for bit, with the
    kernel_grad route as with it forced to the eager code."""
    from phosphorus_mk2_tpu_torch.optim import InverseRenderer
    from phosphorus_mk2_tpu_torch.scenes import multi_bsdf_scene

    target = np.random.default_rng(29).random((64, 64, 3), dtype=np.float32) * 0.6

    def steps():
        inv = InverseRenderer(multi_bsdf_scene(64, 64), target, spp=4, max_depth=3, seed=29,
                              device="cuda")
        n0 = dict(bsdf.LAUNCHES)
        losses, grads = [], []
        for _ in range(2):
            losses.append(inv.step())
            grads.append({k: p.grad.clone() for k, p in inv.params.items()})
        params = {k: p.detach().clone() for k, p in inv.params.items()}
        return losses, grads, params, {k: bsdf.LAUNCHES[k] - n0[k] for k in n0}

    got = steps()
    real = bsdf._kernel_route
    with monkeypatch.context() as m:
        m.setattr(bsdf, "_kernel_route",
                  lambda *a: "eager" if real(*a) == "kernel_grad" else real(*a))
        want = steps()
    # 2 calls a bounce (bsdf_f, bsdf_sample) x depth 3 x 4 spp x 2 steps
    assert got[3] == {"bsdf_kernel": 0, "bsdf_kernel_grad": 48, "bsdf_eager": 0}
    assert want[3] == {"bsdf_kernel": 0, "bsdf_kernel_grad": 0, "bsdf_eager": 48}
    assert got[0] == want[0]
    for step, (a, b) in enumerate(zip(got[1], want[1])):
        for k in a:
            assert not _diff(a[k], b[k]), f"step {step}: the {k} gradient differs"
            assert bool((a[k] != 0).any()), f"step {step}: the {k} gradient is zero"
    for k in got[2]:
        assert not _diff(got[2][k], want[2][k]), f"the {k} parameters differ"


@pytest.mark.card
def test_refusals(card):
    """What the wrappers refuse raises before a launch, and is not
    counted."""
    lobes, n, wi, wo, u2 = _case(61, 64, 2, TYPES, card)
    k0 = dict(kernel.LAUNCHES)
    with pytest.raises(ValueError, match="float32"):
        kernel.bsdf_f(lobes, n.double(), wi, wo)
    with pytest.raises(ValueError, match="int64"):
        kernel.bsdf_f(dict(lobes, type=lobes["type"].int()), n, wi, wo)
    with pytest.raises(ValueError, match="slots"):
        kernel.bsdf_pdf(dict(lobes, max_lobes=9), n, wi, wo)
    with pytest.raises(ValueError, match="shape"):
        kernel.bsdf_sample(lobes, n, wi, u2[:, :1])
    assert dict(kernel.LAUNCHES) == k0
