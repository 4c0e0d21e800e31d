"""The lobe weights' gradient of the container's kernel_grad route
(bsdf/bsdf.py ``_WeightGrad``, bsdf/kernel.py): on the CPU its plain
versions, ``saving_plain`` and ``weight_grad_plain``, against eager
autograd through the dense lobe code, bit for bit (signed zeros
included): the six lobe types of the multi-BSDF scene mixed at 1 to 8
slots, on the call's own weight and through the Fresnel weighting of
``apply_fresnel``. Then a whole ``InverseRenderer`` step: the container
gets its normal, directions and lobe parameters without grad unless a
trainable field lies behind them, and steps on the route's Function equal
the eager steps bit for bit. The card's kernels are held to the same in
tests/test_torch_bsdf_kernel_card.py."""
import dataclasses
import types

import pytest
import torch

from phosphorus_mk2_tpu_torch.bsdf import bsdf, kernel
from phosphorus_mk2_tpu_torch.core.material import (
    DIFFUSE,
    LOBE_FLAGS,
    MICROFACET,
    OREN_NAYAR,
    REFLECTION,
    REFRACTION,
    SHEEN,
)

SIX = (DIFFUSE, OREN_NAYAR, REFLECTION, REFRACTION, MICROFACET, SHEEN)
LANES = 1024


def _case(seed, slots):
    """Seeded lobes of the six types, unit directions, uniforms and an
    incoming gradient with zeros of both signs."""
    g = torch.Generator().manual_seed(seed)
    types_ = torch.tensor(SIX)[torch.randint(0, len(SIX), (LANES, slots), generator=g)]
    flags = torch.tensor([LOBE_FLAGS.get(k, 0) for k in range(max(LOBE_FLAGS) + 1)])[types_]
    param = torch.rand((LANES, slots, 6), generator=g) * 0.9 + 0.05
    param[..., 2] = 1.0 + torch.rand((LANES, slots), generator=g)
    param[..., 4] = torch.randint(0, 3, (LANES, slots), generator=g).float()  # Fresnel mode
    param[..., 5] = torch.where(torch.rand((LANES, slots), generator=g) < 0.2, 0.0, 1.45)
    lobes = {"type": types_, "flags": flags,
             "n": torch.randint(0, slots + 1, (LANES,), generator=g),
             "weight": torch.rand((LANES, slots, 3), generator=g),
             "param": param, "present": SIX, "max_lobes": slots}

    def unit():
        x = torch.randn((LANES, 3), generator=g)
        return x / x.norm(dim=-1, keepdim=True)

    n, wi, wo = unit(), unit(), unit()
    grad = torch.randn((LANES, 3), generator=g)
    grad[::7] = 0.0
    grad[3::11] = -0.0
    return lobes, n, wi, wo, torch.rand((LANES, 2), generator=g), grad


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bit_equal(got, want, what):
    same = (_bits(got) == _bits(want)) | (got.isnan() & want.isnan())
    bad = (~same.reshape(same.shape[0], -1).all(dim=1)).nonzero().flatten()
    assert bad.numel() == 0, (f"{what}: {bad.numel()} lanes differ; lane {int(bad[0])}: "
                              f"{got[bad[0]].tolist()} against {want[bad[0]].tolist()}")


def _eager_grad(sample, lobes, n, wi, x, grad):
    weight = lobes["weight"].detach().clone().requires_grad_()
    fn = bsdf._bsdf_sample_eager if sample else bsdf._bsdf_f_eager
    out = fn(dict(lobes, weight=weight), n, wi, x)
    f = out[0] if sample else out
    return out, torch.autograd.grad(f, weight, grad)[0]


@pytest.mark.parametrize("slots", range(1, 9))
@pytest.mark.parametrize("entry", ("bsdf_f", "bsdf_sample"))
def test_plain_backward_equals_eager_autograd(entry, slots):
    """weight_grad_plain of saving_plain's values is autograd's gradient of
    the eager call's value with respect to its weight; saving_plain's
    outputs are the eager call's."""
    sample = entry == "bsdf_sample"
    lobes, n, wi, wo, u2, grad = _case(100 * slots + sample, slots)
    x = u2 if sample else wo
    want_out, want = _eager_grad(sample, lobes, n, wi, x, grad)
    out, saved = kernel.saving_plain(sample, lobes, n, wi, x)
    for a, b in zip(out if sample else (out,), want_out if sample else (want_out,)):
        assert torch.equal(_bits(a), _bits(b.detach()))
    got = kernel.weight_grad_plain(grad, *saved, slots, sample)
    assert got.shape == lobes["weight"].shape
    _assert_bit_equal(got, want, f"{entry} x {slots} slots")
    assert bool((got != 0).any()), "every gradient lane is zero"


@pytest.mark.parametrize("slots", range(1, 9))
@pytest.mark.parametrize("entry", ("bsdf_f", "bsdf_sample"))
def test_through_fresnel_weighting_as_eager(entry, slots):
    """The route's autograd Function on the plain versions, behind
    apply_fresnel's weighting of a leaf weight (the glass's reflection and
    refraction lobes): its values and the leaf's gradient are the eager
    call's, and wo, the pdf and the flags need no grad."""
    sample = entry == "bsdf_sample"
    lobes, n, wi, wo, u2, grad = _case(7 + 100 * slots + sample, slots)
    x = u2 if sample else wo
    scene = types.SimpleNamespace(has_fresnel=True)
    got = {}
    for route in ("eager", "kernel_grad"):
        leaf = lobes["weight"].clone().requires_grad_()
        lb = bsdf.apply_fresnel(scene, dict(lobes, weight=leaf), n, wi)
        fn = {("eager", False): bsdf._bsdf_f_eager, ("eager", True): bsdf._bsdf_sample_eager,
              ("kernel_grad", False): bsdf._bsdf_f_kernel_grad,
              ("kernel_grad", True): bsdf._bsdf_sample_kernel_grad}[route, sample]
        out = fn(lb, n, wi, x)
        outs = out if sample else (out,)
        got[route] = outs, torch.autograd.grad(outs[0], leaf, grad)[0]
    (o_eager, g_eager), (o_route, g_route) = got["eager"], got["kernel_grad"]
    for a, b in zip(o_route, o_eager):
        assert torch.equal(_bits(a.detach()), _bits(b.detach()))
    assert all(not t.requires_grad for t in o_route[1:])
    _assert_bit_equal(g_route, g_eager, f"{entry} x {slots} slots, Fresnel-weighted")


def test_backward_reads_the_gradient_through_its_strides():
    """An expanded incoming gradient (stride 0, as ``f.sum()``'s) and a
    column block of a wider one give the dense gradient's result."""
    lobes, n, wi, wo, _, grad = _case(5, 2)
    _, saved = kernel.saving_plain(False, lobes, n, wi, wo)
    want = kernel.weight_grad_plain(grad.contiguous(), *saved, 2, False)
    wide = torch.zeros((LANES, 7))
    wide[:, 2:5] = grad
    _assert_bit_equal(kernel.weight_grad_plain(wide[:, 2:5], *saved, 2, False), want, "block")
    ones = torch.ones(()).expand(LANES, 3)
    _assert_bit_equal(kernel.weight_grad_plain(ones, *saved, 2, False),
                      kernel.weight_grad_plain(torch.ones(LANES, 3), *saved, 2, False), "expanded")


def _spy_routes(monkeypatch, card_route):
    """Record what each container call of a step is handed; with
    card_route, send the calls the card would route to kernel_grad there
    (the Function on its plain versions)."""
    seen = []
    real = bsdf._kernel_route

    def route(lobes, *xs):
        others = [t.requires_grad for t in (*xs, lobes["param"])]
        seen.append((lobes["weight"].requires_grad, others))
        if card_route and torch.is_grad_enabled() and lobes["weight"].requires_grad and not any(
                others):
            return "kernel_grad"
        return real(lobes, *xs)

    monkeypatch.setattr(bsdf, "_kernel_route", route)
    return seen


def _steps(trainable, n=2):
    import numpy as np

    from phosphorus_mk2_tpu_torch.optim import InverseRenderer
    from phosphorus_mk2_tpu_torch.scenes import multi_bsdf_scene

    target = np.random.default_rng(3).random((16, 16, 3), dtype=np.float32) * 0.6
    inv = InverseRenderer(multi_bsdf_scene(16, 16), target, trainable=trainable, spp=2,
                          max_depth=3, seed=5, device="cpu")
    losses, grads = [], []
    for _ in range(n):
        losses.append(inv.step())
        grads.append({k: p.grad.clone() for k, p in inv.params.items()})
    return losses, grads, {k: p.detach().clone() for k, p in inv.params.items()}


@pytest.mark.parametrize("trainable", [("emission", "lobe_weight"), ("lobe_weight", "lobe_param"),
                                       ("lobe_weight", "vertices")])
def test_step_hands_the_container_only_what_carries_gradient(monkeypatch, trainable):
    """In an InverseRenderer step each container call gets its normal,
    directions and lobe parameters with grad only where a trainable field
    lies behind them (each block of a gathered row requires grad as its
    source does, math/grad_gather.block_of): with the lobe weights and the
    emission trainable, only the weights require grad (the card's
    kernel_grad route); with the lobe parameters or the geometry
    trainable, those require grad too (the eager code)."""
    seen = _spy_routes(monkeypatch, card_route=False)
    _steps(trainable, n=1)
    assert len(seen) == 12 and all(w for w, _ in seen)  # 2 a bounce x depth 3 x 2 spp
    if trainable == ("emission", "lobe_weight"):
        assert not any(any(o) for _, o in seen)
    elif "lobe_param" in trainable:
        assert all(o[-1] for _, o in seen)
    else:
        assert all(o[0] for _, o in seen)  # the normal


def test_step_on_the_weight_gradient_route_equals_the_eager_step(monkeypatch):
    """Two steps whose container calls take the kernel_grad route's
    Function (on its plain versions, as the card's would take its kernels)
    give the eager steps' losses, gradients and parameters, bit for bit."""
    want = _steps(("emission", "lobe_weight"))
    seen = _spy_routes(monkeypatch, card_route=True)
    got = _steps(("emission", "lobe_weight"))
    assert len(seen) == 24
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        for k in a:
            assert torch.equal(_bits(a[k]), _bits(b[k])), k
    for k in got[2]:
        assert torch.equal(_bits(got[2][k]), _bits(want[2][k])), k


def _scene_grads(fields, trainable):
    """d color.sum() / d fields of a depth-3 render of multi_bsdf_scene,
    each field a fresh leaf."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params
    from phosphorus_mk2_tpu_torch.integrator import path
    from phosphorus_mk2_tpu_torch.scenes import multi_bsdf_scene

    s = multi_bsdf_scene(16, 16)
    td = s.build(device="cpu")
    leaves = {f: getattr(td, f).detach().clone().requires_grad_() for f in fields}
    out = path.render_pass(dataclasses.replace(td, **leaves), camera_to_params(s.camera, "cpu"),
                           3, 0, 2, width=16, height=16, max_depth=3,
                           tracer=path.make_tracer(td, use_bvh=False), trainable=trainable)
    out["color"].sum().backward()
    return {f: leaves[f].grad for f in fields}


@pytest.mark.parametrize("pair", [("emission", "lobe_param"), ("lobe_weight", "lobe_param")])
def test_scoped_lobe_param_gradients_equal_the_unscoped(pair):
    """From the second bounce on, the ray direction is the sampled lobe's,
    which the lobe parameters move; the re-intersection, the shading
    normal and the light direction follow it. A step scoped to a set
    with the lobe parameters and no geometry keeps those paths: its
    gradients are the unscoped render's, bit for bit."""
    full = _scene_grads(pair, None)
    scoped = _scene_grads(pair, pair)
    for f in pair:
        assert bool(full[f].abs().max() > 0), f
        assert torch.equal(_bits(scoped[f]), _bits(full[f])), (
            f, float((scoped[f] - full[f]).abs().max() / full[f].abs().max()))
