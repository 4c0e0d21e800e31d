"""The type-sorted lobe dispatch (bsdf/lobes.py ``eval_lobe_sorted``,
``sample_lobe_sorted``) against the dense dispatch, port against port,
and its gradients against the JAX package's sorted dispatch.

Tolerances, and why:
  * per lane, the dense dispatch keeps its type's function's value bit
    for bit (both dispatches run the same per-type functions, and a
    type's function run over the whole tensor is what the dense dispatch
    selects from).
  * sorted against dense, in this process: every value within rtol 1e-6
    and at least 99.9% of the lanes bit-equal. A sorted segment puts a
    lane at another position of its tensor, and on the CPU ATen computes
    a tensor's last few elements with libm and the rest with SIMD
    polynomials (SLEEF), which differ in the last place for pow, exp,
    sin and cos. With ATEN_CPU_CAPABILITY=default both paths are libm,
    and a child process shows the lanes and whole films bit-equal. On
    the card every element runs the same code, and chip_smoke.py holds
    the films bit-equal.
  * gradients, sorted against dense and against JAX's sorted dispatch:
    rtol 2e-4, atol 1e-7 (tests/test_grad.py's bound for the sorted
    dispatch; the backward sums the same terms in another order).
"""
import dataclasses
import inspect
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu.core.camera import camera_to_params as j_cam_params
from phosphorus_mk2_tpu.integrator.path import make_tracer as j_make_tracer
from phosphorus_mk2_tpu.integrator.path import render_pass as j_render_pass
from phosphorus_mk2_tpu.scenes import multi_bsdf_scene as j_multi_bsdf_scene
from phosphorus_mk2_tpu_torch.bsdf import bsdf, lobes
from phosphorus_mk2_tpu_torch.core.camera import camera_to_params as t_cam_params
from phosphorus_mk2_tpu_torch.core.material import NUM_LOBE_TYPES
from phosphorus_mk2_tpu_torch.integrator import path as tpath
from phosphorus_mk2_tpu_torch.scenes import multi_bsdf_scene

torch.set_num_threads(1)

W, H = 72, 60  # 4,320 rays: both gates of the sorted dispatch open
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lanes(seed, n):
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, NUM_LOBE_TYPES, (n,), generator=g)
    params = torch.rand(n, 6, generator=g) * 0.9 + 0.05
    params[:, 2] = 1.0 + torch.rand(n, generator=g)
    params[::7, 2] = 1.0  # the refractive GGX passthrough

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)

    return (t, params, unit(torch.randn(n, 3, generator=g)), unit(torch.randn(n, 3, generator=g)),
            unit(torch.randn(n, 3, generator=g)), torch.rand(n, 2, generator=g))


def _both(seed, n, present=lobes.ALL_TYPES):
    t, params, nrm, wi, wo, u2 = _lanes(seed, n)
    dense = (lobes.eval_lobe(t, params, nrm, wi, wo, present=present)
             + lobes.sample_lobe(t, params, nrm, wi, u2, present=present))
    srt = (lobes.eval_lobe_sorted(t, params, nrm, wi, wo, present)
           + lobes.sample_lobe_sorted(t, params, nrm, wi, u2, present))
    return dense, srt


@pytest.mark.parametrize("seed,n,present", [(0, 10007, None), (1, 4096, None),
                                            (2, 5000, (1, 2, 5, 7)), (3, 17, None)])
def test_sorted_matches_dense(seed, n, present):
    dense, srt = _both(seed, n, present or lobes.ALL_TYPES)
    same = total = 0
    for a, b in zip(dense, srt):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=0)
        same += int((a == b).reshape(a.shape[0], -1).all(dim=1).sum())
        total += a.shape[0]
    assert same >= 0.999 * total, (same, total)


def test_type_functions_equal_dense_branches():
    t, params, nrm, wi, wo, u2 = _lanes(5, 3001)
    f, pdf = lobes.eval_lobe(t, params, nrm, wi, wo)
    fs, wos, pdfs = lobes.sample_lobe(t, params, nrm, wi, u2)
    for T in range(NUM_LOBE_TYPES):
        sel = t == T
        if T in lobes.EVALS:
            ef, ep = lobes.EVALS[T](lobes._Lanes(params, nrm, wi, wo=wo))
            assert torch.equal(ef[sel], f[sel]) and torch.equal(ep[sel], pdf[sel]), T
        else:  # specular and emissive lobes evaluate to 0
            assert not f[sel].any() and not pdf[sel].any(), T
        if T in lobes.SAMPLERS:
            sf, swo, sp = lobes.SAMPLERS[T](lobes._Lanes(params, nrm, wi, u2=u2))
            assert torch.equal(sf[sel], fs[sel]) and torch.equal(sp[sel], pdfs[sel]), T
            assert torch.equal(swo[sel], wos[sel]), T


def test_gate(monkeypatch):
    """The JAX package's gate: more than two types present, a batch of at
    least 4096 lanes (hits x slots for evaluation, hits for sampling),
    and lobes["sorted_ok"]."""
    calls = []
    for name in ("eval_lobe_sorted", "sample_lobe_sorted"):
        real = getattr(bsdf, name)
        monkeypatch.setattr(bsdf, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    t, params, nrm, wi, wo, u2 = _lanes(6, 8192)

    def run(present, n, sorted_ok, slots=2):
        calls.clear()
        lob = {"type": t[:n * slots].reshape(n, slots), "param": params[:n * slots].reshape(n, slots, 6),
               "weight": torch.ones(n, slots, 3), "flags": torch.full((n, slots), 8),
               "n": torch.full((n,), slots), "present": present, "max_lobes": slots,
               "sorted_ok": sorted_ok}
        bsdf.bsdf_f(lob, nrm[:n], wi[:n], wo[:n])
        bsdf.bsdf_sample(lob, nrm[:n], wi[:n], u2[:n])
        return sorted(calls)

    many = (1, 2, 5, 7)
    assert run(many, 2048, True) == ["eval_lobe_sorted", "eval_lobe_sorted"]
    assert run(many, 4096, True, slots=1) == ["eval_lobe_sorted", "sample_lobe_sorted"]
    assert run(many, 2047, True) == []
    assert run((1, 2), 4096, True, slots=1) == []
    assert run(many, 4096, False, slots=1) == []


_CHILD = r"""
import sys
import torch
sys.path.insert(0, sys.argv[1])
from phosphorus_mk2_tpu_torch.bsdf import lobes
from phosphorus_mk2_tpu_torch.core.camera import camera_to_params
from phosphorus_mk2_tpu_torch.core.material import NUM_LOBE_TYPES
from phosphorus_mk2_tpu_torch.integrator import path
from phosphorus_mk2_tpu_torch.scenes import multi_bsdf_scene
torch.set_num_threads(1)
""" + inspect.getsource(_lanes) + inspect.getsource(_both) + r"""
assert torch.backends.cpu.get_cpu_capability() == "DEFAULT"
for seed, n in ((0, 10007), (1, 4096), (3, 17)):
    dense, srt = _both(seed, n)
    assert all(torch.equal(a, b) for a, b in zip(dense, srt)), seed
s = multi_bsdf_scene(64, 64)  # 4,096 rays: both gates open
d = s.build(device="cpu")
cam = camera_to_params(s.camera, "cpu")
tr = path.make_tracer(d, use_bvh=False)
films = [path.render_pass(d, cam, 0, 0, 2, width=64, height=64, max_depth=3, tracer=tr,
                          sorted_dispatch=sd)["color"] for sd in (True, False)]
assert torch.equal(*films)
print("bit-equal")
"""


def test_sorted_bit_equal_where_the_cpu_computes_every_lane_alike():
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default")
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, ROOT],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "bit-equal" in out.stdout


def _port_grads(sorted_dispatch):
    ts = multi_bsdf_scene(W, H)
    td = ts.build(device="cpu")
    assert len(td.lobe_types_present) > 2
    cam = t_cam_params(ts.camera, "cpu")
    tracer = tpath.make_tracer(td, use_bvh=False)
    names = ("emission", "lobe_weight", "lobe_param")
    leaves = {f: getattr(td, f).detach().clone().requires_grad_() for f in names}
    out = tpath.render_pass(dataclasses.replace(td, **leaves), cam, 2, 0, 1, width=W, height=H,
                            max_depth=2, tracer=tracer, sorted_dispatch=sorted_dispatch)
    out["color"].mean().backward()
    return out["color"].detach(), [leaves[f].grad.numpy() for f in names]


def test_sorted_grads_match_dense_and_jax():
    """tests/test_grad.py::test_sorted_dispatch_grads_match_dense in the
    port, with the brute tracer, and the JAX package's sorted gradients
    of the same render."""
    film_s, g_sorted = _port_grads(True)
    film_d, g_dense = _port_grads(False)
    np.testing.assert_allclose(film_s.numpy(), film_d.numpy(), rtol=1e-6, atol=0)

    js = j_multi_bsdf_scene(width=W, height=H)
    jd = js.build()
    jcam, jtracer = j_cam_params(js.camera), j_make_tracer(jd, use_bvh=False)

    def loss(e, w, p):
        d2 = dataclasses.replace(jd, emission=e, lobe_weight=w, lobe_param=p)
        out = j_render_pass(d2, jcam, jax.random.key(2), 0, 1, width=W, height=H,
                            max_depth=2, tracer=jtracer, sorted_dispatch=True)
        return out["color"].mean()

    g_jax = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jd.emission, jd.lobe_weight, jd.lobe_param)
    for gs, gd, gj, name in zip(g_sorted, g_dense, g_jax, ("emission", "lobe_weight", "lobe_param")):
        assert np.isfinite(gs).all(), name
        np.testing.assert_allclose(gs, gd, rtol=2e-4, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(gs, np.asarray(gj), rtol=2e-4, atol=1e-7, err_msg=name)
    assert np.abs(g_sorted[1]).max() > 0 and np.abs(g_sorted[2]).max() > 0
