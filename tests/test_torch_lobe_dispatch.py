"""The port's one lobe dispatch (bsdf/lobes.py ``eval_lobe``,
``sample_lobe``, dense by type code) against the JAX package's
type-sorted dispatch (``eval_lobe_sorted``, ``sample_lobe_sorted``), and
the port's gradients against JAX's under either of its dispatches.

Tolerances, and why:
  * per lane, the dense dispatch keeps its type's function's value bit
    for bit (a type's function run over the whole tensor is what the
    dense dispatch selects from).
  * port against JAX's sorted dispatch: the bound tests/test_torch_bsdf.py
    holds the dense lobes to JAX's with on mixed types. At least 98% of
    the values within rtol 1e-5, atol 1e-6 (the libm and XLA's fusion of
    a few products differ in the last place), and every value within
    rtol 1e-2, atol 1e-4: the GGX visible-normal warp and the sheen lobe
    are ill-conditioned near grazing angles, where a last-place
    difference in the local frame grows to 1e-4..1e-2 relative. Sampled
    directions are unit vectors, and their components are held to atol
    2e-3 (about 2 mrad) instead of 1e-4: these lanes draw parameters
    outside each type's domain, and on seed 0's lane 5809 (an
    anisotropic GGX sample, rejected on both sides with f and pdf 0) a
    one-ulp nudge of wi moves the port's own wo by 5e-4; the packages
    differ there by 8.9e-4.
  * gradients against JAX's, dense or sorted: rtol 2e-4, atol 1e-7
    (tests/test_grad.py's bound for the sorted dispatch; the backward
    sums the same terms in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phosphorus_mk2_tpu.bsdf.lobes as jl
from phosphorus_mk2_tpu.core.camera import camera_to_params as j_cam_params
from phosphorus_mk2_tpu.integrator.path import make_tracer as j_make_tracer
from phosphorus_mk2_tpu.integrator.path import render_pass as j_render_pass
from phosphorus_mk2_tpu.scenes import multi_bsdf_scene as j_multi_bsdf_scene
from phosphorus_mk2_tpu_torch.bsdf import lobes
from phosphorus_mk2_tpu_torch.core.camera import camera_to_params as t_cam_params
from phosphorus_mk2_tpu_torch.core.material import NUM_LOBE_TYPES
from phosphorus_mk2_tpu_torch.integrator import path as tpath
from phosphorus_mk2_tpu_torch.scenes import multi_bsdf_scene

torch.set_num_threads(1)

W, H = 72, 60  # 4,320 rays: both gates of JAX's sorted dispatch open
FIELDS = ("emission", "lobe_weight", "lobe_param")


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


@pytest.mark.parametrize("seed,n,present", [(0, 10007, None), (1, 4096, None),
                                            (2, 5000, (1, 2, 5, 7)), (3, 17, None)])
def test_dense_matches_jax_sorted(seed, n, present):
    present = present or lobes.ALL_TYPES
    t, params, nrm, wi, wo, u2 = _lanes(seed, n)
    got = (lobes.eval_lobe(t, params, nrm, wi, wo, present=present)
           + lobes.sample_lobe(t, params, nrm, wi, u2, present=present))
    jt = jnp.asarray(t.numpy().astype(np.int32))
    jp, jn, jwi, jwo, ju2 = (jnp.asarray(x.numpy()) for x in (params, nrm, wi, wo, u2))
    ref = (jl.eval_lobe_sorted(jt, jp, jn, jwi, jwo, tuple(present))
           + jl.sample_lobe_sorted(jt, jp, jn, jwi, ju2, tuple(present)))
    for k, (g, r) in enumerate(zip(got, ref)):  # f, pdf, f, wo, pdf
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype
        tight = np.isclose(g, r, rtol=1e-5, atol=1e-6)
        assert tight.mean() >= 0.98, (k, tight.mean(), np.abs(g - r).max())
        np.testing.assert_allclose(g, r, rtol=1e-2, atol=2e-3 if k == 3 else 1e-4, err_msg=k)


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


@pytest.fixture(scope="module")
def port_grads():
    """The port's gradients of a 72x60 multi_bsdf render's mean colour,
    made once for both cases."""
    ts = multi_bsdf_scene(W, H)
    td = ts.build(device="cpu")
    assert len(td.lobe_types_present) > 2
    cam = t_cam_params(ts.camera, "cpu")
    tracer = tpath.make_tracer(td, use_bvh=False)
    leaves = {f: getattr(td, f).detach().clone().requires_grad_() for f in FIELDS}
    out = tpath.render_pass(dataclasses.replace(td, **leaves), cam, 2, 0, 1,
                            width=W, height=H, max_depth=2, tracer=tracer)
    out["color"].mean().backward()
    return [leaves[f].grad.numpy() for f in FIELDS]


@pytest.mark.parametrize("jax_sorted", [False, True])
def test_grads_match_jax_either_dispatch(port_grads, jax_sorted):
    """tests/test_grad.py::test_sorted_dispatch_grads_match_dense across
    the packages: the port's gradients, with the brute tracer, against
    the JAX package's of the same render under its dense or its sorted
    dispatch."""
    js = j_multi_bsdf_scene(width=W, height=H)
    jd = js.build()
    jcam, jtracer = j_cam_params(js.camera), j_make_tracer(jd, use_bvh=False)

    def loss(e, w, p):
        d2 = dataclasses.replace(jd, emission=e, lobe_weight=w, lobe_param=p)
        out = j_render_pass(d2, jcam, jax.random.key(2), 0, 1, width=W, height=H,
                            max_depth=2, tracer=jtracer, sorted_dispatch=jax_sorted)
        return out["color"].mean()

    g_jax = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jd.emission, jd.lobe_weight, jd.lobe_param)
    for g, gj, name in zip(port_grads, g_jax, FIELDS):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(gj), rtol=2e-4, atol=1e-7, err_msg=name)
    assert np.abs(port_grads[1]).max() > 0 and np.abs(port_grads[2]).max() > 0
