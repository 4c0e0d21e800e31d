"""The port's InverseRenderer against the JAX package's on the same scene,
target, seed and options (sphere_in_box 12x12, brute tracer, Adam), step
for step, and the optimizer checkpoint carried across in both
directions: a JAX optimizer.npz resumes in the port and continues as the
JAX run does, and the port's resumes in JAX.

Tolerances, and why: losses within rtol 1e-4 and parameters within
1e-4 absolute over 5 steps and over 2 steps after a resume. The
gradients agree to ~1e-5 of their scale (tests/test_torch_grad.py);
Adam's steps are normalised (lr 0.1), so that difference, and the
different order of Adam's update in optax (mu_hat / (sqrt(nu_hat) +
eps)) and torch (exp_avg / (sqrt(exp_avg_sq) / sqrt(bc2) + eps) * lr /
bc1), move a parameter a few ulps a step; measured at most 5e-6
relative on the losses and 4e-6 on the parameters.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu.optim import InverseRenderer as JInverseRenderer
from phosphorus_mk2_tpu.scenes import sphere_in_box as j_sphere_in_box
from phosphorus_mk2_tpu_torch.optim import InverseRenderer
from phosphorus_mk2_tpu_torch.scenes import sphere_in_box as t_sphere_in_box

torch.set_num_threads(1)

RES = 12
CONFIGS = {
    # one fixed path set, the plain loss, one view
    "fixed": dict(fresh_rng=False),
    # fresh keys, the double-sample loss split by threefry, log emission,
    # two views in turn
    "fresh_unbiased_log_views": dict(fresh_rng=True, unbiased_loss=True, log_emission=True,
                                     views=True),
}


def _scene(mod):
    s = mod(width=RES, height=RES)
    s.materials[3].emission = tuple(0.3 * float(x) for x in s.materials[3].emission)
    return s


def _kwargs(cfg, scene):
    kw = dict(trainable=("emission", "lobe_weight"), learning_rate=0.1, spp=2, max_depth=2,
              use_bvh=False, seed=1, **cfg)
    g = np.random.default_rng(0)
    target = g.uniform(0.0, 0.5, (RES, RES, 3)).astype(np.float32)
    if kw.pop("views", False):
        cam1 = dataclasses.replace(scene.camera, to_world=np.array(scene.camera.to_world))
        cam1.to_world[3, 0] += 0.35
        kw["views"] = [(scene.camera, target), (cam1, target[::-1].copy())]
    return target, kw


def _pair(cfg):
    js, ts = _scene(j_sphere_in_box), _scene(t_sphere_in_box)
    jt, jkw = _kwargs(cfg, js)
    tt, tkw = _kwargs(cfg, ts)
    return (JInverseRenderer(js, jt, n_devices=1, **jkw),
            InverseRenderer(ts, tt, device="cpu", **tkw), tkw, tt)


def _assert_same(jinv, tinv, jl=None, tl=None):
    if jl is not None:
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert jinv._step_count == tinv._step_count
    for k in tinv.params:
        np.testing.assert_allclose(tinv.params[k].detach().numpy(), np.asarray(jinv.params[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_steps_and_checkpoints_match_jax(name, tmp_path):
    jinv, tinv, tkw, target = _pair(CONFIGS[name])
    jl, tl = jinv.run(3), tinv.run(3)
    _assert_same(jinv, tinv, jl, tl)
    jck, tck = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jinv.save_checkpoint(jck)
    tinv.save_checkpoint(tck)
    ck_j, ck_t = np.load(jck), np.load(tck)
    assert sorted(ck_j.files) == sorted(ck_t.files)
    np.testing.assert_array_equal(ck_t["key"], ck_j["key"])
    assert int(ck_t["opt_0"]) == int(ck_j["opt_0"]) == 3

    jl, tl = jinv.run(2), tinv.run(2)  # both uninterrupted to step 5
    _assert_same(jinv, tinv, jl, tl)

    # the JAX checkpoint resumes in the port and continues as JAX did
    from_jax = InverseRenderer(_scene(t_sphere_in_box), target, device="cpu", **tkw)
    from_jax.load_checkpoint(jck)
    _assert_same(jinv, from_jax, jl, from_jax.run(2))

    # and the port's resumes in JAX, continuing as the port did
    jinv.load_checkpoint(tck)
    _assert_same(jinv, tinv, jinv.run(2), tl)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jinv.key)), tinv.key)
