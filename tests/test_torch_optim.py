"""The port's InverseRenderer on its own, on the CPU: copies of
tests/test_optim.py's convergence tests with the same scenes, seeds,
steps and criteria, the checks of its arguments, and the optimizer
checkpoint's resume (a resumed run continues as the uninterrupted one:
parameters within 1e-6, the same operations on the same values).
tests/test_torch_optim_parity.py holds it against the JAX package's."""
import dataclasses

import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu_torch.core.options import Options
from phosphorus_mk2_tpu_torch.integrator.path import render_aovs
from phosphorus_mk2_tpu_torch.optim import InverseRenderer
from phosphorus_mk2_tpu_torch.scenes import sphere_in_box

torch.set_num_threads(1)

RES = 12


def _target(scene, spp, per_pass, cam=None):
    data = scene.build(device="cpu")
    out = render_aovs(data, cam or scene.camera, spp=spp, max_depth=2,
                      options=Options(use_bvh=False, samples_per_pass=per_pass))
    return data, out["color"].numpy()


def _dim_lamp(factor=0.3):
    s = sphere_in_box(width=RES, height=RES)
    true_e = np.asarray(s.materials[3].emission, np.float32)
    s.materials[3].emission = tuple(float(x) * factor for x in true_e)
    return s


def test_recover_emission():
    scene = sphere_in_box(width=RES, height=RES)
    data, target = _target(scene, 4, 4)
    true_e = data.emission.numpy()[3].copy()
    inv = InverseRenderer(_dim_lamp(), target, trainable=("emission",), learning_rate=0.5,
                          spp=2, max_depth=2, use_bvh=False, seed=1, fresh_rng=True,
                          device="cpu")
    losses = inv.run(80)
    assert np.mean(losses[-10:]) < losses[0] * 0.6, losses[::10]
    np.testing.assert_allclose(inv.params["emission"].detach().numpy()[3], true_e, rtol=0.25)


def test_log_emission_recovers_scale():
    scene = sphere_in_box(width=RES, height=RES)
    data, target = _target(scene, 8, 8)
    true_e = data.emission.numpy().copy()
    lamp_rows = np.abs(true_e).sum(axis=1) > 0
    for m in scene.materials:
        if m.is_emitter:
            m.emission = tuple(0.1 * e for e in m.emission)
    inv = InverseRenderer(scene, target, trainable=("emission",), learning_rate=0.25, spp=4,
                          max_depth=2, use_bvh=False, seed=2, log_emission=True,
                          fresh_rng=False, device="cpu")
    losses = inv.run(30)
    assert losses[-1] < losses[0]
    rec = inv.current_scene().emission.numpy()
    rel = np.abs(rec[lamp_rows] - true_e[lamp_rows]) / true_e[lamp_rows].max()
    assert rel.max() < 0.25, rel


def test_unbiased_loss_removes_variance_dimming():
    data, target = _target(sphere_in_box(width=RES, height=RES), 32, 8)
    true_e = data.emission.numpy().copy()
    rows = np.abs(true_e).sum(1) > 0
    ratios = {}
    for unb in (False, True):
        s = sphere_in_box(width=RES, height=RES)
        for m in s.materials:
            if m.is_emitter:
                m.emission = tuple(0.4 * e for e in m.emission)
        inv = InverseRenderer(s, target, trainable=("emission",), learning_rate=0.15, spp=2,
                              max_depth=2, use_bvh=False, seed=5, log_emission=True,
                              unbiased_loss=unb, device="cpu")
        inv.run(40)
        rec = inv.current_scene().emission.numpy()
        ratios[unb] = float((rec[rows] / true_e[rows]).mean())
    assert ratios[True] > ratios[False] + 0.05, ratios


def _two_views(scene):
    cam0 = scene.camera
    tw = np.array(cam0.to_world, np.float32).copy()
    tw[3, 0] += 0.35  # second view: the eye slid sideways
    cam1 = dataclasses.replace(cam0, to_world=tw)
    return [(cam, _target(scene, 4, 4, cam)[1]) for cam in (cam0, cam1)]


def test_multi_view_round_robin():
    scene = sphere_in_box(width=RES, height=RES)
    views = _two_views(scene)
    assert np.abs(views[0][1] - views[1][1]).max() > 1e-3
    true_e = scene.build(device="cpu").emission.numpy()[3].copy()
    inv = InverseRenderer(_dim_lamp(), None, trainable=("emission",), learning_rate=0.5,
                          spp=2, max_depth=2, use_bvh=False, seed=1, views=views, device="cpu")
    assert inv._n_views == 2
    losses = inv.run(80)
    assert np.mean(losses[-10:]) < losses[0] * 0.6, losses[::10]
    np.testing.assert_allclose(inv.params["emission"].detach().numpy()[3], true_e, rtol=0.3)


def test_arguments_refused():
    scene = sphere_in_box(width=RES, height=RES)
    img = np.zeros((RES, RES, 3), np.float32)
    bad_cam = dataclasses.replace(scene.camera, width=8, height=8)
    with pytest.raises(ValueError, match="resolution"):
        InverseRenderer(scene, None, trainable=("emission",), spp=2, max_depth=2,
                        use_bvh=False, device="cpu",
                        views=[(scene.camera, img), (bad_cam, np.zeros((8, 8, 3)))])
    with pytest.raises(ValueError, match="not trainable"):
        InverseRenderer(scene, img, trainable=("tri_mat",), device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        InverseRenderer(scene, img, n_devices=0, device="cpu")  # a mesh of no device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InverseRenderer(scene, img)  # the default device is cuda


def test_checkpoint_resume_continues_the_run(tmp_path):
    scene = sphere_in_box(width=RES, height=RES)
    _, target = _target(scene, 4, 4)

    def make():
        return InverseRenderer(_dim_lamp(), target, trainable=("emission", "lobe_weight"),
                               learning_rate=0.1, spp=2, max_depth=2, use_bvh=False, seed=3,
                               log_emission=True, unbiased_loss=True, device="cpu")

    whole = make()
    whole.run(5)
    first = make()
    first.run(3)
    path = str(tmp_path / "optimizer.npz")
    first.save_checkpoint(path)
    ck = np.load(path)
    assert int(ck["step"]) == 3 and ck["key"].dtype == np.uint32 and ck["key"].shape == (2,)
    assert sorted(k for k in ck.files if k.startswith("opt_")) == [f"opt_{i}" for i in range(5)]
    assert int(ck["opt_0"]) == 3
    resumed = make()
    resumed.load_checkpoint(path)
    resumed.run(2)
    assert resumed._step_count == 5
    np.testing.assert_array_equal(resumed.key, whole.key)
    for k in whole.params:
        np.testing.assert_allclose(resumed.params[k].detach().numpy(),
                                   whole.params[k].detach().numpy(), rtol=0, atol=1e-6)


def test_other_optimizer_and_previews():
    scene = sphere_in_box(width=RES, height=RES)
    _, target = _target(scene, 4, 4)
    inv = InverseRenderer(_dim_lamp(), target, trainable=("lobe_weight",), spp=2, max_depth=2,
                          use_bvh=False, device="cpu",
                          optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-3))
    before = inv.params["lobe_weight"].detach().clone()
    losses = inv.run(2)
    assert np.isfinite(losses).all()
    assert not torch.equal(before, inv.params["lobe_weight"].detach())
    assert inv.render_current(spp=2).shape == (RES, RES, 3)
    with pytest.raises(NotImplementedError, match="Adam"):
        inv.save_checkpoint("unused.npz")
