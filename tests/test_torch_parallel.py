"""The port's data parallelism (phosphorus_mk2_tpu_torch/parallel/,
Renderer(n_devices=...), InverseRenderer(n_devices=...)) against the JAX
package's, from tests/test_sharding.py and tests/test_distributed.py.

The JAX sharding tests are slow-tiered in full (tests/conftest.py), so
the port is held against JAX's cheap host functions and its unsharded
``render_aovs`` on the 8 virtual CPU devices:

* ``shard_pixels`` at 1, 3 and 8 shards, and on the 2-D mesh, gives
  JAX's px, py and n_valid exactly;
* the sharded render at 1, 2 and 8 shards (and 7, which pads the frame)
  is bit-equal to the unsharded render, brute on sphere_in_box 24x24 and
  with the cluster tracer on the terrain at test_distributed.py's grid
  24. That runs in a child process with ATEN_CPU_CAPABILITY=default: the
  CPU computes a tensor's tail with libm and the rest with SIMD, so a
  lane's last bit can depend on its position (ROADMAP.md Queue 3). The
  films also equal JAX's render_aovs within test_sharding.py's atol 2e-5
  and rtol 1e-4;
* two gloo ranks (one process each, a file:// store, a timeout): the
  all-gathered film equals one process bit for bit, and the all-reduced
  gradient of color.sum() equals one process within 1e-6 of each field's
  max |g| (the sums run in another order);
* InverseRenderer at 2 and 5 shards: losses and parameters after 3 steps
  within 1e-6 of one shard (the loss is sum(err * err) / sum(mask) over
  the padded frame, so only the order of the sums differs).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu.core.options import Options as JOptions
from phosphorus_mk2_tpu.integrator.path import render_aovs as j_render_aovs
from phosphorus_mk2_tpu.parallel import distributed as jdist
from phosphorus_mk2_tpu.parallel import sharding as jsharding
from phosphorus_mk2_tpu.scenes import sphere_in_box as j_sphere_in_box
from phosphorus_mk2_tpu.scenes import terrain_scene as j_terrain_scene
from phosphorus_mk2_tpu_torch import Options, Renderer
from phosphorus_mk2_tpu_torch.optim import InverseRenderer
from phosphorus_mk2_tpu_torch.parallel import distributed as tdist
from phosphorus_mk2_tpu_torch.parallel import sharding as tsharding
from phosphorus_mk2_tpu_torch.scenes import cornell_box, sphere_in_box
from phosphorus_mk2_tpu_torch.tools.rank_parity import spawn

ROOT = str(Path(__file__).resolve().parents[1])
RES = 24
CHILD_ENV = {"ATEN_CPU_CAPABILITY": "default", "OMP_NUM_THREADS": "1"}


@pytest.mark.parametrize("mesh", ["wave1", "wave3", "wave8", "host2x4"])
def test_shard_pixels_equal_jax(mesh):
    w, h = 7, 5  # 35 pixels: padded at 3 and 8 shards
    if mesh == "host2x4":
        jm, tm = jdist.make_render_mesh(8, host_axis=2), tdist.make_render_mesh(8, 2, "cpu")
    else:
        k = int(mesh[4:])
        jm, tm = jsharding.make_wave_mesh(k), tsharding.make_wave_mesh(k, "cpu")
    assert tm.shape == jm.devices.shape and tm.axis_names == jm.axis_names
    jpx, jpy, jn = jsharding.shard_pixels(jm, w, h)
    tpx, tpy, tn = tsharding.shard_pixels(tm, w, h)
    assert tn == jn == w * h and len(tpx) == tm.size
    assert {p.shape[0] for p in tpx} == {jpx.shape[0] // tm.size}
    np.testing.assert_array_equal(torch.cat(tpx).numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(torch.cat(tpy).numpy(), np.asarray(jpy))


def test_make_render_mesh_2d_and_bad_factorization():
    mesh = tdist.make_render_mesh(8, host_axis=2, device="cpu")
    assert mesh.shape == (2, 4) and mesh.axis_names == ("host", "chip") and mesh.size == 8
    assert mesh.devices == (torch.device("cpu"),) * 8 and mesh.first == 0
    with pytest.raises(ValueError, match="factor"):
        tdist.make_render_mesh(8, host_axis=3, device="cpu")
    with pytest.raises(ValueError, match="factor"):
        jdist.make_render_mesh(host_axis=3)
    assert tsharding.make_wave_mesh(device="cpu").shape == (1,)  # one CPU shard by default


@pytest.mark.parametrize("n_params,host_axis,w,h,spp,depth",
                         [(1000, 2, 256, 256, 4, 3), (100, 1, 64, 64, 1, 1),
                          (0, 4, 33, 17, 2, 9), (70000, 8, 512, 512, 16, 4)])
def test_comm_accounting_equals_jax(n_params, host_axis, w, h, spp, depth):
    jm = jdist.make_render_mesh(host_axis=host_axis)
    tm = tdist.make_render_mesh(8, host_axis=host_axis, device="cpu")
    ja = jdist.comm_accounting(jm, w, h, n_param_floats=n_params, spp=spp, max_depth=depth)
    ta = tdist.comm_accounting(tm, w, h, n_param_floats=n_params, spp=spp, max_depth=depth)
    assert ta == tdist.CommAccounting(**vars(ja))
    assert ta.summary() == ja.summary()


def test_initialize_single_process_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.initialize() == (0, 1) == jdist.initialize()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        tdist.initialize(num_processes=2)


_CHILD = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from phosphorus_mk2_tpu_torch import Options, Renderer
from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh
from phosphorus_mk2_tpu_torch.integrator.path import render_aovs
from phosphorus_mk2_tpu_torch.scenes import sphere_in_box, terrain_scene
torch.set_num_threads(1)
assert torch.backends.cpu.get_cpu_capability() == "DEFAULT"
out = {}
for name, make, bvh in (("brute", lambda: sphere_in_box(24, 24), False),
                        ("bvh", lambda: terrain_scene(grid=24, width=24, height=24), True)):
    opts = Options(use_bvh=bvh, samples_per_pixel=2, samples_per_pass=2, path_depth=2)
    scene = make()
    data = scene.build(device="cpu")
    if bvh:
        assert data.num_tris > 1024
        data = attach_bvh(data)
    ref = {k: v.numpy() for k, v in render_aovs(data, scene.camera, options=opts).items()}
    for k in (1, 2, 7, 8):
        r = Renderer(make(), opts, n_devices=k, device="cpu")
        assert len(r.px) == k
        film = r.render()
        for c in ref:
            assert np.array_equal(film[c], ref[c]), (name, k, c)
    out[name] = ref["color"]
np.savez(sys.argv[2], **out)
print("bit-equal")
"""


def test_sharded_render_bit_equal_and_equal_to_jax(tmp_path):
    path = tmp_path / "films.npz"
    res = subprocess.run([sys.executable, "-c", _CHILD, ROOT, str(path)],
                         env={**os.environ, **CHILD_ENV}, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "bit-equal" in res.stdout
    films = np.load(path)
    from phosphorus_mk2_tpu.accel.bvh_builder import attach_bvh

    for name, scene, bvh in (("brute", j_sphere_in_box(width=RES, height=RES), False),
                             ("bvh", j_terrain_scene(grid=24, width=RES, height=RES), True)):
        data = scene.build()
        if bvh:
            data = attach_bvh(data)
        ref = j_render_aovs(data, scene.camera, spp=2, max_depth=2,
                            options=JOptions(use_bvh=bvh, samples_per_pass=2))
        np.testing.assert_allclose(films[name], np.asarray(ref["color"]), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_two_gloo_ranks_equal_one_process(tmp_path):
    job = {"device": "cpu",
           "renders": [{"scene": "cornell_box", "scene_kw": {"width": RES, "height": RES},
                        "options": {"use_bvh": False, "samples_per_pixel": 2,
                                    "samples_per_pass": 2, "path_depth": 3}}],
           "grad": {"scene": "cornell_box", "scene_kw": {"width": RES, "height": RES},
                    "fields": ["emission", "lobe_weight"], "spp": 2, "depth": 3}}
    two = spawn(job, tmp_path / "two", 2, "gloo", 300, CHILD_ENV)
    (one,) = spawn(job, tmp_path / "one", 1, None, 300, CHILD_ENV)
    for rank in two:
        for k in ("film0_color", "film0_normal", "film0_alpha"):
            np.testing.assert_array_equal(rank[k], one[k], err_msg=k)
        for f in job["grad"]["fields"]:
            g, ref = rank[f"grad_{f}"], one[f"grad_{f}"]
            assert np.abs(ref).max() > 0, f
            assert np.abs(g - ref).max() <= 1e-6 * np.abs(ref).max(), f
    assert np.array_equal(two[0]["grad_emission"], two[1]["grad_emission"])


def test_a_failed_rank_fails_the_run(tmp_path):
    job = {"device": "cpu", "renders": [{"scene": "no_such_scene", "options": {}}]}
    with pytest.raises(RuntimeError, match="rank . exited"):
        spawn(job, tmp_path, 2, "gloo", 120, CHILD_ENV)


def test_inverse_renderer_steps_equal_at_any_shard_count():
    torch.set_num_threads(1)
    g = np.random.default_rng(0)
    target = g.uniform(0.0, 0.5, (12, 12, 3)).astype(np.float32)
    runs = {}
    for k in (1, 2, 5):
        s = sphere_in_box(12, 12)
        s.materials[3].emission = tuple(0.3 * float(x) for x in s.materials[3].emission)
        inv = InverseRenderer(s, target, trainable=("emission", "lobe_weight"), learning_rate=0.1,
                              spp=2, max_depth=2, use_bvh=False, seed=1, unbiased_loss=True,
                              log_emission=True, n_devices=k, device="cpu")
        assert inv.mesh.size == k
        runs[k] = (np.array(inv.run(3)), {f: p.detach().numpy().copy()
                                          for f, p in inv.params.items()})
    for k in (2, 5):
        np.testing.assert_allclose(runs[k][0], runs[1][0], rtol=1e-6, atol=0)
        for f, p in runs[1][1].items():
            np.testing.assert_allclose(runs[k][1][f], p, rtol=0, atol=1e-6, err_msg=f)


def test_chunks_and_checkpoints_across_shard_counts(tmp_path):
    """Shards in chunks of max_wavefront pixels give the unchunked film;
    a checkpoint written at 3 shards resumes at 1 and at 8."""
    base = dict(use_bvh=False, samples_per_pixel=4, samples_per_pass=2, path_depth=2)
    full = Renderer(cornell_box(10, 10), Options(**base), device="cpu").render()
    chunked = Renderer(cornell_box(10, 10), Options(**base, max_wavefront=16), n_devices=3,
                       device="cpu")
    assert chunked.px[0].shape[0] == 34  # 100 pixels padded to 102, in chunks of 16
    film = chunked.render()
    for k in full:
        np.testing.assert_allclose(film[k], full[k], rtol=0, atol=1e-6)
    for n_dev in (1, 8):
        ck = tmp_path / f"ck{n_dev}"
        opts = Options(**base, checkpoint_dir=str(ck), checkpoint_every=1)
        _, done = next(Renderer(cornell_box(10, 10), opts, n_devices=3, device="cpu").passes())
        assert done == 2 and np.load(ck / "film_checkpoint.npz")["color"].shape == (100, 3)
        resumed = list(Renderer(cornell_box(10, 10), opts, n_devices=n_dev,
                                device="cpu").passes())
        assert [d for _, d in resumed] == [4]
        for k in full:
            np.testing.assert_allclose(resumed[-1][0][k], full[k], rtol=0, atol=1e-6)


def test_more_cards_than_there_are_raise():
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        with pytest.raises(RuntimeError, match="torch sees"):
            tsharding.make_wave_mesh(n + 1)
        with pytest.raises(RuntimeError, match="names one card"):
            tsharding.make_wave_mesh(2, "cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsharding.make_wave_mesh(2)
    assert jax.device_count() == 8  # the JAX side of these tests: 8 virtual devices
