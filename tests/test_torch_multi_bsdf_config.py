"""The benchmark's multi_bsdf configuration against the port, on the CPU:
the frozen scene generator (benchmark/scenes/multi_bsdf.py) equals the
port's ``multi_bsdf_scene`` array for array; the benchmark reference's
sheen lobe (benchmark/reference_lobes/) equals the port's bsdf/lobes.py
sheen in value, pdf and sample; and a 64x64, 1-spp, depth-9 render of the
scene through the port's cluster tracer and its eager lobe dispatch
agrees with the reference copy, pixel for pixel, within the cell's
tolerance (1e-4 relative plus 1e-6 absolute: the reference does the
program's arithmetic in the program's order, so the two differ only where
ATen's vectorised and scalar loops round a transcendental apart)."""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import check  # noqa: E402
from reference.scene import Camera  # noqa: E402
from reference.shade import frame  # noqa: E402
from reference.trace import Tracer  # noqa: E402
from reference_lobes import integrator as ref_integrator  # noqa: E402
from reference_lobes import shade as ref_shade  # noqa: E402
from reference_lobes.scene import SHEEN, Tables  # noqa: E402
from scenes import multi_bsdf as frozen  # noqa: E402

from phosphorus_mk2_tpu_torch.bsdf import lobes  # noqa: E402
from phosphorus_mk2_tpu_torch.core import material  # noqa: E402
from phosphorus_mk2_tpu_torch.core.options import Options  # noqa: E402
from phosphorus_mk2_tpu_torch.math import frame as tsf  # noqa: E402
from phosphorus_mk2_tpu_torch.renderer import Renderer  # noqa: E402
from phosphorus_mk2_tpu_torch.scenes import multi_bsdf_scene  # noqa: E402

CONFIG = os.path.join(BENCH, "configs", "multi_bsdf.json")
CELL = os.path.join(BENCH, "workloads", "multi_bsdf.render.json")


def config():
    with open(CONFIG) as f:
        return json.load(f)


def test_the_frozen_scene_is_the_ports_array_for_array():
    sc = multi_bsdf_scene(40, 24)
    fz = frozen.build(40, 24)
    assert len(sc.meshes) == len(fz["meshes"])
    for m, f in zip(sc.meshes, fz["meshes"]):
        assert np.array_equal(m.vertices, f["vertices"]) and m.vertices.dtype == np.float32
        assert np.array_equal(m.faces, f["faces"])
        if f["normals"] is None:
            assert m.normals is None
        else:
            assert np.array_equal(m.normals, f["normals"])
        assert m.smooth == f["smooth"] and sc.materials[m.material].name == f["material"]
    assert np.array_equal(sc.camera.to_world, fz["camera"]["to_world"])
    assert (sc.camera.width, sc.camera.height) == (40, 24)
    assert sum(f["faces"].shape[0] for f in fz["meshes"]) == config()["triangles"] == 4812


def test_the_configurations_materials_are_the_ports():
    sc = multi_bsdf_scene(8, 8)
    want = material.pack_materials(sc.materials)
    cfg = config()
    assert [m["name"] for m in cfg["materials"]] == [m.name for m in sc.materials]
    tb = Tables(frozen.build(8, 8)["meshes"], cfg["materials"], None, "cpu")
    L = tb.L
    assert np.array_equal(tb.lobe_type.numpy(), want["lobe_type"][:, :L])
    assert np.array_equal(tb.lobe_weight.numpy(), want["lobe_weight"][:, :L])
    assert np.array_equal(tb.lobe_param.numpy(), want["lobe_param"][:, :L])
    assert np.array_equal(tb.lobe_flags.numpy(), want["lobe_flags"][:, :L])
    assert np.array_equal(tb.emission.numpy(), want["emission"])
    assert tb.types == [1, 2, 3, 4, 5, 7]  # six lobe types, sheen among them


def _directions(n, seed):
    g = torch.Generator().manual_seed(seed)

    def unit(k):
        return torch.nn.functional.normalize(torch.randn((k, 3), generator=g), dim=-1)

    nrm, wi, wo = unit(n), unit(n), unit(n)
    # most above the surface, and some below
    wi = torch.where((wi * nrm).sum(-1, keepdim=True) < 0, -wi, wi)
    wo = torch.where((wo * nrm).sum(-1, keepdim=True) < 0, -wo, wo)
    wi[: n // 8] = -wi[: n // 8]
    r = torch.rand((n,), generator=g) * 0.99 + 0.01
    r[:4] = torch.tensor([1e-3, 5e-3, 1.0, 1.5])  # the clamp's edges
    u2 = torch.rand((n, 2), generator=g)
    return nrm, wi, wo, r, u2


@pytest.mark.parametrize("seed", [3, 11])
def test_the_reference_sheen_is_the_ports(seed):
    n = 4099
    nrm, wi, wo, r, u2 = _directions(n, seed)
    params = torch.zeros((n, material.NUM_PARAMS))
    params[:, 0] = r
    types = torch.full((n,), SHEEN, dtype=torch.long)
    assert torch.equal(ref_shade.sheen_f(r, frame(nrm), wi, wo),
                       lobes.sheen_f(r, tsf.make_frame(nrm), wi, wo))
    f_p, pdf_p = lobes.eval_lobe(types, params, nrm, wi, wo, present=(SHEEN,))
    f_r, pdf_r = ref_shade.eval_lobe([SHEEN], types, params, nrm, wi, wo)
    assert torch.equal(f_p, f_r) and torch.equal(pdf_p, pdf_r)
    assert (f_p > 0).sum() > n // 2 and torch.isfinite(f_p).all()
    s_p = lobes.sample_lobe(types, params, nrm, wi, u2, present=(SHEEN,))
    s_r = ref_shade.sample_lobe([SHEEN], types, params, nrm, wi, u2)
    for a, b in zip(s_p, s_r):
        assert torch.equal(a, b)


def test_a_cluster_traced_render_agrees_with_the_reference_copy():
    w = h = 64
    seed = 2 ** 31 + 23
    cfg = config()
    with open(CELL) as f:
        cell = json.load(f)
    opts = Options(samples_per_pixel=1, samples_per_pass=1, path_depth=cell["path_depth"],
                   mis=cell["mis"], use_bvh=True, seed=seed)
    r = Renderer(multi_bsdf_scene(w, h), opts, device="cpu")
    assert r.data.bvh is not None and r.max_wavefront >= w * h  # cluster tracer, one chunk
    film = r.render()

    arrays = frozen.build(w, h)
    tb = Tables(arrays["meshes"], cfg["materials"], None, "cpu")
    tracer = Tracer(tb.tri[:, 0:3], tb.tri[:, 3:6], tb.tri[:, 6:9])
    pix = torch.arange(w * h)
    with torch.no_grad():
        c, nrm, a = ref_integrator.film(tb, Camera(arrays["camera"], "cpu"), tracer, pix % w,
                                        pix // w, seed, 1, 1, max_depth=cell["path_depth"],
                                        mis=cell["mis"], strata=1)
    prog = {"color": film["color"].reshape(-1, 3), "normal": film["normal"].reshape(-1, 3),
            "alpha": film["alpha"].reshape(-1)}
    ref = {"color": c.numpy(), "normal": nrm.numpy(), "alpha": a.numpy()}
    got = check.film_numbers(prog, ref, cell["check"]["tol_rel"], cell["check"]["tol_abs"])
    assert got["bad_pixel_share"] == 0.0
    assert (ref["alpha"] > 0).mean() > 0.9 and ref["color"].max() > 0.0
