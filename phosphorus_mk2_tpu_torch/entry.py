"""Dry-run entry points: a single-device forward step and a sharded
training step.

Counterpart of the repo's ``__graft_entry__.py``:

entry(): the forward render step of the flagship configuration
(cornell_box, 32x32, depth 3, the brute tracer, seed 0) and its
arguments.

dryrun_multichip(n): one differentiable TRAINING step over an n-device
mesh — sharded wavefront render through the cluster tracer, pixel loss,
scene-parameter gradients summed over the shards, Adam update — then a
2-pass render with a checkpoint that a fresh ``Renderer`` resumes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phosphorus_mk2_tpu_torch.device import resolve_device


def entry(device="cuda"):
    """Return (fn, example_args) for the single-device forward step:
    ``fn(scene_data, sample_offset)`` -> (1024, 3) colour sums of one
    sample at depth 3."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params
    from phosphorus_mk2_tpu_torch.integrator.path import make_tracer, render_pass
    from phosphorus_mk2_tpu_torch.scenes import cornell_box

    dev = resolve_device(device)
    width = height = 32
    scene = cornell_box(width=width, height=height)
    data = scene.build(dev)  # brute-force tracer: the MT kernels
    cam = camera_to_params(scene.camera, dev)
    tracer = make_tracer(data, use_bvh=False)
    seed = 0

    def forward_step(scene_data, sample_offset):
        out = render_pass(
            scene_data, cam, seed, sample_offset, 1,
            width=width, height=height, max_depth=3, tracer=tracer,
        )
        return out["color"]

    return forward_step, (data, 0)


def dryrun_multichip(n_devices: int, device="cuda", grid: int = 230) -> dict:
    """One sharded differentiable training step on an n-device mesh
    through the production multi-process module (parallel/distributed.py)
    and the production tracer: the cluster tracer with the hierarchical
    front table, texture atlas gathers and NEE/MIS on the 64x64
    textured_terrain_scene (grid 230: ~105k triangles through the native
    SAH builder), then a 2-pass render whose checkpoint a fresh
    ``Renderer`` resumes on the same mesh. On the CPU the mesh is
    n_devices shards of the CPU. Returns the loss, the triangle count and
    the pass the resume started from; raises RuntimeError on a failure."""
    import tempfile

    from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh
    from phosphorus_mk2_tpu_torch.core.options import Options
    from phosphorus_mk2_tpu_torch.parallel import (
        comm_accounting,
        initialize,
        make_render_mesh,
        make_sharded_render,
    )
    from phosphorus_mk2_tpu_torch.parallel.distributed import all_reduce_grads, rank_and_world
    from phosphorus_mk2_tpu_torch.parallel.sharding import pad_to_multiple, split_frame
    from phosphorus_mk2_tpu_torch.renderer import Renderer
    from phosphorus_mk2_tpu_torch.scenes import textured_terrain_scene

    # the production 2-D (host, chip) mesh: the wavefront shards over
    # both axes. Single-process here, so the host axis is a synthetic
    # factorization exercising the 2-D layout.
    dev = resolve_device(device)
    initialize()
    n_host = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_render_mesh(n_devices, host_axis=n_host, device=dev)

    width = height = 64
    scene = textured_terrain_scene(grid=grid, width=width, height=height)
    data = attach_bvh(scene.build(mesh.devices[0]))
    # dense_k=8: engage the hierarchical (supercluster) front table, the
    # path BMW-scale renders take, at this cluster count
    tune = {"dense_k": 8}
    fn, _, _, n_valid = make_sharded_render(
        mesh, data, scene.camera, max_depth=2, use_bvh=True, mis=True, tracer_tune=tune,
    )
    n_pad = pad_to_multiple(n_valid, mesh.size)  # the frame as the mesh splits it

    # inverse-rendering target: a fixed image (zeros suffices for a dry run)
    targets = split_frame(mesh, torch.zeros((n_valid, 3)))
    # trainable params: emission + lobe weights (the BASELINE.json
    # inverse-rendering config) + VERTICES, so the gradient reduction
    # carries the geometry-sized buffer
    params = {f: getattr(data, f).detach().clone().requires_grad_()
              for f in ("emission", "lobe_weight", "vertices")}
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)

    # one step: the replicas of each field are differentiable copies of
    # the one leaf, so autograd sums the shards' gradients into it; across
    # ranks one all-reduce. Mean squared error over the padded frame.
    outs = fn(dataclasses.replace(data, **params), 0, 0, 1)
    loss = sum(((o["color"] - t) ** 2).sum().to(mesh.devices[0])
               for o, t in zip(outs, targets)) / (n_pad * 3)
    loss.backward()
    if rank_and_world()[1] > 1:  # each rank's loss covers its own pixels
        loss_val, = all_reduce_grads(list(params.values()), loss)
    else:
        loss_val = float(loss.detach())
    opt.step()
    if not np.isfinite(loss_val):
        raise RuntimeError(f"dryrun_multichip: non-finite loss {loss_val}")
    for f, p in params.items():
        if not bool(torch.isfinite(p).all()):
            raise RuntimeError(f"dryrun_multichip: the {f} update is not finite")
    n_param = sum(p.numel() for p in params.values())
    acct = comm_accounting(mesh, width, height, n_param, spp=1, max_depth=2)
    tris = data.num_tris
    print(
        f"dryrun_multichip({n_devices}): one training step OK "
        f"(cluster-traced {tris}-tri scene, hierarchical front table, textures, MIS, "
        f"{width}x{height}), loss={loss_val:.6f}; mesh "
        f"{dict(zip(mesh.axis_names, mesh.shape))} on {dev.type}; comm: {acct.summary()}",
        flush=True,
    )

    # --- multi-pass + checkpoint/resume under the SAME 2-D mesh -------
    # Pass 1 renders and checkpoints through the production Renderer
    # session; a FRESH session must pick the stamped checkpoint up at
    # done=1 and finish pass 2.
    with tempfile.TemporaryDirectory() as ckdir:
        opts = Options(
            use_bvh=True, samples_per_pixel=2, samples_per_pass=1,
            path_depth=2, checkpoint_dir=ckdir, checkpoint_every=1,
            tracer_tune=tune,
        )
        gen = Renderer(scene, opts, mesh=mesh).passes()
        _, done1 = next(gen)  # pass 1 only; checkpoint written
        gen.close()
        if done1 != 1:
            raise RuntimeError(f"dryrun_multichip: the first pass ended at {done1} spp")

        films = list(Renderer(scene, opts, mesh=mesh).passes())  # fresh session, same dir
        film2, done2 = films[-1]
        if done2 != 2 or len(films) != 1:
            raise RuntimeError(
                f"dryrun_multichip: the resumed session rendered {len(films)} pass(es) "
                f"to {done2} spp; it must skip the checkpointed pass"
            )
        img = film2["color"]
        if not (np.isfinite(img).all() and img.max() > 0):
            raise RuntimeError("dryrun_multichip: the resumed film is not finite or is black")
    print(
        f"dryrun_multichip({n_devices}): 2-pass checkpoint/resume OK "
        f"through Renderer on the 2-D mesh (stamped film checkpoint, "
        f"resumed at {done1}/2)",
        flush=True,
    )
    return {"loss": loss_val, "tris": tris, "resumed_at": done1}
