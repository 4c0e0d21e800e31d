"""Inverse rendering: recover scene parameters from target images.

Counterpart of ``phosphorus_mk2_tpu/optim.py`` (BASELINE.json config 5:
recover BSDF albedo and light emission through pixel-loss gradients; the
reference renderer is forward-only). The trainable fields become leaf
tensors, are put into the scene for each step with
``dataclasses.replace``, and a ``torch.optim`` optimizer (Adam by
default, the numbers of ``optax.adam``) takes the step. Keys are the
JAX package's threefry keys (math/rng.py), so a run takes the samples
the JAX package's run takes.

With ``n_devices`` (or under torchrun) the render is sharded as the JAX
package shards it: the pixels, the targets and the mask split over a
wave mesh (``parallel/sharding.py``), the parameters replicated on each
device by a differentiable copy from the one leaf (autograd sums the
shards' gradients into it), and across ranks one all-reduce a step of
the gradients and the loss. The loss is normalised over the padded and
masked frame, sum(err * err) / sum(mask), so a step is the same at any
shard count.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh
from phosphorus_mk2_tpu_torch.convert import adam_state_from_npz, adam_state_to_npz
from phosphorus_mk2_tpu_torch.core.camera import camera_to_params
from phosphorus_mk2_tpu_torch.core.options import Options
from phosphorus_mk2_tpu_torch.integrator.path import BRUTE_MAX_TRIS, render_aovs
from phosphorus_mk2_tpu_torch.math import rng
from phosphorus_mk2_tpu_torch.math.vec import maximum
from phosphorus_mk2_tpu_torch.parallel.distributed import all_reduce_grads, rank_and_world
from phosphorus_mk2_tpu_torch.parallel.sharding import (
    make_sharded_render,
    make_wave_mesh,
    split_frame,
)
from phosphorus_mk2_tpu_torch.utils.profiling import count_saved, counted, span, spanned

TRAINABLE_FIELDS = ("emission", "lobe_weight", "lobe_param", "vertices", "normals")

# what autograd saved in the forwards of the steps taken while a
# torch.profiler session was active; one scope a step
SAVED = counted("optim.SAVED", {"bytes": 0, "tensors": 0, "scopes": 0})


class InverseRenderer:
    """Gradient-descent loop recovering scene parameters.

    target: (H, W, 3) image. trainable: subset of TRAINABLE_FIELDS.
    spp: samples per gradient step (fresh RNG per step: a stochastic
    gradient over the path integral).
    """

    @spanned("setup.session")
    def __init__(
        self,
        scene,
        target,
        trainable=("emission", "lobe_weight"),
        *,
        learning_rate: float = 5e-2,
        spp: int = 4,
        max_depth: int = 3,
        use_bvh: bool = True,
        n_devices=None,
        seed: int = 0,
        optimizer=None,
        fresh_rng: bool = True,
        log_emission: bool = False,
        unbiased_loss: bool = False,
        views=None,
        device="cuda",
    ):
        """fresh_rng: new sample paths each step (unbiased stochastic
        gradients); False reuses one path set, which converges to that
        set's noise floor deterministically (useful for tests).
        log_emission: optimize emission in log space (emission =
        exp(theta)), so that Adam's steps are relative.
        unbiased_loss: the double-sample loss, the per-pixel product of
        the residuals of two independent renders of spp/2 each: a single
        render's MSE holds the estimator's variance, which depends on
        the parameters (dimmer lights render with less noise), and
        drives the optimum dark; the product's expectation does not.
        views: optional list of (camera, target image) pairs; step i uses
        view i % V, and ``target`` is ignored. Every view must have the
        primary camera's resolution.
        optimizer: optional callable building a ``torch.optim.Optimizer``
        from the list of parameter tensors (sorted by field name); the
        default is ``torch.optim.Adam(lr=learning_rate)``. Checkpoints
        hold Adam's state.
        n_devices: devices of the wave mesh the render is sharded over
        (``Renderer``'s meaning; None: all the cards, or one CPU shard).
        device: "cuda" (the default), "cuda:k" or "cpu"."""
        for f in trainable:
            if f not in TRAINABLE_FIELDS:
                raise ValueError(f"not trainable: {f}")
        self.mesh = make_wave_mesh(n_devices, device)
        self.device = self.mesh.devices[0]
        self.scene = scene
        self.trainable = tuple(trainable)
        self.spp = spp
        self._max_depth = max_depth
        self._use_bvh = use_bvh

        data = scene.build(self.device)
        # the BVH only where make_tracer takes the cluster tracer
        if use_bvh and data.num_tris > BRUTE_MAX_TRIS:
            data = attach_bvh(data)
        self.data = data
        self._fn, _, _, n_valid = make_sharded_render(
            self.mesh, data, scene.camera, max_depth=max_depth, use_bvh=use_bvh,
            trainable=self.trainable,  # the backward pays for this set only
        )
        self.tracer = self._fn.tracers[self.device]

        view_list = list(views) if views else [(scene.camera, target)]
        self._n_views = len(view_list)
        w, h = scene.camera.width, scene.camera.height
        for vc, _ in view_list:
            if (vc.width, vc.height) != (w, h):
                raise ValueError(
                    f"view resolution {vc.width}x{vc.height} != primary {w}x{h}"
                )
        self._cams = [camera_to_params(vc, self.device) for vc, _ in view_list]
        # targets and mask split as the pixels are; a shard without
        # padding needs no mask
        self._targets = [split_frame(self.mesh, torch.from_numpy(
            np.asarray(vt, np.float32).reshape(-1, 3))) for _, vt in view_list]
        self._masks = [None if bool(m.all()) else m
                       for m in split_frame(self.mesh, torch.ones((n_valid, 1)))]
        self._n_valid = float(n_valid)  # sum(mask)

        self._log_emission = bool(log_emission) and "emission" in self.trainable
        params = {f: getattr(data, f).detach().clone() for f in self.trainable}
        if self._log_emission:
            params["emission"] = torch.log(maximum(params["emission"], 1e-6))
        self.params = {k: params[k].requires_grad_() for k in sorted(params)}
        with span("setup.optimizer"):
            if optimizer is None:
                self.opt = torch.optim.Adam(list(self.params.values()), lr=learning_rate)
            else:
                self.opt = optimizer(list(self.params.values()))
        self.key = rng.key_data(seed)
        self._step_count = 0
        self._unbiased = bool(unbiased_loss)
        self._fresh_rng = fresh_rng

    # --- the step -----------------------------------------------------

    def _fields(self, params):
        fields = dict(params)
        if self._log_emission:
            fields["emission"] = torch.exp(fields["emission"])
        return fields

    def _errors(self, sd, cam, key, n, tgts):
        """Each shard's masked residual of an n-sample render."""
        outs = self._fn(sd, rng.key_seed(key), 0, n, cam_params=cam)
        errs = [o["color"] / n - t for o, t in zip(outs, tgts)]
        return [e if m is None else e * m for e, m in zip(errs, self._masks)]

    def _loss(self, key, view: int):
        sd = dataclasses.replace(self.data, **self._fields(self.params))
        cam, tgts = self._cams[view], self._targets[view]
        if self._unbiased:
            half = max(1, self.spp // 2)
            k1, k2 = rng.split(key)
            e1 = self._errors(sd, cam, k1, half, tgts)
            e2 = self._errors(sd, cam, k2, half, tgts)
            parts = [(a * b).sum() for a, b in zip(e1, e2)]
        else:
            parts = [(e * e).sum() for e in self._errors(sd, cam, key, self.spp, tgts)]
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(self.device)
        return total / self._n_valid

    @spanned("optim.step")
    def step(self) -> float:
        if self._fresh_rng:
            self.key, sub = rng.split(self.key)
        else:
            sub = self.key
        view = self._step_count % self._n_views
        self.opt.zero_grad(set_to_none=True)
        with span("optim.forward"), count_saved(SAVED):
            loss = self._loss(sub, view)
        with span("optim.backward"):
            loss.backward()
        # where the step waits for the card
        with span("optim.loss_readback"):
            if rank_and_world()[1] > 1:  # each rank's loss covers its own pixels
                value, = all_reduce_grads(list(self.params.values()), loss)
            else:
                value = float(loss.detach())
        with span("optim.update"):
            self.opt.step()
        self._step_count += 1
        return value

    def run(self, n_steps: int, log_every: int = 0) -> list:
        losses = []
        for i in range(n_steps):
            loss = self.step()
            losses.append(loss)
            if log_every and (i + 1) % log_every == 0:
                print(f"step {i + 1}: loss={loss:.6f}")
        return losses

    def current_scene(self):
        """The scene with the parameters recovered so far (detached)."""
        with torch.no_grad():
            fields = self._fields({k: v.detach() for k, v in self.params.items()})
        return dataclasses.replace(self.data, **fields)

    def render_current(self, spp: int = 8):
        """(H, W, 3) numpy render of the scene with the recovered
        parameters (previews, convergence checks)."""
        out = render_aovs(
            self.current_scene(), self.scene.camera, spp=spp, max_depth=self._max_depth,
            options=Options(use_bvh=self._use_bvh, samples_per_pass=spp),
        )
        return out["color"].cpu().numpy()

    # --- checkpoint / resume: the JAX package's optimizer file --------

    def _adam(self):
        if not isinstance(self.opt, torch.optim.Adam):
            raise NotImplementedError(
                "optimizer checkpoints hold Adam's state (the JAX package's "
                f"optax.adam layout); this run uses {type(self.opt).__name__}"
            )
        return self.opt

    def save_checkpoint(self, path: str) -> None:
        """Write parameters, Adam's state, the step counter and the key
        as the JAX package's npz (written atomically)."""
        opt = self._adam()
        names = list(self.params)
        states = [opt.state.get(self.params[k], {}) for k in names]
        count = int(states[0]["step"]) if states and "step" in states[0] else 0

        def host(x, like):
            return (np.zeros(tuple(like.shape), np.float32) if x is None
                    else x.detach().cpu().numpy())

        arrays = adam_state_to_npz(
            step=self._step_count, key=self.key,
            params={k: self.params[k].detach().cpu().numpy() for k in names},
            count=count,
            exp_avg={k: host(s.get("exp_avg"), self.params[k]) for k, s in zip(names, states)},
            exp_avg_sq={k: host(s.get("exp_avg_sq"), self.params[k])
                        for k, s in zip(names, states)},
        )
        tmp = path + ".tmp.npz"
        np.savez(tmp[:-4], **arrays)
        os.replace(tmp, path)

    def load_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint of ``save_checkpoint`` or of the JAX
        package's ``InverseRenderer.save_checkpoint`` (the same fields,
        Adam as optax.adam)."""
        opt = self._adam()
        st = adam_state_from_npz(np.load(path), list(self.params))
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(torch.from_numpy(st["params"][k]))
                opt.state[p] = {
                    "step": torch.tensor(float(st["count"]), dtype=torch.float32),
                    "exp_avg": torch.from_numpy(st["exp_avg"][k]).to(p.device),
                    "exp_avg_sq": torch.from_numpy(st["exp_avg_sq"][k]).to(p.device),
                }
        self._step_count = st["step"]
        self.key = st["key"]
