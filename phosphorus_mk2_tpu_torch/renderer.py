"""High-level render session on one device: build, passes, film.

Counterpart of ``phosphorus_mk2_tpu/renderer.py`` for one CUDA device
(or the CPU when the caller asks for it): "preprocess" is
``Scene.build(device)``, the BVH and cluster tables when ``use_bvh``, and
the tracer's tables; each pass
accumulates ``samples_per_pass`` samples into device-resident sums,
in sequential pixel chunks of at most ``max_wavefront`` rays; the film
comes back to the host after every pass.

Checkpoint/resume (absent in the reference, SURVEY.md §5.4): with
``Options.checkpoint_dir`` set, the film sums, the sample counter and the
render's identity stamp are written every ``checkpoint_every`` passes and
at the end, so a killed render resumes exactly; a stamp that differs
from this render's is refused. The file is the JAX package's
``film_checkpoint.npz``, with the same stamp for the same scene.
"""
from __future__ import annotations

import hashlib
import logging
import math
import os
import time

import numpy as np
import torch

from phosphorus_mk2_tpu_torch.core.camera import camera_to_params
from phosphorus_mk2_tpu_torch.core.options import Options
from phosphorus_mk2_tpu_torch.core.scene import Scene
from phosphorus_mk2_tpu_torch.device import resolve_device
from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh
from phosphorus_mk2_tpu_torch.integrator.path import (
    BRUTE_MAX_TRIS,
    frame_pixels,
    make_tracer,
    render_pass_pixels,
)

log = logging.getLogger(__name__)


class Renderer:
    def __init__(self, scene: Scene, options: Options | None = None,
                 device="cuda"):
        """device: "cuda" (the default) or "cpu"; asking for CUDA without a
        card raises."""
        self.device = resolve_device(device)
        self.scene = scene
        self.options = options or Options()
        o = self.options
        self.data = scene.build(self.device)
        cluster = o.use_bvh and self.data.num_tris > BRUTE_MAX_TRIS
        # with use_bvh and <= 1024 triangles the JAX package builds a BVH
        # it never reads (its brute tracer runs); none is built here
        if cluster:
            self.data = attach_bvh(self.data)
        self.tracer = make_tracer(self.data, o.use_bvh, o.use_pallas,
                                  tracer_tune=o.tracer_tune)
        self.cam_params = camera_to_params(scene.camera, self.device)
        self.px, self.py = frame_pixels(
            scene.camera.width, scene.camera.height, self.device
        )
        self.film_strata = max(1, round(math.sqrt(o.samples_per_pixel)))
        # 0 = auto: the JAX package's bounds (the cluster tracer's per-ray
        # tables and row gathers scale with the wavefront)
        self.max_wavefront = o.max_wavefront or ((1 << 17) if cluster else (1 << 20))

    @torch.no_grad()
    def _pass(self, done: int, todo: int, cancel) -> dict | None:
        """One accumulation pass over the frame, in pixel chunks (a
        forward render: no graph). Returns None when cancelled between
        chunks."""
        n_pix = self.px.shape[0]
        chunk = self.max_wavefront
        pieces = []
        for s0 in range(0, n_pix, chunk):
            if s0 and cancel is not None and cancel():
                return None
            s1 = min(s0 + chunk, n_pix)
            pieces.append(render_pass_pixels(
                self.data, self.cam_params, self.options.seed, done, todo,
                self.px[s0:s1], self.py[s0:s1],
                max_depth=self.options.path_depth, tracer=self.tracer,
                film_strata=self.film_strata, mis=self.options.mis,
                aniso_taps=self.options.aniso_taps,
            ))
        if len(pieces) == 1:
            return pieces[0]
        return {k: torch.cat([p[k] for p in pieces]) for k in pieces[0]}

    def passes(self, cancel=None):
        """Yield (film, done_spp) after each accumulation pass.

        film: dict of host numpy arrays color (H, W, 3), normal (H, W, 3)
        and alpha (H, W), each the mean over the samples done so far.
        cancel: optional zero-argument callable polled between passes and
        between wavefront chunks; on cancel the generator returns without
        yielding a partial pass.
        With ``checkpoint_dir`` set the render resumes from its checkpoint
        there, whatever ``checkpoint_every`` says.
        """
        opts = self.options
        spp = opts.samples_per_pixel
        per_pass = max(1, min(opts.samples_per_pass, spp))
        sums, done = self._load_checkpoint()
        pass_idx = 0
        while done < spp:
            if cancel is not None and cancel():
                return
            todo = min(per_pass, spp - done)
            out = self._pass(done, todo, cancel)
            if out is None:
                return
            sums = out if sums is None else {k: sums[k] + out[k] for k in sums}
            done += todo
            pass_idx += 1
            if (opts.checkpoint_dir and opts.checkpoint_every
                    and pass_idx % opts.checkpoint_every == 0):
                self._save_checkpoint(sums, done)
            yield self._film(sums, done), done
        if opts.checkpoint_dir and opts.checkpoint_every:
            self._save_checkpoint(sums, done)

    def _film(self, sums: dict, spp: int) -> dict:
        inv = 1.0 / spp
        w, h = self.scene.camera.width, self.scene.camera.height
        host = {k: (v * inv).cpu().numpy() for k, v in sums.items()}
        return {
            "color": host["color"].reshape(h, w, 3),
            "normal": host["normal"].reshape(h, w, 3),
            "alpha": host["alpha"].reshape(h, w),
        }

    def render(self) -> dict:
        """All passes; returns the final film (see ``passes``)."""
        t0 = time.perf_counter()
        film = None
        for film, done in self.passes():
            if self.options.verbose:
                log.info("pass %d/%d spp", done, self.options.samples_per_pixel)
        if self.options.verbose and film is not None:
            o = self.options
            w, h = self.scene.camera.width, self.scene.camera.height
            rays = w * h * o.samples_per_pixel * o.path_depth * 2
            secs = time.perf_counter() - t0
            log.info("%s: %.6f Mrays/s", self.device, rays / max(secs, 1e-9) / 1e6)
        return film

    # --- checkpointing ------------------------------------------------

    def _ckpt_path(self) -> str:
        return os.path.join(self.options.checkpoint_dir, "film_checkpoint.npz")

    def _ckpt_stamp(self) -> dict:
        """Identity of the render this film belongs to: a resume whose
        stamp differs would blend incompatible films. The scene hash is
        over the host bytes of the same five arrays as the JAX package's,
        so a scene's stamp is the same in both packages."""
        h = hashlib.sha1()
        for a in (
            self.data.vertices,
            self.data.faces,
            self.data.emission,
            self.data.lobe_weight,
            self.data.lobe_param,
        ):
            h.update(a.cpu().numpy().tobytes())
        o = self.options
        return {
            "scene_hash": h.hexdigest(),
            "width": self.scene.camera.width,
            "height": self.scene.camera.height,
            "spp_target": o.samples_per_pixel,
            "max_depth": o.path_depth,
            "mis": int(o.mis),
            "seed": o.seed,
        }

    def _save_checkpoint(self, sums: dict, done: int) -> None:
        """Write atomically: a temporary file, then os.replace."""
        os.makedirs(self.options.checkpoint_dir, exist_ok=True)
        tmp = self._ckpt_path()[: -len(".npz")] + "_tmp"
        np.savez(
            tmp,
            **{k: sums[k].cpu().numpy() for k in ("color", "normal", "alpha")},
            done=done,
            **self._ckpt_stamp(),
        )
        os.replace(tmp + ".npz", self._ckpt_path())

    def _load_checkpoint(self):
        """(sums on this renderer's device, samples done), or (None, 0)
        without a checkpoint. Raises RuntimeError for a checkpoint
        without the stamp fields or with a different stamp."""
        if not self.options.checkpoint_dir:
            return None, 0
        path = self._ckpt_path()
        if not os.path.exists(path):
            return None, 0
        ck = np.load(path)
        stamp = self._ckpt_stamp()
        legacy = [k for k in stamp if k not in ck]  # a checkpoint without a stamp
        if legacy:
            raise RuntimeError(
                f"checkpoint {path} lacks identity fields {legacy}; "
                "delete it to start fresh"
            )
        bad = {
            k: (str(ck[k]), str(v))
            for k, v in stamp.items()
            if str(ck[k]) != str(v)
        }
        if bad:
            raise RuntimeError(
                f"checkpoint {path} was written by a different render "
                f"(mismatched {bad}); delete it or restore the original "
                "scene/options to resume"
            )
        sums = {k: torch.from_numpy(ck[k]).to(self.device)
                for k in ("color", "normal", "alpha")}
        return sums, int(ck["done"])
