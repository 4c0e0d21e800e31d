"""High-level render session: device mesh, build, passes, film.

Counterpart of ``phosphorus_mk2_tpu/renderer.py``: "discover" is a device
mesh (``parallel/sharding.make_wave_mesh``: the cards, or shards of the
CPU when the caller asks for it); "preprocess" is ``Scene.build``, the
BVH and cluster tables when ``use_bvh``, copied to each device with a
tracer each; each pass accumulates ``samples_per_pass`` samples into
device-resident sums, every shard's block of pixels in sequential chunks
of at most ``max_wavefront`` pixels (so no device holds more; the JAX
package splits each chunk over the shards instead, and the films are
the same: a pixel's samples do not depend on the wavefront it rides in;
with ``spp_batch`` each trace runs that many times a chunk's pixels);
the film comes back to the host after every pass, all-gathered across
ranks, so that every rank holds all of it.

Checkpoint/resume (absent in the reference, SURVEY.md §5.4): with
``Options.checkpoint_dir`` set, the film sums, the sample counter and the
render's identity stamp are written every ``checkpoint_every`` passes and
at the end (by rank 0), so a killed render resumes exactly, at any shard
count; a stamp that differs from this render's is refused. The file is
the JAX package's ``film_checkpoint.npz``, with the same stamp for the
same scene.
"""
from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import torch

from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh
from phosphorus_mk2_tpu_torch.core.options import Options
from phosphorus_mk2_tpu_torch.core.scene import Scene
from phosphorus_mk2_tpu_torch.integrator.path import BRUTE_MAX_TRIS
from phosphorus_mk2_tpu_torch.parallel.distributed import rank_and_world
from phosphorus_mk2_tpu_torch.parallel.sharding import (
    gather_film,
    gather_sums,
    make_sharded_render,
    make_wave_mesh,
    split_frame,
)
from phosphorus_mk2_tpu_torch.utils.log import Metrics, get_logger
from phosphorus_mk2_tpu_torch.utils.profiling import span, spanned


class Renderer:
    @spanned("setup.session")
    def __init__(self, scene: Scene, options: Options | None = None,
                 n_devices=None, mesh=None, device="cuda"):
        """n_devices: devices of the default 1-D wave mesh (all the cards,
        or one CPU shard, when None; more cards than there are raises).
        mesh: a prebuilt ``parallel.DeviceMesh`` instead (for example
        ``parallel.make_render_mesh()`` under torchrun). device: "cuda"
        (the default), "cuda:k" or "cpu"; asking for CUDA without a card
        raises."""
        self.mesh = mesh if mesh is not None else make_wave_mesh(n_devices, device)
        self.device = self.mesh.devices[0]
        self.scene = scene
        self.options = options or Options()
        o = self.options
        self.data = scene.build(self.device)
        cluster = o.use_bvh and self.data.num_tris > BRUTE_MAX_TRIS
        # with use_bvh and <= 1024 triangles the JAX package builds a BVH
        # it never reads (its brute tracer runs); none is built here
        if cluster:
            self.data = attach_bvh(self.data)
        self.film_strata = max(1, round(math.sqrt(o.samples_per_pixel)))
        self.fn, self.px, self.py, self.n_valid = make_sharded_render(
            self.mesh, self.data, scene.camera, max_depth=o.path_depth,
            use_bvh=o.use_bvh, use_pallas=o.use_pallas, film_strata=self.film_strata,
            mis=o.mis, spp_batch=o.spp_batch, remat=o.remat, tracer_tune=o.tracer_tune,
            aniso_taps=o.aniso_taps,
        )
        self.tracer = self.fn.tracers[self.device]
        # 0 = auto: the JAX package's bounds (the cluster tracer's per-ray
        # tables and row gathers scale with the wavefront)
        self.max_wavefront = o.max_wavefront or ((1 << 17) if cluster else (1 << 20))

    @torch.no_grad()
    def _pass(self, done: int, todo: int, cancel) -> list | None:
        """One accumulation pass over the frame: a list, in mesh order, of
        each shard's sums on its device (a forward render: no graph).
        Each shard's block goes in chunks of max_wavefront pixels, every
        shard's chunk launched before the next chunk. Returns None when
        cancelled between chunks."""
        per = self.px[0].shape[0]
        chunk = self.max_wavefront
        pieces = []
        for s0 in range(0, per, chunk):
            if s0 and cancel is not None and cancel():
                return None
            s1 = min(s0 + chunk, per)
            with span("renderer.chunk"):
                pieces.append(self.fn(self.data, self.options.seed, done, todo,
                                      [p[s0:s1] for p in self.px],
                                      [p[s0:s1] for p in self.py]))
        if len(pieces) == 1:
            return pieces[0]
        return [{k: torch.cat([p[i][k] for p in pieces]) for k in pieces[0][i]}
                for i in range(len(pieces[0]))]

    def passes(self, cancel=None):
        """Yield (film, done_spp) after each accumulation pass.

        film: dict of host numpy arrays color (H, W, 3), normal (H, W, 3)
        and alpha (H, W), each the mean over the samples done so far.
        cancel: optional zero-argument callable polled between passes and
        between wavefront chunks; on cancel the generator returns without
        yielding a partial pass.
        With ``checkpoint_dir`` set the render resumes from its checkpoint
        there, whatever ``checkpoint_every`` says. Across ranks every rank
        runs the passes in step (each film is all-gathered), so cancel
        must answer alike on every rank.
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
            # the pass's span closes before the yield: the caller's work
            # on the film is not the pass's
            with span("renderer.pass"):
                out = self._pass(done, todo, cancel)
                if out is None:
                    return
                sums = out if sums is None else [{k: s[k] + o[k] for k in s}
                                                 for s, o in zip(sums, out)]
                done += todo
                pass_idx += 1
                if (opts.checkpoint_dir and opts.checkpoint_every
                        and pass_idx % opts.checkpoint_every == 0):
                    self._save_checkpoint(sums, done)
                with span("renderer.film_gather"):
                    film = gather_film(sums, self.scene.camera.width,
                                       self.scene.camera.height, done)
            yield film, done
        if opts.checkpoint_dir and opts.checkpoint_every:
            self._save_checkpoint(sums, done)

    def render(self) -> dict:
        """All passes; returns the final film (see ``passes``). With
        ``Options.verbose`` each pass is logged to stderr and one JSON
        ``render`` line (``utils.log.Metrics``: passes, spp, width,
        height, mrays_per_s, wall_s) goes to stdout. Every pass's film is
        copied to the host, so the wall time includes the device's work."""
        log = get_logger("renderer")
        m = Metrics("render")
        film = None
        for film, done in self.passes():
            m.inc("passes")
            if self.options.verbose:
                log.info(f"pass {done}/{self.options.samples_per_pixel} spp")
        if self.options.verbose and film is not None:
            o = self.options
            w, h = self.scene.camera.width, self.scene.camera.height
            rays = w * h * o.samples_per_pixel * o.path_depth * 2
            m.set("spp", o.samples_per_pixel).set("width", w).set("height", h)
            m.set("mrays_per_s", round(rays / max(m.elapsed(), 1e-9) / 1e6, 6))
            m.emit()
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

    def _save_checkpoint(self, sums: list, done: int) -> None:
        """Rank 0 writes the whole frame's sums (no padding) atomically: a
        temporary file, then os.replace."""
        n = self.n_valid
        host = {k: v[:n].numpy() for k, v in gather_sums(sums).items()}
        if rank_and_world()[0] != 0:
            return
        os.makedirs(self.options.checkpoint_dir, exist_ok=True)
        tmp = self._ckpt_path()[: -len(".npz")] + "_tmp"
        np.savez(
            tmp,
            **{k: host[k] for k in ("color", "normal", "alpha")},
            done=done,
            **self._ckpt_stamp(),
        )
        os.replace(tmp + ".npz", self._ckpt_path())

    def _load_checkpoint(self):
        """(each shard's sums on its device, samples done), or (None, 0)
        without a checkpoint. The file's rows past the frame (a JAX
        checkpoint's padding) are dropped. Raises RuntimeError for a
        checkpoint without the stamp fields or with a different stamp."""
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
        sums = [{} for _ in self.mesh.devices]
        for k in ("color", "normal", "alpha"):
            rows = torch.from_numpy(ck[k][: self.n_valid])
            for i, block in enumerate(split_frame(self.mesh, rows)):
                sums[i][k] = block
        return sums, int(ck["done"])
