"""Wavefront sharding over a device mesh.

Counterpart of ``phosphorus_mk2_tpu/parallel/sharding.py``. The JAX
package shards the pixel wavefront over a ``jax.sharding.Mesh`` and lets
XLA place the shards; here the mesh is a small object (``DeviceMesh``)
and the shards are launched one by one:

* the pixel wavefront is split statically into contiguous blocks in mesh
  order, one a shard (the layout of ``P(mesh.axis_names)``): a path
  tracer's cost per pixel is statistically uniform at wavefront scale;
* the scene and its BVH tables are copied once to each distinct device,
  with one tracer a device;
* every shard's pass is launched before any is read, so separate cards
  run at the same time; the sums come back in mesh order and are
  gathered on the host (across ranks with an all-gather);
* gradients: the replicas of a trainable field are made from one leaf
  tensor by a differentiable ``.to(device)``, so autograd sums the
  shards' gradients into the leaf (the chip-axis all-reduce); across
  ranks, one ``all_reduce`` of the gradients after ``backward()`` is the
  host-axis all-reduce (``optim.InverseRenderer``).

On the CPU a mesh holds ``n`` shards of the one CPU device, the
counterpart of the JAX tests' virtual host devices, so the split runs
the same way there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from phosphorus_mk2_tpu_torch.core.camera import camera_to_params
from phosphorus_mk2_tpu_torch.device import resolve_device
from phosphorus_mk2_tpu_torch.integrator.path import make_tracer, render_pass_pixels
from phosphorus_mk2_tpu_torch.parallel.distributed import (
    all_gather_rows,
    local_rank,
    rank_and_world,
)
from phosphorus_mk2_tpu_torch.utils.profiling import spanned


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A device mesh as this process sees it.

    axis_names, shape: the whole mesh's (over every rank). devices: the
    devices of this process's shards, in mesh order (on the CPU the one
    device repeats). first: the flat mesh index of this process's first
    shard (rank * len(devices)).
    """

    axis_names: tuple
    shape: tuple
    devices: tuple
    first: int = 0

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def distinct(self) -> tuple:
        """This process's devices, each once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))


def default_local(device) -> int:
    """Devices a process drives by default: every card of its share of
    the host (torchrun's LOCAL_WORLD_SIZE processes split the cards), one
    named card, or one CPU shard."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return 1
    _, local_world = local_rank()
    per = torch.cuda.device_count() // local_world
    if per < 1:
        raise RuntimeError(
            f"{local_world} processes on this host share {torch.cuda.device_count()} "
            "card(s); name each process's card (device='cuda:k')"
        )
    return per


def local_devices(n_local: int, device) -> list:
    """This process's ``n_local`` devices: shards of the CPU, the one card
    that ``device`` names, or the next ``n_local`` cards of this process's
    share of the host. Raises when there are fewer."""
    dev = resolve_device(device)
    if n_local < 1:
        raise ValueError(f"a mesh needs at least one device, not {n_local}")
    if dev.type == "cpu":
        return [dev] * n_local
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    count = torch.cuda.device_count()
    if dev.index is not None:
        if n_local != 1 or dev.index >= count:
            raise RuntimeError(
                f"device={str(device)!r} names one card, {n_local} were asked for "
                f"(torch sees {count})"
            )
        return [dev]
    lr, _ = local_rank()
    start = lr * n_local
    if start + n_local > count:
        raise RuntimeError(
            f"{n_local} card(s) asked for from card {start} on, but torch sees {count}"
        )
    return [torch.device("cuda", start + i) for i in range(n_local)]


def build_mesh(n_devices, device, shape_of, axis_names) -> DeviceMesh:
    """A mesh of ``n_devices`` over every rank (default: each rank's
    ``default_local``), shaped by ``shape_of(n)``; this process drives the
    rank-th block of n / world shards."""
    rank, world = rank_and_world()
    if n_devices is None:
        n_devices = world * default_local(device)
    if n_devices < 1 or n_devices % world:
        raise ValueError(f"{n_devices} devices do not split over {world} processes")
    shape = tuple(shape_of(n_devices))
    n_local = n_devices // world
    return DeviceMesh(tuple(axis_names), shape, tuple(local_devices(n_local, device)),
                      rank * n_local)


def make_wave_mesh(n_devices: int | None = None, device="cuda") -> DeviceMesh:
    """The 1-D ``("wave",)`` mesh: on CUDA the first ``n_devices`` cards
    (default all of them; more than there are raises), on the CPU
    ``n_devices`` shards of the CPU (default 1). Across ranks, n_devices
    counts every rank's devices."""
    return build_mesh(n_devices, device, lambda n: (n,), ("wave",))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def split_frame(mesh: DeviceMesh, rows: torch.Tensor) -> list:
    """``rows`` (a host tensor, one row a pixel of the frame) padded with
    zeros to a multiple of the mesh size and split in contiguous blocks
    in mesh order (the layout of ``P(mesh.axis_names)``): this process's
    shards' blocks, each on its shard's device."""
    n_pad = pad_to_multiple(rows.shape[0], mesh.size)
    per = n_pad // mesh.size
    full = torch.zeros((n_pad, *rows.shape[1:]), dtype=rows.dtype)
    full[: rows.shape[0]] = rows
    return [full[(mesh.first + i) * per:(mesh.first + i + 1) * per].to(d)
            for i, d in enumerate(mesh.devices)]


def shard_pixels(mesh: DeviceMesh, width: int, height: int):
    """Flat pixel coordinates padded to the mesh size (padded ids render
    pixel (0, 0)) and split as ``split_frame`` splits. Returns (px, py,
    n_valid): lists of this process's shards' int64 coordinates, each on
    its shard's device, and the frame's pixel count."""
    n = width * height
    ids = torch.arange(n, dtype=torch.int64)
    return split_frame(mesh, ids % width), split_frame(mesh, ids // width), n


def on_device(dev: torch.device):
    """The current-device context for ``dev`` (the hand kernels launch on
    the current device's stream)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


class ShardedRender:
    """``fn(data, seed, sample_offset, n_samples, px=None, py=None,
    cam_params=None)`` -> list, in mesh order, of each shard's dict of
    per-pixel sums (color, normal, alpha) on its device.

    data: the scene that was replicated, or a copy of it with some tensor
    fields replaced (trainable leaves): those fields are copied to each
    device with a differentiable ``.to``. px, py: per-shard coordinates
    (default the whole frame's shards). cam_params: another camera's
    parameters (moved to each device), default the mesh's camera.
    """

    def __init__(self, mesh, data, camera, tracer_kw, render_kw):
        self.mesh = mesh
        self.data = data
        self.replicas = {d: (data if d == data.device else data.to(d)) for d in mesh.distinct}
        self.tracers = {d: make_tracer(r, **tracer_kw) for d, r in self.replicas.items()}
        self.cams = {d: camera_to_params(camera, d) for d in mesh.distinct}
        self.px, self.py, self.n_valid = shard_pixels(mesh, camera.width, camera.height)
        self.render_kw = render_kw

    def _scenes(self, data):
        if data is self.data:
            return self.replicas
        changed = {f: getattr(data, f) for f in data.tensor_fields()
                   if getattr(data, f) is not getattr(self.data, f)}
        return {d: dataclasses.replace(r, **{f: v.to(d) for f, v in changed.items()})
                for d, r in self.replicas.items()}

    def __call__(self, data, seed: int, sample_offset: int, n_samples: int, px=None, py=None,
                 cam_params=None):
        px = self.px if px is None else px
        py = self.py if py is None else py
        scenes = self._scenes(data)
        cams = (self.cams if cam_params is None else
                {d: {k: (v.to(d) if torch.is_tensor(v) else v) for k, v in cam_params.items()}
                 for d in self.mesh.distinct})
        out = []
        for i, dev in enumerate(self.mesh.devices):
            with on_device(dev):
                out.append(render_pass_pixels(
                    scenes[dev], cams[dev], seed, sample_offset, n_samples, px[i], py[i],
                    tracer=self.tracers[dev], **self.render_kw))
        return out


@spanned("setup.tracer")
def make_sharded_render(
    mesh: DeviceMesh,
    data,
    camera,
    *,
    max_depth: int,
    use_bvh: bool = True,
    use_pallas: bool = False,
    donate: bool = False,
    film_strata: int = 1,
    mis: bool = False,
    spp_batch: int = 1,
    depth_unroll: int = 1,
    sample_unroll: int = 1,
    remat: bool = False,
    tracer_tune: dict | None = None,
    aniso_taps: int = 0,
    trainable: tuple | None = None,
):
    """The render pass over ``mesh``: returns (fn, px, py, n_valid), fn a
    ``ShardedRender``. data: a SceneData (with its BVH attached when the
    cluster tracer is wanted) on any device. spp_batch, remat and
    trainable are render_pass_pixels' and reach every shard's pass. The
    JAX package's donate (buffer donation to a jitted call), depth_unroll
    and sample_unroll (scan unrolls) are accepted and ignored: the port's
    passes are eager PyTorch, with no jitted buffers to donate and no
    scans to unroll."""
    del donate, depth_unroll, sample_unroll
    fn = ShardedRender(
        mesh, data, camera,
        dict(use_bvh=use_bvh, use_pallas=use_pallas, tracer_tune=tracer_tune),
        dict(max_depth=max_depth, film_strata=film_strata, mis=mis, spp_batch=spp_batch,
             remat=remat, aniso_taps=aniso_taps, trainable=trainable),
    )
    return fn, fn.px, fn.py, fn.n_valid


def gather_sums(sums: list, scale: float | None = None) -> dict:
    """Host tensors of the whole (padded) frame's sums, in mesh order:
    each shard's sums (times ``scale``, on its device) copied to the
    host, then all-gathered across ranks."""
    _, world = rank_and_world()
    out = {}
    for k in sums[0]:
        parts = [(s[k] * scale if scale is not None else s[k]).cpu() for s in sums]
        local = parts[0] if len(parts) == 1 else torch.cat(parts)
        out[k] = all_gather_rows(local) if world > 1 else local
    return out


def gather_film(sums: list, width: int, height: int, spp: int) -> dict:
    """Device->host film gather + spp normalization (the reference's
    film::file_t accumulation, src/film/file.cpp:27-45): host numpy
    color (H, W, 3), normal (H, W, 3), alpha (H, W)."""
    n = width * height
    host = {k: v[:n].numpy() for k, v in gather_sums(sums, 1.0 / spp).items()}
    return {
        "color": host["color"].reshape(height, width, 3),
        "normal": host["normal"].reshape(height, width, 3),
        "alpha": host["alpha"].reshape(height, width),
    }
