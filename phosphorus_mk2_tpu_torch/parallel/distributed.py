"""Multi-process runtime: process group, (host, chip) mesh, comm accounting.

Counterpart of ``phosphorus_mk2_tpu/parallel/distributed.py`` for
``torch.distributed``:

* ``initialize()`` calls ``torch.distributed.init_process_group`` when the
  launch is multi-process (one process per host, or per card, as torchrun
  starts them) and does nothing for a single process. Every process calls
  it before it builds a mesh.
* ``make_render_mesh()`` is a 2-D mesh with axes ``("host", "chip")``: the
  host axis spans the processes, the chip axis each process's local
  devices. The pixel wavefront is sharded over both axes (pixels never
  communicate), so per-ray traffic never leaves a device; only the film
  gather and the all-reduce of the scene parameters' gradients cross the
  mesh.
* ``comm_accounting()`` gives the bytes of one render or train step on
  each axis, with the JAX package's arithmetic and field names. "ICI"
  names the link between the devices of one host (NVLink or PCIe here)
  and "DCN" the network between hosts.

The JAX package names ``NamedSharding``s for the wavefront
(``wave_spec``, ``wave_sharding``) and for replicated data
(``replicated_sharding``); torch has no such object. The port's mesh
(``parallel/sharding.DeviceMesh``) carries what they say: the wavefront
is split into contiguous blocks in mesh order over every axis, and the
scene is copied whole to each distinct device.

Collectives are explicit about where their tensors live: NCCL reduces
CUDA tensors on the card, gloo reduces CPU tensors (a CUDA tensor goes to
the host first); any other backend raises.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank() -> tuple[int, int]:
    """(local rank, local world size): torchrun's LOCAL_RANK and
    LOCAL_WORLD_SIZE, else every rank on one host."""
    rank, world = rank_and_world()
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout: float | None = None,
) -> tuple[int, int]:
    """Initialise the process group if this looks like a multi-process
    launch.

    Resolution order: the explicit arguments, then torchrun's environment
    (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK), which take the place
    of the JAX package's JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
    JAX_PROCESS_ID. coordinator_address is "host:port" (a tcp:// store) or
    a full init method such as "file:///path" or "tcp://host:port". A
    launch with no coordinator and at most one process does nothing.

    backend: "nccl" when torch sees a CUDA device, else "gloo", unless
    given. timeout: seconds for the group's store and collectives.

    Returns (rank, world size). Idempotent: a second call after a
    successful one returns the current topology.
    """
    if dist.is_initialized():
        return rank_and_world()
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr and port:
            coordinator_address = f"{addr}:{port}"
    if num_processes is None and os.environ.get("WORLD_SIZE") is not None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK") is not None:
        process_id = int(os.environ["RANK"])

    multi = coordinator_address is not None or (num_processes is not None and num_processes > 1)
    if not multi:
        return 0, 1
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process launch needs the coordinator address, the number of "
            f"processes and this process's id (got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r})"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if backend == "nccl":
        lr = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(lr % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, **kw)
    return rank_and_world()


def _collective_device(t: torch.Tensor) -> torch.device:
    backend = dist.get_backend()
    if backend == "nccl":  # a host tensor goes to the current card
        return t.device if t.device.type == "cuda" else torch.device(
            "cuda", torch.cuda.current_device())
    if backend == "gloo":
        return torch.device("cpu")
    raise NotImplementedError(f"collectives on backend {backend!r}")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``t``, on ``t``'s device."""
    buf = t.detach().to(_collective_device(t)).contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(t.device)


def all_reduce_grads(params, *extra) -> list:
    """One all-reduce (sum) over ranks of every parameter's gradient (a
    missing gradient counts as zeros) and of the scalars ``extra``; the
    summed gradients replace ``p.grad``. Returns the summed extras as
    floats."""
    flat = torch.cat([torch.zeros(p.numel(), device=p.device) if p.grad is None
                      else p.grad.reshape(-1) for p in params]
                     + [torch.as_tensor(x, dtype=torch.float32, device=params[0].device)
                        .detach().reshape(1) for x in extra])
    flat = all_reduce_sum(flat)
    at = 0
    for p in params:
        p.grad = flat[at:at + p.numel()].reshape(p.shape).clone()
        at += p.numel()
    return [float(x) for x in flat[at:]]


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each), concatenated along
    dim 0 in rank order, on ``t``'s device."""
    buf = t.detach().to(_collective_device(t)).contiguous()
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, buf)
    return torch.cat(parts).to(t.device)


def make_render_mesh(n_devices: int | None = None, host_axis: int | None = None,
                     device="cuda"):
    """The 2-D ``("host", "chip")`` mesh over the devices of every process.

    n_devices: the devices of the whole mesh (every rank's), default the
    world size times each rank's default devices (``sharding.default_local``).
    host_axis: the host axis's length, default the world size; a single
    process may pass a synthetic factorization (host_axis=2 over 8 CPU
    shards) to run the 2-D layout without a second host. Raises
    ValueError when n_devices does not factor over host_axis.
    """
    from phosphorus_mk2_tpu_torch.parallel.sharding import build_mesh

    _, world = rank_and_world()
    if host_axis is None:
        host_axis = world
    return build_mesh(n_devices, device, lambda n: _factor(n, host_axis), ("host", "chip"))


def _factor(n: int, host_axis: int) -> tuple[int, int]:
    if host_axis < 1 or n % host_axis != 0:
        raise ValueError(f"{n} devices do not factor over host_axis={host_axis}")
    return host_axis, n // host_axis


@dataclass
class CommAccounting:
    """Per-axis bytes moved by ONE render/train step (per step, not per
    bounce: per-ray state never crosses a device)."""

    film_gather_bytes: int  # sharded film -> host (device-to-host, per pass)
    grad_ici_bytes_per_chip: int  # grad all-reduce, chip axis (within a host)
    grad_dcn_bytes_per_host: int  # grad all-reduce, host axis (between hosts)
    compute_rays: int  # rays traced in the same step, for ratio context

    def summary(self) -> str:
        def fmt(b: int) -> str:
            # adaptive units: a small gradient ring must not print as
            # "0.00 MB", and a true zero must differ from a rounded one
            if b == 0:
                return "0 B"
            if b < 1 << 20:
                return f"{b / 1024:.1f} KB"
            return f"{b / 1e6:.2f} MB"

        return (
            f"film gather {fmt(self.film_gather_bytes)}/pass; "
            f"grad all-reduce {fmt(self.grad_ici_bytes_per_chip)}/chip ICI"
            f" + {fmt(self.grad_dcn_bytes_per_host)}/host DCN; "
            f"{self.compute_rays:,} rays of compute "
            f"({self.film_gather_bytes / max(self.compute_rays, 1):.1f} B/ray film)"
        )


def comm_accounting(mesh, width: int, height: int, n_param_floats: int = 0,
                    spp: int = 1, max_depth: int = 1) -> CommAccounting:
    """Communication volume of one sharded render (+ optional grad) step.

    Film: color(3) + normal(3) + alpha(1) float32 sums per pixel leave the
    devices once per pass. Gradients of replicated params are all-reduced
    with a ring per mesh axis: 2*(k-1)/k of the buffer per participant.
    """
    n_pix = width * height
    film = n_pix * 7 * 4
    pbytes = n_param_floats * 4
    shape = dict(zip(mesh.axis_names, mesh.shape))
    n_chip = shape.get("chip", mesh.size)
    n_host = shape.get("host", 1)
    ici = int(2 * (n_chip - 1) / n_chip * pbytes) if n_chip > 1 else 0
    dcn = int(2 * (n_host - 1) / n_host * pbytes) if n_host > 1 else 0
    return CommAccounting(
        film_gather_bytes=film,
        grad_ici_bytes_per_chip=ici,
        grad_dcn_bytes_per_host=dcn,
        compute_rays=n_pix * spp * max_depth * 2,
    )
