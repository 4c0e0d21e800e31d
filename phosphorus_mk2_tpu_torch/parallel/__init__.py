"""Data parallelism: device meshes, wavefront sharding, the film gather,
multi-process init and comm accounting (counterpart of
``phosphorus_mk2_tpu/parallel/``)."""
from phosphorus_mk2_tpu_torch.parallel.distributed import (  # noqa: F401
    comm_accounting,
    initialize,
    make_render_mesh,
)
from phosphorus_mk2_tpu_torch.parallel.sharding import (  # noqa: F401
    DeviceMesh,
    gather_film,
    make_sharded_render,
    make_wave_mesh,
    shard_pixels,
)
