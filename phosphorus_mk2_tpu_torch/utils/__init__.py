"""Utilities: profiling, logging, metrics (counterpart of
``phosphorus_mk2_tpu/utils/``)."""
from phosphorus_mk2_tpu_torch.utils.log import (  # noqa: F401
    Metrics,
    get_logger,
    set_level,
)
