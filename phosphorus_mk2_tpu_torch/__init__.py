"""phosphorus_mk2_tpu_torch — the PyTorch/CUDA port of phosphorus_mk2_tpu.

A differentiable wavefront path tracer for NVIDIA H100s, held against
the JAX package beside it on the same inputs: forward renders
(``Renderer``), pixel gradients (``integrator.path.render_pass`` with
``trainable=``) and inverse rendering (``InverseRenderer``), with the
pixels sharded over devices and ranks (``parallel/``), and scenes read
from YAML, OBJ, PLY and Alembic files (``io/``). Its layout mirrors the
JAX package (math/, core/, bsdf/, accel/, integrator/, scenes/, io/,
parallel/, renderer.py, optim.py);
the brute-force tracer's Möller-Trumbore kernels and the cluster tracer's
front-table and wave kernels are CUDA C++ for sm_90a (csrc/mt.cu,
csrc/front.cu and csrc/wave.cu, bound in accel/mt.py, accel/front.py and
accel/wave.py). The kernels are primal: gradients flow around the trace.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a card raises. TF32 is switched off for
matrix products and cuDNN: reduced matmul precision routed rays to wrong
triangles on the TPU (phosphorus_mk2_tpu/accel/pallas_front.py:215-231),
and geometry here is float32 throughout.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from phosphorus_mk2_tpu_torch.core.camera import Camera  # noqa: E402
from phosphorus_mk2_tpu_torch.core.options import Options  # noqa: E402
from phosphorus_mk2_tpu_torch.core.scene import Scene, SceneData  # noqa: E402
from phosphorus_mk2_tpu_torch.integrator.path import render, render_aovs  # noqa: E402
from phosphorus_mk2_tpu_torch.optim import InverseRenderer  # noqa: E402
from phosphorus_mk2_tpu_torch.renderer import Renderer  # noqa: E402

__all__ = ["Camera", "InverseRenderer", "Options", "Renderer", "Scene", "SceneData",
           "render", "render_aovs"]
