"""Carry a scene, and an optimizer's state, across from numpy form.

``scene_data_from_numpy`` turns the leaves of a ``SceneData`` as numpy
arrays (for example those of the JAX package's ``Scene.build()``,
converted with ``numpy.asarray``) plus its static fields into this
package's ``SceneData`` on ``device``, so the two packages can be fed
the same scene. ``adam_state_to_npz`` and ``adam_state_from_npz`` map
Adam's state to and from the JAX package's optimizer checkpoint, so an
inverse-rendering run resumes in either package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phosphorus_mk2_tpu_torch.accel.bvh_builder import cluster_rows
from phosphorus_mk2_tpu_torch.core.scene import SceneData
from phosphorus_mk2_tpu_torch.device import resolve_device


def scene_data_from_numpy(arrays: dict, static: dict, device="cuda") -> SceneData:
    """arrays: field name -> numpy array, for every array field of
    SceneData, and ``bvh`` -> dict of numpy arrays (every table of
    ``attach_bvh``; the ``cluster_rows`` and ``cluster_rows_bf16`` tables
    are added when absent); static: field name -> value for
    SceneData.STATIC_FIELDS. Texture fields (atlas, info, proc tables,
    tangents and the texture ids) come across like any other array; an
    f16 atlas stays f16. A bfloat16 array (the JAX package's ``*_bf16``
    tables reach numpy as ml_dtypes' bfloat16, which torch cannot take)
    is carried bit for bit through a 16-bit integer view."""
    dev = resolve_device(device)
    names = {f.name for f in dataclasses.fields(SceneData)}
    unknown = (set(arrays) | set(static)) - names
    if unknown:
        raise ValueError(f"not SceneData fields: {sorted(unknown)}")

    def on_dev(v):
        v = np.array(v)  # a writable copy
        if v.dtype.name == "bfloat16":
            return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(v).to(dev)

    tensors = {k: on_dev(v) for k, v in arrays.items() if k != "bvh" and v is not None}
    if arrays.get("bvh") is not None:
        bvh = {k: on_dev(v) for k, v in arrays["bvh"].items()}
        # the gathered layout of the same geometry, which attach_bvh adds
        if "cluster_rows" not in bvh:
            bvh["cluster_rows"] = torch.from_numpy(cluster_rows(
                *(np.asarray(arrays["bvh"][k]) for k in ("cluster_a", "cluster_e0",
                                                          "cluster_e1")))).to(dev)
        if "cluster_rows_bf16" not in bvh:
            bvh["cluster_rows_bf16"] = bvh["cluster_rows"].to(torch.bfloat16)
        tensors["bvh"] = bvh
    fixed = {k: tuple(v) if k == "lobe_types_present" else v for k, v in static.items()}
    return SceneData(**tensors, **fixed)


def adam_state_to_npz(*, step: int, key, params: dict, count: int, exp_avg: dict,
                      exp_avg_sq: dict) -> dict:
    """The arrays of the JAX package's optimizer checkpoint
    (``InverseRenderer.save_checkpoint``) from Adam's state: ``step``,
    ``key`` (two uint32 words), ``param_<name>``, and ``opt_<i>`` in
    optax.adam's leaf order: the int32 count, then mu (torch's exp_avg),
    then nu (exp_avg_sq), each over the sorted parameter names."""
    names = sorted(params)
    leaves = ([np.asarray(count, np.int32)]
              + [np.asarray(exp_avg[k], np.float32) for k in names]
              + [np.asarray(exp_avg_sq[k], np.float32) for k in names])
    return {
        "step": np.asarray(step),
        "key": np.asarray(key, np.uint32),
        **{f"param_{k}": np.asarray(params[k]) for k in names},
        **{f"opt_{i}": leaf for i, leaf in enumerate(leaves)},
    }


def adam_state_from_npz(ck, names) -> dict:
    """Adam's state from an optimizer checkpoint of either package (see
    ``adam_state_to_npz``): {"step", "key", "params", "count", "exp_avg",
    "exp_avg_sq"}, arrays as numpy. names: the trainable fields; a file
    whose parameters or leaf count differ raises ValueError."""
    names = sorted(names)
    stored = sorted(k[len("param_"):] for k in ck.files if k.startswith("param_"))
    n_opt = sum(k.startswith("opt_") for k in ck.files)
    if stored != names or n_opt != 1 + 2 * len(names):
        raise ValueError(
            f"checkpoint holds parameters {stored} and {n_opt} optimizer leaves; "
            f"Adam over {names} needs {1 + 2 * len(names)}"
        )
    m = len(names)
    return {
        "step": int(ck["step"]),
        "key": np.asarray(ck["key"], np.uint32),
        "params": {k: np.asarray(ck[f"param_{k}"]) for k in names},
        "count": int(ck["opt_0"]),
        "exp_avg": {k: np.asarray(ck[f"opt_{1 + i}"]) for i, k in enumerate(names)},
        "exp_avg_sq": {k: np.asarray(ck[f"opt_{1 + m + i}"]) for i, k in enumerate(names)},
    }
