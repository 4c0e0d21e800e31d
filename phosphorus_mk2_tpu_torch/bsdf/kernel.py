"""The lobe container's calls as CUDA kernels (csrc/bsdf.cu): ``bsdf_f``,
``bsdf_pdf`` and ``bsdf_sample`` of bsdf/bsdf.py, each one launch, one
thread a hit, with no sort, no host read and no allocation but the
outputs.

bsdf/bsdf.py takes them for a call on CUDA tensors that autograd need not
record; every other call runs the eager lobe code (bsdf/lobes.py), which
is this module's plain version: the kernels compute its values, bit for
bit, for inputs whose last axis is their fastest (every caller in the
port). The lobe tensors and directions are read through their strides as
the callers hand them over; the lobe types, flags and counts are int64,
everything else float32. Anything else raises ``ValueError``.
``LAUNCHES`` counts each kernel's calls that returned without an error.
"""
from __future__ import annotations

import ctypes

import torch

from phosphorus_mk2_tpu_torch.accel.build import CSRC, NVCC_FLAGS, find_nvcc, load_shared
from phosphorus_mk2_tpu_torch.bsdf.lobes import ALL_TYPES
from phosphorus_mk2_tpu_torch.core.material import MAX_LOBES
from phosphorus_mk2_tpu_torch.utils.profiling import counted

_FIELDS = (
    ("type", 2), ("flags", 2), ("weight", 3), ("param", 3), ("n_lobes", 1),
    ("n", 2), ("wi", 2), ("wo", 2), ("u2", 2),
)


class _Args(ctypes.Structure):
    """csrc/bsdf.cu's ``BsdfArgs``: each tensor's pointer and strides (in
    elements), the counts, and the outputs; every field 8 bytes."""
    _fields_ = (
        [f for name, dims in _FIELDS for f in
         [(name, ctypes.c_void_p)] + [(f"{name}_s{d}", ctypes.c_longlong) for d in range(dims)]]
        + [(k, ctypes.c_longlong) for k in ("lanes", "max_lobes", "sel_slots", "present")]
        + [(k, ctypes.c_void_p) for k in ("f_out", "wo_out", "pdf_out", "flags_out")]
    )


# launches of bsdf_eval_kernel (bsdf_f, bsdf_pdf) and bsdf_sample_kernel
LAUNCHES = counted("bsdf.kernel.LAUNCHES", {"bsdf_eval": 0, "bsdf_sample": 0})

_lib = None
build_log = ""  # nvcc's output (ptxas register, stack and spill report)


def build() -> ctypes.CDLL:
    """Compile csrc/bsdf.cu (once per source and flags) and load it."""
    global _lib, build_log
    if _lib is None:
        lib, build_log = load_shared(CSRC / "bsdf.cu", find_nvcc(), NVCC_FLAGS, "bsdf")
        _lib = bind(lib)
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare a built bsdf.cu's entry points and check that its
    ``BsdfArgs`` is this module's."""
    vp = ctypes.c_void_p
    lib.bsdf_eval_launch.argtypes = [vp, ctypes.c_int, vp]
    lib.bsdf_eval_launch.restype = ctypes.c_int
    lib.bsdf_sample_launch.argtypes = [vp, vp]
    lib.bsdf_sample_launch.restype = ctypes.c_int
    lib.bsdf_geometry.argtypes = [vp, vp]
    lib.bsdf_geometry.restype = None
    size, slots = ctypes.c_longlong(0), ctypes.c_longlong(0)
    lib.bsdf_geometry(ctypes.byref(size), ctypes.byref(slots))
    if (size.value, slots.value) != (ctypes.sizeof(_Args), MAX_LOBES):
        raise RuntimeError(f"bsdf.cu has BsdfArgs of {size.value} bytes and {slots.value} slots; "
                           f"this module {ctypes.sizeof(_Args)} and {MAX_LOBES}")
    return lib


def _put(args: _Args, name: str, t: torch.Tensor, dtype, shape) -> None:
    """Check ``t`` (its dtype; its dims, each at least ``shape``'s) and
    write its pointer and strides into ``args``."""
    if t.dtype != dtype:
        raise ValueError(f"bsdf kernel: {name} must be {dtype}, not {t.dtype}")
    if t.dim() != len(shape) or any(d < s for d, s in zip(t.shape, shape)):
        raise ValueError(f"bsdf kernel: {name} has shape {tuple(t.shape)}, needs {shape}")
    setattr(args, name, t.data_ptr())
    for d in range(t.dim()):
        setattr(args, f"{name}_s{d}", t.stride(d))


def _args(lobes: dict, n, wi, wo=None, u2=None) -> _Args:
    num = n.shape[0]
    L = lobes.get("max_lobes", MAX_LOBES)
    sel = lobes["type"].shape[1]
    if not 1 <= L <= MAX_LOBES or not 1 <= sel <= MAX_LOBES:
        raise ValueError(f"bsdf kernel: 1 to {MAX_LOBES} slots, not {L} ({sel} to select from)")
    slots = max(L, sel)
    tensors = [("type", lobes["type"], torch.int64, (num, slots)),
               ("flags", lobes["flags"], torch.int64, (num, slots)),
               ("weight", lobes["weight"], torch.float32, (num, slots, 3)),
               ("param", lobes["param"], torch.float32, (num, slots, 3)),
               ("n_lobes", lobes["n"], torch.int64, (num,)),
               ("n", n, torch.float32, (num, 3)), ("wi", wi, torch.float32, (num, 3))]
    if wo is not None:
        tensors.append(("wo", wo, torch.float32, (num, 3)))
    if u2 is not None:
        tensors.append(("u2", u2, torch.float32, (num, 2)))
    args = _Args()
    for name, t, dtype, shape in tensors:
        if t.device != n.device:
            raise ValueError(f"bsdf kernel: {name} is on {t.device}, not {n.device}")
        _put(args, name, t, dtype, shape)
    present = lobes.get("present") or ALL_TYPES
    args.lanes, args.max_lobes, args.sel_slots = num, L, sel
    args.present = sum(1 << int(t) for t in set(present) if 0 <= int(t) < 63)
    return args


def _launch(name: str, fn, args: _Args, *extra) -> None:
    err = fn(ctypes.byref(args), *extra)
    if err != 0:
        raise RuntimeError(f"bsdf kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def bsdf_f(lobes: dict, n, wi, wo):
    """bsdf/bsdf.py ``bsdf_f`` in one launch: (N, 3)."""
    lib = build()
    args = _args(lobes, n, wi, wo=wo)
    out = torch.empty((n.shape[0], 3), dtype=torch.float32, device=n.device)
    args.f_out = out.data_ptr()
    _launch("bsdf_eval", lib.bsdf_eval_launch, args, 0, _stream(n))
    return out


def bsdf_pdf(lobes: dict, n, wi, wo):
    """bsdf/bsdf.py ``bsdf_pdf`` in one launch: (N,)."""
    lib = build()
    args = _args(lobes, n, wi, wo=wo)
    out = torch.empty((n.shape[0],), dtype=torch.float32, device=n.device)
    args.f_out = out.data_ptr()
    _launch("bsdf_eval", lib.bsdf_eval_launch, args, 1, _stream(n))
    return out


def bsdf_sample(lobes: dict, n, wi, u2):
    """bsdf/bsdf.py ``bsdf_sample`` in one launch: (f (N, 3), wo (N, 3),
    pdf (N,), flags (N,) int64)."""
    lib = build()
    args = _args(lobes, n, wi, u2=u2)
    num = n.shape[0]
    f = torch.empty((num, 3), dtype=torch.float32, device=n.device)
    wo = torch.empty((num, 3), dtype=torch.float32, device=n.device)
    pdf = torch.empty((num,), dtype=torch.float32, device=n.device)
    flags = torch.empty((num,), dtype=torch.int64, device=n.device)
    args.f_out, args.wo_out = f.data_ptr(), wo.data_ptr()
    args.pdf_out, args.flags_out = pdf.data_ptr(), flags.data_ptr()
    _launch("bsdf_sample", lib.bsdf_sample_launch, args, _stream(n))
    return f, wo, pdf, flags
