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

Under autograd, a call whose only input that requires grad is the lobe
weight takes ``bsdf_f_saving`` / ``bsdf_sample_saving`` (the same
launch, also writing what the weight's gradient needs: each slot's lobe
value, one float and the masks of a hit) and, in the backward,
``bsdf_weight_grad``: the gradient of the call's weight input, bit-equal
to eager autograd's. On CPU tensors the three take their plain versions
(``saving_plain``, ``weight_grad_plain``).
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
        + [(k, ctypes.c_void_p) for k in ("f_out", "wo_out", "pdf_out", "flags_out",
                                           "e_out", "scale_out", "bits_out")]
    )


# GRAD_BITS of csrc/bsdf.cu: slot masks in bits 0-7, bsdf_sample's selected
# slot in bits 8-15 (255: none), its validity in bit 16
SEL_SHIFT, SEL_NONE, VALID_BIT = 8, 255, 1 << 16

# launches of bsdf_eval_kernel (bsdf_f, bsdf_pdf), bsdf_sample_kernel and
# bsdf_weight_grad_kernel
LAUNCHES = counted("bsdf.kernel.LAUNCHES",
                   {"bsdf_eval": 0, "bsdf_sample": 0, "bsdf_weight_grad": 0})

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
    ll, i = ctypes.c_longlong, ctypes.c_int
    lib.bsdf_weight_grad_launch.argtypes = [vp, ll, ll, vp, vp, vp, vp, ll, i, i, i, vp]
    lib.bsdf_weight_grad_launch.restype = ctypes.c_int
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
    return _sample(lobes, n, wi, u2, None)


def _sample(lobes, n, wi, u2, saved):
    lib = build()
    args = _args(lobes, n, wi, u2=u2)
    num = n.shape[0]
    f = torch.empty((num, 3), dtype=torch.float32, device=n.device)
    wo = torch.empty((num, 3), dtype=torch.float32, device=n.device)
    pdf = torch.empty((num,), dtype=torch.float32, device=n.device)
    flags = torch.empty((num,), dtype=torch.int64, device=n.device)
    args.f_out, args.wo_out = f.data_ptr(), wo.data_ptr()
    args.pdf_out, args.flags_out = pdf.data_ptr(), flags.data_ptr()
    if saved is not None:
        _put_saved(args, saved)
    _launch("bsdf_sample", lib.bsdf_sample_launch, args, _stream(n))
    return f, wo, pdf, flags


def _new_saved(lobes: dict, n):
    """The SAVE forward's outputs: (e (N, L), scale (N,), bits (N,) int32)."""
    num, L = n.shape[0], lobes.get("max_lobes", MAX_LOBES)
    return (torch.empty((num, L), dtype=torch.float32, device=n.device),
            torch.empty((num,), dtype=torch.float32, device=n.device),
            torch.empty((num,), dtype=torch.int32, device=n.device))


def _put_saved(args: _Args, saved) -> None:
    args.e_out, args.scale_out, args.bits_out = (t.data_ptr() for t in saved)


def bsdf_f_saving(lobes: dict, n, wi, wo):
    """``bsdf_f`` and what ``bsdf_weight_grad`` reads, in one launch:
    (f (N, 3), (e (N, L) every slot's lobe value, n.wi (N,), bits (N,)
    int32: the active hemisphere-matching slots)). CPU tensors: the plain
    version."""
    if not n.is_cuda:
        return saving_plain(False, lobes, n, wi, wo)
    lib = build()
    args = _args(lobes, n, wi, wo=wo)
    out = torch.empty((n.shape[0], 3), dtype=torch.float32, device=n.device)
    args.f_out = out.data_ptr()
    saved = _new_saved(lobes, n)
    _put_saved(args, saved)
    _launch("bsdf_eval", lib.bsdf_eval_launch, args, 0, _stream(n))
    return out, saved


def bsdf_sample_saving(lobes: dict, n, wi, u2):
    """``bsdf_sample`` and what ``bsdf_weight_grad`` reads, in one launch:
    ((f, wo, pdf, flags), (e (N, L) every slot's lobe value at the sampled
    direction, written where L > 1; the selected lobe's value (N,); bits
    (N,) int32: the folded-in slots, the selected slot, the validity)).
    CPU tensors: the plain version."""
    if not n.is_cuda:
        return saving_plain(True, lobes, n, wi, u2)
    saved = _new_saved(lobes, n)
    return _sample(lobes, n, wi, u2, saved), saved


def bsdf_weight_grad(g, e, scale, bits, slots: int, sample: bool):
    """The gradient of a container call's weight input, (N, slots, 3), from
    the gradient ``g`` (N, 3) of its value and its saving forward's
    ``e``, ``scale`` and ``bits``; one launch, read through ``g``'s
    strides. CPU tensors: the plain version."""
    if not g.is_cuda:
        return weight_grad_plain(g, e, scale, bits, slots, sample)
    num, L = e.shape
    if g.dtype != torch.float32 or g.shape != (num, 3):
        raise ValueError(f"bsdf kernel: the gradient must be float32 ({num}, 3), not "
                         f"{g.dtype} {tuple(g.shape)}")
    if not 1 <= L <= slots <= MAX_LOBES:
        raise ValueError(f"bsdf kernel: {L} lobe slots into {slots} weight slots")
    lib = build()
    out = torch.empty((num, slots, 3), dtype=torch.float32, device=g.device)
    err = lib.bsdf_weight_grad_launch(g.data_ptr(), g.stride(0), g.stride(1), e.data_ptr(),
                                      scale.data_ptr(), bits.data_ptr(), out.data_ptr(), num, L,
                                      slots, int(sample), _stream(g))
    if err != 0:
        raise RuntimeError(f"bsdf kernel launch failed: cudaError {err}")
    LAUNCHES["bsdf_weight_grad"] += 1
    return out


def _pack(mask):
    """(N, L) bools as bits 0 to L-1 of an int32."""
    shift = torch.arange(mask.shape[1], dtype=torch.int32, device=mask.device)
    return (mask.to(torch.int32) << shift).sum(dim=1, dtype=torch.int32)


def saving_plain(sample: bool, lobes: dict, n, wi, x):
    """The plain version of ``bsdf_f_saving`` (``sample`` False, x = wo)
    and ``bsdf_sample_saving`` (True, x = u2): the eager code's outputs,
    and the values its backward reads, from the eager code's own parts."""
    from phosphorus_mk2_tpu_torch.bsdf import bsdf as container

    if not sample:
        e, atl, on = parts = container._bsdf_f_parts(lobes, n, wi, x)
        return container._bsdf_f_sum(lobes, *parts), (e, atl, _pack(on))
    parts = container._bsdf_sample_parts(lobes, n, wi, x)
    onehot, f_s, wo, pdf, flags, valid, use, e = parts
    slot = torch.arange(onehot.shape[1], dtype=torch.int32, device=n.device)
    sel = torch.where(onehot, slot, 0).sum(dim=1, dtype=torch.int32)
    bits = (torch.where(onehot.any(dim=1), sel, SEL_NONE) << SEL_SHIFT) | (
        valid.to(torch.int32) * VALID_BIT)
    if use is None:
        e = torch.zeros((n.shape[0], 1), dtype=torch.float32, device=n.device)
    else:
        bits = bits | _pack(use)
    out = container._bsdf_sample_sum(lobes, parts), wo, torch.where(valid, pdf, 0.0), flags
    return out, (e, f_s, bits)


def weight_grad_plain(g, e, scale, bits, slots: int, sample: bool):
    """The plain version of ``bsdf_weight_grad``: eager autograd's products,
    in its order (csrc/bsdf.cu ``bsdf_weight_grad_kernel``)."""
    num, L = e.shape
    mask = ((bits[:, None] >> torch.arange(L, device=g.device)) & 1).bool()[..., None]
    pad = torch.zeros((num, slots - L, 3), dtype=g.dtype, device=g.device)
    if not sample:
        return torch.cat([(torch.where(mask, g[:, None, :], 0.0) * scale[:, None, None])
                          * e[..., None], pad], dim=1)
    g1 = torch.where(((bits & VALID_BIT) != 0)[:, None], g, 0.0)
    sel = (bits >> SEL_SHIFT) & 0xFF
    on = sel[:, None] == torch.arange(slots, device=g.device)[None, :]
    picked = torch.where(on[..., None], (g1 * scale[:, None])[:, None, :], 0.0)
    if L == 1:
        return picked
    return picked + torch.cat([torch.where(mask, g1[:, None, :], 0.0) * e[..., None], pad], dim=1)
