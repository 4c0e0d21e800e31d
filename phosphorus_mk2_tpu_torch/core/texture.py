"""Texture system: atlas-packed images with bilinear, trilinear and
anisotropic sampling, procedural noise and lat-long environment lookups.

Counterpart of ``phosphorus_mk2_tpu/core/texture.py`` (reference
src/shaders/texture_node.osl; src/material.cpp:127-129 serves textures
through OSL texture() over an OIIO cache). All scene textures and their
mip pyramids are shelf-packed into one device-resident atlas at scene
build; a lookup is a gather of 4 texels a level plus bilinear weights,
dense over the wavefront.

The host side (``Texture``, ``checkerboard``, ``build_mips``,
``pack_textures``) is numpy, copied as it is. The lookups are PyTorch:
addressing is repeat-wrapped in [0, 1)^2 with floor-mod ``%`` (as in the
JAX package: it differs from ``torch.fmod`` for negative coordinates);
an f16 atlas is gathered in half precision and filtered in float32.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from phosphorus_mk2_tpu_torch.math.rng import _mul32
from phosphorus_mk2_tpu_torch.math.vec import clip, maximum

PROC_IMAGE = 0
PROC_RANDOM = 1    # value noise (reference random_noise_*_node.osl)
PROC_MUSGRAVE = 2  # fractal noise (reference musgrave_noise_3d_node.osl)

_MASK = 0xFFFFFFFF


@dataclasses.dataclass
class Texture:
    """Host-side image, float32 (H, W, 3) scene-linear, or a procedural
    descriptor (the reference's OSL noise nodes become closed-form
    evaluations at the hit uv)."""

    image: np.ndarray = None
    name: str = ""
    procedural: int = PROC_IMAGE
    # procedural params: [scale, octaves, lacunarity, gain]
    proc_params: tuple = (8.0, 4.0, 2.0, 0.5)

    def __post_init__(self):
        if self.procedural != PROC_IMAGE:
            if self.image is None:
                self.image = np.zeros((1, 1, 3), np.float32)
            return
        img = np.asarray(self.image, np.float32)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        if img.shape[-1] == 4:
            img = img[..., :3]
        self.image = np.ascontiguousarray(img)

    @staticmethod
    def random_noise(scale: float = 8.0, name="random"):
        return Texture(procedural=PROC_RANDOM, proc_params=(scale, 0, 0, 0), name=name)

    @staticmethod
    def musgrave(
        scale: float = 4.0, octaves: int = 4, lacunarity: float = 2.0,
        gain: float = 0.5, name="musgrave",
    ):
        return Texture(
            procedural=PROC_MUSGRAVE,
            proc_params=(scale, float(octaves), lacunarity, gain),
            name=name,
        )


def checkerboard(n=8, size=64, a=(1.0, 1.0, 1.0), b=(0.0, 0.0, 0.0)) -> Texture:
    y, x = np.mgrid[0:size, 0:size]
    cells = ((x * n // size) + (y * n // size)) % 2
    img = np.where(cells[..., None] == 0, np.asarray(a), np.asarray(b))
    return Texture(img.astype(np.float32), name="checker")


def _downsample2(img: np.ndarray) -> np.ndarray:
    """2x2 box-filter downsample (odd edges replicate-padded)."""
    h, w = img.shape[:2]
    if h % 2:
        img = np.concatenate([img, img[-1:]], axis=0)
        h += 1
    if w % 2:
        img = np.concatenate([img, img[:, -1:]], axis=1)
        w += 1
    return 0.25 * (
        img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2] + img[1::2, 1::2]
    )


def build_mips(image: np.ndarray) -> list:
    """Full mip chain [L0, L1, ...] down to 1x1 (box filter, the
    OIIO/maketx default the reference inherits through OSL texture())."""
    levels = [np.asarray(image, np.float32)]
    while max(levels[-1].shape[:2]) > 1:
        levels.append(_downsample2(levels[-1]))
    return levels


# default atlas budget: the atlas is device-resident beside the geometry,
# the BVH tables and the tracer's temporaries, with no paging tier
ATLAS_BUDGET_BYTES = 8 << 30


def pack_textures(textures: list, mips: bool = True, dtype: str = "f32",
                  budget_bytes: int = ATLAS_BUDGET_BYTES) -> dict:
    """Shelf-pack textures (and their mip pyramids) into one atlas.

    Returns {"atlas": (AH, AW, 3) f32|f16, "info": (K, L, 4) i32 rows
    (y0, x0, h, w) per mip level (textures with fewer levels repeat
    their deepest level so level indexing never branches), "proc": (K,)
    i32, "proc_params": (K, 4) f32}. K = 0 produces a 1x1 atlas so
    downstream shapes stay valid.

    dtype "f16" halves the atlas bytes and the gather traffic; filtering
    upcasts to f32. budget_bytes: a loud capacity guard on the true
    (shelf-padded) allocation, so an oversized texture set fails at
    build, not mid-render.
    """
    if not textures:
        return {
            "atlas": np.zeros((1, 1, 3), np.float32),
            "info": np.zeros((1, 1, 4), np.int32),
            "proc": np.zeros((1,), np.int32),
            "proc_params": np.zeros((1, 4), np.float32),
        }
    np_dtype = {"f32": np.float32, "f16": np.float16}[dtype]
    itemsize = np.dtype(np_dtype).itemsize
    pyramids = [
        build_mips(t.image) if mips else [np.asarray(t.image, np.float32)]
        for t in textures
    ]
    n_levels = max(len(p) for p in pyramids)
    flat_imgs = [img for p in pyramids for img in p]
    max_w = max(i.shape[1] for i in flat_imgs)
    atlas_w = max(256, 1 << int(np.ceil(np.log2(max_w))))
    # shelf packing over every (texture, level) image
    shelves: list = []  # (y0, height, x_cursor)
    placements = []
    atlas_h = 0
    for img in flat_imgs:
        h, w = img.shape[:2]
        placed = False
        for s in shelves:
            if s[1] >= h and s[2] + w <= atlas_w:
                placements.append((s[0], s[2], h, w))
                s[2] += w
                placed = True
                break
        if not placed:
            shelves.append([atlas_h, h, w])
            placements.append((atlas_h, 0, h, w))
            atlas_h += h
    # capacity guard on the true allocation (shelf padding to atlas_w
    # counts: a raw-texel estimate under-counts by up to ~2x)
    total = atlas_h * atlas_w * 3 * itemsize
    if total > budget_bytes:
        per_tex = [
            sum(i.shape[0] * i.shape[1] for i in p) * 3 * itemsize
            for p in pyramids
        ]
        worst = sorted(
            zip(per_tex,
                (t.name or f"tex{i}" for i, t in enumerate(textures))),
            reverse=True,
        )[:8]
        lines = "\n".join(f"  {name}: {b / 1e9:.2f} GB" for b, name in worst)
        raise ValueError(
            f"texture atlas needs {total / 1e9:.2f} GB "
            f"({atlas_h}x{atlas_w} shelf-packed, {len(textures)} textures "
            f"incl. mips, dtype={dtype}) but the HBM budget is "
            f"{budget_bytes / 1e9:.2f} GB — the atlas is HBM-resident "
            "(no out-of-core paging tier). Largest sources:\n"
            f"{lines}\n"
            "Fix: downscale the sources, pack with dtype='f16' "
            "(Scene.texture_dtype), or raise budget_bytes if the scene "
            "is small."
        )
    atlas = np.zeros((atlas_h, atlas_w, 3), np_dtype)
    info = np.zeros((len(textures), n_levels, 4), np.int32)
    proc = np.zeros((len(textures),), np.int32)
    proc_params = np.zeros((len(textures), 4), np.float32)
    it = iter(zip(flat_imgs, placements))
    for i, (t, pyr) in enumerate(zip(textures, pyramids)):
        for lv in range(n_levels):
            if lv < len(pyr):
                img, (y0, x0, h, w) = next(it)
                atlas[y0 : y0 + h, x0 : x0 + w] = img
            info[i, lv] = (y0, x0, h, w)  # deeper than the chain: repeat last
        proc[i] = t.procedural
        proc_params[i] = t.proc_params
    return {"atlas": atlas, "info": info, "proc": proc, "proc_params": proc_params}


def _bilinear_idx_weights(row, uv, aw: int):
    """Flat atlas indices (..., 4) int64 and bilinear weights (..., 4)
    for one mip row (..., 4) = (y0, x0, h, w)."""
    y0 = row[..., 0].to(torch.float32)
    x0 = row[..., 1].to(torch.float32)
    h = row[..., 2].to(torch.float32)
    w = row[..., 3].to(torch.float32)

    u = uv[..., 0] % 1.0
    v = uv[..., 1] % 1.0
    # v flipped: uv origin bottom-left, image origin top-left
    fx = u * w - 0.5
    fy = (1.0 - v) * h - 0.5
    ix = torch.floor(fx)
    iy = torch.floor(fy)
    tx = fx - ix
    ty = fy - iy

    def flat_idx(ix_, iy_):
        xw = (ix_ % w) + x0
        yw = (iy_ % h) + y0
        return yw.to(torch.int64) * aw + xw.to(torch.int64)

    idx = torch.stack(
        [flat_idx(ix, iy), flat_idx(ix + 1, iy), flat_idx(ix, iy + 1),
         flat_idx(ix + 1, iy + 1)],
        dim=-1,
    )
    wts = torch.stack(
        [(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty], dim=-1
    )
    return idx, wts


def _lod_levels(rows, footprint, n_levels: int):
    """Mip level pair (l0, l1) int64 and blend (N, 1) for a uv-space
    footprint: the texel pitch at level l is 2^l / base size."""
    base = torch.maximum(rows[:, 0, 2], rows[:, 0, 3]).to(torch.float32)
    lod = torch.log2(maximum(footprint, 1e-20) * base)
    lod = clip(lod, 0.0, n_levels - 1.0)
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.clamp(l0 + 1, max=n_levels - 1)
    tl = (lod - l0.to(torch.float32))[..., None]
    return l0, l1, tl


def _sample_aniso(flat, rows, aw: int, n_levels: int, uv, fp: dict):
    """Anisotropic filter: ``taps`` trilinear probes spread along the
    uv-space major-axis vector, box-averaged; the mip level comes from
    the minor axis (the EWA property the reference inherits from OIIO,
    its gaussian weighting approximated by the box line average). All
    taps and both levels ride in one (N, taps * 8) gather."""
    major = fp["major_uv"]  # (N, 2) uv vector, full extent
    taps = int(fp.get("taps", 4))
    # gap-free line sampling: each tap's filter covers major / taps of
    # the line, so the lod axis is max(minor, major / taps)
    major_len = torch.sqrt(maximum((major * major).sum(-1), 1e-20))
    minor = torch.maximum(fp["minor"], major_len / taps)

    l0, l1, tl = _lod_levels(rows, minor, n_levels)
    at = torch.arange(rows.shape[0], device=rows.device)
    row0, row1 = rows[at, l0], rows[at, l1]

    idxs, wts0, wts1 = [], [], []
    for k in range(taps):
        off = (k + 0.5) / taps - 0.5
        uv_k = uv + major * off
        i0, w0 = _bilinear_idx_weights(row0, uv_k, aw)
        i1, w1 = _bilinear_idx_weights(row1, uv_k, aw)
        idxs.extend([i0, i1])
        wts0.append(w0)
        wts1.append(w1)
    idx = torch.cat(idxs, dim=-1)  # (N, taps * 8)
    texels = flat[idx].to(torch.float32)  # an f16 atlas upcasts after the gather
    texels = texels.reshape(idx.shape[0], taps, 2, 4, -1)
    w0 = torch.stack(wts0, dim=1)  # (N, taps, 4)
    w1 = torch.stack(wts1, dim=1)
    c0 = (texels[:, :, 0] * w0[..., None]).sum(dim=-2)  # (N, taps, 3)
    c1 = (texels[:, :, 1] * w1[..., None]).sum(dim=-2)
    per_tap = c0 * (1.0 - tl[:, None]) + c1 * tl[:, None]
    return per_tap.mean(dim=1)


def sample_texture(atlas, info, tex_id, uv, footprint=None):
    """Bilinear (footprint None), trilinear-mip ((N,) footprint) or
    anisotropic (dict footprint) atlas sample. Returns (N, 3) float32.

    tex_id: (N,) integer texture ids (callers mask by tex_id >= 0; -1
    reads texture 0). uv: (N, 2), repeat-wrapped. footprint: optional
    (N,) uv-space sample diameter selecting the mip level pair that
    brackets it; a dict {"minor": (N,), "major_uv": (N, 2), "taps": int}
    asks for the anisotropic filter.
    """
    if info.ndim == 2:  # single-level table
        info = info[:, None]
    aw = atlas.shape[1]
    flat = atlas.reshape(-1, atlas.shape[-1])
    rows = info[torch.clamp(tex_id, min=0).long()]  # (N, L, 4)
    n_levels = info.shape[1]

    if isinstance(footprint, dict) and n_levels > 1:
        return _sample_aniso(flat, rows, aw, n_levels, uv, footprint)
    if isinstance(footprint, dict):
        footprint = footprint["minor"]

    if footprint is None or n_levels == 1:
        idx, wts = _bilinear_idx_weights(rows[:, 0], uv, aw)
        texels = flat[idx].to(torch.float32)  # (N, 4, 3)
        return (texels * wts[..., None]).sum(dim=-2)

    l0, l1, tl = _lod_levels(rows, footprint, n_levels)
    at = torch.arange(rows.shape[0], device=rows.device)
    idx0, w0 = _bilinear_idx_weights(rows[at, l0], uv, aw)
    idx1, w1 = _bilinear_idx_weights(rows[at, l1], uv, aw)
    texels = flat[torch.cat([idx0, idx1], dim=-1)].to(torch.float32)  # both levels
    c0 = (texels[..., :4, :] * w0[..., None]).sum(dim=-2)
    c1 = (texels[..., 4:, :] * w1[..., None]).sum(dim=-2)
    return c0 * (1.0 - tl) + c1 * tl


def direction_to_latlong_uv(d):
    """Equirectangular mapping for environment lookups (y-up)."""
    phi = torch.atan2(d[..., 2], d[..., 0])  # [-pi, pi]
    theta = torch.arccos(clip(d[..., 1], -1.0, 1.0))  # [0, pi]
    u = (phi / (2.0 * math.pi)) + 0.5
    v = 1.0 - theta / math.pi
    return torch.stack([u, v], dim=-1)


# --- procedural evaluation (reference src/shaders/*noise*.osl) ----------

def _hash01(ix, iy, seed: int):
    """Lattice hash -> [0, 1) float32, PCG-style, bit-exact with the JAX
    package's uint32 arithmetic: the words live in int64 masked to 32
    bits after every product and left shift (negative lattice coordinates
    wrap as a uint32 cast does)."""
    x = (_mul32(ix.to(torch.int64) & _MASK, 1664525) + 1013904223) & _MASK
    y = (_mul32(iy.to(torch.int64) & _MASK, 22695477) + (int(seed) & _MASK)) & _MASK
    h = _mul32(x ^ ((y << 7) & _MASK), 0x9E3779B9)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    mant = (h & 0x007FFFFF) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def value_noise(uv, scale, seed: int = 1):
    """Bilinear value noise in [0, 1), (N,) from (N, 2) uv."""
    q = uv * scale
    i = torch.floor(q)
    f = q - i
    f = f * f * (3.0 - 2.0 * f)  # smoothstep
    ix = i[..., 0].to(torch.int32)
    iy = i[..., 1].to(torch.int32)
    a = _hash01(ix, iy, seed)
    b = _hash01(ix + 1, iy, seed)
    c = _hash01(ix, iy + 1, seed)
    d = _hash01(ix + 1, iy + 1, seed)
    top = a * (1 - f[..., 0]) + b * f[..., 0]
    bot = c * (1 - f[..., 0]) + d * f[..., 0]
    return top * (1 - f[..., 1]) + bot * f[..., 1]


def musgrave_noise(uv, scale, octaves: int, lacunarity, gain):
    """Fractal (fBm) value noise, fixed octave unroll."""
    out = torch.zeros(uv.shape[:-1], dtype=torch.float32, device=uv.device)
    amp = 1.0
    freq = scale
    norm = 0.0
    for o in range(int(octaves)):
        out = out + amp * value_noise(uv, freq, seed=11 + o)
        norm += amp
        amp = amp * gain
        freq = freq * lacunarity
    return out / max(norm, 1e-9)


def sample_texture_any(tex_tables: dict, tex_id, uv, footprint=None):
    """Image-or-procedural texture sample. tex_tables holds the atlas,
    info, proc and proc_params tensors. Returns (N, 3). Callers gate on
    the scene's has_procedural flag. Procedurals are evaluated
    analytically (not band-limited; the footprint filters images only),
    and the musgrave branch uses 4 octaves, lacunarity 2 and gain 0.5
    whatever the texture's own parameters say, as the JAX package does."""
    img = sample_texture(tex_tables["atlas"], tex_tables["info"], tex_id, uv,
                         footprint=footprint)
    tid = torch.clamp(tex_id, min=0).long()
    proc = tex_tables["proc"][tid]
    pp = tex_tables["proc_params"][tid]
    rnd = value_noise(uv, pp[..., 0:1])
    mus = musgrave_noise(uv, pp[..., 0:1], 4, 2.0, 0.5)
    out = torch.where((proc == PROC_RANDOM)[..., None], rnd[..., None], img)
    return torch.where((proc == PROC_MUSGRAVE)[..., None], mus[..., None], out)
