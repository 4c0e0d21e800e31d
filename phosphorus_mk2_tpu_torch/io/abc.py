"""Pure-Python Alembic (AbcCoreOgawa) archive reader/writer.

Counterpart of ``phosphorus_mk2_tpu/io/abc.py``, a copy: the port
writes the same bytes and reads the same archives.

Replaces the Alembic SDK the reference links against (reference
src/codecs/scene/alembic.hpp — 321 LoC over the SDK). This module
implements the subset the reference importer actually consumes:
**static (single-sample) archives** of IXform / IPolyMesh / ICamera /
IFaceSet — the reference reads only sample 0 of every property
(alembic.hpp:156-257 uses default sample selectors throughout).

Layer layout (on top of the Ogawa container, io/ogawa.py):

  root group children (6):
      0: data uint32    AbcCoreOgawa file version (0)
      1: data uint32    Alembic library version (e.g. 10708 = 1.7.8)
      2: group          top object ("ABC")
      3: data string    archive metadata
      4: data           serialized time samplings (empty = default uniform)
      5: data           indexed metadata strings

  object group:
      child 0           compound-property group (the object's .prop data)
      children 1..N-2   child object groups
      child N-1         data: child object headers
                        (per child: uint32 name len + name + metadata;
                         trailing hash bytes ignored)

  compound property group:
      children 0..N-2   per-sub-property group
      child N-1         data: property headers (see _decode_prop_headers)

  scalar property group:   child i = sample i data (16-byte key + bytes)
  array property group:    child 2i = sample payload (16-byte key + bytes)
                           child 2i+1 = dims as uint64s (empty = rank 1)

  metadata in headers: uint8 index into the indexed-metadata table, or
  0xff followed by uint32 length + chars (this writer always inlines).

FIDELITY NOTE: the Ogawa container layer follows the published layout
exactly; the property-info bit packing (_encode_prop_info) is
reconstructed from Alembic's AbcCoreOgawa WriteUtil/ReadUtil semantics.
No Alembic binding or ground-truth archive exists in this environment
(zero egress, no PyAlembic, no Blender), so cross-validation against
SDK-written archives is impossible here; correctness is established by
writer/reader round-trip tests (tests/test_abc.py) and the parser is
deliberately tolerant (unknown fields, trailing bytes and unknown
schemas are skipped, never fatal).
"""
from __future__ import annotations

import struct

import numpy as np

from phosphorus_mk2_tpu_torch.io.ogawa import (
    EMPTY_DATA,
    EMPTY_GROUP,
    OgawaReader,
    OgawaWriter,
    is_data,
    is_empty,
)

# Util::PlainOldDataType
POD_BOOL = 0
POD_UINT8 = 1
POD_INT8 = 2
POD_UINT16 = 3
POD_INT16 = 4
POD_UINT32 = 5
POD_INT32 = 6
POD_UINT64 = 7
POD_INT64 = 8
POD_FLOAT16 = 9
POD_FLOAT32 = 10
POD_FLOAT64 = 11
POD_STRING = 12
POD_WSTRING = 13  # wide string: 32-bit code units (Alembic Util::wstring)

_POD_NP = {
    POD_BOOL: np.bool_,
    POD_UINT8: np.uint8,
    POD_INT8: np.int8,
    POD_UINT16: np.uint16,
    POD_INT16: np.int16,
    POD_UINT32: np.uint32,
    POD_INT32: np.int32,
    POD_UINT64: np.uint64,
    POD_INT64: np.int64,
    POD_FLOAT16: np.float16,
    POD_FLOAT32: np.float32,
    POD_FLOAT64: np.float64,
}
_NP_POD = {np.dtype(v): k for k, v in _POD_NP.items()}

COMPOUND = 0
SCALAR = 1
ARRAY = 2

LIB_VERSION = 10708


def _meta_str(d: dict) -> bytes:
    return ";".join(f"{k}={v}" for k, v in d.items()).encode()


def _parse_meta(s: bytes) -> dict:
    out = {}
    for part in s.decode(errors="replace").split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
    return out


class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.pos)
        self.pos += 4
        return v

    def read(self, n: int) -> bytes:
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return v

    @property
    def remaining(self) -> int:
        return len(self.buf) - self.pos


def _read_name_meta(c: _Cursor, indexed: list[bytes]) -> tuple[str, dict]:
    n = c.u32()
    name = c.read(n).decode(errors="replace")
    idx = c.u8()
    if idx == 0xFF:
        m = c.u32()
        meta = c.read(m)
    else:
        meta = indexed[idx] if idx < len(indexed) else b""
    return name, _parse_meta(meta)


def _write_name_meta(out: bytearray, name: str, meta: dict) -> None:
    nb = name.encode()
    out += struct.pack("<I", len(nb)) + nb
    mb = _meta_str(meta)
    out += bytes([0xFF]) + struct.pack("<I", len(mb)) + mb


# ---------------------------------------------------------------------------
# property headers


class PropHeader:
    def __init__(self, name, ptype, pod=POD_FLOAT32, extent=1, num_samples=1,
                 meta=None):
        self.name = name
        self.ptype = ptype
        self.pod = pod
        self.extent = extent
        self.num_samples = num_samples
        self.meta = meta or {}

    def __repr__(self):
        kind = {COMPOUND: "compound", SCALAR: "scalar", ARRAY: "array"}[self.ptype]
        return f"<Prop {self.name} {kind} pod={self.pod} ext={self.extent}>"


def _encode_prop_info(h: PropHeader) -> bytes:
    """info word + sample bookkeeping. Bit packing (see FIDELITY NOTE):
    bits 0-1 property type; 2-5 POD; 6 has-tsidx; 7 no-repeats;
    8-15 extent; 16 homogenous. Sample counts always written uint32."""
    out = bytearray()
    info = h.ptype & 0x3
    if h.ptype == COMPOUND:
        out += struct.pack("<I", info)
        return bytes(out)
    info |= (h.pod & 0xF) << 2
    info |= 0x0080  # no repeats (every sample distinct — we write 1)
    info |= (h.extent & 0xFF) << 8
    out += struct.pack("<I", info)
    out += struct.pack("<I", h.num_samples)
    return bytes(out)


def _decode_prop_header(c: _Cursor, indexed: list[bytes]) -> PropHeader:
    info = c.u32()
    ptype = info & 0x3
    h = PropHeader("", ptype)
    if ptype != COMPOUND:
        h.pod = (info >> 2) & 0xF
        no_repeats = bool(info & 0x0080)
        has_tsidx = bool(info & 0x0040)
        h.extent = (info >> 8) & 0xFF
        h.num_samples = c.u32()
        if not no_repeats:
            c.u32()  # first changed
            c.u32()  # last changed
        if has_tsidx:
            c.u32()  # time sampling index (static import ignores time)
    h.name, h.meta = _read_name_meta(c, indexed)
    return h


# ---------------------------------------------------------------------------
# reader


class AbcObject:
    """One object node: name, metadata, properties, children."""

    def __init__(self, reader: "AbcReader", word: int, name: str, meta: dict):
        self._r = reader
        self._word = word
        self.name = name
        self.meta = meta

    @property
    def schema(self) -> str:
        return self.meta.get("schema", "")

    def children(self) -> list["AbcObject"]:
        og = self._r.og
        kids = og.group(self._word)
        if len(kids) < 2:
            return []
        headers_word = kids[-1]
        if not is_data(headers_word):
            return []
        c = _Cursor(og.data(headers_word))
        out = []
        for child_word in kids[1:-1]:
            if c.remaining < 5:
                break  # trailing hashes / short header data: stop cleanly
            name, meta = _read_name_meta(c, self._r.indexed_meta)
            out.append(AbcObject(self._r, child_word, name, meta))
        return out

    def properties(self) -> dict:
        """Top compound: {name: (header, group_word)}."""
        og = self._r.og
        kids = og.group(self._word)
        if not kids or is_empty(kids[0]) or is_data(kids[0]):
            return {}
        return self._r.read_compound(kids[0])


def _decode_strings(payload: bytes, h: "PropHeader"):
    """Decode string/wstring sample payloads (Alembic stores strings
    NUL-separated; wstring uses 32-bit code units). A SCALAR string is
    one value (extent strings NUL-joined); an ARRAY of strings returns
    the list. Matches the SDK's StringArraySample layout
    (reference alembic.hpp reads faceset names through it)."""
    if h.pod == POD_WSTRING:
        units = np.frombuffer(
            payload[: len(payload) - len(payload) % 4], np.uint32
        )
        parts: list[str] = []
        cur: list[str] = []
        for u in units:
            if u == 0:
                parts.append("".join(cur))
                cur = []
            else:
                cur.append(chr(int(u)) if u <= 0x10FFFF else "�")
        if cur:
            parts.append("".join(cur))
    else:
        parts = [
            p.decode(errors="replace")
            for p in payload.rstrip(b"\x00").split(b"\x00")
        ]
    if h.ptype == ARRAY and (len(parts) != 1):
        return parts
    return parts[0] if parts else ""


class AbcReader:
    def __init__(self, path: str):
        self.og = OgawaReader.open(path)
        root = self.og.group(self.og.root)
        if len(root) < 3:
            raise ValueError("not an Alembic archive (root too small)")
        self.file_version = struct.unpack("<I", self.og.data(root[0]))[0]
        self.lib_version = struct.unpack("<I", self.og.data(root[1]))[0]
        self.indexed_meta: list[bytes] = [b""]
        if len(root) >= 6 and is_data(root[5]):
            c = _Cursor(self.og.data(root[5]))
            while c.remaining > 0:
                n = c.u8()
                self.indexed_meta.append(c.read(n))
        meta = {}
        if len(root) >= 4 and is_data(root[3]):
            meta = _parse_meta(self.og.data(root[3]))
        self.top = AbcObject(self, root[2], "ABC", meta)

    def read_compound(self, group_word: int) -> dict:
        kids = self.og.group(group_word)
        if not kids or not is_data(kids[-1]):
            return {}
        c = _Cursor(self.og.data(kids[-1]))
        out = {}
        for w in kids[:-1]:
            if c.remaining < 5:
                break
            h = _decode_prop_header(c, self.indexed_meta)
            out[h.name] = (h, w)
        return out

    def compound(self, prop) -> dict:
        h, w = prop
        if h.ptype != COMPOUND:
            raise ValueError(f"{h.name} is not a compound")
        return self.read_compound(w)

    def sample(self, prop, index: int = 0):
        """Read one sample of a scalar or array property as a numpy
        array (or a python string for string PODs)."""
        h, w = prop
        kids = self.og.group(w)
        if h.ptype == SCALAR:
            raw = self.og.data(kids[index])
            payload = raw[16:]  # skip the 16-byte sample key
            dims = None
        elif h.ptype == ARRAY:
            raw = self.og.data(kids[2 * index])
            payload = raw[16:] if len(raw) >= 16 else b""
            dims_word = kids[2 * index + 1] if 2 * index + 1 < len(kids) else EMPTY_DATA
            db = self.og.data(dims_word) if is_data(dims_word) else b""
            dims = (
                np.frombuffer(db, np.uint64).astype(np.int64) if db else None
            )
        else:
            raise ValueError(f"{h.name} is a compound")
        if h.pod in (POD_STRING, POD_WSTRING):
            return _decode_strings(payload, h)
        if h.pod not in _POD_NP:
            raise ValueError(
                f"property {h.name!r}: unknown POD type {h.pod}"
            )
        dt = np.dtype(_POD_NP[h.pod])
        arr = np.frombuffer(payload, dt)
        if h.extent > 1:
            arr = arr.reshape(-1, h.extent)
        elif dims is not None and len(dims) > 1:
            arr = arr.reshape(tuple(int(d) for d in dims) + (-1,))[..., 0]
        return arr


# ---------------------------------------------------------------------------
# writer


class AbcWriter:
    """Build a static single-sample archive. Usage:

        w = AbcWriter()
        top = w.object()                        # children appended below
        xf = w.object(parent=top, name="root", schema="AbcGeom_Xform_v3")
        ...
        w.save(path)
    """

    def __init__(self, app: str = "phosphorus_mk2_tpu"):
        self.og = OgawaWriter()
        self.app = app
        self._top = self._node("ABC", {})

    def _node(self, name: str, meta: dict) -> dict:
        return {"name": name, "meta": meta, "props": None, "children": []}

    @property
    def top(self) -> dict:
        return self._top

    def object(self, parent=None, name="", schema="", schema_title="") -> dict:
        meta = {}
        if schema:
            meta["schema"] = schema
            meta["schemaObjTitle"] = schema_title or f"{schema}:.geom"
        node = self._node(name, meta)
        if parent is not None:
            parent["children"].append(node)
        return node

    # properties -----------------------------------------------------------

    def compound(self, name: str, meta: dict | None = None) -> dict:
        return {"h": PropHeader(name, COMPOUND, meta=meta), "children": []}

    def scalar(self, name: str, values, pod=None, meta=None) -> dict:
        arr = np.asarray(values)
        pod = pod if pod is not None else _NP_POD[arr.dtype]
        h = PropHeader(name, SCALAR, pod=pod, extent=arr.size, meta=meta)
        return {"h": h, "samples": [arr]}

    def array(self, name: str, values, extent=None, pod=None, meta=None) -> dict:
        arr = np.asarray(values)
        if extent is None:
            extent = arr.shape[-1] if arr.ndim > 1 else 1
        pod = pod if pod is not None else _NP_POD[arr.dtype]
        h = PropHeader(name, ARRAY, pod=pod, extent=extent, meta=meta)
        return {"h": h, "samples": [arr]}

    # serialization ---------------------------------------------------------

    def _write_prop(self, p: dict) -> int:
        h: PropHeader = p["h"]
        if h.ptype == COMPOUND:
            return self._write_compound(p["children"])
        kids = []
        for s in p["samples"]:
            payload = bytes(16) + np.ascontiguousarray(s).tobytes()
            kids.append(self.og.write_data(payload))
            if h.ptype == ARRAY:
                kids.append(EMPTY_DATA)  # rank-1 dims deduced from size
        return self.og.write_group(kids)

    def _write_compound(self, props: list) -> int:
        kids = []
        headers = bytearray()
        for p in props:
            h: PropHeader = p["h"]
            h.num_samples = len(p.get("samples", [1]))
            kids.append(self._write_prop(p))
            headers += _encode_prop_info(h)
            _write_name_meta(headers, h.name, h.meta)
        kids.append(self.og.write_data(bytes(headers)))
        return self.og.write_group(kids)

    def _write_object(self, node: dict) -> int:
        props_word = (
            self._write_compound(node["props"])
            if node["props"]
            else EMPTY_GROUP
        )
        child_words = []
        headers = bytearray()
        for ch in node["children"]:
            child_words.append(self._write_object(ch))
            _write_name_meta(headers, ch["name"], ch["meta"])
        headers += bytes(32)  # placeholder child hashes (readers skip)
        header_word = self.og.write_data(bytes(headers))
        return self.og.write_group([props_word] + child_words + [header_word])

    def save(self, path: str) -> None:
        top_word = self._write_object(self._top)
        root = self.og.write_group(
            [
                self.og.write_data(struct.pack("<I", 0)),
                self.og.write_data(struct.pack("<I", LIB_VERSION)),
                top_word,
                self.og.write_data(
                    _meta_str(
                        {
                            "_ai_Application": self.app,
                            "_ai_AlembicVersion": "pure-python AbcCoreOgawa",
                        }
                    )
                ),
                self.og.write_data(b""),  # default uniform time sampling
                self.og.write_data(b""),  # no indexed metadata
            ]
        )
        self.og.save(path, root)
