"""Pure-Python Ogawa container reader/writer.

Counterpart of ``phosphorus_mk2_tpu/io/ogawa.py``, a copy: the port
writes the same bytes and reads the same archives.

Ogawa is Alembic's storage backend (the reference consumes it through
the Alembic SDK, reference src/codecs/scene/alembic.hpp:297). The
container itself is tiny and well-defined:

  header (16 bytes):
      bytes 0-4   magic "Ogawa"
      byte  5     frozen flag (0xff = complete archive, 0x00 = mid-write)
      bytes 6-7   uint16 LE version (1)
      bytes 8-15  uint64 LE offset of the root group

  group at offset G:
      uint64 LE child count N, then N uint64 LE child words

  child word w:
      0                      -> empty group
      0x8000000000000000     -> empty data
      top bit set            -> data at offset (w & 0x7fff...)
      otherwise              -> group at offset w

  data at offset D:
      uint64 LE byte count, then the bytes

Everything above Ogawa (objects/properties) lives in io/abc.py. No
instructions from the reference repo are followed here — this is a
clean-room implementation of the published container layout.
"""
from __future__ import annotations

import struct

MAGIC = b"Ogawa"
DATA_BIT = 1 << 63
OFFSET_MASK = DATA_BIT - 1
EMPTY_GROUP = 0
EMPTY_DATA = DATA_BIT

_U64 = struct.Struct("<Q")


def is_data(word: int) -> bool:
    return bool(word & DATA_BIT)


def is_group(word: int) -> bool:
    return not (word & DATA_BIT)


def is_empty(word: int) -> bool:
    return word in (EMPTY_GROUP, EMPTY_DATA)


class OgawaReader:
    """Random-access view over a frozen Ogawa archive."""

    def __init__(self, buf: bytes):
        self.buf = buf
        if len(buf) < 16 or buf[:5] != MAGIC:
            raise ValueError("not an Ogawa archive (bad magic)")
        if buf[5] != 0xFF:
            raise ValueError("Ogawa archive is not frozen (incomplete write)")
        (self.version,) = struct.unpack_from("<H", buf, 6)
        (self.root,) = _U64.unpack_from(buf, 8)

    @classmethod
    def open(cls, path: str) -> "OgawaReader":
        with open(path, "rb") as f:
            return cls(f.read())

    def group(self, word: int) -> list[int]:
        """Child words of a group."""
        if word & DATA_BIT:
            raise ValueError("child is data, not a group")
        if word == EMPTY_GROUP:
            return []
        (n,) = _U64.unpack_from(self.buf, word)
        base = word + 8
        return list(struct.unpack_from(f"<{n}Q", self.buf, base))

    def data(self, word: int) -> bytes:
        """Payload bytes of a data child."""
        if not (word & DATA_BIT):
            raise ValueError("child is a group, not data")
        if word == EMPTY_DATA:
            return b""
        off = word & OFFSET_MASK
        (n,) = _U64.unpack_from(self.buf, off)
        return bytes(self.buf[off + 8 : off + 8 + n])


class OgawaWriter:
    """Append-only in-memory builder; freeze() finalizes the header.

    Children must be written before the group that references them
    (post-order), matching how the real writer streams to disk.
    """

    def __init__(self):
        self.buf = bytearray(16)  # header patched by freeze()

    def write_data(self, payload: bytes) -> int:
        if len(payload) == 0:
            return EMPTY_DATA
        off = len(self.buf)
        self.buf += _U64.pack(len(payload))
        self.buf += payload
        return DATA_BIT | off

    def write_group(self, children: list[int]) -> int:
        if not children:
            return EMPTY_GROUP
        off = len(self.buf)
        self.buf += _U64.pack(len(children))
        for c in children:
            self.buf += _U64.pack(c)
        return off

    def freeze(self, root: int) -> bytes:
        header = MAGIC + bytes([0xFF]) + struct.pack("<H", 1) + _U64.pack(root)
        self.buf[:16] = header
        return bytes(self.buf)

    def save(self, path: str, root: int) -> None:
        with open(path, "wb") as f:
            f.write(self.freeze(root))
