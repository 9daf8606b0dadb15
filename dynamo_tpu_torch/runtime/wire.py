"""The wire codec of the distributed runtime: a msgpack subset in pure
Python, with the 4-byte length framing of the broker's connections.

The reference encodes every frame, request and registration with
``msgpack`` (``dynamo_tpu/runtime/transports/dynstore.py``, ``network.py``,
``component.py``, ``client.py``); the card's machine has no ``msgpack``,
so the port carries this codec. It is byte-compatible with the reference
on the types the runtime sends, so the two packages talk to each other:

- ``packb(obj)`` gives the bytes of ``msgpack.packb(obj, use_bin_type=True)``
  for nil, bool, int (-2**63 .. 2**64 - 1: sequence hashes are u64 and go
  out as uint64, never wrapped negative), float (float64), str, bytes /
  bytearray / memoryview (bin), list / tuple (array) and dict (map), each
  in msgpack's smallest form; any other type raises ``TypeError`` and an
  int out of range ``OverflowError``, as msgpack does.
- ``unpackb(data)`` gives what ``msgpack.unpackb(data, raw=False)`` gives:
  str as str, bin as bytes, arrays as lists (so tuples come back as
  lists), float32 and float64 as float, and map keys held to msgpack's
  ``strict_map_key``: a key that is not str or bytes raises
  ``ValueError``. Ext types and trailing bytes raise ``ValueError``.
"""

from __future__ import annotations

import asyncio
import logging
import struct
from typing import Any, List, Optional, Tuple

logger = logging.getLogger(__name__)

_F64 = struct.Struct(">d")
_F32 = struct.Struct(">f")


def _pack_int(n: int, out: List[bytes]) -> None:
    # msgpack's choice: non-negative ints take the unsigned forms, negative
    # ones the smallest signed form
    if n >= 0:
        if n < 0x80:
            out.append(bytes((n,)))
        elif n <= 0xFF:
            out.append(b"\xcc" + n.to_bytes(1, "big"))
        elif n <= 0xFFFF:
            out.append(b"\xcd" + n.to_bytes(2, "big"))
        elif n <= 0xFFFFFFFF:
            out.append(b"\xce" + n.to_bytes(4, "big"))
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + n.to_bytes(8, "big"))
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -32:
        out.append(bytes((n & 0xFF,)))
    elif n >= -0x80:
        out.append(b"\xd0" + n.to_bytes(1, "big", signed=True))
    elif n >= -0x8000:
        out.append(b"\xd1" + n.to_bytes(2, "big", signed=True))
    elif n >= -0x80000000:
        out.append(b"\xd2" + n.to_bytes(4, "big", signed=True))
    elif n >= -0x8000000000000000:
        out.append(b"\xd3" + n.to_bytes(8, "big", signed=True))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: Optional[int], fix_max: int, codes: Tuple[int, ...],
              what: str, out: List[bytes]) -> None:
    """The header of a str / bin / array / map of ``n`` items: the fix form
    (``fix`` | n) up to ``fix_max``, then the 8- (where there is one), 16-
    and 32-bit length forms in ``codes``."""
    if fix is not None and n <= fix_max:
        out.append(bytes((fix | n,)))
        return
    widths = (1, 2, 4)[-len(codes):]
    for code, width in zip(codes, widths):
        if n < 1 << (8 * width):
            out.append(bytes((code,)) + n.to_bytes(width, "big"))
            return
    raise ValueError(f"{what} is too large")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), "bytes object", out)
        out.append(data)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), "unicode string", out)
        out.append(data)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (0xDE, 0xDF), "dict", out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (0xDC, 0xDD), "list", out)
        for item in obj:
            _pack(item, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes (``msgpack.packb(obj, use_bin_type=True)``)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("unpack(b) received incomplete data")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.uint(1 << (b - 0xC4)))
        if b == 0xCA:
            return _F32.unpack(self.take(4))[0]
        if b == 0xCB:
            return _F64.unpack(self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return self.sint(1 << (b - 0xD0))
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 << (b - 0xDC)))
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 << (b - 0xDE)))
        raise ValueError(f"unsupported msgpack type 0x{b:02x} (ext types "
                         "are not part of the runtime's wire)")

    def text(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if type(key) not in (str, bytes):
                raise ValueError(f"{type(key).__name__} is not allowed for map "
                                 "key when strict_map_key=True")
            out[key] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    """One msgpack object from ``data`` (``msgpack.unpackb(data,
    raw=False)``); trailing bytes raise ``ValueError``."""
    reader = _Reader(bytes(data))
    obj = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("unpack(b) received extra data.")
    return obj


# ------------------------------------------------------------ the framing


async def read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
    """One length-prefixed frame (4-byte big-endian length, then a msgpack
    map); None when the connection ends or the frame does not decode."""
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    length = int.from_bytes(header, "big")
    try:
        body = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    try:
        return unpackb(body)
    except Exception:
        logger.warning("dropping undecodable %d-byte frame", length)
        return None


def write_frame(writer: asyncio.StreamWriter, obj: dict) -> None:
    body = packb(obj)
    writer.write(len(body).to_bytes(4, "big") + body)
