"""Wire framing of the KV transfer plane.

The port's copy of ``dynamo_tpu/transfer/framing.py``: a 4-byte
big-endian length, a header in the runtime's wire codec
(``runtime/wire.py``, byte for byte msgpack's), then the raw payload
bytes the header announces (``k_bytes`` / ``v_bytes``).

Block payloads are a cache's raw bytes. The reference resolves bfloat16
and the float8 names through ``ml_dtypes``; the port carries every block
as its bytes with the dtype's name in the header (the names ml_dtypes and
numpy give: ``float32``, ``bfloat16``, ``float8_e4m3fn``, ...) and views
the received bytes as that torch dtype, so neither ``ml_dtypes`` nor
numpy's dtype table is needed on either side. ``encode_blocks`` copies,
so callers run it in an executor.
"""

from __future__ import annotations

import asyncio
import socket
import struct
from typing import TYPE_CHECKING, Optional, Sequence, Tuple

from ..runtime.wire import packb, unpackb

if TYPE_CHECKING:
    import torch

MAX_HEADER = 1 << 20
# what one event-loop turn may move on a bulk connection (widen_stream)
WIDE_IO_BYTES = 16 << 20

# the dtypes a KV cache holds, by the name the header carries (torch's
# own names; torch is imported where a tensor is packed or viewed, so a
# front that only follows streams never imports it)
DTYPES = ("float32", "bfloat16", "float16", "float8_e4m3fn", "uint8")


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a cache dtype (``torch.bfloat16`` → "bfloat16")."""
    name = str(dtype).removeprefix("torch.")
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r} has no wire form (served: "
                         f"{', '.join(DTYPES)})")
    return name


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire name; an unknown name raises by name."""
    import torch

    if name not in DTYPES:
        raise ValueError(f"unknown block dtype {name!r} on the wire "
                         f"(served: {', '.join(DTYPES)})")
    return getattr(torch, name)


async def read_exact(reader: asyncio.StreamReader, n: int) -> bytes:
    return await reader.readexactly(n)


def widen_stream(writer: asyncio.StreamWriter) -> None:
    """Let one event-loop turn move up to ``WIDE_IO_BYTES`` of a bulk
    connection:
    the socket's send and receive buffers (the kernel caps them at its own
    maximum) and the transport's read size. asyncio's selector transport
    reads 256 KiB a turn, so a loop that runs a decode pass between turns
    (a peer receiving a migration while it decodes) reads a frame at a few
    MiB/s. The wire is unchanged; a transport without a read size keeps
    its own."""
    sock = writer.get_extra_info("socket")
    if sock is not None:
        for opt in (socket.SO_RCVBUF, socket.SO_SNDBUF):
            try:
                sock.setsockopt(socket.SOL_SOCKET, opt, WIDE_IO_BYTES)
            except OSError:
                pass
    if hasattr(writer.transport, "max_size"):
        writer.transport.max_size = WIDE_IO_BYTES


def pack_frame(writer: asyncio.StreamWriter, header: dict, *payloads) -> None:
    """Write one frame: the length-prefixed header, then the payloads.
    The caller drains; payload bytes must already be packed (executor)."""
    data = packb(header)
    writer.write(struct.pack(">I", len(data)) + data)
    for p in payloads:
        writer.write(p)


async def read_header(reader: asyncio.StreamReader,
                      what: str = "transfer") -> Optional[dict]:
    """Read one frame header. None on a clean connection end (EOF or a
    reset between frames); an oversized header raises ValueError (a corrupt
    or hostile peer, never recoverable in-stream)."""
    try:
        raw_len = await read_exact(reader, 4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (hlen,) = struct.unpack(">I", raw_len)
    if hlen > MAX_HEADER:
        raise ValueError(f"{what} header too large: {hlen}")
    return unpackb(await read_exact(reader, hlen))


def _raw(t: torch.Tensor) -> bytes:
    import torch

    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def encode_blocks(k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[bytes, bytes, list, str]:
    """Host-side payload pack: ``(k_bytes, v_bytes, k_shape, dtype_name)``
    of two host tensors of one dtype. Copies: run it in an executor."""
    if k.dtype != v.dtype:
        raise ValueError(f"k and v blocks differ in dtype: {k.dtype} {v.dtype}")
    return _raw(k), _raw(v), list(k.shape), dtype_name(k.dtype)


def _view(raw: bytes, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    import torch

    # a bytearray is writable: torch.frombuffer wants a writable buffer
    flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return flat.view(dtype).reshape(tuple(shape))


def decode_blocks(k_raw: bytes, v_raw: bytes, shape, dtype: str,
                  v_shape=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``encode_blocks``: host tensors over copies of the
    received buffers. ``v_shape`` is V's shape where it differs from K's
    (MLA's ``(c_kv, k_rope)`` pair)."""
    dt = torch_dtype(dtype)
    return _view(k_raw, shape, dt), _view(v_raw, v_shape or shape, dt)
