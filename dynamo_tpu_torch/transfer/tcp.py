"""TcpBackend: block payloads inline on the control connection.

The port's copy of ``dynamo_tpu/transfer/tcp.py``, the one payload path
the port serves. The byte pack copies the frame, so it runs in an
executor; headers alone ride the loop.
"""

from __future__ import annotations

import asyncio
from typing import TYPE_CHECKING, Optional, Tuple

from .framing import decode_blocks, encode_blocks, pack_frame, read_exact

if TYPE_CHECKING:
    import torch


class TcpBackend:
    """Payload path: raw k/v bytes framed behind the header."""

    name = "tcp"

    @staticmethod
    async def send_blocks(writer: asyncio.StreamWriter, header: dict,
                          k: torch.Tensor, v: torch.Tensor,
                          packed: Optional[Tuple] = None) -> int:
        """Write one block frame; returns payload bytes. ``packed`` lets
        a pump that already encoded off-loop skip the executor hop."""
        if packed is None:
            loop = asyncio.get_running_loop()
            packed = await loop.run_in_executor(None, encode_blocks, k, v)
        kb, vb, shape, dtype_name = packed
        header = dict(header)
        header.update(shape=shape, dtype=dtype_name,
                      k_bytes=len(kb), v_bytes=len(vb))
        if list(v.shape) != shape:
            header["v_shape"] = list(v.shape)
        pack_frame(writer, header, kb, vb)
        await writer.drain()
        return len(kb) + len(vb)

    @staticmethod
    async def recv_blocks(reader: asyncio.StreamReader, header: dict
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Read the payload a block-frame header announced."""
        k_raw = await read_exact(reader, header["k_bytes"])
        v_raw = await read_exact(reader, header["v_bytes"])
        return decode_blocks(k_raw, v_raw, header["shape"], header["dtype"],
                             header.get("v_shape"))
