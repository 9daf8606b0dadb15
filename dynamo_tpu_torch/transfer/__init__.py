"""The KV transfer plane: one framing, one pipelining discipline and one
poison vocabulary for the KV blocks that cross a worker boundary.

The port's copy of ``dynamo_tpu/transfer/`` for the ``disagg`` plane
(streamed remote prefill, ``disagg/prefill_worker.py`` →
``disagg/transfer.py``) and the ``fabric`` plane (prefix pulls,
``kv/fabric.py``, served by the same ``KvTransferServer``) over the
``tcp`` backend: block bytes ride the control connection behind their
header. The ``ici`` collective backend and the ``migration`` plane are
not ported.
"""

from .framing import (  # noqa: F401
    MAX_HEADER,
    decode_blocks,
    dtype_name,
    encode_blocks,
    pack_frame,
    read_exact,
    read_header,
    torch_dtype,
    widen_stream,
)
from .plane import FramePipe, PoisonSet, negotiate_backend  # noqa: F401
from .tcp import TcpBackend  # noqa: F401
