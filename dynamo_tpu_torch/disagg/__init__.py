"""Disaggregated prefill and decode serving.

The port of ``dynamo_tpu/disagg/``: decode workers decide per request
whether to prefill locally or enqueue the prompt on the namespace's
prefill work queue (``DisaggRouter``, ``RemotePrefillCoordinator``);
prefill workers pop the queue, compute the KV with the port's kernels and
stream the blocks into the decode worker's cache over TCP through host
memory (``PrefillWorker``, ``KvTransferServer`` / ``KvTransferClient``).
The queue is the runtime's work queue (ack and visibility redelivery);
the transfer descriptor sits in the discovery plane. The transfer server
also serves the cluster KV fabric's prefix pulls (``kv/fabric.py``). Not
ported: the ici collective backend, refused by name.
"""

from .coordinator import RemotePrefillCoordinator
from .prefill_worker import PrefillWorker
from .protocols import PrefillQueue, RemotePrefillRequest
from .router import DisaggRouter
from .transfer import KvTransferClient, KvTransferServer

__all__ = [
    "DisaggRouter",
    "KvTransferClient",
    "KvTransferServer",
    "PrefillQueue",
    "PrefillWorker",
    "RemotePrefillCoordinator",
    "RemotePrefillRequest",
]
