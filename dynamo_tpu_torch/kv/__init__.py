"""Multi-tier KV cache management and the cluster KV fabric.

The port's copy of ``dynamo_tpu/kv/``. Tiers: HBM
(``engine/block_allocator.py``) → host RAM (``host_tier.py``, a pinned
slab) → content-addressed disk (``cold_tier.py``). The fabric
(``fabric.py``) stitches every worker's tiers into one cluster-wide prefix
cache: a remote prefix hit PULLS committed blocks over the transfer plane
instead of recomputing them, and a cold prefix rehydrates from spill files
any worker (a freshly respawned one included) can read.
"""

from .cold_tier import KvColdTier
from .fabric import KvFabric, PullPlan, fabric_key
from .host_tier import KvHostTier

__all__ = ["KvColdTier", "KvFabric", "KvHostTier", "PullPlan", "fabric_key"]
