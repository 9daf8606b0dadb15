"""KV-router wire protocols.

Reference analog: lib/llm/src/kv_router/protocols.rs — RouterEvent,
KvCacheEvent Stored/Removed, ForwardPassMetrics.

The port's copy of ``dynamo_tpu/kv_router/protocols.py``: the same wire
dicts, so a router of either package reads the other's events.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class KvCacheStored:
    block_hashes: List[int]           # chained sequence hashes, in order
    parent_hash: Optional[int] = None  # sequence hash of the block before


@dataclasses.dataclass
class KvCacheRemoved:
    block_hashes: List[int]


@dataclasses.dataclass
class RouterEvent:
    worker_id: str
    stored: Optional[KvCacheStored] = None
    removed: Optional[KvCacheRemoved] = None
    event_id: int = 0
    # which tier holds the blocks: "hbm" (warm — the default, and the
    # only value before the KV fabric) or "cold" (content-addressed
    # spill files the worker can rehydrate; routers score it discounted
    # vs a warm hit — kv_router/scheduler.py cold_discount)
    tier: str = "hbm"

    def to_wire(self) -> dict:
        d: dict = {"worker_id": self.worker_id, "event_id": self.event_id}
        if self.tier != "hbm":
            d["tier"] = self.tier
        if self.stored is not None:
            d["stored"] = {
                "block_hashes": self.stored.block_hashes,
                "parent_hash": self.stored.parent_hash,
            }
        if self.removed is not None:
            d["removed"] = {"block_hashes": self.removed.block_hashes}
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "RouterEvent":
        stored = d.get("stored")
        removed = d.get("removed")
        return cls(
            worker_id=d["worker_id"],
            stored=KvCacheStored(
                block_hashes=list(stored["block_hashes"]),
                parent_hash=stored.get("parent_hash"),
            )
            if stored
            else None,
            removed=KvCacheRemoved(block_hashes=list(removed["block_hashes"]))
            if removed
            else None,
            event_id=d.get("event_id", 0),
            tier=d.get("tier", "hbm"),
        )


@dataclasses.dataclass
class ForwardPassMetrics:
    """Per-worker load snapshot (reference: kv_router/protocols.rs:42-54)."""

    request_active_slots: int = 0
    request_total_slots: int = 0
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    num_requests_waiting: int = 0
    gpu_cache_usage_perc: float = 0.0
    gpu_prefix_cache_hit_rate: float = 0.0
    # recovery drain (recovery/controller.py): a draining worker accepts
    # no new requests — routers must exclude it from every decision
    draining: bool = False

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "ForwardPassMetrics":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


KV_EVENT_SUBJECT = "kv_events"
KV_HIT_RATE_EVENT = "kv-hit-rate"
