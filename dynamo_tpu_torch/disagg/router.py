"""Conditional disaggregation: the local-or-remote prefill decision.

The port's copy of ``dynamo_tpu/disagg/router.py``: a prefill goes remote
when the uncached prompt exceeds ``max_local_prefill_length`` and the
prefill queue holds fewer than ``max_prefill_queue_size`` items. Both are
live-tunable through a watched discovery key (``publish_config``), so an
operator retunes a running deployment without a restart.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..runtime.wire import packb, unpackb

logger = logging.getLogger(__name__)


def config_key(namespace: str, model_name: Optional[str]) -> str:
    return (f"{namespace}/components/disagg_router/models/"
            f"{model_name or '_default'}")


class DisaggRouter:
    def __init__(self, max_local_prefill_length: int = 1000,
                 max_prefill_queue_size: int = 2,
                 model_name: Optional[str] = None,
                 namespace: str = "public"):
        self.max_local_prefill_length = max_local_prefill_length
        self.max_prefill_queue_size = max_prefill_queue_size
        self.model_name = model_name
        self.namespace = namespace
        self._watch_task: Optional[asyncio.Task] = None
        self._watcher = None

    def config_key(self) -> str:
        return config_key(self.namespace, self.model_name)

    def prefill_remote(self, prefill_len: int, prefix_hit_len: int,
                       queue_depth: int) -> bool:
        """True → enqueue for remote prefill; False → prefill locally."""
        return (prefill_len - prefix_hit_len > self.max_local_prefill_length
                and queue_depth < self.max_prefill_queue_size)

    # ---------- live config ----------

    def _apply(self, value: bytes) -> None:
        try:
            cfg = unpackb(value)
        except ValueError:
            logger.warning("malformed disagg config update ignored")
            return
        if "max_local_prefill_length" in cfg:
            self.max_local_prefill_length = int(cfg["max_local_prefill_length"])
        if "max_prefill_queue_size" in cfg:
            self.max_prefill_queue_size = int(cfg["max_prefill_queue_size"])
        logger.info("disagg router config: max_local_prefill_length=%d "
                    "max_prefill_queue_size=%d", self.max_local_prefill_length,
                    self.max_prefill_queue_size)

    async def start(self, discovery, runtime=None) -> "DisaggRouter":
        """Load the current config and watch for live updates."""
        snapshot, watcher = await discovery.watch_prefix(self.config_key())
        for value in snapshot.values():
            self._apply(value)
        self._watcher = watcher

        async def _watch():
            async for ev in watcher:
                if ev.type.value == "put":
                    self._apply(ev.value)

        spawn = runtime.spawn if runtime is not None else asyncio.create_task
        self._watch_task = spawn(_watch())
        return self

    async def stop(self) -> None:
        if self._watcher is not None:
            self._watcher.cancel()
        if self._watch_task is not None:
            self._watch_task.cancel()

    @staticmethod
    async def publish_config(discovery, namespace: str,
                             model_name: Optional[str],
                             max_local_prefill_length: int,
                             max_prefill_queue_size: int) -> None:
        """Operator side: push new thresholds to every live router."""
        await discovery.kv_put(config_key(namespace, model_name), packb({
            "max_local_prefill_length": max_local_prefill_length,
            "max_prefill_queue_size": max_prefill_queue_size,
        }))
