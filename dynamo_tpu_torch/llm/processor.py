"""Processor: the OpenAI↔token-level bridge with KV-aware routing.

The distributed serving shape (reference flagship graph, SURVEY.md §3.2:
Frontend → Processor → Router → Worker):

  frontend (OpenAI passthrough) → THIS component:
    preprocess (template+tokenize) → KvRouter.schedule(token_ids) →
    direct() the PreprocessedRequest to the chosen token-level worker →
    detokenize the EngineOutput stream back into OpenAI chunks.

``KvRoutedClient`` is the terminal engine of that pipeline: it owns the
routing decision (KV-aware when a router is attached, else the client's
round-robin/random mode).

The port's copy of ``dynamo_tpu/llm/processor.py``.
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator, Optional

from ..kv_router.router import KvRouter
from ..protocols.common import PreprocessedRequest
from ..runtime.client import Client
from ..runtime.engine import AsyncEngine, Context
from ..runtime.pipeline import build_pipeline
from .backend import Backend
from .model_card import ModelDeploymentCard
from .preprocessor import OpenAIPreprocessor
from .tokenizer import HFTokenizer

logger = logging.getLogger(__name__)


class KvRoutedClient(AsyncEngine):
    """Routes token-level requests to workers, KV-aware when possible."""

    def __init__(self, client: Client, router: Optional[KvRouter] = None):
        self.client = client
        self.router = router

    async def generate(self, request: Context[Any]) -> AsyncIterator[Any]:
        from ..runtime.client import NoInstancesError

        req = request.payload
        token_ids = (
            req.token_ids if isinstance(req, PreprocessedRequest) else req["token_ids"]
        )
        model = (req.model if isinstance(req, PreprocessedRequest)
                 else req.get("model"))
        if model is not None:
            # per-model pool partition (registry/): the KV router scopes
            # prefix scoring to the model's pool, and the client's
            # fallback/round-robin pick stays inside it too
            request.baggage["model_pool"] = model
        if self.router is not None:
            try:
                decision = await self.router.schedule(
                    token_ids, trace_id=request.trace_id, model=model
                )
                request.baggage["instance_id"] = decision.worker_id
                request.baggage["prefix_hit_tokens"] = decision.prefix_hit_tokens
                # closing-mark span: the routing decision's latency in the
                # request's timeline
                request.add_stage("router.pick")
            except Exception:
                logger.warning("kv scheduling failed; falling back", exc_info=True)
        # explicit aclose on the inner stream: when a downstream consumer
        # (llm/backend.py) closes THIS generator at the finish chunk, the
        # client generator's cleanup — which folds the worker's span
        # export into the request trace — must run synchronously, not at
        # some later GC-driven finalization
        stream = self.client.generate(request)
        try:
            try:
                async for item in stream:
                    yield item
                return
            except NoInstancesError:
                # the KV-chosen worker died between metrics poll and
                # dispatch — retry once, letting the client's own mode
                # pick a live instance
                if "instance_id" not in request.baggage:
                    raise
                logger.warning(
                    "kv-chosen worker %s gone; re-routing",
                    request.baggage.pop("instance_id"),
                )
        finally:
            await stream.aclose()
        retry = self.client.generate(request)
        try:
            async for item in retry:
                yield item
        finally:
            await retry.aclose()

    async def close(self) -> None:
        if self.router is not None:
            await self.router.stop()
        await self.client.close()


def build_processor_pipeline(
    mdc: ModelDeploymentCard,
    worker_client: Client,
    router: Optional[KvRouter] = None,
    tokenizer: Optional[HFTokenizer] = None,
) -> AsyncEngine:
    """OpenAI-level engine: preprocess → route → worker → detokenize."""
    tokenizer = tokenizer or (
        HFTokenizer.from_model_path(mdc.model_path) if mdc.model_path else None
    )
    return build_pipeline(
        [OpenAIPreprocessor(mdc, tokenizer), Backend(tokenizer)],
        KvRoutedClient(worker_client, router),
    )
