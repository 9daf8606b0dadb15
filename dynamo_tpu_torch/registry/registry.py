"""ModelRegistry: the frontend's live view over registered model cards.

Read half (:class:`ModelRegistry`): canonical name + alias resolution
with tenant visibility — ``resolve("llama-fast", tenant="acme")`` →
the pool name a request routes by, or ``None`` when the model is
unknown *or invisible to that tenant* (indistinguishable by design: a
404 must not leak another tenant's catalog). Fed by the frontend's
ModelWatcher as registry records come and go, so workers joining or
leaving a model's pool rebind routes without a frontend restart.

Write half (:class:`RegistryAdmin`): the ``POST/DELETE /admin/models``
surface — writes the same discovery records workers publish at startup
(``llmctl`` analog), non-lease-scoped so an operator's registration
outlives the CLI process.

The port's copy of ``dynamo_tpu/registry/registry.py``: the records go
through the port's wire codec (``runtime/wire.py``), byte for byte
msgpack's.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

from ..runtime.wire import packb, unpackb
from ..telemetry.registry import MetricsRegistry
from .cards import ModelCard

logger = logging.getLogger(__name__)


class ModelRegistry:
    """name/alias → :class:`ModelCard` live view, with change listeners
    (the pool manager subscribes to learn about new/removed pools)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.cards: Dict[str, ModelCard] = {}
        self._aliases: Dict[str, str] = {}  # alias → canonical name
        self._listeners: List[Callable[[str, Optional[ModelCard]], None]] = []
        self.registry = registry or MetricsRegistry()
        self.registry.callback_gauge(
            "dynamo_registry_models_info",
            "1 per registered model card, labelled model= and family=",
            lambda: [
                ({"model": name, "family": card.family or "unknown"}, 1)
                for name, card in sorted(self.cards.items())
            ],
        )

    # ---------- mutation (ModelWatcher / tests) ----------

    def put(self, card: ModelCard) -> None:
        previous = self.cards.get(card.name)
        if previous is not None:
            for alias in previous.aliases:
                if self._aliases.get(alias) == previous.name:
                    del self._aliases[alias]
        self.cards[card.name] = card
        for alias in card.aliases:
            existing = self._aliases.get(alias)
            if existing is not None and existing != card.name:
                logger.warning(
                    "alias %r already points at model %r; %r keeps it",
                    alias, existing, existing)
                continue
            self._aliases[alias] = card.name
        self._notify(card.name, card)

    def remove(self, name: str) -> None:
        card = self.cards.pop(name, None)
        if card is None:
            return
        for alias in card.aliases:
            if self._aliases.get(alias) == name:
                del self._aliases[alias]
        self._notify(name, None)

    def add_listener(
        self, fn: Callable[[str, Optional[ModelCard]], None]
    ) -> None:
        """Subscribe to card changes: ``fn(name, card)`` on put,
        ``fn(name, None)`` on removal. Sync callbacks; one listener's
        failure must not starve the rest."""
        self._listeners.append(fn)

    def _notify(self, name: str, card: Optional[ModelCard]) -> None:
        for fn in list(self._listeners):
            try:
                fn(name, card)
            except Exception:
                logger.exception("registry listener failed for %s", name)

    # ---------- resolution ----------

    def lookup(self, model: str) -> Optional[str]:
        """name or alias → canonical name; None if unknown. Visibility
        is NOT consulted here — use :meth:`resolve` on request paths."""
        if model in self.cards:
            return model
        return self._aliases.get(model)

    def card(self, name: str) -> Optional[ModelCard]:
        return self.cards.get(name)

    def resolve(self, model: str, tenant: Optional[str] = None
                ) -> Optional[str]:
        """Request-path resolution: canonical pool name, or None when
        the model is unknown OR invisible to ``tenant`` (same answer —
        a tenant must not be able to probe another tenant's catalog)."""
        name = self.lookup(model)
        if name is None:
            return None
        return name if self.cards[name].visible_to(tenant) else None

    def visible(self, tenant: Optional[str] = None) -> List[str]:
        """Canonical names visible to ``tenant``, sorted."""
        return sorted(
            name for name, card in self.cards.items()
            if card.visible_to(tenant)
        )


class RegistryAdmin:
    """Dynamic model management over the discovery plane — the write
    half behind ``POST/DELETE /admin/models``.

    Writes the same ``{ns}/models/{type}/{name}`` records workers
    publish at startup, but non-lease-scoped: an operator registration
    must outlive the admin request that created it."""

    def __init__(self, drt, namespace: str = "public"):
        self.drt = drt
        self.namespace = namespace

    def _key(self, model_type: str, name: str) -> str:
        # mirror http/service.py model_registry_key without importing it
        # (the http module imports this package)
        return f"{self.namespace}/models/{model_type}/{name}"

    async def add(self, card: ModelCard) -> None:
        from ..http.service import parse_endpoint_path

        parse_endpoint_path(card.endpoint)  # malformed addresses fail HERE
        entry = {
            "name": card.name,
            "endpoint": card.endpoint,
            "model_type": card.model_type,
            "card": card.to_wire(),
        }
        if card.context_length:
            entry["mdc"] = {"context_length": card.context_length}
        await self.drt.discovery.kv_put(
            self._key(card.model_type, card.name),
            packb(entry),
        )

    async def remove(self, name: str,
                     model_type: Optional[str] = None) -> None:
        """Delete the registration. Without ``model_type`` every type's
        key is deleted — a remove must never miss because the operator
        forgot which kind the model was added as."""
        types = [model_type] if model_type else ["chat", "completions",
                                                 "both"]
        for mt in types:
            await self.drt.discovery.kv_delete(self._key(mt, name))

    async def list(self) -> List[dict]:
        kvs = await self.drt.discovery.kv_get_prefix(
            f"{self.namespace}/models/")
        return [unpackb(v) for v in kvs.values()]
