"""ModelCard: the registry's unit of truth for one served model.

Where :class:`~dynamo_tpu_torch.llm.model_card.ModelDeploymentCard` describes
preprocessing agreement (tokenizer, template, checksum) for ONE engine,
the ModelCard describes the model as a *fleet citizen*: the name clients
route by, the served aliases, the family, which tenants may see it, and
the dyn:// endpoint its worker pool serves. Reference analog: the model
cards ``llmctl http add`` writes for the HTTP frontend's watcher
(reference: launch/llmctl/src/main.rs ModelEntry + lib/llm/src/
model_card/model.rs), extended with visibility + pool metadata.

Cards ride the SAME discovery records the frontend's ModelWatcher
already consumes (``{ns}/models/{type}/{name}``, http/service.py), as an
extra ``card`` field — a registry-less frontend keeps working, a
card-aware one becomes a live view (aliases, tenants, pools).

The port's copy of ``dynamo_tpu/registry/cards.py``: a card's wire dict
is the reference's field for field, so a card a port worker writes reads
back under the reference's ``ModelCard.from_wire`` and the other way round.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

MODEL_TYPES = ("chat", "completions", "both")


@dataclasses.dataclass
class ModelCard:
    name: str                      # canonical served name (the pool key)
    endpoint: str = ""             # dyn://ns.comp.ep of the pool
    model_type: str = "both"       # chat | completions | both
    family: Optional[str] = None   # llama / gemma2 / mixtral / ...
    context_length: Optional[int] = None
    aliases: List[str] = dataclasses.field(default_factory=list)
    # tenant visibility: None = public (every tenant), [] = admin-only
    # (nobody resolves it), else the allow list
    tenants: Optional[List[str]] = None
    owned_by: str = "dynamo"
    # cold-start material: enough for a respawn-with-this-card (the
    # recovery controller / pool backend rebuilds a worker from it)
    model_path: Optional[str] = None
    kv_block_size: Optional[int] = None
    # preprocessing-agreement checksum (ModelDeploymentCard.checksum):
    # lets a router verify two pool members agree before mixing streams
    checksum: Optional[str] = None

    def __post_init__(self) -> None:
        if self.model_type not in MODEL_TYPES:
            raise ValueError(
                f"model_type {self.model_type!r} not in {MODEL_TYPES}")

    def visible_to(self, tenant: Optional[str]) -> bool:
        """Public cards are visible to everyone (including requests with
        no tenant header); scoped cards only to listed tenants."""
        if self.tenants is None:
            return True
        return tenant is not None and tenant in self.tenants

    def served_names(self) -> List[str]:
        return [self.name] + [a for a in self.aliases if a != self.name]

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "ModelCard":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def card_from_mdc(
    mdc,
    endpoint: str,
    name: Optional[str] = None,
    model_type: Optional[str] = None,
    aliases: Optional[List[str]] = None,
    tenants: Optional[List[str]] = None,
) -> ModelCard:
    """Build the fleet card from an engine's deployment card. The family
    is the HF architecture family (config.json ``model_type``) — the
    zoo key (models/__init__.py), not the chat/completions axis."""
    return ModelCard(
        name=name or mdc.display_name,
        endpoint=endpoint,
        model_type=model_type or getattr(mdc, "model_type", "both") or "both",
        family=(mdc.config or {}).get("model_type"),
        context_length=mdc.context_length,
        aliases=list(aliases or []),
        tenants=list(tenants) if tenants is not None else None,
        model_path=mdc.model_path,
        kv_block_size=mdc.kv_block_size,
        checksum=mdc.checksum,
    )
