"""Model registry + fleet routing plane: many models, many tenants.

The deployment-plane capability the reference exposes as ``llmctl http
add/remove`` + model deployment cards (PAPER.md §1 layers 3 and 7),
grown into a fleet feature:

- :mod:`cards` — :class:`ModelCard`: what a served model IS (name,
  family, context length, served aliases, tenant visibility) and where
  its pool lives (a dyn:// endpoint). Workers publish cards as
  lease-scoped discovery records at startup; operators add/remove them
  dynamically (``POST/DELETE /admin/models``).
- :mod:`registry` — :class:`ModelRegistry`: the frontend's live view
  over those records (alias resolution, tenant visibility) plus the
  :class:`RegistryAdmin` write half behind the admin API.
- :mod:`pools` — :class:`PoolManager`: per-model worker pools with
  scale-to-zero for idle models and bounded cold-start waits on first
  request for a cold one (503 + Retry-After past the deadline).
- :mod:`policy` — :class:`PoolPolicy`: the deterministic decide() the
  manager (or a standalone planner) runs over per-model demand.
- :mod:`tenants` — :class:`TenantQuotas`: ``X-Tenant`` admission
  classes with per-tenant token buckets (requests/s and tokens/s), so
  one tenant's spike sheds that tenant (429 + Retry-After) while the
  rest are untouched.

The port's copy of ``dynamo_tpu/registry``: the same exports.
"""

from .cards import ModelCard, card_from_mdc
from .policy import PoolAction, PoolDemand, PoolPolicy, PoolPolicyConfig
from .pools import (
    ColdStartTimeout,
    KubePoolBackend,
    PoolConfig,
    PoolManager,
    StorePoolBackend,
)
from .registry import ModelRegistry, RegistryAdmin
from .tenants import (
    DEFAULT_TENANT,
    TENANT_HEADER,
    TenantQuota,
    TenantQuotas,
)

__all__ = [
    "ModelCard",
    "card_from_mdc",
    "ModelRegistry",
    "RegistryAdmin",
    "PoolManager",
    "PoolConfig",
    "PoolPolicy",
    "PoolPolicyConfig",
    "PoolAction",
    "PoolDemand",
    "ColdStartTimeout",
    "KubePoolBackend",
    "StorePoolBackend",
    "TenantQuotas",
    "TenantQuota",
    "TENANT_HEADER",
    "DEFAULT_TENANT",
]
