"""Actuators: typed planner actions → cluster / router / edge changes.

The port's copy of ``dynamo_tpu/planner/actuation.py``, over the port's
``deploy.operator.Reconciler``, ``deploy.store_source.ApiStoreClient``,
``AdmissionController`` and ``DisaggRouter``.

Three actuation paths, all behind one ``apply(action) -> bool`` protocol
(False = "not mine", so the planner just offers each action down its
actuator list):

- :class:`KubeActuator` — patches per-role replica counts into the CR
  spec and drives the existing deploy ``Reconciler``, so the SAME diff/
  apply/prune machinery serves the planner as serves the operator:
  ``InMemoryKube`` tests the loop end-to-end, ``KubectlClient`` /
  ``KubeApiClient`` run it for real. Reconcile work (kubectl subprocess,
  REST) rides an executor — the planner loop must never block.
- :class:`StoreScaleActuator` — writes the replica change into the
  api-store record instead; the operator sourcing CRs from the store
  (``--api-store-url``) applies it on its next pass. This is the
  planner-as-its-own-pod path where the planner has no cluster creds.
- :class:`LocalActuator` — in-process knobs: the disagg router's
  local/remote threshold (optionally fanned out to every live router
  through the discovery plane via ``DisaggRouter.publish_config``) and
  the admission controller's shed level / limit.

One deviation from the reference: ``replicas()`` reports the service
``apply`` scales (``role_replicas``), where the reference's let a second
service of the same role, such as a cold pool's, hide it.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Mapping, Optional

from ..deploy.operator import Reconciler
from .admission import AdmissionController
from .policy import Action, AdmissionAction, RebalanceAction, ScaleAction

logger = logging.getLogger(__name__)


def role_replicas(services: Mapping[str, dict],
                  role_services: Optional[Mapping[str, str]] = None
                  ) -> Dict[str, int]:
    """role → the replica count of the service an actuator scales for it:
    the one ``role_services`` names, else the FIRST service of that role
    (the one ``apply`` patches). The reference's comprehension keeps the
    last, so a cold pool's ``pool-<slug>`` service (role ``decode``,
    written by a front's ``StorePoolBackend``) hid the graph's own decode
    count from the policy, which then never scaled it down."""
    out: Dict[str, int] = {}
    for name, spec in services.items():
        out.setdefault(spec.get("role", name), int(spec.get("replicas", 1)))
    for role, name in (role_services or {}).items():
        if name in services:
            out[role] = int(services[name].get("replicas", 1))
    return out


def scale_cr_service(cr: dict, service: str, replicas: int) -> dict:
    """Set one service's replica count in a CR spec (in place). The
    service entry is created if the CR relied on render-time defaults."""
    services = cr["spec"].setdefault("services", {})
    spec = services.setdefault(service, {"role": service})
    spec["replicas"] = int(replicas)
    return cr


class KubeActuator:
    """ScaleActions → CR replica patches through the deploy Reconciler."""

    def __init__(
        self,
        reconciler: Reconciler,
        cr: dict,
        role_services: Optional[Mapping[str, str]] = None,
    ):
        self.reconciler = reconciler
        self.cr = cr
        # role → service name; by default resolved from the CR's own
        # service specs (a service's role defaults to its name)
        self._role_services = dict(role_services or {})

    def _service_for_role(self, role: str) -> Optional[str]:
        if role in self._role_services:
            return self._role_services[role]
        for service, spec in (self.cr["spec"].get("services") or {}).items():
            if spec.get("role", service) == role:
                return service
        return None

    def replicas(self) -> Dict[str, int]:
        """role → current replica count, for the policy's targets."""
        return role_replicas(self.cr["spec"].get("services") or {},
                             self._role_services)

    async def apply(self, action: Action) -> bool:
        if not isinstance(action, ScaleAction):
            return False
        service = self._service_for_role(action.role)
        if service is None:
            logger.warning("no service for role %r in CR %s — scale skipped",
                           action.role, self.cr["metadata"]["name"])
            return False
        scale_cr_service(self.cr, service, action.target_replicas)
        # reconcile off-loop: the kubectl/REST client blocks
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(
            None, self.reconciler.reconcile, self.cr)
        return True


class StoreScaleActuator:
    """ScaleActions → api-store record updates (operator applies them)."""

    def __init__(self, store_client, deployment: str,
                 role_services: Optional[Mapping[str, str]] = None):
        self.store = store_client  # deploy.store_source.ApiStoreClient (sync)
        self.deployment = deployment
        self._role_services = dict(role_services or {})

    def _patch(self, role: str, target: int) -> Optional[Dict[str, int]]:
        rec = self.store.get(self.deployment)
        if rec is None:
            logger.warning("deployment %r not in api-store — scale skipped",
                           self.deployment)
            return None
        spec = rec["spec"]
        services = spec.setdefault("services", {})
        service = self._role_services.get(role)
        if service is None:
            for name, sspec in services.items():
                if sspec.get("role", name) == role:
                    service = name
                    break
        if service is None:
            service = role
        services.setdefault(service, {"role": role})["replicas"] = int(target)
        self.store.update(self.deployment, spec)
        return role_replicas(services, self._role_services)

    async def replicas(self) -> Dict[str, int]:
        loop = asyncio.get_running_loop()
        try:
            rec = await loop.run_in_executor(
                None, self.store.get, self.deployment)
        except Exception:
            logger.warning("api-store unreachable for replica lookup",
                           exc_info=True)
            return {}
        if rec is None:
            return {}
        return role_replicas(rec["spec"].get("services") or {},
                             self._role_services)

    async def apply(self, action: Action) -> bool:
        if not isinstance(action, ScaleAction):
            return False
        loop = asyncio.get_running_loop()
        patched = await loop.run_in_executor(
            None, self._patch, action.role, action.target_replicas)
        return patched is not None


class LocalActuator:
    """In-process actuation: disagg router config + admission knobs."""

    def __init__(
        self,
        disagg_router=None,          # disagg.router.DisaggRouter
        admission: Optional[AdmissionController] = None,
        discovery=None,              # publish config to every live router
        namespace: str = "public",
        model_name: Optional[str] = None,
    ):
        self.disagg_router = disagg_router
        self.admission = admission
        self.discovery = discovery
        self.namespace = namespace
        self.model_name = model_name

    async def apply(self, action: Action) -> bool:
        if isinstance(action, RebalanceAction):
            applied = False
            if self.disagg_router is not None:
                self.disagg_router.max_local_prefill_length = (
                    action.max_local_prefill_length)
                self.disagg_router.max_prefill_queue_size = (
                    action.max_prefill_queue_size)
                applied = True
            if self.discovery is not None:
                # the watched-config path: every live router (decode
                # workers included) applies the new threshold
                from ..disagg.router import DisaggRouter

                await DisaggRouter.publish_config(
                    self.discovery, self.namespace, self.model_name,
                    action.max_local_prefill_length,
                    action.max_prefill_queue_size,
                )
                applied = True
            return applied
        if isinstance(action, AdmissionAction):
            if self.admission is None:
                return False
            self.admission.set_shed_level(action.shed_level)
            if action.limit is not None:
                self.admission.set_limit(action.limit)
            return True
        return False
