"""api-store ↔ operator bridge: store records drive the reconciler.

The port's copy of ``dynamo_tpu/deploy/store_source.py``; its client
speaks to either package's api-store (the same routes and bodies).

Reference analog: the reference's api-store does not just register
records — creating a deployment there creates the cluster objects
(deploy/dynamo/api-store/ai_dynamo_store/api/deployments.py:30
``create_dynamo_deployment`` → api/k8s.py). Here the same coupling is a
*source*: the operator's control loop can list CRs from the store
(``--api-store-url``) instead of from the Kubernetes API, and writes
reconcile status back into the record — so ``llmctl deploy`` → store →
reconciler → cluster is one path, testable end-to-end against
``InMemoryKube`` with no cluster at all.

stdlib urllib (the operator binary and llmctl are sync; no aiohttp
client session/event loop to manage for four tiny REST verbs).
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request
from typing import List, Optional

from .operator import GROUP, KIND, VERSION

logger = logging.getLogger(__name__)


class ApiStoreClient:
    """Sync REST client for deploy/api_store.py."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _request(self, method: str, path: str, body: Optional[dict] = None):
        req = urllib.request.Request(
            f"{self.base_url}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read().decode() or "null")

    # ---------- deployment CRUD (llmctl deploy) ----------

    def list(self) -> List[dict]:
        return self._request("GET", "/api/v1/deployments")["deployments"]

    def get(self, name: str) -> Optional[dict]:
        try:
            return self._request("GET", f"/api/v1/deployments/{name}")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def create(self, name: str, spec: dict) -> dict:
        return self._request(
            "POST", "/api/v1/deployments", {"name": name, "spec": spec}
        )

    def update(self, name: str, spec: dict) -> dict:
        return self._request(
            "PUT", f"/api/v1/deployments/{name}", {"spec": spec}
        )

    def delete(self, name: str) -> None:
        self._request("DELETE", f"/api/v1/deployments/{name}")

    def set_status(self, name: str, status: dict) -> None:
        self._request(
            "PUT", f"/api/v1/deployments/{name}/status", {"status": status}
        )

    # ---------- operator source ----------

    def get_crs(self) -> Optional[List[dict]]:
        """Store records as CR dicts for the control loop; None when the
        store is unreachable (the loop skips the cycle — same contract as
        operator_main.get_crs, for the same finalize-everything hazard)."""
        try:
            return [record_to_cr(rec) for rec in self.list()]
        except Exception:
            logger.warning("api-store listing failed", exc_info=True)
            return None

    def write_status(self, cr: dict, status: dict) -> None:
        """Reconciler status sink: the record IS the CR's status home."""
        self.set_status(cr["metadata"]["name"], status)


def record_to_cr(rec: dict) -> dict:
    """Store record → DynamoTpuGraphDeployment CR dict.

    The record's spec is the CR spec verbatim; ``k8sNamespace`` (optional
    spec field) picks the target cluster namespace; the record's update
    timestamp stands in for metadata.generation so status readers can see
    whether the latest spec was observed."""
    spec = rec["spec"]
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": KIND,
        "metadata": {
            "name": rec["name"],
            "namespace": spec.get("k8sNamespace", "default"),
            "generation": int(rec.get("updated") or 0),
        },
        "spec": spec,
    }
