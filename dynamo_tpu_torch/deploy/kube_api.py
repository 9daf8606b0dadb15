"""Direct Kubernetes API-server client (no kubectl shell-out).

The port's copy of ``dynamo_tpu/deploy/kube_api.py``.

Reference analog: the reference's Go operator talks to the API server
through client-go (deploy/dynamo/operator); this is the same plane over
plain REST — urllib + the in-cluster serviceaccount contract — so
operator pods need no kubectl binary, and the client's semantics
(server-side apply, status subresource, labelSelector lists, watch
streams) can be exercised against a real-shaped fake API server in
tests instead of a subprocess mock.

Implements the deploy/operator.py ``KubeClient`` protocol plus the
watch-loop source contract:

- ``apply``: server-side apply (``PATCH ?fieldManager=...&force=true``,
  content type ``application/apply-patch+yaml`` — JSON is valid YAML),
  the modern idempotent upsert; force resolves manager conflicts the
  way a controller must (it owns its children).
- ``update_status``: merge-patch against the CR's ``/status``
  subresource — spec edits in the body are ignored by the server, the
  exact behavior the CRD's ``subresources.status`` enables.
- ``list_managed`` / ``get_crs``: labelSelector / CRD collection GETs.
- ``open_watch``: a ``?watch=1`` streaming GET yielding watch events,
  pluggable into deploy/watch.py ``watch_loop`` as ``open_stream``.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import ssl
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Iterator, List, Optional, Tuple

from .operator import GROUP, KIND, PLURAL, VERSION, managed_selector

logger = logging.getLogger(__name__)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# kind → (API prefix, plural). The operator only manages these children.
_KIND_PATHS: Dict[str, tuple] = {
    "Deployment": ("/apis/apps/v1", "deployments"),
    "Service": ("/api/v1", "services"),
}


class KubeApiError(RuntimeError):
    def __init__(self, status: int, body: str):
        super().__init__(f"kube api {status}: {body[:300]}")
        self.status = status


class KubeApiClient:
    """Sync REST client for the operator's needs (KubeClient protocol)."""

    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        token_file: Optional[str] = None,
        ca_file: Optional[str] = None,
        field_manager: str = "dynamo-tpu-operator",
        timeout: float = 30.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.token = token
        # bound serviceaccount tokens expire (~1h) and the kubelet
        # rotates the mounted file — re-read per request, never cache
        self.token_file = token_file
        self.field_manager = field_manager
        self.timeout = timeout
        if ca_file:
            self._ctx: Optional[ssl.SSLContext] = ssl.create_default_context(
                cafile=ca_file
            )
        elif self.base_url.startswith("https"):
            self._ctx = ssl.create_default_context()
        else:
            self._ctx = None

    @classmethod
    def from_in_cluster(cls) -> "KubeApiClient":
        """The pod serviceaccount contract (KUBERNETES_SERVICE_HOST +
        mounted token/CA) — how the operator container authenticates."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        token_file = os.path.join(SA_DIR, "token")
        if not host or not os.path.exists(token_file):
            raise RuntimeError(
                "not running in a cluster (no KUBERNETES_SERVICE_HOST / "
                f"{token_file}); pass --kube-api-url for an explicit "
                "API-server endpoint"
            )
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        return cls(
            f"https://{host}:{port}", token_file=token_file,
            ca_file=os.path.join(SA_DIR, "ca.crt"),
        )

    # ---------- plumbing ----------

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        content_type: str = "application/json",
        query: Optional[dict] = None,
        stream: bool = False,
        stream_timeout: Optional[float] = None,
    ):
        url = self.base_url + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        req = urllib.request.Request(
            url, method=method,
            data=None if body is None else json.dumps(body).encode(),
        )
        if body is not None:
            req.add_header("Content-Type", content_type)
        token = self.token
        if self.token_file:
            with open(self.token_file) as f:
                token = f.read().strip()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            resp = urllib.request.urlopen(
                req, timeout=stream_timeout if stream else self.timeout,
                context=self._ctx,
            )
        except urllib.error.HTTPError as e:
            raise KubeApiError(e.code, e.read().decode(errors="replace"))
        if stream:
            return resp
        with resp:
            text = resp.read().decode()
        return json.loads(text) if text else None

    @staticmethod
    def _child_path(kind: str, namespace: str, name: Optional[str] = None) -> str:
        prefix, plural = _KIND_PATHS[kind]
        base = f"{prefix}/namespaces/{namespace}/{plural}"
        return f"{base}/{name}" if name else base

    @staticmethod
    def _cr_path(namespace: Optional[str], name: Optional[str] = None) -> str:
        base = (
            f"/apis/{GROUP}/{VERSION}/namespaces/{namespace}/{PLURAL}"
            if namespace else f"/apis/{GROUP}/{VERSION}/{PLURAL}"
        )
        return f"{base}/{name}" if name else base

    # ---------- KubeClient protocol ----------

    def apply(self, manifest: dict) -> None:
        kind = manifest["kind"]
        md = manifest["metadata"]
        self._request(
            "PATCH",
            self._child_path(kind, md.get("namespace", "default"), md["name"]),
            body=manifest,
            content_type="application/apply-patch+yaml",
            query={"fieldManager": self.field_manager, "force": "true"},
        )

    def delete(self, kind: str, namespace: str, name: str) -> None:
        try:
            self._request(
                "DELETE", self._child_path(kind.capitalize(), namespace, name)
            )
        except KubeApiError as e:
            if e.status != 404:  # --ignore-not-found semantics
                raise

    def list_managed(self, namespace: str, instance: str) -> List[dict]:
        items: List[dict] = []
        for kind, (prefix, plural) in _KIND_PATHS.items():
            out = self._request(
                "GET", self._child_path(kind, namespace),
                query={"labelSelector": managed_selector(instance)},
            )
            api_version = prefix.removeprefix("/apis/").removeprefix("/api/")
            for obj in (out or {}).get("items", []):
                # list responses omit per-item kind/apiVersion; the
                # reconciler keys children by kind, so restore them
                obj.setdefault("kind", kind)
                obj.setdefault("apiVersion", api_version)
                items.append(obj)
        return items

    def update_status(self, cr: dict, status: dict) -> None:
        self._request(
            "PATCH",
            self._cr_path(cr["metadata"].get("namespace", "default"),
                          cr["metadata"]["name"]) + "/status",
            body={"status": status},
            content_type="application/merge-patch+json",
        )

    # ---------- CR source (poll + watch loops) ----------

    def get_crs(self, namespace: Optional[str] = None) -> Optional[List[dict]]:
        """None on API failure (a dead API must never read as 'no CRs' —
        the loops treat None as skip-cycle, [] as finalize-everything)."""
        try:
            out = self._request("GET", self._cr_path(namespace))
            items = (out or {}).get("items", [])
            for obj in items:
                obj.setdefault("kind", KIND)
                obj.setdefault("apiVersion", f"{GROUP}/{VERSION}")
            return items
        except (KubeApiError, OSError, http.client.HTTPException,
                json.JSONDecodeError) as e:
            # IncompleteRead on a truncated body is an HTTPException, not
            # an OSError; a garbled body is a JSONDecodeError — both are
            # "API failed this cycle", never allowed to kill the loop
            logger.warning("CR list failed: %s", e)
            return None

    # ---------- coordination.k8s.io Leases (leader election) ----------

    _LEASE_BASE = "/apis/coordination.k8s.io/v1"

    def read_lease(
        self, namespace: str, name: str
    ) -> Tuple[Optional[dict], Optional[str]]:
        """LeaseClient.read: (spec, resourceVersion), or (None, None) when
        absent. Any non-404 failure RAISES — 'lease absent' and 'API
        unreachable' must stay distinct or a blip deposes a healthy
        leader (deploy/leader.py)."""
        try:
            obj = self._request(
                "GET",
                f"{self._LEASE_BASE}/namespaces/{namespace}/leases/{name}",
            )
        except KubeApiError as e:
            if e.status == 404:
                return None, None
            raise
        return obj.get("spec", {}), obj["metadata"].get("resourceVersion")

    def write_lease(self, namespace: str, name: str, spec: dict,
                    expected_version: Optional[str]) -> bool:
        """LeaseClient.write: CAS commit. POST when expected_version is
        None (create-only — 409 AlreadyExists = lost the race), PUT with
        resourceVersion otherwise (409 Conflict = lost the race). Other
        failures raise (transient, NOT an authoritative loss)."""
        body = {
            "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
            "metadata": {"name": name, "namespace": namespace},
            "spec": spec,
        }
        base = f"{self._LEASE_BASE}/namespaces/{namespace}/leases"
        try:
            if expected_version is None:
                self._request("POST", base, body=body)
            else:
                body["metadata"]["resourceVersion"] = expected_version
                self._request("PUT", f"{base}/{name}", body=body)
        except KubeApiError as e:
            if e.status == 409:
                logger.debug("lease write lost the CAS race: %s", e)
                return False
            raise
        return True

    def open_watch(
        self, namespace: Optional[str] = None,
        timeout_seconds: int = 300,
    ) -> Iterator[dict]:
        """``watch_loop`` open_stream source: yields watch event dicts
        ({type, object}) until the server closes the stream."""
        # client-side socket timeout slightly past the server's request
        # timeout: a silently dropped connection (LB idle reset, node
        # failover) must end the stream so watch_loop can relist —
        # without it `for raw in resp` would block forever
        resp = self._request(
            "GET", self._cr_path(namespace),
            query={"watch": "1", "timeoutSeconds": str(timeout_seconds)},
            stream=True, stream_timeout=timeout_seconds + 30.0,
        )
        try:
            for raw in resp:  # the API server streams one JSON per line
                line = raw.decode(errors="replace").strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    logger.warning("watch: undecodable line %r", line[:120])
                    return
        finally:
            resp.close()


class KubeApiLeases:
    """deploy/leader.py LeaseClient over the REST client — leader
    election without a kubectl binary in the image (the kubectl analog
    is leader.KubectlLeases)."""

    def __init__(self, client: KubeApiClient):
        self.client = client

    def read(self, namespace: str, name: str):
        return self.client.read_lease(namespace, name)

    def write(self, namespace: str, name: str, spec: dict,
              expected_version: Optional[str]) -> bool:
        return self.client.write_lease(namespace, name, spec,
                                       expected_version)
