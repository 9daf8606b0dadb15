"""Kubernetes operator for DynamoTpuGraphDeployment resources.

The port's copy of ``dynamo_tpu/deploy/operator.py`` (reference analog:
deploy/dynamo/operator, the Go controller that turns a DynamoDeployment
CR into child Deployments and Services):

- ``render_manifests(cr)`` is a PURE function: CR spec → the desired
  child manifests (dynstore, frontend, one Deployment per service role,
  Services). Its pods run the port: ``python -m dynamo_tpu_torch.cli.run``
  with ``out=torch`` on the engine roles, and ``python -m
  dynamo_tpu_torch.runtime.transports.dynstore`` for the broker. A
  service's ``gpus: n`` requests (and limits) ``nvidia.com/gpu``; an
  optional ``gpuProduct`` becomes the node selector
  ``nvidia.com/gpu.product``. A CR that still carries the reference's
  ``tpus``, ``tpuAccelerator`` or ``tpuTopology`` is refused with a
  ``ValueError`` naming the field (the reconcile writes it into a
  ``Reconciled False`` condition): a worker rendered without its card
  would start on a host with no GPU.
- ``Reconciler`` diffs desired vs. observed through a pluggable
  ``KubeClient`` (apply/delete/list) and is idempotent — the control
  loop can run from a watch or a poll. ``InMemoryKube`` backs the tests;
  ``KubectlClient`` shells out to kubectl for real clusters and
  ``deploy/kube_api.KubeApiClient`` talks REST to the API server.

``GROUP``, ``VERSION``, ``KIND`` and ``PLURAL`` are the reference's: both
packages reconcile the same resource. The port's CRD (``gpus`` and
``gpuProduct`` in place of the TPU fields) ships beside this module as
``crd.yaml``, with a JSON example of the disaggregated graph.
"""

from __future__ import annotations

import json
import logging
import subprocess
import time
from typing import Dict, List, Optional, Protocol

logger = logging.getLogger(__name__)

GROUP = "dynamo.tpu"
VERSION = "v1alpha1"
KIND = "DynamoTpuGraphDeployment"
PLURAL = "dynamotpugraphdeployments"

MANAGED_BY = {"app.kubernetes.io/managed-by": "dynamo-tpu-operator"}


def managed_selector(instance: str) -> str:
    """labelSelector for one CR's managed children — the single source
    both cluster clients (kubectl + REST) list/prune by; a drifting copy
    would silently stop orphan pruning for one of them."""
    return (
        f"app.kubernetes.io/instance={instance},"
        f"app.kubernetes.io/managed-by="
        f"{MANAGED_BY['app.kubernetes.io/managed-by']}"
    )

# role → in=/out= argv of cli.run (the service binaries, SURVEY §2.6/2.7)
ROLE_ARGS = {
    "frontend": ["in=http", "out=none"],
    "processor": ["in=dyn://{ns}.processor.chat", "out=processor"],
    "worker": ["in=dyn://{ns}.backend.generate", "out=torch", "--token-level"],
    "decode": ["in=dyn://{ns}.backend.generate", "out=torch", "--token-level",
               "--remote-prefill"],
    "prefill": ["in=prefill", "out=torch"],
    # the SLA planner control-plane pod: observes the decode pool +
    # prefill queue, actuates router config and (via the api-store)
    # per-role replica counts
    "planner": ["in=planner", "out=none",
                "--worker-endpoint", "dyn://{ns}.backend.generate"],
    # the fleet telemetry hub pod: scrapes every discovery-registered
    # /metrics sidecar into history rings, serves /fleet/metrics +
    # /fleet/workers (dynamotop's data source) + /debug/incidents
    "hub": ["in=hub", "out=none"],
}

DYNSTORE_PORT = 4871
HTTP_PORT = 8080

# the reference's TPU fields: refused by name (a worker rendered without
# its card would start on a host with no GPU)
TPU_FIELDS = ("tpus", "tpuAccelerator", "tpuTopology")
GPU_RESOURCE = "nvidia.com/gpu"
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"


def _labels(cr_name: str, service: str) -> Dict[str, str]:
    return {
        "app.kubernetes.io/name": "dynamo-tpu",
        "app.kubernetes.io/instance": cr_name,
        "app.kubernetes.io/component": service,
        **MANAGED_BY,
    }


def _owner_ref(cr: dict) -> dict:
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": KIND,
        "name": cr["metadata"]["name"],
        "uid": cr["metadata"].get("uid", ""),
        "controller": True,
    }


def _deployment(cr: dict, service: str, spec: dict) -> dict:
    name = cr["metadata"]["name"]
    ns = cr["metadata"].get("namespace", "default")
    graph_ns = cr["spec"].get("namespace", "public")
    image = spec.get("image") or cr["spec"].get("image", "dynamo-tpu:latest")
    role = spec.get("role", service)
    if role not in ROLE_ARGS and role != "dynstore":
        raise ValueError(f"unknown service role {role!r} for {service}")
    for field in TPU_FIELDS:
        if field in spec:
            raise ValueError(
                f"service {service}: field {field!r} is a TPU request the "
                f"PyTorch port does not serve; give gpus (and gpuProduct) "
                f"instead")

    if role == "dynstore":
        command = ["python", "-m",
                   "dynamo_tpu_torch.runtime.transports.dynstore",
                   "--host", "0.0.0.0", "--port", str(DYNSTORE_PORT)]
        ports = [{"containerPort": DYNSTORE_PORT, "name": "dynstore"}]
    else:
        argv = [a.format(ns=graph_ns) for a in ROLE_ARGS[role]]
        command = ["python", "-m", "dynamo_tpu_torch.cli.run", *argv,
                   "--store-host", f"{name}-dynstore",
                   "--store-port", str(DYNSTORE_PORT),
                   "--namespace", graph_ns]
        if spec.get("modelPath"):
            command += ["--model-path", spec["modelPath"]]
        if spec.get("modelName") or cr["spec"].get("modelName"):
            command += ["--model-name",
                        spec.get("modelName") or cr["spec"]["modelName"]]
        command += list(spec.get("extraArgs", []))
        ports = (
            [{"containerPort": HTTP_PORT, "name": "http"}]
            if role == "frontend" else []
        )

    container: dict = {
        "name": service,
        "image": image,
        "command": command,
        "ports": ports,
        "env": [
            {"name": "DYN_LOGGING_JSONL", "value": "1"},
            *[{"name": k, "value": str(v)}
              for k, v in (spec.get("env") or {}).items()],
        ],
    }
    pod_spec: dict = {"containers": [container]}

    gpus = spec.get("gpus", 0)
    if gpus:
        container["resources"] = {
            "requests": {GPU_RESOURCE: str(gpus)},
            "limits": {GPU_RESOURCE: str(gpus)},
        }
        if spec.get("gpuProduct"):
            pod_spec["nodeSelector"] = {GPU_PRODUCT_LABEL: spec["gpuProduct"]}

    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": f"{name}-{service}",
            "namespace": ns,
            "labels": _labels(name, service),
            "ownerReferences": [_owner_ref(cr)],
        },
        "spec": {
            "replicas": spec.get("replicas", 1),
            "selector": {"matchLabels": _labels(name, service)},
            "template": {
                "metadata": {"labels": _labels(name, service)},
                "spec": pod_spec,
            },
        },
    }


def _service(cr: dict, service: str, port: int, port_name: str) -> dict:
    name = cr["metadata"]["name"]
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": f"{name}-{service}",
            "namespace": cr["metadata"].get("namespace", "default"),
            "labels": _labels(name, service),
            "ownerReferences": [_owner_ref(cr)],
        },
        "spec": {
            "selector": _labels(name, service),
            "ports": [{"port": port, "targetPort": port, "name": port_name}],
        },
    }


def render_manifests(cr: dict) -> List[dict]:
    """CR → desired child manifests. Pure; raises on invalid specs."""
    services: Dict[str, dict] = dict(cr["spec"].get("services") or {})
    manifests: List[dict] = []
    # every graph gets its control/message plane + frontend unless the CR
    # overrides them explicitly
    services.setdefault("dynstore", {"role": "dynstore"})
    services.setdefault("frontend", {"role": "frontend"})
    for service, spec in services.items():
        manifests.append(_deployment(cr, service, spec))
        role = spec.get("role", service)
        if role == "dynstore":
            manifests.append(_service(cr, service, DYNSTORE_PORT, "dynstore"))
        elif role == "frontend":
            manifests.append(_service(cr, service, HTTP_PORT, "http"))
    return manifests


def _key(m: dict) -> str:
    return f'{m["kind"]}/{m["metadata"].get("namespace", "default")}/{m["metadata"]["name"]}'


class KubeClient(Protocol):
    """The verbs the reconcile loop needs."""

    def apply(self, manifest: dict) -> None: ...

    def delete(self, kind: str, namespace: str, name: str) -> None: ...

    def list_managed(self, namespace: str, instance: str) -> List[dict]: ...

    def update_status(self, cr: dict, status: dict) -> None: ...


class InMemoryKube:
    """Test double with real apply/delete/list semantics."""

    def __init__(self) -> None:
        self.objects: Dict[str, dict] = {}
        # (namespace, name) → last written CR status
        self.statuses: Dict[tuple, dict] = {}

    def apply(self, manifest: dict) -> None:
        self.objects[_key(manifest)] = json.loads(json.dumps(manifest))

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self.objects.pop(f"{kind}/{namespace}/{name}", None)

    def list_managed(self, namespace: str, instance: str) -> List[dict]:
        out = []
        for m in self.objects.values():
            labels = m["metadata"].get("labels", {})
            if (m["metadata"].get("namespace", "default") == namespace
                    and labels.get("app.kubernetes.io/instance") == instance
                    and labels.get("app.kubernetes.io/managed-by")
                    == MANAGED_BY["app.kubernetes.io/managed-by"]):
                out.append(m)
        return out

    def update_status(self, cr: dict, status: dict) -> None:
        key = (cr["metadata"].get("namespace", "default"),
               cr["metadata"]["name"])
        self.statuses[key] = json.loads(json.dumps(status))


class KubectlClient:
    """Real-cluster client via kubectl (present on operator pods)."""

    def __init__(self, kubectl: str = "kubectl"):
        self.kubectl = kubectl

    def _run(self, *args: str, stdin: Optional[str] = None) -> str:
        proc = subprocess.run(
            [self.kubectl, *args], input=stdin, capture_output=True,
            text=True, check=True,
        )
        return proc.stdout

    def apply(self, manifest: dict) -> None:
        self._run("apply", "-f", "-", stdin=json.dumps(manifest))

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._run("delete", kind.lower(), name, "-n", namespace,
                  "--ignore-not-found")

    def list_managed(self, namespace: str, instance: str) -> List[dict]:
        out = self._run(
            "get", "deployments,services", "-n", namespace,
            "-l", managed_selector(instance), "-o", "json",
        )
        return json.loads(out).get("items", [])

    def update_status(self, cr: dict, status: dict) -> None:
        """Write the CR's status subresource (the CRD enables it) so
        ``kubectl get`` shows reconcile health — reference analog:
        dynamodeployment_controller.go status/conditions handling."""
        self._run(
            "patch", f"{PLURAL}.{GROUP}", cr["metadata"]["name"],
            "-n", cr["metadata"].get("namespace", "default"),
            "--type=merge", "--subresource=status",
            "-p", json.dumps({"status": status}),
        )


class Reconciler:
    """Desired-state reconcile: render, apply changed, prune orphans.

    Reference analog: dynamodeployment_controller.go Reconcile — but as
    an explicit diff over manifests so the same function serves a watch
    loop, a poll loop, and the unit tests.
    """

    def __init__(self, client: KubeClient, status_writer=None):
        self.client = client
        # where CR status lands: the kube client's status subresource by
        # default; store-sourced CRs write back into their store record
        self._status_writer = status_writer
        # last applied spec per child, to skip no-op applies
        self._applied: Dict[str, str] = {}
        # last written status per CR: steady-state cycles must not patch
        # the API server every poll, and lastTransitionTime must mark the
        # actual transition (k8s condition convention)
        self._status_written: Dict[tuple, dict] = {}

    def reconcile(self, cr: dict) -> Dict[str, List[str]]:
        """Bring the cluster to the CR's desired state, then write the
        CR's status (observed generation, child counts, Reconciled
        condition). Returns a change summary {applied: [...],
        deleted: [...]} (for events/logs)."""
        name = cr["metadata"]["name"]
        ns = cr["metadata"].get("namespace", "default")
        try:
            desired = {_key(m): m for m in render_manifests(cr)}
            observed = {_key(o): o for o in self.client.list_managed(ns, name)}

            applied, deleted = [], []
            for key, manifest in desired.items():
                serialized = json.dumps(manifest, sort_keys=True)
                # re-apply on spec change AND on external deletion — the
                # cache alone would never repair drift (e.g. kubectl
                # delete of a child)
                if self._applied.get(key) != serialized or key not in observed:
                    self.client.apply(manifest)
                    self._applied[key] = serialized
                    applied.append(key)

            for key, obj in observed.items():
                if key not in desired:
                    self.client.delete(
                        obj["kind"],
                        obj["metadata"].get("namespace", "default"),
                        obj["metadata"]["name"],
                    )
                    self._applied.pop(key, None)
                    deleted.append(key)
        except Exception as e:
            self.write_status(cr, error=str(e))
            raise
        counts: Dict[str, int] = {}
        for m in desired.values():
            counts[m["kind"]] = counts.get(m["kind"], 0) + 1
        self.write_status(
            cr, children=counts,
            changed=bool(applied or deleted),
        )
        return {"applied": applied, "deleted": deleted}

    def write_status(self, cr: dict, children: Optional[Dict[str, int]] = None,
                     error: Optional[str] = None,
                     changed: bool = False) -> None:
        """Best-effort CR status write (failures must never fail the
        reconcile itself)."""
        condition = {
            "type": "Reconciled",
            "status": "False" if error else "True",
            "reason": "ReconcileError" if error else "ReconcileSucceeded",
            "message": error or (
                "children updated" if changed else "in sync"
            ),
            "lastTransitionTime": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
        }
        status = {
            "observedGeneration": cr["metadata"].get("generation"),
            "children": children or {},
            "conditions": [condition],
        }
        artifact = (cr.get("spec") or {}).get("artifact") or {}
        if artifact.get("version"):
            # artifact-pinned deploys surface what they run (sdk.build
            # content-addressed version) in the CR status
            status["artifactVersion"] = artifact["version"]
            if artifact.get("name"):
                status["artifactName"] = artifact["name"]
        cr_key = (cr["metadata"].get("namespace", "default"),
                  cr["metadata"]["name"])
        prev = self._status_written.get(cr_key)
        if prev is not None:
            prev_cond = prev["conditions"][0]
            if prev_cond["status"] == condition["status"]:
                # same condition state → keep the original transition
                # time; and if nothing else changed, skip the patch
                condition["lastTransitionTime"] = prev_cond["lastTransitionTime"]
                if prev == status:
                    return
        try:
            (self._status_writer or self.client.update_status)(cr, status)
            self._status_written[cr_key] = status
        except Exception:
            logger.exception(
                "status update failed for %s/%s",
                cr["metadata"].get("namespace", "default"),
                cr["metadata"]["name"],
            )

    def finalize(self, cr: dict) -> List[str]:
        """CR deleted: remove every managed child."""
        name = cr["metadata"]["name"]
        ns = cr["metadata"].get("namespace", "default")
        removed = []
        for observed in self.client.list_managed(ns, name):
            self.client.delete(
                observed["kind"],
                observed["metadata"].get("namespace", "default"),
                observed["metadata"]["name"],
            )
            self._applied.pop(_key(observed), None)
            removed.append(_key(observed))
        return removed


def cr_key(cr: dict) -> tuple:
    """(namespace, name) — same-named CRs in different namespaces are
    distinct graphs."""
    return (cr["metadata"].get("namespace", "default"), cr["metadata"]["name"])


def safe_reconcile(reconciler: Reconciler, cr: dict) -> bool:
    """Reconcile one CR; log instead of raising (one bad CR or one
    transient kubectl error must not take a control loop down). False =
    failed, caller should arrange a retry sooner than the next resync."""
    try:
        changes = reconciler.reconcile(cr)
        if changes["applied"] or changes["deleted"]:
            logger.info("reconciled %s/%s: %s", *cr_key(cr), changes)
        return True
    except Exception:
        logger.exception("reconcile failed for %s/%s", *cr_key(cr))
        return False


def safe_finalize(reconciler: Reconciler, cr: dict) -> bool:
    try:
        reconciler.finalize(cr)
        return True
    except Exception:
        logger.exception("finalize failed for %s/%s", *cr_key(cr))
        return False


def relist_reconcile(
    reconciler: Reconciler,
    listed: List[dict],
    seen: Dict[tuple, dict],
) -> Dict[tuple, dict]:
    """One full-state pass shared by the poll and watch loops: reconcile
    every listed CR, finalize every previously-seen CR that vanished
    from the listing. Returns the new ``seen`` map."""
    current = {cr_key(c): c for c in listed}
    for cr in current.values():
        safe_reconcile(reconciler, cr)
    for key, cr in seen.items():
        if key not in current:
            logger.info("finalizing deleted CR %s/%s", key[0], key[1])
            if not safe_finalize(reconciler, cr):
                # children remain for now; the CR stays absent from every
                # later listing, so the next pass retries the teardown
                current[key] = cr  # keep it in seen for the retry
    return current


def control_loop(
    reconciler: Reconciler,
    get_crs,                 # () -> List[dict] current CRs
    interval: float = 10.0,
    stop=None,               # threading.Event-like; None = run forever
) -> None:
    """Poll-based control loop (watch-based callers use watch.watch_loop
    instead; both share relist_reconcile)."""
    seen: Dict[tuple, dict] = {}
    while stop is None or not stop.is_set():
        listed = get_crs()
        if listed is not None:
            seen = relist_reconcile(reconciler, listed, seen)
        # listed None = listing failed — do NOT mistake it for "no CRs"
        # (which would finalize everything); retry next cycle
        if stop is not None and stop.wait(interval):
            break
        if stop is None:
            time.sleep(interval)
