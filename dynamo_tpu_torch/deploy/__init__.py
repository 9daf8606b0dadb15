"""Deployment plane: K8s operator, manifest rendering, api-store.

The port's copy of ``dynamo_tpu/deploy``: the operator renders pods that
run the port (``out=torch``, ``nvidia.com/gpu`` requests).

Reference analog: deploy/dynamo/{operator,api-store,helm} — the Go
operator reconciling DynamoDeployment CRDs into child Deployments, the
deployment-record REST store, and the helm platform chart. Here the
operator is Python (the rest of the framework's control plane already
is), built around pure manifest-rendering functions and a pluggable
cluster client so the reconcile logic is fully testable without a
cluster.
"""

from .operator import (
    InMemoryKube,
    KubectlClient,
    Reconciler,
    render_manifests,
)

__all__ = [
    "InMemoryKube",
    "KubectlClient",
    "Reconciler",
    "render_manifests",
]
