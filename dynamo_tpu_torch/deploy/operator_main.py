"""Operator binary: reconcile DynamoTpuGraphDeployment CRs via kubectl
or the API server's REST (the in-cluster entrypoint).

The port's copy of ``dynamo_tpu/deploy/operator_main.py``:
``python -m dynamo_tpu_torch.deploy.operator_main`` with the reference's
flags. CRs sourced from the api-store (``--api-store-url``) force the poll
loop, as in the reference (the store has no watch API).

Reference analog: deploy/dynamo/operator cmd/main.go. Two drive modes:
the default watch loop (kubectl --watch events + relist-on-reconnect,
matching controller-runtime's informer+resync semantics) and a plain
poll loop (--poll) for API servers where long watches are awkward.
``--leader-elect`` arbitrates replicas through a coordination.k8s.io
Lease, like the Go operator's LeaderElection flag.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import threading

from ..utils.logging import setup_logging
from .operator import GROUP, PLURAL, KubectlClient, Reconciler, control_loop

logger = logging.getLogger(__name__)


def get_crs(kubectl: str = "kubectl", namespace: str | None = None):
    """List CRs, or None when the listing itself failed — the loop must
    skip that cycle; treating a transient API error as "no CRs" would
    finalize (delete) every managed child cluster-wide."""
    args = [kubectl, "get", f"{PLURAL}.{GROUP}", "-o", "json"]
    args += ["-n", namespace] if namespace else ["--all-namespaces"]
    try:
        out = subprocess.run(
            args, capture_output=True, text=True, check=True
        ).stdout
    except subprocess.CalledProcessError as e:
        logger.warning("listing CRs failed: %s", e.stderr.strip())
        return None
    return json.loads(out).get("items", [])


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="dynamo-tpu operator")
    parser.add_argument("--interval", type=float, default=10.0)
    parser.add_argument("--namespace", default=None,
                        help="watch one namespace (default: all)")
    parser.add_argument("--kubectl", default="kubectl")
    parser.add_argument(
        "--kube-client", choices=("kubectl", "api"), default="kubectl",
        help="cluster access: shell out to kubectl, or talk REST to the "
             "API server directly (in-cluster serviceaccount, or "
             "--kube-api-url for an explicit endpoint)",
    )
    parser.add_argument("--kube-api-url", default=None,
                        help="API server base URL (api mode; default: "
                             "in-cluster serviceaccount discovery)")
    parser.add_argument("--poll", action="store_true",
                        help="poll every --interval instead of watching")
    parser.add_argument("--resync-interval", type=float, default=300.0,
                        help="watch mode: relist+reconcile at least this "
                             "often (the watch's request timeout)")
    parser.add_argument("--leader-elect", action="store_true",
                        help="run only while holding the operator Lease")
    parser.add_argument("--leader-elect-namespace", default="default")
    parser.add_argument("--identity", default=None,
                        help="leader-election identity (default: hostname)")
    parser.add_argument(
        "--api-store-url", default=None,
        help="reconcile deployments registered in the api-store instead "
             "of (or in addition to) cluster CRs; reconcile status is "
             "written back into the store record",
    )
    args = parser.parse_args(argv)
    setup_logging(logging.INFO)

    if args.kube_client == "api":
        from .kube_api import KubeApiClient

        kube = (
            KubeApiClient(args.kube_api_url) if args.kube_api_url
            else KubeApiClient.from_in_cluster()
        )
    else:
        kube = KubectlClient(args.kubectl)

    poll = args.poll
    if args.api_store_url:
        from .store_source import ApiStoreClient

        store = ApiStoreClient(args.api_store_url)
        reconciler = Reconciler(kube, status_writer=store.write_status)
        source = store.get_crs
        poll = True  # the store has no watch API; poll it
        logger.info("operator sourcing CRs from api-store %s every %.0fs",
                    args.api_store_url, args.interval)
    else:
        reconciler = Reconciler(kube)
        if args.kube_client == "api":
            source = lambda: kube.get_crs(args.namespace)  # noqa: E731
        else:
            source = lambda: get_crs(args.kubectl, args.namespace)  # noqa: E731
        logger.info("operator %s %s.%s via %s",
                    "polling" if poll else "watching", PLURAL, GROUP,
                    args.kube_client)

    stop = threading.Event()  # set only by a lost leader lease
    if poll:
        drive = lambda: control_loop(  # noqa: E731
            reconciler, source, interval=args.interval, stop=stop)
    else:
        from .watch import KubectlWatchSource, watch_loop

        if args.kube_client == "api":
            open_stream = lambda: kube.open_watch(  # noqa: E731
                args.namespace,
                timeout_seconds=int(args.resync_interval),
            )
        else:
            open_stream = KubectlWatchSource(
                args.kubectl, args.namespace,
                resync_interval_s=args.resync_interval,
            )
        drive = lambda: watch_loop(  # noqa: E731
            reconciler, source, open_stream, stop=stop)

    if args.leader_elect:
        import socket

        from .leader import KubectlLeases, LeaderElector

        if args.kube_client == "api":
            # lease CAS over the same REST client — no kubectl binary
            # needed in the image for any operator feature
            from .kube_api import KubeApiLeases

            leases = KubeApiLeases(kube)
        else:
            leases = KubectlLeases(args.kubectl)
        elector = LeaderElector(
            leases,
            identity=args.identity or socket.gethostname(),
            namespace=args.leader_elect_namespace,
        )
        elector.run(stop, drive)
    else:
        drive()


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:  # SIGINT ends the control loop
        pass
