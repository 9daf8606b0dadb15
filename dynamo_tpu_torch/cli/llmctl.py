"""llmctl: manage the models the HTTP frontend serves from discovery.

The port's copy of ``dynamo_tpu/cli/llmctl.py``: ``http add`` writes the
ModelEntry record (``{name, endpoint, model_type}`` under
``<ns>/models/<type>/<name>``, not lease-scoped, so it outlives this
short-lived process) that the front's ``ModelWatcher`` reads; ``http
remove`` deletes it; ``http list`` prints them.

    python3 -m dynamo_tpu_torch.cli.llmctl --store-port 4871 http add chat-models m8b dyn://public.backend.generate
    python3 -m dynamo_tpu_torch.cli.llmctl --store-port 4871 http list
    python3 -m dynamo_tpu_torch.cli.llmctl --store-port 4871 http remove chat-models m8b

The reference's ``deploy`` plane (graph deployments through the
api-store) is refused by name: it waits for the port of
``deploy/store_source.ApiStoreClient``.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys
from typing import List

from ..http.service import (
    list_models,
    parse_endpoint_path,
    register_model,
    unregister_model,
)
from ..runtime.component import DistributedRuntime

# CLI model-kind words → registry model_type
KINDS = {
    "chat-models": "chat",
    "completion-models": "completions",
    "models": "both",
}

DEPLOY_REFUSED = (
    "llmctl deploy is not served by the PyTorch port: graph deployments go "
    "through the api-store client (deploy/store_source.ApiStoreClient), "
    "which is not ported yet")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llmctl")
    p.add_argument("--store-host", default="127.0.0.1")
    p.add_argument("--store-port", type=int, default=None,
                   help="dynstore port (required for the http plane)")
    p.add_argument("--namespace", default="public")
    sub = p.add_subparsers(dest="plane", required=True)
    http = sub.add_parser("http", help="manage the HTTP frontend's models")
    hsub = http.add_subparsers(dest="action", required=True)
    add = hsub.add_parser("add")
    add.add_argument("kind", choices=sorted(KINDS))
    add.add_argument("name")
    add.add_argument("endpoint", help="dyn://ns.comp.ep")
    rm = hsub.add_parser("remove")
    rm.add_argument("kind", choices=sorted(KINDS))
    rm.add_argument("name")
    hsub.add_parser("list")
    dep = sub.add_parser("deploy", help="refused: " + DEPLOY_REFUSED)
    dep.add_argument("rest", nargs=argparse.REMAINDER)
    return p


async def run(args, drt: DistributedRuntime) -> int:
    if args.action == "add":
        try:
            # the front's model watcher parses the same way: a malformed
            # address must fail here, not there
            parse_endpoint_path(args.endpoint)
        except ValueError as e:
            print(f"bad endpoint {args.endpoint!r}: {e}")
            return 2
        await register_model(drt, args.namespace, args.name, args.endpoint,
                             model_type=KINDS[args.kind], lease_scoped=False)
        print(f"added {KINDS[args.kind]} model {args.name} -> {args.endpoint}")
        return 0
    if args.action == "remove":
        await unregister_model(drt, args.namespace, args.name, KINDS[args.kind])
        print(f"removed {KINDS[args.kind]} model {args.name}")
        return 0
    if args.action == "list":
        models = await list_models(drt, args.namespace)
        if not models:
            print("(no models registered)")
        for m in models:
            print(f"{m.get('model_type', '?'):12s} {m['name']:30s} {m['endpoint']}")
        return 0
    return 2


async def amain(argv: List[str]) -> int:
    args = build_parser().parse_args(argv)
    if args.plane == "deploy":
        raise SystemExit(DEPLOY_REFUSED)
    if args.store_port is None:
        print("--store-port is required for the http plane")
        return 2
    drt = await DistributedRuntime.connect(args.store_host, args.store_port)
    try:
        return await run(args, drt)
    finally:
        await drt.close()


def main() -> None:
    logging.basicConfig(level=logging.WARNING)
    raise SystemExit(asyncio.run(amain(sys.argv[1:])))


if __name__ == "__main__":
    main()
