"""llmctl: manage the models the HTTP frontend serves and the graph
deployments of the api-store.

The port's copy of ``dynamo_tpu/cli/llmctl.py``: ``http add`` writes the
ModelEntry record (``{name, endpoint, model_type}`` under
``<ns>/models/<type>/<name>``, not lease-scoped, so it outlives this
short-lived process) that the front's ``ModelWatcher`` reads; ``http
remove`` deletes it; ``http list`` prints them. ``deploy
create|update|get|list|delete`` manage the api-store's deployment records
(``deploy/store_source.ApiStoreClient``), which the operator reconciles.

    python3 -m dynamo_tpu_torch.cli.llmctl --store-port 4871 http add chat-models m8b dyn://public.backend.generate
    python3 -m dynamo_tpu_torch.cli.llmctl --store-port 4871 http list
    python3 -m dynamo_tpu_torch.cli.llmctl --store-port 4871 http remove chat-models m8b
    python3 -m dynamo_tpu_torch.cli.llmctl deploy create graph -f graph.json --api-store http://127.0.0.1:8790
    python3 -m dynamo_tpu_torch.cli.llmctl deploy list --api-store http://127.0.0.1:8790

    python3 -m dynamo_tpu_torch.cli.llmctl deploy create graph --from-artifact agg-ab12cd34ef56.dyn.tar.gz --api-store http://127.0.0.1:8790

A spec file is JSON (YAML too where the ``yaml`` package is installed).
``--from-artifact`` renders the spec from a graph artifact
(``sdk/build.py``: ``deployment_spec(inspect_artifact(tarball))``); ``-f``
alone gives the spec, or with it overlays fields on the rendered one.
"""

from __future__ import annotations

import argparse
import asyncio
import json
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
    dep = sub.add_parser(
        "deploy", help="manage graph deployments via the api-store")
    # shared by every deploy leaf so the flag works in any position
    store_opt = argparse.ArgumentParser(add_help=False)
    store_opt.add_argument("--api-store", default="http://127.0.0.1:8790",
                           help="api-store base URL")
    dsub = dep.add_subparsers(dest="action", required=True)
    dc = dsub.add_parser("create", parents=[store_opt],
                         help="register a graph deployment spec")
    dc.add_argument("name")
    dc.add_argument("-f", "--file",
                    help="JSON (or YAML) deployment spec — the CR spec: "
                         "{services: {...}, modelName: ...}")
    dc.add_argument("--from-artifact", metavar="TARBALL",
                    help="render the spec from a built graph artifact "
                         "(python -m dynamo_tpu_torch.sdk.build); -f then "
                         "overlays fields on it")
    du = dsub.add_parser("update", parents=[store_opt])
    du.add_argument("name")
    du.add_argument("-f", "--file")
    du.add_argument("--from-artifact", metavar="TARBALL")
    dg = dsub.add_parser("get", parents=[store_opt])
    dg.add_argument("name")
    dsub.add_parser("list", parents=[store_opt])
    dd = dsub.add_parser("delete", parents=[store_opt])
    dd.add_argument("name")
    return p


def _load_spec(path: str) -> dict:
    """A spec file: JSON, or YAML where the ``yaml`` package exists."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        try:
            import yaml
        except ImportError:
            raise SystemExit(
                f"{path} is not JSON ({e}) and the yaml package is not "
                f"installed to read it as YAML: give a JSON spec") from None
        return yaml.safe_load(text)


def run_deploy(args) -> int:
    """The deploy-plane commands (synchronous; no distributed runtime)."""
    from ..deploy.store_source import ApiStoreClient

    client = ApiStoreClient(args.api_store)

    def _resolve_spec() -> dict:
        """--from-artifact renders the spec from the manifest; -f (alone or
        on top) gives or overlays the spec's fields."""
        artifact = getattr(args, "from_artifact", None)
        if not artifact and not args.file:
            raise SystemExit("one of -f/--file or --from-artifact is required")
        spec: dict = {}
        if artifact:
            import tarfile

            from ..sdk.allocator import AllocationError
            from ..sdk.build import deployment_spec, inspect_artifact

            try:
                spec = deployment_spec(inspect_artifact(artifact))
            except (OSError, ValueError, tarfile.TarError,
                    AllocationError) as e:
                # an unreadable artifact, or one that asks for a tpu
                raise SystemExit(
                    f"llmctl deploy --from-artifact {artifact}: {e}") from None
        if args.file:
            overlay = _load_spec(args.file)
            services = {**spec.get("services", {}),
                        **overlay.get("services", {})}
            spec = {**spec, **overlay}
            if services:
                spec["services"] = services
        return spec

    if args.action == "create":
        spec = _resolve_spec()
        rec = client.create(args.name, spec)
        ver = (spec.get("artifact") or {}).get("version")
        print(f"created deployment {rec['name']}"
              + (f" (artifact {ver})" if ver else ""))
        return 0
    if args.action == "update":
        rec = client.update(args.name, _resolve_spec())
        print(f"updated deployment {rec['name']}")
        return 0
    if args.action == "get":
        rec = client.get(args.name)
        if rec is None:
            print(f"deployment {args.name!r} not found")
            return 1
        print(json.dumps(rec, indent=2))
        return 0
    if args.action == "list":
        records = client.list()
        if not records:
            print("(no deployments)")
        for rec in records:
            conds = (rec.get("status") or {}).get("conditions") or []
            health = conds[0]["status"] if conds else "-"
            print(f"{rec['name']:30s} reconciled={health:6s} "
                  f"services={len(rec['spec'].get('services') or {})}")
        return 0
    if args.action == "delete":
        client.delete(args.name)
        print(f"deleted deployment {args.name}")
        return 0
    return 2


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
        return run_deploy(args)
    if args.store_port is None:
        print("--store-port is required for the http plane")
        return 2
    drt = await DistributedRuntime.connect(args.store_host, args.store_port)
    try:
        return await run(args, drt)
    finally:
        await drt.close()


def main() -> None:
    from ..utils.logging import setup_logging

    setup_logging(logging.WARNING)
    raise SystemExit(asyncio.run(amain(sys.argv[1:])))


if __name__ == "__main__":
    main()
