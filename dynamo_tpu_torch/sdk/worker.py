"""A worker process's entry point: bind one @service class to the runtime.

The port's copy of ``dynamo_tpu/sdk/worker.py`` (the upstream
``serve_dynamo``, reference: deploy/dynamo/sdk/src/dynamo/sdk/cli/
serve_dynamo.py:38-184: connect the runtime, create the service, resolve
its dependencies, run its ``async_on_start`` hooks, serve its endpoints).
The supervisor (``sdk/serving.py``) runs this module once per worker:

    python -m dynamo_tpu_torch.sdk.worker \\
        dynamo_tpu_torch.examples.llm.graphs.agg:Frontend --service Worker \\
        --store-port 4871 --config-file agg.json
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import inspect
import logging
import signal
import sys
from typing import List, Optional

from ..runtime.component import DistributedRuntime
from .config import ServiceConfig
from .service import DynamoClient, ServiceDefinition, graph_services

logger = logging.getLogger(__name__)


def load_graph_root(spec: str) -> ServiceDefinition:
    """'pkg.module:Attr' → the ServiceDefinition bound to Attr."""
    module_name, _, attr = spec.partition(":")
    if not attr:
        raise ValueError(f"graph spec {spec!r} must be module:Attr")
    module = importlib.import_module(module_name)
    root = getattr(module, attr)
    if not isinstance(root, ServiceDefinition):
        raise TypeError(f"{spec} is not a @service (got {type(root)})")
    return root


def find_service(root: ServiceDefinition, name: Optional[str]) -> ServiceDefinition:
    if name is None:
        return root
    for svc in graph_services(root):
        if svc.name == name:
            return svc
    raise LookupError(f"service {name!r} not in graph of {root.name}")


async def serve_service(
    svc: ServiceDefinition,
    drt: DistributedRuntime,
    config: Optional[ServiceConfig] = None,
):
    """Instantiate the service class, resolve its depends(), run its hooks
    and serve every endpoint. Returns (instance, [ServingEndpoint]). The
    instance carries ``service_config`` (its merged options), ``drt`` and
    ``resources`` (its declaration's, e.g. ``{"gpu": 1}``)."""
    obj = svc.cls()
    obj.service_config = (config or ServiceConfig.get_instance()).get(svc.name)
    obj.drt = drt
    obj.resources = dict(svc.spec.resources)

    for attr, dep in svc.dependencies.items():
        client = DynamoClient(dep.target, drt)
        await client.start()
        setattr(obj, attr, client)

    for method_name in svc.on_start:
        await getattr(obj, method_name)()

    comp = drt.namespace(svc.spec.namespace).component(svc.name)
    handles = []
    # a service may expose a worker's plumbing: a stats RPC payload
    # (ForwardPassMetrics for KV-aware routers) and a pinned instance id
    # matching its KV event publisher (examples/llm/components.py)
    stats_handler = getattr(obj, "stats_handler", None)
    instance_id = getattr(obj, "instance_id", None)
    for ep_name, method_name in svc.endpoints.items():
        method = getattr(obj, method_name)

        def make_handler(m):
            # an endpoint takes (request) or (request, ctx): the engine
            # context goes through so a cooperative stop reaches user code.
            # Only REQUIRED positional parameters count: an optional second
            # one (temperature=0.7) must not receive the Context
            required = [
                p for p in inspect.signature(m).parameters.values()
                if p.default is p.empty
                and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            ]
            wants_ctx = len(required) >= 2

            async def handler(payload, ctx):
                agen = m(payload, ctx) if wants_ctx else m(payload)
                async for item in agen:
                    if ctx.is_stopped:
                        break
                    yield item

            return handler

        serving = await comp.endpoint(ep_name).serve(
            make_handler(method),
            instance_id=instance_id,
            stats_handler=stats_handler,
        )
        handles.append(serving)
        logger.info("serving %s", svc.endpoint_path(ep_name))
    return obj, handles


async def close_service(obj, handles) -> None:
    """Stop serving, then run the instance's ``close()`` if it has one (the
    engine a Worker built, the HTTP server a Frontend started)."""
    for h in handles:
        await h.stop()
    close = getattr(obj, "close", None)
    if close is not None:
        await close()


async def amain(argv: List[str]) -> None:
    p = argparse.ArgumentParser(prog="dynamo-tpu-torch sdk worker")
    p.add_argument("graph", help="module:Attr of the graph root @service")
    p.add_argument("--service", default=None, help="service name (default: root)")
    p.add_argument("--store-host", default="127.0.0.1")
    p.add_argument("--store-port", type=int, required=True)
    p.add_argument("--config-file", default=None)
    args = p.parse_args(argv)

    root = load_graph_root(args.graph)
    svc = find_service(root, args.service)
    config = (
        ServiceConfig.from_file(args.config_file)
        if args.config_file
        else ServiceConfig.get_instance()
    )

    drt = await DistributedRuntime.connect(args.store_host, args.store_port)
    # SIGTERM / SIGINT (the supervisor's stop) takes the graceful path
    # below: deregister the endpoints, close the service, close the runtime
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, drt.runtime.shutdown)

    obj, handles = await serve_service(svc, drt, config)
    print(f"serving {svc.name} "
          f"{' '.join(svc.endpoint_path(e) for e in svc.endpoints)}", flush=True)
    try:
        await drt.runtime.wait_shutdown()
    finally:
        await close_service(obj, handles)
        await drt.close()


def main() -> None:
    from ..utils.logging import setup_logging
    setup_logging(logging.INFO)
    asyncio.run(amain(sys.argv[1:]))


if __name__ == "__main__":
    main()
