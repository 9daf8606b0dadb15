"""Inference-graph composition: @service, @dynamo_endpoint, depends, link.

The port's copy of ``dynamo_tpu/sdk/service.py`` (the upstream SDK's
surface, reference: deploy/dynamo/sdk/src/dynamo/sdk/lib/{service,
decorators,dependency}.py: ``@service(dynamo={...}, resources={...},
workers=N)``, ``@dynamo_endpoint``, ``depends(Other)`` proxying endpoint
streams, and graphs like ``Frontend.link(Processor).link(Worker)``) over
the port's runtime: component = service name, endpoint = decorated
method, transport = the dynstore and memory planes of
``dynamo_tpu_torch.runtime``. A service asks for cards with
``resources={"gpu": n}``; ``{"tpu": n}`` raises by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Set

from .allocator import refuse_tpu

_ENDPOINT_ATTR = "__dynamo_endpoint__"
_ON_START_ATTR = "__dynamo_on_start__"


def dynamo_endpoint(name: Optional[str] = None):
    """Mark an async-generator method as a served endpoint."""

    def wrap(fn):
        setattr(fn, _ENDPOINT_ATTR, name or fn.__name__)
        return fn

    # bare usage: @dynamo_endpoint over the function itself
    if callable(name):
        fn, name = name, None
        return wrap(fn)
    return wrap


def async_on_start(fn):
    """Mark an async method to run once before the endpoints serve."""
    setattr(fn, _ON_START_ATTR, True)
    return fn


class Dependency:
    """Declared with ``depends(Other)`` as a class attribute; resolved to a
    DynamoClient when the worker runner instantiates the service."""

    def __init__(self, target: "ServiceDefinition"):
        if not isinstance(target, ServiceDefinition):
            raise TypeError("depends() takes a @service-decorated class")
        self.target = target

    def __repr__(self):
        return f"depends({self.target.name})"


def depends(target: "ServiceDefinition") -> Dependency:
    return Dependency(target)


@dataclasses.dataclass
class ServiceSpec:
    namespace: str = "public"
    enabled: bool = True
    resources: Dict[str, Any] = dataclasses.field(default_factory=dict)
    workers: int = 1


class ServiceDefinition:
    """A @service-decorated class: its metadata and graph edges."""

    def __init__(self, cls: type, spec: ServiceSpec):
        self.cls = cls
        self.name = cls.__name__
        self.spec = spec
        self.endpoints: Dict[str, str] = {}   # endpoint name -> method name
        self.on_start: List[str] = []
        self.dependencies: Dict[str, Dependency] = {}
        self.links: List["ServiceDefinition"] = []
        # the whole MRO, so endpoints, hooks and depends declared on base
        # classes count; the more derived definition wins
        attrs: Dict[str, Any] = {}
        for klass in reversed(cls.__mro__):
            attrs.update(vars(klass))
        for attr, value in attrs.items():
            if callable(value) and hasattr(value, _ENDPOINT_ATTR):
                self.endpoints[getattr(value, _ENDPOINT_ATTR)] = attr
            if callable(value) and getattr(value, _ON_START_ATTR, False):
                self.on_start.append(attr)
            if isinstance(value, Dependency):
                self.dependencies[attr] = value

    def link(self, other: "ServiceDefinition") -> "ServiceDefinition":
        """Add a graph edge self → other; returns ``other`` so chains read
        Frontend.link(Processor).link(Worker) as the reference graphs do."""
        if other not in self.links:
            self.links.append(other)
        return other

    def unlink_all(self) -> None:
        """Drop this service's graph edges (links are process-global: one
        graph per process in production; tests that compose several graphs
        over the same services reset between them)."""
        self.links.clear()

    def endpoint_path(self, endpoint: str) -> str:
        return f"dyn://{self.spec.namespace}.{self.name}.{endpoint}"

    def __repr__(self):
        return f"<service {self.name} endpoints={sorted(self.endpoints)}>"


def service(
    cls: Optional[type] = None,
    *,
    dynamo: Optional[dict] = None,
    resources: Optional[dict] = None,
    workers: int = 1,
):
    """Class decorator declaring a deployable service."""

    def wrap(cls: type) -> ServiceDefinition:
        refuse_tpu(resources, f"@service {cls.__name__}")
        dyn = dynamo or {}
        spec = ServiceSpec(
            namespace=dyn.get("namespace", "public"),
            enabled=dyn.get("enabled", True),
            resources=resources or {},
            workers=workers,
        )
        return ServiceDefinition(cls, spec)

    return wrap(cls) if cls is not None else wrap


def graph_services(root: ServiceDefinition) -> List[ServiceDefinition]:
    """Every service reachable from ``root`` over links and dependencies,
    in a fixed discovery order (root first)."""
    seen: Set[int] = set()
    out: List[ServiceDefinition] = []

    def visit(svc: ServiceDefinition) -> None:
        if id(svc) in seen:
            return
        seen.add(id(svc))
        out.append(svc)
        for dep in svc.dependencies.values():
            visit(dep.target)
        for linked in svc.links:
            visit(linked)

    visit(root)
    return out


class DynamoClient:
    """A resolved ``depends``: one attribute per target endpoint, each an
    async-generator call routed through the runtime's Client."""

    def __init__(self, target: ServiceDefinition, drt, router_mode=None):
        from ..runtime.client import Client, RouterMode

        self._target = target
        self._clients: Dict[str, Any] = {}
        ns = drt.namespace(target.spec.namespace)
        comp = ns.component(target.name)
        for ep_name in target.endpoints:
            client = Client(
                comp.endpoint(ep_name), router_mode or RouterMode.ROUND_ROBIN
            )
            self._clients[ep_name] = client

    async def start(self) -> "DynamoClient":
        for client in self._clients.values():
            await client.start()
        return self

    async def wait_ready(self, timeout: float = 10.0) -> None:
        for client in self._clients.values():
            await client.wait_for_instances(timeout=timeout)

    def __getattr__(self, name: str) -> Callable[[Any], AsyncIterator[Any]]:
        try:
            client = self._clients[name]
        except KeyError:
            raise AttributeError(
                f"{self._target.name} has no endpoint {name!r}; "
                f"available: {sorted(self._clients)}"
            ) from None

        def call(payload: Any) -> AsyncIterator[Any]:
            from ..runtime.engine import Context

            return client.generate(Context(payload))

        return call
