"""Python SDK: declare inference graphs, serve them locally or distributed.

The port's copy of ``dynamo_tpu/sdk`` (the upstream SDK's surface,
reference: deploy/dynamo/sdk: @service / @dynamo_endpoint / depends /
ServiceConfig / dynamo serve / dynamo build):

    from dynamo_tpu_torch.sdk import service, dynamo_endpoint, depends

    @service(dynamo={"namespace": "public"}, resources={"gpu": 1})
    class Worker:
        @dynamo_endpoint
        async def generate(self, request):
            yield {"text": "..."}

    @service(workers=2)
    class Frontend:
        worker = depends(Worker)
        @dynamo_endpoint
        async def chat(self, request):
            async for out in self.worker.generate(request):
                yield out

    Frontend.link(Worker)   # a graph edge, the reference's chaining

Serve in one process (tests, one host) with
serving.serve_graph_inprocess, or one process per worker with
serving.GraphSupervisor (cards handed out per worker by
allocator.GpuAllocator through CUDA_VISIBLE_DEVICES); package a graph
with build.build_artifact. Nothing here imports torch.
"""

from .allocator import AllocationError, GpuAllocator
from .config import ServiceConfig
from .service import (
    Dependency,
    DynamoClient,
    ServiceDefinition,
    async_on_start,
    depends,
    dynamo_endpoint,
    graph_services,
    service,
)
from .serving import GraphSupervisor, serve_graph_inprocess, stop_graph

__all__ = [
    "AllocationError",
    "GpuAllocator",
    "ServiceConfig",
    "Dependency",
    "DynamoClient",
    "ServiceDefinition",
    "async_on_start",
    "depends",
    "dynamo_endpoint",
    "graph_services",
    "service",
    "GraphSupervisor",
    "serve_graph_inprocess",
    "stop_graph",
    "serve_service",
]


def __getattr__(name):
    # ``worker`` is also a program (python -m dynamo_tpu_torch.sdk.worker):
    # the package imports it only when asked, so runpy finds it unimported
    if name == "serve_service":
        from .worker import serve_service

        return serve_service
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
