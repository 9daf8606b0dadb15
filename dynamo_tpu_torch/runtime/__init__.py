"""The distributed runtime: the streaming-engine abstractions, the two
planes (discovery and messaging, in process or over a dynstore broker),
the dial-back response streams and the Namespace → Component → Endpoint
model with its routed client. The port's copy of ``dynamo_tpu/runtime``;
its wire is ``runtime/wire.py``."""

from .client import Client, NoInstancesError, RouterMode
from .component import Component, DistributedRuntime, Endpoint, Namespace, Runtime
from .discovery import DiscoveryClient, Lease, WatchEvent, WatchEventType
from .engine import AsyncEngine, AsyncEngineContext, Context, EngineError
from .messaging import Message, MessagingClient, WorkItem
from .network import ResponseStreamError
from .pipeline import Operator, build_pipeline

__all__ = [
    "AsyncEngine",
    "AsyncEngineContext",
    "Client",
    "Component",
    "Context",
    "DiscoveryClient",
    "DistributedRuntime",
    "Endpoint",
    "EngineError",
    "Lease",
    "Message",
    "MessagingClient",
    "Namespace",
    "NoInstancesError",
    "Operator",
    "ResponseStreamError",
    "RouterMode",
    "Runtime",
    "WatchEvent",
    "WatchEventType",
    "WorkItem",
    "build_pipeline",
]
