"""Graph supervisor: one process per service worker, cards handed out.

The port's copy of ``dynamo_tpu/sdk/serving.py`` (the ``dynamo serve``
analog, reference: deploy/dynamo/sdk/src/dynamo/sdk/cli/serving.py:
130-505, circus watchers per service). Spawns ``python -m
dynamo_tpu_torch.sdk.worker`` per worker with its cards from the
``GpuAllocator`` (``CUDA_VISIBLE_DEVICES``; ``""`` for a service that asks
for none), watches the children, and tears the group down together.

Also ``serve_graph_inprocess``: every service bound in one process over
one DistributedRuntime, the test harness and the one-host fast path (no
process or serialisation between services that fit one host).
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..runtime.component import DistributedRuntime
from .allocator import GpuAllocator
from .config import ServiceConfig
from .service import ServiceDefinition, graph_services

logger = logging.getLogger(__name__)

WORKER_MODULE = "dynamo_tpu_torch.sdk.worker"


class GraphSupervisor:
    def __init__(
        self,
        graph_spec: str,           # module:Attr for the worker processes
        root: ServiceDefinition,
        store_host: str = "127.0.0.1",
        store_port: int = 4871,
        config_file: Optional[str] = None,
        allocator: Optional[GpuAllocator] = None,
        stdout=None,
    ):
        self.graph_spec = graph_spec
        self.root = root
        self.store_host = store_host
        self.store_port = store_port
        self.config_file = config_file
        self.allocator = allocator or GpuAllocator()
        self.stdout = stdout       # the children's stdout (default: ours)
        self.procs: List[subprocess.Popen] = []
        self._proc_gpus: Dict[int, List[int]] = {}  # pid → its cards
        # pid → (service, CUDA_VISIBLE_DEVICES it was given, monotonic start)
        self.started: Dict[int, tuple] = {}

    def start(self) -> None:
        try:
            for svc in graph_services(self.root):
                if not svc.spec.enabled:
                    continue
                for worker_idx in range(svc.spec.workers):
                    env = dict(os.environ)
                    extra, gpus = self.allocator.env_for(svc.spec.resources)
                    env.update(extra)
                    cmd = [
                        sys.executable, "-m", WORKER_MODULE,
                        self.graph_spec, "--service", svc.name,
                        "--store-host", self.store_host,
                        "--store-port", str(self.store_port),
                    ]
                    if self.config_file:
                        cmd += ["--config-file", self.config_file]
                    try:
                        proc = subprocess.Popen(cmd, env=env,
                                                stdout=self.stdout)
                    except Exception:
                        # the cards were assigned but no process will own
                        # them: give them back before unwinding
                        self.allocator.release(gpus)
                        raise
                    logger.info(
                        "started %s worker %d (pid %d, CUDA_VISIBLE_DEVICES=%r)",
                        svc.name, worker_idx, proc.pid,
                        extra["CUDA_VISIBLE_DEVICES"])
                    self.procs.append(proc)
                    self._proc_gpus[proc.pid] = gpus
                    self.started[proc.pid] = (
                        svc.name, extra["CUDA_VISIBLE_DEVICES"],
                        time.monotonic())
        except Exception:
            # e.g. an AllocationError mid-graph: leave no earlier worker
            # running with cards held
            self.stop()
            raise

    def poll(self) -> Dict[int, Optional[int]]:
        """pid → returncode (None while running)."""
        return {p.pid: p.poll() for p in self.procs}

    def stop(self, timeout: float = 10.0) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in self.procs:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            self.allocator.release(self._proc_gpus.pop(p.pid, []))
        self.procs.clear()


async def serve_graph_inprocess(
    root: ServiceDefinition,
    drt: Optional[DistributedRuntime] = None,
    config: Optional[ServiceConfig] = None,
):
    """Bind every service of ``root``'s graph in this process.

    Leaves start first, so a depends() target is discoverable before its
    consumer resolves its client. Returns (drt, handles, objects):
    ``objects`` maps service name → live instance (e.g. to reach the
    Frontend's bound HTTP port); the caller shuts down with
    ``stop_graph``.
    """
    from .worker import serve_service

    drt = drt or DistributedRuntime.in_process()
    services = list(reversed(graph_services(root)))  # leaves first
    all_handles = []
    objects: Dict[str, object] = {}
    for svc in services:
        if not svc.spec.enabled:
            continue
        obj, handles = await serve_service(svc, drt, config)
        objects[svc.name] = obj
        all_handles.extend(handles)
    return drt, all_handles, objects


async def stop_graph(drt: DistributedRuntime, handles,
                     objects: Optional[Dict[str, object]] = None) -> None:
    """Close the services in ``objects`` (roots first: a Frontend drains
    and stops taking requests before the engine its Worker serves goes),
    stop serving the endpoints, then close the runtime."""
    from .worker import close_service

    for obj in reversed(list((objects or {}).values())):
        await close_service(obj, [])
    for h in handles:
        await h.stop()
    await drt.close()
