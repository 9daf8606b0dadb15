"""Core streaming-engine abstractions.

``AsyncEngine`` is THE central trait of the framework: everything that turns a
request into a stream of responses — the HTTP frontend's model handles, the
preprocessor/backend pipeline operators, network clients, and the serving engine
itself — implements it. Mirrors the reference's engine trait surface
(reference: lib/runtime/src/engine.rs:47-145 — AsyncEngine::generate,
AsyncEngineContext id/stop/kill, ResponseStream), re-designed on asyncio.
"""

from __future__ import annotations

import abc
import asyncio
import time
import uuid
from typing import Any, AsyncIterator, Dict, Generic, Optional, TypeVar

T = TypeVar("T")


class AsyncEngineContext:
    """Per-request control handle: identity plus cooperative cancellation.

    ``stop_generating`` asks the producer to finish early but still emit any
    buffered output; ``kill`` demands immediate termination. Both are sticky.

    The context also carries the request's trace: ``trace_id`` is the
    ingress-assigned correlation id (honoring ``X-Request-Id``, so it may
    repeat across requests) while ``id`` stays a per-request unique handle —
    engine and disagg-coordinator state is keyed by ``id``, so a client
    reusing a trace id cannot cross-wire another request's KV transfer or
    first-token future. ``stages`` records (name, monotonic time) span marks
    from every layer the request crosses — HTTP, scheduler
    admission/prefill/first-token, completion. Storing them HERE (not in
    pipeline baggage) means the scheduler, which only holds the
    AsyncEngineContext, can stamp spans too.
    """

    def __init__(self, request_id: Optional[str] = None,
                 trace_id: Optional[str] = None):
        self.id: str = request_id or uuid.uuid4().hex
        self.trace_id: str = trace_id or self.id
        self.stages: list = []  # [(stage_name, time.monotonic())]
        # wall anchor for span EXPORT: monotonic stamps are process-local,
        # so spans that cross a process boundary (the cluster-stitched
        # trace, telemetry/stitch.py) ship as wall-clock times derived
        # from this one (mono, wall) pair
        self._anchor = (time.monotonic(), time.time())
        # span sets collected from downstream processes (dial-back end
        # frames, remote-prefill commits, migration end frames), each a
        # stitch.remote_span_set dict with offsets relative to THIS
        # process's clock
        self.remote_spans: list = []
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()

    def add_stage(self, name: str) -> None:
        """Record a processing span mark (reference:
        pipeline/context.rs:125 add_stage)."""
        self.stages.append((name, time.monotonic()))

    def wall(self, t_monotonic: float) -> float:
        """Monotonic stamp → this process's wall clock (span export)."""
        return self._anchor[1] + (t_monotonic - self._anchor[0])

    def export_spans(self) -> list:
        """Span marks as ``[name, wall_time]`` pairs — the shape that
        piggybacks on response/commit frames for cross-process
        stitching (telemetry/stitch.py)."""
        return [[name, self.wall(t)] for name, t in self.stages]

    def add_remote_spans(self, span_set: dict) -> None:
        """Attach one downstream hop's folded span set (a
        stitch.remote_span_set dict) to this request's trace."""
        self.remote_spans.append(span_set)

    def merge_stages_from(self, children: list) -> None:
        """Fold per-choice child-context spans into this trace (the n>1 /
        best_of fan-out gives every choice its own context for cancellation
        isolation). Child stage names gain a ``#<choice>`` suffix and the
        combined list stays chronological, so /debug/requests/{id} shows
        engine spans for multi-choice requests too."""
        for i, child in enumerate(children):
            self.stages.extend(
                (f"{name}#{i}", t) for name, t in child.stages
            )
            # a choice served by a remote worker collected that worker's
            # span set — it belongs to the parent trace like the stages
            self.remote_spans.extend(child.remote_spans)
        self.stages.sort(key=lambda s: s[1])

    def stop_generating(self) -> None:
        self._stopped.set()

    def kill(self) -> None:
        self._stopped.set()
        self._killed.set()

    @property
    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    @property
    def is_killed(self) -> bool:
        return self._killed.is_set()

    async def wait_stopped(self) -> None:
        await self._stopped.wait()


class Context(Generic[T]):
    """A request travelling through a pipeline: payload + control + baggage.

    ``baggage`` is a typed-map analog of the reference's per-request Context
    (reference: lib/runtime/src/pipeline/context.rs:33-150) used by operators
    to pass side-channel data (e.g. the preprocessor stashes the tokenized
    prompt for the response path).
    """

    def __init__(
        self,
        payload: T,
        context: Optional[AsyncEngineContext] = None,
        baggage: Optional[Dict[str, Any]] = None,
    ):
        self.payload = payload
        self.context = context or AsyncEngineContext()
        self.baggage: Dict[str, Any] = baggage or {}

    @property
    def id(self) -> str:
        return self.context.id

    @property
    def trace_id(self) -> str:
        return self.context.trace_id

    def add_stage(self, name: str) -> None:
        """Record a processing stage + monotonic timestamp on the request
        (reference: pipeline/context.rs:125 add_stage). Stages live on the
        shared AsyncEngineContext, so they survive ``map`` AND are visible
        to token-level layers (the scheduler) that never see this wrapper;
        the frontend logs/records the per-stage latency breakdown at
        completion (telemetry/tracing.py)."""
        self.context.add_stage(name)

    @property
    def stages(self):
        return self.context.stages

    def map(self, new_payload: Any) -> "Context[Any]":
        """New payload, same identity/control/baggage."""
        return Context(new_payload, self.context, self.baggage)


class AsyncEngine(abc.ABC):
    """request → async stream of responses. Streaming-first, single method."""

    @abc.abstractmethod
    def generate(self, request: Context[Any]) -> AsyncIterator[Any]:
        """Returns an async iterator of responses for this request."""
        raise NotImplementedError

    async def close(self) -> None:  # optional lifecycle hook
        pass


class EngineError(Exception):
    """Engine could not be created / request rejected before streaming began.

    The network layer maps this onto the response-stream prologue so callers
    get a clean error instead of an empty stream (reference:
    lib/runtime/src/pipeline/network/egress/push.rs ResponseStreamPrologue).
    """


class EngineDrainingError(EngineError):
    """The engine is draining (recovery ladder / rolling update) and takes
    no new work. Transient by construction — the HTTP edge maps it to a
    retryable 503 (vs. EngineError's 400) so load balancers and clients
    re-dispatch to the pool instead of surfacing a client error."""
