"""Pipeline composition: operators around a terminal engine.

The reference wires request pipelines as a doubly-linked chain of nodes
(frontend → operator forward edges → engine → operator backward edges →
frontend; reference: lib/runtime/src/pipeline/nodes.rs,
launch/dynamo-run/src/input/common.rs:77-100). The idiomatic asyncio
re-design: an ``Operator`` transforms the request on the way in and the
response stream on the way out, and ``build_pipeline`` composes operators
middleware-style into a single ``AsyncEngine``. A composed pipeline can be
served over the network (``Endpoint.serve``) or called in-process — the
segment source/sink split falls out for free because ``Client`` is itself
an ``AsyncEngine``.
"""

from __future__ import annotations

import abc
from typing import Any, AsyncIterator, Sequence

from .engine import AsyncEngine, Context


class Operator(abc.ABC):
    """Bidirectional request/response transform."""

    @abc.abstractmethod
    def generate(self, request: Context[Any], next_engine: AsyncEngine) -> AsyncIterator[Any]:
        """Transform request, call ``next_engine``, transform its stream."""


class _OperatorEngine(AsyncEngine):
    def __init__(self, operator: Operator, next_engine: AsyncEngine):
        self.operator = operator
        self.next_engine = next_engine

    def generate(self, request: Context[Any]) -> AsyncIterator[Any]:
        return self.operator.generate(request, self.next_engine)

    async def close(self) -> None:
        await self.next_engine.close()


def build_pipeline(operators: Sequence[Operator], engine: AsyncEngine) -> AsyncEngine:
    """Compose ``operators`` (outermost first) around ``engine``."""
    current = engine
    for op in reversed(list(operators)):
        current = _OperatorEngine(op, current)
    return current
