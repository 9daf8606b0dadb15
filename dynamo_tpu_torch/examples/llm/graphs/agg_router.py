"""Aggregated serving with KV-aware routing: Frontend -> Processor ->
Router -> Worker (reference: examples/llm/graphs/agg_router.py)."""

from ..components import Frontend, Processor, Router, Worker

Frontend.link(Processor).link(Router).link(Worker)
