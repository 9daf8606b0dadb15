"""Aggregated serving: Frontend -> Processor -> Worker (reference:
examples/llm/graphs/agg.py)."""

from ..components import Frontend, Processor, Worker

Frontend.link(Processor).link(Worker)
