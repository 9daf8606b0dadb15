"""Disaggregated serving with KV-aware routing, the flagship graph
(reference: examples/llm/graphs/disagg_router.py)."""

from ..components import Frontend, PrefillWorker, Processor, Router, Worker

Frontend.link(Processor).link(Router).link(Worker).link(PrefillWorker)
