"""Disaggregated prefill and decode: decode Workers hand long prefills to
PrefillWorkers over the namespace queue, their KV back over tcp
(reference: examples/llm/graphs/disagg.py)."""

from ..components import Frontend, PrefillWorker, Processor, Worker

Frontend.link(Processor).link(Worker).link(PrefillWorker)
