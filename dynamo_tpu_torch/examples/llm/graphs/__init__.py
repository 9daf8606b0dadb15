"""The graphs of ``examples/llm/components.py``: each module links its chain
at import time (one graph per process)."""
