"""PyTorch/CUDA port of the dynamo-tpu serving engine.

A second package beside ``dynamo_tpu`` (the JAX reference). It imports
torch, numpy, jinja2 (a requirement of torch) and the standard library
only — never jax and nothing of ``dynamo_tpu`` — and keeps its own copy
of every module it needs. The layout mirrors the reference (``cli/``,
``engine/``, ``http/``, ``llm/``, ``models/``, ``ops/``, ``protocols/``,
``runtime/``, ``telemetry/``) so each module's counterpart is easy to
find. The attention kernels are hand-written CUDA C++ for Hopper
(``csrc/``), built at first use by ``ops/_build.py``.
"""
