"""Bring-your-own Python engine: ``out=pystr:<file.py>`` / ``out=pytok:<file.py>``.

The port's copy of ``dynamo_tpu/llm/engines/python_file.py``. A user's
file is imported and streamed from its ``generate`` async generator;
``pystr`` serves it at the OpenAI level, ``pytok`` at the token level
behind the preprocessor and the detokenizing backend.

User file contract::

    async def generate(request: dict):        # REQUIRED async generator
        yield {...}                           # response chunks (dicts)

    async def initialize(engine_args: dict):  # optional, awaited once

pystr requests are OpenAI request dicts and chunks are OpenAI chunk dicts;
pytok requests are ``PreprocessedRequest`` wire dicts and chunks are
``EngineOutput`` wire dicts (``protocols/common.py``).
"""

from __future__ import annotations

import importlib.util
import inspect
import os
from typing import Any, AsyncIterator, Optional

from ...runtime.engine import AsyncEngine, Context


def to_wire(payload: Any) -> Any:
    """A request payload as the plain dict a user's engine receives."""
    if hasattr(payload, "model_dump"):
        return payload.model_dump(exclude_none=True)
    if hasattr(payload, "to_wire"):
        return payload.to_wire()
    return payload


class PythonFileEngine(AsyncEngine):
    def __init__(self, path: str, generate_fn):
        self.path = path
        self._generate = generate_fn

    @classmethod
    async def load(cls, path: str,
                   engine_args: Optional[dict] = None) -> "PythonFileEngine":
        if not os.path.exists(path):
            raise FileNotFoundError(f"python engine file not found: {path}")
        spec = importlib.util.spec_from_file_location(
            f"dynamo_pyengine_{abs(hash(path))}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        gen = getattr(module, "generate", None)
        if gen is None or not inspect.isasyncgenfunction(gen):
            raise TypeError(f"{path} must define `async def generate(request)` "
                            "as an async generator")
        init = getattr(module, "initialize", None)
        if init is not None:
            await init(engine_args or {})
        return cls(path, gen)

    async def generate(self, request: Context[Any]) -> AsyncIterator[Any]:
        async for chunk in self._generate(to_wire(request.payload)):
            if request.context.is_stopped:
                return
            yield chunk
