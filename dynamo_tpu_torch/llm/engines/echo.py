"""Echo engines: the GPU/TPU-free test engines every pipeline test uses.

Reference analog: lib/llm/src/engines.rs:78-178 — EchoEngineCore (token
level, configurable per-token delay via DYN_TOKEN_ECHO_DELAY_MS) and
EchoEngineFull (OpenAI level). These let the whole serving stack — HTTP,
preprocessor, backend, routing, disaggregation — run on any machine.
The port's copy of ``dynamo_tpu/llm/engines/echo.py``.
"""

from __future__ import annotations

import asyncio
import os
from typing import Any, AsyncIterator

from ...protocols.common import EngineOutput, FinishReason, PreprocessedRequest
from ...runtime.engine import AsyncEngine, Context

DELAY_ENV = "DYN_TOKEN_ECHO_DELAY_MS"


def _delay_s() -> float:
    return float(os.environ.get(DELAY_ENV, "1")) / 1000.0


class EchoEngineCore(AsyncEngine):
    """Token-level echo: emits the prompt's token ids back one at a time.

    Respects max_tokens and cooperative cancellation, so scheduler/stream
    logic can be tested deterministically.
    """

    async def generate(self, request: Context[Any]) -> AsyncIterator[dict]:
        payload = request.payload
        req = (
            payload
            if isinstance(payload, PreprocessedRequest)
            else PreprocessedRequest.from_wire(payload)
        )
        delay = _delay_s()
        max_tokens = req.stop_conditions.max_tokens or len(req.token_ids)
        emitted = 0
        for tid in req.token_ids:
            if request.context.is_stopped:
                yield EngineOutput(
                    token_ids=[], finish_reason=FinishReason.CANCELLED
                ).to_wire()
                return
            if emitted >= max_tokens:
                break
            await asyncio.sleep(delay)
            emitted += 1
            yield EngineOutput(token_ids=[tid]).to_wire()
        yield EngineOutput(token_ids=[], finish_reason=FinishReason.LENGTH).to_wire()


class EchoEngineFull(AsyncEngine):
    """OpenAI-level echo: streams the last user message back as chunks."""

    async def generate(self, request: Context[Any]) -> AsyncIterator[dict]:
        from ...protocols.openai import (
            ChatChoiceDelta,
            ChatCompletionChunk,
            ChatCompletionRequest,
            ChatStreamChoice,
            new_request_id,
        )

        payload = request.payload
        req = (
            payload
            if isinstance(payload, ChatCompletionRequest)
            else ChatCompletionRequest.model_validate(payload)
        )
        rid = new_request_id()
        text = req.messages[-1].text_content() if req.messages else ""
        delay = _delay_s()
        yield ChatCompletionChunk(
            id=rid,
            model=req.model,
            choices=[ChatStreamChoice(delta=ChatChoiceDelta(role="assistant"))],
        ).model_dump(exclude_none=True)
        for word in text.split():
            if request.context.is_stopped:
                break
            await asyncio.sleep(delay)
            yield ChatCompletionChunk(
                id=rid,
                model=req.model,
                choices=[ChatStreamChoice(delta=ChatChoiceDelta(content=word + " "))],
            ).model_dump(exclude_none=True)
        yield ChatCompletionChunk(
            id=rid,
            model=req.model,
            choices=[ChatStreamChoice(delta=ChatChoiceDelta(), finish_reason="stop")],
        ).model_dump(exclude_none=True)
