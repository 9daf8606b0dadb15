"""Backend stage: streaming detokenization + stop-condition enforcement.

Sits between the engine (token ids out) and the preprocessor's response
path (text deltas in). Reference analog: lib/llm/src/backend.rs:87-385 —
incremental DecodeStream plus the "jail" that buffers partial matches of
stop sequences so a stop string is never partially surfaced to the client.

The port's copy of ``dynamo_tpu/llm/backend.py``; it follows the engine
stream as it comes (the reference's re-bind across live migrations waits
for the port's migration plane).
"""

from __future__ import annotations

from typing import AsyncIterator, List, Optional, Tuple

from ..protocols.common import (
    BackendOutput,
    EngineOutput,
    FinishReason,
    PreprocessedRequest,
)
from ..runtime.engine import AsyncEngine, Context
from ..runtime.pipeline import Operator
from .tokenizer import HFTokenizer


class Decoder:
    """Per-request detokenizer with stop-string jail.

    ``step`` returns ``(text_to_emit, finish_reason)``. Text that might be
    the beginning of a stop string is jailed (held back) until the match
    either completes (→ truncate + STOP) or breaks (→ released).
    """

    def __init__(
        self,
        tokenizer: Optional[HFTokenizer],
        stop_strings: Optional[List[str]] = None,
        hidden_stop_ids: Optional[List[int]] = None,
        eos_token_ids: Optional[List[int]] = None,
        ignore_eos: bool = False,
        skip_special_tokens: bool = True,
    ):
        self.stream = (
            tokenizer.decode_stream(skip_special_tokens) if tokenizer else None
        )
        self.stop_strings = [s for s in (stop_strings or []) if s]
        self.hidden_stop_ids = set(hidden_stop_ids or [])
        self.eos_token_ids = set(eos_token_ids or [])
        self.ignore_eos = ignore_eos
        self.jail = ""
        self.generated = 0

    def _longest_held_suffix(self, text: str) -> int:
        """Length of the longest suffix of ``text`` that could still grow
        into a stop string."""
        best = 0
        for stop in self.stop_strings:
            # try suffixes up to len(stop)-1 (a full match is handled earlier)
            max_len = min(len(stop) - 1, len(text))
            for k in range(max_len, 0, -1):
                if stop.startswith(text[-k:]):
                    best = max(best, k)
                    break
        return best

    def step(self, token_id: int) -> Tuple[Optional[str], Optional[FinishReason]]:
        self.generated += 1
        if token_id in self.hidden_stop_ids:
            # token-level stop: jailed text is legitimate output, release it
            # (only a completed stop-STRING match justifies discarding it)
            return self.flush(), FinishReason.STOP
        if not self.ignore_eos and token_id in self.eos_token_ids:
            return self.flush(), FinishReason.EOS

        if self.stream is None:
            return None, None
        delta = self.stream.step(token_id)
        if delta is None:
            return None, None

        text = self.jail + delta
        # full stop-string match → truncate at the earliest match
        cut = -1
        for stop in self.stop_strings:
            idx = text.find(stop)
            if idx != -1 and (cut == -1 or idx < cut):
                cut = idx
        if cut != -1:
            self.jail = ""
            emitted = text[:cut]
            return (emitted or None), FinishReason.STOP

        hold = self._longest_held_suffix(text)
        if hold:
            self.jail = text[-hold:]
            emit = text[:-hold]
        else:
            self.jail = ""
            emit = text
        return (emit or None), None

    def flush(self) -> Optional[str]:
        """Release jailed text (finish for a reason other than a stop match)."""
        out, self.jail = self.jail, ""
        return out or None


class Backend(Operator):
    """Pipeline operator: requests pass through; responses get detokenized."""

    def __init__(self, tokenizer: Optional[HFTokenizer]):
        self.tokenizer = tokenizer

    @classmethod
    def from_mdc(cls, mdc) -> "Backend":
        tok = HFTokenizer.from_model_path(mdc.model_path) if mdc.model_path else None
        return cls(tok)

    async def generate(
        self, request: Context[PreprocessedRequest], next_engine: AsyncEngine
    ) -> AsyncIterator[BackendOutput]:
        req = request.payload
        decoder = Decoder(
            self.tokenizer,
            stop_strings=req.stop_conditions.stop,
            hidden_stop_ids=req.stop_conditions.stop_token_ids_hidden,
            eos_token_ids=req.eos_token_ids,
            ignore_eos=req.stop_conditions.ignore_eos,
            skip_special_tokens=req.output_options.skip_special_tokens,
        )
        max_tokens = req.stop_conditions.max_tokens

        finished = False
        # deterministic finalization: this loop BREAKS at the finish
        # chunk, and an abandoned inner async generator is finalized
        # only lazily (GC / asyncgen hooks). The network client's
        # cleanup, which folds the worker's span export into the request
        # trace (runtime/client.py), must run BEFORE upstream hops
        # export THEIR spans — aclosing() runs the inner finally-chain
        # synchronously at the break.
        from contextlib import aclosing

        engine_stream = next_engine.generate(request)
        async with aclosing(engine_stream):
            async for out in engine_stream:
                if isinstance(out, dict):  # off the wire
                    out = EngineOutput.from_wire(out)
                texts: List[str] = []
                emitted_ids: List[int] = []
                finish: Optional[FinishReason] = out.finish_reason
                for tid in out.token_ids:
                    text, tok_finish = decoder.step(tid)
                    emitted_ids.append(tid)
                    if text is not None:
                        texts.append(text)
                    if tok_finish is not None:
                        finish = tok_finish
                        break
                    if max_tokens is not None and decoder.generated >= max_tokens:
                        finish = finish or FinishReason.LENGTH
                        break
                if finish is not None and finish not in (FinishReason.STOP,):
                    tail = decoder.flush()
                    if tail:
                        texts.append(tail)
                yield BackendOutput(
                    token_ids=emitted_ids,
                    text="".join(texts) if texts else None,
                    finish_reason=finish,
                    logprobs=out.logprobs,
                    prompt_logprobs=out.prompt_logprobs,
                    cum_tokens=decoder.generated,
                )
                if finish is not None:
                    finished = True
                    break
        if not finished:
            # engine stream ended without a finish reason (e.g. cancelled)
            tail = decoder.flush()
            yield BackendOutput(
                token_ids=[],
                text=tail,
                finish_reason=FinishReason.CANCELLED,
                cum_tokens=decoder.generated,
            )
