"""OpenAI ↔ internal translation: prompt templating, tokenization, deltas.

The port's copy of ``dynamo_tpu/llm/preprocessor.py``, over the port's
tokenizer and protocol types; guided JSON (``response_format`` json_object /
json_schema, the ``guided_json`` extra field) is refused by name: its
grammar and the vocabulary's piece table are still to port.

Forward: render the model's chat template (jinja2), tokenize, merge model
defaults into sampling/stop options → ``PreprocessedRequest``.
Backward: wrap ``BackendOutput`` text deltas into OpenAI chat-completion
chunks / completion chunks (SSE payloads).

Reference analog: lib/llm/src/preprocessor.rs:63-359 (OpenAIPreprocessor +
bidirectional Operator + DeltaGenerator) and preprocessor/prompt/template/*
(minijinja chat-template rendering).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator, List, Optional, Union

import jinja2

from ..protocols.annotated import (
    ANNOTATION_FORMATTED_PROMPT,
    ANNOTATION_TOKEN_IDS,
    Annotated,
)
from ..protocols.common import (
    BackendOutput,
    FinishReason,
    OutputOptions,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from ..protocols.openai import (
    ChatChoiceDelta,
    ChatCompletionChunk,
    ChatCompletionRequest,
    ChatStreamChoice,
    ChoiceLogprobs,
    CompletionChoice,
    CompletionRequest,
    CompletionResponse,
    LogprobEntry,
    Usage,
    new_request_id,
)
from ..runtime.engine import AsyncEngine, Context, EngineError
from ..runtime.pipeline import Operator
from .model_card import ModelDeploymentCard
from .tokenizer import HFTokenizer

logger = logging.getLogger(__name__)

FALLBACK_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "{{ message.role }}: {{ message.content }}\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}assistant: {% endif %}"
)


def _child_request(preprocessed, i: int, output_options=None):
    """One seeded single-sample child of a fanned-out request (the n-way
    fan-out and the buffered best_of path share this): n=1, seed offset
    by the child index so seeded requests stay reproducible but
    distinct, annotation side-channels off."""
    import dataclasses as _dc

    seed = preprocessed.sampling_options.seed
    samp = _dc.replace(
        preprocessed.sampling_options, n=1,
        seed=(seed + i) if seed is not None else None,
    )
    return _dc.replace(
        preprocessed, sampling_options=samp,
        output_options=output_options or preprocessed.output_options,
        annotation_values={},
    )


class PromptFormatter:
    """Jinja2 chat-template renderer (HF tokenizer_config semantics)."""

    def __init__(self, template: Optional[str], bos_token: str = "", eos_token: str = ""):
        env = jinja2.Environment(
            loader=jinja2.BaseLoader(), keep_trailing_newline=True
        )
        env.globals["raise_exception"] = self._raise
        env.filters.setdefault("tojson", lambda v, **kw: jinja2.utils.htmlsafe_json_dumps(v))
        self.template = env.from_string(template or FALLBACK_CHAT_TEMPLATE)
        self.bos_token = bos_token
        self.eos_token = eos_token

    @staticmethod
    def _raise(msg):
        raise EngineError(f"chat template error: {msg}")

    def render(self, messages: List[dict], add_generation_prompt: bool = True, **extra) -> str:
        return self.template.render(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            bos_token=self.bos_token,
            eos_token=self.eos_token,
            **extra,
        )


class OpenAIPreprocessor(Operator):
    """Bidirectional operator: OpenAI request in, OpenAI chunks out."""

    def __init__(self, mdc: ModelDeploymentCard, tokenizer: Optional[HFTokenizer] = None):
        self.mdc = mdc
        self.tokenizer = tokenizer or (
            HFTokenizer.from_model_path(mdc.model_path) if mdc.model_path else None
        )
        self.formatter = PromptFormatter(
            mdc.chat_template, mdc.bos_token or "", mdc.eos_token or ""
        )
        # fail at construction, not after a full generation has been spent
        if mdc.tool_call_format is not None:
            from .tools import FORMATS

            if mdc.tool_call_format not in FORMATS:
                raise EngineError(
                    f"unknown tool_call_format {mdc.tool_call_format!r}; "
                    f"use one of {FORMATS} or None to disable"
                )

    # ---------- forward: request translation ----------

    def preprocess_chat(self, req: ChatCompletionRequest) -> PreprocessedRequest:
        self._validate_tool_choice(req)
        use_raw = bool(req.nvext and req.nvext.use_raw_prompt)
        if use_raw and req.messages:
            prompt = "".join(m.text_content() for m in req.messages)
        else:
            prompt = self.formatter.render(
                [m.model_dump(exclude_none=True) for m in req.messages],
                add_generation_prompt=True,
                tools=req.tools,
            )
        token_ids = self._tokenize(prompt)
        return self._build(req, token_ids, prompt, max_tokens=req.effective_max_tokens())

    def preprocess_completion(self, req: CompletionRequest) -> PreprocessedRequest:
        if req.best_of is not None and req.best_of != (req.n or 1):
            # OpenAI semantics: best_of candidates are generated
            # server-side and the n highest-cumulative-logprob ones
            # returned; that selection needs complete outputs, so it
            # cannot stream, and best_of < n has nothing to select
            if req.best_of < (req.n or 1):
                raise EngineError("best_of must be >= n")
            if req.best_of > 20:  # OpenAI's cap; also bounds the fan-out
                raise EngineError("best_of must be <= 20")
            if req.stream:
                raise EngineError("best_of cannot be used with streaming")
            if req.echo:
                raise EngineError("best_of cannot be combined with echo")
            if (req.temperature is not None and req.temperature == 0) or (
                    req.nvext and req.nvext.greed_sampling):
                # greedy candidates are identical: the selection is
                # meaningless and the client pays best_of x the tokens
                raise EngineError(
                    "best_of > n requires sampling (temperature > 0)"
                )
        prompt = req.prompt
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            token_ids = list(prompt)
            prompt_text = None
        elif isinstance(prompt, str):
            token_ids = self._tokenize(prompt)
            prompt_text = prompt
        else:
            raise EngineError("batch prompts must be dispatched one at a time")
        return self._build(req, token_ids, prompt_text, max_tokens=req.max_tokens)

    def _tokenize(self, prompt: str) -> List[int]:
        if self.tokenizer is None:
            raise EngineError(f"no tokenizer available for {self.mdc.display_name}")
        return self.tokenizer.encode(prompt)

    @staticmethod
    def _validate_tool_choice(req: ChatCompletionRequest) -> None:
        """Reject malformed ``tool_choice`` at the door (the named-
        function and "required" forms the reference's delta layer left
        unimplemented at chat_completions/delta.rs:131 — a full
        generation must not be spent before a bad name 400s)."""
        tc = req.tool_choice
        if tc is None or tc in ("none", "auto", "required"):
            if tc == "required" and not req.tools:
                raise EngineError("tool_choice='required' needs tools")
            return
        if isinstance(tc, dict):
            if tc.get("type") != "function":
                raise EngineError(
                    "tool_choice object must be "
                    '{"type": "function", "function": {"name": ...}}'
                )
            name = (tc.get("function") or {}).get("name")
            if not name or not isinstance(name, str):
                raise EngineError("tool_choice.function.name is required")
            names = {
                (t.get("function") or {}).get("name")
                for t in (req.tools or []) if isinstance(t, dict)
            }
            if name not in names:
                raise EngineError(
                    f"tool_choice function {name!r} is not in tools"
                )
            return
        raise EngineError(f"unsupported tool_choice {tc!r}")

    @staticmethod
    def _guided_choice(req) -> Optional[List[str]]:
        """vLLM-style ``guided_choice`` extra field (top level or nvext):
        constrain the completion to exactly one of the given strings.
        Present-but-empty is rejected — silently dropping the constraint
        would hand unconstrained text to a client that relies on it."""
        choices = (req.model_extra or {}).get("guided_choice")
        if choices is None and req.nvext is not None:
            choices = (req.nvext.model_extra or {}).get("guided_choice")
        if choices is None:
            return None
        if (not isinstance(choices, list) or not choices or not all(
                isinstance(c, str) and c for c in choices)):
            raise EngineError(
                "guided_choice must be a non-empty list of non-empty strings"
            )
        return list(choices)

    @staticmethod
    def _guided_json(req) -> Optional[dict]:
        """Guided JSON spec from ``response_format`` (OpenAI) or the
        vLLM-style ``guided_json`` extra field (whose value IS the
        schema). Validated here by compiling the schema — unsupported
        keywords must 400 at the door, not crash the engine loop."""
        spec = None
        rf = getattr(req, "response_format", None)
        if rf and rf.get("type") == "json_object":
            spec = {"type": "json_object"}
        elif rf and rf.get("type") == "json_schema":
            spec = {"type": "json_schema",
                    "schema": rf["json_schema"]["schema"]}
        else:
            gj = (req.model_extra or {}).get("guided_json")
            if gj is None and req.nvext is not None:
                gj = (req.nvext.model_extra or {}).get("guided_json")
            if gj is not None:
                if not isinstance(gj, dict):
                    raise EngineError(
                        "guided_json must be a JSON-schema object"
                    )
                spec = {"type": "json_schema", "schema": gj}
        if spec is None:
            return None
        raise EngineError(
            "guided JSON (response_format json_object / json_schema, "
            "guided_json) is not served by the PyTorch port yet: its grammar "
            "and the vocabulary's piece table are still to port")

    def _guided_choice_ids(
        self, choices: Optional[List[str]]
    ) -> Optional[List[List[int]]]:
        if not choices:
            return None
        if self.tokenizer is None:
            raise EngineError(
                "guided_choice requires a tokenizer (the choices must be "
                "tokenized before the engine can constrain to them)"
            )
        # canonical-tokenization semantics: the engine constrains the
        # output to each choice's whole-string token sequence (no
        # special tokens — the choice is completion text)
        return [
            list(self.tokenizer.encode(c, add_special_tokens=False))
            for c in choices
        ]

    def _stop_token_seqs(
        self, stop_list: Optional[List[str]]
    ) -> Optional[List[List[int]]]:
        """Canonical tokenization of each stop string — the engine's
        device-approximate stop check (the persistent chain's suffix
        ring) matches these token sequences; the backend detokenizer
        jail still catches every OTHER tokenization of the same text,
        so a missing/empty entry only loses the chain fast-path. Best
        effort: a tokenizer-less preprocessor ships None."""
        if not stop_list or self.tokenizer is None:
            return None
        seqs = []
        for s in stop_list:
            try:
                seqs.append(list(
                    self.tokenizer.encode(s, add_special_tokens=False)
                ))
            except Exception:
                # partial coverage reads as unavailable (the request
                # keeps the backend jail; the engine only loses the
                # chain fast-path) — worth a line, not a failure
                logger.debug("stop string %r not tokenizable; engine "
                             "stop-seq fast-path disabled", s)
                return None
        return seqs if all(seqs) else None

    def _build(
        self,
        req: Union[ChatCompletionRequest, CompletionRequest],
        token_ids: List[int],
        prompt_text: Optional[str],
        max_tokens: Optional[int],
    ) -> PreprocessedRequest:
        if len(token_ids) >= self.mdc.context_length:
            raise EngineError(
                f"prompt length {len(token_ids)} exceeds context window "
                f"{self.mdc.context_length}"
            )
        ignore_eos = bool(req.ignore_eos or (req.nvext and req.nvext.ignore_eos))
        # nvext.greed_sampling forces greedy regardless of temperature
        # (reference nvext surface)
        temperature = (
            0.0 if (req.nvext and req.nvext.greed_sampling)
            else req.temperature
        )
        budget = self.mdc.context_length - len(token_ids)
        guided = self._guided_choice(req)
        guided_json = self._guided_json(req)
        if guided and guided_json:
            raise EngineError(
                "guided_choice and guided JSON (response_format/"
                "guided_json) are mutually exclusive"
            )
        stop_list = req.stop_list() or None
        out = PreprocessedRequest(
            token_ids=token_ids,
            stop_conditions=StopConditions(
                # `is not None`: an explicit max_tokens=0 means an EMPTY
                # completion, not the full context budget
                max_tokens=(
                    min(max_tokens, budget) if max_tokens is not None
                    else budget
                ),
                min_tokens=req.min_tokens,
                stop=stop_list,
                ignore_eos=ignore_eos,
                stop_token_seqs=self._stop_token_seqs(stop_list),
            ),
            sampling_options=SamplingOptions(
                n=req.n,
                temperature=temperature,
                top_p=req.top_p,
                top_k=req.top_k,
                min_p=req.min_p,
                frequency_penalty=req.frequency_penalty,
                presence_penalty=req.presence_penalty,
                repetition_penalty=req.repetition_penalty,
                seed=req.seed,
                # OpenAI wire uses string token-id keys; clamp per spec
                logit_bias={
                    int(k): max(-100.0, min(100.0, float(v)))
                    for k, v in req.logit_bias.items()
                } if getattr(req, "logit_bias", None) else None,
                guided_choice=guided,
                guided_choice_token_ids=self._guided_choice_ids(guided),
                guided_json=guided_json,
            ),
            output_options=OutputOptions(
                logprobs=self._logprobs_count(req),
                # OpenAI legacy completions: echo + logprobs returns the
                # prompt tokens' logprobs too (chat has no echo attr)
                prompt_logprobs=(
                    self._logprobs_count(req)
                    if getattr(req, "echo", False)
                    and self._logprobs_count(req) is not None
                    else None
                ),
                echo_prompt=bool(getattr(req, "echo", False)),
            ),
            eos_token_ids=list(self.mdc.eos_token_ids),
            model=req.model,
            mdc_checksum=self.mdc.checksum,
            annotations=list((req.nvext and req.nvext.annotations) or []),
        )
        # payloads for requested annotations (generate() turns them into
        # Annotated events ahead of the stream — reference
        # preprocessor.rs:134-160 formatted_prompt/token_ids)
        if ANNOTATION_FORMATTED_PROMPT in out.annotations and prompt_text is not None:
            out.annotation_values[ANNOTATION_FORMATTED_PROMPT] = prompt_text
        if ANNOTATION_TOKEN_IDS in out.annotations:
            out.annotation_values[ANNOTATION_TOKEN_IDS] = list(token_ids)
        return out

    # ---------- backward: response translation ----------

    @staticmethod
    def _logprobs_count(req) -> Optional[int]:
        """OpenAI logprobs fields → alternatives count (None = off).

        Chat: ``logprobs: true`` + optional ``top_logprobs`` (0 means
        "chosen token only, no alternatives"). Completions: ``logprobs``
        IS the count, 0 included.
        """
        lp = getattr(req, "logprobs", None)
        if isinstance(lp, bool):
            if not lp:
                return None
            top = getattr(req, "top_logprobs", None)
            return int(top) if top is not None else 0
        if isinstance(lp, int):
            return int(lp)
        return None

    async def chat_stream(
        self,
        request_id: str,
        model: str,
        backend_stream: AsyncIterator[BackendOutput],
        prompt_tokens: int,
        include_usage: bool = False,
        tool_format: Optional[str] = None,
        tool_jail: bool = False,
    ) -> AsyncIterator[ChatCompletionChunk]:
        """BackendOutput deltas → OpenAI chat chunks (role chunk first).

        When ``tool_format`` is set (the request carried tools and
        tool_choice != "none"), content is held back and the finished text
        is parsed for tool calls (llm/tools.py): a successful parse emits
        ONE delta carrying ``tool_calls`` with finish_reason="tool_calls"
        — clients never see the raw call syntax as text; a failed parse
        flushes the buffered text as ordinary content. ``tool_jail``
        withholds from token 0: a forced call (tool_choice "required" or
        a named function) means the whole output IS the call, so no
        prose should stream while waiting for a marker."""
        yield ChatCompletionChunk(
            id=request_id,
            model=model,
            choices=[ChatStreamChoice(delta=ChatChoiceDelta(role="assistant"))],
        )
        completion_tokens = 0
        buffered: List[str] = []
        buffered_lps: List[LogprobEntry] = []
        last_finish: Optional[str] = None
        # tool-call jail: with tools enabled, stream prose NORMALLY and
        # withhold text only from a potential call marker onward — holding
        # the whole generation (as a naive buffer-then-parse would) turns
        # TTFT into full-generation latency for plain prose answers
        from .tools import marker_prefix_len as _marker_prefix_len
        from .tools import stream_markers as _tool_stream_markers

        markers = (
            _tool_stream_markers(tool_format) if tool_format is not None
            else ()
        )
        pending = ""    # streamed-side tail that may be a marker prefix
        # logprob entries for exactly the tokens whose text sits in
        # ``pending`` — released text carries its own entries, withheld
        # text buffers its own (no duplication across the jail boundary)
        pending_lps: List[LogprobEntry] = []
        jailed = tool_jail and tool_format is not None
        first_text = True

        def _split_lps(entries: List[LogprobEntry], nchars: int,
                       total_chars: int):
            """Split entries at a character boundary of their joint text.

            When the vocab piece strings sum to the decoded text's length
            (plain-ASCII tokens), a token-length walk is exact; a token
            straddling the boundary goes to the withheld side, matching
            the withheld marker token. Byte-fallback / multi-byte pieces
            decode to different lengths than their piece strings — then
            the split falls back to proportional-by-count: boundary
            placement is approximate but every entry still lands on
            exactly one side (no duplication, no loss)."""
            if not entries:
                return [], []
            if sum(len(e.token or "") for e in entries) == total_chars:
                used = 0
                for i, e in enumerate(entries):
                    tl = len(e.token or "")
                    if used + tl > nchars:
                        return entries[:i], entries[i:]
                    used += tl
                return entries, []
            i = int(round(nchars / max(total_chars, 1) * len(entries)))
            return entries[:i], entries[i:]

        def _chunk(text: str, lp=None, finish=None) -> ChatCompletionChunk:
            return ChatCompletionChunk(
                id=request_id,
                model=model,
                choices=[ChatStreamChoice(
                    delta=ChatChoiceDelta(content=text or None),
                    finish_reason=finish,
                    logprobs=lp,
                )],
            )

        async for out in backend_stream:
            completion_tokens = max(completion_tokens, out.cum_tokens)
            if tool_format is None:
                # out.logprobs without text: the detokenizer held this
                # token's characters (multi-byte piece mid-sequence) —
                # the entry must still reach the client or counts drift
                if out.text or out.finish_reason or out.logprobs:
                    yield _chunk(
                        out.text, self._logprobs(out),
                        out.finish_reason.to_openai() if out.finish_reason
                        else None,
                    )
                continue

            lp = self._logprobs(out)
            if out.finish_reason:
                last_finish = out.finish_reason.to_openai()
            if not jailed and out.text:
                if (first_text and tool_format in ("json", "auto")
                        and out.text.lstrip()[:1] in ("{", "[")):
                    # a leading JSON value is the json tool-call form —
                    # no later marker would flag it. Only those formats:
                    # for hermes/mistral a '[1] footnote...' opener is
                    # ordinary prose and must stream
                    jailed = True
                if out.text.strip():
                    first_text = False
            if jailed:
                if pending:
                    buffered.insert(0, pending)
                    pending = ""
                    buffered_lps[:0] = pending_lps
                    pending_lps = []
                if out.text:
                    buffered.append(out.text)
                if lp and lp.content:
                    buffered_lps.extend(lp.content)
                continue
            pending += out.text or ""
            if lp and lp.content:
                pending_lps.extend(lp.content)
            hit = min(
                (pending.find(m) for m in markers if pending.find(m) >= 0),
                default=-1,
            )
            if hit >= 0:
                # prose before the marker streams WITH its logprob
                # entries; the marker and everything after is withheld
                # for parsing (its entries ride the final parsed chunk)
                jailed = True
                total = len(pending)
                release, held = pending[:hit], pending[hit:]
                pending = ""
                rel_lps, held_lps = _split_lps(pending_lps, hit, total)
                pending_lps = []
                if held:
                    buffered.append(held)
                buffered_lps.extend(held_lps)
            else:
                keep = _marker_prefix_len(pending, markers)
                total = len(pending)
                release = pending[: len(pending) - keep] if keep else pending
                pending = pending[len(pending) - keep:] if keep else ""
                rel_lps, pending_lps = _split_lps(
                    pending_lps, len(release), total
                )
            if release:
                yield _chunk(
                    release,
                    ChoiceLogprobs(content=rel_lps) if rel_lps else None,
                )

        if tool_format is not None:
            from .tools import extract_tool_calls

            if jailed:
                text = "".join(buffered)
                content, calls = extract_tool_calls(text, tool_format)
                final_lps = buffered_lps
            else:
                # no marker ever appeared — whatever tail is pending is
                # plain prose (its entries never buffered: they're here)
                text, content, calls = pending, pending, []
                final_lps = buffered_lps + pending_lps
            lps = ChoiceLogprobs(content=final_lps) if final_lps else None

            def _tc_chunk(entries, finish=None, lp=None):
                return ChatCompletionChunk(
                    id=request_id,
                    model=model,
                    choices=[ChatStreamChoice(
                        delta=ChatChoiceDelta(tool_calls=entries),
                        finish_reason=finish,
                        logprobs=lp,
                    )],
                )

            if calls:
                # the OpenAI streamed tool-call shape (the delta layer the
                # reference left unimplemented at chat_completions/
                # delta.rs:131 — its deltas always carried tool_calls:
                # None; forced tool_choice, handled via tool_jail above,
                # was the remaining piece): per call, a header delta
                # carrying index/id/type/function.name with empty
                # arguments, then argument deltas carrying only
                # {index, function.arguments} fragments for the client to
                # concatenate. The closing chunk carries
                # finish_reason="tool_calls" plus the withheld tokens'
                # logprob entries.
                if content:
                    # prose around the call blocks is real content —
                    # OpenAI responses carry it alongside tool_calls
                    yield _chunk(content)
                for i, call in enumerate(calls):
                    yield _tc_chunk([{
                        "index": i,
                        "id": call["id"],
                        "type": call["type"],
                        "function": {
                            "name": call["function"]["name"],
                            "arguments": "",
                        },
                    }])
                    args = call["function"]["arguments"]
                    if args:
                        yield _tc_chunk([{
                            "index": i,
                            "function": {"arguments": args},
                        }])
                yield _tc_chunk(None, finish="tool_calls", lp=lps)
            else:
                yield _chunk(content, lps, last_finish or "stop")
        if include_usage:
            yield ChatCompletionChunk(
                id=request_id,
                model=model,
                choices=[],
                usage=Usage(
                    prompt_tokens=prompt_tokens,
                    completion_tokens=completion_tokens,
                    total_tokens=prompt_tokens + completion_tokens,
                ),
            )

    def _token_str(self, tid: int) -> str:
        """Display string for one vocab id (chat and legacy-completions
        logprob blocks must render tokens identically)."""
        return (self.tokenizer.id_to_token(tid)
                if self.tokenizer else str(tid)) or str(tid)

    def _logprobs(self, out: BackendOutput) -> Optional[ChoiceLogprobs]:
        if not out.logprobs:
            return None
        entries = []
        for lp in out.logprobs:
            entries.append(
                LogprobEntry(
                    token=self._token_str(lp.token_id),
                    logprob=lp.logprob,
                    top_logprobs=[
                        {"token": self._token_str(t), "logprob": p}
                        for t, p in (lp.top or {}).items()
                    ],
                )
            )
        return ChoiceLogprobs(content=entries)

    def _legacy_logprobs_block(self, entries, offsets) -> dict:
        """tokens / token_logprobs / top_logprobs / text_offset from
        TokenLogprob entries + their text offsets (one rendering shared
        by the streaming chunks and the buffered best_of path)."""
        return {
            "tokens": [self._token_str(e.token_id) for e in entries],
            "token_logprobs": [e.logprob for e in entries],
            # one entry per token even when all None: the aggregator
            # concatenates blocks, so a collapsed list would shift later
            # chunks' top entries onto the wrong tokens
            "top_logprobs": [
                {self._token_str(t): p for t, p in e.top.items()}
                if e.top else None
                for e in entries
            ],
            "text_offset": list(offsets),
        }

    def _completion_logprobs_dict(self, out: BackendOutput) -> Optional[dict]:
        """OpenAI legacy completions logprobs block for one generation
        chunk. Offsets are chunk-relative; with one token per chunk (the
        decode stream's shape) they are exact, and a multi-token chunk
        (the stop-string jail releasing buffered prose) splits the chunk
        text proportionally — same fallback the chat path uses."""
        if not out.logprobs:
            return None
        n = len(out.logprobs)
        text_len = len(out.text or "")
        offs = [int(round(i / n * text_len)) for i in range(n)]
        return self._legacy_logprobs_block(out.logprobs, offs)

    def _prompt_logprobs_dict(self, token_ids, prompt_lps) -> dict:
        """OpenAI legacy completions logprobs block for the echoed prompt:
        tokens / token_logprobs / text_offset (first entry None — the
        first prompt token has no conditioning prefix).

        Offsets index into the DECODED echo text, so each token string is
        the decoded-prefix delta (raw vocab pieces — byte-fallback,
        BPE space markers — have different lengths than the text they
        decode to and would drift every subsequent offset)."""
        token_ids = list(token_ids)
        if self.tokenizer is not None and hasattr(self.tokenizer, "decode"):
            prefixes = [""] + [
                self.tokenizer.decode(token_ids[: i + 1])
                for i in range(len(token_ids))
            ]
            toks = [
                prefixes[i + 1][len(prefixes[i]):]
                for i in range(len(token_ids))
            ]
            offsets = [len(prefixes[i]) for i in range(len(token_ids))]
        else:
            toks = [
                (self.tokenizer.id_to_token(t) if self.tokenizer else str(t))
                or str(t)
                for t in token_ids
            ]
            offsets, pos = [], 0
            for t in toks:
                offsets.append(pos)
                pos += len(t)
        return {
            "tokens": toks,
            "token_logprobs": list(prompt_lps[: len(toks)]),
            # per-token placeholders keep the aggregate list aligned with
            # tokens when generation chunks append their top entries
            "top_logprobs": [None] * len(toks),
            "text_offset": offsets,
        }

    async def completion_stream(
        self,
        request_id: str,
        model: str,
        backend_stream: AsyncIterator[BackendOutput],
        prompt_tokens: int,
        include_usage: bool = False,
        echo_text: Optional[str] = None,
        prompt_token_ids: Optional[List[int]] = None,
    ) -> AsyncIterator[CompletionResponse]:
        completion_tokens = 0
        # with prompt_token_ids the echo chunk waits for the first
        # backend output, which carries the prompt logprobs (the engine
        # computes them during prefill)
        echo_pending = bool(echo_text) and prompt_token_ids is not None
        if echo_text and not echo_pending:
            # OpenAI `echo`: the prompt leads the completion text
            yield CompletionResponse(
                id=request_id,
                model=model,
                choices=[CompletionChoice(text=echo_text, finish_reason=None)],
            )
        async for out in backend_stream:
            completion_tokens = max(completion_tokens, out.cum_tokens)
            if echo_pending:
                echo_pending = False
                lp_dict = (
                    self._prompt_logprobs_dict(
                        prompt_token_ids, out.prompt_logprobs
                    )
                    if out.prompt_logprobs is not None else None
                )
                yield CompletionResponse(
                    id=request_id,
                    model=model,
                    choices=[CompletionChoice(
                        text=echo_text, finish_reason=None, logprobs=lp_dict,
                    )],
                )
            # out.logprobs without text: the detokenizer held this token's
            # characters (multi-byte piece) — its entry must still flow
            if out.text or out.finish_reason or out.logprobs:
                yield CompletionResponse(
                    id=request_id,
                    model=model,
                    choices=[
                        CompletionChoice(
                            text=out.text or "",
                            finish_reason=out.finish_reason.to_openai()
                            if out.finish_reason
                            else None,
                            # legacy logprobs block for this chunk's
                            # tokens; offsets are chunk-relative (the
                            # aggregator rebases onto accumulated text)
                            logprobs=self._completion_logprobs_dict(out),
                        )
                    ],
                )
        if echo_pending:
            # the backend stream ended without a single output (immediate
            # cancel/zero-token completion) — the client still must get the
            # echoed prompt text, just without prompt logprobs
            yield CompletionResponse(
                id=request_id,
                model=model,
                choices=[CompletionChoice(text=echo_text, finish_reason=None)],
            )
        if include_usage:
            yield CompletionResponse(
                id=request_id,
                model=model,
                choices=[],
                usage=Usage(
                    prompt_tokens=prompt_tokens,
                    completion_tokens=completion_tokens,
                    total_tokens=prompt_tokens + completion_tokens,
                ),
            )

    # ---------- Operator impl (dispatches on request type) ----------

    async def generate(
        self,
        request: Context[Union[ChatCompletionRequest, CompletionRequest]],
        next_engine: AsyncEngine,
    ) -> AsyncIterator[Any]:
        req = request.payload
        is_chat = isinstance(req, ChatCompletionRequest)
        request.add_stage("preprocess")
        if is_chat:
            preprocessed = self.preprocess_chat(req)
            request_id = new_request_id()
        else:
            preprocessed = self.preprocess_completion(req)
            request_id = new_request_id("cmpl")
        # requested annotations stream ahead of the data as named events
        for name, value in preprocessed.annotation_values.items():
            yield Annotated.from_annotation(name, value)
        request.add_stage("generate")
        # OpenAI semantics: non-streaming responses ALWAYS carry usage;
        # streaming only includes the final usage chunk on opt-in
        include_usage = bool(
            (req.stream_options and req.stream_options.include_usage)
            or not getattr(req, "stream", False)
        )
        kwargs = {}
        # tool_call_format=None on the card disables parsing entirely
        if (is_chat and req.tools and req.tool_choice != "none"
                and self.mdc.tool_call_format is not None):
            kwargs["tool_format"] = self.mdc.tool_call_format
            if (req.tool_choice == "required"
                    or isinstance(req.tool_choice, dict)):
                # forced call (validated in preprocess): the entire
                # output is expected to be the call — withhold from
                # token 0 rather than waiting for a marker
                kwargs["tool_jail"] = True
        if not is_chat and preprocessed.output_options.echo_prompt:
            kwargs["echo_text"] = (
                req.prompt if isinstance(req.prompt, str)
                else self.tokenizer.decode(preprocessed.token_ids)
                if self.tokenizer else None
            )
            if preprocessed.output_options.prompt_logprobs is not None:
                kwargs["prompt_token_ids"] = list(preprocessed.token_ids)
        translate = self.chat_stream if is_chat else self.completion_stream

        n = preprocessed.sampling_options.n or 1
        best_of = (getattr(req, "best_of", None) or n) if not is_chat else n
        if best_of > n:
            # OpenAI best_of: generate best_of candidates, return the n
            # with the highest cumulative logprob (buffered — selection
            # needs complete outputs; preprocess rejected stream/echo)
            async for chunk in self._best_of(
                best_of, n, request, preprocessed, next_engine,
                request_id, req.model,
            ):
                yield chunk
            return
        if n > 1:
            # n-way fan-out: n independent engine streams, choice indices
            # rewritten per stream, usage summed into one final chunk
            # (reference parity: SamplingOptions carries n,
            # lib/llm/src/protocols/common.rs:248-316)
            async for chunk in self._fan_out(
                n, request, preprocessed, next_engine, translate,
                request_id, req.model, include_usage, kwargs,
            ):
                yield chunk
            return

        backend_stream = next_engine.generate(request.map(preprocessed))
        async for chunk in translate(
            request_id,
            req.model,
            backend_stream,
            prompt_tokens=len(preprocessed.token_ids),
            include_usage=include_usage,
            **kwargs,
        ):
            yield chunk

    async def _best_of(
        self, best_of, n, request, preprocessed, next_engine,
        request_id, model,
    ):
        """OpenAI legacy best_of: run ``best_of`` buffered candidates and
        return the ``n`` highest-cumulative-logprob completions.

        Candidates are forced to compute chosen-token logprobs (the
        ranking signal) even when the client asked for none; blocks are
        attached to the response only when the client did ask. Usage
        counts EVERY candidate's tokens — all of them were generated.
        Reference parity: SamplingOptions carries n/best_of
        (lib/llm/src/protocols/common.rs:248-316).
        """
        import dataclasses as _dc

        from ..runtime.engine import AsyncEngineContext

        prompt_tokens = len(preprocessed.token_ids)
        want_lp = preprocessed.output_options.logprobs
        child_ctxs = [
            AsyncEngineContext(trace_id=request.context.trace_id)
            for _ in range(best_of)
        ]

        async def relay_stop() -> None:
            await request.context.wait_stopped()
            for c in child_ctxs:
                c.stop_generating()

        # ranking needs chosen-token logprobs even when the client asked
        # for none (0 = chosen only, no alternatives)
        oo = _dc.replace(
            preprocessed.output_options,
            logprobs=want_lp if want_lp is not None else 0,
        )

        async def one(i: int):
            sub = _child_request(preprocessed, i, output_options=oo)
            sub_ctx = Context(sub, child_ctxs[i], dict(request.baggage))
            text, cum, ntoks, finish = "", 0.0, 0, None
            entries, offs = [], []
            async for out in next_engine.generate(sub_ctx):
                base, ln = len(text), len(out.text or "")
                if out.text:
                    text += out.text
                if out.logprobs:
                    m = len(out.logprobs)
                    for j, lp in enumerate(out.logprobs):
                        cum += lp.logprob
                        entries.append(lp)
                        offs.append(base + int(round(j / m * ln)))
                ntoks = max(ntoks, out.cum_tokens)
                if out.finish_reason:
                    finish = out.finish_reason.to_openai()
            return text, cum, ntoks, finish, entries, offs

        stop_task = asyncio.ensure_future(relay_stop())
        try:
            results = await asyncio.gather(*(one(i) for i in range(best_of)))
        finally:
            stop_task.cancel()
            for c in child_ctxs:
                c.stop_generating()
            request.context.merge_stages_from(child_ctxs)

        # OpenAI's documented selection: highest log probability PER
        # TOKEN — raw cumulative sums would systematically favor short
        # (early-stopping) candidates
        ranked = sorted(
            results, key=lambda r: r[1] / max(len(r[4]), 1), reverse=True
        )[:n]
        choices = []
        for idx, (text, _cum, _nt, finish, entries, offs) in enumerate(ranked):
            lp_dict = (
                self._legacy_logprobs_block(entries, offs)
                if want_lp is not None and entries else None
            )
            choices.append(CompletionChoice(
                index=idx, text=text, finish_reason=finish, logprobs=lp_dict,
            ))
        completion_tokens = sum(r[2] for r in results)
        yield CompletionResponse(
            id=request_id, model=model, choices=choices,
            usage=Usage(
                prompt_tokens=prompt_tokens,
                completion_tokens=completion_tokens,
                total_tokens=prompt_tokens + completion_tokens,
            ),
        )

    async def _fan_out(
        self, n, request, preprocessed, next_engine, translate,
        request_id, model, include_usage, kwargs,
    ):
        """Run n independent sampled continuations of one prompt.

        Each choice gets its own engine request (n=1, seed offset by the
        choice index so seeded requests stay reproducible but distinct)
        and streams concurrently; chunks are re-indexed per choice and
        usage totals combine at the end."""
        import dataclasses as _dc

        from ..runtime.engine import AsyncEngineContext

        prompt_tokens = len(preprocessed.token_ids)
        # bounded: children block in put() once the consumer lags,
        # restoring the pull-based flow control the single-stream path
        # gets for free. No sentinels ride the queue — completion/errors
        # surface through the gather below, so a cancelled child never
        # wedges on a full queue.
        queue: asyncio.Queue = asyncio.Queue(maxsize=16)
        usage_total = Usage(prompt_tokens=prompt_tokens)
        # each choice gets its OWN engine context: an engine finishing one
        # choice stops that choice's context in its finally, which with a
        # shared context would truncate the sibling streams mid-generation
        child_ctxs = [
            AsyncEngineContext(trace_id=request.context.trace_id)
            for _ in range(n)
        ]

        async def relay_stop() -> None:
            # client disconnect on the parent fans out to every child
            await request.context.wait_stopped()
            for c in child_ctxs:
                c.stop_generating()

        async def one_choice(i: int) -> None:
            sub = _child_request(preprocessed, i)
            sub_ctx = Context(sub, child_ctxs[i], dict(request.baggage))
            async for chunk in translate(
                request_id, model, next_engine.generate(sub_ctx),
                prompt_tokens=prompt_tokens, include_usage=include_usage,
                **kwargs,
            ):
                if getattr(chunk, "usage", None) is not None:
                    usage_total.completion_tokens += chunk.usage.completion_tokens
                    continue
                for choice in chunk.choices:
                    choice.index = i
                await queue.put(chunk)

        tasks = [asyncio.ensure_future(one_choice(i)) for i in range(n)]
        stop_task = asyncio.ensure_future(relay_stop())
        all_done = asyncio.gather(*tasks)
        get_task = None
        try:
            while True:
                get_task = asyncio.ensure_future(queue.get())
                await asyncio.wait(
                    {get_task, all_done}, return_when=asyncio.FIRST_COMPLETED
                )
                if get_task.done():
                    yield get_task.result()
                    continue
                get_task.cancel()
                while not queue.empty():
                    yield queue.get_nowait()
                all_done.result()  # re-raises the first child failure
                break
        finally:
            if get_task is not None:
                get_task.cancel()
            stop_task.cancel()
            all_done.cancel()
            for t in tasks:
                t.cancel()
            for c in child_ctxs:
                c.stop_generating()
            request.context.merge_stages_from(child_ctxs)
        if include_usage:
            usage_total.total_tokens = (
                usage_total.prompt_tokens + usage_total.completion_tokens
            )
            chunk_cls = (
                ChatCompletionChunk
                if translate == self.chat_stream
                else CompletionResponse
            )
            yield chunk_cls(
                id=request_id, model=model, choices=[], usage=usage_total
            )
