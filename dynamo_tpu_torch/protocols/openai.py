"""OpenAI-compatible API types (chat completions + completions).

The port's copy of ``dynamo_tpu/protocols/openai.py``. The reference
declares these types as pydantic models; the port does not depend on
pydantic, so ``Model`` below is a small hand-written base with the same
surface the front uses: ``model_validate(dict)``, keyword construction,
``model_dump(exclude_none=...)``, ``model_dump_json(exclude_none=...)`` and
``model_extra``. Validation follows pydantic's lax mode for the types these
models use: an int field takes a bool, an integral float or a numeric
string; a float field a number or a numeric string; a bool field a bool,
0 / 1 or one of pydantic's words ("yes", "off", ...); a str field only a
str; a union tries each member strictly before it coerces. A model with
``_extra = "allow"`` keeps unknown keys in ``model_extra`` (``guided_json``
and ``guided_choice`` ride there); the others drop them. A failure raises
``ValidationError``, a ``ValueError``, which the HTTP front answers with
400, as it answers pydantic's.
"""

from __future__ import annotations

import json
import math
import time
import typing
import uuid
from typing import Any, Dict, List, Literal, Optional, Union


class ValidationError(ValueError):
    """A request field that does not hold its declared type."""


class _Factory:
    def __init__(self, fn):
        self.fn = fn


def Field(default_factory):  # noqa: N802 — the reference's spelling
    return _Factory(default_factory)


_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}
_MISSING = object()


def _fail(path: str, what: str, value: Any):
    raise ValidationError(f"{path or 'body'}: input should be {what}, got "
                          f"{type(value).__name__} {value!r:.80}")


def _coerce(value: Any, tp: Any, path: str, strict: bool = False) -> Any:
    """``value`` as type ``tp`` (pydantic's lax mode; ``strict`` takes only
    the exact type, the first pass over a union's members)."""
    if tp is Any:
        return value
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is Union:
        if value is None and type(None) in args:
            return None
        members = [a for a in args if a is not type(None)]
        for mode in (True, False) if not strict else (True,):
            for m in members:
                try:
                    return _coerce(value, m, path, strict=mode)
                except ValidationError:
                    continue
        _fail(path, " or ".join(getattr(m, "__name__", str(m))
                                for m in members), value)
    if origin is Literal:
        if value in args:
            return value
        _fail(path, f"one of {args}", value)
    if origin in (list, List):
        if not isinstance(value, (list, tuple)):
            _fail(path, "a list", value)
        (item,) = args or (Any,)
        return [_coerce(v, item, f"{path}.{i}", strict)
                for i, v in enumerate(value)]
    if origin in (dict, Dict):
        if not isinstance(value, dict):
            _fail(path, "a dict", value)
        kt, vt = args or (Any, Any)
        return {_coerce(k, kt, f"{path}.{k}[key]", strict):
                _coerce(v, vt, f"{path}.{k}", strict)
                for k, v in value.items()}
    if isinstance(tp, type) and issubclass(tp, Model):
        if isinstance(value, tp):
            return value
        if not isinstance(value, dict):
            _fail(path, f"a {tp.__name__} object", value)
        return tp._validate(value, path)
    if tp is str:
        if isinstance(value, str):
            return value
        _fail(path, "a valid string", value)
    if tp is bool:
        if isinstance(value, bool):
            return value
        if not strict:
            if isinstance(value, (int, float)) and value in (0, 1):
                return bool(value)
            if isinstance(value, str) and value.strip().lower() in _TRUE | _FALSE:
                return value.strip().lower() in _TRUE
        _fail(path, "a valid boolean", value)
    if tp is int:
        if isinstance(value, int) and not isinstance(value, bool):
            return value
        if not strict:
            if isinstance(value, bool):
                return int(value)
            if isinstance(value, float):
                if math.isfinite(value) and value == int(value):
                    return int(value)
                _fail(path, "a valid integer (no fractional part)", value)
            if isinstance(value, str):
                s = value.strip()
                try:
                    return int(s)
                except ValueError:
                    try:
                        f = float(s)
                    except ValueError:
                        f = math.nan
                    if math.isfinite(f) and f == int(f):
                        return int(f)
        _fail(path, "a valid integer", value)
    if tp is float:
        if isinstance(value, float):
            return value
        if isinstance(value, int) and not isinstance(value, bool):
            return float(value)
        if not strict:
            if isinstance(value, bool):
                return float(value)
            if isinstance(value, str):
                try:
                    return float(value.strip())
                except ValueError:
                    pass
        _fail(path, "a valid number", value)
    raise TypeError(f"unsupported field type {tp!r}")


def _dump(value: Any, exclude_none: bool) -> Any:
    if isinstance(value, Model):
        return value.model_dump(exclude_none=exclude_none)
    if isinstance(value, list):
        return [_dump(v, exclude_none) for v in value]
    if isinstance(value, dict):
        return {k: _dump(v, exclude_none) for k, v in value.items()}
    return value


class Model:
    """The pydantic surface the front uses, over annotated class fields."""

    _extra = "ignore"
    _hints: Dict[type, Dict[str, Any]] = {}

    @classmethod
    def _fields(cls) -> Dict[str, Any]:
        hints = Model._hints.get(cls)
        if hints is None:
            hints = {k: v for k, v in typing.get_type_hints(cls).items()
                     if not k.startswith("_")}
            Model._hints[cls] = hints
        return hints

    def __init__(self, **data):
        self._fill(data, "")

    def _fill(self, data: dict, path: str) -> None:
        extra = {}
        fields = self._fields()
        for name, tp in fields.items():
            value = data.get(name, _MISSING)
            if value is _MISSING:
                default = getattr(type(self), name, _MISSING)
                if default is _MISSING:
                    raise ValidationError(
                        f"{path + '.' if path else ''}{name}: field required")
                value = (default.fn() if isinstance(default, _Factory)
                         else default)
            else:
                value = _coerce(value, tp, f"{path + '.' if path else ''}{name}")
            object.__setattr__(self, name, value)
        if self._extra == "allow":
            extra = {k: v for k, v in data.items() if k not in fields}
        object.__setattr__(self, "model_extra",
                           extra if self._extra == "allow" else None)
        self._after_validation()

    def _after_validation(self) -> None:
        pass

    @classmethod
    def _validate(cls, data: dict, path: str = ""):
        obj = cls.__new__(cls)
        obj._fill(data, path)
        return obj

    @classmethod
    def model_validate(cls, data: Any):
        if isinstance(data, cls):
            return data
        if not isinstance(data, dict):
            raise ValidationError(
                f"input should be a JSON object, got {type(data).__name__}")
        return cls._validate(data)

    def model_dump(self, exclude_none: bool = False) -> dict:
        out = {}
        for name in self._fields():
            value = getattr(self, name)
            if exclude_none and value is None:
                continue
            out[name] = _dump(value, exclude_none)
        for name, value in (self.model_extra or {}).items():
            if exclude_none and value is None:
                continue
            out[name] = _dump(value, exclude_none)
        return out

    def model_dump_json(self, exclude_none: bool = False) -> str:
        return json.dumps(self.model_dump(exclude_none=exclude_none),
                          separators=(",", ":"), ensure_ascii=False)

    def __eq__(self, other) -> bool:
        return (type(other) is type(self)
                and self.model_dump() == other.model_dump())

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={getattr(self, k)!r}" for k in self._fields())
        return f"{type(self).__name__}({inner})"


def _reject_unsupported_extras(req: Model) -> Model:
    """Reject beam-search fields the engine does not honor. The reference
    carries use_beam_search/length_penalty in SamplingOptions as an engine
    pass-through (reference: lib/llm/src/protocols/common.rs:248-316); no
    engine here implements beam search, so accepting them silently
    would change sampling semantics without telling the client."""
    extra = req.model_extra or {}
    # no-op values are allowed: clients built on vLLM-style SamplingParams
    # serialize their defaults (use_beam_search=false, length_penalty=1.0),
    # which request no beam search at all
    if extra.get("use_beam_search"):
        raise ValidationError(
            "'use_beam_search' is not supported by this server (beam "
            "search is not implemented); remove it from the request"
        )
    lp = extra.get("length_penalty")
    if lp is not None and lp != 1.0:
        raise ValidationError(
            "'length_penalty' is not supported by this server (beam "
            "search is not implemented); remove it from the request"
        )
    rf = getattr(req, "response_format", None)
    if rf and rf.get("type") not in (None, "text", "json_object",
                                     "json_schema"):
        raise ValidationError(
            f"response_format type {rf.get('type')!r} is not supported; "
            "use 'json_object', 'json_schema', 'text', or the "
            "'guided_choice' extra field"
        )
    if rf and rf.get("type") == "json_schema":
        js = rf.get("json_schema")
        if not isinstance(js, dict) or not isinstance(
                js.get("schema"), dict):
            raise ValidationError(
                "response_format json_schema requires "
                "{'json_schema': {'schema': {...}}} (OpenAI structured-"
                "outputs shape)"
            )
    return req


class NvExt(Model):
    """Extension block: non-standard knobs (name-compatible with reference)."""

    _extra = "allow"
    use_raw_prompt: Optional[bool] = None
    ignore_eos: Optional[bool] = None
    annotations: Optional[List[str]] = None
    greed_sampling: Optional[bool] = None


class ChatMessage(Model):
    _extra = "allow"
    role: str
    content: Optional[Union[str, List[Dict[str, Any]]]] = None
    name: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None
    tool_call_id: Optional[str] = None

    def text_content(self) -> str:
        if isinstance(self.content, str):
            return self.content
        if isinstance(self.content, list):
            return "".join(
                part.get("text", "") for part in self.content if part.get("type") == "text"
            )
        return ""


class StreamOptions(Model):
    include_usage: Optional[bool] = None


class ChatCompletionRequest(Model):
    _extra = "allow"
    model: str
    messages: List[ChatMessage]
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None  # common extension
    min_p: Optional[float] = None
    n: Optional[int] = None
    stop: Optional[Union[str, List[str]]] = None
    stream: Optional[bool] = None
    stream_options: Optional[StreamOptions] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    seed: Optional[int] = None
    logprobs: Optional[bool] = None
    top_logprobs: Optional[int] = None
    logit_bias: Optional[Dict[str, float]] = None
    min_tokens: Optional[int] = None
    ignore_eos: Optional[bool] = None
    user: Optional[str] = None
    tools: Optional[List[Dict[str, Any]]] = None
    tool_choice: Optional[Union[str, Dict[str, Any]]] = None
    response_format: Optional[Dict[str, Any]] = None
    nvext: Optional[NvExt] = None

    def _after_validation(self) -> None:
        _reject_unsupported_extras(self)

    def effective_max_tokens(self) -> Optional[int]:
        # `is None`, not falsy: max_completion_tokens=0 means an empty
        # completion, same as the completions endpoint's max_tokens=0
        if self.max_completion_tokens is not None:
            return self.max_completion_tokens
        return self.max_tokens

    def stop_list(self) -> List[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)


class CompletionRequest(Model):
    _extra = "allow"
    model: str
    prompt: Union[str, List[str], List[int], List[List[int]]]
    max_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    min_p: Optional[float] = None
    n: Optional[int] = None
    stop: Optional[Union[str, List[str]]] = None
    stream: Optional[bool] = None
    stream_options: Optional[StreamOptions] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    seed: Optional[int] = None
    logprobs: Optional[int] = None
    logit_bias: Optional[Dict[str, float]] = None
    best_of: Optional[int] = None
    echo: Optional[bool] = None
    min_tokens: Optional[int] = None
    ignore_eos: Optional[bool] = None
    user: Optional[str] = None
    nvext: Optional[NvExt] = None

    def _after_validation(self) -> None:
        _reject_unsupported_extras(self)

    def stop_list(self) -> List[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)


class Usage(Model):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


class ChatChoiceDelta(Model):
    role: Optional[str] = None
    content: Optional[str] = None
    tool_calls: Optional[List[Dict[str, Any]]] = None


class LogprobEntry(Model):
    token: str
    logprob: float
    bytes: Optional[List[int]] = None
    top_logprobs: List[Dict[str, Any]] = Field(default_factory=list)


class ChoiceLogprobs(Model):
    content: Optional[List[LogprobEntry]] = None


class ChatStreamChoice(Model):
    index: int = 0
    delta: ChatChoiceDelta = Field(default_factory=ChatChoiceDelta)
    finish_reason: Optional[str] = None
    logprobs: Optional[ChoiceLogprobs] = None


class ChatCompletionChunk(Model):
    id: str
    object: Literal["chat.completion.chunk"] = "chat.completion.chunk"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[ChatStreamChoice] = Field(default_factory=list)
    usage: Optional[Usage] = None


class ChatChoice(Model):
    index: int = 0
    message: ChatMessage
    finish_reason: Optional[str] = None
    logprobs: Optional[ChoiceLogprobs] = None


class ChatCompletionResponse(Model):
    id: str
    object: Literal["chat.completion"] = "chat.completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[ChatChoice] = Field(default_factory=list)
    usage: Optional[Usage] = None


class CompletionChoice(Model):
    index: int = 0
    text: str = ""
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


class CompletionResponse(Model):
    id: str
    object: Literal["text_completion"] = "text_completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[CompletionChoice] = Field(default_factory=list)
    usage: Optional[Usage] = None


class ModelInfo(Model):
    id: str
    object: Literal["model"] = "model"
    created: int = Field(default_factory=lambda: int(time.time()))
    owned_by: str = "dynamo-tpu"
    # dynamo extensions (reference http/service/openai.rs model metadata)
    max_model_len: Optional[int] = None
    model_type: Optional[str] = None
    family: Optional[str] = None
    aliases: Optional[List[str]] = None


class ModelList(Model):
    object: Literal["list"] = "list"
    data: List[ModelInfo] = Field(default_factory=list)


def new_request_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def aggregate_chat_stream(
    chunks: List[ChatCompletionChunk],
) -> ChatCompletionResponse:
    """Fold a chunk stream into a full response (non-streaming requests).

    Reference analog: the stream→full aggregators in
    lib/llm/src/protocols/openai/chat_completions/aggregator.rs.
    """
    content: Dict[int, List[str]] = {}
    finish: Dict[int, Optional[str]] = {}
    logprobs: Dict[int, List[LogprobEntry]] = {}
    role: Dict[int, str] = {}
    tool_calls: Dict[int, List[Dict[str, Any]]] = {}
    usage: Optional[Usage] = None
    rid, model, created = "", "", int(time.time())
    for chunk in chunks:
        rid = chunk.id or rid
        model = chunk.model or model
        created = chunk.created
        if chunk.usage is not None:
            usage = chunk.usage
        for choice in chunk.choices:
            idx = choice.index
            if choice.delta.role:
                role[idx] = choice.delta.role
            if choice.delta.content:
                content.setdefault(idx, []).append(choice.delta.content)
            if choice.delta.tool_calls:
                # fold the streamed shape back into whole entries: a delta
                # carrying an "id" opens call slot "index"; id-less deltas
                # are argument fragments that concatenate into that slot
                merged = tool_calls.setdefault(idx, [])
                for c in choice.delta.tool_calls:
                    entry = {k: v for k, v in c.items() if k != "index"}
                    si = c.get("index")
                    if c.get("id") or si is None or si >= len(merged):
                        merged.append(entry)
                        continue
                    target = merged[si]
                    frag = (entry.get("function") or {})
                    fn = target.setdefault("function", {})
                    if frag.get("name"):
                        fn["name"] = fn.get("name", "") + frag["name"]
                    if frag.get("arguments"):
                        fn["arguments"] = (
                            fn.get("arguments", "") + frag["arguments"]
                        )
            if choice.finish_reason is not None:
                finish[idx] = choice.finish_reason
            if choice.logprobs and choice.logprobs.content:
                logprobs.setdefault(idx, []).extend(choice.logprobs.content)
    indices = sorted(set(content) | set(finish) | set(role) | set(tool_calls)) or [0]
    return ChatCompletionResponse(
        id=rid,
        model=model,
        created=created,
        choices=[
            ChatChoice(
                index=i,
                message=ChatMessage(
                    role=role.get(i, "assistant"),
                    content="".join(content.get(i, [])) or None
                    if i in tool_calls else "".join(content.get(i, [])),
                    tool_calls=tool_calls.get(i),
                ),
                finish_reason=finish.get(i),
                logprobs=ChoiceLogprobs(content=logprobs[i]) if i in logprobs else None,
            )
            for i in indices
        ],
        usage=usage,
    )


def aggregate_completion_stream(chunks: List[CompletionResponse]) -> CompletionResponse:
    text: Dict[int, List[str]] = {}
    finish: Dict[int, Optional[str]] = {}
    lps: Dict[int, dict] = {}
    textlen: Dict[int, int] = {}
    usage: Optional[Usage] = None
    rid, model, created = "", "", int(time.time())
    for chunk in chunks:
        rid = chunk.id or rid
        model = chunk.model or model
        created = chunk.created
        if chunk.usage is not None:
            usage = chunk.usage
        for choice in chunk.choices:
            if choice.logprobs:
                # merge legacy logprobs blocks; offsets rebase onto the
                # text accumulated BEFORE this chunk (the chunk's offsets
                # are relative to its own text)
                base = textlen.get(choice.index, 0)
                m = lps.setdefault(choice.index, {
                    "tokens": [], "token_logprobs": [],
                    "top_logprobs": None, "text_offset": [],
                })
                m["tokens"] += choice.logprobs.get("tokens", [])
                m["token_logprobs"] += choice.logprobs.get("token_logprobs", [])
                tops = choice.logprobs.get("top_logprobs")
                if tops:
                    m["top_logprobs"] = (m["top_logprobs"] or []) + tops
                m["text_offset"] += [
                    base + o for o in choice.logprobs.get("text_offset", [])
                ]
            if choice.text:
                textlen[choice.index] = (
                    textlen.get(choice.index, 0) + len(choice.text)
                )
                text.setdefault(choice.index, []).append(choice.text)
            if choice.finish_reason is not None:
                finish[choice.index] = choice.finish_reason
    indices = sorted(set(text) | set(finish)) or [0]
    return CompletionResponse(
        id=rid,
        model=model,
        created=created,
        choices=[
            CompletionChoice(
                index=i, text="".join(text.get(i, [])),
                finish_reason=finish.get(i), logprobs=lps.get(i),
            )
            for i in indices
        ],
        usage=usage,
    )
