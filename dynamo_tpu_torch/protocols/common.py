"""Internal engine-facing protocol: the framework's lingua franca.

Every request, after preprocessing, becomes a ``PreprocessedRequest`` of
token ids + sampling/stop options; every engine emits ``EngineOutput``
deltas of token ids. The HTTP protocol layer translates both ways.
Field semantics follow the reference's common protocol (reference:
lib/llm/src/protocols/common.rs:205-341 — StopConditions, SamplingOptions,
OutputOptions; common/llm_backend.rs — BackendInput/LLMEngineOutput),
re-designed as msgpack-friendly dataclasses.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional


class FinishReason(str, enum.Enum):
    EOS = "eos"          # hit the model's end-of-sequence token
    STOP = "stop"        # hit a user/model stop sequence or stop token id
    LENGTH = "length"    # hit max_tokens / context limit
    CANCELLED = "cancelled"
    ERROR = "error"

    def to_openai(self) -> str:
        if self in (FinishReason.EOS, FinishReason.STOP):
            return "stop"
        if self is FinishReason.LENGTH:
            return "length"
        return "stop" if self is FinishReason.CANCELLED else "error"


@dataclasses.dataclass
class StopConditions:
    max_tokens: Optional[int] = None
    min_tokens: Optional[int] = None
    stop: Optional[List[str]] = None                 # visible stop strings
    stop_token_ids_hidden: Optional[List[int]] = None  # never surfaced in text
    ignore_eos: bool = False
    # canonical tokenization of each ``stop`` string (preprocessor-
    # filled, aligned 1:1 with ``stop``): lets a token-level engine
    # detect stop strings without a tokenizer — the persistent decode
    # chain's device-approximate stop check hashes these. Text-level
    # matching across OTHER tokenizations stays the backend
    # detokenizer jail's job.
    stop_token_seqs: Optional[List[List[int]]] = None

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "StopConditions":
        return cls(**d)


@dataclasses.dataclass
class SamplingOptions:
    n: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    min_p: Optional[float] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    seed: Optional[int] = None
    # OpenAI logit_bias: token id → additive logit offset (engine applies
    # it in the jitted sampler via a per-slot bias row)
    logit_bias: Optional[Dict[int, float]] = None
    # guided decoding (vLLM-style extra field): constrain the output to
    # one of these strings. The preprocessor tokenizes each choice; the
    # engine walks a token trie and masks the sampler's bias row per
    # step. Canonical-tokenization semantics: the output follows each
    # choice's whole-string tokenization.
    guided_choice: Optional[List[str]] = None
    # the trie's token ids (preprocessor-filled; engines consume this,
    # not the strings — the engine holds no tokenizer)
    guided_choice_token_ids: Optional[List[List[int]]] = None
    # guided JSON (OpenAI response_format / vLLM guided_json extra):
    # {"type": "json_object"} or {"type": "json_schema", "schema": {...}}.
    # The engine compiles it to a character-level JSON machine driving
    # the same per-step bias-row edits as guided_choice (engine/guided.py).
    guided_json: Optional[dict] = None

    def to_wire(self) -> dict:
        d = dataclasses.asdict(self)
        if d.get("logit_bias"):
            # string keys on the wire: msgpack's default strict_map_key
            # decoding (and JSON) reject int map keys
            d["logit_bias"] = {str(k): v for k, v in d["logit_bias"].items()}
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "SamplingOptions":
        if d.get("logit_bias"):
            d = {**d, "logit_bias": {
                int(k): float(v) for k, v in d["logit_bias"].items()
            }}
        return cls(**d)


@dataclasses.dataclass
class OutputOptions:
    logprobs: Optional[int] = None          # top-k logprobs per sampled token
    prompt_logprobs: Optional[int] = None
    skip_special_tokens: bool = True
    echo_prompt: bool = False

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "OutputOptions":
        return cls(**d)


@dataclasses.dataclass
class PreprocessedRequest:
    """Token-level request handed to an engine (or shipped to a worker)."""

    token_ids: List[int]
    stop_conditions: StopConditions = dataclasses.field(default_factory=StopConditions)
    sampling_options: SamplingOptions = dataclasses.field(default_factory=SamplingOptions)
    output_options: OutputOptions = dataclasses.field(default_factory=OutputOptions)
    eos_token_ids: List[int] = dataclasses.field(default_factory=list)
    model: Optional[str] = None
    mdc_checksum: Optional[str] = None
    annotations: List[str] = dataclasses.field(default_factory=list)
    # payloads answering requested annotations (formatted_prompt,
    # token_ids) — local side channel, deliberately NOT a wire field: the
    # preprocessor emits them as Annotated events before dispatch
    annotation_values: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_wire(self) -> dict:
        return {
            "token_ids": list(self.token_ids),
            "stop_conditions": self.stop_conditions.to_wire(),
            "sampling_options": self.sampling_options.to_wire(),
            "output_options": self.output_options.to_wire(),
            "eos_token_ids": list(self.eos_token_ids),
            "model": self.model,
            "mdc_checksum": self.mdc_checksum,
            "annotations": list(self.annotations),
        }

    @classmethod
    def from_wire(cls, d: dict) -> "PreprocessedRequest":
        return cls(
            token_ids=list(d["token_ids"]),
            stop_conditions=StopConditions.from_wire(d.get("stop_conditions", {})),
            sampling_options=SamplingOptions.from_wire(d.get("sampling_options", {})),
            output_options=OutputOptions.from_wire(d.get("output_options", {})),
            eos_token_ids=list(d.get("eos_token_ids", [])),
            model=d.get("model"),
            mdc_checksum=d.get("mdc_checksum"),
            annotations=list(d.get("annotations", [])),
        )


@dataclasses.dataclass
class TokenLogprob:
    token_id: int
    logprob: float
    top: Optional[Dict[int, float]] = None  # token_id -> logprob


@dataclasses.dataclass
class EngineOutput:
    """One streamed delta from an engine: newly generated token ids."""

    token_ids: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[FinishReason] = None
    logprobs: Optional[List[TokenLogprob]] = None
    # engine-side detokenized text, if the engine chooses to provide it
    text: Optional[str] = None
    # OutputOptions.prompt_logprobs result: one entry per prompt token
    # (first None — no conditioning prefix), sent once with the first
    # output (reference: lib/llm/src/protocols/common.rs:320-341)
    prompt_logprobs: Optional[List[Optional[float]]] = None
    # KV/scheduling telemetry piggybacked on outputs (optional)
    kv_transfer_params: Optional[dict] = None
    # migration control frame (recovery/migration.py): the request now
    # lives on a peer — ``{host, port, resume_id}`` lets the consumer
    # re-bind its stream directly to the peer so the source worker can
    # exit instead of staying up to relay. Carries no client payload.
    migrated: Optional[dict] = None
    # n>1 fan-out (engine/serving.py): which choice this delta belongs
    # to. None for single-choice requests — the overwhelmingly common
    # case pays no wire bytes.
    choice: Optional[int] = None

    def to_wire(self) -> dict:
        d: Dict[str, Any] = {"token_ids": list(self.token_ids)}
        if self.finish_reason is not None:
            d["finish_reason"] = self.finish_reason.value
        if self.choice is not None:
            d["choice"] = self.choice
        if self.text is not None:
            d["text"] = self.text
        if self.prompt_logprobs is not None:
            d["prompt_logprobs"] = self.prompt_logprobs
        if self.logprobs is not None:
            d["logprobs"] = [
                {
                    "token_id": lp.token_id,
                    "logprob": lp.logprob,
                    # string keys: int map keys fail msgpack's strict
                    # decode on the dial-back stream (and JSON)
                    "top": (
                        {str(k): v for k, v in lp.top.items()}
                        if lp.top else lp.top
                    ),
                }
                for lp in self.logprobs
            ]
        if self.kv_transfer_params is not None:
            d["kv_transfer_params"] = self.kv_transfer_params
        if self.migrated is not None:
            d["migrated"] = self.migrated
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "EngineOutput":
        fr = d.get("finish_reason")
        lps = d.get("logprobs")
        return cls(
            token_ids=list(d.get("token_ids", [])),
            finish_reason=FinishReason(fr) if fr else None,
            text=d.get("text"),
            logprobs=[
                TokenLogprob(
                    lp["token_id"], lp["logprob"],
                    {int(k): float(v) for k, v in lp["top"].items()}
                    if lp.get("top") else None,
                )
                for lp in lps
            ]
            if lps
            else None,
            prompt_logprobs=d.get("prompt_logprobs"),
            kv_transfer_params=d.get("kv_transfer_params"),
            migrated=d.get("migrated"),
            choice=d.get("choice"),
        )


@dataclasses.dataclass
class BackendOutput:
    """EngineOutput after the detokenizer stage: adds clean text deltas."""

    token_ids: List[int]
    text: Optional[str]
    finish_reason: Optional[FinishReason] = None
    logprobs: Optional[List[TokenLogprob]] = None
    prompt_logprobs: Optional[List[Optional[float]]] = None
    cum_tokens: int = 0
