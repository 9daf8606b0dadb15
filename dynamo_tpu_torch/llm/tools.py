"""Tool-call extraction from generated text → OpenAI ``tool_calls``.

Reference analog: lib/llm/src/preprocessor/tools.rs ToolCallingMatcher —
which only JSON-parses a whole message as {name, parameters|arguments}
(and, notably, was never wired into the reference's delta layer; every
delta carried ``tool_calls: None``, left unimplemented at
chat_completions/delta.rs:131 — resolved here, including the forced
tool_choice forms "required" and named-function, which jail the stream
from token 0). Parsing covers the formats the popular
open-weight families actually emit, and llm/preprocessor.py chat_stream
emits the proper OpenAI STREAMED tool-call shape from it: per call, a
header delta ({index, id, type, function.name, arguments: ""}) followed
by {index, function.arguments} fragment deltas, closed by an empty
delta with finish_reason="tool_calls"; protocols/openai.py
aggregate_chat_stream folds the fragments back into whole entries for
non-streaming responses.

Formats:
- ``hermes``   — ``<tool_call>{...}</tool_call>`` blocks (Hermes, Qwen)
- ``mistral``  — ``[TOOL_CALLS] [{...}, ...]`` prefix
- ``json``     — the whole message is one JSON object or array of
                 objects with ``name`` + ``arguments``/``parameters``
                 (Llama-3.x JSON tool calling; the reference's behavior)
- ``auto``     — try hermes, then mistral, then json
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any, Dict, List, Optional

_HERMES_RE = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.DOTALL)
_MISTRAL_PREFIX = "[TOOL_CALLS]"

FORMATS = ("auto", "hermes", "mistral", "json")


def _call_dict(name: str, arguments: Any) -> Dict[str, Any]:
    """One OpenAI tool_calls entry; arguments always a JSON string."""
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments)
    return {
        "id": f"call-{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


def _from_obj(obj: Any) -> Optional[Dict[str, Any]]:
    """{name, arguments|parameters} → tool_calls entry (else None)."""
    if not isinstance(obj, dict) or not isinstance(obj.get("name"), str):
        return None
    args = obj.get("arguments", obj.get("parameters"))
    if args is None or isinstance(args, (dict, str, list)):
        return _call_dict(obj["name"], args if args is not None else {})
    return None


def _parse_json_value(text: str) -> Optional[List[Dict[str, Any]]]:
    try:
        value = json.loads(text)
    except ValueError:
        return None
    objs = value if isinstance(value, list) else [value]
    calls = [_from_obj(o) for o in objs]
    if calls and all(c is not None for c in calls):
        return calls  # type: ignore[return-value]
    return None


def _extract_hermes(text: str):
    blocks = _HERMES_RE.findall(text)
    if not blocks:
        return text, None
    calls = []
    for block in blocks:
        parsed = _parse_json_value(block)
        if parsed is None:
            return text, None
        calls.extend(parsed)
    content = _HERMES_RE.sub("", text).strip()
    return content, (calls or None)


def _extract_mistral(text: str):
    stripped = text.strip()
    if not stripped.startswith(_MISTRAL_PREFIX):
        return text, None
    calls = _parse_json_value(stripped[len(_MISTRAL_PREFIX):].strip())
    return ("", calls) if calls else (text, None)


def _extract_json(text: str):
    calls = _parse_json_value(text.strip())
    return ("", calls) if calls else (text, None)


_EXTRACTORS = {
    "hermes": _extract_hermes,
    "mistral": _extract_mistral,
    "json": _extract_json,
}


def extract_tool_calls(text: str, fmt: str = "auto"):
    """(surrounding_content, calls-or-None) from a complete generation.

    Models legitimately emit prose around call blocks ("Let me check
    <tool_call>…</tool_call>") — that content is preserved for the
    response alongside ``tool_calls``."""
    if fmt == "auto":
        for name in ("hermes", "mistral", "json"):
            content, calls = _EXTRACTORS[name](text)
            if calls:
                return content, calls
        return text, None
    if fmt not in _EXTRACTORS:
        raise ValueError(f"unknown tool-call format {fmt!r}; use {FORMATS}")
    return _EXTRACTORS[fmt](text)


def parse_tool_calls(
    text: str, fmt: str = "auto"
) -> Optional[List[Dict[str, Any]]]:
    """Extract tool calls from a complete generation, or None if the text
    is not a tool call (callers then deliver it as normal content)."""
    return extract_tool_calls(text, fmt)[1]


def stream_markers(fmt: str = "auto"):
    """Substrings whose appearance in a stream signals a potential tool
    call: the backend's streaming jail withholds text only from a marker
    onward (the ``json`` format has no marker — a leading JSON value is
    its only signature, which the caller checks on the first chunk)."""
    if fmt == "hermes":
        return ("<tool_call>",)
    if fmt == "mistral":
        return (_MISTRAL_PREFIX,)
    if fmt == "json":
        return ()
    return ("<tool_call>", _MISTRAL_PREFIX)


def marker_prefix_len(tail: str, markers) -> int:
    """Longest suffix of ``tail`` that is a proper prefix of any marker —
    that many chars must be withheld in case the marker completes in the
    next chunk (same idea as the detokenizer's stop-string jail)."""
    best = 0
    for m in markers:
        for k in range(min(len(tail), len(m) - 1), 0, -1):
            if tail.endswith(m[:k]):
                best = max(best, k)
                break
    return best
