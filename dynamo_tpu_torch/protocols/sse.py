"""Server-sent-events codec (reference: lib/llm/src/protocols/codec.rs).

Encodes pydantic models / dicts as ``data: {json}\n\n`` lines with the
OpenAI ``data: [DONE]`` terminator, and parses them back (used by tests
and the batch client).
"""

from __future__ import annotations

import json
from typing import Any, Iterator, Optional

DONE = "[DONE]"


def encode_event(data: Any, event: Optional[str] = None, comment: Optional[str] = None) -> bytes:
    """One SSE frame. ``data`` may be a pydantic model, dict, or string."""
    lines = []
    if comment is not None:
        lines.append(f": {comment}")
    if event is not None:
        lines.append(f"event: {event}")
    if data is not None:
        if hasattr(data, "model_dump_json"):
            payload = data.model_dump_json(exclude_none=True)
        elif isinstance(data, str):
            payload = data
        else:
            payload = json.dumps(data, separators=(",", ":"))
        lines.append(f"data: {payload}")
    return ("\n".join(lines) + "\n\n").encode()


def encode_done() -> bytes:
    return encode_event(DONE)


def parse_stream(raw: bytes) -> Iterator[dict]:
    """Parse a full SSE byte stream into the JSON payloads (skips [DONE])."""
    for block in raw.decode().split("\n\n"):
        for line in block.splitlines():
            if line.startswith("data: "):
                payload = line[len("data: "):]
                if payload.strip() == DONE:
                    continue
                yield json.loads(payload)
