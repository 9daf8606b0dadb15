"""Annotated stream envelope: data deltas + out-of-band events.

Reference analog: lib/runtime/src/protocols/annotated.rs:1-168 — every
service stream may interleave plain data items with named events
(annotations) and error markers; on the wire an annotation maps onto an
SSE frame with ``event:`` + ``:`` comment lines and no ``data:`` payload,
so OpenAI clients ignore it while instrumented clients (benchmarks,
debuggers) can read e.g. the preprocessor's ``formatted_prompt`` /
``token_ids`` annotations (preprocessor.rs:134-160).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional

# annotation names the preprocessor understands (requested via
# nvext.annotations on the OpenAI request)
ANNOTATION_FORMATTED_PROMPT = "formatted_prompt"
ANNOTATION_TOKEN_IDS = "token_ids"


@dataclasses.dataclass
class Annotated:
    """One stream element: a data delta, an annotation event, or an error."""

    data: Optional[Any] = None
    id: Optional[str] = None
    event: Optional[str] = None
    comment: Optional[List[str]] = None

    @classmethod
    def from_error(cls, error: str) -> "Annotated":
        return cls(event="error", comment=[error])

    @classmethod
    def from_annotation(cls, name: str, value: Any) -> "Annotated":
        return cls(event=name, comment=[json.dumps(value)])

    @property
    def is_error(self) -> bool:
        return self.event == "error"

    @property
    def is_annotation(self) -> bool:
        return self.event is not None and self.event != "error"

    def annotation_value(self) -> Any:
        """Decode the JSON payload of an annotation event."""
        if not self.comment:
            return None
        return json.loads(self.comment[0])

    def to_wire(self) -> dict:
        """Dict form for the msgpack data plane (distributed graphs).

        Only event envelopes cross the wire — data deltas travel as their
        own raw chunks (``data`` is intentionally not serialized)."""
        body = {}
        for key in ("id", "event", "comment"):
            value = getattr(self, key)
            if value is not None:
                body[key] = value
        return {"__annotated__": body}

    @classmethod
    def maybe_from_wire(cls, obj: Any) -> Optional["Annotated"]:
        """Reconstruct from to_wire() output; None for anything else."""
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict) and "__annotated__" in obj:
            return cls(**obj["__annotated__"])
        return None
