"""Batch input: run a JSONL file of prompts through the engine (``in=batch:<file>``).

The port's copy of ``dynamo_tpu/cli/batch.py``. Each line is ``{"text":
...}`` (with an optional ``max_tokens``) or a whole chat request; one JSON
record a request goes to stdout (its output, TTFT, the mean and p99 gap
between emissions, its total seconds and its token counts), and the
aggregate summary to stderr, so the result stream stays machine-readable.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from typing import List

from ..protocols.annotated import Annotated
from ..protocols.openai import ChatCompletionRequest
from ..runtime.engine import Context


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def itl_stats(gaps: List[float]) -> dict:
    """Gaps between consecutive emissions → {mean, p99} (0.0 when a request
    produced fewer than two chunks)."""
    if not gaps:
        return {"itl_mean_s": 0.0, "itl_p99_s": 0.0}
    return {
        "itl_mean_s": round(sum(gaps) / len(gaps), 4),
        "itl_p99_s": round(_percentile(sorted(gaps), 0.99), 4),
    }


def _load_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _request(entry: dict, name: str) -> ChatCompletionRequest:
    if "messages" in entry:
        return ChatCompletionRequest.model_validate({"model": name, **entry})
    return ChatCompletionRequest(
        model=name, messages=[{"role": "user", "content": entry.get("text", "")}],
        max_tokens=entry.get("max_tokens"))


async def run_batch(flags, engine, mdc, path: str) -> None:
    name = flags.model_name or (mdc.display_name if mdc else "echo")
    # off the loop: the engine may already serve on it while a big file loads
    lines = await asyncio.get_running_loop().run_in_executor(
        None, _load_jsonl, path)
    ttfts: List[float] = []
    all_gaps: List[float] = []
    out_tokens = 0
    for i, entry in enumerate(lines):
        req = _request(entry, name)
        start = time.monotonic()
        first = last_emit = None
        gaps: List[float] = []
        parts = []
        usage = {}
        async for chunk in engine.generate(Context(req)):
            if Annotated.maybe_from_wire(chunk) is not None:
                continue  # annotation envelopes carry no completion text
            d = chunk if isinstance(chunk, dict) else chunk.model_dump(exclude_none=True)
            usage = d.get("usage") or usage
            for choice in d.get("choices", []):
                content = (choice.get("delta") or {}).get("content")
                if content:
                    now = time.monotonic()
                    if first is None:
                        first = now - start
                    else:
                        gaps.append(now - last_emit)
                    last_emit = now
                    parts.append(content)
        if first is not None:
            ttfts.append(first)
        all_gaps.extend(gaps)
        # token counts: the engine's usage where it reports one (a
        # pipeline engine does), else the emissions
        completion_tokens = usage.get("completion_tokens", len(parts))
        out_tokens += completion_tokens
        print(json.dumps({
            "index": i,
            "output": "".join(parts),
            "ttft_s": round(first or 0.0, 4),
            **itl_stats(gaps),
            "total_s": round(time.monotonic() - start, 4),
            "prompt_tokens": usage.get("prompt_tokens"),
            "completion_tokens": completion_tokens,
        }), flush=True)
    if lines:
        summary = {
            "requests": len(lines),
            "ttft_mean_s": round(sum(ttfts) / len(ttfts), 4) if ttfts else 0.0,
            "ttft_p99_s": round(_percentile(sorted(ttfts), 0.99), 4),
            **itl_stats(all_gaps),
            "completion_tokens": out_tokens,
        }
        print(f"batch summary: {json.dumps(summary)}", file=sys.stderr,
              flush=True)
