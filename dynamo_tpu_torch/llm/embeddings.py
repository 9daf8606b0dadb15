"""/v1/embeddings: the prefill-only workload.

The port of ``dynamo_tpu/llm/embeddings.py``. An embeddings request is a
prefill with no decode slot: tokenize, run the batched cacheless prefill
trunk (``models/llama.embed_forward`` via ``ModelRunner.embed_prompts``:
rows pad to the ladders the chat path's prefill uses), L2-normalize the
last valid position's final-norm hidden state, and return OpenAI-shaped
rows with usage counts. No KV blocks, no scheduler slot, no stream.
``EchoEmbedder`` serves the echo engines (hash-seeded unit vectors).
"""

from __future__ import annotations

import asyncio
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np


class EmbeddingError(ValueError):
    """Client-side problem with an embeddings request (HTTP 400)."""


def normalize_inputs(raw) -> List[object]:
    """OpenAI ``input`` shapes → list of items (str or token-id list).

    Accepted: a string, a list of strings, a list of token ids, a list of
    token-id lists. Anything else raises EmbeddingError."""
    if isinstance(raw, str):
        return [raw]
    if isinstance(raw, list):
        if not raw:
            raise EmbeddingError("input must not be empty")
        if all(isinstance(x, str) for x in raw):
            return list(raw)
        if all(isinstance(x, int) for x in raw):
            return [list(raw)]
        if all(isinstance(x, list)
               and x and all(isinstance(t, int) for t in x) for x in raw):
            return [list(x) for x in raw]
    raise EmbeddingError(
        "input must be a string, a list of strings, a list of token ids, "
        "or a list of token-id lists")


class Embedder:
    """Tokenize + batch + embed through a token-level engine.

    ``engine`` must expose ``embed(prompts) -> np.ndarray [n, D]``
    (``TorchServingEngine.embed``). Tokenization and the device round trip
    both run off the event loop."""

    def __init__(self, tokenizer, engine, max_model_len: int,
                 vocab_size: Optional[int] = None):
        self.tokenizer = tokenizer
        self.engine = engine
        self.max_model_len = int(max_model_len)
        self.vocab_size = vocab_size

    def _tokenize(self, items: Sequence[object]) -> List[List[int]]:
        prompts: List[List[int]] = []
        for item in items:
            if isinstance(item, str):
                if self.tokenizer is None:
                    raise EmbeddingError(
                        "string input needs a tokenizer; this engine was "
                        "built without a model path — send token ids")
                ids = list(self.tokenizer.encode(item))
            else:
                ids = [int(t) for t in item]
            if not ids:
                raise EmbeddingError("input item tokenized to zero tokens")
            if len(ids) > self.max_model_len:
                raise EmbeddingError(
                    f"input of {len(ids)} tokens exceeds the model's "
                    f"context length {self.max_model_len}")
            if self.vocab_size is not None:
                bad = next((t for t in ids
                            if not 0 <= t < self.vocab_size), None)
                if bad is not None:
                    raise EmbeddingError(
                        f"token id {bad} outside vocab [0, "
                        f"{self.vocab_size})")
            prompts.append(ids)
        return prompts

    async def embed(self, raw_input) -> Tuple[List[List[float]], int]:
        """→ (L2-normalized vectors, total prompt tokens)."""
        items = normalize_inputs(raw_input)
        loop = asyncio.get_running_loop()
        prompts = await loop.run_in_executor(None, self._tokenize, items)
        vecs = await self.engine.embed(prompts)
        vecs = np.asarray(vecs, np.float32)
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        vecs = vecs / np.maximum(norms, 1e-12)
        return ([[float(x) for x in v] for v in vecs],
                sum(len(p) for p in prompts))


class EchoEmbedder:
    """Deterministic test/demo embedder: a hash-seeded unit vector per input
    (the echo engines' counterpart for the embeddings workload)."""

    def __init__(self, dim: int = 16, tokenizer=None,
                 max_model_len: int = 8192):
        self.dim = dim
        self.tokenizer = tokenizer
        self.max_model_len = max_model_len

    async def embed(self, raw_input) -> Tuple[List[List[float]], int]:
        items = normalize_inputs(raw_input)
        out: List[List[float]] = []
        ntok = 0
        for item in items:
            if isinstance(item, str):
                ntok += max(1, len(item.split()))
                seed_bytes = item.encode()
            else:
                ntok += len(item)
                seed_bytes = np.asarray(item, np.int64).tobytes()
            seed = int.from_bytes(
                hashlib.sha256(seed_bytes).digest()[:8], "little")
            v = np.random.default_rng(seed).standard_normal(self.dim)
            v = v / np.linalg.norm(v)
            out.append([float(x) for x in v])
        return out, ntok
