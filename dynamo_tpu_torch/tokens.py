"""Token sequences and content-addressed KV blocks.

Every KV-cache block is identified by two hashes:

- ``block_hash``: a salted XXH64 over the block's token ids. Identical token
  contents produce identical block hashes regardless of position.
- ``sequence_hash``: a chained hash ``H(parent_sequence_hash, block_hash)``
  that identifies the block *in context* — i.e. the whole prefix ending at
  this block. Two requests share a KV prefix iff their sequence hashes match.

The port's copy of ``dynamo_tpu/tokens.py``. The hashes are bit-equal to the
reference package's (the KV router consumes them), but XXH64 is computed by
the pure-Python implementation below instead of the ``xxhash`` package.
The batched ``compute_block_hashes`` (the router's, the block allocator's,
the KV fabric's and the prefill worker's hot path) runs in the native host
core (``dynamo_tpu_torch/native``, built with the host compiler at first
use); ``compute_block_hashes_plain`` is its plain version. A native build
that fails raises: nothing sends the batched hash to the plain loop then.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import struct

import numpy as np

_M64 = (1 << 64) - 1
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def _merge(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return (acc * _P1 + _P4) & _M64


def xxh64_intdigest(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` as an unsigned 64-bit int (the reference
    algorithm, equal to ``xxh64_intdigest``)."""
    n = len(data)
    seed &= _M64
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed
        v4 = (seed - _P1) & _M64
        while p + 32 <= n:
            a, b, c, d = struct.unpack_from("<4Q", data, p)
            v1, v2 = _round(v1, a), _round(v2, b)
            v3, v4 = _round(v3, c), _round(v4, d)
            p += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = _merge(h, v)
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, p)
        h ^= _round(0, k)
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        (k,) = struct.unpack_from("<I", data, p)
        h ^= (k * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h

# Seed matching the reference's router-side block hasher
# (reference: lib/llm/src/kv_router/indexer.rs:64 — seed 1337).
DEFAULT_SALT = b"dynamo-tpu"
ROUTER_SEED = 1337


def salt_hash(salt: bytes = DEFAULT_SALT) -> int:
    """Hash a salt into a 64-bit seed for block hashing.

    Deployments that must not share hash namespaces pass
    ``TokenSequence(..., salt=...)`` (or ``seed=salt_hash(salt)`` to the
    free functions) so identical token content hashes differently per salt.
    """
    return xxh64_intdigest(salt)


def _tokens_to_bytes(token_ids: Sequence[int]) -> bytes:
    return np.asarray(token_ids, dtype=np.uint32).tobytes()


def compute_block_hash(token_ids: Sequence[int], seed: int = ROUTER_SEED) -> int:
    """Salted content hash of one block's token ids (position-independent)."""
    return xxh64_intdigest(_tokens_to_bytes(token_ids), seed=seed)


def chain_hash(parent_sequence_hash: Optional[int], block_hash: int) -> int:
    """Chained prefix hash: identifies the whole sequence ending at this block."""
    if parent_sequence_hash is None:
        return block_hash
    buf = np.asarray([parent_sequence_hash, block_hash], dtype=np.uint64).tobytes()
    return xxh64_intdigest(buf)


def full_block_ids(token_ids: Sequence[int], block_size: int) -> np.ndarray:
    """The ids of the complete blocks as contiguous uint32, the bytes both
    batched hashes read. The ragged tail is dropped before the conversion,
    so an id outside uint32 there is ignored by both; one inside a complete
    block is refused by both alike (numpy's ``OverflowError`` for a Python
    int; an integer array's values wrap as ``astype`` wraps them)."""
    n_full = len(token_ids) // block_size
    return np.ascontiguousarray(token_ids[: n_full * block_size],
                                dtype=np.uint32)


def compute_block_hashes(
    token_ids: Sequence[int], block_size: int, seed: int = ROUTER_SEED
) -> List[int]:
    """Sequence hashes for each *complete* block of ``token_ids``.

    This is the hot path used by the KV router on every scheduling decision
    (reference: lib/llm/src/kv_router/indexer.rs:123 compute_block_hash_for_seq):
    only full blocks are hashed; the ragged tail is ignored. Runs in the
    native core (``native.compute_block_hashes``).
    """
    from . import native

    return native.compute_block_hashes(token_ids, block_size, seed)


def compute_block_hashes_plain(
    token_ids: Sequence[int], block_size: int, seed: int = ROUTER_SEED
) -> List[int]:
    """The plain version of ``compute_block_hashes``: the pure-Python
    XXH64 block by block."""
    arr = full_block_ids(token_ids, block_size)
    n_full = len(arr) // block_size
    out: List[int] = []
    parent: Optional[int] = None
    for i in range(n_full):
        bh = xxh64_intdigest(
            arr[i * block_size : (i + 1) * block_size].tobytes(), seed=seed
        )
        parent = chain_hash(parent, bh)
        out.append(parent)
    return out


@dataclasses.dataclass(frozen=True)
class TokenBlock:
    """An immutable, completely-filled block of tokens.

    ``sequence_hash`` = chain(parent_sequence_hash, block_hash) uniquely names
    the prefix [0, position*block_size + len(tokens)) of the owning sequence.
    """

    tokens: Tuple[int, ...]
    block_hash: int
    sequence_hash: int
    parent_sequence_hash: Optional[int]
    position: int  # block index within the sequence

    @property
    def block_size(self) -> int:
        return len(self.tokens)


class PartialTokenBlock:
    """Mutable tail block of a growing sequence; freezes into a TokenBlock."""

    def __init__(
        self,
        block_size: int,
        position: int,
        parent_sequence_hash: Optional[int],
        seed: int,
    ):
        self.block_size = block_size
        self.position = position
        self.parent_sequence_hash = parent_sequence_hash
        self.seed = seed
        self.tokens: List[int] = []

    def push(self, token_id: int) -> Optional[TokenBlock]:
        """Append one token. Returns the frozen block when it fills up."""
        self.tokens.append(int(token_id))
        if len(self.tokens) == self.block_size:
            return self.freeze()
        return None

    def freeze(self) -> TokenBlock:
        bh = compute_block_hash(self.tokens, self.seed)
        sh = chain_hash(self.parent_sequence_hash, bh)
        return TokenBlock(
            tokens=tuple(self.tokens),
            block_hash=bh,
            sequence_hash=sh,
            parent_sequence_hash=self.parent_sequence_hash,
            position=self.position,
        )

    def __len__(self) -> int:
        return len(self.tokens)


class TokenSequence:
    """A token sequence chunked into hash-chained blocks.

    Used by the engine's block allocator to track which KV blocks are
    complete (shareable / publishable as KV events) vs. the in-flight tail.
    """

    def __init__(
        self,
        token_ids: Iterable[int] = (),
        block_size: int = 16,
        seed: int = ROUTER_SEED,
        salt: Optional[bytes] = None,
    ):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = block_size
        self.seed = salt_hash(salt) if salt is not None else seed
        self.blocks: List[TokenBlock] = []
        self._tail = PartialTokenBlock(block_size, 0, None, self.seed)
        self.extend(token_ids)

    def extend(self, token_ids: Iterable[int]) -> List[TokenBlock]:
        """Append tokens; returns any blocks completed by this extension."""
        completed: List[TokenBlock] = []
        for t in token_ids:
            blk = self.push(t)
            if blk is not None:
                completed.append(blk)
        return completed

    def push(self, token_id: int) -> Optional[TokenBlock]:
        blk = self._tail.push(token_id)
        if blk is not None:
            self.blocks.append(blk)
            self._tail = PartialTokenBlock(
                self.block_size, blk.position + 1, blk.sequence_hash, self.seed
            )
        return blk

    @property
    def tail(self) -> PartialTokenBlock:
        return self._tail

    @property
    def token_ids(self) -> List[int]:
        out: List[int] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self._tail.tokens)
        return out

    def sequence_hashes(self) -> List[int]:
        return [b.sequence_hash for b in self.blocks]

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self._tail)
