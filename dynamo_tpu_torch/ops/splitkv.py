"""The launch plan of the split-KV core (``csrc/paged_splitkv.cuh``) that
the decode and verify kernels share.

The grid of both kernels is (split, query part x KV head, batch row). A
CTA holds ``Sq`` query positions of its row, at most ``MAX_ROWS`` rows of
(position, group head) pairs; a verify tail with more rows (S 17 at G 8:
136) is cut into parts of ``Sq`` positions (``query_parts``), each a CTA
over the same keys. The number of splits comes from the block table's
width only, never from
``context_lens`` or ``base_pos``: reading those on the host would be a
sync, and a grid fixed by shapes is what a CUDA-graph capture needs. Each
split is a chunk of at least ``MIN_CHUNK`` keys (a multiple of the kernel's
64-key tile), and a table is cut into at most ``MAX_SPLITS`` chunks, so a
16,384-token table launches 32 splits, not 64 of mostly empty CTAs.

When a row's keys span several splits, each writes f32 partials to a
workspace the wrapper allocates per call, and the last split to finish
merges them; it finds out it is last from a counter per (batch row, query
part, KV head) in a buffer kept here per device, zeroed once when allocated and
set back to 0 by every merge. Launches on one device run on one stream at
a time (the engine's), so the kernels share that buffer.

``smem_bytes`` mirrors the kernel's shared-memory layout, so a wrapper
refuses by name a shape that would not fit a CTA on the card (at head_dim
256 a split of more than ~6,600 block-table entries), before a launch
could fail.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

TILE_KEYS = 64    # the kernel's K/V tile
MIN_CHUNK = 256   # keys a split covers at least
MAX_SPLITS = 32
MAX_ROWS = 128    # (query position, group head) rows a CTA holds: Sq * G
MAX_ROWS_D256 = 16  # ... at head_dim 256: one row tile (more spilled)
SMEM_LIMIT = 232448  # dynamic shared memory a CTA may take on an H100

_counters: Dict[torch.device, torch.Tensor] = {}


@functools.lru_cache(maxsize=None)
def plan(table_keys: int) -> Tuple[int, int]:
    """(chunk, splits) for a block table of ``table_keys`` = W * bs keys:
    ``chunk`` a multiple of 64 and ``chunk * splits >= table_keys``."""
    per_split = -(-max(table_keys, 1) // MAX_SPLITS)
    chunk = max(MIN_CHUNK, -(-per_split // TILE_KEYS) * TILE_KEYS)
    return chunk, -(-max(table_keys, 1) // chunk)


def max_rows(head_dim: int) -> int:
    """The (query position, group head) rows a CTA holds at ``head_dim``:
    one 16-row tile at 256, eight below (``paged_splitkv.cuh``)."""
    return MAX_ROWS_D256 if head_dim >= 256 else MAX_ROWS


def query_parts(s: int, g: int, rows: int = MAX_ROWS) -> Tuple[int, int]:
    """(Sq, parts) for S queries of G group heads: the fewest parts of at
    most ``rows`` rows each, their sizes balanced (S 17 at G 8: parts of 9
    and 8 positions; at head_dim 256's 16 rows, S 17 at G 2: 6, 6 and 5).
    The caller checks ``g <= rows``."""
    parts = -(-s // max(1, min(s, rows // g)))
    sq = -(-s // parts)
    return sq, -(-s // sq)


def smem_bytes(head_dim: int, rows: int, chunk: int, bs: int,
               kv_bytes: int = 2) -> int:
    """Dynamic shared memory of one CTA of the split-KV core
    (``paged_splitkv.cuh`` ``smem_bytes``): Q padded to 16-row tiles, the
    three-stage K and V rings of 64-key tiles (``kv_bytes`` 1, the fp8
    form: three e4m3 stages and one bf16 tile each), the merge's row
    statistics and flag, and the chunk's block-table entries."""
    tiles = 1 if rows <= 16 else 2 if rows <= 32 else 4 if rows <= 64 else 8
    tile = TILE_KEYS * head_dim
    ring = 2 * (tile * 2 + 3 * tile) if kv_bytes == 1 else 2 * 3 * tile * 2
    return (16 * tiles * head_dim * 2 + ring
            + 2 * MAX_ROWS * 4 + 16 + (chunk // bs + 2) * 4)


def check_fits(kernel: str, head_dim: int, rows: int, chunk: int,
               bs: int, kv_bytes: int = 2) -> None:
    """Raise, naming ``kernel`` and the shape, when a CTA of ``rows`` rows
    over ``chunk``-key splits of ``bs``-token pages would not fit the
    card's shared memory (``kv_bytes`` the cache's element size)."""
    need = smem_bytes(head_dim, rows, chunk, bs, kv_bytes)
    if need > SMEM_LIMIT:
        raise NotImplementedError(
            f"{kernel}: head_dim {head_dim} with {rows} rows a CTA over "
            f"{chunk}-key splits of {bs}-token pages needs {need} bytes of "
            f"shared memory (> {SMEM_LIMIT})")


def counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's split counters, at least ``n`` of them, all zero
    between launches. A larger buffer replaces a smaller one (zeroed on
    the device, no host sync)."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def workspace(device: torch.device, batch: int, ctas: int, splits: int,
              rows: int, head_dim: int) -> torch.Tensor:
    """f32 partials of every (batch row, query part x KV head = ``ctas``,
    split, query row): acc [.., D], then (m, l) pairs; empty when a call has
    one split."""
    if splits == 1:
        return torch.empty(0, dtype=torch.float32, device=device)
    return torch.empty(batch * ctas * splits * rows * (head_dim + 2),
                       dtype=torch.float32, device=device)
