"""Engine-facing sequence-parallel prefill attention: one chunk of a long
prompt, the ``sp`` ranks on one device.

The port of ``sp_chunk_attention`` and the merge of ``_sp_chunk_body``
(``dynamo_tpu/parallel/sequence.py``), the reference's kernel route. The
chunk's queries and fresh K/V split over the ranks (rank r owns rows
``[r·S/sp, (r+1)·S/sp)``); earlier chunks' K/V already sit in the paged
cache. Both key sources fold into ONE online softmax:

- ring partials over the chunk's fresh K/V only
  (``ring_attention._ring_partials``: causal within the chunk by global
  position), and
- partials of each rank's query shard against the committed prefix, read
  in place from the paged cache by the prefix kernel
  (``ops/sp_prefix.paged_prefix_attention_partials``; its plain version on
  the CPU), the ranks stacked as the kernel's batch rows over one
  broadcast block table. An fp8 (e4m3) cache takes the kernel's fp8 form,
  which upcasts the pages as it reads them (the reference upcasts fp8
  storage to the compute dtype, ``parallel/sequence.py:159``, and in its
  prefix kernel, ``ops/pallas_sp.py:127-129``); the fresh K/V of the ring
  stay in the compute dtype, as there.

The two partial sets merge exp-weighted and normalise once. Prefix keys
are exactly the cache slots ``< chunk_start``: the chunk's own slots are
never counted twice, and a prefix-cache hit's reused blocks come for free.
The reference's XLA gather route is not served here (the tests hold this
route against it); Ulysses and the whole-prompt ``sp_prefill_attention``
are not on the engine's path.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.sp_prefix import paged_prefix_attention_partials
from .ring_attention import _NEG, _ring_partials, shard_ranks


def _chunk_qpos(s: int, chunk_start: int, context_len: int, device) -> torch.Tensor:
    """Global query positions [1, S] for one chunk; rows past the valid tail
    (the last chunk's padding) get -1 and mask out everywhere."""
    idx = torch.arange(s, dtype=torch.int64, device=device)[None, :]
    return torch.where(idx < context_len - chunk_start, chunk_start + idx, -1)


def sp_chunk_attention(
    q: torch.Tensor,             # [1, S, H, D] post-RoPE chunk queries
    k: torch.Tensor,             # [1, S, KVH, D] the chunk's fresh keys
    v: torch.Tensor,             # [1, S, KVH, D]
    k_cache: torch.Tensor,       # [L, N, bs, KVH, D] stacked paged cache
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [1, W] int32: this sequence's block ids
    chunk_start: int,            # the chunk's first absolute position
    context_len: int,            # chunk end (valid tokens incl. the chunk)
    layer_idx: int,              # layer of the stacked cache
    sp: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of ONE sequence-parallel prefill chunk; returns
    [1, S, H, D] in q's dtype (pad rows are exactly 0). ``chunk_start``,
    ``context_len`` and ``layer_idx`` are host ints: nothing is read back
    from the device."""
    b, s, h, d = q.shape
    if b != 1:
        raise ValueError(f"an SP chunk is one sequence (got B={b})")
    if s % sp:
        raise ValueError(f"sp chunk S must divide over sp: S={s}, sp={sp}")
    if scale is None:
        scale = d ** -0.5
    sq = s // sp
    kvh = k.shape[2]
    g = h // kvh
    qpos = shard_ranks(_chunk_qpos(s, chunk_start, context_len, q.device), sp)
    # ring over the chunk's fresh K/V only: kpos == qpos (the chunk IS the
    # newest keys; causality inside the chunk by global positions)
    o_r, m_r, l_r = _ring_partials(
        shard_ranks(q, sp), shard_ranks(k, sp), shard_ranks(v, sp), qpos, qpos,
        scale=scale)                                 # [n,1,KVH,G,Sq(,D)] f32
    acc_p, m_p, l_p = paged_prefix_attention_partials(
        q.reshape(sp, sq, h, d), k_cache, v_cache,
        block_tables.expand(sp, block_tables.shape[1]), chunk_start, layer_idx,
        scale=scale)                                 # [n,Sq,KVH,G(,D)] f32
    acc_p = acc_p.permute(0, 2, 3, 1, 4).reshape(sp, 1, kvh, g, sq, d)
    m_p = m_p.permute(0, 2, 3, 1).reshape(sp, 1, kvh, g, sq)
    l_p = l_p.permute(0, 2, 3, 1).reshape(sp, 1, kvh, g, sq)
    # pad query rows attended the whole prefix inside the kernel (it has no
    # notion of query validity): empty their partials so the merged row is
    # exactly 0, like the gather route's
    padded = (qpos < 0)[:, :, None, None, :]
    m_p = torch.where(padded, _NEG, m_p)
    l_p = torch.where(padded, 0.0, l_p)
    acc_p = torch.where(padded[..., None], 0.0, acc_p)

    m = torch.maximum(m_r, m_p)
    a_r = torch.exp(m_r - m)
    a_p = torch.exp(m_p - m)
    l_tot = a_r * l_r + a_p * l_p
    o = (o_r * a_r[..., None] + acc_p * a_p[..., None]) / torch.where(
        l_tot == 0.0, 1.0, l_tot)[..., None]
    # [n, 1, KVH, G, Sq, D] → [1, S, H, D]: rank-major rows
    return o.permute(1, 0, 4, 2, 3, 5).reshape(b, s, h, d).to(q.dtype)
