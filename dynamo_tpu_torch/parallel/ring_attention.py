"""Ring attention with the ``sp`` ranks laid out on one device.

The port of ``dynamo_tpu/parallel/ring_attention.py`` (``_ring_partials``,
``ring_attention``, ``dense_reference``). The reference shards the
sequence over a mesh axis under ``shard_map``: each device holds S/sp of
the queries and rotates K/V (and their position ids) around the ring with
``lax.ppermute`` while it accumulates online-softmax partials. Here the
ranks are dimension 0 of every sharded tensor — rank r owns rows
``[r·S/sp, (r+1)·S/sp)`` — and the rotation is ``torch.roll(x, 1, dims=0)``:
rank r receives rank r − 1's block, the reference's perm ``(j, j+1)``.
Each rank does the same arithmetic in the same merge order as on the mesh.
The math is f32 einsums, as the reference leaves it to XLA outside any
Pallas kernel. The rank-per-card group (the ring over NCCL send/recv) and
Ulysses wait for a machine with several cards.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -0.5 * torch.finfo(torch.float32).max


def _gqa_scores(q5: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q5: [..., B, Sq, KVH, G, D] f32; k: [..., B, Sk, KVH, D] →
    [..., B, KVH, G, Sq, Sk]."""
    return torch.einsum("...bqhgd,...bkhd->...bhgqk", q5, k.float()) * scale


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """[..., B, Sq], [..., B, Sk] global positions → bool
    [..., B, 1, 1, Sq, Sk]; -1 pads drop."""
    qp = q_pos[..., None, None, :, None]
    kp = k_pos[..., None, None, None, :]
    return (kp >= 0) & (qp >= 0) & (kp <= qp)


def _ring_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor, *, scale: float):
    """Every rank's online-softmax partials over the full ring rotation,
    WITHOUT the final normalisation. Ranks are dim 0: q [n, B, Sq, H, D],
    k/v [n, B, Sk, KVH, D], positions [n, B, Sq] / [n, B, Sk]. Returns the
    unnormalised accumulator ``o`` [n, B, KVH, G, Sq, D] f32 plus the
    running max ``m`` and sum ``l`` [n, B, KVH, G, Sq] f32, so callers can
    merge another key source before dividing. Fully-masked rows keep
    m == _NEG and l == 0."""
    n, b, sq, h, d = q.shape
    kvh = k.shape[3]
    g = h // kvh
    q5 = q.reshape(n, b, sq, kvh, g, d).float()
    o = q.new_zeros((n, b, kvh, g, sq, d), dtype=torch.float32)
    m = torch.full((n, b, kvh, g, sq), _NEG, dtype=torch.float32, device=q.device)
    l = q.new_zeros((n, b, kvh, g, sq), dtype=torch.float32)
    for _ in range(n):
        s = _gqa_scores(q5, k, scale)                        # [n,B,KVH,G,Sq,Sk]
        s = torch.where(_causal_mask(q_pos, k_pos), s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # rows with no valid key anywhere keep m_new == _NEG; zero their
        # probabilities so the final output is 0, not mean(V)
        p = torch.where((m_new > _NEG / 2)[..., None],
                        torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "...bhgqk,...bkhd->...bhgqd", p, v.float())
        m = m_new
        # the ring step: rank r takes rank r - 1's block
        k, v, k_pos = (torch.roll(x, 1, dims=0) for x in (k, v, k_pos))
    return o, m, l


def shard_ranks(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, S, ...] → [n, B, S/n, ...]: rank r holds rows [r·S/n, (r+1)·S/n)."""
    b, s = x.shape[:2]
    if s % n:
        raise ValueError(f"sequence {s} does not divide over sp={n}")
    return x.reshape(b, n, s // n, *x.shape[2:]).transpose(0, 1)


def unshard_ranks(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``shard_ranks``: [n, B, S/n, ...] → [B, S, ...]."""
    n, b, sq = x.shape[:3]
    return x.transpose(0, 1).reshape(b, n * sq, *x.shape[3:])


def ring_attention(
    q: torch.Tensor,             # [B, Sq, H, D]
    k: torch.Tensor,             # [B, Sk, KVH, D]
    v: torch.Tensor,             # [B, Sk, KVH, D]
    q_positions: torch.Tensor,   # [B, Sq] global positions (-1 = pad)
    kv_positions: torch.Tensor,  # [B, Sk]
    sp: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal GQA attention with the sequence split over ``sp`` ranks on
    one device (Sq and Sk each divisible by ``sp``). Returns [B, Sq, H, D]
    in q's dtype; rows with no visible key are 0."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    o, _m, l = _ring_partials(
        shard_ranks(q, sp), shard_ranks(k, sp), shard_ranks(v, sp),
        shard_ranks(q_positions, sp), shard_ranks(kv_positions, sp),
        scale=scale)
    out = o / torch.clamp(l, min=1e-30)[..., None]           # [n,B,KVH,G,Sq/n,D]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(sp, b, sq // sp, h, d)
    return unshard_ranks(out).to(q.dtype)


def dense_reference(q, k, v, q_positions, kv_positions, scale=None):
    """Unsharded causal GQA attention: the correctness oracle for tests."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    q5 = q.reshape(b, sq, kvh, h // kvh, d).float()
    s = _gqa_scores(q5, k, scale)
    s = torch.where(_causal_mask(q_positions, kv_positions), s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m > _NEG / 2, torch.exp(s - m), 0.0)  # fully-masked rows → 0
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    o = o / torch.clamp(p.sum(-1), min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
