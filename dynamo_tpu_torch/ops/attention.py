"""Attention over the paged KV cache: the plain PyTorch route and the
dispatch to the hand-written CUDA kernels.

The port of ``dynamo_tpu/ops/attention.py``. New K/V are scattered into
the stacked cache first, then queries attend over the cache pages — the
same contract serves bucketed prefill (S > 1) and single-token decode
(S == 1). The cache is ``[L, N, bs, KVH, head_dim]`` with no lane padding
(the reference pads head_dim to 128 lanes for the TPU's DMA alignment; a
GPU has no such constraint).

Dispatch is keyed on the tensors' device: CPU tensors take the plain
version (``paged_attention``); CUDA tensors take the decode kernel when
S == 1, the verify kernel when 1 < S <= 32 (the speculative verify tail,
the reference's ``VERIFY_MAX_S``) and the flash kernel when S > 32. There
is no fallback from a kernel to the plain route on a CUDA device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# "no window": a sentinel wider than any context (the reference's 2**30)
NO_WINDOW = 1 << 30


def check_attention_impl(impl: str, device) -> None:
    """Validate ``ModelConfig.attention_impl`` for ``device``. The port
    keys the route on the tensors' device (``attention``); the config
    value only refuses the plain route on a card, where it never runs on
    the serving path."""
    if impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}; use auto|xla|pallas")
    if torch.device(device).type == "cuda" and impl == "xla":
        raise ValueError(
            "attention_impl='xla' (the plain route) is not served on a "
            "CUDA device; the port launches its attention kernels there"
        )


def kv_write_plan(slot_mapping: torch.Tensor, per_layer: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, slots): the flat token rows of ``new_k``/``new_v`` that are
    written, and their slot within one layer. Computed once per forward
    and shared by every layer's scatter.

    The reference drops the ``-1`` sentinel and every slot past the layer
    by mapping them past the end under ``mode="drop"``; torch has no drop
    mode and a negative index wraps, so both are filtered out here."""
    idx = slot_mapping.reshape(-1).long()
    keep = (idx >= 0) & (idx < per_layer)
    rows = torch.nonzero(keep).reshape(-1)
    return rows, idx[rows]


def scatter_kv_rows(k_all, v_all, new_k, new_v, rows, slots, layer_idx: int):
    """Write ``new_k/new_v`` rows ``rows`` into layer ``layer_idx`` of the
    stacked cache at ``slots``, in place (``index_copy_``: no per-layer
    slice of the cache is copied)."""
    l, n, bs, kvh, dk = k_all.shape
    vh, dv = v_all.shape[-2:]
    per_layer = n * bs
    flat_k = k_all.view(l * per_layer, kvh, dk)
    flat_v = v_all.view(l * per_layer, vh, dv)
    dst = slots + layer_idx * per_layer
    flat_k.index_copy_(0, dst, new_k.reshape(-1, kvh, dk)[rows].to(k_all.dtype))
    flat_v.index_copy_(0, dst, new_v.reshape(-1, vh, dv)[rows].to(v_all.dtype))
    return k_all, v_all


def scatter_kv_stacked(
    k_all: torch.Tensor,   # [L, N_blocks, block_size, KVH, Dk] (stacked layers)
    v_all: torch.Tensor,   # [L, N_blocks, block_size, VH, Dv]
    new_k: torch.Tensor,   # [B, S, KVH, Dk]
    new_v: torch.Tensor,   # [B, S, VH, Dv]
    slot_mapping: torch.Tensor,  # [B, S] flat slot (block*bs + off); -1 → drop
    layer_idx: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write new K/V into one layer of the stacked cache, in place. The
    ``-1`` sentinel and slots past the layer are dropped."""
    rows, slots = kv_write_plan(slot_mapping, k_all.shape[1] * k_all.shape[2])
    return scatter_kv_rows(k_all, v_all, new_k, new_v, rows, slots, layer_idx)


def paged_attention(
    q: torch.Tensor,             # [B, S, H, D] (post-RoPE)
    k_cache: torch.Tensor,       # [N_blocks, block_size, KVH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, W] block ids for each sequence
    q_positions: torch.Tensor,   # [B, S] absolute position of each query token
    context_lens: torch.Tensor,  # [B] total valid tokens (incl. current) per seq
    scale: Optional[float] = None,
    softcap: float = 0.0,        # logits ← cap·tanh(logits/cap)
    sliding_window=None,         # keys within the window; None = off
    sinks=None,                  # [H] per-head attention-sink logits
) -> torch.Tensor:
    """Plain paged attention: gather → masked softmax → weighted sum.

    Query at absolute position p attends cache positions j with j <= p and
    j < context_len — and, with ``sliding_window`` w, j > p - w. ``sinks``
    join the softmax as a virtual key that contributes no value (the extra
    exp(sink) term in the denominator)."""
    b, s, h, d = q.shape
    _, block_size, kvh, _ = k_cache.shape
    w = block_tables.shape[1]
    groups = h // kvh
    if scale is None:
        scale = d ** -0.5
    bt = block_tables.long()
    # gather: [B, W, bs, KVH, D] → [B, W*bs, KVH, D], upcast to q's dtype
    k = k_cache[bt].reshape(b, w * block_size, kvh, d).to(q.dtype)
    v = v_cache[bt].reshape(b, w * block_size, kvh, d).to(q.dtype)

    qg = q.reshape(b, s, kvh, groups, d)
    logits = torch.einsum("bskgd,btkd->bskgt", qg * scale, k)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)

    key_pos = torch.arange(w * block_size, device=q.device)[None, None, :]
    qp = q_positions.long()[:, :, None]
    mask = (key_pos <= qp) & (key_pos < context_lens.long()[:, None, None])
    if sliding_window is not None:
        mask = mask & (key_pos > qp - int(sliding_window))
    mask = mask[:, :, None, None, :]                         # [B, S, 1, 1, T]
    logits = torch.where(
        mask, logits, torch.tensor(torch.finfo(logits.dtype).min,
                                   dtype=logits.dtype, device=q.device))
    if sinks is not None:
        sink_col = torch.as_tensor(sinks, dtype=logits.dtype,
                                   device=q.device).reshape(1, 1, kvh, groups, 1)
        logits = torch.cat([logits, sink_col.expand(b, s, kvh, groups, 1)], -1)
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)[..., :-1]
    else:
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bskgt,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def attention(
    q: torch.Tensor,             # [B, S, H, D]
    k_cache: torch.Tensor,       # stacked [L, N, bs, KVH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, W]
    positions: torch.Tensor,     # [B, S] absolute query positions
    context_lens: torch.Tensor,  # [B]
    layer_idx: int = 0,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    sliding_window=None,         # int; None = off
    sinks=None,
) -> torch.Tensor:
    """Paged-attention dispatch on the stacked cache.

    CPU tensors take the plain route. CUDA tensors take the decode kernel
    (S == 1), the verify kernel (1 < S <= 32) or the flash kernel
    (S > 32); each indexes layer ``layer_idx`` of the stacked cache in
    place. The verify and flash kernels assume affine query positions
    (``positions[:, s] == positions[:, 0] + s``), the scheduler's layout.
    The decode kernel assumes the query sits at ``context_lens - 1``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type != "cuda":
        # index the layer through the gather: block n of layer li is flat
        # row li*N + n, so no per-layer slice of the cache is copied
        l, n_blocks = k_cache.shape[:2]
        kf = k_cache.reshape((l * n_blocks,) + k_cache.shape[2:])
        vf = v_cache.reshape((l * n_blocks,) + v_cache.shape[2:])
        return paged_attention(
            q, kf, vf, block_tables.long() + layer_idx * n_blocks, positions,
            context_lens, scale=scale, softcap=softcap,
            sliding_window=sliding_window, sinks=sinks)
    if softcap or sinks is not None:
        raise NotImplementedError(
            "softcap and sinks variants of the attention kernels are not "
            "ported yet")
    window = NO_WINDOW if sliding_window is None else int(sliding_window)
    if q.shape[1] == 1:
        from .paged_decode import paged_decode_attention

        return paged_decode_attention(
            q, k_cache, v_cache, block_tables, context_lens,
            layer_idx=layer_idx, scale=scale, window=window)
    from .paged_verify import VERIFY_MAX_S, paged_verify_attention

    if q.shape[1] <= VERIFY_MAX_S:
        return paged_verify_attention(
            q, k_cache, v_cache, block_tables, positions[:, 0], context_lens,
            layer_idx=layer_idx, scale=scale, window=window)
    from .paged_flash import paged_flash_attention

    return paged_flash_attention(
        q, k_cache, v_cache, block_tables, positions[:, 0], context_lens,
        layer_idx=layer_idx, scale=scale, window=window)
