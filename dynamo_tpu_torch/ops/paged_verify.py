"""Speculative-verify attention (1 < S <= 32 queries per row over one page
walk): the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``dynamo_tpu/ops/pallas_decode.py``
(``paged_verify_attention``, ``_verify_kernel``). Query positions are
affine, as for the flash kernel: token s of row b sits at
``base_pos[b] + s``; rows past ``context_lens`` give values the caller
discards. The kernel (``csrc/paged_verify.cu``) is bound by bytes on an
H100: one CTA per (KV head, batch row) stages each K/V tile once for all
S * G query rows of the group; see the source for the design.

CPU tensors take ``paged_verify_attention_ref``; CUDA tensors launch the
kernel or raise. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import NO_WINDOW, paged_attention

launches = 0

# largest query tail the verify kernel serves; longer chunks take the flash
# kernel (the reference's VERIFY_MAX_S; spec rounds are K + 1 <= 17)
VERIFY_MAX_S = 32
# the one head_dim built and checked on a card (Llama-3.2-1B)
_HEAD_DIM = 64
_ROWS_PER_CTA = 128  # S * G query rows the kernel holds per CTA


def paged_verify_attention_ref(
    q: torch.Tensor,             # [B, S, H, D]
    k_cache: torch.Tensor,       # [L, N, bs, KVH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, W]
    base_pos: torch.Tensor,      # [B] absolute position of q[:, 0]
    context_lens: torch.Tensor,  # [B]
    layer_idx: int = 0,
    scale: Optional[float] = None,
    window: int = NO_WINDOW,
) -> torch.Tensor:
    """The plain version: query s of row b at ``base_pos[b] + s`` sees key
    j iff j <= base + s, j < ctx and j > base + s - window."""
    l, n_blocks = k_cache.shape[:2]
    s = q.shape[1]
    positions = base_pos.long()[:, None] + torch.arange(s, device=q.device)[None, :]
    return paged_attention(
        q,
        k_cache.reshape((l * n_blocks,) + k_cache.shape[2:]),
        v_cache.reshape((l * n_blocks,) + v_cache.shape[2:]),
        block_tables.long() + layer_idx * n_blocks,
        positions, context_lens, scale=scale,
        sliding_window=None if window >= NO_WINDOW else window,
    )


def _lib():
    lib = _build.load("paged_verify")
    fn = lib.paged_verify_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q, k_cache, v_cache, block_tables, base_pos,
                       context_lens):
    b, s, h, d = q.shape
    if not 1 < s <= VERIFY_MAX_S:
        raise ValueError(f"verify kernel serves 1 < S <= {VERIFY_MAX_S}, got S={s}")
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError("expected stacked caches [L, N, bs, KVH, D] of one shape")
    kvh = k_cache.shape[3]
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"verify kernel: {name} must be bfloat16 (got {t.dtype}); "
                "fp8 caches are not ported yet")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"verify kernel: {name} must be contiguous and 16-byte aligned")
        if t.device != q.device:
            raise ValueError(f"verify kernel: {name} is on {t.device}, q on {q.device}")
    if k_cache.shape[-1] != d or d != _HEAD_DIM:
        raise NotImplementedError(f"verify kernel: head_dim {d} is not {_HEAD_DIM}")
    if h % kvh or s * (h // kvh) > _ROWS_PER_CTA:
        raise NotImplementedError(
            f"verify kernel: S={s} times group size {h}/{kvh} exceeds "
            f"{_ROWS_PER_CTA} rows per CTA")
    if (block_tables.shape[0] != b or base_pos.shape != (b,)
            or context_lens.shape != (b,)):
        raise ValueError("block_tables / base_pos / context_lens do not match the batch")


def paged_verify_attention(
    q: torch.Tensor,             # [B, S, H, D] (post-RoPE), 1 < S <= 32
    k_cache: torch.Tensor,       # [L, N, bs, KVH, D] stacked
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, W] int32
    base_pos: torch.Tensor,      # [B] int32 — absolute position of q[:, 0]
    context_lens: torch.Tensor,  # [B] int32
    layer_idx: int = 0,
    scale: Optional[float] = None,
    window: int = NO_WINDOW,     # sliding window; NO_WINDOW = off
) -> torch.Tensor:
    """Causal attention of an S-token verify tail over layer ``layer_idx``
    of the stacked cache; returns [B, S, H, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type != "cuda":
        return paged_verify_attention_ref(
            q, k_cache, v_cache, block_tables, base_pos, context_lens,
            layer_idx, scale, window)
    global launches
    _check_cuda_inputs(q, k_cache, v_cache, block_tables, base_pos,
                       context_lens)
    b, s, h, d = q.shape
    l, n, bs, kvh, _ = k_cache.shape
    if not 0 <= layer_idx < l:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {l})")
    bt = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    base = base_pos.to(device=q.device, dtype=torch.int32).contiguous()
    ctx = context_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    rc = _lib()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), bt.data_ptr(),
        base.data_ptr(), ctx.data_ptr(), out.data_ptr(), b, s, h, kvh, d, n,
        bs, bt.shape[1], int(layer_idx), int(min(window, NO_WINDOW)),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "paged_verify_bf16")
    launches += 1
    return out
