"""Speculative-verify attention (1 < S <= 32 queries per row over one page
walk): the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``dynamo_tpu/ops/pallas_decode.py``
(``paged_verify_attention``, ``_verify_kernel``). Query positions are
affine, as for the flash kernel: token s of row b sits at
``base_pos[b] + s``; rows past ``context_lens`` give values the caller
discards. The kernel (``csrc/paged_verify.cu`` on the split-KV core
``csrc/paged_splitkv.cuh``) is bound by bytes on an H100: the CTAs that
split a row's keys stage each K/V tile once for all S * G query rows of
the group (a tail of more than 128 rows, S 17 at G 8, is cut into query
parts of their own CTAs); see the source for the design and ``splitkv.py``
for the launch plan.

The kernel has a bf16 and an fp8 form: e4m3 caches launch
``paged_verify_fp8``, which reads the e4m3 pages and upcasts them on the
card (the TPU kernel's fp8 specialization, ``pallas_decode.py:492-493``).

CPU tensors take ``paged_verify_attention_ref``; CUDA tensors launch the
kernel or raise. ``launches`` counts launches of the bf16 form,
``launches_fp8`` of the fp8 form.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, splitkv
from .attention import (
    NO_WINDOW,
    kernel_form,
    kernel_sinks,
    kernel_softcap,
    paged_attention,
)

launches = 0
launches_fp8 = 0

# largest query tail the verify kernel serves; longer chunks take the flash
# kernel (the reference's VERIFY_MAX_S; spec rounds are K + 1 <= 17)
VERIFY_MAX_S = 32
# the head_dims the kernel instantiates (Llama-3.2-1B has 64; Phi-3-mini
# 96; Llama-3-8B, Qwen and Mistral 128; Gemma-2-9b 256)
_HEAD_DIMS = (64, 96, 128, 256)


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
    sinks: Optional[torch.Tensor] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """The plain version: query s of row b at ``base_pos[b] + s`` sees key
    j iff j <= base + s, j < ctx and j > base + s - window; ``sinks`` [H]
    join each head's softmax denominator; the scaled scores are capped at
    ``softcap`` (0 = off)."""
    l, n_blocks = k_cache.shape[:2]
    s = q.shape[1]
    positions = base_pos.long()[:, None] + torch.arange(s, device=q.device)[None, :]
    return paged_attention(
        q,
        k_cache.reshape((l * n_blocks,) + k_cache.shape[2:]),
        v_cache.reshape((l * n_blocks,) + v_cache.shape[2:]),
        block_tables.long() + layer_idx * n_blocks,
        positions, context_lens, scale=scale,
        sliding_window=None if window >= NO_WINDOW else window, sinks=sinks,
        softcap=softcap,
    )


def _lib(form: str):
    lib = _build.load("paged_verify")
    fn = getattr(lib, f"paged_verify_{form}")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       i, i, i, i, i, i, ctypes.c_float, ctypes.c_float, p]
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
    form = kernel_form("verify kernel", q, k_cache, v_cache)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"verify kernel: {name} must be contiguous and 16-byte aligned")
        if t.device != q.device:
            raise ValueError(f"verify kernel: {name} is on {t.device}, q on {q.device}")
    if k_cache.shape[-1] != d or d not in _HEAD_DIMS:
        raise NotImplementedError(
            f"verify kernel: head_dim {d} is not one of {_HEAD_DIMS}")
    if h % kvh or h // kvh > splitkv.max_rows(d):
        raise NotImplementedError(
            f"verify kernel: {h} heads over {kvh} KV heads (a group of at "
            f"most {splitkv.max_rows(d)} at head_dim {d})")
    if (block_tables.shape[0] != b or base_pos.shape != (b,)
            or context_lens.shape != (b,)):
        raise ValueError("block_tables / base_pos / context_lens do not match the batch")
    return form


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
    sinks: Optional[torch.Tensor] = None,  # [H] sink logits; None = off
    softcap: float = 0.0,        # scores <- cap * tanh(scores / cap); 0 = off
) -> torch.Tensor:
    """Causal attention of an S-token verify tail over layer ``layer_idx``
    of the stacked cache; returns [B, S, H, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type != "cuda":
        return paged_verify_attention_ref(
            q, k_cache, v_cache, block_tables, base_pos, context_lens,
            layer_idx, scale, window, sinks, softcap)
    global launches, launches_fp8
    form = _check_cuda_inputs(q, k_cache, v_cache, block_tables, base_pos,
                              context_lens)
    b, s, h, d = q.shape
    l, n, bs, kvh, _ = k_cache.shape
    if not 0 <= layer_idx < l:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {l})")
    bt = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    base = base_pos.to(device=q.device, dtype=torch.int32).contiguous()
    ctx = context_lens.to(device=q.device, dtype=torch.int32).contiguous()
    sk = kernel_sinks(sinks, h, q.device)
    cap = kernel_softcap(softcap)
    out = torch.empty_like(q)
    chunk, splits = splitkv.plan(bt.shape[1] * bs)
    sq, parts = splitkv.query_parts(s, h // kvh, splitkv.max_rows(d))
    splitkv.check_fits("verify kernel", d, sq * (h // kvh), chunk, bs,
                       k_cache.element_size())
    ws = splitkv.workspace(q.device, b, parts * kvh, splits, sq * (h // kvh), d)
    cnt = splitkv.counters(q.device, b * parts * kvh)
    rc = _lib(form)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), bt.data_ptr(),
        base.data_ptr(), ctx.data_ptr(), None if sk is None else sk.data_ptr(),
        out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), b, s, sq, h, kvh, d, n,
        bs, bt.shape[1], int(layer_idx),
        int(min(window, NO_WINDOW)), chunk, splits, float(scale), cap,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, f"paged_verify_{form}")
    if form == "fp8":
        launches_fp8 += 1
    else:
        launches += 1
    return out
