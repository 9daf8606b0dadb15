"""Single-token (decode) paged attention: the CUDA kernel and its plain
PyTorch version.

Replaces the TPU kernel ``dynamo_tpu/ops/pallas_decode.py``
(``paged_decode_attention``, ``_decode_kernel``). The kernel
(``csrc/paged_decode.cu`` on the split-KV core ``csrc/paged_splitkv.cuh``)
is bound by bytes on an H100: each live K/V element of a (row, KV head) is
read once, by one of the CTAs that split the row's context, and reused
from shared memory by every query head of the group; see the source for
the design and ``splitkv.py`` for the launch plan.

The kernel has a bf16 and an fp8 form: e4m3 caches (``kv_cache_dtype=
"fp8"``) launch ``paged_decode_fp8``, which reads the e4m3 pages and
upcasts them on the card (the TPU kernel's fp8 specialization,
``pallas_decode.py:165-168``); bf16 caches launch ``paged_decode_bf16``.

CPU tensors take ``paged_decode_attention_ref``; CUDA tensors launch the
kernel or raise. ``launches`` counts launches of the bf16 form and
``launches_fp8`` of the fp8 form (one per call that reached the card), so
a run can show the serving path went through it.
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

# the head_dims the kernel instantiates (Llama-3.2-1B has 64; Phi-3-mini
# 96; Llama-3-8B, Qwen and Mistral 128; Gemma-2-9b 256)
_HEAD_DIMS = (64, 96, 128, 256)


def paged_decode_attention_ref(
    q: torch.Tensor,             # [B, 1, H, D]
    k_cache: torch.Tensor,       # [L, N, bs, KVH, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, W]
    context_lens: torch.Tensor,  # [B]
    layer_idx: int = 0,
    scale: Optional[float] = None,
    window: int = NO_WINDOW,
    sinks: Optional[torch.Tensor] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """The plain version: the query of row b sits at ``context_lens[b] - 1``
    and sees keys in ``[max(ctx - window, 0), ctx)``, with ``sinks`` [H] in
    each head's softmax denominator and the scaled scores capped at
    ``softcap`` (0 = off); a row with ``ctx == 0`` outputs zeros, as the
    kernel does."""
    l, n_blocks = k_cache.shape[:2]
    ctx = context_lens.long()
    out = paged_attention(
        q,
        k_cache.reshape((l * n_blocks,) + k_cache.shape[2:]),
        v_cache.reshape((l * n_blocks,) + v_cache.shape[2:]),
        block_tables.long() + layer_idx * n_blocks,
        (ctx - 1)[:, None], ctx, scale=scale,
        sliding_window=None if window >= NO_WINDOW else window, sinks=sinks,
        softcap=softcap,
    )
    return out * (ctx > 0).to(out.dtype)[:, None, None, None]


def _lib(form: str):
    lib = _build.load("paged_decode")
    fn = getattr(lib, f"paged_decode_{form}")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       i, i, i, ctypes.c_float, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q, k_cache, v_cache, block_tables, context_lens):
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(f"decode kernel takes one query token, got S={s}")
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError("expected stacked caches [L, N, bs, KVH, D] of one shape")
    kvh = k_cache.shape[3]
    form = kernel_form("decode kernel", q, k_cache, v_cache)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode kernel: {name} must be contiguous and 16-byte aligned")
        if t.device != q.device:
            raise ValueError(f"decode kernel: {name} is on {t.device}, q on {q.device}")
    if k_cache.shape[-1] != d or d not in _HEAD_DIMS:
        raise NotImplementedError(
            f"decode kernel: head_dim {d} is not one of {_HEAD_DIMS}")
    if h % kvh or h // kvh > splitkv.max_rows(d):
        raise NotImplementedError(
            f"decode kernel: {h} heads over {kvh} KV heads (a group of at "
            f"most {splitkv.max_rows(d)} at head_dim {d})")
    if block_tables.shape[0] != b or context_lens.shape != (b,):
        raise ValueError("block_tables / context_lens do not match the batch")
    return form


def paged_decode_attention(
    q: torch.Tensor,             # [B, 1, H, D] (post-RoPE)
    k_cache: torch.Tensor,       # [L, N, bs, KVH, D] stacked
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, W] int32
    context_lens: torch.Tensor,  # [B] int32
    layer_idx: int = 0,
    scale: Optional[float] = None,
    window: int = NO_WINDOW,     # sliding window; NO_WINDOW = off
    sinks: Optional[torch.Tensor] = None,  # [H] sink logits; None = off
    softcap: float = 0.0,        # scores <- cap * tanh(scores / cap); 0 = off
) -> torch.Tensor:
    """Single-token paged attention over layer ``layer_idx`` of the stacked
    cache; returns [B, 1, H, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type != "cuda":
        return paged_decode_attention_ref(
            q, k_cache, v_cache, block_tables, context_lens, layer_idx,
            scale, window, sinks, softcap)
    global launches, launches_fp8
    form = _check_cuda_inputs(q, k_cache, v_cache, block_tables, context_lens)
    b, _, h, d = q.shape
    l, n, bs, kvh, _ = k_cache.shape
    if not 0 <= layer_idx < l:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {l})")
    bt = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    ctx = context_lens.to(device=q.device, dtype=torch.int32).contiguous()
    sk = kernel_sinks(sinks, h, q.device)
    cap = kernel_softcap(softcap)
    out = torch.empty_like(q)
    chunk, splits = splitkv.plan(bt.shape[1] * bs)
    splitkv.check_fits("decode kernel", d, h // kvh, chunk, bs,
                       k_cache.element_size())
    ws = splitkv.workspace(q.device, b, kvh, splits, h // kvh, d)
    cnt = splitkv.counters(q.device, b * kvh)
    rc = _lib(form)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), bt.data_ptr(),
        ctx.data_ptr(), None if sk is None else sk.data_ptr(), out.data_ptr(),
        ws.data_ptr(), cnt.data_ptr(), b, h, kvh, d, n, bs, bt.shape[1],
        int(layer_idx),
        int(min(window, NO_WINDOW)), chunk, splits, float(scale), cap,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, f"paged_decode_{form}")
    if form == "fp8":
        launches_fp8 += 1
    else:
        launches += 1
    return out
