"""Flash attention of a query chunk over the paged KV cache: the CUDA
kernel and its plain PyTorch version.

Replaces the TPU kernel ``dynamo_tpu/ops/pallas_attention.py``
(``paged_flash_attention``, ``_kernel``). Query positions are affine: token
s of row b sits at ``base_pos[b] + s``; pad rows past the true suffix give
values the caller discards (a query tile that starts past ctx is written
as zeros without reading a key). The kernel (``csrc/paged_flash.cu``, on
the tensor-core tile loop of ``csrc/paged_attn_tc.cuh``) is bound by
operations for a long chunk: each K/V tile staged in shared memory is
reused by every query row of the CTA; see the sources for the design.

The kernel has a bf16 and an fp8 form: e4m3 caches launch
``paged_flash_fp8``, which reads the e4m3 pages and upcasts them on the
card (the TPU kernel's fp8 specialization, ``pallas_attention.py:100-102``).

CPU tensors take ``paged_flash_attention_ref``; CUDA tensors launch the
kernel or raise. ``launches`` counts launches of the bf16 form,
``launches_fp8`` of the fp8 form.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import (
    NO_WINDOW,
    kernel_form,
    kernel_sinks,
    kernel_softcap,
    paged_attention,
)

launches = 0
launches_fp8 = 0

# the head_dims the library instantiates (Llama-3.2-1B: 64; 128 for the
# 8B/70B-class models; Gemma-2-9b 256)
_HEAD_DIMS = (64, 128, 256)
_ROWS_PER_CTA = 64  # query rows (position, group head) per CTA in the kernel


def smem_bytes(head_dim: int, warpgroups: int = 1) -> int:
    """Dynamic shared memory of a CTA of the tensor-core core's bf16 form
    (``paged_attn_tc.cuh`` ``smem_bytes<D, kWG>``): Q's 64 rows a warpgroup
    and three 64-key K and V stages in bf16, plus 1 KB to align. Flash runs
    one warpgroup (230,400 bytes at head_dim 256, within the card's
    232,448), the prefix partials two (``sp_prefix``: 263,168 at 256). The
    fp8 form holds one bf16 K and V tile beside three e4m3 stages, less."""
    return (64 * warpgroups + 6 * 64) * head_dim * 2 + 1024


def paged_flash_attention_ref(
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
    """The plain version under the kernel's affine-position contract, with
    ``sinks`` [H] in each head's softmax denominator and the scaled scores
    capped at ``softcap`` (0 = off)."""
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
    lib = _build.load("paged_flash")
    fn = getattr(lib, f"paged_flash_{form}")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       i, ctypes.c_float, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q, k_cache, v_cache, block_tables, base_pos,
                       context_lens):
    b, s, h, d = q.shape
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError("expected stacked caches [L, N, bs, KVH, D] of one shape")
    kvh = k_cache.shape[3]
    form = kernel_form("flash kernel", q, k_cache, v_cache)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} must be contiguous and 16-byte aligned")
        if t.device != q.device:
            raise ValueError(f"flash kernel: {name} is on {t.device}, q on {q.device}")
    if k_cache.shape[-1] != d or d not in _HEAD_DIMS:
        raise NotImplementedError(
            f"flash kernel: head_dim {d} is not one of {_HEAD_DIMS}")
    if h % kvh or h // kvh > _ROWS_PER_CTA:
        raise NotImplementedError(
            f"flash kernel: {h} heads over {kvh} KV heads (a group of at "
            f"most {_ROWS_PER_CTA}, the rows of a CTA)")
    if (block_tables.shape[0] != b or base_pos.shape != (b,)
            or context_lens.shape != (b,)):
        raise ValueError("block_tables / base_pos / context_lens do not match the batch")
    return form


def paged_flash_attention(
    q: torch.Tensor,             # [B, S, H, D] (post-RoPE)
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
    """Causal attention of an S-token chunk over layer ``layer_idx`` of the
    stacked cache; returns [B, S, H, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type != "cuda":
        return paged_flash_attention_ref(
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
    rc = _lib(form)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), bt.data_ptr(),
        base.data_ptr(), ctx.data_ptr(), None if sk is None else sk.data_ptr(),
        out.data_ptr(), b, s, h, kvh, d, n,
        bs, bt.shape[1], int(layer_idx), int(min(window, NO_WINDOW)),
        float(scale), cap, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, f"paged_flash_{form}")
    if form == "fp8":
        launches_fp8 += 1
    else:
        launches += 1
    return out
