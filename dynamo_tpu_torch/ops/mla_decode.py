"""DeepSeek MLA single-token (decode) attention over the compressed latent
cache: the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``dynamo_tpu/ops/pallas_decode.py``
(``mla_paged_decode_attention``, ``_mla_decode_kernel``). Scores are
``scale * (q_lat . c + q_rope . kr)`` over the keys ``t < ctx`` of each
row, and the output is ``softmax . c`` in the latent space [B, 1, H, R]
(the caller applies W_uv). The kernel (``csrc/mla_decode.cu``) is bound by
bytes on an H100: it stages each 64-key tile of ``[c | kr]`` in shared
memory once for a group of 16 heads, runs both products on the tensor
cores and reuses the tile's ``c`` as the value; it splits each row's
context over several CTAs, which merge their partials through the
distributed shared memory of a thread-block cluster (and, past one
cluster, the last cluster of a row merges the clusters' partials) in the
same launch. See the source for the design.

The launch plan (``plan``) comes from the block table's width only, never
from ``context_lens``: reading those on the host would be a sync, and a
grid fixed by shapes can be captured in a CUDA graph. The counters that
find a row's last cluster are the split-KV core's (``splitkv.counters``);
the f32 workspace of the clusters' partials is kept here per device and
grows when a call needs more.

The kernel has a bf16 and an fp8 form: e4m3 caches (``c`` and ``kr``
both; ``kv_cache_dtype="fp8"``) launch ``mla_decode_fp8``, which reads the
e4m3 pages and upcasts them on the card (the TPU kernel's fp8
specialization, ``pallas_decode.py:278-281``).

CPU tensors take ``mla_paged_decode_attention_ref``; CUDA tensors launch
the kernel or raise. ``launches`` counts launches of the bf16 form and
``launches_fp8`` of the fp8 form (one per call that reached the card), so
a run can show the serving path went through it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build, splitkv
from .attention import gather_pages, kernel_form

launches = 0
launches_fp8 = 0

# the one latent / rope width built and checked on a card (DeepSeek-V2,
# V2-Lite and V3 all use kv_lora_rank 512, qk_rope_head_dim 64)
_RANK, _ROPE_DIM = 512, 64
TILE_KEYS = 64    # keys per shared-memory tile (csrc/mla_decode.cu TK)
HEAD_GROUP = 16   # query heads per CTA (csrc/mla_decode.cu HG)
CHUNK = 128       # keys a split covers
CLUSTER = 8       # splits a thread-block cluster merges (csrc/mla_decode.cu CL_MAX)

_workspaces: Dict[torch.device, torch.Tensor] = {}


def mla_paged_decode_attention_ref(
    q_lat: torch.Tensor,         # [B, 1, H, R] latent-absorbed queries
    q_rope: torch.Tensor,        # [B, 1, H, RD] post-RoPE decoupled queries
    c_cache: torch.Tensor,       # [L, N, bs, 1, R] stacked latent cache
    kr_cache: torch.Tensor,      # [L, N, bs, 1, RD] stacked rope-key cache
    block_tables: torch.Tensor,  # [B, W]
    context_lens: torch.Tensor,  # [B]
    layer_idx: int = 0,
    scale: float = 1.0,
) -> torch.Tensor:
    """The plain version: the gather formulation at S = 1 over layer
    ``layer_idx`` of the stacked caches. Row b's query sits at
    ``context_lens[b] - 1`` and sees the keys ``t < context_lens[b]``; a
    row with ``ctx == 0`` outputs zeros, as the kernel does."""
    b, _, h, r = q_lat.shape
    l, n, bs = c_cache.shape[:3]
    rd = kr_cache.shape[-1]
    w = block_tables.shape[1]
    bt = block_tables.long() + layer_idx * n
    c = gather_pages(c_cache.reshape(l * n, bs, r), bt).reshape(
        b, w * bs, r).to(q_lat.dtype)
    kr = gather_pages(kr_cache.reshape(l * n, bs, rd), bt).reshape(
        b, w * bs, rd).to(q_lat.dtype)
    scores = (torch.einsum("bhr,btr->bht", q_lat[:, 0], c)
              + torch.einsum("bhd,btd->bht", q_rope[:, 0], kr)) * scale
    ctx = context_lens.long().to(q_lat.device)
    mask = torch.arange(w * bs, device=q_lat.device)[None, None, :] < ctx[:, None, None]
    scores = torch.where(mask, scores, torch.tensor(
        torch.finfo(scores.dtype).min, dtype=scores.dtype, device=q_lat.device))
    probs = torch.softmax(scores.float(), dim=-1).to(q_lat.dtype)
    out = torch.einsum("bht,btr->bhr", probs, c)[:, None]
    return out * (ctx > 0).to(out.dtype)[:, None, None, None]


def _lib(form: str):
    lib = _build.load("mla_decode")
    fn = getattr(lib, f"mla_decode_{form}")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 11 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q_lat, q_rope, c_cache, kr_cache, block_tables,
                       context_lens):
    b, s, h, r = q_lat.shape
    if s != 1:
        raise ValueError(f"MLA decode kernel takes one query token, got S={s}")
    rd = q_rope.shape[-1]
    if q_rope.shape != (b, 1, h, rd):
        raise ValueError("q_rope does not match q_lat's [B, 1, H]")
    if c_cache.dim() != 5 or kr_cache.dim() != 5 \
            or c_cache.shape[:4] != kr_cache.shape[:4] or c_cache.shape[3] != 1:
        raise ValueError("expected stacked caches [L, N, bs, 1, R] and "
                         "[L, N, bs, 1, RD] over the same pages")
    if (r, rd) != (_RANK, _ROPE_DIM) or c_cache.shape[-1] != r \
            or kr_cache.shape[-1] != rd:
        raise NotImplementedError(
            f"MLA decode kernel: (R, RD) = ({r}, {rd}) is not "
            f"({_RANK}, {_ROPE_DIM})")
    form = kernel_form("MLA decode kernel", q_lat, c_cache, kr_cache)
    if q_rope.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"MLA decode kernel: q_rope must be bfloat16 (got {q_rope.dtype})")
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope), ("c_cache", c_cache),
                    ("kr_cache", kr_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"MLA decode kernel: {name} must be contiguous and "
                             "16-byte aligned")
        if t.device != q_lat.device:
            raise ValueError(f"MLA decode kernel: {name} is on {t.device}, "
                             f"q_lat on {q_lat.device}")
    if block_tables.shape[0] != b or context_lens.shape != (b,):
        raise ValueError("block_tables / context_lens do not match the batch")
    return form


def plan(table_keys: int) -> Tuple[int, int, int]:
    """(chunk, splits, cluster) for a block table of ``table_keys`` = W * bs
    keys: splits of ``CHUNK`` keys, in clusters of ``CLUSTER`` consecutive
    splits that merge through distributed shared memory (so ``splits`` is
    a multiple of it; the splits past the table exit at once). A row's
    split boundaries and merge order do not depend on the table's width,
    so the same row gives the same bits whatever width a caller pads its
    tables to."""
    splits = -(-max(table_keys, 1) // CHUNK)
    return CHUNK, -(-splits // CLUSTER) * CLUSTER, CLUSTER


def workspace(device: torch.device, batch: int, groups: int,
              clusters: int) -> torch.Tensor:
    """The device's f32 partials of the clusters, at least ``batch * groups
    * clusters * 16 * (R + 2)`` of them: kept between calls (launches on
    one device run on one stream at a time), replaced by a larger buffer
    when a call needs more. Its contents need no initialising."""
    n = batch * groups * clusters * HEAD_GROUP * (_RANK + 2)
    buf = _workspaces.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.float32, device=device)
        _workspaces[device] = buf
    return buf


def mla_paged_decode_attention(
    q_lat: torch.Tensor,         # [B, 1, H, R]
    q_rope: torch.Tensor,        # [B, 1, H, RD]
    c_cache: torch.Tensor,       # [L, N, bs, 1, R] stacked, unpadded
    kr_cache: torch.Tensor,      # [L, N, bs, 1, RD]
    block_tables: torch.Tensor,  # [B, W] int32
    context_lens: torch.Tensor,  # [B] int32
    layer_idx: int = 0,
    scale: float = 1.0,
) -> torch.Tensor:
    """MLA single-token attention over layer ``layer_idx`` of the stacked
    compressed caches; returns the latent output [B, 1, H, R]."""
    if q_lat.device.type != "cuda":
        return mla_paged_decode_attention_ref(
            q_lat, q_rope, c_cache, kr_cache, block_tables, context_lens,
            layer_idx, scale)
    global launches, launches_fp8
    form = _check_cuda_inputs(q_lat, q_rope, c_cache, kr_cache, block_tables,
                              context_lens)
    b, _, h, r = q_lat.shape
    l, n, bs = c_cache.shape[:3]
    if not 0 <= layer_idx < l:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {l})")
    bt = block_tables.to(device=q_lat.device, dtype=torch.int32).contiguous()
    ctx = context_lens.to(device=q_lat.device, dtype=torch.int32).contiguous()
    w = bt.shape[1]
    chunk, splits, cluster = plan(w * bs)
    groups = -(-h // HEAD_GROUP)
    ws = workspace(q_lat.device, b, groups, splits // cluster)
    cnt = splitkv.counters(q_lat.device, b * groups)
    out = torch.empty_like(q_lat)
    rc = _lib(form)(
        q_lat.data_ptr(), q_rope.data_ptr(), c_cache.data_ptr(),
        kr_cache.data_ptr(), bt.data_ptr(), ctx.data_ptr(), out.data_ptr(),
        ws.data_ptr(), cnt.data_ptr(), b, h, r, q_rope.shape[-1], n, bs, w,
        int(layer_idx), chunk, splits, cluster, float(scale),
        torch.cuda.current_stream(q_lat.device).cuda_stream,
    )
    _build.check(rc, f"mla_decode_{form}")
    if form == "fp8":
        launches_fp8 += 1
    else:
        launches += 1
    return out
