"""Online-softmax partials of a query shard against the committed paged
prefix: the CUDA kernel and its plain PyTorch version.

Replaces the TPU kernel ``dynamo_tpu/ops/pallas_sp.py``
(``paged_prefix_attention_partials``, ``_prefix_kernel``). The sequence-
parallel chunk (``parallel/sequence.sp_chunk_attention``) folds two key
sources into one softmax: the chunk's fresh K/V, rotated around the ring,
and the prefix already in the paged cache, read here in place with no
gather. Keys at cache positions ``< prefix_len`` count, with no causal
term (every prefix key precedes every chunk query). The outputs are NOT
normalised: ``acc = Σ exp(s − m)·v``, ``m`` the running max, ``l = Σ exp(s
− m)``; the caller merges them with the ring's partials and divides once.
An empty prefix reads nothing and returns ``m = MASK_VALUE``, ``l = 0``,
``acc = 0``. Pad query rows get real partials against the whole prefix;
the caller empties them at the merge.

On one device the ``sp`` ranks are the batch dimension: each rank's call
of the reference is one row of the kernel's grid, and every rank reads the
same block table (``block_tables.expand(sp, W)``: a stride-0 row, not a
copy). The kernel (``csrc/sp_prefix.cu``) runs the tensor-core tile loop
of ``csrc/paged_attn_tc.cuh``: a CTA is two warpgroups over 128 (query,
group head) rows, K/V tiles of 64 keys arrive through a cp.async ring,
S = Q·Kᵀ and O += P·V are bf16 ``wgmma`` products with f32 accumulators,
and P enters P·V as bf16 hi + lo, ~16 bits (the reference rounds P to
bf16 once, an error of the order of the 1e-3 to which ``acc`` is held
against the f32 plain version). It is bound by operations at the
engine's shapes; see the sources.

CPU tensors take ``paged_prefix_attention_partials_ref``; CUDA tensors
launch the kernel or raise. ``prefix_len`` and ``layer_idx`` are host
ints, passed as kernel arguments, so a launch reads nothing back from the
card. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

launches = 0

# the reference's MASK_VALUE (pallas_decode.py:39): the running max of a row
# that saw no key. Finite, so the caller's exp(m_p − max(m_r, m_p)) never
# meets -inf − -inf
MASK_VALUE = -1e30

# the head_dims the library instantiates (Llama-3.2-1B: 64; 128 for the
# 8B/70B-class models). Not 256: a CTA of two warpgroups would need
# 263,168 bytes of shared memory (``paged_flash.smem_bytes(256, 2)``)
_HEAD_DIMS = (64, 128)
_ROWS_PER_CTA = 128  # (query position, group head) rows per CTA in the kernel


def paged_prefix_attention_partials_ref(
    q: torch.Tensor,             # [B, S, H, D] query shard (post-RoPE)
    k_cache: torch.Tensor,       # [L, N, bs, KVH, D] stacked
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, W]
    prefix_len: int,             # keys at cache positions < prefix_len live
    layer_idx: Optional[int] = None,
    scale: Optional[float] = None,
):
    """The plain version: gather the prefix pages, then masked f32 scores,
    their max, exp, sum and P·V. Returns ``(acc [B, S, KVH, G, D], m, l
    [B, S, KVH, G])``, all f32."""
    b, s, h, d = q.shape
    bs, kvh = k_cache.shape[2], k_cache.shape[3]
    g = h // kvh
    if scale is None:
        scale = d ** -0.5
    pfx = int(prefix_len)
    li = 0 if layer_idx is None else int(layer_idx)
    acc = torch.zeros((b, s, kvh, g, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, s, kvh, g), MASK_VALUE, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, s, kvh, g), dtype=torch.float32, device=q.device)
    npages = -(-pfx // bs)
    if npages == 0:
        return acc, m, l
    bt = block_tables[:, :npages].long()
    k = k_cache[li][bt].reshape(b, npages * bs, kvh, d).float()
    v = v_cache[li][bt].reshape(b, npages * bs, kvh, d).float()
    qs = q.reshape(b, s, kvh, g, d).float()
    sc = torch.einsum("bskgd,btkd->bskgt", qs, k) * scale
    live = torch.arange(npages * bs, device=q.device) < pfx
    sc = torch.where(live, sc, -torch.inf)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    return torch.einsum("bskgt,btkd->bskgd", p, v), m, p.sum(dim=-1)


def _lib():
    lib = _build.load("sp_prefix")
    fn = lib.sp_prefix_partials_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(q, k_cache, v_cache, block_tables, prefix_len,
                       layer_idx):
    b, s, h, d = q.shape
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError("expected stacked caches [L, N, bs, KVH, D] of one shape")
    l, n, bs, kvh, _ = k_cache.shape
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"sp prefix kernel: {name} must be bfloat16 (got {t.dtype}); "
                "its fp8 form (e4m3 caches, pallas_sp.py:127-129) is not "
                "ported yet")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"sp prefix kernel: {name} must be contiguous and 16-byte aligned")
        if t.device != q.device:
            raise ValueError(
                f"sp prefix kernel: {name} is on {t.device}, q on {q.device}")
    if k_cache.shape[-1] != d or d not in _HEAD_DIMS:
        raise NotImplementedError(
            f"sp prefix kernel: head_dim {d} is not one of {_HEAD_DIMS}")
    if h % kvh or h // kvh > _ROWS_PER_CTA:
        raise NotImplementedError(
            f"sp prefix kernel: {h} heads over {kvh} KV heads (a group of at "
            f"most {_ROWS_PER_CTA}, the rows of a CTA)")
    if (block_tables.dim() != 2 or block_tables.shape[0] != b
            or block_tables.dtype != torch.int32
            or block_tables.device != q.device
            or block_tables.stride(1) != 1):
        raise ValueError(
            "block_tables must be [B, W] int32 on q's device with unit column "
            "stride (a row broadcast over the ranks is fine)")
    if isinstance(prefix_len, torch.Tensor) or isinstance(layer_idx, torch.Tensor):
        raise TypeError("prefix_len and layer_idx are host ints on a card "
                        "(reading a device scalar would sync the host)")
    if not 0 <= prefix_len <= block_tables.shape[1] * bs:
        raise ValueError(f"prefix_len {prefix_len} outside the block table's "
                         f"{block_tables.shape[1] * bs} positions")
    if not 0 <= layer_idx < l:
        raise ValueError(f"layer_idx {layer_idx} outside [0, {l})")


def paged_prefix_attention_partials(
    q: torch.Tensor,             # [B, S, H, D] query shard (post-RoPE)
    k_cache: torch.Tensor,       # [L, N, bs, KVH, D] stacked
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, W] int32
    prefix_len: int,             # keys at cache positions < prefix_len live
    layer_idx: Optional[int] = None,
    scale: Optional[float] = None,
):
    """Online-softmax partials of ``q`` against the committed paged prefix
    of layer ``layer_idx``. Returns ``(acc [B, S, KVH, G, D], m, l
    [B, S, KVH, G])``, all f32 and unnormalised: merge with another key
    source's partials, then divide by the combined ``l``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type != "cuda":
        return paged_prefix_attention_partials_ref(
            q, k_cache, v_cache, block_tables, prefix_len, layer_idx, scale)
    global launches
    layer_idx = 0 if layer_idx is None else layer_idx
    _check_cuda_inputs(q, k_cache, v_cache, block_tables, prefix_len, layer_idx)
    b, s, h, d = q.shape
    l, n, bs, kvh, _ = k_cache.shape
    g = h // kvh
    acc = torch.empty((b, s, kvh, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, s, kvh, g), dtype=torch.float32, device=q.device)
    lsum = torch.empty((b, s, kvh, g), dtype=torch.float32, device=q.device)
    rc = _lib()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), acc.data_ptr(), m.data_ptr(), lsum.data_ptr(),
        b, s, h, kvh, d, n, bs, block_tables.shape[1],
        block_tables.stride(0), int(prefix_len), int(layer_idx), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "sp_prefix_partials_bf16")
    launches += 1
    return acc, m, lsum
