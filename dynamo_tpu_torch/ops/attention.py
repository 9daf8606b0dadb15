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
the reference's ``VERIFY_MAX_S``) and the flash kernel when S > 32, each
with or without GPT-OSS's attention sinks and Gemma-2's logit softcap.
There is no fallback from a kernel to the plain route on a CUDA device.

A cache holds the activation dtype or, with ``kv_cache_dtype="fp8"``,
``torch.float8_e4m3fn`` with no scale, as in the reference: every write
casts into it (``to_cache_dtype``) and every read upcasts. The kernels
then launch their fp8 forms (``kernel_form``), which read the e4m3 pages
and upcast them on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# "no window": a sentinel wider than any context (the reference's 2**30)
NO_WINDOW = 1 << 30

# the fp8 KV cache's storage type and its largest finite value
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def to_cache_dtype(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` cast to a cache's storage ``dtype``. Into e4m3 the values are
    clamped to +-448 first: every |x| <= 464 gives the reference's byte
    (``astype(float8_e4m3fn)``), and a larger one saturates to +-448 where
    the reference stores NaN, which would poison every later token of the
    row and of every request sharing the block through the prefix cache. The
    clamp makes that the rule on every device and torch version, whatever
    their own cast does out of range."""
    if dtype == FP8:
        return x.clamp(-FP8_MAX, FP8_MAX).to(dtype)
    return x.to(dtype)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """An e4m3 tensor as its uint8 view (the writes and gathers run on the
    bytes: torch has no fp8 ``index_copy_`` on the CPU); others as they are."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def gather_pages(cache: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``cache[idx]``, through the bytes for an e4m3 cache."""
    return _bytes(cache)[idx].view(cache.dtype)


def kernel_form(kernel: str, q: torch.Tensor, *caches: torch.Tensor) -> str:
    """The form of ``kernel`` that reads ``caches``: "bf16" for bfloat16
    caches, "fp8" for e4m3 ones (all of one type); ``q`` must be bfloat16.
    Anything else raises by name."""
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{kernel}: the queries must be bfloat16 (got {q.dtype})")
    dtypes = {c.dtype for c in caches}
    if dtypes == {torch.bfloat16}:
        return "bf16"
    if dtypes == {FP8}:
        return "fp8"
    raise NotImplementedError(
        f"{kernel}: the caches must be all bfloat16 or all float8_e4m3fn "
        f"(got {sorted(map(str, dtypes))})")


def kernel_sinks(sinks, heads: int, device):
    """The sink logits as the kernels take them: f32 [H] contiguous on
    ``device``, head order ``kvh * G + g`` (the reference's order,
    ``pallas_decode.py:737-739``); None stays None."""
    if sinks is None:
        return None
    if sinks.numel() != heads:
        raise ValueError(f"sinks hold {sinks.numel()} logits for {heads} heads")
    return sinks.reshape(heads).to(device=device, dtype=torch.float32).contiguous()


def kernel_softcap(softcap) -> float:
    """The logit softcap as the kernels take it: a float, 0 for off; a
    negative or non-finite cap raises."""
    cap = float(softcap or 0.0)
    if not 0.0 <= cap < float("inf"):
        raise ValueError(f"softcap must be a finite cap >= 0 (0 = off), got {softcap}")
    return cap


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


def alloc_kv_cache(shape, dtype, device) -> torch.Tensor:
    """A zeroed stacked cache ``[L, N, bs, heads, dim]`` whose storage holds
    one spare token row past its end. ``scatter_kv_rows`` sends dropped
    rows there: no kernel, no gather and no later read ever sees it, and
    the tensor the kernels and the tests see has exactly ``shape``."""
    l, n, bs, heads, dim = shape
    rows = (l * n * bs + 1, heads, dim)
    if dtype == FP8:  # zero bytes are +0.0 in e4m3
        buf = torch.zeros(rows, dtype=torch.uint8, device=device).view(FP8)
    else:
        buf = torch.zeros(rows, dtype=dtype, device=device)
    return buf[:-1].view(shape)


def _spare_view(cache: torch.Tensor):
    """``cache`` flattened to token rows plus its spare row
    (``alloc_kv_cache``), or None when its storage has none."""
    heads, dim = cache.shape[-2:]
    n_rows = cache.numel() // (heads * dim)
    need = (cache.storage_offset() + (n_rows + 1) * heads * dim) * cache.element_size()
    if not cache.is_contiguous() or cache.untyped_storage().nbytes() < need:
        return None
    return cache.as_strided((n_rows + 1, heads, dim), (heads * dim, dim, 1))


class KVWritePlan:
    """Where one forward's new K/V token rows go, computed once and shared
    by every layer's scatter, at fixed shapes and with no host read (the
    dispatch-ahead decode loop must not wait for the device).

    The reference drops the ``-1`` sentinel and every slot past the layer
    by mapping them past the end under ``mode="drop"``; torch has no drop
    mode and a negative index wraps. Two formulations, one result in the
    cache:

    - ``dst(n_layers)`` [L, B*S], for caches with a spare row
      (``alloc_kv_cache``): kept rows go to their slot of the layer,
      dropped rows to the spare row, which nothing reads.
    - ``rows`` / ``slots`` / ``any_kept``, for any other cache: a dropped
      row writes what the first kept row writes, to the same slot
      (duplicates of one write carry one value); when no row is kept
      (``any_kept`` false: an inert warmup step, a burst of frozen rows)
      every row targets slot 0 and the scatter writes back what slot 0
      already holds."""

    def __init__(self, slot_mapping: torch.Tensor, per_layer: int):
        self.per_layer = per_layer
        self.idx = slot_mapping.reshape(-1).long()
        self.keep = (self.idx >= 0) & (self.idx < per_layer)
        self._dst = None
        self._proxy = None
        self._spare = {}

    def dst(self, n_layers: int) -> torch.Tensor:
        if self._dst is None or self._dst.shape[0] != n_layers:
            base = torch.arange(n_layers, device=self.idx.device) * self.per_layer
            self._dst = torch.where(self.keep[None, :],
                                    self.idx[None, :] + base[:, None],
                                    n_layers * self.per_layer)
        return self._dst

    def spare(self, cache: torch.Tensor):
        """``_spare_view(cache)``, looked up once per forward."""
        key = (cache.data_ptr(), cache.shape)
        if key not in self._spare:
            self._spare[key] = _spare_view(cache)
        return self._spare[key]

    def _proxied(self):
        if self._proxy is None:
            idx, keep = self.idx, self.keep
            first = torch.argmax(keep.to(torch.int32))  # 0 when nothing is kept
            rows = torch.where(
                keep, torch.arange(idx.numel(), device=idx.device), first)
            # (indexing by the 0-dim ``first`` would read it on the host)
            any_kept = keep.any()
            slots = torch.where(any_kept, idx[rows], torch.zeros_like(idx))
            self._proxy = rows, slots, any_kept
        return self._proxy

    rows = property(lambda self: self._proxied()[0])
    slots = property(lambda self: self._proxied()[1])
    any_kept = property(lambda self: self._proxied()[2])


def kv_write_plan(slot_mapping: torch.Tensor, per_layer: int) -> KVWritePlan:
    """The forward's ``KVWritePlan`` for ``slot_mapping`` [B, S] (flat slot
    within one layer; ``-1`` and slots past the layer drop)."""
    return KVWritePlan(slot_mapping, per_layer)


def scatter_kv_rows(k_all, v_all, new_k, new_v, plan: KVWritePlan,
                    layer_idx: int):
    """Write ``new_k/new_v`` [B, S, heads, dim] into layer ``layer_idx`` of
    the stacked caches as ``plan`` says, in place (``index_copy_``: no
    per-layer slice of a cache is copied). The values are cast to the
    cache's dtype (``to_cache_dtype``); an e4m3 cache is written through
    its bytes, on either route."""
    l, n, bs, kvh, dk = k_all.shape
    vh, dv = v_all.shape[-2:]
    per_layer = n * bs
    src_k = _bytes(to_cache_dtype(new_k.reshape(-1, kvh, dk), k_all.dtype))
    src_v = _bytes(to_cache_dtype(new_v.reshape(-1, vh, dv), v_all.dtype))
    spare_k, spare_v = plan.spare(k_all), plan.spare(v_all)
    if spare_k is not None and spare_v is not None:
        dst = plan.dst(l)[layer_idx]
        _bytes(spare_k).index_copy_(0, dst, src_k)
        _bytes(spare_v).index_copy_(0, dst, src_v)
        return k_all, v_all
    flat_k = _bytes(k_all).view(l * per_layer, kvh, dk)
    flat_v = _bytes(v_all).view(l * per_layer, vh, dv)
    base = layer_idx * per_layer
    dst = plan.slots + base
    flat_k.index_copy_(0, dst, torch.where(plan.any_kept, src_k[plan.rows],
                                           flat_k[base]))
    flat_v.index_copy_(0, dst, torch.where(plan.any_kept, src_v[plan.rows],
                                           flat_v[base]))
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
    plan = kv_write_plan(slot_mapping, k_all.shape[1] * k_all.shape[2])
    return scatter_kv_rows(k_all, v_all, new_k, new_v, plan, layer_idx)


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
    k = gather_pages(k_cache, bt).reshape(b, w * block_size, kvh, d).to(q.dtype)
    v = gather_pages(v_cache, bt).reshape(b, w * block_size, kvh, d).to(q.dtype)

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
    logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    if sinks is not None:
        sink_col = torch.as_tensor(sinks, dtype=logits.dtype,
                                   device=q.device).reshape(1, 1, kvh, groups, 1)
        logits = torch.cat([logits, sink_col.expand(b, s, kvh, groups, 1)], -1)
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)[..., :-1]
    else:
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bskgt,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


# the dense prefill's query chunk: each chunk's logits stay within this many
# elements (f32 softmax: 4 bytes each, beside the activation-dtype logits)
PREFILL_LOGITS_BUDGET = 1 << 27


def prefill_attention(
    q: torch.Tensor,           # [B, S, H, D]
    k: torch.Tensor,           # [B, S, KVH, D]
    v: torch.Tensor,
    valid_lens: torch.Tensor,  # [B] number of real (non-pad) tokens
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense causal self-attention for a prefill without cache reads (the
    whole context is the in-flight prompt: the embed trunk). The
    reference's arithmetic: logits in the activation dtype, the causal and
    valid-length masks at the dtype's minimum, the softmax in f32 cast
    back, the values' sum in the activation dtype. SDPA rounds differently,
    so it is not used.

    The queries are walked in chunks of as many rows as keep a chunk's
    [B, chunk, KVH, G, S] logits within ``PREFILL_LOGITS_BUDGET`` elements
    (the unchunked logits grow with S²). A query row's softmax reads only
    its own logits, so a chunk computes the same numbers as the unchunked
    version."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    if scale is None:
        scale = d ** -0.5
    query_chunk = max(1, PREFILL_LOGITS_BUDGET // max(1, b * h * s))
    qg = q.reshape(b, s, kvh, groups, d) * scale
    k_pos = torch.arange(s, device=q.device)
    valid = k_pos[None, :] < valid_lens.long()[:, None]     # [B, T]
    out = torch.empty_like(q)
    for c0 in range(0, s, query_chunk):
        c1 = min(s, c0 + query_chunk)
        logits = torch.einsum("bskgd,btkd->bskgt", qg[:, c0:c1], k)
        causal = k_pos[None, :] <= k_pos[c0:c1, None]       # [C, T]
        mask = (causal[None] & valid[:, None, :])[:, :, None, None, :]
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out[:, c0:c1] = torch.einsum("bskgt,btkd->bskgd", probs, v).reshape(
            b, c1 - c0, h, d)
    return out


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
    place, and takes ``sinks`` ([H] logits, head order ``kvh * G + g``) and
    ``softcap``. The verify and flash kernels assume affine query positions
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
    window = NO_WINDOW if sliding_window is None else int(sliding_window)
    kw = dict(layer_idx=layer_idx, scale=scale, window=window, sinks=sinks,
              softcap=softcap)
    if q.shape[1] == 1:
        from .paged_decode import paged_decode_attention

        return paged_decode_attention(
            q, k_cache, v_cache, block_tables, context_lens, **kw)
    from .paged_verify import VERIFY_MAX_S, paged_verify_attention

    if q.shape[1] <= VERIFY_MAX_S:
        return paged_verify_attention(
            q, k_cache, v_cache, block_tables, positions[:, 0], context_lens,
            **kw)
    from .paged_flash import paged_flash_attention

    return paged_flash_attention(
        q, k_cache, v_cache, block_tables, positions[:, 0], context_lens, **kw)
