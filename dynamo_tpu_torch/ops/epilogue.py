"""The fused sampling epilogue: the per-row decode tail in one kernel, and
its plain PyTorch version.

Replaces the TPU kernel ``dynamo_tpu/ops/pallas_epilogue.py``
(``fused_sampling_epilogue``, ``_epilogue_kernel``) in all its forms. Per
row: bias (plus ``extra_bias``, the chained burst's guided mask),
repetition / frequency / presence penalties, greedy argmax, temperature,
top-k, min-p, top-p, the gumbel argmax, the chosen token's logprob from the
biased (unpenalized) logits, and the count commit. With ``finish`` (the
chained burst's per-row carry) the same launch also returns the step's
finish verdicts: ``hard`` (a stop id at or past ``min_new``, ``max_new``
reached, the model-len horizon), the row's suffix ring with the token
pushed for committed rows, and ``cand`` (a watched stop sequence's rolling
suffix hash matched).

The count commit: with ``alias_counts=True`` (the decode and burst paths,
whose sample slots are unique) the kernel adds each committed row's token
to ``counts`` in place; with ``alias_counts=False`` (the batched prefill
step, whose pad rows share slot 0 with a live row) it stays an
``index_put_(accumulate=True)`` outside the kernel, a scatter-add in which
a pad row adds 0.

CPU tensors take ``fused_sampling_epilogue_ref``; CUDA tensors launch the
kernel (``csrc/sampling_epilogue.cu``) or raise. ``launches`` counts
kernel launches.

The kernel runs one thread-block cluster of ``CLUSTER`` CTAs per batch
row, each holding a contiguous slice of the row in its shared memory
(``cluster_plan``), so the vocabulary it takes is bounded by what a CTA's
shared memory holds; a larger one raises ``NotImplementedError`` before
anything is built or launched.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..engine.sampling import (
    SamplingParams,
    device_finish_mask,
    ring_push,
    sample,
    stop_candidate_mask,
)
from . import _build

launches = 0
launches_finish = 0   # the launches of the ``finish`` form among them

CLUSTER = 8                # CTAs a row (csrc/sampling_epilogue.cu CS)
_SMEM_FIXED = 28672        # the kernel's per-CTA state (FIXED_BYTES)
_SMEM_MAX = 232448         # an H100 CTA's dynamic shared memory
# the largest vocabulary whose slice (f32, a multiple of 8 entries) and
# compacted list (u16) fit
MAX_VOCAB = CLUSTER * ((_SMEM_MAX - _SMEM_FIXED) // 6 // 8 * 8)


def cluster_plan(vocab: int) -> Tuple[int, int, int]:
    """(CTAs a row, entries of the row each CTA holds, dynamic shared
    memory bytes a CTA needs) at ``vocab``; raises ``NotImplementedError``
    when the slice does not fit a CTA's shared memory."""
    if not 0 < vocab <= MAX_VOCAB:
        raise NotImplementedError(
            f"epilogue kernel: vocabulary {vocab} is outside 1..{MAX_VOCAB} "
            f"(a row's slice over a cluster of {CLUSTER} CTAs must fit a "
            "CTA's shared memory)")
    per_cta = -(-vocab // CLUSTER)
    slice_len = -(-per_cta // 8) * 8   # a multiple of 8 entries
    smem = -(-(_SMEM_FIXED + 6 * slice_len) // 16) * 16
    return CLUSTER, slice_len, smem


def fused_sampling_epilogue_ref(
    last_logits: torch.Tensor,   # [B, V] head output
    gumbel: torch.Tensor,        # [B, V] f32 per-row gumbel noise
    samp: SamplingParams,        # per-row [B] tensors
    counts: torch.Tensor,        # [NS, V] i32 generated-token counts (updated)
    seen: torch.Tensor,          # [NS, V] bool prompt presence
    bias: torch.Tensor,          # [NS, V] f32 logit_bias rows
    sample_slots: torch.Tensor,  # [B] each row's state slot
    commit: torch.Tensor,        # [B] bool rows whose sample is kept (live)
    alias_counts: bool = True,
    extra_bias: Optional[torch.Tensor] = None,  # [B, V] f32 in-step bias
    finish: Optional[Tuple] = None,
    # finish = (gen, pos, min_new, max_new, stop_ids, ring, stop_hash,
    #           stop_hlen): the chained burst's carry rows
    max_model_len: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """The plain version, op for op ``engine/sampling.sample`` plus the
    chosen logprob and the count commit (a scatter-add either way, so
    ``alias_counts`` changes nothing here). Returns ``(next_tokens [B]
    int64, lps [B] f32, counts)``; ``counts`` is updated in place. With
    ``finish`` it appends ``(hard [B] bool, cand [B] bool, ring_new
    [B, W])`` composed from ``device_finish_mask``, ``ring_push`` and
    ``stop_candidate_mask``."""
    slots = sample_slots.long()
    row_bias = bias[slots]
    if extra_bias is not None:
        row_bias = row_bias + extra_bias
    next_tokens = sample(last_logits, samp, gumbel, counts[slots], seen[slots],
                         bias=row_bias)
    logp = torch.log_softmax(last_logits.float() + row_bias, dim=-1)
    lps = torch.gather(logp, 1, next_tokens[:, None])[:, 0]
    counts.index_put_((slots, next_tokens), commit.to(counts.dtype),
                      accumulate=True)
    if finish is None:
        return next_tokens, lps, counts
    gen, pos, min_new, max_new, stop_ids, ring, stop_hash, stop_hlen = finish
    gen_n = gen + commit.to(gen.dtype)
    hard = device_finish_mask(next_tokens, gen_n, pos, stop_ids, min_new,
                              max_new, max_model_len)
    ring_new = ring_push(ring, next_tokens, commit)
    cand = stop_candidate_mask(ring_new, gen_n, min_new, stop_hash, stop_hlen)
    return next_tokens, lps, counts, hard, cand, ring_new


def _lib():
    lib = _build.load("sampling_epilogue")
    fn = lib.sampling_epilogue
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, i] + [p] * 16 + [i] * 4 + [p] * 11 + [i] * 4 + [p])
        fn.restype = ctypes.c_int
    return fn


def _device_row(t: torch.Tensor, dtype, dev, name: str, b: int,
                width: Optional[int] = None) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor on ``dev``: [B], or [B, W]
    when ``width`` is given (0 accepts any W)."""
    ok = t.shape == (b,) if width is None else (
        t.dim() == 2 and t.shape[0] == b and width in (0, t.shape[1]))
    if not ok:
        raise ValueError(f"epilogue: {name} has shape {tuple(t.shape)} at batch {b}")
    return t.to(device=dev, dtype=dtype).contiguous()


def fused_sampling_epilogue(
    last_logits: torch.Tensor,
    gumbel: torch.Tensor,
    samp: SamplingParams,
    counts: torch.Tensor,
    seen: torch.Tensor,
    bias: torch.Tensor,
    sample_slots: torch.Tensor,
    commit: torch.Tensor,
    alias_counts: bool = True,
    extra_bias: Optional[torch.Tensor] = None,
    finish: Optional[Tuple] = None,
    max_model_len: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """One-launch sampling tail; returns ``(next_tokens [B] int64, lps [B]
    f32, counts)`` with ``counts`` updated in place, plus ``(hard [B]
    bool, cand [B] bool, ring_new [B, W] int32)`` when ``finish`` is
    given. ``alias_counts=True`` requires unique ``sample_slots``."""
    if last_logits.device.type != "cuda":
        return fused_sampling_epilogue_ref(
            last_logits, gumbel, samp, counts, seen, bias, sample_slots,
            commit, alias_counts, extra_bias, finish, max_model_len)
    global launches, launches_finish
    dev = last_logits.device
    if last_logits.dim() != 2:
        raise ValueError("epilogue: last_logits must be [B, V]")
    b, v = last_logits.shape
    cluster_plan(v)
    if last_logits.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"epilogue: logits must be bfloat16 or float32 (got {last_logits.dtype})")
    if gumbel.shape != (b, v) or gumbel.dtype != torch.float32:
        raise ValueError("epilogue: gumbel must be f32 [B, V]")
    ns = counts.shape[0]
    for name, t, dt in (("counts", counts, torch.int32), ("seen", seen, torch.bool),
                        ("bias", bias, torch.float32)):
        if t.shape != (ns, v) or t.dtype != dt:
            raise ValueError(f"epilogue: {name} must be {dt} [{ns}, {v}]")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"epilogue: {name} must be contiguous on {dev}")
    logits = last_logits.contiguous()
    gum = gumbel.to(dev).contiguous()
    f32, i32 = torch.float32, torch.int32
    extra = None
    if extra_bias is not None:
        if extra_bias.shape != (b, v) or extra_bias.dtype != f32:
            raise ValueError("epilogue: extra_bias must be f32 [B, V]")
        extra = extra_bias.to(dev).contiguous()
    rows = [_device_row(getattr(samp, name), dt, dev, name, b) for name, dt in (
        ("temperature", f32), ("top_k", torch.int64), ("top_p", f32),
        ("min_p", f32), ("presence_penalty", f32), ("frequency_penalty", f32),
        ("repetition_penalty", f32))]
    slots = _device_row(sample_slots, torch.int64, dev, "sample_slots", b)
    com = _device_row(commit, torch.bool, dev, "commit", b)
    tokens = torch.empty(b, dtype=torch.int64, device=dev)
    lps = torch.empty(b, dtype=f32, device=dev)
    fin, fin_out, dims = [None] * 8, [None] * 3, (0, 0, 0)
    if finish is not None:
        names = ("gen", "pos", "min_new", "max_new", "stop_ids", "ring",
                 "stop_hash", "stop_hlen")
        if len(finish) != len(names):
            raise ValueError(f"epilogue: finish must hold {names}")
        fin = [_device_row(t, i32, dev, n, b) for n, t in zip(names[:4], finish)]
        stop_ids = _device_row(finish[4], i32, dev, "stop_ids", b, width=0)
        ring = _device_row(finish[5], i32, dev, "ring", b, width=0)
        stop_hash = _device_row(finish[6], torch.int64, dev, "stop_hash", b, width=0)
        stop_hlen = _device_row(finish[7], i32, dev, "stop_hlen", b,
                                width=stop_hash.shape[1])
        fin += [stop_ids, ring, stop_hash, stop_hlen]
        fin_out = [torch.empty(b, dtype=torch.bool, device=dev),
                   torch.empty(b, dtype=torch.bool, device=dev),
                   torch.empty_like(ring)]
        dims = (stop_ids.shape[1], ring.shape[1], stop_hash.shape[1])

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = _lib()(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16), gum.data_ptr(),
        *(t.data_ptr() for t in rows), counts.data_ptr(), seen.data_ptr(),
        bias.data_ptr(), ptr(extra), slots.data_ptr(), com.data_ptr(),
        tokens.data_ptr(), lps.data_ptr(), b, v,
        int(bool(alias_counts)), int(finish is not None),
        *(ptr(t) for t in fin), *(ptr(t) for t in fin_out), *dims,
        int(max_model_len), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "sampling_epilogue")
    launches += 1
    if finish is not None:
        launches_finish += 1
    if not alias_counts:
        counts.index_put_((slots, tokens), com.to(counts.dtype), accumulate=True)
    if finish is None:
        return tokens, lps, counts
    return (tokens, lps, counts) + tuple(fin_out)
