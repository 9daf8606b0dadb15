"""The fused sampling epilogue: the per-row decode tail in one kernel, and
its plain PyTorch version.

Replaces the TPU kernel ``dynamo_tpu/ops/pallas_epilogue.py``
(``fused_sampling_epilogue``, ``_epilogue_kernel``) without its chained-
burst forms (the finish verdict, the suffix ring and the guided
``extra_bias``). Per row: bias, repetition / frequency / presence
penalties, greedy argmax, temperature, top-k, min-p, top-p, the gumbel
argmax, the chosen token's logprob from the biased (unpenalized) logits,
and the count commit.

The count commit: with ``alias_counts=True`` (the decode and burst paths,
whose sample slots are unique) the kernel adds each committed row's token
to ``counts`` in place; with ``alias_counts=False`` (the batched prefill
step, whose pad rows share slot 0 with a live row) it stays an
``index_put_(accumulate=True)`` outside the kernel, a scatter-add in which
a pad row adds 0.

CPU tensors take ``fused_sampling_epilogue_ref``; CUDA tensors launch the
kernel (``csrc/sampling_epilogue.cu``) or raise. ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..engine.sampling import SamplingParams, sample
from . import _build

launches = 0


def fused_sampling_epilogue_ref(
    last_logits: torch.Tensor,   # [B, V] head output
    gumbel: torch.Tensor,        # [B, V] f32 per-row gumbel noise
    samp: SamplingParams,        # per-row [B] tensors
    counts: torch.Tensor,        # [NS, V] i32 generated-token counts (updated)
    seen: torch.Tensor,          # [NS, V] bool prompt presence
    bias: torch.Tensor,          # [NS, V] f32 logit_bias rows
    sample_slots: torch.Tensor,  # [B] each row's state slot
    commit: torch.Tensor,        # [B] bool rows whose sample is kept
    alias_counts: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version, op for op ``engine/sampling.sample`` plus the
    chosen logprob and the count commit (a scatter-add either way, so
    ``alias_counts`` changes nothing here). Returns ``(next_tokens [B]
    int64, lps [B] f32, counts)``; ``counts`` is updated in place."""
    slots = sample_slots.long()
    row_bias = bias[slots]
    next_tokens = sample(last_logits, samp, gumbel, counts[slots], seen[slots],
                         bias=row_bias)
    logp = torch.log_softmax(last_logits.float() + row_bias, dim=-1)
    lps = torch.gather(logp, 1, next_tokens[:, None])[:, 0]
    counts.index_put_((slots, next_tokens), commit.to(counts.dtype),
                      accumulate=True)
    return next_tokens, lps, counts


def _lib():
    lib = _build.load("sampling_epilogue")
    fn = lib.sampling_epilogue
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, p, p, p, p, p, p, p, p, p, p, p,
                       i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _device_row(t: torch.Tensor, dtype, dev, name: str, b: int) -> torch.Tensor:
    if t.shape != (b,):
        raise ValueError(f"epilogue: {name} has shape {tuple(t.shape)}, want ({b},)")
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-launch sampling tail; returns ``(next_tokens [B] int64, lps [B]
    f32, counts)`` with ``counts`` updated in place. ``alias_counts=True``
    requires unique ``sample_slots``."""
    if last_logits.device.type != "cuda":
        return fused_sampling_epilogue_ref(
            last_logits, gumbel, samp, counts, seen, bias, sample_slots,
            commit, alias_counts)
    global launches
    dev = last_logits.device
    if last_logits.dim() != 2:
        raise ValueError("epilogue: last_logits must be [B, V]")
    b, v = last_logits.shape
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
    f32 = torch.float32
    rows = [_device_row(getattr(samp, name), dt, dev, name, b) for name, dt in (
        ("temperature", f32), ("top_k", torch.int64), ("top_p", f32),
        ("min_p", f32), ("presence_penalty", f32), ("frequency_penalty", f32),
        ("repetition_penalty", f32))]
    slots = _device_row(sample_slots, torch.int64, dev, "sample_slots", b)
    com = _device_row(commit, torch.bool, dev, "commit", b)
    scratch = torch.empty((b, v), dtype=f32, device=dev)
    tokens = torch.empty(b, dtype=torch.int64, device=dev)
    lps = torch.empty(b, dtype=f32, device=dev)
    rc = _lib()(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16), gum.data_ptr(),
        *(t.data_ptr() for t in rows), counts.data_ptr(), seen.data_ptr(),
        bias.data_ptr(), slots.data_ptr(), com.data_ptr(), scratch.data_ptr(),
        tokens.data_ptr(), lps.data_ptr(), b, v, int(bool(alias_counts)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "sampling_epilogue")
    launches += 1
    if not alias_counts:
        counts.index_put_((slots, tokens), com.to(counts.dtype), accumulate=True)
    return tokens, lps, counts
