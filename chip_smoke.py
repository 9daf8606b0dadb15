#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dynamo_tpu_torch``) on one
NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and the CUDA toolkit (``nvcc``); it imports
nothing of JAX or of the JAX package. Phases, each printed as a JSON line:

1. ``device``  — the card's name and ``nvidia-smi`` name / power limit.
2. ``build``   — builds the four kernels from ``dynamo_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once).
3. ``kernels`` — holds each kernel against its plain PyTorch version at the
   Llama-3.2-1B shapes (H=32, KVH=8, D=64, bs=16, bf16, a 16-layer stacked
   cache, layer_idx != 0): decode; flash, also at the engine's batched
   prefill shapes (rows with their own base_pos and ctx, pad rows); verify
   at S 2, 5, 17 and 32 (padded proposals, a window, a pad row); the
   sampling epilogue at B 8 over V 128,256 in every sampling regime, with
   the count commit in the kernel and outside it. It times kernel, plain
   version, a PyTorch library call where one computes the same function
   (SDPA over pre-gathered dense K/V, a yardstick only) and the card's
   bound for the same work.
4. ``engine``  — serves token-id requests through ``TorchServingEngine``
   at the full Llama-3.2-1B shapes with seeded random bf16 weights,
   checks every stream, the kernels' launch counts on that run, a repeated
   request, and the logits of batched prefill and decode steps against the
   same forwards on the CPU in f32.
5. ``engine_paths`` — the same weights behind three more engines: the
   unfused sampling tail and 4-step decode bursts must stream wave 1
   identically; ngram speculation must stream its repeated-pattern prompts
   as without it, or part at a printed near-tie.

Every check raises on failure, so any failed phase ends the run with a
non-zero exit. The last line is the machine-readable result
``{"ok": true, "device": {...}}``; the line before it holds the kernels'
numbers; the line before that the card's name and power limit.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Llama-3.2-1B (published config.json): the flagship shapes of the JAX
# package plus tied embeddings and llama3 rope scaling
FLAGSHIP = dict(
    vocab_size=128256, hidden_size=2048, intermediate_size=8192,
    num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
    rope_theta=500000.0, max_position_embeddings=131072,
    tie_word_embeddings=True,
    rope_scaling={"rope_type": "llama3", "factor": 32.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192},
)
ENGINE = dict(max_batch_size=8, max_model_len=2048, kv_block_size=16,
              num_kv_blocks=1024, dtype="bfloat16",
              # small enough to chunk every long prompt over several steps
              max_prefill_tokens_per_step=512)
NEW_TOKENS = 32
SEED = 0
# speculative phase: ngram proposals of 4 tokens on a 3-gram match, 64 new
# tokens per request; a parted stream must part at a near-tie
SPEC = dict(spec_ngram_tokens=4, spec_ngram_match=3)
SPEC_NEW_TOKENS = 64
NEAR_TIE = 0.05

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # outside the tensor cores

# kernel tolerance: bf16 output rounding (~4e-3 relative) plus a different
# summation order than the f32 plain version
ATOL, RTOL = 1e-2, 1e-2
# whole-model tolerance, GPU bf16 vs CPU f32 on the same bf16-valued
# weights: relative L2 error of the logits. bf16 activations through 16
# layers stay near 1e-2; a wrong attention result anywhere gives O(1)
LOGITS_REL_L2 = 5e-2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA-event timed after a warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, got, ref) -> float:
    """max |got - ref|, raising unless |diff| <= ATOL + RTOL * |ref|."""
    diff = (got.float() - ref.float()).abs()
    bad = diff > ATOL + RTOL * ref.float().abs()
    if bool(bad.any()) or not bool(got.float().isfinite().all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements out of tolerance, "
            f"max |diff| {float(diff.max()):.3g}")
    return float(diff.max())


# ---------------------------------------------------------------- kernels


def _visible(qpos, ctx, window):
    """Number of keys a query at ``qpos`` sees: j <= qpos, j < ctx,
    j > qpos - window."""
    hi = np.minimum(qpos, ctx - 1)
    lo = np.maximum(0, qpos - window + 1)
    return np.maximum(hi - lo + 1, 0)


def _bound_ms(flops: float, nbytes: float):
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes")


def _flash_timing(torch, pf, k, v, k32, v32, layer, qf, btp, basep, ctxp, S,
                  rows, ref):
    """Kernel, plain (f32) and SDPA-yardstick times of one flash call, its
    bound from the keys this call's valid query rows see, and the plain
    version's own error when run in bf16."""
    F = torch.nn.functional
    dev = qf.device
    B, _, H, D = qf.shape
    KVH = k.shape[3]
    ms = cuda_ms(lambda: pf.paged_flash_attention(qf, k, v, btp, basep, ctxp,
                                                  layer_idx=layer))
    plain_ms = cuda_ms(lambda: pf.paged_flash_attention_ref(
        qf.float(), k32, v32, btp, basep, ctxp, layer))
    plain_bf16 = pf.paged_flash_attention_ref(qf, k, v, btp, basep, ctxp, layer)
    # library yardstick: SDPA over each row's K/V pre-gathered to dense
    T = max(c for _, c in rows)
    kd = k[layer][btp.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
    vd = v[layer][btp.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
    kd = kd.repeat_interleave(H // KVH, dim=1).contiguous()
    vd = vd.repeat_interleave(H // KVH, dim=1).contiguous()
    qpos = basep.long()[:, None, None] + torch.arange(S, device=dev)[None, :, None]
    keys = torch.arange(T, device=dev)[None, None, :]
    mask = ((keys <= qpos) & (keys < ctxp.long()[:, None, None]))[:, None]
    qd = qf.transpose(1, 2).contiguous()
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask))
    flops, kv_bytes, plain_err = 0.0, 0, 0.0
    for i, (base, c) in enumerate(rows):
        nv = min(S, c - base)
        flops += 4.0 * D * H * _visible(base + np.arange(nv), c, 1 << 30).sum()
        kv_bytes += min(c, base + S) * KVH * D * 2 * 2
        plain_err = max(plain_err, float(
            (plain_bf16[i, :nv].float() - ref[i, :nv]).abs().max()))
    bound, by = _bound_ms(flops, 2 * qf.numel() * 2 + kv_bytes)
    torch.cuda.synchronize()
    return dict(kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by=by, plain_bf16_max_err=plain_err,
                ctas=-(-S // (64 // (H // KVH))) * KVH * B)


def kernel_phase(torch, dev):
    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_flash as pf

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    F = torch.nn.functional
    L, N, BS, KVH, D, H = 16, 1024, 16, 8, 64, 32
    LAYER = 7
    g = torch.Generator(device=dev).manual_seed(SEED)
    k = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    v = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    k32, v32 = k.float(), v.float()
    W = ENGINE["max_model_len"] // BS
    entries = {}

    # ---- decode: B=8, ctx spread over page boundaries up to the full table
    ctx_l = [1, 15, 16, 17, 513, 2048, 700, 1500]
    B = len(ctx_l)
    bt = torch.randperm(N, generator=g, device=dev)[: B * W].reshape(B, W).int()
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    q = torch.randn(B, 1, H, D, generator=g, device=dev).bfloat16()
    errs = {}
    for window in (pd.NO_WINDOW, 256):
        out = pd.paged_decode_attention(q, k, v, bt, ctx, layer_idx=LAYER,
                                        window=window)
        ref = pd.paged_decode_attention_ref(q.float(), k32, v32, bt, ctx,
                                            LAYER, None, window)
        torch.cuda.synchronize()
        errs[window] = check_close(f"decode window={window}", out, ref)
    plain_bf16 = pd.paged_decode_attention_ref(q, k, v, bt, ctx, LAYER)
    ref = pd.paged_decode_attention_ref(q.float(), k32, v32, bt, ctx, LAYER)
    ms = cuda_ms(lambda: pd.paged_decode_attention(q, k, v, bt, ctx, layer_idx=LAYER))
    plain_ms = cuda_ms(lambda: pd.paged_decode_attention_ref(
        q.float(), k32, v32, bt, ctx, LAYER))
    # library yardstick: SDPA over K/V pre-gathered into dense [B, H, T, D]
    T = W * BS
    kd = k[LAYER][bt.long()].reshape(B, T, KVH, D).transpose(1, 2)
    vd = v[LAYER][bt.long()].reshape(B, T, KVH, D).transpose(1, 2)
    kd = kd.repeat_interleave(H // KVH, dim=1).contiguous()
    vd = vd.repeat_interleave(H // KVH, dim=1).contiguous()
    mask = (torch.arange(T, device=dev)[None, :] < ctx[:, None])[:, None, None, :]
    qd = q.transpose(1, 2).contiguous()
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask))
    keys = np.asarray(ctx_l, np.int64)
    nbytes = 2 * q.numel() * 2 + keys.sum() * KVH * D * 2 * 2
    flops = 4.0 * D * H * keys.sum()
    bound, by = _bound_ms(flops, nbytes)
    emit("kernels", kernel="paged_decode", shape=dict(B=B, H=H, KVH=KVH, D=D,
         bs=BS, L=L, layer=LAYER, ctx=ctx_l), max_err=errs[pd.NO_WINDOW],
         max_err_window256=errs[256],
         plain_bf16_max_err=float((plain_bf16.float() - ref).abs().max()),
         kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
         bound_by=by, ctas=B * KVH, sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    entries["paged_decode"] = dict(
        name="paged_decode_attention", route="cuda",
        source="dynamo_tpu_torch/csrc/paged_decode.cu",
        replaces="dynamo_tpu/ops/pallas_decode.py:742",
        max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=lib_ms)
    torch.cuda.synchronize()

    # ---- flash: one row at S 64 and 512 from position 0, a prefix hit and
    # a padded tail; then batches as the engine's chunked prefill builds
    # them (ENGINE's 512-token budget: 8 rows at S 64, 4 rows at S 128),
    # each row with its own base_pos and ctx, and pad rows as the scheduler
    # pads the power-of-two row ladder (base 0, ctx 1, block table 0).
    # (name, S, [(base_pos, ctx) per row, None = pad row])
    cases = [("s64", 64, [(0, 64)]), ("s512", 512, [(0, 512)]),
             ("prefix_hit", 512, [(256, 768)]), ("padded_tail", 512, [(0, 300)]),
             ("batch8_s64", 64, [(0, 64), (256, 320), (128, 168), (1984, 2048),
                                 (64, 100), (1472, 1500), None, None]),
             ("batch4_s128", 128, [(0, 128), (384, 512), (1024, 1100), None])]
    max_errs, inputs = {}, {}
    for name, S, rows in cases:
        B = len(rows)
        pad = torch.tensor([r is None for r in rows], device=dev)
        rows = [r or (0, 1) for r in rows]
        qf = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
        basep = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
        ctxp = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
        btp = bt[:B].clone()
        btp[pad] = 0
        out = pf.paged_flash_attention(qf, k, v, btp, basep, ctxp, layer_idx=LAYER)
        ref = pf.paged_flash_attention_ref(qf.float(), k32, v32, btp, basep,
                                           ctxp, LAYER)
        torch.cuda.synchronize()
        if not bool(out.float().isfinite().all()):
            raise AssertionError(f"flash {name}: non-finite output (pad rows too)")
        errs = []
        for i, (base, c) in enumerate(rows):
            nv = min(S, c - base)  # rows past ctx are discarded by the caller
            errs.append(check_close(f"flash {name} row {i}", out[i, :nv],
                                    ref[i, :nv]))
        max_errs[name] = max(errs)
        inputs[name] = (qf, btp, basep, ctxp, S, rows, ref)
    timings = {name: _flash_timing(torch, pf, k, v, k32, v32, LAYER,
                                   *inputs[name])
               for name in ("prefix_hit", "batch4_s128")}
    emit("kernels", kernel="paged_flash",
         shape=dict(H=H, KVH=KVH, D=D, bs=BS, L=L, layer=LAYER,
                    cases={name: dict(S=S, rows=rows) for name, S, rows in cases}),
         max_err=max_errs, timed=timings)
    # the line's entry: the engine's own batched chunk (4 rows at S 128)
    t = timings["batch4_s128"]
    entries["paged_flash"] = dict(
        name="paged_flash_attention", route="cuda",
        source="dynamo_tpu_torch/csrc/paged_flash.cu",
        replaces="dynamo_tpu/ops/pallas_attention.py:254",
        max_abs_err=max(max_errs.values()), ms=t["kernel_ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"])
    entries["paged_verify"] = _verify_cases(torch, dev, g, k, v, k32, v32,
                                            bt, ctx_l, LAYER)
    del k, v, k32, v32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    entries["sampling_epilogue"] = _epilogue_cases(torch, dev)
    return entries


def _verify_cases(torch, dev, g, k, v, k32, v32, bt, ctx_l, layer):
    """The verify kernel at S 2, 5, 17 and 32 over the decode phase's
    contexts (each row's tail ends at its ctx: base = max(ctx - S, 0), so
    short rows are padded proposals) plus a pad row (base 0, ctx 1, table
    0); S 5 (the engine's K + 1 = 5) also with window 256. Every valid row
    (base + s < ctx) is held against the f32 plain version; S 5 is timed."""
    from dynamo_tpu_torch.ops import paged_verify as pv

    F = torch.nn.functional
    H, D = 32, 64
    KVH = k.shape[3]
    B = len(ctx_l) + 1
    btv = torch.cat([bt, torch.zeros_like(bt[:1])])
    ctx = torch.tensor(ctx_l + [1], dtype=torch.int32, device=dev)
    errs, timed = {}, None
    for S in (2, 5, 17, 32):
        base = torch.clamp(ctx - S, min=0)
        q = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
        for window in ((pv.NO_WINDOW, 256) if S == 5 else (pv.NO_WINDOW,)):
            out = pv.paged_verify_attention(q, k, v, btv, base, ctx,
                                            layer_idx=layer, window=window)
            ref = pv.paged_verify_attention_ref(q.float(), k32, v32, btv, base,
                                                ctx, layer, None, window)
            torch.cuda.synchronize()
            if not bool(out.float().isfinite().all()):
                raise AssertionError(f"verify S={S}: non-finite output")
            errs[f"S{S}" + ("" if window == pv.NO_WINDOW else f"_w{window}")] = max(
                check_close(f"verify S={S} window={window} row {i}",
                            out[i, : int(c - b)], ref[i, : int(c - b)])
                for i, (b, c) in enumerate(zip(base.tolist(), ctx.tolist())))
        if S == 5:
            timed = (q, base)
    q, base = timed
    S = q.shape[1]
    ms = cuda_ms(lambda: pv.paged_verify_attention(q, k, v, btv, base, ctx,
                                                   layer_idx=layer))
    plain_ms = cuda_ms(lambda: pv.paged_verify_attention_ref(
        q.float(), k32, v32, btv, base, ctx, layer))
    # library yardstick: SDPA over K/V pre-gathered to dense, causal by
    # absolute position (query s of row b at base + s)
    T = max(ctx_l)
    kd = k[layer][btv.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
    vd = v[layer][btv.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
    kd = kd.repeat_interleave(H // KVH, dim=1).contiguous()
    vd = vd.repeat_interleave(H // KVH, dim=1).contiguous()
    qpos = base.long()[:, None, None] + torch.arange(S, device=dev)[None, :, None]
    keys = torch.arange(T, device=dev)[None, None, :]
    mask = ((keys <= qpos) & (keys < ctx.long()[:, None, None]))[:, None]
    qd = q.transpose(1, 2).contiguous()
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask))
    flops, kv_bytes = 0.0, 0
    for b, c in zip(base.tolist(), ctx.tolist()):
        nv = c - b
        flops += 4.0 * D * H * _visible(b + np.arange(nv), c, 1 << 30).sum()
        kv_bytes += min(c, b + S) * KVH * D * 2 * 2
    bound, by = _bound_ms(flops, 2 * q.numel() * 2 + kv_bytes)
    emit("kernels", kernel="paged_verify",
         shape=dict(B=B, S=[2, 5, 17, 32], H=H, KVH=KVH, D=D, layer=layer,
                    ctx=ctx.tolist(), pad_row="base 0, ctx 1, table 0"),
         max_err=errs, timed_S=S, kernel_ms=ms, plain_ms=plain_ms,
         library_ms=lib_ms, bound_ms=bound, bound_by=by, ctas=B * KVH)
    torch.cuda.synchronize()
    return dict(name="paged_verify_attention", route="cuda",
                source="dynamo_tpu_torch/csrc/paged_verify.cu",
                replaces="dynamo_tpu/ops/pallas_decode.py:634",
                max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms)


# epilogue rows (B 8): the reference's mixed-regime set (greedy, top-k,
# top-p, min-p with penalties, top-k + top-p with repetition, greedy), then
# top-k 1 and a row with planted ties at the top-k and top-p cuts
EPILOGUE_ROWS = dict(
    temperature=[0.0, 0.7, 1.0, 1.3, 0.9, 0.0, 0.8, 1.0],
    top_k=[0, 5, 0, 0, 3, 0, 1, 12],
    top_p=[1.0, 1.0, 0.9, 1.0, 0.8, 1.0, 1.0, 0.55],
    min_p=[0.0, 0.0, 0.0, 0.2, 0.05, 0.0, 0.0, 0.0],
    presence_penalty=[0.0, 0.5, 0.0, 1.1, 0.0, 0.0, 0.0, 0.0],
    frequency_penalty=[0.0, 0.0, 0.3, 0.2, 0.0, 0.0, 0.0, 0.0],
    repetition_penalty=[1.0, 1.2, 1.0, 1.05, 1.3, 1.0, 1.0, 1.0],
)
EPILOGUE_LP_TOL = 1e-4


def _topp_margins(torch, logits, samp, counts, seen, bias, slots):
    """Per top-p row, the smallest |exclusive mass - top_p| over its
    tokens, after penalties, temperature, top-k and min-p as the plain
    version applies them (masses summed in f64): a token whose margin is
    within f32 rounding may flip between the kernel and the plain version."""
    out = {}
    for r in range(logits.shape[0]):
        tp = float(samp.top_p[r])
        if tp >= 1.0 or float(samp.temperature[r]) <= 0.0:
            continue
        sl = int(slots[r])
        x = logits[r].float() + bias[sl]
        c, gen = counts[sl], counts[sl] > 0
        rp = samp.repetition_penalty[r]
        x = torch.where(gen | seen[sl], torch.where(x > 0, x / rp, x * rp), x)
        x = x - samp.frequency_penalty[r] * c.float() - samp.presence_penalty[r] * gen.float()
        x = x / torch.clamp(samp.temperature[r], min=1e-6)
        tk = int(samp.top_k[r])
        if tk > 0:
            x = torch.where(x < torch.sort(x, descending=True).values[min(tk, x.numel()) - 1],
                            float("-inf"), x)
        p = torch.softmax(x, -1)
        x = torch.where(p < samp.min_p[r] * p.max(), float("-inf"), x)
        order = torch.flip(torch.argsort(x, stable=True), [0])
        p = torch.softmax(x[order].double(), -1)
        excl = torch.cumsum(p, 0) - p
        out[r] = float((excl[p > 0] - tp).abs().min())
    return out


def _epilogue_cases(torch, dev):
    """The epilogue kernel at B 8, V 128,256 over bf16 logits (normal * 4),
    with unique slots (the count commit in the kernel) and with pad rows
    sharing slot 0 (the commit outside), against its f32 plain version:
    tokens and counts equal in every row, logprobs within 1e-4. Times the
    kernel and, as its plain time, the unfused tail on the same inputs."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.ops import epilogue as ep

    V, B = FLAGSHIP["vocab_size"], len(EPILOGUE_ROWS["temperature"])
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    samp = SamplingParams(**{
        name: torch.tensor(vals, dtype=torch.int64 if name == "top_k"
                           else torch.float32, device=dev)
        for name, vals in EPILOGUE_ROWS.items()})
    u = torch.rand(B, V, generator=g, device=dev).clamp_(min=1e-30)
    gumbel = -torch.log(-torch.log(u))
    cases = {
        "unique_slots": (torch.tensor([3, 0, 5, 1, 6, 2, 4, 7], device=dev),
                         [1, 1, 0, 1, 1, 0, 1, 1], True),
        "pad_rows_on_slot0": (torch.tensor([3, 0, 5, 1, 0, 2, 0, 7], device=dev),
                              [1, 1, 0, 1, 0, 0, 0, 1], False),
    }
    results, timing_inputs = {}, None
    for name, (slots, commit, alias) in cases.items():
        logits = (torch.randn(B, V, generator=g, device=dev) * 4).bfloat16()
        counts = torch.randint(0, 3, (B, V), generator=g, device=dev,
                               dtype=torch.int32)
        seen = torch.randint(0, 2, (B, V), generator=g, device=dev).bool()
        bias = torch.randn(B, V, generator=g, device=dev) * 0.5
        # the tie row: 10 tokens tied at the top (the top-p 0.55 cut falls
        # inside them: 6 stay, by index), 5 tied at the top-k 12 cut, the
        # rest far below; no penalty state on its slot
        tie = torch.randperm(V, generator=g, device=dev)[:15]
        row = torch.full((V,), -20.0, device=dev)
        row[tie[:10]], row[tie[10:]] = 8.0, 6.0
        logits[B - 1] = row.bfloat16()
        ts = int(slots[B - 1])
        counts[ts], seen[ts], bias[ts] = 0, False, 0.0
        com = torch.tensor(commit, device=dev).bool()
        c_ker, c_ref = counts.clone(), counts.clone()
        tok, lps, _ = ep.fused_sampling_epilogue(logits, gumbel, samp, c_ker, seen,
                                                 bias, slots, com, alias_counts=alias)
        tok_r, lps_r, _ = ep.fused_sampling_epilogue_ref(logits, gumbel, samp, c_ref,
                                                         seen, bias, slots, com)
        torch.cuda.synchronize()
        margins = _topp_margins(torch, logits, samp, counts, seen, bias, slots)
        bad = [r for r in range(B) if int(tok[r]) != int(tok_r[r])]
        if bad:
            raise AssertionError(
                f"epilogue {name}: tokens differ in rows {bad} "
                f"(kernel {tok.tolist()}, plain {tok_r.tolist()}; "
                f"top-p margins {margins})")
        if not torch.equal(c_ker, c_ref):
            raise AssertionError(f"epilogue {name}: committed counts differ")
        lp_err = float((lps - lps_r).abs().max())
        if not lp_err <= EPILOGUE_LP_TOL:
            raise AssertionError(f"epilogue {name}: logprob error {lp_err:.3g}")
        results[name] = dict(tokens=tok.tolist(), logprob_max_err=lp_err,
                             topp_min_margin=margins)
        if alias:
            timing_inputs = (logits, seen, bias, slots, counts)
    logits, seen, bias, slots, counts = timing_inputs
    nocommit = torch.zeros(B, dtype=torch.bool, device=dev)  # counts stay put
    ms = cuda_ms(lambda: ep.fused_sampling_epilogue(
        logits, gumbel, samp, counts, seen, bias, slots, nocommit))
    plain_ms = cuda_ms(lambda: ep.fused_sampling_epilogue_ref(
        logits, gumbel, samp, counts, seen, bias, slots, nocommit))
    # the bytes the function must move: each row's logits (bf16) and its
    # slot's bias, counts and seen rows; gumbel rows of the sampled rows
    sampled = sum(t > 0 for t in EPILOGUE_ROWS["temperature"])
    nbytes = B * V * (2 + 4 + 4 + 1) + sampled * V * 4 + B * (8 + 4)
    # the function's f32 work, ~30 operations per element of a row (bias,
    # penalties, temperature, three softmax passes, masks, the gumbel add)
    flops = B * V * 30.0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    bound, by = max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")
    emit("kernels", kernel="sampling_epilogue",
         shape=dict(B=B, V=V, logits="bf16", rows=EPILOGUE_ROWS),
         cases=results, kernel_ms=ms, plain_ms=plain_ms, library_ms=None,
         bound_ms=bound, bound_by=by, ctas=B)
    torch.cuda.synchronize()
    return dict(name="fused_sampling_epilogue", route="cuda",
                source="dynamo_tpu_torch/csrc/sampling_epilogue.cu",
                replaces="dynamo_tpu/ops/pallas_epilogue.py:281",
                max_abs_err=max(r["logprob_max_err"] for r in results.values()),
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None)


# ----------------------------------------------------------------- engine


def _requests(rng):
    """Token-id prompts of 100-1500 tokens. Two share a 256-token prefix
    (the second is served after the first, through the prefix cache); one
    greedy prompt and one seeded-temperature prompt appear twice in the
    same wave, so each twin pair must stream identically."""
    vocab = FLAGSHIP["vocab_size"]
    lens = [1500, 100, 730, 1210, 420, 960]
    prompts = [[int(t) for t in rng.integers(0, vocab, n)] for n in lens]
    shared = prompts[2][:256]
    late = shared + [int(t) for t in rng.integers(0, vocab, 300)]
    greedy = dict(temperature=0.0)
    seeded = dict(temperature=0.8, top_p=0.95, top_k=50, seed=1234)
    wave1 = [(prompts[0], greedy), (prompts[0], greedy),      # greedy twins
             (prompts[1], seeded), (prompts[1], seeded),      # seeded twins
             (prompts[2], greedy), (prompts[3], dict(temperature=0.7, seed=7)),
             (prompts[4], greedy), (prompts[5], dict(temperature=1.0, seed=99))]
    wave2 = [(late, greedy)]
    return wave1, wave2


def _spec_requests(rng):
    """Eight greedy requests whose 200-600-token prompts repeat a random
    pattern of 3 to 40 tokens: the ngram lookup finds continuations in
    them (whether the random-weight model accepts them is its own)."""
    vocab = FLAGSHIP["vocab_size"]
    out = []
    for n, period in zip((200, 260, 330, 390, 450, 510, 560, 600),
                         (3, 7, 12, 20, 5, 33, 40, 9)):
        pattern = [int(t) for t in rng.integers(0, vocab, period)]
        out.append(((pattern * (n // period + 1))[:n], dict(temperature=0.0)))
    return out


def _last_logits(torch, runner, tokens):
    """The logits after ``tokens`` from one plain forward of the whole
    sequence on blocks 0.. of the runner's cache (run when it is idle)."""
    from dynamo_tpu_torch.models import llama

    cfg = runner.config
    dev = runner.device
    n = len(tokens)
    nb = -(-n // cfg.kv_block_size)
    bt = torch.zeros((1, cfg.blocks_per_seq), dtype=torch.int32, device=dev)
    bt[0, :nb] = torch.arange(nb, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
    with torch.inference_mode():
        hidden, _ = llama.forward(
            runner.params, cfg.model,
            torch.tensor([tokens], dtype=torch.int32, device=dev), pos,
            runner.kv_cache, bt, pos, torch.tensor([n], device=dev).int(),
            return_hidden=True)
        return llama.lm_logits(hidden[:, -1], runner.params, cfg.model)[0].float().cpu()


def _spec_agreement(torch, runner, requests, base, spec):
    """Spec streams against the same requests served without speculation:
    equal, or parted at a near-tie — at the first differing position the
    non-spec logits' top-2 gap is under NEAR_TIE of the row's max |logit|
    (the verify step and single-token decode run different kernels and
    GEMM shapes in bf16). Returns one record per parted stream."""
    parted = []
    for i, ((prompt, _), a, b) in enumerate(zip(requests, base, spec)):
        if a["tokens"] == b["tokens"]:
            continue
        j = next(j for j, (x, y) in enumerate(zip(a["tokens"], b["tokens"]))
                 if x != y)
        lg = _last_logits(torch, runner, prompt + a["tokens"][:j])
        top2 = torch.topk(lg, 2).values
        gap = float(top2[0] - top2[1])
        rel = gap / float(lg.abs().max())
        parted.append(dict(request=i, position=j, top2_gap=gap,
                           gap_over_max_abs_logit=rel))
        if not rel < NEAR_TIE:
            raise AssertionError(
                f"spec stream {i} parts from the non-spec stream at {j} where "
                f"the top-2 gap is {rel:.4g} of the max |logit| (>= {NEAR_TIE})")
    return parted


async def _serve(engine, batch, new_tokens=None):
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(prompt, samp):
        req = PreprocessedRequest(
            token_ids=prompt,
            stop_conditions=StopConditions(max_tokens=new_tokens or NEW_TOKENS,
                                           ignore_eos=True),
            sampling_options=SamplingOptions(**samp))
        t0 = time.monotonic()
        ttft, toks, reasons = None, [], []
        async for out in engine.generate(Context(req)):
            if ttft is None and out["token_ids"]:
                ttft = time.monotonic() - t0
            toks.extend(out["token_ids"])
            reasons.append(out.get("finish_reason"))
        return dict(tokens=toks, finish=reasons[-1], ttft_s=ttft)

    return await asyncio.gather(*(one(p, s) for p, s in batch))


def _check_logits(torch, engine, prompt_a, prompt_b):
    """Logits of batched steps from the engine's runner (bf16, the kernels)
    against the same forwards on the CPU in f32 through the plain route,
    from the same weights, built as the scheduler builds its steps:

    1. A's first 64 tokens and all of B as rows of one prefill step at
       bucket 64, padded to 4 rows (pad rows: base 0, ctx 1, table 0);
    2. A's tail at base_pos 64 beside one pad row;
    3. one decode step of both.

    Only the valid positions of the real rows are compared. Runs after the
    requests finished, on blocks 0.. of the runner's cache."""
    from dynamo_tpu_torch.engine.scheduler import build_prefill_arrays
    from dynamo_tpu_torch.models import llama

    runner = engine.runner
    cfg = runner.config
    bs, w = cfg.kv_block_size, cfg.blocks_per_seq
    na, nb = len(prompt_a), len(prompt_b)
    n_a = -(-(na + 1) // bs)
    blocks_a = list(range(n_a))
    blocks_b = list(range(n_a, n_a + -(-(nb + 1) // bs)))

    def tree_map(fn, tree):
        return ({k: tree_map(fn, v) for k, v in tree.items()}
                if isinstance(tree, dict) else fn(tree))

    cpu_params = tree_map(lambda t: t.float().cpu(), runner.params)
    cpu_cache = llama.init_kv_cache(cfg.model, blocks_b[-1] + 1, bs,
                                    torch.float32, "cpu")

    def pad_row(bucket):
        return (np.zeros((1, bucket), np.int32), np.zeros((1, bucket), np.int32),
                np.zeros((1, w), np.int32), np.full((1, bucket), -1, np.int32),
                np.ones(1, np.int32), np.zeros(1, np.int32))

    def prefill_step(parts, n_rows, bucket=64):
        rows = [build_prefill_arrays(cfg, p[:end], start, blocks, bucket=bucket)
                for p, start, end, blocks in parts]
        rows += [pad_row(bucket)] * (n_rows - len(parts))
        return [np.concatenate(a) for a in zip(*rows)][:5]

    def decode_step(rows):  # [(token, position, blocks)]
        btab = np.zeros((len(rows), w), np.int32)
        slots = np.zeros((len(rows), 1), np.int32)
        for i, (_, pos, blocks) in enumerate(rows):
            btab[i, : len(blocks)] = blocks
            slots[i] = blocks[pos // bs] * bs + pos % bs
        return [np.asarray([[r[0]] for r in rows]),
                np.asarray([[r[1]] for r in rows]), btab, slots,
                np.asarray([r[1] + 1 for r in rows])]

    def forward_both(arrays, valid):  # valid: [(row, n_positions)]
        outs = []
        for device, params, cache in ((runner.device, runner.params,
                                       runner.kv_cache),
                                      ("cpu", cpu_params, cpu_cache)):
            t = [torch.as_tensor(np.asarray(a).astype(np.int32), device=device)
                 for a in arrays]
            with torch.inference_mode():
                logits, _ = llama.forward(params, cfg.model, t[0], t[1], cache,
                                          t[2], t[3], t[4])
            logits = logits.float().cpu()
            if not bool(logits.isfinite().all()):
                raise AssertionError(f"non-finite logits on {device} (pad rows too)")
            outs.append([logits[r, :n] for r, n in valid])
        g, c = (torch.cat(o) for o in outs)
        return float((g - c).norm() / c.norm()), outs[0], outs[1]

    out = {}
    out["prefill_batch_rel_l2"], _, c1 = forward_both(
        prefill_step([(prompt_a, 0, 64, blocks_a), (prompt_b, 0, nb, blocks_b)],
                     4), [(0, 64), (1, nb)])
    out["prefill_base64_rel_l2"], _, c2 = forward_both(
        prefill_step([(prompt_a, 64, na, blocks_a)], 2), [(0, na - 64)])
    nxt = [int(c2[0][-1].argmax()), int(c1[1][-1].argmax())]
    out["decode_rel_l2"], g3, c3 = forward_both(
        decode_step([(nxt[0], na, blocks_a), (nxt[1], nb, blocks_b)]),
        [(0, 1), (1, 1)])
    out["decode_argmax_equal"] = [int(a.argmax()) == int(b.argmax())
                                  for a, b in zip(g3, c3)]
    for key in ("prefill_batch_rel_l2", "prefill_base64_rel_l2", "decode_rel_l2"):
        if not out[key] <= LOGITS_REL_L2:
            raise AssertionError(f"{key} {out[key]:.4g} > {LOGITS_REL_L2}")
    return out


KERNEL_MODULES = ("paged_decode", "paged_flash", "paged_verify", "epilogue")


def _reset_launches():
    import importlib

    for name in KERNEL_MODULES:
        importlib.import_module(f"dynamo_tpu_torch.ops.{name}").launches = 0


def _read_launches():
    import importlib

    return {name: importlib.import_module(f"dynamo_tpu_torch.ops.{name}").launches
            for name in KERNEL_MODULES}


def _check_streams(results, new_tokens):
    for r in results:
        if len(r["tokens"]) != new_tokens or r["finish"] != "length":
            raise AssertionError(f"bad stream: {len(r['tokens'])} tokens, "
                                 f"finish {r['finish']}")
        if max(r["tokens"]) >= FLAGSHIP["vocab_size"] or min(r["tokens"]) < 0:
            raise AssertionError("token id outside the vocabulary")


def _check_launches(path, launches, kernels, layers=FLAGSHIP["num_layers"]):
    """Every named kernel launched on this path; the attention kernels once
    per layer per forward."""
    for name in kernels:
        n = launches[name]
        per_layer = name != "epilogue"
        if n <= 0 or (per_layer and n % layers):
            raise AssertionError(
                f"{name} launched {n} times on the {path} path (want > 0"
                + (f" and a multiple of {layers})" if per_layer else ")"))


def engine_phase(torch, dev, smi):
    """Serves the smoke workload through ``TorchServingEngine`` in four
    engines on the same seeded weights, each path's kernel launches counted
    from 0 just before its requests and read just after:

    1. the main path (fused epilogue, single-token decode): wave 1, the
       prefix-hit wave 2, the speculative prompts without speculation, and
       the logits check;
    2. ``fused_epilogue="off"``: wave 1 must stream identically;
    3. ``multi_step_decode=4``: wave 1 must stream identically;
    4. ngram speculation (``SPEC``): the speculative prompts, equal to the
       non-spec streams or parted at a printed near-tie."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine

    def config(**kw):
        return EngineConfig(model=ModelConfig(**FLAGSHIP), seed=SEED,
                            **dict(ENGINE, **kw))

    rng = np.random.default_rng(SEED)
    wave1, wave2 = _requests(rng)
    spec_reqs = _spec_requests(rng)

    async def main_path():
        t0 = time.monotonic()
        engine = await TorchServingEngine.create(config(), device="cuda")
        setup_s = time.monotonic() - t0
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            _reset_launches()
            t1 = time.monotonic()
            res1 = await _serve(engine, wave1)
            wall1 = time.monotonic() - t1
            res2 = await _serve(engine, wave2)
            launches = _read_launches()
            metrics = engine.metrics()
            peak = torch.cuda.max_memory_allocated(dev)
            spec_base = await _serve(engine, spec_reqs, SPEC_NEW_TOKENS)
            logits = _check_logits(torch, engine, wave1[4][0][:100],
                                   wave1[2][0][:40])
        finally:
            await engine.close()
        return (setup_s, res1, res2, wall1, launches, metrics, peak, logits,
                spec_base)

    async def other_path(kw, batch, new_tokens=None, spec_base=None):
        engine = await TorchServingEngine.create(config(**kw), device="cuda")
        try:
            _reset_launches()
            t0 = time.monotonic()
            res = await _serve(engine, batch, new_tokens)
            wall = time.monotonic() - t0
            launches = _read_launches()
            metrics = engine.metrics()
            parted = (None if spec_base is None else
                      _spec_agreement(torch, engine.runner, batch, spec_base, res))
        finally:
            await engine.close()
        torch.cuda.empty_cache()
        return res, wall, launches, metrics, parted

    (setup_s, res1, res2, wall1, launches, metrics, peak, logits,
     spec_base) = asyncio.run(main_path())
    torch.cuda.empty_cache()
    _check_streams(res1 + res2, NEW_TOKENS)
    _check_streams(spec_base, SPEC_NEW_TOKENS)
    if res1[0]["tokens"] != res1[1]["tokens"]:
        raise AssertionError("repeated greedy request gave a different stream")
    if res1[2]["tokens"] != res1[3]["tokens"]:
        raise AssertionError("repeated seeded request gave a different stream")
    _check_launches("main", launches, ("paged_decode", "paged_flash", "epilogue"))
    if metrics["gpu_prefix_cache_hit_rate"] <= 0:
        raise AssertionError("the shared-prefix request missed the prefix cache")
    tokens1 = [r["tokens"] for r in res1]

    res_off, _, launches_off, _, _ = asyncio.run(
        other_path(dict(fused_epilogue="off"), wave1))
    if [r["tokens"] for r in res_off] != tokens1:
        raise AssertionError("fused_epilogue='off' streams differ from the "
                             "epilogue kernel's")
    if launches_off["epilogue"]:
        raise AssertionError("fused_epilogue='off' launched the epilogue kernel")

    res_k4, wall_k4, launches_k4, metrics_k4, _ = asyncio.run(
        other_path(dict(multi_step_decode=4), wave1))
    _check_streams(res_k4, NEW_TOKENS)
    if [r["tokens"] for r in res_k4] != tokens1:
        raise AssertionError("multi_step_decode=4 streams differ from K=1")
    _check_launches("burst", launches_k4, ("paged_decode", "epilogue"))

    res_spec, wall_spec, launches_spec, metrics_spec, parted = asyncio.run(
        other_path(SPEC, spec_reqs, SPEC_NEW_TOKENS, spec_base))
    _check_streams(res_spec, SPEC_NEW_TOKENS)
    _check_launches("spec", launches_spec, ("paged_verify",))
    if metrics_spec["spec_proposed"] <= 0:
        raise AssertionError("ngram speculation proposed nothing")

    ttfts = sorted(r["ttft_s"] for r in res1)
    emit("engine", model="Llama-3.2-1B shapes, seeded random bf16 weights",
         config={k: v for k, v in ENGINE.items()}, requests=len(res1) + len(res2),
         new_tokens=NEW_TOKENS, setup_s=setup_s,
         wave1_prompt_tokens=sum(len(p) for p, _ in wave1),
         wave1_wall_s=wall1,
         wave1_output_tokens_per_s=len(res1) * NEW_TOKENS / wall1,
         ttft_s=dict(min=ttfts[0], median=ttfts[len(ttfts) // 2],
                     max=ttfts[-1]),
         peak_memory_bytes=peak, launches=launches, metrics=metrics,
         logits_vs_cpu_f32=logits, card=smi)
    emit("engine_paths",
         unfused=dict(streams_identical=True, launches=launches_off),
         burst=dict(k=4, streams_identical=True, wave1_wall_s=wall_k4,
                    wave1_output_tokens_per_s=len(res_k4) * NEW_TOKENS / wall_k4,
                    decode_steps=metrics_k4["decode_steps"],
                    launches=launches_k4),
         spec=dict(**SPEC, requests=len(spec_reqs), new_tokens=SPEC_NEW_TOKENS,
                   prompt_tokens=sum(len(p) for p, _ in spec_reqs),
                   proposed=metrics_spec["spec_proposed"],
                   accepted=metrics_spec["spec_accepted"],
                   decode_steps=metrics_spec["decode_steps"],
                   wall_s=wall_spec, streams_equal=sum(
                       a["tokens"] == b["tokens"]
                       for a, b in zip(spec_base, res_spec)),
                   parted=parted, launches=launches_spec))
    return dict(paged_decode=launches["paged_decode"],
                paged_flash=launches["paged_flash"],
                sampling_epilogue=launches["epilogue"],
                paged_verify=launches_spec["paged_verify"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from dynamo_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the dynamo_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    torch.cuda.synchronize()

    t0 = time.monotonic()
    seconds = _build.build()
    emit("build", seconds=time.monotonic() - t0, per_kernel=seconds,
         ptxas={n: [ln.strip() for ln in log.splitlines() if "registers" in ln
                    or "spill" in ln] for n, log in _build.build_log.items()})
    torch.cuda.synchronize()

    entries = kernel_phase(torch, dev)
    torch.cuda.synchronize()
    launches = engine_phase(torch, dev, smi)
    torch.cuda.synchronize()

    kernels = []
    for key, entry in entries.items():
        kernels.append(dict(entry, launches=launches[key]))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
