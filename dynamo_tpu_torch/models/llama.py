"""Llama-family decoder over the paged KV cache, in PyTorch.

The port of ``dynamo_tpu/models/llama.py``. Parameters keep the reference's
names and layouts — a dict with ``embed`` [V, D], ``layers`` holding
weights stacked on a leading L axis (``wq`` [L, D, H*hd], ``wk``/``wv``
[L, D, KVH*hd], ``wo`` [L, H*hd, D], ``w_gate``/``w_up`` [L, D, I],
``w_down`` [L, I, D], ``ln1``/``ln2`` [L, D], optional ``bq``/``bk``/``bv``
and ``q_norm``/``k_norm``), ``final_norm`` [D] and, unless the embeddings
are tied, ``lm_head`` [D, V] — so the weight bridge (``models/weights.py``)
is a plain copy. The layer loop is a Python loop that writes the stacked
cache in place at ``layer_idx``; the large projections are plain matmuls,
as the reference leaves them to XLA.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..engine.config import ModelConfig
from ..ops.attention import (
    alloc_kv_cache,
    attention,
    kv_write_plan,
    prefill_attention,
    scatter_kv_rows,
)
from ..ops.transfer import to_device
from ..parallel.sequence import sp_chunk_attention
from .quant import QuantizedWeight, dense, quantize_int8

Params = Dict[str, Any]
KVCache = Tuple[torch.Tensor, torch.Tensor]  # k, v: [L, N_blocks, bs, KVH, D]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Refuse model features outside this slice (Llama-family dense GQA,
    incl. the Qwen2 biases and Qwen3 q/k norms)."""
    unported = []
    if cfg.model_family:
        unported.append(f"model family {cfg.model_family!r}")
    if cfg.num_experts:
        unported.append("mixture-of-experts layers")
    if cfg.kv_lora_rank:
        unported.append("MLA attention")
    if cfg.attn_logit_softcap or cfg.final_logit_softcap:
        unported.append("logit softcapping")
    if unported:
        raise NotImplementedError(
            "not ported to the PyTorch engine yet: " + "; ".join(unported))


def param_keys(cfg: ModelConfig):
    """Per layer group, the keys a Llama-family param tree must hold (the
    Qwen3 q/k norms are optional)."""
    keys = {"ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up", "w_down"}
    if cfg.attention_bias:
        keys |= {"bq", "bk", "bv"}
    return {"layers": keys}


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm computed in f32, returned in x's dtype (as the reference)."""
    dtype = x.dtype
    x = x.float()
    norm = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (norm * weight.float()).to(dtype)


def _yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    if factor <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def rope_frequencies(
    head_dim: int, theta: float, scaling: Optional[dict] = None
) -> Tuple[torch.Tensor, float]:
    """(inverse rope frequencies [hd/2] f32 on the CPU, attention factor)
    with HF ``rope_scaling`` applied: default, "linear", "llama3" and
    "yarn" (DeepSeek-V2/V3: interpolated and extrapolated frequencies
    blended over the beta_fast/beta_slow correction range, and the mscale
    attention factor that cos/sin carry). "longrope" / "su" (Phi-3) gives
    both profiles, [2, hd/2] (``longrope_frequencies``): the row's profile
    is chosen in ``rope_cos_sin``. An unknown type raises."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim)
    )
    if not scaling:
        return inv_freq, 1.0
    kind = scaling.get("rope_type") or scaling.get("type")
    if kind in ("longrope", "su"):
        return longrope_frequencies(head_dim, theta, scaling)
    factor = float(scaling.get("factor", 1.0))
    if kind in (None, "default"):
        return inv_freq, 1.0
    if kind == "linear":
        return inv_freq / factor, 1.0
    if kind == "llama3":
        low = float(scaling.get("low_freq_factor", 1.0))
        high = float(scaling.get("high_freq_factor", 4.0))
        orig = float(scaling.get("original_max_position_embeddings", 8192))
        wavelen = 2.0 * math.pi / inv_freq
        smooth = ((orig / wavelen - low) / (high - low)).clamp(0.0, 1.0)
        scaled = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        return torch.where(
            wavelen < orig / high, inv_freq,            # high freq: keep
            torch.where(wavelen > orig / low, inv_freq / factor, scaled),
        ), 1.0
    if kind == "yarn":
        orig = float(scaling.get("original_max_position_embeddings", 4096))
        beta_fast = float(scaling.get("beta_fast", 32.0))
        beta_slow = float(scaling.get("beta_slow", 1.0))

        def correction_dim(num_rotations: float) -> float:
            return (head_dim / 2.0) * math.log(
                orig / (num_rotations * 2.0 * math.pi)) / math.log(theta)

        low = max(math.floor(correction_dim(beta_fast)), 0)
        # clamped to head_dim - 1, not to the head_dim / 2 frequency count,
        # as transformers does: the ramp's denominator must match or every
        # mid-band blend shifts
        high = min(math.ceil(correction_dim(beta_slow)), head_dim - 1)
        if low == high:
            high += 0.001  # avoid a zero-width ramp
        ramp = ((torch.arange(head_dim // 2, dtype=torch.float32) - low)
                / (high - low)).clamp(0.0, 1.0)
        extrapolation_w = 1.0 - ramp   # high-frequency dims: keep as-is
        inv = (inv_freq / factor) * (1.0 - extrapolation_w) \
            + inv_freq * extrapolation_w
        attention_factor = scaling.get("attention_factor")
        if attention_factor is None:
            mscale = float(scaling.get("mscale") or 0.0)
            mscale_all = float(scaling.get("mscale_all_dim") or 0.0)
            if mscale and mscale_all:
                # DeepSeek: the ratio of the two mscale curves, taken only
                # when both keys are present (transformers'
                # _compute_yarn_parameters); the softmax scale carries the
                # rest (models/deepseek.mla_softmax_scale)
                attention_factor = (_yarn_mscale(factor, mscale)
                                    / _yarn_mscale(factor, mscale_all))
            else:
                attention_factor = _yarn_mscale(factor)
        return inv, float(attention_factor)
    raise NotImplementedError(f"rope_scaling type {kind!r} is not ported yet")


def longrope_frequencies(head_dim: int, theta: float, scaling: dict
                         ) -> Tuple[torch.Tensor, float]:
    """Phi-3 longrope (the reference's ``_longrope_frequencies``,
    transformers' ``_compute_longrope_parameters``): (inverse frequencies
    [2, hd/2] f32 on the CPU, row 0 the short profile ``1 / (short_factor *
    theta^(2i/hd))`` and row 1 the long one; the attention factor
    ``sqrt(1 + ln(factor) / ln(original))`` with ``factor = maxpos /
    original``, or the config's own ``attention_factor``). The attention
    factor rides cos/sin whatever the profile, as HF applies it. A missing
    field raises with the reference's words."""
    missing = [k for k in ("short_factor", "long_factor") if k not in scaling]
    if missing or "original_max_position_embeddings" not in scaling:
        raise ValueError(
            f"longrope rope_scaling needs short_factor/long_factor and "
            f"original_max_position_embeddings (missing: "
            f"{missing + [k for k in ['original_max_position_embeddings'] if k not in scaling]}); "
            "ModelConfig.from_hf_config injects the window fields from "
            "the checkpoint config"
        )
    original = scaling["original_max_position_embeddings"]
    maxpos = scaling.get("max_position_embeddings", original)
    factor = maxpos / original
    attn_factor = scaling.get("attention_factor") or (
        1.0 if factor <= 1.0
        else math.sqrt(1.0 + math.log(factor) / math.log(original)))
    base_pow = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                         / head_dim)
    ext = torch.tensor([scaling["short_factor"], scaling["long_factor"]],
                       dtype=torch.float32)
    return 1.0 / (ext * base_pow), float(attn_factor)


_ROPE_TABLES: Dict[tuple, Tuple[torch.Tensor, float]] = {}


def _rope_table(head_dim: int, theta: float, scaling: Optional[dict], device):
    """``rope_frequencies`` on ``device``, kept per (shape, scaling,
    device): a forward neither recomputes the table nor copies it to the
    card (a blocking copy would stall a dispatch-ahead decode loop)."""
    key = (head_dim, float(theta),
           json.dumps(scaling, sort_keys=True, default=str), str(device))
    hit = _ROPE_TABLES.get(key)
    if hit is None:
        inv_freq, factor = rope_frequencies(head_dim, theta, scaling)
        hit = _ROPE_TABLES[key] = (to_device(inv_freq, device), factor)
    return hit


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling: Optional[dict] = None, seq_basis=None):
    """(cos, sin) [B, S, 1, hd/2] f32 for ``positions`` [B, S] — computed
    once per forward and shared by every layer's q and k.

    Longrope picks each row's profile from ``seq_basis``, the row's covered
    context ([B] tensor, or one int for every row; without it, each row's
    max position + 1): long when ``seq_basis > original``. The choice stays
    on the device (a ``torch.where`` over the cached [2, hd/2] table), so a
    chained burst's carry is never read on the host. A key roped while its
    row was short keeps that rotation as the row grows, as in the reference
    and HF."""
    inv_freq, attn_factor = _rope_table(head_dim, theta, scaling,
                                        positions.device)
    if inv_freq.dim() == 2:  # longrope: [B, 1, hd/2] by each row's profile
        original = scaling["original_max_position_embeddings"]
        if seq_basis is None:
            seq_basis = positions.amax(dim=-1) + 1
        if not isinstance(seq_basis, torch.Tensor):
            inv_freq = inv_freq[1 if int(seq_basis) > original else 0]
        else:
            is_long = (seq_basis > original)[:, None, None]
            inv_freq = torch.where(is_long, inv_freq[1], inv_freq[0])
    angles = positions.float()[..., None] * inv_freq
    cos = torch.cos(angles)[:, :, None, :] * attn_factor
    sin = torch.sin(angles)[:, :, None, :] * attn_factor
    return cos, sin


def apply_rope_cs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                  ) -> torch.Tensor:
    """HF-style half-rotation RoPE of x [B, S, H, D] with precomputed
    (cos, sin), in f32, returned in x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling: Optional[dict] = None, seq_basis=None) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S]. HF-style half-rotation RoPE
    (``seq_basis``: longrope's per-row covered context, ``rope_cos_sin``)."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta, scaling, seq_basis)
    return apply_rope_cs(x, cos, sin)


def normal_slices(shape, fan_in: int, generator: torch.Generator, dtype,
                  device, quantize: bool = False):
    """normal(0, fan_in^-0.5) of ``shape`` in ``dtype`` on ``device``,
    drawn from ``generator`` on the generator's device one leading slice at
    a time, so the f32 transient is one slice: a whole stacked expert leaf
    would not fit in f32 beside the rest of a large model (GPT-OSS-20b's
    ``w_gate_up`` is 12.7 G elements).

    With ``quantize``, each slice is rounded to ``dtype`` and quantized into
    an int8 stack as it is drawn (``quant.quantize_int8``), so the leaf
    never exists whole in ``dtype`` (Mixtral-8x7B is 93 GB in bf16). The
    scale is taken over the in axis only, so the result equals the whole
    ``dtype`` leaf quantized at once."""
    def draw(part_shape):
        return (torch.randn(part_shape, generator=generator,
                            dtype=torch.float32, device=generator.device)
                * fan_in ** -0.5)

    if not quantize:
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in (out if len(shape) > 2 else (out,)):
            part.copy_(draw(part.shape))
        return out
    out = QuantizedWeight(
        torch.empty(shape, dtype=torch.int8, device=device),
        torch.empty((*shape[:-2], shape[-1]), dtype=torch.float32,
                    device=device))
    for i in (range(shape[0]) if len(shape) > 2 else (slice(None),)):
        part = out[i]
        w = quantize_int8(draw(part.shape).to(device=device, dtype=dtype))
        part.q.copy_(w.q)
        part.scale.copy_(w.scale)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """Random-init params with the reference's shapes and layout (tests,
    benchmarks): normal(0, fan_in^-0.5) weights drawn from ``generator``
    on the generator's device, unit norms, zero biases."""
    check_supported(cfg)
    l, d_model = cfg.num_layers, cfg.hidden_size
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    inter = cfg.intermediate_size

    def w(shape, fan_in):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
                * fan_in ** -0.5).to(device=device, dtype=dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "ln1": ones((l, d_model)),
        "wq": w((l, d_model, h * hd), d_model),
        "wk": w((l, d_model, kvh * hd), d_model),
        "wv": w((l, d_model, kvh * hd), d_model),
        "wo": w((l, h * hd, d_model), h * hd),
        "ln2": ones((l, d_model)),
        "w_gate": w((l, d_model, inter), d_model),
        "w_up": w((l, d_model, inter), d_model),
        "w_down": w((l, inter, d_model), inter),
    }
    if cfg.attention_bias:
        for name, width in (("bq", h * hd), ("bk", kvh * hd), ("bv", kvh * hd)):
            layers[name] = torch.zeros((l, width), dtype=dtype, device=device)
    params: Params = {
        "embed": w((cfg.vocab_size, d_model), d_model),
        "layers": layers,
        "final_norm": ones((d_model,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((d_model, cfg.vocab_size), d_model)
    return params


def init_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                  dtype=torch.bfloat16, device="cpu") -> KVCache:
    """Zeroed stacked cache pair [L, N, bs, KVH, head_dim] (unpadded) in
    ``dtype`` (the activation dtype, or ``torch.float8_e4m3fn`` for an fp8
    cache), each with the spare row dropped writes go to
    (``alloc_kv_cache``)."""
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    return (alloc_kv_cache(shape, dtype, device),
            alloc_kv_cache(shape, dtype, device))


def alternating_window(cfg: ModelConfig, li: int) -> Optional[int]:
    """The sliding window of global layer ``li`` for families whose layers
    alternate sliding and full attention starting sliding at layer 0
    (GPT-OSS; the reference's ``alternating_window``): ``cfg.sliding_window``
    on even layers, no window (None) on odd ones and when the family has
    none."""
    return cfg.sliding_window if cfg.sliding_window and li % 2 == 0 else None


def swiglu_mlp(x: torch.Tensor, lp: Params) -> torch.Tensor:
    gate = torch.nn.functional.silu(dense(x, lp["w_gate"]))
    return dense(gate * dense(x, lp["w_up"]), lp["w_down"])


def qkv_prologue(cfg: ModelConfig, x: torch.Tensor, lp: Params, b: int,
                 s: int, cos: torch.Tensor, sin: torch.Tensor):
    """The per-layer QKV head: projections (+ Qwen2 biases), head reshape,
    Qwen3 per-head norms, RoPE."""
    h_heads, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(x, lp["wq"])
    k = dense(x, lp["wk"])
    v = dense(x, lp["wv"])
    if "bq" in lp:  # Qwen2-family qkv biases, pre-rope
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(b, s, h_heads, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if "q_norm" in lp:  # Qwen3-family per-head norms, pre-rope
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    return apply_rope_cs(q, cos, sin), apply_rope_cs(k, cos, sin), v


def run_layers(hidden: torch.Tensor, kv_cache: KVCache, layers: Params,
               cfg: ModelConfig, attn_fn, mlp_fn=swiglu_mlp, li0: int = 0):
    """One stacked group of decoder layers as a Python loop; ``attn_fn(x,
    lp, k_all, v_all, li)`` writes layer ``li`` of the stacked cache in
    place. Families chain groups with different weights (DeepSeek: its
    dense prefix, then its MoE layers) through one cache: ``li0`` is the
    group's first cache layer. Returns (hidden, kv_cache, next_li)."""
    k_all, v_all = kv_cache
    n = next(iter(layers.values())).shape[0]
    for i in range(n):
        lp = {name: w[i] for name, w in layers.items()}
        x = rms_norm(hidden, lp["ln1"], cfg.rms_norm_eps)
        delta, k_all, v_all = attn_fn(x, lp, k_all, v_all, li0 + i)
        hidden = hidden + delta
        x = rms_norm(hidden, lp["ln2"], cfg.rms_norm_eps)
        hidden = hidden + mlp_fn(x, lp)
    return hidden, (k_all, v_all), li0 + n


def make_sp_gqa_attn_fn(cfg: ModelConfig, b: int, s: int, cos, sin, plan,
                        block_tables: torch.Tensor, chunk_start: int,
                        context_len: int, sp: int):
    """The sequence-parallel sibling of ``forward``'s attention: QKV, RoPE
    and the MLP are position-local, attention is one ring pass over the
    chunk's fresh K/V merged with the committed paged prefix
    (``parallel/sequence.sp_chunk_attention``), and the fresh K/V scatter
    into the paged cache as the dense path does. B is 1 by construction:
    one oversized prompt owns the ranks."""
    h_heads, hd = cfg.num_heads, cfg.head_dim

    def attn_fn(x, lp, k_all, v_all, li):
        q, k, v = qkv_prologue(cfg, x, lp, b, s, cos, sin)
        # the prefix is read from the INCOMING cache, before the scatter, as
        # the reference does; the chunk's own slots are masked there anyway
        attn = sp_chunk_attention(q, k, v, k_all, v_all, block_tables,
                                  chunk_start, context_len, li, sp)
        k_all, v_all = scatter_kv_rows(k_all, v_all, k, v, plan, li)
        return dense(attn.reshape(b, s, h_heads * hd), lp["wo"]), k_all, v_all

    return attn_fn


def sp_decoder_forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [1, S] one chunk
    positions: torch.Tensor,     # [1, S] absolute positions (pad → repeat last)
    kv_cache: KVCache,
    block_tables: torch.Tensor,  # [1, W] int32
    slot_mapping: torch.Tensor,  # [1, S] flat cache slot per token; -1 drops
    context_len: int,            # valid tokens incl. this chunk
    chunk_start: int,            # the chunk's first absolute position
    sp: int,
) -> Tuple[torch.Tensor, KVCache]:
    """One sequence-parallel prefill chunk through the GQA trunk. Returns
    (pre-final-norm hidden [1, S, D], the cache, updated in place): the
    engine samples from the last valid position through ``lm_logits``, as
    the dense step does."""
    b, s = tokens.shape
    hidden = params["embed"][tokens.long()]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling, seq_basis=context_len)
    k_all = kv_cache[0]
    plan = kv_write_plan(slot_mapping, k_all.shape[1] * k_all.shape[2])
    attn_fn = make_sp_gqa_attn_fn(cfg, b, s, cos, sin, plan, block_tables,
                                  chunk_start, context_len, sp)
    hidden, kv_cache, _ = run_layers(hidden, kv_cache, params["layers"], cfg,
                                     attn_fn)
    return hidden, kv_cache


def lm_logits(hidden: torch.Tensor, params: Params, cfg: ModelConfig
              ) -> torch.Tensor:
    """Final norm + lm head over any [..., D] slice (tied embeddings read
    ``embed`` transposed)."""
    hidden = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    lm_head = params.get("lm_head")
    if lm_head is None:
        return hidden @ params["embed"].T
    return dense(hidden, lm_head)


def embed_forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,      # [R, S] right-padded prompt rows
    positions: torch.Tensor,   # [R, S] (pad → repeat last)
    valid_lens: torch.Tensor,  # [R] real tokens per row
) -> torch.Tensor:
    """Prefill-only trunk for the embeddings workload: dense causal
    self-attention with NO cache reads or writes (the whole context is the
    prompt; nothing decodes afterwards), the final norm, and the LAST valid
    position's hidden state as the sequence embedding, the standard
    decoder-LM pooling. The engine L2-normalizes at the edge. Returns
    [R, D] float32."""
    b, s = tokens.shape
    h_heads, hd = cfg.num_heads, cfg.head_dim
    hidden = params["embed"][tokens.long()]
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta, cfg.rope_scaling,
                            seq_basis=valid_lens)

    def attn_fn(x, lp, k_all, v_all, li):
        q, k, v = qkv_prologue(cfg, x, lp, b, s, cos, sin)
        attn = prefill_attention(q, k, v, valid_lens)
        return dense(attn.reshape(b, s, h_heads * hd), lp["wo"]), k_all, v_all

    hidden, _, _ = run_layers(hidden, (None, None), params["layers"], cfg,
                              attn_fn)
    hidden = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    rows = torch.arange(b, device=hidden.device)
    return hidden[rows, valid_lens.long() - 1].float()


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B, S]
    positions: torch.Tensor,     # [B, S] absolute positions (pad → repeat last)
    kv_cache: KVCache,
    block_tables: torch.Tensor,  # [B, W]
    slot_mapping: torch.Tensor,  # [B, S] flat cache slot per token; -1 drops
    context_lens: torch.Tensor,  # [B] valid tokens incl. the ones being written
    return_hidden: bool = False,
    mlp_fn=swiglu_mlp,
) -> Tuple[torch.Tensor, KVCache]:
    """Embed → layers (RoPE, paged-KV scatter, GQA attention, ``mlp_fn``:
    SwiGLU, or the Mixtral family's routed experts) → logits [B, S, V], or
    the pre-final-norm hidden [B, S, D] with ``return_hidden``. The cache
    tensors are updated in place and also returned."""
    b, s = tokens.shape
    h_heads, hd = cfg.num_heads, cfg.head_dim
    hidden = params["embed"][tokens.long()]
    # longrope's per-row profile: the context lengths the kernels read
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta, cfg.rope_scaling,
                            seq_basis=context_lens)
    k_all, v_all = kv_cache
    plan = kv_write_plan(slot_mapping, k_all.shape[1] * k_all.shape[2])
    window = cfg.sliding_window or None

    def attn_fn(x, lp, k_all, v_all, li):
        q, k, v = qkv_prologue(cfg, x, lp, b, s, cos, sin)
        k_all, v_all = scatter_kv_rows(k_all, v_all, k, v, plan, li)
        attn = attention(q, k_all, v_all, block_tables, positions,
                         context_lens, layer_idx=li, sliding_window=window)
        return dense(attn.reshape(b, s, h_heads * hd), lp["wo"]), k_all, v_all

    hidden, kv_cache, _ = run_layers(hidden, kv_cache, params["layers"], cfg,
                                     attn_fn, mlp_fn)
    if return_hidden:
        return hidden, kv_cache
    return lm_logits(hidden, params, cfg), kv_cache
