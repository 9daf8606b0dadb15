"""DeepSeek-class decoder with Multi-head Latent Attention (MLA), in
PyTorch.

The port of ``dynamo_tpu/models/deepseek.py``. Each token's KV state is a
low-rank latent ``c_kv`` (kv_lora_rank wide) plus one shared RoPE key
(qk_rope_head_dim wide); the paged cache stores only those two vectors per
token. Attention runs in the absorbed form, reading the compressed cache
directly:

    score(q, t) = (q_nope W_uk) . c_kv[t] + q_rope . k_rope[t]
    out_latent  = softmax(score) @ c_kv   ->  o = out_latent W_uv W_o

The trunk: ``first_k_dense_replace`` dense-prefix layers with a SwiGLU at
``intermediate_size``, then MoE layers with routed experts at
``moe_intermediate_size`` plus ``n_shared_experts`` always-on shared
experts (``models/mixtral.make_moe_mlp_fn``); both groups chain through
one stacked cache (``llama.run_layers`` with ``li0``).

Attention routes on the tensors' device (``mla_attention``): on a card,
single-token decode (S = 1) launches the MLA decode kernel
(``ops/mla_decode.py``, ``csrc/mla_decode.cu``), which indexes the layer
in place. Every S > 1 shape (prefill chunks, the speculative verify) runs
the dense gather formulation ``mla_paged_attention`` as plain PyTorch
einsums, on the card as on the CPU: that is the reference's own route for
those shapes, which it computes in XLA with no Pallas kernel — so it is
the port of that path, not a fallback. CPU tensors take the gather
formulation for every S, as the reference's XLA route does.

The caches are unpadded, [L, N, bs, 1, R] and [L, N, bs, 1, RD]: the
reference pads R and RD to 128 lanes for its TPU page DMA (at RD = 64 the
rope cache would be half padding).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..engine.config import ModelConfig
from ..ops.attention import (
    alloc_kv_cache,
    gather_pages,
    kv_write_plan,
    scatter_kv_rows,
)
from .llama import (  # lm_logits: the final norm + head, as the runner reads it
    Params,
    apply_rope_cs,
    lm_logits,
    normal_slices,
    rms_norm,
    rope_cos_sin,
    run_layers,
    swiglu_mlp,
)
from .llama import _yarn_mscale
from .mixtral import make_moe_mlp_fn
from .quant import dense

KVCache = Tuple[torch.Tensor, torch.Tensor]  # (latent c_kv, shared k_rope)


def check_supported(cfg: ModelConfig) -> None:
    """Refuse the features of DeepSeek-class configs this slice does not
    serve (the MLA + routed-MoE trunk with yarn rope is served)."""
    unported = []
    if cfg.model_family:
        unported.append(f"model family {cfg.model_family!r}")
    if cfg.attn_logit_softcap or cfg.final_logit_softcap:
        unported.append("logit softcapping")
    if cfg.sliding_window:
        unported.append("sliding-window attention")
    if cfg.attention_bias:
        unported.append("attention biases")
    if unported:
        raise NotImplementedError(
            "not ported to the PyTorch engine yet: " + "; ".join(unported))


def _split_layer_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(dense-prefix layers, MoE layers)."""
    if cfg.num_experts <= 0:
        return cfg.num_layers, 0
    k = min(cfg.first_k_dense_replace, cfg.num_layers)
    return k, cfg.num_layers - k


def _attn_keys(cfg: ModelConfig):
    base = {"ln1", "w_dkv", "ln_kv", "w_kr", "w_uk", "w_uv", "wo", "ln2"}
    return base | ({"w_dq", "ln_q", "w_uq"} if cfg.q_lora_rank > 0 else {"wq"})


def param_keys(cfg: ModelConfig) -> Dict[str, set]:
    """Per layer group, the keys a DeepSeek param tree must hold."""
    n_dense, n_moe = _split_layer_counts(cfg)
    groups = {}
    if n_dense:
        groups["dense_layers"] = _attn_keys(cfg) | {"w_gate", "w_up", "w_down"}
    if n_moe:
        moe = _attn_keys(cfg) | {"router", "w_gate", "w_up", "w_down"}
        if cfg.n_shared_experts > 0:
            moe |= {"w_sh_gate", "w_sh_up", "w_sh_down"}
        groups["layers"] = moe
    return groups


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """Random-init params with the reference's shapes and names:
    normal(0, fan_in^-0.5) weights drawn from ``generator`` on the
    generator's device, unit norms. Stacked weights are drawn one layer
    (and one expert stack) at a time, so the f32 transient is one slice:
    at DeepSeek-V2-Lite's widths the 26-layer expert stacks would be
    19 GB in f32."""
    check_supported(cfg)
    d_model, h = cfg.hidden_size, cfg.num_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    inter = cfg.intermediate_size
    moe_inter = cfg.moe_intermediate_size or inter
    e = cfg.num_experts
    n_dense, n_moe = _split_layer_counts(cfg)

    def w(shape, fan_in):
        return normal_slices(shape, fan_in, generator, dtype, device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def attn(l):
        out = {
            "ln1": ones((l, d_model)),
            "w_dkv": w((l, d_model, r), d_model),
            "ln_kv": ones((l, r)),
            "w_kr": w((l, d_model, rope), d_model),
            "w_uk": w((l, r, h, nope), r),
            "w_uv": w((l, r, h, vd), r),
            "wo": w((l, h * vd, d_model), h * vd),
            "ln2": ones((l, d_model)),
        }
        if qr > 0:
            out["w_dq"] = w((l, d_model, qr), d_model)
            out["ln_q"] = ones((l, qr))
            out["w_uq"] = w((l, qr, h * (nope + rope)), qr)
        else:
            out["wq"] = w((l, d_model, h * (nope + rope)), d_model)
        return out

    params: Params = {
        "embed": w((cfg.vocab_size, d_model), d_model),
        "final_norm": ones((d_model,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((d_model, cfg.vocab_size), d_model)
    if n_dense > 0:
        group = attn(n_dense)
        group["w_gate"] = w((n_dense, d_model, inter), d_model)
        group["w_up"] = w((n_dense, d_model, inter), d_model)
        group["w_down"] = w((n_dense, inter, d_model), inter)
        params["dense_layers"] = group
    if n_moe > 0:
        moe = attn(n_moe)
        moe["router"] = w((n_moe, d_model, e), d_model)
        moe["w_gate"] = w((n_moe, e, d_model, moe_inter), d_model)
        moe["w_up"] = w((n_moe, e, d_model, moe_inter), d_model)
        moe["w_down"] = w((n_moe, e, moe_inter, d_model), moe_inter)
        if cfg.n_shared_experts > 0:
            sh = cfg.n_shared_experts * moe_inter
            moe["w_sh_gate"] = w((n_moe, d_model, sh), d_model)
            moe["w_sh_up"] = w((n_moe, d_model, sh), d_model)
            moe["w_sh_down"] = w((n_moe, sh, d_model), sh)
        params["layers"] = moe
    return params


def init_kv_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                  dtype=torch.bfloat16, device="cpu") -> KVCache:
    """Zeroed compressed cache: c_kv [L, N, bs, 1, R] and k_rope
    [L, N, bs, 1, RD], unpadded, both in ``dtype`` (the activation dtype,
    or ``torch.float8_e4m3fn`` for an fp8 cache)."""
    lead = (cfg.num_layers, num_blocks, block_size, 1)
    return (alloc_kv_cache(lead + (cfg.kv_lora_rank,), dtype, device),
            alloc_kv_cache(lead + (cfg.qk_rope_head_dim,), dtype, device))


def mla_paged_attention(
    q_lat: torch.Tensor,         # [B, S, H, R] queries absorbed into latent space
    q_rope: torch.Tensor,        # [B, S, H, RD] post-RoPE decoupled queries
    c_cache: torch.Tensor,       # [N, bs, 1, R]
    kr_cache: torch.Tensor,      # [N, bs, 1, RD]
    block_tables: torch.Tensor,  # [B, W]
    q_positions: torch.Tensor,   # [B, S]
    context_lens: torch.Tensor,  # [B]
    scale: float,
) -> torch.Tensor:
    """The dense gather formulation over the compressed cache; returns the
    latent output [B, S, H, R]. Query at position p sees keys j <= p and
    j < context_len."""
    b, s, h, r = q_lat.shape
    _, block_size, _, rd = kr_cache.shape
    t = block_tables.shape[1] * block_size
    bt = block_tables.long()
    # upcast from the cache storage dtype (an fp8 cache is gathered
    # through its bytes: gather_pages)
    c = gather_pages(c_cache, bt).reshape(b, t, r).to(q_lat.dtype)
    kr = gather_pages(kr_cache, bt).reshape(b, t, rd).to(q_lat.dtype)
    scores = (torch.einsum("bshr,btr->bsht", q_lat, c)
              + torch.einsum("bshd,btd->bsht", q_rope, kr)) * scale
    key_pos = torch.arange(t, device=q_lat.device)[None, None, :]
    mask = (key_pos <= q_positions.long()[:, :, None]) & (
        key_pos < context_lens.long()[:, None, None])
    scores = torch.where(mask[:, :, None, :], scores,
                         torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q_lat.dtype)
    return torch.einsum("bsht,btr->bshr", probs, c)


def mla_attention(q_lat, q_rope, c_all, kr_all, li: int, block_tables,
                  positions, context_lens, scale: float) -> torch.Tensor:
    """MLA attention over the stacked compressed caches, keyed on the
    tensors' device: on a card, S == 1 launches the MLA decode kernel
    (which indexes layer ``li`` in place and assumes the query sits at
    ``context_lens - 1``, the scheduler's layout); every other case runs
    the gather formulation with the layer indexed through the gather
    (block n of layer li is flat row li*N + n, so no per-layer slice of
    the cache is copied)."""
    if q_lat.device.type == "cuda" and q_lat.shape[1] == 1:
        from ..ops.mla_decode import mla_paged_decode_attention

        return mla_paged_decode_attention(
            q_lat.contiguous(), q_rope.contiguous(), c_all, kr_all,
            block_tables, context_lens, layer_idx=li, scale=scale)
    l, n_blocks = c_all.shape[:2]
    c_flat = c_all.reshape((l * n_blocks,) + c_all.shape[2:])
    kr_flat = kr_all.reshape((l * n_blocks,) + kr_all.shape[2:])
    return mla_paged_attention(
        q_lat, q_rope, c_flat, kr_flat, block_tables.long() + li * n_blocks,
        positions, context_lens, scale)


def mla_softmax_scale(cfg: ModelConfig) -> float:
    """The MLA softmax scale, with DeepSeek's yarn mscale: under yarn with
    ``mscale_all_dim`` the scale carries mscale_all_dim^2 over the WHOLE
    score (nope + rope), while the rope part's cos/sin carry the
    mscale / mscale_all_dim ratio (``llama.rope_frequencies``), as in
    DeepSeek's own modeling code. For DeepSeek-V2-Lite (factor 40, both
    mscales 0.707): 192^-0.5 * 1.2608^2 = 0.11472, cos/sin factor 1.0."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    sc = cfg.rope_scaling or {}
    if (sc.get("rope_type") or sc.get("type")) == "yarn":
        mscale_all = float(sc.get("mscale_all_dim") or 0.0)
        if mscale_all:
            m = _yarn_mscale(float(sc.get("factor", 1.0)), mscale_all)
            scale = scale * m * m
    return scale


def make_mla_attn_fn(cfg: ModelConfig, b: int, s: int, positions,
                     slot_mapping, block_tables, context_lens):
    """The MLA attention block for ``llama.run_layers``. The rope table of
    the decoupled dims and the cache write plan are computed once per
    forward and shared by every layer."""
    h = cfg.num_heads
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    scale = mla_softmax_scale(cfg)
    cos, sin = rope_cos_sin(positions, rope_d, cfg.rope_theta, cfg.rope_scaling)
    plan = None

    def attn_fn(x, lp, c_all, kr_all, li):
        nonlocal plan
        if plan is None:
            plan = kv_write_plan(slot_mapping, c_all.shape[1] * c_all.shape[2])
        if "w_uq" in lp:  # the query low-rank bottleneck (q_lora_rank > 0)
            cq = rms_norm(dense(x, lp["w_dq"]), lp["ln_q"], cfg.rms_norm_eps)
            qfull = dense(cq, lp["w_uq"]).reshape(b, s, h, nope + rope_d)
        else:
            qfull = dense(x, lp["wq"]).reshape(b, s, h, nope + rope_d)
        q_nope, q_rope = qfull[..., :nope], qfull[..., nope:]
        q_rope = apply_rope_cs(q_rope, cos, sin)

        # compressed KV state of the new tokens, written into layer li
        c_kv = rms_norm(dense(x, lp["w_dkv"]), lp["ln_kv"], cfg.rms_norm_eps)
        kr = apply_rope_cs((x @ lp["w_kr"])[:, :, None, :], cos, sin)
        c_all, kr_all = scatter_kv_rows(c_all, kr_all, c_kv[:, :, None, :], kr,
                                        plan, li)

        # absorb W_uk into the query, attend over the latent cache
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, lp["w_uk"])
        o_lat = mla_attention(q_lat, q_rope, c_all, kr_all, li, block_tables,
                              positions, context_lens, scale)
        o = torch.einsum("bshr,rhv->bshv", o_lat, lp["w_uv"])
        return dense(o.reshape(b, s, -1), lp["wo"]), c_all, kr_all

    return attn_fn


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # [B, S]
    positions: torch.Tensor,     # [B, S]
    kv_cache: KVCache,
    block_tables: torch.Tensor,  # [B, W]
    slot_mapping: torch.Tensor,  # [B, S] flat cache slot per token; -1 drops
    context_lens: torch.Tensor,  # [B]
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """Embed → dense-prefix layers → MoE layers → logits [B, S, V] (or the
    pre-final-norm hidden [B, S, D] with ``return_hidden``). The layer
    index carries across the two groups: the MoE group writes cache layers
    ``first_k_dense_replace`` and up, never over the dense prefix's. The
    caches are updated in place and also returned."""
    b, s = tokens.shape
    hidden = params["embed"][tokens.long()]
    attn_fn = make_mla_attn_fn(cfg, b, s, positions, slot_mapping,
                               block_tables, context_lens)
    li = 0
    if "dense_layers" in params:
        hidden, kv_cache, li = run_layers(hidden, kv_cache, params["dense_layers"],
                                          cfg, attn_fn, swiglu_mlp, li0=li)
    if "layers" in params:  # present iff the config is MoE
        hidden, kv_cache, li = run_layers(
            hidden, kv_cache, params["layers"], cfg, attn_fn,
            make_moe_mlp_fn(cfg, b, s, slot_mapping), li0=li)
    if return_hidden:
        return hidden, kv_cache
    return lm_logits(hidden, params, cfg), kv_cache
