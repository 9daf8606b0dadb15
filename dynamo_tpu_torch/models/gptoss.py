"""GPT-OSS family: a routed-MoE trunk with attention sinks, biased
attention projections and alternating sliding-window attention, in PyTorch.

The port of ``dynamo_tpu/models/gptoss.py``. Deltas from the Llama trunk
(``models/llama.py``), as the reference computes them:

- every attention projection has a bias, the output projection's too;
- a learned logit per query head (``sinks``) joins that head's softmax as
  a virtual key with no value: only the denominator grows. On a card the
  decode, verify and flash kernels take it (``ops/attention.attention``);
- EVEN layers see only a sliding window of the cache, odd layers all of it
  (``llama.alternating_window``; the config parse enforces the
  alternation);
- yarn rope (θ 150,000, factor 32 on gpt-oss-20b), its attention factor on
  cos/sin;
- routed experts with a biased router and clamped GLU experts over one
  interleaved gate/up projection (``mixtral.gptoss_moe``), through the
  same dense dispatch and capacity as the other MoE trunks.

Parameters keep the reference's names and layouts, so the weight bridge is
a plain copy: ``layers`` holds ``ln1``, ``wq``/``bq``, ``wk``/``bk``,
``wv``/``bv``, ``wo``/``bo``, ``sinks`` [L, H], ``ln2``, ``router``
[L, D, E], ``router_bias`` [L, E], ``w_gate_up`` [L, E, D, 2I],
``b_gate_up`` [L, E, 2I], ``w_down`` [L, E, I, D] and ``b_down`` [L, E, D].
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..engine.config import ModelConfig
from ..ops.attention import attention, kv_write_plan, scatter_kv_rows
from .llama import (  # the cache layout and the final norm + head are llama's
    Params,
    alternating_window,
    init_kv_cache,
    lm_logits,
    normal_slices,
    qkv_prologue,
    rope_cos_sin,
    run_layers,
)
from .mixtral import expert_capacity, gptoss_moe
from .quant import dense

KVCache = Tuple[torch.Tensor, torch.Tensor]

_LAYER_KEYS = {"ln1", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "sinks",
               "ln2", "router", "router_bias", "w_gate_up", "b_gate_up",
               "w_down", "b_down"}


def check_supported(cfg: ModelConfig) -> None:
    """Refuse configs this family module does not serve."""
    unported = []
    if cfg.model_family != "gptoss":
        unported.append(f"model family {cfg.model_family!r} (not gptoss)")
    if cfg.num_experts <= 0:
        unported.append("a GPT-OSS trunk without routed experts")
    if cfg.kv_lora_rank:
        unported.append("MLA attention")
    if cfg.attn_logit_softcap or cfg.final_logit_softcap:
        unported.append("logit softcapping")
    if unported:
        raise NotImplementedError(
            "not served by the GPT-OSS family: " + "; ".join(unported))


def param_keys(cfg: ModelConfig) -> Dict[str, set]:
    """Per layer group, the keys a GPT-OSS param tree must hold."""
    return {"layers": set(_LAYER_KEYS)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """Random-init params with the reference's shapes and names:
    normal(0, fan_in^-0.5) weights drawn from ``generator`` slice by slice
    (``llama.normal_slices``), unit norms, zero biases and sinks (as the
    reference inits them)."""
    check_supported(cfg)
    l, d_model = cfg.num_layers, cfg.hidden_size
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    e, inter = cfg.num_experts, cfg.intermediate_size

    def w(shape, fan_in):
        return normal_slices(shape, fan_in, generator, dtype, device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    params: Params = {
        "embed": w((cfg.vocab_size, d_model), d_model),
        "layers": {
            "ln1": ones((l, d_model)),
            "wq": w((l, d_model, h * hd), d_model),
            "bq": zeros((l, h * hd)),
            "wk": w((l, d_model, kvh * hd), d_model),
            "bk": zeros((l, kvh * hd)),
            "wv": w((l, d_model, kvh * hd), d_model),
            "bv": zeros((l, kvh * hd)),
            "wo": w((l, h * hd, d_model), h * hd),
            "bo": zeros((l, d_model)),
            "sinks": zeros((l, h)),
            "ln2": ones((l, d_model)),
            "router": w((l, d_model, e), d_model),
            "router_bias": zeros((l, e)),
            "w_gate_up": w((l, e, d_model, 2 * inter), d_model),
            "b_gate_up": zeros((l, e, 2 * inter)),
            "w_down": w((l, e, inter, d_model), inter),
            "b_down": zeros((l, e, d_model)),
        },
        "final_norm": ones((d_model,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((d_model, cfg.vocab_size), d_model)
    return params


def make_mlp_fn(cfg: ModelConfig, b: int, s: int, slot_mapping: torch.Tensor):
    """The routed-experts ``mlp_fn`` for ``llama.run_layers``: capacity from
    the padded token count ``b * s`` and validity from ``slot_mapping >=
    0``, as in the reference (gpt-oss-20b at a decode batch of 8 holds
    ``int(8 * 4 * 2 / 32) = 2`` tokens an expert)."""
    capacity = expert_capacity(b * s, cfg.num_experts, cfg.num_experts_per_tok,
                               cfg.moe_capacity_factor)
    valid = (slot_mapping.reshape(b * s) >= 0).float()

    def mlp(x: torch.Tensor, lp) -> torch.Tensor:
        return gptoss_moe(
            x.reshape(b * s, -1), lp["router"], lp["router_bias"],
            lp["w_gate_up"], lp["b_gate_up"], lp["w_down"], lp["b_down"],
            cfg.num_experts_per_tok, capacity, valid=valid,
        ).reshape(b, s, -1)

    return mlp


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
) -> Tuple[torch.Tensor, KVCache]:
    """Embed → layers (biased QKV, yarn RoPE, paged-KV scatter, attention
    with sinks over the layer's window, biased O; routed GLU experts) →
    logits [B, S, V], or the pre-final-norm hidden [B, S, D] with
    ``return_hidden``. The cache tensors are updated in place and also
    returned."""
    b, s = tokens.shape
    h_heads, hd = cfg.num_heads, cfg.head_dim
    hidden = params["embed"][tokens.long()]
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta, cfg.rope_scaling)
    k_all = kv_cache[0]
    plan = kv_write_plan(slot_mapping, k_all.shape[1] * k_all.shape[2])

    def attn_fn(x, lp, k_all, v_all, li):
        q, k, v = qkv_prologue(cfg, x, lp, b, s, cos, sin)  # + bq, bk, bv
        k_all, v_all = scatter_kv_rows(k_all, v_all, k, v, plan, li)
        attn = attention(q, k_all, v_all, block_tables, positions,
                         context_lens, layer_idx=li,
                         sliding_window=alternating_window(cfg, li),
                         sinks=lp["sinks"])
        delta = dense(attn.reshape(b, s, h_heads * hd), lp["wo"]) + lp["bo"]
        return delta, k_all, v_all

    hidden, kv_cache, _ = run_layers(hidden, kv_cache, params["layers"], cfg,
                                     attn_fn, make_mlp_fn(cfg, b, s, slot_mapping))
    if return_hidden:
        return hidden, kv_cache
    return lm_logits(hidden, params, cfg), kv_cache
