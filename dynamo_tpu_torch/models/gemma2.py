"""Gemma-2 family: sandwich norms, GeGLU, softcapped and alternating
sliding-window attention, tied embeddings, in PyTorch.

The port of ``dynamo_tpu/models/gemma2.py``. Deltas from the Llama trunk
(``models/llama.py``), as the reference computes them:

- embeddings scaled by sqrt(hidden_size), the factor cast to the
  activation dtype first (HF's ``normalizer``: 59.87 is 59.75 in bf16);
- RMSNorm in f32, multiplied by ``1 + weight``;
- four norms a layer: before and after attention, before and after the
  MLP; the post norms apply to each block's OUTPUT before the residual add;
- GeGLU MLP (tanh-approximated gelu on the gate);
- attention scaled by ``query_pre_attn_scalar ** -0.5`` with the logit
  softcap ``cap * tanh(score / cap)``; EVEN layers see only a sliding
  window of the cache (``llama.alternating_window``). On a card the
  decode, verify and flash kernels take both (``ops/attention.attention``);
- logits through the tied embedding (or ``lm_head`` when a tree has one)
  and the final softcap.

Parameters keep the reference's names and layouts, so the weight bridge is
a plain copy: ``layers`` holds ``ln1``, ``wq`` [L, D, H*hd], ``wk`` /
``wv`` [L, D, KVH*hd], ``wo`` [L, H*hd, D], ``ln_post_attn``,
``ln_pre_mlp``, ``w_gate`` / ``w_up`` [L, D, I], ``w_down`` [L, I, D] and
``ln_post_mlp`` (each norm [L, D]); beside them ``embed`` [V, D] and
``final_norm`` [D].
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..engine.config import ModelConfig
from ..ops.attention import attention, kv_write_plan, scatter_kv_rows
from .llama import (  # the cache layout and the rope tables are llama's
    Params,
    alternating_window,
    apply_rope_cs,
    init_kv_cache,
    normal_slices,
    rope_cos_sin,
)
from .quant import dense

KVCache = Tuple[torch.Tensor, torch.Tensor]

_LAYER_KEYS = {"ln1", "wq", "wk", "wv", "wo", "ln_post_attn", "ln_pre_mlp",
               "w_gate", "w_up", "w_down", "ln_post_mlp"}


def check_supported(cfg: ModelConfig) -> None:
    """Refuse configs this family module does not serve."""
    unported = []
    if cfg.model_family != "gemma2":
        unported.append(f"model family {cfg.model_family!r} (not gemma2)")
    if cfg.num_experts:
        unported.append("mixture-of-experts layers")
    if cfg.kv_lora_rank:
        unported.append("MLA attention")
    if cfg.attention_bias:
        unported.append("attention biases")
    if unported:
        raise NotImplementedError(
            "not served by the Gemma-2 family: " + "; ".join(unported))


def param_keys(cfg: ModelConfig) -> Dict[str, set]:
    """Per layer group, the keys a Gemma-2 param tree must hold."""
    return {"layers": set(_LAYER_KEYS)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """Random-init params with the reference's shapes and names:
    normal(0, fan_in^-0.5) weights drawn from ``generator`` slice by slice
    (``llama.normal_slices``) and zero norms, as the reference inits them
    (the ``1 + w`` form makes 0 the identity); no ``lm_head``: the family
    reads the embedding unless a tree holds one, whatever the config's tie
    flag, as the reference does."""
    check_supported(cfg)
    l, d_model = cfg.num_layers, cfg.hidden_size
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    inter = cfg.intermediate_size

    def w(shape, fan_in):
        return normal_slices(shape, fan_in, generator, dtype, device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "embed": w((cfg.vocab_size, d_model), d_model),
        "layers": {
            "ln1": zeros((l, d_model)),
            "wq": w((l, d_model, h * hd), d_model),
            "wk": w((l, d_model, kvh * hd), d_model),
            "wv": w((l, d_model, kvh * hd), d_model),
            "wo": w((l, h * hd, d_model), h * hd),
            "ln_post_attn": zeros((l, d_model)),
            "ln_pre_mlp": zeros((l, d_model)),
            "w_gate": w((l, d_model, inter), d_model),
            "w_up": w((l, d_model, inter), d_model),
            "w_down": w((l, inter, d_model), inter),
            "ln_post_mlp": zeros((l, d_model)),
        },
        "final_norm": zeros((d_model,)),
    }


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma RMSNorm: f32 compute, multiplied by ``1 + weight``, returned in
    x's dtype."""
    x32 = x.float()
    n = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (n * (1.0 + weight.float())).to(x.dtype)


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding rows scaled by sqrt(hidden_size), the factor rounded to
    the embedding's dtype first, as the reference (and HF) do."""
    hidden = params["embed"][tokens.long()]
    scale = torch.tensor(math.sqrt(hidden.shape[-1]), dtype=hidden.dtype)
    return hidden * scale.item()


def mlp(x: torch.Tensor, lp: Params) -> torch.Tensor:
    """GeGLU: tanh-approximated gelu on the gate."""
    gate = torch.nn.functional.gelu(dense(x, lp["w_gate"]), approximate="tanh")
    return dense(gate * dense(x, lp["w_up"]), lp["w_down"])


def run_layers(hidden: torch.Tensor, kv_cache: KVCache, layers: Params,
               cfg: ModelConfig, attn_fn) -> Tuple[torch.Tensor, KVCache]:
    """The sandwich-norm layer loop: pre and post norms around both the
    attention and the MLP block, the post norms on the block's output
    before the residual add (the reference's ``run_layers``)."""
    eps = cfg.rms_norm_eps
    k_all, v_all = kv_cache
    n = next(iter(layers.values())).shape[0]
    for li in range(n):
        lp = {name: w[li] for name, w in layers.items()}
        x = rms_norm(hidden, lp["ln1"], eps)
        delta, k_all, v_all = attn_fn(x, lp, k_all, v_all, li)
        hidden = hidden + rms_norm(delta, lp["ln_post_attn"], eps)
        x = rms_norm(hidden, lp["ln_pre_mlp"], eps)
        hidden = hidden + rms_norm(mlp(x, lp), lp["ln_post_mlp"], eps)
    return hidden, (k_all, v_all)


def lm_logits(hidden: torch.Tensor, params: Params, cfg: ModelConfig
              ) -> torch.Tensor:
    """Final ``1 + w`` norm, the tied head (or ``lm_head`` when the tree
    has one) and the final softcap, over any [..., D] slice."""
    hidden = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    lm_head = params.get("lm_head")
    logits = (hidden @ params["embed"].T if lm_head is None
              else dense(hidden, lm_head))
    cap = cfg.final_logit_softcap
    if cap:
        logits = cap * torch.tanh(logits / cap)
    return logits


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
    """Embed (scaled) → sandwich layers (QKV, RoPE, paged-KV scatter,
    softcapped attention over the layer's window, O; GeGLU) → logits
    [B, S, V], or the pre-final-norm hidden [B, S, D] with
    ``return_hidden``. The cache tensors are updated in place and also
    returned."""
    b, s = tokens.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = (cfg.query_pre_attn_scalar or hd) ** -0.5
    hidden = embed_tokens(params, tokens)
    # plain rope: the reference passes no scaling for this family
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta, None)
    k_all = kv_cache[0]
    plan = kv_write_plan(slot_mapping, k_all.shape[1] * k_all.shape[2])

    def attn_fn(x, lp, k_all, v_all, li):
        q = apply_rope_cs(dense(x, lp["wq"]).reshape(b, s, h, hd), cos, sin)
        k = apply_rope_cs(dense(x, lp["wk"]).reshape(b, s, kvh, hd), cos, sin)
        v = dense(x, lp["wv"]).reshape(b, s, kvh, hd)
        k_all, v_all = scatter_kv_rows(k_all, v_all, k, v, plan, li)
        attn = attention(q, k_all, v_all, block_tables, positions,
                         context_lens, layer_idx=li, scale=scale,
                         softcap=cfg.attn_logit_softcap,
                         sliding_window=alternating_window(cfg, li))
        return dense(attn.reshape(b, s, h * hd), lp["wo"]), k_all, v_all

    hidden, kv_cache = run_layers(hidden, kv_cache, params["layers"], cfg,
                                  attn_fn)
    if return_hidden:
        return hidden, kv_cache
    return lm_logits(hidden, params, cfg), kv_cache
