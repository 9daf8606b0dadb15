"""The Mixtral / Qwen3-MoE family and top-k routed mixture of experts, in
PyTorch.

The port of ``dynamo_tpu/models/mixtral.py``:

- the family surface (``check_supported``, ``param_keys``, ``init_params``,
  ``init_kv_cache``, ``forward``, ``lm_logits``): the Llama trunk
  (``models/llama.py``: GQA, RoPE, the paged KV cache, the decode, verify
  and flash kernels on a card; Qwen3's per-head q/k norms when the tree
  holds them) with the routed experts as its MLP;
- the routed-MoE part shared with DeepSeek and GPT-OSS:
  ``expert_capacity``, ``_dispatch_combine``, ``moe_mlp`` and
  ``make_moe_mlp_fn`` (with DeepSeek's always-on shared experts), and
  ``gptoss_moe`` (GPT-OSS's biased router and clamped GLU experts).

The reference's dense (GShard/Switch) formulation is kept: routing gives
every (token, expert) pair a queue position, tokens past an expert's
capacity are dropped for that expert (their residual stream still flows),
and the expert products are batched matmuls over [E, C, D], as XLA
computes them in the reference (``quant.expert_bmm``: int8 stacks too).
Expert parallelism (``ep_axis``) belongs to a later slice.

Parameters keep the reference's names and layouts: ``layers`` holds
``ln1``, ``wq`` [L, D, H*hd], ``wk`` / ``wv`` [L, D, KVH*hd], ``wo``
[L, H*hd, D], ``ln2``, ``router`` [L, D, E], ``w_gate`` / ``w_up``
[L, E, D, I] and ``w_down`` [L, E, I, D], with optional ``q_norm`` /
``k_norm`` [L, hd] (Qwen3-MoE, from a checkpoint) and ``bq`` / ``bk`` /
``bv``; beside them ``embed`` [V, D], ``final_norm`` [D] and, unless the
embeddings are tied, ``lm_head`` [D, V].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..engine.config import ModelConfig
from . import llama
from .llama import Params, init_kv_cache, lm_logits, normal_slices  # noqa: F401
from .quant import QUANT_KEYS, dense, expert_bmm

KVCache = Tuple[torch.Tensor, torch.Tensor]


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float = 2.0) -> int:
    """Per-expert slot count C. At factor 1.0 a perfectly balanced router
    drops nothing; headroom absorbs imbalance."""
    return max(1, int(num_tokens * top_k * capacity_factor / num_experts))


def _dispatch_combine(gate_vals: torch.Tensor, gate_idx: torch.Tensor, e: int,
                      capacity: int, valid: Optional[torch.Tensor]):
    """The reference's token-major slot assignment: one-hot the expert
    choices, queue (token, k) pairs per expert in token-major then k order
    with a cumsum, drop past ``capacity``, and return the [T, E, C]
    dispatch (0/1) and combine (gate-weighted) tensors in f32. Pad tokens
    (``valid == 0``) claim no slots and contribute nothing.

    The reference builds the slot one-hot as a [T, K, E, C] product; here
    each kept (token, k, expert) pair is scattered to its slot instead (a
    token picks an expert at most once and a queue position is unique per
    expert, so no slot receives two non-zero values: the tensors are the
    reference's exactly, without the [T, K, E, C] transient)."""
    t, top_k = gate_idx.shape
    onehot = F.one_hot(gate_idx.long(), e).float()               # [T, K, E]
    if valid is not None:
        onehot = onehot * valid[:, None, None]
        gate_vals = gate_vals * valid[:, None]
    flat = onehot.reshape(t * top_k, e)
    pos = torch.cumsum(flat, dim=0) - flat                       # queue pos
    keep = (pos < capacity).float() * flat                       # [T*K, E]
    tok = torch.arange(t, device=flat.device).repeat_interleave(top_k)
    # every (t, k, e) lands somewhere in its token's [E, C] plane; dropped
    # and unchosen pairs add 0 at a clamped slot
    idx = ((tok[:, None] * e + torch.arange(e, device=flat.device)[None, :])
           * capacity + pos.long().clamp(max=capacity - 1))
    dispatch = torch.zeros(t * e * capacity, dtype=torch.float32,
                           device=flat.device)
    combine = torch.zeros_like(dispatch)
    dispatch.scatter_add_(0, idx.reshape(-1), keep.reshape(-1))
    combine.scatter_add_(0, idx.reshape(-1),
                         (keep * gate_vals.reshape(t * top_k, 1)).reshape(-1))
    return (dispatch.reshape(t, e, capacity), combine.reshape(t, e, capacity))


def moe_mlp(
    x: torch.Tensor,         # [T, D] flattened tokens
    router_w: torch.Tensor,  # [D, E]
    w_gate: torch.Tensor,    # [E, D, I]
    w_up: torch.Tensor,      # [E, D, I]
    w_down: torch.Tensor,    # [E, I, D]
    top_k: int,
    capacity: int,
    valid: Optional[torch.Tensor] = None,  # [T] 1.0 = real token, 0.0 = pad
    scoring: str = "softmax",              # "softmax" (Mixtral/V2) | "sigmoid" (V3)
    norm_topk: bool = True,                # renormalize the top-k gate weights
    routed_scaling: float = 1.0,           # DeepSeek routed_scaling_factor
    router_bias: Optional[torch.Tensor] = None,  # [E] V3 e_score_correction_bias
    n_group: int = 1,                      # DeepSeek group-limited routing
    topk_group: int = 1,                   # groups the top-k may draw from
) -> torch.Tensor:
    """Top-k routed SwiGLU experts through the dense one-hot dispatch.

    Routing as in the reference: Mixtral = softmax scores + renormalized
    top-k; DeepSeek-V2 = softmax, ``norm_topk=False``, scaled routed
    output; DeepSeek-V3 = sigmoid scores, the bias steering selection
    only. ``torch.topk`` (sorted) gives ``lax.top_k``'s descending order,
    which fixes the queue order and so which tokens a full expert drops."""
    e = router_w.shape[1]
    logits = (x @ router_w).float()                              # [T, E]
    if scoring == "sigmoid":
        probs = torch.sigmoid(logits)
    elif scoring == "softmax":
        probs = torch.softmax(logits, dim=-1)
    else:
        raise ValueError(f"unknown moe scoring {scoring!r}")
    select = probs if router_bias is None else probs + router_bias.float()[None, :]
    if n_group > 1:
        # group-limited routing: score each group of E/G experts (V3 by its
        # top-2 sum of biased scores, V2 by its max), keep the topk_group
        # best groups and zero every other expert's selection score (scores
        # are >= 0, so a zeroed expert loses top_k to any live one)
        t = select.shape[0]
        gsize = e // n_group
        grouped = select.reshape(t, n_group, gsize)
        if router_bias is not None:
            group_scores = torch.topk(grouped, min(2, gsize), dim=-1).values.sum(-1)
        else:
            group_scores = grouped.max(dim=-1).values
        gsel = torch.topk(group_scores, topk_group, dim=-1).indices  # [T, KG]
        gmask = F.one_hot(gsel, n_group).sum(1)                      # [T, G]
        select = torch.where(gmask.repeat_interleave(gsize, dim=1) > 0,
                             select, torch.zeros_like(select))
    gate_idx = torch.topk(select, top_k, dim=-1, sorted=True).indices  # [T, K]
    gate_vals = torch.gather(probs, 1, gate_idx)
    if norm_topk:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                            min=1e-9)
    gate_vals = gate_vals * routed_scaling

    dispatch, combine = _dispatch_combine(gate_vals, gate_idx, e, capacity, valid)
    x_e = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)      # [E, C, D]
    h = F.silu(expert_bmm(x_e, w_gate)) * expert_bmm(x_e, w_up)    # [E, C, I]
    y_e = expert_bmm(h, w_down)                                    # [E, C, D]
    return torch.einsum("tec,ecd->td", combine.to(x.dtype), y_e)


def gptoss_moe(
    x: torch.Tensor,          # [T, D] flattened tokens
    router_w: torch.Tensor,   # [D, E]
    router_b: torch.Tensor,   # [E]
    w_gate_up: torch.Tensor,  # [E, D, 2I] (gate/up interleaved on the last dim)
    b_gate_up: torch.Tensor,  # [E, 2I]
    w_down: torch.Tensor,     # [E, I, D]
    b_down: torch.Tensor,     # [E, D]
    top_k: int,
    capacity: int,
    valid: Optional[torch.Tensor] = None,  # [T] 1.0 = real token, 0.0 = pad
    alpha: float = 1.702,
    limit: float = 7.0,
) -> torch.Tensor:
    """GPT-OSS routed experts (the reference's ``gptoss_moe``): the router's
    bias takes part in both selection and the combine weights, softmaxed
    over the selected top-k only; each expert is a clamped sigmoid GLU
    (gate <= limit, up in [-limit, limit], ``(up + 1) * gate *
    sigmoid(alpha * gate)``) over one fused projection whose gate and up
    columns interleave, and every projection has its bias. Dispatch,
    capacity and drop order are ``moe_mlp``'s."""
    e = router_w.shape[1]
    logits = (x @ router_w).float() + router_b.float()             # [T, E]
    gate_vals, gate_idx = torch.topk(logits, top_k, dim=-1, sorted=True)
    gate_vals = torch.softmax(gate_vals, dim=-1)
    dispatch, combine = _dispatch_combine(gate_vals, gate_idx, e, capacity, valid)
    x_e = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)      # [E, C, D]
    gu = expert_bmm(x_e, w_gate_up) + b_gate_up[:, None, :]        # [E, C, 2I]
    gate = gu[..., 0::2].clamp(max=limit)
    up = gu[..., 1::2].clamp(-limit, limit)
    h = (up + 1.0) * (gate * torch.sigmoid(gate * alpha))
    y_e = expert_bmm(h, w_down) + b_down[:, None, :]                # [E, C, D]
    return torch.einsum("tec,ecd->td", combine.to(x.dtype), y_e)


def make_moe_mlp_fn(cfg: ModelConfig, b: int, s: int,
                    slot_mapping: torch.Tensor):
    """Routed-experts ``mlp_fn`` for ``llama.run_layers``, with the
    always-on shared experts when the layer has them (DeepSeek).

    Capacity comes from the PADDED token count ``b * s`` and validity from
    ``slot_mapping >= 0``, as in the reference: at a decode batch of 8
    rows, DeepSeek-V2-Lite (64 experts, top 6, factor 2) gets capacity
    ``int(8 * 6 * 2 / 64) = 1``, so an expert chosen by two rows keeps
    only the first — the reference's behaviour, matched here."""
    capacity = expert_capacity(b * s, cfg.num_experts, cfg.num_experts_per_tok,
                               cfg.moe_capacity_factor)
    valid = (slot_mapping.reshape(b * s) >= 0).float()

    def mlp(x: torch.Tensor, lp) -> torch.Tensor:
        y = moe_mlp(
            x.reshape(b * s, -1), lp["router"], lp["w_gate"], lp["w_up"],
            lp["w_down"], cfg.num_experts_per_tok, capacity, valid=valid,
            scoring=cfg.moe_scoring_func, norm_topk=cfg.norm_topk_prob,
            routed_scaling=cfg.routed_scaling_factor,
            router_bias=lp.get("router_bias"), n_group=cfg.n_group,
            topk_group=cfg.topk_group,
        ).reshape(b, s, -1)
        if "w_sh_gate" in lp:
            gate = F.silu(dense(x, lp["w_sh_gate"]))
            y = y + dense(gate * dense(x, lp["w_sh_up"]), lp["w_sh_down"])
        return y

    return mlp


_LAYER_KEYS = {"ln1", "wq", "wk", "wv", "wo", "ln2", "router", "w_gate",
               "w_up", "w_down"}


def check_supported(cfg: ModelConfig) -> None:
    """Refuse configs this family module does not serve."""
    unported = []
    if cfg.model_family:
        unported.append(f"model family {cfg.model_family!r}")
    if not cfg.num_experts:
        unported.append("a dense MLP (num_experts 0: the llama family)")
    if cfg.kv_lora_rank:
        unported.append("MLA attention")
    if cfg.attn_logit_softcap or cfg.final_logit_softcap:
        unported.append("logit softcapping")
    if unported:
        raise NotImplementedError(
            "not served by the Mixtral family: " + "; ".join(unported))


def param_keys(cfg: ModelConfig) -> Dict[str, set]:
    """Per layer group, the keys a Mixtral-family param tree must hold (the
    Qwen3 q/k norms are optional; the Qwen2-style biases are required when
    the config has them)."""
    keys = set(_LAYER_KEYS)
    if cfg.attention_bias:
        keys |= {"bq", "bk", "bv"}
    return {"layers": keys}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """Random-init params with the reference's shapes and names:
    normal(0, fan_in^-0.5) weights drawn from ``generator`` a layer slice at
    a time (``llama.normal_slices``), unit norms, zero biases; no q/k norms
    (a Qwen3-MoE checkpoint brings them). With ``cfg.quantization`` the
    ``quant.QUANT_KEYS`` leaves are quantized to int8 slice by slice as
    they are drawn, so a tree too large for the card in ``dtype``
    (Mixtral-8x7B: 93 GB in bf16) is never held whole in it."""
    check_supported(cfg)
    l, d_model = cfg.num_layers, cfg.hidden_size
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    inter = cfg.moe_intermediate_size or cfg.intermediate_size
    e = cfg.num_experts
    quantized = QUANT_KEYS if cfg.quantization else frozenset()

    def w(name, shape, fan_in):
        return normal_slices(shape, fan_in, generator, dtype, device,
                             quantize=name in quantized)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "ln1": ones((l, d_model)),
        "wq": w("wq", (l, d_model, h * hd), d_model),
        "wk": w("wk", (l, d_model, kvh * hd), d_model),
        "wv": w("wv", (l, d_model, kvh * hd), d_model),
        "wo": w("wo", (l, h * hd, d_model), h * hd),
        "ln2": ones((l, d_model)),
        "router": w("router", (l, d_model, e), d_model),
        "w_gate": w("w_gate", (l, e, d_model, inter), d_model),
        "w_up": w("w_up", (l, e, d_model, inter), d_model),
        "w_down": w("w_down", (l, e, inter, d_model), inter),
    }
    if cfg.attention_bias:
        for name, width in (("bq", h * hd), ("bk", kvh * hd), ("bv", kvh * hd)):
            layers[name] = torch.zeros((l, width), dtype=dtype, device=device)
    params: Params = {
        "embed": w("embed", (cfg.vocab_size, d_model), d_model),
        "layers": layers,
        "final_norm": ones((d_model,)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w("lm_head", (d_model, cfg.vocab_size), d_model)
    return params


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
    """Logits [B, S, V] (or the pre-final-norm hidden with
    ``return_hidden``) and the cache, updated in place: the Llama trunk with
    the routed experts as its MLP. Bucket-padding tokens (slot_mapping < 0)
    claim no expert slots."""
    b, s = tokens.shape
    return llama.forward(params, cfg, tokens, positions, kv_cache,
                         block_tables, slot_mapping, context_lens,
                         return_hidden=return_hidden,
                         mlp_fn=make_moe_mlp_fn(cfg, b, s, slot_mapping))
