"""Top-k routed mixture of experts, in PyTorch.

The port of the routed-MoE part of ``dynamo_tpu/models/mixtral.py``:
``expert_capacity``, ``_dispatch_combine``, ``moe_mlp`` and
``make_moe_mlp_fn`` (with DeepSeek's always-on shared experts), and
``gptoss_moe`` (GPT-OSS's biased router and clamped GLU experts). The
reference's dense (GShard/Switch) formulation is kept: routing gives every
(token, expert) pair a queue position, tokens past an expert's capacity
are dropped for that expert (their residual stream still flows), and the
expert products are batched matmuls over [E, C, D], as XLA computes them
in the reference. The Mixtral trunk itself (its ``forward``) and expert
parallelism (``ep_axis``) belong to later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..engine.config import ModelConfig


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
    h = F.silu(torch.bmm(x_e, w_gate)) * torch.bmm(x_e, w_up)      # [E, C, I]
    y_e = torch.bmm(h, w_down)                                     # [E, C, D]
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
    gu = torch.bmm(x_e, w_gate_up) + b_gate_up[:, None, :]         # [E, C, 2I]
    gate = gu[..., 0::2].clamp(max=limit)
    up = gu[..., 1::2].clamp(-limit, limit)
    h = (up + 1.0) * (gate * torch.sigmoid(gate * alpha))
    y_e = torch.bmm(h, w_down) + b_down[:, None, :]                 # [E, C, D]
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
            gate = F.silu(x @ lp["w_sh_gate"])
            y = y + (gate * (x @ lp["w_sh_up"])) @ lp["w_sh_down"]
        return y

    return mlp
