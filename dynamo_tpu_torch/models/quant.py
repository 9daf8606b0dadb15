"""Weight-only int8 quantization for serving, in PyTorch.

The port of ``dynamo_tpu/models/quant.py``. Matmul weights are stored as
int8 with a symmetric per-output-channel f32 scale, which halves the
weights' bytes against bf16 (and lets Mixtral-8x7B, 93 GB in bf16, fit one
80 GB card). Models call ``dense(x, w)`` (or ``expert_bmm`` for the
[E, in, out] expert stacks) instead of ``x @ w``; for a plain tensor it is
exactly ``x @ w``.

The products are plain ``torch.matmul`` / ``torch.bmm`` on a dequantised
operand, as the reference leaves them to XLA outside any Pallas kernel:
``q.to(x.dtype)`` materialises the layer's weight in the activation dtype
for each product (XLA fuses that convert into the dot's operand read; a
fused int8 GEMM is a speed item of its own). The scale lands on the
[..., out] result, rounded to the activation dtype first, as in the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class QuantizedWeight:
    """int8 weight + per-output-channel scale.

    Stacked form: ``q`` [L, (E,) in, out] int8 and ``scale`` [L, (E,) out]
    f32; a layer's slice (``w[i]``) is ``q`` [(E,) in, out] and ``scale``
    [(E,) out]."""

    q: torch.Tensor      # int8
    scale: torch.Tensor  # f32: max |w| over the in axis / 127

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def __getitem__(self, idx) -> "QuantizedWeight":
        """Index or slice both along the leading (stack) axes."""
        return QuantizedWeight(self.q[idx], self.scale[idx])

    def to(self, device) -> "QuantizedWeight":
        """Moved to ``device``; ``q`` stays int8 and ``scale`` f32."""
        return QuantizedWeight(self.q.to(device), self.scale.to(device))


def quantize_int8(w: torch.Tensor) -> QuantizedWeight:
    """Per-output-channel symmetric int8, the scale over the in (second to
    last) axis: ``scale = max(|w|) / 127`` clamped at 1e-8 (all-zero
    columns), ``q = clip(round(w / scale), -127, 127)`` in f32, rounding
    half to even as ``jnp.round`` does. The scale never crosses a leading
    axis, so quantising a stacked leaf slice by slice gives the whole
    leaf's result."""
    a = w.to(torch.float32, copy=True)
    amax = a.abs().amax(dim=-2)
    # a tensor divisor: PyTorch's CUDA kernels divide by a Python scalar as
    # a multiply by its reciprocal, which rounds differently from the
    # reference's true division (one ulp of some scales on the card)
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
    a.div_(scale[..., None, :]).round_().clamp_(-127, 127)
    return QuantizedWeight(q=a.to(torch.int8), scale=scale)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain or quantized weight."""
    if isinstance(w, QuantizedWeight):
        return (x @ w.q.to(x.dtype)) * w.scale.to(x.dtype)
    return x @ w


def expert_bmm(x: torch.Tensor, w) -> torch.Tensor:
    """``torch.bmm(x, w)`` for the MoE expert products: ``x`` [E, C, in]
    against a plain or quantized [E, in, out] stack (the reference's
    ``expert_einsum``); the scale [E, out] broadcasts as
    ``scale[:, None, :]``."""
    if isinstance(w, QuantizedWeight):
        return torch.bmm(x, w.q.to(x.dtype)) * w.scale.to(x.dtype)[:, None, :]
    return torch.bmm(x, w)


# the weights worth quantizing: the big matmul operands. embed stays full
# (a gather and the tied head's transpose), norms and biases are tiny, MoE
# routers steer expert selection (precision-sensitive and tiny), and MLA's
# w_kr / w_uk / w_uv stay full (w_kr keeps the rope keys exact; w_uk / w_uv
# use other contraction layouts and are latent-rank small)
LLAMA_QUANT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"}
)
# + DeepSeek's shared experts and MLA low-rank projections; the Mixtral
# expert stacks reuse the w_gate / w_up / w_down names ([L, E, in, out]);
# GPT-OSS's interleaved gate / up stack (each output column owns its scale)
QUANT_KEYS = LLAMA_QUANT_KEYS | frozenset(
    {"w_sh_gate", "w_sh_up", "w_sh_down", "w_dq", "w_uq", "w_dkv",
     "w_gate_up"}
)


def quantize_params(params: Dict, keys: frozenset = QUANT_KEYS) -> Dict:
    """The param tree with the named matmul weights quantized, at any depth
    of the nested dict; a leaf that is already quantized stays as it is."""
    def walk(node):
        if isinstance(node, dict):
            return {k: quantize_int8(v)
                    if k in keys and not isinstance(v, QuantizedWeight)
                    else walk(v)
                    for k, v in node.items()}
        return node

    return walk(params)
