"""Model families: architecture config → implementing module.

Each family module exposes the same surface — ``check_supported(cfg)``,
``init_params(cfg, generator, dtype, device)``,
``init_kv_cache(cfg, n, bs, dtype, device)``, ``forward(params, cfg, ...)``
and ``lm_logits(hidden, params, cfg)`` — so the engine
(``engine/model_runner.py``) is architecture-agnostic. The port serves
Llama-family dense GQA (``llama``), DeepSeek-class MLA with routed
experts (``deepseek``), GPT-OSS (``gptoss``: sinks, alternating windows,
routed GLU experts), the Mixtral / Qwen3-MoE trunk (``mixtral``: the Llama
trunk with routed SwiGLU experts) and Gemma-2 (``gemma2``: sandwich norms,
GeGLU, softcapped alternating-window attention). Every family serves its
weights in int8 too (``ModelConfig.quantization``, ``models/quant.py``).
"""

from __future__ import annotations

from ..engine.config import ModelConfig


def resolve(cfg: ModelConfig):
    """The implementing module for an architecture config, chosen as the
    reference's ``dynamo_tpu/models.resolve`` chooses it."""
    if cfg.kv_lora_rank > 0:
        from . import deepseek

        return deepseek
    if cfg.model_family == "gptoss":
        from . import gptoss

        return gptoss
    if cfg.num_experts > 0:
        from . import mixtral

        return mixtral
    if cfg.model_family == "gemma2":
        from . import gemma2

        return gemma2
    from . import llama

    return llama
