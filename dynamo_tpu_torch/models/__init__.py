"""Model families: architecture config → implementing module.

Each family module exposes the same surface — ``check_supported(cfg)``,
``init_params(cfg, generator, dtype, device)``,
``init_kv_cache(cfg, n, bs, dtype, device)``, ``forward(params, cfg, ...)``
and ``lm_logits(hidden, params, cfg)`` — so the engine
(``engine/model_runner.py``) is architecture-agnostic. The port serves
Llama-family dense GQA (``llama``), DeepSeek-class MLA with routed
experts (``deepseek``) and GPT-OSS (``gptoss``: sinks, alternating windows,
routed GLU experts); the reference's other families raise.
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
    if cfg.model_family == "gemma2":
        family = cfg.model_family
    elif cfg.num_experts > 0:
        family = "mixtral"
    else:
        from . import llama

        return llama
    raise NotImplementedError(
        f"model family {family!r} is not ported to the PyTorch engine yet")
