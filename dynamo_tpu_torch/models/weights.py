"""Weight bridge: the reference package's parameter tree, as numpy arrays,
into the port's tensors.

The port keeps the reference's parameter names and layouts
(``models/llama.py``, ``models/deepseek.py``, ``models/gptoss.py``,
``models/mixtral.py``, ``models/gemma2.py``), so the bridge is a plain copy
of every leaf, checked against the family's keys. The caller hands in numpy
arrays (e.g. ``jax.device_get(params)`` on the JAX side); this module never
imports jax. bfloat16 leaves (numpy's ``ml_dtypes.bfloat16``) are
reinterpreted bit for bit. A quantized leaf of the reference (its
``QuantizedWeight``: after ``jax.device_get`` an object with numpy ``q``
and ``scale``) becomes the port's ``QuantizedWeight`` with its int8 ``q``
and f32 ``scale`` as they are.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..engine.config import ModelConfig
from . import resolve
from .llama import Params, torch_dtype
from .quant import QuantizedWeight


def to_tensor(arr, device="cpu", dtype=None) -> torch.Tensor:
    """One numpy leaf → a tensor on ``device`` (cast to ``dtype`` if given)."""
    arr = np.array(arr)  # a writable copy: jax.device_get leaves are read-only
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax_params(np_params: Mapping[str, Any], cfg: ModelConfig,
                    device="cpu", dtype=None) -> Params:
    """The reference's params (nested dict of numpy arrays) as the port's
    params on ``device``, cast to ``dtype`` ("bfloat16" / "float32" / a
    torch dtype; None keeps each leaf's own)."""
    family = resolve(cfg)
    family.check_supported(cfg)
    td = torch_dtype(dtype) if dtype is not None else None

    def walk(tree):
        if isinstance(tree, Mapping):
            return {k: walk(v) for k, v in tree.items()}
        if hasattr(tree, "q") and hasattr(tree, "scale"):
            # a quantized leaf: its dtypes are the scheme's, not ``dtype``
            return QuantizedWeight(to_tensor(tree.q, device),
                                   to_tensor(tree.scale, device))
        return to_tensor(tree, device, td)

    params = walk(np_params)
    groups = family.param_keys(cfg)
    missing = ({"embed", "final_norm"} | set(groups)) - set(params)
    # gemma-2 reads the embedding unless the tree holds an lm_head, whatever
    # the tie flag (the reference's gemma2 does so)
    if not cfg.tie_word_embeddings and cfg.model_family != "gemma2":
        missing |= {"lm_head"} - set(params)
    for group, keys in groups.items():
        missing |= {f"{group}.{k}" for k in keys - set(params.get(group, {}))}
    if missing:
        raise ValueError(f"param tree lacks {sorted(missing)}")
    return params
