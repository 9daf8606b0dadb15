"""Differential tests of the port's sampling epilogue against the JAX
package's Pallas epilogue.

The reference kernel runs as its own tests run it on the CPU
(``interpret=True``); the port's wrapper takes its plain version for CPU
tensors. Both get the same inputs, made with numpy from a seed, and the
reference's gumbel noise (torch cannot reproduce threefry), so sampled
tokens and committed counts must be exactly equal. The case is the mixed-
regime batch of ``tests/test_pallas_campaign.py``: greedy, top-k, top-p,
min-p with penalties, top-k + top-p with repetition, greedy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as jax_sampling
from dynamo_tpu.ops.pallas_epilogue import fused_sampling_epilogue as jax_epilogue
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.model_runner import (
    resolve_fused_epilogue,
    sample_and_logprobs,
)
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.ops import epilogue

B, V, NS = 6, 64, 8


def _case():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(B, V)) * 4).astype(np.float32)
    counts = rng.integers(0, 3, size=(NS, V)).astype(np.int32)
    seen = rng.integers(0, 2, size=(NS, V)).astype(bool)
    bias = (rng.normal(size=(NS, V)) * 0.5).astype(np.float32)
    scal = dict(
        temperature=np.array([0.0, 0.7, 1.0, 1.3, 0.9, 0.0], np.float32),
        top_k=np.array([0, 5, 0, 0, 3, 0], np.int32),
        top_p=np.array([1.0, 1.0, 0.9, 1.0, 0.8, 1.0], np.float32),
        min_p=np.array([0.0, 0.0, 0.0, 0.2, 0.05, 0.0], np.float32),
        presence_penalty=np.array([0.0, 0.5, 0.0, 1.1, 0.0, 0.0], np.float32),
        frequency_penalty=np.array([0.0, 0.0, 0.3, 0.2, 0.0, 0.0], np.float32),
        repetition_penalty=np.array([1.0, 1.2, 1.0, 1.05, 1.3, 1.0], np.float32),
    )
    keys = rng.integers(0, 2**32, size=(B, 2)).astype(np.uint32)
    counters = rng.integers(0, 100, size=(B,)).astype(np.int32)
    params = jax_sampling.SamplingParams(
        **{k: jnp.asarray(v) for k, v in scal.items()},
        keys=jnp.asarray(keys), counters=jnp.asarray(counters))
    row_keys = jax_sampling._row_keys(params)
    gumbel = np.array(jax.vmap(
        lambda kk: jax.random.gumbel(kk, (V,), jnp.float32))(row_keys))
    return logits, counts, seen, bias, scal, gumbel


def _torch_samp(scal):
    return SamplingParams.from_host(
        "cpu", scal["temperature"], scal["top_k"], scal["top_p"], scal["min_p"],
        scal["presence_penalty"], scal["frequency_penalty"],
        scal["repetition_penalty"])


# unique slots (decode / burst: the count commit in place), and pad rows
# sharing slot 0 with a live row (batched prefill: the commit outside)
SLOTS = {
    "unique": ([3, 0, 5, 1, 7, 2], [1, 1, 0, 1, 1, 0], True),
    "duplicate": ([3, 0, 5, 0, 7, 0], [1, 1, 0, 0, 1, 0], False),
}


@pytest.mark.parametrize("name", list(SLOTS))
def test_epilogue_plain_version_matches_pallas_interpret(name):
    slots, commit, alias = SLOTS[name]
    logits, counts, seen, bias, scal, gumbel = _case()
    slots = np.asarray(slots, np.int32)
    commit = np.asarray(commit, bool)
    want_tok, want_lp, want_counts = jax_epilogue(
        jnp.asarray(logits), jnp.asarray(gumbel),
        tuple(jnp.asarray(scal[k]) for k in (
            "temperature", "top_k", "top_p", "min_p", "presence_penalty",
            "frequency_penalty", "repetition_penalty")),
        jnp.asarray(counts), jnp.asarray(seen), jnp.asarray(bias),
        jnp.asarray(slots), jnp.asarray(commit), alias_counts=alias,
        interpret=True)

    t_counts = torch.from_numpy(counts.copy())
    tok, lp, out_counts = epilogue.fused_sampling_epilogue(
        torch.from_numpy(logits), torch.from_numpy(gumbel), _torch_samp(scal),
        t_counts, torch.from_numpy(seen), torch.from_numpy(bias),
        torch.from_numpy(slots).long(), torch.from_numpy(commit),
        alias_counts=alias)
    assert out_counts.data_ptr() == t_counts.data_ptr()  # in place
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(out_counts.numpy(), np.asarray(want_counts))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=1e-6, atol=1e-6)
    assert epilogue.launches == 0  # CPU tensors never launch the kernel


def test_runner_tail_fused_route_equals_unfused():
    """``sample_and_logprobs`` through the epilogue's route (its plain
    version on the CPU) and the unfused tail agree exactly, top-K
    alternatives included; the fused-route resolution follows the device."""
    logits, counts, seen, bias, scal, gumbel = _case()
    cfg = ModelConfig(vocab_size=V)
    outs = []
    for fused in (False, True):
        c = torch.from_numpy(counts.copy())
        outs.append(sample_and_logprobs(
            cfg, torch.from_numpy(logits), _torch_samp(scal),
            torch.from_numpy(gumbel), c, torch.from_numpy(seen),
            torch.from_numpy(bias), torch.tensor([3, 0, 5, 1, 7, 2]),
            torch.tensor([1, 1, 0, 1, 1, 0]).bool(), True, fused=fused,
            unique_slots=True) + (c,))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert resolve_fused_epilogue("auto", "cpu") is False
    assert resolve_fused_epilogue("auto", "cuda") is True
    assert resolve_fused_epilogue("on", "cpu") is True
    assert resolve_fused_epilogue("off", "cuda") is False
