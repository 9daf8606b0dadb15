"""Differential tests of the port's routed mixture of experts
(``dynamo_tpu_torch/models/mixtral.py``) against the JAX package.

Tiny widths (hidden 64, expert width 32, 4 or 8 experts, top-2), inputs
made from a seed with numpy and handed to both packages, f32. Tolerance
1e-5: both sides compute the same f32 products; the rest is summation
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models import mixtral as jax_mixtral
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.models import mixtral

TOL = dict(rtol=1e-5, atol=1e-5)
D, I = 64, 32


def _weights(rng, e, d=D, i=I):
    s = d ** -0.5
    return (rng.standard_normal((d, e)).astype(np.float32) * s,
            rng.standard_normal((e, d, i)).astype(np.float32) * s,
            rng.standard_normal((e, d, i)).astype(np.float32) * s,
            rng.standard_normal((e, i, d)).astype(np.float32) * i ** -0.5)


# name → (experts, tokens, capacity, moe_mlp keyword arguments, pad rows)
CASES = {
    # DeepSeek-V2: softmax scores, no top-k renormalisation, scaled output
    "v2_softmax_scaled": (4, 12, 12, dict(scoring="softmax", norm_topk=False,
                                          routed_scaling=2.5), []),
    # DeepSeek-V3: sigmoid scores, a selection bias, group-limited routing
    "v3_sigmoid_bias_groups": (8, 12, 12, dict(scoring="sigmoid", norm_topk=True,
                                               routed_scaling=1.5, n_group=2,
                                               topk_group=1, bias=True), []),
    # V2's group_limited_greedy (groups scored by their max, no bias)
    "v2_groups_by_max": (8, 10, 10, dict(scoring="softmax", norm_topk=False,
                                         n_group=4, topk_group=2), []),
    # pad tokens claim no slots and contribute nothing
    "pad_tokens": (4, 12, 6, dict(scoring="softmax", norm_topk=True),
                   [0, 5, 6, 11]),
    # capacity 1: an expert chosen by several tokens keeps only the first
    # in token-major, then k, order (the V2-Lite decode case)
    "capacity_drops": (4, 8, 1, dict(scoring="softmax", norm_topk=False), [3]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_moe_mlp_matches_jax(name):
    e, t, cap, kw, pads = CASES[name]
    kw = dict(kw)
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal((t, D)).astype(np.float32)
    router, wg, wu, wd = _weights(rng, e)
    valid = np.ones(t, np.float32)
    valid[pads] = 0.0
    bias = (0.3 * rng.standard_normal(e)).astype(np.float32) if kw.pop("bias", False) else None
    want = jax_mixtral.moe_mlp(
        jnp.asarray(x), jnp.asarray(router), jnp.asarray(wg), jnp.asarray(wu),
        jnp.asarray(wd), 2, cap, valid=jnp.asarray(valid),
        router_bias=None if bias is None else jnp.asarray(bias), **kw)
    got = mixtral.moe_mlp(
        torch.from_numpy(x), torch.from_numpy(router), torch.from_numpy(wg),
        torch.from_numpy(wu), torch.from_numpy(wd), 2, cap,
        valid=torch.from_numpy(valid),
        router_bias=None if bias is None else torch.from_numpy(bias), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[pads].any()
    if name == "capacity_drops":
        # some token lost an expert to the capacity: the output differs
        # from the same routing with room for every token
        roomy = mixtral.moe_mlp(
            torch.from_numpy(x), torch.from_numpy(router), torch.from_numpy(wg),
            torch.from_numpy(wu), torch.from_numpy(wd), 2, t,
            valid=torch.from_numpy(valid), **kw)
        assert not torch.allclose(got, roomy)


@pytest.mark.parametrize("cap", [1, 3, 16])
def test_dispatch_combine_equal_jax(cap):
    """The slot tensors themselves, exactly: queue order token-major then
    k, drops past capacity, pad tokens claim nothing."""
    rng = np.random.default_rng(cap)
    t, k, e = 16, 2, 4
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(np.int32)
    vals = rng.random((t, k)).astype(np.float32)
    valid = (rng.random(t) > 0.2).astype(np.float32)
    jd, jc = jax_mixtral._dispatch_combine(jnp.asarray(vals), jnp.asarray(idx), e,
                                           cap, jnp.asarray(valid))
    td, tc = mixtral._dispatch_combine(torch.from_numpy(vals),
                                       torch.from_numpy(idx), e, cap,
                                       torch.from_numpy(valid))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_expert_capacity_matches_jax():
    for args in ((8, 64, 6, 2.0), (1, 4, 2, 2.0), (512, 64, 6, 2.0),
                 (40, 8, 2, 1.25), (3, 160, 8, 1.0)):
        assert mixtral.expert_capacity(*args) == jax_mixtral.expert_capacity(*args)
    # DeepSeek-V2-Lite at a decode batch of 8 rows: one slot per expert
    assert mixtral.expert_capacity(8, 64, 6, 2.0) == 1


@pytest.mark.parametrize("shared", [0, 2])
def test_moe_mlp_fn_with_shared_experts_matches_jax(shared):
    """The runner's mlp_fn: capacity from the padded b * s, validity from
    slot_mapping >= 0, plus the always-on shared experts."""
    kw = dict(hidden_size=D, intermediate_size=96, num_experts=4,
              num_experts_per_tok=2, moe_intermediate_size=I,
              n_shared_experts=shared, norm_topk_prob=False,
              routed_scaling_factor=1.3)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(shared)
    b, s = 2, 5
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    router, wg, wu, wd = _weights(rng, 4)
    lp = dict(router=router, w_gate=wg, w_up=wu, w_down=wd)
    if shared:
        sh = shared * I
        lp.update(w_sh_gate=rng.standard_normal((D, sh)).astype(np.float32) * D ** -0.5,
                  w_sh_up=rng.standard_normal((D, sh)).astype(np.float32) * D ** -0.5,
                  w_sh_down=rng.standard_normal((sh, D)).astype(np.float32) * sh ** -0.5)
    slots = np.arange(b * s, dtype=np.int32).reshape(b, s)
    slots[1, 3:] = -1  # a padded tail
    want = jax_mixtral.make_moe_mlp_fn(jcfg, b, s, jnp.asarray(slots))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()})
    got = mixtral.make_moe_mlp_fn(cfg, b, s, torch.from_numpy(slots))(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in lp.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
