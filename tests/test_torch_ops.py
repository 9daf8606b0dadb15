"""Differential tests of the port's attention ops against the JAX package.

The same inputs, made with numpy from a seed, go through the reference
function and its port, f32 throughout. The reference's Pallas kernels run
as their own tests run them on the CPU (``interpret=True``); the port's
kernel modules take their plain versions for CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops.attention import paged_attention as jax_paged_attention
from dynamo_tpu.ops.attention import scatter_kv_stacked as jax_scatter
from dynamo_tpu.ops.pallas_attention import paged_flash_attention as jax_flash
from dynamo_tpu.ops.pallas_decode import paged_decode_attention as jax_decode
from dynamo_tpu_torch.ops import paged_decode, paged_flash
from dynamo_tpu_torch.ops.attention import (
    attention,
    paged_attention,
    check_attention_impl,
    scatter_kv_stacked,
)

# tiny widths: 4 heads over 2 KV heads, head_dim 16, block size 8
L, H, KVH, D, BS = 2, 4, 2, 16, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(rng, b, w, n_blocks=None, d=D):
    n_blocks = n_blocks or b * w + 3
    k = rng.standard_normal((L, n_blocks, BS, KVH, d)).astype(np.float32)
    v = rng.standard_normal((L, n_blocks, BS, KVH, d)).astype(np.float32)
    bt = rng.permutation(n_blocks)[: b * w].reshape(b, w).astype(np.int32)
    return k, v, bt


def test_scatter_kv_stacked_drops_sentinel_and_out_of_layer_slots():
    rng = np.random.default_rng(0)
    n_blocks = 5
    per_layer = n_blocks * BS
    k, v, _ = _case(rng, 1, 1, n_blocks)
    new_k = rng.standard_normal((2, 6, KVH, D)).astype(np.float32)
    new_v = rng.standard_normal((2, 6, KVH, D)).astype(np.float32)
    # -1 sentinels, a slot past the layer, and ordinary slots (unique)
    slots = np.array([[3, -1, 17, per_layer, 0, -1],
                      [per_layer + 7, 39, 8, -1, 21, 22]], np.int32)
    for li in range(L):
        jk, jv = jax_scatter(jnp.asarray(k), jnp.asarray(v), jnp.asarray(new_k),
                             jnp.asarray(new_v), jnp.asarray(slots), jnp.int32(li))
        tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        ok, ov = scatter_kv_stacked(tk, tv, torch.from_numpy(new_k),
                                    torch.from_numpy(new_v),
                                    torch.from_numpy(slots), li)
        assert ok.data_ptr() == tk.data_ptr()  # in place
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ov.numpy(), np.asarray(jv))


@pytest.mark.parametrize("window", [None, 5])
def test_paged_attention_matches_jax(window):
    rng = np.random.default_rng(1)
    b, s, w = 3, 4, 3
    k, v, bt = _case(rng, b, w)
    q = rng.standard_normal((b, s, H, D)).astype(np.float32)
    ctx = np.array([4, 13, 24], np.int32)
    pos = (ctx - s)[:, None] + np.arange(s)[None, :]
    ref = jax_paged_attention(jnp.asarray(q), jnp.asarray(k[1]), jnp.asarray(v[1]),
                              jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(ctx),
                              sliding_window=window)
    got = paged_attention(torch.from_numpy(q), torch.from_numpy(k[1]),
                          torch.from_numpy(v[1]), torch.from_numpy(bt),
                          torch.from_numpy(pos), torch.from_numpy(ctx),
                          sliding_window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the stacked-cache dispatch on CPU takes the same plain route
    got2 = attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                     torch.from_numpy(bt), torch.from_numpy(pos),
                     torch.from_numpy(ctx), layer_idx=1, sliding_window=window)
    np.testing.assert_allclose(got2.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("head_dim", [D, 96, 128])  # 96 Phi-3, 128 the 8B class
@pytest.mark.parametrize("window", [None, 6])
def test_decode_plain_version_matches_pallas_interpret(window, head_dim):
    rng = np.random.default_rng(2)
    ctx = np.array([1, BS - 1, BS, BS + 1], np.int32)
    b, w = len(ctx), 3
    k, v, bt = _case(rng, b, w, d=head_dim)
    q = rng.standard_normal((b, 1, H, head_dim)).astype(np.float32)
    for li in range(L):
        ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(bt), jnp.asarray(ctx),
                         layer_idx=jnp.int32(li), interpret=True, window=window)
        got = paged_decode.paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(bt), torch.from_numpy(ctx), layer_idx=li,
            window=window if window is not None else paged_decode.NO_WINDOW)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert paged_decode.launches == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("head_dim", [D, 96, 128])  # 96 Phi-3, 128 the 8B class
@pytest.mark.parametrize("window", [None, 7])
def test_flash_plain_version_matches_pallas_interpret(window, head_dim):
    rng = np.random.default_rng(3)
    s, w = 16, 6
    # base_pos 0 (ctx = S), a prefix hit (base > 0, ctx = base + S), a
    # padded tail (ctx < base + S: rows past ctx are discarded), and a pad
    # row of a batched prefill step (base 0, ctx 1, block table all 0)
    base = np.array([0, 11, 5, 0], np.int32)
    ctx = np.array([16, 27, 12, 1], np.int32)
    b = len(base)
    k, v, bt = _case(rng, b, w, d=head_dim)
    bt[-1] = 0
    q = rng.standard_normal((b, s, H, head_dim)).astype(np.float32)
    ref = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(base), jnp.asarray(ctx), layer_idx=jnp.int32(1),
        q_chunk=8, interpret=True, window=window))
    got = paged_flash.paged_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bt), torch.from_numpy(base), torch.from_numpy(ctx),
        layer_idx=1,
        window=window if window is not None else paged_flash.NO_WINDOW).numpy()
    for i in range(b):
        valid = ctx[i] - base[i]
        np.testing.assert_allclose(got[i, :valid], ref[i, :valid], **TOL)
    assert paged_flash.launches == 0


@pytest.mark.parametrize("h,kvh", [(14, 2), (10, 2)])  # G 7 and G 5
def test_flash_plain_version_matches_pallas_interpret_at_odd_groups(h, kvh):
    """Qwen2.5's GQA groups (G 7, Qwen2.5-32B's G 5), whose query positions
    do not fill the kernel's 64-row CTA: the plain version against the
    reference's kernel (any G) in interpret mode, at head_dim 128."""
    rng = np.random.default_rng(8)
    s, w, d = 16, 6, 128
    base = np.array([0, 11, 0], np.int32)
    ctx = np.array([16, 27, 1], np.int32)
    b = len(base)
    k = rng.standard_normal((L, b * w + 3, BS, kvh, d)).astype(np.float32)
    v = rng.standard_normal((L, b * w + 3, BS, kvh, d)).astype(np.float32)
    bt = rng.permutation(b * w + 3)[: b * w].reshape(b, w).astype(np.int32)
    bt[-1] = 0
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ref = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(base), jnp.asarray(ctx), layer_idx=jnp.int32(1),
        q_chunk=8, interpret=True))
    got = paged_flash.paged_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bt), torch.from_numpy(base), torch.from_numpy(ctx),
        layer_idx=1).numpy()
    for i in range(b):
        valid = ctx[i] - base[i]
        np.testing.assert_allclose(got[i, :valid], ref[i, :valid], **TOL)


def test_attention_impl_resolution():
    for impl in ("auto", "xla", "pallas"):
        check_attention_impl(impl, "cpu")
    check_attention_impl("auto", "cuda")
    check_attention_impl("pallas", "cuda")
    with pytest.raises(ValueError):
        check_attention_impl("xla", "cuda")
    with pytest.raises(ValueError):
        check_attention_impl("bogus", "cpu")
