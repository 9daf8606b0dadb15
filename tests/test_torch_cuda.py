"""The port's CUDA kernels against their plain versions, on a card.

These tests need a CUDA device and ``nvcc``; elsewhere they skip (the
decision is made inside each test, never at import). On the card run
``python -m pytest tests/test_torch_cuda.py -m cuda``; ``chip_smoke.py``
covers the same ground at the full Llama-3.2-1B and DeepSeek-V2-Lite
shapes.
"""

import pytest
import torch

from dynamo_tpu_torch.ops import (
    epilogue,
    mla_decode,
    paged_decode,
    paged_flash,
    paged_verify,
)

# bf16 output rounding plus a different summation order than the f32
# plain version
ATOL = RTOL = 1e-2


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _cache(g, layers=3, blocks=40, bs=16, kvh=2, d=64):
    shape = (layers, blocks, bs, kvh, d)
    return (torch.randn(shape, generator=g, device="cuda").bfloat16(),
            torch.randn(shape, generator=g, device="cuda").bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("window", [paged_decode.NO_WINDOW, 20])
def test_decode_kernel_matches_plain_version(window):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    k, v = _cache(g)
    ctx = torch.tensor([1, 15, 16, 17, 33], dtype=torch.int32, device="cuda")
    bt = torch.randperm(40, generator=g, device="cuda")[:15].reshape(5, 3).int()
    q = torch.randn(5, 1, 8, 64, generator=g, device="cuda").bfloat16()
    before = paged_decode.launches
    out = paged_decode.paged_decode_attention(q, k, v, bt, ctx, layer_idx=2,
                                              window=window)
    ref = paged_decode.paged_decode_attention_ref(
        q.float(), k.float(), v.float(), bt, ctx, 2, None, window)
    torch.cuda.synchronize()
    assert paged_decode.launches == before + 1
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("s,rows", [
    (40, [(0, 40)]), (64, [(20, 84)]), (64, [(0, 30)]),
    # a batched prefill step as the scheduler builds it: from 0, a prefix
    # hit, a padded tail, and a pad row (base 0, ctx 1, block table 0)
    (32, [(0, 32), (20, 52), (48, 60), None]),
])
def test_flash_kernel_matches_plain_version(s, rows):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    k, v = _cache(g)
    n = len(rows)
    bt = torch.randperm(40, generator=g, device="cuda")[: n * 6].reshape(n, 6).int()
    bt[[i for i, r in enumerate(rows) if r is None]] = 0
    rows = [r or (0, 1) for r in rows]
    q = torch.randn(n, s, 8, 64, generator=g, device="cuda").bfloat16()
    b = torch.tensor([r[0] for r in rows], dtype=torch.int32, device="cuda")
    c = torch.tensor([r[1] for r in rows], dtype=torch.int32, device="cuda")
    out = paged_flash.paged_flash_attention(q, k, v, bt, b, c, layer_idx=1)
    ref = paged_flash.paged_flash_attention_ref(
        q.float(), k.float(), v.float(), bt, b, c, 1)
    torch.cuda.synchronize()
    assert out.float().isfinite().all()
    for i, (base, ctx) in enumerate(rows):
        valid = min(s, ctx - base)
        torch.testing.assert_close(out[i, :valid].float(), ref[i, :valid],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 5, 17, 32])
def test_verify_kernel_matches_plain_version(s):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(2)
    k, v = _cache(g)
    # rows: from a long context, a short one, a row whose tail runs past
    # ctx (a padded proposal), and a pad row (base 0, ctx 1, table 0)
    rows = [(40, 40 + s), (3, 3 + s), (60, 60 + s - 1), None]
    n = len(rows)
    bt = torch.randperm(40, generator=g, device="cuda")[: n * 6].reshape(n, 6).int()
    bt[-1] = 0
    rows = [r or (0, 1) for r in rows]
    q = torch.randn(n, s, 8, 64, generator=g, device="cuda").bfloat16()
    b = torch.tensor([r[0] for r in rows], dtype=torch.int32, device="cuda")
    c = torch.tensor([r[1] for r in rows], dtype=torch.int32, device="cuda")
    for window in (paged_verify.NO_WINDOW, 9):
        before = paged_verify.launches
        out = paged_verify.paged_verify_attention(q, k, v, bt, b, c, layer_idx=1,
                                                  window=window)
        ref = paged_verify.paged_verify_attention_ref(
            q.float(), k.float(), v.float(), bt, b, c, 1, None, window)
        torch.cuda.synchronize()
        assert paged_verify.launches == before + 1
        assert out.float().isfinite().all()
        for i, (base, ctx) in enumerate(rows):
            valid = min(s, ctx - base)
            torch.testing.assert_close(out[i, :valid].float(), ref[i, :valid],
                                       atol=ATOL, rtol=RTOL)


def _epilogue_inputs(g, b=8, v=1000, slots=None):
    """Mixed sampling regimes over bf16 logits (normal * 4), one row per
    regime: greedy, top-k, top-p, min-p with penalties, top-k + top-p +
    repetition, greedy, top-k 1, and top-k + top-p over planted ties."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams

    dev = "cuda"
    logits = (torch.randn(b, v, generator=g, device=dev) * 4).bfloat16()
    ns = b
    counts = torch.randint(0, 3, (ns, v), generator=g, device=dev, dtype=torch.int32)
    seen = torch.randint(0, 2, (ns, v), generator=g, device=dev).bool()
    bias = torch.randn(ns, v, generator=g, device=dev) * 0.5
    slots = torch.arange(b, device=dev) if slots is None else slots
    # the tie row: 10 tokens tied at the top, 5 tied at top-k's cut (k 12),
    # the rest far below, and no penalty state on its slot
    tie = torch.randperm(v, generator=g, device=dev)[:15]
    row = torch.full((v,), -20.0, device=dev)
    row[tie[:10]], row[tie[10:]] = 8.0, 6.0
    logits[b - 1] = row.bfloat16()
    ts = int(slots[b - 1])
    counts[ts], seen[ts], bias[ts] = 0, False, 0.0
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    samp = SamplingParams(
        temperature=f([0.0, 0.7, 1.0, 1.3, 0.9, 0.0, 0.8, 1.0]),
        top_k=torch.tensor([0, 5, 0, 0, 3, 0, 1, 12], device=dev),
        top_p=f([1.0, 1.0, 0.9, 1.0, 0.8, 1.0, 1.0, 0.55]),
        min_p=f([0.0, 0.0, 0.0, 0.2, 0.05, 0.0, 0.0, 0.0]),
        presence_penalty=f([0.0, 0.5, 0.0, 1.1, 0.0, 0.0, 0.0, 0.0]),
        frequency_penalty=f([0.0, 0.0, 0.3, 0.2, 0.0, 0.0, 0.0, 0.0]),
        repetition_penalty=f([1.0, 1.2, 1.0, 1.05, 1.3, 1.0, 1.0, 1.0]),
    )
    u = torch.rand(b, v, generator=g, device=dev).clamp_(min=1e-30)
    gumbel = -torch.log(-torch.log(u))
    return logits, gumbel, samp, counts, seen, bias, slots


@pytest.mark.cuda
@pytest.mark.parametrize("v", [1000, 102400, 128256])
@pytest.mark.parametrize("alias", [True, False])
def test_epilogue_kernel_matches_plain_version(v, alias):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    # unique slots, or pad rows sharing slot 0 with a live row
    slots = (torch.tensor([3, 0, 5, 1, 6, 2, 4, 7], device="cuda") if alias
             else torch.tensor([3, 0, 5, 1, 0, 2, 0, 7], device="cuda"))
    commit = torch.tensor([1, 1, 0, 1, alias, 0, alias, 1], device="cuda").bool()
    logits, gumbel, samp, counts, seen, bias, slots = _epilogue_inputs(
        g, v=v, slots=slots)
    c_ref = counts.clone()
    before = epilogue.launches
    tok, lps, c_out = epilogue.fused_sampling_epilogue(
        logits, gumbel, samp, counts, seen, bias, slots, commit, alias_counts=alias)
    tok_r, lps_r, c_ref = epilogue.fused_sampling_epilogue_ref(
        logits, gumbel, samp, c_ref, seen, bias, slots, commit)
    torch.cuda.synchronize()
    assert epilogue.launches == before + 1
    assert tok.tolist() == tok_r.tolist()
    assert torch.equal(c_out, c_ref)
    torch.testing.assert_close(lps, lps_r, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [16, 20])
def test_mla_decode_kernel_matches_plain_version(h):
    """DeepSeek widths (R 512, RD 64) at a small batch: ragged contexts, a
    ctx-1 row, a layer other than 0; 20 heads take a second, partial head
    group."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    layers, n, bs = 3, 40, 16
    c = torch.randn(layers, n, bs, 1, 512, generator=g, device="cuda").bfloat16()
    kr = torch.randn(layers, n, bs, 1, 64, generator=g, device="cuda").bfloat16()
    ctx = torch.tensor([1, 15, 16, 17, 130, 200], dtype=torch.int32, device="cuda")
    # 13 pages cover ctx 200; rows may share pages (reads only)
    bt = torch.randint(0, n, (6, 13), generator=g, device="cuda").int()
    q_lat = torch.randn(6, 1, h, 512, generator=g, device="cuda").bfloat16()
    q_rope = torch.randn(6, 1, h, 64, generator=g, device="cuda").bfloat16()
    before = mla_decode.launches
    out = mla_decode.mla_paged_decode_attention(q_lat, q_rope, c, kr, bt, ctx,
                                                layer_idx=2, scale=0.11472)
    ref = mla_decode.mla_paged_decode_attention_ref(
        q_lat.float(), q_rope.float(), c.float(), kr.float(), bt, ctx, 2, 0.11472)
    torch.cuda.synchronize()
    assert mla_decode.launches == before + 1
    assert out.float().isfinite().all()
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=RTOL)
