"""The port's CUDA kernels against their plain versions, on a card.

These tests need a CUDA device and ``nvcc``; elsewhere they skip (the
decision is made inside each test, never at import). On the card run
``python -m pytest tests/test_torch_cuda.py -m cuda``; ``chip_smoke.py``
covers the same ground at the full Llama-3.2-1B and DeepSeek-V2-Lite
shapes.
"""

import ctypes

import pytest
import torch

from dynamo_tpu_torch.ops import (
    epilogue,
    mla_decode,
    paged_decode,
    paged_flash,
    paged_verify,
    sp_prefix,
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


# the split-KV edges of a 768-key table (three 256-key splits): one key
# under, at and over a split, a row with no key, the full table
SPLIT_EDGE_CTX = [0, 255, 256, 257, 511, 513, 700, 768]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h", [2, 8, 16, 256])  # G 1, 4, 8, 128 over two KV heads
@pytest.mark.parametrize("window", [paged_decode.NO_WINDOW, 300])
def test_decode_kernel_split_edges(d, h, window):
    """Contexts at the splits' edges, a window that crosses a split, group
    sizes 1, 4, 8 and 128 (one to eight 16-row tiles), head_dim 64 and 128;
    two calls bit-identical."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    k, v = _cache(g, blocks=400, d=d)
    n = len(SPLIT_EDGE_CTX)
    bt = torch.randperm(400, generator=g, device="cuda")[: n * 48].reshape(n, 48).int()
    ctx = torch.tensor(SPLIT_EDGE_CTX, dtype=torch.int32, device="cuda")
    q = torch.randn(n, 1, h, d, generator=g, device="cuda").bfloat16()
    before = paged_decode.launches
    out = paged_decode.paged_decode_attention(q, k, v, bt, ctx, layer_idx=2,
                                              window=window)
    again = paged_decode.paged_decode_attention(q, k, v, bt, ctx, layer_idx=2,
                                                window=window)
    ref = paged_decode.paged_decode_attention_ref(
        q.float(), k.float(), v.float(), bt, ctx, 2, None, window)
    torch.cuda.synchronize()
    assert paged_decode.launches == before + 2
    assert torch.equal(out, again)
    assert not out[0].any()  # ctx 0: zeros
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,s", [(2, 32), (8, 5), (8, 32), (16, 16)])
@pytest.mark.parametrize("window", [paged_verify.NO_WINDOW, 300])
def test_verify_kernel_split_edges(d, h, s, window):
    """Verify tails that end one key under, at and over a 256-key split,
    start at one or cross one, a pad row; a window that crosses a split;
    group sizes 1, 4 and 8 up to 128 rows a CTA, head_dim 64 and 128; two
    calls bit-identical."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    k, v = _cache(g, blocks=400, d=d)
    rows = [(255 - s, 255), (256 - s, 256), (257 - s, 257), (256, 256 + s),
            (500, 500 + s), (700, 700 + s - 1), None]
    n = len(rows)
    bt = torch.randperm(400, generator=g, device="cuda")[: n * 48].reshape(n, 48).int()
    bt[-1] = 0
    rows = [r or (0, 1) for r in rows]
    q = torch.randn(n, s, h, d, generator=g, device="cuda").bfloat16()
    b = torch.tensor([r[0] for r in rows], dtype=torch.int32, device="cuda")
    c = torch.tensor([r[1] for r in rows], dtype=torch.int32, device="cuda")
    before = paged_verify.launches
    out = paged_verify.paged_verify_attention(q, k, v, bt, b, c, layer_idx=1,
                                              window=window)
    again = paged_verify.paged_verify_attention(q, k, v, bt, b, c, layer_idx=1,
                                                window=window)
    ref = paged_verify.paged_verify_attention_ref(
        q.float(), k.float(), v.float(), bt, b, c, 1, None, window)
    torch.cuda.synchronize()
    assert paged_verify.launches == before + 2
    assert torch.equal(out, again)
    assert out.float().isfinite().all()
    for i, (base, ctx) in enumerate(rows):
        valid = min(s, ctx - base)
        torch.testing.assert_close(out[i, :valid].float(), ref[i, :valid],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("s,rows", [
    (40, [(0, 40)]), (64, [(20, 84)]), (64, [(0, 30)]),
    # a batched prefill step as the scheduler builds it: from 0, a prefix
    # hit, a padded tail, and a pad row (base 0, ctx 1, block table 0)
    (32, [(0, 32), (20, 52), (48, 60), None]),
])
def test_flash_kernel_matches_plain_version(s, rows):
    _flash_case(s, rows, d=64)


@pytest.mark.cuda
@pytest.mark.parametrize("s,rows", [
    (64, [(20, 84)]),
    (32, [(0, 32), (20, 52), (48, 60), None]),
])
def test_flash_kernel_matches_plain_version_d128(s, rows):
    """head_dim 128, the library's second instantiation."""
    _flash_case(s, rows, d=128)


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh,window", [(8, 1, 20), (8, 8, 9), (16, 2, 33)])
def test_flash_kernel_window_and_group_sizes(h, kvh, window):
    """A sliding window (the window's first tile is masked) at group sizes
    8, 1 and 8 over two KV heads: 8, 64 and 8 query positions a CTA."""
    _flash_case(76, [(20, 96), (0, 50)], d=64, h=h, kvh=kvh, window=window)


def _flash_case(s, rows, d, h=8, kvh=2, seed=1, window=paged_flash.NO_WINDOW):
    """One flash launch against the f32 plain version: every row finite,
    the rows below ctx within ATOL / RTOL. Returns the output."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(seed)
    k, v = _cache(g, kvh=kvh, d=d)
    n = len(rows)
    bt = torch.randperm(40, generator=g, device="cuda")[: n * 6].reshape(n, 6).int()
    bt[[i for i, r in enumerate(rows) if r is None]] = 0
    rows = [r or (0, 1) for r in rows]
    q = torch.randn(n, s, h, d, generator=g, device="cuda").bfloat16()
    b = torch.tensor([r[0] for r in rows], dtype=torch.int32, device="cuda")
    c = torch.tensor([r[1] for r in rows], dtype=torch.int32, device="cuda")
    before = paged_flash.launches
    out = paged_flash.paged_flash_attention(q, k, v, bt, b, c, layer_idx=1,
                                            window=window)
    ref = paged_flash.paged_flash_attention_ref(
        q.float(), k.float(), v.float(), bt, b, c, 1, None, window)
    torch.cuda.synchronize()
    assert paged_flash.launches == before + 1
    assert out.float().isfinite().all()
    for i, (base, ctx) in enumerate(rows):
        valid = min(s, ctx - base)
        torch.testing.assert_close(out[i, :valid].float(), ref[i, :valid],
                                   atol=ATOL, rtol=RTOL)
    return out


@pytest.mark.cuda
def test_flash_kernel_zeroes_query_tiles_past_ctx():
    """S 512 at G 1 (64 query positions a CTA) with ctx - base = 40: ctx
    ends inside the first of 8 query tiles. The 40 valid rows match the
    plain version, every row is finite, and the 7 tiles that start past
    ctx are written as zeros without reading a key."""
    out = _flash_case(512, [(20, 60)], d=64, h=2, kvh=2, seed=7)
    assert not out[0, 64:].any()


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
@pytest.mark.parametrize("v", [1000, 32000, 102400, 128256, 151936])
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
@pytest.mark.parametrize("form", ["finish", "extra_bias", "both"])
@pytest.mark.parametrize("v", [1000, 128256])
def test_epilogue_kernel_forms_match_plain_version(v, form):
    """The ``finish`` and ``extra_bias`` forms: tokens, counts, ``hard``,
    ``cand`` and ``ring_new`` equal the plain version's exactly, logprobs
    within 1e-4; a dead row moves neither its ring nor its counts."""
    _need_cuda()
    from dynamo_tpu_torch.engine.sampling import stop_seq_hash

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    logits, gumbel, samp, counts, seen, bias, slots = _epilogue_inputs(g, v=v)
    b = logits.shape[0]
    live = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], device=dev).bool()
    extra = None
    if form != "finish":
        extra = torch.zeros(b, v, device=dev)
        extra[5] = -1e9
        extra[5, [17, v - 2]] = 0.0          # a guided row with two ids
    tok0 = epilogue.fused_sampling_epilogue_ref(
        logits, gumbel, samp, counts.clone(), seen, bias, slots, live,
        extra_bias=extra)[0].tolist()
    fin = None
    if form != "extra_bias":
        ring = torch.randint(0, v, (b, 32), generator=g, device=dev).int()
        ring[0, :20] = -1
        ring[1, :] = -1
        pushed = torch.where(live[:, None], torch.cat(
            [ring[:, 1:], torch.tensor(tok0, device=dev).int()[:, None]], 1), ring)
        stop_ids = torch.full((b, 16), -1, dtype=torch.int32, device=dev)
        stop_ids[0, 1], stop_ids[1, 0], stop_ids[6, 15] = tok0[0], tok0[1], tok0[6]
        stop_hash = torch.zeros((b, 4), dtype=torch.int64, device=dev)
        stop_hlen = torch.zeros((b, 4), dtype=torch.int32, device=dev)
        for r in range(b):                   # matching suffixes, length 1..8
            stop_hash[r, 2] = stop_seq_hash(pushed[r, 32 - (r + 1):].tolist())
            stop_hlen[r, 2] = r + 1
            stop_hash[r, 0] = stop_seq_hash([1, 2, 3])   # and one that is not
            stop_hlen[r, 0] = 3
        i32 = dict(dtype=torch.int32, device=dev)
        fin = (torch.tensor([3, 2, 6, 9, 9, 2, 9, 4], **i32),
               torch.tensor([40, 41, 42, 62, 61, 43, 44, 45], **i32),
               torch.tensor([0, 5, 0, 0, 0, 0, 0, 0], **i32),
               torch.tensor([99, 99, 7, 99, 99, 99, 99, 99], **i32),
               stop_ids, ring, stop_hash, stop_hlen)
    c_ker, c_ref = counts.clone(), counts.clone()
    before = epilogue.launches
    out = epilogue.fused_sampling_epilogue(
        logits, gumbel, samp, c_ker, seen, bias, slots, live, extra_bias=extra,
        finish=fin, max_model_len=64)
    ref = epilogue.fused_sampling_epilogue_ref(
        logits, gumbel, samp, c_ref, seen, bias, slots, live, extra_bias=extra,
        finish=fin, max_model_len=64)
    torch.cuda.synchronize()
    assert epilogue.launches == before + 1     # one launch, whatever the form
    assert len(out) == len(ref) == (3 if fin is None else 6)
    assert out[0].tolist() == ref[0].tolist()
    assert torch.equal(c_ker, c_ref) and torch.equal(c_ker[6], counts[6])
    torch.testing.assert_close(out[1], ref[1], atol=1e-4, rtol=1e-4)
    if extra is not None:
        assert int(out[0][5]) in (17, v - 2)
    if fin is not None:
        assert out[3].tolist() == ref[3].tolist() == [
            True, False, True, True, False, False, True, False]
        assert out[4].tolist() == ref[4].tolist() == [
            True, False, True, True, True, False, True, False]
        assert torch.equal(out[5], ref[5]) and torch.equal(out[5][6], fin[5][6])


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


@pytest.mark.cuda
@pytest.mark.parametrize("prefix_len", [0, 1, 15, 16, 17, 160])
def test_sp_prefix_kernel_matches_plain_version(prefix_len):
    """The prefix partials kernel for 4 ranks sharing one broadcast block
    table row (stride 0), a partial last page and a partial query tile
    (S 20 of the 32 positions a CTA holds at G 4), layer 2. The same bf16 values on both
    sides in f32: only the summation order differs (m to 1e-4; l and acc to
    1e-3 of their scale). The empty prefix is exact."""
    _sp_prefix_case(prefix_len, d=64)


@pytest.mark.cuda
@pytest.mark.parametrize("prefix_len", [0, 17, 160])
def test_sp_prefix_kernel_matches_plain_version_d128(prefix_len):
    """head_dim 128, the library's second instantiation, at the same
    tolerances."""
    _sp_prefix_case(prefix_len, d=128)


def _sp_prefix_case(prefix_len, d, h=8):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    k, v = _cache(g, d=d)
    row = torch.randperm(40, generator=g, device="cuda")[:10].int()[None]
    bt = row.expand(4, 10)
    q = torch.randn(4, 20, h, d, generator=g, device="cuda").bfloat16()
    before = sp_prefix.launches
    acc, m, l = sp_prefix.paged_prefix_attention_partials(
        q, k, v, bt, prefix_len, 2)
    ref = sp_prefix.paged_prefix_attention_partials_ref(
        q.float(), k.float(), v.float(), bt, prefix_len, 2)
    torch.cuda.synchronize()
    assert sp_prefix.launches == before + 1
    if prefix_len == 0:
        assert (m == sp_prefix.MASK_VALUE).all()
        assert (l == 0).all() and (acc == 0).all()
        return
    torch.testing.assert_close(m, ref[1], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, ref[2], atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(acc, ref[0], atol=1e-3 * float(ref[0].abs().max()),
                               rtol=1e-3)


# the MLA split plan's edges in a 1,280-key table (80 pages of 16: ten
# 128-key splits in two clusters of 8): no key, one, a tile's edges, a
# split's last key and the first of the next, a cluster's last key and the
# first of the next cluster, the full table, and a context past the table
# (only the table's keys count)
MLA_EDGE_CTX = [0, 1, 63, 64, 65, 128, 129, 1024, 1025, 1280, 1300]


@pytest.mark.cuda
@pytest.mark.parametrize("ctx", MLA_EDGE_CTX)
@pytest.mark.parametrize("h", [16, 20, 128])
def test_mla_decode_kernel_split_and_tile_edges(h, ctx):
    """One row at the tile, split and cluster edges, at 16 heads (one
    group), 20 (a ragged second group) and 128 (DeepSeek-V2/V3: eight
    groups); two calls bit-identical; ctx 0 gives zeros."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(6)
    layers, n, bs, w = 2, 96, 16, 80
    c = torch.randn(layers, n, bs, 1, 512, generator=g, device="cuda").bfloat16()
    kr = torch.randn(layers, n, bs, 1, 64, generator=g, device="cuda").bfloat16()
    bt = torch.randperm(n, generator=g, device="cuda")[:w][None].int()
    ctx_t = torch.tensor([ctx], dtype=torch.int32, device="cuda")
    q_lat = torch.randn(1, 1, h, 512, generator=g, device="cuda").bfloat16()
    q_rope = torch.randn(1, 1, h, 64, generator=g, device="cuda").bfloat16()
    assert mla_decode.plan(w * bs) == (128, 16, 8)
    before = mla_decode.launches
    out = mla_decode.mla_paged_decode_attention(q_lat, q_rope, c, kr, bt, ctx_t,
                                                layer_idx=1, scale=0.11472)
    again = mla_decode.mla_paged_decode_attention(q_lat, q_rope, c, kr, bt, ctx_t,
                                                  layer_idx=1, scale=0.11472)
    ref = mla_decode.mla_paged_decode_attention_ref(
        q_lat.float(), q_rope.float(), c.float(), kr.float(), bt, ctx_t, 1, 0.11472)
    torch.cuda.synchronize()
    assert mla_decode.launches == before + 2
    assert torch.equal(out, again)
    if ctx == 0:
        assert not out.any()
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=RTOL)


# 50,257 (GPT-2's) is not a multiple of 8: the kernel reads it an entry at a time
EPILOGUE_WIDTHS = [1000, 32000, 50257, 102400, 128256, 151936, 201088, 256000]


def _cluster_epilogue_inputs(g, b, v):
    """``b`` rows cycling the mixed regimes of ``_epilogue_inputs``, row 0
    the tie row (top-k 12, top-p 0.55): 10 tokens tied at the top around
    the first CTA-slice boundary (the top-p cut falls inside them, so ties
    on both sides of it are counted in index order) and 5 tied at the top-k
    cut around the second boundary."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams

    dev = "cuda"
    _, sl, _ = epilogue.cluster_plan(v)
    logits = (torch.randn(b, v, generator=g, device=dev) * 4).bfloat16()
    counts = torch.randint(0, 3, (b, v), generator=g, device=dev, dtype=torch.int32)
    seen = torch.randint(0, 2, (b, v), generator=g, device=dev).bool()
    bias = torch.randn(b, v, generator=g, device=dev) * 0.5
    row = torch.full((v,), -20.0, device=dev)
    row[sl - 5:sl + 5] = 8.0
    row[2 * sl - 2:2 * sl + 3] = 6.0
    logits[0] = row.bfloat16()
    counts[0], seen[0], bias[0] = 0, False, 0.0
    regime = [(r + 7) % 8 for r in range(b)]

    def f(vals, dtype=torch.float32):
        return torch.tensor([vals[i] for i in regime], dtype=dtype, device=dev)

    samp = SamplingParams(
        temperature=f([0.0, 0.7, 1.0, 1.3, 0.9, 0.0, 0.8, 1.0]),
        top_k=f([0, 5, 0, 0, 3, 0, 1, 12], torch.int64),
        top_p=f([1.0, 1.0, 0.9, 1.0, 0.8, 1.0, 1.0, 0.55]),
        min_p=f([0.0, 0.0, 0.0, 0.2, 0.05, 0.0, 0.0, 0.0]),
        presence_penalty=f([0.0, 0.5, 0.0, 1.1, 0.0, 0.0, 0.0, 0.0]),
        frequency_penalty=f([0.0, 0.0, 0.3, 0.2, 0.0, 0.0, 0.0, 0.0]),
        repetition_penalty=f([1.0, 1.2, 1.0, 1.05, 1.3, 1.0, 1.0, 1.0]),
    )
    u = torch.rand(b, v, generator=g, device=dev).clamp_(min=1e-30)
    gumbel = -torch.log(-torch.log(u))
    return logits, gumbel, samp, counts, seen, bias, torch.arange(b, device=dev)


def _cluster_finish_rows(g, tokens, live, v):
    """Finish carry rows for ``tokens``: a stop id hit on even rows, a
    matching suffix of length 1-8 and a non-matching one on every row,
    ``max_new`` reached every third row, the horizon every fifth."""
    from dynamo_tpu_torch.engine.sampling import stop_seq_hash

    dev = "cuda"
    b = len(tokens)
    i32 = dict(dtype=torch.int32, device=dev)
    ring = torch.randint(0, v, (b, 32), generator=g, device=dev).int()
    ring[0, :20] = -1
    tok = torch.tensor(tokens, **i32)
    pushed = torch.where(live[:, None], torch.cat([ring[:, 1:], tok[:, None]], 1), ring)
    stop_ids = torch.full((b, 16), -1, **i32)
    stop_ids[::2, 3] = tok[::2]
    stop_hash = torch.zeros((b, 4), dtype=torch.int64, device=dev)
    stop_hlen = torch.zeros((b, 4), **i32)
    for r in range(b):
        n = r % 8 + 1
        stop_hash[r, 1] = stop_seq_hash(pushed[r, 32 - n:].tolist())
        stop_hlen[r, 1] = n
        stop_hash[r, 3] = stop_seq_hash([1, 2, 3])
        stop_hlen[r, 3] = 3
    rows = torch.arange(b, device=dev)
    gen = (rows % 10).int()
    pos = torch.where(rows % 5 == 0, 62, 40).int()
    min_new = torch.where(rows % 4 == 2, 9, 0).int()
    max_new = torch.where(rows % 3 == 0, gen + 1, 99).int()
    return gen, pos, min_new, max_new, stop_ids, ring, stop_hash, stop_hlen


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["plain", "finish", "extra_bias", "both"])
@pytest.mark.parametrize("b", [1, 8, 33])
@pytest.mark.parametrize("v", EPILOGUE_WIDTHS)
def test_epilogue_cluster_kernel_widths_and_batches(v, b, form):
    """Every vocabulary from 1,000 to 256,000 (Gemma's) at batch 1, 8 and
    33 in every form (one width not a multiple of 8): tokens, counts and the finish outputs equal the
    plain version's, logprobs within 1e-4, two calls bit-identical; the
    tie row straddles CTA-slice boundaries at both cuts."""
    _need_cuda()
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)
    logits, gumbel, samp, counts, seen, bias, slots = _cluster_epilogue_inputs(g, b, v)
    live = torch.arange(b, device=dev) % 7 != 6
    extra = None
    if form in ("extra_bias", "both"):
        extra = torch.zeros(b, v, device=dev)
        extra[b - 1] = -1e9
        extra[b - 1, [17, v - 2]] = 0.0      # a guided row with two ids
    fin = None
    if form in ("finish", "both"):
        tok0 = epilogue.fused_sampling_epilogue_ref(
            logits, gumbel, samp, counts.clone(), seen, bias, slots, live,
            extra_bias=extra)[0].tolist()
        fin = _cluster_finish_rows(g, tok0, live, v)
    outs = []
    for _ in range(2):
        c_ker = counts.clone()
        before = epilogue.launches
        out = epilogue.fused_sampling_epilogue(
            logits, gumbel, samp, c_ker, seen, bias, slots, live,
            extra_bias=extra, finish=fin, max_model_len=64)
        assert epilogue.launches == before + 1
        outs.append(out)
    c_ref = counts.clone()
    ref = epilogue.fused_sampling_epilogue_ref(
        logits, gumbel, samp, c_ref, seen, bias, slots, live,
        extra_bias=extra, finish=fin, max_model_len=64)
    torch.cuda.synchronize()
    out, again = outs
    assert len(out) == len(ref) == (3 if fin is None else 6)
    for a, a2 in zip(out, again):
        assert torch.equal(a, a2)
    assert out[0].tolist() == ref[0].tolist()
    assert torch.equal(out[2], c_ref)
    torch.testing.assert_close(out[1], ref[1], atol=1e-4, rtol=1e-4)
    if extra is not None:
        assert int(out[0][b - 1]) in (17, v - 2)
    if fin is not None:
        for a, r in zip(out[3:], ref[3:]):
            assert torch.equal(a, r.to(a.dtype))
    if extra is None or b > 1:
        # the tie row keeps the 6 highest indices of the 10 top ties, one
        # in the first CTA's slice and five in the second's
        _, sl, _ = epilogue.cluster_plan(v)
        assert sl - 1 <= int(out[0][0]) <= sl + 4


@pytest.mark.cuda
def test_epilogue_cluster_plan_matches_the_library():
    """The wrapper's copy of the cluster plan is the library's."""
    _need_cuda()
    from dynamo_tpu_torch.ops import _build

    lib = _build.load("sampling_epilogue")
    lib.sampling_epilogue_smem_bytes.restype = ctypes.c_longlong
    assert lib.sampling_epilogue_cluster_size() == epilogue.CLUSTER
    for v in EPILOGUE_WIDTHS + [1, 7, epilogue.MAX_VOCAB]:
        assert lib.sampling_epilogue_smem_bytes(v) == epilogue.cluster_plan(v)[2]
    assert lib.sampling_epilogue_smem_bytes(epilogue.MAX_VOCAB + 1) == -1


@pytest.mark.cuda
def test_epilogue_kernel_refuses_a_vocabulary_above_the_limit():
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(8)
    v = epilogue.MAX_VOCAB + 1
    logits, gumbel, samp, counts, seen, bias, slots = _epilogue_inputs(g, b=8, v=v)
    before = epilogue.launches
    with pytest.raises(NotImplementedError, match=f"vocabulary {v} "):
        epilogue.fused_sampling_epilogue(
            logits, gumbel, samp, counts, seen, bias, slots,
            torch.ones(8, dtype=torch.bool, device="cuda"))
    assert epilogue.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("v", [1000, 128256])
def test_epilogue_topk_candidate_bound_edges(v):
    """Rows around the kernel's candidate bound (the k-th largest of the
    cluster's 128 warp maxima) and its two selection paths (rank 0 over a
    gathered candidate list, or the whole cluster over its slices): top-k
    128 and 129, 1 and 300, a row whose 3,000 top values tie across every
    CTA slice (top-k 5, and top-k 5 with top-p 0.3 cutting inside the
    ties), min-p over the candidates, a flat row (temperature 4) under
    top-p 0.95 whose nucleus the candidates cannot hold, min-p alone, and
    top-p over a row biased to -1e9 but for three ids (as a guided row);
    tokens and counts equal the plain version's, logprobs within 1e-4."""
    _need_cuda()
    from dynamo_tpu_torch.engine.sampling import SamplingParams

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(9)
    b = 11
    logits = (torch.randn(b, v, generator=g, device=dev) * 4).bfloat16()
    ties = torch.randperm(v, generator=g, device=dev)[:min(3000, v // 2)]
    for r in (3, 4):
        row = torch.randn(v, generator=g, device=dev) - 10.0
        row[ties] = 5.0
        logits[r] = row.bfloat16()
    counts = torch.zeros(b, v, dtype=torch.int32, device=dev)
    seen = torch.zeros(b, v, dtype=torch.bool, device=dev)
    bias = torch.zeros(b, v, device=dev)
    allowed = [3, v // 2, v - 1]
    bias[10] = -1e9
    bias[10, allowed] = 0.0
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    samp = SamplingParams(
        temperature=f([1.0, 0.8, 1.2, 1.0, 1.0, 0.7, 1.0, 0.9, 4.0, 1.0, 1.0]),
        top_k=torch.tensor([128, 129, 1, 5, 5, 40, 128, 300, 0, 0, 0], device=dev),
        top_p=f([1.0, 1.0, 1.0, 1.0, 0.3, 0.9, 0.5, 1.0, 0.95, 1.0, 0.9]),
        min_p=f([0.0, 0.0, 0.0, 0.0, 0.0, 0.1, 0.0, 0.05, 0.0, 0.3, 0.0]),
        presence_penalty=f([0.0] * b), frequency_penalty=f([0.0] * b),
        repetition_penalty=f([1.0] * b))
    u = torch.rand(b, v, generator=g, device=dev).clamp_(min=1e-30)
    gumbel = -torch.log(-torch.log(u))
    slots = torch.arange(b, device=dev)
    live = torch.ones(b, dtype=torch.bool, device=dev)
    c_ker, c_ref = counts.clone(), counts.clone()
    tok, lps, _ = epilogue.fused_sampling_epilogue(
        logits, gumbel, samp, c_ker, seen, bias, slots, live)
    tok_r, lps_r, _ = epilogue.fused_sampling_epilogue_ref(
        logits, gumbel, samp, c_ref, seen, bias, slots, live)
    torch.cuda.synchronize()
    assert tok.tolist() == tok_r.tolist()
    assert torch.equal(c_ker, c_ref)
    torch.testing.assert_close(lps, lps_r, atol=1e-4, rtol=1e-4)
    assert int(tok[3]) in ties.tolist() and int(tok[4]) in ties.tolist()
    assert int(tok[10]) in allowed


# GPT-OSS's attention sinks: 16 heads over 2 KV heads (G 8, gpt-oss-20b's
# group), sinks ~ N(0, 4^2) so some lie above every score (scores ~ N(0, 1))
def _sinks(g, h=16):
    return torch.randn(h, generator=g, device="cuda") * 4.0


@pytest.mark.cuda
@pytest.mark.parametrize("window", [paged_decode.NO_WINDOW, 128])
def test_decode_kernel_sinks_at_split_edges(window):
    """The sink form at the splits' edges (one exit per split count: a
    single live split stores, several merge), a ctx-0 row of zeros; two
    calls bit-identical."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(11)
    k, v = _cache(g, blocks=400)
    n = len(SPLIT_EDGE_CTX)
    bt = torch.randperm(400, generator=g, device="cuda")[: n * 48].reshape(n, 48).int()
    ctx = torch.tensor(SPLIT_EDGE_CTX, dtype=torch.int32, device="cuda")
    q = torch.randn(n, 1, 16, 64, generator=g, device="cuda").bfloat16()
    sinks = _sinks(g)
    out = paged_decode.paged_decode_attention(q, k, v, bt, ctx, layer_idx=2,
                                              window=window, sinks=sinks)
    again = paged_decode.paged_decode_attention(q, k, v, bt, ctx, layer_idx=2,
                                                window=window, sinks=sinks)
    ref = paged_decode.paged_decode_attention_ref(
        q.float(), k.float(), v.float(), bt, ctx, 2, None, window, sinks)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert not out[0].any()  # ctx 0: zeros
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [5, 17, 32])  # G 8: 40, 136 and 256 rows
@pytest.mark.parametrize("window", [paged_verify.NO_WINDOW, 128])
@pytest.mark.parametrize("with_sinks", [False, True])
def test_verify_kernel_query_parts_and_sinks(s, window, with_sinks):
    """At G 8, S 17 and 32 need more than the 128 rows of a CTA: the tail is
    cut into two query parts over the same keys. Split edges, a pad row;
    two calls bit-identical; with and without sinks."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(12)
    k, v = _cache(g, blocks=400)
    rows = [(255 - s, 255), (256 - s, 256), (257 - s, 257), (500, 500 + s),
            (700, 700 + s - 1), None]
    n = len(rows)
    bt = torch.randperm(400, generator=g, device="cuda")[: n * 48].reshape(n, 48).int()
    bt[-1] = 0
    rows = [r or (0, 1) for r in rows]
    q = torch.randn(n, s, 16, 64, generator=g, device="cuda").bfloat16()
    b = torch.tensor([r[0] for r in rows], dtype=torch.int32, device="cuda")
    c = torch.tensor([r[1] for r in rows], dtype=torch.int32, device="cuda")
    sinks = _sinks(g) if with_sinks else None
    out = paged_verify.paged_verify_attention(q, k, v, bt, b, c, layer_idx=1,
                                              window=window, sinks=sinks)
    again = paged_verify.paged_verify_attention(q, k, v, bt, b, c, layer_idx=1,
                                                window=window, sinks=sinks)
    ref = paged_verify.paged_verify_attention_ref(
        q.float(), k.float(), v.float(), bt, b, c, 1, None, window, sinks)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert out.float().isfinite().all()
    for i, (base, ctx) in enumerate(rows):
        valid = min(s, ctx - base)
        torch.testing.assert_close(out[i, :valid].float(), ref[i, :valid],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [paged_flash.NO_WINDOW, 20])
def test_flash_kernel_sinks(window):
    """The sink form over a batched prefill step (from 0, a prefix hit, a
    padded tail, a pad row) at G 8."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(13)
    k, v = _cache(g)
    rows = [(0, 40), (20, 84), (48, 60), None]
    n, s = len(rows), 64
    bt = torch.randperm(40, generator=g, device="cuda")[: n * 6].reshape(n, 6).int()
    bt[-1] = 0
    rows = [r or (0, 1) for r in rows]
    q = torch.randn(n, s, 16, 64, generator=g, device="cuda").bfloat16()
    b = torch.tensor([r[0] for r in rows], dtype=torch.int32, device="cuda")
    c = torch.tensor([r[1] for r in rows], dtype=torch.int32, device="cuda")
    sinks = _sinks(g)
    before = paged_flash.launches
    out = paged_flash.paged_flash_attention(q, k, v, bt, b, c, layer_idx=1,
                                            window=window, sinks=sinks)
    ref = paged_flash.paged_flash_attention_ref(
        q.float(), k.float(), v.float(), bt, b, c, 1, None, window, sinks)
    torch.cuda.synchronize()
    assert paged_flash.launches == before + 1
    assert out.float().isfinite().all()
    for i, (base, ctx) in enumerate(rows):
        valid = min(s, ctx - base)
        torch.testing.assert_close(out[i, :valid].float(), ref[i, :valid],
                                   atol=ATOL, rtol=RTOL)


# Gemma-2's logit softcap: q scaled so the scores are ~N(0, 4^2) and a cap
# of 5 binds (tanh of most scores is far from linear); head_dim 256 with
# and without it (gemma-2-9b), 64 and 128 with it
SOFTCAP_FORMS = [(64, 5.0), (128, 5.0), (256, 5.0), (256, 0.0)]


def _softcap_q(g, shape):
    return (torch.randn(shape, generator=g, device="cuda") * 4.0).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("d,cap", SOFTCAP_FORMS)
@pytest.mark.parametrize("h", [4, 16])  # G 2 (gemma-2-9b) and 8
@pytest.mark.parametrize("window", [paged_decode.NO_WINDOW, 300])
def test_decode_kernel_softcap_and_d256_at_split_edges(d, cap, h, window):
    """The softcap and head_dim-256 forms at the splits' edges, a window
    that crosses a split, a ctx-0 row of zeros; two calls bit-identical."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(21)
    k, v = _cache(g, blocks=400, d=d)
    n = len(SPLIT_EDGE_CTX)
    bt = torch.randperm(400, generator=g, device="cuda")[: n * 48].reshape(n, 48).int()
    ctx = torch.tensor(SPLIT_EDGE_CTX, dtype=torch.int32, device="cuda")
    q = _softcap_q(g, (n, 1, h, d))
    kw = dict(layer_idx=2, window=window, softcap=cap)
    before = paged_decode.launches
    out = paged_decode.paged_decode_attention(q, k, v, bt, ctx, **kw)
    again = paged_decode.paged_decode_attention(q, k, v, bt, ctx, **kw)
    ref = paged_decode.paged_decode_attention_ref(
        q.float(), k.float(), v.float(), bt, ctx, 2, None, window, None, cap)
    torch.cuda.synchronize()
    assert paged_decode.launches == before + 2
    assert torch.equal(out, again)
    assert not out[0].any()  # ctx 0: zeros
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,cap", SOFTCAP_FORMS)
@pytest.mark.parametrize("h,s", [(4, 5), (4, 32), (16, 17)])  # 10, 64, 136 rows
@pytest.mark.parametrize("window", [paged_verify.NO_WINDOW, 300])
def test_verify_kernel_softcap_and_d256_at_split_edges(d, cap, h, s, window):
    """Verify tails at a 256-key split's edges and a pad row in the softcap
    and head_dim-256 forms, up to 64 rows a CTA and two query parts; two
    calls bit-identical."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(22)
    k, v = _cache(g, blocks=400, d=d)
    rows = [(255 - s, 255), (256 - s, 256), (257 - s, 257), (256, 256 + s),
            (700, 700 + s - 1), None]
    n = len(rows)
    bt = torch.randperm(400, generator=g, device="cuda")[: n * 48].reshape(n, 48).int()
    bt[-1] = 0
    rows = [r or (0, 1) for r in rows]
    q = _softcap_q(g, (n, s, h, d))
    b = torch.tensor([r[0] for r in rows], dtype=torch.int32, device="cuda")
    c = torch.tensor([r[1] for r in rows], dtype=torch.int32, device="cuda")
    kw = dict(layer_idx=1, window=window, softcap=cap)
    out = paged_verify.paged_verify_attention(q, k, v, bt, b, c, **kw)
    again = paged_verify.paged_verify_attention(q, k, v, bt, b, c, **kw)
    ref = paged_verify.paged_verify_attention_ref(
        q.float(), k.float(), v.float(), bt, b, c, 1, None, window, None, cap)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert out.float().isfinite().all()
    for i, (base, ctx) in enumerate(rows):
        valid = min(s, ctx - base)
        torch.testing.assert_close(out[i, :valid].float(), ref[i, :valid],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,cap", SOFTCAP_FORMS)
@pytest.mark.parametrize("window", [paged_flash.NO_WINDOW, 20])
def test_flash_kernel_softcap_and_d256(d, cap, window):
    """The softcap and head_dim-256 forms over a batched prefill step (from
    0, a prefix hit, a padded tail, a pad row) at G 2."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(23)
    k, v = _cache(g, d=d)
    rows = [(0, 40), (20, 84), (48, 60), None]
    n, s = len(rows), 64
    bt = torch.randperm(40, generator=g, device="cuda")[: n * 6].reshape(n, 6).int()
    bt[-1] = 0
    rows = [r or (0, 1) for r in rows]
    q = _softcap_q(g, (n, s, 4, d))
    b = torch.tensor([r[0] for r in rows], dtype=torch.int32, device="cuda")
    c = torch.tensor([r[1] for r in rows], dtype=torch.int32, device="cuda")
    before = paged_flash.launches
    out = paged_flash.paged_flash_attention(q, k, v, bt, b, c, layer_idx=1,
                                            window=window, softcap=cap)
    ref = paged_flash.paged_flash_attention_ref(
        q.float(), k.float(), v.float(), bt, b, c, 1, None, window, None, cap)
    torch.cuda.synchronize()
    assert paged_flash.launches == before + 1
    assert out.float().isfinite().all()
    for i, (base, ctx) in enumerate(rows):
        valid = min(s, ctx - base)
        torch.testing.assert_close(out[i, :valid].float(), ref[i, :valid],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_sp_prefix_kernel_refuses_head_dim_256_by_name():
    """Two warpgroups at head_dim 256 would need 263,168 bytes of shared
    memory: the partials kernel keeps 64 and 128 and refuses 256 before
    any launch."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(24)
    k, v = _cache(g, d=256)
    q = torch.randn(2, 64, 4, 256, generator=g, device="cuda").bfloat16()
    bt = torch.zeros(2, 6, dtype=torch.int32, device="cuda")
    before = sp_prefix.launches
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        sp_prefix.paged_prefix_attention_partials(q, k, v, bt, 17, 1)
    assert sp_prefix.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mixtral", "llama"])
def test_quantized_tiny_engine_serves_through_the_kernels(family):
    """An int8 engine on the card (a tiny Mixtral-family or Llama trunk,
    head_dim 64): every quantized leaf stays int8 on the card, greedy
    requests stream through the decode, flash and epilogue kernels, and a
    prefill's logits stay within 5e-2 relative L2 of the CPU's f32 forward
    over the same ``q`` and ``scale`` (the Mixtral trunk's routing pinned:
    a bf16 rounding can flip a top-2 choice, a jump rather than a near
    tie)."""
    _need_cuda()
    import asyncio

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.models import quant
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    experts = dict(num_experts=4, num_experts_per_tok=2) if family == "mixtral" else {}
    model = ModelConfig(vocab_size=1000, hidden_size=256, intermediate_size=512,
                        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                        quantization="int8", **experts)
    cfg = EngineConfig(model=model, max_batch_size=4, max_model_len=256,
                       kv_block_size=16, num_kv_blocks=64, dtype="bfloat16")
    prompts = [[int(t) for t in torch.randint(3, 1000, (n,),
                                              generator=torch.Generator().manual_seed(n))]
               for n in (40, 90, 7)]

    async def serve():
        engine = await TorchServingEngine.create(cfg, device="cuda", warmup=False)
        try:
            async def one(p):
                req = PreprocessedRequest(
                    token_ids=p, stop_conditions=StopConditions(
                        max_tokens=8, ignore_eos=True),
                    sampling_options=SamplingOptions(temperature=0.0))
                toks = []
                async for out in engine.generate(Context(req)):
                    toks.extend(out["token_ids"])
                return toks
            return engine.runner, await asyncio.gather(*(one(p) for p in prompts))
        finally:
            await engine.close()

    launches = (paged_decode.launches, paged_flash.launches, epilogue.launches)
    runner, streams = asyncio.run(serve())
    assert all(len(t) == 8 for t in streams)
    assert paged_decode.launches > launches[0]
    assert paged_flash.launches > launches[1]
    assert epilogue.launches > launches[2]
    layers = runner.params["layers"]
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert layers[name].q.dtype == torch.int8 and layers[name].q.is_cuda
    assert isinstance(runner.params["lm_head"], quant.QuantizedWeight)

    def cpu_tree(tree):
        if isinstance(tree, dict):
            return {k: cpu_tree(v) for k, v in tree.items()}
        if isinstance(tree, quant.QuantizedWeight):
            return tree.to("cpu")
        return tree.float().cpu()

    arch = runner.arch
    params = runner.params
    if family == "mixtral":
        lay = params["layers"]
        bias = torch.linspace(0.0, 3.0, 4, device="cuda").bfloat16()
        params = dict(params, layers=dict(
            lay, router=torch.zeros_like(lay["router"]),
            router_bias=bias.expand(lay["router"].shape[0], 4)))
    n = 40
    bt = torch.arange(4, dtype=torch.int32)[None]
    pos = torch.arange(n, dtype=torch.int32)[None]
    ctx = torch.tensor([n], dtype=torch.int32)
    out = {}
    for dev, prm, dt in (("cuda", params, torch.bfloat16),
                         ("cpu", cpu_tree(params), torch.float32)):
        cache = arch.init_kv_cache(model, 8, 16, dt, dev)
        toks = torch.tensor([prompts[0]], dtype=torch.int32)
        with torch.inference_mode():
            logits, _ = arch.forward(prm, model, toks.to(dev), pos.to(dev),
                                     cache, bt.to(dev), pos.to(dev), ctx.to(dev))
        out[dev] = logits.float().cpu()
    rel = (out["cuda"] - out["cpu"]).norm() / out["cpu"].norm()
    assert float(rel) < 5e-2


@pytest.mark.cuda
def test_http_front_round_trip_on_the_card(tmp_path):
    """The OpenAI front in process on the card: ``cli.run.build_engine``
    over a tiny model directory (the synthetic byte-level BPE of
    ``chip_smoke``, 1,000 ids), ``HttpService`` on a free port, a streamed
    chat and a non-streamed completion from the stdlib client, through the
    decode, flash and epilogue kernels, and no KV block left in use."""
    _need_cuda()
    import asyncio
    import json

    import chip_smoke
    from dynamo_tpu_torch.cli import run
    from dynamo_tpu_torch.http.service import HttpService, ModelManager

    spec = chip_smoke.synthetic_tokenizer(vocab_size=1000, n_special=8)
    specials = [t["content"] for t in spec["added_tokens"]]
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(dict(
        chat_template=chip_smoke.LLAMA3_CHAT_TEMPLATE, bos_token=specials[0],
        eos_token=specials[1])))
    (tmp_path / "config.json").write_text(json.dumps(dict(
        model_type="llama", vocab_size=1000, hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=64, max_position_embeddings=512,
        bos_token_id=992, eos_token_id=993)))
    flags = run.parse_flags([
        "--model-path", str(tmp_path), "--model-name", "tiny",
        "--allow-random-weights", "--max-model-len", "256",
        "--num-kv-blocks", "64", "--decode-pipeline-depth", "2"])

    async def serve():
        pipe, _ = await run.build_engine("torch", flags)
        manager = ModelManager()
        manager.add_chat_model("tiny", pipe)
        manager.add_completion_model("tiny", pipe)
        service = HttpService(manager, "127.0.0.1", 0)
        await service.start()
        try:
            chat = await chip_smoke.http_request(
                service.port, "POST", "/v1/chat/completions", dict(
                    model="tiny", stream=True, max_tokens=12, temperature=0.0,
                    ignore_eos=True, logprobs=True,
                    messages=[{"role": "user", "content": "hello there"}]))
            done = await chip_smoke.http_request(
                service.port, "POST", "/v1/completions", dict(
                    model="tiny", prompt="abc " * 40, max_tokens=6,
                    ignore_eos=True))
            return chat, done, pipe.core_engine.metrics()
        finally:
            await service.stop()
            await pipe.close()

    launches = (paged_decode.launches, paged_flash.launches, epilogue.launches)
    (status, _, _, events), (status2, _, raw, _), metrics = asyncio.run(serve())
    assert status == status2 == 200
    entries = [e for _, c in events if c and c.get("choices")
               for e in ((c["choices"][0].get("logprobs") or {}).get("content")
                         or [])]
    assert len(entries) == 12
    assert json.loads(raw)["usage"]["completion_tokens"] == 6
    assert paged_decode.launches > launches[0]
    assert paged_flash.launches > launches[1]
    assert epilogue.launches > launches[2]
    assert metrics["kv_active_blocks"] == 0


# ------------------------------------------------------- fp8 (e4m3) caches

FP8 = torch.float8_e4m3fn


def _fp8_caches(g, layers=3, blocks=400, bs=16, kvh=2, d=64):
    """e4m3 K and V caches and their upcast bf16 copies (exact)."""
    shape = (layers, blocks, bs, kvh, d)
    k8, v8 = (torch.randn(shape, generator=g, device="cuda").to(FP8)
              for _ in range(2))
    return k8, v8, k8.to(torch.bfloat16), v8.to(torch.bfloat16)


FP8_FORMS = {"plain": {}, "window_sinks": dict(window=300, sinks=True),
             "softcap": dict(softcap=5.0, scale=0.25)}


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(FP8_FORMS))
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("kind", ["decode", "verify", "flash"])
def test_fp8_forms_equal_the_bf16_forms_over_the_upcast_cache(kind, d, form):
    """Each attention kernel's fp8 form over e4m3 caches returns bit for bit
    what its bf16 form returns over the caches upcast to bf16 (every e4m3
    value is a bf16 value and only the producer differs), at the split-KV
    edges of a 768-key table, with a window and sinks, a binding softcap, or
    neither; it launches the fp8 symbol and not the bf16 one, and stays
    within ATOL / RTOL of the f32 plain version."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(9)
    k8, v8, kb, vb = _fp8_caches(g, d=d)
    opts = FP8_FORMS[form]
    h = 8  # G 4 over two KV heads
    kw = dict(layer_idx=2, window=opts.get("window", paged_decode.NO_WINDOW),
              softcap=opts.get("softcap", 0.0),
              scale=opts.get("scale", 1.0) * d ** -0.5,
              sinks=(torch.randn(h, generator=g, device="cuda") * 2
                     if opts.get("sinks") else None))
    ctx_l = SPLIT_EDGE_CTX
    n = len(ctx_l)
    bt = torch.randperm(400, generator=g, device="cuda")[: n * 48].reshape(n, 48).int()
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device="cuda")
    if kind == "decode":
        mod, s = paged_decode, 1
        kernel, ref_fn = mod.paged_decode_attention, mod.paged_decode_attention_ref
        base = ctx - 1
        args = (bt, ctx)
    else:
        mod = paged_verify if kind == "verify" else paged_flash
        s = 17 if kind == "verify" else 64
        kernel, ref_fn = ((mod.paged_verify_attention, mod.paged_verify_attention_ref)
                          if kind == "verify" else
                          (mod.paged_flash_attention, mod.paged_flash_attention_ref))
        base = torch.clamp(ctx - s, min=0)
        args = (bt, base, ctx)
    q = torch.randn(n, s, h, d, generator=g, device="cuda").bfloat16()

    def run(k, v, fn):
        if fn is kernel:
            return fn(q, k, v, *args, **kw)
        return fn(q.float(), k, v, *args, kw["layer_idx"], kw["scale"],
                  kw["window"], kw["sinks"], kw["softcap"])

    before = (mod.launches, mod.launches_fp8)
    out8 = run(k8, v8, kernel)
    outb = run(kb, vb, kernel)
    ref = run(kb.float(), vb.float(), ref_fn)
    torch.cuda.synchronize()
    assert (mod.launches, mod.launches_fp8) == (before[0] + 1, before[1] + 1)
    assert torch.equal(out8, outb)
    for i, c in enumerate(ctx_l):  # rows past ctx are discarded by the caller
        nv = 1 if kind == "decode" else max(0, min(s, c - int(base[i])))
        torch.testing.assert_close(out8[i, :nv].float(), ref[i, :nv],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("ctx", [0, 1, 65, 129, 1025, 1280])
@pytest.mark.parametrize("h", [16, 20])
def test_mla_fp8_form_equals_the_bf16_form_over_the_upcast_cache(h, ctx):
    """The MLA kernel's fp8 form over e4m3 latent and rope caches equals its
    bf16 form over the caches upcast to bf16, bit for bit, at its tile,
    split and cluster edges; the fp8 symbol launches, not the bf16 one."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(10)
    layers, n, bs, w = 2, 96, 16, 80
    c8 = torch.randn(layers, n, bs, 1, 512, generator=g, device="cuda").to(FP8)
    kr8 = torch.randn(layers, n, bs, 1, 64, generator=g, device="cuda").to(FP8)
    bt = torch.randperm(n, generator=g, device="cuda")[:w][None].int()
    ctx_t = torch.tensor([ctx], dtype=torch.int32, device="cuda")
    q_lat = torch.randn(1, 1, h, 512, generator=g, device="cuda").bfloat16()
    q_rope = torch.randn(1, 1, h, 64, generator=g, device="cuda").bfloat16()
    before = (mla_decode.launches, mla_decode.launches_fp8)
    out8 = mla_decode.mla_paged_decode_attention(q_lat, q_rope, c8, kr8, bt,
                                                 ctx_t, layer_idx=1, scale=0.11472)
    outb = mla_decode.mla_paged_decode_attention(
        q_lat, q_rope, c8.to(torch.bfloat16), kr8.to(torch.bfloat16), bt, ctx_t,
        layer_idx=1, scale=0.11472)
    ref = mla_decode.mla_paged_decode_attention_ref(
        q_lat.float(), q_rope.float(), c8.float(), kr8.float(), bt, ctx_t, 1,
        0.11472)
    torch.cuda.synchronize()
    assert (mla_decode.launches, mla_decode.launches_fp8) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(out8, outb)
    torch.testing.assert_close(out8.float(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_fp8_writes_on_the_card_give_the_cpu_bytes():
    """``scatter_kv_stacked`` into e4m3 caches on the card writes the bytes
    the CPU writes for the same bf16 values: normals, subnormals, +-0,
    448-464 and the saturated values past 464."""
    _need_cuda()
    from dynamo_tpu_torch.ops.attention import alloc_kv_cache, scatter_kv_stacked

    g = torch.Generator().manual_seed(11)
    shape = (2, 4, 16, 2, 64)
    new = (torch.randn(2, 6, 2, 64, generator=g) * 50).bfloat16()
    new.view(-1)[:12] = torch.tensor(
        [0.0, -0.0, 2 ** -9, 3 * 2 ** -9, 2 ** -10, 448.0, 460.0, 464.0,
         -464.0, 500.0, -1e4, float("inf")]).bfloat16()
    slots = torch.tensor([[3, -1, 17, 64, 0, 5], [70, 39, 8, -1, 21, 22]])
    out = {}
    for dev in ("cpu", "cuda"):
        k, v = alloc_kv_cache(shape, FP8, dev), alloc_kv_cache(shape, FP8, dev)
        scatter_kv_stacked(k, v, new.to(dev), new.to(dev), slots.to(dev), 1)
        out[dev] = k.view(torch.uint8).cpu()
    torch.cuda.synchronize()
    assert torch.equal(out["cpu"], out["cuda"])


# ------------------------------------------- GQA groups that leave spare rows

# Qwen2.5-7B's 7 query heads a KV head and Qwen2.5-32B's 5, over two KV
# heads: flash holds 9 and 12 positions a CTA (63 and 60 of 64 rows), the
# prefix partials 18 and 25 (126 and 125 of 128)
ODD_GROUPS = [(14, 2), (10, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh", ODD_GROUPS)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("window", [paged_flash.NO_WINDOW, 20])
def test_flash_kernel_groups_that_leave_spare_rows(h, kvh, d, window):
    """A batched step (from 0, a prefix hit, a padded tail, a pad row) at
    G 7 and 5: every valid row within ATOL / RTOL of the plain version, and
    the query tiles past ctx zero."""
    out = _flash_case(76, [(20, 96), (0, 50), (30, 40), None], d=d, h=h,
                      kvh=kvh, window=window)
    bq = 64 // (h // kvh)
    assert not out[2, -(-10 // bq) * bq:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh", ODD_GROUPS)
def test_flash_fp8_form_groups_that_leave_spare_rows(h, kvh):
    """The fp8 form at G 7 and 5 equals the bf16 form over the cache upcast
    to bf16, bit for bit."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(12)
    k8, v8, kb, vb = _fp8_caches(g, d=128)
    bt = torch.randperm(400, generator=g, device="cuda")[:12].reshape(2, 6).int()
    q = torch.randn(2, 40, h, 128, generator=g, device="cuda").bfloat16()
    b = torch.tensor([0, 30], dtype=torch.int32, device="cuda")
    c = torch.tensor([40, 70], dtype=torch.int32, device="cuda")
    out8 = paged_flash.paged_flash_attention(q, k8, v8, bt, b, c, layer_idx=1)
    outb = paged_flash.paged_flash_attention(q, kb, vb, bt, b, c, layer_idx=1)
    ref = paged_flash.paged_flash_attention_ref(
        q.float(), kb.float(), vb.float(), bt, b, c, 1)
    torch.cuda.synchronize()
    assert torch.equal(out8, outb)
    torch.testing.assert_close(out8.float(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [14, 10])
@pytest.mark.parametrize("prefix_len", [0, 17, 160])
def test_sp_prefix_kernel_groups_that_leave_spare_rows(h, prefix_len):
    _sp_prefix_case(prefix_len, d=128, h=h)


def _write_safetensors(path, tensors):
    """A safetensors file by its format (8-byte header length, JSON
    header, the tensors' bytes): the card's machine has no writer."""
    import json
    import struct

    header, blobs, off = {}, [], 0
    names = {torch.bfloat16: "BF16", torch.float32: "F32"}
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).reshape(-1).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * ((-len(head)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))


@pytest.mark.cuda
@pytest.mark.parametrize("quantization", [None, "int8"])
def test_safetensors_round_trip_onto_the_card(tmp_path, quantization):
    """A tiny Qwen2-shaped checkpoint (G 7, qkv biases) loaded onto the card
    equals the CPU's load leaf for bit (int8: ``q`` and ``scale`` too), and
    the runner on the card serves it."""
    _need_cuda()
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.model_runner import ModelRunner
    from dynamo_tpu_torch.models import loader, resolve
    from dynamo_tpu_torch.models.quant import QuantizedWeight

    cfg = ModelConfig.from_hf_config({
        "architectures": ["Qwen2ForCausalLM"], "vocab_size": 256,
        "hidden_size": 112, "intermediate_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 14, "num_key_value_heads": 2,
        "tie_word_embeddings": False})
    cfg.quantization = quantization
    g = torch.Generator().manual_seed(0)
    tensors = {"model.embed_tokens.weight": torch.randn(256, 112, generator=g),
               "model.norm.weight": torch.ones(112),
               "lm_head.weight": torch.randn(256, 112, generator=g).bfloat16()}
    shapes = {"self_attn.q_proj": (112, 112), "self_attn.k_proj": (16, 112),
              "self_attn.v_proj": (16, 112), "self_attn.o_proj": (112, 112),
              "mlp.gate_proj": (64, 112), "mlp.up_proj": (64, 112),
              "mlp.down_proj": (112, 64)}
    for i in range(2):
        p = f"model.layers.{i}."
        tensors[p + "input_layernorm.weight"] = torch.rand(112, generator=g)
        tensors[p + "post_attention_layernorm.weight"] = torch.rand(112, generator=g)
        for name, shape in shapes.items():
            tensors[p + name + ".weight"] = (
                torch.randn(shape, generator=g) * 0.1).bfloat16()
        for name in ("q_proj", "k_proj", "v_proj"):
            tensors[p + f"self_attn.{name}.bias"] = torch.randn(
                shapes[f"self_attn.{name}"][0], generator=g)
    _write_safetensors(tmp_path / "model.safetensors", tensors)
    cpu = loader.load_llama_params(str(tmp_path), cfg, torch.bfloat16, "cpu")
    card = loader.load_llama_params(str(tmp_path), cfg, torch.bfloat16, "cuda")
    flat = dict(card["layers"], **{k: v for k, v in card.items() if k != "layers"})
    want = dict(cpu["layers"], **{k: v for k, v in cpu.items() if k != "layers"})
    assert sorted(flat) == sorted(want)
    for name, leaf in want.items():
        got = flat[name]
        if isinstance(leaf, QuantizedWeight):
            assert got.q.is_cuda and torch.equal(got.q.cpu(), leaf.q), name
            assert torch.equal(got.scale.cpu(), leaf.scale), name
        else:
            assert got.is_cuda and torch.equal(got.cpu(), leaf), name
    runner = ModelRunner(EngineConfig(model=cfg, max_batch_size=1,
                                      max_model_len=64, kv_block_size=16,
                                      num_kv_blocks=8),
                         model_dir=str(tmp_path))
    assert resolve(cfg).__name__.endswith("llama")
    assert runner.params["layers"]["bq"].is_cuda
