"""The kernel build cache, the head_dim guards of the attention kernels
and the split-KV launch plan, on the CPU (no ``nvcc``, no card).

- ``_build.library_path`` names a library by a hash of its source and
  every ``csrc`` header the source includes, so an edited header rebuilds
  (checked on a temporary ``CSRC``);
- the flash, prefix-partials, decode and verify wrappers accept the
  head_dims their library instantiates (64, 128 and, but for the
  prefix partials, 256) and refuse others by name before any launch
  (``_check_cuda_inputs`` on CPU tensors); flash and the prefix partials
  take any GQA group up to a CTA's rows (64, 128), 5 and 7 among them;
- ``splitkv.plan`` cuts a block table into splits from its width alone;
- the split-KV and flash CTAs' shared memory stays under the card's limit
  at every shape the wrappers accept, head_dim 256 included, and a split-KV
  shape past it raises by name;
- the MLA decode kernel's plan cuts a row the same at every table width
  (128-key splits in clusters of 8), its counters and workspace are kept
  per device and grow;
- the sampling epilogue's cluster plan (slice a CTA, shared memory a CTA)
  and its vocabulary limit, with no library loaded.
"""

import inspect

import pytest
import torch

from dynamo_tpu_torch.ops import (
    _build,
    epilogue,
    mla_decode,
    paged_decode,
    paged_flash,
    paged_verify,
    sp_prefix,
    splitkv,
)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary CSRC: a.cu includes h.cuh, which includes g.cuh;
    other.cuh is included by nobody; b.cu includes nothing."""
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n#include "h.cuh"\nA\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n# include "g.cuh"\nH\n')
    (tmp_path / "g.cuh").write_text("G\n")
    (tmp_path / "other.cuh").write_text("O\n")
    (tmp_path / "b.cu").write_text("B\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "SOURCES", {"a": "a.cu", "b": "b.cu"})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path


@pytest.mark.parametrize("edited,rebuilds_a", [
    ("a.cu", True), ("h.cuh", True), ("g.cuh", True), ("other.cuh", False),
])
def test_library_path_covers_included_headers(csrc, edited, rebuilds_a):
    before = {n: _build.library_path(n) for n in ("a", "b")}
    assert before["a"] == _build.library_path("a")  # stable
    assert before["a"].parent == csrc / "_build"
    (csrc / edited).write_text((csrc / edited).read_text() + "// edited\n")
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert (after["a"] != before["a"]) == rebuilds_a
    assert after["b"] == before["b"]  # b includes none of them


def test_library_path_survives_an_include_cycle(csrc):
    (csrc / "g.cuh").write_text('#include "h.cuh"\nG\n')
    path = _build.library_path("a")
    (csrc / "g.cuh").write_text('#include "h.cuh"\nG2\n')
    assert _build.library_path("a") != path


def test_prefill_kernels_share_the_tensor_core_header():
    for name in ("paged_flash", "sp_prefix"):
        deps = [p.name for p in _build._sources(_build.CSRC / _build.SOURCES[name], [])]
        # the e4m3 upcast of the fp8 forms comes in through the core
        assert deps == [_build.SOURCES[name], "paged_attn_tc.cuh", "kv_fp8.cuh"]


def test_decode_and_verify_share_the_splitkv_header():
    for name in ("paged_decode", "paged_verify"):
        deps = [p.name for p in _build._sources(_build.CSRC / _build.SOURCES[name], [])]
        assert deps == [_build.SOURCES[name], "paged_splitkv.cuh", "kv_fp8.cuh"]


def _flash_inputs(d, h=8, kvh=2):
    q = torch.zeros(2, 40, h, d, dtype=torch.bfloat16)
    k = torch.zeros(3, 10, 16, kvh, d, dtype=torch.bfloat16)
    bt = torch.zeros(2, 4, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    return q, k, k.clone(), bt, pos, pos + 1


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_guard_accepts_instantiated_head_dims(d):
    paged_flash._check_cuda_inputs(*_flash_inputs(d))


@pytest.mark.parametrize("d", [64, 128])
def test_sp_prefix_guard_accepts_instantiated_head_dims(d):
    q, k, v, bt, _, _ = _flash_inputs(d)
    sp_prefix._check_cuda_inputs(q, k, v, bt, 17, 2)


@pytest.mark.parametrize("g,ok", [(5, True), (7, True), (64, True),
                                  (65, False)])
def test_flash_guard_takes_any_group_up_to_the_rows_of_a_cta(g, ok):
    """Any G up to a CTA's 64 rows: a G that does not divide them (Qwen2.5's
    7, Qwen2.5-32B's 5) leaves spare rows in the CTA."""
    args = _flash_inputs(64, h=2 * g)
    if ok:
        paged_flash._check_cuda_inputs(*args)
    else:
        with pytest.raises(NotImplementedError, match="at most 64"):
            paged_flash._check_cuda_inputs(*args)


@pytest.mark.parametrize("g,ok", [(5, True), (7, True), (128, True),
                                  (129, False)])
def test_sp_prefix_guard_takes_any_group_up_to_the_rows_of_a_cta(g, ok):
    q, k, v, bt, _, _ = _flash_inputs(64, h=2 * g)
    if ok:
        sp_prefix._check_cuda_inputs(q, k, v, bt, 17, 2)
    else:
        with pytest.raises(NotImplementedError, match="at most 128"):
            sp_prefix._check_cuda_inputs(q, k, v, bt, 17, 2)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_decode_guard_accepts_instantiated_head_dims(d):
    q, k, v, bt, _, ctx = _flash_inputs(d)
    paged_decode._check_cuda_inputs(q[:, :1].contiguous(), k, v, bt, ctx)


@pytest.mark.parametrize("h,ok", [(256, True), (258, False)])
def test_decode_guard_takes_groups_up_to_the_rows_of_a_cta(h, ok):
    """G query heads a KV head are G rows of the split-KV core: up to 128."""
    q, k, v, bt, _, ctx = _flash_inputs(64, h=h)
    args = (q[:, :1].contiguous(), k, v, bt, ctx)
    if ok:
        paged_decode._check_cuda_inputs(*args)
    else:
        with pytest.raises(NotImplementedError, match="at most 128"):
            paged_decode._check_cuda_inputs(*args)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_verify_guard_accepts_instantiated_head_dims(d):
    q, k, v, bt, base, ctx = _flash_inputs(d)
    paged_verify._check_cuda_inputs(q[:, :5].contiguous(), k, v, bt, base, ctx)


@pytest.mark.parametrize("s", [17, 32])
def test_verify_guard_takes_tails_past_the_rows_of_a_cta(s):
    """S 17 and 32 at G 8 (136 and 256 rows) are served in query parts."""
    q, k, v, bt, base, ctx = _flash_inputs(64, h=16)
    paged_verify._check_cuda_inputs(q[:, :s].contiguous(), k, v, bt, base, ctx)


@pytest.mark.parametrize("s,g,rows,sq,parts", [
    (1, 8, 128, 1, 1), (5, 8, 128, 5, 1), (16, 8, 128, 16, 1),
    (17, 8, 128, 9, 2),   # gpt-oss-20b's ngram verify at K 16: 136 rows
    (32, 8, 128, 16, 2), (32, 4, 128, 32, 1), (5, 64, 128, 2, 3),
    (2, 128, 128, 1, 2),
    # head_dim 256 (gemma-2-9b, G 2): one 16-row tile a CTA
    (5, 2, 16, 5, 1), (17, 2, 16, 6, 3), (32, 2, 16, 8, 4), (3, 16, 16, 1, 3),
])
def test_splitkv_query_parts(s, g, rows, sq, parts):
    assert splitkv.query_parts(s, g, rows) == (sq, parts)
    assert sq * g <= rows and sq * parts >= s > sq * (parts - 1)
    if rows == splitkv.MAX_ROWS:
        assert splitkv.query_parts(s, g) == (sq, parts)


def test_splitkv_rows_a_cta_by_head_dim():
    assert [splitkv.max_rows(d) for d in (64, 128, 256)] == [128, 128, 16]
    q, k, v, bt, _, ctx = _flash_inputs(256, h=34, kvh=2)  # G 17
    with pytest.raises(NotImplementedError, match="at most 16 at head_dim 256"):
        paged_decode._check_cuda_inputs(q[:, :1].contiguous(), k, v, bt, ctx)
    q, k, v, bt, base, ctx = _flash_inputs(256, h=32, kvh=2)  # G 16
    paged_decode._check_cuda_inputs(q[:, :1].contiguous(), k, v, bt, ctx)
    paged_verify._check_cuda_inputs(q[:, :32].contiguous(), k, v, bt, base, ctx)


def test_guards_refuse_head_dim_96_by_name():
    """The SP-prefix guard still refuses head_dim 96 by name (no served
    config reaches that form); the decode, verify and flash guards take 96
    (Phi-3-mini) and refuse a head_dim outside (64, 96, 128, 256), say 80,
    by name."""
    q, k, v, bt, base, ctx = _flash_inputs(96)
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        sp_prefix._check_cuda_inputs(q, k, v, bt, 17, 2)
    paged_flash._check_cuda_inputs(q, k, v, bt, base, ctx)
    paged_decode._check_cuda_inputs(q[:, :1].contiguous(), k, v, bt, ctx)
    paged_verify._check_cuda_inputs(q[:, :5].contiguous(), k, v, bt, base, ctx)
    q, k, v, bt, base, ctx = _flash_inputs(80)
    with pytest.raises(NotImplementedError, match="head_dim 80"):
        paged_flash._check_cuda_inputs(q, k, v, bt, base, ctx)
    with pytest.raises(NotImplementedError, match="head_dim 80"):
        paged_decode._check_cuda_inputs(q[:, :1].contiguous(), k, v, bt, ctx)
    with pytest.raises(NotImplementedError, match="head_dim 80"):
        paged_verify._check_cuda_inputs(q[:, :5].contiguous(), k, v, bt, base, ctx)


@pytest.mark.parametrize("d,rows,kv_bytes,want", [
    # bf16 rows of 96 columns take 128 in shared memory: Q 16 rows, three
    # K and V stages, the stats and flag, 256 / 16 + 2 table entries
    (96, 1, 2, 16 * 128 * 2 + 6 * 64 * 128 * 2 + 1040 + 18 * 4),
    # fp8: one bf16 K and V tile (padded), three e4m3 stages of 96 bytes
    (96, 1, 1, 16 * 128 * 2 + 2 * (64 * 128 * 2 + 3 * 64 * 96) + 1040 + 72),
    (96, 32, 2, 32 * 128 * 2 + 6 * 64 * 128 * 2 + 1040 + 72),
    (128, 1, 2, 16 * 128 * 2 + 6 * 64 * 128 * 2 + 1040 + 72),
    (64, 1, 1, 16 * 64 * 2 + 2 * (64 * 64 * 2 + 3 * 64 * 64) + 1040 + 72),
])
def test_splitkv_smem_counts_the_padded_layout(d, rows, kv_bytes, want):
    """The host's byte count is the kernel's layout: a count below it would
    under-allocate dynamic shared memory and corrupt the result silently."""
    assert splitkv.smem_bytes(d, rows, 256, 16, kv_bytes) == want
    splitkv.check_fits("decode kernel", d, rows, 256, 16, kv_bytes)
    assert splitkv.pitch(d) == (128 if d == 96 else d)
    assert paged_flash.smem_bytes(d) == 448 * splitkv.pitch(d) * 2 + 1024


def test_sp_prefix_guard_refuses_head_dim_256_by_name():
    """Two warpgroups of the tensor-core core at head_dim 256 would take
    more shared memory than a CTA has; flash's one warpgroup fits."""
    q, k, v, bt, _, _ = _flash_inputs(256)
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        sp_prefix._check_cuda_inputs(q, k, v, bt, 17, 2)
    assert paged_flash.smem_bytes(256, 2) == 263168 > splitkv.SMEM_LIMIT
    assert paged_flash.smem_bytes(256) == 230400


@pytest.mark.parametrize("d", paged_flash._HEAD_DIMS)
def test_flash_smem_fits_at_every_head_dim(d):
    assert paged_flash.smem_bytes(d) <= splitkv.SMEM_LIMIT
    if d in sp_prefix._HEAD_DIMS:
        assert paged_flash.smem_bytes(d, 2) <= splitkv.SMEM_LIMIT


@pytest.mark.parametrize("kv_bytes", [2, 1])  # bf16 and e4m3 caches
@pytest.mark.parametrize("d", paged_decode._HEAD_DIMS)
@pytest.mark.parametrize("bs", [1, 16, 64])
def test_splitkv_smem_fits_every_accepted_shape(d, bs, kv_bytes):
    """Every (query position, group head) row count a CTA takes (1 to
    128: one to eight 16-row tiles) over the splits of every table up to
    128k keys a row (gemma-2-9b: 8,192 at bs 16), within the card's shared
    memory (at head_dim 256 a CTA holds 16 rows), in the bf16 form and the
    fp8 form (three e4m3 stages and one bf16 tile each of K and V)."""
    widest = 0
    for rows in (r for r in (1, 2, 16, 17, 32, 33, 64, 65, 128)
                 if r <= splitkv.max_rows(d)):
        for table_keys in (16, 2048, 8192, 16384, 131072):
            chunk, _ = splitkv.plan(table_keys)
            need = splitkv.smem_bytes(d, rows, chunk, bs, kv_bytes)
            splitkv.check_fits("decode kernel", d, rows, chunk, bs, kv_bytes)
            widest = max(widest, need)
    assert widest <= splitkv.SMEM_LIMIT
    # the layout of the header at 16 rows over 256-key splits of 16-token
    # pages: Q, the K and V rings, statistics, flag, 18 table entries; bf16
    # rows take whole 64-column lines (96 -> 128), e4m3 rows their width
    p = splitkv.pitch(d)
    ring = (2 * 64 * p * 2 + 2 * 3 * 64 * d if kv_bytes == 1
            else 2 * 3 * 64 * p * 2)
    assert splitkv.smem_bytes(d, 16, 256, 16, kv_bytes) == (
        32 * p + ring + 1024 + 16 + 18 * 4)


def test_splitkv_shape_past_the_shared_memory_raises_by_name():
    """One-token pages and a 1M-key table: a split's 32,770 block-table
    entries do not fit beside head_dim 256's ring; 4,098 (a 128k-key
    table) do."""
    chunk, _ = splitkv.plan(1 << 20)
    assert splitkv.smem_bytes(256, 16, chunk, 1) > splitkv.SMEM_LIMIT
    with pytest.raises(NotImplementedError,
                       match="verify kernel: head_dim 256 with 16 rows"):
        splitkv.check_fits("verify kernel", 256, 16, chunk, 1)
    splitkv.check_fits("verify kernel", 256, 16, splitkv.plan(1 << 17)[0], 1)


@pytest.mark.parametrize("table_keys,chunk,splits", [
    (48, 256, 1),         # a short table: one split
    (2048, 256, 8),       # the engine's max_model_len 2,048
    (8192, 256, 32),
    (16384, 512, 32),     # engine_sp's 1,024-page table
    (16400, 576, 29),     # not a multiple of the tile
])
def test_splitkv_plan_follows_the_table_width(table_keys, chunk, splits):
    got = splitkv.plan(table_keys)
    assert got == (chunk, splits)
    assert chunk % splitkv.TILE_KEYS == 0 and chunk >= splitkv.MIN_CHUNK
    assert splits <= splitkv.MAX_SPLITS and chunk * splits >= table_keys
    assert (splits - 1) * chunk < table_keys  # no split is past the table


def test_splitkv_counters_grow_zeroed():
    dev = torch.device("cpu")
    first = splitkv.counters(dev, 8)
    assert first.dtype == torch.int32 and not first.any()
    assert splitkv.counters(dev, 8) is first  # kept per device
    bigger = splitkv.counters(dev, first.numel() + 1)
    assert bigger.numel() > first.numel() and not bigger.any()
    assert splitkv.workspace(dev, 2, 2, 1, 4, 64).numel() == 0
    assert splitkv.workspace(dev, 2, 2, 3, 4, 64).numel() == 2 * 2 * 3 * 4 * 66


@pytest.mark.parametrize("table_keys,splits", [
    (48, 8),          # a short table: one split holds keys, 7 exit at once
    (768, 8),
    (2048, 16),       # the engine's max_model_len 2,048 (V2-Lite's cell)
    (16384, 128),
    (163840, 1280),   # DeepSeek-V3's 160k context
])
def test_mla_plan_follows_the_table_width(table_keys, splits):
    chunk, got, cluster = mla_decode.plan(table_keys)
    assert (chunk, got, cluster) == (mla_decode.CHUNK, splits, mla_decode.CLUSTER)
    assert chunk % mla_decode.TILE_KEYS == 0 and got % cluster == 0
    assert chunk * got >= table_keys
    # at most the last cluster holds splits past the table
    assert (got - cluster) * chunk < table_keys


def test_mla_plan_never_reads_context_lengths():
    """The grid comes from shapes: ``plan`` takes the table width and
    nothing else, and the wrapper calls it with that."""
    assert list(inspect.signature(mla_decode.plan).parameters) == ["table_keys"]
    src = inspect.getsource(mla_decode.mla_paged_decode_attention)
    assert "plan(w * bs)" in src


def test_mla_plan_cuts_a_row_the_same_at_every_table_width():
    """The K=1 step and the decode bursts pad their block tables to other
    widths: a row's split boundaries (chunk) and merge groups (cluster)
    must not follow the width, or the two would round its output apart."""
    shapes = {mla_decode.plan(w * 16)[::2] for w in range(1, 2049)}
    assert shapes == {(mla_decode.CHUNK, mla_decode.CLUSTER)}


def test_mla_counters_and_workspace_grow_zeroed():
    dev = torch.device("cpu")
    cnt = splitkv.counters(dev, 8 * 8)   # B 8 rows x 8 head groups (H 128)
    assert cnt.dtype == torch.int32 and cnt.numel() >= 64 and not cnt.any()
    more = splitkv.counters(dev, cnt.numel() + 1)
    assert more.numel() > cnt.numel() and not more.any()
    ws = mla_decode.workspace(dev, 8, 1, 8)
    assert ws.dtype == torch.float32 and ws.numel() == 8 * 8 * 16 * 514
    assert mla_decode.workspace(dev, 2, 1, 8) is ws      # kept, large enough
    big = mla_decode.workspace(dev, 8, 8, 8)
    assert big.numel() == 8 * 8 * 8 * 16 * 514 and mla_decode.workspace(dev, 1, 1, 1) is big


@pytest.mark.parametrize("vocab,slice_len,smem", [
    (1000, 128, 28672 + 6 * 128),
    (32000, 4000, 28672 + 24000),
    (102400, 12800, 28672 + 76800),     # DeepSeek-V2-Lite
    (128256, 16032, 28672 + 96192),     # Llama-3.2-1B: 64 KB of f32 a CTA
    (151936, 18992, 28672 + 113952),    # Qwen2
    (201088, 25136, 28672 + 150816),    # gpt-oss-20b
    (256000, 32000, 28672 + 192000),    # Gemma
])
def test_epilogue_cluster_plan(vocab, slice_len, smem):
    cluster, sl, nbytes = epilogue.cluster_plan(vocab)
    assert (cluster, sl, nbytes) == (8, slice_len, smem)
    assert nbytes % 16 == 0 and nbytes <= 232448
    assert sl % 8 == 0 and cluster * sl >= vocab > cluster * (sl - 8)


def test_epilogue_vocabulary_limit_raises_by_name_with_no_library_loaded(monkeypatch):
    monkeypatch.setattr(_build, "_libs", {})
    assert epilogue.cluster_plan(epilogue.MAX_VOCAB)[2] <= 232448
    for vocab in (epilogue.MAX_VOCAB + 1, 1 << 20, 0):
        with pytest.raises(NotImplementedError, match=f"vocabulary {vocab} "):
            epilogue.cluster_plan(vocab)
    assert _build._libs == {}
