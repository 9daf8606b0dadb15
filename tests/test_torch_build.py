"""The kernel build cache, the head_dim guards of the attention kernels
and the split-KV launch plan, on the CPU (no ``nvcc``, no card).

- ``_build.library_path`` names a library by a hash of its source and
  every ``csrc`` header the source includes, so an edited header rebuilds
  (checked on a temporary ``CSRC``);
- the flash, prefix-partials, decode and verify wrappers accept the
  head_dims their library instantiates (64 and 128) and refuse others by
  name before any launch (``_check_cuda_inputs`` on CPU tensors);
- ``splitkv.plan`` cuts a block table into splits from its width alone.
"""

import pytest
import torch

from dynamo_tpu_torch.ops import (
    _build,
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
        assert deps == [_build.SOURCES[name], "paged_attn_tc.cuh"]


def test_decode_and_verify_share_the_splitkv_header():
    for name in ("paged_decode", "paged_verify"):
        deps = [p.name for p in _build._sources(_build.CSRC / _build.SOURCES[name], [])]
        assert deps == [_build.SOURCES[name], "paged_splitkv.cuh"]


def _flash_inputs(d, h=8, kvh=2):
    q = torch.zeros(2, 40, h, d, dtype=torch.bfloat16)
    k = torch.zeros(3, 10, 16, kvh, d, dtype=torch.bfloat16)
    bt = torch.zeros(2, 4, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    return q, k, k.clone(), bt, pos, pos + 1


@pytest.mark.parametrize("d", [64, 128])
def test_flash_guard_accepts_instantiated_head_dims(d):
    paged_flash._check_cuda_inputs(*_flash_inputs(d))


@pytest.mark.parametrize("d", [64, 128])
def test_sp_prefix_guard_accepts_instantiated_head_dims(d):
    q, k, v, bt, _, _ = _flash_inputs(d)
    sp_prefix._check_cuda_inputs(q, k, v, bt, 17, 2)


@pytest.mark.parametrize("d", [64, 128])
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


@pytest.mark.parametrize("d", [64, 128])
def test_verify_guard_accepts_instantiated_head_dims(d):
    q, k, v, bt, base, ctx = _flash_inputs(d)
    paged_verify._check_cuda_inputs(q[:, :5].contiguous(), k, v, bt, base, ctx)


def test_guards_refuse_head_dim_96_by_name():
    q, k, v, bt, base, ctx = _flash_inputs(96)
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        paged_flash._check_cuda_inputs(q, k, v, bt, base, ctx)
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        sp_prefix._check_cuda_inputs(q, k, v, bt, 17, 2)
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        paged_decode._check_cuda_inputs(q[:, :1].contiguous(), k, v, bt, ctx)
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        paged_verify._check_cuda_inputs(q[:, :5].contiguous(), k, v, bt, base, ctx)


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
