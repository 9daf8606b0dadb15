"""Differential tests of the port's guided-choice machinery
(``dynamo_tpu_torch/engine/guided.py``) against the JAX package's: choice
tries, the ``TrieConstraint`` cursor's ``allowed`` / ``advance`` verdicts
along seeded walks, and ``compile_device_table``'s tables and state ids,
all exactly equal, over seeded choice lists with shared prefixes, with and
without eos ids, and at the ``max_states`` bound (both return ``None``).
"""

import numpy as np
import pytest
import torch

from dynamo_tpu.engine import guided as jax_guided
from dynamo_tpu_torch.engine import guided

VOCAB = 300


def _choices(seed, n=6, max_len=5):
    """``n`` choices that share prefixes: each new choice keeps a random
    prefix of an earlier one; some are prefixes of others."""
    rng = np.random.default_rng(seed)
    out = [[int(t) for t in rng.integers(0, VOCAB, rng.integers(1, max_len + 1))]]
    while len(out) < n:
        base = out[rng.integers(0, len(out))]
        keep = int(rng.integers(0, len(base) + 1))
        tail = [int(t) for t in rng.integers(0, VOCAB, rng.integers(0, max_len))]
        cand = (base[:keep] + tail) or [int(rng.integers(0, VOCAB))]
        out.append(cand)
    return out


@pytest.mark.parametrize("seed", range(5))
def test_trie_and_cursor_match_reference(seed):
    choices = _choices(seed)
    assert guided.GUIDED_END == jax_guided.GUIDED_END
    assert guided.build_choice_trie(choices) == jax_guided.build_choice_trie(choices)
    rng = np.random.default_rng(100 + seed)
    for choice in choices + [[VOCAB + 5], choices[0][:1] + [VOCAB - 1]]:
        a, b = guided.TrieConstraint(choices), jax_guided.TrieConstraint(choices)
        # walk the choice, then one token that may derail
        for t in list(choice) + [int(rng.integers(0, VOCAB))]:
            ia, ea = a.allowed()
            ib, eb = b.allowed()
            assert (sorted(ia), ea) == (sorted(ib), eb)
            va, vb = a.advance(t), b.advance(t)
            assert va == vb and a.path == b.path
            if va != "ok":
                break
        a.reset()
        b.reset()
        assert a.path == b.path == () and a.allowed() == b.allowed()
    # state_key: equal positions share a key, an advance changes it
    c = guided.TrieConstraint(choices)
    k0 = c.state_key()
    assert c.advance(choices[0][0]) in ("ok", "done") and c.state_key() != k0


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("eos", [(), (2,), (2, 299, 1000)])
def test_device_table_matches_reference(seed, eos):
    choices = _choices(seed, n=8)
    got = guided.compile_device_table(
        guided.TrieConstraint(choices), VOCAB, eos, max_states=256)
    want = jax_guided.compile_device_table(
        jax_guided.TrieConstraint(choices), VOCAB, eos, max_states=256)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got.table, want.table)
    assert got.table.dtype == want.table.dtype == np.int32
    assert got.state_ids == want.state_ids
    assert got.n_states == want.n_states and got.kind == want.kind == "trie"
    # the cursor's state id follows both along every choice
    for choice in choices:
        a, b = guided.TrieConstraint(choices), jax_guided.TrieConstraint(choices)
        for t in choice:
            assert got.state_id(a) == want.state_id(b) is not None
            row = got.table[got.state_id(a)]
            allowed, at_end = a.allowed()
            legal = set(t for t in allowed if t < VOCAB)
            if at_end:
                legal |= {e for e in eos if e < VOCAB}
            assert set(np.nonzero(row >= 0)[0].tolist()) == legal
            if a.advance(t) != "ok":
                assert row[t] == guided.DeviceGuidedTable.DONE
                break
            b.advance(t)
    # the device form: padded to the bucket with reject rows, cached
    dev = got.device(64, "cpu")
    assert dev.dtype == torch.int32 and dev.shape == (64, VOCAB)
    np.testing.assert_array_equal(dev.numpy()[: got.n_states], got.table)
    assert (dev.numpy()[got.n_states:] == -1).all()
    assert got.device(64, "cpu") is dev


def test_device_table_state_bound_and_foreign_constraint():
    choices = _choices(7, n=8)
    full = guided.compile_device_table(guided.TrieConstraint(choices), VOCAB)
    n = len(full.state_ids)
    for bound, fits in ((n, True), (n - 1, False), (2, False)):
        got = guided.compile_device_table(
            guided.TrieConstraint(choices), VOCAB, max_states=bound)
        want = jax_guided.compile_device_table(
            jax_guided.TrieConstraint(choices), VOCAB, max_states=bound)
        assert (got is not None) == (want is not None) == fits
    assert guided.compile_device_table(object(), VOCAB) is None
    # a live cursor is never touched by the compile
    c = guided.TrieConstraint(choices)
    c.advance(choices[0][0])
    path = c.path
    guided.compile_device_table(c, VOCAB)
    assert c.path == path
