"""Differential tests of the port's device-finish helpers and of the
``finish`` / ``extra_bias`` forms of its sampling epilogue.

Every helper of ``dynamo_tpu_torch/engine/sampling.py`` that the chained
burst uses is held against the JAX package's, exactly: stop-id rows, the
finish mask, stop-sequence hashes (including hashes that wrap past 2^32),
ring fill and push (rings with ``-1`` pads), suffix hashes and the stop
candidate mask. The epilogue's plain version (what CPU tensors get) with
``finish``, with ``extra_bias`` and with both is held against the Pallas
epilogue run in interpret mode and fed the reference's gumbel noise, as in
``tests/test_torch_epilogue.py``: tokens, ``hard``, ``cand``, ``ring_new``
and counts exactly equal, logprobs to 1e-6; rows that are not live leave
ring and counts untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as jax_sampling
from dynamo_tpu.ops.pallas_epilogue import fused_sampling_epilogue as jax_epilogue
from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.model_runner import sample_and_logprobs
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.ops import epilogue

B, V, NS = 8, 96, 8
MAX_LEN = 64


def test_constants_match_reference():
    for name in ("STOP_ID_WIDTH", "SUFFIX_RING_W", "STOP_SEQ_WIDTH",
                 "STOP_SEQ_MAX_LEN"):
        assert getattr(sampling, name) == getattr(jax_sampling, name)
    assert sampling._HASH_P == int(jax_sampling._HASH_P)


@pytest.mark.parametrize("eos,hidden,ignore", [
    ([2], [7, 9], False), ([2, 3], None, True), (None, None, False),
    (list(range(10)), list(range(5, 16)), False),    # 16 ids: fits
    (list(range(10)), list(range(5, 17)), False),    # 17 ids: overflow
])
def test_stop_id_row(eos, hidden, ignore):
    got = sampling.stop_id_row(eos, hidden, ignore)
    want = jax_sampling.stop_id_row(eos, hidden, ignore)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_stop_seq_hash_wraps_like_uint32():
    rng = np.random.default_rng(0)
    seqs = [[5], [0, 0, 0], [511, 3, 77, 2], [2**31 - 1] * 8,
            [int(t) for t in rng.integers(0, 2**31, 8)], [128255] * 6]
    for s in seqs:
        assert sampling.stop_seq_hash(s) == jax_sampling.stop_seq_hash(s)
    # the products really wrapped
    assert any(sampling._HASH_P ** (len(s) - 1) * (max(s) + 1) >= 2**32
               for s in seqs)


@pytest.mark.parametrize("seqs", [
    [[4, 5]], [[1], [2, 3], [4, 5, 6], [7, 8, 9, 10]], [],
    [[1]] * 5,                    # more than STOP_SEQ_WIDTH
    [list(range(9))],             # longer than STOP_SEQ_MAX_LEN
    [[], [3, 4]],                 # empty sequences are dropped
])
def test_stop_seq_rows(seqs):
    got = sampling.stop_seq_rows(seqs)
    want = jax_sampling.stop_seq_rows(seqs)
    assert (got is None) == (want is None)
    if want is not None:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.mark.parametrize("n", [0, 1, 5, 32, 40])
def test_ring_init(n):
    toks = list(range(100, 100 + n))
    np.testing.assert_array_equal(sampling.ring_init(toks),
                                  jax_sampling.ring_init(toks))


def _finish_case(seed=0):
    """Rows that cover: a stop id hit below and above ``min_new``,
    ``max_new`` reached, the model-len horizon (``pos + 2 == MAX_LEN`` hits,
    ``pos + 3`` does not), rings with ``-1`` pads and with large ids."""
    rng = np.random.default_rng(seed)
    w = sampling.SUFFIX_RING_W
    tokens = rng.integers(0, V, B).astype(np.int32)
    ring = rng.integers(0, 2**31 - 1, (B, w)).astype(np.int32)
    ring[0, :20] = -1
    ring[1, :] = -1
    ring[2, :-3] = -1
    live = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    gen = np.array([0, 3, 5, 7, 2, 9, 4, 1], np.int32)
    pos = np.array([5, 6, 7, 8, MAX_LEN - 2, MAX_LEN - 3, 9, 10], np.int32)
    min_new = np.array([0, 6, 0, 0, 0, 0, 0, 0], np.int32)
    max_new = np.array([50, 50, 50, 8, 50, 50, 50, 50], np.int32)
    stop_ids = np.full((B, sampling.STOP_ID_WIDTH), -1, np.int32)
    stop_ids[0, :2] = [tokens[0], 3]          # hit, min_new satisfied
    stop_ids[1, :1] = [tokens[1]]             # hit below min_new: no stop
    stop_ids[6, :1] = [tokens[6]]             # dead row: still judged
    return tokens, ring, live, gen, pos, min_new, max_new, stop_ids


def test_device_finish_mask_ring_push_and_hashes():
    tokens, ring, live, gen, pos, min_new, max_new, stop_ids = _finish_case()
    gen_n = gen + live.astype(np.int32)
    want = jax_sampling.device_finish_mask(
        jnp.asarray(tokens), jnp.asarray(gen_n), jnp.asarray(pos),
        jnp.asarray(stop_ids), jnp.asarray(min_new), jnp.asarray(max_new),
        MAX_LEN)
    got = sampling.device_finish_mask(
        torch.from_numpy(tokens).long(), torch.from_numpy(gen_n),
        torch.from_numpy(pos), torch.from_numpy(stop_ids),
        torch.from_numpy(min_new), torch.from_numpy(max_new), MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().tolist() == [True, False, False, True, True, False,
                                    True, False]

    want_ring = jax_sampling.ring_push(jnp.asarray(ring), jnp.asarray(tokens),
                                       jnp.asarray(live))
    got_ring = sampling.ring_push(torch.from_numpy(ring),
                                  torch.from_numpy(tokens).long(),
                                  torch.from_numpy(live))
    np.testing.assert_array_equal(got_ring.numpy(), np.asarray(want_ring))
    assert got_ring.dtype == torch.int32
    # dead rows keep their ring
    np.testing.assert_array_equal(got_ring.numpy()[~live], ring[~live])

    want_h = np.asarray(jax_sampling.suffix_hashes(want_ring)).astype(np.int64)
    got_h = sampling.suffix_hashes(got_ring).numpy()
    np.testing.assert_array_equal(got_h, want_h)
    assert got_h.max() < 2**32 and got_h.min() >= 0
    # a ring of pads hashes to 0 at every length
    assert not got_h[2, :1].any() and not sampling.suffix_hashes(
        torch.full((1, 32), -1, dtype=torch.int32)).any()


def _hash_rows(ring_new, gen_n, min_new):
    """Per row, stop sequences that cover a matching and a non-matching
    suffix of each length 1..8, gated by gen and min_new."""
    w = ring_new.shape[1]
    stop_hash = np.zeros((B, sampling.STOP_SEQ_WIDTH), np.uint32)
    stop_hlen = np.zeros((B, sampling.STOP_SEQ_WIDTH), np.int32)
    for r in range(B):
        length = r + 1                                   # 1..8
        seq = [int(t) for t in ring_new[r, w - length:]]
        stop_hash[r, 0] = sampling.stop_seq_hash([t + 1 for t in seq])  # miss
        stop_hlen[r, 0] = length
        stop_hash[r, 2] = sampling.stop_seq_hash(seq)                   # match
        stop_hlen[r, 2] = length
    return stop_hash, stop_hlen


def test_stop_candidate_mask():
    tokens, ring, live, gen, pos, min_new, max_new, _ = _finish_case(1)
    ring[:, :] = np.random.default_rng(2).integers(0, V, ring.shape)
    ring_new = np.array(jax_sampling.ring_push(
        jnp.asarray(ring), jnp.asarray(tokens), jnp.asarray(live)))
    gen_n = np.array([1, 2, 9, 9, 9, 9, 9, 9], np.int32)  # row 1: gen_n >= 2
    min_new = np.array([0, 0, 0, 0, 0, 0, 20, 0], np.int32)  # row 6 gated
    stop_hash, stop_hlen = _hash_rows(ring_new, gen_n, min_new)
    want = jax_sampling.stop_candidate_mask(
        jnp.asarray(ring_new), jnp.asarray(gen_n), jnp.asarray(min_new),
        jnp.asarray(stop_hash), jnp.asarray(stop_hlen))
    got = sampling.stop_candidate_mask(
        torch.from_numpy(ring_new), torch.from_numpy(gen_n),
        torch.from_numpy(min_new),
        torch.from_numpy(stop_hash.astype(np.int64)),
        torch.from_numpy(stop_hlen))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().tolist() == [True, True, True, True, True, True,
                                    False, True]
    # with only the non-matching sequences nothing is a candidate
    stop_hlen[:, 2] = 0
    got = sampling.stop_candidate_mask(
        torch.from_numpy(ring_new), torch.from_numpy(gen_n),
        torch.from_numpy(min_new),
        torch.from_numpy(stop_hash.astype(np.int64)),
        torch.from_numpy(stop_hlen))
    assert not got.any()


# ---- the epilogue's forms against the Pallas kernel in interpret mode ----

SCAL = dict(
    temperature=np.array([0.0, 0.7, 1.0, 1.3, 0.9, 0.0, 0.8, 0.0], np.float32),
    top_k=np.array([0, 5, 0, 0, 3, 0, 1, 0], np.int32),
    top_p=np.array([1.0, 1.0, 0.9, 1.0, 0.8, 1.0, 1.0, 1.0], np.float32),
    min_p=np.array([0.0, 0.0, 0.0, 0.2, 0.05, 0.0, 0.0, 0.0], np.float32),
    presence_penalty=np.array([0.0, 0.5, 0.0, 1.1, 0.0, 0.0, 0.0, 0.0], np.float32),
    frequency_penalty=np.array([0.0, 0.0, 0.3, 0.2, 0.0, 0.0, 0.0, 0.0], np.float32),
    repetition_penalty=np.array([1.0, 1.2, 1.0, 1.05, 1.3, 1.0, 1.0, 1.0], np.float32),
)
SCAL_KEYS = ("temperature", "top_k", "top_p", "min_p", "presence_penalty",
             "frequency_penalty", "repetition_penalty")


def _epilogue_case():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(B, V)) * 4).astype(np.float32)
    counts = rng.integers(0, 3, size=(NS, V)).astype(np.int32)
    seen = rng.integers(0, 2, size=(NS, V)).astype(bool)
    bias = (rng.normal(size=(NS, V)) * 0.5).astype(np.float32)
    keys = rng.integers(0, 2**32, size=(B, 2)).astype(np.uint32)
    counters = rng.integers(0, 100, size=(B,)).astype(np.int32)
    params = jax_sampling.SamplingParams(
        **{k: jnp.asarray(v) for k, v in SCAL.items()},
        keys=jnp.asarray(keys), counters=jnp.asarray(counters))
    gumbel = np.array(jax.vmap(
        lambda kk: jax.random.gumbel(kk, (V,), jnp.float32))(
            jax_sampling._row_keys(params)))
    # a guided mask: rows 5 and 7 (greedy) may take two ids each, row 1
    # (sampled) five; the other rows are unguided (zeros)
    extra = np.zeros((B, V), np.float32)
    for r, allowed in ((5, [11, 40]), (7, [3, 90]), (1, [1, 2, 3, 50, 60])):
        extra[r] = -1e9
        extra[r, allowed] = 0.0
    return logits, counts, seen, bias, gumbel, extra


def _torch_samp():
    return SamplingParams.from_host("cpu", *(SCAL[k] for k in SCAL_KEYS))


def _finish_inputs(jax_tokens):
    """The finish tuple for the epilogue case, built around the tokens the
    reference samples so that every verdict kind occurs."""
    _, ring, live, gen, pos, min_new, max_new, stop_ids = _finish_case()
    ring[:, :] = np.where(ring < 0, ring, ring % V)
    stop_ids[:] = -1
    stop_ids[0, :2] = [jax_tokens[0], 3]
    stop_ids[1, :1] = [jax_tokens[1]]
    stop_ids[6, :1] = [jax_tokens[6]]
    ring_new = np.where(live[:, None], np.concatenate(
        [ring[:, 1:], np.asarray(jax_tokens, np.int32)[:, None]], 1), ring)
    gen_n = gen + live.astype(np.int32)
    stop_hash, stop_hlen = _hash_rows(ring_new, gen_n, min_new)
    stop_hlen[3, 2] = 0                  # row 3: only the non-matching one
    return (live, gen, pos, min_new, max_new, stop_ids, ring, stop_hash,
            stop_hlen)


@pytest.mark.parametrize("form", ["finish", "extra_bias", "both"])
def test_epilogue_forms_match_pallas_interpret(form):
    logits, counts, seen, bias, gumbel, extra = _epilogue_case()
    slots = np.array([3, 0, 5, 1, 7, 2, 4, 6], np.int32)
    with_extra = form in ("extra_bias", "both")
    with_finish = form in ("finish", "both")
    jx = jnp.asarray(extra) if with_extra else None

    def run_jax(commit, finish):
        return jax_epilogue(
            jnp.asarray(logits), jnp.asarray(gumbel),
            tuple(jnp.asarray(SCAL[k]) for k in SCAL_KEYS),
            jnp.asarray(counts), jnp.asarray(seen), jnp.asarray(bias),
            jnp.asarray(slots), jnp.asarray(commit), extra_bias=jx,
            finish=finish, max_model_len=MAX_LEN, interpret=True)

    # the reference's tokens first (they do not depend on finish), so the
    # finish inputs can be built around them
    tok0 = np.asarray(run_jax(np.ones(B, bool), None)[0])
    (live, gen, pos, min_new, max_new, stop_ids, ring, stop_hash,
     stop_hlen) = _finish_inputs(tok0)
    jfin = tfin = None
    if with_finish:
        jfin = tuple(jnp.asarray(a) for a in (
            gen, pos, min_new, max_new, stop_ids, ring, stop_hash, stop_hlen))
        tfin = tuple(torch.from_numpy(a) for a in (
            gen, pos, min_new, max_new, stop_ids, ring,
            stop_hash.astype(np.int64), stop_hlen))
    want = run_jax(live, jfin)

    t_counts = torch.from_numpy(counts.copy())
    got = epilogue.fused_sampling_epilogue(
        torch.from_numpy(logits), torch.from_numpy(gumbel), _torch_samp(),
        t_counts, torch.from_numpy(seen), torch.from_numpy(bias),
        torch.from_numpy(slots).long(), torch.from_numpy(live),
        extra_bias=torch.from_numpy(extra) if with_extra else None,
        finish=tfin, max_model_len=MAX_LEN)
    assert len(got) == len(want) == (6 if with_finish else 3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].data_ptr() == t_counts.data_ptr()
    # rows that are not live commit no count
    dead = slots[~live]
    np.testing.assert_array_equal(got[2].numpy()[dead], counts[dead])
    if with_extra:
        # guided rows took an allowed id
        assert int(got[0][5]) in (11, 40) and int(got[0][7]) in (3, 90)
        assert int(got[0][1]) in (1, 2, 3, 50, 60)
    if with_finish:
        hard, cand, ring_new = (g.numpy() for g in got[3:])
        np.testing.assert_array_equal(hard, np.asarray(want[3]))
        np.testing.assert_array_equal(cand, np.asarray(want[4]))
        np.testing.assert_array_equal(ring_new, np.asarray(want[5]))
        np.testing.assert_array_equal(ring_new[~live], ring[~live])
        if not with_extra:
            # every verdict kind occurs: stop id hit, hit below min_new,
            # max_new, the horizon and one short of it, a dead row
            assert hard.tolist() == [True, False, False, True, True, False,
                                     True, False]
            # cand: matched (0, 2, 5); gated by min_new (1), by gen_n <
            # the sequence's length (4, 6, 7); no matching sequence (3)
            assert cand.tolist() == [True, False, True, False, False, True,
                                     False, False]
    assert epilogue.launches == 0  # CPU tensors never launch the kernel


def test_runner_tail_fused_finish_equals_unfused():
    """``sample_and_logprobs`` with ``extra_bias`` and ``finish`` through
    the epilogue's route (its plain version on the CPU) and through the
    unfused tail (composed from the helpers) agree exactly."""
    logits, counts, seen, bias, gumbel, extra = _epilogue_case()
    tok0 = np.zeros(B, np.int64)
    (live, gen, pos, min_new, max_new, stop_ids, ring, stop_hash,
     stop_hlen) = _finish_inputs(tok0)
    fin = tuple(torch.from_numpy(a) for a in (
        gen, pos, min_new, max_new, stop_ids, ring,
        stop_hash.astype(np.int64), stop_hlen))
    outs = []
    for fused in (False, True):
        c = torch.from_numpy(counts.copy())
        outs.append(sample_and_logprobs(
            ModelConfig(vocab_size=V), torch.from_numpy(logits), _torch_samp(),
            torch.from_numpy(gumbel), c, torch.from_numpy(seen),
            torch.from_numpy(bias), torch.arange(B), torch.from_numpy(live),
            True, fused=fused, unique_slots=True,
            extra_bias=torch.from_numpy(extra), finish=fin,
            max_model_len=MAX_LEN) + (c,))
    assert len(outs[0]) == len(outs[1]) == 8
    for a, b in zip(*outs):
        assert torch.equal(a, b)
