"""Batched sampling: greedy / temperature / top-k / top-p / min-p plus
presence, frequency and repetition penalties — all per slot.

The port of ``dynamo_tpu/engine/sampling.py``: the unfused sampling tail
and the device-finish helpers of the chained decode burst (stop-id rows,
the finish mask, the suffix ring and its rolling stop-sequence hashes).
All parameters are per-row tensors, so one call serves every sampling
configuration in the batch; temperature == 0 means greedy.

Randomness: the reference draws ``categorical(key, l) ==
argmax(gumbel(key) + l)`` from per-row threefry keys. Torch cannot give
the same bits, and this port does not re-implement threefry, so
``sample`` takes the per-row gumbel noise [B, V] as an argument. The model
runner draws it from per-request ``torch.Generator``s seeded from the
request's key and step counter (``gumbel_noise``), so a seeded request is
reproducible within the port; the tests feed both packages the same noise.

Penalty state lives on the device as [num_slots, V] buffers owned by the
runner: ``counts`` (how often each token was generated) and ``seen``
(tokens present in the prompt). Semantics follow vLLM, as the reference:

- repetition_penalty r: for tokens in prompt or output, positive logits are
  divided by r, negative multiplied (r == 1 disables).
- presence_penalty: subtracted once from every token that has been generated.
- frequency_penalty: subtracted per occurrence of a generated token.
- min_p: after temperature scaling, tokens with prob < min_p * max_prob drop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.transfer import to_device_packed
from ..protocols.common import SamplingOptions


@dataclasses.dataclass
class SamplingParams:
    """Per-row tensors; batch dimension leads."""

    temperature: torch.Tensor          # [B] f32; 0 → greedy
    top_k: torch.Tensor                # [B] i64; 0 → disabled
    top_p: torch.Tensor                # [B] f32; 1.0 → disabled
    min_p: torch.Tensor                # [B] f32; 0.0 → disabled
    presence_penalty: torch.Tensor     # [B] f32; 0.0 → disabled
    frequency_penalty: torch.Tensor    # [B] f32; 0.0 → disabled
    repetition_penalty: torch.Tensor   # [B] f32; 1.0 → disabled

    @classmethod
    def from_host(cls, device, temperature, top_k, top_p, min_p=None,
                  presence_penalty=None, frequency_penalty=None,
                  repetition_penalty=None) -> "SamplingParams":
        """Build from host arrays (missing penalties/min_p → disabled),
        sent to the device in one transfer."""
        b = len(temperature)
        f32 = torch.float32

        def f(x, fill):
            return (np.full(b, fill, np.float32) if x is None else x, f32)

        return cls(**to_device_packed(
            device,
            temperature=f(temperature, 0.0),
            top_k=(top_k, torch.int64),
            top_p=f(top_p, 1.0),
            min_p=f(min_p, 0.0),
            presence_penalty=f(presence_penalty, 0.0),
            frequency_penalty=f(frequency_penalty, 0.0),
            repetition_penalty=f(repetition_penalty, 1.0),
        ))


def host_row(opts: SamplingOptions):
    """One request's SamplingOptions → the per-slot host scalars
    (temperature, top_k, top_p, min_p, presence, frequency, repetition)."""
    temp = opts.temperature if opts.temperature is not None else 1.0
    return (
        float(temp),
        int(opts.top_k) if opts.top_k and opts.top_k > 0 else 0,
        float(opts.top_p) if opts.top_p is not None else 1.0,
        float(opts.min_p) if opts.min_p else 0.0,
        float(opts.presence_penalty) if opts.presence_penalty else 0.0,
        float(opts.frequency_penalty) if opts.frequency_penalty else 0.0,
        float(opts.repetition_penalty) if opts.repetition_penalty else 1.0,
    )


def seed_to_key(seed: int) -> np.ndarray:
    """A per-request base key from an explicit user seed (uint32[2])."""
    seed = int(seed)
    return np.asarray(
        [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32
    )


_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def row_seed(key, counter: int) -> int:
    """The generator seed of one row's step: a hash of the request's base
    key (uint32[2]) and its step counter (the port's analog of the
    reference's ``fold_in(key, counter)``)."""
    k = (int(key[0]) << 32) | int(key[1])
    return _splitmix64(_splitmix64(k) ^ (int(counter) & 0xFFFFFFFF)) >> 1


def gumbel_noise(keys: np.ndarray, counters: np.ndarray, vocab: int,
                 device, rows=None) -> torch.Tensor:
    """[B, V] f32 gumbel noise, row i drawn from a ``torch.Generator`` on
    ``device`` seeded with ``row_seed(keys[i], counters[i])``. ``rows``
    limits the draw to those rows (the rest stay 0: greedy rows never
    read their noise)."""
    b = len(counters)
    out = torch.zeros((b, vocab), dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    for i in (range(b) if rows is None else rows):
        g = torch.Generator(device=device)
        g.manual_seed(row_seed(keys[i], counters[i]))
        u = torch.rand(vocab, generator=g, device=device, dtype=torch.float32)
        out[i] = -torch.log(-torch.log(u.clamp_(min=tiny)))
    return out


def sample(
    logits: torch.Tensor,              # [B, V]
    params: SamplingParams,
    gumbel: torch.Tensor,              # [B, V] f32 per-row gumbel noise
    counts: Optional[torch.Tensor] = None,   # [B, V] i32 generated-token counts
    seen: Optional[torch.Tensor] = None,     # [B, V] bool prompt-token presence
    bias: Optional[torch.Tensor] = None,     # [B, V] f32 OpenAI logit_bias rows
) -> torch.Tensor:
    """Returns sampled token ids [B] (int64), in the reference's order:
    bias → penalties → greedy | temperature → top-k → min-p → top-p →
    gumbel argmax."""
    b, v = logits.shape
    logits = logits.float()
    if bias is not None:
        logits = logits + bias

    # ---- penalties (on raw logits, before temperature) ----
    if counts is not None:
        generated = counts > 0
        ever = generated if seen is None else (generated | seen)
        rp = params.repetition_penalty[:, None]
        logits = torch.where(
            ever, torch.where(logits > 0, logits / rp, logits * rp), logits)
        logits = logits - params.frequency_penalty[:, None] * counts.float()
        logits = logits - params.presence_penalty[:, None] * generated.float()

    greedy = torch.argmax(logits, dim=-1)

    # temperature scaling (guard against 0 for the sampled branch)
    temp = torch.clamp(params.temperature, min=1e-6)[:, None]
    scaled = logits / temp
    neg_inf = torch.full((), float("-inf"), device=logits.device)

    # top-k: mask everything below the k-th largest (k=0 → no-op)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = torch.clamp(params.top_k - 1, 0, v - 1)
    kth = torch.gather(sorted_desc, 1, k_idx[:, None])
    topk_mask = (params.top_k[:, None] > 0) & (scaled < kth)
    scaled = torch.where(topk_mask, neg_inf, scaled)

    # min-p on the already-top-k-masked logits
    probs_all = torch.softmax(scaled, dim=-1)
    minp_mask = probs_all < params.min_p[:, None] * probs_all.amax(-1, keepdim=True)
    scaled = torch.where(minp_mask, neg_inf, scaled)

    # top-p (nucleus): mask the tail whose cumulative prob exceeds p. The
    # order is the reference's: a stable ascending argsort, reversed
    sort_idx = torch.flip(torch.argsort(scaled, dim=-1, stable=True), [-1])
    sorted_scaled = torch.gather(scaled, 1, sort_idx)
    probs = torch.softmax(sorted_scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < params.top_p[:, None]  # always keep the top token
    keep = torch.zeros_like(keep_sorted).scatter_(1, sort_idx, keep_sorted)
    scaled = torch.where(keep, scaled, neg_inf)

    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(params.temperature <= 0.0, greedy, sampled)


# ---- device-resident finish detection (the chained decode burst) ----
#
# The chained burst evaluates each row's finish conditions on the device
# so a finished row freezes in place instead of ending the burst. The
# per-row stop-token set rides as a fixed-width id matrix; a request whose
# set overflows the width keeps host-side finish checks (the scheduler's
# "device-checkable" classification) and is counted there.

# ids per row: eos ids + hidden stop ids, -1 padded
STOP_ID_WIDTH = 16


def stop_id_row(eos_ids, hidden_ids, ignore_eos: bool) -> Optional[np.ndarray]:
    """One request's device stop-token row: the merged eos (unless
    suppressed) + hidden-stop id set, -1 padded to ``STOP_ID_WIDTH``.
    None when the set overflows the width: the request is not
    device-checkable."""
    ids = set() if ignore_eos else {int(t) for t in (eos_ids or [])}
    ids |= {int(t) for t in (hidden_ids or [])}
    if len(ids) > STOP_ID_WIDTH:
        return None
    row = np.full(STOP_ID_WIDTH, -1, np.int32)
    row[: len(ids)] = sorted(ids)
    return row


def device_finish_mask(
    tokens: torch.Tensor,     # [B] the step's sampled tokens
    gen: torch.Tensor,        # [B] generated count INCLUDING this token
    pos: torch.Tensor,        # [B] position the step's forward ran at
    stop_ids: torch.Tensor,   # [B, STOP_ID_WIDTH], -1 padded
    min_new: torch.Tensor,    # [B] min_tokens (suppresses eos/stop below)
    max_new: torch.Tensor,    # [B] effective max_tokens
    max_model_len: int,
) -> torch.Tensor:
    """Per-row finish verdict of one chained step, the device mirror of
    ``Scheduler._check_finish``: at host-check time the committed context
    is ``pos + 1`` (the pending token's KV was just written), so the
    model-len bound reads ``pos + 2 >= max_model_len``. Token ids are
    non-negative, so the -1 padding never matches."""
    hit = (tokens[:, None] == stop_ids).any(dim=1)
    stop = (gen >= min_new) & hit
    length = (gen >= max_new) | (pos + 2 >= max_model_len)
    return stop | length


# ---- device-approximate stop strings (suffix ring + rolling hash) ----
#
# Stop STRINGS are a text-level condition the engine cannot evaluate
# exactly (it holds no tokenizer), so chained rows use an approximation:
# the preprocessor ships each stop string's canonical tokenization
# (``StopConditions.stop_token_seqs``), the burst carries a ring of the
# last SUFFIX_RING_W emitted tokens per row, and each step compares
# rolling polynomial hashes of the ring's suffixes against the per-
# sequence target hashes. A match freezes the row as a stop *candidate*;
# the host confirms on drain with an exact token-suffix compare
# (``Scheduler._check_finish`` runs it on every emitted token) and a hash
# collision resumes the row.

SUFFIX_RING_W = 32    # trailing tokens carried per row
STOP_SEQ_WIDTH = 4    # stop sequences per row the device can watch
STOP_SEQ_MAX_LEN = 8  # tokens per watched sequence

_HASH_P = 1000003
_M32 = 0xFFFFFFFF


def stop_seq_hash(seq) -> int:
    """Polynomial hash of one token sequence in uint32 with wraparound,
    the host mirror of the rolling suffix hash. A token hashes as
    ``uint32(token) + 1``."""
    h = 0
    for t in seq:
        h = (h * _HASH_P + ((int(t) & _M32) + 1)) & _M32
    return h


def stop_seq_rows(seqs):
    """Pack one request's stop token sequences into the device rows:
    ``(hashes [STOP_SEQ_WIDTH] uint32, lens [STOP_SEQ_WIDTH] int32)``.
    None when the set overflows the width / length bounds: the request is
    not device-checkable (counted, never silent)."""
    seqs = [tuple(int(t) for t in s) for s in (seqs or []) if s]
    if not seqs or len(seqs) > STOP_SEQ_WIDTH:
        return None
    if any(len(s) > STOP_SEQ_MAX_LEN for s in seqs):
        return None
    hashes = np.zeros(STOP_SEQ_WIDTH, np.uint32)
    lens = np.zeros(STOP_SEQ_WIDTH, np.int32)
    for i, s in enumerate(seqs):
        hashes[i] = stop_seq_hash(s)
        lens[i] = len(s)
    return hashes, lens


def ring_init(tokens, width: int = SUFFIX_RING_W) -> np.ndarray:
    """Host-side ring fill: the last ``width`` tokens of the emitted
    history (prompt + generated, ending with the pending token), -1 padded
    on the left. The chain-fill input of the burst carry."""
    row = np.full(width, -1, np.int32)
    tail = list(tokens)[-width:]
    if tail:
        row[-len(tail):] = tail
    return row


def ring_push(ring: torch.Tensor, tokens: torch.Tensor,
              live: torch.Tensor) -> torch.Tensor:
    """Shift each LIVE row's ring left and append its new token."""
    shifted = torch.cat([ring[:, 1:], tokens[:, None].to(ring.dtype)], dim=1)
    return torch.where(live[:, None], shifted, ring)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for int64 ``a`` in [0, 2^32) and a constant ``c``
    in [0, 2^32), with every intermediate below 2^49 (torch has no
    dependable uint32 arithmetic, and an int64 product could overflow)."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def suffix_hashes(ring: torch.Tensor) -> torch.Tensor:
    """[B, STOP_SEQ_MAX_LEN + 1] int64 rolling hashes (values in
    [0, 2^32)) of the ring's trailing suffixes: column L is the hash of
    the last L tokens (column 0 = 0). A -1 pad hashes as 0."""
    b, w = ring.shape
    toks = (ring.long() + 1) & _M32
    cols = [torch.zeros(b, dtype=torch.int64, device=ring.device)]
    p_pow = 1
    for ell in range(1, STOP_SEQ_MAX_LEN + 1):
        cols.append((cols[-1] + _mul32(toks[:, w - ell], p_pow)) & _M32)
        p_pow = (p_pow * _HASH_P) & _M32
    return torch.stack(cols, dim=1)


def stop_candidate_mask(
    ring: torch.Tensor,       # [B, W] trailing tokens INCLUDING this step's
    gen: torch.Tensor,        # [B] generated count including this token
    min_new: torch.Tensor,    # [B] min_tokens (suppresses stops below)
    stop_hash: torch.Tensor,  # [B, STOP_SEQ_WIDTH] target hashes in [0, 2^32)
    stop_len: torch.Tensor,   # [B, STOP_SEQ_WIDTH] lengths (0 = unused)
) -> torch.Tensor:
    """Per-row stop-STRING candidate verdict of one step: any watched
    sequence whose length-L suffix hash matches, gated so the whole suffix
    is generated output (gen >= L) and min_tokens is satisfied."""
    hs = suffix_hashes(ring)                               # [B, L+1]
    stop_len = stop_len.long()
    sel = torch.gather(hs, 1, stop_len.clamp(0, STOP_SEQ_MAX_LEN))  # [B, NS]
    cand = (
        (stop_len > 0)
        & (gen[:, None] >= stop_len)
        & (gen[:, None] >= min_new[:, None])
        & (sel == (stop_hash.long() & _M32))
    )
    return cand.any(dim=1)


# alternatives returned with every step — covers OpenAI's top_logprobs (≤ 20)
TOP_LOGPROBS_K = 20


def top_k_width(vocab_size: int) -> int:
    """The step's top-logprobs width (≤ vocab for tiny test vocabs)."""
    return min(TOP_LOGPROBS_K, vocab_size)


def top_logprobs_for(logits: torch.Tensor,
                     logp: Optional[torch.Tensor] = None) -> tuple:
    """(values [B, K], ids [B, K]) of the K most likely tokens per row.

    Pass ``logp`` to reuse an already-computed log_softmax."""
    if logp is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
    vals, ids = torch.topk(logp, top_k_width(logits.shape[-1]), dim=-1)
    return vals, ids
