"""The model runner: params, paged KV cache and sampling state on one
device, and the programs the scheduler drives.

The port of ``dynamo_tpu/engine/model_runner.py`` for the reference's
synchronous serving path: one ``step`` (bucketed prefill, per-token decode
and the speculative verify's S = K + 1 positions alike) and ``decode_burst``
(K single-token steps with no host read of sampled tokens between them),
each ending in the sampling tail — the fused epilogue kernel on a card
(``fused_epilogue`` "auto" or "on"), the unfused PyTorch tail otherwise.
The model family's module comes from ``models.resolve`` (Llama-family
GQA, or DeepSeek MLA with routed experts), as in the reference.
PyTorch runs eagerly, so there is no compiled-program cache; the KV cache
and the sample state are updated in place. Not in this slice (later work):
chained and pipelined decode (the device-finish burst), draft-model
speculation, sequence-parallel prefill, embeddings, block gather/scatter
for offload or migration, CUDA graphs and compile tracking.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import llama, resolve
from ..ops.attention import check_attention_impl
from ..ops.epilogue import fused_sampling_epilogue
from .config import EngineConfig
from .sampling import (
    SamplingParams,
    gumbel_noise,
    sample,
    top_k_width,
    top_logprobs_for,
)

logger = logging.getLogger(__name__)


def resolve_device(device) -> torch.device:
    """The runner's device. "cuda" (the default of every entry point)
    raises when no CUDA device is present — there is no silent CPU
    fallback; tests pass ``device="cpu"`` explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch route on the CPU"
        )
    return dev


def resolve_fused_epilogue(mode: str, device) -> bool:
    """``EngineConfig.fused_epilogue`` for ``device``: "off" runs the
    unfused tail anywhere; "auto" follows the attention route — the kernel
    on a card, the unfused tail on the CPU; "on" takes the epilogue's
    route everywhere (the kernel on a card, its plain version on the CPU)."""
    if mode == "off":
        return False
    return mode == "on" or torch.device(device).type == "cuda"


def sample_and_logprobs(cfg, last_logits, samp: SamplingParams, gumbel,
                        counts, seen, bias, sample_slots, commit, want_top,
                        fused: bool = False, unique_slots: bool = True):
    """The per-token tail shared by ``step`` and every burst iteration
    (the reference's ``_sample_and_logprobs``): penalty-aware sampling,
    the sampled token's logprob from the biased (unpenalized) logits, the
    optional top-K alternatives, and the count commit for rows whose
    sample is kept.

    ``fused=True`` runs the sampling epilogue (``ops/epilogue.py``); the
    top-K alternatives stay a ``torch.topk`` outside it.
    ``unique_slots=False`` marks call sites whose pad rows may share a
    live row's sample slot (the batched prefill step): the count commit
    then stays a scatter-add outside the kernel. Unfused, ``counts`` is
    always updated with a scatter-ADD: pad rows share sample slot 0 with
    ``commit=False`` and add 0, so they never overwrite a live row's
    count."""
    b = last_logits.shape[0]
    logp = None
    if fused:
        next_tokens, lps, _ = fused_sampling_epilogue(
            last_logits, gumbel, samp, counts, seen, bias, sample_slots,
            commit, alias_counts=unique_slots)
    else:
        row_bias = bias[sample_slots]
        next_tokens = sample(last_logits, samp, gumbel, counts[sample_slots],
                             seen[sample_slots], bias=row_bias)
        logp = torch.log_softmax(last_logits.float() + row_bias, dim=-1)
        lps = torch.gather(logp, 1, next_tokens[:, None])[:, 0]
        counts.index_put_((sample_slots, next_tokens), commit.to(counts.dtype),
                          accumulate=True)
    if want_top:
        if logp is None:
            logp = torch.log_softmax(
                last_logits.float() + bias[sample_slots], dim=-1)
        top_vals, top_ids = top_logprobs_for(last_logits, logp)
    else:
        kw = top_k_width(cfg.vocab_size)
        top_vals = torch.zeros((b, kw), dtype=torch.float32, device=lps.device)
        top_ids = torch.zeros((b, kw), dtype=torch.int64, device=lps.device)
    return next_tokens, lps, top_vals, top_ids


class ModelRunner:
    """Owns params, the KV cache and the sample state on ``device``."""

    def __init__(self, config: EngineConfig, params=None, device="cuda"):
        self.config = config
        cfg = config.model
        self.arch = resolve(cfg)   # the model family's module
        self.arch.check_supported(cfg)
        self.device = resolve_device(device)
        check_attention_impl(cfg.attention_impl, self.device)
        self.fused_epilogue = resolve_fused_epilogue(config.fused_epilogue,
                                                     self.device)
        self.dtype = llama.torch_dtype(config.dtype)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            params = self.arch.init_params(cfg, gen, self.dtype, self.device)
        self.params = _to_device(params, self.device, self.dtype)
        self._reinit_device_state()

    def _reinit_device_state(self) -> None:
        """The paged KV cache and the per-slot sample state (generated-
        token counts, prompt presence, logit_bias rows — [slots, V])."""
        cfg = self.config
        self.kv_cache = self.arch.init_kv_cache(
            cfg.model, cfg.num_kv_blocks, cfg.kv_block_size, self.dtype,
            self.device)
        b, v = cfg.max_batch_size, cfg.model.vocab_size
        self.sample_state = (
            torch.zeros((b, v), dtype=torch.int32, device=self.device),
            torch.zeros((b, v), dtype=torch.bool, device=self.device),
            torch.zeros((b, v), dtype=torch.float32, device=self.device),
        )

    def _t(self, x, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device).to(dtype)

    def _check_slots(self, sample_slots: np.ndarray) -> None:
        n = self.config.max_batch_size
        if len(sample_slots) and not (0 <= sample_slots.min()
                                      and sample_slots.max() < n):
            raise ValueError(f"sample slots outside [0, {n})")

    @torch.inference_mode()
    def step(
        self,
        tokens: np.ndarray,        # [B, S]
        positions: np.ndarray,     # [B, S]
        block_tables: np.ndarray,  # [B, W]
        slot_mapping: np.ndarray,  # [B, S]
        context_lens: np.ndarray,  # [B]
        last_idx: np.ndarray,      # [B] index of the position to sample from
        temperature: np.ndarray,
        top_k: np.ndarray,
        top_p: np.ndarray,
        key=None,                  # uint32[2] broadcast to every row
        *,
        min_p: Optional[np.ndarray] = None,
        presence_penalty: Optional[np.ndarray] = None,
        frequency_penalty: Optional[np.ndarray] = None,
        repetition_penalty: Optional[np.ndarray] = None,
        seed_keys: Optional[np.ndarray] = None,   # [B, 2] u32 per-row keys
        counters: Optional[np.ndarray] = None,    # [B] i32 step counters
        sample_slots: Optional[np.ndarray] = None,  # [B] state row per batch row
        commit: Optional[np.ndarray] = None,      # [B] bool count sampled token
        want_top: bool = True,     # compute top-K alternatives this step?
        targets: Optional[np.ndarray] = None,  # [B, S] next-prompt-token ids
        want_prompt: bool = False,  # compute prompt logprobs at `targets`?
        want_greedy: bool = False,  # per-position argmax?
    ) -> Tuple[torch.Tensor, ...]:
        """Run one step; returns (next_tokens, logprobs, top_vals, top_ids,
        prompt_logprobs, greedy_all) as device tensors — the reference's
        signature and returns. Rows with temperature > 0 draw their gumbel
        noise from generators seeded by (key, counter)."""
        cfg = self.config.model
        b, s = tokens.shape
        if seed_keys is None:
            seed_keys = np.tile(
                np.asarray(key if key is not None else (0, 0), np.uint32)[None],
                (b, 1))
        if counters is None:
            counters = np.arange(b, dtype=np.int32)
        if sample_slots is None:
            sample_slots = np.arange(b, dtype=np.int32)
        if commit is None:
            commit = np.zeros(b, bool)
        self._check_slots(np.asarray(sample_slots))
        temperature = np.asarray(temperature, np.float32)
        samp = SamplingParams.from_host(
            self.device, temperature, top_k, top_p, min_p, presence_penalty,
            frequency_penalty, repetition_penalty)
        gumbel = gumbel_noise(seed_keys, counters, cfg.vocab_size, self.device,
                              rows=np.nonzero(temperature > 0.0)[0])

        hidden, self.kv_cache = self.arch.forward(
            self.params, cfg, self._t(tokens), self._t(positions),
            self.kv_cache, self._t(block_tables, torch.int32),
            self._t(slot_mapping), self._t(context_lens, torch.int32),
            return_hidden=True,
        )
        # the full-S [B, S, V] head runs only when a consumer needs every
        # position (prompt logprobs, per-position argmax)
        prompt_lps = torch.zeros((b, s), dtype=torch.float32, device=self.device)
        greedy_all = torch.zeros((b, s), dtype=torch.int64, device=self.device)
        if want_prompt or want_greedy:
            lg = self.arch.lm_logits(hidden, self.params, cfg)
            if want_prompt:
                tg = self._t(targets if targets is not None else np.zeros_like(tokens))
                prompt_lps = torch.gather(
                    torch.log_softmax(lg.float(), dim=-1), 2, tg[..., None])[..., 0]
            greedy_all = torch.argmax(lg, dim=-1)
        rows = torch.arange(b, device=self.device)
        last_logits = self.arch.lm_logits(
            hidden[rows, self._t(last_idx)], self.params, cfg)   # [B, V]
        counts, seen, bias = self.sample_state
        # pad rows of a batched prefill share slot 0: the commit stays a
        # scatter-add outside the epilogue kernel
        next_tokens, lps, top_vals, top_ids = sample_and_logprobs(
            cfg, last_logits, samp, gumbel, counts, seen, bias,
            self._t(sample_slots), self._t(commit, torch.bool), want_top,
            fused=self.fused_epilogue, unique_slots=False)
        return next_tokens, lps, top_vals, top_ids, prompt_lps, greedy_all

    @torch.inference_mode()
    def decode_burst(
        self,
        tokens0: np.ndarray,       # [B] pending token per row
        positions0: np.ndarray,    # [B] its position
        block_tables: np.ndarray,  # [B, W] covering positions0 + K
        temperature: np.ndarray,
        top_k: np.ndarray,
        top_p: np.ndarray,
        *,
        min_p: np.ndarray,
        presence_penalty: np.ndarray,
        frequency_penalty: np.ndarray,
        repetition_penalty: np.ndarray,
        seed_keys: np.ndarray,     # [B, 2] u32 per-row keys
        counters: np.ndarray,      # [B] i32 step counters of the first step
        commit: np.ndarray,        # [B] row is live (inactive rows inert)
        want_top: bool = False,
    ) -> Tuple[torch.Tensor, ...]:
        """K = ``multi_step_decode`` single-token steps, each sampled token
        feeding the next, with no host read of a sampled token in between.
        Each iteration derives its KV slot from the block table on the
        device (-1 for rows that do not commit), draws its gumbel noise
        with counters ``counters + step`` and runs the epilogue with the
        count commit in place (slots are ``arange``). The tail, the noise
        and the kernels are those of single steps, so the stream equals K
        single steps'. Returns (tokens, logprobs, top_vals, top_ids) as
        [K, B]-leading device tensors."""
        cfg = self.config.model
        k_steps = self.config.multi_step_decode
        bs = self.config.kv_block_size
        b = len(tokens0)
        temperature = np.asarray(temperature, np.float32)
        samp = SamplingParams.from_host(
            self.device, temperature, top_k, top_p, min_p, presence_penalty,
            frequency_penalty, repetition_penalty)
        sampled_rows = np.nonzero(temperature > 0.0)[0]
        counters = np.asarray(counters, np.int64)
        bt = self._t(block_tables, torch.int32)
        live = self._t(commit, torch.bool)
        slots = torch.arange(b, device=self.device)
        toks = self._t(tokens0)
        pos = self._t(positions0)
        counts, seen, bias = self.sample_state
        outs = []
        for step_i in range(k_steps):
            # inactive rows run from position 0 and never write: clamp their
            # table lookup to the table
            blk = bt[slots, (pos // bs).clamp(max=bt.shape[1] - 1)]
            slot = blk.long() * bs + pos % bs
            slot = torch.where(live, slot, torch.full_like(slot, -1))
            gumbel = gumbel_noise(seed_keys, counters + step_i, cfg.vocab_size,
                                  self.device, rows=sampled_rows)
            hidden, self.kv_cache = self.arch.forward(
                self.params, cfg, toks[:, None], pos[:, None], self.kv_cache,
                bt, slot[:, None], (pos + 1).int(), return_hidden=True)
            logits = self.arch.lm_logits(hidden[:, 0], self.params, cfg)
            out = sample_and_logprobs(
                cfg, logits, samp, gumbel, counts, seen, bias, slots, live,
                want_top, fused=self.fused_epilogue, unique_slots=True)
            outs.append(out)
            toks, pos = out[0], pos + 1
        return tuple(torch.stack(parts) for parts in zip(*outs))

    @torch.inference_mode()
    def set_sample_row(self, slot: int, prompt_ids, generated_ids=(),
                       logit_bias=None) -> None:
        """Install sampling state for a slot at admission: prompt presence,
        generated-token counts (non-empty when resuming a preempted
        stream) and the request's OpenAI logit_bias row."""
        v = self.config.model.vocab_size
        seen_row = np.zeros(v, bool)
        if len(prompt_ids):
            ids = np.asarray(prompt_ids, np.int64)
            seen_row[ids[(ids >= 0) & (ids < v)]] = True
        counts_row = np.zeros(v, np.int32)
        if len(generated_ids):
            gids = np.asarray(generated_ids, np.int64)
            np.add.at(counts_row, gids[(gids >= 0) & (gids < v)], 1)
        bias_row = np.zeros(v, np.float32)
        for tid, val in (logit_bias or {}).items():
            tid = int(tid)
            if 0 <= tid < v:
                bias_row[tid] += float(val)
        counts, seen, bias = self.sample_state
        counts[slot].copy_(torch.from_numpy(counts_row))
        seen[slot].copy_(torch.from_numpy(seen_row))
        bias[slot].copy_(torch.from_numpy(bias_row))

    @torch.inference_mode()
    def set_bias_row(self, slot: int, bias_row: np.ndarray) -> None:
        """Replace ONE slot's sampler bias row."""
        self.sample_state[2][slot].copy_(
            torch.as_tensor(np.asarray(bias_row, np.float32)))

    def warmup(self, decode_batch: Optional[int] = None) -> None:
        """Build the kernels (on a card) and run one inert step per prefill
        bucket, one decode step, one verify-shaped step (S = the ngram
        proposal count + 1, or 2) and, with ``multi_step_decode > 1``, one
        burst, so no first request pays for a kernel build or a
        first-launch cost. Inert: every slot is the drop sentinel and
        nothing commits, so the cache and the sample state keep their
        values."""
        if self.device.type == "cuda":
            from ..ops import _build

            _build.build()
        self.set_sample_row(0, [])
        b = decode_batch or self.config.max_batch_size
        w = self.config.blocks_per_seq
        verify_s = (self.config.spec_ngram_tokens or 1) + 1
        shapes = [(b, 1, False), (b, verify_s, True)] + [
            (1, s, False) for s in self.config.prefill_buckets]
        for rows, s, verify in shapes:
            z = np.zeros((rows, s), np.int32)
            self.step(z, z, np.zeros((rows, w), np.int32),
                      np.full((rows, s), -1, np.int32), np.ones(rows, np.int32),
                      np.zeros(rows, np.int32), np.zeros(rows, np.float32),
                      np.zeros(rows, np.int32), np.ones(rows, np.float32),
                      want_top=False, want_greedy=verify)
        if self.config.multi_step_decode > 1:
            zf, zi = np.zeros(b, np.float32), np.zeros(b, np.int32)
            self.decode_burst(
                zi, zi, np.zeros((b, w), np.int32), zf, zi, np.ones(b, np.float32),
                min_p=zf, presence_penalty=zf, frequency_penalty=zf,
                repetition_penalty=np.ones(b, np.float32),
                seed_keys=np.zeros((b, 2), np.uint32), counters=zi,
                commit=np.zeros(b, bool))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _to_device(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_device(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)
