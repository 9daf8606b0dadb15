"""The model runner: params, paged KV cache and sampling state on one
device, and the programs the scheduler drives.

The port of ``dynamo_tpu/engine/model_runner.py``: one ``step`` (bucketed
prefill, per-token decode and the speculative verify's S = K + 1 positions
alike), ``decode_burst`` (K single-token steps with no host read of
sampled tokens between them; its first tokens may be a device tensor, the
dispatch-ahead carry) and ``decode_burst_chained`` (the same K steps with
device-resident finish detection: finished rows freeze on the device and
the carry feeds the next burst without a host round trip), each ending in
the sampling tail — the fused epilogue kernel on a card (``fused_epilogue``
"auto" or "on"), the unfused PyTorch tail otherwise. No program reads a
device value on the host or blocks the host on the device: host arrays
travel through pinned memory (``ops/transfer.py``), and ``stage_to_host``
starts a burst's outputs on their way back. The model family's module
comes from ``models.resolve`` (Llama-family GQA, DeepSeek MLA with routed
experts, GPT-OSS, Mixtral / Qwen3-MoE, Gemma-2), as in the reference; its
weights come from ``model_dir``'s checkpoint (``models/loader.py``: an HF
safetensors snapshot or a ``.gguf``) or are drawn from the seed; with
``quantization="int8"`` the matmul weights are quantized (as a checkpoint's
leaves land, or after init), as the reference does (``models/quant.py``). PyTorch runs eagerly, so
there is no compiled-program cache; the KV cache and the sample state are
updated in place. With ``sp_size > 1`` the runner also owns the sequence-parallel
prefill chunk (``sp_prefill_chunk``: one fixed ``[1, S]`` shape, the ``sp``
ranks laid out on the one device). The block ops (``gather_blocks_device``,
``blocks_to_host``, ``scatter_blocks``) move whole KV blocks of the cache
pair in and out for the disaggregated transfer, ordered on the runner's
stream with its programs. ``embed_prompts`` runs the cacheless embed
trunk for /v1/embeddings (Llama-family dense trunks, as in the reference).
Not in this slice (later work): the chained propose-verify round,
draft-model speculation, CUDA graphs and compile tracking.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models import llama, quant, resolve
from ..models.loader import load_checkpoint_params, resolve_weights
from ..ops.attention import FP8, _bytes, check_attention_impl
from ..ops.epilogue import fused_sampling_epilogue
from ..ops.transfer import to_device, to_device_packed
from .config import EngineConfig, check_kv_cache_dtype, check_quantization
from .sampling import (
    STOP_ID_WIDTH,
    STOP_SEQ_WIDTH,
    SUFFIX_RING_W,
    SamplingParams,
    device_finish_mask,
    gumbel_noise,
    ring_push,
    sample,
    stop_candidate_mask,
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
                        fused: bool = False, unique_slots: bool = True,
                        extra_bias=None, finish=None, max_model_len: int = 0):
    """The per-token tail shared by ``step`` and every burst iteration
    (the reference's ``_sample_and_logprobs``): penalty-aware sampling,
    the sampled token's logprob from the biased (unpenalized) logits, the
    optional top-K alternatives, and the count commit for rows whose
    sample is kept.

    ``extra_bias`` is an additive [B, V] term computed in the step (the
    chained burst's guided mask from the device table); the synchronous
    path expresses the same mask through the persistent ``bias`` rows, so
    the two paths' logits and logprobs agree. ``finish`` (the chained
    burst's carry rows ``(gen, pos, min_new, max_new, stop_ids, ring,
    stop_hash, stop_hlen)``) appends the step's ``(hard, cand, ring_new)``
    verdicts to the return.

    ``fused=True`` runs the sampling epilogue (``ops/epilogue.py``), the
    verdicts inside the same launch; the top-K alternatives stay a
    ``torch.topk`` outside it. Unfused, the verdicts are composed from
    ``ring_push``, ``device_finish_mask`` and ``stop_candidate_mask``.
    ``unique_slots=False`` marks call sites whose pad rows may share a
    live row's sample slot (the batched prefill step): the count commit
    then stays a scatter-add outside the kernel. Unfused, ``counts`` is
    always updated with a scatter-ADD: pad rows share sample slot 0 with
    ``commit=False`` and add 0, so they never overwrite a live row's
    count."""
    b = last_logits.shape[0]
    logp = None
    verdicts = ()
    if fused:
        next_tokens, lps, _, *verdicts = fused_sampling_epilogue(
            last_logits, gumbel, samp, counts, seen, bias, sample_slots,
            commit, alias_counts=unique_slots, extra_bias=extra_bias,
            finish=finish, max_model_len=max_model_len)
    else:
        row_bias = bias[sample_slots]
        if extra_bias is not None:
            row_bias = row_bias + extra_bias
        next_tokens = sample(last_logits, samp, gumbel, counts[sample_slots],
                             seen[sample_slots], bias=row_bias)
        logp = torch.log_softmax(last_logits.float() + row_bias, dim=-1)
        lps = torch.gather(logp, 1, next_tokens[:, None])[:, 0]
        counts.index_put_((sample_slots, next_tokens), commit.to(counts.dtype),
                          accumulate=True)
        if finish is not None:
            gen, pos, min_new, max_new, stop_ids, ring, stop_hash, stop_hlen = finish
            gen_n = gen + commit.to(gen.dtype)
            ring_n = ring_push(ring, next_tokens, commit)
            verdicts = (
                device_finish_mask(next_tokens, gen_n, pos, stop_ids, min_new,
                                   max_new, max_model_len),
                stop_candidate_mask(ring_n, gen_n, min_new, stop_hash, stop_hlen),
                ring_n)
    if want_top:
        if logp is None:
            row_bias = bias[sample_slots]
            if extra_bias is not None:
                row_bias = row_bias + extra_bias
            logp = torch.log_softmax(last_logits.float() + row_bias, dim=-1)
        top_vals, top_ids = top_logprobs_for(last_logits, logp)
    else:
        kw = top_k_width(cfg.vocab_size)
        top_vals = torch.zeros((b, kw), dtype=torch.float32, device=lps.device)
        top_ids = torch.zeros((b, kw), dtype=torch.int64, device=lps.device)
    return (next_tokens, lps, top_vals, top_ids) + tuple(verdicts)


def build_prefill_arrays(cfg: EngineConfig, prompt: List[int], num_cached: int,
                         block_ids: List[int], bucket: Optional[int] = None):
    """Batch-of-1 arrays for one bucketed prefill step: (tokens, positions,
    block_tables, slot_mapping, context_lens, last_idx) — the leading
    arguments of ``ModelRunner.step``. Pass ``bucket`` to pad to a
    caller-chosen bucket."""
    suffix = prompt[num_cached:]
    bucket = bucket or cfg.bucket_for(len(suffix))
    w = cfg.blocks_per_seq
    bs = cfg.kv_block_size

    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, : len(suffix)] = suffix
    positions = np.full((1, bucket), num_cached + len(suffix) - 1, np.int32)
    positions[0, : len(suffix)] = np.arange(num_cached, len(prompt))
    slot_map = np.full((1, bucket), -1, np.int32)
    for i, pos in enumerate(range(num_cached, len(prompt))):
        slot_map[0, i] = block_ids[pos // bs] * bs + pos % bs
    btab = np.zeros((1, w), np.int32)
    btab[0, : len(block_ids)] = block_ids
    ctx_lens = np.asarray([len(prompt)], np.int32)
    last_idx = np.asarray([len(suffix) - 1], np.int32)
    return tokens, positions, btab, slot_map, ctx_lens, last_idx


class HostCopy:
    """A dispatched program's outputs on their way to the host.

    On a card, ``non_blocking`` copies into pinned host buffers are
    enqueued right behind the program on its stream and an event is
    recorded after them: ``ready()`` probes the event and ``numpy()``
    waits for it, never for work dispatched later (a ``.cpu()`` call would
    queue behind every burst dispatched since, which would make a
    dispatch-ahead loop serial in fact). On the CPU the tensors are ready
    at once."""

    def __init__(self, tensors):
        self._event = None
        if tensors[0].device.type == "cuda":
            self._host = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True) for t in tensors]
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = list(tensors)

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def tensors(self) -> List[torch.Tensor]:
        """The outputs as host tensors; blocks until the copies landed."""
        if self._event is not None:
            self._event.synchronize()
        return self._host

    def numpy(self):
        """The outputs as numpy arrays; blocks until the copies landed."""
        return [t.numpy() for t in self.tensors()]


def _table_ctx(pos: torch.Tensor, bt: torch.Tensor, bs: int) -> torch.Tensor:
    """A burst step's context lengths, ``pos + 1``, held within the block
    table: a row that does not commit (frozen, or no longer a member) can
    sit past the table, which is sized to the live rows, and an attention
    kernel reads ``ceil(ctx / bs)`` entries of its row (past the width:
    out of bounds). The live rows' blocks are reserved, so only rows whose
    token and KV write are discarded move."""
    return torch.clamp(pos + 1, max=bt.shape[1] * bs).int()


class ModelRunner:
    """Owns params, the KV cache and the sample state on ``device``."""

    def __init__(self, config: EngineConfig, params=None, device="cuda",
                 model_dir: Optional[str] = None):
        self.config = config
        cfg = config.model
        self.arch = resolve(cfg)   # the model family's module
        self.arch.check_supported(cfg)
        self.device = resolve_device(device)
        check_attention_impl(cfg.attention_impl, self.device)
        if self.device.type == "cuda" and config.dtype != "bfloat16":
            # the attention kernels take bf16 only; the CPU keeps f32 for
            # the differential tests
            raise NotImplementedError(
                f"dtype={config.dtype!r} on a CUDA device: the port's "
                "attention kernels take bfloat16 only")
        self.fused_epilogue = resolve_fused_epilogue(config.fused_epilogue,
                                                     self.device)
        self.dtype = llama.torch_dtype(config.dtype)
        # the KV cache's storage dtype: the activation dtype, or e4m3 with
        # no scale (every write casts into it, every read upcasts)
        check_kv_cache_dtype(config.kv_cache_dtype)
        self.kv_dtype = FP8 if config.kv_cache_dtype == "fp8" else self.dtype
        check_quantization(cfg)   # before any weight is drawn or read
        if params is None and model_dir is not None and resolve_weights(
                model_dir, config.allow_random_weights):
            # raises for a family without a loader: a checkpoint never
            # turns into random weights
            params = load_checkpoint_params(model_dir, cfg, self.arch,
                                            self.dtype, self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            params = self.arch.init_params(cfg, gen, self.dtype, self.device)
        params = _to_device(params, self.device, self.dtype)
        if cfg.quantization:
            # leaves already quantized (a loaded checkpoint's, quantized as
            # they landed, or the Mixtral family's stacks, as they were
            # drawn) stay as they are
            params = quant.quantize_params(params)
        self.params = params
        self._reinit_device_state()
        self._build_sp_prefill()

    def _build_sp_prefill(self) -> None:
        """The sequence-parallel prefill chunk's gate and fixed shape (the
        reference's ``_build_sp_prefill``): llama-family GQA dense trunks
        only (``check_sp_trunk``), one ``[1, sp_prefill_bucket()]`` chunk
        over the full block-table width. The ``sp`` ranks are the leading
        dimension of the chunk's query shard on this one device."""
        cfg_e = self.config
        self._sp_bucket = 0
        if cfg_e.sp_size > 1:
            cfg_e.check_sp_trunk()
            self._sp_bucket = cfg_e.sp_prefill_bucket()

    @property
    def sp_ready(self) -> bool:
        """Is the sequence-parallel prefill chunk served? (The scheduler
        gates the SP ladder on this.)"""
        return self._sp_bucket > 0

    @property
    def sp_chunk_tokens(self) -> int:
        """Tokens one SP chunk advances (the fixed chunk shape)."""
        return self._sp_bucket

    def _reinit_device_state(self) -> None:
        """The paged KV cache and the per-slot sample state (generated-
        token counts, prompt presence, logit_bias rows — [slots, V])."""
        cfg = self.config
        self.kv_cache = self.arch.init_kv_cache(
            cfg.model, cfg.num_kv_blocks, cfg.kv_block_size, self.kv_dtype,
            self.device)
        b, v = cfg.max_batch_size, cfg.model.vocab_size
        self.sample_state = (
            torch.zeros((b, v), dtype=torch.int32, device=self.device),
            torch.zeros((b, v), dtype=torch.bool, device=self.device),
            torch.zeros((b, v), dtype=torch.float32, device=self.device),
        )

    def _t(self, x, dtype=torch.int64) -> torch.Tensor:
        """Host array (or a tensor already on the device) → device tensor,
        without blocking the host on the device."""
        return to_device(x, self.device, dtype)

    def _tp(self, **specs):
        """Several host arrays → device tensors in one transfer
        (``name=(array, dtype)``; see ``to_device_packed``)."""
        return to_device_packed(self.device, **specs)

    def stage_to_host(self, *tensors: torch.Tensor) -> HostCopy:
        """Start a dispatched program's outputs on their way to the host."""
        return HostCopy(tensors)

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

        i64, i32 = torch.int64, torch.int32
        d = self._tp(
            tokens=(tokens, i64), positions=(positions, i64),
            block_tables=(block_tables, i32), slot_mapping=(slot_mapping, i64),
            context_lens=(context_lens, i32), last_idx=(last_idx, i64),
            sample_slots=(sample_slots, i64), commit=(commit, torch.bool),
            targets=(targets if want_prompt and targets is not None
                     else np.zeros((1, 1), np.int64), i64))
        hidden, self.kv_cache = self.arch.forward(
            self.params, cfg, d["tokens"], d["positions"], self.kv_cache,
            d["block_tables"], d["slot_mapping"], d["context_lens"],
            return_hidden=True,
        )
        # the full-S [B, S, V] head runs only when a consumer needs every
        # position (prompt logprobs, per-position argmax)
        prompt_lps = torch.zeros((b, s), dtype=torch.float32, device=self.device)
        greedy_all = torch.zeros((b, s), dtype=torch.int64, device=self.device)
        if want_prompt or want_greedy:
            lg = self.arch.lm_logits(hidden, self.params, cfg)
            if want_prompt:
                tg = (d["targets"] if targets is not None
                      else torch.zeros_like(d["tokens"]))
                prompt_lps = torch.gather(
                    torch.log_softmax(lg.float(), dim=-1), 2, tg[..., None])[..., 0]
            greedy_all = torch.argmax(lg, dim=-1)
        rows = torch.arange(b, device=self.device)
        last_logits = self.arch.lm_logits(
            hidden[rows, d["last_idx"]], self.params, cfg)   # [B, V]
        counts, seen, bias = self.sample_state
        # pad rows of a batched prefill share slot 0: the commit stays a
        # scatter-add outside the epilogue kernel
        next_tokens, lps, top_vals, top_ids = sample_and_logprobs(
            cfg, last_logits, samp, gumbel, counts, seen, bias,
            d["sample_slots"], d["commit"], want_top,
            fused=self.fused_epilogue, unique_slots=False)
        return next_tokens, lps, top_vals, top_ids, prompt_lps, greedy_all

    @torch.inference_mode()
    def decode_burst(
        self,
        tokens0,                   # [B] pending token per row: host array,
                                   # or a device tensor (dispatch-ahead carry)
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
        and the kernels are those of single steps, and an inactive row holds
        its first token and position through the burst as the pads of
        single steps do. A row that finishes inside the burst rides on
        live: the dispatch-ahead pipeline and the SP handoff take this
        form, and the synchronous scheduler's bursts take
        ``decode_burst_chained``, which freezes it (on a MoE trunk a row's
        experts depend on the rows before it). Returns (tokens, logprobs,
        top_vals, top_ids) as [K, B]-leading device tensors."""
        cfg = self.config.model
        k_steps = self.config.multi_step_decode
        bs = self.config.kv_block_size
        b = len(positions0)
        temperature = np.asarray(temperature, np.float32)
        samp = SamplingParams.from_host(
            self.device, temperature, top_k, top_p, min_p, presence_penalty,
            frequency_penalty, repetition_penalty)
        # rows that do not commit never read their noise
        sampled_rows = np.nonzero((temperature > 0.0) & np.asarray(commit, bool))[0]
        counters = np.asarray(counters, np.int64)
        d = self._tp(bt=(block_tables, torch.int32), live=(commit, torch.bool),
                     toks=(tokens0, torch.int64), pos=(positions0, torch.int64))
        bt, live, toks, pos = d["bt"], d["live"], d["toks"], d["pos"]
        slots = torch.arange(b, device=self.device)
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
                bt, slot[:, None], _table_ctx(pos, bt, bs), return_hidden=True)
            logits = self.arch.lm_logits(hidden[:, 0], self.params, cfg)
            out = sample_and_logprobs(
                cfg, logits, samp, gumbel, counts, seen, bias, slots, live,
                want_top, fused=self.fused_epilogue, unique_slots=True)
            outs.append(out)
            # an inactive row stays the pad a single step carries: on a
            # MoE trunk whose experts hold one token each, a pad that moved
            # on would take other experts from the rows after it
            toks = torch.where(live, out[0], toks)
            pos = torch.where(live, pos + 1, pos)
        return tuple(torch.stack(parts) for parts in zip(*outs))

    def sp_prefill_chunk(
        self,
        prompt,                    # full token list UP TO the chunk end
        start: int,                # the chunk's first position (KV before
        block_ids,                 #   it is already committed)
        *,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        repetition_penalty: float = 1.0,
        seed_keys=None,            # [2] u32 per-request key
        counters: int = 0,
        sample_slot: int = 0,
        commit: bool = False,      # the final chunk samples and commits
        want_top: bool = False,
    ):
        """Dispatch ONE sequence-parallel chunk (``[start, len(prompt))``, at
        most ``sp_chunk_tokens`` tokens) and, on the final chunk
        (``commit``), the sampling tail on its last valid row. Returns
        ``(next_tokens, lps, top_vals, top_ids)`` device tensors on the
        final chunk and None on the others: nothing reads a non-final
        chunk's outputs, so its head and tail are skipped. Dispatch-only:
        nothing is read back from the device."""
        tokens, positions, btab, slot_map, _, _ = build_prefill_arrays(
            self.config, prompt, start, block_ids, bucket=self._sp_bucket)
        return self._sp_dispatch(
            tokens, positions, slot_map, btab, start, len(prompt),
            len(prompt) - start - 1, tail=commit, commit=commit,
            temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
            presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty,
            repetition_penalty=repetition_penalty, seed_keys=seed_keys,
            counters=counters, sample_slot=sample_slot, want_top=want_top)

    @torch.inference_mode()
    def _sp_dispatch(self, tokens, positions, slot_map, btab, chunk_start: int,
                     context_len: int, last: int, *, tail: bool,
                     commit: bool = False, temperature: float = 0.0,
                     top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                     presence_penalty: float = 0.0,
                     frequency_penalty: float = 0.0,
                     repetition_penalty: float = 1.0, seed_keys=None,
                     counters: int = 0, sample_slot: int = 0,
                     want_top: bool = False):
        """The SP chunk from its host arrays (``sp_prefill_chunk``'s shape):
        the trunk, then with ``tail`` the head and the sampling tail on row
        ``last``."""
        cfg = self.config.model
        i64, i32 = torch.int64, torch.int32
        # one packed pinned transfer: no blocking copy inside the dispatch
        d = self._tp(tokens=(tokens, i64), positions=(positions, i64),
                     slot_mapping=(slot_map, i64), block_tables=(btab, i32),
                     last=(np.asarray([last]), i64),
                     slot=(np.asarray([sample_slot]), i64),
                     commit=(np.asarray([commit]), torch.bool))
        # llama's trunk and tail: check_sp_trunk admits llama-family dense
        # GQA trunks only (no window, no softcap), so no other family
        # reaches this path
        hidden, self.kv_cache = llama.sp_decoder_forward(
            self.params, cfg, d["tokens"], d["positions"], self.kv_cache,
            d["block_tables"], d["slot_mapping"], context_len, chunk_start,
            self.config.sp_size)
        if not tail:
            return None
        temp = np.asarray([temperature], np.float32)
        samp = SamplingParams.from_host(
            self.device, temp, np.asarray([top_k]), np.asarray([top_p]),
            np.asarray([min_p], np.float32),
            np.asarray([presence_penalty], np.float32),
            np.asarray([frequency_penalty], np.float32),
            np.asarray([repetition_penalty], np.float32))
        if seed_keys is None:
            seed_keys = np.zeros(2, np.uint32)
        gumbel = gumbel_noise(np.asarray(seed_keys, np.uint32)[None],
                              np.asarray([counters]), cfg.vocab_size,
                              self.device, rows=np.nonzero(temp > 0.0)[0])
        last_logits = llama.lm_logits(hidden[0, d["last"]], self.params, cfg)
        counts, seen, bias = self.sample_state
        return sample_and_logprobs(
            cfg, last_logits, samp, gumbel, counts, seen, bias, d["slot"],
            d["commit"], want_top, fused=self.fused_epilogue, unique_slots=True)

    @torch.inference_mode()
    def handoff_tokens(self, next_tokens: torch.Tensor, slot: int) -> torch.Tensor:
        """[B] first tokens of a decode burst with the final SP chunk's
        sampled token at ``slot`` and 0 elsewhere, composed on the device
        (the early decode handoff never reads the token on the host)."""
        b = self.config.max_batch_size
        tok0 = torch.zeros(b, dtype=torch.int64, device=self.device)
        tok0[slot: slot + 1].copy_(next_tokens[:1])
        return tok0

    # ---------- KV block ops (the disaggregated transfer) ----------

    def _block_index(self, block_ids) -> torch.Tensor:
        """Block ids, checked on the host against the cache's blocks (the
        spare row dropped writes go to lies past them, so no id reaches it),
        as a device index."""
        ids = np.asarray(list(block_ids), np.int64)
        n = self.config.num_kv_blocks
        if ids.size == 0 or ids.min() < 0 or ids.max() >= n:
            raise ValueError(f"block ids outside [0, {n}): {ids.tolist()}")
        return self._t(ids)

    @torch.inference_mode()
    def gather_blocks_device(self, block_ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cache pair's blocks ``block_ids`` as device tensors
        ``[L, n, bs, ...]`` (the Llama family's K and V; MLA's ``c_kv`` and
        ``k_rope``, whose last dims differ). Dispatch-only: an
        ``index_select`` on dim 1 on the runner's stream, so it reads what
        every step dispatched before it wrote; an e4m3 cache is gathered
        through its bytes."""
        ids = self._block_index(block_ids)
        return tuple(_bytes(c).index_select(1, ids).view(c.dtype)
                     for c in self.kv_cache)

    def blocks_to_host(self, k_dev: torch.Tensor, v_dev: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host copies of one gathered block frame: copied into pinned
        memory behind the gather and waited on through that copy's own
        event (never a device-wide synchronize)."""
        k, v = self.stage_blocks_to_host(k_dev, v_dev).tensors()
        return k.view(k_dev.dtype), v.view(v_dev.dtype)

    def stage_blocks_to_host(self, k_dev: torch.Tensor, v_dev: torch.Tensor
                             ) -> HostCopy:
        """Start a gathered frame's copy to the host (its bytes; an e4m3
        frame is viewed back by the reader). Dispatch-only."""
        return HostCopy((_bytes(k_dev), _bytes(v_dev)))

    def gather_blocks(self, block_ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """``gather_blocks_device`` then ``blocks_to_host``."""
        return self.blocks_to_host(*self.gather_blocks_device(block_ids))

    def stage_blocks(self, k: torch.Tensor, v: torch.Tensor):
        """Received host blocks in pinned memory on a card (so the copy in
        ``scatter_blocks`` does not block); as they are on the CPU. Touches
        no runner state: any thread may call it."""
        if self.device.type != "cuda":
            return k, v
        return k.pin_memory(), v.pin_memory()

    @torch.inference_mode()
    def scatter_blocks(self, block_ids, k_blocks: torch.Tensor,
                       v_blocks: torch.Tensor) -> None:
        """Write blocks ``[L, n, bs, ...]`` (host or device tensors of the
        cache's dtype and block shape, else ``ValueError``) into the cache
        pair at ``block_ids``: one ``index_copy_`` on dim 1 each, after a
        pinned ``non_blocking`` copy to the card, both on the runner's
        stream, so they are ordered against ``step``."""
        ids = self._block_index(block_ids)
        for cache, blocks in zip(self.kv_cache, (k_blocks, v_blocks)):
            want = (cache.shape[0], len(ids), *cache.shape[2:])
            if tuple(blocks.shape) != want or blocks.dtype != cache.dtype:
                raise ValueError(
                    f"blocks {tuple(blocks.shape)} {blocks.dtype} do not fit "
                    f"the cache's {want} {cache.dtype}")
            src = to_device(blocks, self.device)
            _bytes(cache).index_copy_(1, ids, _bytes(src))

    # guided device tables pad their state dim to this ladder, as the
    # reference does (there each bucket is one compiled burst program)
    GUIDED_STATE_BUCKETS = (1, 64, 256, 1024)

    def guided_state_bucket(self, n_states: int) -> int:
        for s in self.GUIDED_STATE_BUCKETS:
            if n_states <= s:
                return s
        return self.GUIDED_STATE_BUCKETS[-1]

    @torch.inference_mode()
    def decode_burst_chained(
        self,
        tokens0,                   # [B] host array (chain start) or device carry
        positions0,                # [B] likewise
        gen0,                      # [B] generated-token counts, likewise
        done0,                     # [B] bool done mask, likewise
        block_tables: np.ndarray,  # [B, W]
        temperature: np.ndarray,
        top_k: np.ndarray,
        top_p: np.ndarray,
        *,
        min_p: np.ndarray,
        presence_penalty: np.ndarray,
        frequency_penalty: np.ndarray,
        repetition_penalty: np.ndarray,
        seed_keys: np.ndarray,
        counters: np.ndarray,      # [B] i32 noise counters of the first step
        commit: np.ndarray,        # [B] row is a (live) chain member
        stop_ids: np.ndarray,      # [B, STOP_ID_WIDTH] -1-padded stop set
        min_new: np.ndarray,       # [B] i32
        max_new: np.ndarray,       # [B] i32
        ring0=None,                # [B, SUFFIX_RING_W] trailing tokens
        gstate0=None,              # [B] guided table state (-1 unguided)
        stop_hash=None,            # [B, STOP_SEQ_WIDTH] uint32 targets
        stop_hlen=None,            # [B, STOP_SEQ_WIDTH] i32 lengths
        gtable=None,               # [S, V] device table (None: no guided row)
        want_top: bool = False,
    ):
        """One K-step burst with device-resident finish detection (the
        reference's ``burst_df``).

        Each step's finish verdict (eos / hidden stop id / ``max_new`` /
        the model-len horizon, the stop-sequence suffix hash, the guided
        table reaching DONE) is computed on the device. A row that
        finishes FREEZES: its KV slot goes to -1 (no writes), its count
        commit, ring and position stop, and its output lane emits ``-1`` /
        ``0.0`` pads. The burst never ends early and reads no device value
        on the host, so the scheduler chains dispatches off the returned
        carry. Guided rows (``gstate >= 0``) take their mask from
        ``gtable[gstate]`` through the tail's ``extra_bias`` and advance
        their state on the sampled token.

        ``counters`` replaces the reference's in-scan fold-in counter (the
        carried ``gen``): a row that has not frozen has ``gen = counters +
        step`` when the scheduler passes the chain-start count plus K per
        dispatch, and a frozen row's draw is never read.

        Returns ``(toks, lps, tvs, tis, carry)`` with [K, B]-leading
        output tensors and ``carry`` the next dispatch's device-resident
        ``(tokens, positions, gen, done, ring, gstate)``."""
        cfg = self.config.model
        k_steps = max(1, self.config.multi_step_decode)
        bs = self.config.kv_block_size
        max_len = self.config.max_model_len
        b = block_tables.shape[0]
        i32 = torch.int32
        temperature = np.asarray(temperature, np.float32)
        samp = SamplingParams.from_host(
            self.device, temperature, top_k, top_p, min_p, presence_penalty,
            frequency_penalty, repetition_penalty)
        sampled_rows = np.nonzero((temperature > 0.0) & np.asarray(commit, bool))[0]
        counters = np.asarray(counters, np.int64)
        if ring0 is None:
            ring0 = np.full((b, SUFFIX_RING_W), -1, np.int32)
        if gstate0 is None:
            gstate0 = np.full(b, -1, np.int32)
        if stop_hash is None:
            stop_hash = np.zeros((b, STOP_SEQ_WIDTH), np.uint32)
        if stop_hlen is None:
            stop_hlen = np.zeros((b, STOP_SEQ_WIDTH), np.int32)
        i64 = torch.int64
        d = self._tp(
            bt=(block_tables, i32), member=(commit, torch.bool),
            sids=(stop_ids, i32), mn=(min_new, i32), mx=(max_new, i32),
            sh=(stop_hash, i64), sl=(stop_hlen, i32),
            toks=(tokens0, i64), pos=(positions0, i64), gen=(gen0, i32),
            done=(done0, torch.bool), ring=(ring0, i32), gstate=(gstate0, i64))
        bt, member, sids, mn, mx, sh, sl = (
            d[k] for k in ("bt", "member", "sids", "mn", "mx", "sh", "sl"))
        toks, pos, gen, done, ring, gstate = (
            d[k] for k in ("toks", "pos", "gen", "done", "ring", "gstate"))
        slots = torch.arange(b, device=self.device)
        counts, seen, bias = self.sample_state
        outs = []
        for step_i in range(k_steps):
            live = member & ~done
            blk = bt[slots, (pos // bs).clamp(max=bt.shape[1] - 1)]
            slot = torch.where(live, blk.long() * bs + pos % bs, -1)
            gumbel = gumbel_noise(seed_keys, counters + step_i, cfg.vocab_size,
                                  self.device, rows=sampled_rows)
            hidden, self.kv_cache = self.arch.forward(
                self.params, cfg, toks[:, None], pos[:, None], self.kv_cache,
                bt, slot[:, None], _table_ctx(pos, bt, bs), return_hidden=True)
            logits = self.arch.lm_logits(hidden[:, 0], self.params, cfg)
            gmask = None
            if gtable is not None:
                guided = gstate >= 0
                sel = torch.where(guided, gstate, 0)
                gmask = torch.where(guided[:, None] & (gtable[sel] < 0),
                                    -1e9, 0.0).float()
            nt, lp, tv, ti, hard, cand, ring = sample_and_logprobs(
                cfg, logits, samp, gumbel, counts, seen, bias, slots, live,
                want_top, fused=self.fused_epilogue, unique_slots=True,
                extra_bias=gmask,
                finish=(gen, pos.int(), mn, mx, sids, ring, sh, sl),
                max_model_len=max_len)
            gen = gen + live.to(i32)
            newly = hard | cand
            if gtable is not None:
                # grammar advance on the sampled token: DONE (state 0)
                # completes the constraint; a reject (< 0) is unreachable
                # through the mask but freezes defensively. A hard finish
                # wins, as the host checks finish before the guided advance
                gnext = gtable[sel, nt].long()
                newly = newly | (guided & ~hard & (gnext <= 0))
            newly = live & newly
            done = done | newly
            # the finishing token still emits; later steps of a frozen row
            # emit -1 pads
            outs.append((torch.where(live, nt, -1), torch.where(live, lp, 0.0),
                         tv, ti))
            adv = live & ~newly
            toks = torch.where(adv, nt, toks)
            pos = torch.where(adv, pos + 1, pos)
            if gtable is not None:
                gstate = torch.where(adv & guided, gnext, gstate)
        toks_o, lps_o, tvs, tis = (torch.stack(parts) for parts in zip(*outs))
        return toks_o, lps_o, tvs, tis, (toks, pos, gen, done, ring, gstate)

    @property
    def embed_ready(self) -> bool:
        """Can this runner serve the embeddings workload? Llama-family GQA
        dense trunks without sliding windows (``embed_forward`` runs the
        cacheless dense-attention trunk)."""
        cfg = self.config.model
        return (self.arch is llama and not cfg.sliding_window
                and not cfg.num_experts and not cfg.kv_lora_rank
                and self.config.pp_size == 1)

    @torch.inference_mode()
    def embed_prompts(self, prompts) -> np.ndarray:
        """Batched prefill-only embeddings: prompts → [n, D] float32.

        Rows pad to the PREFILL_ROW_BUCKETS ladder and lengths to the
        prefill bucket ladder, as the batched prefill does, but through the
        CACHELESS trunk (``llama.embed_forward``): no block allocation, no
        KV writes, no decode slot. Blocking (the vectors are read back to
        the host); callers on an event loop run it in an executor."""
        if not self.embed_ready:
            raise ValueError(
                "embeddings are served by llama-family GQA dense trunks "
                "only (no MoE/MLA/sliding-window embed path yet)")
        cfg = self.config
        out = np.zeros((len(prompts), cfg.model.hidden_size), np.float32)
        i = 0
        while i < len(prompts):
            batch = prompts[i: i + cfg.PREFILL_ROW_BUCKETS[-1]]
            rows = cfg.prefill_row_bucket(len(batch))
            bucket = cfg.bucket_for(max(len(p) for p in batch))
            tokens = np.zeros((rows, bucket), np.int32)
            positions = np.zeros((rows, bucket), np.int32)
            valid = np.ones(rows, np.int32)
            for j, p in enumerate(batch):
                tokens[j, : len(p)] = p
                positions[j, : len(p)] = np.arange(len(p))
                positions[j, len(p):] = len(p) - 1
                valid[j] = len(p)
            dev = self._tp(tokens=(tokens, torch.int64),
                           positions=(positions, torch.int64),
                           valid=(valid, torch.int64))
            vecs = self.arch.embed_forward(
                self.params, cfg.model, dev["tokens"], dev["positions"],
                dev["valid"])
            out[i: i + len(batch)] = vecs[: len(batch)].cpu().numpy()
            i += len(batch)
        return out

    @torch.inference_mode()
    def set_sample_row(self, slot: int, prompt_ids, generated_ids=(),
                       logit_bias=None, guided_mask=None) -> None:
        """Install sampling state for a slot at admission: prompt presence,
        generated-token counts (non-empty when resuming a preempted
        stream) and the request's OpenAI logit_bias row — plus, for guided
        decoding, the initial token mask (``guided_mask``: dense [V] f32
        the logit_bias entries add onto)."""
        v = self.config.model.vocab_size
        seen_row = np.zeros(v, bool)
        if len(prompt_ids):
            ids = np.asarray(prompt_ids, np.int64)
            seen_row[ids[(ids >= 0) & (ids < v)]] = True
        counts_row = np.zeros(v, np.int32)
        if len(generated_ids):
            gids = np.asarray(generated_ids, np.int64)
            np.add.at(counts_row, gids[(gids >= 0) & (gids < v)], 1)
        bias_row = (np.asarray(guided_mask, np.float32).copy()
                    if guided_mask is not None else np.zeros(v, np.float32))
        for tid, val in (logit_bias or {}).items():
            tid = int(tid)
            if 0 <= tid < v:
                bias_row[tid] += float(val)
        counts, seen, bias = self.sample_state
        counts[slot].copy_(self._t(counts_row, torch.int32))
        seen[slot].copy_(self._t(seen_row, torch.bool))
        bias[slot].copy_(self._t(bias_row, torch.float32))

    @torch.inference_mode()
    def set_bias_row(self, slot: int, bias_row: np.ndarray) -> None:
        """Replace ONE slot's sampler bias row (guided decoding's token
        mask; it also carries the request's logit_bias)."""
        self.sample_state[2][slot].copy_(
            self._t(np.asarray(bias_row, np.float32), torch.float32))

    @torch.inference_mode()
    def edit_bias_entries(self, slot: int, ids, vals) -> bool:
        """Sparse update of ONE slot's bias row: ``row[ids] = vals``. A
        guided mask changes only around a trie node (a handful of ids),
        not across the vocabulary. Always applies (the reference returns
        False past its largest compiled edit bucket; eager PyTorch has no
        bucket)."""
        if len(ids):
            self.sample_state[2][slot].index_copy_(
                0, self._t(np.asarray(ids, np.int64)),
                self._t(np.asarray(vals, np.float32), torch.float32))
        return True

    def warmup(self, decode_batch: Optional[int] = None) -> None:
        """Build the kernels (on a card) and run one inert step per prefill
        bucket, one decode step, one verify-shaped step (S = the ngram
        proposal count + 1, or 2), with ``sp_size > 1`` one SP chunk, with
        ``multi_step_decode > 1`` or a dispatch-ahead pipeline (or the SP
        ladder's decode handoff) one burst, and with ``multi_step_decode >
        1`` (the synchronous bursts freeze finished rows on the device) or
        device finish one chained burst (with a one-state guided table, so
        both forms of the epilogue have launched), so no first request pays
        for a kernel build or a first-launch cost. Inert: every slot is the
        drop sentinel and nothing commits, so the cache and the sample
        state keep their values."""
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
        zf, zi = np.zeros(b, np.float32), np.zeros(b, np.int32)
        inert = dict(
            min_p=zf, presence_penalty=zf, frequency_penalty=zf,
            repetition_penalty=np.ones(b, np.float32),
            seed_keys=np.zeros((b, 2), np.uint32), counters=zi,
            commit=np.zeros(b, bool))
        pipelined = self.config.decode_pipeline_depth >= 2
        if self.config.multi_step_decode > 1 or pipelined or self.sp_ready:
            self.decode_burst(zi, zi, np.zeros((b, w), np.int32), zf, zi,
                              np.ones(b, np.float32), **inert)
        if self.sp_ready:
            # the SP chunk, inert: every slot is the drop sentinel and the
            # tail runs without a commit
            S, w = self._sp_bucket, self.config.blocks_per_seq
            z = np.zeros((1, S), np.int32)
            self._sp_dispatch(z, z, np.full((1, S), -1, np.int32),
                              np.zeros((1, w), np.int32), 0, 1, 0, tail=True)
        if self.config.multi_step_decode > 1 or self.config.device_finish_enabled:
            gtable = torch.full((1, self.config.model.vocab_size), -1,
                                dtype=torch.int32, device=self.device)
            for table in (None, gtable):
                self.decode_burst_chained(
                    zi, zi, zi, np.zeros(b, bool), np.zeros((b, w), np.int32),
                    zf, zi, np.ones(b, np.float32),
                    stop_ids=np.full((b, STOP_ID_WIDTH), -1, np.int32),
                    min_new=zi, max_new=zi, gtable=table, **inert)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _to_device(tree, device, dtype):
    """The param tree on ``device``, every leaf in ``dtype`` but a quantized
    one, whose int8 ``q`` and f32 ``scale`` keep their dtypes (cast to bf16
    it would serve full precision at twice the bytes)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, quant.QuantizedWeight):
        return tree.to(device)
    return tree.to(device=device, dtype=dtype)
