"""Engine configuration: model architecture + serving shapes + mesh layout.

The port's copy of ``dynamo_tpu/engine/config.py``. Every field is kept so
a configuration written for the reference package parses here unchanged;
``EngineConfig`` rejects, with a clear error, the features this slice of
the port does not serve yet (see ``_reject_unported``). Prefill lengths are
bucketed and block tables are fixed-width exactly as in the reference, so
both packages run the same step shapes.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List, Optional


@dataclasses.dataclass
class ModelConfig:
    """Llama-family architecture description (HF config.json compatible)."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    # HF rope_scaling dict (rope_type/type + params): "linear", "llama3"
    # and "yarn" (incl. DeepSeek's mscale variant) are applied exactly
    # (models/llama.rope_frequencies); other types load with a loud
    # warning (unscaled frequencies)
    rope_scaling: Optional[dict] = None
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    # qkv projection biases (Qwen2-family); o_proj stays bias-free
    attention_bias: bool = False
    # MoE (Mixtral-class); num_experts == 0 means dense
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 2.0  # headroom over perfectly-balanced routing
    moe_intermediate_size: int = 0    # per-expert width; 0 → intermediate_size
    n_shared_experts: int = 0         # DeepSeek always-on shared expert count
    first_k_dense_replace: int = 0    # DeepSeek: first k layers use dense MLP
    # routing semantics (DeepSeek): gate score fn, top-k weight normalization,
    # and the scaling applied to the routed (non-shared) output
    moe_scoring_func: str = "softmax"  # "softmax" | "sigmoid"
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    # DeepSeek group-limited routing: experts partition into n_group
    # groups, top-k selection is restricted to the topk_group
    # best-scoring groups (V2 "group_limited_greedy" scores a group by
    # its max expert, V3 "noaux_tc" by its top-2 sum of biased scores).
    # n_group == 1 disables the restriction (Mixtral/Qwen/V2-Lite).
    n_group: int = 1
    topk_group: int = 1
    # attention implementation, kept for config compatibility: the port
    # dispatches on the tensors' device (CPU → the plain PyTorch route,
    # CUDA → the hand-written kernels). "xla" (the plain route) is refused
    # on a CUDA device: it never runs on the serving path there.
    attention_impl: str = "auto"
    # serving-time weight quantization: None (checkpoint dtype) or "int8"
    # (per-out-channel weight-only; halves the decode weight stream —
    # models/quant.py QUANT_KEYS: llama-family trunks, MoE expert
    # stacks incl. GPT-OSS fused gate/up, DeepSeek shared experts and
    # MLA low-rank projections).
    quantization: Optional[str] = None
    # Gemma-2 family (models/gemma2.py): sandwich norms, GeGLU, logit
    # softcapping, alternating sliding-window attention. model_family
    # "gemma2" routes models.resolve; the numeric fields are 0/off for
    # every other family.
    model_family: str = ""
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    query_pre_attn_scalar: int = 0
    sliding_window: int = 0
    # MLA (DeepSeek-class); kv_lora_rank > 0 enables MLA attention
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_heads
        if self.kv_lora_rank > 0:
            missing = [
                name for name in
                ("qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim")
                if getattr(self, name) <= 0
            ]
            if missing:
                raise ValueError(
                    f"kv_lora_rank={self.kv_lora_rank} selects MLA attention, "
                    f"which also requires {', '.join(missing)} > 0"
                )

    @classmethod
    def from_hf_config(cls, config: dict) -> "ModelConfig":
        arch = str(config.get("architectures", "")).lower()
        rope_scaling = config.get("rope_scaling") or None
        if rope_scaling and rope_scaling.get(
                "rope_type", rope_scaling.get("type")) in ("longrope", "su"):
            # longrope's profile choice and attention factor need the
            # original/extended windows, which live OUTSIDE the HF
            # rope_scaling dict — carry them in (models/llama.py)
            rope_scaling = dict(rope_scaling)
            rope_scaling.setdefault(
                "original_max_position_embeddings",
                config.get("original_max_position_embeddings")
                or config.get("max_position_embeddings", 4096),
            )
            rope_scaling.setdefault(
                "max_position_embeddings",
                config.get("max_position_embeddings", 4096),
            )
        if config.get("num_experts") and (
            config.get("mlp_only_layers")
            or config.get("decoder_sparse_step", 1) != 1
        ):
            # Qwen-MoE variants that interleave dense MLP layers; the
            # MoE trunk here is uniformly sparse
            raise NotImplementedError(
                "MoE checkpoints with mlp_only_layers/decoder_sparse_step "
                "(mixed dense+sparse trunks) are not supported"
            )
        lt = config.get("layer_types")
        if "gptoss" in arch and lt:
            want = [
                "sliding_attention" if i % 2 == 0 else "full_attention"
                for i in range(len(lt))
            ]
            if list(lt) != want:
                # the family module hardcodes the even-sliding alternation
                # (models/gptoss.py window = li % 2 == 0)
                raise NotImplementedError(
                    "gpt-oss layer_types must alternate "
                    "sliding/full starting sliding at layer 0"
                )
        if config.get("shared_expert_intermediate_size"):
            # Qwen2-MoE's sigmoid-gated shared expert — reject at config
            # parse, BEFORE any multi-GB checkpoint stream starts (the
            # loader keeps a tensor-level backstop)
            raise NotImplementedError(
                "Qwen2-MoE checkpoints (gated shared expert) are not "
                "supported; Qwen3-MoE and Mixtral load"
            )
        n_group = config.get("n_group", 1) or 1
        topk_group = config.get("topk_group", 1) or 1
        if config.get("topk_method") == "greedy":
            # DeepSeek-V2-Lite ships n_group in its config but routes
            # plain greedy — the restriction is off
            n_group = topk_group = 1
        n_experts = (config.get("num_local_experts", 0)
                     or config.get("n_routed_experts", 0)
                     or config.get("num_experts", 0) or 0)
        if n_group > 1:
            # the group-limited restriction only composes when the
            # expert set tiles evenly into groups and the selection can
            # still fill top_k from the permitted groups
            if n_experts % n_group:
                raise ValueError(
                    f"n_group={n_group} does not divide "
                    f"n_routed_experts={n_experts}"
                )
            if not (1 <= topk_group <= n_group):
                raise ValueError(
                    f"topk_group={topk_group} outside [1, n_group={n_group}]"
                )
            if topk_group * (n_experts // n_group) < config.get(
                    "num_experts_per_tok", 2):
                raise ValueError(
                    "permitted groups hold fewer experts than "
                    "num_experts_per_tok"
                )
        return cls(
            vocab_size=config.get("vocab_size", 32000),
            hidden_size=config.get("hidden_size", 2048),
            intermediate_size=config.get("intermediate_size", 5632),
            num_layers=config.get("num_hidden_layers", 16),
            num_heads=config.get("num_attention_heads", 16),
            num_kv_heads=config.get(
                "num_key_value_heads", config.get("num_attention_heads", 16)
            ),
            head_dim=config.get("head_dim"),
            rope_theta=config.get("rope_theta", 10000.0),
            rope_scaling=rope_scaling,
            # Qwen2-family checkpoints carry qkv biases but their HF config
            # has no attention_bias key — infer from the architecture name
            attention_bias=config.get("attention_bias", "qwen2" in arch),
            rms_norm_eps=config.get("rms_norm_eps", 1e-5),
            max_position_embeddings=config.get("max_position_embeddings", 4096),
            tie_word_embeddings=config.get("tie_word_embeddings", False),
            num_experts=config.get("num_local_experts", 0)
            or config.get("n_routed_experts", 0)
            or config.get("num_experts", 0)  # Qwen-MoE config key
            or 0,
            num_experts_per_tok=config.get("num_experts_per_tok", 2),
            moe_intermediate_size=config.get("moe_intermediate_size", 0) or 0,
            n_shared_experts=config.get("n_shared_experts", 0) or 0,
            first_k_dense_replace=config.get("first_k_dense_replace", 0) or 0,
            moe_scoring_func=config.get("scoring_func", "softmax"),
            norm_topk_prob=config.get("norm_topk_prob", True),
            routed_scaling_factor=config.get("routed_scaling_factor", 1.0) or 1.0,
            n_group=n_group,
            topk_group=topk_group,
            # Gemma-2 / GPT-OSS (config.json keys; sliding_window exists
            # in other families' configs too, so gate on the architecture)
            model_family=(
                "gemma2" if "gemma2" in arch
                else "gptoss" if "gptoss" in arch
                else ""
            ),
            attn_logit_softcap=config.get("attn_logit_softcapping") or 0.0,
            final_logit_softcap=config.get("final_logit_softcapping") or 0.0,
            query_pre_attn_scalar=config.get("query_pre_attn_scalar", 0) or 0,
            # honored whenever the checkpoint's HF modeling honors it:
            # gemma2 alternates it per layer; mistral/phi3-style configs
            # apply it to every layer; qwen2 ships the key but disables
            # it via use_sliding_window
            sliding_window=(
                (config.get("sliding_window", 0) or 0)
                if ("gemma2" in arch
                    or config.get("use_sliding_window", True))
                else 0
            ),
            # MLA (DeepSeek config.json keys)
            kv_lora_rank=config.get("kv_lora_rank", 0) or 0,
            q_lora_rank=config.get("q_lora_rank", 0) or 0,
            qk_rope_head_dim=config.get("qk_rope_head_dim", 0) or 0,
            qk_nope_head_dim=config.get("qk_nope_head_dim", 0) or 0,
            v_head_dim=config.get("v_head_dim", 0) or 0,
        )

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "ModelConfig":
        """HF snapshot dir (config.json) or a .gguf file (its metadata)."""
        if model_dir.endswith(".gguf"):
            from ..llm.gguf import model_config_from_gguf, read_gguf

            return model_config_from_gguf(read_gguf(model_dir))
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_hf_config(json.load(f))


def check_quantization(model: ModelConfig) -> None:
    """The reference's config-only quantization check
    (``dynamo_tpu/engine/model_runner.py``), run before any weight is drawn
    or loaded: int8 weight-only is the one scheme."""
    if model.quantization and model.quantization != "int8":
        raise ValueError(
            f"unknown quantization {model.quantization!r} (only int8)"
        )


def check_kv_cache_dtype(kv_cache_dtype: str) -> None:
    """The reference's check of ``EngineConfig.kv_cache_dtype``
    (``dynamo_tpu/engine/model_runner.py:208-212``): "auto" or "fp8"."""
    if kv_cache_dtype not in ("auto", "fp8"):
        raise ValueError(
            f"unknown kv_cache_dtype {kv_cache_dtype!r} (auto | fp8)"
        )


def default_prefill_buckets(max_len: int) -> List[int]:
    """Powers of two up to max_len — each bucket is one compiled program."""
    buckets = []
    b = 64
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return buckets


@dataclasses.dataclass
class EngineConfig:
    model: ModelConfig
    max_batch_size: int = 8          # concurrent decode slots
    max_model_len: int = 4096        # max tokens per sequence (prompt+gen)
    kv_block_size: int = 16
    num_kv_blocks: int = 2048        # HBM budget for the paged cache
    prefill_buckets: Optional[List[int]] = None
    dtype: str = "bfloat16"
    # paged-KV-cache storage dtype: "auto" stores at the engine dtype;
    # "fp8" stores float8_e4m3fn — halves the decode KV stream and
    # doubles cache capacity for ~6% elementwise KV error (the standard
    # serving lever the reference's engines expose as kv_cache_dtype).
    # Unscaled e4m3: post-rope K and V are O(1), well inside its ±448
    # range (a write clamps to it: ops/attention.to_cache_dtype). Every
    # family, MLA included: the reference measured the e4m3 noise on
    # MLA's latent + rope cache to match the GQA path's (rel logit error
    # 0.043 against 0.042, argmax flips 0.10 against 0.10;
    # dynamo_tpu/engine/model_runner.py:213-221), and its MLA decode
    # kernel has its own fp8 form, as the port's has (mla_decode_fp8).
    # Sequence-parallel prefill reads an fp8 prefix through kernel 6's fp8
    # form (sp_prefix_partials_fp8).
    kv_cache_dtype: str = "auto"
    # mesh axes: pipeline stages x data-parallel replicas x expert-parallel
    # x tensor-parallel. pp > 1 stages the dense trunk over a collective
    # GPipe schedule (parallel/pipeline.py) — reference analog:
    # pipeline_parallel_size = num_nodes (lib/engines/vllm0_7/src/
    # vllm_inc.py:37-38 over Ray); here it is one SPMD program over the
    # mesh's pp axis.
    pp_size: int = 1
    dp_size: int = 1
    ep_size: int = 1
    tp_size: int = 1
    # sequence parallelism for long-context prefill (parallel/sequence.py):
    # sp_size > 1 routes ONE oversized prompt at a time through the
    # sequence-parallel chunk ladder — ring attention over the chunk's
    # fresh K/V merged with partials of the committed paged prefix. In the
    # port the ``sp`` ranks are laid out on the one device as the leading
    # dimension of the query shard (rank r owns chunk rows [r·S/sp,
    # (r+1)·S/sp), the ring's rotation is a roll of that dimension); it is
    # not a mesh of cards. Decode ignores it, so an sp engine decodes
    # exactly as before. Llama-family GQA dense trunks only (no MLA, MoE,
    # sliding window or softcap), and no tp/pp beside it.
    sp_size: int = 1
    # the admission class: prompts whose uncached suffix is at least this
    # long route to the sequence-parallel prefill program (local mesh) or,
    # in disagg mode, bias toward the prefill-worker pool whose workers
    # run the same SP chunk ladder. 0 with sp_size > 1 defaults to
    # max_prefill_tokens_per_step (one dense chunk budget); 0 with
    # sp_size == 1 disables the class entirely.
    long_prefill_threshold_tokens: int = 0
    seed: int = 0
    # serve random-init weights when model_dir has no checkpoint (tests,
    # topology dry runs); off by default so a misnamed checkpoint dir
    # fails loudly instead of serving plausible-looking garbage
    allow_random_weights: bool = False
    # scheduler knobs
    max_prefill_tokens_per_step: int = 8192
    # concurrent prompts batched into ONE prefill step (rows padded to a
    # power-of-two ladder; one compiled program per (rows, bucket)).
    # Serial prefill (the round-2 design) queued TTFT linearly under
    # prompt bursts; batching amortizes the weight stream and per-step
    # overhead across rows. 1 restores strictly-serial behavior.
    max_prefill_batch: int = 4
    # decode steps fused into ONE device dispatch (lax.scan inside the
    # compiled program). Each dispatch pays fixed host+launch overhead
    # (scheduler bookkeeping, transfer latency, program launch); at small
    # per-step compute that overhead dominates, and fusing K steps
    # amortizes it K-fold — the TPU-native analog of the multi-step
    # scheduling the reference's engines use. Tokens stream in bursts of
    # K (ITL becomes bursty), so it only engages when no prefill work is
    # waiting, and 1 (default) keeps strict per-token dispatch. Sampling
    # is bit-identical either way (same per-row PRNG fold-in counters).
    multi_step_decode: int = 1
    # dispatch-ahead decode: with depth 2, burst k+1 is dispatched before
    # burst k's sampled tokens are synced to the host (JAX dispatch is
    # async; the carry tokens are already device-resident), so the host's
    # detokenize/stream/finish-check work for burst k overlaps burst
    # k+1's device compute instead of leaving the TPU idle. Finishes
    # (eos/stop/max-token/cancel) are detected one burst late and the
    # over-decoded rows retro-invalidated (tokens truncated, KV blocks
    # rolled back); block headroom for 2*K positions is reserved before
    # every dispatch so the in-flight burst can never OOM. Guided
    # decoding, speculative decoding, and prefill work force the
    # synchronous path per pass. 0/1 = today's strictly-synchronous
    # behavior, 2 = double-buffered (the only pipelined depth).
    decode_pipeline_depth: int = 1
    # device-resident finish detection (the persistent decode loop):
    # "auto" | "on" | "off". When enabled, the fused decode burst carries
    # a per-row ``done`` mask and evaluates EOS / hidden-stop /
    # max-tokens / model-len checks INSIDE the scan — finished rows
    # freeze (no further sampling or KV writes, padded emission) instead
    # of ending the burst, so the scheduler dispatches bursts
    # back-to-back off the device-resident carry and drains completed
    # rows asynchronously, compacting batch membership only at natural
    # barriers (admission, preemption, KV-OOM, drain). The carry also
    # holds speculative state (trailing-token ring), bounded guided
    # grammar state (guided_device_table below), and the stop-string
    # suffix-hash ring (device_stop_strings below), so spec / guided /
    # stop-string / n>1 traffic chains too; the remaining sync-path
    # fallbacks are counted per pass in
    # dynamo_engine_sync_fallback_total{reason}. "auto" engages with
    # decode_pipeline_depth >= 2; "on" requires it.
    device_finish: str = "auto"
    # the fused Pallas sampling epilogue (ops/pallas_epilogue.py): run
    # the whole per-step decode tail — penalties, top-k/top-p/min-p
    # sampling, count commit, and (in the chained burst) the
    # device-finish verdict + stop-suffix rolling hash — as ONE kernel
    # dispatch instead of a string of small [B, V] XLA ops. Sampling is
    # bit-identical to the unfused ladder by construction. "auto"
    # follows the attention route: it engages exactly when the Pallas
    # serving kernels do (warmup probe passes), so the probe/warmup XLA
    # fallback drops it automatically. "on" forces it (CPU tests use
    # DYN_PALLAS_INTERPRET=1); "off" keeps the XLA tail.
    fused_epilogue: str = "auto"
    # guided decoding inside the chain: compile TrieConstraint /
    # in-bound JsonGrammar cursors to a dense device transition table
    # (state x token -> next state) so the per-token mask is computed
    # on device and the grammar cursor advances in the burst carry.
    # Grammars whose reachable state set exceeds the bound keep the
    # host sync path explicitly (fallback reason "guided_table_bound").
    guided_device_table: bool = True
    guided_table_max_states: int = 256
    # stop STRINGS inside the chain: device-approximate detection via a
    # rolling suffix-hash over the burst carry's trailing-token ring
    # against the stop strings' canonical tokenizations
    # (StopConditions.stop_token_seqs); candidate rows freeze on device,
    # the host confirms exactly on drain, and hash-collision false
    # positives resume byte-identically. Off -> stop-string rows keep
    # the per-burst sync pipeline.
    device_stop_strings: bool = True
    # n-gram (prompt-lookup) speculative decoding: propose up to K tokens
    # per decode step by matching the context's trailing n-gram against
    # its own history, then VERIFY all K+1 positions in one forward.
    # Decode is bandwidth-bound (weights stream once per step regardless
    # of S), so accepted tokens are nearly free — the reference's engines
    # ship the same technique (vLLM ngram speculative decoding). Greedy,
    # penalty-free requests only; mixed batches fall back per step.
    spec_ngram_tokens: int = 0   # K proposal tokens (0 = off)
    spec_ngram_match: int = 3    # trailing n-gram length to look up
    # draft-MODEL speculative decoding: a small model proposes K tokens
    # per round (its fused K-step burst = ONE extra dispatch) and the
    # target verifies all K+1 positions in one forward — the
    # draft/verify speculation reference-class engines ship. The draft
    # keeps a mirror paged cache on the SAME block ids as the target
    # (same allocator decisions), so prefix-cache hits, resume, and
    # block registration carry valid draft context for free. Greedy,
    # penalty-free requests only (stream is provably identical either
    # way). Mutually exclusive with ngram speculation; incompatible
    # with the host KV tier (restored blocks would hold stale draft KV).
    spec_draft_model: Optional[str] = None  # HF dir of the draft model
    spec_draft_tokens: int = 0              # K proposals per round (2..16)
    # streamed remote prefill (the disagg prefill worker): the worker
    # always chunks its prefill with the shared bucket ladder +
    # max_prefill_tokens_per_step and streams each chunk's completed KV
    # blocks while the next chunk computes, so remote TTFT approaches
    # max(compute, transfer) instead of compute + transfer. This knob is
    # the transfer plane's frame depth: 2 (default) double-buffers — the
    # next frame's gather/host-pack proceeds while the previous frame's
    # bytes are on the wire — and 1 ships frames strictly serially.
    # Streams are byte-identical at every depth; host memory is bounded
    # at <= depth chunk-sized frames either way.
    disagg_stream_depth: int = 2
    enable_prefix_caching: bool = True
    # host-RAM KV offload tier: evicted HBM blocks are copied out and can be
    # restored on later prefix hits instead of recomputed. 0 disables.
    host_kv_blocks: int = 0
    # cluster KV fabric (kv/fabric.py, docs/kv_fabric.md): cross-worker
    # prefix PULL — when the fabric's ownership view says a peer holds a
    # longer prefix of an incoming prompt than every local tier, the
    # scheduler pulls those committed KV blocks over the transfer plane
    # instead of recomputing them (pull failure/timeout falls back to
    # local recompute, byte-identically). The peer view itself (KV event
    # feed + pull-server descriptors) is wired by the CLI/discovery
    # layer; this flag builds the engine-side machinery.
    prefix_pull: bool = False
    # minimum remote/cold extension (in blocks past the local hit) worth
    # a pull — below this the transfer round trip loses to recompute
    prefix_pull_min_blocks: int = 2
    # per-pull deadline: a dead/stalled source must never hold a request
    # past this before the local-recompute fallback takes over
    prefix_pull_timeout_s: float = 30.0
    # content-addressed cold tier (kv/cold_tier.py): host-tier-evicted
    # blocks spill to checksummed files keyed by sequence hash in this
    # directory, so cold-but-hot-again prefixes (system prompts, RAG
    # documents) survive RAM eviction and ANY worker sharing the
    # directory — including a freshly respawned one — can rehydrate
    # them. Requires host_kv_blocks > 0 (the spill source is host-tier
    # eviction). Both knobs must be set together.
    cold_tier_dir: str = ""
    cold_tier_blocks: int = 0
    # stall watchdog (telemetry/watchdog.py): trip when work is pending
    # but the scheduler loop's heartbeat (or its dispatch counter) has
    # been stale for this long — a wedged Mosaic compile or dead host
    # sync then dumps a flight artifact to DYN_FLIGHT_DIR instead of
    # freezing silently. 0 disables the watchdog. The deadline must
    # comfortably exceed one loop PASS (chunked prefill bounds a pass;
    # a cold late compile is the longest legitimate pass).
    watchdog_stall_s: float = 30.0
    watchdog_interval_s: float = 1.0

    def __post_init__(self):
        if self.prefill_buckets is None:
            self.prefill_buckets = default_prefill_buckets(self.max_model_len)
        self.prefill_buckets = sorted(self.prefill_buckets)
        if self.dp_size > 1:
            if self.max_batch_size % self.dp_size:
                raise ValueError(
                    f"max_batch_size {self.max_batch_size} not divisible "
                    f"by dp_size {self.dp_size} (decode rows shard over dp)"
                )
            # batch rows shard over dp in every compiled program (jit
            # in_shardings P("dp")), so the padded prefill row ladder must
            # stay dp-divisible too — scale it; short batches ride as
            # inert pad rows
            self.PREFILL_ROW_BUCKETS = tuple(
                r * self.dp_size for r in type(self).PREFILL_ROW_BUCKETS
            )
        # clamp into the compiled row ladder: values past the top bucket
        # would admit more rows than the step arrays hold (IndexError in
        # the scheduler), and <= 0 would silently admit nothing
        self.max_prefill_batch = max(
            1, min(self.max_prefill_batch, self.PREFILL_ROW_BUCKETS[-1])
        )
        # a burst must fit comfortably inside one sequence's block budget;
        # 64 already amortizes dispatch overhead past the point of returns
        self.multi_step_decode = max(1, min(self.multi_step_decode, 64))
        # depth > 2 buys nothing: with one burst in flight the host is
        # already fully overlapped, and reconciliation lag grows with
        # every extra stage — clamp instead of failing
        self.decode_pipeline_depth = max(0, min(self.decode_pipeline_depth, 2))
        if self.device_finish not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown device_finish {self.device_finish!r} "
                "(auto | on | off)"
            )
        if self.fused_epilogue not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown fused_epilogue {self.fused_epilogue!r} "
                "(auto | on | off)"
            )
        if self.device_finish == "on" and self.decode_pipeline_depth < 2:
            # the chained dispatch only exists under the dispatch-ahead
            # pipeline; an explicit "on" that silently never engaged
            # would be worse than failing here
            raise ValueError(
                "device_finish='on' requires decode_pipeline_depth >= 2 "
                "(the persistent loop rides the dispatch-ahead pipeline)"
            )
        # (speculation + device_finish used to be mutually exclusive —
        # the chain now runs propose-verify rounds off the same device
        # carry, so spec engines chain too)
        self.guided_table_max_states = max(2, self.guided_table_max_states)
        # one frame in flight is the serial floor; beyond two buys nothing
        # (the wire is busy continuously at 2) and unbounds host buffers
        self.disagg_stream_depth = max(1, min(self.disagg_stream_depth, 2))
        # watchdog: negative means off (same as 0); the sampling interval
        # floors at 50 ms so a mistyped value can't busy-spin the loop
        self.watchdog_stall_s = max(0.0, self.watchdog_stall_s)
        self.watchdog_interval_s = max(0.05, self.watchdog_interval_s)
        self.spec_ngram_tokens = max(0, min(self.spec_ngram_tokens, 16))
        self.spec_ngram_match = max(1, self.spec_ngram_match)
        self.sp_size = max(1, self.sp_size)
        self.long_prefill_threshold_tokens = max(
            0, self.long_prefill_threshold_tokens)
        if self.sp_size > 1:
            if self.prefill_buckets[0] % self.sp_size:
                # every SP chunk pads to a bucket sharded over the axis;
                # the smallest bucket bounds the divisibility requirement
                raise ValueError(
                    f"sp_size {self.sp_size} must divide the smallest "
                    f"prefill bucket {self.prefill_buckets[0]}"
                )
            if self.pp_size > 1:
                raise ValueError(
                    "sp_size > 1 does not compose with pipeline "
                    "parallelism (the SP program assumes an unstaged "
                    "cache)"
                )
            if self.long_prefill_threshold_tokens == 0:
                # default: anything past one dense chunk budget is
                # "long" — it would already take multiple ladder passes
                self.long_prefill_threshold_tokens = (
                    self.max_prefill_tokens_per_step
                    or self.prefill_buckets[-1]
                )
            self.check_sp_trunk()
        self._reject_unported()
        self.prefix_pull_min_blocks = max(1, self.prefix_pull_min_blocks)
        self.prefix_pull_timeout_s = max(0.1, self.prefix_pull_timeout_s)
        if bool(self.cold_tier_dir) != (self.cold_tier_blocks > 0):
            raise ValueError(
                "cold_tier_dir and cold_tier_blocks must be set together "
                f"(got dir={self.cold_tier_dir!r}, "
                f"blocks={self.cold_tier_blocks})"
            )
        if self.cold_tier_blocks > 0 and self.host_kv_blocks <= 0:
            raise ValueError(
                "the cold tier spills from the host tier: "
                "cold_tier_blocks > 0 requires host_kv_blocks > 0"
            )
        if self.spec_draft_tokens and not self.spec_draft_model:
            raise ValueError(
                "spec_draft_tokens set without spec_draft_model — "
                "speculation would silently stay off"
            )
        if self.spec_draft_model:
            if not 2 <= self.spec_draft_tokens <= 16:
                raise ValueError(
                    "spec_draft_model needs spec_draft_tokens in 2..16 "
                    f"(got {self.spec_draft_tokens}; a 1-token draft "
                    "round never amortizes the extra dispatch)"
                )
            if self.spec_ngram_tokens:
                raise ValueError(
                    "spec_draft_model and spec_ngram_tokens are mutually "
                    "exclusive proposal sources"
                )
            if self.host_kv_blocks:
                raise ValueError(
                    "spec_draft_model is incompatible with the host KV "
                    "tier: restored blocks would carry stale draft KV "
                    "(the draft cache mirrors device block ids only)"
                )

    def _reject_unported(self) -> None:
        """Refuse the features the port does not serve yet.

        Served: per-token decode steps and K-step bursts
        (``multi_step_decode``), ngram speculative decoding on the
        synchronous path, the dispatch-ahead pipeline
        (``decode_pipeline_depth=2``) and the chained device-finish loop
        on top of it (``device_finish``, with ``guided_device_table``,
        ``guided_table_max_states`` and ``device_stop_strings`` as live
        knobs), sequence-parallel prefill (``sp_size``, its ranks on the
        one device), disaggregated prefill (``disagg_stream_depth``, and
        ``long_prefill_threshold_tokens`` at ``sp_size`` 1: the prefill
        pool's admission class), the KV tiers and the cluster KV fabric
        (``host_kv_blocks``, ``cold_tier_dir`` / ``cold_tier_blocks``,
        ``prefix_pull`` over tcp), on one device with a KV cache in the activation dtype
        or in fp8 (``kv_cache_dtype="fp8"``; any other value raises the
        reference's ``ValueError``), the weights in the activation dtype
        or in int8 (``quantization="int8"``; any other scheme raises
        ``ValueError`` by name, as in the reference). Not served: the
        chained propose-verify round (so the pipeline together with
        speculation), draft models, several devices (so SP over TP heads).
        Each refusal names the knob so a reference config that uses it
        fails loudly instead of serving something else."""
        check_quantization(self.model)
        check_kv_cache_dtype(self.kv_cache_dtype)
        unported = []
        if self.decode_pipeline_depth >= 2 and self.spec_ngram_tokens > 0:
            unported.append(
                "decode_pipeline_depth >= 2 with spec_ngram_tokens > 0 (the "
                "chained propose-verify round)")
        if self.spec_draft_model:
            unported.append("spec_draft_model (draft-model speculation)")
        if self.sp_size > 1 and self.tp_size > 1:
            unported.append(
                "sp_size > 1 with tp_size > 1 (the SP ring over "
                "tensor-parallel heads, a rank per card)")
        if max(self.tp_size, self.dp_size, self.ep_size, self.pp_size) > 1:
            unported.append("multi-device parallelism (tp/dp/ep/pp)")
        if self.dtype not in ("bfloat16", "float32"):
            unported.append(f"dtype={self.dtype!r}")
        if unported:
            raise NotImplementedError(
                "not ported to the PyTorch engine yet: " + "; ".join(unported)
            )

    def check_sp_trunk(self) -> None:
        """Refuse, by name, the trunks the sequence-parallel chunk has no
        form for (the reference's SP gate, ``model_runner.py:1003-1011``):
        MLA, mixture-of-experts layers, sliding windows, logit softcaps."""
        m = self.model
        bad = [name for name, on in (
            ("MLA attention (kv_lora_rank)", m.kv_lora_rank),
            ("mixture-of-experts layers (num_experts)", m.num_experts),
            ("sliding_window", m.sliding_window),
            ("attn_logit_softcap", m.attn_logit_softcap)) if on]
        if bad:
            raise ValueError(
                "sequence-parallel prefill (sp_size > 1) serves llama-family "
                "GQA dense trunks only; this model has " + ", ".join(bad))

    @property
    def blocks_per_seq(self) -> int:
        return math.ceil(self.max_model_len / self.kv_block_size)

    @property
    def device_finish_enabled(self) -> bool:
        """Resolved device-resident finish detection: explicit on/off,
        auto follows the dispatch-ahead pipeline."""
        if self.device_finish == "on":
            return True
        return (self.device_finish == "auto"
                and self.decode_pipeline_depth >= 2)

    def bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if length <= b:
                return b
        raise ValueError(f"prompt length {length} exceeds max bucket {self.prefill_buckets[-1]}")

    PREFILL_ROW_BUCKETS = (1, 2, 4, 8)

    def prefill_row_buckets(self) -> List[int]:
        """Row-count ladder for batched prefill: the prefill batch pads to
        the next power of two (one compiled program per (rows, bucket));
        warmup sweeps this ladder."""
        cap = self.prefill_row_bucket(self.max_prefill_batch)
        return [r for r in self.PREFILL_ROW_BUCKETS if r <= cap]

    def prefill_row_bucket(self, n: int) -> int:
        for r in self.PREFILL_ROW_BUCKETS:
            if n <= r:
                return r
        return self.PREFILL_ROW_BUCKETS[-1]

    def sp_prefill_bucket(self) -> int:
        """The ONE chunk length the sequence-parallel prefill program
        compiles at: the largest prefill bucket whose PER-DEVICE token
        share (bucket / sp) stays within the per-step budget — the same
        ITL bound the dense ladder honors, scaled by the axis. A fixed
        bucket (short/final chunks pad into it) keeps ``prefill_sp`` at
        exactly one compiled shape."""
        budget = self.max_prefill_tokens_per_step
        if not budget:
            return self.prefill_buckets[-1]
        allowed = [
            b for b in self.prefill_buckets
            if b <= self.sp_size * budget and b % self.sp_size == 0
        ]
        return allowed[-1] if allowed else self.prefill_buckets[0]

    def kv_width_buckets(self) -> List[int]:
        """The decode block-table width ladder: powers of two from 8 up to
        the full per-seq width (always included). One compiled decode
        program exists per bucket; ModelRunner.warmup sweeps the ladder."""
        widths = []
        w = 8
        while w < self.blocks_per_seq:
            widths.append(w)
            w *= 2
        widths.append(self.blocks_per_seq)
        return widths

    def kv_width_bucket(self, nblocks: int) -> int:
        """Block-table width for a decode step covering ``nblocks`` live
        blocks. Attention cost on the gather/page-walk side scales with
        table width, so short contexts must not pay max_model_len's
        width."""
        for w in self.kv_width_buckets():
            if nblocks <= w:
                return w
        return self.blocks_per_seq
