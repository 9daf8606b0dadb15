#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dynamo_tpu_torch``) on one
NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and the CUDA toolkit (``nvcc``); it imports
nothing of JAX or of the JAX package. Phases, each printed as a JSON line:

1. ``device``  — the card's name and ``nvidia-smi`` name / power limit.
2. ``build``   — builds the six kernel sources of
   ``dynamo_tpu_torch/csrc`` and its host checksum (``host_xxh64.cpp``, the
   cold KV tier's; one ``nvcc`` per source, all at once), with ptxas's
   registers and spills of every instantiation.
3. ``kernels`` — holds each kernel against its plain PyTorch version at the
   Llama-3.2-1B shapes (H=32, KVH=8, D=64, bs=16, bf16, a 16-layer stacked
   cache, layer_idx != 0): decode, also at its splits' edges (ctx 0, one
   key under, at and over a 256-key split, a window crossing one), at
   group sizes 1, 4 and 8, at head_dim 128 and at ``engine_sp``'s
   long-context decode batch; flash, also at the engine's batched
   prefill shapes (rows with their own base_pos and ctx, pad rows); verify
   at S 2, 5, 17 and 32 (padded proposals, a window, a pad row), and at
   the splits' edges, group sizes 1, 4 and 8 and head_dim 128; decode and
   verify twice on the same inputs (bit-identical); the
   sampling epilogue at B 8 over V 128,256 in every sampling regime, with
   the count commit in the kernel and outside it, and in its ``finish``,
   ``extra_bias`` and combined forms (stop ids below and above
   ``min_new``, ``max_new``, the model-len horizon, matching and
   non-matching suffixes of every length 1-8, a dead row, guided rows);
   and the MLA decode
   kernel at DeepSeek-V2-Lite's shapes (H 16, R 512, RD 64, a 27-layer
   stacked latent cache, the decode contexts incl. a ctx-1 row); and the
   sequence-parallel prefix partials kernel for 4 ranks of a 2,048-token
   chunk over one broadcast block table, at prefixes 0 to 14,336; and the
   sink form of decode, verify and flash at gpt-oss-20b's attention (H 64,
   KVH 8, a 24-layer cache, the 128-token window and none; decode at the
   split edges with a ctx-0 row, verify at S 5 and 17 (136 rows, two
   query parts) with a pad row, flash at the engine's batched prefill
   steps), each timed beside its no-sink form and an SDPA call with one
   zero key whose mask is the sink, and the epilogue's forms at
   gpt-oss-20b's vocabulary of 201,088; and the softcap form of decode,
   verify and flash at gemma-2-9b's attention (head_dim 256, H 16, KVH 8,
   scale 256^-0.5, cap 50, the 4,096-token window and none, 8,192-key
   tables at contexts 1 to 8,192; decode, verify at S 5 and 32 with a pad
   row, flash at the engine's batched chunk and at the 5,000-token
   prompt's long step), again at a cap of 5 over queries scaled by 4
   (where the cap binds; the share of scores beyond cap / 2 is printed),
   and at gemma-2-27b's head_dim 128 (H 32, KVH 16, scale 144^-0.5), each
   timed beside its no-softcap form (no PyTorch call computes a softcapped
   softmax: SDPA without the cap stands beside it as such), and the
   epilogue at gemma-2-9b's 256,000; decode, verify and flash at head_dim
   128 over the MoE families' caches (``MOE_ATTENTION``: Qwen3-30B-A3B's
   32 heads over 4 KV heads and 48 layers, Mixtral-8x7B's 32 over 8 and
   32 layers; decode at the split edges and the engine's contexts, verify
   at S 5 and 17 with a pad row, flash at the engine's batched prefill
   steps), and the epilogue at their vocabularies of 151,936 and 32,000
   in every form; decode, verify and flash the same way at Qwen2.5-7B's
   G 7 (H 28, KVH 4, D 128, 28 layers) and the epilogue at its 152,064;
   flash (bf16 and fp8) and the prefix partials at the GQA groups that
   leave spare rows in a tensor-core CTA (``ODD_GROUPS``: G 7 and
   Qwen2.5-32B's G 5, H 40, KVH 8): flash at the batched chunk and the
   long step, the prefix partials at every ``SP_PREFIXES`` edge; and the fp8 forms of decode, verify, flash and MLA decode
   over e4m3 caches (``FP8_SHAPES``: Llama-3.2-1B's attention, Qwen3's
   head_dim 128, gemma-2-9b's softcap at head_dim 256, gpt-oss-20b's sinks
   with its window; V2-Lite's MLA), each held against its f32 plain
   version and bit for bit against its bf16 form over the caches upcast to
   bf16, and timed beside it (the bound with one byte a K/V element; no
   PyTorch call reads e4m3 pages, so SDPA over the upcast caches stands
   beside it); kernel 6's fp8 form the same way at the SP call's shapes
   (Llama-3.2-1B's heads, D 64) and at G 7 (``ODD_GROUPS``); and decode,
   verify and flash at Phi-3-mini's attention (``_phi3_cases``: H = KVH =
   32, head_dim 96; decode at B 8 over contexts up to 4,097 and the split
   edges, verify at S 5 with a pad row, flash at the batched chunk and the
   5,120-token prompt's last 512-token step, decode and flash also with
   Phi-3-mini-4k's window of 2,047), bf16 and fp8. Flash
   and the prefix partials (one tensor-core core) are also held at head_dim
   128 (H 32, KVH 8), and flash also at the dense ladder's long step of
   ``engine_sp`` (S 512 at position 11,776, ctx 12,000: the query tiles
   past ctx must come back as zeros). It times kernel, plain version, a
   PyTorch library call where one computes the same function (SDPA over
   pre-gathered dense keys, a yardstick only) and the card's bound for the
   same work; decode, verify, flash, MLA decode, the sampling epilogue
   and the SDPA yardsticks by a CUDA graph's replay (``graph_ms``: device
   time, beside the eager ``cuda_ms`` that includes the wrapper's host
   time), the rest by ``cuda_ms``.
4. ``engine``  — serves token-id requests through ``TorchServingEngine``
   at the full Llama-3.2-1B shapes with seeded random bf16 weights,
   checks every stream, the kernels' launch counts on that run, a repeated
   request, the logits of batched prefill and decode steps against the
   same forwards on the CPU in f32, and a profiled decode step (the decode
   and epilogue kernels' shares of its device-busy time).
5. ``engine_paths`` — the same weights behind three more engines: the
   unfused sampling tail and 4-step decode bursts must stream wave 1
   identically; ngram speculation must stream its repeated-pattern prompts
   as without it, or part at a printed near-tie.
6. ``engine_chain`` — the decode loop: the same Llama-3.2-1B weights
   behind a synchronous engine, a dispatch-ahead engine
   (``decode_pipeline_depth=2``, ``device_finish="off"``) and the chained
   device-finish engine, all at ``multi_step_decode=4``: wave 1, then
   requests that end on a hidden stop id, on a stop sequence, at
   ``max_tokens`` on and off a burst boundary, and two guided-choice
   requests sharing one choice list. Every stream must equal the
   synchronous engine's in tokens and finish reason; every pipelined and
   chained dispatch runs under ``torch.cuda.set_sync_debug_mode("error")``
   (no host sync inside a dispatch); the chain is longer than one burst,
   rows finish on the device, each chained step launches the epilogue once
   and the decode kernel once per layer, and no KV block stays in use.
7. ``engine_fp8`` — Llama-3.2-1B at full width and depth over an fp8
   (e4m3) KV cache (``kv_cache_dtype="fp8"``): wave 1 and the prefix-hit
   wave, the spec prompts with and without ngram speculation (verify's fp8
   form; equal or parted at a printed near-tie), and the synchronous and
   chained 4-step-burst engines over wave 1 and the finish requests (equal;
   the chained dispatches under the sync guard), all on one set of weight
   tensors. Only the fp8 forms of decode, flash and verify launch; the
   cache is e4m3, half the bytes of a bf16 engine's on the same weights;
   the logits of a prompt stay within ``FP8_LOGITS_REL_L2`` of the bf16
   cache's; the card's e4m3 writes of ``FP8_WRITE_VALUES`` give the CPU's
   bytes; no KV block stays in use.
8. ``engine_mla`` — DeepSeek-V2-Lite at full width, its depth cut to 14
   of its 27 layers (``MLA_LAYERS``: MLA attention, a dense first layer,
   then routed-MoE layers with 2 shared experts), built by ``ModelConfig.from_hf_config`` from its published
   ``config.json`` values with seeded random bf16 weights: wave 1 and the
   prefix-hit wave (streams, the MLA kernel's and the epilogue's launch
   counts, peak memory), the decode step's time and device profile (the
   MLA and epilogue kernels' shares of its busy time), wave 1
   again on a 4-step-burst engine over the same weight tensors (identical
   streams), and the logits of a prefill and a decode step at full width
   and 2 layers against the CPU in f32; then an fp8-cache engine over the
   same weight tensors (wave 1 and the prefix-hit wave through the MLA
   kernel's fp8 form and the dense S > 1 gather over e4m3 pages). Twins
   within one wave may part there: the reference's expert capacity at a
   decode batch of 8 is 1.
9. ``engine_gptoss`` — gpt-oss-20b at full width, its depth cut to 8 of
   its 24 layers (``GPTOSS_LAYERS``; 20.9 B parameters in full: sinks,
   alternating 128-token windows, 32 experts top 4), built by ``ModelConfig.from_hf_config`` from its published
   ``config.json`` values with seeded random bf16 weights and seeded
   non-zero sinks and biases: wave 1 and the prefix-hit wave (streams, the
   decode, flash and epilogue launch counts, peak memory), a profiled
   decode step, the 2-layer logits against the CPU in f32 (routing pinned
   and held; free and reported), wave 1 again on a 4-step-burst and a
   chained engine over the same weight tensors (identical streams, the
   chained dispatches under the sync guard), and the spec prompts without
   and with ngram speculation (verify launches; equal or parted at a
   near-tie, routing pinned).
10. ``engine_gemma2`` — gemma-2-9b at full width, its depth cut to 14 of
   its 42 layers (``GEMMA_LAYERS``; 9.24 B parameters in full: head_dim 256, attention logits capped at 50 and
   final logits at 30, 4,096-token windows on the even layers, sandwich
   norms, GeGLU, a tied 256,000 vocabulary), built by
   ``ModelConfig.from_hf_config`` from its published ``config.json``
   values with seeded random bf16 weights and non-zero norms, at its
   8,192 positions: wave 1 with a 5,000-token prompt past the window and
   the prefix-hit wave (streams, twins, the decode, flash and epilogue
   launch counts, peak memory), a profiled decode step, 2-layer logits
   against the CPU in f32 (a batched prefill step, a decode step, and the
   5,000-token prompt's last position, which must also move with the
   window off), wave 1 again on a 4-step-burst and a chained engine over
   the same weight tensors (identical streams, the chained dispatches
   under the sync guard), and the spec prompts without and with ngram
   speculation (verify launches; equal or parted at a near-tie).
11. ``engine_qwen3moe`` — Qwen3-30B-A3B at full width, its depth cut to
   12 of its 48 layers (``MOE_LAYERS``; 30.53 B parameters in full: 128
   experts top 8, per-head q/k norms,
   G 8 at head_dim 128, an untied 151,936 vocabulary), built by
   ``ModelConfig.from_hf_config`` from its published ``config.json``
   values with seeded random bf16 weights and seeded non-unit q/k norms:
   wave 1 and the prefix-hit wave (streams, the decode, flash and epilogue
   launch counts, peak memory), a profiled decode step, the 2-layer logits
   against the CPU in f32 (routing pinned at no drop and held; free and
   reported), wave 1 again on a 4-step-burst and a chained engine over the
   same weight tensors (identical streams, the chained dispatches under
   the sync guard), and the spec prompts without and with ngram
   speculation (verify launches; routing pinned).
12. ``engine_mixtral_int8`` — Mixtral-8x7B at full width, its depth cut to
   4 of its 32 layers (``MOE_LAYERS``), in int8 (46.70 B parameters in full, 8 experts top 2, G 4 at head_dim 128, a
   32,000 vocabulary), from its published ``config.json`` values with
   ``quantization="int8"``: the weights are quantized slice by slice as
   they are drawn (93 GB in bf16 would not fit), and every ``QUANT_KEYS``
   leaf on the card must be int8. Wave 1 and the prefix-hit wave, a
   profiled decode step with the step's dequantising conversions timed as
   a line of their own, the 2-layer logits against the CPU in f32 from the
   same ``q`` and ``scale`` (routing pinned and held; free and reported),
   and wave 1 again on a 4-step-burst and a chained engine (identical
   streams).
13. ``engine_sp`` — sequence-parallel long-context prefill on Llama-3.2-1B
   (16k context, ``sp_size`` 4, the ranks laid out on the one card): a
   12,000- and a 6,000-token prompt on the SP ladder beside two short
   prompts on the dense ladder, then a prefix-hit request, on a
   synchronous SP engine, a dense engine and a chained SP engine over the
   same weights; streams against the dense engine's (equal or parted at a
   near-tie) and the chained engine's (equal), the 12k prompt's SP logits
   against the dense ladder's on the card, kernel 6 once a layer per SP
   chunk, every SP chunk under the sync guard, the early handoffs; then an
   SP engine over an fp8 (e4m3) cache on the same weights and prompts:
   kernel 6's fp8 form once a layer per SP chunk (no bf16 form launches),
   its greedy streams equal the bf16 SP engine's or part at a near-tie.
14. ``engine_http`` — the OpenAI front at the full Llama-3.2-1B shapes in
   bf16: a model directory written here (``write_model_dir``: the HF
   ``config.json``, Llama-3's chat template, a synthetic byte-level BPE
   ``tokenizer.json`` over all 128,256 ids with Llama-3's ``Split``
   pattern and ``ignore_merges``), the engine built by
   ``cli.run.build_engine`` (the chained decode loop over 128 KV blocks, so
   the wave preempts) and served by ``HttpService`` on a free port. A
   stdlib client sends at once 8 streamed greedy chats (prompts of 100 to
   1,500 tokens), 2 non-streamed completions, a top-5 logprobs request, a
   penalised one, one with a stop string, an ``n = 2`` sampled one and one
   that disconnects after 4 chunks, and reads /v1/models, /health and
   /metrics. Every stream is held token for token against a roomy engine
   over the same directory and seed (fed the prompt ids the front
   annotated; ``n = 2`` against two requests seeded ``seed`` and
   ``seed + 1``), its text against the tokenizer's decode of its ids, its
   logprobs within 2e-2; /metrics must show preemptions, one TTFT sample a
   request and no KV block in use, the launch counts the decode, flash and
   epilogue kernels (the epilogue in its plain and ``finish`` forms). The
   edge's TTFT and inter-token gaps a request, the front's share of TTFT
   and the tokenizer's encode cost a token are printed. The front runs
   with its telemetry on (a trace store, SLO targets, a profile directory,
   the engine's registry attached): each request's ``/debug/requests/{id}``
   has its stage marks in order and a ``first_token`` mark that agrees with
   the client's TTFT within the front's share; /metrics carries the
   device-time histogram, the decode busy ratio and a roofline fraction in
   (0, 1], and SLO verdicts that sum to the finished requests; a
   ``/debug/profile`` window taken from the wave's start holds kernels 1, 2
   and 3 by name. Prints the busy gauge beside the profile's kernel-busy
   share and the estimator over the same window, the roofline gauge and
   the compile tracker's startup and late first dispatches. The CLI itself
   (``python3 -m dynamo_tpu_torch.cli.run in=http out=torch`` in a
   subprocess, on the card by default) runs in ``engine_guided``'s leg C.
15. ``engine_guided`` — guided JSON and /v1/embeddings behind the front
   at the full Llama-3.2-1B shapes in bf16, on ``engine_http``'s model
   directory and tokenizer, each engine built by ``cli.run.build_engine``
   and served by ``HttpService``. Leg A, on a synchronous engine and then
   on the chained loop (``decode_pipeline_depth`` 2, 4-step bursts): 4
   ``json_object`` and 4 ``json_schema`` chats (a required string, an
   integer, a boolean, an enum and an array of numbers; half greedy, half
   seeded at 0.8; 128 tokens) beside 2 unguided streams, then a boolean-
   array grammar small enough for a device table, alone. A reply that
   finishes ``stop`` parses and validates, one cut at ``length`` is a
   legal prefix under a fresh grammar walk; greedy guided streams are
   identical on the two engines; the array grammar's table compiles and
   launches the epilogue's ``extra_bias`` form on the chained engine.
   Prints each grammar's table outcome (the engine's compiles and one more
   at the reference's bound and budget: state count, seconds a state),
   ``sync_fallback`` by reason, the piece table's seconds, the guided and
   unguided TTFTs and the unguided streams' largest gap over a sweep on
   the scheduler's loop. Leg B, on the chained engine: 8 /v1/embeddings
   requests (strings and token-id lists of 16 to 1,500 tokens) while 2
   greedy chats decode: unit vectors of 2,048, ``usage`` the prompt
   tokens, the two shortest within cosine 0.999 of an f32 CPU
   ``embed_forward`` of the engine's weights, the chats token-identical to
   their run alone; ``embed_s`` a request. Leg C: the CLI started with the
   mapped engine flags (``--multi-step-decode 4 --device-finish on
   --fused-epilogue on`` ...) gives the reference's ``EngineConfig``
   fields, reaches /health, chains a chat, serves a guided reply and an
   embedding, and exits 0 on SIGINT.
16. ``engine_graph`` — the distributed inference graph, each role a
   subprocess on the one card as a user starts it: a dynstore broker, two
   ``--token-level --prefix-pull`` workers (Llama-3.2-1B at full width and
   depth, random weights, ``engine_http``'s synthetic tokenizer; each
   drops its first pull serve), an ``out=processor
   --router-mode kv`` processor and a round-robin one, each behind an
   ``in=http out=none`` frontend that discovers its model. Groups sharing
   a 1,024-token prefix: each leader alone, its followers once the
   router's index holds its blocks (read from the stats scrapes); every
   follower must land on its leader's worker; streams equal an
   in-process engine's or part at a near-tie; a seeded sampled request
   gives the same tokens on both workers; a 12,000-token prefill expires
   no lease; after SIGKILL of one worker, requests complete on the
   survivor within the lease TTL plus a margin; no KV block stays in use.
   Round-robin followers beside their leader's worker pull the shared
   prefix over the transfer plane (each whole), the dropped serves fall
   back to a local recompute, streams as above, no pinned block left.
   Prints the followers' TTFT under kv and round-robin routing in turns,
   the routing decision's µs, the events' lag and the pulls' counters.
   The workers and the kv processor run ``--metrics-port`` sidecars and
   the kv frontend ``--hub``: before the kill, ``/fleet/workers`` lists
   both workers up with their KV use and busy ratio, and the processor's
   sidecar renders the aggregator's per-worker gauges.
17. ``engine_disagg`` — disaggregated prefill and decode on Llama-3.2-1B at
   full width and depth. Leg A in one process, over a bf16 and an fp8
   cache: a decode engine whose coordinator talks over a ``MemoryHub`` to
   a prefill worker with a runner of its own on the card; the installed
   blocks byte-equal to the prefill worker's, every decode dispatch and
   install free of host syncs, streams equal a local engine's or part at
   a near-tie. Leg B, the CLI roles as subprocesses (broker, a
   ``--remote-prefill`` decode worker, an ``in=prefill`` worker with the
   SP ladder, a KV-routing processor, a frontend): two turns, remote and
   local by the router's live key, each with 4 streamed chats beside a
   12,000- and a 3,000-word prompt; remote prefills counted, bytes
   reckoned, the SP ladder's launches, no fallback or nack, no block left
   in use. Prints per turn the long prompts' TTFT, the short streams'
   largest gap while they prefilled and the transfer's bytes, frames,
   duration and exposed seconds. Each remote long prompt's trace nests the
   prefill worker's span set inside the decode engine's, inside the
   processor's, each hop's offset inside its error bound (half the round
   trip; the queued prefill hop's, its round trip), and its
   ``/debug/trace/{id}`` names all four sources.
18. ``engine_kv_tiers`` — the multi-tier KV block manager on Llama-3.2-1B
   at full width and depth in one process: 1,024 HBM blocks, a 1,024-slot
   pinned host slab and a 2,048-block cold tier; six 6,000-token prompts
   push blocks HBM → host → cold (every dispatch, offload and restore
   under the sync guard), then a host restore and a cold pull on that
   engine, a rehydrate on a fresh engine over the same cold directory, a
   corrupted file (a miss, never installed) on another, and a host restore
   over an e4m3 cache: restored and rehydrated blocks byte-equal to the
   first written, streams equal or parted at a near-tie, nothing left
   pinned or in use, the native xxh64 equal to its plain version. Prints
   the tiers' counters, offload and restore GB/s, the cold tier's MB/s and
   the checksum's share.
19. ``engine_load`` — checkpoints from files: Qwen2.5-7B at full width, its
   depth cut to 4 of its 28 layers (``LOAD_LAYERS``; its published
   ``config.json``: G 7, qkv biases, V 152,064) with
   seeded random bf16 weights written as a 4-shard HF safetensors
   snapshot (``write_safetensors_snapshot``) and loaded by
   ``ModelRunner(model_dir=...)``: every leaf equal to the drawn one, the
   write and load seconds, load GB/s, the load's device and host peaks;
   wave 1, the prefix-hit wave and the spec prompts (launch counts), the
   2-layer logits against the CPU in f32; then the CLI with
   ``--model-path`` and no ``--allow-random-weights`` in a subprocess
   serving wave 1 and the spec prompts over /v1/completions (greedy
   streams equal the in-process engine's or part at a near-tie); then
   Llama-3.2-1B as one GGUF file (Q8_0, ``write_gguf_llama_q8``) served
   by the CLI the same way against an engine given d * q directly.
20. ``engine_spec`` — the rest of speculation: Llama-3.1-8B at full width,
   its depth cut to 16 of 32 layers (``LLAMA_8B_CUT``; ``LLAMA_31_8B``,
   its published ``config.json``, seeded
   random bf16 weights) drafted by Llama-3.2-1B, drawn on the card and
   written as a safetensors snapshot that the draft's runner loads. The
   engine phase's spec prompts, 64 tokens each, through: the plain
   synchronous and chained 8B engines; leg A, the synchronous draft engine
   (K 4); leg B, the chained one (depth 2), with kernel 4 at S 17 held and
   timed on its 8B cache after the wave; leg D, chained ngram speculation
   on the 8B; leg C, the 1B drafted by its own snapshot (every rejected
   proposal at a printed near-tie of a plain forward's logits); leg E, the
   CLI's engine builder with ``--spec-draft-model`` /
   ``--spec-draft-tokens`` (fields as the reference maps them). Spec
   streams equal the non-spec engine's of their mode or part at a printed
   near-tie; E's against B's. Every round's pieces run under the sync
   guard (the draft's burst, the device mask between it and the verify,
   the verify, the staging): kernel 4 launches once a target layer a
   round, kernel 1 and the epilogue once a draft layer a step and once a
   step of each draft burst. Prints each leg's acceptance, rounds and
   decode wall a round.
21. ``engine_recovery`` — recovery and live migration: Llama-3.1-8B at
   full width, 16 of its 32 layers (``RECOVERY_MODEL``, its published ``config.json``,
   seeded random bf16 weights) behind a source and a peer in one process
   (one set of weight tensors, 1,024 blocks of 16 each, no prefix cache),
   wave 1's eight prompts with 64 new tokens (six greedy, two seeded at
   0.8 / 0.95 with seeds of their own) served undisturbed first. Leg A: a
   ``RecoveryController`` drain (grace 0.05 s, graceful seize, hot) once
   every stream has 8 tokens, from a synchronous and then a chained source
   (depth 2, 4-step bursts): 8 of 8 migrated hot, the blocks the peer's
   cache holds after each scatter byte-equal to the frames shipped, and the
   frames byte-equal to the source's cache re-read after its seize (a
   gather ordered before a burst's write would differ), greedy streams equal
   the baseline or part at a printed near-tie, the seeded ones bit for bit,
   the peer's resumed decode under the sync guard, no block in use on
   either side. Leg B: a source whose stall watchdog samples every 0.1 s
   against a 2 s deadline; ``decode_burst_hang`` wedges its next decode
   sync: one ``decode_stall`` trip, a flight artifact holding the 8
   requests, the hard seize, 8 cold migrations (the peer re-prefills
   through the flash kernel), the injected respawner between the
   ``deregister`` and ``register`` hooks, the draining snapshot that keeps
   the port's ``KvScheduler`` off the source, every stream to its length,
   no block in use after the release; an incident recorder wired as
   ``--incident-dir`` wires it folds the trip and the drain into exactly
   one bundle (manifest, flight, history, traces) that a front's
   ``/debug/incidents`` lists. Leg C: two ``in=http out=torch
   --self-heal`` CLIs on Llama-3.2-1B, four streamed chats on A, ``POST
   /admin/drain``: 4 migrated, every stream to ``[DONE]`` with B's
   undisturbed text (or a near-tie), 503 with Retry-After after, 4
   committed hot migrations on A's /metrics, and A's SIGUSR2 flight
   artifact holding 4 handoffs, each before the streams ended; each
   re-bound stream's trace on A carries the peer's spans from ``mig_end``
   (``migration.resume`` onward) inside the attach hop's offset bound.
   Prints the
   drains' seconds, the KV bytes and frames, each stream's gap across the
   hop, the peer's launches of kernels 1–3.
22. ``engine_phi3`` — Phi-3-mini-128k-instruct at full width and 16 of 32
   layers (``PHI3_MINI_128K``, its published ``config.json`` with factor
   lists of the published length drawn from the seed: longrope, head_dim
   96, 32 KV heads, a window past every context), seeded random bf16
   weights written as a safetensors snapshot under Phi-3's names (fused
   ``qkv_proj`` and ``gate_up_proj``) beside a SentencePiece
   ``tokenizer.model`` only (32,000 pieces with the 256 byte pieces,
   written by ``spm_model_bytes``), loaded by the port's loader (every
   leaf equal), served: a wave with a 5,120-token prompt (long profile)
   and a 4,090-token one that crosses 4,096 while it decodes, the
   prefix-hit wave, 4-step bursts and the chained loop (identical
   streams, every chained dispatch under the sync guard), ngram spec
   (equal or parted at a near-tie), an fp8 KV engine (only fp8 forms
   launch; logits within ``FP8_LOGITS_REL_L2`` of the bf16 cache's);
   ``sp_size`` 2 refused by the window; 2-layer logits against the CPU
   in f32 with the original window cut to 64 (short and long rows in one
   batch); one text request through the CLI (its SentencePiece reader:
   the stream equals the in-process one's, its text the reader's decode).
   Prints the peak memory, the KV bytes a token, the load's GB/s and a
   profiled decode step's D-96 decode kernel share.

Every check raises on failure, so any failed phase ends the run with a
non-zero exit. The last line is the machine-readable result
``{"ok": true, "device": {...}}``; the line before it holds the kernels'
numbers (the epilogue twice a vocabulary: its plain form with the main
path's launches, its ``finish`` + ``extra_bias`` form with the chained
engine's; the sink forms and the epilogue at V 201,088 with the gpt-oss
paths' launches, the softcap forms and the epilogue at V 256,000 with the
gemma-2 paths', the head_dim-128 forms and the epilogue at V 151,936 and
32,000 with the Qwen3-MoE and Mixtral paths', the G 7 forms and the
epilogue at V 152,064 with ``engine_load``'s, the fp8 forms with the
``engine_fp8`` paths' and the MLA fp8 engine's, the head_dim-96 forms
(bf16 and fp8) with ``engine_phi3``'s; the forms no cell runs —
G 5, flash's fp8 form and the prefix partials at G 7 and 5 — with a count
of 0 and a ``path`` saying so; the decode, flash and
epilogue entries also carry ``launches_engine_http``, the HTTP path's own
counts, ``launches_engine_guided``, the guided path's chained engine's,
and ``launches_engine_graph``, the graph's workers'; they and
kernel 6 carry ``launches_engine_disagg``, the disaggregated pair's two
workers' (decode and flash's fp8 forms: leg A's fp8 pair); decode, flash
and the epilogue carry ``launches_engine_kv_tiers``, the tiers' engines'
(decode and flash's fp8 forms: the e4m3 engine's); decode, flash, verify
and the epilogue carry ``launches_engine_spec``, the chained draft
engine's (verify: with the chained ngram engine's); decode, flash and the
epilogue carry ``launches_engine_recovery``, the peer's over legs A and B
(its resumed decode and cold re-prefills); kernel 6's
fp8 form has the fp8 SP engine's launches); the line before that the
card's name and power limit.
"""

from __future__ import annotations

import asyncio
import functools
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Llama-3.2-1B (published config.json): the flagship shapes of the JAX
# package plus tied embeddings and llama3 rope scaling
FLAGSHIP = dict(
    vocab_size=128256, hidden_size=2048, intermediate_size=8192,
    num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
    rope_theta=500000.0, max_position_embeddings=131072,
    tie_word_embeddings=True,
    rope_scaling={"rope_type": "llama3", "factor": 32.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 8192},
)
# DeepSeek-V2-Lite (its published config.json): MLA with kv_lora_rank 512
# and no q_lora, one dense first layer, then 26 MoE layers of 64 routed
# experts (top 6, softmax, no top-k renormalisation, greedy routing) plus 2
# shared experts; yarn rope (factor 40, both mscales 0.707); untied
# depth cuts that keep the whole script inside its time limit; the widths
# stay the published ones
MLA_LAYERS = 14      # of V2-Lite's 27
GPTOSS_LAYERS = 8    # of gpt-oss-20b's 24
V2_LITE = {
    "architectures": ["DeepseekV2ForCausalLM"], "vocab_size": 102400,
    "hidden_size": 2048, "intermediate_size": 10944,
    "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "num_key_value_heads": 16,
    "n_routed_experts": 64, "num_experts_per_tok": 6, "n_shared_experts": 2,
    "first_k_dense_replace": 1, "norm_topk_prob": False,
    "scoring_func": "softmax", "topk_method": "greedy", "n_group": 1,
    "topk_group": 1, "routed_scaling_factor": 1.0, "kv_lora_rank": 512,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "v_head_dim": 128, "rope_theta": 10000,
    "rope_scaling": {"type": "yarn", "factor": 40,
                     "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                     "mscale_all_dim": 0.707},
    "max_position_embeddings": 163840, "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "attention_bias": False,
}
# gpt-oss-20b (its published config.json): 24 layers alternating a
# 128-token sliding window (even layers) and full attention, 64 query heads
# over 8 KV heads of dim 64 with learned attention sinks and biased
# projections, 32 experts top 4 of a clamped GLU (gate and up interleaved,
# 2 x 2,880 wide), yarn rope (factor 32 at theta 150,000), untied 201,088
# vocabulary: 20.91 B parameters, 41.8 GB in bf16
GPT_OSS_20B = {
    "architectures": ["GptOssForCausalLM"], "model_type": "gpt_oss",
    "vocab_size": 201088, "hidden_size": 2880, "intermediate_size": 2880,
    "num_hidden_layers": 24, "num_attention_heads": 64,
    "num_key_value_heads": 8, "head_dim": 64, "num_local_experts": 32,
    "num_experts_per_tok": 4, "experts_per_token": 4, "sliding_window": 128,
    "layer_types": ["sliding_attention", "full_attention"] * 12,
    "rope_theta": 150000, "rope_scaling": {
        "rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
        "beta_slow": 1.0, "original_max_position_embeddings": 4096,
        "truncate": False},
    "initial_context_length": 4096, "max_position_embeddings": 131072,
    "rms_norm_eps": 1e-5, "attention_bias": True, "swiglu_limit": 7.0,
    "tie_word_embeddings": False, "hidden_act": "silu",
    "eos_token_id": 200002, "pad_token_id": 199999,
}
# gemma-2-9b (its published config.json; the family reads the embedding
# as its head whatever the tie flag): 42 layers alternating a 4,096-token
# sliding window (even layers) and full attention, 16 query heads over 8 KV
# heads of dim 256 scaled by query_pre_attn_scalar 256, attention logits
# capped at 50 and final logits at 30, sandwich norms, GeGLU, tied 256,000
# vocabulary: 9,241,705,984 parameters, 18.48 GB in bf16
GEMMA_2_9B = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
    "vocab_size": 256000, "hidden_size": 3584, "intermediate_size": 14336,
    "num_hidden_layers": 42, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 256,
    "max_position_embeddings": 8192, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "sliding_window": 4096, "sliding_window_size": 4096,
    "query_pre_attn_scalar": 256, "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0, "hidden_act": "gelu_pytorch_tanh",
    "hidden_activation": "gelu_pytorch_tanh", "attention_bias": False,
    "bos_token_id": 2, "eos_token_id": 1, "pad_token_id": 0,
}
# Qwen3-30B-A3B (its published config.json): 48 layers, 32 query heads over
# 4 KV heads of dim 128 with per-head q/k norms, 128 experts top 8 of
# width 768 (top-k renormalised), rope theta 1e6, no window, untied 151,936
# vocabulary: 30.53 B parameters, 61.1 GB in bf16
QWEN3_30B_A3B = {
    "architectures": ["Qwen3MoeForCausalLM"], "model_type": "qwen3_moe",
    "vocab_size": 151936, "hidden_size": 2048, "intermediate_size": 6144,
    "moe_intermediate_size": 768, "num_hidden_layers": 48,
    "num_attention_heads": 32, "num_key_value_heads": 4, "head_dim": 128,
    "num_experts": 128, "num_experts_per_tok": 8, "norm_topk_prob": True,
    "decoder_sparse_step": 1, "mlp_only_layers": [],
    "max_position_embeddings": 40960, "rope_theta": 1000000.0,
    "rope_scaling": None, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
    "attention_bias": False, "sliding_window": None,
    "use_sliding_window": False, "hidden_act": "silu",
    "bos_token_id": 151643, "eos_token_id": 151645,
}
# Mixtral-8x7B (its published config.json): 32 layers, 32 query heads over
# 8 KV heads of dim 128, 8 experts top 2 of width 14,336, rope theta 1e6,
# no window, untied 32,000 vocabulary: 46.70 B parameters, 93.4 GB in bf16,
# 46.7 GB in int8
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_local_experts": 8,
    "num_experts_per_tok": 2, "max_position_embeddings": 32768,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-5, "sliding_window": None,
    "tie_word_embeddings": False, "hidden_act": "silu",
    "bos_token_id": 1, "eos_token_id": 2,
}
# Phi-3-mini-128k-instruct (its published config.json, every field but the
# factor lists): 32 layers, 32 query heads over 32 KV heads of dim 96 (G 1),
# intermediate 8,192, longrope from 4,096 to 131,072 positions, a sliding
# window of 262,144 (past every context), untied 32,064 vocabulary: 3.82 B
# parameters, 7.64 GB in bf16. The published 48-entry short_factor and
# long_factor lists are not in the repository: lists of their length are
# drawn from the seed (short in [1, 1.2), long log-uniform in [1, 64), each
# ascending, the published lists' shape) until that config.json is.
_PHI3_RNG = np.random.default_rng(50)
PHI3_MINI_128K = {
    "architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
    "vocab_size": 32064, "hidden_size": 3072, "intermediate_size": 8192,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 32, "max_position_embeddings": 131072,
    "original_max_position_embeddings": 4096, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5, "sliding_window": 262144,
    "tie_word_embeddings": False, "hidden_act": "silu",
    "attention_bias": False, "attention_dropout": 0.0, "embd_pdrop": 0.0,
    "resid_pdrop": 0.0, "bos_token_id": 1, "eos_token_id": 32000,
    "pad_token_id": 32000, "torch_dtype": "bfloat16",
    "rope_scaling": {
        "type": "longrope",
        "short_factor": [float(x) for x in
                         np.sort(1.0 + 0.2 * _PHI3_RNG.random(48))],
        "long_factor": [float(x) for x in np.sort(np.exp(
            _PHI3_RNG.uniform(0.0, np.log(64.0), 48)))]},
}
ENGINE = dict(max_batch_size=8, max_model_len=2048, kv_block_size=16,
              num_kv_blocks=1024, dtype="bfloat16",
              # small enough to chunk every long prompt over several steps
              max_prefill_tokens_per_step=512)
NEW_TOKENS = 32
SEED = 0
# speculative phase: ngram proposals of 4 tokens on a 3-gram match, 64 new
# tokens per request; a parted stream must part at a near-tie
SPEC = dict(spec_ngram_tokens=4, spec_ngram_match=3)
SPEC_NEW_TOKENS = 64
NEAR_TIE = 0.05

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # outside the tensor cores

# kernel tolerance: bf16 output rounding (~4e-3 relative) plus a different
# summation order than the f32 plain version
ATOL, RTOL = 1e-2, 1e-2
# whole-model tolerance, GPU bf16 vs CPU f32 on the same bf16-valued
# weights: relative L2 error of the logits. bf16 activations through 16
# layers stay near 1e-2; a wrong attention result anywhere gives O(1)
LOGITS_REL_L2 = 5e-2


def _ptxas_summary(log: str):
    """nvcc's ``-Xptxas=-v`` report as one line per kernel instantiation:
    ``name<template arguments>: registers, spill stores, spill loads``
    (a bool argument as 0 / 1: the split-KV and flash kernels' last one is
    the softcap)."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"([A-Za-z_]+_kernel)", mangled)
            args = re.findall(r"L[ib](\d+)E", mangled)  # ints and bools
            ty = re.search(r"I(f|13__nv_bfloat16)L", mangled)
            if ty:
                args = [ty.group(1).replace("13__nv_", "")] + args
            name = (base.group(1) if base else mangled) + (
                f"<{','.join(args)}>" if args else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return out


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA-event timed after a warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, warmup: int = 3, replays: int = 5) -> float:
    """Mean device milliseconds per call: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events. A kernel
    that takes tens of microseconds runs faster than its Python wrapper can
    launch it, so ``cuda_ms`` of it times the host; the replay does not."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # relaxed: a wrapper may set a function attribute while capturing
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def check_close(name: str, got, ref) -> float:
    """max |got - ref|, raising unless |diff| <= ATOL + RTOL * |ref|."""
    diff = (got.float() - ref.float()).abs()
    bad = diff > ATOL + RTOL * ref.float().abs()
    if bool(bad.any()) or not bool(got.float().isfinite().all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements out of tolerance, "
            f"max |diff| {float(diff.max()):.3g}")
    return float(diff.max())


# ---------------------------------------------------------------- kernels


def _visible(qpos, ctx, window):
    """Number of keys a query at ``qpos`` sees: j <= qpos, j < ctx,
    j > qpos - window."""
    hi = np.minimum(qpos, ctx - 1)
    lo = np.maximum(0, qpos - window + 1)
    return np.maximum(hi - lo + 1, 0)


def _bound_ms(flops: float, nbytes: float):
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes")


# engine_sp's dense ladder, last step of the 12k prompt: (base_pos, ctx)
LONG_DENSE_STEP, LONG_DENSE_PAGES = (11776, 12000), 750


def _flash_check(torch, pf, name, k, v, k32, v32, layer, qf, btp, basep, ctxp,
                 rows, window=1 << 30, sinks=None, scale=None, softcap=0.0):
    """One flash call against the f32 plain version: every row finite, the
    rows below ctx within ATOL / RTOL, and every query tile that starts at
    or past its row's ctx exactly zero (the kernel skips it). Returns the
    max error."""
    B, S, H, _ = qf.shape
    out = pf.paged_flash_attention(qf, k, v, btp, basep, ctxp, layer_idx=layer,
                                   window=window, sinks=sinks, scale=scale,
                                   softcap=softcap)
    ref = pf.paged_flash_attention_ref(qf.float(), k32, v32, btp, basep, ctxp,
                                       layer, scale, window, sinks, softcap)
    torch.cuda.synchronize()
    if not bool(out.float().isfinite().all()):
        raise AssertionError(f"flash {name}: non-finite output (pad rows too)")
    bq = 64 // (H // k.shape[3])  # query positions per CTA
    errs = []
    for i, (base, c) in enumerate(rows):
        nv = min(S, c - base)  # rows past ctx are discarded by the caller
        errs.append(check_close(f"flash {name} row {i}", out[i, :nv], ref[i, :nv]))
        dead = -(-max(nv, 0) // bq) * bq
        if dead < S and bool(out[i, dead:].any()):
            raise AssertionError(f"flash {name} row {i}: a query tile past "
                                 f"ctx is not zero")
    return max(errs)


def _flash_d128(torch, pf, dev):
    """The flash kernel at head_dim 128 (H 32, KVH 8): the prefix-hit case
    (S 512 at base 256, ctx 768) and a padded tail over a 4-layer cache,
    held against the f32 plain version at ATOL / RTOL and timed."""
    L, N, BS, KVH, D, H, layer = 4, 256, 16, 8, 128, 32, 2
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    k = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    v = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    k32, v32 = k.float(), v.float()
    rows = [(256, 768), (0, 300)]
    qf = torch.randn(len(rows), 512, H, D, generator=g, device=dev).bfloat16()
    btp = torch.randperm(N, generator=g, device=dev)[:2 * 48].reshape(2, 48).int()
    basep = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
    ctxp = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    err = _flash_check(torch, pf, "d128", k, v, k32, v32, layer, qf, btp,
                       basep, ctxp, rows)
    t = _flash_timing(torch, pf, k, v, k32, v32, layer, qf[:1], btp[:1],
                      basep[:1], ctxp[:1], 512, rows[:1])
    return err, t


def _flash_timing(torch, pf, k, v, k32, v32, layer, qf, btp, basep, ctxp, S,
                  rows):
    """Kernel, plain (f32) and SDPA-yardstick times of one flash call, its
    bound from the keys this call's valid query rows see, and the plain
    version's own error when run in bf16."""
    F = torch.nn.functional
    dev = qf.device
    B, _, H, D = qf.shape
    KVH = k.shape[3]
    ms = graph_ms(lambda: pf.paged_flash_attention(qf, k, v, btp, basep, ctxp,
                                                   layer_idx=layer))
    eager_ms = cuda_ms(lambda: pf.paged_flash_attention(qf, k, v, btp, basep,
                                                        ctxp, layer_idx=layer))
    plain_ms = cuda_ms(lambda: pf.paged_flash_attention_ref(
        qf.float(), k32, v32, btp, basep, ctxp, layer))
    ref = pf.paged_flash_attention_ref(qf.float(), k32, v32, btp, basep, ctxp,
                                       layer)
    plain_bf16 = pf.paged_flash_attention_ref(qf, k, v, btp, basep, ctxp, layer)
    # library yardstick: SDPA over each row's K/V pre-gathered to dense
    T = max(c for _, c in rows)
    kd = k[layer][btp.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
    vd = v[layer][btp.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
    kd = kd.repeat_interleave(H // KVH, dim=1).contiguous()
    vd = vd.repeat_interleave(H // KVH, dim=1).contiguous()
    qpos = basep.long()[:, None, None] + torch.arange(S, device=dev)[None, :, None]
    keys = torch.arange(T, device=dev)[None, None, :]
    mask = ((keys <= qpos) & (keys < ctxp.long()[:, None, None]))[:, None]
    qd = qf.transpose(1, 2).contiguous()
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask))
    flops, kv_bytes, plain_err = 0.0, 0, 0.0
    for i, (base, c) in enumerate(rows):
        nv = min(S, c - base)
        flops += 4.0 * D * H * _visible(base + np.arange(nv), c, 1 << 30).sum()
        kv_bytes += min(c, base + S) * KVH * D * 2 * 2
        plain_err = max(plain_err, float(
            (plain_bf16[i, :nv].float() - ref[i, :nv]).abs().max()))
    bound, by = _bound_ms(flops, 2 * qf.numel() * 2 + kv_bytes)
    torch.cuda.synchronize()
    return dict(kernel_ms=ms, kernel_ms_eager=eager_ms, plain_ms=plain_ms,
                library_ms=lib_ms,
                bound_ms=bound, bound_by=by, plain_bf16_max_err=plain_err,
                ctas=-(-S // (64 // (H // KVH))) * KVH * B)


def kernel_phase(torch, dev):
    from dynamo_tpu_torch.ops import paged_flash as pf

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    L, N, BS, KVH, D, H = 16, 1024, 16, 8, 64, 32
    LAYER = 7
    g = torch.Generator(device=dev).manual_seed(SEED)
    k = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    v = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    k32, v32 = k.float(), v.float()
    W = ENGINE["max_model_len"] // BS
    entries = {}

    # ---- decode: B=8, ctx spread over page boundaries up to the full table
    ctx_l = [1, 15, 16, 17, 513, 2048, 700, 1500]
    B = len(ctx_l)
    bt = torch.randperm(N, generator=g, device=dev)[: B * W].reshape(B, W).int()
    q = torch.randn(B, 1, H, D, generator=g, device=dev).bfloat16()
    entries["paged_decode"] = _decode_cases(torch, dev, k, v, k32, v32, bt,
                                            ctx_l, q, LAYER)
    torch.cuda.synchronize()

    # ---- flash: one row at S 64 and 512 from position 0, a prefix hit and
    # a padded tail; then batches as the engine's chunked prefill builds
    # them (ENGINE's 512-token budget: 8 rows at S 64, 4 rows at S 128),
    # each row with its own base_pos and ctx, and pad rows as the scheduler
    # pads the power-of-two row ladder (base 0, ctx 1, block table 0).
    # (name, S, [(base_pos, ctx) per row, None = pad row])
    cases = [("s64", 64, [(0, 64)]), ("s512", 512, [(0, 512)]),
             ("prefix_hit", 512, [(256, 768)]), ("padded_tail", 512, [(0, 300)]),
             ("batch8_s64", 64, [(0, 64), (256, 320), (128, 168), (1984, 2048),
                                 (64, 100), (1472, 1500), None, None]),
             ("batch4_s128", 128, [(0, 128), (384, 512), (1024, 1100), None])]
    # the dense ladder's last step of engine_sp's 12k prompt: 224 real
    # tokens in a 512-row bucket over a 750-page block table (its own
    # generator, so the cases above keep their inputs)
    g2 = torch.Generator(device=dev).manual_seed(SEED + 1)
    long_case = ("long_dense_step", 512, [LONG_DENSE_STEP], LONG_DENSE_PAGES)
    max_errs, inputs = {}, {}
    for name, S, rows, *pages in cases + [long_case]:
        gen = g2 if pages else g
        B = len(rows)
        pad = torch.tensor([r is None for r in rows], device=dev)
        rows = [r or (0, 1) for r in rows]
        qf = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
        basep = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
        ctxp = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
        if pages:
            btp = torch.randperm(N, generator=gen, device=dev)[:pages[0]][None].int()
        else:
            btp = bt[:B].clone()
            btp[pad] = 0
        max_errs[name] = _flash_check(torch, pf, name, k, v, k32, v32, LAYER,
                                      qf, btp, basep, ctxp, rows)
        inputs[name] = (qf, btp, basep, ctxp, S, rows)
    timings = {name: _flash_timing(torch, pf, k, v, k32, v32, LAYER,
                                   *inputs[name])
               for name in ("prefix_hit", "batch4_s128", "long_dense_step")}
    max_errs["d128"], timings["d128_prefix_hit"] = _flash_d128(torch, pf, dev)
    emit("kernels", kernel="paged_flash",
         shape=dict(H=H, KVH=KVH, D=D, bs=BS, L=L, layer=LAYER,
                    cases={name: dict(S=S, rows=rows)
                           for name, S, rows, *_ in cases + [long_case]}),
         max_err=max_errs, timed=timings)
    # the line's entry: the engine's own batched chunk (4 rows at S 128),
    # and beside it the long dense step
    t, tl = timings["batch4_s128"], timings["long_dense_step"]
    entries["paged_flash"] = dict(
        name="paged_flash_attention", route="cuda",
        source="dynamo_tpu_torch/csrc/paged_flash.cu",
        replaces="dynamo_tpu/ops/pallas_attention.py:254",
        max_abs_err=max(max_errs.values()), ms=t["kernel_ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"],
        long_dense_step=dict(ms=tl["kernel_ms"], plain_ms=tl["plain_ms"],
                             bound_ms=tl["bound_ms"], bound_by=tl["bound_by"],
                             library_ms=tl["library_ms"]))
    entries["paged_verify"] = _verify_cases(torch, dev, g, k, v, k32, v32,
                                            bt, ctx_l, LAYER)
    entries.update(_sp_prefix_cases(torch, dev, g, k, v, k32, v32, LAYER))
    del k, v, k32, v32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    entries["sampling_epilogue"] = _epilogue_cases(torch, dev)
    _epilogue_cases(torch, dev, V2_LITE["vocab_size"])  # the MLA path's width
    entries["sampling_epilogue_finish"] = _epilogue_finish_cases(torch, dev)
    _epilogue_finish_cases(torch, dev, V2_LITE["vocab_size"])
    entries["mla_decode"] = _mla_cases(torch, dev)
    entries.update(_sink_cases(torch, dev))
    entries.update(_softcap_cases(torch, dev))
    for family in MOE_ATTENTION:
        entries.update(_moe_attention_cases(torch, dev, family))
    entries.update(_odd_group_cases(torch, dev, entries))
    entries.update(_fp8_cases(torch, dev))
    entries.update(_phi3_cases(torch, dev))
    # kernel 3 at gpt-oss-20b's vocabulary of 201,088, gemma-2-9b's of
    # 256,000, Qwen3-30B-A3B's of 151,936 and Mixtral-8x7B's of 32,000
    for fam, model in (("gptoss", GPT_OSS_20B), ("gemma2", GEMMA_2_9B),
                       ("qwen3moe", QWEN3_30B_A3B), ("mixtral", MIXTRAL_8X7B)):
        gv = model["vocab_size"]
        for key, fn in ((f"sampling_epilogue_{fam}", _epilogue_cases),
                        (f"sampling_epilogue_finish_{fam}",
                         _epilogue_finish_cases)):
            entry = fn(torch, dev, gv)
            entries[key] = dict(entry, name=f"{entry['name']}[V={gv}]")
    # and at Qwen2.5-7B's 152,064 (engine_load's main path: the plain form)
    gv = QWEN25_7B["vocab_size"]
    entry = _epilogue_cases(torch, dev, gv)
    entries["sampling_epilogue_qwen25"] = dict(entry, name=f"{entry['name']}[V={gv}]")
    return entries


def _sdpa_decode_ms(torch, q, k, layer, bt, ctx_l, v):
    """SDPA over each row's K/V pre-gathered to dense [B, H, T, D], masked
    past ctx: the decode kernel's library yardstick (device time, graph
    replay)."""
    F = torch.nn.functional
    B, _, H, D = q.shape
    KVH = k.shape[3]
    T = max(ctx_l)
    kd = k[layer][bt.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
    vd = v[layer][bt.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
    kd = kd.repeat_interleave(H // KVH, dim=1).contiguous()
    vd = vd.repeat_interleave(H // KVH, dim=1).contiguous()
    ctx = torch.tensor(ctx_l, device=q.device)
    mask = (torch.arange(T, device=q.device)[None, :] < ctx[:, None])[:, None, None, :]
    qd = q.transpose(1, 2).contiguous()
    return graph_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask))


def _layers_ms(fn, layers, timer=cuda_ms):
    """Mean ms of ``fn(layer)`` with the layer cycling through the stacked
    cache, so a call finds its keys in device memory as a model's forward
    does (the L2 holds 50 MB; one layer of the timed shapes fits in it)."""
    it = iter(range(1 << 30))
    return timer(lambda: fn(next(it) % layers))


def _split_ctas(ctx_l, table_keys, kvh, window=1 << 30, S=1, base_l=None):
    """(launched, live) CTAs of the split-KV grid for these rows: a split
    is live when its chunk meets the row's key range."""
    from dynamo_tpu_torch.ops import splitkv

    chunk, splits = splitkv.plan(table_keys)
    live = 0
    for i, c in enumerate(ctx_l):
        base = c - 1 if base_l is None else base_l[i]
        lo, hi = max(0, base - window + 1), min(c - 1, base + S - 1)
        live += hi // chunk - lo // chunk + 1 if hi >= lo else 0
    return splits * kvh * len(ctx_l), live * kvh


def _decode_check(torch, pd, name, q, k, v, k32, v32, bt, ctx, layer,
                  window=None, sinks=None, scale=None, softcap=0.0):
    """One decode call against the f32 plain version at ATOL / RTOL, and a
    second call on the same inputs bit-identical to the first. Returns the
    max error."""
    window = pd.NO_WINDOW if window is None else window
    kw = dict(layer_idx=layer, window=window, sinks=sinks, scale=scale,
              softcap=softcap)
    out = pd.paged_decode_attention(q, k, v, bt, ctx, **kw)
    again = pd.paged_decode_attention(q, k, v, bt, ctx, **kw)
    ref = pd.paged_decode_attention_ref(q.float(), k32, v32, bt, ctx, layer,
                                        scale, window, sinks, softcap)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"decode {name}: two calls on the same inputs "
                             "are not bit-identical")
    return check_close(f"decode {name}", out, ref)


# the split-KV edges of the engine's 2,048-key table (256-key splits): one
# key under, at and over a split, a row with no key, the full table
DECODE_EDGE_CTX = [0, 255, 256, 257, 511, 513, 1300, 2048]
DECODE_WINDOW = 300  # crosses a split at ctx 513 and 1300
# engine_sp's decode batch while its 12k prompt decodes: 4 rows over a
# 1,024-page table (max_model_len 16,384, 32 splits of 512 keys)
LONG_DECODE_CTX, LONG_DECODE_PAGES = [12032, 6032, 332, 932], 1024


def _decode_cases(torch, dev, k, v, k32, v32, bt, ctx_l, q, layer):
    """The decode kernel against its f32 plain version, each case twice
    (bit-identical): the timed shape with and without a window; the split
    edges with and without a window crossing a split; group sizes 1, 4 and
    8 at head_dim 64 and 128 (H / KVH over 8 KV heads); and the long
    context decode batch of ``engine_sp``, timed too."""
    from dynamo_tpu_torch.ops import paged_decode as pd

    B, _, H, D = q.shape
    L, N, BS, KVH, _ = k.shape
    W = bt.shape[1]
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    errs = {}
    for window in (pd.NO_WINDOW, 256):
        errs[f"timed_w{window}"] = _decode_check(
            torch, pd, f"window={window}", q, k, v, k32, v32, bt, ctx, layer,
            window)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    ctx_e = torch.tensor(DECODE_EDGE_CTX, dtype=torch.int32, device=dev)
    for h in (8, 32, 64):  # G 1, 4, 8
        qe = torch.randn(B, 1, h, D, generator=g, device=dev).bfloat16()
        for window in (pd.NO_WINDOW, DECODE_WINDOW):
            errs[f"edges_h{h}_w{window}"] = _decode_check(
                torch, pd, f"edges H={h} window={window}", qe, k, v, k32, v32,
                bt, ctx_e, layer, window)
    # head_dim 128 over a 4-layer cache
    L2, N2 = 4, 256
    k2 = torch.randn(L2, N2, BS, KVH, 128, generator=g, device=dev).bfloat16()
    v2 = torch.randn(L2, N2, BS, KVH, 128, generator=g, device=dev).bfloat16()
    k2_32, v2_32 = k2.float(), v2.float()
    bt2 = torch.stack([torch.randperm(N2, generator=g, device=dev)[:W]
                       for _ in range(B)]).int()
    for h in (8, 32, 64):
        q2 = torch.randn(B, 1, h, 128, generator=g, device=dev).bfloat16()
        for window in (pd.NO_WINDOW, DECODE_WINDOW):
            errs[f"d128_h{h}_w{window}"] = _decode_check(
                torch, pd, f"head_dim 128 H={h} window={window}", q2, k2, v2,
                k2_32, v2_32, bt2, ctx_e, 2, window)
    q2 = torch.randn(B, 1, H, 128, generator=g, device=dev).bfloat16()
    d128_ms = _layers_ms(lambda li: pd.paged_decode_attention(
        q2, k2, v2, bt2, ctx_e, layer_idx=li), L2, graph_ms)
    del k2, v2, k2_32, v2_32

    # the timed shape
    plain_bf16 = pd.paged_decode_attention_ref(q, k, v, bt, ctx, layer)
    ref = pd.paged_decode_attention_ref(q.float(), k32, v32, bt, ctx, layer)
    ms = graph_ms(lambda: pd.paged_decode_attention(q, k, v, bt, ctx,
                                                    layer_idx=layer))
    eager_ms = cuda_ms(lambda: pd.paged_decode_attention(q, k, v, bt, ctx,
                                                         layer_idx=layer))
    layers_ms = _layers_ms(lambda li: pd.paged_decode_attention(
        q, k, v, bt, ctx, layer_idx=li), L, graph_ms)
    plain_ms = cuda_ms(lambda: pd.paged_decode_attention_ref(
        q.float(), k32, v32, bt, ctx, layer))
    lib_ms = _sdpa_decode_ms(torch, q, k, layer, bt, ctx_l, v)
    keys = np.asarray(ctx_l, np.int64)
    bound, by = _bound_ms(4.0 * D * H * keys.sum(),
                          2 * q.numel() * 2 + keys.sum() * KVH * D * 2 * 2)
    ctas, live = _split_ctas(ctx_l, W * BS, KVH)

    # engine_sp's long-context decode batch: its own 4-layer cache of
    # 2,048 pages, the rows' live pages distinct, as the engine lays them
    gl = torch.Generator(device=dev).manual_seed(SEED + 4)
    Ll, Nl = 4, 2048
    kl = torch.randn(Ll, Nl, BS, KVH, D, generator=gl, device=dev).bfloat16()
    vl = torch.randn(Ll, Nl, BS, KVH, D, generator=gl, device=dev).bfloat16()
    perm = torch.randperm(Nl, generator=gl, device=dev).int()
    btl = torch.zeros(len(LONG_DECODE_CTX), LONG_DECODE_PAGES, dtype=torch.int32,
                      device=dev)
    at = 0
    for i, c in enumerate(LONG_DECODE_CTX):
        n_pg = -(-c // BS)
        btl[i, :n_pg] = perm[at:at + n_pg]
        at += n_pg
    ctxl = torch.tensor(LONG_DECODE_CTX, dtype=torch.int32, device=dev)
    ql = torch.randn(len(LONG_DECODE_CTX), 1, H, D, generator=gl,
                     device=dev).bfloat16()
    kl32, vl32 = kl.float(), vl.float()
    errs["long_context"] = _decode_check(torch, pd, "long context", ql, kl, vl,
                                         kl32, vl32, btl, ctxl, 1)
    long_ms = graph_ms(lambda: pd.paged_decode_attention(ql, kl, vl, btl, ctxl,
                                                         layer_idx=1))
    long_layers_ms = _layers_ms(lambda li: pd.paged_decode_attention(
        ql, kl, vl, btl, ctxl, layer_idx=li), Ll, graph_ms)
    long_plain_ms = cuda_ms(lambda: pd.paged_decode_attention_ref(
        ql.float(), kl32, vl32, btl, ctxl, 1), iters=5, warmup=1)
    del kl32, vl32
    long_lib_ms = _sdpa_decode_ms(torch, ql, kl, 1, btl, LONG_DECODE_CTX, vl)
    keys_l = np.asarray(LONG_DECODE_CTX, np.int64)
    long_bound, long_by = _bound_ms(
        4.0 * D * H * keys_l.sum(),
        2 * ql.numel() * 2 + keys_l.sum() * KVH * D * 2 * 2)
    long_ctas = _split_ctas(LONG_DECODE_CTX, LONG_DECODE_PAGES * BS, KVH)
    del kl, vl
    torch.cuda.synchronize()
    long = dict(ms=long_ms, ms_layers_rotated=long_layers_ms,
                plain_ms=long_plain_ms, bound_ms=long_bound, bound_by=long_by,
                library_ms=long_lib_ms)
    emit("kernels", kernel="paged_decode", shape=dict(
         B=B, H=H, KVH=KVH, D=D, bs=BS, L=L, layer=layer, ctx=ctx_l,
         edges=DECODE_EDGE_CTX, window=DECODE_WINDOW, groups=[1, 4, 8],
         head_dims=[64, 128], long_context=dict(ctx=LONG_DECODE_CTX,
                                                pages=LONG_DECODE_PAGES)),
         max_err=errs, bit_identical=True,
         plain_bf16_max_err=float((plain_bf16.float() - ref).abs().max()),
         kernel_ms=ms, kernel_ms_layers_rotated=layers_ms,
         kernel_ms_eager=eager_ms, plain_ms=plain_ms,
         library_ms=lib_ms, bound_ms=bound, bound_by=by, ctas=ctas,
         live_ctas=live, d128_ms_layers_rotated=d128_ms,
         long_context=dict(long, ctas=long_ctas[0], live_ctas=long_ctas[1]),
         sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    return dict(
        name="paged_decode_attention", route="cuda",
        source="dynamo_tpu_torch/csrc/paged_decode.cu",
        core="dynamo_tpu_torch/csrc/paged_splitkv.cuh",
        replaces="dynamo_tpu/ops/pallas_decode.py:742",
        max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=lib_ms, long_context=long)


def _verify_check(torch, pv, name, q, k, v, k32, v32, bt, base, ctx, layer,
                  window=None, sinks=None, scale=None, softcap=0.0):
    """One verify call against the f32 plain version: every row finite, the
    valid rows (base + s < ctx) within ATOL / RTOL, and a second call on the
    same inputs bit-identical to the first. Returns the max error."""
    window = pv.NO_WINDOW if window is None else window
    kw = dict(layer_idx=layer, window=window, sinks=sinks, scale=scale,
              softcap=softcap)
    out = pv.paged_verify_attention(q, k, v, bt, base, ctx, **kw)
    again = pv.paged_verify_attention(q, k, v, bt, base, ctx, **kw)
    ref = pv.paged_verify_attention_ref(q.float(), k32, v32, bt, base, ctx,
                                        layer, scale, window, sinks, softcap)
    torch.cuda.synchronize()
    if not bool(out.float().isfinite().all()):
        raise AssertionError(f"verify {name}: non-finite output")
    if not torch.equal(out, again):
        raise AssertionError(f"verify {name}: two calls on the same inputs "
                             "are not bit-identical")
    return max(check_close(f"verify {name} row {i}", out[i, : c - b],
                           ref[i, : c - b])
               for i, (b, c) in enumerate(zip(base.tolist(), ctx.tolist()))
               if c > b)


# verify rows (base, ctx) at the edges of a 256-key split: the tail ends one
# key under, at and over the split, starts at it, crosses the next; a pad
# row (base 0, ctx 1, table 0) last
VERIFY_EDGE_ROWS = [(250, 255), (251, 256), (252, 257), (256, 261),
                    (254, 259), (509, 514), (1296, 1301), (0, 1)]


def _verify_cases(torch, dev, g, k, v, k32, v32, bt, ctx_l, layer):
    """The verify kernel at S 2, 5, 17 and 32 over the decode phase's
    contexts (each row's tail ends at its ctx: base = max(ctx - S, 0), so
    short rows are padded proposals) plus a pad row (base 0, ctx 1, table
    0); S 5 (the engine's K + 1 = 5) also with window 256. Then the split
    edges (``VERIFY_EDGE_ROWS``) with and without a window crossing a split,
    at group sizes 1, 4 and 8 and head_dim 64 and 128 (S 5 and 16; S 32 at
    G 1 and 4). Every valid row (base + s < ctx) is held against the f32
    plain version and every call is made twice (bit-identical); S 5 is
    timed."""
    from dynamo_tpu_torch.ops import paged_verify as pv

    F = torch.nn.functional
    H, D = 32, 64
    L, N, BS, KVH, _ = k.shape
    B = len(ctx_l) + 1
    btv = torch.cat([bt, torch.zeros_like(bt[:1])])
    ctx = torch.tensor(ctx_l + [1], dtype=torch.int32, device=dev)
    errs, timed = {}, None
    for S in (2, 5, 17, 32):
        base = torch.clamp(ctx - S, min=0)
        q = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
        for window in ((pv.NO_WINDOW, 256) if S == 5 else (pv.NO_WINDOW,)):
            errs[f"S{S}" + ("" if window == pv.NO_WINDOW else f"_w{window}")] = (
                _verify_check(torch, pv, f"S={S} window={window}", q, k, v,
                              k32, v32, btv, base, ctx, layer, window))
        if S == 5:
            timed = (q, base)

    # split edges, group sizes and head_dim 128 (their own generator, so
    # the timed inputs above stay as they were)
    ge = torch.Generator(device=dev).manual_seed(SEED + 5)
    Be = len(VERIFY_EDGE_ROWS)
    base_e = torch.tensor([r[0] for r in VERIFY_EDGE_ROWS], dtype=torch.int32,
                          device=dev)
    ctx_e = torch.tensor([r[1] for r in VERIFY_EDGE_ROWS], dtype=torch.int32,
                         device=dev)
    bt_e = btv[:Be].clone()
    bt_e[-1] = 0
    L2, N2 = 4, 256
    k2 = torch.randn(L2, N2, BS, KVH, 128, generator=ge, device=dev).bfloat16()
    v2 = torch.randn(L2, N2, BS, KVH, 128, generator=ge, device=dev).bfloat16()
    k2_32, v2_32 = k2.float(), v2.float()
    bt2 = torch.stack([torch.randperm(N2, generator=ge, device=dev)[:bt.shape[1]]
                       for _ in range(Be)]).int()
    bt2[-1] = 0
    caches = {64: (k, v, k32, v32, bt_e, layer), 128: (k2, v2, k2_32, v2_32, bt2, 2)}
    for d, (kc, vc, kc32, vc32, btc, li) in caches.items():
        for h in (8, 32, 64):  # G 1, 4, 8
            for S in ((5, 32) if h < 64 else (5, 16)):
                qe = torch.randn(Be, S, h, d, generator=ge, device=dev).bfloat16()
                for window in (pv.NO_WINDOW, DECODE_WINDOW):
                    errs[f"edges_d{d}_h{h}_S{S}_w{window}"] = _verify_check(
                        torch, pv, f"edges D={d} H={h} S={S} window={window}",
                        qe, kc, vc, kc32, vc32, btc, base_e, ctx_e, li, window)
    q2 = torch.randn(Be, 5, H, 128, generator=ge, device=dev).bfloat16()
    d128_ms = _layers_ms(lambda li: pv.paged_verify_attention(
        q2, k2, v2, bt2, base_e, ctx_e, layer_idx=li), L2, graph_ms)
    del k2, v2, k2_32, v2_32

    q, base = timed
    S = q.shape[1]
    ms = graph_ms(lambda: pv.paged_verify_attention(q, k, v, btv, base, ctx,
                                                    layer_idx=layer))
    eager_ms = cuda_ms(lambda: pv.paged_verify_attention(q, k, v, btv, base,
                                                         ctx, layer_idx=layer))
    layers_ms = _layers_ms(lambda li: pv.paged_verify_attention(
        q, k, v, btv, base, ctx, layer_idx=li), L, graph_ms)
    plain_ms = cuda_ms(lambda: pv.paged_verify_attention_ref(
        q.float(), k32, v32, btv, base, ctx, layer))
    # library yardstick: SDPA over K/V pre-gathered to dense, causal by
    # absolute position (query s of row b at base + s)
    T = max(ctx_l)
    kd = k[layer][btv.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
    vd = v[layer][btv.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
    kd = kd.repeat_interleave(H // KVH, dim=1).contiguous()
    vd = vd.repeat_interleave(H // KVH, dim=1).contiguous()
    qpos = base.long()[:, None, None] + torch.arange(S, device=dev)[None, :, None]
    keys = torch.arange(T, device=dev)[None, None, :]
    mask = ((keys <= qpos) & (keys < ctx.long()[:, None, None]))[:, None]
    qd = q.transpose(1, 2).contiguous()
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask))
    flops, kv_bytes = 0.0, 0
    for b, c in zip(base.tolist(), ctx.tolist()):
        nv = c - b
        flops += 4.0 * D * H * _visible(b + np.arange(nv), c, 1 << 30).sum()
        kv_bytes += min(c, b + S) * KVH * D * 2 * 2
    bound, by = _bound_ms(flops, 2 * q.numel() * 2 + kv_bytes)
    ctas, live = _split_ctas(ctx.tolist(), bt.shape[1] * BS, KVH, S=S,
                             base_l=base.tolist())
    emit("kernels", kernel="paged_verify",
         shape=dict(B=B, S=[2, 5, 17, 32], H=H, KVH=KVH, D=D, layer=layer,
                    ctx=ctx.tolist(), pad_row="base 0, ctx 1, table 0",
                    edges=VERIFY_EDGE_ROWS, window=DECODE_WINDOW,
                    groups=[1, 4, 8], head_dims=[64, 128]),
         max_err=errs, bit_identical=True, timed_S=S, kernel_ms=ms,
         kernel_ms_layers_rotated=layers_ms, kernel_ms_eager=eager_ms,
         plain_ms=plain_ms,
         library_ms=lib_ms, bound_ms=bound, bound_by=by, ctas=ctas,
         live_ctas=live, d128_ms_layers_rotated=d128_ms)
    torch.cuda.synchronize()
    return dict(name="paged_verify_attention", route="cuda",
                source="dynamo_tpu_torch/csrc/paged_verify.cu",
                core="dynamo_tpu_torch/csrc/paged_splitkv.cuh",
                replaces="dynamo_tpu/ops/pallas_decode.py:634",
                max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms)


# kernel 6 at the engine_sp phase's chunk: 4 ranks of a 2,048-token chunk
SP_RANKS, SP_ROWS = 4, 512
SP_PREFIXES = (0, 1, 15, 16, 17, 8192, 14336)
# tolerances of the prefix partials against the plain version on the same
# bf16 values in f32 (only the summation order and the fast exp differ):
# m to 1e-3 absolute + 1e-3 relative; l to 1e-3 relative + 1e-3; acc to
# 1e-3 of its row's l (|acc| <= l * max|v|) + 1e-3 relative
SP_PREFIX_TOL = 1e-3


def _sp_prefix_check(torch, spx, q, k, v, k32, v32, bt, pfx, layer):
    """One kernel 6 call against the f32 plain version at SP_PREFIX_TOL
    (the empty prefix exactly); returns the max errors of m, l and acc."""
    tol = SP_PREFIX_TOL
    acc, m, l = spx.paged_prefix_attention_partials(q, k, v, bt, pfx, layer)
    if pfx == 0:
        torch.cuda.synchronize()
        if not (bool((m == spx.MASK_VALUE).all()) and bool((l == 0).all())
                and bool((acc == 0).all())):
            raise AssertionError("sp prefix: the empty prefix is not "
                                 "m = -1e30, l = acc = 0")
        return dict(m=0.0, l=0.0, acc=0.0)
    racc, rm, rl = spx.paged_prefix_attention_partials_ref(
        q.float(), k32, v32, bt, pfx, layer)
    torch.cuda.synchronize()
    e = dict(m=(m - rm).abs(), l=(l - rl).abs(), acc=(acc - racc).abs())
    bad = dict(m=e["m"] > tol + tol * rm.abs(),
               l=e["l"] > tol + tol * rl.abs(),
               acc=e["acc"] > tol * rl[..., None] + tol * racc.abs())
    for name, b in bad.items():
        if bool(b.any()) or not bool(e[name].isfinite().all()):
            raise AssertionError(
                f"sp prefix {pfx} (D {q.shape[-1]}): {name} out of tolerance "
                f"in {int(b.sum())} elements, max |diff| {float(e[name].max()):.3g}")
    return {name: float(x.max()) for name, x in e.items()}


def _sp_prefix_d128(torch, spx, dev):
    """Kernel 6 at head_dim 128 (H 32, KVH 8) for the SP call's 4 ranks of
    512 rows over one broadcast block-table row of a 4-layer cache, at a
    prefix inside the second page and at 8,192 keys, held against the f32
    plain version at SP_PREFIX_TOL; the second timed beside its bound."""
    L, N, BS, KVH, D, H, layer = 4, 1024, 16, 8, 128, 32, 2
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    k = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    v = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    k32, v32 = k.float(), v.float()
    bt = torch.randperm(N, generator=g, device=dev).int()[None].expand(SP_RANKS, N)
    q = torch.randn(SP_RANKS, SP_ROWS, H, D, generator=g, device=dev).bfloat16()
    errs = {f"d128_{pfx}": _sp_prefix_check(torch, spx, q, k, v, k32, v32, bt,
                                            pfx, layer)
            for pfx in (17, 8192)}
    ms = cuda_ms(lambda: spx.paged_prefix_attention_partials(q, k, v, bt, 8192,
                                                             layer))
    bound, by = _bound_ms(4.0 * SP_RANKS * SP_ROWS * H * 8192 * D,
                          8192 * KVH * D * 2 * 2 + q.numel() * 6
                          + 2 * SP_RANKS * SP_ROWS * H * 4)
    return errs, dict(prefix=8192, kernel_ms=ms, bound_ms=bound, bound_by=by)


def _sp_prefix_run(torch, spx, g, k, v, k32, v32, layer, H):
    """The prefix partials kernel (kernel 6) against its plain version at
    the one-card SP call's shapes for ``H`` query heads over the cache
    ``k`` / ``v`` [L, N, bs, KVH, D]: q [4, 512, H, D] (4 ranks of a 2,048-
    token chunk) over one block table row broadcast to the ranks, layer
    ``layer``, at every prefix of ``SP_PREFIXES`` (the empty prefix
    exactly: m == -1e30, l == acc == 0). Timed by CUDA events at the
    longest prefix beside the plain version, the bound and SDPA over the
    gathered prefix, non-causal: a yardstick that computes the normalised
    output, not the partials, and that the port never calls. Returns the
    max errors by prefix and the timings."""
    F = torch.nn.functional
    L, N, BS, KVH, D = k.shape
    R, S = SP_RANKS, SP_ROWS
    row = torch.randperm(N, generator=g, device=k.device).int()[None]
    bt = row.expand(R, N)                      # stride 0: no copy per rank
    q = torch.randn(R, S, H, D, generator=g, device=k.device).bfloat16()
    errs = {pfx: _sp_prefix_check(torch, spx, q, k, v, k32, v32, bt, pfx, layer)
            for pfx in SP_PREFIXES}
    P = SP_PREFIXES[-1]
    ms = cuda_ms(lambda: spx.paged_prefix_attention_partials(q, k, v, bt, P, layer))
    plain_ms = cuda_ms(lambda: spx.paged_prefix_attention_partials_ref(
        q.float(), k32, v32, bt, P, layer), iters=3, warmup=1)
    pages = row[0, : -(-P // BS)].long()
    kd = k[layer][pages].reshape(1, -1, KVH, D)[:, :P].transpose(1, 2)
    vd = v[layer][pages].reshape(1, -1, KVH, D)[:, :P].transpose(1, 2)
    kd = kd.repeat_interleave(H // KVH, dim=1).expand(R, H, P, D).contiguous()
    vd = vd.repeat_interleave(H // KVH, dim=1).expand(R, H, P, D).contiguous()
    qd = q.transpose(1, 2).contiguous()
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd))
    flops = 4.0 * R * S * H * P * D
    nbytes = (P * KVH * D * 2 * 2            # K and V of the prefix, once
              + q.numel() * 2                # q in bf16
              + q.numel() * 4 + 2 * R * S * H * 4)  # acc, m, l in f32
    bound, by = _bound_ms(flops, nbytes)
    torch.cuda.synchronize()
    del kd, vd, qd
    return errs, dict(timed_prefix=P, kernel_ms=ms, plain_ms=plain_ms,
                      library_ms=lib_ms, bound_ms=bound, bound_by=by,
                      ctas=-(-S // (spx._ROWS_PER_CTA // (H // KVH))) * KVH * R)


def _sp_prefix_fp8_run(torch, spx, g, k8, v8, layer, H):
    """Kernel 6's fp8 form over the e4m3 caches ``k8`` / ``v8`` at
    ``_sp_prefix_run``'s shapes (4 ranks of 512 rows, one broadcast block
    table row, every ``SP_PREFIXES`` edge): held against the f32 plain
    version at SP_PREFIX_TOL and bit for bit against the bf16 form over the
    caches upcast to bf16 (every e4m3 value is a bf16 value; only the
    producer differs), then timed at the longest prefix beside the bf16
    form, the plain version (which upcasts the e4m3 pages it gathers),
    SDPA over the upcast caches (a yardstick: no PyTorch call reads e4m3
    pages, so ``library_ms`` is null) and the bound with one byte a K/V
    element. Returns the max errors by prefix and the timings."""
    F = torch.nn.functional
    L, N, BS, KVH, D = k8.shape
    R, S = SP_RANKS, SP_ROWS
    kb, vb = k8.to(torch.bfloat16), v8.to(torch.bfloat16)
    k32, v32 = kb.float(), vb.float()
    row = torch.randperm(N, generator=g, device=k8.device).int()[None]
    bt = row.expand(R, N)
    q = torch.randn(R, S, H, D, generator=g, device=k8.device).bfloat16()
    errs = {}
    for pfx in SP_PREFIXES:
        errs[pfx] = _sp_prefix_check(torch, spx, q, k8, v8, k32, v32, bt, pfx,
                                     layer)
        a8 = spx.paged_prefix_attention_partials(q, k8, v8, bt, pfx, layer)
        ab = spx.paged_prefix_attention_partials(q, kb, vb, bt, pfx, layer)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a8, ab)):
            raise AssertionError(
                f"sp prefix fp8 {pfx} (D {D}, G {H // KVH}): not bit-equal to "
                "the bf16 form over the upcast cache")
        del a8, ab
    P = SP_PREFIXES[-1]
    ms = cuda_ms(lambda: spx.paged_prefix_attention_partials(q, k8, v8, bt, P, layer))
    bf16_ms = cuda_ms(lambda: spx.paged_prefix_attention_partials(
        q, kb, vb, bt, P, layer))
    plain_ms = cuda_ms(lambda: spx.paged_prefix_attention_partials_ref(
        q.float(), k8, v8, bt, P, layer), iters=3, warmup=1)
    pages = row[0, : -(-P // BS)].long()
    kd = kb[layer][pages].reshape(1, -1, KVH, D)[:, :P].transpose(1, 2)
    vd = vb[layer][pages].reshape(1, -1, KVH, D)[:, :P].transpose(1, 2)
    kd = kd.repeat_interleave(H // KVH, dim=1).expand(R, H, P, D).contiguous()
    vd = vd.repeat_interleave(H // KVH, dim=1).expand(R, H, P, D).contiguous()
    qd = q.transpose(1, 2).contiguous()
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd))
    flops = 4.0 * R * S * H * P * D
    nbytes = (P * KVH * D * 1 * 2            # e4m3 K and V of the prefix, once
              + q.numel() * 2                # q in bf16
              + q.numel() * 4 + 2 * R * S * H * 4)  # acc, m, l in f32
    bound, by = _bound_ms(flops, nbytes)
    torch.cuda.synchronize()
    del kd, vd, qd, kb, vb, k32, v32
    return errs, dict(timed_prefix=P, kernel_ms=ms, bf16_form_ms=bf16_ms,
                      plain_ms=plain_ms, library_ms=None,
                      sdpa_over_upcast_bf16_ms=sdpa_ms, bound_ms=bound,
                      bound_by=by, bit_equal_to_bf16_form=True)


def _sp_prefix_fp8_entry(errs, t, **extra):
    """The kernels-line entry of kernel 6's fp8 form from
    ``_sp_prefix_fp8_run``'s numbers."""
    src = "dynamo_tpu_torch/csrc/"
    return dict(
        route="cuda", source=src + "sp_prefix.cu",
        core=src + "paged_attn_tc.cuh", upcast=src + "kv_fp8.cuh",
        replaces="dynamo_tpu/ops/pallas_sp.py:232",
        max_abs_err=max(max(e.values()) for e in errs.values()),
        **{k: t[k] for k in ("ms", "bf16_form_ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms",
                             "sdpa_over_upcast_bf16_ms")}, **extra)


def _sp_prefix_cases(torch, dev, g, k, v, k32, v32, layer):
    """Kernel 6 at Llama-3.2-1B's heads over the 16-layer cache
    (``_sp_prefix_run``) and at head_dim 128 (``_sp_prefix_d128``)."""
    from dynamo_tpu_torch.ops import sp_prefix as spx

    L, N, BS, KVH, D = k.shape
    H = FLAGSHIP["num_heads"]
    errs, t = _sp_prefix_run(torch, spx, g, k, v, k32, v32, layer, H)
    d128_errs, d128_timed = _sp_prefix_d128(torch, spx, dev)
    errs.update(d128_errs)
    emit("kernels", kernel="sp_prefix",
         shape=dict(ranks=SP_RANKS, S=SP_ROWS, H=H, KVH=KVH, D=D, bs=BS, L=L,
                    layer=layer, W=N, prefixes=list(SP_PREFIXES)),
         max_err=errs, tol=dict(m="1e-3 + 1e-3|ref|", l="1e-3 + 1e-3|ref|",
                                acc="1e-3 l + 1e-3|ref|"),
         **t, d128_timed=d128_timed)
    # the fp8 form over an e4m3 cache of the same shape (the engine_sp fp8
    # engine's path)
    k8 = torch.randn(k.shape, generator=g, device=dev).to(torch.float8_e4m3fn)
    v8 = torch.randn(k.shape, generator=g, device=dev).to(torch.float8_e4m3fn)
    errs8, t8 = _sp_prefix_fp8_run(torch, spx, g, k8, v8, layer, H)
    del k8, v8
    torch.cuda.empty_cache()
    emit("kernels", kernel="sp_prefix_fp8",
         shape=dict(ranks=SP_RANKS, S=SP_ROWS, H=H, KVH=KVH, D=D, bs=BS, L=L,
                    layer=layer, W=N, prefixes=list(SP_PREFIXES)),
         max_err=errs8, **t8, card=nvidia_smi_line())
    entries = dict(sp_prefix=dict(
        name="paged_prefix_attention_partials", route="cuda",
        source="dynamo_tpu_torch/csrc/sp_prefix.cu",
        replaces="dynamo_tpu/ops/pallas_sp.py:232",
        max_abs_err=max(max(e.values()) for e in errs.values()),
        ms=t["kernel_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"]))
    entries["sp_prefix_fp8"] = _sp_prefix_fp8_entry(
        errs8, dict(t8, ms=t8["kernel_ms"]),
        name="paged_prefix_attention_partials[fp8]")
    return entries


# the sink form of kernels 1, 4 and 2 at gpt-oss-20b's attention: 64 query
# heads over 8 KV heads of dim 64, a 24-layer stacked cache, the 128-token
# window of its even layers; sinks ~ N(0, 4^2), so some lie above every
# score a query sees (scores here are ~ N(0, 1))
SINK_LAYERS, SINK_HEADS, SINK_WINDOW, SINK_SCALE = 24, 64, 128, 4.0


def _visible_mask(torch, base, ctx, S, T, window):
    """[B, S, T] bool: query s of row b (at base[b] + s) sees key j."""
    dev = ctx.device
    qpos = base.long()[:, None, None] + torch.arange(S, device=dev)[None, :, None]
    keys = torch.arange(T, device=dev)[None, None, :]
    return ((keys <= qpos) & (keys < ctx.long()[:, None, None])
            & (keys > qpos - window))


def _sinks_above(torch, q, k32, layer, bt, base, ctx, sinks, window):
    """How many (query, head) rows with a visible key have a sink above
    every score they see."""
    B, S, H, D = q.shape
    KVH = k32.shape[3]
    T = int(max(ctx.tolist()))
    kd = k32[layer][bt.long()].reshape(B, -1, KVH, D)[:, :T]
    sc = torch.einsum("bskgd,btkd->bskgt", q.float().reshape(B, S, KVH, -1, D),
                      kd) * D ** -0.5
    vis = _visible_mask(torch, base, ctx, S, T, window)[:, :, None, None, :]
    top = torch.where(vis, sc, float("-inf")).amax(-1).reshape(B, S, H)
    live = vis.any(-1).reshape(B, S, 1)
    return int(((sinks.float() > top) & live).sum())


def _sdpa_sink(torch, q, k, v, layer, bt, base, ctx, sinks, window, ref,
               valid):
    """The sink forms' library yardstick: SDPA over each row's K/V
    pre-gathered to dense [B, H, T + 1, D] with one zero key and zero value
    appended, whose additive float mask is the head's sink, so it computes
    the same function. Returns (device ms by graph replay, its max error
    against the f32 plain version ``ref`` on the ``valid`` query rows of
    each batch row: reported, not held, as the bf16 mask rounds the sink)."""
    F = torch.nn.functional
    B, S, H, D = q.shape
    KVH = k.shape[3]
    T = int(max(ctx.tolist()))

    def dense(c):
        x = c[layer][bt.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
        x = x.repeat_interleave(H // KVH, dim=1)
        return torch.cat([x, torch.zeros_like(x[:, :, :1])], 2).contiguous()

    kd, vd = dense(k), dense(v)
    vis = _visible_mask(torch, base, ctx, S, T, window)[:, None]
    mask = torch.cat([torch.where(vis, 0.0, float("-inf")).expand(B, H, S, T),
                      sinks.float()[None, :, None, None].expand(B, H, S, 1)],
                     -1).to(q.dtype).contiguous()
    qd = q.transpose(1, 2).contiguous()
    out = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask).transpose(1, 2)
    err = max(float((out[i, :n].float() - ref[i, :n]).abs().max())
              for i, n in enumerate(valid) if n > 0)
    ms = graph_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                         attn_mask=mask))
    return ms, err


def _attn_bound(D, H, KVH, q, base_l, ctx_l, S, window, kv_bytes=2):
    """The card's bound for one attention call: 4 D H FLOPs a visible
    (query, key) pair; the live query rows (those below ctx: the kernels
    skip the rest and the caller discards them) and their outputs once,
    each key and value a row's queries see once (``kv_bytes`` an element:
    1 for an e4m3 cache), the sinks."""
    kv_el = kv_bytes
    flops, kv_bytes, live = 0.0, 0, 0
    for b, c in zip(base_l, ctx_l):
        qpos = b + np.arange(S)
        vis = _visible(qpos, c, window) * (qpos < c)
        flops += 4.0 * D * H * vis.sum()
        live += int((qpos < c).sum())
        lo, hi = max(0, b - window + 1), min(c - 1, b + S - 1)
        kv_bytes += max(hi - lo + 1, 0) * KVH * D * 2 * kv_el
    return _bound_ms(flops, 2 * live * H * D * q.element_size() + kv_bytes
                     + H * 4)


def _sink_cases(torch, dev):
    """Kernels 1, 4 and 2 in their sink form at gpt-oss-20b's shapes, each
    call held against its f32 plain version at ATOL / RTOL (decode and
    verify twice, bit-identical), without a window and with the 128-token
    window of the sliding layers:

    - decode at the split edges (``DECODE_EDGE_CTX``: a ctx-0 row, one key
      under, at and over a 256-key split, the full 2,048-key table) and at
      the engine's decode contexts, timed;
    - verify at S 5 and 17 (G 8: 40 and 136 rows, the second in two query
      parts) over the engine's decode contexts and a pad row, S 17 timed;
    - flash at the engine's batched prefill steps (8 rows at S 64 and 4 at
      S 128, pad rows), the second timed.

    Each timed call gives its sink form's ``graph_ms``, the no-sink form at
    the same shape, the windowed sink form, the plain version's time, the
    bound and the SDPA-with-a-sink-key yardstick. Returns the kernels-line
    entries."""
    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_flash as pf
    from dynamo_tpu_torch.ops import paged_verify as pv

    L, N, BS, KVH, D, H, layer = SINK_LAYERS, 1024, 16, 8, 64, SINK_HEADS, 13
    NW = pd.NO_WINDOW
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    k = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    v = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    k32, v32 = k.float(), v.float()
    W = ENGINE["max_model_len"] // BS
    sinks = torch.randn(H, generator=g, device=dev) * SINK_SCALE
    bt = torch.randperm(N, generator=g, device=dev)[:8 * W].reshape(8, W).int()
    ctx_l = [1, 15, 16, 17, 513, 2048, 700, 1500]
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    out = {}

    def timed(fn, fn_nosink, fn_window, fn_plain):
        return dict(ms=graph_ms(fn), no_sink_ms=graph_ms(fn_nosink),
                    window128_ms=graph_ms(fn_window),
                    plain_ms=cuda_ms(fn_plain, iters=5, warmup=1))

    # ---- decode
    errs, above = {}, {}
    ctx_e = torch.tensor(DECODE_EDGE_CTX, dtype=torch.int32, device=dev)
    qe = torch.randn(8, 1, H, D, generator=g, device=dev).bfloat16()
    q = torch.randn(8, 1, H, D, generator=g, device=dev).bfloat16()
    for name, qq, cc in (("edges", qe, ctx_e), ("engine", q, ctx)):
        for window in (NW, SINK_WINDOW):
            errs[f"{name}_w{window}"] = _decode_check(
                torch, pd, f"sinks {name} window={window}", qq, k, v, k32, v32,
                bt, cc, layer, window, sinks)
            above[f"{name}_w{window}"] = _sinks_above(
                torch, qq, k32, layer, bt, cc - 1, cc, sinks, window)
    t = timed(lambda: pd.paged_decode_attention(q, k, v, bt, ctx, layer_idx=layer,
                                                sinks=sinks),
              lambda: pd.paged_decode_attention(q, k, v, bt, ctx, layer_idx=layer),
              lambda: pd.paged_decode_attention(q, k, v, bt, ctx, layer_idx=layer,
                                                window=SINK_WINDOW, sinks=sinks),
              lambda: pd.paged_decode_attention_ref(q.float(), k32, v32, bt, ctx,
                                                    layer, None, NW, sinks))
    ref = pd.paged_decode_attention_ref(q.float(), k32, v32, bt, ctx, layer,
                                        None, NW, sinks)
    lib_ms, lib_err = _sdpa_sink(torch, q, k, v, layer, bt, ctx - 1, ctx, sinks,
                                 NW, ref, [1] * 8)
    bound, by = _attn_bound(D, H, KVH, q, [c - 1 for c in ctx_l], ctx_l, 1, NW)
    if not any(above.values()):
        raise AssertionError("decode sinks: no sink lies above every score")
    emit("kernels", kernel="paged_decode[sinks]",
         shape=dict(B=8, H=H, KVH=KVH, D=D, bs=BS, L=L, layer=layer,
                    edges=DECODE_EDGE_CTX, ctx=ctx_l, window=SINK_WINDOW,
                    sinks=f"N(0, {SINK_SCALE}^2) f32"),
         max_err=errs, bit_identical=True, sinks_above_every_score=above,
         timed=dict(t, library_ms=lib_ms, library_max_err=lib_err,
                    bound_ms=bound, bound_by=by))
    out["paged_decode_sinks"] = dict(
        name="paged_decode_attention[sinks]", route="cuda",
        source="dynamo_tpu_torch/csrc/paged_decode.cu",
        core="dynamo_tpu_torch/csrc/paged_splitkv.cuh",
        replaces="dynamo_tpu/ops/pallas_decode.py:742",
        max_abs_err=max(errs.values()), ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=bound, bound_by=by, library_ms=lib_ms,
        no_sink_ms=t["no_sink_ms"], window128_ms=t["window128_ms"])

    # ---- verify: the engine's decode rows and a pad row (base 0, ctx 1,
    # table 0)
    errs, above = {}, {}
    btv = torch.cat([bt, torch.zeros_like(bt[:1])])
    ctxv = torch.tensor(ctx_l + [1], dtype=torch.int32, device=dev)
    for S in (5, 17):
        base = torch.clamp(ctxv - S, min=0)
        qv = torch.randn(9, S, H, D, generator=g, device=dev).bfloat16()
        for window in (NW, SINK_WINDOW):
            errs[f"S{S}_w{window}"] = _verify_check(
                torch, pv, f"sinks S={S} window={window}", qv, k, v, k32, v32,
                btv, base, ctxv, layer, window, sinks)
            above[f"S{S}_w{window}"] = _sinks_above(
                torch, qv, k32, layer, btv, base, ctxv, sinks, window)
    t = timed(lambda: pv.paged_verify_attention(qv, k, v, btv, base, ctxv,
                                                layer_idx=layer, sinks=sinks),
              lambda: pv.paged_verify_attention(qv, k, v, btv, base, ctxv,
                                                layer_idx=layer),
              lambda: pv.paged_verify_attention(qv, k, v, btv, base, ctxv,
                                                layer_idx=layer,
                                                window=SINK_WINDOW, sinks=sinks),
              lambda: pv.paged_verify_attention_ref(
                  qv.float(), k32, v32, btv, base, ctxv, layer, None, NW, sinks))
    ref = pv.paged_verify_attention_ref(qv.float(), k32, v32, btv, base, ctxv,
                                        layer, None, NW, sinks)
    base_l = base.tolist()
    valid = [c - b for b, c in zip(base_l, ctxv.tolist())]
    lib_ms, lib_err = _sdpa_sink(torch, qv, k, v, layer, btv, base, ctxv, sinks,
                                 NW, ref, valid)
    bound, by = _attn_bound(D, H, KVH, qv, base_l, ctxv.tolist(), 17, NW)
    emit("kernels", kernel="paged_verify[sinks]",
         shape=dict(B=9, S=[5, 17], H=H, KVH=KVH, D=D, layer=layer,
                    ctx=ctxv.tolist(), pad_row="base 0, ctx 1, table 0",
                    window=SINK_WINDOW, query_parts_S17=[9, 8]),
         max_err=errs, bit_identical=True, sinks_above_every_score=above,
         timed=dict(t, S=17, library_ms=lib_ms, library_max_err=lib_err,
                    bound_ms=bound, bound_by=by))
    out["paged_verify_sinks"] = dict(
        name="paged_verify_attention[sinks]", route="cuda",
        source="dynamo_tpu_torch/csrc/paged_verify.cu",
        core="dynamo_tpu_torch/csrc/paged_splitkv.cuh",
        replaces="dynamo_tpu/ops/pallas_decode.py:634",
        max_abs_err=max(errs.values()), ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=bound, bound_by=by, library_ms=lib_ms,
        no_sink_ms=t["no_sink_ms"], window128_ms=t["window128_ms"])

    # ---- flash: the engine's batched prefill steps (512-token budget), pad
    # rows as the scheduler pads the row ladder (base 0, ctx 1, table 0)
    errs = {}
    cases = [("batch8_s64", 64, [(0, 64), (256, 320), (128, 168), (1984, 2048),
                                 (64, 100), (1472, 1500), None, None]),
             ("batch4_s128", 128, [(0, 128), (384, 512), (1024, 1100), None])]
    for name, S, rows in cases:
        B = len(rows)
        pad = torch.tensor([r is None for r in rows], device=dev)
        rows = [r or (0, 1) for r in rows]
        qf = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
        basep = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
        ctxp = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
        btp = bt[:B].clone()
        btp[pad] = 0
        for window in (NW, SINK_WINDOW):
            errs[f"{name}_w{window}"] = _flash_check(
                torch, pf, f"sinks {name} window={window}", k, v, k32, v32,
                layer, qf, btp, basep, ctxp, rows, window, sinks)
    t = timed(lambda: pf.paged_flash_attention(qf, k, v, btp, basep, ctxp,
                                               layer_idx=layer, sinks=sinks),
              lambda: pf.paged_flash_attention(qf, k, v, btp, basep, ctxp,
                                               layer_idx=layer),
              lambda: pf.paged_flash_attention(qf, k, v, btp, basep, ctxp,
                                               layer_idx=layer,
                                               window=SINK_WINDOW, sinks=sinks),
              lambda: pf.paged_flash_attention_ref(
                  qf.float(), k32, v32, btp, basep, ctxp, layer, None, NW, sinks))
    ref = pf.paged_flash_attention_ref(qf.float(), k32, v32, btp, basep, ctxp,
                                       layer, None, NW, sinks)
    base_l, ctx_p = basep.tolist(), ctxp.tolist()
    valid = [min(S, c - b) for b, c in zip(base_l, ctx_p)]
    lib_ms, lib_err = _sdpa_sink(torch, qf, k, v, layer, btp, basep, ctxp,
                                 sinks, NW, ref, valid)
    bound, by = _attn_bound(D, H, KVH, qf, base_l, ctx_p, S, NW)
    emit("kernels", kernel="paged_flash[sinks]",
         shape=dict(H=H, KVH=KVH, D=D, bs=BS, L=L, layer=layer,
                    window=SINK_WINDOW,
                    cases={name: dict(S=S, rows=rows) for name, S, rows in cases}),
         max_err=errs, timed=dict(t, case="batch4_s128", library_ms=lib_ms,
                                  library_max_err=lib_err, bound_ms=bound,
                                  bound_by=by))
    out["paged_flash_sinks"] = dict(
        name="paged_flash_attention[sinks]", route="cuda",
        source="dynamo_tpu_torch/csrc/paged_flash.cu",
        core="dynamo_tpu_torch/csrc/paged_attn_tc.cuh",
        replaces="dynamo_tpu/ops/pallas_attention.py:254",
        max_abs_err=max(errs.values()), ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=bound, bound_by=by, library_ms=lib_ms,
        no_sink_ms=t["no_sink_ms"], window128_ms=t["window128_ms"])
    del k, v, k32, v32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


# Gemma-2's softcap forms of kernels 1, 4 and 2 at gemma-2-9b's attention:
# 16 query heads over 8 KV heads of dim 256 (G 2), scale 256^-0.5, its
# attention cap of 50 and the 4,096-token window of its even layers, over
# 8,192-token tables (its max_position_embeddings) at contexts on both
# sides of the window; then a cap of 5 over queries scaled by 4 (scores
# ~N(0, 4^2): the cap binds, where at 50 over scores ~N(0, 1) it is nearly
# the identity); and the head_dim 128 form at gemma-2-27b's attention (32
# heads over 16, scale 144^-0.5). The flash long step is the 5,000-token
# prompt's last chunk of the engine phase (S 512 at base 4,608, 392 rows
# below ctx).
SOFTCAP_H, SOFTCAP_KVH, SOFTCAP_D, SOFTCAP_CAP, SOFTCAP_WINDOW = 16, 8, 256, 50.0, 4096
SOFTCAP_SCALE = 256 ** -0.5
SOFTCAP_BINDING, SOFTCAP_BINDING_Q = 5.0, 4.0
SOFTCAP_CTX = [1, 15, 16, 17, 513, 4096, 4097, 5000, 8192]
SOFTCAP_PAGES = 512
SOFTCAP_LONG_STEP = (4608, 5000)
SOFTCAP_27B = dict(H=32, KVH=16, D=128, scale=144 ** -0.5)


def _beyond_half_cap(torch, q, k32, layer, bt, base, ctx, window, scale, cap):
    """The share of visible (query, head, key) scores, scaled, whose
    magnitude exceeds cap / 2 (where tanh is far from the identity)."""
    B, S, H, D = q.shape
    KVH = k32.shape[3]
    T = int(max(ctx.tolist()))
    n_beyond, n_vis = 0, 0
    for b in range(B):  # a row at a time: the score tensor stays small
        kd = k32[layer][bt[b].long()].reshape(-1, KVH, D)[:T]
        sc = torch.einsum("skgd,tkd->skgt",
                          q[b].float().reshape(S, KVH, -1, D), kd) * scale
        vis = _visible_mask(torch, base[b:b + 1], ctx[b:b + 1], S, T,
                            window)[0][:, None, None, :]
        n_beyond += int(((sc.abs() > cap / 2) & vis).sum())
        n_vis += int(vis.sum()) * H
    return n_beyond / max(n_vis, 1)


def _sdpa_no_softcap(torch, q, k, v, layer, bt, base, ctx, window, scale):
    """SDPA over each row's K/V pre-gathered to dense [B, H, T, D] with the
    causal and window mask, no cap: the no-softcap form's yardstick (device
    ms by graph replay). No PyTorch call computes a softcapped softmax."""
    F = torch.nn.functional
    B, S, H, D = q.shape
    KVH = k.shape[3]
    T = int(max(ctx.tolist()))

    def dense(c):
        x = c[layer][bt.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
        return x.repeat_interleave(H // KVH, dim=1).contiguous()

    kd, vd = dense(k), dense(v)
    mask = _visible_mask(torch, base, ctx, S, T, window)[:, None]
    qd = q.transpose(1, 2).contiguous()
    ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=scale))
    del kd, vd
    return ms


def _softcap_cases(torch, dev):
    """Kernels 1, 4 and 2 in their softcap form at head_dim 256
    (gemma-2-9b's attention) and 128 (gemma-2-27b's), each call held
    against its f32 plain version at ATOL / RTOL (decode and verify twice,
    bit-identical), with no window and with the 4,096-token window, at the
    cap of 50 and at a binding cap of 5:

    - decode at ``SOFTCAP_CTX`` (1 to 8,192 keys over 8,192-key tables);
    - verify at S 5 and 32 (10 and 64 rows a CTA) over the same rows and a
      pad row (base 0, ctx 1, table 0);
    - flash at the engine's batched chunk (4 rows at S 128, a pad row) and
      at the long step of the engine phase's 5,000-token prompt.

    Each timed call gives the softcap form's ``graph_ms`` beside the
    no-softcap form at the same shape (and the windowed form), the plain
    version's time, the bound and the no-softcap SDPA yardstick. Returns the
    kernels-line entries."""
    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_flash as pf
    from dynamo_tpu_torch.ops import paged_verify as pv

    H, KVH, D, scale = SOFTCAP_H, SOFTCAP_KVH, SOFTCAP_D, SOFTCAP_SCALE
    cap, cap5, win, NW = SOFTCAP_CAP, SOFTCAP_BINDING, SOFTCAP_WINDOW, pd.NO_WINDOW
    L, BS, layer, W = 4, 16, 3, SOFTCAP_PAGES
    B = len(SOFTCAP_CTX)
    N = B * W + 8
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    k = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    v = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    k32, v32 = k.float(), v.float()
    bt = torch.randperm(N, generator=g, device=dev)[:B * W].reshape(B, W).int()
    ctx_l = list(SOFTCAP_CTX)
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    out, shares = {}, {}
    forms = ((f"cap{cap:g}", cap, 1.0), (f"cap{cap5:g}", cap5, SOFTCAP_BINDING_Q))

    def timed(fn, fn_nocap, fn_window, fn_plain):
        return dict(ms=graph_ms(fn), no_softcap_ms=graph_ms(fn_nocap),
                    window4096_ms=graph_ms(fn_window),
                    plain_ms=cuda_ms(fn_plain, iters=5, warmup=1))

    def entry(kernel, src, replaces, errs, t, bound, by, lib_ms):
        return dict(name=f"{kernel}[softcap,D{D}]", route="cuda", source=src,
                    replaces=replaces, max_abs_err=max(errs.values()),
                    ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bound,
                    bound_by=by, library_ms=None,
                    no_softcap_ms=t["no_softcap_ms"],
                    window4096_ms=t["window4096_ms"],
                    sdpa_no_softcap_ms=lib_ms)

    # ---- decode
    q = torch.randn(B, 1, H, D, generator=g, device=dev).bfloat16()
    errs = {}
    for tag, c, qs in forms:
        qq = (q.float() * qs).bfloat16()
        for window in (NW, win):
            errs[f"{tag}_w{window}"] = _decode_check(
                torch, pd, f"softcap {tag} window={window}", qq, k, v, k32, v32,
                bt, ctx, layer, window, scale=scale, softcap=c)
            shares[f"decode_{tag}_w{window}"] = _beyond_half_cap(
                torch, qq, k32, layer, bt, ctx - 1, ctx, window, scale, c)
    kw = dict(layer_idx=layer, scale=scale)
    t = timed(lambda: pd.paged_decode_attention(q, k, v, bt, ctx, softcap=cap, **kw),
              lambda: pd.paged_decode_attention(q, k, v, bt, ctx, **kw),
              lambda: pd.paged_decode_attention(q, k, v, bt, ctx, softcap=cap,
                                                window=win, **kw),
              lambda: pd.paged_decode_attention_ref(q.float(), k32, v32, bt, ctx,
                                                    layer, scale, NW, None, cap))
    lib_ms = _sdpa_no_softcap(torch, q, k, v, layer, bt, ctx - 1, ctx, NW, scale)
    bound, by = _attn_bound(D, H, KVH, q, [c - 1 for c in ctx_l], ctx_l, 1, NW)
    emit("kernels", kernel="paged_decode[softcap]",
         shape=dict(B=B, H=H, KVH=KVH, D=D, bs=BS, L=L, layer=layer, ctx=ctx_l,
                    pages=W, scale=scale, caps=[cap, cap5],
                    binding_q_scale=SOFTCAP_BINDING_Q, window=win),
         max_err=errs, bit_identical=True, timed=dict(
             t, cap=cap, bound_ms=bound, bound_by=by, library_ms=None,
             sdpa_no_softcap_ms=lib_ms))
    out["paged_decode_softcap"] = entry(
        "paged_decode_attention", "dynamo_tpu_torch/csrc/paged_decode.cu",
        "dynamo_tpu/ops/pallas_decode.py:742", errs, t, bound, by, lib_ms)

    # ---- verify: the decode rows and a pad row (base 0, ctx 1, table 0)
    errs = {}
    btv = torch.cat([bt, torch.zeros_like(bt[:1])])
    ctxv = torch.tensor(ctx_l + [1], dtype=torch.int32, device=dev)
    timed_in = None
    for S in (5, 32):
        base = torch.clamp(ctxv - S, min=0)
        qv = torch.randn(B + 1, S, H, D, generator=g, device=dev).bfloat16()
        for tag, c, qs in forms:
            qq = (qv.float() * qs).bfloat16()
            for window in (NW, win):
                errs[f"S{S}_{tag}_w{window}"] = _verify_check(
                    torch, pv, f"softcap S={S} {tag} window={window}", qq, k, v,
                    k32, v32, btv, base, ctxv, layer, window, scale=scale,
                    softcap=c)
                shares[f"verify_S{S}_{tag}_w{window}"] = _beyond_half_cap(
                    torch, qq, k32, layer, btv, base, ctxv, window, scale, c)
        if S == 5:
            timed_in = (qv, base)
    qv, base = timed_in
    t = timed(lambda: pv.paged_verify_attention(qv, k, v, btv, base, ctxv,
                                                softcap=cap, **kw),
              lambda: pv.paged_verify_attention(qv, k, v, btv, base, ctxv, **kw),
              lambda: pv.paged_verify_attention(qv, k, v, btv, base, ctxv,
                                                softcap=cap, window=win, **kw),
              lambda: pv.paged_verify_attention_ref(
                  qv.float(), k32, v32, btv, base, ctxv, layer, scale, NW, None,
                  cap))
    lib_ms = _sdpa_no_softcap(torch, qv, k, v, layer, btv, base, ctxv, NW, scale)
    bound, by = _attn_bound(D, H, KVH, qv, base.tolist(), ctxv.tolist(), 5, NW)
    emit("kernels", kernel="paged_verify[softcap]",
         shape=dict(B=B + 1, S=[5, 32], H=H, KVH=KVH, D=D, layer=layer,
                    ctx=ctxv.tolist(), pad_row="base 0, ctx 1, table 0",
                    scale=scale, caps=[cap, cap5], window=win),
         max_err=errs, bit_identical=True, timed=dict(
             t, S=5, cap=cap, bound_ms=bound, bound_by=by, library_ms=None,
             sdpa_no_softcap_ms=lib_ms))
    out["paged_verify_softcap"] = entry(
        "paged_verify_attention", "dynamo_tpu_torch/csrc/paged_verify.cu",
        "dynamo_tpu/ops/pallas_decode.py:634", errs, t, bound, by, lib_ms)

    # ---- flash: the engine's batched chunk (a pad row: base 0, ctx 1,
    # table 0) and the 5,000-token prompt's long step
    errs, inputs = {}, {}
    cases = [("batch4_s128", 128, [(0, 128), (384, 512), (1024, 1100), None]),
             ("long_step", 512, [SOFTCAP_LONG_STEP])]
    for name, S, rows in cases:
        nb = len(rows)
        pad = torch.tensor([r is None for r in rows], device=dev)
        rows = [r or (0, 1) for r in rows]
        qf = torch.randn(nb, S, H, D, generator=g, device=dev).bfloat16()
        basep = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
        ctxp = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
        btp = bt[-nb:].clone()  # the long step takes the 8,192-key row
        btp[pad] = 0
        for tag, c, qs in forms:
            qq = (qf.float() * qs).bfloat16()
            for window in (NW, win):
                errs[f"{name}_{tag}_w{window}"] = _flash_check(
                    torch, pf, f"softcap {name} {tag} window={window}", k, v,
                    k32, v32, layer, qq, btp, basep, ctxp, rows, window,
                    scale=scale, softcap=c)
                shares[f"flash_{name}_{tag}_w{window}"] = _beyond_half_cap(
                    torch, qq, k32, layer, btp, basep, ctxp, window, scale, c)
        inputs[name] = (qf, btp, basep, ctxp, S, rows)
    flash_t = {}
    for name in ("batch4_s128", "long_step"):
        qf, btp, basep, ctxp, S, rows = inputs[name]
        t = timed(lambda: pf.paged_flash_attention(qf, k, v, btp, basep, ctxp,
                                                   softcap=cap, **kw),
                  lambda: pf.paged_flash_attention(qf, k, v, btp, basep, ctxp, **kw),
                  lambda: pf.paged_flash_attention(qf, k, v, btp, basep, ctxp,
                                                   softcap=cap, window=win, **kw),
                  lambda: pf.paged_flash_attention_ref(
                      qf.float(), k32, v32, btp, basep, ctxp, layer, scale, NW,
                      None, cap))
        t["sdpa_no_softcap_ms"] = _sdpa_no_softcap(
            torch, qf, k, v, layer, btp, basep, ctxp, NW, scale)
        t["bound_ms"], t["bound_by"] = _attn_bound(
            D, H, KVH, qf, basep.tolist(), ctxp.tolist(), S, NW)
        flash_t[name] = t
    emit("kernels", kernel="paged_flash[softcap]",
         shape=dict(H=H, KVH=KVH, D=D, bs=BS, L=L, layer=layer, scale=scale,
                    caps=[cap, cap5], window=win,
                    cases={name: dict(S=S, rows=rows) for name, S, rows in cases}),
         max_err=errs, timed=dict(flash_t, cap=cap, library_ms=None))
    t = flash_t["batch4_s128"]
    out["paged_flash_softcap"] = dict(
        entry("paged_flash_attention", "dynamo_tpu_torch/csrc/paged_flash.cu",
              "dynamo_tpu/ops/pallas_attention.py:254", errs, t, t["bound_ms"],
              t["bound_by"], t["sdpa_no_softcap_ms"]),
        long_step={key: flash_t["long_step"][key] for key in (
            "ms", "no_softcap_ms", "window4096_ms", "plain_ms", "bound_ms",
            "bound_by", "sdpa_no_softcap_ms")})
    emit("kernels", kernel="softcap_scores_beyond_half_cap", share=shares)
    del k, v, k32, v32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _softcap_d128(torch, dev)
    return out


def _softcap_d128(torch, dev):
    """The softcap form at head_dim 128 (gemma-2-27b: 32 heads over 16 KV
    heads, scale 144^-0.5, cap 50 and the binding 5): decode over the
    engine's decode contexts, verify at S 5 and flash at the batched chunk
    over a 4-layer cache of 128-page tables, each held against its f32
    plain version; decode timed beside its no-softcap form."""
    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_flash as pf
    from dynamo_tpu_torch.ops import paged_verify as pv

    H, KVH, D, scale = (SOFTCAP_27B[k] for k in ("H", "KVH", "D", "scale"))
    L, N, BS, layer, W, NW = 4, 1100, 16, 2, 128, pd.NO_WINDOW
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    k = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    v = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    k32, v32 = k.float(), v.float()
    ctx_l = [1, 15, 16, 17, 513, 2048, 700, 1500]
    B = len(ctx_l)
    bt = torch.randperm(N, generator=g, device=dev)[:B * W].reshape(B, W).int()
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    q = torch.randn(B, 1, H, D, generator=g, device=dev).bfloat16()
    qv = torch.randn(B, 5, H, D, generator=g, device=dev).bfloat16()
    base_v = torch.clamp(ctx - 5, min=0)
    rows = [(0, 128), (384, 512), (1024, 1100), (0, 1)]
    qf = torch.randn(4, 128, H, D, generator=g, device=dev).bfloat16()
    btf = bt[:4].clone()
    btf[3] = 0
    basef = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
    ctxf = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    errs = {}
    for c, qs in ((SOFTCAP_CAP, 1.0), (SOFTCAP_BINDING, SOFTCAP_BINDING_Q)):
        for window in (NW, 300):
            tag = f"cap{c:g}_w{window}"
            kw = dict(scale=scale, softcap=c)
            errs[f"decode_{tag}"] = _decode_check(
                torch, pd, f"d128 softcap {tag}", (q.float() * qs).bfloat16(),
                k, v, k32, v32, bt, ctx, layer, window, **kw)
            errs[f"verify_{tag}"] = _verify_check(
                torch, pv, f"d128 softcap {tag}", (qv.float() * qs).bfloat16(),
                k, v, k32, v32, bt, base_v, ctx, layer, window, **kw)
            errs[f"flash_{tag}"] = _flash_check(
                torch, pf, f"d128 softcap {tag}", k, v, k32, v32, layer,
                (qf.float() * qs).bfloat16(), btf, basef, ctxf, rows, window,
                **kw)
    kw = dict(layer_idx=layer, scale=scale)
    ms = graph_ms(lambda: pd.paged_decode_attention(q, k, v, bt, ctx,
                                                    softcap=SOFTCAP_CAP, **kw))
    no_cap_ms = graph_ms(lambda: pd.paged_decode_attention(q, k, v, bt, ctx, **kw))
    emit("kernels", kernel="softcap[D128]",
         shape=dict(B=B, H=H, KVH=KVH, D=D, scale=scale, ctx=ctx_l, pages=W,
                    verify_S=5, flash_rows=rows, window=300,
                    caps=[SOFTCAP_CAP, SOFTCAP_BINDING]),
         max_err=errs, bit_identical=True, decode_ms=ms,
         decode_no_softcap_ms=no_cap_ms)
    del k, v, k32, v32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# the MoE families' attention at head_dim 128: Qwen3-30B-A3B (32 heads over
# 4 KV heads, G 8, 48 layers) and Mixtral-8x7B (32 over 8, G 4, 32 layers),
# neither windowed nor capped; (H, KVH, layers, with verify)
MOE_ATTENTION = {"qwen3moe": (32, 4, 48, True), "mixtral": (32, 8, 32, False),
                 # dense, but the same cases: Qwen2.5-7B's G 7 (engine_load)
                 "qwen25": (28, 4, 28, True)}


def _moe_attention_cases(torch, dev, family):
    """Kernels 1, 2 and 4 at a MoE family's attention (``MOE_ATTENTION``),
    each call held against its f32 plain version at ATOL / RTOL (decode and
    verify twice, bit-identical), over a cache of the family's depth:

    - decode at the split edges (``DECODE_EDGE_CTX``) and at the engine's
      decode contexts, the latter timed;
    - verify at S 5 (the spec engine's K + 1) and 17 (136 rows at G 8: two
      query parts) over the engine's decode contexts and a pad row, S 5
      timed (the Qwen3 family's spec engine runs it);
    - flash at the engine's batched prefill steps (8 rows at S 64, 4 at
      S 128, pad rows), the second timed.

    Each timed call gives its ``graph_ms``, the plain version's time, the
    bound and an SDPA yardstick over pre-gathered dense keys. Returns the
    kernels-line entries."""
    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_flash as pf
    from dynamo_tpu_torch.ops import paged_verify as pv

    F = torch.nn.functional
    H, KVH, L, with_verify = MOE_ATTENTION[family]
    N, BS, D, layer = 1024, 16, 128, L // 2 + 1
    NW = pd.NO_WINDOW
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    k = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    v = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    k32, v32 = k[layer:layer + 1].float(), v[layer:layer + 1].float()
    W = ENGINE["max_model_len"] // BS
    bt = torch.randperm(N, generator=g, device=dev)[:8 * W].reshape(8, W).int()
    ctx_l = [1, 15, 16, 17, 513, 2048, 700, 1500]
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    shape = dict(H=H, KVH=KVH, D=D, bs=BS, L=L, layer=layer)
    out = {}

    def entry(kernel, source, core, replaces, errs, ms, plain_ms, lib_ms,
              bound, by):
        return dict(name=f"{kernel}[{family}]", route="cuda", source=source,
                    core=core, replaces=replaces,
                    max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=lib_ms)

    def sdpa_ms(q, btab, base, cc, S):
        T = int(max(cc.tolist()))
        B = q.shape[0]
        kd = k[layer][btab.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
        vd = v[layer][btab.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
        kd = kd.repeat_interleave(H // KVH, dim=1).contiguous()
        vd = vd.repeat_interleave(H // KVH, dim=1).contiguous()
        mask = _visible_mask(torch, base, cc, S, T, 1 << 30)[:, None]
        qd = q.transpose(1, 2).contiguous()
        return graph_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))

    # ---- decode (the f32 cache copies hold the tested layer only: layer 0
    # of k32 / v32 is the cache's ``layer``)
    errs = {}
    ctx_e = torch.tensor(DECODE_EDGE_CTX, dtype=torch.int32, device=dev)
    qe = torch.randn(8, 1, H, D, generator=g, device=dev).bfloat16()
    q = torch.randn(8, 1, H, D, generator=g, device=dev).bfloat16()
    for name, qq, cc in (("edges", qe, ctx_e), ("engine", q, ctx)):
        out_k = pd.paged_decode_attention(qq, k, v, bt, cc, layer_idx=layer)
        again = pd.paged_decode_attention(qq, k, v, bt, cc, layer_idx=layer)
        ref = pd.paged_decode_attention_ref(qq.float(), k32, v32, bt, cc, 0)
        torch.cuda.synchronize()
        if not torch.equal(out_k, again):
            raise AssertionError(f"decode [{family}] {name}: two calls are not "
                                 "bit-identical")
        errs[name] = check_close(f"decode [{family}] {name}", out_k, ref)
    ms = graph_ms(lambda: pd.paged_decode_attention(q, k, v, bt, ctx,
                                                    layer_idx=layer))
    plain_ms = cuda_ms(lambda: pd.paged_decode_attention_ref(
        q.float(), k32, v32, bt, ctx, 0), iters=5, warmup=1)
    lib_ms = _sdpa_decode_ms(torch, q, k, layer, bt, ctx_l, v)
    bound, by = _attn_bound(D, H, KVH, q, [c - 1 for c in ctx_l], ctx_l, 1, NW)
    emit("kernels", kernel=f"paged_decode[{family}]",
         shape=dict(shape, B=8, edges=DECODE_EDGE_CTX, ctx=ctx_l),
         max_err=errs, bit_identical=True, kernel_ms=ms, plain_ms=plain_ms,
         library_ms=lib_ms, bound_ms=bound, bound_by=by)
    out[f"paged_decode_{family}"] = entry(
        "paged_decode_attention", "dynamo_tpu_torch/csrc/paged_decode.cu",
        "dynamo_tpu_torch/csrc/paged_splitkv.cuh",
        "dynamo_tpu/ops/pallas_decode.py:742", errs, ms, plain_ms, lib_ms,
        bound, by)

    # ---- verify: the engine's decode rows and a pad row (base 0, ctx 1,
    # table 0)
    if with_verify:
        errs, timed = {}, None
        btv = torch.cat([bt, torch.zeros_like(bt[:1])])
        ctxv = torch.tensor(ctx_l + [1], dtype=torch.int32, device=dev)
        for S in (17, 5):
            base = torch.clamp(ctxv - S, min=0)
            qv = torch.randn(9, S, H, D, generator=g, device=dev).bfloat16()
            kw = dict(layer_idx=layer)
            o1 = pv.paged_verify_attention(qv, k, v, btv, base, ctxv, **kw)
            o2 = pv.paged_verify_attention(qv, k, v, btv, base, ctxv, **kw)
            ref = pv.paged_verify_attention_ref(qv.float(), k32, v32, btv, base,
                                                ctxv, 0)
            torch.cuda.synchronize()
            if not (torch.equal(o1, o2) and bool(o1.float().isfinite().all())):
                raise AssertionError(f"verify [{family}] S={S}: not bit-identical "
                                     "or not finite")
            errs[f"S{S}"] = max(
                check_close(f"verify [{family}] S={S} row {i}", o1[i, :c - b],
                            ref[i, :c - b])
                for i, (b, c) in enumerate(zip(base.tolist(), ctxv.tolist()))
                if c > b)
            timed = (qv, base, S)
        qv, base, S = timed
        ms = graph_ms(lambda: pv.paged_verify_attention(qv, k, v, btv, base, ctxv,
                                                        layer_idx=layer))
        plain_ms = cuda_ms(lambda: pv.paged_verify_attention_ref(
            qv.float(), k32, v32, btv, base, ctxv, 0), iters=5, warmup=1)
        lib_ms = sdpa_ms(qv, btv, base, ctxv, S)
        bound, by = _attn_bound(D, H, KVH, qv, base.tolist(), ctxv.tolist(), S, NW)
        emit("kernels", kernel=f"paged_verify[{family}]",
             shape=dict(shape, B=9, S=[5, 17], ctx=ctxv.tolist(),
                        pad_row="base 0, ctx 1, table 0"),
             max_err=errs, bit_identical=True, timed_S=S, kernel_ms=ms,
             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)
        out[f"paged_verify_{family}"] = entry(
            "paged_verify_attention", "dynamo_tpu_torch/csrc/paged_verify.cu",
            "dynamo_tpu_torch/csrc/paged_splitkv.cuh",
            "dynamo_tpu/ops/pallas_decode.py:634", errs, ms, plain_ms, lib_ms,
            bound, by)

    # ---- flash: the engine's batched prefill steps (512-token budget), pad
    # rows as the scheduler pads the row ladder (base 0, ctx 1, table 0)
    errs = {}
    cases = [("batch8_s64", 64, [(0, 64), (256, 320), (128, 168), (1984, 2048),
                                 (64, 100), (1472, 1500), None, None]),
             ("batch4_s128", 128, [(0, 128), (384, 512), (1024, 1100), None])]
    for name, S, rows in cases:
        B = len(rows)
        pad = torch.tensor([r is None for r in rows], device=dev)
        rows = [r or (0, 1) for r in rows]
        qf = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
        basep = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
        ctxp = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
        btp = bt[:B].clone()
        btp[pad] = 0
        errs[name] = _flash_check(torch, pf, f"[{family}] {name}", k[layer:],
                                  v[layer:], k32, v32, 0, qf, btp, basep, ctxp,
                                  rows)
    ms = graph_ms(lambda: pf.paged_flash_attention(qf, k, v, btp, basep, ctxp,
                                                   layer_idx=layer))
    plain_ms = cuda_ms(lambda: pf.paged_flash_attention_ref(
        qf.float(), k32, v32, btp, basep, ctxp, 0), iters=5, warmup=1)
    lib_ms = sdpa_ms(qf, btp, basep, ctxp, S)
    bound, by = _attn_bound(D, H, KVH, qf, basep.tolist(), ctxp.tolist(), S, NW)
    emit("kernels", kernel=f"paged_flash[{family}]",
         shape=dict(shape, cases={n: dict(S=s_, rows=r) for n, s_, r in cases}),
         max_err=errs, timed_case="batch4_s128", kernel_ms=ms,
         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)
    out[f"paged_flash_{family}"] = entry(
        "paged_flash_attention", "dynamo_tpu_torch/csrc/paged_flash.cu",
        "dynamo_tpu_torch/csrc/paged_attn_tc.cuh",
        "dynamo_tpu/ops/pallas_attention.py:254", errs, ms, plain_ms, lib_ms,
        bound, by)
    del k, v, k32, v32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


# Phi-3-mini's attention in the kernels phase: H = KVH = 32 (G 1), head_dim
# 96 (kernels 1, 2 and 4 at D 96, rows padded to 128 columns in shared
# memory), over a 2-layer cache of PHI3_PAGES pages of 16 and the engine's
# 8,192-key block tables
PHI3_PAGES, PHI3_TABLE = 4096, 512
# decode: contexts up to 4k and one past 4,096, where longrope turns long
PHI3_DECODE_CTX = [1, 15, 16, 17, 513, 2048, 4096, 4097]
PHI3_WINDOW = 2047  # Phi-3-mini-4k's sliding window
PHI3_FLASH_ROWS = [(0, 128), (384, 512), (1024, 1100), None]
# the 5,120-token prompt's last 512-token prefill chunk
PHI3_LONG_STEP = (4608, 5120)


def _phi3_cases(torch, dev):
    """Kernels 1, 4 and 2 at Phi-3-mini's attention (H 32, KVH 32, D 96:
    one query head a KV head), bf16 and fp8, each call held against its f32
    plain version at ATOL / RTOL (decode and verify twice, bit-identical;
    the fp8 forms bit for bit against the bf16 forms over the upcast cache,
    ``_fp8_form``):

    - decode at B 8 over ``PHI3_DECODE_CTX`` (up to 4,097 keys), at the
      split edges, and with Phi-3-mini-4k's window of 2,047;
    - verify at S 5 (the spec engine's K + 1) over the same rows and a pad
      row;
    - flash at the engine's batched chunk (4 rows at S 128, a pad row) and
      the 5,120-token prompt's last 512-token step (``PHI3_LONG_STEP``),
      both also with the window of 2,047.

    Each timed call gives its graph replay, the plain version's time, the
    bound and an SDPA yardstick over pre-gathered dense keys. Returns the
    kernels-line entries (their launches: ``engine_phi3``'s)."""
    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_flash as pf
    from dynamo_tpu_torch.ops import paged_verify as pv

    F = torch.nn.functional
    H = KVH = PHI3_MINI_128K["num_key_value_heads"]
    D = PHI3_MINI_128K["hidden_size"] // H
    L, N, BS, W, layer = 2, PHI3_PAGES, 16, PHI3_TABLE, 1
    NW = pd.NO_WINDOW
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    k = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    v = torch.randn(L, N, BS, KVH, D, generator=g, device=dev).bfloat16()
    k32, v32 = k.float(), v.float()
    bt = torch.randperm(N, generator=g, device=dev)[:8 * W].reshape(8, W).int()
    ctx_l = PHI3_DECODE_CTX
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    shape = dict(H=H, KVH=KVH, D=D, bs=BS, L=L, layer=layer, table_pages=W)
    out, errs = {}, {}

    def entry(kernel, source, core, replaces, e, ms, plain_ms, lib_ms,
              bound, by, **extra):
        return dict(name=f"{kernel}[phi3 D96]", route="cuda", source=source,
                    core=core, replaces=replaces, max_abs_err=max(e.values()),
                    ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                    library_ms=lib_ms, **extra)

    def sdpa_ms(q, btab, base, cc, S, window):
        T = int(max(cc.tolist()))
        B = q.shape[0]
        kd = k[layer][btab.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
        vd = v[layer][btab.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
        mask = _visible_mask(torch, base, cc, S, T, window)[:, None]
        qd = q.transpose(1, 2).contiguous()
        return graph_ms(lambda: F.scaled_dot_product_attention(
            qd, kd.contiguous(), vd.contiguous(), attn_mask=mask))

    # ---- decode
    ctx_e = torch.tensor(DECODE_EDGE_CTX, dtype=torch.int32, device=dev)
    q = torch.randn(8, 1, H, D, generator=g, device=dev).bfloat16()
    for name, cc, window in (("edges", ctx_e, NW), ("engine", ctx, NW),
                             (f"window{PHI3_WINDOW}", ctx, PHI3_WINDOW)):
        errs[name] = _decode_check(torch, pd, f"[phi3] {name}", q, k, v, k32,
                                   v32, bt, cc, layer, window)
    timed = {}
    for name, window in (("engine", NW), ("window", PHI3_WINDOW)):
        timed[name] = dict(
            ms=graph_ms(lambda: pd.paged_decode_attention(
                q, k, v, bt, ctx, layer_idx=layer, window=window)),
            plain_ms=cuda_ms(lambda: pd.paged_decode_attention_ref(
                q.float(), k32, v32, bt, ctx, layer, None, window),
                iters=5, warmup=1),
            library_ms=sdpa_ms(q, bt, ctx - 1, ctx, 1, window),
            **dict(zip(("bound_ms", "bound_by"), _attn_bound(
                D, H, KVH, q, [c - 1 for c in ctx_l], ctx_l, 1, window))))
    timed["engine"]["ms_layers_rotated"] = _layers_ms(
        lambda li: pd.paged_decode_attention(q, k, v, bt, ctx, layer_idx=li),
        L, graph_ms)
    ctas = _split_ctas(ctx_l, W * BS, KVH)
    emit("kernels", kernel="paged_decode[phi3 D96]",
         shape=dict(shape, B=8, ctx=ctx_l, edges=DECODE_EDGE_CTX,
                    window=PHI3_WINDOW),
         max_err=errs, bit_identical=True, timed=timed, ctas=ctas[0],
         live_ctas=ctas[1])
    t = timed["engine"]
    out["paged_decode_d96"] = entry(
        "paged_decode_attention", "dynamo_tpu_torch/csrc/paged_decode.cu",
        "dynamo_tpu_torch/csrc/paged_splitkv.cuh",
        "dynamo_tpu/ops/pallas_decode.py:742", errs, t["ms"], t["plain_ms"],
        t["library_ms"], t["bound_ms"], t["bound_by"],
        window_2047=timed["window"])

    # ---- verify at S 5: the engine's decode rows and a pad row
    errs = {}
    btv = torch.cat([bt, torch.zeros_like(bt[:1])])
    ctxv = torch.tensor(ctx_l + [1], dtype=torch.int32, device=dev)
    S = 5
    base = torch.clamp(ctxv - S, min=0)
    qv = torch.randn(9, S, H, D, generator=g, device=dev).bfloat16()
    errs["S5"] = _verify_check(torch, pv, "[phi3] S=5", qv, k, v, k32, v32,
                               btv, base, ctxv, layer)
    ms = graph_ms(lambda: pv.paged_verify_attention(qv, k, v, btv, base, ctxv,
                                                    layer_idx=layer))
    plain_ms = cuda_ms(lambda: pv.paged_verify_attention_ref(
        qv.float(), k32, v32, btv, base, ctxv, layer), iters=5, warmup=1)
    lib_ms = sdpa_ms(qv, btv, base, ctxv, S, NW)
    bound, by = _attn_bound(D, H, KVH, qv, base.tolist(), ctxv.tolist(), S, NW)
    emit("kernels", kernel="paged_verify[phi3 D96]",
         shape=dict(shape, B=9, S=S, ctx=ctxv.tolist(),
                    pad_row="base 0, ctx 1, table 0"),
         max_err=errs, bit_identical=True, kernel_ms=ms, plain_ms=plain_ms,
         library_ms=lib_ms, bound_ms=bound, bound_by=by)
    out["paged_verify_d96"] = entry(
        "paged_verify_attention", "dynamo_tpu_torch/csrc/paged_verify.cu",
        "dynamo_tpu_torch/csrc/paged_splitkv.cuh",
        "dynamo_tpu/ops/pallas_decode.py:634", errs, ms, plain_ms, lib_ms,
        bound, by)

    # ---- flash: the engine's batched chunk and the long prompt's last step
    errs, flash_in, timed = {}, {}, {}
    for name, S, rows in (("batch4_s128", 128, PHI3_FLASH_ROWS),
                          ("long_step", 512, [PHI3_LONG_STEP])):
        B = len(rows)
        pad = torch.tensor([r is None for r in rows], device=dev)
        rows = [r or (0, 1) for r in rows]
        qf = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
        basep = torch.tensor([r[0] for r in rows], dtype=torch.int32, device=dev)
        ctxp = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
        btp = bt[:B].clone()
        btp[pad] = 0
        flash_in[name] = (qf, btp, basep, ctxp, S, rows)
        for window in (NW, PHI3_WINDOW):
            errs[f"{name}_w{window}"] = _flash_check(
                torch, pf, f"[phi3] {name} window={window}", k, v, k32, v32,
                layer, qf, btp, basep, ctxp, rows, window)
            timed[f"{name}_w{window}"] = dict(
                ms=graph_ms(lambda: pf.paged_flash_attention(
                    qf, k, v, btp, basep, ctxp, layer_idx=layer,
                    window=window)),
                plain_ms=cuda_ms(lambda: pf.paged_flash_attention_ref(
                    qf.float(), k32, v32, btp, basep, ctxp, layer, None,
                    window), iters=3, warmup=1),
                library_ms=sdpa_ms(qf, btp, basep, ctxp, S, window),
                **dict(zip(("bound_ms", "bound_by"), _attn_bound(
                    D, H, KVH, qf, basep.tolist(), ctxp.tolist(), S, window))))
    emit("kernels", kernel="paged_flash[phi3 D96]",
         shape=dict(shape, batch4_s128=PHI3_FLASH_ROWS,
                    long_step=PHI3_LONG_STEP, window=PHI3_WINDOW),
         max_err=errs, timed=timed)
    t, tl = timed[f"batch4_s128_w{NW}"], timed[f"long_step_w{NW}"]
    out["paged_flash_d96"] = entry(
        "paged_flash_attention", "dynamo_tpu_torch/csrc/paged_flash.cu",
        "dynamo_tpu_torch/csrc/paged_attn_tc.cuh",
        "dynamo_tpu/ops/pallas_attention.py:254", errs, t["ms"], t["plain_ms"],
        t["library_ms"], t["bound_ms"], t["bound_by"], long_step=tl,
        window_2047=dict(batch4_s128=timed[f"batch4_s128_w{PHI3_WINDOW}"],
                         long_step=timed[f"long_step_w{PHI3_WINDOW}"]))

    # ---- the fp8 forms over e4m3 caches of the same values' shape
    del k32, v32
    k8, v8 = k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn)
    del k, v
    torch.cuda.empty_cache()
    kb, vb = k8.to(torch.bfloat16), v8.to(torch.bfloat16)
    k32, v32 = kb.float(), vb.float()
    kw = dict(layer_idx=layer, window=NW, sinks=None, softcap=0.0,
              scale=D ** -0.5)
    forms = {}
    forms["decode"] = _fp8_form(torch, "decode", "phi3", q, k8, v8, kb, vb,
                                k32, v32, bt, [c - 1 for c in ctx_l], ctx_l, kw)
    forms["verify"] = _fp8_form(torch, "verify", "phi3", qv, k8, v8, kb, vb,
                                k32, v32, btv, base.tolist(), ctxv.tolist(), kw)
    for name in ("batch4_s128", "long_step"):
        qf, btp, basep, ctxp, _, _ = flash_in[name]
        forms[f"flash_{name}"] = _fp8_form(
            torch, "flash", f"phi3 {name}", qf, k8, v8, kb, vb, k32, v32,
            btp, basep.tolist(), ctxp.tolist(), kw)
    emit("kernels", kernel="fp8_forms[phi3 D96]", **forms)
    for kind, mod, src, core, line, form in (
            ("decode", "paged_decode", "paged_decode.cu", "paged_splitkv.cuh",
             "dynamo_tpu/ops/pallas_decode.py:742", "decode"),
            ("verify", "paged_verify", "paged_verify.cu", "paged_splitkv.cuh",
             "dynamo_tpu/ops/pallas_decode.py:634", "verify"),
            ("flash", "paged_flash", "paged_flash.cu", "paged_attn_tc.cuh",
             "dynamo_tpu/ops/pallas_attention.py:254", "flash_batch4_s128")):
        r = forms[form]
        out[f"{mod}_d96_fp8"] = dict(
            name=f"{mod}_attention[phi3 D96 fp8]", route="cuda",
            source=f"dynamo_tpu_torch/csrc/{src}",
            core=f"dynamo_tpu_torch/csrc/{core}",
            upcast="dynamo_tpu_torch/csrc/kv_fp8.cuh", replaces=line,
            **{key: r[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "sdpa_over_upcast_bf16_ms", "bf16_form_ms")},
            **({"long_step": {key: forms["flash_long_step"][key] for key in (
                "max_abs_err", "ms", "bf16_form_ms", "plain_ms", "bound_ms",
                "bound_by", "sdpa_over_upcast_bf16_ms")}}
               if kind == "flash" else {}))
    del k8, v8, kb, vb, k32, v32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


# GQA groups that leave spare rows in a tensor-core CTA (kernels 2 and 6):
# Qwen2.5-7B's 28 query heads over 4 KV heads (G 7: flash holds 9 positions,
# 63 of 64 rows; the prefix partials 18, 126 of 128) and Qwen2.5-32B's 40
# over 8 (G 5: 12 and 60 of 64; 25 and 125 of 128), head_dim 128
ODD_GROUPS = {"qwen25": (28, 4), "qwen25_32b": (40, 8)}
ODD_LAYERS, ODD_PAGES = 4, 1024


def _odd_group_cases(torch, dev, decode_entries):
    """Kernels 2 (bf16 and fp8) and 6 at ``ODD_GROUPS``, over 4-layer
    caches of e4m3 values (the bf16 cache their exact upcast), layer 2:

    - flash at the engine's batched chunk (``batch4_s128``: 4 rows at S 128,
      a pad row) and the dense ladder's long step (S 512 at 11,776, ctx
      12,000: the query tiles past ctx must be zero), held against the f32
      plain version and timed by graph replay (``_flash_check``,
      ``_flash_timing``); its fp8 form by ``_fp8_form``;
    - the prefix partials by ``_sp_prefix_run``.

    ``decode_entries`` holds the G 7 flash entry of ``_moe_attention_cases``
    (``paged_flash_qwen25``), which gains the long step. Returns the
    kernels-line entries of the forms no cell of this script serves (G 5;
    flash's fp8 form and kernel 6 at G 7): their ``launches`` is null and
    ``path`` says why."""
    from dynamo_tpu_torch.ops import paged_flash as pf
    from dynamo_tpu_torch.ops import sp_prefix as spx

    D, layer = 128, 2
    kw = dict(layer_idx=layer, window=1 << 30, sinks=None, softcap=0.0,
              scale=D ** -0.5)
    src = "dynamo_tpu_torch/csrc/"
    off_path = dict(launches=None, path="kernels phase only: no cell of this "
                    "script serves this form")
    entries = {}
    for fam, (H, KVH) in ODD_GROUPS.items():
        g = torch.Generator(device=dev).manual_seed(SEED + 40)
        shape = (ODD_LAYERS, ODD_PAGES, 16, KVH, D)
        k8 = torch.randn(shape, generator=g, device=dev).to(torch.float8_e4m3fn)
        v8 = torch.randn(shape, generator=g, device=dev).to(torch.float8_e4m3fn)
        k, v = k8.to(torch.bfloat16), v8.to(torch.bfloat16)
        k32, v32 = k.float(), v.float()
        W = ENGINE["max_model_len"] // 16
        bt = torch.randperm(ODD_PAGES, generator=g, device=dev)[:4 * W].reshape(4, W).int()
        bt[-1] = 0
        chunk = [(0, 128), (384, 512), (1024, 1100), (0, 1)]
        long_bt = torch.randperm(ODD_PAGES, generator=g, device=dev)[
            :LONG_DENSE_PAGES][None].int()
        flash, fp8 = {}, {}
        for name, S, rows, btp in (("batch4_s128", 128, chunk, bt),
                                   ("long_dense_step", 512, [LONG_DENSE_STEP],
                                    long_bt)):
            qf = torch.randn(len(rows), S, H, D, generator=g, device=dev).bfloat16()
            base_l, c_l = [r[0] for r in rows], [r[1] for r in rows]
            basep = torch.tensor(base_l, dtype=torch.int32, device=dev)
            ctxp = torch.tensor(c_l, dtype=torch.int32, device=dev)
            err = _flash_check(torch, pf, f"[{fam}] {name}", k, v, k32, v32,
                               layer, qf, btp, basep, ctxp, rows)
            t = _flash_timing(torch, pf, k, v, k32, v32, layer, qf, btp, basep,
                              ctxp, S, rows)
            flash[name] = dict(t, max_abs_err=err)
            fp8[name] = _fp8_form(torch, "flash", f"[{fam}] {name}", qf, k8, v8,
                                  k, v, k32, v32, btp, base_l, c_l, kw)
        sp_errs, sp = _sp_prefix_run(torch, spx, g, k, v, k32, v32, layer, H)
        del k, v, k32, v32
        sp8 = None
        if fam == "qwen25":  # kernel 6's fp8 form at G 7
            sp8_errs, sp8 = _sp_prefix_fp8_run(torch, spx, g, k8, v8, layer, H)
            entries[f"sp_prefix_fp8_{fam}"] = _sp_prefix_fp8_entry(
                sp8_errs, dict(sp8, ms=sp8["kernel_ms"]),
                name=f"paged_prefix_attention_partials[fp8,{fam}]", **off_path)
            sp8 = dict(max_err=sp8_errs, **sp8)
        del k8, v8
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        G = H // KVH
        emit("kernels", kernel=f"odd_group[{fam}]",
             shape=dict(H=H, KVH=KVH, G=G, D=D, L=ODD_LAYERS, layer=layer,
                        flash_positions_a_cta=64 // G,
                        flash_spare_rows=64 - 64 // G * G,
                        sp_positions_a_cta=128 // G,
                        sp_spare_rows=128 - 128 // G * G,
                        chunk=chunk, long_step=LONG_DENSE_STEP,
                        sp_prefixes=list(SP_PREFIXES)),
             flash=flash, flash_fp8=fp8, sp_prefix=dict(max_err=sp_errs, **sp),
             sp_prefix_fp8=sp8, card=nvidia_smi_line())
        t, tl = flash["batch4_s128"], flash["long_dense_step"]
        long_step = dict(ms=tl["kernel_ms"], plain_ms=tl["plain_ms"],
                         bound_ms=tl["bound_ms"], bound_by=tl["bound_by"],
                         library_ms=tl["library_ms"],
                         max_abs_err=tl["max_abs_err"])
        if fam == "qwen25":
            decode_entries["paged_flash_qwen25"]["long_dense_step"] = long_step
        else:
            entries[f"paged_flash_{fam}"] = dict(
                name=f"paged_flash_attention[{fam}]", route="cuda",
                source=src + "paged_flash.cu", core=src + "paged_attn_tc.cuh",
                replaces="dynamo_tpu/ops/pallas_attention.py:254",
                max_abs_err=max(t["max_abs_err"], tl["max_abs_err"]),
                ms=t["kernel_ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=t["library_ms"], long_dense_step=long_step,
                **off_path)
        f8, f8l = fp8["batch4_s128"], fp8["long_dense_step"]
        keys = ("ms", "bf16_form_ms", "plain_ms", "bound_ms", "bound_by",
                "sdpa_over_upcast_bf16_ms")
        entries[f"paged_flash_fp8_{fam}"] = dict(
            name=f"paged_flash_attention[fp8,{fam}]", route="cuda",
            source=src + "paged_flash.cu", core=src + "paged_attn_tc.cuh",
            upcast=src + "kv_fp8.cuh",
            replaces="dynamo_tpu/ops/pallas_attention.py:254",
            max_abs_err=max(f8["max_abs_err"], f8l["max_abs_err"]),
            library_ms=None, **{k_: f8[k_] for k_ in keys},
            long_dense_step={k_: f8l[k_] for k_ in keys}, **off_path)
        entries[f"sp_prefix_{fam}"] = dict(
            name=f"paged_prefix_attention_partials[{fam}]", route="cuda",
            source=src + "sp_prefix.cu", core=src + "paged_attn_tc.cuh",
            replaces="dynamo_tpu/ops/pallas_sp.py:232",
            max_abs_err=max(max(e.values()) for e in sp_errs.values()),
            ms=sp["kernel_ms"], plain_ms=sp["plain_ms"],
            bound_ms=sp["bound_ms"], bound_by=sp["bound_by"],
            library_ms=sp["library_ms"], **off_path)
    return entries


def _mla_cases(torch, dev):
    """The MLA decode kernel at DeepSeek-V2-Lite's shapes: B 8, H 16, R 512,
    RD 64, bs 16, a 27-layer stacked latent cache at layer 13, the decode
    phase's contexts (a ctx-1 row, page edges, a full 2048-key table),
    against its f32 plain version within ATOL / RTOL. Times the kernel, the
    plain version and, as the library yardstick, SDPA over the keys
    [c | kr] pre-gathered to dense [B, H, T, 576] with c as the value."""
    from dynamo_tpu_torch.ops import mla_decode as md

    F = torch.nn.functional
    L, N, BS, H, R, RD = 27, 1024, 16, 16, 512, 64
    LAYER = 13
    W = ENGINE["max_model_len"] // BS
    scale = 0.11472  # V2-Lite's MLA softmax scale (models/deepseek.py)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    c = torch.randn(L, N, BS, 1, R, generator=g, device=dev).bfloat16()
    kr = torch.randn(L, N, BS, 1, RD, generator=g, device=dev).bfloat16()
    ctx_l = [1, 15, 16, 17, 513, 2048, 700, 1500]
    B = len(ctx_l)
    bt = torch.randperm(N, generator=g, device=dev)[: B * W].reshape(B, W).int()
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    q_lat = (torch.randn(B, 1, H, R, generator=g, device=dev) * 0.5).bfloat16()
    q_rope = (torch.randn(B, 1, H, RD, generator=g, device=dev) * 0.5).bfloat16()
    c32, kr32 = c.float(), kr.float()
    out = md.mla_paged_decode_attention(q_lat, q_rope, c, kr, bt, ctx,
                                        layer_idx=LAYER, scale=scale)
    ref = md.mla_paged_decode_attention_ref(q_lat.float(), q_rope.float(), c32,
                                            kr32, bt, ctx, LAYER, scale)
    torch.cuda.synchronize()
    err = check_close("mla_decode", out, ref)
    plain_bf16 = md.mla_paged_decode_attention_ref(q_lat, q_rope, c, kr, bt, ctx,
                                                   LAYER, scale)
    ms = graph_ms(lambda: md.mla_paged_decode_attention(
        q_lat, q_rope, c, kr, bt, ctx, layer_idx=LAYER, scale=scale))
    eager_ms = cuda_ms(lambda: md.mla_paged_decode_attention(
        q_lat, q_rope, c, kr, bt, ctx, layer_idx=LAYER, scale=scale))
    plain_ms = cuda_ms(lambda: md.mla_paged_decode_attention_ref(
        q_lat.float(), q_rope.float(), c32, kr32, bt, ctx, LAYER, scale))
    # library yardstick: SDPA over the keys pre-gathered to dense
    T = max(ctx_l)
    keys = torch.cat([c[LAYER][bt.long()].reshape(B, -1, R),
                      kr[LAYER][bt.long()].reshape(B, -1, RD)], -1)[:, :T]
    kd = keys[:, None].expand(B, H, T, R + RD).contiguous()
    vd = keys[:, None, :, :R].expand(B, H, T, R).contiguous()
    qd = torch.cat([q_lat, q_rope], -1).transpose(1, 2).contiguous()
    mask = (torch.arange(T, device=dev)[None, :] < ctx[:, None])[:, None, None, :]
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=scale))
    nkeys = int(np.sum(ctx_l))
    # each live key once (c and kr), the queries, the output, the tables
    nbytes = (nkeys * (R + RD) * 2 + B * H * (R + RD) * 2 + B * H * R * 2
              + bt.numel() * 4 + B * 4)
    flops = 2.0 * nkeys * H * ((R + RD) + R)
    bound, by = _bound_ms(flops, nbytes)
    chunk, splits, cluster = md.plan(W * BS)
    emit("kernels", kernel="mla_decode",
         shape=dict(B=B, H=H, R=R, RD=RD, bs=BS, L=L, layer=LAYER, ctx=ctx_l,
                    scale=scale),
         max_err=err, plain_bf16_max_err=float((plain_bf16.float() - ref).abs().max()),
         kernel_ms=ms, kernel_ms_eager=eager_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
         bound_by=by, chunk=chunk, splits=splits, cluster=cluster,
         ctas=dict(grid=B * splits * -(-H // md.HEAD_GROUP),
                   live=sum(-(-n // chunk) for n in ctx_l)))
    del c, kr, c32, kr32, keys, kd, vd
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(name="mla_paged_decode_attention", route="cuda",
                source="dynamo_tpu_torch/csrc/mla_decode.cu",
                replaces="dynamo_tpu/ops/pallas_decode.py:376",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)


# the fp8 forms' attention shapes: (name, H, KVH, D, window, sinks, softcap,
# scale): Llama-3.2-1B (the engine_fp8 path), Qwen3-30B-A3B's head_dim 128
# (Mixtral-8x7B's too), gemma-2-9b's softcap at head_dim 256 with its
# 4,096-token window, gpt-oss-20b's sinks with its 128-token window
FP8_SHAPES = (
    ("llama_d64", 32, 8, 64, None, False, 0.0, None),
    ("qwen3moe_d128", 32, 4, 128, None, False, 0.0, None),
    ("gemma2_d256_cap50", 16, 8, 256, 4096, False, 50.0, SOFTCAP_SCALE),
    ("gptoss_sinks_w128", 64, 8, 64, SINK_WINDOW, True, 0.0, None),
)
FP8_LAYERS, FP8_PAGES = 4, 1024


def _fp8_call(torch, kind, q, k, v, bt, base, ctx, **kw):
    """One call of the ``kind`` kernel (decode, verify, flash) on the card."""
    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_flash as pf
    from dynamo_tpu_torch.ops import paged_verify as pv

    if kind == "decode":
        return pd.paged_decode_attention(q, k, v, bt, ctx, **kw)
    fn = pv.paged_verify_attention if kind == "verify" else pf.paged_flash_attention
    return fn(q, k, v, bt, base, ctx, **kw)


def _fp8_plain(torch, kind, q, k, v, bt, base, ctx, layer, scale, window,
               sinks, softcap):
    """The plain version of the ``kind`` kernel (f32 here)."""
    from dynamo_tpu_torch.ops import paged_decode as pd
    from dynamo_tpu_torch.ops import paged_flash as pf
    from dynamo_tpu_torch.ops import paged_verify as pv

    if kind == "decode":
        return pd.paged_decode_attention_ref(q, k, v, bt, ctx, layer, scale,
                                             window, sinks, softcap)
    fn = (pv.paged_verify_attention_ref if kind == "verify"
          else pf.paged_flash_attention_ref)
    return fn(q, k, v, bt, base, ctx, layer, scale, window, sinks, softcap)


def _fp8_form(torch, kind, name, q, k8, v8, kb, vb, k32, v32, bt, base_l,
              c_l, kw):
    """One fp8 call of the ``kind`` kernel over the e4m3 caches ``k8`` /
    ``v8``: bit for bit equal to itself and to the bf16 form over the upcast
    caches ``kb`` / ``vb``, and within ATOL / RTOL of the f32 plain version
    on each row's valid queries; both forms timed by graph replay beside
    the plain version, SDPA over the upcast K/V (``library_ms`` is null: no
    PyTorch call reads e4m3 pages) and the bound with 1-byte K/V."""
    dev = q.device
    B, S, H, D = q.shape
    KVH = k8.shape[3]
    layer, sc, win = kw["layer_idx"], kw["scale"], kw["window"]
    sinks, cap = kw["sinks"], kw["softcap"]
    base = torch.tensor(base_l, dtype=torch.int32, device=dev)
    ctx = torch.tensor(c_l, dtype=torch.int32, device=dev)
    out8 = _fp8_call(torch, kind, q, k8, v8, bt, base, ctx, **kw)
    again = _fp8_call(torch, kind, q, k8, v8, bt, base, ctx, **kw)
    outb = _fp8_call(torch, kind, q, kb, vb, bt, base, ctx, **kw)
    ref = _fp8_plain(torch, kind, q.float(), k32, v32, bt, base, ctx,
                     layer, sc, win, sinks, cap)
    torch.cuda.synchronize()
    if not (torch.equal(out8, again) and torch.equal(out8, outb)):
        raise AssertionError(
            f"{kind} fp8 {name}: not bit-equal to itself and to the "
            f"bf16 form over the upcast cache (max |diff| "
            f"{float((out8.float() - outb.float()).abs().max()):.3g})")
    valid = [1 if kind == "decode" else max(0, min(S, c - b))
             for b, c in zip(base_l, c_l)]
    err = max(check_close(f"{kind} fp8 {name} row {i}", out8[i, :n],
                          ref[i, :n])
              for i, n in enumerate(valid) if n > 0)
    del out8, again, outb, ref
    ms = graph_ms(lambda: _fp8_call(torch, kind, q, k8, v8, bt, base, ctx, **kw))
    bf16_ms = graph_ms(lambda: _fp8_call(torch, kind, q, kb, vb, bt, base,
                                         ctx, **kw))
    plain_ms = cuda_ms(lambda: _fp8_plain(
        torch, kind, q.float(), k32, v32, bt, base, ctx, layer, sc, win,
        sinks, cap), iters=5, warmup=1)
    sdpa_ms = _sdpa_no_softcap(torch, q, kb, vb, layer, bt, base, ctx, win, sc)
    bound, by = _attn_bound(D, H, KVH, q, base_l, c_l, S, win, kv_bytes=1)
    bound_bf16, _ = _attn_bound(D, H, KVH, q, base_l, c_l, S, win)
    return dict(max_abs_err=err, ms=ms, bf16_form_ms=bf16_ms,
                plain_ms=plain_ms, library_ms=None,
                sdpa_over_upcast_bf16_ms=sdpa_ms, bound_ms=bound,
                bound_by=by, bf16_bound_ms=bound_bf16,
                bit_equal_to_bf16_form=True)


def _fp8_cases(torch, dev):
    """The fp8 forms of kernels 1, 4 and 2 (decode, verify, flash) at the
    ``FP8_SHAPES``, over e4m3 caches of ``FP8_LAYERS`` layers, and kernel
    5's (MLA decode) at DeepSeek-V2-Lite's. Each call is held against its
    plain version in f32 over the same e4m3 values (ATOL / RTOL), and bit
    for bit against the bf16 form over the caches upcast to bf16; both
    forms are timed by graph replay at the same shape. Shapes: decode at
    the engine's decode contexts (B 8, 2,048-key tables); verify at S 5
    (the spec engine's K + 1) over the same rows (ctx 1 is a pad row);
    flash at the engine's batched chunk (4 rows at S 128, a pad row). The
    bound counts one byte a K/V element. No PyTorch call reads e4m3 pages:
    ``library_ms`` is null, and SDPA over the caches upcast to bf16 (no cap,
    no sink) stands beside it as ``sdpa_over_upcast_bf16_ms``. Returns the
    kernels-line entries: the Llama-3.2-1B shape's numbers (the
    ``engine_fp8`` path's), the other shapes under ``forms``."""
    NW = 1 << 30
    W = ENGINE["max_model_len"] // 16
    ctx_l = [1, 15, 16, 17, 513, 2048, 700, 1500]
    flash_rows = [(0, 128), (384, 512), (1024, 1100), (0, 1)]
    cases = dict(
        decode=(1, [c - 1 for c in ctx_l], ctx_l),
        verify=(5, [max(0, c - 5) for c in ctx_l], ctx_l),
        flash=(128, [r[0] for r in flash_rows], [r[1] for r in flash_rows]))
    results = {k: {} for k in cases}
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    for name, H, KVH, D, window, with_sinks, cap, scale in FP8_SHAPES:
        shape = (FP8_LAYERS, FP8_PAGES, 16, KVH, D)
        k8 = torch.randn(shape, generator=g, device=dev).to(torch.float8_e4m3fn)
        v8 = torch.randn(shape, generator=g, device=dev).to(torch.float8_e4m3fn)
        kb, vb = k8.to(torch.bfloat16), v8.to(torch.bfloat16)
        k32, v32 = kb.float(), vb.float()
        sinks = (torch.randn(H, generator=g, device=dev) * SINK_SCALE
                 if with_sinks else None)
        win = window or NW
        sc = scale or D ** -0.5
        layer = 2
        kw = dict(layer_idx=layer, window=win, sinks=sinks, softcap=cap,
                  scale=sc)
        bt_all = torch.randperm(FP8_PAGES, generator=g, device=dev)[
            :8 * W].reshape(8, W).int()
        for kind, (S, base_l, c_l) in cases.items():
            B = len(c_l)
            bt = bt_all[:B].clone()
            if kind == "flash":
                bt[-1] = 0  # the pad row reads block 0
            q = torch.randn(B, S, H, D, generator=g, device=dev).bfloat16()
            results[kind][name] = dict(
                _fp8_form(torch, kind, name, q, k8, v8, kb, vb, k32, v32, bt,
                          base_l, c_l, kw),
                shape=dict(B=B, S=S, H=H, KVH=KVH, D=D, window=window,
                           sinks=with_sinks, softcap=cap, scale=sc))
        del k8, v8, kb, vb, k32, v32
        torch.cuda.empty_cache()
    emit("kernels", kernel="fp8_forms", layers=FP8_LAYERS, pages=FP8_PAGES,
         decode_ctx=ctx_l, verify_S=5, flash_rows=flash_rows, **results)
    entries = {}
    for kind, mod, src, core, line in (
            ("decode", "paged_decode", "paged_decode.cu", "paged_splitkv.cuh",
             "dynamo_tpu/ops/pallas_decode.py:742"),
            ("verify", "paged_verify", "paged_verify.cu", "paged_splitkv.cuh",
             "dynamo_tpu/ops/pallas_decode.py:634"),
            ("flash", "paged_flash", "paged_flash.cu", "paged_attn_tc.cuh",
             "dynamo_tpu/ops/pallas_attention.py:254")):
        main = results[kind]["llama_d64"]
        entries[f"{mod}_fp8"] = dict(
            name=f"{mod}_attention[fp8]", route="cuda",
            source=f"dynamo_tpu_torch/csrc/{src}",
            core=f"dynamo_tpu_torch/csrc/{core}",
            upcast="dynamo_tpu_torch/csrc/kv_fp8.cuh", replaces=line,
            **{k: main[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "sdpa_over_upcast_bf16_ms", "bf16_form_ms")},
            forms={n: {k: r[k] for k in ("max_abs_err", "ms", "bf16_form_ms",
                                         "bound_ms", "bound_by",
                                         "sdpa_over_upcast_bf16_ms")}
                   for n, r in results[kind].items() if n != "llama_d64"})
    entries["mla_decode_fp8"] = _mla_fp8_case(torch, dev)
    return entries


def _mla_fp8_case(torch, dev):
    """Kernel 5's fp8 form at DeepSeek-V2-Lite's shapes (``_mla_cases``'):
    e4m3 latent and rope caches of 27 layers, held against the f32 plain
    version and bit for bit against the bf16 form over the upcast caches;
    both forms timed by graph replay, the bound with one byte a key
    element."""
    from dynamo_tpu_torch.ops import mla_decode as md

    L, N, BS, H, R, RD = 27, 1024, 16, 16, 512, 64
    LAYER, scale = 13, 0.11472
    W = ENGINE["max_model_len"] // BS
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    c8 = torch.randn(L, N, BS, 1, R, generator=g, device=dev).to(torch.float8_e4m3fn)
    kr8 = torch.randn(L, N, BS, 1, RD, generator=g, device=dev).to(torch.float8_e4m3fn)
    cb, krb = c8.to(torch.bfloat16), kr8.to(torch.bfloat16)
    ctx_l = [1, 15, 16, 17, 513, 2048, 700, 1500]
    B = len(ctx_l)
    bt = torch.randperm(N, generator=g, device=dev)[: B * W].reshape(B, W).int()
    ctx = torch.tensor(ctx_l, dtype=torch.int32, device=dev)
    q_lat = (torch.randn(B, 1, H, R, generator=g, device=dev) * 0.5).bfloat16()
    q_rope = (torch.randn(B, 1, H, RD, generator=g, device=dev) * 0.5).bfloat16()

    def call(c, kr):
        return md.mla_paged_decode_attention(q_lat, q_rope, c, kr, bt, ctx,
                                             layer_idx=LAYER, scale=scale)

    out8, again, outb = call(c8, kr8), call(c8, kr8), call(cb, krb)
    ref = md.mla_paged_decode_attention_ref(q_lat.float(), q_rope.float(),
                                            cb.float(), krb.float(), bt, ctx,
                                            LAYER, scale)
    torch.cuda.synchronize()
    if not (torch.equal(out8, again) and torch.equal(out8, outb)):
        raise AssertionError("mla_decode fp8: not bit-equal to itself and to "
                             "the bf16 form over the upcast caches")
    err = check_close("mla_decode fp8", out8, ref)
    ms = graph_ms(lambda: call(c8, kr8))
    bf16_ms = graph_ms(lambda: call(cb, krb))
    plain_ms = cuda_ms(lambda: md.mla_paged_decode_attention_ref(
        q_lat.float(), q_rope.float(), cb.float(), krb.float(), bt, ctx, LAYER,
        scale), iters=3, warmup=1)
    nkeys = int(np.sum(ctx_l))
    flops = 2.0 * nkeys * H * ((R + RD) + R)
    small = B * H * (R + RD) * 2 + B * H * R * 2 + bt.numel() * 4 + B * 4
    bound, by = _bound_ms(flops, nkeys * (R + RD) + small)
    bound_bf16, _ = _bound_ms(flops, nkeys * (R + RD) * 2 + small)
    emit("kernels", kernel="mla_decode_fp8",
         shape=dict(B=B, H=H, R=R, RD=RD, bs=BS, L=L, layer=LAYER, ctx=ctx_l,
                    scale=scale),
         max_err=err, bit_equal_to_bf16_form=True, kernel_ms=ms,
         bf16_form_ms=bf16_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
         bf16_bound_ms=bound_bf16)
    del c8, kr8, cb, krb
    torch.cuda.empty_cache()
    return dict(name="mla_paged_decode_attention[fp8]", route="cuda",
                source="dynamo_tpu_torch/csrc/mla_decode.cu",
                upcast="dynamo_tpu_torch/csrc/kv_fp8.cuh",
                replaces="dynamo_tpu/ops/pallas_decode.py:376",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None, bf16_form_ms=bf16_ms)


# epilogue rows (B 8): the reference's mixed-regime set (greedy, top-k,
# top-p, min-p with penalties, top-k + top-p with repetition, greedy), then
# top-k 1 and a row with planted ties at the top-k and top-p cuts
EPILOGUE_ROWS = dict(
    temperature=[0.0, 0.7, 1.0, 1.3, 0.9, 0.0, 0.8, 1.0],
    top_k=[0, 5, 0, 0, 3, 0, 1, 12],
    top_p=[1.0, 1.0, 0.9, 1.0, 0.8, 1.0, 1.0, 0.55],
    min_p=[0.0, 0.0, 0.0, 0.2, 0.05, 0.0, 0.0, 0.0],
    presence_penalty=[0.0, 0.5, 0.0, 1.1, 0.0, 0.0, 0.0, 0.0],
    frequency_penalty=[0.0, 0.0, 0.3, 0.2, 0.0, 0.0, 0.0, 0.0],
    repetition_penalty=[1.0, 1.2, 1.0, 1.05, 1.3, 1.0, 1.0, 1.0],
)
EPILOGUE_LP_TOL = 1e-4


def _topp_margins(torch, logits, samp, counts, seen, bias, slots):
    """Per top-p row, the smallest |exclusive mass - top_p| over its
    tokens, after penalties, temperature, top-k and min-p as the plain
    version applies them (masses summed in f64): a token whose margin is
    within f32 rounding may flip between the kernel and the plain version."""
    out = {}
    for r in range(logits.shape[0]):
        tp = float(samp.top_p[r])
        if tp >= 1.0 or float(samp.temperature[r]) <= 0.0:
            continue
        sl = int(slots[r])
        x = logits[r].float() + bias[sl]
        c, gen = counts[sl], counts[sl] > 0
        rp = samp.repetition_penalty[r]
        x = torch.where(gen | seen[sl], torch.where(x > 0, x / rp, x * rp), x)
        x = x - samp.frequency_penalty[r] * c.float() - samp.presence_penalty[r] * gen.float()
        x = x / torch.clamp(samp.temperature[r], min=1e-6)
        tk = int(samp.top_k[r])
        if tk > 0:
            x = torch.where(x < torch.sort(x, descending=True).values[min(tk, x.numel()) - 1],
                            float("-inf"), x)
        p = torch.softmax(x, -1)
        x = torch.where(p < samp.min_p[r] * p.max(), float("-inf"), x)
        order = torch.flip(torch.argsort(x, stable=True), [0])
        p = torch.softmax(x[order].double(), -1)
        excl = torch.cumsum(p, 0) - p
        out[r] = float((excl[p > 0] - tp).abs().min())
    return out


def _epilogue_cases(torch, dev, V=FLAGSHIP["vocab_size"]):
    """The epilogue kernel at B 8 over V (128,256: Llama-3.2-1B; 102,400:
    DeepSeek-V2-Lite) bf16 logits (normal * 4),
    with unique slots (the count commit in the kernel) and with pad rows
    sharing slot 0 (the commit outside), against its f32 plain version:
    tokens and counts equal in every row, logprobs within 1e-4. Times the
    kernel (by a CUDA graph's replay, and eagerly by CUDA events) and, as
    its plain time, the unfused tail on the same inputs."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.ops import epilogue as ep

    B = len(EPILOGUE_ROWS["temperature"])
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    samp = SamplingParams(**{
        name: torch.tensor(vals, dtype=torch.int64 if name == "top_k"
                           else torch.float32, device=dev)
        for name, vals in EPILOGUE_ROWS.items()})
    u = torch.rand(B, V, generator=g, device=dev).clamp_(min=1e-30)
    gumbel = -torch.log(-torch.log(u))
    cases = {
        "unique_slots": (torch.tensor([3, 0, 5, 1, 6, 2, 4, 7], device=dev),
                         [1, 1, 0, 1, 1, 0, 1, 1], True),
        "pad_rows_on_slot0": (torch.tensor([3, 0, 5, 1, 0, 2, 0, 7], device=dev),
                              [1, 1, 0, 1, 0, 0, 0, 1], False),
    }
    results, timing_inputs = {}, None
    for name, (slots, commit, alias) in cases.items():
        logits = (torch.randn(B, V, generator=g, device=dev) * 4).bfloat16()
        counts = torch.randint(0, 3, (B, V), generator=g, device=dev,
                               dtype=torch.int32)
        seen = torch.randint(0, 2, (B, V), generator=g, device=dev).bool()
        bias = torch.randn(B, V, generator=g, device=dev) * 0.5
        # the tie row: 10 tokens tied at the top (the top-p 0.55 cut falls
        # inside them: 6 stay, by index), 5 tied at the top-k 12 cut, the
        # rest far below; no penalty state on its slot
        tie = torch.randperm(V, generator=g, device=dev)[:15]
        row = torch.full((V,), -20.0, device=dev)
        row[tie[:10]], row[tie[10:]] = 8.0, 6.0
        logits[B - 1] = row.bfloat16()
        ts = int(slots[B - 1])
        counts[ts], seen[ts], bias[ts] = 0, False, 0.0
        com = torch.tensor(commit, device=dev).bool()
        c_ker, c_ref = counts.clone(), counts.clone()
        tok, lps, _ = ep.fused_sampling_epilogue(logits, gumbel, samp, c_ker, seen,
                                                 bias, slots, com, alias_counts=alias)
        tok_r, lps_r, _ = ep.fused_sampling_epilogue_ref(logits, gumbel, samp, c_ref,
                                                         seen, bias, slots, com)
        torch.cuda.synchronize()
        margins = _topp_margins(torch, logits, samp, counts, seen, bias, slots)
        bad = [r for r in range(B) if int(tok[r]) != int(tok_r[r])]
        if bad:
            raise AssertionError(
                f"epilogue {name}: tokens differ in rows {bad} "
                f"(kernel {tok.tolist()}, plain {tok_r.tolist()}; "
                f"top-p margins {margins})")
        if not torch.equal(c_ker, c_ref):
            raise AssertionError(f"epilogue {name}: committed counts differ")
        lp_err = float((lps - lps_r).abs().max())
        if not lp_err <= EPILOGUE_LP_TOL:
            raise AssertionError(f"epilogue {name}: logprob error {lp_err:.3g}")
        results[name] = dict(tokens=tok.tolist(), logprob_max_err=lp_err,
                             topp_min_margin=margins)
        if alias:
            timing_inputs = (logits, seen, bias, slots, counts)
    logits, seen, bias, slots, counts = timing_inputs
    nocommit = torch.zeros(B, dtype=torch.bool, device=dev)  # counts stay put
    ms = graph_ms(lambda: ep.fused_sampling_epilogue(
        logits, gumbel, samp, counts, seen, bias, slots, nocommit))
    eager_ms = cuda_ms(lambda: ep.fused_sampling_epilogue(
        logits, gumbel, samp, counts, seen, bias, slots, nocommit))
    plain_ms = cuda_ms(lambda: ep.fused_sampling_epilogue_ref(
        logits, gumbel, samp, counts, seen, bias, slots, nocommit))
    # the bytes the function must move: each row's logits (bf16) and its
    # slot's bias, counts and seen rows; gumbel rows of the sampled rows
    sampled = sum(t > 0 for t in EPILOGUE_ROWS["temperature"])
    nbytes = B * V * (2 + 4 + 4 + 1) + sampled * V * 4 + B * (8 + 4)
    # the function's f32 work, ~30 operations per element of a row (bias,
    # penalties, temperature, three softmax passes, masks, the gumbel add)
    flops = B * V * 30.0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    bound, by = max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")
    emit("kernels", kernel="sampling_epilogue",
         shape=dict(B=B, V=V, logits="bf16", rows=EPILOGUE_ROWS),
         cases=results, kernel_ms=ms, kernel_ms_eager=eager_ms,
         plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by=by,
         ctas=B * ep.CLUSTER, cluster_plan=ep.cluster_plan(V))
    torch.cuda.synchronize()
    return dict(name="fused_sampling_epilogue", route="cuda",
                source="dynamo_tpu_torch/csrc/sampling_epilogue.cu",
                replaces="dynamo_tpu/ops/pallas_epilogue.py:281",
                max_abs_err=max(r["logprob_max_err"] for r in results.values()),
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None)


EPILOGUE_MAX_LEN = 2048   # ENGINE's max_model_len: the finish horizon


def _finish_rows(torch, dev, tokens, live, V):
    """The ``finish`` inputs of the epilogue cases, built around the
    ``tokens`` the plain version samples, so that every verdict occurs:

    row 0 a stop id hit at ``gen_n >= min_new``; row 1 the same hit below
    ``min_new`` (no stop); row 2 ``gen_n`` reaching ``max_new``; row 3 at
    the model-len horizon (``pos + 2 == max_model_len``) and row 4 one
    short of it; row 6 dead (its ring and count must not move); rings with
    ``-1`` pads (row 1 all pads but the pushed token). Row r watches a
    matching suffix of length r + 1 and a non-matching one of length 8 - r
    (every length 1-8 both ways); row 1's match is gated by ``min_new``,
    rows 5 and 7 by ``gen_n`` below the sequence's length."""
    from dynamo_tpu_torch.engine.sampling import (
        STOP_ID_WIDTH,
        STOP_SEQ_WIDTH,
        SUFFIX_RING_W,
        stop_seq_hash,
    )

    B = len(tokens)
    rng = np.random.default_rng(SEED + 3)
    ring = rng.integers(0, V, (B, SUFFIX_RING_W)).astype(np.int32)
    ring[0, :20] = -1
    ring[1, :] = -1
    gen = np.array([3, 2, 6, 9, 9, 2, 9, 4], np.int32)
    pos = np.array([40, 41, 42, EPILOGUE_MAX_LEN - 2, EPILOGUE_MAX_LEN - 3,
                    43, 44, 45], np.int32)
    min_new = np.array([0, 5, 0, 0, 0, 0, 0, 0], np.int32)
    max_new = np.array([99, 99, 7, 99, 99, 99, 99, 99], np.int32)
    stop_ids = np.full((B, STOP_ID_WIDTH), -1, np.int32)
    stop_ids[0, :3] = [7, tokens[0], V - 1]
    stop_ids[1, :1] = [tokens[1]]
    stop_ids[6, 15] = tokens[6]
    pushed = np.where(live[:, None], np.concatenate(
        [ring[:, 1:], np.asarray(tokens, np.int32)[:, None]], 1), ring)
    stop_hash = np.zeros((B, STOP_SEQ_WIDTH), np.int64)
    stop_hlen = np.zeros((B, STOP_SEQ_WIDTH), np.int32)
    for r in range(B):
        n = r + 1
        stop_hash[r, 1] = stop_seq_hash(pushed[r, SUFFIX_RING_W - n:])
        stop_hlen[r, 1] = n
        miss = [int(t) + 1 for t in pushed[r, SUFFIX_RING_W - (8 - r):]]
        stop_hash[r, 3] = stop_seq_hash(miss)
        stop_hlen[r, 3] = 8 - r
    return tuple(torch.as_tensor(a, device=dev) for a in (
        gen, pos, min_new, max_new, stop_ids, ring, stop_hash, stop_hlen))


def _epilogue_finish_cases(torch, dev, V=FLAGSHIP["vocab_size"]):
    """The epilogue kernel's ``finish``, ``extra_bias`` and combined forms
    at B 8 over V bf16 logits in the mixed sampling regimes, against the
    plain version on the same inputs: tokens, counts, ``hard``, ``cand``
    and ``ring_new`` exactly equal, logprobs within EPILOGUE_LP_TOL. The
    guided mask lets greedy row 5 choose between two ids and sampled row 2
    (top-p 0.9) among three. Times the combined form (by a CUDA graph's
    replay, and eagerly by CUDA events), its plain version and its byte
    bound."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.ops import epilogue as ep

    B = len(EPILOGUE_ROWS["temperature"])
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    samp = SamplingParams(**{
        name: torch.tensor(vals, dtype=torch.int64 if name == "top_k"
                           else torch.float32, device=dev)
        for name, vals in EPILOGUE_ROWS.items()})
    u = torch.rand(B, V, generator=g, device=dev).clamp_(min=1e-30)
    gumbel = -torch.log(-torch.log(u))
    logits = (torch.randn(B, V, generator=g, device=dev) * 4).bfloat16()
    counts = torch.randint(0, 3, (B, V), generator=g, device=dev, dtype=torch.int32)
    seen = torch.randint(0, 2, (B, V), generator=g, device=dev).bool()
    bias = torch.randn(B, V, generator=g, device=dev) * 0.5
    slots = torch.tensor([3, 0, 5, 1, 6, 2, 4, 7], device=dev)
    live_l = [1, 1, 1, 1, 1, 1, 0, 1]
    live = torch.tensor(live_l, device=dev).bool()
    extra = torch.zeros(B, V, device=dev)
    allowed = {5: [17, V - 2], 2: [5, 1000, V // 2]}
    for r, ids in allowed.items():
        extra[r] = -1e9
        extra[r, ids] = 0.0
    results, timed = {}, None
    for form in ("finish", "extra_bias", "both"):
        eb = extra if form != "finish" else None
        tok0, _, _ = ep.fused_sampling_epilogue_ref(
            logits, gumbel, samp, counts.clone(), seen, bias, slots, live,
            extra_bias=eb)
        fin = (_finish_rows(torch, dev, tok0.tolist(), np.asarray(live_l, bool), V)
               if form != "extra_bias" else None)
        c_ker, c_ref = counts.clone(), counts.clone()
        out = ep.fused_sampling_epilogue(
            logits, gumbel, samp, c_ker, seen, bias, slots, live,
            extra_bias=eb, finish=fin, max_model_len=EPILOGUE_MAX_LEN)
        ref = ep.fused_sampling_epilogue_ref(
            logits, gumbel, samp, c_ref, seen, bias, slots, live,
            extra_bias=eb, finish=fin, max_model_len=EPILOGUE_MAX_LEN)
        torch.cuda.synchronize()
        if len(out) != len(ref):
            raise AssertionError(f"epilogue {form}: {len(out)} outputs")
        if out[0].tolist() != ref[0].tolist():
            raise AssertionError(
                f"epilogue {form}: tokens differ (kernel {out[0].tolist()}, "
                f"plain {ref[0].tolist()})")
        if not torch.equal(c_ker, c_ref):
            raise AssertionError(f"epilogue {form}: committed counts differ")
        dead = slots[~live]
        if not torch.equal(c_ker[dead], counts[dead]):
            raise AssertionError(f"epilogue {form}: a dead row committed a count")
        lp_err = float((out[1] - ref[1]).abs().max())
        if not lp_err <= EPILOGUE_LP_TOL:
            raise AssertionError(f"epilogue {form}: logprob error {lp_err:.3g}")
        rec = dict(tokens=out[0].tolist(), logprob_max_err=lp_err)
        if eb is not None:
            for r, ids in allowed.items():
                if int(out[0][r]) not in ids:
                    raise AssertionError(
                        f"epilogue {form}: guided row {r} took {int(out[0][r])}")
        if fin is not None:
            for name, a, b in zip(("hard", "cand", "ring_new"), out[3:], ref[3:]):
                if not torch.equal(a, b.to(a.dtype)):
                    raise AssertionError(
                        f"epilogue {form}: {name} differs (kernel {a.tolist()}, "
                        f"plain {b.tolist()})")
            if not torch.equal(out[5][~live], fin[5][~live]):
                raise AssertionError(f"epilogue {form}: a dead row's ring moved")
            rec.update(hard=out[3].tolist(), cand=out[4].tolist())
            if form == "finish":
                # the cases are what the docstring says they are
                want_hard = [True, False, True, True, False, False, True, False]
                want_cand = [True, False, True, True, True, False, True, False]
                if rec["hard"] != want_hard or rec["cand"] != want_cand:
                    raise AssertionError(
                        f"epilogue finish: verdicts {rec['hard']} {rec['cand']}, "
                        f"want {want_hard} {want_cand}")
        results[form] = rec
        if form == "both":
            timed = (eb, fin)
    eb, fin = timed
    nocommit = torch.zeros(B, dtype=torch.bool, device=dev)  # state stays put
    ms = graph_ms(lambda: ep.fused_sampling_epilogue(
        logits, gumbel, samp, counts, seen, bias, slots, nocommit,
        extra_bias=eb, finish=fin, max_model_len=EPILOGUE_MAX_LEN))
    eager_ms = cuda_ms(lambda: ep.fused_sampling_epilogue(
        logits, gumbel, samp, counts, seen, bias, slots, nocommit,
        extra_bias=eb, finish=fin, max_model_len=EPILOGUE_MAX_LEN))
    plain_ms = cuda_ms(lambda: ep.fused_sampling_epilogue_ref(
        logits, gumbel, samp, counts, seen, bias, slots, nocommit,
        extra_bias=eb, finish=fin, max_model_len=EPILOGUE_MAX_LEN))
    ms_plain_form = graph_ms(lambda: ep.fused_sampling_epilogue(
        logits, gumbel, samp, counts, seen, bias, slots, nocommit))
    # bytes: the plain form's (logits bf16, the slot's bias, counts and seen
    # rows, the sampled rows' gumbel rows) plus one more [B, V] f32 read for
    # extra_bias and the finish rows in and out
    sampled = sum(t > 0 for t in EPILOGUE_ROWS["temperature"])
    fin_bytes = sum(t.numel() * t.element_size() for t in fin) + B * (1 + 1 + 32 * 4)
    nbytes = (B * V * (2 + 4 + 4 + 1 + 4) + sampled * V * 4 + B * (8 + 4)
              + fin_bytes)
    flops = B * V * 31.0      # the plain form's ~30 per element and the add
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    bound, by = max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")
    emit("kernels", kernel="sampling_epilogue_finish",
         shape=dict(B=B, V=V, logits="bf16", rows=EPILOGUE_ROWS, live=live_l,
                    guided_rows={str(k): v for k, v in allowed.items()},
                    max_model_len=EPILOGUE_MAX_LEN),
         cases=results, kernel_ms=ms, kernel_ms_eager=eager_ms,
         plain_ms=plain_ms, library_ms=None,
         plain_form_kernel_ms=ms_plain_form, bound_ms=bound, bound_by=by,
         ctas=B * ep.CLUSTER)
    torch.cuda.synchronize()
    return dict(name="fused_sampling_epilogue[finish+extra_bias]", route="cuda",
                source="dynamo_tpu_torch/csrc/sampling_epilogue.cu",
                replaces="dynamo_tpu/ops/pallas_epilogue.py:281",
                max_abs_err=max(r["logprob_max_err"] for r in results.values()),
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None)


# ----------------------------------------------------------------- engine


def _requests(rng, vocab=FLAGSHIP["vocab_size"]):
    """Token-id prompts of 100-1500 tokens below ``vocab``. Two share a 256-token prefix
    (the second is served after the first, through the prefix cache); one
    greedy prompt and one seeded-temperature prompt appear twice in the
    same wave, so each twin pair must stream identically."""
    lens = [1500, 100, 730, 1210, 420, 960]
    prompts = [[int(t) for t in rng.integers(0, vocab, n)] for n in lens]
    shared = prompts[2][:256]
    late = shared + [int(t) for t in rng.integers(0, vocab, 300)]
    greedy = dict(temperature=0.0)
    seeded = dict(temperature=0.8, top_p=0.95, top_k=50, seed=1234)
    wave1 = [(prompts[0], greedy), (prompts[0], greedy),      # greedy twins
             (prompts[1], seeded), (prompts[1], seeded),      # seeded twins
             (prompts[2], greedy), (prompts[3], dict(temperature=0.7, seed=7)),
             (prompts[4], greedy), (prompts[5], dict(temperature=1.0, seed=99))]
    wave2 = [(late, greedy)]
    return wave1, wave2


def _spec_requests(rng, vocab=FLAGSHIP["vocab_size"]):
    """Eight greedy requests whose 200-600-token prompts repeat a random
    pattern of 3 to 40 tokens below ``vocab``: the ngram lookup finds
    continuations in them (whether the random-weight model accepts them is
    its own)."""
    out = []
    for n, period in zip((200, 260, 330, 390, 450, 510, 560, 600),
                         (3, 7, 12, 20, 5, 33, 40, 9)):
        pattern = [int(t) for t in rng.integers(0, vocab, period)]
        out.append(((pattern * (n // period + 1))[:n], dict(temperature=0.0)))
    return out


def _last_logits(torch, runner, tokens):
    """The logits after ``tokens`` from one plain forward of the whole
    sequence on blocks 0.. of the runner's cache (run when it is idle),
    through the runner's model family."""
    arch = runner.arch
    cfg = runner.config
    dev = runner.device
    n = len(tokens)
    nb = -(-n // cfg.kv_block_size)
    bt = torch.zeros((1, cfg.blocks_per_seq), dtype=torch.int32, device=dev)
    bt[0, :nb] = torch.arange(nb, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
    with torch.inference_mode():
        hidden, _ = arch.forward(
            runner.params, cfg.model,
            torch.tensor([tokens], dtype=torch.int32, device=dev), pos,
            runner.kv_cache, bt, pos, torch.tensor([n], device=dev).int(),
            return_hidden=True)
        return arch.lm_logits(hidden[:, -1], runner.params, cfg.model)[0].float().cpu()


def _spec_agreement(torch, runner, requests, base, spec):
    """Spec streams against the same requests served without speculation:
    equal, or parted at a near-tie — at the first differing position the
    non-spec logits' top-2 gap is under NEAR_TIE of the row's max |logit|
    (the verify step and single-token decode run different kernels and
    GEMM shapes in bf16). Returns one record per parted stream."""
    parted = []
    for i, ((prompt, _), a, b) in enumerate(zip(requests, base, spec)):
        if a["tokens"] == b["tokens"]:
            continue
        j = next(j for j, (x, y) in enumerate(zip(a["tokens"], b["tokens"]))
                 if x != y)
        lg = _last_logits(torch, runner, prompt + a["tokens"][:j])
        top2 = torch.topk(lg, 2).values
        gap = float(top2[0] - top2[1])
        rel = gap / float(lg.abs().max())
        parted.append(dict(request=i, position=j, top2_gap=gap,
                           gap_over_max_abs_logit=rel))
        if not rel < NEAR_TIE:
            raise AssertionError(
                f"spec stream {i} parts from the non-spec stream at {j} where "
                f"the top-2 gap is {rel:.4g} of the max |logit| (>= {NEAR_TIE})")
    return parted


async def _serve_reqs(engine, reqs):
    """Serve ``reqs`` (dicts: ``prompt``, ``samp``, ``stop`` and optional
    ``eos``) concurrently; returns per request its tokens, finish reason
    and time to the first token. A scheduler loop that died (a check that
    raised inside a dispatch) ends the wait with its exception."""
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(r):
        req = PreprocessedRequest(
            token_ids=r["prompt"], eos_token_ids=r.get("eos") or [],
            stop_conditions=StopConditions(**r["stop"]),
            sampling_options=SamplingOptions(**r["samp"]))
        t0 = time.monotonic()
        ttft, toks, reasons = None, [], []
        async for out in engine.generate(Context(req)):
            if ttft is None and out["token_ids"]:
                ttft = time.monotonic() - t0
            toks.extend(out["token_ids"])
            reasons.append(out.get("finish_reason"))
        return dict(tokens=toks, finish=reasons[-1], ttft_s=ttft)

    serving = asyncio.ensure_future(asyncio.gather(*(one(r) for r in reqs)))
    loop_task = engine.scheduler._task
    await asyncio.wait({serving, loop_task}, return_when=asyncio.FIRST_COMPLETED)
    if not serving.done():
        serving.cancel()
        raise RuntimeError("the scheduler loop ended while requests were "
                           "in flight") from loop_task.exception()
    return serving.result()


async def _serve(engine, batch, new_tokens=None):
    """``batch`` of (prompt, sampling kwargs), ``new_tokens`` each, eos
    ignored."""
    return await _serve_reqs(engine, [
        dict(prompt=p, samp=s, stop=dict(max_tokens=new_tokens or NEW_TOKENS,
                                         ignore_eos=True))
        for p, s in batch])


def _check_logits(torch, cfg, arch, mcfg, device, params, prompt_a, prompt_b,
                  limit=LOGITS_REL_L2):
    """Logits of batched steps on the card (bf16, the kernels) against the
    same forwards on the CPU in f32 through the plain route, from the same
    weights (``params`` on the card; ``arch`` the model family's module,
    ``mcfg`` its config), built as the scheduler builds its steps for the
    engine config ``cfg``:

    1. A's first 64 tokens and all of B as rows of one prefill step at
       bucket 64, padded to 4 rows (pad rows: base 0, ctx 1, table 0);
    2. A's tail at base_pos 64 beside one pad row;
    3. one decode step of both.

    Only the valid positions of the real rows are compared, each relative L2
    error held to ``limit`` (None: reported only). Each side runs on a fresh
    cache of its own."""
    from dynamo_tpu_torch.engine.scheduler import build_prefill_arrays

    bs, w = cfg.kv_block_size, cfg.blocks_per_seq
    na, nb = len(prompt_a), len(prompt_b)
    n_a = -(-(na + 1) // bs)
    blocks_a = list(range(n_a))
    blocks_b = list(range(n_a, n_a + -(-(nb + 1) // bs)))

    from dynamo_tpu_torch.models.quant import QuantizedWeight

    def tree_map(fn, tree):
        return ({k: tree_map(fn, v) for k, v in tree.items()}
                if isinstance(tree, dict) else fn(tree))

    # an int8 leaf goes to the CPU as it is: the f32 forward there computes
    # from the same q and scale
    cpu_params = tree_map(lambda t: t.to("cpu") if isinstance(t, QuantizedWeight)
                          else t.cpu().float(), params)
    dtype = params["embed"].dtype
    caches = {side: arch.init_kv_cache(mcfg, blocks_b[-1] + 1, bs, dt, dev)
              for side, dt, dev in (("card", dtype, device),
                                    ("cpu", torch.float32, "cpu"))}

    def pad_row(bucket):
        return (np.zeros((1, bucket), np.int32), np.zeros((1, bucket), np.int32),
                np.zeros((1, w), np.int32), np.full((1, bucket), -1, np.int32),
                np.ones(1, np.int32), np.zeros(1, np.int32))

    def prefill_step(parts, n_rows, bucket=64):
        rows = [build_prefill_arrays(cfg, p[:end], start, blocks, bucket=bucket)
                for p, start, end, blocks in parts]
        rows += [pad_row(bucket)] * (n_rows - len(parts))
        return [np.concatenate(a) for a in zip(*rows)][:5]

    def decode_step(rows):  # [(token, position, blocks)]
        btab = np.zeros((len(rows), w), np.int32)
        slots = np.zeros((len(rows), 1), np.int32)
        for i, (_, pos, blocks) in enumerate(rows):
            btab[i, : len(blocks)] = blocks
            slots[i] = blocks[pos // bs] * bs + pos % bs
        return [np.asarray([[r[0]] for r in rows]),
                np.asarray([[r[1]] for r in rows]), btab, slots,
                np.asarray([r[1] + 1 for r in rows])]

    def forward_both(arrays, valid):  # valid: [(row, n_positions)]
        outs = []
        for side, dev, prm in (("card", device, params), ("cpu", "cpu", cpu_params)):
            t = [torch.as_tensor(np.asarray(a).astype(np.int32), device=dev)
                 for a in arrays]
            with torch.inference_mode():
                logits, _ = arch.forward(prm, mcfg, t[0], t[1], caches[side],
                                         t[2], t[3], t[4])
            logits = logits.float().cpu()
            if not bool(logits.isfinite().all()):
                raise AssertionError(f"non-finite logits on the {side} (pad rows too)")
            outs.append([logits[r, :n] for r, n in valid])
        g, c = (torch.cat(o) for o in outs)
        return float((g - c).norm() / c.norm()), outs[0], outs[1]

    out = {}
    out["prefill_batch_rel_l2"], _, c1 = forward_both(
        prefill_step([(prompt_a, 0, 64, blocks_a), (prompt_b, 0, nb, blocks_b)],
                     4), [(0, 64), (1, nb)])
    out["prefill_base64_rel_l2"], _, c2 = forward_both(
        prefill_step([(prompt_a, 64, na, blocks_a)], 2), [(0, na - 64)])
    nxt = [int(c2[0][-1].argmax()), int(c1[1][-1].argmax())]
    out["decode_rel_l2"], g3, c3 = forward_both(
        decode_step([(nxt[0], na, blocks_a), (nxt[1], nb, blocks_b)]),
        [(0, 1), (1, 1)])
    out["decode_argmax_equal"] = [int(a.argmax()) == int(b.argmax())
                                  for a, b in zip(g3, c3)]
    for key in ("prefill_batch_rel_l2", "prefill_base64_rel_l2", "decode_rel_l2"):
        if limit is not None and not out[key] <= limit:
            raise AssertionError(f"{key} {out[key]:.4g} > {limit}")
    return out


KERNEL_MODULES = ("paged_decode", "paged_flash", "paged_verify", "epilogue",
                  "mla_decode", "sp_prefix")
# the modules whose kernels have an fp8 form (``launches_fp8``)
FP8_MODULES = ("paged_decode", "paged_flash", "paged_verify", "mla_decode",
               "sp_prefix")


def _reset_launches():
    import importlib

    for name in KERNEL_MODULES:
        importlib.import_module(f"dynamo_tpu_torch.ops.{name}").launches = 0
    for name in FP8_MODULES:
        importlib.import_module(f"dynamo_tpu_torch.ops.{name}").launches_fp8 = 0
    epilogue = importlib.import_module("dynamo_tpu_torch.ops.epilogue")
    epilogue.launches_finish = epilogue.launches_extra_bias = 0


def _read_launches():
    """Each kernel module's launch count (of its bf16 form where it has an
    fp8 one), the fp8 forms' as ``<module>_fp8``, and the epilogue's
    ``finish`` and ``extra_bias`` forms' among its own (``epilogue_finish``,
    ``epilogue_extra_bias``)."""
    import importlib

    out = {name: importlib.import_module(f"dynamo_tpu_torch.ops.{name}").launches
           for name in KERNEL_MODULES}
    for name in FP8_MODULES:
        out[f"{name}_fp8"] = importlib.import_module(
            f"dynamo_tpu_torch.ops.{name}").launches_fp8
    epilogue = importlib.import_module("dynamo_tpu_torch.ops.epilogue")
    out["epilogue_finish"] = epilogue.launches_finish
    out["epilogue_extra_bias"] = epilogue.launches_extra_bias
    return out


def _check_streams(results, new_tokens, vocab=FLAGSHIP["vocab_size"]):
    for r in results:
        if len(r["tokens"]) != new_tokens or r["finish"] != "length":
            raise AssertionError(f"bad stream: {len(r['tokens'])} tokens, "
                                 f"finish {r['finish']}")
        if max(r["tokens"]) >= vocab or min(r["tokens"]) < 0:
            raise AssertionError("token id outside the vocabulary")


def _check_launches(path, launches, kernels, layers=FLAGSHIP["num_layers"]):
    """Every named kernel launched on this path; the attention kernels once
    per layer per forward."""
    for name in kernels:
        n = launches[name]
        per_layer = not name.startswith("epilogue")
        if n <= 0 or (per_layer and n % layers):
            raise AssertionError(
                f"{name} launched {n} times on the {path} path (want > 0"
                + (f" and a multiple of {layers})" if per_layer else ")"))


def engine_phase(torch, dev, smi):
    """Serves the smoke workload through ``TorchServingEngine`` in four
    engines on the same seeded weights, each path's kernel launches counted
    from 0 just before its requests and read just after:

    1. the main path (fused epilogue, single-token decode): wave 1, the
       prefix-hit wave 2, the speculative prompts without speculation, and
       the logits check;
    2. ``fused_epilogue="off"``: wave 1 must stream identically;
    3. ``multi_step_decode=4``: wave 1 must stream identically;
    4. ngram speculation (``SPEC``): the speculative prompts, equal to the
       non-spec streams or parted at a printed near-tie."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.models import llama

    def config(**kw):
        return EngineConfig(model=ModelConfig(**FLAGSHIP), seed=SEED,
                            **dict(ENGINE, **kw))

    rng = np.random.default_rng(SEED)
    wave1, wave2 = _requests(rng)
    spec_reqs = _spec_requests(rng)

    async def main_path():
        t0 = time.monotonic()
        engine = await TorchServingEngine.create(config(), device="cuda")
        setup_s = time.monotonic() - t0
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            _reset_launches()
            t1 = time.monotonic()
            res1 = await _serve(engine, wave1)
            wall1 = time.monotonic() - t1
            res2 = await _serve(engine, wave2)
            launches = _read_launches()
            metrics = engine.metrics()
            peak = torch.cuda.max_memory_allocated(dev)
            spec_base = await _serve(engine, spec_reqs, SPEC_NEW_TOKENS)
            logits = _check_logits(
                torch, engine.config, llama, engine.config.model,
                engine.runner.device, engine.runner.params, wave1[4][0][:100],
                wave1[2][0][:40])
            step = _decode_step_profile(torch, engine.runner)
        finally:
            await engine.close()
        return (setup_s, res1, res2, wall1, launches, metrics, peak, logits,
                spec_base, step)

    async def other_path(kw, batch, new_tokens=None, spec_base=None):
        engine = await TorchServingEngine.create(config(**kw), device="cuda")
        try:
            _reset_launches()
            t0 = time.monotonic()
            res = await _serve(engine, batch, new_tokens)
            wall = time.monotonic() - t0
            launches = _read_launches()
            metrics = engine.metrics()
            parted = (None if spec_base is None else
                      _spec_agreement(torch, engine.runner, batch, spec_base, res))
        finally:
            await engine.close()
        torch.cuda.empty_cache()
        return res, wall, launches, metrics, parted

    (setup_s, res1, res2, wall1, launches, metrics, peak, logits,
     spec_base, step) = asyncio.run(main_path())
    torch.cuda.empty_cache()
    _check_streams(res1 + res2, NEW_TOKENS)
    _check_streams(spec_base, SPEC_NEW_TOKENS)
    if res1[0]["tokens"] != res1[1]["tokens"]:
        raise AssertionError("repeated greedy request gave a different stream")
    if res1[2]["tokens"] != res1[3]["tokens"]:
        raise AssertionError("repeated seeded request gave a different stream")
    _check_launches("main", launches, ("paged_decode", "paged_flash", "epilogue"))
    if metrics["gpu_prefix_cache_hit_rate"] <= 0:
        raise AssertionError("the shared-prefix request missed the prefix cache")
    tokens1 = [r["tokens"] for r in res1]

    res_off, _, launches_off, _, _ = asyncio.run(
        other_path(dict(fused_epilogue="off"), wave1))
    if [r["tokens"] for r in res_off] != tokens1:
        raise AssertionError("fused_epilogue='off' streams differ from the "
                             "epilogue kernel's")
    if launches_off["epilogue"]:
        raise AssertionError("fused_epilogue='off' launched the epilogue kernel")

    res_k4, wall_k4, launches_k4, metrics_k4, _ = asyncio.run(
        other_path(dict(multi_step_decode=4), wave1))
    _check_streams(res_k4, NEW_TOKENS)
    if [r["tokens"] for r in res_k4] != tokens1:
        raise AssertionError("multi_step_decode=4 streams differ from K=1")
    _check_launches("burst", launches_k4, ("paged_decode", "epilogue"))

    res_spec, wall_spec, launches_spec, metrics_spec, parted = asyncio.run(
        other_path(SPEC, spec_reqs, SPEC_NEW_TOKENS, spec_base))
    _check_streams(res_spec, SPEC_NEW_TOKENS)
    _check_launches("spec", launches_spec, ("paged_verify",))
    if metrics_spec["spec_proposed_tokens"] <= 0:
        raise AssertionError("ngram speculation proposed nothing")

    ttfts = sorted(r["ttft_s"] for r in res1)
    emit("engine", model="Llama-3.2-1B shapes, seeded random bf16 weights",
         config={k: v for k, v in ENGINE.items()}, requests=len(res1) + len(res2),
         new_tokens=NEW_TOKENS, setup_s=setup_s,
         wave1_prompt_tokens=sum(len(p) for p, _ in wave1),
         wave1_wall_s=wall1,
         wave1_output_tokens_per_s=len(res1) * NEW_TOKENS / wall1,
         ttft_s=dict(min=ttfts[0], median=ttfts[len(ttfts) // 2],
                     max=ttfts[-1]),
         peak_memory_bytes=peak, launches=launches, metrics=metrics,
         decode_step=step, logits_vs_cpu_f32=logits, card=smi)
    emit("engine_paths",
         unfused=dict(streams_identical=True, launches=launches_off),
         burst=dict(k=4, streams_identical=True, wave1_wall_s=wall_k4,
                    wave1_output_tokens_per_s=len(res_k4) * NEW_TOKENS / wall_k4,
                    decode_steps=metrics_k4["decode_steps"],
                    launches=launches_k4),
         spec=dict(**SPEC, requests=len(spec_reqs), new_tokens=SPEC_NEW_TOKENS,
                   prompt_tokens=sum(len(p) for p, _ in spec_reqs),
                   proposed=metrics_spec["spec_proposed_tokens"],
                   accepted=metrics_spec["spec_accepted_tokens"],
                   decode_steps=metrics_spec["decode_steps"],
                   wall_s=wall_spec, streams_equal=sum(
                       a["tokens"] == b["tokens"]
                       for a, b in zip(spec_base, res_spec)),
                   parted=parted, launches=launches_spec))
    if not (step["decode_kernel_ms"] > 0 and step["epilogue_kernel_ms"] > 0):
        raise AssertionError(f"the profiled decode step shows no decode or "
                             f"epilogue kernel: {step['top_kernels_ms']}")
    return dict(paged_decode=launches["paged_decode"],
                paged_flash=launches["paged_flash"],
                sampling_epilogue=launches["epilogue"],
                paged_verify=launches_spec["paged_verify"])


# the decode loop's phase: dispatch-ahead bursts of 4 steps; guided
# requests choose among these token-id sequences (two share a prefix; each
# is long enough to span more than one burst)
CHAIN = dict(decode_pipeline_depth=2, multi_step_decode=4)
GUIDED_CHOICES = [list(range(1001, 1011)),
                  [1001, 1002, 2000, 2001, 2002, 2003, 2004],
                  list(range(3000, 3009))]


def _chain_prompts(rng):
    return [[int(t) for t in rng.integers(0, FLAGSHIP["vocab_size"], n)]
            for n in (180, 240, 90, 310, 150, 120)]


def _chain_requests(prompts, probe):
    """Greedy requests that end every way the device can end them, built
    around ``probe`` (each prompt's unconstrained greedy stream). Token 0
    of a stream comes from the prefill; with 4-step bursts the bursts hold
    tokens 1-4, 5-8, 9-12, ..."""
    greedy = dict(temperature=0.0)
    guided = dict(temperature=0.0, guided_choice_token_ids=GUIDED_CHOICES)
    # the first token id from position 5 on that the stream has not shown
    # before (a random-weight model repeats itself): the device meets it
    # inside a burst, not the prefill's host check
    fresh = next((j for j in range(5, len(probe[0]))
                  if probe[0][j] not in probe[0][:j]), 9)
    return [
        # a hidden stop id
        dict(prompt=prompts[0], samp=greedy, stop=dict(
            max_tokens=NEW_TOKENS, ignore_eos=True,
            stop_token_ids_hidden=[probe[0][fresh]])),
        # a stop string by its canonical token sequence (tokens 5..7)
        dict(prompt=prompts[1], samp=greedy, stop=dict(
            max_tokens=NEW_TOKENS, ignore_eos=True, stop=["x"],
            stop_token_seqs=[probe[1][5:8]])),
        # max_tokens on a burst boundary (9 = 1 + 2 bursts) and off it
        dict(prompt=prompts[2], samp=greedy,
             stop=dict(max_tokens=9, ignore_eos=True)),
        dict(prompt=prompts[3], samp=greedy,
             stop=dict(max_tokens=11, ignore_eos=True)),
        # two guided requests sharing one choice list (one device table)
        dict(prompt=prompts[4], samp=guided, eos=[2],
             stop=dict(max_tokens=NEW_TOKENS)),
        dict(prompt=prompts[5], samp=guided, eos=[2],
             stop=dict(max_tokens=NEW_TOKENS)),
    ]


def _guard_dispatches(torch, runner, layers, k_steps, on_card=True,
                      attention="paged_decode", sp=False, counter="launches"):
    """Wrap the runner's programs so that each runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync inside a
    dispatch raises), and count, per burst, the epilogue's and the decode
    kernel's launches: a burst must launch the epilogue once a step and
    the decode kernel (``attention``: ``paged_decode``, or ``mla_decode``
    on the MLA path) once a layer a step. Draining a burst (the event
    wait, reading the pinned buffers) is outside the guard. With ``sp``,
    every SP chunk dispatch runs under the guard too, and its start, its
    commit flag and its prefix-kernel and flash-kernel launches are
    recorded (``sp_chunks``). ``on_card`` false (a rehearsal on the CPU,
    where no kernel launches) only counts the calls. ``counter`` names the
    attention module's count to read (``launches_fp8`` on an fp8 path)."""
    import importlib

    from dynamo_tpu_torch.ops import epilogue

    paged_decode = importlib.import_module(f"dynamo_tpu_torch.ops.{attention}")
    stats = dict(decode_burst_chained=0, decode_burst=0, step=0,
                 stage_to_host=0, chained_epilogue_launches=0, bad=[])

    def guard(name, burst):
        fn = getattr(runner, name)

        def wrapped(*args, **kw):
            if not on_card:
                stats[name] += 1
                return fn(*args, **kw)
            prev = torch.cuda.get_sync_debug_mode()
            e0, d0 = epilogue.launches, getattr(paged_decode, counter)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
            stats[name] += 1
            got = (epilogue.launches - e0, getattr(paged_decode, counter) - d0)
            if burst and got != (k_steps, k_steps * layers):
                stats["bad"].append((name, got))
            if name == "decode_burst_chained":
                stats["chained_epilogue_launches"] += got[0]
            return out

        setattr(runner, name, wrapped)

    guard("decode_burst_chained", True)
    guard("decode_burst", True)
    guard("step", False)
    guard("stage_to_host", False)
    if sp:
        from dynamo_tpu_torch.ops import paged_flash, sp_prefix

        stats["sp_chunks"] = []
        chunk = runner.sp_prefill_chunk

        def both(mod):  # the bf16 and the fp8 form's launches
            return mod.launches + mod.launches_fp8

        def sp_wrapped(prompt, start, *args, **kw):
            s0, f0 = both(sp_prefix), both(paged_flash)
            prev = torch.cuda.get_sync_debug_mode() if on_card else None
            if on_card:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = chunk(prompt, start, *args, **kw)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(prev)
            stats["sp_chunks"].append(dict(
                start=start, end=len(prompt), commit=kw.get("commit", False),
                sp_prefix=both(sp_prefix) - s0,
                paged_flash=both(paged_flash) - f0))
            return out

        runner.sp_prefill_chunk = sp_wrapped
    return stats


def engine_chain_phase(torch, dev, smi):
    """The decode loop on Llama-3.2-1B at full width and depth, three
    engines over the same weight tensors, all with 4-step bursts:
    synchronous, dispatch-ahead (``device_finish="off"``) and chained.
    Each serves wave 1 of the engine phase, then the finish requests
    (``_chain_requests``). The numbers are printed before the checks."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine

    layers, k_steps = FLAGSHIP["num_layers"], CHAIN["multi_step_decode"]
    on_card = torch.device(dev).type == "cuda"

    def config(**kw):
        return EngineConfig(model=ModelConfig(**FLAGSHIP), seed=SEED,
                            **dict(ENGINE, **kw))

    rng = np.random.default_rng(SEED)
    wave1, _ = _requests(rng)
    prompts = _chain_prompts(rng)

    async def run(kw, params=None, probe=None, guarded=False):
        engine = await TorchServingEngine.create(config(**kw), params=params,
                                                 device=dev)
        stats = (_guard_dispatches(torch, engine.runner, layers, k_steps,
                                   on_card)
                 if guarded else None)
        try:
            if probe is None:
                probed = await _serve(engine, [(p, dict(temperature=0.0))
                                               for p in prompts])
                probe = [r["tokens"] for r in probed]
            _reset_launches()
            t0 = time.monotonic()
            res1 = await _serve(engine, wave1)
            wall = time.monotonic() - t0
            res2 = await _serve_reqs(engine, _chain_requests(prompts, probe))
            launches = _read_launches()
            out = dict(res1=res1, res2=res2, wall=wall, launches=launches,
                       metrics=engine.metrics(), stats=stats, probe=probe,
                       blocks_in_use=engine.scheduler.allocator.used,
                       params=engine.runner.params)
        finally:
            await engine.close()
        return out

    sync = asyncio.run(run(dict(multi_step_decode=k_steps)))
    params, probe = sync["params"], sync["probe"]
    piped = asyncio.run(run(dict(CHAIN, device_finish="off"), params, probe, True))
    chained = asyncio.run(run(dict(CHAIN), params, probe, True))
    del params
    runs = dict(synchronous=sync, pipelined=piped, chained=chained)
    for r in runs.values():
        del r["params"]
    if on_card:
        torch.cuda.empty_cache()

    def summary(r):
        ttfts = sorted(x["ttft_s"] for x in r["res1"])
        m = r["metrics"]
        return dict(
            wave1_wall_s=r["wall"],
            wave1_output_tokens_per_s=len(r["res1"]) * NEW_TOKENS / r["wall"],
            # from the moment every request of the wave had its first token
            wave1_decode_wall_s=r["wall"] - ttfts[-1],
            ttft_s=dict(min=ttfts[0], median=ttfts[len(ttfts) // 2],
                        max=ttfts[-1]),
            decode_steps=m["decode_steps"],
            decode_pipeline_bursts=m.get("decode_pipeline_bursts"),
            chain_len_max=m["chain_len_max"],
            decode_burst_chain_length=m.get("decode_burst_chain_length"),
            device_finished_rows=m["device_finished_rows"],
            sync_fallback=m["sync_fallback"], launches=r["launches"],
            dispatches=r["stats"], blocks_in_use=r["blocks_in_use"],
            finish_requests=[dict(n=len(x["tokens"]), finish=x["finish"])
                             for x in r["res2"]])

    emit("engine_chain", model="Llama-3.2-1B shapes, seeded random bf16 weights",
         config=dict(ENGINE, **CHAIN), requests=len(wave1) + 6,
         new_tokens=NEW_TOKENS, guided_choices=GUIDED_CHOICES,
         engines={name: summary(r) for name, r in runs.items()}, card=smi)

    _check_streams(sync["res1"], NEW_TOKENS)
    want = [(x["tokens"], x["finish"]) for x in sync["res1"] + sync["res2"]]
    for name in ("pipelined", "chained"):
        r = runs[name]
        got = [(x["tokens"], x["finish"]) for x in r["res1"] + r["res2"]]
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if bad:
            raise AssertionError(
                f"{name} engine: requests {bad} stream differently from the "
                f"synchronous engine ({[got[i] for i in bad]} vs "
                f"{[want[i] for i in bad]})")
        if r["stats"]["bad"]:
            raise AssertionError(
                f"{name} engine: a burst did not launch the epilogue once a "
                f"step and the decode kernel once a layer a step: "
                f"{r['stats']['bad'][:4]}")
        if r["blocks_in_use"]:
            raise AssertionError(f"{name} engine: {r['blocks_in_use']} KV "
                                 "blocks still in use after the run")
        if on_card:
            _check_launches(name, r["launches"],
                            ("paged_decode", "paged_flash", "epilogue"))
    # the finish requests ended as they were built to
    fin = sync["res2"]
    if fin[0]["finish"] != "stop" or fin[0]["tokens"] != probe[0][
            : probe[0].index(fin[0]["tokens"][-1]) + 1]:
        raise AssertionError(f"hidden stop id: {fin[0]}")
    if fin[1]["finish"] != "stop" or fin[1]["tokens"][-3:] != probe[1][5:8]:
        raise AssertionError(f"stop sequence: {fin[1]}")
    if [(len(x["tokens"]), x["finish"]) for x in fin[2:4]] != [
            (9, "length"), (11, "length")]:
        raise AssertionError(f"max_tokens: {fin[2:4]}")
    for x in fin[4:]:
        if x["finish"] != "stop" or x["tokens"] not in GUIDED_CHOICES:
            raise AssertionError(f"guided choice: {x}")
    if piped["stats"]["decode_burst"] < 2 or piped["metrics"]["decode_pipeline_bursts"] < 2:
        raise AssertionError("the dispatch-ahead engine dispatched no bursts")
    m = chained["metrics"]
    if chained["stats"]["decode_burst_chained"] < 2 or m["chain_len_max"] <= 1:
        raise AssertionError(f"the chain never grew past one burst: {m}")
    if m["device_finished_rows"] <= 0:
        raise AssertionError("no row finished on the device")
    return dict(
        sampling_epilogue_finish=chained["stats"]["chained_epilogue_launches"])


# fp8 against bf16 KV, logits of one prompt on the same weights: relative
# L2 error. e4m3 rounds each K and V element to within 2^-4 of itself;
# through 16 layers the logits move by a few percent (the reference
# measured 0.043 on DeepSeek, 0.042 on a GQA trunk,
# dynamo_tpu/engine/model_runner.py:213-221); a K/V page read wrong, or a
# write lost, moves them by O(1)
FP8_LOGITS_REL_L2 = 0.25
# values whose e4m3 bytes the card's write must give as the CPU's: normals,
# subnormals and what rounds into them, +-0, 448-464 (round to 448) and
# past 464 (saturate to +-448)
FP8_WRITE_VALUES = (0.0, -0.0, 2.0 ** -9, -3 * 2.0 ** -9, 2.0 ** -10,
                    1.5 * 2.0 ** -10, 0.3, -1.0625, 17.0, 240.0, 448.0, 460.0,
                    464.0, -464.0, 500.0, -1e4, float("inf"), float("-inf"))


def _cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache)


def _fp8_write_bytes(torch, dev):
    """The e4m3 bytes ``scatter_kv_stacked`` writes for ``FP8_WRITE_VALUES``
    (and seeded normals) in bf16 on ``dev``, as a CPU uint8 tensor."""
    from dynamo_tpu_torch.ops.attention import FP8, alloc_kv_cache, scatter_kv_stacked

    g = torch.Generator().manual_seed(SEED)
    new = (torch.randn(2, 4, 8, 64, generator=g) * 30).bfloat16()
    new.view(-1)[:len(FP8_WRITE_VALUES)] = torch.tensor(FP8_WRITE_VALUES).bfloat16()
    shape = (2, 4, 16, 8, 64)
    k, v = alloc_kv_cache(shape, FP8, dev), alloc_kv_cache(shape, FP8, dev)
    slots = torch.tensor([[0, 5, -1, 17], [63, 64, 33, 2]], device=dev)
    scatter_kv_stacked(k, v, new.to(dev), new.to(dev), slots, 1)
    return k.view(torch.uint8).cpu()


def engine_fp8_phase(torch, dev, smi):
    """Llama-3.2-1B at full width and depth with an fp8 (e4m3) KV cache,
    seeded random bf16 weights, every path's launches counted from 0 just
    before its requests and read just after:

    1. the main path (``kv_cache_dtype="fp8"``, single-token decode): wave
       1 and the prefix-hit wave 2, the spec prompts without speculation and
       the finish requests' probe; the cache's element size and bytes;
    2. a bf16-KV engine on the same weight tensors: its cache's bytes and
       the logits of one prompt, held against the fp8 engine's;
    3. ngram speculation (``SPEC``) over the fp8 cache: verify's fp8 form;
       streams equal the fp8 engine's or part at a printed near-tie;
    4. the chained decode loop (``CHAIN``) over the fp8 cache, every
       dispatch under the sync guard, against a synchronous 4-step-burst
       fp8 engine: wave 1 and the finish requests stream identically.

    The fp8 forms of the decode, flash and verify kernels must launch and
    their bf16 forms must not; no KV block stays in use; the card's e4m3
    writes of a fixed set of values give the CPU's bytes."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine

    layers, k_steps = FLAGSHIP["num_layers"], CHAIN["multi_step_decode"]

    def config(kv="fp8", **kw):
        return EngineConfig(model=ModelConfig(**FLAGSHIP), seed=SEED,
                            kv_cache_dtype=kv, **dict(ENGINE, **kw))

    rng = np.random.default_rng(SEED)
    wave1, wave2 = _requests(rng)
    spec_reqs = _spec_requests(rng)
    prompts = _chain_prompts(rng)
    logit_prompt = wave1[4][0][:100]

    async def main_path():
        t0 = time.monotonic()
        engine = await TorchServingEngine.create(config(), device="cuda")
        setup_s = time.monotonic() - t0
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            _reset_launches()
            t1 = time.monotonic()
            res1 = await _serve(engine, wave1)
            wall1 = time.monotonic() - t1
            res2 = await _serve(engine, wave2)
            launches = _read_launches()
            metrics = engine.metrics()
            peak = torch.cuda.max_memory_allocated(dev)
            spec_base = await _serve(engine, spec_reqs, SPEC_NEW_TOKENS)
            probed = await _serve(engine, [(p, dict(temperature=0.0))
                                           for p in prompts])
            cache = engine.runner.kv_cache
            out = dict(setup_s=setup_s, res1=res1, res2=res2, wall1=wall1,
                       launches=launches, metrics=metrics, peak=peak,
                       spec_base=spec_base,
                       probe=[r["tokens"] for r in probed],
                       element_size=[t.element_size() for t in cache],
                       dtype=[str(t.dtype) for t in cache],
                       cache_bytes=_cache_bytes(cache),
                       blocks_in_use=engine.scheduler.allocator.used,
                       logits=_last_logits(torch, engine.runner, logit_prompt),
                       params=engine.runner.params)
        finally:
            await engine.close()
        return out

    async def bf16_logits(params):
        engine = await TorchServingEngine.create(config(kv="auto"),
                                                 params=params, device="cuda")
        try:
            return (_last_logits(torch, engine.runner, logit_prompt),
                    _cache_bytes(engine.runner.kv_cache),
                    [str(t.dtype) for t in engine.runner.kv_cache])
        finally:
            await engine.close()

    async def path(kw, reqs, params, new_tokens=None, spec_base=None,
                   guarded=False):
        engine = await TorchServingEngine.create(config(**kw), params=params,
                                                 device="cuda")
        stats = (_guard_dispatches(torch, engine.runner, layers, k_steps,
                                   counter="launches_fp8") if guarded else None)
        try:
            _reset_launches()
            t0 = time.monotonic()
            if spec_base is not None:
                res = await _serve(engine, reqs, new_tokens)
            else:
                res = (await _serve(engine, wave1)
                       + await _serve_reqs(engine, reqs))
            wall = time.monotonic() - t0
            launches = _read_launches()
            parted = (None if spec_base is None else
                      _spec_agreement(torch, engine.runner, reqs, spec_base, res))
            metrics = dict(engine.metrics(), dispatches=stats,
                           blocks_in_use=engine.scheduler.allocator.used)
        finally:
            await engine.close()
        torch.cuda.empty_cache()
        return dict(res=res, wall=wall, launches=launches, parted=parted,
                    metrics=metrics)

    main = asyncio.run(main_path())
    params = main.pop("params")
    torch.cuda.empty_cache()
    logits_bf16, bf16_bytes, bf16_dtype = asyncio.run(bf16_logits(params))
    torch.cuda.empty_cache()
    spec = asyncio.run(path(SPEC, spec_reqs, params, SPEC_NEW_TOKENS,
                            main["spec_base"]))
    finish_reqs = _chain_requests(prompts, main["probe"])
    sync = asyncio.run(path(dict(multi_step_decode=k_steps), finish_reqs, params))
    chained = asyncio.run(path(CHAIN, finish_reqs, params, guarded=True))
    del params
    torch.cuda.empty_cache()
    lg8 = main.pop("logits")
    diff = (lg8 - logits_bf16).abs()
    logits = dict(max_abs_diff=float(diff.max()),
                  rel_l2=float((lg8 - logits_bf16).norm() / logits_bf16.norm()),
                  max_abs_logit_bf16=float(logits_bf16.abs().max()),
                  argmax_equal=int(lg8.argmax()) == int(logits_bf16.argmax()),
                  limit_rel_l2=FP8_LOGITS_REL_L2, prompt_tokens=len(logit_prompt))
    writes_card = _fp8_write_bytes(torch, dev)
    writes_cpu = _fp8_write_bytes(torch, "cpu")
    torch.cuda.synchronize()
    ttfts = sorted(r["ttft_s"] for r in main["res1"])

    def chain_summary(r):
        m = r["metrics"]
        return dict(wall_s=r["wall"], launches=r["launches"],
                    **{k: m.get(k) for k in ("decode_steps", "decode_pipeline_bursts",
                                         "chain_len_max", "device_finished_rows",
                                         "sync_fallback", "dispatches",
                                         "blocks_in_use")},
                    finish_requests=[dict(n=len(x["tokens"]), finish=x["finish"])
                                     for x in r["res"][len(wave1):]])

    emit("engine_fp8", model="Llama-3.2-1B shapes, seeded random bf16 weights, "
         "fp8 (e4m3) KV cache", config=dict(ENGINE, kv_cache_dtype="fp8"),
         requests=len(main["res1"]) + len(main["res2"]), new_tokens=NEW_TOKENS,
         setup_s=main["setup_s"],
         wave1_prompt_tokens=sum(len(p) for p, _ in wave1),
         wave1_wall_s=main["wall1"],
         wave1_output_tokens_per_s=len(main["res1"]) * NEW_TOKENS / main["wall1"],
         ttft_s=dict(min=ttfts[0], median=ttfts[len(ttfts) // 2], max=ttfts[-1]),
         peak_memory_bytes=main["peak"], launches=main["launches"],
         metrics=main["metrics"], blocks_in_use=main["blocks_in_use"],
         cache=dict(dtype=main["dtype"], element_size=main["element_size"],
                    bytes=main["cache_bytes"], bf16_engine_bytes=bf16_bytes,
                    bf16_engine_dtype=bf16_dtype),
         logits_vs_bf16_kv=logits,
         writes_card_equal_cpu=bool(torch.equal(writes_card, writes_cpu)),
         spec=dict(**SPEC, requests=len(spec_reqs), new_tokens=SPEC_NEW_TOKENS,
                   proposed=spec["metrics"]["spec_proposed_tokens"],
                   accepted=spec["metrics"]["spec_accepted_tokens"],
                   wall_s=spec["wall"], streams_equal=sum(
                       a["tokens"] == b["tokens"]
                       for a, b in zip(main["spec_base"], spec["res"])),
                   parted=spec["parted"], launches=spec["launches"],
                   blocks_in_use=spec["metrics"]["blocks_in_use"]),
         synchronous_k4=chain_summary(sync), chained=chain_summary(chained),
         card=smi)

    _check_streams(main["res1"] + main["res2"], NEW_TOKENS)
    _check_streams(main["spec_base"] + spec["res"], SPEC_NEW_TOKENS)
    res1 = main["res1"]
    if res1[0]["tokens"] != res1[1]["tokens"] or res1[2]["tokens"] != res1[3]["tokens"]:
        raise AssertionError("fp8: repeated requests in one wave streamed differently")
    if main["metrics"]["gpu_prefix_cache_hit_rate"] <= 0:
        raise AssertionError("fp8: the shared-prefix request missed the prefix cache")
    if main["element_size"] != [1, 1] or main["dtype"] != ["torch.float8_e4m3fn"] * 2:
        raise AssertionError(f"fp8: the cache is {main['dtype']}")
    if 2 * main["cache_bytes"] != bf16_bytes:
        raise AssertionError(f"fp8: the cache holds {main['cache_bytes']} bytes, "
                             f"the bf16 engine's {bf16_bytes}")
    if not logits["rel_l2"] <= FP8_LOGITS_REL_L2:
        raise AssertionError(f"fp8: logits {logits}")
    if not torch.equal(writes_card, writes_cpu):
        raise AssertionError("fp8: the card's e4m3 writes differ from the CPU's")
    _check_launches("fp8 main", main["launches"],
                    ("paged_decode_fp8", "paged_flash_fp8", "epilogue"))
    _check_launches("fp8 spec", spec["launches"], ("paged_verify_fp8",))
    if spec["metrics"]["spec_proposed_tokens"] <= 0:
        raise AssertionError("fp8: ngram speculation proposed nothing")
    for name, r in (("main", main), ("spec", spec), ("synchronous", sync),
                    ("chained", chained)):
        bf16 = {k: r["launches"][k] for k in ("paged_decode", "paged_flash",
                                               "paged_verify")}
        if any(bf16.values()):
            raise AssertionError(f"fp8 {name} path launched a bf16 form: {bf16}")
        used = r["blocks_in_use"] if name == "main" else r["metrics"]["blocks_in_use"]
        if used:
            raise AssertionError(f"fp8 {name}: {used} KV blocks still in use")
    _check_streams(sync["res"][:len(wave1)], NEW_TOKENS)
    want = [(x["tokens"], x["finish"]) for x in sync["res"]]
    got = [(x["tokens"], x["finish"]) for x in chained["res"]]
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"fp8: the chained engine's requests {bad} stream "
                             "differently from the synchronous engine's")
    m = chained["metrics"]
    if m["dispatches"]["bad"] or m["chain_len_max"] <= 1 or m["device_finished_rows"] <= 0:
        raise AssertionError(f"fp8 chained engine: {m}")
    _check_launches("fp8 chained", chained["launches"],
                    ("paged_decode_fp8", "paged_flash_fp8", "epilogue"))
    fin = sync["res"][len(wave1):]
    if [x["finish"] for x in fin] != ["stop", "stop", "length", "length", "stop",
                                      "stop"]:
        raise AssertionError(f"fp8: finish requests ended {fin}")
    return dict(paged_decode_fp8=main["launches"]["paged_decode_fp8"],
                paged_flash_fp8=main["launches"]["paged_flash_fp8"],
                paged_verify_fp8=spec["launches"]["paged_verify_fp8"])


def _tree_bytes(tree) -> int:
    """Bytes of a param tree's leaves; an int8 leaf counts its ``q`` (one
    byte a weight) and its f32 ``scale``."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    parts = (tree.q, tree.scale) if hasattr(tree, "scale") else (tree,)
    return sum(t.numel() * t.element_size() for t in parts)


def _busy_us(kernels):
    """Device-busy microseconds: the union of the kernels' intervals."""
    busy, end = 0.0, None
    for s0, e0 in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if end is None or s0 > end:
            busy, end = busy + e0 - s0, e0
        elif e0 > end:
            busy, end = busy + e0 - end, e0
    return busy


def _decode_step_profile(torch, runner, steps=5,
                         ctx=(1, 15, 16, 17, 513, 2048, 700, 1500)):
    """Host-clock time of inert single-token decode steps at the engine's
    batch (8 rows at ``ctx``, by default the decode phase's contexts, every
    KV slot the drop sentinel), the weight bytes a step must read (every
    parameter but the embedding table, of which it gathers 8 rows), and a
    ``torch.profiler`` trace of 3 more steps: device-busy time (the union of
    kernel intervals), events, the top kernels (summed by their names'
    first 80 characters), and the time and share of the busy time of the
    split-KV decode kernel, the MLA decode kernel and the sampling epilogue
    kernel (and the flash kernel's time, 0 in a decode step), and the time
    of PyTorch's copy kernels (``direct_copy_kernel_cuda``: dtype
    conversions and copies; an int8 trunk's dequantisation runs there)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = runner.config
    b, w = cfg.max_batch_size, cfg.blocks_per_seq
    ctx = np.asarray(list(ctx)[:b], np.int32)
    bt = np.arange(b * w, dtype=np.int32).reshape(b, w) % cfg.num_kv_blocks
    z = np.zeros((b, 1), np.int32)
    args = (z, (ctx - 1)[:, None], bt, np.full((b, 1), -1, np.int32), ctx,
            np.zeros(b, np.int32), np.zeros(b, np.float32), np.zeros(b, np.int32),
            np.ones(b, np.float32))

    def step():
        runner.step(*args, want_top=False)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        traced_s = time.monotonic() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = _busy_us(kernels)
    short = {}
    for k, v in by_name.items():
        short[k[:80]] = short.get(k[:80], 0.0) + v

    def family_us(tag):
        return sum(v for k, v in by_name.items() if tag in k)

    decode_us = family_us("splitkv_kernel")
    flash_us = family_us("paged_flash_tc_kernel")
    mla_us = family_us("mla_decode_kernel")
    epilogue_us = family_us("sampling_epilogue_kernel")
    copy_us = family_us("direct_copy_kernel_cuda")
    weight_bytes = (_tree_bytes(runner.params)
                    - _tree_bytes({"embed": runner.params["embed"]}))
    return dict(
        step_ms=dict(mean=1e3 * float(np.mean(times)), min=1e3 * min(times),
                     max=1e3 * max(times), n=steps),
        weight_bytes=weight_bytes,
        weight_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        traced_steps=3, traced_wall_ms=traced_s * 1e3,
        device_busy_ms=busy / 1e3, device_busy_share=busy / (traced_s * 1e6),
        device_events=len(kernels), decode_kernel_ms=decode_us / 1e3,
        decode_kernel_share_of_busy=decode_us / busy if busy else None,
        flash_kernel_ms=flash_us / 1e3,
        mla_kernel_ms=mla_us / 1e3,
        mla_kernel_share_of_busy=mla_us / busy if busy else None,
        epilogue_kernel_ms=epilogue_us / 1e3,
        epilogue_kernel_share_of_busy=epilogue_us / busy if busy else None,
        copy_kernel_ms=copy_us / 1e3,
        copy_kernel_share_of_busy=copy_us / busy if busy else None,
        top_kernels_ms={k: v / 1e3 for k, v in sorted(
            short.items(), key=lambda kv: -kv[1])[:10]})


def engine_mla_phase(torch, dev, smi):
    """DeepSeek-V2-Lite through ``TorchServingEngine`` at full width, its
    depth cut to ``MLA_LAYERS`` of 27, from ``ModelConfig.from_hf_config``
    of its published config, with
    seeded random bf16 weights and the Llama engines' settings (``ENGINE``):

    1. the main path (fused epilogue, single-token decode): wave 1 and the
       prefix-hit wave 2 with ids below V2-Lite's vocabulary, launches
       counted from 0 just before and read just after; the decode step's
       time and profile; the logits of a prefill and a decode step at full
       width and 2 layers (the dense layer and the first MoE layer of the
       same weights) against the CPU in f32;
    2. ``multi_step_decode=4`` on the same weight tensors: every request of
       wave 1, served again, must stream identically;
    3. the chained decode loop (``CHAIN``) on the same weight tensors, every
       dispatch under the sync guard: wave 1 must stream identically once
       more, with a chain longer than one burst and no block left in use;
    4. an fp8 (e4m3) KV cache on the same weight tensors
       (``kv_cache_dtype="fp8"``): wave 1 and the prefix-hit wave through
       the MLA kernel's fp8 form (its bf16 form and the GQA kernels never
       launch) and the dense S > 1 gather over e4m3 pages; streams of their
       length, half the bf16 cache's bytes, no block left in use.

    The numbers are printed before the checks run."""
    import dataclasses

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.models import deepseek

    mcfg = dataclasses.replace(ModelConfig.from_hf_config(V2_LITE),
                               num_layers=MLA_LAYERS)
    vocab = mcfg.vocab_size
    layers = mcfg.num_layers

    def config(**kw):
        return EngineConfig(model=mcfg, seed=SEED, **dict(ENGINE, **kw))

    wave1, wave2 = _requests(np.random.default_rng(SEED), vocab)

    async def main_path():
        t0 = time.monotonic()
        engine = await TorchServingEngine.create(config(), device="cuda")
        setup_s = time.monotonic() - t0
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            _reset_launches()
            t1 = time.monotonic()
            res1 = await _serve(engine, wave1)
            wall1 = time.monotonic() - t1
            res2 = await _serve(engine, wave2)
            launches = _read_launches()
            metrics = engine.metrics()
            peak = torch.cuda.max_memory_allocated(dev)
            step = _decode_step_profile(torch, engine.runner)
            params = engine.runner.params
            two = dataclasses.replace(mcfg, num_layers=2)   # 1 dense + 1 MoE
            params2 = dict(params, layers={k: v[:1] for k, v in
                                           params["layers"].items()})
            logits = _check_logits(torch, engine.config, deepseek, two,
                                   engine.runner.device, params2,
                                   wave1[4][0][:100], wave1[2][0][:40])
        finally:
            await engine.close()
        return (setup_s, res1, res2, wall1, launches, metrics, peak, step,
                logits, params)

    async def burst_path(params, guarded=False, **kw):
        engine = await TorchServingEngine.create(
            config(multi_step_decode=4, **kw), params=params, device="cuda")
        stats = (_guard_dispatches(torch, engine.runner, layers, 4,
                                   attention="mla_decode") if guarded else None)
        try:
            _reset_launches()
            t0 = time.monotonic()
            res = await _serve(engine, wave1)
            wall = time.monotonic() - t0
            launches = _read_launches()
            metrics = dict(engine.metrics(), dispatches=stats,
                           blocks_in_use=engine.scheduler.allocator.used)
        finally:
            await engine.close()
        return res, wall, launches, metrics

    async def fp8_path(params):
        engine = await TorchServingEngine.create(
            config(kv_cache_dtype="fp8"), params=params, device="cuda")
        try:
            _reset_launches()
            t0 = time.monotonic()
            res = await _serve(engine, wave1)
            wall = time.monotonic() - t0
            res_b = await _serve(engine, wave2)
            launches = _read_launches()
            cache = engine.runner.kv_cache
            out = dict(res=res, res2=res_b, wall=wall, launches=launches,
                       metrics=engine.metrics(),
                       blocks_in_use=engine.scheduler.allocator.used,
                       dtype=[str(t.dtype) for t in cache],
                       cache_bytes=_cache_bytes(cache))
        finally:
            await engine.close()
        return out

    (setup_s, res1, res2, wall1, launches, metrics, peak, step, logits,
     params) = asyncio.run(main_path())
    torch.cuda.empty_cache()
    res_k4, wall_k4, launches_k4, metrics_k4 = asyncio.run(burst_path(params))
    torch.cuda.empty_cache()
    res_ch, wall_ch, launches_ch, metrics_ch = asyncio.run(
        burst_path(params, guarded=True, decode_pipeline_depth=2))
    torch.cuda.empty_cache()
    fp8 = asyncio.run(fp8_path(params))
    del params
    torch.cuda.empty_cache()
    # the bf16 engines' cache, from the config's shapes (deepseek.init_kv_cache)
    fp8["bf16_cache_bytes"] = (2 * layers * ENGINE["num_kv_blocks"]
                               * ENGINE["kv_block_size"]
                               * (mcfg.kv_lora_rank + mcfg.qk_rope_head_dim))

    def parts_at(a, b):
        return next((i for i, (x, y) in enumerate(zip(a["tokens"], b["tokens"]))
                     if x != y), None)

    ttfts = sorted(r["ttft_s"] for r in res1)
    emit("engine_mla", model="DeepSeek-V2-Lite (published config.json), seeded "
         "random bf16 weights", layers=layers, vocab=vocab,
         config={k: v for k, v in ENGINE.items()},
         requests=len(res1) + len(res2), new_tokens=NEW_TOKENS, setup_s=setup_s,
         wave1_prompt_tokens=sum(len(p) for p, _ in wave1),
         wave1_wall_s=wall1,
         wave1_output_tokens_per_s=len(res1) * NEW_TOKENS / wall1,
         ttft_s=dict(min=ttfts[0], median=ttfts[len(ttfts) // 2], max=ttfts[-1]),
         peak_memory_bytes=peak, launches=launches, metrics=metrics,
         twins_part_at=dict(greedy=parts_at(res1[0], res1[1]),
                            seeded=parts_at(res1[2], res1[3])),
         decode_step=step, logits_vs_cpu_f32_2_layers=logits,
         burst=dict(k=4, streams_equal=sum(a["tokens"] == b["tokens"]
                                           for a, b in zip(res1, res_k4)),
                    wave1_wall_s=wall_k4,
                    wave1_output_tokens_per_s=len(res_k4) * NEW_TOKENS / wall_k4,
                    decode_steps=metrics_k4["decode_steps"], launches=launches_k4),
         chained=dict(k=4, streams_equal=sum(a["tokens"] == b["tokens"]
                                             for a, b in zip(res1, res_ch)),
                      wave1_wall_s=wall_ch,
                      wave1_output_tokens_per_s=len(res_ch) * NEW_TOKENS / wall_ch,
                      **{k: metrics_ch[k] for k in (
                          "decode_steps", "decode_pipeline_bursts", "chain_len_max",
                          "device_finished_rows", "sync_fallback", "dispatches",
                          "blocks_in_use")},
                      launches=launches_ch),
         fp8=dict(kv_cache_dtype="fp8", dtype=fp8["dtype"],
                  cache_bytes=fp8["cache_bytes"],
                  bf16_cache_bytes=fp8["bf16_cache_bytes"],
                  wave1_wall_s=fp8["wall"],
                  wave1_output_tokens_per_s=len(fp8["res"]) * NEW_TOKENS / fp8["wall"],
                  streams_equal_bf16=sum(a["tokens"] == b["tokens"]
                                         for a, b in zip(res1, fp8["res"])),
                  decode_steps=fp8["metrics"]["decode_steps"],
                  prefix_hit_rate=fp8["metrics"]["gpu_prefix_cache_hit_rate"],
                  blocks_in_use=fp8["blocks_in_use"], launches=fp8["launches"]),
         card=smi)

    _check_streams(fp8["res"] + fp8["res2"], NEW_TOKENS, vocab)
    _check_launches("mla fp8", fp8["launches"], ("mla_decode_fp8", "epilogue"),
                    layers)
    if any(fp8["launches"][k] for k in ("mla_decode", "paged_decode",
                                        "paged_flash", "paged_verify",
                                        "paged_decode_fp8", "paged_flash_fp8",
                                        "paged_verify_fp8")):
        raise AssertionError(f"the MLA fp8 path launched another attention "
                             f"form: {fp8['launches']}")
    if (fp8["dtype"] != ["torch.float8_e4m3fn"] * 2
            or 2 * fp8["cache_bytes"] != fp8["bf16_cache_bytes"]):
        raise AssertionError(f"MLA fp8 cache: {fp8['dtype']}, "
                             f"{fp8['cache_bytes']} bytes")
    if fp8["blocks_in_use"] or fp8["metrics"]["gpu_prefix_cache_hit_rate"] <= 0:
        raise AssertionError(f"MLA fp8 engine: {fp8['blocks_in_use']} blocks in "
                             f"use, metrics {fp8['metrics']}")
    _check_streams(res1 + res2, NEW_TOKENS, vocab)
    _check_streams(res_k4, NEW_TOKENS, vocab)
    # twins in one wave may part: at a decode batch of 8 rows each expert
    # holds one token (capacity int(8 * 6 * 2 / 64) = 1, the reference's
    # routing), so the second twin loses every routed expert its first
    # twin took. Repeated requests are held instead across engines: every
    # request of wave 1, served again by a second engine over the same
    # weight tensors (4-step bursts), must stream identically.
    if [r["tokens"] for r in res_k4] != [r["tokens"] for r in res1]:
        raise AssertionError("MLA: wave 1 on the multi_step_decode=4 engine "
                             "streams differently from the K=1 engine")
    _check_launches("mla main", launches, ("mla_decode", "epilogue"), layers)
    _check_launches("mla burst", launches_k4, ("mla_decode", "epilogue"), layers)
    _check_streams(res_ch, NEW_TOKENS, vocab)
    if [r["tokens"] for r in res_ch] != [r["tokens"] for r in res1]:
        raise AssertionError("MLA: wave 1 on the chained engine streams "
                             "differently from the K=1 engine")
    _check_launches("mla chained", launches_ch, ("mla_decode", "epilogue"), layers)
    if (metrics_ch["dispatches"]["bad"] or metrics_ch["chain_len_max"] <= 1
            or metrics_ch["blocks_in_use"]):
        raise AssertionError(f"MLA chained engine: {metrics_ch}")
    if launches["paged_decode"] or launches["paged_flash"] or launches["paged_verify"]:
        raise AssertionError(f"the MLA path launched a GQA attention kernel: {launches}")
    if metrics["gpu_prefix_cache_hit_rate"] <= 0:
        raise AssertionError("MLA: the shared-prefix request missed the prefix cache")
    if not (step["mla_kernel_ms"] > 0 and step["epilogue_kernel_ms"] > 0):
        raise AssertionError(f"MLA: the profiled decode step shows no MLA or "
                             f"epilogue kernel: {step['top_kernels_ms']}")
    return dict(mla_decode=launches["mla_decode"],
                mla_decode_fp8=fp8["launches"]["mla_decode_fp8"])


# gpt-oss-20b's sinks and biases: the reference inits them to zero, which
# would leave the sink form untested; seeded values of these scales replace
# them before serving (sinks of a few units, as trained models carry)
GPTOSS_NONZERO = dict(sinks=2.0, bq=0.1, bk=0.1, bv=0.1, bo=0.1,
                      router_bias=0.1, b_gate_up=0.1, b_down=0.1)
# The spec and logits comparisons hold two computations of one function
# whose bf16 roundings differ (a verify step's GEMM shapes against a
# decode step's; the card in bf16 against the CPU in f32). Top-4 routing
# is a jump of that function: a rounding flips some tokens' 4th expert
# (12-25% relative L2 of 2-layer logits at hidden 512 on the CPU, 1.4%
# with the routing pinned), and a flip is no near-tie. So those
# comparisons pin the routing (``_pinned_routing``) and run at a capacity
# factor where every expert holds every token of a step, so no token is
# dropped (the reference's own GPT-OSS tests run at 8.0 for that reason).
# The streams of the engine's own routing are held by the K = 4 and chained
# engines, whose steps round exactly as single steps do.
GPTOSS_NO_DROP = 8.0


def _pinned_routing(torch, params):
    """``params`` sharing every tensor but the router: weights 0 and
    distinct biases, so every token takes the same 4 experts (the last
    four) at the same combine weights, whatever the rounding."""
    lay = params["layers"]
    l, e = lay["router_bias"].shape
    bias = torch.linspace(0.0, 3.0, e, device=lay["router_bias"].device)
    return dict(params, layers=dict(
        lay, router=torch.zeros_like(lay["router"]),
        router_bias=bias.to(lay["router_bias"].dtype).expand(l, e)))


def _gptoss_params(torch, mcfg, dev):
    """gpt-oss-20b's weights drawn from the seed on ``dev``, with seeded
    non-zero sinks and biases (``GPTOSS_NONZERO``)."""
    from dynamo_tpu_torch.models import gptoss

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = gptoss.init_params(mcfg, gen, torch.bfloat16, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    for name, scale in GPTOSS_NONZERO.items():
        t = params["layers"][name]
        t.copy_(torch.randn(t.shape, generator=g, device=dev) * scale)
    return params


def engine_gptoss_phase(torch, dev, smi):
    """gpt-oss-20b through ``TorchServingEngine`` at full width, its depth
    cut to ``GPTOSS_LAYERS`` of 24 (20.9 B parameters in full), from ``ModelConfig.from_hf_config`` of
    its published config, with seeded random bf16 weights (sinks and biases
    non-zero) and the engines' settings (``ENGINE``), one set of weight
    tensors behind five engines:

    1. the main path (fused epilogue, single-token decode): wave 1 (prompts
       of 100-1,500 tokens past the 128-token window) and the prefix-hit
       wave 2, launches counted from 0 just before and read just after; a
       profiled decode step; the logits of a batched prefill step and a
       decode step at full width and 2 layers (one sliding, one full)
       against the CPU in f32, with the routing pinned (held) and free
       (reported);
    2. ``multi_step_decode=4``: wave 1 must stream identically;
    3. the chained decode loop (``CHAIN``), every dispatch under the sync
       guard: wave 1 must stream identically, with a chain longer than one
       burst and no block left in use;
    4. and 5. the spec prompts without and with ngram speculation (``SPEC``)
       on the same weights with the routing pinned, at ``GPTOSS_NO_DROP``:
       equal, or parted at a printed near-tie.

    The numbers are printed before the checks run."""
    import dataclasses

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.models import gptoss

    on_card = torch.device(dev).type == "cuda"
    mcfg = dataclasses.replace(ModelConfig.from_hf_config(GPT_OSS_20B),
                               num_layers=GPTOSS_LAYERS)
    vocab, layers = mcfg.vocab_size, mcfg.num_layers
    spec_model = dataclasses.replace(mcfg, moe_capacity_factor=GPTOSS_NO_DROP)

    def config(model=mcfg, **kw):
        return EngineConfig(model=model, seed=SEED, **dict(ENGINE, **kw))

    rng = np.random.default_rng(SEED)
    wave1, wave2 = _requests(rng, vocab)
    spec_reqs = _spec_requests(rng)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = _gptoss_params(torch, mcfg, dev)
    init_s = time.monotonic() - t0
    pinned = _pinned_routing(torch, params)
    n_params = sum(t.numel() for grp in params.values()
                   for t in (grp.values() if isinstance(grp, dict) else [grp]))

    async def main_path():
        t0 = time.monotonic()
        engine = await TorchServingEngine.create(config(), params=params,
                                                 device=dev)
        setup_s = time.monotonic() - t0
        try:
            _reset_launches()
            t1 = time.monotonic()
            res1 = await _serve(engine, wave1)
            wall1 = time.monotonic() - t1
            res2 = await _serve(engine, wave2)
            launches = _read_launches()
            metrics = engine.metrics()
            step = _decode_step_profile(torch, engine.runner) if on_card else None
            # 2 layers (sliding + full) of the same weights, the routing
            # pinned (held) and free (reported)
            two = dataclasses.replace(mcfg, num_layers=2,
                                      moe_capacity_factor=GPTOSS_NO_DROP)
            args = (torch, engine.config, gptoss, two, engine.runner.device)
            prompts = (wave1[4][0][:100], wave1[2][0][:40])
            by_routing = {}
            for name, prm in (("free", params), ("pinned", pinned)):
                lay2 = {k: v[:2] for k, v in prm["layers"].items()}
                by_routing[name] = _check_logits(
                    *args, dict(prm, layers=lay2), *prompts,
                    limit=LOGITS_REL_L2 if name == "pinned" else None)
            logits = dict(by_routing["pinned"], free_routing=by_routing["free"])
        finally:
            await engine.close()
        return setup_s, res1, res2, wall1, launches, metrics, step, logits

    async def other_path(kw, batch, new_tokens=None, model=mcfg, prm=None,
                         guarded=False, spec_base=None):
        engine = await TorchServingEngine.create(config(model, **kw),
                                                 params=prm or params,
                                                 device=dev)
        stats = (_guard_dispatches(torch, engine.runner, layers, 4, on_card)
                 if guarded else None)
        try:
            _reset_launches()
            t0 = time.monotonic()
            res = await _serve(engine, batch, new_tokens)
            wall = time.monotonic() - t0
            launches = _read_launches()
            metrics = dict(engine.metrics(), dispatches=stats,
                           blocks_in_use=engine.scheduler.allocator.used)
            parted = (None if spec_base is None else
                      _spec_agreement(torch, engine.runner, batch, spec_base, res))
        finally:
            await engine.close()
        if on_card:
            torch.cuda.empty_cache()
        return res, wall, launches, metrics, parted

    (setup_s, res1, res2, wall1, launches, metrics, step,
     logits) = asyncio.run(main_path())
    res_k4, wall_k4, launches_k4, metrics_k4, _ = asyncio.run(
        other_path(dict(multi_step_decode=4), wave1))
    res_ch, wall_ch, launches_ch, metrics_ch, _ = asyncio.run(
        other_path(CHAIN, wave1, guarded=True))
    spec_base, _, _, _, _ = asyncio.run(
        other_path({}, spec_reqs, SPEC_NEW_TOKENS, spec_model, pinned))
    res_spec, wall_spec, launches_spec, metrics_spec, parted = asyncio.run(
        other_path(SPEC, spec_reqs, SPEC_NEW_TOKENS, spec_model, pinned,
                   spec_base=spec_base))
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    del params, pinned
    if on_card:
        torch.cuda.empty_cache()

    def parts_at(a, b):
        return next((i for i, (x, y) in enumerate(zip(a["tokens"], b["tokens"]))
                     if x != y), None)

    ttfts = sorted(r["ttft_s"] for r in res1)
    emit("engine_gptoss", model="gpt-oss-20b (published config.json), seeded "
         "random bf16 weights, non-zero sinks and biases", layers=layers,
         vocab=vocab, parameters=n_params, init_s=init_s,
         nonzero=GPTOSS_NONZERO, config={k: v for k, v in ENGINE.items()},
         requests=len(res1) + len(res2), new_tokens=NEW_TOKENS, setup_s=setup_s,
         wave1_prompt_tokens=sum(len(p) for p, _ in wave1), wave1_wall_s=wall1,
         wave1_output_tokens_per_s=len(res1) * NEW_TOKENS / wall1,
         ttft_s=dict(min=ttfts[0], median=ttfts[len(ttfts) // 2], max=ttfts[-1]),
         finishes=sorted({(len(r["tokens"]), r["finish"]) for r in res1 + res2}),
         peak_memory_bytes=peak, launches=launches, metrics=metrics,
         twins_part_at=dict(greedy=parts_at(res1[0], res1[1]),
                            seeded=parts_at(res1[2], res1[3])),
         decode_step=step, logits_vs_cpu_f32_2_layers=logits,
         burst=dict(k=4, streams_equal=sum(a["tokens"] == b["tokens"]
                                           for a, b in zip(res1, res_k4)),
                    wave1_wall_s=wall_k4,
                    wave1_output_tokens_per_s=len(res_k4) * NEW_TOKENS / wall_k4,
                    decode_steps=metrics_k4["decode_steps"], launches=launches_k4),
         chained=dict(k=4, streams_equal=sum(a["tokens"] == b["tokens"]
                                             for a, b in zip(res1, res_ch)),
                      wave1_wall_s=wall_ch,
                      wave1_output_tokens_per_s=len(res_ch) * NEW_TOKENS / wall_ch,
                      **{k: metrics_ch[k] for k in (
                          "decode_steps", "decode_pipeline_bursts", "chain_len_max",
                          "device_finished_rows", "sync_fallback", "dispatches",
                          "blocks_in_use")},
                      launches=launches_ch),
         spec=dict(**SPEC, moe_capacity_factor=GPTOSS_NO_DROP,
                   routing="pinned",
                   requests=len(spec_reqs), new_tokens=SPEC_NEW_TOKENS,
                   proposed=metrics_spec["spec_proposed_tokens"],
                   accepted=metrics_spec["spec_accepted_tokens"],
                   decode_steps=metrics_spec["decode_steps"], wall_s=wall_spec,
                   streams_equal=sum(a["tokens"] == b["tokens"]
                                     for a, b in zip(spec_base, res_spec)),
                   parted=parted, launches=launches_spec),
         card=smi)

    _check_streams(res1 + res2, NEW_TOKENS, vocab)
    _check_streams(res_k4 + res_ch, NEW_TOKENS, vocab)
    _check_streams(spec_base + res_spec, SPEC_NEW_TOKENS, vocab)
    # twins in one wave may part (an expert holds int(8 * 4 * 2 / 32) = 2
    # tokens of a decode step, the reference's routing); repeated requests
    # are held across engines over the same weight tensors instead
    tokens1 = [r["tokens"] for r in res1]
    if [r["tokens"] for r in res_k4] != tokens1:
        raise AssertionError("gpt-oss: wave 1 on the multi_step_decode=4 "
                             "engine streams differently from the K=1 engine")
    if [r["tokens"] for r in res_ch] != tokens1:
        raise AssertionError("gpt-oss: wave 1 on the chained engine streams "
                             "differently from the K=1 engine")
    if (metrics_ch["dispatches"]["bad"] or metrics_ch["chain_len_max"] <= 1
            or metrics_ch["blocks_in_use"]):
        raise AssertionError(f"gpt-oss chained engine: {metrics_ch}")
    if metrics["gpu_prefix_cache_hit_rate"] <= 0:
        raise AssertionError("gpt-oss: the shared-prefix request missed the "
                             "prefix cache")
    if metrics_spec["spec_proposed_tokens"] <= 0:
        raise AssertionError("gpt-oss: ngram speculation proposed nothing")
    if on_card:
        _check_launches("gpt-oss main", launches,
                        ("paged_decode", "paged_flash", "epilogue"), layers)
        _check_launches("gpt-oss burst", launches_k4,
                        ("paged_decode", "epilogue"), layers)
        _check_launches("gpt-oss chained", launches_ch,
                        ("paged_decode", "epilogue"), layers)
        _check_launches("gpt-oss spec", launches_spec, ("paged_verify",), layers)
        if launches["mla_decode"] or launches["sp_prefix"]:
            raise AssertionError(f"the gpt-oss path launched a foreign kernel: "
                                 f"{launches}")
        if not (step["decode_kernel_ms"] > 0 and step["epilogue_kernel_ms"] > 0):
            raise AssertionError(f"gpt-oss: the profiled decode step shows no "
                                 f"decode or epilogue kernel: "
                                 f"{step['top_kernels_ms']}")
    return dict(paged_decode_sinks=launches["paged_decode"],
                paged_flash_sinks=launches["paged_flash"],
                sampling_epilogue_gptoss=launches["epilogue"],
                sampling_epilogue_finish_gptoss=launches_ch["epilogue"],
                paged_verify_sinks=launches_spec["paged_verify"])


# gemma-2-9b's engines: its 8,192 positions, the KV cache sized to the
# wave (336 KB of KV a token over 42 layers: 2,560 blocks of 16 tokens hold
# 40,960 tokens in 14.1 GB)
GEMMA_ENGINE = dict(max_model_len=8192, num_kv_blocks=2560)
# a depth cut that keeps the whole script inside its time limit (of 42
# layers, sliding and global alternating); the widths stay the published
# ones
GEMMA_LAYERS = 14
# the five norms the reference inits to 0 (its 1 + w form, so zeros would
# leave the weights untested): drawn N(0, 0.1^2)
GEMMA_NORMS = ("ln1", "ln_post_attn", "ln_pre_mlp", "ln_post_mlp")
GEMMA_NORM_SCALE = 0.1
# wave 1's last request: a prompt past the 4,096-token window
GEMMA_LONG_PROMPT = 5000
# the decode step's rows: both sides of the window, a full 8,192-key row
GEMMA_DECODE_CTX = (1, 15, 16, 17, 513, 4097, 5000, 8192)
# the long prompt's window must move its 2-layer logits this many times
# further than the card's rounding moves them from the f32 forward
GEMMA_WINDOW_MARGIN = 3.0
# spec prompts whose ngram drafts the model rejects (``_spec_traps``): the
# random trunk's greedy streams fall into cycles the lookup predicts exactly
GEMMA_SPEC_TRAPS = 2


def _gemma2_params(torch, mcfg, dev):
    """gemma-2-9b's weights drawn from the seed on ``dev``, every norm
    N(0, ``GEMMA_NORM_SCALE``^2)."""
    from dynamo_tpu_torch.models import gemma2

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = gemma2.init_params(mcfg, gen, torch.bfloat16, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    for t in [params["layers"][n] for n in GEMMA_NORMS] + [params["final_norm"]]:
        t.copy_(torch.randn(t.shape, generator=g, device=dev) * GEMMA_NORM_SCALE)
    return params


def _prompt_logits(torch, arch, mcfg, params, prompt, device, dtype,
                   chunk=512):
    """The last position's logits of ``prompt`` [V] (f32, on the CPU): the
    prompt through ``arch.forward`` in chunks of ``chunk`` tokens (the
    engine's prefill step: the flash kernel on a card) over a fresh cache
    on ``device``, whose block ``i`` holds positions 16 i .. 16 i + 15."""
    bs = 16
    n = len(prompt)
    nb = -(-n // bs)
    cache = arch.init_kv_cache(mcfg, nb, bs, dtype, device)
    bt = torch.arange(nb, dtype=torch.int32, device=device)[None]
    toks = torch.tensor([prompt], dtype=torch.int32, device=device)
    with torch.inference_mode():
        for start in range(0, n, chunk):
            end = min(n, start + chunk)
            pos = torch.arange(start, end, dtype=torch.int32, device=device)[None]
            hidden, cache = arch.forward(
                params, mcfg, toks[:, start:end], pos, cache, bt, pos,
                torch.tensor([end], dtype=torch.int32, device=device),
                return_hidden=True)
        return arch.lm_logits(hidden[:, -1], params, mcfg)[0].float().cpu()


def _spec_traps(torch, arch, mcfg, params, device, n=GEMMA_SPEC_TRAPS,
                tries=8):
    """Greedy requests whose ngram drafts the model contradicts, so the
    spec engine's verify rejects and rolls back. Each prompt is random
    tokens ending in (u, v), with earlier plants (u, v, t, r1..r4) for
    each greedy token t the model has given after the prompt (a forward
    through ``_prompt_logits``), planted again until the model's token is
    one of them: after it the lookup proposes that plant's random r1..r4.
    Raises if no plant holds within ``tries`` forwards."""
    rng = np.random.default_rng(SEED + 11)
    vocab = mcfg.vocab_size
    out = []
    for _ in range(n):
        body = [int(t) for t in rng.integers(0, vocab, 300)]
        tail = [int(t) for t in rng.integers(0, vocab, 2)]
        plants = {}
        for _ in range(tries):
            prompt = (body[:100] + [x for p in plants.values() for x in p]
                      + body[100:] + tail)
            t = int(_prompt_logits(torch, arch, mcfg, params, prompt, device,
                                   params["embed"].dtype).argmax())
            if t in plants:
                out.append((prompt, dict(temperature=0.0)))
                break
            plants[t] = tail + [t] + [int(x) for x in rng.integers(0, vocab, 4)]
        else:
            raise AssertionError(f"gemma-2 spec trap: no plant held in {tries} "
                                 f"forwards: {list(plants)}")
    return out


def _window_logits(torch, arch, mcfg, params, prompt, device):
    """The ``GEMMA_LONG_PROMPT`` check at 2 layers (one windowed, one
    full): the last position's logits on the card (bf16, the flash kernel)
    against the CPU's f32 forward of the same weights, and against the card
    with the window off. Returns both relative L2 distances."""
    import dataclasses

    two = dataclasses.replace(mcfg, num_layers=2)
    p2 = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    cpu2 = {k: ({n: t.cpu().float() for n, t in v.items()}
                if isinstance(v, dict) else v.cpu().float())
            for k, v in p2.items()}
    dt = params["embed"].dtype
    card = _prompt_logits(torch, arch, two, p2, prompt, device, dt)
    cpu = _prompt_logits(torch, arch, two, cpu2, prompt, "cpu", torch.float32)
    del cpu2
    no_window = _prompt_logits(
        torch, arch, dataclasses.replace(two, sliding_window=0), p2, prompt,
        device, dt)
    return dict(prompt_tokens=len(prompt), window=mcfg.sliding_window,
                card_vs_cpu_f32_rel_l2=float((card - cpu).norm() / cpu.norm()),
                window_off_vs_on_rel_l2=float((no_window - card).norm()
                                              / card.norm()),
                argmax_equal=int(card.argmax()) == int(cpu.argmax()))


def engine_gemma2_phase(torch, dev, smi):
    """gemma-2-9b through ``TorchServingEngine`` at full width, its depth
    cut to ``GEMMA_LAYERS`` of 42, from ``ModelConfig.from_hf_config`` of
    its published config, with seeded random bf16 weights (every norm
    non-zero), the engines' settings (``ENGINE``) at its 8,192 positions
    (``GEMMA_ENGINE``), one set of weight tensors behind five engines:

    1. the main path (fused epilogue, single-token decode): wave 1 (its last
       prompt of ``GEMMA_LONG_PROMPT`` tokens, past the window) and the
       prefix-hit wave 2, launches counted from 0 just before and read just
       after; a profiled decode step; the logits of a batched prefill step
       and a decode step at full width and 2 layers (one windowed, one
       full) against the CPU in f32, and the long prompt's last logits
       against the CPU and against the card with the window off;
    2. ``multi_step_decode=4``: wave 1 must stream identically;
    3. the chained decode loop (``CHAIN``), every dispatch under the sync
       guard: wave 1 must stream identically, with a chain longer than one
       burst and no block left in use;
    4. and 5. the spec prompts, the last ``GEMMA_SPEC_TRAPS`` of them
       replaced by ``_spec_traps``, without and with ngram speculation
       (``SPEC``): equal, or parted at a printed near-tie, with at least
       one proposal rejected.

    The numbers are printed before the checks run."""
    import dataclasses

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.models import gemma2

    on_card = torch.device(dev).type == "cuda"
    mcfg = dataclasses.replace(ModelConfig.from_hf_config(GEMMA_2_9B),
                               num_layers=GEMMA_LAYERS)
    vocab, layers = mcfg.vocab_size, mcfg.num_layers

    def config(**kw):
        return EngineConfig(model=mcfg, seed=SEED,
                            **dict(ENGINE, **GEMMA_ENGINE, **kw))

    rng = np.random.default_rng(SEED)
    wave1, wave2 = _requests(rng, vocab)
    long_prompt = [int(t) for t in rng.integers(0, vocab, GEMMA_LONG_PROMPT)]
    wave1[-1] = (long_prompt, wave1[-1][1])
    spec_reqs = _spec_requests(rng)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = _gemma2_params(torch, mcfg, dev)
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for grp in params.values()
                   for t in (grp.values() if isinstance(grp, dict) else [grp]))
    embed_bytes = params["embed"].numel() * params["embed"].element_size()

    async def main_path():
        t0 = time.monotonic()
        engine = await TorchServingEngine.create(config(), params=params,
                                                 device=dev)
        setup_s = time.monotonic() - t0
        try:
            _reset_launches()
            t1 = time.monotonic()
            res1 = await _serve(engine, wave1)
            wall1 = time.monotonic() - t1
            res2 = await _serve(engine, wave2)
            launches = _read_launches()
            metrics = engine.metrics()
            step = (_decode_step_profile(torch, engine.runner,
                                         ctx=GEMMA_DECODE_CTX)
                    if on_card else None)
            two = dataclasses.replace(mcfg, num_layers=2)
            lay2 = {k: v[:2] for k, v in params["layers"].items()}
            logits = _check_logits(
                torch, engine.config, gemma2, two, engine.runner.device,
                dict(params, layers=lay2), wave1[4][0][:100], wave1[2][0][:40])
            logits["long_prompt"] = _window_logits(
                torch, gemma2, mcfg, params, long_prompt, engine.runner.device)
        finally:
            await engine.close()
        return setup_s, res1, res2, wall1, launches, metrics, step, logits

    async def other_path(kw, batch, new_tokens=None, guarded=False,
                         spec_base=None):
        gc.collect()  # the engine before frees its 14.1 GB cache first
        engine = await TorchServingEngine.create(config(**kw), params=params,
                                                 device=dev)
        stats = (_guard_dispatches(torch, engine.runner, layers, 4, on_card)
                 if guarded else None)
        try:
            _reset_launches()
            t0 = time.monotonic()
            res = await _serve(engine, batch, new_tokens)
            wall = time.monotonic() - t0
            launches = _read_launches()
            metrics = dict(engine.metrics(), dispatches=stats,
                           blocks_in_use=engine.scheduler.allocator.used)
            parted = (None if spec_base is None else
                      _spec_agreement(torch, engine.runner, batch, spec_base, res))
        finally:
            await engine.close()
        if on_card:
            torch.cuda.empty_cache()
        return res, wall, launches, metrics, parted

    (setup_s, res1, res2, wall1, launches, metrics, step,
     logits) = asyncio.run(main_path())
    res_k4, wall_k4, launches_k4, metrics_k4, _ = asyncio.run(
        other_path(dict(multi_step_decode=4), wave1))
    res_ch, wall_ch, launches_ch, metrics_ch, _ = asyncio.run(
        other_path(CHAIN, wave1, guarded=True))
    gc.collect()
    # the traps take the last pattern prompts' places: a request left
    # waiting for a slot keeps the scheduler from speculating
    spec_reqs = (spec_reqs[:len(spec_reqs) - GEMMA_SPEC_TRAPS]
                 + _spec_traps(torch, gemma2, mcfg, params, dev))
    spec_base, _, _, _, _ = asyncio.run(other_path({}, spec_reqs, SPEC_NEW_TOKENS))
    res_spec, wall_spec, launches_spec, metrics_spec, parted = asyncio.run(
        other_path(SPEC, spec_reqs, SPEC_NEW_TOKENS, spec_base=spec_base))
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    del params
    if on_card:
        torch.cuda.empty_cache()
    if step is not None:
        step["weight_bound_ms_with_tied_head"] = (
            (step["weight_bytes"] + embed_bytes) / HBM_BYTES_PER_S * 1e3)

    def parts_at(a, b):
        return next((i for i, (x, y) in enumerate(zip(a["tokens"], b["tokens"]))
                     if x != y), None)

    ttfts = sorted(r["ttft_s"] for r in res1)
    emit("engine_gemma2", model="gemma-2-9b (published config.json), seeded "
         "random bf16 weights, non-zero norms", layers=layers, vocab=vocab,
         parameters=n_params, init_s=init_s, norm_scale=GEMMA_NORM_SCALE,
         config=dict(ENGINE, **GEMMA_ENGINE),
         requests=len(res1) + len(res2), new_tokens=NEW_TOKENS, setup_s=setup_s,
         wave1_prompt_tokens=sum(len(p) for p, _ in wave1), wave1_wall_s=wall1,
         wave1_output_tokens_per_s=len(res1) * NEW_TOKENS / wall1,
         ttft_s=dict(min=ttfts[0], median=ttfts[len(ttfts) // 2], max=ttfts[-1],
                     long_prompt=res1[-1]["ttft_s"]),
         finishes=sorted({(len(r["tokens"]), r["finish"]) for r in res1 + res2}),
         peak_memory_bytes=peak, launches=launches, metrics=metrics,
         twins_part_at=dict(greedy=parts_at(res1[0], res1[1]),
                            seeded=parts_at(res1[2], res1[3])),
         decode_step=step, logits_vs_cpu_f32_2_layers=logits,
         burst=dict(k=4, streams_equal=sum(a["tokens"] == b["tokens"]
                                           for a, b in zip(res1, res_k4)),
                    wave1_wall_s=wall_k4,
                    wave1_output_tokens_per_s=len(res_k4) * NEW_TOKENS / wall_k4,
                    decode_steps=metrics_k4["decode_steps"], launches=launches_k4),
         chained=dict(k=4, streams_equal=sum(a["tokens"] == b["tokens"]
                                             for a, b in zip(res1, res_ch)),
                      wave1_wall_s=wall_ch,
                      wave1_output_tokens_per_s=len(res_ch) * NEW_TOKENS / wall_ch,
                      **{k: metrics_ch[k] for k in (
                          "decode_steps", "decode_pipeline_bursts", "chain_len_max",
                          "device_finished_rows", "sync_fallback", "dispatches",
                          "blocks_in_use")},
                      launches=launches_ch),
         spec=dict(**SPEC, requests=len(spec_reqs), traps=GEMMA_SPEC_TRAPS,
                   new_tokens=SPEC_NEW_TOKENS, proposed=metrics_spec["spec_proposed_tokens"],
                   accepted=metrics_spec["spec_accepted_tokens"],
                   decode_steps=metrics_spec["decode_steps"], wall_s=wall_spec,
                   streams_equal=sum(a["tokens"] == b["tokens"]
                                     for a, b in zip(spec_base, res_spec)),
                   parted=parted, launches=launches_spec),
         card=smi)

    _check_streams(res1 + res2, NEW_TOKENS, vocab)
    _check_streams(res_k4 + res_ch, NEW_TOKENS, vocab)
    _check_streams(spec_base + res_spec, SPEC_NEW_TOKENS, vocab)
    if res1[0]["tokens"] != res1[1]["tokens"]:
        raise AssertionError("gemma-2: the greedy twins streamed differently")
    if res1[2]["tokens"] != res1[3]["tokens"]:
        raise AssertionError("gemma-2: the seeded twins streamed differently")
    tokens1 = [r["tokens"] for r in res1]
    if [r["tokens"] for r in res_k4] != tokens1:
        raise AssertionError("gemma-2: wave 1 on the multi_step_decode=4 "
                             "engine streams differently from the K=1 engine")
    if [r["tokens"] for r in res_ch] != tokens1:
        raise AssertionError("gemma-2: wave 1 on the chained engine streams "
                             "differently from the K=1 engine")
    if (metrics_ch["dispatches"]["bad"] or metrics_ch["chain_len_max"] <= 1
            or metrics_ch["blocks_in_use"]):
        raise AssertionError(f"gemma-2 chained engine: {metrics_ch}")
    if metrics["gpu_prefix_cache_hit_rate"] <= 0:
        raise AssertionError("gemma-2: the shared-prefix request missed the "
                             "prefix cache")
    if metrics_spec["spec_proposed_tokens"] <= 0:
        raise AssertionError("gemma-2: ngram speculation proposed nothing")
    if not metrics_spec["spec_accepted_tokens"] < metrics_spec["spec_proposed_tokens"]:
        raise AssertionError("gemma-2: the spec engine accepted every proposal, "
                             "so verify never rejected a draft")
    lp = logits["long_prompt"]
    if not lp["card_vs_cpu_f32_rel_l2"] <= LOGITS_REL_L2:
        raise AssertionError(f"gemma-2 long prompt: card vs CPU {lp}")
    # the window binds: turning it off moves the logits well past the
    # card's own distance from the f32 forward
    if not lp["window_off_vs_on_rel_l2"] > max(
            GEMMA_WINDOW_MARGIN * lp["card_vs_cpu_f32_rel_l2"], LOGITS_REL_L2):
        raise AssertionError(f"gemma-2 long prompt: the window does not bind {lp}")
    if on_card:
        _check_launches("gemma-2 main", launches,
                        ("paged_decode", "paged_flash", "epilogue"), layers)
        _check_launches("gemma-2 burst", launches_k4,
                        ("paged_decode", "epilogue"), layers)
        _check_launches("gemma-2 chained", launches_ch,
                        ("paged_decode", "epilogue"), layers)
        _check_launches("gemma-2 spec", launches_spec, ("paged_verify",), layers)
        if launches["mla_decode"] or launches["sp_prefix"]:
            raise AssertionError(f"the gemma-2 path launched a foreign kernel: "
                                 f"{launches}")
        if not (step["decode_kernel_ms"] > 0 and step["epilogue_kernel_ms"] > 0):
            raise AssertionError(f"gemma-2: the profiled decode step shows no "
                                 f"decode or epilogue kernel: "
                                 f"{step['top_kernels_ms']}")
    return dict(paged_decode_softcap=launches["paged_decode"],
                paged_flash_softcap=launches["paged_flash"],
                sampling_epilogue_gemma2=launches["epilogue"],
                sampling_epilogue_finish_gemma2=launches_ch["epilogue"],
                paged_verify_softcap=launches_spec["paged_verify"])


# The MoE family's cells: Qwen3-30B-A3B in bf16 (seeded non-unit q/k norms
# [L, 128], as its checkpoint carries them) and Mixtral-8x7B in int8 (its
# weights quantized slice by slice as they are drawn), each at full width,
# their depth cut to MOE_LAYERS. (published config, quantization, spec
# engines)
MOE_CELLS = {"qwen3moe": (QWEN3_30B_A3B, None, True),
             "mixtral_int8": (MIXTRAL_8X7B, "int8", False)}
# depth cuts that keep the whole script inside its time limit (of 48 and 32
# layers); the widths stay the published ones
MOE_LAYERS = {"qwen3moe": 12, "mixtral_int8": 4}
MOE_QK_NORM_SCALE = 0.2   # q/k norms drawn 1 + N(0, 0.2^2)


def _moe_params(torch, mcfg, dev, qk_norms):
    """The family's weights drawn from the seed on ``dev`` (int8 as they
    are drawn when ``mcfg.quantization`` asks), with seeded non-unit q/k
    norms when ``qk_norms``."""
    from dynamo_tpu_torch.models import mixtral

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = mixtral.init_params(mcfg, gen, torch.bfloat16, dev)
    if qk_norms:
        g = torch.Generator(device=dev).manual_seed(SEED + 12)
        shape = (mcfg.num_layers, mcfg.head_dim)
        for name in ("q_norm", "k_norm"):
            params["layers"][name] = (
                1.0 + MOE_QK_NORM_SCALE * torch.randn(
                    shape, generator=g, device=dev)).bfloat16()
    return params


def _pinned_moe_routing(torch, params):
    """``params`` sharing every tensor but the router: weights 0 and a
    ``router_bias`` leaf of distinct values, which steers selection only
    (``moe_mlp``), so every token takes the same top-k experts (the last
    k) at equal combine weights whatever the rounding; run at a capacity
    factor of E / k (``dataclasses.replace`` of the config), no token is
    dropped."""
    lay = params["layers"]
    l, _, e = lay["router"].shape
    bias = torch.linspace(0.0, 3.0, e, device=lay["router"].device)
    return dict(params, layers=dict(
        lay, router=torch.zeros_like(lay["router"]),
        router_bias=bias.to(lay["router"].dtype).expand(l, e)))


def _dequant_profile(torch, params):
    """The dequantizing conversions one decode step makes (``q.to(bf16)``
    of every int8 leaf once: each layer's slice in its layer, the head once),
    timed by CUDA events over every layer, with the bytes they move (int8
    read, bf16 written)."""
    from dynamo_tpu_torch.models.quant import QuantizedWeight

    stacks = [w for w in params["layers"].values()
              if isinstance(w, QuantizedWeight)]
    head = params.get("lm_head")
    layers = next(iter(params["layers"].values())).shape[0]

    def convert():   # a layer's slices at a time, as the forward does
        for i in range(layers):
            for w in stacks:
                w.q[i].to(torch.bfloat16)
        if isinstance(head, QuantizedWeight):
            head.q.to(torch.bfloat16)

    ms = cuda_ms(convert, iters=3, warmup=1)
    nbytes = 3 * (sum(w.q.numel() for w in stacks)
                  + (head.q.numel() if isinstance(head, QuantizedWeight) else 0))
    return dict(ms=ms, bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def engine_moe_phase(torch, dev, smi, cell):
    """One MoE-family cell (``MOE_CELLS``) through ``TorchServingEngine`` at
    full width, its depth cut to ``MOE_LAYERS``, from
    ``ModelConfig.from_hf_config`` of its
    published config, with seeded random weights and the engines' settings
    (``ENGINE``), one set of weight tensors behind every engine:

    1. the main path (fused epilogue, single-token decode): wave 1 and the
       prefix-hit wave 2, launches counted from 0 just before and read just
       after; a profiled decode step (for int8, the dequantizing conversions
       of a step timed as a line of their own); the logits of a batched
       prefill step and a decode step at full width and 2 layers against
       the CPU in f32 over the same weights (int8: the same ``q`` and
       ``scale``), with the routing pinned (held) and free (reported);
    2. ``multi_step_decode=4``: wave 1 must stream identically;
    3. the chained decode loop (``CHAIN``), every dispatch under the sync
       guard: wave 1 must stream identically, with a chain longer than one
       burst and no block left in use;
    4. and 5. (Qwen3-30B-A3B) the spec prompts, the last
       ``GEMMA_SPEC_TRAPS`` of them replaced by ``_spec_traps``, without
       and with ngram speculation (``SPEC``) with the routing pinned at a
       capacity where no token drops: equal, or parted at a printed
       near-tie, with at least one proposal rejected.

    For int8 every ``QUANT_KEYS`` leaf on the card must be int8. The numbers
    are printed before the checks run."""
    import dataclasses

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.models import mixtral
    from dynamo_tpu_torch.models.quant import QUANT_KEYS, QuantizedWeight

    hf, quantization, with_spec = MOE_CELLS[cell]
    on_card = torch.device(dev).type == "cuda"
    mcfg = dataclasses.replace(ModelConfig.from_hf_config(hf),
                               quantization=quantization,
                               num_layers=MOE_LAYERS[cell])
    vocab, layers = mcfg.vocab_size, mcfg.num_layers
    # every expert holds every token of a step at this capacity factor
    no_drop = dataclasses.replace(
        mcfg, moe_capacity_factor=mcfg.num_experts / mcfg.num_experts_per_tok)

    def config(model=mcfg, **kw):
        return EngineConfig(model=model, seed=SEED, **dict(ENGINE, **kw))

    rng = np.random.default_rng(SEED)
    wave1, wave2 = _requests(rng, vocab)
    spec_reqs = _spec_requests(rng)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = _moe_params(torch, mcfg, dev, qk_norms=quantization is None)
    init_s = time.monotonic() - t0
    pinned = _pinned_moe_routing(torch, params)
    n_params = sum((t.q if isinstance(t, QuantizedWeight) else t).numel()
                   for grp in params.values()
                   for t in (grp.values() if isinstance(grp, dict) else [grp]))
    weight_bytes = _tree_bytes(params)

    async def main_path():
        t0 = time.monotonic()
        engine = await TorchServingEngine.create(config(), params=params,
                                                 device=dev)
        setup_s = time.monotonic() - t0
        try:
            served = engine.runner.params
            leaves = dict(served["layers"], **{k: v for k, v in served.items()
                                               if k != "layers"})
            not_int8 = sorted(
                k for k, t in leaves.items()
                if quantization and k in QUANT_KEYS
                and not (isinstance(t, QuantizedWeight) and t.q.is_cuda == on_card
                         and t.q.dtype == torch.int8
                         and t.scale.dtype == torch.float32))
            _reset_launches()
            t1 = time.monotonic()
            res1 = await _serve(engine, wave1)
            wall1 = time.monotonic() - t1
            res2 = await _serve(engine, wave2)
            launches = _read_launches()
            metrics = engine.metrics()
            step = _decode_step_profile(torch, engine.runner) if on_card else None
            if step is not None and quantization:
                step["dequant"] = _dequant_profile(torch, served)
            # 2 layers of the same weights: the routing free at the engine's
            # capacity (reported), pinned at no drop (held)
            prompts = (wave1[4][0][:100], wave1[2][0][:40])
            by_routing = {}
            for name, prm, model in (("free", params, mcfg),
                                     ("pinned", pinned, no_drop)):
                lay2 = {k: v[:2] for k, v in prm["layers"].items()}
                by_routing[name] = _check_logits(
                    torch, engine.config, mixtral,
                    dataclasses.replace(model, num_layers=2),
                    engine.runner.device, dict(prm, layers=lay2), *prompts,
                    limit=LOGITS_REL_L2 if name == "pinned" else None)
                gc.collect()
            logits = dict(by_routing["pinned"], free_routing=by_routing["free"])
        finally:
            await engine.close()
        return (setup_s, res1, res2, wall1, launches, metrics, step, logits,
                not_int8)

    async def other_path(kw, batch, new_tokens=None, model=mcfg, prm=None,
                         guarded=False, spec_base=None):
        gc.collect()  # the engine before frees its cache first
        engine = await TorchServingEngine.create(config(model, **kw),
                                                 params=prm or params,
                                                 device=dev)
        stats = (_guard_dispatches(torch, engine.runner, layers, 4, on_card)
                 if guarded else None)
        try:
            _reset_launches()
            t0 = time.monotonic()
            res = await _serve(engine, batch, new_tokens)
            wall = time.monotonic() - t0
            launches = _read_launches()
            metrics = dict(engine.metrics(), dispatches=stats,
                           blocks_in_use=engine.scheduler.allocator.used)
            parted = (None if spec_base is None else
                      _spec_agreement(torch, engine.runner, batch, spec_base, res))
        finally:
            await engine.close()
        if on_card:
            torch.cuda.empty_cache()
        return res, wall, launches, metrics, parted

    (setup_s, res1, res2, wall1, launches, metrics, step, logits,
     not_int8) = asyncio.run(main_path())
    res_k4, wall_k4, launches_k4, metrics_k4, _ = asyncio.run(
        other_path(dict(multi_step_decode=4), wave1))
    res_ch, wall_ch, launches_ch, metrics_ch, _ = asyncio.run(
        other_path(CHAIN, wave1, guarded=True))
    spec = None
    if with_spec:
        # as on gemma-2: the random trunk accepts every pattern draft (384 of
        # 384 on the card), so the last prompts are traps whose drafts the
        # model contradicts, and the phase fails unless verify rejects one
        gc.collect()
        spec_reqs = (spec_reqs[:len(spec_reqs) - GEMMA_SPEC_TRAPS]
                     + _spec_traps(torch, mixtral, no_drop, pinned, dev))
        spec_base, _, _, _, _ = asyncio.run(
            other_path({}, spec_reqs, SPEC_NEW_TOKENS, no_drop, pinned))
        res_spec, wall_spec, launches_spec, metrics_spec, parted = asyncio.run(
            other_path(SPEC, spec_reqs, SPEC_NEW_TOKENS, no_drop, pinned,
                       spec_base=spec_base))
        spec = dict(**SPEC, moe_capacity_factor=no_drop.moe_capacity_factor,
                    routing="pinned", requests=len(spec_reqs),
                    traps=GEMMA_SPEC_TRAPS,
                    new_tokens=SPEC_NEW_TOKENS,
                    proposed=metrics_spec["spec_proposed_tokens"],
                    accepted=metrics_spec["spec_accepted_tokens"],
                    decode_steps=metrics_spec["decode_steps"], wall_s=wall_spec,
                    streams_equal=sum(a["tokens"] == b["tokens"]
                                      for a, b in zip(spec_base, res_spec)),
                    parted=parted, launches=launches_spec)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    del params, pinned
    if on_card:
        torch.cuda.empty_cache()

    def parts_at(a, b):
        return next((i for i, (x, y) in enumerate(zip(a["tokens"], b["tokens"]))
                     if x != y), None)

    ttfts = sorted(r["ttft_s"] for r in res1)
    emit(f"engine_{cell}", model=f"{hf['architectures'][0]} (published "
         f"config.json), seeded random weights"
         + (", quantized to int8 slice by slice at init" if quantization
            else " in bf16, non-unit q/k norms"),
         layers=layers, vocab=vocab, experts=mcfg.num_experts,
         top_k=mcfg.num_experts_per_tok, quantization=quantization,
         parameters=n_params, weight_bytes=weight_bytes, init_s=init_s,
         config={k: v for k, v in ENGINE.items()},
         requests=len(res1) + len(res2), new_tokens=NEW_TOKENS, setup_s=setup_s,
         wave1_prompt_tokens=sum(len(p) for p, _ in wave1), wave1_wall_s=wall1,
         wave1_output_tokens_per_s=len(res1) * NEW_TOKENS / wall1,
         ttft_s=dict(min=ttfts[0], median=ttfts[len(ttfts) // 2], max=ttfts[-1]),
         finishes=sorted({(len(r["tokens"]), r["finish"]) for r in res1 + res2}),
         peak_memory_bytes=peak, launches=launches, metrics=metrics,
         quant_leaves_not_int8=not_int8,
         twins_part_at=dict(greedy=parts_at(res1[0], res1[1]),
                            seeded=parts_at(res1[2], res1[3])),
         decode_step=step, logits_vs_cpu_f32_2_layers=logits,
         burst=dict(k=4, streams_equal=sum(a["tokens"] == b["tokens"]
                                           for a, b in zip(res1, res_k4)),
                    wave1_wall_s=wall_k4,
                    wave1_output_tokens_per_s=len(res_k4) * NEW_TOKENS / wall_k4,
                    decode_steps=metrics_k4["decode_steps"], launches=launches_k4),
         chained=dict(k=4, streams_equal=sum(a["tokens"] == b["tokens"]
                                             for a, b in zip(res1, res_ch)),
                      wave1_wall_s=wall_ch,
                      wave1_output_tokens_per_s=len(res_ch) * NEW_TOKENS / wall_ch,
                      **{k: metrics_ch[k] for k in (
                          "decode_steps", "decode_pipeline_bursts", "chain_len_max",
                          "device_finished_rows", "sync_fallback", "dispatches",
                          "blocks_in_use")},
                      launches=launches_ch),
         spec=spec, card=smi)
    if step is not None and quantization:
        dq = step["dequant"]
        emit(f"engine_{cell}_dequant", per_decode_step_ms=dq["ms"],
             share_of_step=dq["ms"] / step["step_ms"]["mean"],
             bytes=dq["bytes"], bound_ms=dq["bound_ms"],
             copy_kernels_in_the_trace_ms_per_step=step["copy_kernel_ms"]
             / step["traced_steps"],
             copy_kernels_share_of_device_busy=step["copy_kernel_share_of_busy"],
             weight_bound_ms_int8=step["weight_bound_ms"], card=smi)

    name = hf["architectures"][0]
    if not_int8:
        raise AssertionError(f"{name}: quantized leaves not int8 on the card: "
                             f"{not_int8}")
    _check_streams(res1 + res2, NEW_TOKENS, vocab)
    _check_streams(res_k4 + res_ch, NEW_TOKENS, vocab)
    # twins in one wave may part (the reference's expert capacity at a
    # decode batch of 8); repeated requests are held across engines over
    # the same weight tensors instead
    tokens1 = [r["tokens"] for r in res1]
    if [r["tokens"] for r in res_k4] != tokens1:
        raise AssertionError(f"{name}: wave 1 on the multi_step_decode=4 "
                             "engine streams differently from the K=1 engine")
    if [r["tokens"] for r in res_ch] != tokens1:
        raise AssertionError(f"{name}: wave 1 on the chained engine streams "
                             "differently from the K=1 engine")
    if (metrics_ch["dispatches"]["bad"] or metrics_ch["chain_len_max"] <= 1
            or metrics_ch["blocks_in_use"]):
        raise AssertionError(f"{name} chained engine: {metrics_ch}")
    if metrics["gpu_prefix_cache_hit_rate"] <= 0:
        raise AssertionError(f"{name}: the shared-prefix request missed the "
                             "prefix cache")
    if with_spec:
        _check_streams(spec_base + res_spec, SPEC_NEW_TOKENS, vocab)
        if metrics_spec["spec_proposed_tokens"] <= 0:
            raise AssertionError(f"{name}: ngram speculation proposed nothing")
        if not metrics_spec["spec_accepted_tokens"] < metrics_spec["spec_proposed_tokens"]:
            raise AssertionError(f"{name}: the spec engine accepted every "
                                 "proposal, so verify never rejected a draft")
    if on_card:
        _check_launches(f"{name} main", launches,
                        ("paged_decode", "paged_flash", "epilogue"), layers)
        _check_launches(f"{name} burst", launches_k4,
                        ("paged_decode", "epilogue"), layers)
        _check_launches(f"{name} chained", launches_ch,
                        ("paged_decode", "epilogue"), layers)
        if with_spec:
            _check_launches(f"{name} spec", launches_spec, ("paged_verify",),
                            layers)
        if launches["mla_decode"] or launches["sp_prefix"]:
            raise AssertionError(f"the {name} path launched a foreign kernel: "
                                 f"{launches}")
        if not (step["decode_kernel_ms"] > 0 and step["epilogue_kernel_ms"] > 0):
            raise AssertionError(f"{name}: the profiled decode step shows no "
                                 f"decode or epilogue kernel: "
                                 f"{step['top_kernels_ms']}")
    family = cell.split("_")[0]
    out = {f"paged_decode_{family}": launches["paged_decode"],
           f"paged_flash_{family}": launches["paged_flash"],
           f"sampling_epilogue_{family}": launches["epilogue"],
           f"sampling_epilogue_finish_{family}": launches_ch["epilogue"]}
    if with_spec:
        out[f"paged_verify_{family}"] = launches_spec["paged_verify"]
    return out


# the sequence-parallel phase: Llama-3.2-1B with a 16k context and the SP
# ladder at 4 ranks on the card. The SP chunk is 2,048 tokens (4 ranks x the
# 512-token step budget); the threshold sits between the short prompts
# (300, 900: dense ladder) and the prefix-hit request's 1,000-token suffix
SP_ENGINE = dict(max_model_len=16384, num_kv_blocks=2048, multi_step_decode=4,
                 sp_size=4, max_prefill_tokens_per_step=512,
                 long_prefill_threshold_tokens=1000)
# (prompt tokens, sampling): 6 SP chunks, 3 SP chunks, two dense prompts
SP_WAVE = ((12000, dict(temperature=0.0)),
           (6000, dict(temperature=0.8, seed=2024)),
           (300, dict(temperature=0.0)), (900, dict(temperature=0.0)))
# after the wave: the first 8,192 tokens of the 12k prompt + 1,000 new ones
SP_SHARED, SP_EXTRA = 8192, 1000


def _profiled(torch, fn):
    """Run ``fn`` once under ``torch.profiler`` (after a synchronize) and
    return its device time by kernel family (``sp_prefix`` the prefix
    kernel, ``paged_flash`` the flash kernel, ``gemm`` the cuBLAS / CUTLASS
    products incl. the ring's f32 einsums, ``other`` the rest), the
    device-busy time (the union of kernel intervals), the traced wall and
    the number of device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    fams = dict(sp_prefix=0.0, paged_flash=0.0, gemm=0.0, other=0.0)
    for e in kernels:
        low = e.name.lower()
        fam = ("sp_prefix" if "sp_prefix" in low else
               "paged_flash" if "paged_flash" in low else
               "gemm" if any(k in low for k in ("gemm", "xmma", "cutlass",
                                                 "nvjet", "gemv")) else "other")
        fams[fam] += e.time_range.elapsed_us() / 1e3
    busy = _busy_us(kernels)
    return out, dict(device_ms_by_family=fams, device_busy_ms=busy / 1e3,
                     traced_wall_ms=wall * 1e3, device_events=len(kernels))


def _sp_logits(torch, runner, prompt, dense_step):
    """The last-row logits of ``prompt`` on the card, through the SP ladder's
    chunks (``sp_decoder_forward``, the runner's chunk shape) and through the
    dense ladder's ``dense_step``-token chunks (``llama.forward``), each on
    a fresh cache of its own, from the runner's weights. A CPU f32 forward
    of a 12k prompt at full depth would take too long here; the dense
    ladder's bf16 logits on the card are the reference instead. On a card
    the last chunk of each ladder runs under ``torch.profiler``
    (``_profiled``): where an SP chunk's time goes, beside the dense
    ladder's step over the same last positions."""
    from dynamo_tpu_torch.engine.model_runner import build_prefill_arrays
    from dynamo_tpu_torch.models import llama

    cfg, dev = runner.config, runner.device
    mcfg, bs = cfg.model, cfg.kv_block_size
    n = len(prompt)
    blocks = list(range(-(-n // bs)))

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    on_card = torch.device(dev).type == "cuda"
    profiles = {}

    def run(name, fn, last):
        if not (on_card and last):
            return fn()
        out, profiles[name] = _profiled(torch, fn)
        return out

    with torch.inference_mode():
        cache = llama.init_kv_cache(mcfg, len(blocks), bs, runner.dtype, dev)
        S = runner.sp_chunk_tokens
        for start in range(0, n, S):
            end = min(start + S, n)
            tok, pos, bt, slots, _, _ = build_prefill_arrays(
                cfg, prompt[:end], start, blocks, bucket=S)
            hidden, cache = run("sp_last_chunk", lambda: llama.sp_decoder_forward(
                runner.params, mcfg, t(tok), t(pos), cache, t(bt, torch.int32),
                t(slots), end, start, cfg.sp_size), end == n)
        profiles["sp_last_chunk_tokens"] = [start, end]
        sp = llama.lm_logits(hidden[0, end - start - 1], runner.params, mcfg)
        del cache
        cache = llama.init_kv_cache(mcfg, len(blocks), bs, runner.dtype, dev)
        for start in range(0, n, dense_step):
            end = min(start + dense_step, n)
            tok, pos, bt, slots, ctx, last = build_prefill_arrays(
                cfg, prompt[:end], start, blocks, bucket=dense_step)
            hidden, cache = run("dense_last_step", lambda: llama.forward(
                runner.params, mcfg, t(tok), t(pos), cache, t(bt, torch.int32),
                t(slots), t(ctx, torch.int32), return_hidden=True), end == n)
        profiles["dense_last_step_tokens"] = [start, end]
        dense = llama.lm_logits(hidden[0, int(last[0])], runner.params, mcfg)
        del cache
    sp, dense = sp.float().cpu(), dense.float().cpu()
    return dict(rel_l2=float((sp - dense).norm() / dense.norm()),
                argmax_equal=int(sp.argmax()) == int(dense.argmax()),
                profiles=profiles)


def engine_sp_phase(torch, dev, smi):
    """Sequence-parallel long-context prefill on Llama-3.2-1B at full width
    and depth (the seeded random bf16 weights), 16k context, ``sp_size`` 4
    (the ranks laid out on the one card), three engines over the same weight
    tensors, in turns: the synchronous SP engine, the dense engine
    (``sp_size`` 1) and the chained SP engine (``decode_pipeline_depth`` 2).
    Each serves ``SP_WAVE`` concurrently (two prompts on the SP ladder, two
    short ones on the dense ladder decoding meanwhile), then a request that
    shares the first 8,192 tokens of the 12k prompt, whose first SP chunk
    starts at 8,192 on prefix-cache blocks. Launches are counted from 0
    just before the wave and read just after the last request.

    Checks: stream lengths and finish reasons; the SP streams equal the
    dense engine's or part at a printed near-tie; the chained SP engine
    streams exactly as the synchronous one; the 12k prompt's last-row
    logits through the SP chunks within ``LOGITS_REL_L2`` of the dense
    ladder's; kernel 6 launched once a layer per SP chunk and no flash
    kernel inside an SP chunk; every SP chunk dispatch under
    ``torch.cuda.set_sync_debug_mode("error")``; at least 3 early
    handoffs; no KV block in use at the end. The numbers are printed before
    the checks run."""
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine

    layers, k_steps = FLAGSHIP["num_layers"], SP_ENGINE["multi_step_decode"]
    on_card = torch.device(dev).type == "cuda"
    vocab = FLAGSHIP["vocab_size"]

    def config(**kw):
        return EngineConfig(model=ModelConfig(**FLAGSHIP), seed=SEED,
                            **dict(ENGINE, **dict(SP_ENGINE, **kw)))

    rng = np.random.default_rng(SEED + 5)
    wave = [([int(t) for t in rng.integers(0, vocab, n)], samp)
            for n, samp in SP_WAVE]
    hit = wave[0][0][:SP_SHARED] + [int(t) for t in rng.integers(0, vocab, SP_EXTRA)]
    greedy = dict(temperature=0.0)

    async def run(kw, params=None, keep_runner=False):
        # the engine before this one goes first: each peak holds the shared
        # weights and this engine's own cache, not an earlier engine's
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        engine = await TorchServingEngine.create(config(**kw), params=params,
                                                 device=dev)
        counter = ("launches_fp8" if kw.get("kv_cache_dtype") == "fp8"
                   else "launches")
        stats = _guard_dispatches(torch, engine.runner, layers, k_steps,
                                  on_card, sp=True, counter=counter)
        try:
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            _reset_launches()
            t0 = time.monotonic()
            res1 = await _serve(engine, wave)
            wall = time.monotonic() - t0
            res2 = await _serve(engine, [(hit, greedy)])
            launches = _read_launches()
            out = dict(res=res1 + res2, wall=wall, launches=launches,
                       metrics=engine.metrics(), stats=stats,
                       peak=torch.cuda.max_memory_allocated(dev) if on_card else None,
                       blocks_in_use=engine.scheduler.allocator.used,
                       params=engine.runner.params,
                       runner=engine.runner if keep_runner else None)
        finally:
            await engine.close()
        return out

    sp = asyncio.run(run({}))
    params = sp["params"]
    dense = asyncio.run(run(dict(sp_size=1, long_prefill_threshold_tokens=0),
                            params))
    # the same prompts over an fp8 (e4m3) cache: kernel 6's fp8 form
    fp8 = asyncio.run(run(dict(kv_cache_dtype="fp8"), params))
    chained = asyncio.run(run(dict(decode_pipeline_depth=2), params,
                              keep_runner=True))
    runner = chained.pop("runner")
    # a decode step at the wave's contexts while its 12k prompt decodes
    step = (_decode_step_profile(torch, runner, ctx=LONG_DECODE_CTX + [1] * 4)
            if on_card else None)
    logits = _sp_logits(torch, runner, wave[0][0], ENGINE["max_prefill_tokens_per_step"])
    requests = wave + [(hit, greedy)]
    parted = _spec_agreement(torch, runner, requests, dense["res"], sp["res"])
    # the fp8 SP engine's greedy streams against the bf16 SP engine's: equal
    # or parted at a near-tie of the bf16 logits (the e4m3 cache's error is
    # ~6% an element); the seeded sampled stream is checked for its length
    greedy_i = [i for i, (_, samp) in enumerate(requests)
                if samp["temperature"] == 0.0]
    fp8_parted = _spec_agreement(
        torch, runner, [requests[i] for i in greedy_i],
        [sp["res"][i] for i in greedy_i], [fp8["res"][i] for i in greedy_i])
    del params, runner
    runs = dict(sp=sp, dense=dense, sp_chained=chained, sp_fp8=fp8)
    for r in runs.values():
        del r["params"]
    if on_card:
        torch.cuda.empty_cache()

    def summary(r):
        wave_res = r["res"][:len(wave)]
        ttfts = sorted(x["ttft_s"] for x in wave_res)
        m = r["metrics"]
        return dict(
            wave_wall_s=r["wall"],
            wave_output_tokens_per_s=len(wave_res) * NEW_TOKENS / r["wall"],
            ttft_s=dict(min=ttfts[0], median=ttfts[len(ttfts) // 2],
                        max=ttfts[-1]),
            ttft_12k_s=wave_res[0]["ttft_s"], ttft_prefix_hit_s=r["res"][-1]["ttft_s"],
            peak_memory_bytes=r["peak"],
            prefill_steps=m["prefill_steps"], decode_steps=m["decode_steps"],
            sp_chunks=m["sp_chunks"], sp_tokens=m["sp_tokens"],
            sp_handoffs=m["sp_handoffs"],
            decode_pipeline_bursts=m.get("decode_pipeline_bursts"),
            sync_fallback=m["sync_fallback"],
            prefix_hit_rate=m["gpu_prefix_cache_hit_rate"],
            launches=r["launches"], sp_chunk_dispatches=r["stats"]["sp_chunks"],
            bad_bursts=r["stats"]["bad"], blocks_in_use=r["blocks_in_use"])

    emit("engine_sp", model="Llama-3.2-1B shapes, seeded random bf16 weights",
         config=dict(ENGINE, **SP_ENGINE),
         wave=[dict(prompt_tokens=n, **samp) for n, samp in SP_WAVE],
         prefix_hit=dict(shared=SP_SHARED, new=SP_EXTRA), new_tokens=NEW_TOKENS,
         engines={name: summary(r) for name, r in runs.items()},
         decode_step=step, logits_12k_sp_vs_dense=logits,
         sp_vs_dense_parted=parted, fp8_vs_bf16_sp_parted=fp8_parted,
         card=smi)

    for name, r in runs.items():
        _check_streams(r["res"], NEW_TOKENS)
        if r["blocks_in_use"]:
            raise AssertionError(f"{name} engine: {r['blocks_in_use']} KV blocks "
                                 "still in use after the run")
        if r["stats"]["bad"]:
            raise AssertionError(
                f"{name} engine: a burst did not launch the epilogue once a "
                f"step and the decode kernel once a layer a step: "
                f"{r['stats']['bad'][:4]}")
    got = [(x["tokens"], x["finish"]) for x in chained["res"]]
    want = [(x["tokens"], x["finish"]) for x in sp["res"]]
    if got != want:
        raise AssertionError("the chained SP engine streams differently from "
                             "the synchronous SP engine")
    if not logits["rel_l2"] <= LOGITS_REL_L2:
        raise AssertionError(f"12k prompt: SP logits vs the dense ladder's, "
                             f"relative L2 {logits['rel_l2']:.4g} > {LOGITS_REL_L2}")
    # 12,000 and 6,000 tokens in 2,048-token chunks, then the 1,000-token
    # suffix of the prefix hit: 6 + 3 + 1
    bucket = config().sp_prefill_bucket()
    want_chunks = sum(-(-n // bucket) for n, _ in SP_WAVE
                      if n >= SP_ENGINE["long_prefill_threshold_tokens"])
    want_chunks += -(-SP_EXTRA // bucket)
    for name in ("sp", "sp_chained", "sp_fp8"):
        r = runs[name]
        sfx = "_fp8" if name == "sp_fp8" else ""
        m, chunks = r["metrics"], r["stats"]["sp_chunks"]
        if len(chunks) != m["sp_chunks"] or m["sp_chunks"] != want_chunks:
            raise AssertionError(f"{name}: SP chunks {m['sp_chunks']} "
                                 f"(dispatches seen {len(chunks)})")
        if SP_SHARED not in [c["start"] for c in chunks]:
            raise AssertionError(f"{name}: no SP chunk started at {SP_SHARED} "
                                 f"(the prefix hit): {chunks}")
        if m["sp_handoffs"] < 3:
            raise AssertionError(f"{name}: {m['sp_handoffs']} early handoffs (< 3)")
        if on_card:
            launches = r["launches"]
            other = "" if sfx else "_fp8"  # the form this engine must not run
            if launches["sp_prefix" + sfx] != layers * m["sp_chunks"] or any(
                    c["sp_prefix"] != layers or c["paged_flash"] for c in chunks):
                raise AssertionError(
                    f"{name}: kernel 6 launched {launches['sp_prefix' + sfx]} "
                    f"times for {m['sp_chunks']} SP chunks of {layers} layers, "
                    f"per chunk "
                    f"{[(c['sp_prefix'], c['paged_flash']) for c in chunks]}")
            if launches["paged_flash" + sfx] != layers * m["prefill_steps"]:
                raise AssertionError(
                    f"{name}: the flash kernel launched "
                    f"{launches['paged_flash' + sfx]} times for "
                    f"{m['prefill_steps']} dense prefill steps")
            if any(launches[k + other] for k in ("sp_prefix", "paged_flash",
                                                 "paged_decode")):
                raise AssertionError(f"{name}: a kernel's other form launched: "
                                     f"{launches}")
            _check_launches(name, launches, ("paged_decode" + sfx, "epilogue"))
    if dense["metrics"]["sp_chunks"] or (on_card and dense["launches"]["sp_prefix"]):
        raise AssertionError("the dense engine ran an SP chunk")
    return dict(sp_prefix=sp["launches"]["sp_prefix"],
                sp_prefix_fp8=fp8["launches"]["sp_prefix_fp8"])


# ------------------------------------------------------------ engine_http

# Llama-3's published pre-tokenizer pattern and chat template (the
# Meta-Llama-3-8B-Instruct tokenizer files)
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_CHAT_TEMPLATE = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' %}"
    "{% if loop.index0 == 0 %}{% set content = bos_token + content %}"
    "{% endif %}{{ content }}{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")
LLAMA3_SPECIAL = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
                  128004: "<|finetune_right_pad_id|>",
                  128006: "<|start_header_id|>", 128007: "<|end_header_id|>",
                  128008: "<|eom_id|>", 128009: "<|eot_id|>",
                  128010: "<|python_tag|>"}
TOKEN_MAX_CHARS = 16   # the longest synthetic merge, in byte-level chars


def _byte_level_alphabet():
    """GPT-2's byte → printable character table, in byte order."""
    bs = list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256))
    cs = bs[:]
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + len(cs) - 188)
    table = dict(zip(bs, cs))
    return [chr(table[b]) for b in range(256)]


def synthetic_tokenizer(vocab_size=FLAGSHIP["vocab_size"], seed=SEED,
                        n_special=256, special_names=None) -> dict:
    """A byte-level BPE ``tokenizer.json`` over ``vocab_size`` ids in
    Llama-3's layout: 256 byte symbols, then merges drawn from ``seed``
    (each new token the concatenation of two existing tokens of at most
    ``TOKEN_MAX_CHARS`` together, so encoding is valid BPE and every id
    decodes to bytes), then ``n_special`` special tokens (``special_names``
    by id, Llama-3's named ones by default; reserved ones in the gaps);
    Llama-3's ``Split`` pattern and ``ignore_merges``."""
    rng = np.random.default_rng(seed)
    vocab_list = _byte_level_alphabet()
    vocab = {t: i for i, t in enumerate(vocab_list)}
    space = vocab_list[ord(" ")]
    # half the merges grow a word by a letter (words: a leading space or
    # not, then ASCII letters), so text made of such words encodes as a
    # word a token; the other half join any two tokens
    letters = [vocab_list[b] for b in range(256)
               if chr(b).isascii() and chr(b).isalpha()]
    words = letters + [space]
    merges = []
    n_regular = vocab_size - n_special
    while len(vocab_list) < n_regular:
        draws = rng.random((4096, 3))
        for word, u, v in draws:
            if word < 0.5:
                ta = words[int(u * len(words))]
                tb = letters[int(v * len(letters))]
            else:
                ta = vocab_list[int(u * len(vocab_list))]
                tb = vocab_list[int(v * len(vocab_list))]
            t = ta + tb
            if len(t) > TOKEN_MAX_CHARS or t in vocab:
                continue
            vocab[t] = len(vocab_list)
            vocab_list.append(t)
            merges.append([ta, tb])
            if word < 0.5 and len(t) < TOKEN_MAX_CHARS:
                words.append(t)
            if len(vocab_list) == n_regular:
                break
    names = LLAMA3_SPECIAL if special_names is None else special_names
    specials = {i: names.get(i, f"<|reserved_special_token_{i - n_regular}|>")
                for i in range(n_regular, vocab_size)}
    added = [dict(id=i, content=t, single_word=False, lstrip=False,
                  rstrip=False, normalized=False, special=True)
             for i, t in specials.items()]
    for i, t in specials.items():
        vocab[t] = i
    bos = specials.get(128000, specials[n_regular])
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True,
             "trim_offsets": False, "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [vocab[bos]],
                                      "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": True, "vocab": vocab, "merges": merges},
    }


def write_model_dir(path, seed=SEED) -> str:
    """The model directory ``engine_http`` serves: ``config.json`` from
    ``FLAGSHIP`` in the HF layout, ``tokenizer_config.json`` with
    Llama-3's chat template, and ``synthetic_tokenizer``'s
    ``tokenizer.json``. No checkpoint: the engine draws seeded random
    weights (``--allow-random-weights``)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    f = FLAGSHIP
    config = {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": f["vocab_size"], "hidden_size": f["hidden_size"],
        "intermediate_size": f["intermediate_size"],
        "num_hidden_layers": f["num_layers"],
        "num_attention_heads": f["num_heads"],
        "num_key_value_heads": f["num_kv_heads"], "head_dim": f["head_dim"],
        "rope_theta": f["rope_theta"],
        "max_position_embeddings": f["max_position_embeddings"],
        "tie_word_embeddings": f["tie_word_embeddings"],
        "rope_scaling": f["rope_scaling"], "rms_norm_eps": 1e-5,
        "hidden_act": "silu", "attention_bias": False,
        "bos_token_id": 128000, "eos_token_id": 128009,
        "torch_dtype": "bfloat16"}
    (path / "config.json").write_text(json.dumps(config, indent=1))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
        "chat_template": LLAMA3_CHAT_TEMPLATE}, indent=1))
    (path / "tokenizer.json").write_text(
        json.dumps(synthetic_tokenizer(seed=seed), ensure_ascii=False),
        encoding="utf-8")
    return str(path)


# the server of engine_http: the chained decode loop over so few KV blocks
# that its wave preempts (the roomy engine gets HTTP_ROOMY_BLOCKS)
HTTP_SERVER = dict(max_model_len=2048, num_kv_blocks=128, kv_block_size=16,
                   max_batch_size=8, decode_pipeline_depth=2)
HTTP_ROOMY_BLOCKS = 1024
HTTP_PREFILL = dict(max_prefill_tokens_per_step=512)
HTTP_PROMPTS = (1500, 100, 730, 1210, 420, 960, 1100, 250)  # words (tokens)
HTTP_NEW_TOKENS = 32
HTTP_SEED = 1234
HTTP_LOGPROB_TOL = 2e-2
HTTP_DISCONNECT_AFTER = 4      # chunks read before the client goes away
HTTP_CLI_TIMEOUT_S = 300
HTTP_WAVE_TIMEOUT_S = 240
HTTP_DEVICE = "cuda"           # a CPU rehearsal sets "cpu"
# the telemetry the front runs with in engine_http: the trace store's bound,
# the SLO targets (each finished request gets a verdict, met or not), a
# torch.profiler window taken from the wave's start (prefill, first tokens
# and decode steps all land in it) and the kernels it must hold: kernel 1
# (the split-KV core's __global__), kernel 2 and kernel 3
HTTP_TRACE_CAPACITY = 64
HTTP_SLO_TTFT_MS = 2000.0
HTTP_SLO_ITL_MS = 250.0
HTTP_PROFILE_S = 2.0
HTTP_PROFILE_KERNELS = {"paged_decode": "splitkv_kernel",
                        "paged_flash": "paged_flash_tc_kernel",
                        "sampling_epilogue": "sampling_epilogue_kernel"}
# a trace's first_token mark against the client's TTFT: the client's also
# covers the request's way in, the detokenizer and the SSE write, the
# front's share (the client's TTFT less the engine's, PERF.md §5: 0.02-0.16
# s on the card), and the hop from the scheduler's first_token stamp to the
# engine's output stream (measured per request: the loop finishes its pass
# first); the difference may exceed their sum by this much
HTTP_TRACE_TTFT_SLACK_S = 0.05


def _word_ids(tok):
    """The synthetic vocabulary's ' word' tokens (a space, then ASCII
    letters): text made of them encodes back to the same ids."""
    import re

    return [i for i in range(tok.vocab_size)
            if re.fullmatch(r" [A-Za-z]+", tok.decode([i]) or "")]


def _cli_flags(model_dir, extra_path, **kw):
    """``cli.run``'s flags for ``model_dir`` with the engine settings
    ``kw`` (HTTP_SERVER's keys)."""
    from dynamo_tpu_torch.cli import run

    args = ["--model-path", model_dir, "--model-name", "llama-3.2-1b-random",
            "--allow-random-weights", "--extra-engine-args", extra_path,
            "--http-host", "127.0.0.1", "--http-port", "0",
            "--device", HTTP_DEVICE]
    for k, v in kw.items():
        args += ["--" + k.replace("_", "-"), str(v)]
    return run.parse_flags(args)


async def http_request(port, method, path, body=None, disconnect_after=None,
                       headers=None, on_event=None):
    """One HTTP/1.1 request over asyncio streams: (status, headers, body,
    events). For an SSE answer ``events`` holds (arrival seconds since the
    request was sent, payload) per ``data:`` event, and ``body`` the raw
    stream; ``disconnect_after`` closes the connection after that many
    events; ``on_event(seconds, payload)`` sees each event as it arrives."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = b"" if body is None else json.dumps(body).encode()
    head = [f"{method} {path} HTTP/1.1", "Host: 127.0.0.1",
            "Connection: close", f"Content-Length: {len(data)}",
            "Content-Type: application/json"]
    head += [f"{k}: {v}" for k, v in (headers or {}).items()]
    t0 = time.monotonic()
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
    await writer.drain()
    try:
        status_line, *lines = (await reader.readuntil(b"\r\n\r\n")).decode(
            "latin-1").split("\r\n")
        status = int(status_line.split()[1])
        hdrs = {k.lower(): v.strip() for k, _, v in
                (line.partition(":") for line in lines if line)}
        events, raw = [], b""
        if hdrs.get("transfer-encoding") == "chunked":
            pending = b""
            while True:
                size = int((await reader.readline()).split(b";")[0], 16)
                if size == 0:
                    break
                chunk = await reader.readexactly(size)
                await reader.readexactly(2)
                now = time.monotonic() - t0
                raw += chunk
                pending += chunk
                while b"\n\n" in pending:
                    event, pending = pending.split(b"\n\n", 1)
                    for line in event.decode().splitlines():
                        if line.startswith("data: "):
                            payload = line[6:]
                            events.append((now, None if payload == "[DONE]"
                                           else json.loads(payload)))
                            if on_event is not None:
                                on_event(*events[-1])
                if disconnect_after and len(events) >= disconnect_after:
                    return status, hdrs, raw, events
            return status, hdrs, raw, events
        raw = await reader.readexactly(int(hdrs.get("content-length", 0)))
        hdrs["elapsed_s"] = time.monotonic() - t0
        return status, hdrs, raw, events
    finally:
        writer.close()


def _stream_record(events, chat):
    """Token ids (from the logprob entries' token strings: the caller maps
    them), text, logprobs, finish reason, TTFT and inter-token gaps of one
    SSE stream of a single choice."""
    text, toks, lps, finish, times = "", [], [], None, []
    for t, c in events:
        if c is None or not c.get("choices"):
            continue
        ch = c["choices"][0]
        piece = (ch.get("delta") or {}).get("content") if chat else ch.get("text")
        if piece:
            text += piece
            times.append(t)
        lp = ch.get("logprobs")
        if chat and lp and lp.get("content"):
            toks += [e["token"] for e in lp["content"]]
            lps += [e["logprob"] for e in lp["content"]]
            if not piece:
                times.append(t)
        elif not chat and lp:
            toks += lp["tokens"]
            lps += lp["token_logprobs"]
        if ch.get("finish_reason"):
            finish = ch["finish_reason"]
    gaps = np.diff(times) if len(times) > 1 else np.zeros(1)
    return dict(text=text, tokens=toks, logprobs=lps, finish=finish,
                ttft_s=times[0] if times else None,
                itl_median_s=float(np.median(gaps)), itl_max_s=float(gaps.max()))


def _metric(text, name, labels=""):
    """The value of one sample of a Prometheus exposition."""
    for line in text.splitlines():
        key, _, value = line.rpartition(" ")
        if key == name + labels:
            return float(value)
    raise AssertionError(f"{name}{labels} not on /metrics")


async def _guarded(wave, engine, timeout_s=HTTP_WAVE_TIMEOUT_S):
    """Await ``wave`` while ``engine``'s scheduler loop lives: a loop that
    died ends the wait with its exception, and a wave that outlasts
    ``timeout_s`` prints every task's stack and the scheduler's state."""
    import faulthandler

    wave = asyncio.ensure_future(wave)
    loop_task = engine.scheduler._task

    async def progress():
        while True:
            await asyncio.sleep(20)
            m = engine.metrics()
            print(f"wave: steps {m['steps']}, preemptions {m['preemptions']}, "
                  f"active {m['request_active_slots']}, waiting "
                  f"{m['num_requests_waiting']}, kv {m['kv_active_blocks']}",
                  file=sys.stderr, flush=True)
    ticker = asyncio.ensure_future(progress())
    # a loop blocked in native code cannot time out by itself: every
    # thread's stack, then exit
    faulthandler.dump_traceback_later(timeout_s + 30, exit=True)
    try:
        done, _ = await asyncio.wait({wave, loop_task}, timeout=timeout_s,
                                     return_when=asyncio.FIRST_COMPLETED)
    finally:
        faulthandler.cancel_dump_traceback_later()
        ticker.cancel()
    if wave in done:
        return wave.result()
    wave.cancel()
    if loop_task in done:
        raise RuntimeError("the scheduler loop ended while requests were in "
                           "flight") from loop_task.exception()
    sched = engine.scheduler
    print(f"wave stalled after {timeout_s} s: metrics {engine.metrics()}, "
          f"waiting {[er.request_id for er in sched.waiting]}, slots "
          f"{[(er.request_id, er.context_len, er.generated, len(er.block_ids)) for er in sched.slots if er is not None]}",
          file=sys.stderr, flush=True)
    for task in asyncio.all_tasks():
        task.print_stack(file=sys.stderr)
    raise TimeoutError(f"the HTTP wave did not end within {timeout_s} s")


def _bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place at ``x`` (8 significant bits)."""
    return 2.0 ** (int(np.floor(np.log2(max(abs(x), 2.0 ** -126)))) - 7)


def _chosen_logits(torch, runner, prompt, tokens):
    """The logit of each of ``tokens`` after ``prompt`` and the tokens
    before it: one plain forward of the whole sequence on blocks 0.. of
    the (idle) runner's cache, through its model family."""
    arch, cfg, dev = runner.arch, runner.config, runner.device
    seq = list(prompt) + list(tokens)
    n = len(seq)
    nb = -(-n // cfg.kv_block_size)
    bt = torch.zeros((1, cfg.blocks_per_seq), dtype=torch.int32, device=dev)
    bt[0, :nb] = torch.arange(nb, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
    with torch.inference_mode():
        hidden, _ = arch.forward(
            runner.params, cfg.model,
            torch.tensor([seq], dtype=torch.int32, device=dev), pos,
            runner.kv_cache, bt, pos, torch.tensor([n], device=dev).int(),
            return_hidden=True)
        lg = arch.lm_logits(hidden[0, len(prompt) - 1:n - 1], runner.params,
                            cfg.model).float()
        idx = torch.tensor(list(tokens), device=dev)[:, None]
        return lg.gather(1, idx)[:, 0].cpu().tolist()


def _held_text(streamed, full):
    """The streamed text is the decode of the stream's ids, but for a tail
    the incremental decoder holds while it ends in an incomplete UTF-8
    sequence."""
    return streamed == full or (full.startswith(streamed)
                                and full.endswith("�"))


def engine_http_phase(torch, dev, smi):
    """The OpenAI front on the card: a model directory written here
    (``write_model_dir``), the engine built by ``cli.run.build_engine`` and
    served by ``HttpService``, a concurrent wave of HTTP requests from a
    stdlib client, held against a roomy engine over the same directory and
    seed (the CLI in a subprocess: ``engine_guided``'s leg C)."""
    import dataclasses
    import tempfile

    from dynamo_tpu_torch.cli import run
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.http.service import HttpService, ModelManager
    from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
    from dynamo_tpu_torch.protocols.annotated import ANNOTATION_TOKEN_IDS
    from dynamo_tpu_torch.protocols.openai import (
        ChatCompletionRequest,
        CompletionRequest,
    )
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.telemetry.slo import SloTracker

    tmp = tempfile.TemporaryDirectory(prefix="engine_http_")
    t0 = time.monotonic()
    model_dir = write_model_dir(Path(tmp.name) / "llama-3.2-1b-random")
    extra = Path(tmp.name) / "extra.json"
    extra.write_text(json.dumps(HTTP_PREFILL))
    write_s = time.monotonic() - t0
    t0 = time.monotonic()
    tok = HFTokenizer.from_pretrained_dir(model_dir)
    load_s = time.monotonic() - t0
    words = _word_ids(tok)
    rng = np.random.default_rng(SEED)

    def words_text(n):
        return tok.decode([words[int(i)] for i in rng.integers(0, len(words), n)])

    prompts = [words_text(n) for n in HTTP_PROMPTS]
    # tokenizer cost: a fresh tokenizer's first encode (cold BPE cache) and
    # a second one, per prompt token
    cold = HFTokenizer.from_pretrained_dir(model_dir)
    t0 = time.perf_counter()
    n_tok = sum(len(cold.encode(p)) for p in prompts)
    cold_us = (time.perf_counter() - t0) / n_tok * 1e6
    t0 = time.perf_counter()
    for p in prompts:
        cold.encode(p)
    warm_us = (time.perf_counter() - t0) / n_tok * 1e6
    del cold

    greedy = dict(temperature=0.0, max_tokens=HTTP_NEW_TOKENS, ignore_eos=True)
    ann = dict(nvext={"annotations": [ANNOTATION_TOKEN_IDS]})

    def chat(content, **kw):
        return dict(model="llama-3.2-1b-random", stream=True,
                    messages=[{"role": "user", "content": content}], **kw)

    reqs = {f"greedy{i}": ("chat", chat(p, logprobs=True, **greedy, **ann))
            for i, p in enumerate(prompts)}
    reqs["completion0"] = ("completion", dict(
        model="llama-3.2-1b-random", prompt=words_text(300), logprobs=0,
        **greedy))
    reqs["completion1"] = ("completion", dict(
        model="llama-3.2-1b-random", prompt=words_text(640), logprobs=0,
        **greedy))
    reqs["logprobs"] = ("chat", chat(words_text(180), logprobs=True,
                                     top_logprobs=5, **greedy, **ann))
    reqs["penalties"] = ("chat", chat(words_text(220), logprobs=True,
                                      frequency_penalty=0.5,
                                      presence_penalty=0.3, **greedy, **ann))
    reqs["stop"] = ("chat", chat(words_text(160), logprobs=True, **greedy, **ann))
    reqs["n2"] = ("chat", chat(words_text(140), logprobs=True, n=2,
                               temperature=0.8, seed=HTTP_SEED,
                               max_tokens=HTTP_NEW_TOKENS, ignore_eos=True,
                               **ann))
    disconnect = chat(words_text(200), max_tokens=400, temperature=0.0,
                      ignore_eos=True)

    def preprocessed(pre, kind, body):
        cls = ChatCompletionRequest if kind == "chat" else CompletionRequest
        b = dict(body)
        fn = pre.preprocess_chat if kind == "chat" else pre.preprocess_completion
        return fn(cls.model_validate(b))

    async def serve_roomy(engine, pre_reqs):
        async def one(pr):
            toks, lps = [], []
            async for out in engine.generate(Context(pr)):
                toks += out["token_ids"]
                lps += [lp["logprob"] for lp in out.get("logprobs") or []]
            return toks, lps
        return await _guarded(asyncio.gather(*(one(pr) for pr in pre_reqs)),
                              engine)

    async def main():
        # the roomy engine first: it picks the stop request's stop string
        # from its own greedy text
        roomy = await TorchServingEngine.create(
            mdc=run.load_mdc(_cli_flags(model_dir, str(extra))),
            flags=_cli_flags(model_dir, str(extra), **dict(
                HTTP_SERVER, num_kv_blocks=HTTP_ROOMY_BLOCKS)), device=HTTP_DEVICE)
        pipe, mdc = await run.build_engine(
            "torch", _cli_flags(model_dir, str(extra), **HTTP_SERVER))
        pre = pipe.operator
        try:
            stop_pr = preprocessed(pre, "chat", reqs["stop"][1])
            (stop_ids, stop_lps), = await serve_roomy(roomy, [stop_pr])
            prompt_lens["stop"] = len(stop_pr.token_ids)
            stop_text = tok.decode(stop_ids)
            k = next(i for i in range(len(stop_text) // 2, len(stop_text) - 3)
                     if "�" not in stop_text[i:i + 3]
                     and stop_text[i:i + 3].strip())
            reqs["stop"][1]["stop"] = [stop_text[k:k + 3]]

            core = pipe.core_engine
            engine_times = {}
            generate = core.generate

            async def timed(request):
                rid = request.context.trace_id
                rec = engine_times.setdefault(rid, {"in": time.monotonic()})
                rec.setdefault("contexts", []).append(request.context)
                async for out in generate(request):
                    if out.get("token_ids") and "first" not in rec:
                        rec["first"] = time.monotonic()
                    yield out
            core.generate = timed

            manager = ModelManager()
            manager.add_chat_model("llama-3.2-1b-random", pipe)
            manager.add_completion_model("llama-3.2-1b-random", pipe)
            # the front as the CLI builds it with --trace-capacity,
            # --slo-ttft-ms, --slo-itl-ms and --profile-dir: the engine's
            # registry (scheduler, first dispatches, device time) attached
            service = HttpService(
                manager, "127.0.0.1", 0, profile_dir=str(Path(tmp.name) / "prof"),
                slo=SloTracker(ttft_s=HTTP_SLO_TTFT_MS / 1e3,
                               itl_s=HTTP_SLO_ITL_MS / 1e3),
                trace_capacity=HTTP_TRACE_CAPACITY)
            service.metrics.register_callback_gauges("dynamo_engine", core.metrics)
            service.metrics.registry.attach(core.registry)
            await service.start()
            port = service.port
            try:
                _, _, models, _ = await http_request(port, "GET", "/v1/models")
                _, _, health, _ = await http_request(port, "GET", "/health")
                _reset_launches()
                t_wave = time.monotonic()
                sent = {name: http_request(
                    port, "POST", "/v1/chat/completions" if kind == "chat"
                    else "/v1/completions", body,
                    headers={"X-Request-Id": name})
                    for name, (kind, body) in reqs.items()}
                sent["disconnect"] = http_request(
                    port, "POST", "/v1/chat/completions", disconnect,
                    disconnect_after=HTTP_DISCONNECT_AFTER,
                    headers={"X-Request-Id": "disconnect"})
                # a profiler window from the wave's start, concurrent with it
                sent["profile"] = http_request(
                    port, "GET", f"/debug/profile?seconds={HTTP_PROFILE_S}")
                # the event loop's largest stall over the wave (a capture
                # must not freeze the server it measures)
                lag = {"max": 0.0}

                async def probe_lag():
                    while True:
                        t = time.monotonic()
                        await asyncio.sleep(0.01)
                        lag["max"] = max(lag["max"], time.monotonic() - t - 0.01)

                lag_task = asyncio.ensure_future(probe_lag())
                answers = dict(zip(sent, await _guarded(
                    asyncio.gather(*sent.values()), core)))
                lag_task.cancel()
                dropped = answers.pop("disconnect")
                profile = answers.pop("profile")
                wave_s = time.monotonic() - t_wave
                for _ in range(600):  # the dropped request is reaped
                    m = core.metrics()
                    if not m["kv_active_blocks"] and not m["request_active_slots"]:
                        break
                    await asyncio.sleep(0.05)
                launches = _read_launches()
                _, _, metrics_raw, _ = await http_request(port, "GET", "/metrics")
                traces = {}
                for name in reqs:
                    status, _, raw, _ = await http_request(
                        port, "GET", f"/debug/requests/{name}")
                    traces[name] = json.loads(raw) if status == 200 else None
                # per request: the scheduler's first_token stamp to the
                # moment the engine's stream yielded it (same clock)
                hops = {}
                for name, rec in engine_times.items():
                    firsts = [t for ctx in rec.get("contexts", [])
                              for s, t in ctx.stages if s == "first_token"]
                    if firsts and "first" in rec:
                        hops[name] = rec["first"] - min(firsts)
                telemetry = dict(
                    profile=profile, t_wave=t_wave, traces=traces, hops=hops,
                    loop_lag_max_s=lag["max"],
                    prepare_s=getattr(service, "profiler_prepare_s", None),
                    window=list(core.runner.device_time._window),
                    compiles=list(core.runner.compiles.records))
            finally:
                await service.stop()
            core_metrics = core.metrics()
            await pipe.close()
            if HTTP_DEVICE == "cuda":
                torch.cuda.empty_cache()
            # the same requests on the roomy engine: the prompt ids the
            # front annotated (completions: the preprocessor's), the same
            # options; n = 2 as two n = 1 requests seeded seed and seed + 1
            roomy_reqs, keys = [], []
            for name, (kind, body) in reqs.items():
                if name == "stop":  # served above, before the stop was set
                    continue
                pr = preprocessed(pre, kind, body)
                prompt_lens[name] = len(pr.token_ids)
                if kind == "chat":
                    ann_line = next(
                        line for line in answers[name][2].decode().split("\n")
                        if line.startswith(": "))
                    ids = json.loads(ann_line[2:])
                    if ids != pr.token_ids:
                        raise AssertionError(f"{name}: annotated prompt ids differ "
                                             "from the preprocessor's")
                    pr = dataclasses.replace(pr, token_ids=ids)
                if name == "n2":
                    for i in range(2):
                        roomy_reqs.append(dataclasses.replace(
                            pr, sampling_options=dataclasses.replace(
                                pr.sampling_options, n=1, seed=HTTP_SEED + i)))
                        keys.append((name, i))
                else:
                    roomy_reqs.append(pr)
                    keys.append((name, None))
            roomy_out = dict(zip(keys, await serve_roomy(roomy, roomy_reqs)))
            roomy_out[("stop", None)] = (stop_ids, stop_lps)
            # a preempted stream re-prefilled its generated tokens: its later
            # logits may differ from the roomy engine's by one bf16 rounding,
            # so its bound needs each chosen token's logit (one forward of
            # the whole sequence on the idle roomy runner)
            prompts_by = {k: pr.token_ids for k, pr in zip(keys, roomy_reqs)}
            prompts_by[("stop", None)] = stop_pr.token_ids
            for key, (toks, _) in roomy_out.items():
                if any(s == "preempted" for ctx in engine_times.get(
                        key[0], {}).get("contexts", []) for s, _ in ctx.stages):
                    chosen_logits[key] = _chosen_logits(
                        torch, roomy.runner, prompts_by[key], toks)
        finally:
            await roomy.close()
        return (models, health, answers, dropped, wave_s, launches,
                metrics_raw.decode(), core_metrics, engine_times, roomy_out,
                telemetry)

    prompt_lens, chosen_logits = {}, {}
    (models, health, answers, dropped, wave_s, launches, metrics_text,
     core_metrics, engine_times, roomy_out, telemetry) = asyncio.run(main())

    # ---- checks
    if json.loads(health)["status"] != "ok" or json.loads(models)["data"][0][
            "id"] != "llama-3.2-1b-random":
        raise AssertionError(f"/health or /v1/models: {health} {models}")
    per_request, lp_fail = {}, []
    for name, (kind, body) in reqs.items():
        status, hdrs, raw, events = answers[name]
        if status != 200:
            raise AssertionError(f"{name}: HTTP {status}: {raw[:400]}")
        if kind == "completion":
            resp = json.loads(raw)
            events = [(hdrs["elapsed_s"], dict(choices=resp["choices"]))]
        choices = sorted({(c or {}).get("choices", [{}])[0].get("index", 0)
                          for _, c in events if c and c.get("choices")})
        for ci in (choices if name == "n2" else [None]):
            evs = [(t, c) for t, c in events if ci is None or (
                c and c.get("choices") and c["choices"][0]["index"] == ci)]
            rec = _stream_record(evs, kind == "chat")
            ids = [tok.token_to_id(t) for t in rec["tokens"]]
            want_ids, want_lps = roomy_out[(name, ci)]
            if name == "stop":
                if rec["finish"] != "stop" or want_ids[:len(ids)] != ids:
                    raise AssertionError(
                        f"stop: finish {rec['finish']}, ids {ids} vs {want_ids}")
                full = tok.decode(want_ids)
                cut = full.find(body["stop"][0])
                if cut < 0 or rec["text"] != full[:cut]:
                    raise AssertionError(f"stop: text {rec['text']!r} vs "
                                         f"{full!r} cut at {body['stop']}")
            else:
                if ids != want_ids:
                    raise AssertionError(
                        f"{name}{'' if ci is None else f'[{ci}]'}: the server's "
                        f"stream differs from the roomy engine's: {ids} vs "
                        f"{want_ids}")
                if not _held_text(rec["text"], tok.decode(ids)):
                    raise AssertionError(f"{name}: text {rec['text']!r} is not "
                                         f"the decode of its ids")
                if rec["finish"] != "length":
                    raise AssertionError(f"{name}: finish {rec['finish']}")
            diffs = [abs(a - b) for a, b in zip(rec["logprobs"], want_lps)]
            lp_err = max(diffs) if diffs else None
            et = engine_times.get(name, {})
            preempted = (name, ci) in chosen_logits
            # the bound: HTTP_LOGPROB_TOL, plus one bf16 unit of the chosen
            # token's logit on a stream that was preempted and re-prefilled
            bounds = [HTTP_LOGPROB_TOL + (_bf16_ulp(chosen_logits[(name, ci)][i])
                                          if preempted else 0.0)
                      for i in range(len(diffs))]
            over = [(i, a, b, bound) for i, (a, b, bound) in enumerate(
                zip(rec["logprobs"], want_lps, bounds)) if abs(a - b) > bound]
            if lp_err is None or over:
                lp_fail.append(dict(request=name, choice=ci, max_abs=lp_err,
                                    preempted=preempted, over=over))
            engine_ttft = (et["first"] - et["in"]) if "first" in et else None
            streamed = kind == "chat"
            per_request[name if ci is None else f"{name}[{ci}]"] = dict(
                prompt_tokens=prompt_lens[name],
                ttft_s=rec["ttft_s"] if streamed else None,
                response_s=None if streamed else rec["ttft_s"],
                engine_ttft_s=engine_ttft,
                front_ttft_share_s=(rec["ttft_s"] - engine_ttft
                                    if streamed and engine_ttft is not None
                                    else None),
                itl_median_s=rec["itl_median_s"] if streamed else None,
                itl_max_s=rec["itl_max_s"] if streamed else None,
                preempted=preempted,
                logprob_max_err=lp_err, tokens=len(ids))
    top = [c for _, c in answers["logprobs"][3] if c and c.get("choices")
           and (c["choices"][0].get("logprobs") or {}).get("content")]
    if not all(len(e["top_logprobs"]) == 5 for c in top
               for e in c["choices"][0]["logprobs"]["content"]):
        raise AssertionError("top_logprobs=5 did not give 5 alternatives")
    d_status, _, _, d_events = dropped
    if d_status != 200 or len(d_events) < HTTP_DISCONNECT_AFTER:
        raise AssertionError(f"the disconnecting request got {d_status}, "
                             f"{len(d_events)} events")
    preemptions = _metric(metrics_text, "dynamo_engine_preemptions")
    served = len(reqs) + 1
    ttft_count = _metric(metrics_text,
                         "dynamo_http_service_time_to_first_token_seconds_count",
                         '{model="llama-3.2-1b-random"}')
    disconnects = _metric(metrics_text, "dynamo_http_service_requests_total",
                          '{model="llama-3.2-1b-random",status="disconnect"}')
    if preemptions <= 0:
        raise AssertionError("the small-KV server did not preempt")
    if ttft_count != served or disconnects != 1:
        raise AssertionError(f"/metrics: {ttft_count} TTFT samples for {served} "
                             f"requests, {disconnects} disconnects")
    if core_metrics["kv_active_blocks"] or _metric(
            metrics_text, "dynamo_engine_kv_active_blocks"):
        raise AssertionError(f"KV blocks still in use after the wave: "
                             f"{core_metrics['kv_active_blocks']}")
    _check_launches("http", launches, ("paged_decode", "paged_flash", "epilogue"))
    plain = launches["epilogue"] - launches["epilogue_finish"]
    if launches["epilogue_finish"] <= 0 or plain <= 0:
        raise AssertionError(f"the epilogue's plain ({plain}) and finish "
                             f"({launches['epilogue_finish']}) forms must both "
                             "launch on the HTTP path")

    tel = _http_telemetry_checks(telemetry, metrics_text, per_request, reqs,
                                 on_card=HTTP_DEVICE == "cuda")
    tmp.cleanup()
    ttfts = [r["ttft_s"] for r in per_request.values() if r["ttft_s"] is not None]
    emit("engine_http_telemetry", card=smi, **tel)
    emit("engine_http", model="Llama-3.2-1B shapes, seeded random bf16 weights, "
         "synthetic 128,256-id byte-level BPE", server=HTTP_SERVER,
         roomy_kv_blocks=HTTP_ROOMY_BLOCKS, http_requests=served,
         engine_requests=len(roomy_out) + 1, wave_s=wave_s,
         model_dir_write_s=write_s, tokenizer_load_s=load_s,
         encode_us_per_token=dict(cold=cold_us, warm=warm_us,
                                  prompt_tokens=n_tok),
         edge=per_request,
         ttft_s=dict(min=min(ttfts), median=float(np.median(ttfts)),
                     max=max(ttfts)),
         front_share_s=dict(
             median=float(np.median([r["front_ttft_share_s"]
                                     for r in per_request.values()
                                     if r["front_ttft_share_s"] is not None]))),
         preemptions=preemptions, ttft_samples=ttft_count,
         kv_active_blocks_after=core_metrics["kv_active_blocks"],
         launches=launches, epilogue_plain=plain,
         epilogue_finish=launches["epilogue_finish"],
         logprob_over_tol=lp_fail, card=smi)
    if lp_fail:
        raise AssertionError(f"logprobs differ from the roomy engine's by more "
                             f"than {HTTP_LOGPROB_TOL}: {lp_fail}")
    return dict(paged_decode=launches["paged_decode"],
                paged_flash=launches["paged_flash"],
                sampling_epilogue=plain,
                sampling_epilogue_finish=launches["epilogue_finish"])


def _windowed_busy(samples, t0, t1, phase=None):
    """The device-time estimator's busy share over [t0, t1] from its
    rolling samples ``(t, phase, busy, bubble, bytes)``: the gauge's own
    arithmetic, restricted to the profiler's window."""
    rows = [s for s in samples if t0 <= s[0] <= t1
            and (phase is None or s[1] == phase)]
    busy, bubble = sum(s[2] for s in rows), sum(s[3] for s in rows)
    return busy / (busy + bubble) if busy + bubble > 0 else None


def _http_telemetry_checks(tel, metrics_text, per_request, reqs, on_card):
    """engine_http's telemetry checks: each request's trace (its stage
    marks in order, its first_token mark against the client's TTFT), the
    device-time family, the busy ratio and the roofline on /metrics, the
    SLO verdicts summing to the finished requests, the profiler capture
    (kernels 1, 2 and 3 by name on a card) beside the busy gauge, and the
    compile tracker's startup and late counts."""
    order = ("admission", "prefill", "first_token", "completion")
    ttft_gaps = {}
    for name, trace in tel["traces"].items():
        if trace is None or trace["status"] != "success":
            raise AssertionError(f"{name}: no successful trace: {trace}")
        marks = {}
        for span in trace["spans"]:
            base = span["name"].split("#")[0]
            marks.setdefault(base, span["offset_s"] + span["duration_s"])
        # a stop-string finish cancels the engine request from the
        # detokenizer: the trace may close before the scheduler's
        # "completion" mark (as in the reference)
        missing = [m for m in order[:3] if m not in marks]
        present = [marks[m] for m in order if m in marks]
        if missing or present != sorted(present):
            raise AssertionError(f"{name}: stage marks out of order or "
                                 f"missing {missing}: {trace['spans']}")
        edge = per_request.get(name, {})
        client, share = edge.get("ttft_s"), edge.get("front_ttft_share_s")
        hop = tel["hops"].get(name)
        if client is not None and share is not None and hop is not None:
            gap = client - marks["first_token"]
            ttft_gaps[name] = dict(gap=gap, front_share=share, hop=hop)
            if not (-HTTP_TRACE_TTFT_SLACK_S <= gap
                    <= share + hop + HTTP_TRACE_TTFT_SLACK_S):
                raise AssertionError(
                    f"{name}: the trace's first_token mark "
                    f"{marks['first_token']:.4f} s vs the client's TTFT "
                    f"{client:.4f} s (front share {share:.4f} s, emit to "
                    f"stream {hop:.4f} s)")
    busy = _metric(metrics_text, "dynamo_engine_device_busy_ratio",
                   '{phase="decode"}')
    roof = _metric(metrics_text, "dynamo_engine_roofline_fraction")
    dt_count = sum(float(line.rpartition(" ")[2]) for line in
                   metrics_text.splitlines() if line.startswith(
                       "dynamo_engine_device_time_seconds_count{"))
    if not (0.0 < busy <= 1.0 and 0.0 < roof <= 1.0 and dt_count > 0):
        raise AssertionError(f"device time on /metrics: busy {busy}, "
                             f"roofline {roof}, {dt_count} observations")
    def slo(met):
        labels = f'{{met="{met}",slo="request"}}'
        key = "dynamo_slo_attainment_total" + labels
        return (_metric(metrics_text, "dynamo_slo_attainment_total", labels)
                if key in metrics_text else 0.0)

    verdicts = slo("true") + slo("false")
    if verdicts != len(reqs):
        raise AssertionError(f"SLO verdicts {verdicts} for {len(reqs)} "
                             "finished requests")
    status, _, raw, _ = tel["profile"]
    if status != 200:
        raise AssertionError(f"/debug/profile: HTTP {status}: {raw[:400]}")
    prof = json.loads(raw)
    summary = prof["summary"]
    found = {k: sum(v["launches"] for n, v in summary["kernels"].items()
                    if want in n)
             for k, want in HTTP_PROFILE_KERNELS.items()}
    if on_card and not all(found.values()):
        raise AssertionError(f"the profile lacks a kernel: {found} of "
                             f"{sorted(summary['kernels'])[:20]}")
    # the capture window starts with the request (an executor picks it up
    # within milliseconds of the wave's start)
    t0 = tel["t_wave"]
    t1 = t0 + HTTP_PROFILE_S
    compiles = tel["compiles"]
    return dict(
        busy_ratio_gauge_decode=busy, roofline_fraction_gauge=roof,
        device_time_observations=dt_count,
        window_busy_estimator=dict(
            all=_windowed_busy(tel["window"], t0, t1),
            decode=_windowed_busy(tel["window"], t0, t1, "decode")),
        profiler=dict(window_s=summary["window_s"],
                      kernel_busy_share=summary["kernel_busy_share"],
                      kernel_launches=summary["kernel_launches"],
                      kernels_found=found,
                      top=dict(list(summary["kernels"].items())[:6])),
        slo_verdicts=verdicts, wave_loop_lag_max_s=tel["loop_lag_max_s"],
        profile_stages_s=summary.get("stages_s"),
        profiler_prepare_s=tel["prepare_s"],
        slo_met=slo("true"),
        trace_ttft_gap_s=ttft_gaps,
        first_dispatches=dict(
            startup=sum(r["phase"] == "startup" for r in compiles),
            late=sum(r["phase"] == "late" for r in compiles),
            late_programs=sorted({r["program"] for r in compiles
                                  if r["phase"] == "late"}),
            late_max_s=max([r["duration_s"] for r in compiles
                            if r["phase"] == "late"], default=0.0)))


# ------------------------------------------------------------ engine_guided

# guided JSON and /v1/embeddings behind the OpenAI front, on engine_http's
# model directory and synthetic tokenizer, each engine built by the CLI's
# builders: a synchronous engine, then the chained loop
GUIDED_SERVER = dict(max_model_len=2048, num_kv_blocks=1024, max_batch_size=16)
GUIDED_CHAIN = dict(decode_pipeline_depth=2, multi_step_decode=4)
# no prefix cache: leg B's chats run twice, and a prefix hit would prefill
# the second run another way
GUIDED_EXTRA = dict(max_prefill_tokens_per_step=512, enable_prefix_caching=False)
GUIDED_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string"}, "count": {"type": "integer"},
    "active": {"type": "boolean"},
    "color": {"enum": ["red", "green", "blue"]},
    "scores": {"type": "array", "items": {"type": "number"}}},
    "required": ["name", "count", "active", "color", "scores"]}
# a grammar small enough for a device table (24 states): its requests run
# after the wave, alone, so the chain can take them
GUIDED_TABLE_SCHEMA = {"type": "array", "items": {"type": "boolean"}}
GUIDED_NEW_TOKENS = 128
GUIDED_TEMPERATURE = 0.8
GUIDED_SEED = 1818
GUIDED_PROMPT_WORDS = (40, 90, 60, 120, 75, 30, 100, 50)   # the 8 guided
GUIDED_UNGUIDED_WORDS = (300, 180)                          # the 2 beside them
GUIDED_TABLE_REQUESTS = 2
EMBED_INPUT_TOKENS = (16, 40, 120, 300, 600, 900, 1200, 1500)
EMBED_CHAT_WORDS = (220, 140)
EMBED_COSINE = 0.999
EMBED_DIM = FLAGSHIP["hidden_size"]
GUIDED_CLI_FLAGS = ["--decode-pipeline-depth", "2", "--multi-step-decode", "4",
                    "--device-finish", "on", "--fused-epilogue", "on",
                    "--guided-table-max-states", "128", "--spec-ngram-match", "2",
                    "--no-device-stop-strings"]
GUIDED_CLI_FIELDS = dict(decode_pipeline_depth=2, multi_step_decode=4,
                         device_finish="on", fused_epilogue="on",
                         guided_table_max_states=128, spec_ngram_match=2,
                         device_stop_strings=False, guided_device_table=True,
                         spec_ngram_tokens=0, sp_size=1)


def _json_valid(obj, schema) -> bool:
    """``obj`` against the schema subset guided decoding enforces
    (object/required, string, number, integer, boolean, null, enum,
    array); no JSON-schema package on the card."""
    if schema is True or schema == {} or schema is None:
        return True
    if "enum" in schema:
        return any(obj == v and type(obj) is type(v) for v in schema["enum"])
    t = schema.get("type")
    if t == "object" or (t is None and "properties" in schema):
        props = schema.get("properties")
        return (isinstance(obj, dict)
                and set(schema.get("required", ())) <= set(obj)
                and (props is None or (set(obj) <= set(props) and all(
                    _json_valid(v, props[k]) for k, v in obj.items()))))
    if t == "array":
        return isinstance(obj, list) and all(
            _json_valid(v, schema.get("items", True)) for v in obj)
    checks = {"string": lambda o: isinstance(o, str),
              "integer": lambda o: isinstance(o, int) and not isinstance(o, bool),
              "number": lambda o: isinstance(o, (int, float))
              and not isinstance(o, bool),
              "boolean": lambda o: isinstance(o, bool),
              "null": lambda o: o is None}
    return checks[t](obj) if t in checks else True


def _guided_verdict(text, finish, schema):
    """A reply that finished ``stop`` parses and validates; one cut at
    ``length`` is a legal prefix under a fresh walk of the grammar."""
    from dynamo_tpu_torch.engine.guided import JsonGrammar

    g = JsonGrammar([], schema)
    state = g.run_piece(g.initial(), text)
    if finish == "stop":
        try:
            obj = json.loads(text)
        except ValueError as e:
            raise AssertionError(f"guided reply does not parse: {text!r}: {e}")
        if not _json_valid(obj, schema if schema is not None
                           else {"type": "object"}):
            raise AssertionError(f"guided reply fails its schema: {text!r}")
        return "valid"
    if finish != "length" or state is None:
        raise AssertionError(f"guided reply ({finish}) is no legal prefix: "
                             f"{text!r}")
    return "prefix"


class _SweepLog:
    """Times every vocabulary sweep of a JSON grammar
    (``JsonGrammar.transitions``) by the grammar and the thread it ran on:
    the scheduler's loop (the main thread), a device-table compile, or the
    serving build's first sweep (another executor thread)."""

    def __init__(self):
        import threading

        from dynamo_tpu_torch.engine import guided

        self.records = []
        self.tls = threading.local()
        self._guided = guided
        self._orig = orig = guided.JsonGrammar.transitions
        log = self

        def timed(grammar, state):
            t0 = time.monotonic()
            out = orig(grammar, state)
            t1 = time.monotonic()
            where = getattr(log.tls, "where", None) or (
                "loop" if threading.current_thread() is threading.main_thread()
                else "build")
            log.records.append((id(grammar), where, t0, t1, len(out)))
            return out

        guided.JsonGrammar.transitions = timed

    def restore(self):
        self._guided.JsonGrammar.transitions = self._orig

    def hook_compiles(self, scheduler, outcomes):
        """Record each device-table compile: its seconds, sweeps and table
        (None: past the bound or the budget)."""
        compile_table = scheduler._compile_guided_table
        log = self

        def timed(er):
            log.tls.where = "compile"
            t0 = time.monotonic()
            try:
                table = compile_table(er)
            finally:
                log.tls.where = None
            outcomes.append(dict(
                grammar=id(er.guided.grammar), seconds=time.monotonic() - t0,
                n_states=None if table is None else table.n_states,
                start=t0))
            return table

        scheduler._compile_guided_table = timed


def _guided_requests(words_text):
    """The leg A wave: 4 json_object and 4 json_schema chats (half greedy,
    half seeded at GUIDED_TEMPERATURE), beside 2 unguided streams."""
    def chat(content, **kw):
        return dict(model="llama-3.2-1b-random", stream=True, logprobs=True,
                    max_tokens=GUIDED_NEW_TOKENS,
                    messages=[{"role": "user", "content": content}], **kw)

    reqs = {}
    for i, n in enumerate(GUIDED_PROMPT_WORDS):
        kind = "object" if i < 4 else "schema"
        samp = (dict(temperature=0.0) if i % 2 == 0 else
                dict(temperature=GUIDED_TEMPERATURE, seed=GUIDED_SEED + i))
        rf = ({"type": "json_object"} if kind == "object" else
              {"type": "json_schema", "json_schema": {
                  "name": "record", "schema": GUIDED_SCHEMA}})
        reqs[f"{kind}{i}"] = chat(words_text(n), response_format=rf, **samp)
    for i, n in enumerate(GUIDED_UNGUIDED_WORDS):
        reqs[f"unguided{i}"] = chat(words_text(n), temperature=0.0,
                                    ignore_eos=True)
    return reqs


def _guided_schema_of(body):
    rf = body.get("response_format")
    if not rf:
        return "none", None
    if rf["type"] == "json_object":
        return "object", None
    return "schema", rf["json_schema"]["schema"]


def _largest_gap_over_sweeps(records, wave_t0, loop_sweeps):
    """The unguided streams' largest inter-chunk gap that holds the end of
    a sweep on the scheduler's loop, and their largest gap overall."""
    worst, overall = 0.0, 0.0
    for rec in records:
        times = [wave_t0 + t for t in rec["times"]]
        for a, b in zip(times, times[1:]):
            overall = max(overall, b - a)
            if any(a <= t1 <= b for _, _, _, t1, _ in loop_sweeps):
                worst = max(worst, b - a)
    return worst, overall


async def _guided_leg_a(torch, model_dir, extra, mode, reqs, table_body, sweeps):
    """One engine of leg A (``mode`` "sync" or "chained"), served over HTTP:
    the wave, then the device-table grammar's requests alone. With the
    chained engine also leg B. Returns the answers and the engine's
    numbers."""
    from dynamo_tpu_torch.cli import run
    from dynamo_tpu_torch.http.service import HttpService, ModelManager

    kw = dict(GUIDED_SERVER, **(GUIDED_CHAIN if mode == "chained" else {}))
    t0 = time.monotonic()
    pipe, _ = await run.build_engine("torch", _cli_flags(model_dir, extra, **kw))
    build_s = time.monotonic() - t0
    core = pipe.core_engine
    outcomes = []
    sweeps.hook_compiles(core.scheduler, outcomes)
    manager = ModelManager()
    manager.add_chat_model("llama-3.2-1b-random", pipe)
    manager.add_completion_model("llama-3.2-1b-random", pipe)
    service = HttpService(manager, "127.0.0.1", 0)
    service.metrics.register_callback_gauges("dynamo_engine", core.metrics)
    await service.start()
    port = service.port
    out = dict(mode=mode, build_s=build_s)
    try:
        # the wave: unguided streams first (they hold their slots), then
        # the guided chats at once; the first guided request builds the
        # piece table and its grammar
        _reset_launches()
        n0 = len(sweeps.records)
        wave_t0 = time.monotonic()
        sent = {name: asyncio.ensure_future(http_request(
            port, "POST", "/v1/chat/completions", body,
            headers={"X-Request-Id": f"{mode}-{name}"}))
            for name, body in reqs.items()}
        answers = dict(zip(sent, await _guarded(
            asyncio.gather(*sent.values()), core)))
        out["wave_s"] = time.monotonic() - wave_t0
        out["wave_t0"] = wave_t0
        out["answers"] = answers
        out["wave_sweeps"] = sweeps.records[n0:]
        # the device-table grammar: one request compiles its table, then
        # GUIDED_TABLE_REQUESTS together, counted from 0
        table_reqs = [dict(table_body, messages=[{"role": "user", "content": c}])
                      for c in ("list some flags", "more flags please",
                                "flags again")]
        await _guarded(http_request(port, "POST", "/v1/chat/completions",
                                    table_reqs[0]), core)
        before = _read_launches()
        table_answers = await _guarded(asyncio.gather(*(
            http_request(port, "POST", "/v1/chat/completions", b)
            for b in table_reqs[1: 1 + GUIDED_TABLE_REQUESTS])), core)
        after = _read_launches()
        out["table_answers"] = table_answers
        out["table_extra_bias"] = (after["epilogue_extra_bias"]
                                   - before["epilogue_extra_bias"])
        out["launches"] = after
        out["metrics"] = core.metrics()
        out["outcomes"] = outcomes
        out["grammars"] = {key: id(g) for key, g in core._json_grammars.items()
                           if not asyncio.isfuture(g)}
        if mode == "chained":
            out["bound_checks"] = _guided_bound_checks(core, sweeps)
        out["piece_table_s"] = core.piece_table_s
        if mode == "chained":
            out["leg_b"] = await _guided_leg_b(torch, port, core)
    finally:
        await service.stop()
        await pipe.close()
    return out


def _guided_bound_checks(core, sweeps):
    """Each grammar of the engine compiled once more, off the engine, at the
    reference's bound and budget (``max_states`` 256, ``budget_s`` 2.0):
    whether its table fits, its state count and the seconds it took. The
    scheduler stops at the first row it cannot chain, so a grammar behind
    another's fallback is never compiled by the engine itself."""
    from dynamo_tpu_torch.engine.guided import JsonConstraint, compile_device_table

    out = {}
    eos = 128009  # write_model_dir's eos_token_id, <|eot_id|>
    for key, g in core._json_grammars.items():
        if asyncio.isfuture(g):
            continue
        n0 = len(sweeps.records)
        sweeps.tls.where = "bound_check"
        t0 = time.monotonic()
        try:
            table = compile_device_table(JsonConstraint(g),
                                         core.config.model.vocab_size, [eos])
        finally:
            sweeps.tls.where = None
        secs = time.monotonic() - t0
        n = len(sweeps.records) - n0
        out[id(g)] = dict(
            outcome="compiled" if table is not None else (
                "past_budget" if secs >= 2.0 else "past_bound"),
            n_states=None if table is None else table.n_states,
            states_swept=n, seconds=secs,
            seconds_a_state=secs / n if n else None)
    return out


async def _guided_leg_b(torch, port, core):
    """/v1/embeddings while 2 greedy chat streams decode: the chats first
    alone, then again beside 8 embedding requests (4 strings, 4 token-id
    lists of 16 to 1,500 tokens)."""
    from dynamo_tpu_torch.llm.tokenizer import HFTokenizer

    tok = HFTokenizer.from_pretrained_dir(core._model_path)
    words = _word_ids(tok)
    rng = np.random.default_rng(GUIDED_SEED + 1)

    def word_ids(n):
        return [words[int(i)] for i in rng.integers(0, len(words), n)]

    chats = [dict(model="llama-3.2-1b-random", stream=True, logprobs=True,
                  max_tokens=GUIDED_NEW_TOKENS, temperature=0.0, ignore_eos=True,
                  messages=[{"role": "user", "content": tok.decode(word_ids(n))}])
             for n in EMBED_CHAT_WORDS]
    inputs = [tok.decode(word_ids(n)) if i % 2 == 0 else word_ids(n)
              for i, n in enumerate(EMBED_INPUT_TOKENS)]
    alone = await _guarded(asyncio.gather(*(
        http_request(port, "POST", "/v1/chat/completions", c) for c in chats)),
        core)
    streams = [asyncio.ensure_future(http_request(
        port, "POST", "/v1/chat/completions", c)) for c in chats]
    while core.metrics()["request_active_slots"] < len(chats):
        await asyncio.sleep(0.01)

    async def embed(inp):
        t0 = time.monotonic()
        ans = await http_request(port, "POST", "/v1/embeddings", dict(
            model="llama-3.2-1b-random", input=inp))
        return ans, time.monotonic() - t0

    embeds = await _guarded(asyncio.gather(*(embed(i) for i in inputs)), core)
    beside = await _guarded(asyncio.gather(*streams), core)
    ids = [tok.encode(i) if isinstance(i, str) else i for i in inputs]
    short = [int(i) for i in np.argsort([len(x) for x in ids])[:2]]
    return dict(alone=alone, beside=beside, embeds=embeds,
                tokens=[len(x) for x in ids], short=short,
                reference=_embed_reference(torch, core, [ids[i] for i in short]))


def _embed_reference(torch, core, inputs):
    """``inputs``' vectors from an f32 copy of the engine's weights through
    the plain route on the CPU (``llama.embed_forward``), L2-normalised."""
    from dynamo_tpu_torch.models import llama

    runner = core.runner

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.float().cpu()
                for k, v in tree.items()}

    params = f32(runner.params)
    out = []
    for ids in inputs:
        n = len(ids)
        t = torch.tensor([ids], dtype=torch.int64)
        pos = torch.arange(n, dtype=torch.int64)[None]
        v = llama.embed_forward(params, runner.config.model, t, pos,
                                torch.tensor([n]))[0].numpy().astype(np.float64)
        out.append(v / np.linalg.norm(v))
    return out


def engine_guided_phase(torch, dev, smi):
    """Guided JSON and /v1/embeddings on the card (the module docstring's
    ``engine_guided``)."""
    import tempfile

    from dynamo_tpu_torch.llm.tokenizer import HFTokenizer

    tmp = tempfile.TemporaryDirectory(prefix="engine_guided_")
    model_dir = write_model_dir(Path(tmp.name) / "llama-3.2-1b-random")
    extra = Path(tmp.name) / "extra.json"
    extra.write_text(json.dumps(GUIDED_EXTRA))
    tok = HFTokenizer.from_pretrained_dir(model_dir)
    words = _word_ids(tok)
    rng = np.random.default_rng(GUIDED_SEED)

    def words_text(n):
        return tok.decode([words[int(i)] for i in rng.integers(0, len(words), n)])

    reqs = _guided_requests(words_text)
    table_body = dict(model="llama-3.2-1b-random", stream=True, logprobs=True,
                      max_tokens=GUIDED_NEW_TOKENS, temperature=0.0,
                      response_format={"type": "json_schema", "json_schema": {
                          "name": "flags", "schema": GUIDED_TABLE_SCHEMA}})
    sweeps = _SweepLog()
    try:
        legs = {mode: asyncio.run(_guided_leg_a(
            torch, model_dir, str(extra), mode, reqs, table_body, sweeps))
            for mode in ("sync", "chained")}
    finally:
        sweeps.restore()

    # ---- leg A: validity, determinism, tables, costs
    verdicts, per_leg = {}, {}
    for mode, leg in legs.items():
        recs = {}
        for name, (status, _, raw, events) in leg["answers"].items():
            if status != 200:
                raise AssertionError(f"{mode} {name}: HTTP {status}: {raw[:300]}")
            recs[name] = _stream_record(events, True)
            recs[name]["times"] = [t for t, c in events if c and c.get(
                "choices") and ((c["choices"][0].get("delta") or {}).get("content")
                                or c["choices"][0].get("logprobs"))]
            kind, schema = _guided_schema_of(reqs[name])
            if kind == "none":
                if (recs[name]["finish"] != "length"
                        or len(recs[name]["tokens"]) != GUIDED_NEW_TOKENS):
                    raise AssertionError(f"{mode} {name}: {recs[name]['finish']}, "
                                         f"{len(recs[name]['tokens'])} tokens")
                continue
            verdicts[(mode, name)] = _guided_verdict(
                recs[name]["text"], recs[name]["finish"], schema)
        for status, _, raw, events in leg["table_answers"]:
            if status != 200:
                raise AssertionError(f"{mode} table request: HTTP {status}")
            rec = _stream_record(events, True)
            verdicts[(mode, "table")] = _guided_verdict(
                rec["text"], rec["finish"], GUIDED_TABLE_SCHEMA)
        leg["records"] = recs
        leg["table_texts"] = [_stream_record(e, True)["text"]
                              for _, _, _, e in leg["table_answers"]]
    for name, body in reqs.items():
        if body.get("response_format") and body["temperature"] == 0.0:
            a, b = legs["sync"]["records"][name], legs["chained"]["records"][name]
            if (a["tokens"], a["finish"]) != (b["tokens"], b["finish"]):
                raise AssertionError(
                    f"{name}: the greedy guided stream differs between the "
                    f"synchronous and the chained engine: {a['text']!r} vs "
                    f"{b['text']!r}")
    if legs["sync"]["table_texts"] != legs["chained"]["table_texts"]:
        raise AssertionError("the device-table grammar's streams differ: "
                             f"{legs['sync']['table_texts']} vs "
                             f"{legs['chained']['table_texts']}")
    chained = legs["chained"]
    launches = chained["launches"]
    _check_launches("guided", launches, ("paged_decode", "paged_flash", "epilogue"))
    if chained["table_extra_bias"] <= 0:
        raise AssertionError("the device table's grammar never launched the "
                             "epilogue's extra_bias form on the chained engine")
    if legs["sync"]["table_extra_bias"]:
        raise AssertionError("the synchronous engine launched extra_bias")
    tables = {}
    for mode, leg in legs.items():
        names = {gid: key for key, gid in leg["grammars"].items()}
        label = {json.dumps({"type": "json_object"}, sort_keys=True): "object"}
        for key in names.values():
            spec = json.loads(key)
            if spec.get("schema") == GUIDED_SCHEMA:
                label[key] = "schema"
            elif spec.get("schema") == GUIDED_TABLE_SCHEMA:
                label[key] = "bool_array"
        for gid, key in names.items():
            mine = [r for r in sweeps.records if r[0] == gid]
            comp = [o for o in leg["outcomes"] if o["grammar"] == gid]
            tables[f"{mode}/{label.get(key, key)}"] = dict(
                engine_compiles=[(
                    "compiled" if o["n_states"] is not None else
                    ("past_budget" if o["seconds"] >= 2.0 else "past_bound"),
                    o["n_states"], o["seconds"]) for o in comp],
                compile_sweeps=sum(1 for r in mine if r[1] == "compile"),
                at_reference_bound=leg.get("bound_checks", {}).get(gid),
                sweep_s_a_state=(float(np.mean([r[3] - r[2] for r in mine
                                                if r[1] != "bound_check"]))
                                 if mine else None),
                loop_sweeps=sum(1 for r in mine if r[1] == "loop"),
                loop_sweep_max_s=max([r[3] - r[2] for r in mine
                                      if r[1] == "loop"] or [0.0]))
        loop_sweeps = [r for r in leg["wave_sweeps"] if r[1] == "loop"]
        unguided = [leg["records"][n] for n in reqs if n.startswith("unguided")]
        worst, overall = _largest_gap_over_sweeps(unguided, leg["wave_t0"],
                                                  loop_sweeps)
        guided_ttfts = {n: leg["records"][n]["ttft_s"] for n in reqs
                        if not n.startswith("unguided")}
        first = min(guided_ttfts.values())
        per_leg[mode] = dict(
            build_s=leg["build_s"], wave_s=leg["wave_s"],
            piece_table_s=leg["piece_table_s"],
            guided_ttft_s=guided_ttfts,
            unguided_ttft_s=[r["ttft_s"] for r in unguided],
            first_guided_extra_ttft_s=first - min(r["ttft_s"] for r in unguided),
            unguided_itl_median_s=float(np.median([r["itl_median_s"]
                                                   for r in unguided])),
            unguided_gap_max_s=overall, unguided_gap_over_loop_sweep_s=worst,
            loop_sweeps=len(loop_sweeps),
            loop_sweep_s=sum(r[3] - r[2] for r in loop_sweeps),
            sync_fallback=leg["metrics"].get("sync_fallback"),
            chain_len_max=leg["metrics"].get("chain_len_max"),
            table_extra_bias_launches=leg["table_extra_bias"],
            verdicts={n: v for (m, n), v in verdicts.items() if m == mode})

    # ---- leg B: embeddings beside two decoding chats
    leg_b = chained["leg_b"]
    for (a, b) in zip(leg_b["alone"], leg_b["beside"]):
        ra, rb = _stream_record(a[3], True), _stream_record(b[3], True)
        if a[0] != 200 or b[0] != 200 or ra["tokens"] != rb["tokens"]:
            raise AssertionError("a chat stream changed beside the embeddings: "
                                 f"{ra['text']!r} vs {rb['text']!r}")
    embed_s, vecs = [], []
    for ((status, _, raw, _), secs), n_tok in zip(leg_b["embeds"],
                                                   leg_b["tokens"]):
        if status != 200:
            raise AssertionError(f"/v1/embeddings: HTTP {status}: {raw[:300]}")
        body = json.loads(raw)
        v = np.asarray(body["data"][0]["embedding"], np.float64)
        if (v.shape != (EMBED_DIM,) or abs(np.linalg.norm(v) - 1) > 1e-4
                or not np.isfinite(v).all()):
            raise AssertionError(f"an embedding of shape {v.shape}, norm "
                                 f"{np.linalg.norm(v)}")
        if body["usage"] != {"prompt_tokens": n_tok, "total_tokens": n_tok}:
            raise AssertionError(f"usage {body['usage']} for {n_tok} tokens")
        embed_s.append(secs)
        vecs.append(v)
    # two short inputs against an f32 copy of the engine's weights on the CPU
    cos = [float(ref @ vecs[i] / np.linalg.norm(vecs[i]))
           for i, ref in zip(leg_b["short"], leg_b["reference"])]
    if min(cos) < EMBED_COSINE:
        raise AssertionError(f"embeddings against the f32 CPU forward: cosine "
                             f"{cos} < {EMBED_COSINE}")

    # ---- leg C: the CLI with the mapped engine flags
    cli = _guided_cli(model_dir, str(extra))
    tmp.cleanup()
    emit("engine_guided", model="Llama-3.2-1B shapes, seeded random bf16 "
         "weights, synthetic 128,256-id byte-level BPE", server=GUIDED_SERVER,
         chained=GUIDED_CHAIN, legs=per_leg, tables=tables,
         embed=dict(input_tokens=list(leg_b["tokens"]), embed_s=embed_s,
                    cosine_vs_cpu_f32=cos, dim=EMBED_DIM,
                    chats_alone_ttft_s=[_stream_record(a[3], True)["ttft_s"]
                                        for a in leg_b["alone"]],
                    chats_beside_gap_max_s=[
                        _stream_record(b[3], True)["itl_max_s"]
                        for b in leg_b["beside"]]),
         launches=launches, cli=cli, card=smi)
    return dict(paged_decode=launches["paged_decode"],
                paged_flash=launches["paged_flash"],
                sampling_epilogue=launches["epilogue"] - launches["epilogue_finish"],
                sampling_epilogue_finish=launches["epilogue_finish"])


def _guided_cli(model_dir, extra_path):
    """``python3 -m dynamo_tpu_torch.cli.run in=http out=torch`` as a user
    starts it (on the card by default), with the mapped engine flags: the
    flags give the reference's EngineConfig fields, and the server reaches
    /health, chains a chat, serves a guided reply and an embedding, and
    exits 0 on SIGINT."""
    import signal

    from dynamo_tpu_torch.cli import run
    from dynamo_tpu_torch.engine.serving import engine_config_from_mdc

    base = ["--model-path", model_dir, "--allow-random-weights",
            "--extra-engine-args", extra_path, "--max-model-len", "2048",
            "--num-kv-blocks", "1024", "--http-host", "127.0.0.1",
            "--http-port", "0"] + (["--device", "cpu"]
                                   if HTTP_DEVICE == "cpu" else [])
    flags = run.parse_flags(base + GUIDED_CLI_FLAGS)
    cfg = engine_config_from_mdc(run.load_mdc(flags), flags)
    fields = {k: getattr(cfg, k) for k in GUIDED_CLI_FIELDS}
    if fields != GUIDED_CLI_FIELDS:
        raise AssertionError(f"the CLI's flags gave {fields}")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.cli.run", "in=http",
         "out=torch"] + base + GUIDED_CLI_FLAGS,
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        while "listening on" not in line:
            line = proc.stdout.readline()
            if (not line and proc.poll() is not None) or (
                    time.monotonic() - t0 > HTTP_CLI_TIMEOUT_S):
                raise AssertionError(f"the CLI did not start: {line!r} "
                                     f"{proc.stderr.read()[-3000:]}")
        port = int(line.strip().rsplit(":", 1)[1])
        startup_s = time.monotonic() - t0

        async def ask():
            h = await http_request(port, "GET", "/health")
            chat = await http_request(port, "POST", "/v1/chat/completions", dict(
                model="llama-3.2-1b-random", max_tokens=16, temperature=0.0,
                ignore_eos=True,
                messages=[{"role": "user", "content": "hello there"}]))
            guided = await http_request(port, "POST", "/v1/chat/completions", dict(
                model="llama-3.2-1b-random", max_tokens=24, temperature=0.0,
                response_format={"type": "json_object"},
                messages=[{"role": "user", "content": "json please"}]))
            emb = await http_request(port, "POST", "/v1/embeddings", dict(
                model="llama-3.2-1b-random", input=["hello there", "json"]))
            m = await http_request(port, "GET", "/metrics")
            return h, chat, guided, emb, m
        h, chat, guided_ans, emb, m = asyncio.run(ask())
        if h[0] != 200 or json.loads(h[2])["status"] != "ok":
            raise AssertionError(f"/health: {h[0]} {h[2][:200]}")
        for name, ans in (("chat", chat), ("guided", guided_ans),
                          ("embeddings", emb)):
            if ans[0] != 200:
                raise AssertionError(f"the CLI's {name}: HTTP {ans[0]}: "
                                     f"{ans[2][:300]}")
        if json.loads(chat[2])["usage"]["completion_tokens"] < 1:
            raise AssertionError(f"the CLI's chat: {chat[2][:300]}")
        gbody = json.loads(guided_ans[2])
        verdict = _guided_verdict(gbody["choices"][0]["message"]["content"],
                                  gbody["choices"][0]["finish_reason"], None)
        bursts = _metric(m[2].decode(), "dynamo_engine_decode_pipeline_bursts")
        if bursts <= 0:
            raise AssertionError("the CLI's engine never chained a burst")
        if len(json.loads(emb[2])["data"]) != 2:
            raise AssertionError("the CLI's embeddings answer has no 2 rows")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"the CLI exited {rc} on SIGINT: "
                                 f"{proc.stderr.read()[-3000:]}")
        return dict(startup_s=startup_s, fields=fields, guided=verdict,
                    pipeline_bursts=bursts, exit_code=rc,
                    total_s=time.monotonic() - t0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ------------------------------------------------------------ engine_graph

# the inference graph on the one card: a dynstore broker, two token-level
# workers (Llama-3.2-1B at full width and depth, random weights, the
# synthetic tokenizer of engine_http), a KV-routing processor and a
# round-robin one beside it, each with a pure frontend that discovers its
# model (a model's registration is by name within a namespace, so the
# round-robin pair registers in a namespace of its own)
GRAPH_NS = "graph"
GRAPH_RR_NS = "graph_rr"
GRAPH_WORKER_FLAGS = ["--max-model-len", "16384", "--num-kv-blocks", "1024",
                      "--kv-block-size", "16"]
# two groups a wave (four until PR 20: the script's time limit)
GRAPH_GROUPS, GRAPH_FOLLOWERS = 2, 3
GRAPH_PREFIX, GRAPH_TAIL = 1024, 64   # tokens (words of one token each)
GRAPH_AFTER_KILL = 4
GRAPH_LONG_PROMPT = 12000
# the primary lease's TTL (DynStoreClient.grant_lease's default): a killed
# worker's requests must run on the survivor within it plus the margin
GRAPH_LEASE_TTL_S, GRAPH_MARGIN_S = 10.0, 20.0
GRAPH_START_TIMEOUT_S = 300
GRAPH_TIMEOUT_S = 400
GRAPH_SEED = 4321
GRAPH_SAMPLED = dict(temperature=0.8, seed=77)
GRAPH_DEVICE = "cuda"                 # a CPU rehearsal sets "cpu"
# leg B of the KV tiers: both workers serve and pull prefixes (the cluster
# KV fabric), and each drops its first pull serve mid-stream once (the
# fault the puller must fall back from)
GRAPH_PULL_FLAGS = ["--prefix-pull"]
GRAPH_PULL_FAULT = {"DYN_FAULT": "transfer_conn_drop:once"}
# the fleet view: each worker and the kv processor serve a --metrics-port
# sidecar (advertised in discovery), the kv frontend runs the hub
GRAPH_HUB_INTERVAL_S = 0.5
GRAPH_FLEET_TIMEOUT_S = 30


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_role(args, name, logdir, env=None):
    """One role of the graph as a user starts it (``python3 -m ...`` from
    the checkout's root, ``env`` added to this process's environment);
    stderr goes to ``<logdir>/<name>.log``."""
    err = open(Path(logdir) / f"{name}.log", "w")
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=err, text=True,
                            env=dict(os.environ, **(env or {})))
    proc.role, proc.log = name, Path(logdir) / f"{name}.log"
    err.close()
    return proc


def _role_tail(proc) -> str:
    return proc.log.read_text(errors="replace")[-3000:]


def _await_line(proc, needle, deadline):
    while True:
        line = proc.stdout.readline()
        if needle in line:
            return line
        if (not line and proc.poll() is not None) or time.monotonic() > deadline:
            raise AssertionError(f"{proc.role} did not print {needle!r} "
                                 f"(rc {proc.poll()}): {_role_tail(proc)}")


def _graph_chat(model, content, **kw):
    from dynamo_tpu_torch.protocols.annotated import ANNOTATION_TOKEN_IDS

    return dict(model=model, stream=True, max_tokens=NEW_TOKENS,
                temperature=0.0, ignore_eos=True, logprobs=True,
                nvext={"annotations": [ANNOTATION_TOKEN_IDS]},
                messages=[{"role": "user", "content": content}], **kw)


async def _graph_ask(port, body, tok):
    """One chat request through the frontend: its stream record with the
    token ids (from the logprob entries) and the prompt ids the front
    annotated."""
    status, _, raw, events = await http_request(
        port, "POST", "/v1/chat/completions", body)
    if status != 200:
        raise AssertionError(f"graph: HTTP {status}: {raw[:400]}")
    rec = _stream_record(events, True)
    rec["ids"] = [tok.token_to_id(t) for t in rec["tokens"]]
    ann = next(line for line in raw.decode().split("\n") if line.startswith(": "))
    rec["prompt_ids"] = json.loads(ann[2:])
    return rec


async def _graph_fleet(port, sidecars):
    """The kv frontend's hub sees both workers up, with their KV use and
    busy ratio, and the kv processor's sidecar renders the aggregator's
    per-worker gauges: polled (the hub scrapes on its cadence), never
    slept on."""
    deadline = time.monotonic() + GRAPH_FLEET_TIMEOUT_S
    rows, text = [], ""
    while time.monotonic() < deadline:
        _, _, raw, _ = await http_request(port, "GET", "/fleet/workers")
        rows = json.loads(raw)["workers"]
        up = [w for w in rows if w["role"] == "decode_engine" and w["up"]
              and w["kv_usage_ratio"] is not None
              and w["busy_ratio"] is not None]
        _, _, raw, _ = await http_request(sidecars["processor"], "GET", "/metrics")
        text = raw.decode()
        per_worker = [line for line in text.splitlines() if line.startswith(
            "dynamo_kv_router_worker_kv_total_blocks{")]
        if len(up) == 2 and len(per_worker) == 2:
            return dict(ok=True, rows=rows, router_gauges=per_worker)
        await asyncio.sleep(GRAPH_HUB_INTERVAL_S)
    return dict(ok=False, rows=rows, router_text=text[-2000:])


async def _graph_traffic(ports, store, tok, words_text, procs, worker_ids,
                         sidecars=None):
    """The graph's traffic and checks, from a client of the broker of its
    own (the workers' and the processor's stats scrape, a watch on the
    workers' registrations) and an HTTP client of the frontend."""
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.client import Client
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.discovery import WatchEventType
    from dynamo_tpu_torch.runtime.engine import Context

    drt = await DistributedRuntime.connect("127.0.0.1", store)
    ns = drt.namespace(GRAPH_NS)
    backend = ns.component("backend").endpoint("generate")
    wclient = await Client(backend).start()
    pclient = await Client(ns.component("processor").endpoint("chat")).start()
    await wclient.wait_for_instances(2, timeout=60)
    await pclient.wait_for_instances(1, timeout=60)
    # every registration the broker drops (a lease that expired) is seen here
    _, watcher = await drt.discovery.watch_prefix(
        backend.component.etcd_prefix() + "generate:")
    deletes = []

    async def watch():
        async for ev in watcher:
            if ev.type == WatchEventType.DELETE:
                deletes.append((time.monotonic(), ev.key))

    watch_task = asyncio.ensure_future(watch())

    async def wstats():
        return {iid: s for iid, s in (await wclient.scrape_stats(timeout=5.0)).items()}

    async def pstats():
        s = await pclient.scrape_stats(timeout=5.0)
        return next(iter(s.values()))["data"]

    async def settled():
        """The router's index holds every event the workers published (the
        same count on two reads 50 ms apart) and it has both loads."""
        last = None
        while True:
            ws, ps = await wstats(), await pstats()
            pub = sum(s["data"]["kv_events_published"] for s in ws.values())
            now = (pub, ps["events_applied"])
            if (now == last and ps["events_applied"] >= pub
                    and len(ps["workers_with_metrics"]) == len(ws)):
                return
            last = now
            await asyncio.sleep(0.05)

    for mode, port in ports.items():  # each frontend discovered its model
        for _ in range(600):
            _, _, models, _ = await http_request(port, "GET", "/v1/models")
            if [m["id"] for m in json.loads(models)["data"]] == ["llama"]:
                break
            await asyncio.sleep(0.1)
        else:
            raise AssertionError(f"the {mode} frontend did not discover the "
                                 f"model: {models}")
    await settled()

    def served(before, after):
        return {i: after[i]["requests_total"] - before.get(i, {}).get(
            "requests_total", 0) for i in after}

    async def wave(mode, at_once=True):
        """GRAPH_GROUPS groups through the ``mode`` frontend: each leader
        alone, then its followers at once (or one by one) after the
        router's index holds the leader's blocks."""
        port = ports[mode]
        groups = []
        for g in range(GRAPH_GROUPS):
            prefix = words_text(GRAPH_PREFIX)
            bodies = [_graph_chat("llama", prefix + words_text(GRAPH_TAIL))
                      for _ in range(1 + GRAPH_FOLLOWERS)]
            before = await wstats()
            lead = await _graph_ask(port, bodies[0], tok)
            after = await wstats()
            leader = [i for i, n in served(before, after).items() if n]
            await settled()
            before = after
            t0 = time.monotonic()
            if at_once:
                follow = await asyncio.gather(*(_graph_ask(port, b, tok)
                                                for b in bodies[1:]))
            else:
                follow = []
                for b in bodies[1:]:
                    follow.append(await _graph_ask(port, b, tok))
                    await settled()
            wall = time.monotonic() - t0
            after = await wstats()
            await settled()
            hits = {i: after[i]["data"]["prefix_hit_tokens"]
                    - before[i]["data"]["prefix_hit_tokens"] for i in after}
            groups.append(dict(leader=leader, followers=served(before, after),
                               follower_prefix_hit_tokens=hits,
                               records=[lead] + list(follow), follower_wall_s=wall))
        return groups

    launches0 = {i: s["data"]["launches"] for i, s in (await wstats()).items()}
    kv = await wave("kv")
    launches1 = {i: s["data"]["launches"] for i, s in (await wstats()).items()}
    turns = {"kv": [kv], "round_robin": [], "kv_one_by_one": [],
             "round_robin_one_by_one": []}
    # one round-robin wave after the kv wave, at once and one by one (two kv
    # waves fewer since PR 18 and two round-robin ones fewer since PR 20:
    # the script's time limit)
    turns["round_robin"].append(await wave("round_robin"))
    # the followers one after another: the prefix hit without three
    # followers meeting in one worker's steps
    for mode in ("kv", "round_robin"):
        turns[f"{mode}_one_by_one"].append(await wave(mode, at_once=False))

    # the cluster KV fabric's counters after the waves: the round-robin
    # followers that landed beside their leader's worker pulled its prefix
    fabric = {iid: s["data"].get("kv_fabric") for iid, s in (await wstats()).items()}

    # a seeded sampled request straight to each worker, at once: sent one
    # after the other, the second worker would pull the first one's prefix
    # (--prefix-pull) and compute only its tail over the pulled blocks, a
    # route whose bf16 rounding (the verify kernel on a short tail against
    # one flash chunk) moves a temperature-0.8 stream; at once, neither has
    # the other's KV events at admission, and each computes the prompt whole
    sampled_prompt = [128000] + tok.encode(words_text(200))

    async def sample(iid):
        req = PreprocessedRequest(
            token_ids=sampled_prompt,
            stop_conditions=StopConditions(max_tokens=NEW_TOKENS, ignore_eos=True),
            sampling_options=SamplingOptions(**GRAPH_SAMPLED))
        rec = await wclient.direct(req.to_wire(), iid)
        return iid, [t async for out in rec for t in out["token_ids"]]

    fab_before = {iid: (s["data"].get("kv_fabric") or {}).get("pull_commits", 0)
                  for iid, s in (await wstats()).items()}
    sampled = dict(await asyncio.gather(*(sample(i) for i in worker_ids.values())))
    sampled_pulls = {iid: (s["data"].get("kv_fabric") or {}).get("pull_commits", 0)
                     - fab_before.get(iid, 0) for iid, s in (await wstats()).items()}

    # a long prefill on one worker: its lease must survive it
    long_iid = worker_ids["worker0"]
    req = PreprocessedRequest(
        token_ids=[128000] + tok.encode(words_text(GRAPH_LONG_PROMPT - 1)),
        stop_conditions=StopConditions(max_tokens=4, ignore_eos=True),
        sampling_options=SamplingOptions(temperature=0.0))
    t0 = time.monotonic()
    rec = await wclient.direct(req.to_wire(), long_iid)
    long_tokens = [t async for out in rec for t in out["token_ids"]]
    long_s = time.monotonic() - t0
    long_prompt_tokens = len(req.token_ids)

    # no worker keeps a KV block (a finished stream is reaped first)
    for _ in range(100):
        ws = await wstats()
        blocks = {i: s["data"]["kv_active_blocks"] for i, s in ws.items()}
        if not any(blocks.values()):
            break
        await asyncio.sleep(0.05)
    expiries_before_kill = list(deletes)
    router_before_kill = await pstats()
    fleet = (await _graph_fleet(ports["kv"], sidecars)
             if sidecars is not None else None)

    # worker1 dies (SIGKILL): its connection drops and the broker expires its
    # lease; requests go on, on the survivor
    victim, survivor = worker_ids["worker1"], worker_ids["worker0"]
    before = await wstats()
    t_kill = time.monotonic()
    procs["worker1"].kill()
    while victim in wclient.instances:
        await asyncio.sleep(0.01)
    gone_s = time.monotonic() - t_kill
    prompts = [words_text(GRAPH_PREFIX + GRAPH_TAIL) for _ in range(GRAPH_AFTER_KILL)]
    after_kill = await asyncio.gather(*(
        _graph_ask(ports["kv"], _graph_chat("llama", p), tok) for p in prompts))
    recovered_s = time.monotonic() - t_kill
    after = await wstats()
    blocks_after = {i: s["data"]["kv_active_blocks"] for i, s in after.items()}
    router = await pstats()
    watch_task.cancel()
    watcher.cancel()
    await wclient.close()
    await pclient.close()
    await drt.close()
    return dict(turns=turns, launches0=launches0, launches1=launches1,
                fabric=fabric, sampled_pulls=sampled_pulls,
                sampled=sampled, long_s=long_s, long_tokens=long_tokens,
                long_prompt_tokens=long_prompt_tokens, blocks=blocks,
                expiries_before_kill=expiries_before_kill, gone_s=gone_s,
                after_kill=after_kill, recovered_s=recovered_s,
                served_after_kill=served(before, after),
                blocks_after_kill=blocks_after, router=router,
                router_before_kill=router_before_kill, victim=victim,
                survivor=survivor, fleet=fleet)


def engine_graph_phase(torch, dev, smi):
    """The distributed inference graph on the one card, each role a
    subprocess started as a user starts it: ``python3 -m
    dynamo_tpu_torch.runtime.transports.dynstore``, two ``in=dyn://...
    out=torch --token-level`` workers (Llama-3.2-1B at full width and
    depth with random weights and engine_http's synthetic 128,256-id
    tokenizer, 1,024 KV blocks each, ``--prefix-pull``: the cluster KV
    fabric, each worker's first pull serve dropped by
    ``DYN_FAULT=transfer_conn_drop:once``), an ``out=processor --router-mode
    kv`` processor and a ``--router-mode round_robin`` one beside it, and an
    ``in=http out=none`` frontend whose ``ModelWatcher`` discovers both.
    The kernels were built before the workers start.

    Traffic: waves of GRAPH_GROUPS groups, each a 1,024-token shared prefix
    with GRAPH_FOLLOWERS + 1 unique 64-token tails: the leader alone, the
    followers at once once the router's index holds every event the workers
    published (the processor's and the workers' stats scrape: observable
    state, no sleeps). One kv wave is checked; it and rr, rr waves time the
    followers' TTFT under each mode, and kv, rr, rr waves with the
    followers sent one by one. Then a seeded sampled
    request straight to each worker, at once (in turn, the second would
    pull the first's prefix and compute only its tail, on another kernel
    route), a 12,000-token prefill on one, and
    SIGKILL of the other, after which GRAPH_AFTER_KILL requests must run on
    the survivor.

    Fails unless: every follower of the checked wave is served by its
    leader's worker (requests_total and prefix_hit_tokens of the workers'
    stats); every stream has NEW_TOKENS tokens and finish "length"; the
    greedy streams equal an in-process engine's over the same directory
    (fed the prompt ids the front annotated) or part at a near-tie; the
    seeded sampled request gives the same tokens on both workers; no lease
    expired before the kill (the long prefill did not starve a keepalive);
    the requests after the kill complete on the survivor within
    GRAPH_LEASE_TTL_S + GRAPH_MARGIN_S of it; no worker keeps a KV block;
    every role but the killed worker exits 0 on SIGINT. Leg B (the fabric):
    a round-robin follower that lands beside its leader's worker pulls the
    shared prefix; every committed pull brought the whole shared prefix
    (the leader's and the follower's prompt ids share it, in blocks); each
    dropped serve fell back to a local recompute (a fallback named
    "error", nothing else); the first round-robin wave's streams (pulled
    and fallen back) equal the in-process engine's or part at a near-tie;
    no worker keeps a pinned block. Prints the followers' TTFT by mode, the
    routing decision's µs, the events' lag, the workers' kernel launches on
    the checked wave, and the pulls' counts, blocks, bytes and seconds
    beside the kv wave leaders' TTFT (a local prefill of the prefix)."""
    import tempfile

    from dynamo_tpu_torch.cli import run
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.llm.tokenizer import HFTokenizer

    tmp = tempfile.TemporaryDirectory(prefix="engine_graph_")
    model_dir = write_model_dir(Path(tmp.name) / "llama-3.2-1b-random")
    tok = HFTokenizer.from_pretrained_dir(model_dir)
    words = _word_ids(tok)
    rng = np.random.default_rng(GRAPH_SEED)

    def words_text(n):
        return tok.decode([words[int(i)] for i in rng.integers(0, len(words), n)])

    store = _free_port()
    common = ["--model-path", model_dir, "--model-name", "llama",
              "--store-port", str(store), "--kv-block-size", "16"]
    worker_ep = f"dyn://{GRAPH_NS}.backend.generate"
    procs = {}
    t0 = time.monotonic()
    try:
        procs["dynstore"] = _spawn_role(
            ["dynamo_tpu_torch.runtime.transports.dynstore", "--host",
             "127.0.0.1", "--port", str(store)], "dynstore", tmp.name)
        deadline = time.monotonic() + GRAPH_START_TIMEOUT_S
        import socket

        while True:  # the broker listens before any client dials it
            try:
                socket.create_connection(("127.0.0.1", store), 1).close()
                break
            except OSError:
                if procs["dynstore"].poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(f"dynstore did not start: "
                                         f"{_role_tail(procs['dynstore'])}")
                time.sleep(0.05)
        sidecars = {name: _free_port()
                    for name in ("worker0", "worker1", "processor")}
        for i in range(2):
            procs[f"worker{i}"] = _spawn_role(
                ["dynamo_tpu_torch.cli.run", f"in={worker_ep}", "out=torch",
                 "--token-level", "--namespace", GRAPH_NS,
                 "--allow-random-weights", "--device", GRAPH_DEVICE,
                 "--metrics-port", str(sidecars[f"worker{i}"]),
                 *GRAPH_WORKER_FLAGS, *GRAPH_PULL_FLAGS, *common],
                f"worker{i}", tmp.name, env=GRAPH_PULL_FAULT)
        modes = (("kv", "processor", GRAPH_NS),
                 ("round_robin", "processor_rr", GRAPH_RR_NS))
        for mode, comp, ns in modes:
            # the kv pair carries the fleet view: the processor's sidecar
            # and the frontend's hub (the workers register in GRAPH_NS)
            kv = mode == "kv"
            procs[f"processor_{mode}"] = _spawn_role(
                ["dynamo_tpu_torch.cli.run", f"in=dyn://{GRAPH_NS}.{comp}.chat",
                 "out=processor", "--worker-endpoint", worker_ep,
                 "--router-mode", mode, "--namespace", ns, *common,
                 *(["--metrics-port", str(sidecars["processor"])] if kv else [])],
                f"processor_{mode}", tmp.name)
            procs[f"frontend_{mode}"] = _spawn_role(
                ["dynamo_tpu_torch.cli.run", "in=http", "out=none",
                 "--store-port", str(store), "--namespace", ns,
                 "--http-host", "127.0.0.1", "--http-port", "0",
                 *(["--hub", "--hub-interval-s", str(GRAPH_HUB_INTERVAL_S)]
                   if kv else [])],
                f"frontend_{mode}", tmp.name)
        worker_ids, ports = {}, {}
        for i in range(2):
            line = _await_line(procs[f"worker{i}"], "token-level worker", deadline)
            worker_ids[f"worker{i}"] = line.split()[2]
        for mode, _, _ in modes:
            _await_line(procs[f"processor_{mode}"], "processor serving", deadline)
            line = _await_line(procs[f"frontend_{mode}"], "listening on", deadline)
            ports[mode] = int(line.strip().rsplit(":", 1)[1])
        startup_s = time.monotonic() - t0
        out = asyncio.run(asyncio.wait_for(
            _graph_traffic(ports, store, tok, words_text, procs, worker_ids,
                           sidecars),
            GRAPH_TIMEOUT_S))
        exits = {}
        for name in reversed(list(procs)):  # the frontends first, the broker last
            p = procs[name]
            if p.poll() is None:
                p.send_signal(__import__("signal").SIGINT)
            exits[name] = p.wait(timeout=60)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = {name: _role_tail(p) for name, p in procs.items()}

    # ---- the same greedy requests on an in-process engine over the directory
    # (the checked kv wave, and the round-robin waves whose followers pulled
    # their prefix or fell back from a dropped pull)
    checked = [r for w in (out["turns"]["kv"][:1] + out["turns"]["round_robin"][:1])
               for g in w for r in g["records"]]
    flags = run.parse_flags(["--model-path", model_dir, "--allow-random-weights",
                             "--device", GRAPH_DEVICE, *GRAPH_WORKER_FLAGS])
    requests = [(r["prompt_ids"], dict(temperature=0.0)) for r in checked]

    async def inproc():
        engine = await TorchServingEngine.create(
            mdc=run.load_mdc(flags), flags=flags, device=GRAPH_DEVICE)
        try:
            res = await _serve(engine, requests)
            graph = [dict(tokens=r["ids"]) for r in checked]
            parted = _spec_agreement(torch, engine.runner, requests, res, graph)
            return res, parted
        finally:
            await engine.close()

    base, parted = asyncio.run(inproc())
    tmp.cleanup()

    def ttfts(waves):
        xs = sorted(r["ttft_s"] for w in waves for g in w for r in g["records"][1:])
        return dict(n=len(xs), median=xs[len(xs) // 2], min=xs[0], max=xs[-1],
                    mean=float(np.mean(xs)))

    delta = {iid: {k: out["launches1"][iid][k] - out["launches0"][iid][k]
                   for k in out["launches1"][iid]} for iid in out["launches1"]}
    wave1 = out["turns"]["kv"][0]
    # the pulls: each committed one brought the whole shared prefix, in
    # blocks (a round-robin group's leader and follower prompt ids share it)
    fab = {iid: f for iid, f in out["fabric"].items() if f}
    shared = set()
    for w in out["turns"]["round_robin"] + out["turns"]["round_robin_one_by_one"]:
        for g in w:
            lead = g["records"][0]["prompt_ids"]
            for r in g["records"][1:]:
                n = next((j for j, (a, b) in enumerate(zip(lead, r["prompt_ids"]))
                          if a != b), min(len(lead), len(r["prompt_ids"])))
                shared.add(n // 16)
    pulls = [r for f in fab.values() for r in f["recent"]]
    fallbacks = {}
    for f in fab.values():
        for reason, n in f["pull_fallbacks"].items():
            fallbacks[reason] = fallbacks.get(reason, 0) + n
    leader_ttft = [g["records"][0]["ttft_s"] for w in out["turns"]["kv"]
                   for g in w]
    emit("engine_graph", model="Llama-3.2-1B shapes, seeded random bf16 weights",
         roles=list(procs), workers=worker_ids, startup_s=startup_s,
         groups=GRAPH_GROUPS, followers=GRAPH_FOLLOWERS,
         prefix_tokens=GRAPH_PREFIX, tail_tokens=GRAPH_TAIL,
         routing=[dict(leader=g["leader"], followers=g["followers"],
                       follower_prefix_hit_tokens=g["follower_prefix_hit_tokens"])
                  for g in wave1],
         follower_ttft_s={mode: ttfts(w) for mode, w in out["turns"].items()},
         follower_ttft_by_turn_s={
             mode: [ttfts([w])["median"] for w in ws]
             for mode, ws in out["turns"].items()},
         router_decision_us=out["router"]["decision_us"],
         router_event_lag_ms=out["router"]["event_lag_ms"],
         router_decisions=out["router"]["decisions"],
         router_indexer_blocks=out["router_before_kill"]["indexer_blocks"],
         kernel_launches_wave1=delta, greedy_parted=parted,
         prefix_pulls=dict(
             commits={iid: f["pull_commits"] for iid, f in fab.items()},
             fallbacks={iid: f["pull_fallbacks"] for iid, f in fab.items()},
             pulls={iid: f["pulls"] for iid, f in fab.items()},
             bytes={iid: f["pull_bytes"] for iid, f in fab.items()},
             served={iid: (f["serves"], f["served_blocks"])
                     for iid, f in fab.items()},
             shared_prefix_blocks=sorted(shared),
             pull_s=[r["seconds"] for r in pulls if r["outcome"] == "committed"],
             pull_blocks=[r["served"] for r in pulls if r["outcome"] == "committed"],
             kv_leader_ttft_s=leader_ttft,
             pinned_blocks={iid: f["pinned_blocks"] for iid, f in fab.items()}),
         sampled_equal=len(set(map(tuple, out["sampled"].values()))) == 1,
         sampled_pulls=out["sampled_pulls"],
         long_prefill=dict(prompt_tokens=out["long_prompt_tokens"],
                           seconds=out["long_s"]),
         lease_expiries_before_kill=len(out["expiries_before_kill"]),
         kill=dict(victim=out["victim"], registration_gone_s=out["gone_s"],
                   requests_done_s=out["recovered_s"],
                   served=out["served_after_kill"]),
         kv_blocks_in_use=out["blocks"], kv_blocks_after_kill=out["blocks_after_kill"],
         fleet=dict(ok=out["fleet"]["ok"], workers=[
             {k: w.get(k) for k in ("name", "role", "up", "kv_usage_ratio",
                                    "busy_ratio", "roofline_fraction",
                                    "draining", "model")}
             for w in out["fleet"]["rows"]],
             router_gauges=out["fleet"].get("router_gauges")),
         exits=exits, card=smi)

    # ---- checks
    if not out["fleet"]["ok"]:
        raise AssertionError(f"graph: the hub's /fleet/workers or the router's "
                             f"sidecar fell short: {out['fleet']}")
    bad = [(g["leader"], g["followers"]) for g in wave1
           if len(g["leader"]) != 1 or g["followers"].get(g["leader"][0]) != GRAPH_FOLLOWERS]
    if bad:
        raise AssertionError(f"graph: followers not routed to their leader's "
                             f"worker: {bad}")
    for g in wave1:
        if g["follower_prefix_hit_tokens"][g["leader"][0]] < GRAPH_FOLLOWERS * GRAPH_PREFIX // 2:
            raise AssertionError(f"graph: the leader's worker hit only "
                                 f"{g['follower_prefix_hit_tokens']} prefix tokens")
    every = [r for ws in out["turns"].values() for w in ws for g in w
             for r in g["records"]] + list(out["after_kill"])
    for r in every:
        if len(r["ids"]) != NEW_TOKENS or r["finish"] != "length":
            raise AssertionError(f"graph: a stream of {len(r['ids'])} tokens, "
                                 f"finish {r['finish']}")
    _check_streams(base, NEW_TOKENS)
    if len(set(map(tuple, out["sampled"].values()))) != 1:
        raise AssertionError(f"graph: the seeded sampled request differs "
                             f"between the workers: {out['sampled']} (pulls "
                             f"it made: {out['sampled_pulls']})")
    if out["expiries_before_kill"]:
        raise AssertionError(f"graph: a lease expired before the kill: "
                             f"{out['expiries_before_kill']}")
    if len(out["long_tokens"]) != 4:
        raise AssertionError("graph: the long prefill did not finish")
    if any(out["blocks"].values()) or any(out["blocks_after_kill"].values()):
        raise AssertionError(f"graph: KV blocks left in use: {out['blocks']} "
                             f"{out['blocks_after_kill']}")
    if not out["recovered_s"] <= GRAPH_LEASE_TTL_S + GRAPH_MARGIN_S:
        raise AssertionError(f"graph: the requests after the kill took "
                             f"{out['recovered_s']:.1f} s")
    if out["served_after_kill"] != {out["survivor"]: GRAPH_AFTER_KILL}:
        raise AssertionError(f"graph: after the kill: {out['served_after_kill']}")
    if any(rc != 0 for name, rc in exits.items() if name != "worker1"):
        raise AssertionError(f"graph: exit codes {exits}: {logs}")
    if exits.get("worker1") != -9:
        raise AssertionError(f"graph: the killed worker exited {exits.get('worker1')}")
    committed = [r for r in pulls if r["outcome"] == "committed"]
    # each worker drops its first serve: one fallback a direction pulls go
    if (len(fab) != 2 or not committed or set(fallbacks) != {"error"}
            or not 1 <= fallbacks["error"] <= 2):
        raise AssertionError(f"graph: prefix pulls {len(committed)} committed, "
                             f"fallbacks {fallbacks} (want the dropped serves'): "
                             f"{fab}")
    bad = [r for r in committed if r["served"] != r["asked"]
           or r["served"] not in shared]
    if bad:
        raise AssertionError(f"graph: pulls that did not bring the shared "
                             f"prefix ({sorted(shared)} blocks): {bad}")
    if any(f["pinned_blocks"] for f in fab.values()):
        raise AssertionError(f"graph: pinned blocks left: {fab}")
    totals = {k: sum(d[k] for d in delta.values()) for k in
              ("paged_decode", "paged_flash", "epilogue")}
    if GRAPH_DEVICE == "cuda" and not all(totals.values()):
        raise AssertionError(f"graph: a kernel did not launch in the workers: {delta}")
    return dict(paged_decode=totals["paged_decode"],
                paged_flash=totals["paged_flash"],
                sampling_epilogue=totals["epilogue"])


# ------------------------------------------------------------ engine_disagg

# disaggregated prefill and decode on the one card, Llama-3.2-1B at full
# width and depth (random weights; one KV block of it is 16 layers x 16
# tokens x 8 KV heads x 64 x 2 bytes x K and V = 524,288 bytes)
DISAGG_NS = "disagg"
DISAGG_MAX_LOCAL = 1000        # a remote turn's router threshold (tokens)
DISAGG_ALL_LOCAL = 100000      # a local turn's: nothing goes remote
# max_prefill_queue_size: above the two long prompts a turn sends, since
# the cached depth may count a push twice (a refresh that reads the pushed
# item before the submit's optimistic increment), as the reference's does
DISAGG_QUEUE = 4
DISAGG_BLOCK_BYTES = (FLAGSHIP["num_layers"] * 16 * FLAGSHIP["num_kv_heads"]
                      * FLAGSHIP["head_dim"] * 2 * 2)
# leg A (one process): two prompts past the threshold, two short ones
# decoding (DISAGG_LEG_A_NEW tokens) while their installs land
DISAGG_ENGINE = dict(ENGINE, max_model_len=4096)
DISAGG_LEG_A = (200, 400, 1500, 3000)
DISAGG_LEG_A_NEW = (256, 256, NEW_TOKENS, NEW_TOKENS)
# leg B (the CLI roles): the prefill worker's SP ladder (4 ranks x 512 rows
# a chunk, as engine_sp) past 4,096 uncached tokens
DISAGG_WORKER_FLAGS = ["--max-model-len", "16384", "--num-kv-blocks", "2048",
                       "--kv-block-size", "16"]
DISAGG_PREFILL_EXTRA = dict(sp_size=4, long_prefill_threshold_tokens=4096,
                            max_prefill_tokens_per_step=512)
DISAGG_TURNS = ("remote", "local")
DISAGG_SHORT = (100, 250, 420, 600)   # words of the 4 streamed chats
DISAGG_SHORT_NEW = 128
DISAGG_LONG = (12000, 3000)           # words of the two long prompts
DISAGG_LONG_NEW = 32
DISAGG_LONG_AFTER_S = 0.5
DISAGG_START_TIMEOUT_S = 300
DISAGG_TIMEOUT_S = 400
DISAGG_SEED = 1616
DISAGG_DEVICE = "cuda"                # a CPU rehearsal sets "cpu"


def _disagg_leg_a(torch, dev, smi, kv, params):
    """One process: a ``TorchServingEngine`` whose coordinator talks over a
    ``MemoryHub`` to a ``PrefillWorker`` with a runner of its own on the
    same card (the same weight tensors), against a local engine over the
    same requests. Returns the checks' inputs and the weights."""
    from dynamo_tpu_torch.disagg import (
        DisaggRouter,
        PrefillWorker,
        RemotePrefillCoordinator,
    )
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.model_runner import ModelRunner
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.runtime.transports.memory import MemoryHub

    on_card = torch.device(dev).type == "cuda"
    cfg = EngineConfig(model=ModelConfig(**FLAGSHIP), seed=SEED,
                       **dict(DISAGG_ENGINE, kv_cache_dtype=kv))
    rng = np.random.default_rng(DISAGG_SEED)
    requests = [([int(t) for t in rng.integers(0, FLAGSHIP["vocab_size"], n)],
                 dict(temperature=0.0)) for n in DISAGG_LEG_A]
    reqs = [dict(prompt=p, samp=samp, stop=dict(max_tokens=n, ignore_eos=True))
            for (p, samp), n in zip(requests, DISAGG_LEG_A_NEW)]

    async def local():
        engine = await TorchServingEngine.create(cfg, params=params, device=dev)
        try:
            return await _serve_reqs(engine, reqs), engine.runner.params
        finally:
            await engine.close()

    base, params = asyncio.run(local())

    async def disagg():
        hub = MemoryHub()
        drt, drt_p = (DistributedRuntime.in_process(hub),
                      DistributedRuntime.in_process(hub))
        box = {}

        async def factory(runner):
            box["coord"] = await RemotePrefillCoordinator(
                drt, runner, router=DisaggRouter(
                    max_local_prefill_length=DISAGG_MAX_LOCAL,
                    max_prefill_queue_size=DISAGG_QUEUE),
                depth_refresh_s=0.05).start()
            return box["coord"]

        engine = await TorchServingEngine.create(
            cfg, params=params, device=dev, disagg_factory=factory)
        runner_p = ModelRunner(cfg, params=params, device=dev)
        worker = PrefillWorker(drt_p, runner_p, cfg)
        # the prefill side's frames (its own copy of each block, gathered
        # right after the chunk that completed it) and the decode side's
        # blocks gathered right after each install
        sent, gathered, installed = [], [], []
        ship, gather = worker._ship, runner_p.gather_blocks_device

        async def ship_rec(pipe, rpr, block_ids, lo, hi):
            for i in range(lo, hi, pipe.frame_blocks):
                sent.append(list(rpr.block_ids[i: min(i + pipe.frame_blocks, hi)]))
            await ship(pipe, rpr, block_ids, lo, hi)

        def gather_rec(ids):
            out = gather(ids)
            gathered.append(out)
            return out

        worker._ship, runner_p.gather_blocks_device = ship_rec, gather_rec
        attention, counter = (("paged_decode", "launches_fp8") if kv == "fp8"
                              else ("paged_decode", "launches"))
        stats = _guard_dispatches(torch, engine.runner, FLAGSHIP["num_layers"],
                                  cfg.multi_step_decode, on_card,
                                  attention=attention, counter=counter)
        scatter = engine.runner.scatter_blocks
        stats["installs"] = stats["installs_while_decoding"] = 0

        def scatter_guarded(ids, k, v):
            prev = torch.cuda.get_sync_debug_mode() if on_card else None
            if on_card:
                torch.cuda.set_sync_debug_mode("error")
            try:
                scatter(ids, k, v)
                installed.append((list(ids), engine.runner.gather_blocks_device(ids)))
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(prev)
            stats["installs"] += 1
            stats["installs_while_decoding"] += int(any(engine.scheduler.slots))

        engine.runner.scatter_blocks = scatter_guarded
        task = asyncio.ensure_future(worker.run())
        try:
            _reset_launches()
            t0 = time.monotonic()
            res = await _serve_reqs(engine, reqs)
            wall = time.monotonic() - t0
            launches = _read_launches()
            metrics, wm = engine.metrics(), worker.metrics()
            used = dict(decode=engine.scheduler.allocator.used,
                        prefill=worker.allocator.used)
        finally:
            worker.stop()
            await task
            await worker.close()
            await engine.close()
            await drt_p.close()
            await drt.close()
        # every installed block against the prefill worker's copy, bytes
        decode_copy = {}
        for ids, (k, v) in installed:
            for j, b in enumerate(ids):
                decode_copy[b] = (k[:, j], v[:, j])
        compared = mismatched = 0
        for dst, (k, v) in zip(sent, gathered):
            for j, b in enumerate(dst):
                dk, dv = decode_copy[b]
                compared += 1
                if not (torch.equal(dk.view(torch.uint8), k[:, j].view(torch.uint8))
                        and torch.equal(dv.view(torch.uint8),
                                        v[:, j].view(torch.uint8))):
                    mismatched += 1
        parted = _spec_agreement(torch, runner_p, requests, base, res)
        return dict(res=res, wall=wall, launches=launches, metrics=metrics,
                    worker=wm, used=used, stats=stats, compared=compared,
                    mismatched=mismatched, frames=len(sent), parted=parted)

    out = asyncio.run(disagg())
    out["base"] = base
    expect_blocks = sum(-(-n // 16) for n in DISAGG_LEG_A if n > DISAGG_MAX_LOCAL)
    m, wm = out["metrics"], out["worker"]
    emit("engine_disagg", leg="A", kv_cache_dtype=kv,
         requests=list(DISAGG_LEG_A), wall_s=out["wall"],
         ttft_s=[r["ttft_s"] for r in out["res"]],
         local_ttft_s=[r["ttft_s"] for r in base],
         remote_completed=m["remote_prefill_completed"],
         failures=m["remote_prefill_failures"], nacks=m["kv_transfer_nacks"],
         bytes_received=m["kv_transfer_bytes_received"],
         bytes_shipped=wm["transfer_bytes_total"],
         frames=wm["transfer_frames_total"], transfers=wm["transfers"],
         blocks_compared=out["compared"], blocks_mismatched=out["mismatched"],
         installs=out["stats"]["installs"],
         installs_while_decoding=out["stats"]["installs_while_decoding"],
         guarded_steps=out["stats"]["step"], bad_bursts=out["stats"]["bad"],
         greedy_parted=out["parted"], kv_blocks_in_use=out["used"],
         launches=out["launches"], card=smi)
    if m["remote_prefill_completed"] != 2 or m["remote_prefill_failures"] \
            or m["kv_transfer_nacks"] or wm["nacks_total"]:
        raise AssertionError(f"disagg leg A ({kv}): {m} {wm}")
    if out["compared"] != expect_blocks or out["mismatched"]:
        raise AssertionError(
            f"disagg leg A ({kv}): {out['mismatched']} of {out['compared']} "
            f"installed blocks differ from the prefill worker's (want "
            f"{expect_blocks} compared)")
    if not (wm["transfer_bytes_total"] == m["kv_transfer_bytes_received"]
            == expect_blocks * _kv_block_bytes(kv)):
        raise AssertionError(f"disagg leg A ({kv}): bytes {wm} {m}")
    if out["stats"]["bad"]:
        raise AssertionError(f"disagg leg A ({kv}): bursts {out['stats']['bad']}")
    if not out["stats"]["installs_while_decoding"]:
        raise AssertionError(f"disagg leg A ({kv}): no install landed while a "
                             f"stream decoded")
    if any(out["used"].values()):
        raise AssertionError(f"disagg leg A ({kv}): blocks in use {out['used']}")
    for r, n in zip(out["res"], DISAGG_LEG_A_NEW):
        _check_streams([r], n)
    if on_card:
        sfx = "_fp8" if kv == "fp8" else ""
        lc = out["launches"]
        if not (lc["paged_decode" + sfx] and lc["paged_flash" + sfx]
                and lc["epilogue"]):
            raise AssertionError(f"disagg leg A ({kv}): launches {lc}")
    return out, params


def _kv_block_bytes(kv):
    return DISAGG_BLOCK_BYTES // 2 if kv == "fp8" else DISAGG_BLOCK_BYTES


async def _disagg_ask(port, body, tok, rid=None):
    """One chat request (with ``X-Request-Id: rid`` when given): its stream
    record, the prompt ids the front annotated, the token ids, and each
    chunk's arrival on this process's monotonic clock."""
    t0 = time.monotonic()
    status, _, raw, events = await http_request(
        port, "POST", "/v1/chat/completions", body,
        headers={"X-Request-Id": rid} if rid else None)
    if status != 200:
        raise AssertionError(f"disagg: HTTP {status}: {raw[:400]}")
    rec = _stream_record(events, True)
    rec["ids"] = [tok.token_to_id(t) for t in rec["tokens"]]
    ann = next(line for line in raw.decode().split("\n") if line.startswith(": "))
    rec["prompt_ids"] = json.loads(ann[2:])
    rec["arrivals"] = [t0 + t for t, c in events if c and c.get("choices")]
    rec["sent"] = t0
    return rec


async def _disagg_traffic(port, store, tok, words_text):
    """The turns through the frontend (``DISAGG_TURNS``), switched by the
    router's discovery key, with the workers' stats scraped around each."""
    from dynamo_tpu_torch.disagg import DisaggRouter
    from dynamo_tpu_torch.runtime.client import Client
    from dynamo_tpu_torch.runtime.component import DistributedRuntime

    drt = await DistributedRuntime.connect("127.0.0.1", store)
    ns = drt.namespace(DISAGG_NS)
    dclient = await Client(ns.component("backend").endpoint("generate")).start()
    pclient = await Client(ns.component("prefill").endpoint("stats")).start()
    await dclient.wait_for_instances(1, timeout=60)
    await pclient.wait_for_instances(1, timeout=60)

    async def stats(client):
        s = await client.scrape_stats(timeout=10.0)
        return next(iter(s.values()))["data"]

    for _ in range(600):  # the frontend discovered the model
        _, _, models, _ = await http_request(port, "GET", "/v1/models")
        if [m["id"] for m in json.loads(models)["data"]] == ["llama"]:
            break
        await asyncio.sleep(0.1)
    else:
        raise AssertionError(f"disagg: the frontend found no model: {models}")

    def body(text, n):
        return dict(_graph_chat("llama", text), max_tokens=n)

    turns = []
    d_first, p_first = await stats(dclient), await stats(pclient)
    for mode in DISAGG_TURNS:
        await DisaggRouter.publish_config(
            drt.discovery, DISAGG_NS, "llama",
            max_local_prefill_length=(DISAGG_MAX_LOCAL if mode == "remote"
                                      else DISAGG_ALL_LOCAL),
            max_prefill_queue_size=DISAGG_QUEUE)
        await asyncio.sleep(0.5)  # the watch delivers the key
        d0, p0 = await stats(dclient), await stats(pclient)
        shorts = [asyncio.ensure_future(_disagg_ask(
            port, body(words_text(n), DISAGG_SHORT_NEW), tok))
            for n in DISAGG_SHORT]
        await asyncio.sleep(DISAGG_LONG_AFTER_S)
        mid_text = words_text(DISAGG_LONG[1])
        rids = [f"{mode}-long{i}" for i in range(2)]
        longs = await asyncio.gather(
            _disagg_ask(port, body(words_text(DISAGG_LONG[0]), DISAGG_LONG_NEW),
                        tok, rids[0]),
            _disagg_ask(port, body(mid_text, DISAGG_LONG_NEW), tok, rids[1]))
        shorts = await asyncio.gather(*shorts)
        # the 3,000-word prompt again: its prefix hit on the decode side
        # leaves a suffix under the threshold, so it prefills locally
        again = await _disagg_ask(port, body(mid_text, DISAGG_LONG_NEW), tok)
        d1, p1 = await stats(dclient), await stats(pclient)
        traces = {}
        for rid in rids:  # the raw span sets and the stitched timeline
            _, _, raw, _ = await http_request(port, "GET",
                                              f"/debug/requests/{rid}")
            _, _, stitched, _ = await http_request(port, "GET",
                                                   f"/debug/trace/{rid}")
            traces[rid] = (json.loads(raw), json.loads(stitched))
        turns.append(dict(mode=mode, shorts=shorts, longs=longs, again=again,
                          d0=d0, d1=d1, p0=p0, p1=p1, traces=traces))
    blocks = {}
    for _ in range(100):  # finished streams are reaped first
        d, p = await stats(dclient), await stats(pclient)
        blocks = dict(decode=d["kv_active_blocks"], prefill=p["kv_active_blocks"])
        if not any(blocks.values()):
            break
        await asyncio.sleep(0.05)
    await dclient.close()
    await pclient.close()
    await drt.close()
    return dict(turns=turns, blocks=blocks, d_first=d_first, p_first=p_first,
                d_last=d, p_last=p)


def _disagg_trace_hops(trace):
    """A remote-prefill request's span sets: the chain frontend → processor
    → decode engine → prefill worker, each hop's offset and round trip.
    Raises unless the prefill worker's set nests inside the decode engine's
    and every offset lies inside its error bound: half the round trip for
    the dial-back hops (NTP-style), the round trip for the queued prefill
    hop (its offset comes from the commit's return leg alone; the bound is
    that leg's transit, inside the round trip). One host: the true offset
    is 0."""
    hops, node = [], {"children": trace.get("remote") or []}
    for want in ("processor", "decode_engine", "prefill_worker"):
        child = next((c for c in node.get("children") or []
                      if c.get("source") == want), None)
        if child is None:
            raise AssertionError(f"disagg: no {want} span set under "
                                 f"{node.get('source', 'frontend')}: {trace}")
        bound = child["rtt_s"] if want == "prefill_worker" else child["rtt_s"] / 2
        if abs(child["offset_s"]) > bound + 1e-3:
            raise AssertionError(f"disagg: the {want} hop's offset "
                                 f"{child['offset_s']} exceeds its bound "
                                 f"{bound} (rtt {child['rtt_s']})")
        hops.append(dict(source=want, offset_s=child["offset_s"],
                         rtt_s=child["rtt_s"],
                         marks=[n for n, _ in child["spans"]]))
        node = child
    return hops


def _disagg_turn_line(t):
    """A turn's printed numbers: the long prompts' edge TTFT, the short
    streams' largest gap between chunks while the long prompts were in
    prefill (from their send to their last first token), the transfer's
    bytes, frames, duration and exposed seconds (the prefill worker's
    records of this turn's remote prefills)."""
    long_send = min(r["sent"] for r in t["longs"])
    long_first = max(r["arrivals"][0] for r in t["longs"])
    gap = 0.0
    for r in t["shorts"]:
        a = r["arrivals"]
        for x, y in zip(a, a[1:]):
            if y > long_send and x < long_first:
                gap = max(gap, y - x)
    d0, d1, p0, p1 = t["d0"], t["d1"], t["p0"], t["p1"]
    n = p1["prefills_total"] - p0["prefills_total"]
    new = p1["transfers"][len(p1["transfers"]) - n:] if n else []
    return dict(
        mode=t["mode"],
        long_ttft_s=[r["ttft_s"] for r in t["longs"]],
        long_prompt_tokens=[len(r["prompt_ids"]) for r in t["longs"]],
        again_ttft_s=t["again"]["ttft_s"],
        short_max_gap_during_long_prefill_s=gap,
        short_itl_median_s=float(np.median([r["itl_median_s"] for r in t["shorts"]])),
        remote_completed=(d1["remote_prefill_completed"]
                          - d0["remote_prefill_completed"]),
        bytes_shipped=p1["transfer_bytes_total"] - p0["transfer_bytes_total"],
        bytes_received=(d1["kv_transfer_bytes_received"]
                        - d0["kv_transfer_bytes_received"]),
        frames=p1["transfer_frames_total"] - p0["transfer_frames_total"],
        sp_prefills=p1["sp_prefills_total"] - p0["sp_prefills_total"],
        transfers=[{k: x[k] for k in ("prompt_tokens", "shipped_blocks", "sp",
                                      "chunks", "bytes", "frames", "compute_s",
                                      "duration_s", "exposed_s")} for x in new],
        sp_prefix_launches=(p1["launches"]["sp_prefix"]
                            - p0["launches"]["sp_prefix"]))


def engine_disagg_phase(torch, dev, smi):
    """Disaggregated prefill and decode on the one card, Llama-3.2-1B at
    full width and depth with seeded random bf16 weights.

    Leg A, in this process, over a bf16 and then an fp8 (e4m3) cache: a
    ``TorchServingEngine`` whose ``RemotePrefillCoordinator`` talks over a
    ``MemoryHub`` to a ``PrefillWorker`` with a runner of its own on the
    card (the same weight tensors), ``max_local_prefill_length`` 1,000,
    prompts of 200, 400, 1,500 and 3,000 tokens at once. Fails unless the
    two long prompts complete remotely with no failure and no nack; every
    block the decode side installed is byte-equal to the prefill worker's
    copy (gathered on both sides right at the transfer); the bytes are the
    blocks x the cache's block bytes; every decode-side dispatch and every
    install ran under ``set_sync_debug_mode("error")``; greedy streams equal
    a local engine's or part at a near-tie; no KV block stays in use.

    Leg B, the CLI roles as subprocesses on the card as a user starts them:
    a dynstore broker; a decode worker (``--token-level --remote-prefill
    --max-local-prefill-length 1000``, 2,048 blocks, max_model_len 16,384);
    a prefill worker (``in=prefill``; ``sp_size`` 4 and
    ``long_prefill_threshold_tokens`` 4,096 through
    ``--extra-engine-args``); a KV-routing processor; an ``in=http
    out=none`` frontend. Two turns, remote then local, switched
    by publishing the ``DisaggRouter`` key (1,000 / 100,000) with no role
    restarted: 4 streamed greedy chats of 100-600 words (128 new tokens),
    0.5 s later a 12,000- and a 3,000-word prompt (32 new tokens), then the
    3,000-word prompt again (a prefix hit: local). Fails unless
    ``remote_prefill_completed`` moves by 2 in each remote turn and 0 in
    each local one; the shipped bytes equal the received bytes and the
    prompts' blocks x 524,288; the 12,000-word prompt took the prefill
    worker's SP ladder (``sp_prefix`` launches); every greedy stream equals
    an in-process engine's or parts at a near-tie; no fallback, no nack,
    no KV block left in use; every role exits 0 on SIGINT. Prints per turn
    the long prompts' edge TTFT, the short streams' largest gap while they
    prefilled, the transfer's bytes, frames, duration and exposed seconds.

    Returns the CLI path's launches (the two workers' together) of the
    decode, flash, epilogue and prefix-partials kernels, and Leg A's fp8
    forms of decode and flash."""
    import tempfile

    from dynamo_tpu_torch.cli import run
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.llm.tokenizer import HFTokenizer

    on_card = torch.device(dev).type == "cuda"
    t_phase = time.monotonic()
    leg_a, params = _disagg_leg_a(torch, dev, smi, "auto", None)
    leg_a8, params = _disagg_leg_a(torch, dev, smi, "fp8", params)
    del params
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_leg_b = time.monotonic()

    tmp = tempfile.TemporaryDirectory(prefix="engine_disagg_")
    model_dir = write_model_dir(Path(tmp.name) / "llama-3.2-1b-random")
    extra = Path(tmp.name) / "prefill.json"
    extra.write_text(json.dumps(DISAGG_PREFILL_EXTRA))
    tok = HFTokenizer.from_pretrained_dir(model_dir)
    words = _word_ids(tok)
    rng = np.random.default_rng(DISAGG_SEED)

    def words_text(n):
        return tok.decode([words[int(i)] for i in rng.integers(0, len(words), n)])

    store = _free_port()
    common = ["--model-path", model_dir, "--model-name", "llama",
              "--store-port", str(store), "--namespace", DISAGG_NS,
              "--kv-block-size", "16"]
    engine_flags = ["--allow-random-weights", "--device", DISAGG_DEVICE,
                    *DISAGG_WORKER_FLAGS]
    worker_ep = f"dyn://{DISAGG_NS}.backend.generate"
    procs = {}
    t0 = time.monotonic()
    try:
        procs["dynstore"] = _spawn_role(
            ["dynamo_tpu_torch.runtime.transports.dynstore", "--host",
             "127.0.0.1", "--port", str(store)], "dynstore", tmp.name)
        deadline = time.monotonic() + DISAGG_START_TIMEOUT_S
        import socket

        while True:  # the broker listens before any client dials it
            try:
                socket.create_connection(("127.0.0.1", store), 1).close()
                break
            except OSError:
                if procs["dynstore"].poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(f"dynstore did not start: "
                                         f"{_role_tail(procs['dynstore'])}")
                time.sleep(0.05)
        procs["decode"] = _spawn_role(
            ["dynamo_tpu_torch.cli.run", f"in={worker_ep}", "out=torch",
             "--token-level", "--remote-prefill", "--max-local-prefill-length",
             str(DISAGG_MAX_LOCAL), "--max-prefill-queue-size",
             str(DISAGG_QUEUE), *engine_flags, *common], "decode", tmp.name)
        procs["prefill"] = _spawn_role(
            ["dynamo_tpu_torch.cli.run", "in=prefill", "out=torch",
             "--extra-engine-args", str(extra), *engine_flags, *common],
            "prefill", tmp.name)
        procs["processor"] = _spawn_role(
            ["dynamo_tpu_torch.cli.run", f"in=dyn://{DISAGG_NS}.processor.chat",
             "out=processor", "--worker-endpoint", worker_ep,
             "--router-mode", "kv", *common], "processor", tmp.name)
        procs["frontend"] = _spawn_role(
            ["dynamo_tpu_torch.cli.run", "in=http", "out=none",
             "--store-port", str(store), "--namespace", DISAGG_NS,
             "--http-host", "127.0.0.1", "--http-port", "0"],
            "frontend", tmp.name)
        _await_line(procs["decode"], "token-level worker", deadline)
        _await_line(procs["prefill"], "prefill worker consuming", deadline)
        _await_line(procs["processor"], "processor serving", deadline)
        line = _await_line(procs["frontend"], "listening on", deadline)
        port = int(line.strip().rsplit(":", 1)[1])
        startup_s = time.monotonic() - t0
        out = asyncio.run(asyncio.wait_for(
            _disagg_traffic(port, store, tok, words_text), DISAGG_TIMEOUT_S))
        exits = {}
        for name in reversed(list(procs)):  # the frontend first, the broker last
            p = procs[name]
            if p.poll() is None:
                p.send_signal(__import__("signal").SIGINT)
            exits[name] = p.wait(timeout=60)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = {name: _role_tail(p) for name, p in procs.items()}
    t_inproc = time.monotonic()

    # ---- the same greedy requests on an in-process engine over the directory
    every = [r for t in out["turns"] for r in (*t["shorts"], *t["longs"], t["again"])]
    flags = run.parse_flags(["--model-path", model_dir, "--allow-random-weights",
                             "--device", DISAGG_DEVICE, *DISAGG_WORKER_FLAGS])
    requests = [(r["prompt_ids"], dict(temperature=0.0)) for r in every]

    async def inproc():
        engine = await TorchServingEngine.create(
            mdc=run.load_mdc(flags), flags=flags, device=DISAGG_DEVICE)
        try:
            res = []
            for t in out["turns"]:  # a turn's shorts at once, then its longs
                for group, n in ((t["shorts"], DISAGG_SHORT_NEW),
                                 ((*t["longs"], t["again"]), DISAGG_LONG_NEW)):
                    res += await _serve(engine, [(r["prompt_ids"], dict(
                        temperature=0.0)) for r in group], n)
            parted = _spec_agreement(torch, engine.runner, requests, res,
                                     [dict(tokens=r["ids"]) for r in every])
            return res, parted
        finally:
            await engine.close()

    base, parted = asyncio.run(inproc())
    tmp.cleanup()

    lines = [_disagg_turn_line(t) for t in out["turns"]]
    trace_hops = {rid: _disagg_trace_hops(raw)
                  for t in out["turns"] if t["mode"] == "remote"
                  for rid, (raw, _) in t["traces"].items()}
    stitched_sources = {rid: [s["source"] for s in st["sources"]]
                        for t in out["turns"] if t["mode"] == "remote"
                        for rid, (_, st) in t["traces"].items()}
    d_first, d_last = out["d_first"], out["d_last"]
    p_first, p_last = out["p_first"], out["p_last"]
    launches = {}
    for key, mod in (("paged_decode", "paged_decode"), ("paged_flash", "paged_flash"),
                     ("sampling_epilogue", "epilogue"), ("sp_prefix", "sp_prefix")):
        launches[key] = sum(last["launches"][mod] - first["launches"][mod]
                            for first, last in ((d_first, d_last), (p_first, p_last)))
    per_role = {role: {k: last["launches"][k] - first["launches"][k]
                       for k in ("paged_decode", "paged_flash", "epilogue",
                                 "sp_prefix")}
                for role, first, last in (("decode", d_first, d_last),
                                          ("prefill", p_first, p_last))}
    emit("engine_disagg", leg="B",
         model="Llama-3.2-1B shapes, seeded random bf16 weights",
         roles=list(procs), startup_s=startup_s, turns=lines,
         greedy_parted=parted, kv_blocks_in_use=out["blocks"],
         failures=d_last["remote_prefill_failures"],
         nacks=dict(decode=d_last["kv_transfer_nacks"],
                    prefill=p_last["nacks_total"]),
         max_live_host_frames=p_last["max_live_host_frames"],
         launches=per_role, exits=exits, trace_hops=trace_hops,
         stitched_sources=stitched_sources,
         seconds=dict(leg_a=t_leg_b - t_phase, leg_b=t_inproc - t_leg_b,
                      inproc_check=time.monotonic() - t_inproc),
         card=smi)

    # ---- checks
    for t, line in zip(out["turns"], lines):
        want = 2 if t["mode"] == "remote" else 0
        if line["remote_completed"] != want:
            raise AssertionError(f"disagg: a {t['mode']} turn completed "
                                 f"{line['remote_completed']} remote prefills")
        blocks = sum(-(-len(r["prompt_ids"]) // 16) for r in t["longs"])
        if t["mode"] == "remote" and not (
                line["bytes_shipped"] == line["bytes_received"]
                == blocks * DISAGG_BLOCK_BYTES):
            raise AssertionError(
                f"disagg: shipped {line['bytes_shipped']} B, received "
                f"{line['bytes_received']} B, want {blocks} x "
                f"{DISAGG_BLOCK_BYTES}")
        if t["mode"] == "local" and (line["bytes_shipped"] or line["bytes_received"]):
            raise AssertionError(f"disagg: a local turn moved bytes: {line}")
        if t["mode"] == "remote" and (line["sp_prefills"] != 1
                                      or line["sp_prefix_launches"] <= 0
                                      and DISAGG_DEVICE == "cuda"):
            raise AssertionError(f"disagg: the 12,000-word prompt did not take "
                                 f"the prefill worker's SP ladder: {line}")
    for r in every:
        if len(r["ids"]) not in (DISAGG_SHORT_NEW, DISAGG_LONG_NEW) \
                or r["finish"] != "length":
            raise AssertionError(f"disagg: a stream of {len(r['ids'])} tokens, "
                                 f"finish {r['finish']}")
    if d_last["remote_prefill_failures"] or d_last["kv_transfer_nacks"] \
            or p_last["nacks_total"]:
        raise AssertionError(f"disagg: a fallback or a nack: {d_last} {p_last}")
    if any(out["blocks"].values()):
        raise AssertionError(f"disagg: KV blocks left in use: {out['blocks']}")
    if any(rc != 0 for rc in exits.values()):
        raise AssertionError(f"disagg: exit codes {exits}: {logs}")
    if DISAGG_DEVICE == "cuda" and not all(launches.values()):
        raise AssertionError(f"disagg: a kernel did not launch: {per_role}")
    out = dict(launches)
    if on_card:
        lc = leg_a8["launches"]
        out.update(paged_decode_fp8=lc["paged_decode_fp8"],
                   paged_flash_fp8=lc["paged_flash_fp8"])
    return out


# ----------------------------------------------------------- engine_kv_tiers

# the multi-tier KV block manager on the one card, Llama-3.2-1B at full width
# and depth (random weights; a block is 524,288 bytes in bf16): 1,024 HBM
# blocks, a 1,024-slot pinned host slab, a 2,048-block cold tier in a
# temporary directory; six distinct 6,000-token prompts (2,250 complete
# blocks) push blocks from HBM to the host tier and about 200 on to the
# cold tier
TIERS_ENGINE = dict(ENGINE, max_model_len=8192, num_kv_blocks=1024,
                    host_kv_blocks=1024, cold_tier_blocks=2048,
                    prefix_pull_min_blocks=1)
TIERS_PROMPT = 6000
TIERS_PROMPTS = 6
TIERS_FP8_PROMPTS = 4          # the e4m3 cache's pass (HBM overflows once)
TIERS_NEW = 16
TIERS_RATE_BLOCKS = 256        # blocks a timed offload / restore moves
TIERS_XXH64_SIZES = (0, 1, 3, 31, 32, 33, 100, 4096, 524288)
TIERS_SEED = 1717


def _same_bytes(torch, a, b) -> bool:
    return torch.equal(a.contiguous().view(-1).view(torch.uint8),
                       b.contiguous().view(-1).view(torch.uint8))


def _tier_blocks(engine, hashes):
    """Host copies ([L, n, ...] K and V) of the engine's HBM blocks of
    ``hashes``, gathered now."""
    alloc = engine.scheduler.allocator
    return engine.runner.gather_blocks([alloc.by_hash[h] for h in hashes])


def _residency(engine, chain):
    """Where each block of a prompt's chain sits: 'hbm', 'host', 'cold' or
    '-' (the first tier that holds it)."""
    alloc = engine.scheduler.allocator
    fab = engine.scheduler.fabric
    out = []
    for h in chain:
        out.append("hbm" if h in alloc.by_hash
                   else "host" if alloc.tier2 is not None and alloc.tier2.has(h)
                   else "cold" if fab is not None and fab.cold is not None
                   and fab.cold.has(h) else "-")
    return out


def _run_length(res, tier) -> int:
    n = 0
    while n < len(res) and res[n] == tier:
        n += 1
    return n


def _tier_rates(torch, engine, n, rounds=2):
    """Timed offloads of ``n`` blocks and timed restores of them into the
    same slots (the bytes they hold), on an idle engine, ``rounds`` times
    (the first pays the pinned staging buffers' allocation). An offload is
    split into its dispatch (the gather, the block-major transpose and the
    copy into pinned memory queued), the device's part (a synchronize: the
    copy landed) and the drain (filing the blocks into a pinned slab of its
    own); a restore into the host gather of the slots into a pinned frame
    (the restore's runs of slots, timed alone beside it) and the whole
    (with the copy to the card and the scatter). Seconds and GB/s."""
    from dynamo_tpu_torch.kv import KvHostTier
    from dynamo_tpu_torch.kv.host_tier import _runs
    from dynamo_tpu_torch.ops.attention import _bytes

    runner = engine.runner
    on_card = runner.device.type == "cuda"
    tier = KvHostTier(runner, n)
    ids = list(range(n))
    nbytes = sum(c[:, :1].numel() * c.element_size() for c in runner.kv_cache) * n
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = []
    for r in range(rounds):
        hashes = [(1 << 40) + r * n + i for i in ids]
        sync()
        t0 = time.perf_counter()
        tier.offload_batch(list(zip(hashes, ids)))
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        tier.drain()
        t3 = time.perf_counter()
        runs = _runs(enumerate(tier.store[h] for h in hashes))
        bufs = [torch.empty((n, *s.shape[1:]), dtype=_bytes(s).dtype,
                            pin_memory=on_card) for s in tier.slabs]
        t4 = time.perf_counter()
        for s, buf in zip(tier.slabs, bufs):
            for d, src, k in runs:
                buf[d:d + k].copy_(_bytes(s)[src:src + k])
        t5 = time.perf_counter()
        sync()
        tier.restore(hashes, ids)
        sync()
        t6 = time.perf_counter()
        out.append(dict(
            offload_dispatch_ms=(t1 - t0) * 1e3, offload_device_ms=(t2 - t1) * 1e3,
            offload_drain_ms=(t3 - t2) * 1e3, offload_s=t3 - t0,
            offload_gb_s=nbytes / (t3 - t0) / 1e9,
            restore_host_gather_ms=(t5 - t4) * 1e3, restore_s=t6 - t5,
            restore_gb_s=nbytes / (t6 - t5) / 1e9))
    return dict(blocks=n, bytes=nbytes, rounds=out,
                slab_pinned=all(s.is_pinned() for s in tier.slabs) if on_card
                else None)


def _kv_tiers_xxh64(torch):
    """The native host xxh64 against its plain version on random payloads
    (the split between K and V at a third), and its time on one block."""
    from dynamo_tpu_torch.ops import host_xxh64

    rng = np.random.default_rng(TIERS_SEED)
    checked = 0
    for n in TIERS_XXH64_SIZES:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 2**64 - 1):
            a, b = data[: n // 3], data[n // 3:]
            got = host_xxh64.xxh64_pair(a, b, seed)
            want = host_xxh64.xxh64_pair_ref(a, b, seed)
            if got != want:
                raise AssertionError(f"kv_tiers: native xxh64 {got:#x} != plain "
                                     f"{want:#x} over {n} bytes (seed {seed})")
            checked += 1
    block = rng.integers(0, 256, 524288, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    for _ in range(20):
        host_xxh64.xxh64_pair(block[:262144], block[262144:])
    native_ms = (time.perf_counter() - t0) / 20 * 1e3
    t0 = time.perf_counter()
    host_xxh64.xxh64_pair_ref(block[:262144], block[262144:])
    plain_ms = (time.perf_counter() - t0) * 1e3
    return dict(payloads_checked=checked, native_ms_per_block=native_ms,
                plain_ms_per_block=plain_ms)


async def _tiers_serve_one(engine, r):
    return (await _serve_reqs(engine, [r]))[0]


def engine_kv_tiers_phase(torch, dev, smi):
    """The multi-tier KV block manager on the one card: Llama-3.2-1B at full
    width and depth with seeded random bf16 weights, 1,024 HBM blocks, a
    1,024-block host tier (one pinned slab) and a 2,048-block cold tier in
    a temporary directory, in this process.

    1. Six distinct 6,000-token prompts, one at a time, 16 greedy tokens
       each: 2,250 complete blocks move HBM → host → cold. Each prompt's
       blocks are captured right after it (still in HBM). Every dispatch,
       offload and restore runs under ``set_sync_debug_mode("error")``;
       dispatches made while offloads are staged are counted.
    2. The prompt with the longest run of blocks in the host tier again:
       they restore (the prompt's last block recomputes: one token must stay
       uncached); then the prompt with the longest run in the cold tier:
       the run is pulled (the fabric's cold source), the rest recomputes.
    3. A fresh engine (empty HBM and host tiers) over the same cold
       directory: the prompt with the longest cold run rehydrates.
    4. Another fresh engine: one file of that run corrupted; it must be a
       miss (quarantined, counted), never installed, the pull committing
       only the verified blocks before it, the rest recomputed.
    5. An e4m3 cache (host tier only): four prompts, then the one with the
       longest host run again: it restores.

    Fails unless every restored or rehydrated block is byte-equal to the
    block first written; every repeated stream equals its first pass or
    parts at a near-tie; no host sync in a guarded dispatch; some dispatch
    ran while offloads were staged; no pinned and no used block is left;
    the native xxh64 equals the plain one; decode, flash and the epilogue
    launched (the fp8 forms on the e4m3 engine). Prints each tier's
    counters, the offload and restore GB/s of a timed 256-block move, the
    cold tier's write and read MB/s with the checksum's share, and the
    native checksum's time on one block against the plain one's."""
    import tempfile

    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.tokens import compute_block_hashes

    on_card = torch.device(dev).type == "cuda"
    t_phase = time.monotonic()
    bs = TIERS_ENGINE["kv_block_size"]
    xxh = _kv_tiers_xxh64(torch) if on_card else None
    rng = np.random.default_rng(TIERS_SEED)
    prompts = [[int(t) for t in rng.integers(0, FLAGSHIP["vocab_size"],
                                             TIERS_PROMPT)]
               for _ in range(TIERS_PROMPTS)]
    chains = [compute_block_hashes(p, bs) for p in prompts]
    reqs = [dict(prompt=p, samp=dict(temperature=0.0),
                 stop=dict(max_tokens=TIERS_NEW, ignore_eos=True))
            for p in prompts]
    tmp = tempfile.TemporaryDirectory(prefix="engine_kv_tiers_")
    cold_dir = str(Path(tmp.name) / "cold")

    def cfg(kv="auto", **over):
        kw = dict(TIERS_ENGINE, cold_tier_dir=cold_dir, kv_cache_dtype=kv)
        kw.update(over)
        return EngineConfig(model=ModelConfig(**FLAGSHIP), seed=SEED, **kw)

    def compare(first, again, idx):
        """Blocks ``idx`` of a first-pass capture against ``again``'s n
        blocks: the count that differ."""
        bad = 0
        for c in range(2):
            for j, i in enumerate(idx):
                bad += not _same_bytes(torch, first[c][:, i], again[c][:, j])
        return bad

    def leaks(engine):
        a = engine.scheduler.allocator
        return dict(pinned=len(a.pinned), used=a.used)

    # ---- 1-2: one engine, the first pass, the host restore, the cold pull
    async def engine_one():
        engine = await TorchServingEngine.create(cfg(), device=dev)
        runner, tier = engine.runner, engine.scheduler.allocator.tier2
        stats = _guard_dispatches(torch, runner, FLAGSHIP["num_layers"], 1, on_card)
        staged = dict(dispatches=0, with_staged=0)
        for name in ("step", "decode_burst"):
            def counted(*a, fn=getattr(runner, name), **kw):
                staged["dispatches"] += 1
                staged["with_staged"] += bool(tier._staged)
                return fn(*a, **kw)
            setattr(runner, name, counted)
        guarded = dict(offload_batch=0, restore=0)
        for name in ("offload_batch", "restore"):
            def under_guard(*a, fn=getattr(tier, name), name=name, **kw):
                prev = torch.cuda.get_sync_debug_mode() if on_card else None
                if on_card:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*a, **kw)
                finally:
                    if on_card:
                        torch.cuda.set_sync_debug_mode(prev)
                    guarded[name] += 1
            setattr(tier, name, under_guard)
        try:
            _reset_launches()
            t0 = time.monotonic()
            first_streams, first = [], []
            for r, chain in zip(reqs, chains):
                first_streams.append(await _tiers_serve_one(engine, r))
                first.append(_tier_blocks(engine, chain))
            first_s = time.monotonic() - t0
            await engine.scheduler.fabric.cold.close()  # the spills landed
            where = [_residency(engine, c) for c in chains]
            # the longest host run (ties: the most recent prompt) and the
            # longest cold run, each from the prompt's first block
            host_i = max(range(len(where)),
                         key=lambda i: (_run_length(where[i], "host"), i))
            cold_i = max(range(len(where)),
                         key=lambda i: _run_length(where[i], "cold"))
            m0 = engine.metrics()
            again_host = await _tiers_serve_one(engine, reqs[host_i])
            restored = engine.metrics()["host_kv_restored_total"] \
                - m0["host_kv_restored_total"]
            host_blocks = _tier_blocks(engine, chains[host_i][:restored])
            s0 = engine.scheduler.fabric_stats()
            # the host restore spilled more: the run the pull will take
            cold_run = min(_run_length(_residency(engine, chains[cold_i]), "cold"),
                           (TIERS_PROMPT - 1) // bs)
            t1 = time.monotonic()
            again_cold = await _tiers_serve_one(engine, reqs[cold_i])
            cold_pull_s = time.monotonic() - t1
            s1 = engine.scheduler.fabric_stats()
            pulled = s1["recent"][-1]["served"] if s1["recent"] else 0
            cold_blocks = _tier_blocks(engine, chains[cold_i][:pulled])
            launches = _read_launches()
            await engine.scheduler.fabric.cold.close()
            rates = _tier_rates(torch, engine, TIERS_RATE_BLOCKS)
            parted = _spec_agreement(
                torch, runner, [(prompts[host_i], {}), (prompts[cold_i], {})],
                [first_streams[host_i], first_streams[cold_i]],
                [again_host, again_cold])
            cold = engine.scheduler.fabric.cold
            out = dict(
                first_s=first_s, where={i: {t: w.count(t) for t in set(w)}
                                        for i, w in enumerate(where)},
                host_i=host_i, cold_i=cold_i, cold_run=cold_run,
                restored=restored, pulled=pulled, cold_pull_s=cold_pull_s,
                host_bad=compare(first[host_i], host_blocks, range(restored)),
                cold_bad=compare(first[cold_i], cold_blocks, range(pulled)),
                pull_commits=s1["pull_commits"] - s0["pull_commits"],
                parted=parted, stats=stats, staged=staged, guarded=guarded,
                launches=launches, metrics=engine.metrics(),
                fabric=engine.scheduler.fabric_stats(), rates=rates,
                cold_io=dict(put_bytes=cold.put_bytes, put_s=cold.put_s,
                             get_bytes=cold.get_bytes, get_s=cold.get_s,
                             checksum_s=cold.checksum_s),
                streams=[len(r["tokens"]) for r in
                         first_streams + [again_host, again_cold]],
                finishes=[r["finish"] for r in
                          first_streams + [again_host, again_cold]])
        finally:
            await engine.close()
        out["leaks"] = leaks(engine)
        return out, first, first_streams, engine.runner.params

    one, first, first_streams, params = asyncio.run(engine_one())

    # ---- 3-4: fresh engines over the cold directory
    async def fresh(corrupt: bool):
        engine = await TorchServingEngine.create(cfg(), params=params,
                                                 device=dev, warmup=False)
        try:
            cold = engine.scheduler.fabric.cold
            cold.refresh()
            where = [_residency(engine, c) for c in chains]
            i = max(range(len(where)), key=lambda j: _run_length(where[j], "cold"))
            # a pull leaves one prompt token uncached
            run = min(_run_length(where[i], "cold"), (TIERS_PROMPT - 1) // bs)
            victim = None
            if corrupt:
                c = run // 2
                victim = Path(cold.dir) / f"{chains[i][c] & (2**64 - 1):016x}.kvb"
                raw = bytearray(victim.read_bytes())
                raw[-1] ^= 0xFF
                victim.write_bytes(bytes(raw))
            t0 = time.monotonic()
            again = await _tiers_serve_one(engine, reqs[i])
            pull_s = time.monotonic() - t0
            s = engine.scheduler.fabric_stats()
            pulled = s["recent"][-1]["served"] if s["recent"] else 0
            blocks = _tier_blocks(engine, chains[i][:pulled])
            parted = _spec_agreement(torch, engine.runner, [(prompts[i], {})],
                                     [first_streams[i]], [again])
            out = dict(prompt=i, cold_run=run, pulled=pulled, seconds=pull_s,
                       bad=compare(first[i], blocks, range(pulled)),
                       parted=parted, fabric=s, metrics=engine.metrics(),
                       victim_left=victim.exists() if victim else None,
                       victim_index=run // 2 if corrupt else None,
                       tokens=len(again["tokens"]), finish=again["finish"])
        finally:
            await engine.close()
        out["leaks"] = leaks(engine)
        return out

    rehydrate = asyncio.run(fresh(False))
    corrupt = asyncio.run(fresh(True))

    # ---- 5: the host restore over an e4m3 cache
    async def fp8():
        engine = await TorchServingEngine.create(
            cfg("fp8", cold_tier_blocks=0, cold_tier_dir=""), params=params,
            device=dev, warmup=False)
        try:
            _reset_launches()
            streams, caps = [], []
            for r, chain in zip(reqs[:TIERS_FP8_PROMPTS], chains):
                streams.append(await _tiers_serve_one(engine, r))
                caps.append(_tier_blocks(engine, chain))
            where = [_residency(engine, c) for c in chains[:TIERS_FP8_PROMPTS]]
            i = max(range(len(where)),
                    key=lambda j: (_run_length(where[j], "host"), j))
            m0 = engine.metrics()["host_kv_restored_total"]
            again = await _tiers_serve_one(engine, reqs[i])
            restored = engine.metrics()["host_kv_restored_total"] - m0
            blocks = _tier_blocks(engine, chains[i][:restored])
            launches = _read_launches()
            parted = _spec_agreement(torch, engine.runner, [(prompts[i], {})],
                                     [streams[i]], [again])
            out = dict(prompt=i, restored=restored,
                       bad=compare(caps[i], blocks, range(restored)),
                       kv_dtype=str(engine.runner.kv_cache[0].dtype),
                       parted=parted, launches=launches,
                       metrics=engine.metrics(), tokens=len(again["tokens"]),
                       finish=again["finish"])
        finally:
            await engine.close()
        out["leaks"] = leaks(engine)
        return out

    e4m3 = asyncio.run(fp8())
    tmp.cleanup()

    m, io = one["metrics"], one["cold_io"]
    block_bytes = sum(
        FLAGSHIP["num_layers"] * bs * FLAGSHIP["num_kv_heads"]
        * FLAGSHIP["head_dim"] * 2 for _ in range(2))
    emit("engine_kv_tiers",
         model="Llama-3.2-1B shapes, seeded random bf16 weights",
         prompts=[TIERS_PROMPT] * TIERS_PROMPTS, new_tokens=TIERS_NEW,
         hbm_blocks=TIERS_ENGINE["num_kv_blocks"],
         host_blocks=TIERS_ENGINE["host_kv_blocks"],
         cold_blocks=TIERS_ENGINE["cold_tier_blocks"],
         block_bytes=block_bytes, first_pass_s=one["first_s"],
         residency_after_first_pass=one["where"],
         host_restore=dict(prompt=one["host_i"], blocks_restored=one["restored"],
                           blocks_mismatched=one["host_bad"]),
         cold_pull=dict(prompt=one["cold_i"], cold_run=one["cold_run"],
                        blocks_pulled=one["pulled"],
                        blocks_mismatched=one["cold_bad"],
                        request_s=one["cold_pull_s"]),
         rehydrate_fresh_engine={k: rehydrate[k] for k in (
             "prompt", "cold_run", "pulled", "bad", "seconds", "leaks")},
         corrupt_file={k: corrupt[k] for k in (
             "prompt", "cold_run", "victim_index", "pulled", "bad",
             "victim_left", "leaks")} | {"cold": corrupt["fabric"].get("cold")},
         e4m3_host_restore={k: e4m3[k] for k in (
             "prompt", "restored", "bad", "kv_dtype", "leaks")},
         greedy_parted=dict(first=one["parted"], rehydrate=rehydrate["parted"],
                            corrupt=corrupt["parted"], e4m3=e4m3["parted"]),
         guarded_steps=one["stats"]["step"], bad_bursts=one["stats"]["bad"],
         guarded_offloads=one["guarded"]["offload_batch"],
         guarded_restores=one["guarded"]["restore"],
         dispatches_with_staged_offloads=one["staged"]["with_staged"],
         dispatches=one["staged"]["dispatches"],
         host_tier={k: v for k, v in m.items() if k.startswith("host_kv")},
         cold_tier=dict({k: v for k, v in m.items() if k.startswith("cold_kv")},
                        **(one["fabric"].get("cold") or {})),
         fabric=dict(pulls=one["fabric"]["pulls"],
                     pull_commits=one["fabric"]["pull_commits"],
                     pull_fallbacks=one["fabric"]["pull_fallbacks"]),
         offload_restore=one["rates"],
         cold_write_mb_s=io["put_bytes"] / io["put_s"] / 1e6 if io["put_s"] else None,
         cold_read_mb_s=io["get_bytes"] / io["get_s"] / 1e6 if io["get_s"] else None,
         cold_checksum_share=(io["checksum_s"] / (io["put_s"] + io["get_s"])
                              if io["put_s"] + io["get_s"] else None),
         cold_io=io, native_xxh64=xxh, launches=one["launches"],
         launches_e4m3=e4m3["launches"], kv_blocks_left=dict(
             first=one["leaks"], rehydrate=rehydrate["leaks"],
             corrupt=corrupt["leaks"], e4m3=e4m3["leaks"]),
         seconds=time.monotonic() - t_phase, card=smi)

    # ---- checks
    if not one["restored"] or one["host_bad"]:
        raise AssertionError(f"kv_tiers: host restore {one['restored']} blocks, "
                             f"{one['host_bad']} differ")
    if (not one["pulled"] or one["pulled"] != one["cold_run"]
            or one["cold_bad"] or one["pull_commits"] != 1):
        raise AssertionError(f"kv_tiers: cold pull {one['pulled']} blocks, "
                             f"{one['cold_bad']} differ, {one['pull_commits']} commits")
    if not rehydrate["pulled"] or rehydrate["bad"] \
            or rehydrate["pulled"] != rehydrate["cold_run"]:
        raise AssertionError(f"kv_tiers: rehydrate {rehydrate}")
    if (corrupt["pulled"] != corrupt["victim_index"] or corrupt["bad"]
            or corrupt["victim_left"]
            or (corrupt["fabric"].get("cold") or {}).get("misses") != {"corrupt": 1}):
        raise AssertionError(f"kv_tiers: the corrupt file: {corrupt}")
    if not e4m3["restored"] or e4m3["bad"] or "float8" not in e4m3["kv_dtype"]:
        raise AssertionError(f"kv_tiers: e4m3 host restore {e4m3}")
    if one["stats"]["bad"] or not one["staged"]["with_staged"] \
            or not one["guarded"]["offload_batch"] or not one["guarded"]["restore"]:
        raise AssertionError(f"kv_tiers: guard {one['stats']} {one['staged']} "
                             f"{one['guarded']}")
    for name, lk in dict(first=one["leaks"], rehydrate=rehydrate["leaks"],
                         corrupt=corrupt["leaks"], e4m3=e4m3["leaks"]).items():
        if lk != dict(pinned=0, used=0):
            raise AssertionError(f"kv_tiers: {name} left blocks {lk}")
    if any(n != TIERS_NEW for n in one["streams"]) or any(
            f != "length" for f in one["finishes"]):
        raise AssertionError(f"kv_tiers: streams {one['streams']} {one['finishes']}")
    for r in (rehydrate, corrupt, e4m3):
        if r["tokens"] != TIERS_NEW or r["finish"] != "length":
            raise AssertionError(f"kv_tiers: a stream of {r['tokens']} tokens")
    if on_card:
        lc, l8 = one["launches"], e4m3["launches"]
        if not (lc["paged_decode"] and lc["paged_flash"] and lc["epilogue"]
                and l8["paged_decode_fp8"] and l8["paged_flash_fp8"]):
            raise AssertionError(f"kv_tiers: launches {lc} {l8}")
    lc, l8 = one["launches"], e4m3["launches"]
    return dict(paged_decode=lc["paged_decode"], paged_flash=lc["paged_flash"],
                sampling_epilogue=lc["epilogue"],
                paged_decode_fp8=l8["paged_decode_fp8"],
                paged_flash_fp8=l8["paged_flash_fp8"])


# ------------------------------------------------------------- engine_load

# Qwen2.5-7B (its published config.json): 28 layers, 28 query heads over 4
# KV heads of dim 128 (G 7), qkv biases, SwiGLU 18,944 wide, rope theta 1e6,
# RMS eps 1e-6, no sliding window, an untied 152,064 vocabulary: 7.62 B
# parameters, 15.2 GB in bf16
QWEN25_7B = {
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
    "vocab_size": 152064, "hidden_size": 3584, "intermediate_size": 18944,
    "num_hidden_layers": 28, "num_attention_heads": 28,
    "num_key_value_heads": 4, "max_position_embeddings": 131072,
    "max_window_layers": 28, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
    "sliding_window": 131072, "use_sliding_window": False,
    "tie_word_embeddings": False, "hidden_act": "silu",
    "attention_dropout": 0.0, "bos_token_id": 151643,
    "eos_token_id": 151643, "torch_dtype": "bfloat16",
}
QWEN_SPECIAL = {151643: "<|endoftext|>", 151644: "<|im_start|>",
                151645: "<|im_end|>"}
QWEN_CHAT_TEMPLATE = (
    "{% for m in messages %}<|im_start|>{{ m['role'] }}\n{{ m['content'] }}"
    "<|im_end|>\n{% endfor %}{% if add_generation_prompt %}<|im_start|>"
    "assistant\n{% endif %}")
LOAD_SHARDS = 4
# a depth cut that keeps the whole script inside its time limit (of 28
# layers); the widths stay the published ones
LOAD_LAYERS = 4
LOAD_DRAWN_SCALE = 0.1   # qkv biases N(0, 0.1^2), norms 1 + N(0, 0.1^2)
LOAD_CLI_TIMEOUT_S = 600
# the CLI's flags (a CPU rehearsal appends "--device", "cpu")
LOAD_CLI_FLAGS = ["--max-model-len", str(ENGINE["max_model_len"]),
                  "--num-kv-blocks", str(ENGINE["num_kv_blocks"]),
                  "--kv-block-size", str(ENGINE["kv_block_size"])]
LOAD_EXTRA = dict(max_prefill_tokens_per_step=ENGINE["max_prefill_tokens_per_step"])
ST_DTYPE_NAMES = {"torch.bfloat16": "BF16"}
GGUF_Q8_0, GGUF_F32 = 8, 0


def _qwen2_hf_tensors(params, layers):
    """(HF name, the tensor on the card in HF's [out, in] layout: a view of
    the port's leaf) of a Qwen2 checkpoint."""
    out = [("model.embed_tokens.weight", params["embed"]),
           ("model.norm.weight", params["final_norm"]),
           ("lm_head.weight", params["lm_head"].T)]
    lay = params["layers"]
    for i in range(layers):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", lay["ln1"][i]),
                (p + "post_attention_layernorm.weight", lay["ln2"][i])]
        for key, name in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                          ("wo", "o_proj")):
            out.append((p + f"self_attn.{name}.weight", lay[key][i].T))
        for key, name in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            out.append((p + f"self_attn.{name}.bias", lay[key][i]))
        for key, name in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                          ("w_down", "down_proj")):
            out.append((p + f"mlp.{name}.weight", lay[key][i].T))
    return out


def _host_bytes(t):
    """A card tensor's bytes on the host as a numpy view of its one copy."""
    import torch

    return t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy()


def _page_cache_bytes():
    """``Cached`` of /proc/meminfo in bytes (None where absent)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("Cached:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def _mount_of(path):
    """The (mount point, filesystem type) of /proc/mounts that holds
    ``path``."""
    best = ("", None)
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                mnt, fs = parts[1], parts[2]
                if (str(path) + "/").startswith(mnt.rstrip("/") + "/") and \
                        len(mnt) >= len(best[0]):
                    best = (mnt, fs)
    except OSError:
        pass
    return best


def evict_page_cache(paths):
    """Ask the kernel to drop ``paths``' pages (synced by their writer) from
    the page cache, ``posix_fadvise(POSIX_FADV_DONTNEED)`` on each; returns
    the page cache's bytes before and after: whether the advice took shows
    there (a user-space kernel or a memory-backed filesystem may keep the
    pages)."""
    before = _page_cache_bytes()
    for p in paths:
        fd = os.open(p, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    after = _page_cache_bytes()
    return dict(page_cache_before_bytes=before, page_cache_after_bytes=after,
                dropped_bytes=None if None in (before, after) else before - after,
                mount=_mount_of(Path(paths[0]).parent))


def write_safetensors_snapshot(path, tensors, shards=LOAD_SHARDS) -> int:
    """An HF safetensors snapshot of ``tensors`` ((name, tensor on the card)
    pairs): ``shards`` files of about equal bytes, each an 8-byte header
    length, the JSON header (dtype, shape, data_offsets a tensor) and the
    tensors' bytes, one tensor on the host at a time, synced to disk; and
    the ``model.safetensors.index.json`` weight map. Returns the bytes."""
    import struct

    sizes = [t.numel() * t.element_size() for _, t in tensors]
    total, acc = sum(sizes), 0
    groups = [[] for _ in range(shards)]
    for (name, t), n in zip(tensors, sizes):
        groups[min(shards - 1, acc * shards // total)].append((name, t, n))
        acc += n
    weight_map = {}
    for i, group in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        header, off = {}, 0
        for name, t, n in group:
            header[name] = {"dtype": ST_DTYPE_NAMES[str(t.dtype)],
                            "shape": list(t.shape),
                            "data_offsets": [off, off + n]}
            weight_map[name] = fname
            off += n
        head = json.dumps(header).encode()
        head += b" " * ((-len(head)) % 8)
        with open(Path(path) / fname, "wb") as f:
            f.write(struct.pack("<Q", len(head)) + head)
            for _, t, _ in group:
                f.write(_host_bytes(t))
            f.flush()
            os.fsync(f.fileno())  # on disk: its pages can leave the cache
    (Path(path) / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return total


def _q8_0(torch, w):
    """llama.cpp's Q8_0 of an [out, in] weight on the card: per 32-value
    block of a row, d = max |x| / 127 stored in f16 and q = round(x / d) in
    int8. Returns (the blocks' bytes as a uint8 [blocks, 34] tensor on the
    card: d then q, in row order; the dequantized d * q as bf16 [out, in],
    the weight a loader of the file gets)."""
    x = w.float().reshape(-1, 32)
    amax = x.abs().amax(dim=1, keepdim=True)
    d = amax / torch.full_like(amax, 127.0)
    q = torch.where(d > 0, x / torch.where(d > 0, d, torch.ones_like(d)),
                    torch.zeros_like(x)).round_().clamp_(-127, 127)
    d16 = d.half()
    blocks = torch.cat([d16.view(torch.uint8), q.to(torch.int8).view(torch.uint8)],
                       dim=1)
    dq = (d16.float() * q).reshape(w.shape).bfloat16()
    return blocks, dq


def _gguf_permute(w, n_head):
    """llama.cpp's converter's q/k row permutation of an [out, in] weight."""
    out, inner = w.shape
    return (w.reshape(n_head, 2, out // n_head // 2, inner).transpose(1, 2)
            .reshape(out, inner))


def _gguf_value(vtype, v) -> bytes:
    import struct

    if vtype == 8:       # string
        raw = v.encode()
        return struct.pack("<Q", len(raw)) + raw
    if vtype == 9:       # array (item type, values)
        item, vals = v
        return struct.pack("<IQ", item, len(vals)) + b"".join(
            _gguf_value(item, x) for x in vals)
    return struct.pack({4: "<I", 5: "<i", 6: "<f"}[vtype], v)


def write_gguf_llama_q8(torch, path, mcfg, params, tokenizer_spec):
    """A llama.cpp-style GGUF v3 file of the Llama tree ``params`` (on the
    card, tied embeddings): every matmul weight in Q8_0 (q and k rows
    permuted as llama.cpp's converter does), the norms in F32, the ``gpt2``
    tokenizer kind from ``tokenizer_spec``'s vocabulary and merges (its
    added tokens CONTROL). Returns (bytes written, the tree a loader of the
    file gets: every Q8_0 leaf replaced by d * q)."""
    import struct

    lay = params["layers"]
    vocab = tokenizer_spec["model"]["vocab"]
    tokens = [t for t, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
    specials = {t["content"] for t in tokenizer_spec["added_tokens"]}
    meta = [("general.architecture", 8, "llama"),
            ("general.name", 8, "llama-3.2-1b-q8_0-random"),
            ("general.alignment", 4, 32),
            ("llama.context_length", 4, mcfg.max_position_embeddings),
            ("llama.embedding_length", 4, mcfg.hidden_size),
            ("llama.block_count", 4, mcfg.num_layers),
            ("llama.feed_forward_length", 4, mcfg.intermediate_size),
            ("llama.attention.head_count", 4, mcfg.num_heads),
            ("llama.attention.head_count_kv", 4, mcfg.num_kv_heads),
            ("llama.attention.key_length", 4, mcfg.head_dim),
            ("llama.rope.freq_base", 6, mcfg.rope_theta),
            ("llama.attention.layer_norm_rms_epsilon", 6, mcfg.rms_norm_eps),
            ("tokenizer.ggml.model", 8, "gpt2"),
            ("tokenizer.ggml.tokens", 9, (8, tokens)),
            ("tokenizer.ggml.token_type", 9,
             (5, [3 if t in specials else 1 for t in tokens])),
            ("tokenizer.ggml.merges", 9,
             (8, [" ".join(m) for m in tokenizer_spec["model"]["merges"]])),
            # Llama-3's <|begin_of_text|> and <|eot_id|>: 128,000 and 128,009
            ("tokenizer.ggml.bos_token_id", 4, len(tokens) - 256),
            ("tokenizer.ggml.eos_token_id", 4, len(tokens) - 247),
            ("tokenizer.chat_template", 8, LLAMA3_CHAT_TEMPLATE)]
    loaded = {"final_norm": params["final_norm"],
              "layers": {k: lay[k] for k in ("ln1", "ln2")}}
    # (name, ggml type, numpy shape [out, in], card tensor or its q8 bytes)
    items = [("output_norm.weight", GGUF_F32, params["final_norm"])]
    blocks, loaded["embed"] = _q8_0(torch, params["embed"])
    items.append(("token_embd.weight", GGUF_Q8_0, (params["embed"].shape, blocks)))
    for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        loaded["layers"][key] = torch.empty_like(lay[key])
    for i in range(mcfg.num_layers):
        items += [(f"blk.{i}.attn_norm.weight", GGUF_F32, lay["ln1"][i]),
                  (f"blk.{i}.ffn_norm.weight", GGUF_F32, lay["ln2"][i])]
        for key, name, heads in (("wq", "attn_q", mcfg.num_heads),
                                 ("wk", "attn_k", mcfg.num_kv_heads),
                                 ("wv", "attn_v", 0), ("wo", "attn_output", 0),
                                 ("w_gate", "ffn_gate", 0), ("w_up", "ffn_up", 0),
                                 ("w_down", "ffn_down", 0)):
            w = lay[key][i].T  # [out, in]
            blocks, dq = _q8_0(torch, w)
            loaded["layers"][key][i].copy_(dq.T)
            if heads:  # the file holds the permuted rows (row-wise blocks)
                blocks = _gguf_permute(blocks.reshape(w.shape[0], -1), heads)
            items.append((f"blk.{i}.{name}.weight", GGUF_Q8_0, (w.shape, blocks)))
    descs, off = [], 0
    for name, kind, t in items:
        shape = tuple(t.shape) if kind == GGUF_F32 else tuple(t[0])
        n = (t.numel() * 4 if kind == GGUF_F32
             else t[1].numel())
        descs.append((name, tuple(reversed(shape)), kind, off))
        off += n + (-n) % 32
    total = 0
    with open(path, "wb") as f:
        f.write(b"GGUF" + struct.pack("<IQQ", 3, len(descs), len(meta)))
        for key, vtype, v in meta:
            f.write(_gguf_value(8, key) + struct.pack("<I", vtype)
                    + _gguf_value(vtype, v))
        for name, ne, kind, o in descs:
            f.write(_gguf_value(8, name) + struct.pack("<I", len(ne))
                    + b"".join(struct.pack("<Q", d) for d in ne)
                    + struct.pack("<IQ", kind, o))
        f.write(b"\0" * ((-f.tell()) % 32))
        for name, kind, t in items:
            raw = _host_bytes(t.float() if kind == GGUF_F32 else t[1])
            f.write(raw)
            f.write(b"\0" * ((-raw.size) % 32))
        total = f.tell()
    return total, loaded


class RssPeak:
    """The resident set of process ``pid`` ("self": this one) while the
    ``with`` block runs: ``VmRSS`` and ``RssFile`` (mapped file pages) of
    ``/proc/<pid>/status`` sampled every 5 ms on a thread; ``before`` and
    ``peak`` in bytes (empty where the kernel reports neither). Sampled,
    because ``getrusage``'s peak under a user-space kernel (gVisor) need not
    be the process's."""

    KEYS = ("VmRSS", "RssFile")

    def __init__(self, pid="self"):
        self.path = f"/proc/{pid}/status"
        self.before, self.peak = self._read(), {}

    def _read(self):
        out = {}
        try:
            with open(self.path) as f:
                for line in f:
                    key, _, value = line.partition(":")
                    if key in self.KEYS:
                        out[key] = int(value.split()[0]) * 1024
        except OSError:
            pass
        return out

    def _run(self):
        while not self._stop.is_set():
            for key, value in self._read().items():
                self.peak[key] = max(self.peak.get(key, 0), value)
            self._stop.wait(0.005)

    def __enter__(self):
        import threading

        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


async def _cli_completions(port, model, batch, new_tokens, vocab_ids):
    """``batch`` ((prompt, sampling kwargs) pairs; a prompt of token ids or
    a text) as streamed /v1/completions requests, ``new_tokens`` each, sent
    at once; per request its token ids (the logprob entries' token strings
    through ``vocab_ids``), finish reason, TTFT and streamed text."""
    async def one(prompt, samp):
        status, _, raw, events = await http_request(
            port, "POST", "/v1/completions", dict(
                model=model, prompt=prompt, max_tokens=new_tokens, stream=True,
                logprobs=0, ignore_eos=True, **samp))
        if status != 200:
            raise AssertionError(f"the CLI answered {status}: {raw[:300]}")
        rec = _stream_record(events, chat=False)
        return dict(tokens=[vocab_ids[t] for t in rec["tokens"]],
                    finish=rec["finish"], ttft_s=rec["ttft_s"],
                    text=rec["text"])
    return await asyncio.gather(*(one(p, s) for p, s in batch))


def _cli_serve(model_path, model_name, extra, waves, vocab_ids,
               flags=LOAD_CLI_FLAGS):
    """``python3 -m dynamo_tpu_torch.cli.run in=http out=torch --model-path
    <model_path>`` (no ``--allow-random-weights``: the checkpoint is loaded)
    in a subprocess on the card, with the engine flags ``flags``: each of
    ``waves`` ((batch, new tokens) pairs) in turn over HTTP
    (``_cli_completions``), then SIGINT and exit code 0. Returns the waves'
    records, the seconds to /health answering (the load included) and the
    child's sampled resident set from its start to /health."""
    import signal
    import tempfile

    tmp = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
    json.dump(extra, tmp)
    tmp.close()
    args = [sys.executable, "-m", "dynamo_tpu_torch.cli.run", "in=http",
            "out=torch", "--model-path", model_path, "--model-name", model_name,
            "--extra-engine-args", tmp.name, "--http-host", "127.0.0.1",
            "--http-port", "0", *flags]
    t0 = time.monotonic()
    proc = subprocess.Popen(args, cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        with RssPeak(proc.pid) as rss:
            while "listening on" not in line:
                line = proc.stdout.readline()
                if (not line and proc.poll() is not None) or (
                        time.monotonic() - t0 > LOAD_CLI_TIMEOUT_S):
                    raise AssertionError(f"the CLI did not start: {line!r} "
                                         f"{proc.stderr.read()[-3000:]}")
        port = int(line.strip().rsplit(":", 1)[1])
        startup_s = time.monotonic() - t0
        out, walls = [], []
        for batch, new_tokens in waves:
            t1 = time.monotonic()
            out.append(asyncio.run(_cli_completions(port, model_name, batch,
                                                    new_tokens, vocab_ids)))
            walls.append(time.monotonic() - t1)
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
        if rc != 0:
            raise AssertionError(f"the CLI exited {rc} on SIGINT: "
                                 f"{proc.stderr.read()[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        Path(tmp.name).unlink()
    return out, dict(startup_s=startup_s, wave_wall_s=walls, exit_code=rc,
                     startup_peak_rss_bytes=rss.peak)


def _held_greedy(torch, runner, requests, base, got, label):
    """``got`` streams against ``base`` (the same requests in-process): the
    greedy ones equal, or parted at a near-tie (``_spec_agreement``'s rule,
    on ``runner``); the sampled ones counted. Returns (greedy equal,
    greedy parted records, sampled equal, sampled count)."""
    greedy = [i for i, (_, s) in enumerate(requests) if s["temperature"] == 0]
    sampled = [i for i in range(len(requests)) if i not in greedy]
    for r in got:
        if len(r["tokens"]) != NEW_TOKENS and len(r["tokens"]) != SPEC_NEW_TOKENS:
            raise AssertionError(f"{label}: a stream of {len(r['tokens'])} tokens")
    parted = _spec_agreement(torch, runner, [requests[i] for i in greedy],
                             [base[i] for i in greedy], [got[i] for i in greedy])
    return (sum(base[i]["tokens"] == got[i]["tokens"] for i in greedy), parted,
            sum(base[i]["tokens"] == got[i]["tokens"] for i in sampled),
            len(sampled))


def engine_load_phase(torch, dev, smi):
    """Checkpoints from files, on the card (the port's loader,
    ``models/loader.py``):

    1. Qwen2.5-7B at full width, its depth cut to ``LOAD_LAYERS`` of 28,
       from its published config (``QWEN25_7B``: G 7, qkv biases, V
       152,064): weights drawn on the
       card from the seed (non-zero biases, non-unit norms), written as a
       4-shard HF safetensors snapshot (HF names, [out, in], the index file,
       a synthetic 152,064-id ``tokenizer.json`` with Qwen's specials and a
       ChatML ``tokenizer_config.json``) in a temporary directory, synced,
       its shards' pages advised out of the page cache
       (``evict_page_cache``, which reports whether they left), loaded by
       ``ModelRunner(model_dir=...)``: every leaf ``torch.equal`` to the
       drawn one; the bytes, write and load seconds, load GB/s, peak device
       memory of the load against the parameter bytes, the host's peak RSS
       during the load; then loaded again from the page cache the first
       load filled (``load_warm_s``);
    2. the main path over the loaded leaves (``TorchServingEngine``, the
       fused epilogue): wave 1 and the prefix-hit wave, launches counted
       from 0 after the engine's warmup and read just after; a profiled
       decode step (``_decode_step_profile``); 2-layer logits against the
       CPU in f32; the spec prompts without and with ngram speculation
       (verify launches, counted the same way);
    3. the CLI in a subprocess with ``--model-path`` and no
       ``--allow-random-weights`` (ngram speculation on, by
       ``--extra-engine-args``): wave 1 and the spec prompts over
       /v1/completions; every greedy stream equals the in-process engine's
       or parts at a near-tie;
    4. Llama-3.2-1B at full width and depth as one GGUF file (Q8_0
       weights, F32 norms, the ``gpt2`` tokenizer kind from
       ``engine_http``'s synthetic vocabulary and merges) served by the CLI
       with ``--model-path m.gguf``: wave 1's greedy streams equal an
       in-process engine's given d * q directly, or part at a near-tie.

    The temporary files are removed in ``finally``. Returns the main path's
    launch counts under the Qwen2.5 kernels-line keys."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="engine_load_"))
    try:
        return _engine_load(torch, dev, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _engine_load(torch, dev, smi, tmp):
    import dataclasses

    from dynamo_tpu_torch.cli import run
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.model_runner import ModelRunner
    from dynamo_tpu_torch.engine.serving import (
        TorchServingEngine,
        engine_config_from_mdc,
    )
    from dynamo_tpu_torch.models import llama

    on_card = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    # the depth cut (of 28 layers) reaches the snapshot's config.json, so
    # every engine and CLI here reads the same model
    hf = dict(QWEN25_7B, num_hidden_layers=LOAD_LAYERS,
              max_window_layers=LOAD_LAYERS)
    snap = tmp / "qwen2.5-7b-random"
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps(hf, indent=1))
    tok_spec = synthetic_tokenizer(hf["vocab_size"],
                                   n_special=hf["vocab_size"] - min(QWEN_SPECIAL),
                                   special_names=QWEN_SPECIAL)
    (snap / "tokenizer.json").write_text(json.dumps(tok_spec, ensure_ascii=False),
                                         encoding="utf-8")
    (snap / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": None, "eos_token": "<|endoftext|>",
        "chat_template": QWEN_CHAT_TEMPLATE}))
    vocab_ids = tok_spec["model"]["vocab"]
    mcfg = ModelConfig.from_hf_config(hf)
    layers, vocab = mcfg.num_layers, mcfg.vocab_size
    flags = run.parse_flags(["--model-path", str(snap), *LOAD_CLI_FLAGS])
    mdc = run.load_mdc(flags)
    cfg = engine_config_from_mdc(mdc, flags, extra=LOAD_EXTRA)

    # ---- 1. draw, write, load
    gen = torch.Generator(device=dev).manual_seed(SEED)
    drawn = llama.init_params(mcfg, gen, torch.bfloat16, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    lay = drawn["layers"]
    for key in ("bq", "bk", "bv"):
        lay[key].copy_(torch.randn(lay[key].shape, generator=g, device=dev)
                       * LOAD_DRAWN_SCALE)
    for key in ("ln1", "ln2"):
        lay[key].copy_(1 + torch.randn(lay[key].shape, generator=g, device=dev)
                       * LOAD_DRAWN_SCALE)
    n_params = sum(t.numel() for grp in drawn.values()
                   for t in (grp.values() if isinstance(grp, dict) else [grp]))
    param_bytes = _tree_bytes(drawn)
    sync()
    t0 = time.monotonic()
    written = write_safetensors_snapshot(snap, _qwen2_hf_tensors(drawn, layers))
    write_s = time.monotonic() - t0
    shards = sorted(p.name for p in snap.glob("*.safetensors"))
    gc.collect()
    sync()
    evicted = evict_page_cache([str(snap / n) for n in shards])
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev) if on_card else 0
    with RssPeak() as rss:
        t0 = time.monotonic()
        runner = ModelRunner(cfg, device=dev, model_dir=str(snap))
        sync()
        load_s = time.monotonic() - t0
    load_peak = (torch.cuda.max_memory_allocated(dev) - before) if on_card else None
    kv_bytes = _cache_bytes(runner.kv_cache)
    loaded = runner.params

    def flat(p):
        return dict(p["layers"], **{k: v for k, v in p.items() if k != "layers"})
    unequal = sorted(k for k, v in flat(drawn).items()
                     if not torch.equal(v, flat(loaded)[k]))
    if sorted(flat(drawn)) != sorted(flat(loaded)):
        unequal.append(f"keys {sorted(flat(drawn))} != {sorted(flat(loaded))}")
    del drawn, lay
    gc.collect()
    torch.cuda.empty_cache()
    # the same load again, from the page cache the first one filled
    cache_after_load = _page_cache_bytes()
    sync()
    t0 = time.monotonic()
    warm = ModelRunner(cfg, device=dev, model_dir=str(snap))
    sync()
    load_warm_s = time.monotonic() - t0
    del warm
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 2. the main path over the loaded leaves
    rng = np.random.default_rng(SEED)
    wave1, wave2 = _requests(rng, vocab)
    spec_reqs = _spec_requests(rng)

    async def serve(kw, batches, new_tokens=None, count=False, profile=False):
        """``batches`` in turn on an engine over the loaded leaves; with
        ``count`` the launches from 0 after the engine's warmup to the last
        batch's end."""
        gc.collect()
        engine = await TorchServingEngine.create(
            dataclasses.replace(cfg, **kw), params=loaded, device=dev)
        try:
            if count:
                _reset_launches()
            res, walls = [], []
            for batch in batches:
                t0 = time.monotonic()
                res.append(await _serve(engine, batch, new_tokens))
                walls.append(time.monotonic() - t0)
            launches = _read_launches() if count else None
            step = (_decode_step_profile(torch, engine.runner)
                    if profile and on_card else None)
            metrics = dict(engine.metrics(), decode_step=step)
        finally:
            await engine.close()
        return res, walls, launches, metrics

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    (res1, res2), (wall1, _), launches, metrics = asyncio.run(
        serve({}, [wave1, wave2], count=True, profile=True))
    step = metrics.pop("decode_step")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    prompts = (wave1[4][0][:100], wave1[2][0][:40])
    lay2 = {k: v[:2] for k, v in loaded["layers"].items()}
    logits = _check_logits(torch, cfg, llama,
                           dataclasses.replace(mcfg, num_layers=2),
                           runner.device, dict(loaded, layers=lay2), *prompts)
    (spec_base,), _, _, _ = asyncio.run(serve({}, [spec_reqs], SPEC_NEW_TOKENS))
    (res_spec,), (wall_spec,), launches_spec, metrics_spec = asyncio.run(
        serve(SPEC, [spec_reqs], SPEC_NEW_TOKENS, count=True))
    parted_spec = _spec_agreement(torch, runner, spec_reqs, spec_base, res_spec)

    # ---- 3. the CLI over the snapshot
    gc.collect()
    torch.cuda.empty_cache()
    (cli_w1, cli_spec), cli = _cli_serve(
        str(snap), "qwen2.5-7b-random", dict(LOAD_EXTRA, **SPEC),
        [(wave1, NEW_TOKENS), (spec_reqs, SPEC_NEW_TOKENS)], vocab_ids)
    held_w1 = _held_greedy(torch, runner, wave1, res1, cli_w1, "CLI wave 1")
    held_spec = _held_greedy(torch, runner, spec_reqs, spec_base, cli_spec,
                             "CLI spec wave")
    del runner, loaded, lay2
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 4. Llama-3.2-1B as a GGUF file (Q8_0)
    gguf_path = tmp / "llama-3.2-1b-q8_0.gguf"
    g_hf = {k: v for k, v in FLAGSHIP.items() if k != "rope_scaling"}
    gcfg0 = ModelConfig(**g_hf, rms_norm_eps=1e-5)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    g_params = llama.init_params(gcfg0, gen, torch.bfloat16, dev)
    t0 = time.monotonic()
    spec128 = synthetic_tokenizer(FLAGSHIP["vocab_size"], seed=SEED)
    gguf_bytes, g_loaded = write_gguf_llama_q8(torch, gguf_path, gcfg0,
                                               g_params, spec128)
    gguf_write_s = time.monotonic() - t0
    del g_params
    g_flags = run.parse_flags(["--model-path", str(gguf_path), *LOAD_CLI_FLAGS])
    g_mdc = run.load_mdc(g_flags)
    g_cfg = engine_config_from_mdc(g_mdc, g_flags, extra=LOAD_EXTRA)
    for field in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
                  "num_heads", "num_kv_heads", "head_dim", "tie_word_embeddings"):
        if getattr(g_cfg.model, field) != getattr(gcfg0, field):
            raise AssertionError(f"GGUF config {field}: "
                                 f"{getattr(g_cfg.model, field)} != "
                                 f"{getattr(gcfg0, field)}")
    g_rng = np.random.default_rng(SEED + 2)
    g_wave1, _ = _requests(g_rng, g_cfg.model.vocab_size)

    async def serve_gguf():
        engine = await TorchServingEngine.create(g_cfg, params=g_loaded,
                                                 device=dev)
        try:
            return await _serve(engine, g_wave1), engine.runner
        finally:
            await engine.close()
    g_res, g_runner = asyncio.run(serve_gguf())
    (g_cli,), g_cli_info = _cli_serve(str(gguf_path), "llama-3.2-1b-q8_0",
                                      LOAD_EXTRA, [(g_wave1, NEW_TOKENS)],
                                      spec128["model"]["vocab"])
    held_gguf = _held_greedy(torch, g_runner, g_wave1, g_res, g_cli, "GGUF CLI")
    del g_runner, g_loaded
    gc.collect()
    torch.cuda.empty_cache()

    ttfts = sorted(r["ttft_s"] for r in res1)
    cli_ttfts = sorted(r["ttft_s"] for r in cli_w1)
    emit("engine_load", model="Qwen2ForCausalLM (Qwen2.5-7B published "
         "config.json), seeded random bf16 weights written as an HF "
         "safetensors snapshot and loaded by ModelRunner(model_dir=...)",
         layers=layers, vocab=vocab, parameters=n_params,
         parameter_bytes=param_bytes, snapshot_bytes=written,
         shards=shards, write_s=write_s, page_cache_eviction=evicted,
         page_cache_after_load_bytes=cache_after_load, load_s=load_s,
         load_gb_per_s=written / load_s / 1e9, load_warm_s=load_warm_s,
         load_warm_gb_per_s=written / load_warm_s / 1e9,
         load_peak_device_bytes_over_before=load_peak,
         load_kv_cache_bytes=kv_bytes,
         load_peak_device_bytes_past_params_and_cache=(
             None if load_peak is None else load_peak - param_bytes - kv_bytes),
         host_rss_before_load_bytes=rss.before,
         host_rss_peak_during_load_bytes=rss.peak,
         leaves_equal_to_drawn=not unequal,
         config={k: getattr(cfg, k) for k in (
             "max_batch_size", "max_model_len", "kv_block_size",
             "num_kv_blocks", "max_prefill_tokens_per_step")},
         requests=len(res1) + len(res2), new_tokens=NEW_TOKENS,
         wave1_prompt_tokens=sum(len(p) for p, _ in wave1), wave1_wall_s=wall1,
         wave1_output_tokens_per_s=len(res1) * NEW_TOKENS / wall1,
         ttft_s=dict(min=ttfts[0], median=ttfts[len(ttfts) // 2],
                     max=ttfts[-1]),
         peak_memory_bytes=peak, launches=launches, metrics=metrics,
         decode_step=step, logits_vs_cpu_f32_2_layers=logits,
         spec=dict(**SPEC, requests=len(spec_reqs), new_tokens=SPEC_NEW_TOKENS,
                   proposed=metrics_spec["spec_proposed_tokens"],
                   accepted=metrics_spec["spec_accepted_tokens"], wall_s=wall_spec,
                   streams_equal=sum(a["tokens"] == b["tokens"]
                                     for a, b in zip(spec_base, res_spec)),
                   parted=parted_spec, launches=launches_spec),
         cli=dict(cli, wave1_ttft_s=dict(min=cli_ttfts[0],
                                         median=cli_ttfts[len(cli_ttfts) // 2],
                                         max=cli_ttfts[-1]),
                  wave1_greedy_equal=held_w1[0], wave1_greedy_parted=held_w1[1],
                  wave1_sampled_equal=f"{held_w1[2]}/{held_w1[3]}",
                  spec_greedy_equal=held_spec[0], spec_parted=held_spec[1]),
         gguf=dict(model="Llama-3.2-1B shapes (no llama3 rope scaling: a GGUF "
                   "holds it as a rope_freqs tensor the loader does not read), "
                   "Q8_0 weights, F32 norms, gpt2 tokenizer kind",
                   bytes=gguf_bytes, write_s=gguf_write_s,
                   cli=g_cli_info, greedy_equal=held_gguf[0],
                   greedy_parted=held_gguf[1],
                   sampled_equal=f"{held_gguf[2]}/{held_gguf[3]}"),
         card=smi)

    # ---- checks
    if unequal:
        raise AssertionError(f"loaded leaves differ from the drawn ones: {unequal}")
    _check_streams(res1 + res2, NEW_TOKENS, vocab)
    _check_streams(spec_base + res_spec, SPEC_NEW_TOKENS, vocab)
    if metrics["gpu_prefix_cache_hit_rate"] <= 0:
        raise AssertionError("Qwen2.5-7B: the shared-prefix request missed "
                             "the prefix cache")
    if metrics_spec["spec_proposed_tokens"] <= 0:
        raise AssertionError("Qwen2.5-7B: ngram speculation proposed nothing")
    if on_card:
        _check_launches("Qwen2.5-7B main", launches,
                        ("paged_decode", "paged_flash", "epilogue"), layers)
        _check_launches("Qwen2.5-7B spec", launches_spec, ("paged_verify",),
                        layers)
        if launches["mla_decode"] or launches["sp_prefix"]:
            raise AssertionError(f"the Qwen2.5-7B path launched a foreign "
                                 f"kernel: {launches}")
    return {"paged_decode_qwen25": launches["paged_decode"],
            "paged_flash_qwen25": launches["paged_flash"],
            "sampling_epilogue_qwen25": launches["epilogue"],
            "paged_verify_qwen25": launches_spec["paged_verify"]}


# ------------------------------------------------------------- engine_spec

# Llama-3.1-8B (its published config.json): 32 layers, 32 query heads over
# 8 KV heads of dim 128, llama3 rope scaling (factor 8), untied 128,256
# vocabulary: 8.03 B parameters, 16.1 GB in bf16. Drafted by Llama-3.2-1B
# (FLAGSHIP, the same vocabulary)
LLAMA_31_8B = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "rope_theta": 500000.0,
    "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                     "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192},
    "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
    "tie_word_embeddings": False, "hidden_act": "silu",
    "attention_bias": False, "bos_token_id": 128000,
    "eos_token_id": [128001, 128008, 128009], "torch_dtype": "bfloat16",
}
# the 8B of engine_spec and engine_recovery: its depth cut to keep the whole
# script inside its time limit, widths kept
LLAMA_8B_LAYERS = 16
LLAMA_8B_CUT = dict(LLAMA_31_8B, num_hidden_layers=LLAMA_8B_LAYERS)
SPEC_DRAFT_K = 4
# leg C's self-draft: the first prompts of the spec wave
SPEC_SELF_REQUESTS = 4
SPEC_CHAIN = dict(decode_pipeline_depth=2, multi_step_decode=4)
SPEC_CLI_TIMEOUT_S = 300


def _flagship_hf_config():
    """FLAGSHIP (Llama-3.2-1B) as its published ``config.json``."""
    f = FLAGSHIP
    return {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": f["vocab_size"], "hidden_size": f["hidden_size"],
        "intermediate_size": f["intermediate_size"],
        "num_hidden_layers": f["num_layers"],
        "num_attention_heads": f["num_heads"],
        "num_key_value_heads": f["num_kv_heads"], "head_dim": f["head_dim"],
        "rope_theta": f["rope_theta"],
        "max_position_embeddings": f["max_position_embeddings"],
        "tie_word_embeddings": f["tie_word_embeddings"],
        "rope_scaling": f["rope_scaling"], "rms_norm_eps": 1e-5,
        "hidden_act": "silu", "attention_bias": False,
        "bos_token_id": 128000, "eos_token_id": 128009,
        "torch_dtype": "bfloat16"}


def _llama_hf_tensors(params, layers):
    """(HF name, the tensor on the card in HF's [out, in] layout) of a
    Llama checkpoint; a tied head (no ``lm_head`` leaf) writes none."""
    out = [("model.embed_tokens.weight", params["embed"]),
           ("model.norm.weight", params["final_norm"])]
    if "lm_head" in params:
        out.append(("lm_head.weight", params["lm_head"].T))
    lay = params["layers"]
    for i in range(layers):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", lay["ln1"][i]),
                (p + "post_attention_layernorm.weight", lay["ln2"][i])]
        for key, name in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                          ("wo", "o_proj")):
            out.append((p + f"self_attn.{name}.weight", lay[key][i].T))
        for key, name in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                          ("w_down", "down_proj")):
            out.append((p + f"mlp.{name}.weight", lay[key][i].T))
    return out


def _guard_spec_rounds(torch, engine, on_card=True):
    """Wrap the pieces of a propose-verify round so that each runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync inside raises):
    the target's ``decode_burst_spec``, the draft's ``decode_burst`` and the
    device mask between them (the draft's ``live_rows``), and the outputs'
    staging. Counts, per call, the verify kernel's launches of a round
    (once a target layer) and the decode kernel's and the epilogue's of a
    draft burst (once a draft layer a step, once a step), and the
    synchronous verify steps (``step`` with ``want_greedy``)."""
    from dynamo_tpu_torch.ops import epilogue, paged_decode, paged_verify

    runner, draft = engine.runner, engine.scheduler.draft
    t_layers = runner.config.model.num_layers
    stats = dict(rounds=0, draft_bursts=0, sync_verifies=0, bad=[])

    def guarded(fn):
        def wrapped(*args, **kw):
            if not on_card:
                return fn(*args, **kw)
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return wrapped

    spec = runner.decode_burst_spec

    def round_(*args, **kw):
        v0 = paged_verify.launches
        out = guarded(spec)(*args, **kw)
        stats["rounds"] += 1
        if on_card and paged_verify.launches - v0 != t_layers:
            stats["bad"].append(("decode_burst_spec", paged_verify.launches - v0))
        return out

    runner.decode_burst_spec = round_
    runner.stage_to_host = guarded(runner.stage_to_host)
    step = runner.step

    def step_(*args, **kw):
        if kw.get("want_greedy"):
            stats["sync_verifies"] += 1
        return step(*args, **kw)

    runner.step = step_
    if draft is not None:
        d_layers = draft.config.model.num_layers
        k1 = draft.config.multi_step_decode
        burst = draft.decode_burst

        def burst_(*args, **kw):
            d0, e0 = paged_decode.launches, epilogue.launches
            out = guarded(burst)(*args, **kw)
            stats["draft_bursts"] += 1
            got = (paged_decode.launches - d0, epilogue.launches - e0)
            if on_card and got != (k1 * d_layers, k1):
                stats["bad"].append(("draft decode_burst", got))
            return out

        draft.decode_burst = burst_
        draft.live_rows = guarded(draft.live_rows)
    return stats


def _record_proposals(engine):
    """Wrap the synchronous draft round's proposer: per call, each row's
    history (prompt and emitted tokens, the pending one last) and its
    proposals."""
    sched = engine.scheduler
    propose = sched._draft_propose
    rounds = []

    async def recorded(loop, active, K):
        props = await propose(loop, active, K)
        for er in active:
            rounds.append((er.prompt, len(er.seq.token_ids) + 1 - len(er.prompt),
                           props[er.slot]))
        return props

    sched._draft_propose = recorded
    return rounds


def _rejections_at_near_ties(torch, runner, rounds, requests, results):
    """Every proposal of a self-draft that the verify rejected, at a
    near-tie: the round's history and the stream give the first rejected
    position; there the target's logits from one plain forward of the
    whole sequence have a top-2 gap under NEAR_TIE of their max |logit|.
    Returns the records and the counts of rounds and rejections."""
    streams = {tuple(p): r["tokens"] for (p, _), r in zip(requests, results)}
    records = []
    for prompt, n, props in rounds:
        toks = streams[tuple(prompt)]
        a = 0
        while a < len(props) and n + a < len(toks) and toks[n + a] == props[a]:
            a += 1
        if a == len(props) or n + a >= len(toks):
            continue   # all accepted, or the stream ended first
        lg = _last_logits(torch, runner, prompt + toks[: n + a])
        top2 = torch.topk(lg, 2)
        gap = float(top2.values[0] - top2.values[1])
        rel = gap / float(lg.abs().max())
        records.append(dict(position=n + a, proposed=props[a],
                            verified=toks[n + a], top2_gap=gap,
                            gap_over_max_abs_logit=rel))
        if not rel < NEAR_TIE:
            raise AssertionError(
                f"the self-draft's proposal {props[a]} was rejected for "
                f"{toks[n + a]} where the top-2 gap is {rel:.4g} of the max "
                f"|logit| (>= {NEAR_TIE})")
    return records


def _verify_s17(torch, runner, smi):
    """Kernel 4 at S 17 (K 16) on the 8B target's own cache after a wave:
    D 128, G 4, eight rows over blocks of that cache, held against the f32
    plain version on its first and last layer (each a one-layer view), and
    timed on the first (a CUDA graph's replay, as the kernels phase times
    it, and eager) beside the plain version and SDPA over the rows' K/V
    gathered to dense (the kernels phase's yardstick)."""
    from dynamo_tpu_torch.ops import paged_verify as pv

    F = torch.nn.functional

    k, v = runner.kv_cache
    L, N, BS, KVH, D = k.shape
    H, S, B = runner.config.model.num_heads, 17, 8
    g = torch.Generator(device=k.device).manual_seed(SEED + 17)
    ctx = torch.tensor([250, 300, 411, 600, 17, 33, 520, 128], dtype=torch.int32,
                       device=k.device)
    base = torch.clamp(ctx - S, min=0)
    nb = -(-int(ctx.max()) // BS)
    bt = torch.stack([torch.randperm(N, generator=g, device=k.device)[:nb]
                      for _ in range(B)]).int()
    q = torch.randn(B, S, H, D, generator=g, device=k.device).bfloat16()
    errs = {}
    for layer in (0, L - 1):
        kl, vl = k[layer: layer + 1], v[layer: layer + 1]
        errs[f"layer{layer}"] = _verify_check(
            torch, pv, f"8B S=17 layer {layer}", q, kl, vl, kl.float(),
            vl.float(), bt, base, ctx, 0)
    k0, v0 = k[:1], v[:1]
    ms = graph_ms(lambda: pv.paged_verify_attention(q, k0, v0, bt, base, ctx,
                                                    layer_idx=0))
    eager_ms = cuda_ms(lambda: pv.paged_verify_attention(
        q, k0, v0, bt, base, ctx, layer_idx=0))
    k0f, v0f = k0.float(), v0.float()
    plain = cuda_ms(lambda: pv.paged_verify_attention_ref(
        q.float(), k0f, v0f, bt, base, ctx, 0))
    T = int(ctx.max())
    kd = k[0][bt.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
    vd = v[0][bt.long()].reshape(B, -1, KVH, D)[:, :T].transpose(1, 2)
    kd = kd.repeat_interleave(H // KVH, dim=1).contiguous()
    vd = vd.repeat_interleave(H // KVH, dim=1).contiguous()
    qpos = base.long()[:, None, None] + torch.arange(S, device=k.device)[None, :, None]
    keys = torch.arange(T, device=k.device)[None, None, :]
    mask = ((keys <= qpos) & (keys < ctx.long()[:, None, None]))[:, None]
    qd = q.transpose(1, 2).contiguous()
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                             attn_mask=mask))
    flops = sum(4.0 * D * H * _visible(b + np.arange(c - b), c, 1 << 30).sum()
                for b, c in zip(base.tolist(), ctx.tolist()))
    kv_bytes = sum(min(c, b + S) * KVH * D * 2 * 2
                   for b, c in zip(base.tolist(), ctx.tolist()))
    bound, by = _bound_ms(flops, 2 * q.numel() * 2 + kv_bytes)
    return dict(shape=dict(B=B, S=S, H=H, KVH=KVH, D=D, ctx=ctx.tolist()),
                max_err=errs, ms=ms, eager_ms=eager_ms, plain_ms=plain,
                library_ms=lib_ms, bound_ms=bound, bound_by=by, card=smi)


def _wave_summary(res, wall, metrics, stats=None):
    ttfts = sorted(r["ttft_s"] for r in res)
    m = metrics
    out = dict(wall_s=wall, decode_wall_s=wall - ttfts[-1],
               ttft_s=dict(min=ttfts[0], max=ttfts[-1]),
               proposed=m.get("spec_proposed_tokens"),
               accepted=m.get("spec_accepted_tokens"),
               acceptance=(m["spec_accepted_tokens"] / m["spec_proposed_tokens"]
                           if m.get("spec_proposed_tokens") else None),
               decode_steps=m["decode_steps"], chain_len_max=m["chain_len_max"],
               sync_fallback=m["sync_fallback"])
    if stats is not None:
        rounds = stats["rounds"] + stats["sync_verifies"]
        out.update(rounds=stats["rounds"], sync_verifies=stats["sync_verifies"],
                   draft_bursts=stats["draft_bursts"],
                   decode_wall_s_per_round=(out["decode_wall_s"] / rounds
                                            if rounds else None))
    return out


def engine_spec_phase(torch, dev, smi):
    """The rest of speculation on the card (the module docstring's
    ``engine_spec``)."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="engine_spec_"))
    try:
        return _engine_spec(torch, dev, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _engine_spec(torch, dev, smi, tmp):
    from dynamo_tpu_torch.cli import run
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import (
        TorchServingEngine,
        engine_config_from_mdc,
    )
    from dynamo_tpu_torch.models import llama

    on_card = torch.device(dev).type == "cuda"
    rng = np.random.default_rng(SEED)
    _requests(rng)
    reqs = _spec_requests(rng)      # the engine phase's spec prompts
    target = ModelConfig.from_hf_config(LLAMA_8B_CUT)
    small = ModelConfig(**FLAGSHIP)

    # the draft: Llama-3.2-1B drawn on the card and written as a snapshot
    t0 = time.monotonic()
    draft_dir = tmp / "llama-3.2-1b-draft"
    draft_dir.mkdir()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    draft_params = llama.init_params(small, gen, torch.bfloat16, dev)
    snapshot_bytes = write_safetensors_snapshot(
        draft_dir, _llama_hf_tensors(draft_params, small.num_layers))
    (draft_dir / "config.json").write_text(json.dumps(_flagship_hf_config()))
    write_s = time.monotonic() - t0
    if ModelConfig.from_model_dir(str(draft_dir)) != small:
        raise AssertionError("the draft directory's config parses to another "
                             "model than Llama-3.2-1B")

    def config(model, **kw):
        return EngineConfig(model=model, seed=SEED, **dict(ENGINE, **kw))

    draft_kw = dict(spec_draft_model=str(draft_dir),
                    spec_draft_tokens=SPEC_DRAFT_K)

    async def serve(cfg, params=None, guard=False, record=False):
        t0 = time.monotonic()
        engine = await TorchServingEngine.create(cfg, params=params, device=dev)
        setup_s = time.monotonic() - t0
        stats = _guard_spec_rounds(torch, engine, on_card) if guard else None
        rounds = _record_proposals(engine) if record else None
        try:
            _reset_launches()
            t1 = time.monotonic()
            res = await _serve(engine, reqs[:SPEC_SELF_REQUESTS] if record
                               else reqs, SPEC_NEW_TOKENS)
            wall = time.monotonic() - t1
            launches = _read_launches()
            out = dict(res=res, wall=wall, setup_s=setup_s, launches=launches,
                       metrics=engine.metrics(), stats=stats, rounds=rounds,
                       params=engine.runner.params)
            out["summary"] = _wave_summary(res, wall, out["metrics"], stats)
            out["engine"] = engine
        except BaseException:
            await engine.close()
            raise
        return out

    async def close(leg):
        await leg.pop("engine").close()

    async def legs():
        out = {}
        # the plain synchronous engine (its params serve every 8B leg)
        base = await serve(config(target))
        params = base["params"]
        await close(base)
        out["base_sync"] = base
        # A: the synchronous draft engine
        a = await serve(config(target, **draft_kw), params, guard=True)
        a["parted"] = _spec_agreement(torch, a["engine"].runner, reqs,
                                      base["res"], a["res"])
        await close(a)
        out["A"] = a
        # the plain chained engine, then B: the chained draft engine
        base_c = await serve(config(target, **SPEC_CHAIN), params)
        await close(base_c)
        out["base_chain"] = base_c
        b = await serve(config(target, **SPEC_CHAIN, **draft_kw), params,
                        guard=True)
        b["parted"] = _spec_agreement(torch, b["engine"].runner, reqs,
                                      base_c["res"], b["res"])
        b["verify_s17"] = (_verify_s17(torch, b["engine"].runner, smi)
                           if on_card else None)
        await close(b)
        out["B"] = b
        # D: chained ngram speculation on the 8B
        d = await serve(config(target, **SPEC_CHAIN, **SPEC), params, guard=True)
        d["parted"] = _spec_agreement(torch, d["engine"].runner, reqs,
                                      base_c["res"], d["res"])
        await close(d)
        out["D"] = d
        for leg in out.values():
            leg.pop("params")
        del params
        gc.collect()
        # C: the 1B drafted by its own snapshot (the target holds the same
        # leaves the snapshot was written from)
        c = await serve(config(small, **draft_kw), draft_params, guard=True,
                        record=True)
        c["rejections"] = _rejections_at_near_ties(
            torch, c["engine"].runner, c["rounds"], reqs, c["res"])
        await close(c)
        c.pop("params")
        out["C"] = c
        return out

    out = asyncio.run(legs())
    del draft_params
    gc.collect()
    torch.cuda.empty_cache()

    # E: the CLI's engine builder with the draft flags
    target_dir = tmp / "llama-3.1-8b-random"
    target_dir.mkdir()
    (target_dir / "config.json").write_text(json.dumps(LLAMA_8B_CUT))
    extra = tmp / "extra.json"
    extra.write_text(json.dumps(dict(
        max_prefill_tokens_per_step=ENGINE["max_prefill_tokens_per_step"])))
    argv = ["--model-path", str(target_dir), "--allow-random-weights",
            "--extra-engine-args", str(extra),
            "--max-model-len", str(ENGINE["max_model_len"]),
            "--num-kv-blocks", str(ENGINE["num_kv_blocks"]),
            "--kv-block-size", str(ENGINE["kv_block_size"]),
            "--max-batch-size", str(ENGINE["max_batch_size"]),
            "--decode-pipeline-depth", "2", "--multi-step-decode", "4",
            "--spec-draft-model", str(draft_dir),
            "--spec-draft-tokens", str(SPEC_DRAFT_K)] + (
                [] if on_card else ["--device", "cpu"])

    async def cli_leg():
        flags = run.parse_flags(argv)
        mdc = run.load_mdc(flags)
        cfg = engine_config_from_mdc(mdc, flags)
        fields = {k: getattr(cfg, k) for k in (
            "spec_draft_model", "spec_draft_tokens", "decode_pipeline_depth",
            "multi_step_decode", "max_prefill_tokens_per_step")}
        want = dict(spec_draft_model=str(draft_dir), spec_draft_tokens=SPEC_DRAFT_K,
                    decode_pipeline_depth=2, multi_step_decode=4,
                    max_prefill_tokens_per_step=ENGINE["max_prefill_tokens_per_step"])
        if fields != want:
            raise AssertionError(f"the CLI's draft flags gave {fields}")
        t0 = time.monotonic()
        engine = await asyncio.wait_for(run.build_core_engine("torch", flags, mdc),
                                        SPEC_CLI_TIMEOUT_S)
        build_s = time.monotonic() - t0
        try:
            t1 = time.monotonic()
            res = await _serve(engine, reqs, SPEC_NEW_TOKENS)
            wall = time.monotonic() - t1
            parted = _spec_agreement(torch, engine.runner, reqs,
                                     out["B"]["res"], res)
            m = engine.metrics()
        finally:
            await engine.close()
        return dict(fields=fields, build_s=build_s, res=res, parted=parted,
                    summary=_wave_summary(res, wall, m))

    e = asyncio.run(cli_leg())
    gc.collect()
    torch.cuda.empty_cache()

    legs_out = dict(out, E=e)
    emit("engine_spec",
         target=f"Llama-3.1-8B at full width, {LLAMA_8B_LAYERS} of its 32 "
         "layers, seeded random bf16 weights", draft="Llama-3.2-1B from a written safetensors snapshot",
         config=ENGINE, spec_draft_tokens=SPEC_DRAFT_K, ngram=SPEC,
         chain=SPEC_CHAIN, requests=len(reqs), new_tokens=SPEC_NEW_TOKENS,
         snapshot_bytes=snapshot_bytes, snapshot_write_s=write_s,
         legs={name: dict(leg["summary"], setup_s=leg.get("setup_s"),
                          streams_equal=(None if "parted" not in leg else
                                         len(leg["res"]) - len(leg["parted"])),
                          parted=leg.get("parted"),
                          rejections=leg.get("rejections"),
                          launches=leg.get("launches"),
                          dispatches=({k: v for k, v in leg["stats"].items()}
                                      if leg.get("stats") else None))
               for name, leg in legs_out.items()},
         cli=dict(fields=e["fields"], build_s=e["build_s"]),
         verify_s17=out["B"]["verify_s17"], card=smi)

    # the checks, after the numbers are out
    for name, leg in legs_out.items():
        n = SPEC_SELF_REQUESTS if name == "C" else len(reqs)
        _check_streams(leg["res"], SPEC_NEW_TOKENS)
        if len(leg["res"]) != n:
            raise AssertionError(f"leg {name}: {len(leg['res'])} streams")
    for name in ("A", "B", "C", "D"):
        st = out[name]["stats"]
        if st["bad"]:
            raise AssertionError(f"leg {name}: a round launched the wrong "
                                 f"kernel counts: {st['bad'][:4]}")
    a, b, c, d = (out[k] for k in "ABCD")
    for name, leg in (("A", a), ("B", b), ("C", c)):
        if leg["metrics"]["spec_proposed_tokens"] <= 0:
            raise AssertionError(f"leg {name}: the draft proposed nothing")
    if a["stats"]["sync_verifies"] <= 0 or a["stats"]["draft_bursts"] <= 0:
        raise AssertionError(f"leg A ran no synchronous draft round: {a['stats']}")
    if b["stats"]["rounds"] <= 1 or b["metrics"]["chain_len_max"] <= 1:
        raise AssertionError(f"leg B: the chain never reached a second round: "
                             f"{b['stats']} {b['metrics']['chain_len_max']}")
    if b["stats"]["draft_bursts"] < b["stats"]["rounds"]:
        raise AssertionError("leg B: a chained round ran without its draft burst")
    if d["metrics"]["spec_proposed_tokens"] <= 0 or d["stats"]["rounds"] <= 1:
        raise AssertionError(f"leg D: chained ngram speculation proposed "
                             f"nothing or never chained: {d['summary']}")
    if on_card:
        _check_launches("draft chained", b["launches"],
                        ("paged_verify", "paged_decode", "epilogue"), layers=16)
        _check_launches("ngram chained", d["launches"], ("paged_verify",),
                        layers=LLAMA_8B_LAYERS)
        _check_launches("draft sync", a["launches"],
                        ("paged_verify", "paged_decode", "epilogue"), layers=16)
    return dict(paged_verify=b["launches"]["paged_verify"]
                + d["launches"]["paged_verify"],
                paged_decode=b["launches"]["paged_decode"],
                paged_flash=b["launches"]["paged_flash"],
                sampling_epilogue=(b["launches"]["epilogue"]
                                   - b["launches"]["epilogue_finish"]))


# --------------------------------------------------------- engine_recovery

# recovery and live migration: Llama-3.1-8B at full width (its depth cut,
# LLAMA_8B_LAYERS) behind a source and a peer in one process (one set of
# weight tensors, a cache of 1,024 blocks each), the CLI's rolling update on
# the 1B
RECOVERY_MODEL = LLAMA_8B_CUT             # a CPU rehearsal shrinks it
# no prefix cache: the baseline's and leg A's waves run on one source, and
# the near-tie checks use the peer's idle cache as scratch
RECOVERY_ENGINE = dict(ENGINE, enable_prefix_caching=False)
RECOVERY_CHAIN = dict(decode_pipeline_depth=2, multi_step_decode=4)
RECOVERY_NEW_TOKENS = 64
RECOVERY_LIVE = 8            # tokens every stream has when the drain fires
RECOVERY_SAMPLED = dict(temperature=0.8, top_p=0.95)
RECOVERY_SEEDS = {3: 2020, 5: 2121}       # wave 1's seeded rows, own seeds
RECOVERY_GRACE_S = 0.05
RECOVERY_STALL_S, RECOVERY_INTERVAL_S = 2.0, 0.1
RECOVERY_TIMEOUT_S = 300
RECOVERY_DEVICE = "cuda"                  # a CPU rehearsal sets "cpu"
RECOVERY_CLI_CHATS = (120, 300, 500, 800)  # words of leg C's streamed chats
RECOVERY_CLI_NEW = 160
RECOVERY_CLI_GRACE_S = 0.2
RECOVERY_CLI_EXTRA = dict(max_prefill_tokens_per_step=512)
RECOVERY_CLI_LIVE = 8        # chunks every chat has when /admin/drain is sent
# leg B's incident capture: the trip-to-capture delay, so the drain that
# follows the trip folds into the same bundle
RECOVERY_INCIDENT_SETTLE_S = 1.0


def _recovery_requests(rng):
    """Wave 1's eight prompts (100–1,500 tokens), 64 new tokens each: six
    greedy, two seeded sampled with seeds of their own."""
    wave1, _ = _requests(rng, RECOVERY_MODEL["vocab_size"])
    return [dict(prompt=p, samp=(dict(RECOVERY_SAMPLED, seed=RECOVERY_SEEDS[i])
                                 if i in RECOVERY_SEEDS
                                 else dict(temperature=0.0)),
                 stop=dict(max_tokens=RECOVERY_NEW_TOKENS, ignore_eos=True))
            for i, (p, _) in enumerate(wave1)]


def _recovery_start(engine, reqs):
    """Stream ``reqs`` from ``engine`` as token-level consumers reading the
    relay: per request its tokens, finish reason, each token chunk's
    arrival and how many chunks came before the ``migrated`` frame."""
    from dynamo_tpu_torch.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    records = [dict(tokens=[], finish=None, times=[], hop_at=None) for _ in reqs]

    async def one(r, rec):
        req = PreprocessedRequest(
            token_ids=r["prompt"], stop_conditions=StopConditions(**r["stop"]),
            sampling_options=SamplingOptions(**r["samp"]))
        async for out in engine.generate(Context(req)):
            if out.get("migrated"):
                rec["hop_at"] = len(rec["times"])
                continue
            if out["token_ids"]:
                rec["tokens"].extend(out["token_ids"])
                rec["times"].append(time.monotonic())
            rec["finish"] = out.get("finish_reason") or rec["finish"]

    tasks = [asyncio.ensure_future(one(r, rec)) for r, rec in zip(reqs, records)]
    return records, tasks


async def _recovery_until(cond, loops, timeout_s=RECOVERY_TIMEOUT_S):
    """Poll ``cond`` while every scheduler loop of ``loops`` lives: a loop
    that died (a check that raised inside a dispatch) ends the wait with its
    exception."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        for t in loops:
            if t is not None and t.done():
                raise RuntimeError("a scheduler loop ended mid-leg") \
                    from (t.exception() if not t.cancelled() else None)
        if time.monotonic() > deadline:
            raise TimeoutError(f"engine_recovery: no progress in {timeout_s} s")
        await asyncio.sleep(0.005)


def _hop_gap(rec):
    """A stream's gap across the hop: from its last token chunk before the
    ``migrated`` frame to its first one after (None without a hop)."""
    h = rec["hop_at"]
    if h is None or not 0 < h < len(rec["times"]):
        return None
    return rec["times"][h] - rec["times"][h - 1]


def _recovery_check_streams(torch, runner, reqs, base, records, leg,
                            sampled_exact):
    """Every stream has its length and finish; greedy ones equal the
    baseline or part at a near-tie (``_spec_agreement``); the seeded ones
    equal theirs bit for bit (``sampled_exact``) or part only after the
    hop. Returns the parted records."""
    res = [dict(tokens=r["tokens"], finish=r["finish"]) for r in records]
    _check_streams(res, RECOVERY_NEW_TOKENS, RECOVERY_MODEL["vocab_size"])
    greedy = [i for i, r in enumerate(reqs) if r["samp"]["temperature"] == 0.0]
    parted = _spec_agreement(torch, runner,
                             [(reqs[i]["prompt"], None) for i in greedy],
                             [base[i] for i in greedy], [res[i] for i in greedy])
    for p in parted:
        p["request"] = greedy[p["request"]]
    sampled = []
    for i in sorted(RECOVERY_SEEDS):
        a, b = base[i]["tokens"], res[i]["tokens"]
        if a == b:
            continue
        j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        # one token a chunk on the relay: the chunks before the hop are the
        # tokens the source emitted
        hop = records[i]["hop_at"] or 0
        sampled.append(dict(request=i, position=j, tokens_before_hop=hop))
        if sampled_exact or j < hop:
            raise AssertionError(f"leg {leg}: seeded stream {i} parts from its "
                                 f"baseline at {j} (the hop after {hop} tokens)")
    return parted, sampled


async def _recovery_leg_a(torch, src, peer, server, reqs, layers, on_card,
                          timers):
    """Leg A on ``src``: an admin drain (graceful seize, hot) into ``peer``
    once every stream has RECOVERY_LIVE tokens; the frames as shipped, the
    installed blocks, the source's cache after the drain, the peer's
    launches and its guarded dispatches."""
    from dynamo_tpu_torch.recovery import (
        RecoveryConfig,
        RecoveryController,
        migration,
    )

    ctl = RecoveryController(
        engine_id="source", scheduler=src.scheduler, runner=src.runner,
        peers=lambda: [dict(server.descriptor, engine_id="peer")],
        config=RecoveryConfig(drain_grace_s=RECOVERY_GRACE_S))
    shipped, ids_q = [], []
    gather_dev, to_host = src.runner.gather_blocks_device, src.runner.blocks_to_host
    # the stages' seconds: the source's host copies, the tcp sends and
    # receives, the peer's scatters (its sink's wrapper adds those)
    timers.update(to_host_s=0.0, send_s=0.0, recv_s=0.0, scatter_s=0.0)

    def gather(ids):
        ids_q.append(list(ids))
        return gather_dev(ids)

    def host(k, v):
        t0 = time.monotonic()
        hk, hv = to_host(k, v)
        timers["to_host_s"] += time.monotonic() - t0
        # a pageable copy: the pinned frame goes back to the host allocator
        shipped.append((ids_q.pop(0), hk.clone(), hv.clone()))
        return hk, hv

    tcp = migration.TcpBackend

    class TimedTcp(tcp):
        """The plane's tcp backend, its send and receive awaits timed."""

        @staticmethod
        async def send_blocks(*a, **kw):
            t0 = time.monotonic()
            try:
                return await tcp.send_blocks(*a, **kw)
            finally:
                timers["send_s"] += time.monotonic() - t0

        @staticmethod
        async def recv_blocks(*a, **kw):
            t0 = time.monotonic()
            try:
                return await tcp.recv_blocks(*a, **kw)
            finally:
                timers["recv_s"] += time.monotonic() - t0

    src.runner.gather_blocks_device = gather
    src.runner.blocks_to_host = host
    migration.TcpBackend = TimedTcp
    stats = _guard_dispatches(torch, peer.runner, layers, 1, on_card=on_card)
    records, tasks = _recovery_start(src, reqs)
    loops = [src.scheduler._task, peer.scheduler._task]
    try:
        await _recovery_until(lambda: min(len(r["tokens"]) for r in records)
                              >= RECOVERY_LIVE, loops)
        t0 = time.monotonic()
        summary = await ctl.drain(hard=False)
        drain_wall = time.monotonic() - t0
        _reset_launches()  # the peer's resumed decode, counted from here
        draining = src.metrics()["draining"]
        del src.runner.gather_blocks_device, src.runner.blocks_to_host
        # the source's cache after its seize, every dispatch done: the
        # frames it shipped must hold what its bursts wrote
        if on_card:
            torch.cuda.synchronize()
        regathered = [src.runner.gather_blocks(ids) for ids, _, _ in shipped]
        await _recovery_until(lambda: all(t.done() for t in tasks),
                              [peer.scheduler._task])
        for t in tasks:
            t.result()
        launches = _read_launches()
    finally:
        for t in tasks:
            t.cancel()
        migration.TcpBackend = tcp
        for name in ("gather_blocks_device", "blocks_to_host"):
            src.runner.__dict__.pop(name, None)
        # the peer's guard goes with the leg (the class's methods again)
        for name in ("decode_burst_chained", "decode_burst", "step",
                     "stage_to_host"):
            peer.runner.__dict__.pop(name, None)
        await ctl.close()
    same_src = all(_same_bytes(torch, hk, gk) and _same_bytes(torch, hv, gv)
                   for (_, hk, hv), (gk, gv) in zip(shipped, regathered))
    return dict(records=records, summary=summary, drain_wall_s=drain_wall,
                stage_s=dict(timers),
                registry=ctl.registry.render(), shipped=dict(ctl.shipped),
                frames_checked=len(shipped), source_bytes_equal=same_src,
                launches=launches, stats=stats, draining=draining,
                src_used=src.scheduler.allocator.used,
                peer_used=peer.scheduler.allocator.used)


def engine_recovery_phase(torch, dev, smi):
    """Recovery and live migration on the card (the module docstring's
    ``engine_recovery``)."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="engine_recovery_"))
    try:
        return _engine_recovery(torch, dev, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _engine_recovery(torch, dev, smi, tmp):
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.kv_router.indexer import OverlapScores
    from dynamo_tpu_torch.kv_router.protocols import ForwardPassMetrics
    from dynamo_tpu_torch.kv_router.scheduler import KvScheduler
    from dynamo_tpu_torch.recovery import MigrationServer, MigrationSink
    from dynamo_tpu_torch.utils import faults

    on_card = torch.device(dev).type == "cuda"
    layers = RECOVERY_MODEL["num_hidden_layers"]
    reqs = _recovery_requests(np.random.default_rng(SEED))
    model = ModelConfig.from_hf_config(RECOVERY_MODEL)

    def config(**kw):
        return EngineConfig(model=model, seed=SEED,
                            **dict(RECOVERY_ENGINE, **kw))

    def registry_count(text, mode, outcome="committed"):
        try:
            return _metric(text, "dynamo_recovery_migrations_total",
                           f'{{mode="{mode}",outcome="{outcome}"}}')
        except AssertionError:
            return 0.0

    async def legs():
        out = {}
        t0 = time.monotonic()
        # the source of the baseline and of leg A's synchronous drain draws
        # the weights; the peer and every later source share its tensors
        src = await TorchServingEngine.create(config(), device=dev)
        params = src.runner.params
        peer = await TorchServingEngine.create(config(), params=params, device=dev)
        out["setup_s"] = time.monotonic() - t0
        sink = MigrationSink(peer.scheduler, peer.runner)
        installed = []
        real_scatter = sink.scatter
        timers = {}

        async def scatter(mig_id, offset, k, v):
            # the blocks as the peer's cache holds them right after the
            # scatter, beside the bytes that arrived
            t0 = time.monotonic()
            await real_scatter(mig_id, offset, k, v)
            timers["scatter_s"] += time.monotonic() - t0
            ids = sink._pending[mig_id][1][offset:offset + k.shape[1]]
            gk, gv = peer.runner.gather_blocks(ids)
            installed.append(_same_bytes(torch, k, gk) and _same_bytes(torch, v, gv))

        sink.scatter = scatter
        server = await MigrationServer(sink).start()
        try:
            t1 = time.monotonic()
            base = await _serve_reqs(src, reqs)
            out["baseline_wall_s"] = time.monotonic() - t1
            # A, synchronous source
            a = await _recovery_leg_a(torch, src, peer, server, reqs, layers,
                                      on_card, timers)
            await src.close()
            a["parted"], a["sampled_parted"] = _recovery_check_streams(
                torch, peer.runner, reqs, base, a["records"], "A sync", True)
            a["installed"] = list(installed)
            installed.clear()
            out["A_sync"] = a
            # A, chained source: its graceful seize meets dispatched bursts
            src = await TorchServingEngine.create(config(**RECOVERY_CHAIN),
                                                  params=params, device=dev)
            a = await _recovery_leg_a(torch, src, peer, server, reqs, layers,
                                      on_card, timers)
            a["chain_len_max"] = src.metrics()["chain_len_max"]
            await src.close()
            a["parted"], a["sampled_parted"] = _recovery_check_streams(
                torch, peer.runner, reqs, base, a["records"], "A chained", True)
            a["installed"] = list(installed)
            out["A_chained"] = a
            # B: a wedge, the watchdog's trip, the hard seize, cold
            out["B"] = await _recovery_leg_b(torch, dev, config, params, peer,
                                             server, reqs, base, tmp, faults)
        finally:
            await server.close()
            await peer.close()
        return out

    out = asyncio.run(asyncio.wait_for(legs(), 3 * RECOVERY_TIMEOUT_S))
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    b = out["B"]
    sick = ForwardPassMetrics.from_wire(b["sick_metrics"])
    ks = KvScheduler(block_size=RECOVERY_ENGINE["kv_block_size"])
    ks.update_metrics("sick", sick)
    ks.update_metrics("peer", ForwardPassMetrics(
        request_total_slots=RECOVERY_ENGINE["max_batch_size"],
        kv_total_blocks=RECOVERY_ENGINE["num_kv_blocks"]))
    picks = [ks.schedule(64, OverlapScores()).worker_id for _ in range(16)]

    def leg_line(a):
        gaps = [_hop_gap(r) for r in a["records"]]
        return dict(summary=a["summary"], drain_wall_s=a["drain_wall_s"],
                    stage_s=a["stage_s"],
                    kv_bytes=a["shipped"]["bytes"], kv_frames=a["shipped"]["frames"],
                    hop_gap_s=gaps, hop_gap_max_s=max(g for g in gaps if g is not None)
                    if any(g is not None for g in gaps) else None,
                    installed_frames_byte_equal=sum(a["installed"]),
                    installed_frames=len(a["installed"]),
                    source_frames_equal_after_seize=a["source_bytes_equal"],
                    parted=a["parted"], sampled_parted=a["sampled_parted"],
                    peer_launches={k: a["launches"][k] for k in (
                        "paged_decode", "paged_flash", "epilogue")},
                    peer_dispatches={k: v for k, v in a["stats"].items()
                                     if k != "bad"},
                    chain_len_max=a.get("chain_len_max"))

    emit("engine_recovery",
         model=f"Llama-3.1-8B at full width, {RECOVERY_MODEL['num_hidden_layers']} "
         "of its 32 layers (its published config.json), seeded random bf16 "
         "weights; source and peer in one "
         "process over one set of weight tensors",
         config=RECOVERY_ENGINE, requests=len(reqs),
         new_tokens=RECOVERY_NEW_TOKENS, drain_at_tokens=RECOVERY_LIVE,
         setup_s=out["setup_s"], baseline_wall_s=out["baseline_wall_s"],
         leg_a_sync=leg_line(out["A_sync"]),
         leg_a_chained=leg_line(out["A_chained"]),
         leg_b=dict(trips=b["trips"], summary=b["summary"],
                    trip_to_drain_done_s=b["trip_to_done_s"],
                    artifact_requests=b["artifact_requests"],
                    hooks=b["hooks"], respawned=b["respawned"],
                    parted=b["parted"], sampled_parted=b["sampled_parted"],
                    hop_gap_s=[_hop_gap(r) for r in b["records"]],
                    peer_launches={k: b["launches"][k] for k in (
                        "paged_decode", "paged_flash", "epilogue")},
                    router_picks=sorted(set(picks)),
                    draining_during_drain=b["draining"],
                    incident=b["incident"]),
         card=smi)

    # the checks, after the numbers are out
    for name in ("A_sync", "A_chained"):
        a = out[name]
        s = a["summary"]
        if (s["migrated"], s["failed"]) != (len(reqs), 0):
            raise AssertionError(f"leg {name}: {s}")
        if registry_count(a["registry"], "hot") != len(reqs):
            raise AssertionError(f"leg {name}: not every migration was hot: "
                                 f"{a['registry']}")
        if not a["installed"] or not all(a["installed"]):
            raise AssertionError(f"leg {name}: installed KV differs from the "
                                 f"frames shipped ({a['installed']})")
        if not a["source_bytes_equal"]:
            raise AssertionError(f"leg {name}: a shipped frame differs from the "
                                 "source's cache after its seize (the gather "
                                 "read KV before a burst's write)")
        if a["src_used"] or a["peer_used"]:
            raise AssertionError(f"leg {name}: blocks left in use: source "
                                 f"{a['src_used']}, peer {a['peer_used']}")
        if a["stats"]["bad"] or a["stats"]["step"] <= 0:
            raise AssertionError(f"leg {name}: the peer's guarded decode: "
                                 f"{a['stats']}")
        if not a["draining"]:
            raise AssertionError(f"leg {name}: the source was not draining")
    if out["A_chained"]["chain_len_max"] <= 1:
        raise AssertionError("leg A chained: the source never chained a burst")
    s = b["summary"]
    if b["trips"] != ["decode_stall"]:
        raise AssertionError(f"leg B: trips {b['trips']}")
    inc = b["incident"]
    if (inc["captures"] != 1 or inc["reasons"] != ["decode_stall"]
            or inc["files"] != ["flight.json", "history.json", "manifest.json",
                                "traces.json"]
            or inc["listed"] != [inc["bundle"]]
            or not inc.get("history_series")):
        raise AssertionError(f"leg B: the wedge's incident bundle: {inc}")
    if (s["hard"], s["migrated"], s["failed"], s["respawned"]) != (
            True, len(reqs), 0, True):
        raise AssertionError(f"leg B: {s}")
    if registry_count(b["registry"], "cold") != len(reqs):
        raise AssertionError(f"leg B: not every migration was cold: "
                             f"{b['registry']}")
    if b["hooks"] != ["deregister", "register"] or not b["respawned"]:
        raise AssertionError(f"leg B: hooks {b['hooks']}, respawned "
                             f"{b['respawned']}")
    if b["artifact_requests"] != len(reqs):
        raise AssertionError(f"leg B: the flight artifact holds "
                             f"{b['artifact_requests']} requests")
    if not b["draining"] or not sick.draining or picks != ["peer"] * len(picks):
        raise AssertionError(f"leg B: the sick worker was routed to: {picks}")
    if b["src_used"] or b["peer_used"]:
        raise AssertionError(f"leg B: blocks left in use: source "
                             f"{b['src_used']}, peer {b['peer_used']}")
    # C: the CLI's rolling update (its own line)
    emit("engine_recovery", leg="C", **_recovery_leg_c(torch, dev, tmp),
         card=smi)
    launches = {k: out["A_sync"]["launches"][k] + out["A_chained"]["launches"][k]
                + b["launches"][k] for k in out["A_sync"]["launches"]}
    if on_card:
        for name in ("A_sync", "A_chained"):
            _check_launches(f"recovery {name} peer", out[name]["launches"],
                            ("paged_decode", "epilogue"), layers=layers)
        _check_launches("recovery B peer", b["launches"],
                        ("paged_decode", "paged_flash", "epilogue"),
                        layers=layers)
    return dict(paged_decode=launches["paged_decode"],
                paged_flash=launches["paged_flash"],
                sampling_epilogue=launches["epilogue"] - launches["epilogue_finish"])


async def _recovery_leg_b(torch, dev, config, params, peer, server, reqs, base,
                          tmp, faults):
    """Leg B: a source whose stall watchdog samples every 0.1 s with a 2 s
    deadline; ``decode_burst_hang`` wedges its next decode sync; the trip
    drives the controller's ladder: the hard seize, cold migration into the
    peer, the injected respawner between the deregister and register
    hooks."""
    from dynamo_tpu_torch.engine.serving import TorchServingEngine
    from dynamo_tpu_torch.http.service import HttpService, ModelManager
    from dynamo_tpu_torch.recovery import RecoveryConfig, RecoveryController
    from dynamo_tpu_torch.telemetry.flight import FLIGHT_DIR_ENV
    from dynamo_tpu_torch.telemetry.history import (
        LocalHistorySampler,
        MetricHistory,
    )
    from dynamo_tpu_torch.telemetry.incidents import (
        IncidentConfig,
        IncidentRecorder,
        load_bundle_dir,
    )

    flight_dir = tmp / "flight"
    prev_dir = os.environ.get(FLIGHT_DIR_ENV)
    os.environ[FLIGHT_DIR_ENV] = str(flight_dir)
    src = await TorchServingEngine.create(
        config(watchdog_stall_s=RECOVERY_STALL_S,
               watchdog_interval_s=RECOVERY_INTERVAL_S),
        params=params, device=dev)
    src.watchdog.name = "source"
    hooks, respawned = [], []

    async def respawner():
        respawned.append(time.monotonic())

    draining = []

    async def deregister():
        # after the gate: the snapshot a router scrapes says draining
        hooks.append("deregister")
        draining.append(src.metrics()["draining"])

    async def register():
        hooks.append("register")

    ctl = RecoveryController(
        engine_id="source", scheduler=src.scheduler, runner=src.runner,
        watchdog=src.watchdog, respawner=respawner, deregister=deregister,
        register=register,
        peers=lambda: [dict(server.descriptor, engine_id="peer")],
        config=RecoveryConfig(drain_grace_s=RECOVERY_GRACE_S,
                              respawn_backoff_s=0.1)).attach()
    # the peer's launches from the ladder's start: the wedged source
    # launches nothing from there
    ctl.add_drain_listener(lambda info: _reset_launches())
    # the incident recorder as the CLI's --incident-dir wires it: the
    # watchdog's trip and the ladder's drain fold into one bundle, which
    # carries the source's metric history; a front lists it
    incidents = IncidentRecorder(
        IncidentConfig(out_dir=str(tmp / "incidents"),
                       settle_s=RECOVERY_INCIDENT_SETTLE_S),
        history=MetricHistory(window_s=600.0))
    incidents.watch_watchdog(src.watchdog)
    incidents.watch_recovery(ctl)
    sampler = LocalHistorySampler(src.scheduler.registry,
                                  history=incidents.history,
                                  interval_s=0.1).start()
    front = await HttpService(ModelManager(), "127.0.0.1", 0,
                              incidents=incidents).start()
    records, tasks = _recovery_start(src, reqs)
    try:
        await _recovery_until(lambda: min(len(r["tokens"]) for r in records)
                              >= RECOVERY_LIVE, [src.scheduler._task])
        faults.arm("decode_burst_hang", "once")
        await _recovery_until(lambda: bool(ctl.recoveries),
                              [peer.scheduler._task])
        trip_t = src.watchdog.trips[0]["time"]
        done_t = time.time()
        await _recovery_until(lambda: all(t.done() for t in tasks),
                              [peer.scheduler._task])
        for t in tasks:
            t.result()
        launches = _read_launches()
        await _recovery_until(lambda: bool(incidents.captures),
                              [peer.scheduler._task])
        await asyncio.sleep(RECOVERY_INCIDENT_SETTLE_S)  # a second would land
        _, _, listed, _ = await http_request(front.port, "GET",
                                             "/debug/incidents")
        bundles = list(incidents.bundles)
        incident = dict(
            captures=incidents.captures, suppressed=incidents.suppressed,
            reasons=[b["reason"] for b in bundles],
            files=sorted(os.listdir(bundles[0]["path"])) if bundles else [],
            listed=[b["bundle"] for b in json.loads(listed)["bundles"]],
            bundle=bundles[0]["bundle"] if bundles else None)
        if bundles:
            loaded = load_bundle_dir(bundles[0]["path"])
            incident["flight_events"] = len(loaded["flight"]["events"])
            incident["history_series"] = len(loaded["history"]["series"])
            incident["traces"] = len(loaded["traces"])
        art = json.loads(Path(src.watchdog.trips[0]["artifact"]).read_text())
        (table,) = [x["requests"] for x in art["sources"]
                    if x["name"] == "source"]
        out = dict(records=records, trips=[t["reason"] for t in src.watchdog.trips],
                   summary=ctl.recoveries[0], trip_to_done_s=done_t - trip_t,
                   artifact_requests=len(table), hooks=list(hooks),
                   respawned=bool(respawned), launches=launches,
                   registry=ctl.registry.render(),
                   draining=draining == [True],
                   sick_metrics=src.metrics(), incident=incident)
    finally:
        faults.release()
        for t in tasks:
            t.cancel()
        await sampler.stop()
        await incidents.stop()
        await front.stop()
        await ctl.close()
        await src.close()
        if prev_dir is None:
            os.environ.pop(FLIGHT_DIR_ENV, None)
        else:
            os.environ[FLIGHT_DIR_ENV] = prev_dir
    out["src_used"] = src.scheduler.allocator.used
    out["peer_used"] = peer.scheduler.allocator.used
    out["parted"], out["sampled_parted"] = _recovery_check_streams(
        torch, peer.runner, reqs, base, records, "B", False)
    return out


def _recovery_leg_c(torch, dev, tmp):
    """Leg C, the CLI's rolling update on Llama-3.2-1B (``engine_http``'s
    model directory): B receives migrations (``--migrate-port``), A names B
    (``--migrate-peers``, ``--drain-grace-s 0.2``, ``--flight-dir``); four
    streamed greedy chats on A, then ``POST /admin/drain`` on A. The reply
    says 4 migrated and none failed; every stream runs to ``[DONE]`` with no
    error and B's undisturbed text (or parts at a near-tie of an in-process
    engine's logits); a new request to A gets 503 with Retry-After; A's
    /metrics counts 4 committed hot migrations; A's flight artifact
    (SIGUSR2) holds a handoff for each stream, every one before the streams
    ended (the re-bind freed A's relays); both exit 0 on SIGINT."""
    import signal

    from dynamo_tpu_torch.llm.tokenizer import HFTokenizer

    model_dir = write_model_dir(tmp / "llama-3.2-1b-random")
    extra = tmp / "recovery_extra.json"
    extra.write_text(json.dumps(RECOVERY_CLI_EXTRA))
    tok = HFTokenizer.from_pretrained_dir(model_dir)
    words = _word_ids(tok)
    rng = np.random.default_rng(SEED + 2)

    def words_text(n):
        return tok.decode([words[int(i)] for i in rng.integers(0, len(words), n)])

    flight_dir = tmp / "flight_cli"
    mig_b = _free_port()
    common = ["dynamo_tpu_torch.cli.run", "in=http", "out=torch",
              "--model-path", model_dir, "--model-name", "llama",
              "--allow-random-weights", "--extra-engine-args", str(extra),
              "--max-model-len", "2048", "--num-kv-blocks", "1024",
              "--kv-block-size", "16", "--http-host", "127.0.0.1",
              "--http-port", "0", "--self-heal", "--advertise-host",
              "127.0.0.1"] + (["--device", "cpu"] if RECOVERY_DEVICE == "cpu"
                              else [])
    t0 = time.monotonic()
    procs = {
        "B": _spawn_role(common + ["--migrate-port", str(mig_b)], "cli_b", tmp),
        "A": _spawn_role(common + ["--migrate-peers", f"127.0.0.1:{mig_b}",
                                   "--drain-grace-s", str(RECOVERY_CLI_GRACE_S),
                                   "--flight-dir", str(flight_dir)], "cli_a", tmp),
    }
    try:
        deadline = time.monotonic() + HTTP_CLI_TIMEOUT_S
        ports = {n: int(_await_line(p, "listening on", deadline).strip()
                        .rsplit(":", 1)[1]) for n, p in procs.items()}
        startup_s = time.monotonic() - t0
        bodies = [dict(_graph_chat("llama", words_text(n)),
                       max_tokens=RECOVERY_CLI_NEW) for n in RECOVERY_CLI_CHATS]

        async def traffic():
            seen = [0] * len(bodies)
            ends = [None] * len(bodies)

            def counter(i):
                def on_event(t, payload):
                    seen[i] += 1
                    if payload is None:
                        ends[i] = time.time()
                return on_event

            streams = [asyncio.ensure_future(http_request(
                ports["A"], "POST", "/v1/chat/completions", b,
                headers={"X-Request-Id": f"recovery-c-{i}"},
                on_event=counter(i))) for i, b in enumerate(bodies)]
            while min(seen) < RECOVERY_CLI_LIVE:
                if any(s.done() for s in streams):
                    raise AssertionError("leg C: a stream ended before the drain")
                await asyncio.sleep(0.005)
            t_drain = time.monotonic()
            drain = await http_request(ports["A"], "POST", "/admin/drain")
            drain_s = time.monotonic() - t_drain
            answers = await asyncio.gather(*streams)
            # each re-bound stream's trace on A: the peer's spans arrive
            # with mig_end on the direct connection
            traces = [json.loads((await http_request(
                ports["A"], "GET", f"/debug/requests/recovery-c-{i}"))[2])
                for i in range(len(bodies))]
            refused = await http_request(ports["A"], "POST",
                                         "/v1/chat/completions",
                                         dict(bodies[0], stream=False))
            metrics = (await http_request(ports["A"], "GET", "/metrics"))[2]
            direct = await asyncio.gather(*(
                http_request(ports["B"], "POST", "/v1/chat/completions", b)
                for b in bodies))
            return (drain, drain_s, answers, ends, refused, metrics.decode(),
                    direct, traces)

        (drain, drain_s, answers, ends, refused, metrics, direct,
         traces) = asyncio.run(asyncio.wait_for(traffic(), RECOVERY_TIMEOUT_S))
        # A's flight ring, through SIGUSR2 into --flight-dir
        procs["A"].send_signal(signal.SIGUSR2)
        t_sig = time.monotonic()
        while not list(flight_dir.glob("*-sigusr2.json")):
            if time.monotonic() - t_sig > 60:
                raise AssertionError("leg C: A wrote no SIGUSR2 artifact")
            time.sleep(0.05)
        art = None
        while art is None and time.monotonic() - t_sig < 60:
            try:
                art = json.loads(next(flight_dir.glob("*-sigusr2.json")).read_text())
            except ValueError:
                time.sleep(0.05)
        # each stream's relay end on A (its trace id is the X-Request-Id)
        handoffs = {e.get("trace_id"): e["wall"] for e in art["events"]
                    if e["kind"] == "recovery.migrate_handoff"}
        exits = {}
        for n, p in procs.items():
            p.send_signal(signal.SIGINT)
            exits[n] = p.wait(timeout=60)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for ans in answers:
        if ans[0] != 200:
            raise AssertionError(f"leg C: a stream answered {ans[0]}: {ans[2][:300]}")
        rec = _stream_record(ans[3], True)
        ann = next(line for line in ans[2].decode().split("\n")
                   if line.startswith(": "))
        rec["prompt_ids"] = json.loads(ann[2:])
        recs.append(rec)
    direct_recs = [_stream_record(d[3], True) for d in direct]
    errors = [c for _, c in sum((a[3] for a in answers), [])
              if c is not None and "error" in c]
    summary = json.loads(drain[2]) if drain[0] == 200 else drain[2][:300]
    hot = _metric(metrics, "dynamo_recovery_migrations_total",
                  '{mode="hot",outcome="committed"}')
    parted = []
    for i, (r, d) in enumerate(zip(recs, direct_recs)):
        if r["tokens"] != d["tokens"]:
            parted.append(dict(request=i, first_token_diff=next(
                j for j, (x, y) in enumerate(zip(r["tokens"], d["tokens"]))
                if x != y)))
    out = dict(startup_s=startup_s, drain_status=drain[0], drain=summary,
               drain_http_s=drain_s, streams_done=[a[3][-1][1] is None
                                                   for a in answers],
               stream_tokens=[len(r["tokens"]) for r in recs],
               ttft_s=[r["ttft_s"] for r in recs],
               itl_max_s=[r["itl_max_s"] for r in recs],
               refused=(refused[0], refused[1].get("retry-after")),
               hot_committed=hot, handoffs=len(handoffs),
               handoff_before_stream_end_s=[
                   (ends[i] - handoffs[f"recovery-c-{i}"])
                   if f"recovery-c-{i}" in handoffs and ends[i] else None
                   for i in range(len(bodies))],
               parted=parted, exits=exits,
               peer_spans=[_peer_span_set(t) for t in traces])
    if not all(p and "migration.resume" in p["marks"]
               and abs(p["offset_s"]) <= p["rtt_s"] / 2 + 1e-3
               for p in out["peer_spans"]):
        raise AssertionError(f"leg C: a migrated stream's trace lacks the "
                             f"peer's spans or their offset bound: "
                             f"{out['peer_spans']}")
    if drain[0] != 200 or (summary["migrated"], summary["failed"]) != (4, 0):
        raise AssertionError(f"leg C: /admin/drain answered {drain[0]}: {summary}")
    if errors or not all(out["streams_done"]):
        raise AssertionError(f"leg C: a stream carried an error or no [DONE]: "
                             f"{errors[:2]}")
    if any(n != RECOVERY_CLI_NEW for n in out["stream_tokens"]):
        raise AssertionError(f"leg C: stream lengths {out['stream_tokens']}")
    if out["refused"] != (503, "1"):
        raise AssertionError(f"leg C: a request after the drain: {refused[:2]}")
    if hot != 4.0:
        raise AssertionError(f"leg C: hot committed migrations {hot}")
    if not all(d is not None and d > 0 for d in out["handoff_before_stream_end_s"]):
        raise AssertionError(f"leg C: a relay did not end before its stream: "
                             f"handoffs {handoffs}, stream ends {ends}")
    if any(rc != 0 for rc in exits.values()):
        raise AssertionError(f"leg C: exits {exits}")
    if parted:
        out["parted"] = _recovery_cli_near_ties(torch, dev, tok, model_dir,
                                                extra, bodies, recs, direct_recs,
                                                parted)
    return out


def _peer_span_set(trace):
    """The migration peer's span set in a completed trace (searched through
    nested hops), or None."""
    stack = list(trace.get("remote") or [])
    while stack:
        rs = stack.pop()
        if rs.get("source") == "migration_peer":
            return dict(offset_s=rs.get("offset_s", 0.0),
                        rtt_s=rs.get("rtt_s", 0.0),
                        marks=[n for n, _ in rs.get("spans") or []])
        stack.extend(rs.get("children") or [])
    return None


def _recovery_cli_near_ties(torch, dev, tok, model_dir, extra, bodies, recs,
                            direct, parted):
    """A leg C stream that parts from B's undisturbed reply must part at a
    near-tie of the same weights' logits (an in-process engine built from
    the CLI's flags: the same seeded draw)."""
    from dynamo_tpu_torch.cli import run

    flags = run.parse_flags(
        ["--model-path", model_dir, "--model-name", "llama",
         "--allow-random-weights", "--extra-engine-args", str(extra),
         "--max-model-len", "2048", "--num-kv-blocks", "1024",
         "--kv-block-size", "16"] + (["--device", "cpu"]
                                     if RECOVERY_DEVICE == "cpu" else []))

    async def check():
        core = await run.build_core_engine("torch", flags, run.load_mdc(flags))
        try:
            reqs = [(recs[p["request"]]["prompt_ids"], None) for p in parted]
            return _spec_agreement(
                torch, core.runner, reqs,
                [dict(tokens=[tok.token_to_id(t) for t in direct[p["request"]]["tokens"]])
                 for p in parted],
                [dict(tokens=[tok.token_to_id(t) for t in recs[p["request"]]["tokens"]])
                 for p in parted])
        finally:
            await core.close()

    return asyncio.run(check())


# ------------------------------------------------------------ engine_phi3

# the SentencePiece vocabulary written beside the Phi-3 snapshot: Llama-2 /
# Phi-3's 32,000 pieces (the published model holds 32,064 embedding rows;
# ids from 32,000 have no piece)
PHI3_SPM_PIECES = 32000
SPM_MAX_CHARS = 12     # the longest synthetic merge, in characters
# the engine: 8,192 positions (two long prompts and six short ones fit one
# wave), blocks for its prompts and a prefix-hit wave
PHI3_ENGINE = dict(max_model_len=8192, num_kv_blocks=1536)
PHI3_NEW_TOKENS = 16
PHI3_LAYERS = 16          # of Phi-3-mini's 32 (a depth cut; widths kept)
PHI3_LONG_PROMPT = 5120   # past original 4,096 from its first token
PHI3_CROSSING = 4090      # crosses 4,096 while it decodes
PHI3_ORIGINAL_CUT = 64    # the logits check's original window (widths kept)
PHI3_NORM_SCALE = 0.1     # norms drawn 1 + N(0, 0.1^2)
# the CLI's flags and engine args (a CPU rehearsal appends "--device",
# "cpu" and an f32 dtype)
PHI3_CLI_FLAGS = ["--max-model-len", "8192", "--num-kv-blocks", "512",
                  "--kv-block-size", "16"]
PHI3_CLI_EXTRA = dict(max_prefill_tokens_per_step=ENGINE["max_prefill_tokens_per_step"])
PHI3_CLI_WORDS = 200      # the CLI request's prompt: words of the vocabulary
PHI3_CLI_TEXT_TAIL = " café, naïve 日本語 ✓ 😀\n\tend"  # byte fallback


def synthetic_spm_pieces(n=PHI3_SPM_PIECES, seed=SEED):
    """A SentencePiece BPE vocabulary in Llama-2 / Phi-3's layout, as
    (piece, score, type) triples: ``<unk>`` (UNKNOWN 2), ``<s>`` and
    ``</s>`` (CONTROL 3), the 256 byte pieces ``<0x00>``..``<0xFF>`` (BYTE
    6), then NORMAL (1) pieces: ▁ and the printable ASCII characters, then
    merges drawn from ``seed``, each the concatenation of two earlier
    NORMAL pieces of at most ``SPM_MAX_CHARS`` characters (words grow by a
    letter after ▁ or a letter, so text of such words encodes as a piece
    a word), scored by rank (SentencePiece BPE's merge order)."""
    rng = np.random.default_rng(seed)
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    normal = ["▁"] + [chr(c) for c in range(33, 127)]
    letters = [c for c in normal if c.isalpha()]
    words = ["▁"] + letters
    seen = set(normal)
    while len(pieces) + len(normal) < n:
        for word, u, v in rng.random((4096, 3)):
            if word < 0.6:
                t = words[int(u * len(words))] + letters[int(v * len(letters))]
            else:
                t = normal[int(u * len(normal))] + normal[int(v * len(normal))]
            if len(t) > SPM_MAX_CHARS or t in seen or t.isdigit():
                continue
            seen.add(t)
            normal.append(t)
            if word < 0.6:
                words.append(t)
            if len(pieces) + len(normal) == n:
                break
    return pieces + [(t, -float(i), 1) for i, t in enumerate(normal)]


def spm_model_bytes(pieces, model_type=2, unk_id=0) -> bytes:
    """A SentencePiece ``ModelProto`` in protobuf's wire format, written
    here without a protobuf package: ``pieces`` (field 1: ``piece`` 1,
    ``score`` 2 as fixed32, ``type`` 3), ``trainer_spec`` (field 2:
    ``model_type`` 3, ``unk_id`` 40) and a ``normalizer_spec`` (field 3:
    ``name`` 1, ``add_dummy_prefix`` 3, ``remove_extra_whitespaces`` 4), as
    a Llama-2 / Phi-3 ``tokenizer.model`` carries."""
    import struct

    def varint(x):
        x &= (1 << 64) - 1
        out = bytearray()
        while True:
            out.append((x & 0x7F) | (0x80 if x > 0x7F else 0))
            x >>= 7
            if not out[-1] & 0x80:
                return bytes(out)

    def field(num, wire, payload):
        if wire == 2:
            payload = varint(len(payload)) + payload
        return varint(num << 3 | wire) + payload

    out = bytearray()
    for piece, score, kind in pieces:
        out += field(1, 2, field(1, 2, piece.encode())
                     + field(2, 5, struct.pack("<f", score))
                     + field(3, 0, varint(kind)))
    out += field(2, 2, field(3, 0, varint(model_type))
                 + field(40, 0, varint(unk_id)))
    out += field(3, 2, field(1, 2, b"identity") + field(3, 0, varint(1))
                 + field(4, 0, varint(0)))
    return bytes(out)


def _phi3_hf_tensors(torch, params, layers):
    """(HF name, the tensor on the card in HF's [out, in] layout) of a
    Phi-3 checkpoint: the fused ``qkv_proj`` (q, k, v rows) and
    ``gate_up_proj`` (gate, up rows), as Phi-3 stores them."""
    lay = params["layers"]
    out = [("model.embed_tokens.weight", params["embed"]),
           ("model.norm.weight", params["final_norm"]),
           ("lm_head.weight", params["lm_head"].T)]
    for i in range(layers):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", lay["ln1"][i]),
                (p + "post_attention_layernorm.weight", lay["ln2"][i]),
                (p + "self_attn.qkv_proj.weight",
                 torch.cat([lay[k][i].T for k in ("wq", "wk", "wv")])),
                (p + "self_attn.o_proj.weight", lay["wo"][i].T),
                (p + "mlp.gate_up_proj.weight",
                 torch.cat([lay["w_gate"][i].T, lay["w_up"][i].T])),
                (p + "mlp.down_proj.weight", lay["w_down"][i].T)]
    return out


def _phi3_cli_text(pieces):
    """The CLI request's prompt: ``PHI3_CLI_WORDS`` words of the
    vocabulary's ▁-led pieces, then ``PHI3_CLI_TEXT_TAIL`` (characters no
    piece holds: they encode through the byte pieces)."""
    rng = np.random.default_rng(SEED + 51)
    words = [p[1:] for p, _, kind in pieces
             if kind == 1 and p.startswith("▁") and len(p) > 1
             and "▁" not in p[1:]]
    picks = rng.integers(0, len(words), PHI3_CLI_WORDS)
    return " ".join(words[i] for i in picks) + PHI3_CLI_TEXT_TAIL


def engine_phi3_phase(torch, dev, smi):
    """Phi-3-mini-128k-instruct at full width and all 32 layers
    (``PHI3_MINI_128K``: longrope, head_dim 96, G 1, a window past every
    context) from files, on the card:

    1. weights drawn on the card from the seed (norms 1 + N(0, 0.1^2)),
       written as a 4-shard safetensors snapshot under Phi-3's own names
       (fused ``qkv_proj`` and ``gate_up_proj``) beside a SentencePiece
       ``tokenizer.model`` only (``synthetic_spm_pieces`` through
       ``spm_model_bytes``; no ``tokenizer.json``), loaded by the port's
       loader (every leaf equal to the drawn one);
    2. the main path over the loaded leaves (fused epilogue, single-token
       decode): wave 1 (six of ``_requests``' prompts with their twins,
       beside one of ``PHI3_LONG_PROMPT`` tokens, long from its first
       token, and one of ``PHI3_CROSSING`` that crosses 4,096 while it
       decodes) and the prefix-hit wave 2, launches counted from 0 just
       before and read just after; a profiled decode step at contexts up to
       4,097; the spec prompts' streams without speculation; the logits of
       a batched prefill step and a decode step at full width and 2 layers
       against the CPU in f32, ``original_max_position_embeddings`` cut to
       ``PHI3_ORIGINAL_CUT`` so short and long rows share a batch (the one
       cut; widths kept);
    3. ``multi_step_decode=4`` and the chained loop (``CHAIN``, every
       dispatch under the sync guard): wave 1 must stream identically;
    4. ngram speculation (``SPEC``): equal, or parted at a printed
       near-tie;
    5. an fp8 (e4m3) KV engine with ngram speculation: wave 1 and the spec
       prompts through the fp8 forms (no bf16 form launches), its last
       logits of a prompt within ``FP8_LOGITS_REL_L2`` of the bf16 main
       engine's;
    6. an ``sp_size`` 2 engine on this config refused by name (the window);
    7. one text request through the CLI's HTTP front over the snapshot
       (``in=http out=torch``, its tokenizer the SentencePiece reader): its
       stream equals the in-process engine's on the reader's ids (or parts
       at a near-tie), and its text is the reader's decode of its ids.

    The numbers are printed before the checks run: the device's peak
    memory, the KV bytes a token, the load's GB/s, the decode step's
    D-96 decode kernel share."""
    import dataclasses
    import tempfile

    from dynamo_tpu_torch.cli import run
    from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
    from dynamo_tpu_torch.engine.model_runner import ModelRunner
    from dynamo_tpu_torch.engine.serving import (
        TorchServingEngine,
        engine_config_from_mdc,
    )
    from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
    from dynamo_tpu_torch.models import llama

    on_card = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    hf = dict(PHI3_MINI_128K, num_hidden_layers=PHI3_LAYERS)
    mcfg = ModelConfig.from_hf_config(hf)
    layers, vocab = mcfg.num_layers, mcfg.vocab_size
    kv_bytes_token = layers * 2 * mcfg.num_kv_heads * mcfg.head_dim * 2
    with tempfile.TemporaryDirectory() as tmp:
        snap = Path(tmp) / "phi-3-mini-128k-random"
        snap.mkdir()
        (snap / "config.json").write_text(json.dumps(hf, indent=1))
        pieces = synthetic_spm_pieces()
        (snap / "tokenizer.model").write_bytes(spm_model_bytes(pieces))
        flags = run.parse_flags(["--model-path", str(snap),
                                 "--max-model-len",
                                 str(PHI3_ENGINE["max_model_len"]),
                                 "--num-kv-blocks",
                                 str(PHI3_ENGINE["num_kv_blocks"])])
        mdc = run.load_mdc(flags)
        cfg = dataclasses.replace(
            engine_config_from_mdc(mdc, flags, extra=dict(
                max_prefill_tokens_per_step=ENGINE["max_prefill_tokens_per_step"],
                dtype=ENGINE["dtype"])), seed=SEED)
        tok = HFTokenizer.from_pretrained_dir(str(snap))

        # ---- 1. draw, write, load
        gen = torch.Generator(device=dev).manual_seed(SEED)
        drawn = llama.init_params(mcfg, gen, torch.bfloat16, dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 52)
        for t in (drawn["layers"]["ln1"], drawn["layers"]["ln2"],
                  drawn["final_norm"]):
            t.copy_(1 + torch.randn(t.shape, generator=g, device=dev)
                    * PHI3_NORM_SCALE)
        n_params = sum(t.numel() for grp in drawn.values()
                       for t in (grp.values() if isinstance(grp, dict) else [grp]))
        param_bytes = _tree_bytes(drawn)
        sync()
        t0 = time.monotonic()
        written = write_safetensors_snapshot(
            snap, _phi3_hf_tensors(torch, drawn, layers))
        write_s = time.monotonic() - t0
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        sync()
        t0 = time.monotonic()
        runner = ModelRunner(cfg, device=dev, model_dir=str(snap))
        sync()
        load_s = time.monotonic() - t0
        loaded = runner.params

        def flat(p):
            return dict(p["layers"], **{k: v for k, v in p.items()
                                        if k != "layers"})
        unequal = sorted(k for k, v in flat(drawn).items()
                         if k not in flat(loaded) or not torch.equal(
                             v.float(), flat(loaded)[k].float()))
        del drawn
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # ---- 2.-5. the engines over the loaded leaves
        rng = np.random.default_rng(SEED)
        base1, wave2 = _requests(rng, vocab)
        long_prompt = [int(t) for t in rng.integers(0, vocab, PHI3_LONG_PROMPT)]
        crossing = [int(t) for t in rng.integers(0, vocab, PHI3_CROSSING)]
        greedy = dict(temperature=0.0)
        wave1 = base1[:6] + [(long_prompt, greedy), (crossing, greedy)]
        spec_reqs = _spec_requests(rng, vocab)
        cli_text = _phi3_cli_text(pieces)
        cli_ids = tok.encode(cli_text)

        async def serve(kw, batches, count=False, guarded=False, main=False):
            gc.collect()
            engine = await TorchServingEngine.create(
                dataclasses.replace(cfg, **kw), params=loaded, device=dev)
            stats = (_guard_dispatches(torch, engine.runner, layers, 4,
                                       on_card) if guarded else None)
            out = dict(res=[], walls=[])
            try:
                if count:
                    _reset_launches()
                for batch, new_tokens in batches:
                    t0 = time.monotonic()
                    out["res"].append(await _serve(engine, batch, new_tokens))
                    out["walls"].append(time.monotonic() - t0)
                out["launches"] = _read_launches() if count else None
                out["metrics"] = dict(
                    engine.metrics(), dispatches=stats,
                    blocks_in_use=engine.scheduler.allocator.used)
                out["logits"] = _last_logits(torch, engine.runner,
                                             wave1[4][0][:100])
                if main:
                    out["spec_base"] = await _serve(engine, spec_reqs,
                                                    SPEC_NEW_TOKENS)
                    (out["cli_base"],) = await _serve(
                        engine, [(cli_ids, greedy)], NEW_TOKENS)
                    out["step"] = (_decode_step_profile(
                        torch, engine.runner, ctx=PHI3_DECODE_CTX)
                        if on_card else None)
            finally:
                await engine.close()
            return out

        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        waves = [(wave1, PHI3_NEW_TOKENS), (wave2, PHI3_NEW_TOKENS)]
        main = asyncio.run(serve({}, waves, count=True, main=True))
        peak = torch.cuda.max_memory_allocated(dev) if on_card else None
        step = main["step"]
        cut = dataclasses.replace(mcfg, num_layers=2, rope_scaling=dict(
            mcfg.rope_scaling, original_max_position_embeddings=PHI3_ORIGINAL_CUT))
        logits = _check_logits(
            torch, cfg, llama, cut, runner.device,
            dict(loaded, layers={k: v[:2] for k, v in loaded["layers"].items()}),
            wave1[4][0][:100], wave1[2][0][:40])
        k4 = asyncio.run(serve(dict(multi_step_decode=4), waves[:1], count=True))
        chained = asyncio.run(serve(CHAIN, waves[:1], count=True, guarded=True))
        spec = asyncio.run(serve(SPEC, [(spec_reqs, SPEC_NEW_TOKENS)],
                                 count=True))
        parted = _spec_agreement(torch, runner, spec_reqs, main["spec_base"],
                                 spec["res"][0])
        fp8 = asyncio.run(serve(dict(SPEC, kv_cache_dtype="fp8"),
                                [waves[0], (spec_reqs, SPEC_NEW_TOKENS)],
                                count=True))
        try:
            EngineConfig(model=mcfg, **dict(
                ENGINE, **PHI3_ENGINE, sp_size=2,
                long_prefill_threshold_tokens=4096))
            sp_refusal = None
        except ValueError as e:
            sp_refusal = str(e)

        # ---- 7. the CLI over the snapshot
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        vocab_ids = {p: i for i, (p, _, _) in enumerate(pieces)}
        vocab_ids.update({str(i): i for i in range(len(pieces), vocab)})
        (cli_res,), cli = _cli_serve(
            str(snap), "phi-3-mini-128k-random", PHI3_CLI_EXTRA,
            [([(cli_text, greedy)], NEW_TOKENS)], vocab_ids,
            flags=PHI3_CLI_FLAGS)
        cli_greedy = _held_greedy(torch, runner, [(cli_ids, greedy)],
                                  [main["cli_base"]], cli_res, "phi-3 CLI")
        cli_decoded = tok.decode(cli_res[0]["tokens"])
    del runner, loaded
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    res1, res2 = main["res"]
    lg8, lgb = fp8["logits"], main["logits"]
    fp8_logits = dict(rel_l2=float((lg8 - lgb).norm() / lgb.norm()),
                      argmax_equal=int(lg8.argmax()) == int(lgb.argmax()),
                      limit_rel_l2=FP8_LOGITS_REL_L2)
    ttfts = sorted(r["ttft_s"] for r in res1)

    def same(a, b):
        return sum(x["tokens"] == y["tokens"] for x, y in zip(a, b))
    emit("engine_phi3", model="Phi-3-mini-128k-instruct (published config.json, "
         "factor lists drawn from the seed), seeded random bf16 weights, "
         "non-unit norms, from a safetensors snapshot with a SentencePiece "
         "tokenizer.model", layers=layers, vocab=vocab, parameters=n_params,
         parameter_bytes=param_bytes, kv_bytes_per_token=kv_bytes_token,
         config=dict(ENGINE, **PHI3_ENGINE),
         snapshot=dict(written_bytes=written, write_s=write_s, load_s=load_s,
                       load_gb_per_s=param_bytes / load_s / 1e9,
                       leaves_unequal=unequal,
                       tokenizer_pieces=len(pieces)),
         requests=len(res1) + len(res2), new_tokens=PHI3_NEW_TOKENS,
         wave1_prompt_tokens=sum(len(p) for p, _ in wave1),
         wave1_wall_s=main["walls"][0],
         wave1_output_tokens_per_s=len(res1) * PHI3_NEW_TOKENS / main["walls"][0],
         ttft_s=dict(min=ttfts[0], median=ttfts[len(ttfts) // 2], max=ttfts[-1],
                     long_prompt=res1[6]["ttft_s"], crossing=res1[7]["ttft_s"]),
         peak_memory_bytes=peak, launches=main["launches"],
         metrics=main["metrics"], decode_step=step,
         logits_vs_cpu_f32_2_layers=dict(logits,
                                         original_cut=PHI3_ORIGINAL_CUT),
         burst=dict(k=4, streams_equal=same(res1, k4["res"][0]),
                    wave1_wall_s=k4["walls"][0], launches=k4["launches"]),
         chained=dict(k=4, streams_equal=same(res1, chained["res"][0]),
                      wave1_wall_s=chained["walls"][0],
                      **{k: chained["metrics"][k] for k in (
                          "decode_steps", "decode_pipeline_bursts",
                          "chain_len_max", "sync_fallback", "dispatches",
                          "blocks_in_use")},
                      launches=chained["launches"]),
         spec=dict(**SPEC, requests=len(spec_reqs),
                   proposed=spec["metrics"]["spec_proposed_tokens"],
                   accepted=spec["metrics"]["spec_accepted_tokens"],
                   streams_equal=same(main["spec_base"], spec["res"][0]),
                   parted=parted, launches=spec["launches"]),
         fp8=dict(wave1_streams_equal=same(res1, fp8["res"][0]),
                  spec_proposed=fp8["metrics"]["spec_proposed_tokens"],
                  logits_vs_bf16_kv=fp8_logits, launches=fp8["launches"],
                  blocks_in_use=fp8["metrics"]["blocks_in_use"]),
         sp_size_2_refused=sp_refusal,
         cli=dict(cli, prompt_tokens=len(cli_ids),
                  round_trip=tok.decode(cli_ids) == cli_text,
                  greedy_equal=cli_greedy[0], greedy_parted=cli_greedy[1],
                  text_is_decode=_held_text(cli_res[0]["text"], cli_decoded)),
         card=smi)

    if unequal:
        raise AssertionError(f"phi-3: loaded leaves differ from the drawn: "
                             f"{unequal}")
    _check_streams(res1 + res2, PHI3_NEW_TOKENS, vocab)
    _check_streams(k4["res"][0] + chained["res"][0] + fp8["res"][0],
                   PHI3_NEW_TOKENS, vocab)
    _check_streams(main["spec_base"] + spec["res"][0] + fp8["res"][1],
                   SPEC_NEW_TOKENS, vocab)
    if res1[0]["tokens"] != res1[1]["tokens"] or res1[2]["tokens"] != res1[3]["tokens"]:
        raise AssertionError("phi-3: repeated requests in one wave streamed "
                             "differently")
    tokens1 = [r["tokens"] for r in res1]
    for name, r in (("multi_step_decode=4", k4), ("chained", chained)):
        if [x["tokens"] for x in r["res"][0]] != tokens1:
            raise AssertionError(f"phi-3: wave 1 on the {name} engine streams "
                                 "differently from the K=1 engine")
    m = chained["metrics"]
    if m["dispatches"]["bad"] or m["chain_len_max"] <= 1 or m["blocks_in_use"]:
        raise AssertionError(f"phi-3 chained engine: {m}")
    if main["metrics"]["gpu_prefix_cache_hit_rate"] <= 0:
        raise AssertionError("phi-3: the shared-prefix request missed the "
                             "prefix cache")
    if spec["metrics"]["spec_proposed_tokens"] <= 0:
        raise AssertionError("phi-3: ngram speculation proposed nothing")
    if not fp8_logits["rel_l2"] <= FP8_LOGITS_REL_L2:
        raise AssertionError(f"phi-3 fp8: logits {fp8_logits}")
    if fp8["metrics"]["blocks_in_use"]:
        raise AssertionError("phi-3 fp8: KV blocks still in use")
    if sp_refusal is None or "sliding_window" not in sp_refusal:
        raise AssertionError(f"phi-3: sp_size 2 was not refused by the "
                             f"window: {sp_refusal!r}")
    if tok.decode(cli_ids) != cli_text:
        raise AssertionError("phi-3: the SentencePiece reader's decode of its "
                             "encode is not the text")
    if not _held_text(cli_res[0]["text"], cli_decoded):
        raise AssertionError(f"phi-3 CLI: streamed {cli_res[0]['text']!r}, the "
                             f"reader decodes {cli_decoded!r}")
    if on_card:
        _check_launches("phi-3 main", main["launches"],
                        ("paged_decode", "paged_flash", "epilogue"), layers)
        _check_launches("phi-3 burst", k4["launches"],
                        ("paged_decode", "epilogue"), layers)
        _check_launches("phi-3 chained", chained["launches"],
                        ("paged_decode", "epilogue"), layers)
        _check_launches("phi-3 spec", spec["launches"], ("paged_verify",),
                        layers)
        _check_launches("phi-3 fp8", fp8["launches"],
                        ("paged_decode_fp8", "paged_flash_fp8",
                         "paged_verify_fp8"), layers)
        bf16 = {k: fp8["launches"][k] for k in ("paged_decode", "paged_flash",
                                                 "paged_verify")}
        if any(bf16.values()):
            raise AssertionError(f"phi-3 fp8 path launched a bf16 form: {bf16}")
        if main["launches"]["mla_decode"] or main["launches"]["sp_prefix"]:
            raise AssertionError(f"the phi-3 path launched a foreign kernel: "
                                 f"{main['launches']}")
        if not step["decode_kernel_ms"] > 0:
            raise AssertionError(f"phi-3: the profiled decode step shows no "
                                 f"decode kernel: {step['top_kernels_ms']}")
    return dict(paged_decode_d96=main["launches"]["paged_decode"],
                paged_flash_d96=main["launches"]["paged_flash"],
                paged_verify_d96=spec["launches"]["paged_verify"],
                paged_decode_d96_fp8=fp8["launches"]["paged_decode_fp8"],
                paged_flash_d96_fp8=fp8["launches"]["paged_flash_fp8"],
                paged_verify_d96_fp8=fp8["launches"]["paged_verify_fp8"])


PHASES = ("kernels", "engine", "engine_chain", "engine_fp8", "engine_mla",
          "engine_gptoss", "engine_gemma2", "engine_qwen3moe",
          "engine_mixtral_int8", "engine_sp", "engine_http", "engine_guided",
          "engine_graph", "engine_disagg", "engine_kv_tiers", "engine_load",
          "engine_spec", "engine_recovery", "engine_phi3")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--phases", default=",".join(PHASES),
        help="comma-separated subset of %(default)s to run while working on "
             "one of them; the result line then says partial")
    phases = [p for p in ap.parse_args(argv).phases.split(",") if p]
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        ap.error(f"unknown phases {unknown}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from dynamo_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the dynamo_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 3
    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    torch.cuda.synchronize()

    t0 = time.monotonic()
    seconds = _build.build()
    emit("build", seconds=time.monotonic() - t0, per_kernel=seconds,
         ptxas={n: _ptxas_summary(log) for n, log in _build.build_log.items()})
    torch.cuda.synchronize()

    entries, launches, phase_s = {}, {}, {}
    if "kernels" in phases:
        t0 = time.monotonic()
        entries = kernel_phase(torch, dev)
        phase_s["kernels"] = time.monotonic() - t0
        torch.cuda.synchronize()
    for name, phase in (("engine", engine_phase),
                        ("engine_chain", engine_chain_phase),
                        ("engine_fp8", engine_fp8_phase),
                        ("engine_mla", engine_mla_phase),
                        ("engine_gptoss", engine_gptoss_phase),
                        ("engine_gemma2", engine_gemma2_phase),
                        ("engine_qwen3moe",
                         functools.partial(engine_moe_phase, cell="qwen3moe")),
                        ("engine_mixtral_int8",
                         functools.partial(engine_moe_phase,
                                           cell="mixtral_int8")),
                        ("engine_sp", engine_sp_phase)):
        if name in phases:
            t0 = time.monotonic()
            launches.update(phase(torch, dev, smi))
            phase_s[name] = time.monotonic() - t0
            torch.cuda.synchronize()
            gc.collect()  # the phase's weights and caches go first
            torch.cuda.empty_cache()
    http_launches = {}
    if "engine_http" in phases:
        # the OpenAI front's path: its own counts, beside the main path's
        t0 = time.monotonic()
        http_launches = engine_http_phase(torch, dev, smi)
        phase_s["engine_http"] = time.monotonic() - t0
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
    guided_launches = {}
    if "engine_guided" in phases:
        # guided JSON and /v1/embeddings behind the front: the chained
        # engine's own counts
        t0 = time.monotonic()
        guided_launches = engine_guided_phase(torch, dev, smi)
        phase_s["engine_guided"] = time.monotonic() - t0
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
    graph_launches = {}
    if "engine_graph" in phases:
        # the inference graph's workers (subprocesses): their own counts
        t0 = time.monotonic()
        graph_launches = engine_graph_phase(torch, dev, smi)
        phase_s["engine_graph"] = time.monotonic() - t0
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
    disagg_launches = {}
    if "engine_disagg" in phases:
        # the disaggregated pair (the CLI path's two workers; leg A's fp8
        # forms): their own counts
        t0 = time.monotonic()
        disagg_launches = engine_disagg_phase(torch, dev, smi)
        phase_s["engine_disagg"] = time.monotonic() - t0
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
    tiers_launches = {}
    if "engine_kv_tiers" in phases:
        # the KV tiers' engines (host restore, cold pull and rehydrate; the
        # e4m3 engine's fp8 forms): their own counts
        t0 = time.monotonic()
        tiers_launches = engine_kv_tiers_phase(torch, dev, smi)
        phase_s["engine_kv_tiers"] = time.monotonic() - t0
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
    if "engine_load" in phases:
        t0 = time.monotonic()
        launches.update(engine_load_phase(torch, dev, smi))
        phase_s["engine_load"] = time.monotonic() - t0
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
    spec_launches = {}
    if "engine_spec" in phases:
        # the rest of speculation (a drafted Llama-3.1-8B, chained rounds):
        # the chained draft engine's counts, kernel 4's beside the chained
        # ngram engine's
        t0 = time.monotonic()
        spec_launches = engine_spec_phase(torch, dev, smi)
        phase_s["engine_spec"] = time.monotonic() - t0
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()

    recovery_launches = {}
    if "engine_recovery" in phases:
        # recovery and live migration (a drained Llama-3.1-8B, the CLI's
        # rolling update): the peer's resumed decode and re-prefills
        t0 = time.monotonic()
        recovery_launches = engine_recovery_phase(torch, dev, smi)
        phase_s["engine_recovery"] = time.monotonic() - t0
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
    if "engine_phi3" in phases:
        # Phi-3-mini-128k from its snapshot: the D-96 forms' counts
        t0 = time.monotonic()
        launches.update(engine_phi3_phase(torch, dev, smi))
        phase_s["engine_phi3"] = time.monotonic() - t0
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()

    kernels = [dict(entry, launches=launches.get(key),
                    **({"launches_engine_http": http_launches[key]}
                       if key in http_launches else {}),
                    **({"launches_engine_guided": guided_launches[key]}
                       if key in guided_launches else {}),
                    **({"launches_engine_graph": graph_launches[key]}
                       if key in graph_launches else {}),
                    **({"launches_engine_disagg": disagg_launches[key]}
                       if key in disagg_launches else {}),
                    **({"launches_engine_kv_tiers": tiers_launches[key]}
                       if key in tiers_launches else {}),
                    **({"launches_engine_spec": spec_launches[key]}
                       if key in spec_launches else {}),
                    **({"launches_engine_recovery": recovery_launches[key]}
                       if key in recovery_launches else {}))
               for key, entry in entries.items()]
    partial = len(phases) < len(PHASES)
    # a form no cell serves (``path`` says so) has no count: null
    if not partial and any(k["launches"] is None and "path" not in k
                           for k in kernels):
        raise AssertionError(f"a kernel has no launch count: {kernels}")
    emit("done", seconds=time.monotonic() - t_start, phases=phases,
         phase_s=phase_s)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, **({"partial": phases} if partial else {}),
                      "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
