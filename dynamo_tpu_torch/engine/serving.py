"""TorchServingEngine: the AsyncEngine facade over runner + scheduler.

The port of ``JaxServingEngine`` (``dynamo_tpu/engine/serving.py``): the
token-level engine — ``PreprocessedRequest`` token ids in, streamed
``EngineOutput`` dicts out, the interface the OpenAI front's preprocessor
and backend stages drive (``cli/run.py``, ``out=torch``) and the reference
worker serves as ``in=dyn://... out=jax --token-level``. Served: sampling
with penalties, logit_bias and logprobs, stop ids and canonical stop
sequences (``stop_token_seqs``), guided choices by token ids
(``guided_choice_token_ids``, which the preprocessor tokenizes), ``n > 1``
as n independent requests (each seed offset by its choice index, each
delta tagged with its choice), on the synchronous path or, with
``EngineConfig.decode_pipeline_depth=2``, the dispatch-ahead and chained
device-finish decode loop, and with ``EngineConfig.sp_size > 1`` the
sequence-parallel prefill ladder for long prompts (its ranks laid out on
the one device; the reference's ``sequence_parallel_size`` flag is this
config field). Guided JSON (``guided_json``: ``json_object`` or a schema)
walks a ``JsonGrammar`` compiled once per distinct spec over the model
card's tokenizer (its piece table built once per engine, both in an
executor thread; a 32-grammar LRU), one ``JsonConstraint`` cursor per
request or per child of ``n > 1``. ``embed`` serves the cacheless embed
trunk (``ModelRunner.embed_prompts``, the /v1/embeddings engine half) in
an executor beside the scheduler's loop. ``create`` takes an
``EngineConfig``, or a model card and the CLI's flags
(``engine_config_from_mdc``). With a ``disagg_factory`` the engine is a
disaggregated decode worker: long prompts prefill on the prefill pool and
their KV streams back into this cache. With ``host_kv_blocks`` /
``cold_tier_blocks`` / ``prefix_pull`` the scheduler builds the KV tiers
and the cluster KV fabric (``kv/``); the engine's ``registry`` carries
their instruments. With ``spec_draft_model`` the engine also builds the
draft's runner (``build_draft_config``: the draft's own model directory,
the target's cache geometry, a K + 1-step burst) on the target's device,
warms it up and hands it to the scheduler, whose speculative rounds draw
their proposals from it. Refused by name: ``guided_choice`` given as text
without its token ids, and ``guided_json`` on an engine built without a
model card (it holds no tokenizer). A model card's
directory (or ``.gguf``) is loaded by the runner (``models/loader.py``);
without a checkpoint it serves seeded random weights only with
``allow_random_weights``, as the reference does. Not ported: the stall
watchdog.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import threading
import time
import uuid
from typing import Any, AsyncIterator, Optional

from ..protocols.common import EngineOutput, FinishReason, PreprocessedRequest
from ..runtime.engine import AsyncEngine, AsyncEngineContext, Context, EngineError
from ..models.loader import resolve_weights
from ..llm.tokenizer import HFTokenizer
from .block_allocator import KvEventSink
from .config import EngineConfig, ModelConfig
from .guided import JsonConstraint, JsonGrammar, build_piece_table
from .model_runner import ModelRunner
from .scheduler import EngineRequest, Scheduler


def engine_config_from_mdc(mdc, flags=None, extra=None) -> EngineConfig:
    """The one place MDC + CLI flags become an EngineConfig (the reference's
    ``engine_config_from_mdc`` for the flags the port's CLI takes, each with
    the reference's default and fallback; every other engine knob comes
    through ``extra``, and the ones the port does not serve are refused by
    ``EngineConfig`` when set).

    ``extra`` is the ``--extra-engine-args`` JSON passthrough: keys naming
    ModelConfig fields override the model config, keys naming EngineConfig
    fields override the engine config; unknown keys are rejected loudly.
    """
    model_cfg = ModelConfig.from_hf_config(mdc.config) if mdc.config else ModelConfig()
    if getattr(flags, "quantization", None):
        model_cfg.quantization = flags.quantization
    if extra is None:
        extra = load_extra_engine_args(flags)
    extra = dict(extra or {})
    model_extra = {}
    engine_extra = {}
    model_fields = {f.name for f in dataclasses.fields(ModelConfig)}
    engine_fields = {f.name for f in dataclasses.fields(EngineConfig)}
    for key, value in extra.items():
        if key in model_fields:
            model_extra[key] = value
        elif key in engine_fields and key != "model":
            engine_extra[key] = value
        else:
            raise ValueError(
                f"--extra-engine-args key {key!r} matches no ModelConfig or "
                f"EngineConfig field"
            )
    if model_extra:
        # replace (not setattr) so __post_init__ re-validates/derives
        model_cfg = dataclasses.replace(model_cfg, **model_extra)
    return _apply_engine_extra(engine_extra, EngineConfig(
        model=model_cfg,
        max_batch_size=getattr(flags, "max_batch_size", 8),
        max_model_len=getattr(flags, "max_model_len", None)
        or min(mdc.context_length, model_cfg.max_position_embeddings),
        kv_block_size=mdc.kv_block_size,
        num_kv_blocks=getattr(flags, "num_kv_blocks", None) or 2048,
        # the sequence-parallel prefill ladder's ranks (on the one card)
        sp_size=getattr(flags, "sequence_parallel_size", 1) or 1,
        multi_step_decode=getattr(flags, "multi_step_decode", 1) or 1,
        decode_pipeline_depth=getattr(flags, "decode_pipeline_depth", 1) or 1,
        device_finish=getattr(flags, "device_finish", "auto") or "auto",
        fused_epilogue=getattr(flags, "fused_epilogue", "auto") or "auto",
        spec_ngram_tokens=getattr(flags, "spec_ngram_tokens", 0) or 0,
        spec_ngram_match=getattr(flags, "spec_ngram_match", 3) or 3,
        spec_draft_model=getattr(flags, "spec_draft_model", None),
        spec_draft_tokens=getattr(flags, "spec_draft_tokens", 0) or 0,
        # the chain's guided device tables and device-approximate stop
        # strings
        guided_device_table=not getattr(flags, "no_guided_device_table", False),
        guided_table_max_states=getattr(
            flags, "guided_table_max_states", 256) or 256,
        device_stop_strings=not getattr(flags, "no_device_stop_strings", False),
        allow_random_weights=getattr(flags, "allow_random_weights", False),
        kv_cache_dtype=getattr(flags, "kv_cache_dtype", "auto") or "auto",
        long_prefill_threshold_tokens=getattr(
            flags, "long_prefill_threshold_tokens", 0) or 0,
        disagg_stream_depth=getattr(flags, "disagg_stream_depth", None) or 2,
        host_kv_blocks=getattr(flags, "host_kv_blocks", 0) or 0,
        prefix_pull=getattr(flags, "prefix_pull", False),
        prefix_pull_min_blocks=getattr(
            flags, "prefix_pull_min_blocks", 2) or 2,
        prefix_pull_timeout_s=getattr(
            flags, "prefix_pull_timeout_s", 30.0) or 30.0,
        cold_tier_dir=getattr(flags, "cold_tier_dir", "") or "",
        cold_tier_blocks=getattr(flags, "cold_tier_blocks", 0) or 0,
    ))


def load_extra_engine_args(flags) -> dict:
    """--extra-engine-args <file.json> → dict."""
    path = getattr(flags, "extra_engine_args", None)
    if not path:
        return {}
    with open(path) as f:
        return json.load(f)


def _apply_engine_extra(extra: dict, cfg: EngineConfig) -> EngineConfig:
    """Apply --extra-engine-args EngineConfig overrides after construction
    (a max_model_len override without a bucket list drops the derived
    buckets, so the new length gets its own ladder)."""
    if not extra:
        return cfg
    if "max_model_len" in extra and "prefill_buckets" not in extra:
        extra = dict(extra, prefill_buckets=None)
    return dataclasses.replace(cfg, **extra)


def build_draft_config(target: EngineConfig) -> EngineConfig:
    """The draft model's EngineConfig for draft-model speculation (the
    reference's ``build_draft_config``).

    The draft's paged cache MIRRORS the target's block ids (the target's
    allocator decides for both), so the block geometry is the target's;
    the draft runs on one device with a K + 1-step burst as its proposal
    program."""
    draft_model = ModelConfig.from_model_dir(target.spec_draft_model)
    if draft_model.vocab_size != target.model.vocab_size:
        # smaller: target ids are out of range for the draft; larger: the
        # draft proposes ids the target never accepts
        raise ValueError(
            f"draft vocab {draft_model.vocab_size} != target "
            f"{target.model.vocab_size}: the two must share a tokenizer "
            "(out-of-range ids are either invalid for the draft or "
            "never-accepted noise for the target)"
        )
    if draft_model.max_position_embeddings < target.max_model_len:
        raise ValueError(
            f"draft max_position_embeddings "
            f"{draft_model.max_position_embeddings} < target max_model_len "
            f"{target.max_model_len}: past its rope range the draft's "
            "proposals degrade to noise and every round pays for nothing"
        )
    return dataclasses.replace(
        target,
        model=draft_model,
        spec_draft_model=None, spec_draft_tokens=0,  # no recursion
        tp_size=1, dp_size=1, ep_size=1, pp_size=1,
        # K + 1 burst steps for K proposals: the last step writes the K-th
        # proposal's KV into the mirror cache, so a fully accepted round
        # leaves no hole behind the new context
        multi_step_decode=target.spec_draft_tokens + 1,
    )


def check_random_weights(model_dir: Optional[str], config: EngineConfig) -> None:
    """The reference's weight rule for a model directory, checked before a
    model is built (``models.loader.resolve_weights``)."""
    if model_dir is not None:
        resolve_weights(model_dir, config.allow_random_weights)


class TorchServingEngine(AsyncEngine):
    JSON_GRAMMARS = 32  # the compiled-grammar LRU's bound (distinct specs)

    def __init__(self, runner: ModelRunner, scheduler: Scheduler,
                 config: EngineConfig):
        self.runner = runner
        self.scheduler = scheduler
        self.config = config
        # guided JSON: grammars (and the vocabulary piece table they share)
        # are compiled once per distinct spec and reused across requests
        self._model_path: Optional[str] = None
        self._pieces = None
        # two specs' first builds run in two executor threads: one of them
        # builds the piece table, the other waits for it
        self._pieces_lock = threading.Lock()
        self.piece_table_s: Optional[float] = None  # the build's seconds
        self._json_grammars: dict = {}

    @classmethod
    async def create(
        cls,
        engine_config: Optional[EngineConfig] = None,
        params=None,
        device="cuda",
        warmup: bool = True,
        *,
        mdc=None,
        flags=None,
        events: Optional[KvEventSink] = None,
        disagg_factory=None,
    ) -> "TorchServingEngine":
        """Build the runner on ``device`` (default "cuda", which raises when
        no card is present), warm it up (builds the kernels on a card) and
        start the scheduler loop. ``params`` in the reference layout; None
        with no model card draws seeded random weights
        (``engine_config.seed``). Without an ``engine_config`` it comes from
        the model card ``mdc`` and the CLI ``flags``
        (``engine_config_from_mdc``). The card's directory (or ``.gguf``)
        is loaded (``ModelRunner(model_dir=...)``) or, without a checkpoint,
        must allow random weights (``models.loader.resolve_weights``).
        ``events`` receives the allocator's KV events (a token-level
        worker's ``KvEventPublisher.as_sink()``). ``disagg_factory(runner)``
        (a coroutine function returning a started
        ``RemotePrefillCoordinator``) turns on conditional remote prefill;
        draft-model speculation is refused with it, as in the reference.
        With ``spec_draft_model`` the draft's runner is loaded from that
        directory (``models.loader``) on the same device, beside the
        target's, and warmed up with it."""
        if engine_config is None:
            if mdc is None:
                raise ValueError("create needs an engine_config or a model card")
            engine_config = engine_config_from_mdc(mdc, flags)
        model_dir = mdc.model_path if mdc is not None and params is None else None
        loop = asyncio.get_running_loop()
        runner_fut = loop.run_in_executor(
            None, lambda: ModelRunner(engine_config, params=params,
                                      device=device, model_dir=model_dir))
        draft_runner = None
        if engine_config.spec_draft_model:
            # the target's and the draft's builds share nothing: both load
            # at once
            draft_config = build_draft_config(engine_config)
            draft_fut = loop.run_in_executor(
                None, lambda: ModelRunner(
                    draft_config, device=device,
                    model_dir=engine_config.spec_draft_model))
            runner, draft_runner = await asyncio.gather(runner_fut, draft_fut)
        else:
            runner = await runner_fut
        disagg = None
        if disagg_factory is not None:
            if engine_config.spec_draft_model:
                raise ValueError(
                    "spec_draft_model is incompatible with disaggregated "
                    "remote prefill: remotely computed KV never passes "
                    "through the draft model, so its mirror cache would be "
                    "stale for every remote-prefilled request")
            disagg = await disagg_factory(runner)
        if warmup:
            # one after the other: the first builds the kernels
            for r in (runner, draft_runner):
                if r is not None:
                    await loop.run_in_executor(None, r.warmup)
        scheduler = Scheduler(runner, engine_config, events, disagg=disagg,
                              draft_runner=draft_runner)
        engine = cls(runner, scheduler, engine_config)
        if mdc is not None:
            engine._model_path = mdc.model_path  # guided JSON's piece table
        scheduler.start()
        return engine

    async def generate(self, request: Context[Any]) -> AsyncIterator[dict]:
        if self.scheduler._stopping:
            raise EngineError("engine is closed")
        payload = request.payload
        req = (
            payload
            if isinstance(payload, PreprocessedRequest)
            else PreprocessedRequest.from_wire(payload)
        )
        if not req.token_ids:
            raise EngineError("empty prompt")
        if len(req.token_ids) >= self.config.max_model_len:
            raise EngineError(
                f"prompt length {len(req.token_ids)} exceeds engine max_model_len "
                f"{self.config.max_model_len}"
            )
        vocab = self.config.model.vocab_size
        bad = next((t for t in req.token_ids if not 0 <= int(t) < vocab), None)
        if bad is not None:
            raise EngineError(f"prompt token id {bad} outside vocab [0, {vocab})")
        so = req.sampling_options
        if so.guided_choice and not so.guided_choice_token_ids:
            raise EngineError(
                "guided_choice without guided_choice_token_ids is not served "
                "by the PyTorch engine (it holds no tokenizer)")
        if so.n is not None and so.n > 1:
            # n independent n = 1 scheduler requests (the reference's
            # engine-level fan-out): seeds offset by the choice index, each
            # delta tagged with its choice
            if so.n > 20:  # OpenAI's cap; also bounds the fan-out
                raise EngineError("n must be <= 20")
            async for out in self._generate_fanout(request, req, so.n):
                yield out
            return
        if (req.stop_conditions.max_tokens == 0
                and req.output_options.prompt_logprobs is None):
            # an empty completion: nothing to schedule
            yield EngineOutput(
                token_ids=[], finish_reason=FinishReason.LENGTH).to_wire()
            return
        guided = None
        if so.guided_json:
            guided = await self._json_constraint(so.guided_json)
        er = EngineRequest(
            request_id=request.id or uuid.uuid4().hex,
            prompt=list(req.token_ids),
            req=req,
            ctx=request.context,
            out_queue=asyncio.Queue(),
            guided=guided,
        )
        self.scheduler.add_request(er)
        try:
            while True:
                out = await er.out_queue.get()
                if out is None:
                    return
                yield out.to_wire()
        finally:
            # consumer went away (stop/kill/break) — the scheduler reaps it
            request.context.stop_generating()

    async def _generate_fanout(self, request: Context[Any],
                               req: PreprocessedRequest, n: int):
        """n>1 as n independent n=1 scheduler requests sharing the caller's
        cancellation; deltas interleave in completion order, each stamped
        with its choice index, and the stream ends when every choice's
        sentinel arrived."""
        base_seed = req.sampling_options.seed
        child_ctxs = [AsyncEngineContext(trace_id=request.context.trace_id)
                      for _ in range(n)]

        async def relay_stop() -> None:
            await request.context.wait_stopped()
            for c in child_ctxs:
                c.stop_generating()

        relay = asyncio.ensure_future(relay_stop())
        base_id = request.id or uuid.uuid4().hex
        spec = req.sampling_options.guided_json
        children = []
        for i in range(n):
            children.append(EngineRequest(
                request_id=f"{base_id}#{i}",
                prompt=list(req.token_ids),
                req=dataclasses.replace(req, sampling_options=dataclasses.replace(
                    req.sampling_options, n=1,
                    seed=(base_seed + i) if base_seed is not None else None)),
                ctx=child_ctxs[i],
                out_queue=asyncio.Queue(),
                # one cursor per child over the shared grammar
                guided=await self._json_constraint(spec) if spec else None,
            ))
        merged: asyncio.Queue = asyncio.Queue()

        async def pump(i: int, er: EngineRequest):
            while True:
                out = await er.out_queue.get()
                await merged.put((i, out))
                if out is None:
                    return

        tasks = [asyncio.ensure_future(pump(i, er))
                 for i, er in enumerate(children)]
        for er in children:
            self.scheduler.add_request(er)
        open_choices = n
        try:
            while open_choices:
                i, out = await merged.get()
                if out is None:
                    open_choices -= 1
                    continue
                out.choice = i
                yield out.to_wire()
        finally:
            for t in tasks:
                t.cancel()
            relay.cancel()
            for c in child_ctxs:
                c.stop_generating()
            request.context.merge_stages_from(child_ctxs)

    async def _json_constraint(self, spec: dict) -> JsonConstraint:
        """Per-request cursor over the (cached) compiled grammar. The first
        request with a new spec pays the compile and the O(vocab) piece
        table in an executor thread; the scheduler loop never blocks on
        it, and followers with the same spec await that build."""
        key = json.dumps(spec, sort_keys=True)
        entry = self._json_grammars.get(key)
        if isinstance(entry, asyncio.Future):
            # a concurrent first request is already building this spec
            grammar = await asyncio.shield(entry)
        else:
            grammar = entry
        if grammar is None:
            if self._model_path is None:
                raise EngineError(
                    "guided json requires a tokenizer; this engine was "
                    "built without a model path")
            loop = asyncio.get_running_loop()

            def build():
                with self._pieces_lock:
                    if self._pieces is None:
                        t0 = time.perf_counter()
                        tok = HFTokenizer.from_model_path(self._model_path)
                        self._pieces = build_piece_table(
                            tok, self.config.model.vocab_size)
                        self.piece_table_s = time.perf_counter() - t0
                schema = (spec.get("schema")
                          if spec.get("type") == "json_schema" else None)
                g = JsonGrammar(self._pieces, schema)
                # the first O(vocab) mask sweep belongs here (executor
                # thread), not on the event loop, and it doubles as the
                # expressibility check
                ids, _at_end = JsonConstraint(g).allowed()
                if not ids:
                    raise EngineError(
                        "guided json: this model's tokenizer cannot "
                        "express the requested grammar (no legal first "
                        "token)")
                return g

            fut = loop.create_future()
            self._json_grammars[key] = fut  # followers await this build
            try:
                grammar = await loop.run_in_executor(None, build)
            except ValueError as e:
                err = EngineError(f"guided json: {e}")
                fut.set_exception(err)
                fut.exception()  # consumed (no un-retrieved warning)
                self._json_grammars.pop(key, None)
                raise err
            except BaseException as e:
                fut.set_exception(e)
                fut.exception()
                self._json_grammars.pop(key, None)
                raise
            fut.set_result(grammar)
            # bounded LRU over distinct specs: each grammar's mask cache
            # holds vocabulary-sized lists
            evictable = [k for k, v in self._json_grammars.items()
                         if not isinstance(v, asyncio.Future)]
            while len(self._json_grammars) > self.JSON_GRAMMARS and evictable:
                self._json_grammars.pop(evictable.pop(0), None)
            self._json_grammars[key] = grammar  # resolve future → value
        else:
            self._json_grammars.pop(key)
            self._json_grammars[key] = grammar  # LRU touch
        return JsonConstraint(grammar)

    @property
    def embed_ready(self) -> bool:
        return self.runner.embed_ready

    async def embed(self, prompts):
        """Batched prefill-only embeddings (the /v1/embeddings engine
        half): [n] token-id lists → [n, D] float32. The cacheless embed
        trunk reads the weights only (no cache, no sample state), so it
        runs in an executor thread beside the scheduler loop's own
        dispatches."""
        return await asyncio.get_running_loop().run_in_executor(
            None, self.runner.embed_prompts, prompts)

    @property
    def registry(self):
        """The scheduler's instruments (the KV tiers' and the fabric's)."""
        return self.scheduler.registry

    def metrics(self) -> dict:
        return self.scheduler.metrics()

    async def close(self) -> None:
        await self.scheduler.stop()
