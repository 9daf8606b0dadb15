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
config field). ``create`` takes an ``EngineConfig``, or a model card and
the CLI's flags (``engine_config_from_mdc``). Refused by name:
``guided_json`` (it needs the tokenizer's piece table) and
``guided_choice`` given as text without its token ids. A model card's
directory (or ``.gguf``) is loaded by the runner (``models/loader.py``);
without a checkpoint it serves seeded random weights only with
``allow_random_weights``, as the reference does. Not ported: the stall
watchdog.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import uuid
from typing import Any, AsyncIterator, Optional

from ..protocols.common import EngineOutput, FinishReason, PreprocessedRequest
from ..runtime.engine import AsyncEngine, AsyncEngineContext, Context, EngineError
from ..models.loader import resolve_weights
from .config import EngineConfig, ModelConfig
from .model_runner import ModelRunner
from .scheduler import EngineRequest, Scheduler


def engine_config_from_mdc(mdc, flags=None, extra=None) -> EngineConfig:
    """The one place MDC + CLI flags become an EngineConfig (the reference's
    ``engine_config_from_mdc`` for the flags the port's CLI takes; every
    other engine knob comes through ``extra``, and the ones the port does
    not serve are refused by ``EngineConfig`` when set).

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
        decode_pipeline_depth=getattr(flags, "decode_pipeline_depth", 1) or 1,
        allow_random_weights=getattr(flags, "allow_random_weights", False),
        kv_cache_dtype=getattr(flags, "kv_cache_dtype", "auto") or "auto",
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


def check_random_weights(model_dir: Optional[str], config: EngineConfig) -> None:
    """The reference's weight rule for a model directory, checked before a
    model is built (``models.loader.resolve_weights``)."""
    if model_dir is not None:
        resolve_weights(model_dir, config.allow_random_weights)


class TorchServingEngine(AsyncEngine):
    def __init__(self, runner: ModelRunner, scheduler: Scheduler,
                 config: EngineConfig):
        self.runner = runner
        self.scheduler = scheduler
        self.config = config

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
    ) -> "TorchServingEngine":
        """Build the runner on ``device`` (default "cuda", which raises when
        no card is present), warm it up (builds the kernels on a card) and
        start the scheduler loop. ``params`` in the reference layout; None
        with no model card draws seeded random weights
        (``engine_config.seed``). Without an ``engine_config`` it comes from
        the model card ``mdc`` and the CLI ``flags``
        (``engine_config_from_mdc``). The card's directory (or ``.gguf``)
        is loaded (``ModelRunner(model_dir=...)``) or, without a checkpoint,
        must allow random weights (``models.loader.resolve_weights``)."""
        if engine_config is None:
            if mdc is None:
                raise ValueError("create needs an engine_config or a model card")
            engine_config = engine_config_from_mdc(mdc, flags)
        model_dir = mdc.model_path if mdc is not None and params is None else None
        loop = asyncio.get_running_loop()
        runner = await loop.run_in_executor(
            None, lambda: ModelRunner(engine_config, params=params,
                                      device=device, model_dir=model_dir))
        if warmup:
            await loop.run_in_executor(None, runner.warmup)
        scheduler = Scheduler(runner, engine_config)
        engine = cls(runner, scheduler, engine_config)
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
        if so.guided_json:
            raise EngineError(
                "guided_json is not served by the PyTorch engine yet (it "
                "needs the tokenizer's piece table)")
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
        er = EngineRequest(
            request_id=request.id or uuid.uuid4().hex,
            prompt=list(req.token_ids),
            req=req,
            ctx=request.context,
            out_queue=asyncio.Queue(),
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
        children = [EngineRequest(
            request_id=f"{base_id}#{i}",
            prompt=list(req.token_ids),
            req=dataclasses.replace(req, sampling_options=dataclasses.replace(
                req.sampling_options, n=1,
                seed=(base_seed + i) if base_seed is not None else None)),
            ctx=child_ctxs[i],
            out_queue=asyncio.Queue(),
        ) for i in range(n)]
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

    def metrics(self) -> dict:
        return self.scheduler.metrics()

    async def close(self) -> None:
        await self.scheduler.stop()
