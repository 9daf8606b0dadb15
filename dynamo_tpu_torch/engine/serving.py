"""TorchServingEngine: the AsyncEngine facade over runner + scheduler.

The port of ``JaxServingEngine`` (``dynamo_tpu/engine/serving.py``): the
token-level engine — ``PreprocessedRequest`` token ids in, streamed
``EngineOutput`` dicts out, the same interface the reference worker serves
as ``in=dyn://... out=jax --token-level``. Served: sampling with
penalties, logit_bias and logprobs, stop ids and canonical stop sequences
(``stop_token_seqs``), guided choices by token ids
(``guided_choice_token_ids``), on the synchronous path or, with
``EngineConfig.decode_pipeline_depth=2``, the dispatch-ahead and chained
device-finish decode loop, and with ``EngineConfig.sp_size > 1`` the
sequence-parallel prefill ladder for long prompts (its ranks laid out on
the one device; the reference's ``sequence_parallel_size`` flag is this
config field). Refused by name: ``n > 1`` fan-out,
``guided_json`` and ``guided_choice`` given as text (both need the
tokenizer, a later slice). Not ported: the stall watchdog.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any, AsyncIterator

from ..protocols.common import EngineOutput, FinishReason, PreprocessedRequest
from ..runtime.engine import AsyncEngine, Context, EngineError
from .config import EngineConfig
from .model_runner import ModelRunner
from .scheduler import EngineRequest, Scheduler


class TorchServingEngine(AsyncEngine):
    def __init__(self, runner: ModelRunner, scheduler: Scheduler,
                 config: EngineConfig):
        self.runner = runner
        self.scheduler = scheduler
        self.config = config

    @classmethod
    async def create(
        cls,
        engine_config: EngineConfig,
        params=None,
        device="cuda",
        warmup: bool = True,
    ) -> "TorchServingEngine":
        """Build the runner on ``device`` (default "cuda", which raises when
        no card is present), warm it up (builds the kernels on a card) and
        start the scheduler loop. ``params`` in the reference layout; None
        draws seeded random weights (``engine_config.seed``)."""
        loop = asyncio.get_running_loop()
        runner = await loop.run_in_executor(
            None, lambda: ModelRunner(engine_config, params=params,
                                      device=device))
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
        if so.n is not None and so.n > 1:
            raise EngineError("n > 1 is not served by the PyTorch engine yet")
        if so.guided_json:
            raise EngineError(
                "guided_json is not served by the PyTorch engine yet (it "
                "needs the tokenizer's piece table)")
        if so.guided_choice and not so.guided_choice_token_ids:
            raise EngineError(
                "guided_choice without guided_choice_token_ids is not served "
                "by the PyTorch engine (it holds no tokenizer)")
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

    def metrics(self) -> dict:
        return self.scheduler.metrics()

    async def close(self) -> None:
        await self.scheduler.stop()
