"""The canonical LLM serving graph on the port's SDK.

The port's copy of ``examples/llm/components.py`` (reference: upstream
examples/llm/components/{frontend,processor,kv_router,worker,
prefill_worker}.py and graphs/{agg,agg_router,disagg,disagg_router}.py):

- ``Frontend``: the OpenAI HTTP server and the model watcher. On close
  (a worker process's SIGTERM) it stops taking requests and drains the
  ones in flight for up to ``RuntimeSettings.graceful_shutdown_timeout``
  (``DYN_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT``), as the CLI's front does.
- ``Processor``: tokenize and detokenize, route to the workers (round
  robin, or through the Router service's KV-aware decision), stream the
  deltas back.
- ``Router``: KV-aware scheduling as a service: token ids in, the chosen
  worker instance out.
- ``Worker``: the token-level engine worker (the echo engine by default,
  so the graph runs on any machine; ``engine: torch`` with ``model-path``
  serves a model on the card its ``resources={"gpu": 1}`` hands it, or on
  the CPU with ``device: cpu``), publishing KV events and
  ForwardPassMetrics.
- ``PrefillWorker``: consumes the namespace's prefill queue for
  disaggregated serving over tcp.

Each service reads its options from ServiceConfig (``configs/*.json``); a
Worker's and a PrefillWorker's options are the CLI's flags
(``cli/run.py``), checked and refused as the CLI refuses them: the
parallel sizes, the multi-host flags and ``kv-transfer: ici`` raise by
name, and so does ``engine: jax``. Nothing here imports torch until a
Worker or a PrefillWorker builds its engine.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any, AsyncIterator

from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.sdk import async_on_start, depends, dynamo_endpoint, service
from dynamo_tpu_torch.sdk.config import ServiceConfig

NAMESPACE = "public"
# the Worker's own keys; every other key is a flag of cli/run.py
WORKER_KEYS = ("engine",)
# what a Worker's ``engine`` may name (cli/run.py's token-level engines)
WORKER_ENGINES = ("torch", "echo_core")
# the reference's multi-host keys (its _maybe_join_world); the port joins no
# world across hosts yet
MULTI_HOST_KEYS = ("num-nodes", "node-rank", "leader-addr")


def _opt(obj, key: str, default=None):
    return obj.service_config.get(key, default)


def worker_flags(cfg: dict):
    """A Worker's or a PrefillWorker's service config → the flag namespace
    of ``cli/run.py`` (the counterpart of the reference's ``_WorkerFlags``):
    its keys are the CLI's flags, parsed and refused by the CLI's own
    parser. Raises ValueError naming a key the CLI does not take or
    refuses."""
    from dynamo_tpu_torch.cli import run

    _maybe_join_world(cfg)
    args = ServiceConfig(
        {"w": {k: v for k, v in cfg.items() if k not in WORKER_KEYS}}
    ).as_args("w")
    known = run.build_parser()._option_string_actions
    unknown = [a for a in args if a.startswith("--") and a not in known
               and a not in run.REFUSED_FLAGS]
    if unknown:
        raise ValueError(f"worker config keys {unknown} are not flags of "
                         f"the PyTorch port's CLI (cli/run.py)")
    try:
        flags = run.parse_flags(args)
    except SystemExit as e:
        raise ValueError(f"worker config: {e}") from None
    flags.namespace = NAMESPACE
    return flags


def _maybe_join_world(cfg: dict) -> None:
    """The reference joins a jax.distributed world here when ``num-nodes``
    is above 1. The port serves one host: every multi-host key raises by
    name, as the CLI's REFUSED_FLAGS do."""
    keys = [k for k in MULTI_HOST_KEYS if k in cfg]
    if keys:
        raise ValueError(
            f"worker config keys {keys} are not served by the PyTorch port "
            f"(a multi-host world is not ported; one host serves the graph)")


def _check_engine(engine: str, flags, resources: dict) -> None:
    """``engine: torch`` serves on a card only where the service asked for
    one: a Worker without a ``gpu`` resource raises rather than build its
    engine on the CPU unasked (``device: cpu`` asks for the CPU)."""
    if engine not in WORKER_ENGINES and not engine.startswith("pytok:"):
        raise ValueError(
            f"Worker engine {engine!r} is not served by the PyTorch port "
            f"(served: {', '.join(WORKER_ENGINES)}, pytok:<file>)")
    if (engine == "torch" and flags.device != "cpu"
            and int(resources.get("gpu", 0)) < 1):
        raise ValueError(
            f"a Worker serving engine: torch on device {flags.device!r} needs "
            f"a card: its resources {resources} name no 'gpu' (declare "
            f"resources={{'gpu': 1}}, or set device: cpu)")


# --------------------------------------------------------------------------


@service(dynamo={"namespace": NAMESPACE}, resources={"gpu": 1})
class Worker:
    """The token-level engine worker (reference: components/worker.py)."""

    @async_on_start
    async def setup(self):
        from dynamo_tpu_torch.cli.run import (
            _disagg_factory,
            build_core_engine,
            load_mdc,
        )
        from dynamo_tpu_torch.kv_router.publisher import (
            KvEventPublisher,
            KvMetricsPublisher,
        )

        engine = _opt(self, "engine", "echo_core")
        flags = worker_flags(self.service_config)
        _check_engine(engine, flags, self.resources)
        self.instance_id = f"w-{uuid.uuid4().hex[:12]}"
        comp = self.drt.namespace(NAMESPACE).component("Worker")
        self.publisher = KvEventPublisher(comp, self.instance_id)
        self.publisher.start()
        mdc = load_mdc(flags) if flags.model_path else None
        self.engine = await build_core_engine(
            engine, flags, mdc, events=self.publisher.as_sink(),
            disagg_factory=_disagg_factory(flags, self.drt, "Worker"))
        metrics_fn = getattr(self.engine, "metrics", dict)
        self.stats_handler = KvMetricsPublisher(metrics_fn).stats_handler

    @dynamo_endpoint
    async def generate(self, request, ctx) -> AsyncIterator[dict]:
        async for out in self.engine.generate(Context(request, ctx)):
            yield out

    async def close(self):
        self.publisher.stop()
        close = getattr(self.engine, "close", None)
        if close is not None:
            await close()


# --------------------------------------------------------------------------


@service(dynamo={"namespace": NAMESPACE})
class Router:
    """KV-aware worker selection as a service (reference:
    components/kv_router.py and the router binary)."""

    @async_on_start
    async def setup(self):
        from dynamo_tpu_torch.kv_router.router import KvRouter
        from dynamo_tpu_torch.runtime.client import Client

        block_size = int(_opt(self, "block-size", 16))
        comp = self.drt.namespace(NAMESPACE).component("Worker")
        self.router = await KvRouter(
            comp, Client(comp.endpoint("generate")), block_size=block_size
        ).start()

    @dynamo_endpoint
    async def generate(self, request) -> AsyncIterator[dict]:
        decision = await self.router.schedule(request["token_ids"])
        yield {
            "worker_id": decision.worker_id,
            "prefix_hit_blocks": decision.matched_blocks,
        }

    async def close(self):
        await self.router.stop()


class _RemoteRoutedClient(AsyncEngine):
    """The Processor's client: ask the Router service for a worker, then
    route the preprocessed request straight to it."""

    def __init__(self, worker_client, router_call):
        self.worker_client = worker_client
        self.router_call = router_call

    async def generate(self, request: Context[Any]) -> AsyncIterator[Any]:
        payload = request.payload
        token_ids = (
            payload.token_ids if hasattr(payload, "token_ids")
            else payload.get("token_ids", [])
        )
        try:
            async for decision in self.router_call({"token_ids": list(token_ids)}):
                request.baggage["instance_id"] = decision["worker_id"]
                break
        except Exception:
            pass  # the router is down: the client's own routing serves
        async for item in self.worker_client.generate(request):
            yield item


@service(dynamo={"namespace": NAMESPACE})
class Processor:
    """OpenAI ↔ token translation and routing (reference:
    components/processor.py).

    The Router service is NOT a declared dependency (agg graphs run
    without one); ``router-mode: kv`` builds a client to it here (the
    router graphs link it in, so the supervisor spawns it)."""

    @async_on_start
    async def setup(self):
        from dynamo_tpu_torch.http.service import register_model
        from dynamo_tpu_torch.llm.backend import Backend
        from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
        from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
        from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
        from dynamo_tpu_torch.runtime.client import Client, RouterMode
        from dynamo_tpu_torch.runtime.pipeline import build_pipeline

        model_path = _opt(self, "model-path")
        if model_path is None:
            raise ValueError("Processor requires model-path in its config")
        mdc = ModelDeploymentCard.from_local_path(model_path)
        tokenizer = HFTokenizer.from_pretrained_dir(model_path)

        comp = self.drt.namespace(NAMESPACE).component("Worker")
        mode = _opt(self, "router-mode", "round_robin")
        self.client = Client(
            comp.endpoint("generate"),
            RouterMode.ROUND_ROBIN if mode == "kv" else RouterMode(mode),
        )
        await self.client.start()
        engine_tail: AsyncEngine = self.client
        if mode == "kv":
            from dynamo_tpu_torch.sdk import DynamoClient

            router = await DynamoClient(Router, self.drt).start()
            engine_tail = _RemoteRoutedClient(self.client, router.generate)
        self.engine = build_pipeline(
            [OpenAIPreprocessor(mdc, tokenizer), Backend(tokenizer)], engine_tail
        )
        name = _opt(self, "model-name", mdc.display_name)
        await register_model(
            self.drt, NAMESPACE, name, f"dyn://{NAMESPACE}.Processor.chat",
            model_type="both",
        )

    @dynamo_endpoint
    async def chat(self, request, ctx) -> AsyncIterator[dict]:
        from dynamo_tpu_torch.protocols.annotated import Annotated
        from dynamo_tpu_torch.protocols.openai import (
            ChatCompletionRequest,
            CompletionRequest,
        )

        cls = ChatCompletionRequest if "messages" in request else CompletionRequest
        async for chunk in self.engine.generate(Context(cls.model_validate(request), ctx)):
            if isinstance(chunk, Annotated):
                yield chunk.to_wire()
            else:
                yield chunk if isinstance(chunk, dict) else chunk.model_dump(
                    exclude_none=True)

    async def close(self):
        await self.client.close()


# --------------------------------------------------------------------------


@service(dynamo={"namespace": NAMESPACE})
class Frontend:
    """The OpenAI HTTP front and the discovery plane's model watcher
    (reference: components/frontend.py and the http binary)."""

    processor = depends(Processor)

    @async_on_start
    async def setup(self):
        from dynamo_tpu_torch.http.service import (
            HttpService,
            ModelManager,
            ModelWatcher,
        )
        from dynamo_tpu_torch.runtime.client import RouterMode

        manager = ModelManager()
        self.http = HttpService(
            manager,
            _opt(self, "http-host", "0.0.0.0"),
            int(_opt(self, "http-port", 8080)),
        )
        self.watcher = ModelWatcher(
            self.drt, manager, NAMESPACE, RouterMode.ROUND_ROBIN
        )
        await self.watcher.start()
        await self.http.start()

    async def close(self):
        """Stop taking requests, drain the ones in flight for up to the
        runtime settings' grace period, then stop."""
        from dynamo_tpu_torch.utils.config import RuntimeSettings

        settings = RuntimeSettings.from_settings()
        loop = asyncio.get_running_loop()
        await self.http.stop_accepting()
        deadline = loop.time() + settings.graceful_shutdown_timeout
        while (self.http.metrics.inflight_total() > 0
               and loop.time() < deadline):
            await asyncio.sleep(0.1)
        await self.http.stop()
        await self.watcher.stop()


# --------------------------------------------------------------------------


@service(dynamo={"namespace": NAMESPACE}, resources={"gpu": 1})
class PrefillWorker:
    """The dedicated prefill worker consuming the namespace's prefill
    queue (reference: components/prefill_worker.py). Its KV goes to the
    decode worker over tcp; the reference's ``_make_ici`` has no
    counterpart (``kv-transfer: ici`` raises by name)."""

    @async_on_start
    async def setup(self):
        from dynamo_tpu_torch.cli.run import load_mdc
        from dynamo_tpu_torch.disagg import PrefillWorker as PrefillLoop
        from dynamo_tpu_torch.engine.model_runner import ModelRunner
        from dynamo_tpu_torch.engine.serving import engine_config_from_mdc

        flags = worker_flags(self.service_config)
        if flags.model_path is None:
            raise ValueError("PrefillWorker requires model-path in its config")
        _check_engine("torch", flags, self.resources)
        mdc = load_mdc(flags)
        engine_config = engine_config_from_mdc(mdc, flags)
        loop = asyncio.get_running_loop()
        runner = await loop.run_in_executor(
            None, lambda: ModelRunner(engine_config, device=flags.device,
                                      model_dir=mdc.model_path))
        await loop.run_in_executor(None, runner.warmup)
        self.worker = PrefillLoop(
            self.drt, runner, engine_config, namespace=NAMESPACE)
        self._task = self.drt.runtime.spawn(self.worker.run())

    async def close(self):
        self.worker.stop()
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        await self.worker.close()
