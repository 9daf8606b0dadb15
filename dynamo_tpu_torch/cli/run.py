"""serve CLI: ``python3 -m dynamo_tpu_torch.cli.run in=<src> out=<engine> [flags]``.

The port's copy of ``dynamo_tpu/cli/run.py`` for one process serving the
OpenAI front: ``in=http`` (the HTTP service) or ``in=text`` (a prompt on
stdin) over ``out=torch`` (``TorchServingEngine`` behind the preprocessor
and the detokenizing backend), ``out=echo_core`` (the same stages over the
token echo engine) or ``out=echo_full`` (the OpenAI-level echo). The engine
runs on the card unless ``--device cpu`` asks for the CPU; without a card
the default raises, it does not fall back. Every other input, output and
reference flag is refused by name.

A ``--model-path`` directory holding a safetensors checkpoint, or a
``.gguf`` file, is loaded (``models/loader.py``); a directory without one
serves seeded random weights only with ``--allow-random-weights``.

Examples:
  python3 -m dynamo_tpu_torch.cli.run in=http out=torch --model-path <dir> \\
      --http-port 8080
  python3 -m dynamo_tpu_torch.cli.run in=http out=torch --model-path m.gguf
  python3 -m dynamo_tpu_torch.cli.run in=http out=torch --model-path <dir> \\
      --allow-random-weights --http-port 8080
  python3 -m dynamo_tpu_torch.cli.run in=http out=torch --model-path <dir> \\
      --allow-random-weights --device cpu --extra-engine-args f32.json
  python3 -m dynamo_tpu_torch.cli.run in=http out=torch --model-path <dir> \\
      --allow-random-weights --kv-cache-dtype fp8
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys
from typing import List

logger = logging.getLogger(__name__)

INPUTS = ("http", "text")
ENGINES = ("torch", "echo_core", "echo_full")
GRACEFUL_SHUTDOWN_S = 30.0

# the reference's flags this CLI does not take (each raises by name): the
# engine knobs among them are EngineConfig fields that --extra-engine-args
# sets; the rest (distribution, recovery, planning, tenants, telemetry)
# are not ported
REFUSED_FLAGS = (
    "--store-host", "--store-port", "--namespace", "--router-mode",
    "--tensor-parallel-size", "--expert-parallel-size",
    "--data-parallel-size", "--pipeline-parallel-size",
    "--sequence-parallel-size", "--long-prefill-threshold-tokens",
    "--token-level", "--worker-endpoint", "--isolate-engine",
    "--engine-heartbeat-s", "--engine-heartbeat-misses",
    "--engine-init-timeout-s", "--host-kv-blocks", "--multi-step-decode",
    "--device-finish", "--fused-epilogue", "--guided-table-max-states",
    "--no-guided-device-table", "--no-device-stop-strings",
    "--disagg-stream-depth", "--spec-ngram-tokens",
    "--spec-draft-model", "--spec-draft-tokens", "--spec-ngram-match",
    "--remote-prefill", "--max-local-prefill-length",
    "--max-prefill-queue-size", "--advertise-host", "--kv-transfer",
    "--ici-sender-rank", "--ici-receiver-rank", "--num-nodes", "--node-rank",
    "--leader-addr", "--profile-dir", "--profiler-port", "--flight-dir",
    "--watchdog-stall-s", "--self-heal", "--drain-grace-s", "--respawn-max",
    "--respawn-backoff-s", "--migrate-peers", "--migrate-port",
    "--prefix-pull", "--prefix-pull-min-blocks", "--prefix-pull-timeout-s",
    "--cold-tier-dir", "--cold-tier-blocks", "--admission-limit",
    "--admission-queue-depth", "--admission-queue-timeout-s", "--planner",
    "--planner-interval-s", "--planner-min-replicas",
    "--planner-max-replicas", "--planner-cooldown-s",
    "--planner-deployment", "--api-store-url", "--slo-ttft-ms",
    "--slo-itl-ms", "--hub", "--hub-interval-s", "--hub-target",
    "--incident-dir", "--incident-cooldown-s", "--incident-profile-s",
    "--trace-ttl-s", "--trace-capacity", "--served-alias", "--model-tenants",
    "--tenant-rps", "--tenant-tps", "--tenant-burst-s", "--tenant-quotas",
    "--pool-scale-to-zero-idle-s", "--pool-cold-start-deadline-s",
    "--pool-cooldown-s", "--router-staleness-bound-s", "--metrics-port",
)


def parse_io(args: List[str]):
    src, engine = "http", "echo_full"
    rest = []
    for a in args:
        if a.startswith("in="):
            src = a[3:]
        elif a.startswith("out="):
            engine = a[4:]
        else:
            rest.append(a)
    return src, engine, rest


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dynamo_tpu_torch run", add_help=True)
    p.add_argument("--model-path", default=None,
                   help="HF snapshot dir or a .gguf file")
    p.add_argument("--model-name", default=None, help="served model name")
    p.add_argument("--http-host", default="0.0.0.0")
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--device", default="cuda",
                   help="the engine's device: cuda (the default; raises "
                        "without a card) or cpu")
    p.add_argument("--kv-block-size", type=int, default=16)
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--max-model-len", type=int, default=None)
    p.add_argument("--extra-engine-args", default=None,
                   help="JSON file of ModelConfig / EngineConfig fields")
    p.add_argument("--decode-pipeline-depth", type=int, default=1,
                   help="2 = dispatch-ahead and chained decode loop")
    p.add_argument("--quantization", choices=["int8"], default=None)
    p.add_argument("--kv-cache-dtype", choices=["auto", "fp8"],
                   default="auto",
                   help="paged KV cache storage dtype: fp8 (e4m3, no scale) "
                        "halves the decode KV stream and doubles cache "
                        "capacity")
    p.add_argument("--num-kv-blocks", type=int, default=2048)
    p.add_argument("--allow-random-weights", action="store_true",
                   help="serve seeded random weights from a model directory "
                        "without a checkpoint")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def parse_flags(rest: List[str]):
    for a in rest:
        name = a.split("=", 1)[0]
        if name in REFUSED_FLAGS:
            raise SystemExit(
                f"{name} is not served by the PyTorch port's CLI (an engine "
                "field goes through --extra-engine-args)")
    return build_parser().parse_args(rest)


def load_mdc(flags):
    from ..llm.model_card import ModelDeploymentCard

    if not flags.model_path:
        raise SystemExit("this mode requires --model-path")
    if flags.model_path.endswith(".gguf"):
        from ..llm.gguf import mdc_from_gguf

        return mdc_from_gguf(flags.model_path, flags.model_name,
                             kv_block_size=flags.kv_block_size)
    return ModelDeploymentCard.from_local_path(
        flags.model_path, flags.model_name, kv_block_size=flags.kv_block_size
    )


async def build_core_engine(engine_spec: str, flags, mdc):
    """Token-level engine (PreprocessedRequest → EngineOutput stream)."""
    if engine_spec == "echo_core":
        from ..llm.engines.echo import EchoEngineCore

        return EchoEngineCore()
    if engine_spec == "torch":
        from ..engine.serving import TorchServingEngine

        return await TorchServingEngine.create(
            mdc=mdc, flags=flags, device=flags.device)
    raise SystemExit(f"unknown core engine {engine_spec!r}")


async def build_engine(engine_spec: str, flags):
    """Returns (openai_engine, mdc_or_None). The engine accepts
    ChatCompletionRequest/CompletionRequest contexts and yields chunks."""
    if engine_spec not in ENGINES:
        raise SystemExit(
            f"out={engine_spec} is not served by the PyTorch port (served: "
            f"{', '.join(ENGINES)})")
    if engine_spec == "echo_full":
        from ..llm.engines.echo import EchoEngineFull

        return EchoEngineFull(), None
    from ..llm.backend import Backend
    from ..llm.preprocessor import OpenAIPreprocessor
    from ..llm.tokenizer import HFTokenizer
    from ..runtime.pipeline import build_pipeline

    mdc = load_mdc(flags)
    tokenizer = HFTokenizer.from_model_path(flags.model_path)
    core = await build_core_engine(engine_spec, flags, mdc)
    pipe = build_pipeline(
        [OpenAIPreprocessor(mdc, tokenizer), Backend(tokenizer)], core
    )
    pipe.core_engine = core
    if hasattr(core, "metrics"):
        # surfaced on /metrics as dynamo_engine_* gauges (run_http)
        pipe.engine_metrics = core.metrics
    return pipe, mdc


async def run_http(flags, engine, mdc) -> None:
    """Serve until SIGINT / SIGTERM: the first drains in-flight requests
    (up to ``GRACEFUL_SHUTDOWN_S``), a second exits at once."""
    from ..http.service import HttpService, ModelManager

    manager = ModelManager()
    name = flags.model_name or (mdc.display_name if mdc else "echo")
    manager.add_chat_model(name, engine)
    if mdc is not None:  # pipeline engines dispatch chat AND completions
        manager.add_completion_model(name, engine)
    manager.set_metadata(
        name,
        model_type="both" if mdc is not None else "chat",
        max_model_len=mdc.context_length if mdc is not None else None,
    )
    service = HttpService(manager, flags.http_host, flags.http_port)
    if hasattr(engine, "engine_metrics"):
        service.metrics.register_callback_gauges(
            "dynamo_engine", engine.engine_metrics)
    await service.start()
    print(f"listening on http://{flags.http_host}:{service.port}", flush=True)
    stop_event = asyncio.Event()
    force_event = asyncio.Event()
    loop = asyncio.get_running_loop()

    def _on_signal():
        # first signal: drain; second: skip the drain and exit now
        if stop_event.is_set():
            force_event.set()
        stop_event.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, _on_signal)
        except (NotImplementedError, RuntimeError):
            pass
    try:
        await stop_event.wait()
        await service.stop_accepting()
        deadline = loop.time() + GRACEFUL_SHUTDOWN_S
        while (service.metrics.inflight_total() > 0
               and loop.time() < deadline and not force_event.is_set()):
            await asyncio.sleep(0.1)
    finally:
        await service.stop()
        await engine.close()


async def run_text(flags, engine, mdc) -> None:
    from ..protocols.annotated import Annotated
    from ..protocols.openai import ChatCompletionRequest
    from ..runtime.engine import Context

    name = flags.model_name or (mdc.display_name if mdc else "echo")
    loop = asyncio.get_running_loop()
    try:
        while True:
            try:
                line = await loop.run_in_executor(None, lambda: input("> "))
            except (EOFError, KeyboardInterrupt):
                return
            if not line.strip():
                continue
            req = ChatCompletionRequest(
                model=name, messages=[{"role": "user", "content": line}],
                stream=True)
            async for chunk in engine.generate(Context(req)):
                if Annotated.maybe_from_wire(chunk) is not None:
                    continue  # annotation envelopes carry no printable text
                d = (chunk if isinstance(chunk, dict)
                     else chunk.model_dump(exclude_none=True))
                for choice in d.get("choices", []):
                    content = (choice.get("delta") or {}).get("content")
                    if content:
                        print(content, end="", flush=True)
            print()
    finally:
        await engine.close()


async def amain(argv: List[str]) -> None:
    src, engine_spec, rest = parse_io(argv)
    flags = parse_flags(rest)
    logging.basicConfig(
        level=logging.DEBUG if flags.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if src not in INPUTS:
        raise SystemExit(
            f"in={src} is not served by the PyTorch port (served: "
            f"{', '.join(INPUTS)})")
    engine, mdc = await build_engine(engine_spec, flags)
    if src == "http":
        await run_http(flags, engine, mdc)
    else:
        await run_text(flags, engine, mdc)


def main() -> None:
    try:
        asyncio.run(amain(sys.argv[1:]))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
