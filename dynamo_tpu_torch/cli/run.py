"""serve CLI: ``python3 -m dynamo_tpu_torch.cli.run in=<src> out=<engine> [flags]``.

The port's copy of ``dynamo_tpu/cli/run.py``. One process serving the
OpenAI front: ``in=http`` (the HTTP service), ``in=text`` or ``in=stdin``
(prompts read from stdin) or ``in=batch:<file.jsonl>`` (one JSON record a
request on stdout, TTFT, the gaps and token counts, the summary on stderr:
``cli/batch.py``) over ``out=torch`` (``TorchServingEngine`` behind the
preprocessor and the detokenizing backend), ``out=echo_core`` (the same
stages over the token echo engine), ``out=echo_full`` (the OpenAI-level
echo), ``out=pystr:<file.py>`` (a user's OpenAI-level engine) or
``out=pytok:<file.py>`` (a user's token-level engine behind the
preprocessor and backend; ``llm/engines/python_file.py``). The engine runs
on the card unless ``--device cpu`` asks for the CPU; without a card the
default raises, it does not fall back. A ``--model-path`` that is no local
directory or ``.gguf`` file goes to ``models/hub.resolve_model_path``.

The supervised engine child: ``--isolate-engine`` hosts ``out=torch``
(the ``@torch`` engine, built in the child from this process's flags),
``pystr:`` or ``pytok:`` in a child process
(``llm/engines/subprocess_host.py``): heartbeats every
``--engine-heartbeat-s`` (a child that misses ``--engine-heartbeat-misses``
pongs is killed), an init deadline of ``--engine-init-timeout-s``, in-flight
requests failed cleanly when the child dies, and a respawn on the next
request or, with ``--self-heal``, at once through the recovery ladder
(``POST /admin/drain?respawn=1`` restarts a live child). This process
never opens the card then; the child does. ``--remote-prefill`` is refused
with it (the coordinator needs the runner in process), as in the
reference.

The distributed inference graph, over a dynstore broker (``python3 -m
dynamo_tpu_torch.runtime.transports.dynstore --port P``, then
``--store-port P`` on every role):

- ``in=dyn://ns.comp.ep out=torch``: an OpenAI-level worker (preprocess,
  engine and detokenize here), registered as a model;
- ``in=dyn://ns.comp.ep out=torch --token-level``: an engine worker
  serving token-level requests, publishing its KV events and serving its
  load (``ForwardPassMetrics``) on its stats scrape;
- ``in=dyn://ns.comp.ep out=processor --worker-endpoint dyn://...
  --router-mode {round_robin,random,kv}``: preprocess here, route to the
  token-level workers (``kv``: by the KV-aware router), detokenize here;
  registered as a model;
- ``in=http out=none``: a pure frontend whose models come from the
  discovery plane (``ModelWatcher``).

Disaggregated prefill and decode: a token-level worker started with
``--remote-prefill`` sends prompts whose uncached part exceeds
``--max-local-prefill-length`` (live-tunable: ``DisaggRouter``'s discovery
key) through the namespace's prefill queue while it holds fewer than
``--max-prefill-queue-size`` items; ``in=prefill out=torch`` runs a prefill
worker that computes them and streams their KV blocks back over TCP
(``--kv-transfer tcp``, the one transfer the port serves).

The KV tiers and the cluster KV fabric: ``--host-kv-blocks`` offloads
evicted HBM blocks to a pinned host slab, ``--cold-tier-dir`` /
``--cold-tier-blocks`` spill the host tier's evictions to checksummed
files any worker sharing the directory rehydrates, and a ``--token-level``
worker started with ``--prefix-pull`` serves its blocks to peers (its pull
server registers under ``kv/fabric.fabric_key``) and pulls a prefix a peer
holds instead of recomputing it (its ownership view rides the component's
KV event stream).

Self-healing serving: ``--self-heal`` on an ``out=torch`` engine (``in=http``
or a ``--token-level`` worker) builds a recovery controller and a migration
receiver (``--migrate-port``). A stall-watchdog trip (``--watchdog-stall-s``)
or ``POST /admin/drain`` drains the engine (``--drain-grace-s``) and
live-migrates its requests to a peer (``--migrate-peers host:port,...``, or
the component's migration prefix in discovery) over tcp, with a respawn
ladder (``--respawn-max``, ``--respawn-backoff-s``). Flight artifacts go to
``--flight-dir`` (or DYN_FLIGHT_DIR) on a trip and on SIGUSR2.

Telemetry: ``--trace-capacity`` / ``--trace-ttl-s`` bound the front's
completed-trace store (``/debug/requests``, ``/debug/trace/{id}``);
``--slo-ttft-ms`` / ``--slo-itl-ms`` judge each request at the edge
(``dynamo_slo_*``); ``--profile-dir`` serves ``GET /debug/profile`` (a
``torch.profiler`` capture); ``--metrics-port`` starts a /metrics sidecar on
a processor, a token-level worker or a prefill worker, advertised in
discovery for a fleet hub; ``--hub`` (``--hub-interval-s``,
``--hub-target role=url``) scrapes the fleet into ``/fleet/metrics`` and
``/fleet/workers``; ``--incident-dir`` (or DYN_INCIDENT_DIR,
``--incident-cooldown-s``, ``--incident-profile-s``) captures an incident
bundle on a watchdog trip, a recovery drain, an SLO floor breach or a burst
of late first dispatches, listed at ``GET /debug/incidents``.

The fleet controls at the HTTP edge: ``--admission-limit`` (with
``--admission-queue-depth``, ``--admission-queue-timeout-s``) admits by
``X-Priority`` class into a bounded concurrency limit; ``--tenant-rps``,
``--tenant-tps``, ``--tenant-burst-s`` and ``--tenant-quotas FILE.json``
give each ``X-Tenant`` its token buckets; a front with ``--store-port``
serves ``/admin/models`` (``RegistryAdmin``) and, with
``--pool-scale-to-zero-idle-s`` (``--pool-cold-start-deadline-s``,
``--pool-cooldown-s``), gates a cold model's requests on its pool and
answers ``/admin/pools``. A processor or OpenAI-level worker publishes its
model card with ``--served-alias`` (repeatable) and ``--model-tenants``.

The closed-loop SLA planner (``planner/``): ``in=http --planner``
(``--planner-interval-s``, ``--planner-min-replicas``,
``--planner-max-replicas``, ``--planner-cooldown-s``) runs the planner in
the front, fed by its admission snapshot, its SLO tracker, an in-process
engine's load and the hub's fleet signals, and actuating the admission
shed level; ``in=planner --worker-endpoint dyn://... --store-port P``
runs it as a role of its own over the workers' scraped load and the
prefill queue's depth, actuating the disagg router's thresholds through
discovery and, with ``--api-store-url`` and ``--planner-deployment``, the
per-role replica counts of that api-store record (the operator,
``python3 -m dynamo_tpu_torch.deploy.operator_main``, applies them). A
front given both also writes a cold pool's ``pool-<slug>`` replicas into
the record (``registry.StorePoolBackend``). ``in=hub`` serves a
stand-alone fleet hub (``/metrics``, ``/fleet/metrics``,
``/fleet/workers``, ``/debug/incidents``) over ``--hub-target`` and the
discovery-registered sidecars of ``--namespace``.

Every other input, output and reference flag is refused by name
(``--profiler-port`` with its reason: torch has no profiler server; the
multi-card flags wait for the multi-card slice).
``cli/llmctl.py`` registers models for a front and manages the api-store's
deployment records (``llmctl deploy``); ``cli/metrics.py`` is the
namespace metrics aggregator.

A ``--model-path`` directory holding a safetensors checkpoint, or a
``.gguf`` file, is loaded (``models/loader.py``); a directory without one
serves seeded random weights only with ``--allow-random-weights``.

Examples:
  python3 -m dynamo_tpu_torch.cli.run in=http out=torch --model-path <dir> \\
      --http-port 8080
  python3 -m dynamo_tpu_torch.cli.run in=http out=torch --model-path m.gguf
  python3 -m dynamo_tpu_torch.cli.run in=http out=torch --model-path <dir> \\
      --allow-random-weights --device cpu --extra-engine-args f32.json
  python3 -m dynamo_tpu_torch.cli.run in=http out=torch --model-path <dir> \\
      --allow-random-weights --kv-cache-dtype fp8
  python3 -m dynamo_tpu_torch.cli.run in=http out=torch --model-path <dir> \\
      --self-heal --migrate-port 8391 --migrate-peers 10.0.0.2:8391
  python3 -m dynamo_tpu_torch.cli.run in=http out=torch --model-path <dir> \\
      --isolate-engine --self-heal
  python3 -m dynamo_tpu_torch.cli.run in=batch:prompts.jsonl out=torch \\
      --model-path <dir> --isolate-engine
  python3 -m dynamo_tpu_torch.cli.run in=http out=pystr:engine.py
  python3 -m dynamo_tpu_torch.cli.run in=dyn://public.backend.generate \\
      out=torch --token-level --model-path <dir> --store-port 4871
  python3 -m dynamo_tpu_torch.cli.run in=dyn://public.processor.chat \\
      out=processor --worker-endpoint dyn://public.backend.generate \\
      --router-mode kv --model-path <dir> --store-port 4871
  python3 -m dynamo_tpu_torch.cli.run in=http out=none --store-port 4871
  python3 -m dynamo_tpu_torch.cli.run in=dyn://public.backend.generate \\
      out=torch --token-level --remote-prefill --model-path <dir> \\
      --store-port 4871
  python3 -m dynamo_tpu_torch.cli.run in=prefill out=torch \\
      --model-path <dir> --store-port 4871
  python3 -m dynamo_tpu_torch.cli.run in=planner \\
      --worker-endpoint dyn://public.backend.generate --store-port 4871 \\
      --api-store-url http://127.0.0.1:8790 --planner-deployment graph
  python3 -m dynamo_tpu_torch.cli.run in=hub --store-port 4871 --http-port 9100
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys
from typing import List

logger = logging.getLogger(__name__)

# and batch:<file>, and the roles dyn://ns.comp.ep, prefill and planner
INPUTS = ("http", "text", "stdin", "hub")
# and the Python-file engines pystr:<file> and pytok:<file>
ENGINES = ("torch", "echo_core", "echo_full", "none", "processor")
PY_ENGINES = ("pystr:", "pytok:")
ROUTER_MODES = ("round_robin", "random", "kv")

# the reference's flags this CLI does not take (each raises by name):
# multi-device, the ici transfer plane and the jax profiler server are not
# ported
REFUSED_FLAGS = (
    "--tensor-parallel-size", "--expert-parallel-size",
    "--data-parallel-size", "--pipeline-parallel-size",
    "--ici-sender-rank", "--ici-receiver-rank", "--num-nodes", "--node-rank",
    "--leader-addr", "--profiler-port",
)
# why a refused flag is refused (the others wait for their slice)
REFUSED_WHY = {
    "--profiler-port": (
        "the reference's flag starts jax's profiler gRPC server "
        "(utils/profiling.enable_profiler_server) and torch has no "
        "counterpart; capture a trace with --profile-dir and GET "
        "/debug/profile instead"),
}


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
    # the engine's decode knobs, as the reference's parser names them
    p.add_argument("--multi-step-decode", type=int, default=1,
                   help="decode steps fused per device dispatch (tokens "
                        "stream in bursts of K; 1 = per-token)")
    p.add_argument("--device-finish", choices=["auto", "on", "off"],
                   default="auto",
                   help="device-resident finish detection: bursts chain back "
                        "to back and finished rows freeze on the device. "
                        "auto = follow --decode-pipeline-depth >= 2")
    p.add_argument("--fused-epilogue", choices=["auto", "on", "off"],
                   default="auto",
                   help="the fused sampling epilogue kernel: auto = on a "
                        "card, the unfused tail on the CPU")
    p.add_argument("--guided-table-max-states", type=int, default=256,
                   help="state bound for compiling guided grammars to device "
                        "transition tables (larger ones keep the host path, "
                        "counted in sync_fallback)")
    p.add_argument("--no-guided-device-table", action="store_true",
                   help="guided rows keep the per-token host mask path")
    p.add_argument("--no-device-stop-strings", action="store_true",
                   help="stop-string rows keep the per-burst sync path")
    p.add_argument("--spec-ngram-tokens", type=int, default=0,
                   help="ngram speculative decoding: propose up to K tokens "
                        "per step from the context's own history (greedy "
                        "requests; 0 = off)")
    p.add_argument("--spec-ngram-match", type=int, default=3,
                   help="trailing n-gram length the proposer looks up")
    p.add_argument("--spec-draft-model", default=None,
                   help="draft-model speculative decoding: HF dir of a "
                        "small same-tokenizer model that proposes "
                        "--spec-draft-tokens per round (one burst) for the "
                        "target to verify in one forward")
    p.add_argument("--spec-draft-tokens", type=int, default=0,
                   help="proposals per draft round (2..16)")
    p.add_argument("--sequence-parallel-size", type=int, default=1,
                   help="sequence-parallel ranks of the long-prompt prefill "
                        "ladder (laid out on the one card)")
    p.add_argument("--quantization", choices=["int8"], default=None)
    p.add_argument("--kv-cache-dtype", choices=["auto", "fp8"],
                   default="auto",
                   help="paged KV cache storage dtype: fp8 (e4m3, no scale) "
                        "halves the decode KV stream and doubles cache "
                        "capacity")
    p.add_argument("--num-kv-blocks", type=int, default=2048)
    # the supervised engine child (llm/engines/subprocess_host.py)
    p.add_argument("--isolate-engine", action="store_true",
                   help="host the engine (out=torch, pystr:, pytok:) in a "
                        "supervised subprocess (heartbeat + respawn; a dead "
                        "or wedged engine fails its requests instead of the "
                        "whole worker)")
    p.add_argument("--engine-heartbeat-s", type=float, default=5.0,
                   help="isolated-engine heartbeat interval; the child's event "
                        "loop must answer within heartbeat x misses")
    p.add_argument("--engine-heartbeat-misses", type=int, default=6,
                   help="consecutive missed pongs before the isolated engine "
                        "is killed as wedged")
    p.add_argument("--engine-init-timeout-s", type=float, default=120.0,
                   help="isolated-engine spawn + initialize() deadline (a "
                        "first start on a fresh tree builds the kernels "
                        "inside it)")
    p.add_argument("--allow-random-weights", action="store_true",
                   help="serve seeded random weights from a model directory "
                        "without a checkpoint")
    # the distributed graph (in=dyn://..., out=processor, out=none)
    p.add_argument("--store-host", default="127.0.0.1", help="dynstore host")
    p.add_argument("--store-port", type=int, default=None,
                   help="dynstore port (distributed mode)")
    p.add_argument("--namespace", default="public")
    p.add_argument("--router-mode", choices=ROUTER_MODES,
                   default="round_robin",
                   help="how a processor (or a pure frontend) picks a worker: "
                        "kv = the KV-aware router")
    p.add_argument("--token-level", action="store_true",
                   help="in=dyn:// worker serving token-level requests "
                        "(publishes KV events and load metrics)")
    p.add_argument("--worker-endpoint", default=None,
                   help="dyn://ns.comp.ep of token-level workers (processor role)")
    p.add_argument("--router-staleness-bound-s", type=float, default=0.0,
                   help="the KV router skips a worker whose scraped load is "
                        "older than this (0 = off)")
    # disaggregated prefill and decode (--token-level decode workers and
    # in=prefill prefill workers)
    p.add_argument("--remote-prefill", action="store_true",
                   help="decode worker: send long prefills to the prefill queue")
    p.add_argument("--max-local-prefill-length", type=int, default=1000,
                   help="uncached prompt tokens above this go remote")
    p.add_argument("--max-prefill-queue-size", type=int, default=2,
                   help="prefill locally while the queue is this deep")
    p.add_argument("--advertise-host", default="127.0.0.1",
                   help="host other workers use to reach this worker's KV "
                        "transfer server")
    p.add_argument("--kv-transfer", default="tcp",
                   help="KV block payload path: tcp (through host memory); "
                        "ici is not ported")
    p.add_argument("--disagg-stream-depth", type=int, default=2,
                   help="prefill worker: KV frames in flight (2 overlaps a "
                        "frame's copy with the previous one's write)")
    p.add_argument("--long-prefill-threshold-tokens", type=int, default=0,
                   help="admission class: prompts whose uncached suffix is "
                        "at least this long take the SP ladder or, on a "
                        "--remote-prefill worker, prefer the prefill pool")
    # the KV tiers and the cluster KV fabric (kv/)
    p.add_argument("--host-kv-blocks", type=int, default=0,
                   help="host-RAM KV offload tier capacity in blocks (0 = off)")
    p.add_argument("--prefix-pull", action="store_true",
                   help="cluster KV fabric: on a prefix another worker holds "
                        "(learned from the component's KV event stream), PULL "
                        "its committed KV blocks over the transfer plane "
                        "instead of recomputing them; a failed pull falls back "
                        "to a local recompute with the same stream")
    p.add_argument("--prefix-pull-min-blocks", type=int, default=2,
                   help="minimum remote or cold extension (blocks past the "
                        "local hit) worth a pull")
    p.add_argument("--prefix-pull-timeout-s", type=float, default=30.0,
                   help="per-pull deadline before the local-recompute "
                        "fallback takes over")
    p.add_argument("--cold-tier-dir", default="",
                   help="content-addressed cold KV tier: spill host-tier-"
                        "evicted blocks to checksummed files in this directory "
                        "(any worker sharing it, a respawned one included, "
                        "rehydrates them); requires --host-kv-blocks > 0")
    p.add_argument("--cold-tier-blocks", type=int, default=0,
                   help="cold-tier capacity in blocks (0 = off; set together "
                        "with --cold-tier-dir)")
    # HTTP-edge admission control (planner/admission.py)
    p.add_argument("--admission-limit", type=int, default=0,
                   help="HTTP-edge admission control: max concurrently "
                        "admitted requests; overflow queues per priority "
                        "class (X-Priority: high|normal|low), dequeued "
                        "highest-first, shed with 429 + Retry-After on "
                        "saturation or deadline (0 = admission off)")
    p.add_argument("--admission-queue-depth", type=int, default=64,
                   help="per-priority-class admission queue bound")
    p.add_argument("--admission-queue-timeout-s", type=float, default=10.0,
                   help="queue-wait deadline before a queued request is "
                        "shed with 429")
    # the closed-loop SLA planner (planner/) and its api-store record
    p.add_argument("--planner", action="store_true",
                   help="in=http: run an in-process planner loop that "
                        "tightens/relaxes admission (and the disagg "
                        "split) from the engine's own load signals")
    p.add_argument("--planner-interval-s", type=float, default=2.0,
                   help="planner observe→decide→actuate cadence")
    p.add_argument("--planner-min-replicas", type=int, default=1)
    p.add_argument("--planner-max-replicas", type=int, default=8)
    p.add_argument("--planner-cooldown-s", type=float, default=30.0,
                   help="scale-up cooldown per role (scale-down waits "
                        "4x this)")
    p.add_argument("--planner-deployment", default=None,
                   help="in=planner: api-store deployment record whose "
                        "per-role replica counts the planner patches "
                        "(the operator applies them via --api-store-url); "
                        "in=http: the record a cold pool's replicas go to")
    p.add_argument("--api-store-url", default=None,
                   help="in=planner: api-store base URL for replica "
                        "actuation; in=http: with --planner-deployment, "
                        "the cold pools' spawner")
    # the multi-model multi-tenant fleet (registry/)
    p.add_argument("--served-alias", action="append", default=None,
                   metavar="ALIAS",
                   help="extra name this model answers to (repeatable); "
                        "rides the model card workers publish at startup, "
                        "resolved by registry-aware frontends")
    p.add_argument("--model-tenants", default=None,
                   help="comma-separated tenant allow list for this model's "
                        "card (unset = public; tenant-scoped models are "
                        "invisible — 404 — to other tenants)")
    p.add_argument("--tenant-rps", type=float, default=0.0,
                   help="per-tenant requests/s token bucket (X-Tenant header; "
                        "unknown/garbage degrades to the 'default' tenant; "
                        "0 = unlimited). Exceeding tenants are shed with 429 "
                        "+ Retry-After while other tenants are untouched")
    p.add_argument("--tenant-tps", type=float, default=0.0,
                   help="per-tenant streamed-tokens/s token bucket (charged "
                        "by actual streamed tokens; overdraft delays the "
                        "tenant's next admission; 0 = unlimited)")
    p.add_argument("--tenant-burst-s", type=float, default=2.0,
                   help="token-bucket capacity in seconds of rate")
    p.add_argument("--tenant-quotas", default=None, metavar="FILE.json",
                   help="per-tenant overrides: {tenant: {requests_per_s, "
                        "tokens_per_s, burst_s}}")
    p.add_argument("--pool-scale-to-zero-idle-s", type=float, default=0.0,
                   help="drain a model's pool to zero replicas after this "
                        "long without a request (0 = off); the next request "
                        "for the cold model waits for a worker to join")
    p.add_argument("--pool-cold-start-deadline-s", type=float, default=30.0,
                   help="how long a request for a cold model waits for a "
                        "worker to join the pool before shedding with 503 + "
                        "Retry-After")
    p.add_argument("--pool-cooldown-s", type=float, default=30.0,
                   help="per-model pool action pacing (scale-to-zero / "
                        "cold-start decisions)")
    # the flight recorder and the stall watchdog (telemetry/)
    p.add_argument("--flight-dir", default="",
                   help="directory for flight artifacts (watchdog trips, "
                        "SIGUSR2); also settable via DYN_FLIGHT_DIR")
    p.add_argument("--watchdog-stall-s", type=float, default=None,
                   help="stall-watchdog deadline: trip (and dump a flight "
                        "artifact) when the engine has pending work but its "
                        "loop heartbeat or dispatch counter has been stale "
                        "this long (default 30; 0 = off)")
    # self-healing serving (recovery/): trip → drain → migrate → respawn
    p.add_argument("--self-heal", action="store_true",
                   help="automated recovery: watchdog trips drive drain → "
                        "live request migration to a healthy peer → respawn; "
                        "also enables POST /admin/drain for zero-downtime "
                        "rolling updates")
    p.add_argument("--drain-grace-s", type=float, default=5.0,
                   help="soft-drain grace: how long committed work may "
                        "finish on its own before migration starts")
    p.add_argument("--respawn-max", type=int, default=3,
                   help="consecutive failed respawns before the recovery "
                        "controller gives up")
    p.add_argument("--respawn-backoff-s", type=float, default=1.0,
                   help="respawn backoff base (doubles per consecutive "
                        "failure)")
    p.add_argument("--migrate-peers", default="",
                   help="comma-separated host:port list of peer migration "
                        "receivers (in=dyn:// workers discover peers through "
                        "the discovery plane instead)")
    p.add_argument("--migrate-port", type=int, default=0,
                   help="port of this worker's inbound-migration receiver "
                        "(0 = ephemeral; started only with --self-heal on a "
                        "torch engine)")
    # telemetry (telemetry/, utils/profiling.py)
    p.add_argument("--trace-capacity", type=int, default=None,
                   help="completed-trace store bound in entries (LRU; default "
                        "DYN_TRACE_CAPACITY or 512)")
    p.add_argument("--trace-ttl-s", type=float, default=None,
                   help="completed-trace age bound in seconds (0 = no age "
                        "bound; default DYN_TRACE_TTL_S or 600)")
    p.add_argument("--slo-ttft-ms", type=float, default=0.0,
                   help="time-to-first-token SLO target: per-request "
                        "attainment and goodput on /metrics (0 = unjudged)")
    p.add_argument("--slo-itl-ms", type=float, default=0.0,
                   help="inter-token latency SLO target, judged on each "
                        "request's worst gap (0 = unjudged)")
    p.add_argument("--profile-dir", default="",
                   help="serve GET /debug/profile?seconds=N: a torch.profiler "
                        "capture (CPU and CUDA activity) into this directory")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="a /metrics sidecar on a processor, token-level worker "
                        "or prefill worker (0 = off); advertised in discovery "
                        "for a fleet hub")
    p.add_argument("--hub", action="store_true",
                   help="run a fleet telemetry hub in this frontend: scrape "
                        "--hub-target and the discovery-registered metrics "
                        "sidecars, serve /fleet/metrics and /fleet/workers")
    p.add_argument("--hub-interval-s", type=float, default=2.0,
                   help="hub scrape cadence")
    p.add_argument("--hub-target", action="append", default=None,
                   help="a static hub target, role=url (repeatable); the url "
                        "gains /metrics when it lacks it")
    p.add_argument("--incident-dir", default="",
                   help="capture incident bundles into this directory (also "
                        "DYN_INCIDENT_DIR): on a watchdog trip, a recovery "
                        "drain, an SLO floor breach or a late-dispatch burst; "
                        "listed at GET /debug/incidents")
    p.add_argument("--incident-cooldown-s", type=float, default=60.0,
                   help="per-reason incident capture cooldown")
    p.add_argument("--incident-profile-s", type=float, default=0.0,
                   help="include a torch.profiler window of this many seconds "
                        "in each incident bundle (skipped while another "
                        "capture is in flight)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def parse_flags(rest: List[str]):
    for a in rest:
        name = a.split("=", 1)[0]
        if name in REFUSED_FLAGS:
            raise SystemExit(
                f"{name} is not served by the PyTorch port's CLI ("
                + REFUSED_WHY.get(name, "an engine field goes through "
                                        "--extra-engine-args") + ")")
    flags = build_parser().parse_args(rest)
    if flags.kv_transfer != "tcp":
        raise SystemExit(
            f"--kv-transfer {flags.kv_transfer} is not served by the PyTorch "
            "port (served: tcp; the ici collective plane is not ported)")
    if flags.isolate_engine and flags.remote_prefill:
        raise SystemExit(
            "--isolate-engine is incompatible with --remote-prefill: the "
            "disagg coordinator needs in-process access to the runner's KV "
            "cache")
    return flags


def load_mdc(flags):
    from ..llm.model_card import ModelDeploymentCard
    from ..models.hub import resolve_model_path

    if not flags.model_path:
        raise SystemExit("this mode requires --model-path")
    # a hub id is taken wherever a path is; a local path passes through
    flags.model_path = resolve_model_path(flags.model_path)
    if flags.model_path.endswith(".gguf"):
        from ..llm.gguf import mdc_from_gguf

        return mdc_from_gguf(flags.model_path, flags.model_name,
                             kv_block_size=flags.kv_block_size)
    return ModelDeploymentCard.from_local_path(
        flags.model_path, flags.model_name, kv_block_size=flags.kv_block_size
    )


def _supervision(flags) -> dict:
    """The supervised child's heartbeat and init deadline, from the flags."""
    return dict(heartbeat_interval_s=flags.engine_heartbeat_s,
                heartbeat_misses=flags.engine_heartbeat_misses,
                init_timeout_s=flags.engine_init_timeout_s)


def wire_flags(flags) -> dict:
    """The flag namespace as the plain dict a ``@torch`` child is built
    from, with ``isolate_engine`` cleared (the child spawns no child)."""
    wire = {k: v for k, v in vars(flags).items()
            if v is None or isinstance(v, (str, int, float, bool, list, dict))}
    wire["isolate_engine"] = False
    return wire


async def _load_python_engine(path: str, flags):
    """A Python-file engine, in process or (``--isolate-engine``) hosted in
    a supervised child with heartbeats and respawn."""
    from ..engine.serving import load_extra_engine_args

    if flags.isolate_engine:
        from ..llm.engines.subprocess_host import SubprocessEngine

        return await SubprocessEngine.load(
            path, load_extra_engine_args(flags), **_supervision(flags))
    from ..llm.engines.python_file import PythonFileEngine

    return await PythonFileEngine.load(path, load_extra_engine_args(flags))


async def build_core_engine(engine_spec: str, flags, mdc, events=None,
                            disagg_factory=None):
    """Token-level engine (PreprocessedRequest → EngineOutput stream).
    ``events`` receives the allocator's KV events (a hosted child's replay
    through the host); ``disagg_factory`` turns on remote prefill."""
    if engine_spec == "echo_core":
        from ..llm.engines.echo import EchoEngineCore

        return EchoEngineCore()
    if engine_spec.startswith("pytok:"):
        return await _load_python_engine(engine_spec[len("pytok:"):], flags)
    if engine_spec == "torch":
        if flags.isolate_engine:
            # the engine in a supervised child: heartbeats catch a wedged
            # loop, a dead child fails its requests cleanly, and the next
            # request (or the recovery ladder) respawns it
            from ..llm.engines.subprocess_host import (
                TORCH_ENGINE,
                SubprocessEngine,
            )

            return await SubprocessEngine.load(
                TORCH_ENGINE, {"flags": wire_flags(flags)}, events=events,
                **_supervision(flags))
        from ..engine.serving import TorchServingEngine

        return await TorchServingEngine.create(
            mdc=mdc, flags=flags, device=flags.device, events=events,
            disagg_factory=disagg_factory)
    raise SystemExit(f"unknown core engine {engine_spec!r}")


def _served(engine_spec: str) -> bool:
    return engine_spec in ENGINES or engine_spec.startswith(PY_ENGINES)


def _refuse_output(engine_spec: str) -> None:
    raise SystemExit(
        f"out={engine_spec} is not served by the PyTorch port (served: "
        f"{', '.join(ENGINES)}, pystr:<file>, pytok:<file>)")


async def build_engine(engine_spec: str, flags):
    """Returns (openai_engine, mdc_or_None). The engine accepts
    ChatCompletionRequest/CompletionRequest contexts and yields chunks."""
    if not _served(engine_spec):
        _refuse_output(engine_spec)
    if engine_spec == "none":
        # pure frontend: models come exclusively from the discovery watcher
        return None, None
    if engine_spec.startswith("pystr:"):
        # a user's OpenAI-level engine
        return await _load_python_engine(engine_spec[len("pystr:"):], flags), None
    if engine_spec == "processor":
        raise SystemExit("out=processor is a worker role: give it "
                         "in=dyn://ns.comp.ep")
    if engine_spec == "echo_full":
        from ..llm.embeddings import EchoEmbedder
        from ..llm.engines.echo import EchoEngineFull

        engine = EchoEngineFull()
        # the echo stack serves /v1/embeddings too (hash-seeded vectors)
        engine.embedder = EchoEmbedder()
        return engine, None
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
    if getattr(core, "host_registry", None) is not None:
        # a supervised child's host: the restart counter and the heartbeat
        # gap beside the child's dict gauges
        pipe.host_registry = core.host_registry
    if getattr(core, "registry", None) is not None:
        # the KV tiers' and the fabric's instruments, on the same /metrics
        pipe.engine_registry = core.registry
    if hasattr(core, "metrics"):
        # surfaced on /metrics as dynamo_engine_* gauges (run_http)
        pipe.engine_metrics = core.metrics
    if getattr(core, "embed_ready", False) and hasattr(core, "embed"):
        # /v1/embeddings rides this engine's cacheless embed trunk
        from ..llm.embeddings import Embedder

        pipe.embedder = Embedder(
            tokenizer, core, max_model_len=core.config.max_model_len,
            vocab_size=core.config.model.vocab_size)
    return pipe, mdc


def _build_slo(flags):
    """--slo-ttft-ms / --slo-itl-ms → an SloTracker (None without either)."""
    if flags.slo_ttft_ms <= 0 and flags.slo_itl_ms <= 0:
        return None
    from ..telemetry.slo import SloTracker

    return SloTracker(
        ttft_s=flags.slo_ttft_ms / 1e3 if flags.slo_ttft_ms > 0 else None,
        itl_s=flags.slo_itl_ms / 1e3 if flags.slo_itl_ms > 0 else None)


def _build_hub(flags):
    """--hub → a FleetHub over the static --hub-target list (discovery
    targets attach later, once a DistributedRuntime exists)."""
    if not flags.hub:
        return None
    from ..telemetry.hub import FleetHub, parse_target_flag

    return FleetHub(
        targets=[parse_target_flag(t) for t in (flags.hub_target or [])],
        interval_s=flags.hub_interval_s)


def _model_card(flags, mdc, endpoint_path: str, model_type: str = "both"):
    """The fleet card a worker publishes at startup (registry/cards.py):
    name and pool endpoint, family and context from the deployment card,
    aliases and tenant visibility from the flags."""
    from ..registry.cards import card_from_mdc

    tenants = None
    if flags.model_tenants is not None:
        tenants = [t.strip() for t in flags.model_tenants.split(",")
                   if t.strip()]
    return card_from_mdc(
        mdc, endpoint_path, name=flags.model_name or mdc.display_name,
        model_type=model_type, aliases=flags.served_alias or [],
        tenants=tenants)


def _build_admission(flags):
    """--admission-* → the edge's AdmissionController, or None."""
    if flags.admission_limit <= 0:
        return None
    from ..planner import AdmissionConfig, AdmissionController

    return AdmissionController(AdmissionConfig(
        limit=flags.admission_limit,
        queue_depth=flags.admission_queue_depth,
        queue_timeout_s=flags.admission_queue_timeout_s))


def _build_quotas(flags, admissions_registry=None):
    """--tenant-* → a TenantQuotas gate for the HTTP edge, or None.
    ``admissions_registry`` shares the admission controller's counter
    family, so outcome="quota" rides the same instrument."""
    if (flags.tenant_rps <= 0 and flags.tenant_tps <= 0
            and not flags.tenant_quotas):
        return None
    from ..registry.tenants import TenantQuotas

    quotas = TenantQuotas.from_flags(
        flags.tenant_rps, flags.tenant_tps,
        overrides_path=flags.tenant_quotas, burst_s=flags.tenant_burst_s)
    if admissions_registry is not None:
        quotas.bind_admissions(admissions_registry)
    return quotas


def _build_pools(flags, manager, watcher):
    """The multi-model frontend's pool manager: scale-to-zero for idle
    pools and the cold-start gate for requests that find their pool empty.
    With --api-store-url and --planner-deployment its spawner and drainer
    patch the pool's ``pool-<slug>`` replicas into that api-store record
    (``StorePoolBackend``; the operator reconciles the patch); without a
    backend, a cold request waits out the deadline for a worker started
    elsewhere. None when neither is asked for."""
    from ..registry import (
        PoolConfig,
        PoolManager,
        PoolPolicy,
        PoolPolicyConfig,
        StorePoolBackend,
    )

    backend = None
    if flags.api_store_url and flags.planner_deployment:
        from ..deploy.store_source import ApiStoreClient

        backend = StorePoolBackend(
            ApiStoreClient(flags.api_store_url), flags.planner_deployment)
    if backend is None and flags.pool_scale_to_zero_idle_s <= 0:
        return None
    return PoolManager(
        manager.registry, watcher.pool_size,
        spawner=backend.spawn if backend is not None else None,
        drainer=backend.drain if backend is not None else None,
        config=PoolConfig(
            cold_start_deadline_s=flags.pool_cold_start_deadline_s),
        policy=PoolPolicy(PoolPolicyConfig(
            idle_to_zero_s=flags.pool_scale_to_zero_idle_s,
            cooldown_s=flags.pool_cooldown_s)))


def _planner_policy(flags, **kw):
    """The --planner-* flags → an SlaPolicy (scale-down waits 4x the
    scale-up cooldown, as in the reference)."""
    from ..planner import PolicyConfig, SlaPolicy

    return SlaPolicy(PolicyConfig(
        min_replicas=flags.planner_min_replicas,
        max_replicas=flags.planner_max_replicas,
        scale_up_cooldown_s=flags.planner_cooldown_s,
        scale_down_cooldown_s=flags.planner_cooldown_s * 4), **kw)


def _build_front_planner(flags, engine, admission, slo, hub):
    """--planner on ``in=http``: an in-process planner whose sources are the
    edge's admission snapshot, its SLO tracker, an in-process engine's load
    and the hub's fleet signals, and whose actuator is the edge's admission
    shed level and limit. None without the flag."""
    if not flags.planner:
        return None
    from ..planner import (
        LocalActuator,
        Planner,
        PlannerConfig,
        engine_metrics_source,
        slo_source,
    )

    planner = Planner(_planner_policy(flags),
                      config=PlannerConfig(interval_s=flags.planner_interval_s))
    if admission is not None:
        planner.add_source(admission.snapshot)
        planner.add_actuator(LocalActuator(admission=admission))
    if slo is not None:
        # user-visible latency: the policy sheds on SLO attainment, not on
        # queue proxies alone
        planner.add_source(slo_source(slo))
    if engine is not None and hasattr(engine, "engine_metrics"):
        planner.add_source(engine_metrics_source(engine.engine_metrics))
    if hub is not None:
        # fleet-level saturation: the scraped pool's busy, KV and SLO
        # rollups beside this process's own view
        planner.add_source(hub.signal_source())
    return planner


def _advertise_model(registry, name: str) -> None:
    """Stamp the served model on a registry (the fleet hub's ``model``)."""
    registry.gauge("dynamo_registry_model_info",
                   "Model this process serves, labelled model=").set(
                       1.0, model=name)


async def _setup_incidents(flags, registry=None, watchdog=None,
                           recovery=None, slo=None, compiles=None):
    """DYN_INCIDENT_DIR / --incident-dir → an IncidentRecorder wired to
    every degradation edge this process emits, plus a local history
    sampler so bundles carry the metric curve INTO the incident. Returns
    (recorder, sampler), both None without a directory."""
    from ..telemetry.incidents import (
        IncidentConfig,
        IncidentRecorder,
        incident_dir,
        late_compile_probe,
        slo_probe,
    )

    if not incident_dir():
        return None, None
    from ..telemetry.history import LocalHistorySampler, MetricHistory

    recorder = IncidentRecorder(
        IncidentConfig(cooldown_s=flags.incident_cooldown_s,
                       profile_s=flags.incident_profile_s),
        history=MetricHistory(window_s=600.0))
    if watchdog is not None:
        recorder.watch_watchdog(watchdog)
    if recovery is not None:
        recorder.watch_recovery(recovery)
    if slo is not None:
        recorder.add_probe(slo_probe(slo))
    if compiles is not None:
        recorder.add_probe(late_compile_probe(compiles))
    if flags.incident_profile_s > 0:
        # a bundle's profile window starts on the loop: initialise CUPTI now
        from ..utils.profiling import prepare_profiler

        prepare_profiler()
    sampler = None
    if registry is not None:
        sampler = LocalHistorySampler(registry, history=recorder.history,
                                      interval_s=5.0).start()
    recorder.start()
    return recorder, sampler


async def advertise_sidecar(drt, flags, mserver, role: str,
                            instance: str) -> None:
    """Register a process's /metrics sidecar in discovery so a fleet hub
    finds it without static targets; the lease-scoped key vanishes with the
    worker."""
    if mserver is None:
        return
    from ..telemetry.hub import register_metrics_endpoint

    try:
        await register_metrics_endpoint(
            drt, flags.namespace, role, instance,
            f"http://{flags.advertise_host}:{mserver.port}/metrics")
    except Exception:
        logger.warning("metrics-sidecar discovery registration failed; hub "
                       "scrapes need --hub-target", exc_info=True)


async def run_http(flags, engine, mdc) -> None:
    """Serve until SIGINT / SIGTERM: the first drains in-flight requests
    (up to ``RuntimeSettings.graceful_shutdown_timeout``, 30 s unless the
    runtime settings say otherwise), a second exits at once."""
    from ..http.service import HttpService, ModelManager, ModelWatcher

    manager = ModelManager()
    if engine is not None:
        name = flags.model_name or (mdc.display_name if mdc else "echo")
        manager.add_chat_model(name, engine)
        if mdc is not None:  # pipeline engines dispatch chat AND completions
            manager.add_completion_model(name, engine)
        manager.set_metadata(
            name,
            model_type="both" if mdc is not None else "chat",
            max_model_len=mdc.context_length if mdc is not None else None,
        )
    slo = _build_slo(flags)
    hub = _build_hub(flags)
    admission = _build_admission(flags)
    service = HttpService(
        manager, flags.http_host, flags.http_port,
        profile_dir=flags.profile_dir or None, admission=admission, slo=slo,
        trace_ttl_s=flags.trace_ttl_s, trace_capacity=flags.trace_capacity,
        hub=hub, quotas=_build_quotas(
            flags, admission.registry if admission is not None else None))
    if engine is not None:
        _advertise_model(
            service.metrics.registry,
            flags.model_name or (mdc.display_name if mdc else "echo"))
    if hub is not None:
        # the frontend scrapes ITSELF (the engine's registries attach into
        # the service's, so one local scrape covers every layer of this
        # process) beside the remote targets
        hub.add_local("frontend", "frontend", service.metrics.registry)
    if hasattr(engine, "engine_metrics"):
        service.metrics.register_callback_gauges(
            "dynamo_engine", engine.engine_metrics)
    if getattr(engine, "engine_registry", None) is not None:
        service.metrics.registry.attach(engine.engine_registry)
    if getattr(engine, "host_registry", None) is not None:
        service.metrics.registry.attach(engine.host_registry)
    recovery = migserver = None
    if flags.self_heal and engine is not None:
        recovery, migserver = await _setup_self_healing(
            flags, getattr(engine, "core_engine", engine), admission=admission)
        if recovery is not None:
            recovery.attach()
            service.drainer = recovery.admin_drain
            service.metrics.registry.attach(recovery.registry)
    planner = _build_front_planner(flags, engine, admission, slo, hub)
    if planner is not None:
        service.metrics.attach_registry(planner.registry)
        planner.start()
    # the incident recorder: wired to every degradation edge this process
    # emits (the engine's watchdog, the recovery ladder, the SLO floor,
    # late first dispatches)
    core = getattr(engine, "core_engine", engine) if engine is not None else None
    incidents, inc_sampler = await _setup_incidents(
        flags, registry=service.metrics.registry,
        watchdog=getattr(core, "watchdog", None), recovery=recovery, slo=slo,
        compiles=getattr(getattr(core, "runner", None), "compiles", None))
    if incidents is not None:
        service.incidents = incidents
        service.metrics.registry.attach(incidents.registry)
    watcher = drt = pools = None
    if flags.store_port is not None:
        from ..runtime.client import RouterMode
        from ..runtime.component import DistributedRuntime

        drt = await DistributedRuntime.connect(flags.store_host, flags.store_port)
        if hub is not None:
            # scrape every sidecar the workers registered in discovery, on
            # top of the static targets
            from ..telemetry.hub import discovery_targets

            hub.discover = discovery_targets(drt, flags.namespace)
        # the frontend routes each model's OpenAI-level instances (a
        # processor's, or workers'); "kv" picks round-robin here: a
        # KV-aware pick needs token ids, which only a processor has
        watcher = ModelWatcher(drt, manager, flags.namespace,
                               RouterMode(flags.router_mode))
        await watcher.start()
        # POST/DELETE /admin/models write the records workers publish
        from ..registry.registry import RegistryAdmin

        service.registry_admin = RegistryAdmin(drt, flags.namespace)
        pools = _build_pools(flags, manager, watcher)
        if pools is not None:
            service.attach_pools(pools)
            pools.start(spawn=drt.runtime.spawn)
    elif engine is None:
        raise SystemExit("out=none serves the models it discovers: give it "
                         "--store-port")
    if hub is not None:
        hub.start()
    await service.start()
    print(f"listening on http://{flags.http_host}:{service.port}", flush=True)
    # SIGTERM drains in-flight requests for up to the runtime settings'
    # grace period (DYN_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT, DYN_RUNTIME_*,
    # DYN_CONFIG_PATH and /opt/dynamo/*/runtime.toml, as the reference)
    from ..utils.config import RuntimeSettings

    settings = RuntimeSettings.from_settings()
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
        deadline = loop.time() + settings.graceful_shutdown_timeout
        while (service.metrics.inflight_total() > 0
               and loop.time() < deadline and not force_event.is_set()):
            await asyncio.sleep(0.1)
    finally:
        if planner is not None:
            planner.stop()
        if hub is not None:
            await hub.stop()
        if pools is not None:
            await pools.stop()
        if inc_sampler is not None:
            await inc_sampler.stop()
        if incidents is not None:
            await incidents.stop()
        await service.stop()
        if recovery is not None:
            await recovery.close()
        if migserver is not None:
            await migserver.close()
        if watcher is not None:
            await watcher.stop()
            await drt.close()
        if engine is not None:
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


def _kernel_launches() -> dict:
    """Each kernel wrapper's launch count in this process (its bf16 form's
    where it has an fp8 one, which counts as ``<module>_fp8``; the
    epilogue's ``finish`` and ``extra_bias`` forms as ``epilogue_finish``
    and ``epilogue_extra_bias``)."""
    import importlib

    out = {}
    for name in ("paged_decode", "paged_flash", "paged_verify", "epilogue",
                 "mla_decode", "sp_prefix"):
        mod = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.ops.{name}")
        out[name] = mod.launches
        if hasattr(mod, "launches_fp8"):
            out[f"{name}_fp8"] = mod.launches_fp8
        if hasattr(mod, "launches_finish"):
            out[f"{name}_finish"] = mod.launches_finish
        if hasattr(mod, "launches_extra_bias"):
            out[f"{name}_extra_bias"] = mod.launches_extra_bias
    return out


def _launches_of(engine_spec: str, core):
    """The kernel launch counts a worker's stats report: this process's
    for an in-process torch engine, the child's (``launches_<kernel>`` of
    its last pong) for a supervised one, none otherwise."""
    if engine_spec != "torch":
        return dict
    if hasattr(core, "add_down_listener"):
        return lambda: {k[len("launches_"):]: v
                        for k, v in core.metrics().items()
                        if k.startswith("launches_")}
    return _kernel_launches


def _disagg_factory(flags, drt, component: str):
    """A ``--remote-prefill`` decode worker's coordinator factory (None
    without the flag): the router's thresholds from the flags, live-tunable
    through its discovery key; the transfer server advertised at
    ``--advertise-host``."""
    if not flags.remote_prefill:
        return None

    async def factory(runner):
        from ..disagg import DisaggRouter, RemotePrefillCoordinator

        router = DisaggRouter(
            max_local_prefill_length=flags.max_local_prefill_length,
            max_prefill_queue_size=flags.max_prefill_queue_size,
            model_name=flags.model_name, namespace=flags.namespace)
        return await RemotePrefillCoordinator(
            drt, runner, namespace=flags.namespace, component=component,
            router=router, advertise_host=flags.advertise_host).start()

    return factory


async def _setup_self_healing(flags, core, drt=None, component: str = "backend",
                              peer_ranker=None, instance_id: str = "",
                              admission=None):
    """``--self-heal`` wiring: a RecoveryController for an in-process torch
    engine plus a migration receiver for peers draining TOWARD this worker.
    Returns ``(controller, migration_server)``, both None for an engine with
    nothing to recover (echo). A supervised child (``--isolate-engine``)
    gets the respawn ladder only, driven by its deaths, and no receiver:
    its drain and migration would run inside the child's own stack, as in
    the reference; ``respawn()`` (not a lazy spawn) makes ``POST
    /admin/drain?respawn=1`` restart a LIVE child. On a distributed worker (``drt``) the
    receiver's descriptor is registered lease-scoped under the component's
    migration prefix (packed with the runtime's wire codec), peers are
    discovered there, and the drain's deregister / register hooks remove and
    restore it. ``admission`` (the edge's AdmissionController) closes beside
    the scheduler on a drain and reopens on a successful respawn."""
    import uuid

    from ..recovery import (
        MigrationServer,
        MigrationSink,
        RecoveryConfig,
        RecoveryController,
        migration_key,
    )
    from ..runtime.wire import packb, unpackb

    config = RecoveryConfig(drain_grace_s=flags.drain_grace_s,
                            respawn_backoff_s=flags.respawn_backoff_s,
                            max_respawns=flags.respawn_max)
    engine_id = f"eng-{uuid.uuid4().hex[:12]}"
    if hasattr(core, "add_down_listener"):
        # the controller ignores the down event of its own drain's kill
        controller = RecoveryController(engine_id=engine_id,
                                        respawner=core.respawn,
                                        admission=admission, config=config)
        core.add_down_listener(controller.on_child_down)
        return controller, None
    scheduler = getattr(core, "scheduler", None)
    if scheduler is None:
        return None, None
    server = await MigrationServer(MigrationSink(scheduler, core.runner),
                                   host=flags.advertise_host,
                                   port=flags.migrate_port).start()
    static_peers = [
        {"host": hp.rsplit(":", 1)[0], "port": int(hp.rsplit(":", 1)[1]),
         "engine_id": f"static-{hp}"}
        for hp in flags.migrate_peers.split(",") if hp.strip()]
    peers = (lambda: static_peers)
    deregister = register = None
    if drt is not None:
        key = migration_key(flags.namespace, component, engine_id)
        # worker_id: the KV-event id this worker publishes under, the join
        # key peer fabrics rank migration targets by
        desc = packb(dict(server.descriptor, engine_id=engine_id,
                          **({"worker_id": instance_id} if instance_id else {})))
        lease = await drt.discovery.primary_lease()
        await drt.discovery.kv_put(key, desc, lease_id=lease.id)
        peer_cache: list = list(static_peers)

        async def refresh_peers():
            kvs = await drt.discovery.kv_get_prefix(
                migration_key(flags.namespace, component, ""))
            peer_cache[:] = static_peers + [unpackb(v) for v in kvs.values()]

        async def deregister():
            # routers already skip this worker through the draining
            # snapshot; removing the descriptor keeps peers from draining
            # INTO it. Delete first and unconditionally: a flaky refresh must
            # neither leave the descriptor registered nor abort the drain
            await drt.discovery.kv_delete(key)
            try:
                await refresh_peers()  # after the delete: self is gone too
            except Exception:
                logger.warning("peer refresh failed during drain; using the "
                               "last known peers", exc_info=True)

        async def register():
            await drt.discovery.kv_put(key, desc, lease_id=lease.id)

        try:
            await refresh_peers()
        except Exception:
            logger.warning("initial migration-peer discovery failed; starting "
                           "with the static peers only", exc_info=True)
        peers = (lambda: peer_cache)
    controller = RecoveryController(
        engine_id=engine_id, scheduler=scheduler, runner=core.runner,
        watchdog=getattr(core, "watchdog", None), peers=peers,
        deregister=deregister, register=register, admission=admission,
        config=config, peer_ranker=peer_ranker)
    return controller, server


def _pool_scope_peers(peers: dict, endpoint_records: dict,
                      model: str = "") -> tuple:
    """Filter a fabric peer-descriptor map to this worker's model pool.

    Several model pools can share one component (clients and the KV router
    partition a shared component's instances by the ``model`` metadata of
    their lease-scoped endpoint records), but the fabric's descriptor
    prefix is component-wide: without this filter a pull could splice
    another model's KV blocks into this pool's cache. Peers with no
    endpoint record yet or no model metadata (single-pool deployments) are
    kept: missing metadata is a wildcard. Returns ``(scoped, live)``,
    ``live`` being every instance id holding an endpoint record (the
    ownership view's prune set, pool-agnostic: liveness is the lease's)."""
    from ..runtime.wire import unpackb

    pool_of: dict = {}
    for key, raw in endpoint_records.items():
        wid = key.rsplit(":", 1)[-1]
        try:
            pool_of[wid] = unpackb(raw).get("model")
        except Exception:
            logger.debug("unreadable endpoint record for %s; treating its "
                         "pool as wildcard", wid, exc_info=True)
            pool_of[wid] = None
    scoped = {wid: desc for wid, desc in peers.items()
              if not model or pool_of.get(wid) in (None, model)}
    return scoped, set(pool_of)


# the fabric's peer descriptors are re-read from discovery this often
FABRIC_PEER_REFRESH_S = 5.0


async def _setup_kv_fabric(flags, core, drt=None, component: str = "backend",
                           endpoint=None, instance_id: str = "",
                           model: str = ""):
    """Cluster-KV-fabric wiring for a token-level worker.

    The engine built its fabric half (``Scheduler.fabric``: the cold tier
    and the pull machinery) from the EngineConfig knobs; this attaches the
    cluster half: the pull SERVER (advertised in discovery under
    ``fabric_key``), the peer descriptors (refreshed on a cadence) and the
    ownership view (the component's KV event stream, the events the router
    indexes). Returns the fabric or None."""
    from ..kv.fabric import fabric_key
    from ..kv_router.protocols import KV_EVENT_SUBJECT, RouterEvent
    from ..runtime.wire import packb, unpackb

    scheduler = getattr(core, "scheduler", None)
    fabric = getattr(scheduler, "fabric", None) if scheduler else None
    if fabric is None:
        return None
    if instance_id:
        # the ownership view keys workers by the id the KV event publisher
        # stamps, so this worker's own events are skipped and peer scores
        # map onto descriptors
        fabric.engine_id = instance_id
    if fabric.cold is not None:
        # respawn-warm: prime the cold index off the loop so the first
        # request after a respawn sees the spilled prefixes
        n = await asyncio.get_running_loop().run_in_executor(
            None, fabric.cold.refresh)
        if n:
            logger.info("cold tier primed: %d resident blocks", n)
    if not fabric.peer_pull:
        # cold tier only: local spill was the opt-in, not networking
        return fabric
    server = await fabric.serve(host=flags.advertise_host)
    if drt is None or endpoint is None:
        return fabric
    key = fabric_key(flags.namespace, component, fabric.engine_id)
    desc = packb(dict(server.descriptor, engine_id=fabric.engine_id))
    lease = await drt.discovery.primary_lease()
    await drt.discovery.kv_put(key, desc, lease_id=lease.id)

    peer_cache: dict = {}

    async def refresh_peers():
        kvs = await drt.discovery.kv_get_prefix(
            fabric_key(flags.namespace, component, ""))
        peers = {}
        for v in kvs.values():
            d = unpackb(v)
            wid = d.get("engine_id")
            if wid and wid != fabric.engine_id:
                peers[wid] = d
        # prune dead workers from the ownership view: liveness is the
        # lease-scoped ENDPOINT registry (keyed by the id KV events carry),
        # which also carries pool membership
        eps = await drt.discovery.kv_get_prefix(endpoint.component.etcd_prefix())
        peers, live = _pool_scope_peers(peers, eps, model)
        peer_cache.clear()
        peer_cache.update(peers)
        for wid in list(fabric.indexer.worker_ids):
            if wid != fabric.engine_id and wid not in live:
                fabric.remove_worker(wid)

    async def refresh_loop():
        while True:
            try:
                await refresh_peers()
            except Exception:
                # a discovery hiccup keeps the last known pool: a pull to a
                # dead descriptor just falls back to a recompute
                logger.debug("fabric peer refresh failed", exc_info=True)
            await asyncio.sleep(FABRIC_PEER_REFRESH_S)

    try:
        await refresh_peers()
    except Exception:
        logger.warning("initial fabric peer discovery failed; starting with "
                       "no peers", exc_info=True)
    fabric.peers = (lambda: peer_cache)
    fabric.hold_task(drt.runtime.spawn(refresh_loop()))
    # the ownership view rides the event subject the KV router consumes;
    # apply_event skips this worker's own events
    sub = await endpoint.component.subscribe_event(KV_EVENT_SUBJECT)

    async def consume_events():
        async for msg in sub:
            try:
                fabric.apply_event(RouterEvent.from_wire(unpackb(msg.payload)))
            except Exception:
                logger.exception("bad kv event on the fabric feed")

    fabric.hold_task(drt.runtime.spawn(consume_events()))
    return fabric


def _stop_on_signals(loop) -> asyncio.Event:
    """An event SIGINT and SIGTERM set (a role's clean shutdown)."""
    stop_event = asyncio.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop_event.set)
        except (NotImplementedError, RuntimeError):
            pass
    return stop_event


async def run_prefill(flags) -> None:
    """The prefill worker role (``in=prefill out=torch``): consumes the
    namespace's prefill queue and streams each prompt's KV to the decode
    worker that enqueued it. Its stats (prefills, tokens, transfer bytes
    and frames, each transfer's duration and exposed seconds, the kernels'
    launches) answer the stats scrape of ``dyn://<ns>.prefill.stats``, as a
    token-level worker's do."""
    import uuid

    from ..disagg import PrefillWorker
    from ..engine.model_runner import ModelRunner
    from ..engine.serving import engine_config_from_mdc
    from ..runtime.component import DistributedRuntime

    if flags.store_port is None:
        raise SystemExit("in=prefill requires --store-port")
    mdc = load_mdc(flags)
    engine_config = engine_config_from_mdc(mdc, flags)
    drt = await DistributedRuntime.connect(flags.store_host, flags.store_port)
    loop = asyncio.get_running_loop()
    runner = await loop.run_in_executor(None, lambda: ModelRunner(
        engine_config, device=flags.device, model_dir=mdc.model_path))
    await loop.run_in_executor(None, runner.warmup)
    # first dispatches from here on are late ones (the storm signal)
    runner.compiles.mark_serving_started()
    worker = PrefillWorker(drt, runner, engine_config, namespace=flags.namespace)

    async def no_requests(payload, ctx):
        raise RuntimeError("the prefill worker's endpoint serves stats only")
        yield  # an async generator, as endpoint handlers are

    endpoint = drt.namespace(flags.namespace).component("prefill").endpoint("stats")
    instance_id = f"prefill-{uuid.uuid4().hex[:12]}"
    serving = await endpoint.serve(
        no_requests, instance_id=instance_id,
        stats_handler=lambda: dict(worker.metrics(),
                                   launches=_kernel_launches()))
    from ..telemetry.server import maybe_start_metrics_server

    mserver = await maybe_start_metrics_server(worker.registry,
                                               flags.metrics_port)
    await advertise_sidecar(drt, flags, mserver, "prefill_worker", instance_id)
    task = asyncio.ensure_future(worker.run())
    print(f"prefill worker consuming {worker.queue.name}", flush=True)
    stop_event = _stop_on_signals(loop)
    try:
        await asyncio.wait([task, asyncio.ensure_future(stop_event.wait())],
                           return_when=asyncio.FIRST_COMPLETED)
        if task.done():
            task.result()  # the worker's loop never ends on its own
    finally:
        worker.stop()
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        await serving.stop()
        if mserver is not None:
            await mserver.stop()
        await worker.close()
        await drt.close()


async def run_hub(flags) -> None:
    """The stand-alone fleet hub (``in=hub``), the reference's ``run_hub``:
    scrape every --hub-target and discovery-registered metrics sidecar of
    ``--namespace`` into history rings and serve /metrics (the hub's own
    instruments and rollups), /fleet/metrics, /fleet/workers and
    /debug/incidents on ``--http-port``."""
    from ..http.server import json_response
    from ..runtime.component import DistributedRuntime
    from ..telemetry.hub import FleetHub, discovery_targets, parse_target_flag
    from ..telemetry.incidents import IncidentRecorder, incident_dir
    from ..telemetry.server import MetricsServer

    targets = [parse_target_flag(s) for s in (flags.hub_target or [])]
    discover = None
    drt = None
    if flags.store_port is not None:
        drt = await DistributedRuntime.connect(flags.store_host,
                                               flags.store_port)
        discover = discovery_targets(drt, flags.namespace)
    if not targets and discover is None:
        raise SystemExit(
            "in=hub needs scrape targets: --hub-target role=url and/or "
            "--store-port for discovery-registered sidecars")
    hub = FleetHub(targets=targets, discover=discover,
                   interval_s=flags.hub_interval_s)
    routes = [
        ("GET", "/fleet/metrics", hub.handle_fleet_metrics),
        ("GET", "/fleet/workers", hub.handle_fleet_workers),
    ]
    if incident_dir():
        # the listing and fetch surface only: triggers live in the engine
        # processes that own the evidence
        routes.append(("GET", "/debug/incidents",
                       IncidentRecorder().handle_debug_incidents))
    else:
        # the frontend's 501 with its hint: an operator learns the flag
        async def _incidents_off(request, conn=None):
            return json_response(
                {"error": "no incident recorder attached (set "
                          "DYN_INCIDENT_DIR or --incident-dir)"}, status=501)

        routes.append(("GET", "/debug/incidents", _incidents_off))
    server = await MetricsServer(hub.registry, flags.http_host,
                                 flags.http_port, routes=routes).start()
    hub.start()
    print(f"fleet hub on http://{flags.http_host}:{server.port} "
          f"({len(targets)} static target(s)"
          f"{', discovery-driven' if discover else ''})", flush=True)
    stop_event = _stop_on_signals(asyncio.get_running_loop())
    try:
        await stop_event.wait()
    finally:
        await hub.stop()
        await server.stop()
        if drt is not None:
            await drt.close()


async def run_planner(flags) -> None:
    """The stand-alone SLA planner (``in=planner``), the reference's
    ``run_planner``: scrape the worker pool's load and the prefill queue's
    depth, run the policy, and actuate the disagg router's thresholds
    through discovery and, with --api-store-url and --planner-deployment,
    the per-role replica counts of that api-store record (the operator
    reconciles it). ``--metrics-port`` serves the planner's instruments
    (and, with ``--hub``, the fleet routes beside them)."""
    from ..disagg.protocols import PrefillQueue
    from ..http.service import parse_endpoint_path
    from ..kv_router.metrics_aggregator import KvMetricsAggregator
    from ..planner import (
        LocalActuator,
        Planner,
        PlannerConfig,
        StoreScaleActuator,
        aggregator_source,
    )
    from ..runtime.client import Client, RouterMode
    from ..runtime.component import DistributedRuntime
    from ..telemetry.server import maybe_start_metrics_server

    if flags.store_port is None:
        raise SystemExit("in=planner requires --store-port")
    if not flags.worker_endpoint:
        raise SystemExit(
            "in=planner requires --worker-endpoint "
            "(the decode workers to observe)")
    drt = await DistributedRuntime.connect(flags.store_host, flags.store_port)
    wns, wcomp, wep = parse_endpoint_path(flags.worker_endpoint)
    client = Client(drt.namespace(wns).component(wcomp).endpoint(wep),
                    RouterMode.ROUND_ROBIN)
    await client.start()
    aggregator = KvMetricsAggregator(client)
    aggregator.start()
    planner = Planner(
        _planner_policy(
            flags, initial_local_prefill_length=flags.max_local_prefill_length,
            initial_prefill_queue_size=flags.max_prefill_queue_size),
        config=PlannerConfig(interval_s=flags.planner_interval_s))
    planner.add_source(aggregator_source(aggregator))

    # the prefill queue's depth, polled as the decode side's coordinator
    # polls it: the dict starts EMPTY and empties again on a failure, since
    # a fabricated 0 would read as "queue drained" and steer the rebalance
    # the wrong way exactly when the messaging plane is down
    queue = PrefillQueue(drt.messaging, flags.namespace)
    depth: dict = {}

    async def _depth_loop() -> None:
        while True:
            try:
                depth["prefill.queue_depth"] = float(await queue.depth())
            except Exception:
                depth.clear()
                logger.debug("prefill queue depth refresh failed",
                             exc_info=True)
            await asyncio.sleep(1.0)

    depth_task = drt.runtime.spawn(_depth_loop())
    planner.add_source(lambda: depth)
    planner.add_actuator(LocalActuator(
        discovery=drt.discovery, namespace=flags.namespace,
        model_name=flags.model_name))
    if flags.api_store_url and flags.planner_deployment:
        from ..deploy.store_source import ApiStoreClient

        planner.add_actuator(StoreScaleActuator(
            ApiStoreClient(flags.api_store_url), flags.planner_deployment))
    else:
        logger.warning(
            "in=planner without --api-store-url/--planner-deployment: "
            "scale actions will be decided and logged but not actuated")
    hub = _build_hub(flags)
    routes = None
    if hub is not None:
        # a fleet hub riding the planner: the discovery-registered sidecars
        # feed fleet-level saturation into the policy, and /fleet/* is
        # served beside the planner's own exposition
        from ..telemetry.hub import discovery_targets

        hub.discover = discovery_targets(drt, flags.namespace)
        planner.add_source(hub.signal_source())
        planner.registry.attach(hub.registry)
        routes = [
            ("GET", "/fleet/metrics", hub.handle_fleet_metrics),
            ("GET", "/fleet/workers", hub.handle_fleet_workers),
        ]
        hub.start(spawn=drt.runtime.spawn)
    mserver = await maybe_start_metrics_server(
        planner.registry, flags.metrics_port, routes=routes)
    planner.start(spawn=drt.runtime.spawn)
    print(f"planner observing {flags.worker_endpoint} "
          f"every {flags.planner_interval_s:.1f}s"
          f"{' + fleet hub' if hub else ''}", flush=True)
    stop_event = _stop_on_signals(asyncio.get_running_loop())
    try:
        await stop_event.wait()
    finally:
        planner.stop()
        depth_task.cancel()
        if hub is not None:
            await hub.stop()
        if mserver is not None:
            await mserver.stop()
        aggregator.stop()
        await client.close()
        await drt.close()


async def run_worker(flags, engine_spec: str, path: str) -> None:
    """Distributed worker roles (in=dyn://ns.comp.ep), the reference's
    ``run_worker``; ``--metrics-port`` starts each role's /metrics sidecar
    (advertised in discovery for a fleet hub) and ``--incident-dir`` an
    incident recorder on a token-level worker:

    - default: full OpenAI-level worker (preprocess+engine+detokenize here)
    - --token-level: engine worker serving PreprocessedRequests, publishing
      KV events + ForwardPassMetrics for KV-aware routers, and with the KV
      tiers or ``--prefix-pull`` the cluster KV fabric's wiring
    - out=processor: preprocess + route to --worker-endpoint workers
      (KV-aware with --router-mode kv); its stats scrape answers the
      router's ``stats()``
    """
    import uuid

    from ..http.service import parse_endpoint_path, register_model
    from ..runtime.component import DistributedRuntime
    from ..runtime.engine import Context
    from ..telemetry.server import maybe_start_metrics_server

    if flags.store_port is None:
        raise SystemExit("in=dyn:// requires --store-port")
    if engine_spec == "none":
        raise SystemExit("out=none is only valid with in=http (pure frontend)")
    if not _served(engine_spec):
        _refuse_output(engine_spec)
    ns_name, comp, ep_name = parse_endpoint_path(path)
    drt = await DistributedRuntime.connect(flags.store_host, flags.store_port)
    endpoint = drt.namespace(ns_name).component(comp).endpoint(ep_name)
    closers = []

    def make_openai_handler(engine):
        async def handler(payload, ctx):
            from ..protocols.annotated import Annotated
            from ..protocols.openai import ChatCompletionRequest, CompletionRequest

            cls = ChatCompletionRequest if "messages" in payload else CompletionRequest
            async for chunk in engine.generate(Context(cls.model_validate(payload), ctx)):
                if isinstance(chunk, Annotated):
                    yield chunk.to_wire()
                else:
                    yield chunk if isinstance(chunk, dict) else chunk.model_dump(exclude_none=True)

        return handler

    if engine_spec == "processor":
        from ..kv_router.router import KvRouter
        from ..llm.processor import build_processor_pipeline
        from ..runtime.client import Client, RouterMode

        if not flags.worker_endpoint:
            raise SystemExit("out=processor requires --worker-endpoint")
        mdc = load_mdc(flags)
        wns, wcomp, wep = parse_endpoint_path(flags.worker_endpoint)
        w_endpoint = drt.namespace(wns).component(wcomp).endpoint(wep)
        client = Client(
            w_endpoint,
            RouterMode.ROUND_ROBIN if flags.router_mode == "kv"
            else RouterMode(flags.router_mode),
        )
        router = None
        if flags.router_mode == "kv":
            router = await KvRouter(
                w_endpoint.component, client, block_size=flags.kv_block_size,
                staleness_bound_s=flags.router_staleness_bound_s,
            ).start()
        else:
            await client.start()
        engine = build_processor_pipeline(mdc, client, router)
        closers.append(engine.close)
        name = flags.model_name or mdc.display_name
        serving = await endpoint.serve(
            make_openai_handler(engine), span_source="processor",
            metadata={"model": name},
            stats_handler=router.stats if router is not None else None)
        await register_model(drt, flags.namespace, name, path, model_type="both",
                             mdc={"context_length": mdc.context_length},
                             card=_model_card(flags, mdc, path))
        if router is not None:
            # the router's own surface: per-worker scraped load and the
            # routing decisions
            _advertise_model(router.registry, name)
            mserver = await maybe_start_metrics_server(router.registry,
                                                       flags.metrics_port)
            await advertise_sidecar(drt, flags, mserver, "processor",
                                    f"processor-{uuid.uuid4().hex[:12]}")
            if mserver is not None:
                closers.append(mserver.stop)
        print(f"processor serving {path} (model={name} → {flags.worker_endpoint})", flush=True)

    elif flags.token_level:
        from ..kv_router.publisher import KvEventPublisher, KvMetricsPublisher

        mdc = load_mdc(flags)
        instance_id = f"w-{uuid.uuid4().hex[:12]}"
        publisher = KvEventPublisher(endpoint.component, instance_id)
        publisher.start()
        core = await build_core_engine(
            engine_spec, flags, mdc, events=publisher.as_sink(),
            disagg_factory=_disagg_factory(flags, drt, comp))
        closers.append(core.close)

        async def handler(payload, ctx):
            async for out in core.generate(Context(payload, ctx)):
                yield out

        base_metrics = core.metrics if hasattr(core, "metrics") else dict
        launches = _launches_of(engine_spec, core)

        scheduler = getattr(core, "scheduler", None)

        def metrics_fn():
            # the engine's load, the events handed to the broker, the
            # kernels' launch counts of this process and, with the KV
            # fabric, its pull counters
            out = dict(base_metrics(), kv_events_published=publisher.published,
                       launches=launches())
            if getattr(scheduler, "fabric", None) is not None:
                out["kv_fabric"] = scheduler.fabric_stats()
            return out

        model_name = flags.model_name or mdc.display_name
        serving = await endpoint.serve(
            handler,
            instance_id=instance_id,
            stats_handler=KvMetricsPublisher(metrics_fn).stats_handler,
            span_source="decode_engine",
            metadata={"model": model_name},
        )
        # the cluster KV fabric: pull server, peer view, ownership feed,
        # keyed by the instance id the KV event publisher stamps
        fabric = await _setup_kv_fabric(flags, core, drt=drt, component=comp,
                                        endpoint=endpoint,
                                        instance_id=instance_id,
                                        model=model_name)
        if flags.self_heal:
            # watchdog trips drain this worker and migrate its requests to
            # peers discovered under the component's migration prefix,
            # ranked by the fabric's ownership view (prefix overlap)
            recovery, migserver = await _setup_self_healing(
                flags, core, drt=drt, component=comp,
                peer_ranker=fabric.rank_peers if fabric is not None else None,
                instance_id=instance_id)
            if recovery is not None:
                recovery.attach()
                if getattr(core, "registry", None) is not None:
                    core.registry.attach(recovery.registry)
                # closed before the engine (closers run in order); a
                # supervised child's ladder has no migration receiver
                closers[-1:-1] = [recovery.close] + (
                    [migserver.close] if migserver is not None else [])
        else:
            recovery = None
        reg = getattr(core, "registry", None)
        # incident bundles at trip time: the engine worker is where wedges
        # happen, and its evidence must reach the disk before a respawn
        incidents, inc_sampler = await _setup_incidents(
            flags, registry=reg, watchdog=getattr(core, "watchdog", None),
            recovery=recovery,
            compiles=getattr(getattr(core, "runner", None), "compiles", None))
        if incidents is not None:
            if reg is not None:
                reg.attach(incidents.registry)
            closers[0:0] = [incidents.stop]
            if inc_sampler is not None:
                closers[0:0] = [inc_sampler.stop]
        # the engine's whole registry (scheduler, runner trackers, KV tiers,
        # recovery) on the sidecar; an echo core carries none
        if reg is not None:
            _advertise_model(reg, model_name)
        mserver = await maybe_start_metrics_server(reg, flags.metrics_port)
        await advertise_sidecar(drt, flags, mserver, "decode_engine",
                                instance_id)
        if mserver is not None:
            closers[0:0] = [mserver.stop]
        print(f"token-level worker {instance_id} serving {path}", flush=True)

    else:
        engine, mdc = await build_engine(engine_spec, flags)
        if engine is not None and hasattr(engine, "close"):
            closers.append(engine.close)
        name = flags.model_name or (mdc.display_name if mdc else "echo")
        serving = await endpoint.serve(make_openai_handler(engine),
                                       metadata={"model": name})
        model_type = "both" if mdc is not None else "chat"
        await register_model(
            drt, flags.namespace, name, path, model_type=model_type,
            mdc={"context_length": mdc.context_length} if mdc else None,
            card=_model_card(flags, mdc, path, model_type)
            if mdc is not None else None,
        )
        mserver = await maybe_start_metrics_server(
            getattr(engine, "engine_registry", None), flags.metrics_port)
        await advertise_sidecar(drt, flags, mserver, "worker",
                                f"worker-{uuid.uuid4().hex[:12]}")
        if mserver is not None:
            closers[0:0] = [mserver.stop]
        print(f"worker serving {path} (model={name})", flush=True)

    stop_event = _stop_on_signals(asyncio.get_running_loop())
    try:
        await stop_event.wait()
    finally:
        await serving.stop()
        for close in closers:
            await close()
        await drt.close()


async def amain(argv: List[str]) -> None:
    src, engine_spec, rest = parse_io(argv)
    flags = parse_flags(rest)
    from ..utils.logging import setup_logging
    setup_logging(logging.DEBUG if flags.verbose else logging.INFO)
    if flags.flight_dir:
        # one env var is the single source of truth for every dump site
        import os

        from ..telemetry.flight import FLIGHT_DIR_ENV

        os.environ[FLIGHT_DIR_ENV] = flags.flight_dir
    if flags.incident_dir:
        # likewise the incident recorder's
        import os

        from ..telemetry.incidents import INCIDENT_DIR_ENV

        os.environ[INCIDENT_DIR_ENV] = flags.incident_dir
    # SIGUSR2 → a flight artifact, on every role: the way to ask "what is
    # this process doing", even with a wedged event loop
    from ..telemetry.watchdog import install_signal_dump

    install_signal_dump()
    if flags.remote_prefill and not (src.startswith("dyn://")
                                     and flags.token_level
                                     and engine_spec == "torch"):
        raise SystemExit("--remote-prefill is served by a token-level decode "
                         "worker: in=dyn://ns.comp.ep out=torch --token-level")
    if src.startswith("dyn://"):
        await run_worker(flags, engine_spec, src)
        return
    if src == "prefill":
        if engine_spec != "torch":
            raise SystemExit(f"in=prefill serves out=torch, not out={engine_spec}")
        await run_prefill(flags)
        return
    if src == "planner":
        await run_planner(flags)
        return
    if src == "hub":
        await run_hub(flags)
        return
    if src not in INPUTS and not src.startswith("batch:"):
        raise SystemExit(
            f"in={src} is not served by the PyTorch port (served: "
            f"{', '.join(INPUTS)}, planner, prefill, dyn://ns.comp.ep, "
            f"batch:<file>)")
    engine, mdc = await build_engine(engine_spec, flags)
    if src == "http":
        await run_http(flags, engine, mdc)
    elif src.startswith("batch:"):
        from .batch import run_batch

        try:
            await run_batch(flags, engine, mdc, src[len("batch:"):])
        finally:
            await engine.close()
    else:
        await run_text(flags, engine, mdc)


def main() -> None:
    try:
        asyncio.run(amain(sys.argv[1:]))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
