"""The port imports neither jax nor anything of the JAX package, nor the
packages it does not depend on.

``tests/conftest.py`` imports jax into every test process, so the import
check runs in a fresh interpreter: a ``sys.meta_path`` finder refuses
``jax``, ``jaxlib`` and ``dynamo_tpu``/``dynamo_tpu.*`` (``dynamo_tpu_torch``
is allowed), and the packages the reference's front stands on that the
port does not depend on (``aiohttp``, ``pydantic``, ``tokenizers``,
``regex``, ``msgpack``, ``safetensors``, ``transformers``, ``gguf``,
``ml_dtypes``, ``xxhash``, ``jsonschema``, ``google.protobuf``: the
checkpoint loader reads safetensors and GGUF files on the standard
library, the cold KV tier checksums with the port's own xxh64, guided JSON
walks its own schema subset, and the SentencePiece reader decodes a
``tokenizer.model``'s wire format itself; ``jinja2``, a
requirement of torch, stays allowed), then every module of
``dynamo_tpu_torch`` and ``chip_smoke`` is imported, and CUDA must not have
been initialised by any import. A static scan of the import statements
backs it up.
"""

import ast
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "dynamo_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


REFUSED = ("jax", "jaxlib", "dynamo_tpu", "aiohttp", "pydantic", "tokenizers",
           "regex", "msgpack", "safetensors", "transformers", "gguf",
           "ml_dtypes", "xxhash", "jsonschema", "google.protobuf")


def _blocked(name: str) -> bool:
    """``name`` is a refused package or one of its modules (a dotted entry
    refuses that subpackage only: ``google.protobuf``, not ``google``)."""
    return any(name == r or name.startswith(r + ".") for r in REFUSED)


def test_blocked_names_match_exactly():
    assert _blocked("dynamo_tpu") and _blocked("dynamo_tpu.ops")
    assert _blocked("jax.numpy") and _blocked("jaxlib")
    assert not _blocked("dynamo_tpu_torch")
    assert not _blocked("dynamo_tpu_torch.ops.attention")
    assert not _blocked("jaxtyping")
    for name in ("aiohttp.web", "pydantic", "tokenizers.models", "regex",
                 "msgpack", "safetensors.torch", "transformers", "gguf",
                 "ml_dtypes", "xxhash", "jsonschema.validators",
                 "google.protobuf", "google.protobuf.message"):
        assert _blocked(name)
    assert not _blocked("jinja2") and not _blocked("regexp")
    assert not _blocked("google") and not _blocked("google.protobufx")


def test_port_imports_without_jax_or_reference_package():
    mods = _port_modules() + ["chip_smoke"]
    # every kernel module is among them (the imports of its wrapper count)
    assert {"dynamo_tpu_torch.ops.epilogue", "dynamo_tpu_torch.ops.paged_verify",
            "dynamo_tpu_torch.ops.paged_decode", "dynamo_tpu_torch.ops.paged_flash",
            "dynamo_tpu_torch.ops.mla_decode", "dynamo_tpu_torch.models.deepseek",
            "dynamo_tpu_torch.models.mixtral", "dynamo_tpu_torch.models.quant",
            "dynamo_tpu_torch.engine.guided", "dynamo_tpu_torch.llm.embeddings",
            "dynamo_tpu_torch.ops.transfer", "dynamo_tpu_torch.ops.sp_prefix",
            "dynamo_tpu_torch.parallel.ring_attention",
            "dynamo_tpu_torch.parallel.sequence",
            "dynamo_tpu_torch.llm.tokenizer", "dynamo_tpu_torch.llm.preprocessor",
            "dynamo_tpu_torch.llm.backend", "dynamo_tpu_torch.http.service",
            "dynamo_tpu_torch.protocols.openai", "dynamo_tpu_torch.cli.run",
            "dynamo_tpu_torch.telemetry.registry",
            "dynamo_tpu_torch.models.loader", "dynamo_tpu_torch.llm.gguf",
            "dynamo_tpu_torch.llm.gguf_tensors",
            # the distributed layer: its wire is the port's own codec, so
            # msgpack (refused above) is never imported
            "dynamo_tpu_torch.runtime.wire", "dynamo_tpu_torch.runtime.discovery",
            "dynamo_tpu_torch.runtime.messaging", "dynamo_tpu_torch.runtime.network",
            "dynamo_tpu_torch.runtime.component", "dynamo_tpu_torch.runtime.client",
            "dynamo_tpu_torch.runtime.transports.memory",
            "dynamo_tpu_torch.runtime.transports.dynstore",
            "dynamo_tpu_torch.kv_router.protocols", "dynamo_tpu_torch.kv_router.indexer",
            "dynamo_tpu_torch.kv_router.publisher", "dynamo_tpu_torch.kv_router.scheduler",
            "dynamo_tpu_torch.kv_router.metrics_aggregator",
            "dynamo_tpu_torch.kv_router.router",
            "dynamo_tpu_torch.llm.processor",
            # the disagg layer: headers in the port's codec, blocks as raw
            # bytes viewed as torch dtypes, so neither msgpack nor ml_dtypes
            "dynamo_tpu_torch.transfer.framing", "dynamo_tpu_torch.transfer.tcp",
            "dynamo_tpu_torch.transfer.plane", "dynamo_tpu_torch.disagg.protocols",
            "dynamo_tpu_torch.disagg.router", "dynamo_tpu_torch.disagg.transfer",
            "dynamo_tpu_torch.disagg.coordinator",
            "dynamo_tpu_torch.disagg.prefill_worker",
            # the KV tiers and the fabric: the wire codec for the cold
            # files' headers, the port's own xxh64 and fault sites
            "dynamo_tpu_torch.kv", "dynamo_tpu_torch.kv.host_tier",
            "dynamo_tpu_torch.kv.cold_tier", "dynamo_tpu_torch.kv.fabric",
            "dynamo_tpu_torch.ops.host_xxh64",
            "dynamo_tpu_torch.utils.faults",
            # recovery: the flight ring, the watchdog, the migration plane
            "dynamo_tpu_torch.telemetry.flight",
            "dynamo_tpu_torch.telemetry.watchdog",
            "dynamo_tpu_torch.recovery", "dynamo_tpu_torch.recovery.migration",
            "dynamo_tpu_torch.recovery.controller",
            # the supervised engine child, the Python-file engines and the
            # CLI's tools: their wire is the port's codec, their HTTP the
            # port's own server
            "dynamo_tpu_torch.llm.engines.subprocess_host",
            "dynamo_tpu_torch.llm.engines.python_file",
            "dynamo_tpu_torch.cli.batch", "dynamo_tpu_torch.cli.llmctl",
            "dynamo_tpu_torch.cli.metrics",
            "dynamo_tpu_torch.models.hub",
            # the native host core, the edge's admission and the registry:
            # ctypes over the port's own C++, records in the port's codec
            "dynamo_tpu_torch.native", "dynamo_tpu_torch.kv_router.recorder",
            "dynamo_tpu_torch.planner", "dynamo_tpu_torch.planner.admission",
            "dynamo_tpu_torch.registry", "dynamo_tpu_torch.registry.cards",
            "dynamo_tpu_torch.registry.registry",
            "dynamo_tpu_torch.registry.tenants",
            "dynamo_tpu_torch.registry.policy",
            "dynamo_tpu_torch.registry.pools",
            # the closed-loop planner and the deployment plane: urllib,
            # sqlite3 and the port's own HTTP core, no aiohttp
            "dynamo_tpu_torch.planner.signals", "dynamo_tpu_torch.planner.policy",
            "dynamo_tpu_torch.planner.planner",
            "dynamo_tpu_torch.planner.actuation",
            "dynamo_tpu_torch.deploy", "dynamo_tpu_torch.deploy.operator",
            "dynamo_tpu_torch.deploy.store_source",
            "dynamo_tpu_torch.deploy.api_store",
            "dynamo_tpu_torch.deploy.kube_api", "dynamo_tpu_torch.deploy.watch",
            "dynamo_tpu_torch.deploy.leader",
            "dynamo_tpu_torch.deploy.operator_main",
            "dynamo_tpu_torch.utils.logging",
            # runtime settings and the graph SDK with its example graphs
            "dynamo_tpu_torch.utils.config", "dynamo_tpu_torch.sdk",
            "dynamo_tpu_torch.sdk.config", "dynamo_tpu_torch.sdk.service",
            "dynamo_tpu_torch.sdk.worker", "dynamo_tpu_torch.sdk.allocator",
            "dynamo_tpu_torch.sdk.serving", "dynamo_tpu_torch.sdk.build",
            "dynamo_tpu_torch.examples.hello_world",
            "dynamo_tpu_torch.examples.llm.components",
            "dynamo_tpu_torch.examples.llm.graphs.agg",
            "dynamo_tpu_torch.examples.llm.graphs.agg_router",
            "dynamo_tpu_torch.examples.llm.graphs.disagg",
            "dynamo_tpu_torch.examples.llm.graphs.disagg_router",
            # the fleet simulator and its CLI
            "dynamo_tpu_torch.sim", "dynamo_tpu_torch.sim.clock",
            "dynamo_tpu_torch.sim.workload", "dynamo_tpu_torch.sim.metrics",
            "dynamo_tpu_torch.sim.worker", "dynamo_tpu_torch.sim.fleet",
            "dynamo_tpu_torch.sim.report", "dynamo_tpu_torch.sim.scenarios",
            "dynamo_tpu_torch.cli.fleetsim"} <= set(mods)
    _import_refusing_reference(mods)


def test_guided_module_imports_without_jax_or_reference_package():
    """``engine/guided.py`` alone (the reference's is imported by its
    scheduler at module level): neither jax nor ``dynamo_tpu`` comes with
    it, and the trie cursor works in that interpreter."""
    _import_refusing_reference(["dynamo_tpu_torch.engine.guided"], """
        from dynamo_tpu_torch.engine.guided import (
            TrieConstraint, compile_device_table)
        c = TrieConstraint([[4, 5], [4, 6, 7]])
        assert c.advance(4) == "ok" and c.advance(5) == "done"
        assert compile_device_table(c, 16, [2]).n_states == 4
    """)


def test_sp_modules_import_without_jax_or_reference_package():
    """The sequence-parallel modules alone: neither jax nor ``dynamo_tpu``
    comes with them, and the ring runs in that interpreter."""
    _import_refusing_reference([
        "dynamo_tpu_torch.parallel.ring_attention",
        "dynamo_tpu_torch.parallel.sequence", "dynamo_tpu_torch.ops.sp_prefix",
    ], """
        import torch
        from dynamo_tpu_torch.parallel.ring_attention import (
            dense_reference, ring_attention)
        q = torch.randn(1, 8, 4, 16)
        k = torch.randn(1, 8, 2, 16)
        pos = torch.arange(8)[None]
        torch.testing.assert_close(ring_attention(q, k, k, pos, pos, 4),
                                   dense_reference(q, k, k, pos, pos))
    """)


def test_quant_and_mixtral_modules_import_without_jax_or_reference_package():
    """``models/quant.py`` and ``models/mixtral.py`` alone: neither jax nor
    ``dynamo_tpu`` comes with them, and a quantized expert product runs in
    that interpreter."""
    _import_refusing_reference([
        "dynamo_tpu_torch.models.quant", "dynamo_tpu_torch.models.mixtral",
    ], """
        import torch
        from dynamo_tpu_torch.models.quant import expert_bmm, quantize_int8
        w = torch.randn(2, 8, 4)
        x = torch.randn(2, 3, 8)
        qw = quantize_int8(w)
        assert qw.q.dtype == torch.int8 and qw[1].shape == (8, 4)
        err = (expert_bmm(x, qw) - torch.bmm(x, w)).abs().max()
        assert float(err) < 0.1, float(err)
    """)


def test_kv_tiers_and_faults_import_without_jax_or_reference_package(tmp_path):
    """``kv/`` and ``utils/faults.py`` alone: neither jax, ``dynamo_tpu``,
    msgpack nor xxhash comes with them, and a cold-tier block file round
    trips (wire-codec header, pure-Python xxh64) in that interpreter."""
    _import_refusing_reference([
        "dynamo_tpu_torch.kv", "dynamo_tpu_torch.utils.faults",
    ], f"""
        import torch
        from dynamo_tpu_torch.kv import KvColdTier
        from dynamo_tpu_torch.utils import faults
        tier = KvColdTier({str(tmp_path)!r}, 4)
        k = torch.arange(24, dtype=torch.float32).reshape(2, 1, 4, 3)
        tier.put(9, k, -k)
        got = tier.get(9)
        assert torch.equal(got[0], k) and torch.equal(got[1], -k)
        faults.arm("prefix_pull_stall", "once")
        assert faults.fire("prefix_pull_stall") and not faults.fire("prefix_pull_stall")
    """)


def test_sentencepiece_reader_imports_without_protobuf(tmp_path):
    """``llm/tokenizer.py`` alone reads a ``tokenizer.model`` (written by
    ``chip_smoke.spm_model_bytes``) in an interpreter that refuses
    ``google.protobuf`` and ``transformers``: the round trip holds."""
    import chip_smoke

    path = tmp_path / "tokenizer.model"
    path.write_bytes(chip_smoke.spm_model_bytes(
        chip_smoke.synthetic_spm_pieces(1000, seed=5)))
    _import_refusing_reference(["dynamo_tpu_torch.llm.tokenizer"], f"""
        from dynamo_tpu_torch.llm.tokenizer import HFTokenizer
        tok = HFTokenizer.from_pretrained_dir({str(tmp_path)!r})
        text = "abc déf 日本 1 2"
        assert tok.decode(tok.encode(text)) == text
    """)


def _import_refusing_reference(mods, then=""):
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, sys

        def blocked(name):
            return any(name == r or name.startswith(r + ".")
                       for r in {REFUSED!r})

        for m in list(sys.modules):
            if blocked(m) and m.split(".")[0] != "dynamo_tpu":
                del sys.modules[m]

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if blocked(name):
                    raise ImportError("refused import of " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(REPO)!r})
        for m in {mods!r}:
            importlib.import_module(m)
    """) + textwrap.dedent(then) + textwrap.dedent(f"""
        import torch
        assert not torch.cuda.is_initialized(), "an import initialised CUDA"
        bad = [m for m in sys.modules if blocked(m)]
        assert not bad, bad
        print("imported", len({mods!r}))
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    assert f"imported {len(mods)}" in res.stdout


def test_native_planner_and_registry_import_without_jax_or_reference_package():
    """``native``, ``planner``, ``registry`` and the recorder alone: neither
    jax, ``dynamo_tpu`` nor msgpack comes with them, and in that
    interpreter the native core hashes and indexes (built with the host
    compiler if it is missing) and a card packs in the port's codec."""
    _import_refusing_reference([
        "dynamo_tpu_torch.native", "dynamo_tpu_torch.planner",
        "dynamo_tpu_torch.registry", "dynamo_tpu_torch.kv_router.recorder",
    ], """
        from dynamo_tpu_torch import tokens
        from dynamo_tpu_torch.kv_router.indexer import KvIndexer
        from dynamo_tpu_torch.registry import ModelCard, ModelRegistry
        from dynamo_tpu_torch.runtime.wire import packb, unpackb
        ids = list(range(64))
        assert (tokens.compute_block_hashes(ids, 16)
                == tokens.compute_block_hashes_plain(ids, 16))
        assert type(KvIndexer().tree).__name__ == "_NativeTreeAdapter"
        card = ModelCard(name="m", aliases=["a"], tenants=["t"])
        assert ModelCard.from_wire(unpackb(packb(card.to_wire()))) == card
        reg = ModelRegistry()
        reg.put(card)
        assert reg.resolve("a", "t") == "m" and reg.resolve("a") is None
    """)


def test_planner_and_deploy_import_without_jax_or_reference_package():
    """The planner and the deployment plane alone: neither jax,
    ``dynamo_tpu``, aiohttp nor yaml comes with them, and in that
    interpreter the policy decides, the operator renders a GPU worker and
    the api-store's sqlite store round-trips a record."""
    _import_refusing_reference([
        "dynamo_tpu_torch.planner", "dynamo_tpu_torch.deploy",
        "dynamo_tpu_torch.deploy.api_store", "dynamo_tpu_torch.deploy.kube_api",
        "dynamo_tpu_torch.deploy.watch", "dynamo_tpu_torch.deploy.leader",
        "dynamo_tpu_torch.deploy.operator_main",
        "dynamo_tpu_torch.deploy.store_source", "dynamo_tpu_torch.utils.logging",
    ], """
        from dynamo_tpu_torch.planner import SignalStore, SlaPolicy
        from dynamo_tpu_torch.deploy import render_manifests
        from dynamo_tpu_torch.deploy.api_store import DeploymentStore
        s = SignalStore(clock=lambda: 0.0)
        s.observe("decode.slot_busy_ratio", 1.0)
        (a,) = SlaPolicy(clock=lambda: 0.0).decide(s, {"decode": 1})
        assert (a.role, a.target_replicas) == ("decode", 2)
        cr = {"metadata": {"name": "g"}, "spec": {"services": {
            "decode": {"role": "decode", "gpus": 1}}}}
        (dep,) = [m for m in render_manifests(cr)
                  if m["metadata"]["name"] == "g-decode"]
        res = dep["spec"]["template"]["spec"]["containers"][0]["resources"]
        assert res["limits"] == {"nvidia.com/gpu": "1"}
        store = DeploymentStore(":memory:")
        assert store.put("g", {"a": 1})["spec"] == {"a": 1}
        assert "yaml" not in sys.modules
    """)


SDK_MODULES = [
    "dynamo_tpu_torch.utils.config", "dynamo_tpu_torch.sdk",
    "dynamo_tpu_torch.sdk.build", "dynamo_tpu_torch.examples.hello_world",
    "dynamo_tpu_torch.examples.llm.components",
    "dynamo_tpu_torch.examples.llm.graphs.agg_router",
    "dynamo_tpu_torch.llm.processor", "dynamo_tpu_torch.llm.preprocessor",
    "dynamo_tpu_torch.http.service", "dynamo_tpu_torch.kv_router.router",
    # a stream's first chunk through a processor: the detokenizer follows
    # migrations, whose frames pack tensors only when KV moves
    "dynamo_tpu_torch.llm.backend", "dynamo_tpu_torch.recovery.migration",
    "dynamo_tpu_torch.transfer",
]


def test_sdk_and_examples_import_without_jax_reference_package_or_torch():
    """The runtime settings, the SDK, the example graphs and what a
    Frontend, Processor or Router service runs, its first stream included:
    neither jax, ``dynamo_tpu`` nor yaml, and not torch either (a spawned
    service that serves no model pays no torch import, before or at its
    first request). In that interpreter the agg_router graph
    composes, the runtime settings read their default and the Worker asks
    for a card."""
    _import_refusing_reference(SDK_MODULES, """
        from dynamo_tpu_torch.sdk import graph_services
        from dynamo_tpu_torch.examples.llm import components as C
        from dynamo_tpu_torch.utils.config import RuntimeSettings
        assert [s.name for s in graph_services(C.Frontend)] == [
            "Frontend", "Processor", "Router", "Worker"]
        assert RuntimeSettings.from_settings().graceful_shutdown_timeout == 30.0
        assert C.Worker.spec.resources == {"gpu": 1}
        assert "torch" not in sys.modules and "yaml" not in sys.modules
    """)


def test_fleet_simulator_runs_without_jax_reference_package_or_torch():
    """``dynamo_tpu_torch.sim`` and ``python3 -m dynamo_tpu_torch.cli.fleetsim
    --list`` in an interpreter that refuses jax, ``dynamo_tpu``, the packages
    the port does not use and torch too (a torch import would eat the CLI's
    ``--speedup`` gate): the listing prints and a short chaos run
    completes in that interpreter."""
    script = textwrap.dedent(f"""
        import contextlib, importlib.abc, io, runpy, sys

        def blocked(name):
            return any(name == r or name.startswith(r + ".")
                       for r in {REFUSED + ("torch",)!r})

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if blocked(name):
                    raise ImportError("refused import of " + name)
                return None

        for m in [m for m in sys.modules if blocked(m)]:
            del sys.modules[m]
        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(REPO)!r})
        from dynamo_tpu_torch.sim import run_scenario
        rep = run_scenario("chaos", seed=0, duration_s=200.0)
        assert rep["totals"]["outcomes"]["completed"] > 0, rep["totals"]
        sys.argv = ["fleetsim", "--list"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                runpy.run_module("dynamo_tpu_torch.cli.fleetsim",
                                 run_name="__main__")
            except SystemExit as e:
                assert e.code == 0, e.code
        assert "diurnal" in out.getvalue() and "rag_pod" not in out.getvalue()
        bad = sorted(m for m in sys.modules if blocked(m))
        assert not bad, bad
        print("fleetsim ok")
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "fleetsim ok" in res.stdout


def test_sdk_worker_runs_as_a_module_without_jax_or_reference_package():
    """``python -m dynamo_tpu_torch.sdk.worker`` serving the hello-world
    Backend in an interpreter that refuses jax, ``dynamo_tpu`` and the
    packages the port does not use: a client streams through it, SIGTERM
    ends it with 0, and it never imported torch."""
    import asyncio
    import signal
    import socket

    from dynamo_tpu_torch.examples import hello_world
    from dynamo_tpu_torch.runtime.component import DistributedRuntime
    from dynamo_tpu_torch.sdk import DynamoClient

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    store = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.runtime.transports.dynstore",
         "--host", "127.0.0.1", "--port", str(port)], cwd=str(REPO))
    script = textwrap.dedent(f"""
        import importlib.abc, runpy, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if any(name == r or name.startswith(r + ".")
                       for r in {REFUSED!r}):
                    raise ImportError("refused import of " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(REPO)!r})
        sys.argv = ["worker", "dynamo_tpu_torch.examples.hello_world:Frontend",
                    "--service", "Backend", "--store-port", "{port}"]
        runpy.run_module("dynamo_tpu_torch.sdk.worker", run_name="__main__")
        assert "torch" not in sys.modules, "the worker imported torch"
    """)
    proc = None
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                break
            except OSError:
                assert time.monotonic() < deadline, "the dynstore never listened"
                time.sleep(0.05)
        proc = subprocess.Popen([sys.executable, "-c", script], cwd=str(REPO),
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)

        async def ask():
            drt = await DistributedRuntime.connect("127.0.0.1", port)
            try:
                client = await DynamoClient(hello_world.Backend, drt).start()
                await client.wait_ready(timeout=60)
                return [i async for i in client.generate({"text": "p,q"})]
            finally:
                await drt.close()

        assert asyncio.run(asyncio.wait_for(ask(), 90)) == [
            {"text": "back-p"}, {"text": "back-q"}]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()[-3000:]
        assert "serving Backend dyn://hello.Backend.generate" in proc.stdout.read()
    finally:
        for p in (proc, store):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()


DEPLOY = PKG / "deploy"


def _deploy_texts():
    helm = sorted((DEPLOY / "helm").rglob("*.yaml"))
    return {str(p.relative_to(REPO)): p.read_text()
            for p in helm + [DEPLOY / "docker-compose.yml"]}


def test_helm_chart_and_compose_run_the_ports_modules():
    """The port's Helm chart and compose file run ``python -m`` modules of
    ``dynamo_tpu_torch`` that exist, and none of the JAX package; the
    compose worker serves ``out=torch`` on an ``nvidia.com/gpu`` device;
    the chart's RBAC names the port's CRD (group and plural of
    ``deploy/crd.yaml``), and the operator it runs renders
    ``nvidia.com/gpu`` requests."""
    import re

    import yaml

    texts = _deploy_texts()
    assert {"dynamo_tpu_torch/deploy/docker-compose.yml",
            "dynamo_tpu_torch/deploy/helm/dynamo-tpu-torch/templates/operator.yaml",
            "dynamo_tpu_torch/deploy/helm/dynamo-tpu-torch/templates/api-store.yaml",
            "dynamo_tpu_torch/deploy/helm/dynamo-tpu-torch/templates/rbac.yaml",
            "dynamo_tpu_torch/deploy/helm/dynamo-tpu-torch/Chart.yaml",
            "dynamo_tpu_torch/deploy/helm/dynamo-tpu-torch/values.yaml"} <= set(texts)
    run = []
    for name, text in texts.items():
        assert not re.search(r"\bdynamo_tpu\.", text), name
        run += re.findall(r"-m\s+(dynamo_tpu_torch[\w.]*)", text)
        run += re.findall(r"-\s+-m\s*\n\s*-\s+(dynamo_tpu_torch[\w.]*)", text)
        run += re.findall(r"^\s*-\s+(dynamo_tpu_torch\.[\w.]*)\s*$", text,
                          re.M)
    assert {"dynamo_tpu_torch.deploy.api_store",
            "dynamo_tpu_torch.deploy.operator_main",
            "dynamo_tpu_torch.runtime.transports.dynstore",
            "dynamo_tpu_torch.cli.run", "dynamo_tpu_torch.cli.metrics"} <= set(run)
    for mod in run:
        path = REPO.joinpath(*mod.split("."))
        assert path.with_suffix(".py").exists() or (path / "__init__.py").exists(), mod

    compose = yaml.safe_load(texts["dynamo_tpu_torch/deploy/docker-compose.yml"])
    worker = compose["services"]["worker"]
    assert "out=torch" in worker["command"]
    (dev,) = worker["deploy"]["resources"]["reservations"]["devices"]
    assert dev["device_ids"] == ["nvidia.com/gpu=0"] and dev["capabilities"] == ["gpu"]
    for svc in ("frontend", "processor", "dynstore", "metrics-aggregator"):
        assert "deploy" not in compose["services"][svc], svc

    crd = yaml.safe_load((DEPLOY / "crd.yaml").read_text())
    rbac = texts["dynamo_tpu_torch/deploy/helm/dynamo-tpu-torch/templates/rbac.yaml"]
    assert f'apiGroups: ["{crd["spec"]["group"]}"]' in rbac
    plural = crd["spec"]["names"]["plural"]
    assert f'"{plural}", "{plural}/status"' in rbac

    from dynamo_tpu_torch.deploy import operator

    assert operator.GPU_RESOURCE == "nvidia.com/gpu"
    assert (operator.GROUP, operator.PLURAL) == (crd["spec"]["group"], plural)


def test_static_scan_finds_no_jax_or_reference_imports():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names if _blocked(n)]
    assert not offenders, offenders


def test_dynstore_runs_as_a_module_without_msgpack():
    """``python -m dynamo_tpu_torch.runtime.transports.dynstore`` in an
    interpreter that refuses ``msgpack``, ``jax`` and ``dynamo_tpu``: the
    reference's client (msgpack on its side) puts and gets a key through
    it, and the broker exits 0 on SIGINT."""
    import asyncio
    import signal
    import socket

    from dynamo_tpu.runtime.transports.dynstore import DynStoreClient

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = textwrap.dedent(f"""
        import importlib.abc, runpy, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if any(name == r or name.startswith(r + ".")
                       for r in {REFUSED!r}):
                    raise ImportError("refused import of " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(REPO)!r})
        sys.argv = ["dynstore", "--host", "127.0.0.1", "--port", "{port}"]
        runpy.run_module("dynamo_tpu_torch.runtime.transports.dynstore",
                         run_name="__main__")
        assert "msgpack" not in sys.modules
    """)
    proc = subprocess.Popen([sys.executable, "-c", script], cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        async def talk():
            for _ in range(200):
                try:
                    client = await DynStoreClient("127.0.0.1", port).connect()
                    break
                except OSError:
                    await asyncio.sleep(0.05)
            await client.kv_put("a/b", b"\x00\x01")
            got = await client.kv_get("a/b")
            await client.close()
            return got

        assert asyncio.run(asyncio.wait_for(talk(), 30)) == b"\x00\x01"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0, proc.stderr.read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_engine_child_runs_as_a_module_without_jax_or_reference_package(tmp_path):
    """``python -m dynamo_tpu_torch.llm.engines.subprocess_host @torch``,
    spawned by the port's host with a ``sitecustomize`` that installs the
    refusing finder in the child: the child builds the torch engine from
    the CLI's flags, serves a greedy stream and answers a ping, and at its
    exit holds no refused module and no CUDA context."""
    import asyncio
    import json

    from fixtures import make_model_dir

    from dynamo_tpu_torch.cli import run as port_run
    from dynamo_tpu_torch.llm.engines.subprocess_host import (
        TORCH_ENGINE,
        SubprocessEngine,
    )
    from dynamo_tpu_torch.runtime.engine import Context

    site = tmp_path / "site"
    site.mkdir()
    report = tmp_path / "child_modules.json"
    (site / "sitecustomize.py").write_text(textwrap.dedent(f"""
        import atexit, importlib.abc, json, sys

        def blocked(name):
            return any(name == r or name.startswith(r + ".")
                       for r in {REFUSED!r})

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if blocked(name):
                    raise ImportError("refused import of " + name)
                return None

        sys.meta_path.insert(0, Refuse())

        def _report():
            torch = sys.modules.get("torch")
            with open({str(report)!r}, "w") as f:
                json.dump({{"blocked": sorted(m for m in list(sys.modules)
                                               if blocked(m)),
                           "engine": "dynamo_tpu_torch.engine.serving"
                                     in sys.modules,
                           "cuda": bool(torch is not None
                                        and torch.cuda.is_initialized())}}, f)

        atexit.register(_report)
    """))
    d = make_model_dir(tmp_path, config_overrides=dict(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=512))
    extra = tmp_path / "f32.json"
    extra.write_text(json.dumps({"dtype": "float32"}))
    flags = port_run.parse_flags([
        "--model-path", d, "--device", "cpu", "--allow-random-weights",
        "--extra-engine-args", str(extra), "--max-model-len", "64",
        "--num-kv-blocks", "16", "--kv-block-size", "8", "--isolate-engine"])
    env = dict(os.environ, PYTHONPATH=str(site), CUDA_VISIBLE_DEVICES="")
    async def main():
        eng = await SubprocessEngine.load(
            TORCH_ENGINE, {"flags": port_run.wire_flags(flags)}, child_env=env,
            heartbeat_interval_s=0.1)
        try:
            payload = {"token_ids": [3, 7, 11],
                       "stop_conditions": {"max_tokens": 3},
                       "sampling_options": {"temperature": 0.0}}
            toks = [t async for c in eng.generate(Context(payload))
                    for t in c.get("token_ids", [])]
            for _ in range(100):
                if eng.metrics():
                    break
                await asyncio.sleep(0.05)
            return toks, eng.metrics()
        finally:
            await eng.close()

    toks, metrics = asyncio.run(asyncio.wait_for(main(), 120))
    assert len(toks) == 3 and metrics
    got = json.loads(report.read_text())
    assert got == {"blocked": [], "engine": True, "cuda": False}, got
