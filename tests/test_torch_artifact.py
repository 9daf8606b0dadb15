"""The port's graph artifacts (``sdk/build.py``) against the reference's.

Every case of the reference's ``tests/test_artifact_build.py`` has its
counterpart here on the port's agg graph
(``dynamo_tpu_torch.examples.llm.graphs.agg``) and its JSON config:
versioned, deterministic, byte-identical archives; file targets; Common
inheritance into the spec; inspect; the operator's manifests; the store
and reconcile path to ``artifactVersion``; ``llmctl deploy create
--from-artifact`` and an overlay. Held against the reference:
``deployment_spec`` of the same manifest gives the same spec field for
field, but ``gpus`` where the reference writes ``tpus``; the same graph
built by both packages records the same topology; a manifest that asks
for ``tpu`` raises by name in the port.

Tolerance: exact equality throughout.
"""

import asyncio
import copy
import json
import os
import tarfile
from pathlib import Path

import pytest

from dynamo_tpu.sdk import build as ref_build
from dynamo_tpu_torch.deploy.api_store import ApiStoreService, DeploymentStore
from dynamo_tpu_torch.deploy.operator import InMemoryKube, Reconciler
from dynamo_tpu_torch.sdk.allocator import AllocationError
from dynamo_tpu_torch.sdk.build import (
    build_artifact,
    deployment_spec,
    inspect_artifact,
)

REPO = Path(__file__).resolve().parent.parent
TARGET = "dynamo_tpu_torch.examples.llm.graphs.agg:Frontend"
CONFIG = str(REPO / "dynamo_tpu_torch/examples/llm/configs/agg.json")
REF_TARGET = "examples.llm.graphs.agg:Frontend"
REF_CONFIG = str(REPO / "examples/llm/configs/agg.yaml")


def build(tmp_path, **kw):
    return build_artifact(
        TARGET, config_path=CONFIG, output_dir=str(tmp_path), **kw
    )


def test_artifact_is_versioned_and_deterministic(tmp_path):
    a1 = build(tmp_path)
    a2 = build(tmp_path)
    assert a1.version == a2.version == a1.manifest["version"]
    assert len(a1.version) == 12
    assert a1.path.endswith(f"agg-{a1.version}.dyn.tar.gz")
    # the graph topology is captured
    svcs = a1.manifest["services"]
    assert set(svcs) == {"Frontend", "Processor", "Worker"}
    assert svcs["Frontend"]["links"] == ["Processor"]
    assert svcs["Processor"]["links"] == ["Worker"]
    assert svcs["Worker"]["resources"] == {"gpu": 1}
    # source + config are embedded; code digests pin the content
    with tarfile.open(a1.path) as tar:
        names = tar.getnames()
    assert "manifest.json" in names
    assert any(n.startswith("src/") for n in names)
    assert "config.json" in names
    assert a1.manifest["code"]["digests"]


def test_topology_matches_the_reference_build(tmp_path):
    """The same graph built by each package (each on its own components
    and config) records the same services, roles, endpoints and links;
    only the cards differ (the port's Worker asks for a ``gpu``)."""
    import sys

    sys.path.insert(0, str(REPO))
    port = build(tmp_path / "port").manifest
    ref = ref_build.build_artifact(REF_TARGET, config_path=REF_CONFIG,
                                   output_dir=str(tmp_path / "ref")).manifest
    assert port["schema"] == ref["schema"] and port["name"] == ref["name"]
    for rec in port["services"].values():
        rec.pop("resources")
    for rec in ref["services"].values():
        rec.pop("resources")
    assert port["services"] == ref["services"]


def test_version_changes_with_config(tmp_path):
    a1 = build(tmp_path)
    alt = tmp_path / "alt.json"
    doc = json.loads(open(CONFIG).read())
    doc["Extra"] = {"x": 1}
    alt.write_text(json.dumps(doc))
    a2 = build_artifact(TARGET, config_path=str(alt),
                        output_dir=str(tmp_path))
    assert a1.version != a2.version


def test_artifact_archives_are_byte_identical(tmp_path):
    a1 = build(tmp_path / "a")
    a2 = build(tmp_path / "b")
    assert a1.version == a2.version
    assert open(a1.path, "rb").read() == open(a2.path, "rb").read()


def test_file_target_digests_code_and_names_artifact(tmp_path):
    """File-path graph targets: the artifact is named after the file, its
    source is digested, and editing the code mints a NEW version."""
    graph = tmp_path / "mygraph.py"
    src = (
        "from dynamo_tpu_torch.sdk import service, dynamo_endpoint\n\n"
        "@service\n"
        "class Frontend:\n"
        "    @dynamo_endpoint()\n"
        "    async def chat(self, req):\n"
        "        yield req\n"
    )
    graph.write_text(src)
    a1 = build_artifact(f"{graph}:Frontend", output_dir=str(tmp_path))
    assert a1.name == "mygraph"
    assert a1.manifest["code"]["digests"], "file-target code not digested"
    graph.write_text(src + "\n# drift\n")
    a2 = build_artifact(f"{graph}:Frontend", output_dir=str(tmp_path))
    assert a1.version != a2.version


def test_deployment_spec_applies_common_config_inheritance(tmp_path):
    """A model-path the Worker opts into from Common (the SDK config
    convention) reaches the rendered deploy spec."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "Common": {"model-path": "/models/m8b", "model-name": "m8b"},
        "Worker": {"common-configs": ["model-path", "model-name"]},
        "Frontend": {"http-port": 8080}}))
    art = build_artifact(TARGET, config_path=str(cfg),
                         output_dir=str(tmp_path))
    spec = deployment_spec(art.manifest)
    assert spec["services"]["worker"]["modelPath"] == "/models/m8b"
    assert spec["services"]["worker"]["modelName"] == "m8b"
    # Frontend did not opt in: no model fields leak
    assert "modelPath" not in spec["services"]["frontend"]
    # the reference renders the same manifest the same way, but the card
    assert ref_build.deployment_spec(art.manifest) == _without_gpus(spec)


def _without_gpus(spec):
    out = copy.deepcopy(spec)
    for svc in out["services"].values():
        svc.pop("gpus", None)
    return out


def _with_cards(manifest, key):
    m = copy.deepcopy(manifest)
    for name, n in (("Worker", 2), ("Processor", None)):
        m["services"][name]["resources"] = {key: n} if n else {}
    return m


def test_deployment_spec_matches_the_reference_field_for_field(tmp_path):
    """The same manifest, its cards as ``tpu`` for the reference and
    ``gpu`` for the port: equal specs once ``tpus`` reads ``gpus``."""
    m = build(tmp_path).manifest
    ref = ref_build.deployment_spec(_with_cards(m, "tpu"))
    port = deployment_spec(_with_cards(m, "gpu"))
    assert ref["services"]["worker"]["tpus"] == 2
    for svc in ref["services"].values():
        if "tpus" in svc:
            svc["gpus"] = svc.pop("tpus")
    assert port == ref
    assert port["services"]["worker"]["gpus"] == 2
    assert "gpus" not in port["services"]["processor"]


def test_a_manifest_asking_for_tpu_raises_by_name(tmp_path):
    m = _with_cards(build(tmp_path).manifest, "tpu")
    with pytest.raises(AllocationError, match="Worker.*'tpu'.*'gpu'"):
        deployment_spec(m)


def test_inspect_roundtrip_and_bad_archive(tmp_path):
    art = build(tmp_path)
    m = inspect_artifact(art.path)
    assert m == art.manifest
    bogus = tmp_path / "x.tar.gz"
    with tarfile.open(bogus, "w:gz") as tar:
        pass
    with pytest.raises(ValueError):
        inspect_artifact(str(bogus))
    # the reference reads the port's artifact as its own (one schema)
    assert ref_build.inspect_artifact(art.path) == m


def test_deployment_spec_renders_operator_ready(tmp_path):
    from dynamo_tpu_torch.deploy.operator import render_manifests

    art = build(tmp_path)
    spec = deployment_spec(art.manifest)
    assert spec["artifact"]["version"] == art.version
    assert spec["services"]["worker"]["role"] == "worker"
    assert spec["services"]["worker"]["gpus"] == 1
    # the spec renders directly into cluster manifests
    cr = {"apiVersion": "dynamo.tpu/v1alpha1", "kind": "DynamoDeployment",
          "metadata": {"name": "agg1", "namespace": "default"},
          "spec": spec}
    manifests = render_manifests(cr)
    assert any(m["kind"] == "Deployment" for m in manifests)
    (worker,) = [m for m in manifests if m["kind"] == "Deployment"
                 and m["metadata"]["name"] == "agg1-worker"]
    res = worker["spec"]["template"]["spec"]["containers"][0]["resources"]
    assert res["limits"] == {"nvidia.com/gpu": "1"}


async def test_build_store_reconcile_version_in_status(tmp_path):
    """The full path: sdk.build → the --from-artifact spec → api-store →
    the operator's reconcile sourced from the store → artifactVersion in
    the record's CR status."""
    from dynamo_tpu_torch.deploy.store_source import ApiStoreClient

    art = build(tmp_path)
    spec = deployment_spec(art.manifest)

    service = ApiStoreService(DeploymentStore(":memory:"), "127.0.0.1", 0)
    await service.start()
    try:
        client = ApiStoreClient(f"http://127.0.0.1:{service.port}")
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(
            None, lambda: client.create("agg-pinned", spec))

        kube = InMemoryKube()
        rec = Reconciler(kube, status_writer=client.write_status)
        crs = await loop.run_in_executor(None, client.get_crs)
        assert len(crs) == 1
        await loop.run_in_executor(None, rec.reconcile, crs[0])

        record = await loop.run_in_executor(None, client.get, "agg-pinned")
        status = record["status"]
        assert status["artifactVersion"] == art.version
        assert status["artifactName"] == "agg"
        assert status["conditions"][0]["status"] == "True"
        # the cluster runs the artifact's services
        kinds = [k.split("/")[0] for k in kube.objects]
        assert kinds.count("Deployment") >= 4  # 3 graph svcs + dynstore
    finally:
        await service.stop()


def test_llmctl_create_from_artifact(tmp_path, capsys):
    """llmctl deploy create --from-artifact registers the rendered spec; an
    update with -f overlays fields on it."""
    from dynamo_tpu_torch.cli.llmctl import amain
    from dynamo_tpu_torch.deploy.store_source import ApiStoreClient

    async def run():
        service = ApiStoreService(DeploymentStore(":memory:"), "127.0.0.1", 0)
        await service.start()
        try:
            art = build(tmp_path)
            loop = asyncio.get_running_loop()

            def llmctl(argv):
                # the deploy plane is a sync urllib client; in production
                # it is its own process, so it runs off this loop (which
                # serves the store)
                return asyncio.run(amain(argv))

            rc = await loop.run_in_executor(None, llmctl, [
                "deploy", "create", "agg-a",
                "--from-artifact", art.path,
                "--api-store", f"http://127.0.0.1:{service.port}",
            ])
            assert rc == 0
            client = ApiStoreClient(f"http://127.0.0.1:{service.port}")
            record = await loop.run_in_executor(None, client.get, "agg-a")
            assert record["spec"]["artifact"]["version"] == art.version
            assert record["spec"] == deployment_spec(art.manifest)
            # overlay: -f on top of the artifact spec wins per field
            overlay = tmp_path / "patch.json"
            overlay.write_text(json.dumps(
                {"modelName": "m8b",
                 "services": {"worker": {"role": "worker", "gpus": 4}}}
            ))
            rc = await loop.run_in_executor(None, llmctl, [
                "deploy", "update", "agg-a",
                "--from-artifact", art.path, "-f", str(overlay),
                "--api-store", f"http://127.0.0.1:{service.port}",
            ])
            assert rc == 0
            record = await loop.run_in_executor(None, client.get, "agg-a")
            assert record["spec"]["modelName"] == "m8b"
            assert record["spec"]["services"]["worker"]["gpus"] == 4
            assert record["spec"]["artifact"]["version"] == art.version
        finally:
            await service.stop()

    asyncio.run(run())
    out = capsys.readouterr().out
    assert "created deployment agg-a" in out


def test_build_module_builds_and_inspects(tmp_path):
    """``python -m dynamo_tpu_torch.sdk.build`` builds the artifact the
    function builds, and ``--inspect`` prints its manifest."""
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.sdk.build", TARGET,
         "-f", CONFIG, "-o", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=120, cwd=str(REPO), env=env)
    assert out.returncode == 0, out.stderr
    want = build(tmp_path / "fn")
    assert out.stdout.strip() == (
        f"built agg:{want.version} -> "
        f"{tmp_path / 'out' / os.path.basename(want.path)}")
    shown = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.sdk.build", "--inspect",
         str(tmp_path / "out" / os.path.basename(want.path))],
        capture_output=True, text=True, timeout=120, cwd=str(REPO), env=env)
    assert shown.returncode == 0 and json.loads(shown.stdout) == want.manifest
