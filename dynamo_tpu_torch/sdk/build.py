"""Graph artifact packaging: the ``dynamo build`` analog.

The port's copy of ``dynamo_tpu/sdk/build.py`` (reference analog:
deploy/dynamo/sdk/src/dynamo/sdk/cli/{build,bentos}.py): a graph target
is packaged into a versioned, content-addressed bundle (``name:version``)
that the api-store registers and the operator deploys by version, so a
cluster deploy pins exactly what it runs. The bundle is a plain tarball
(the runtime image is a deploy-time concern):

    <name>-<version>.dyn.tar.gz
    ├── manifest.json      # the record below
    ├── config.<ext>       # the graph's service config, verbatim
    └── src/<files...>     # the source of every service class in the graph

``version`` is the first 12 hex digits of the sha256 over the manifest's
content-bearing fields (graph target, service topology, config, code
digests, model-card checksums): the same build twice gives the same
version; any drift in code or config gives a new one.

``deployment_spec`` writes a service's cards as ``gpus`` (the port's
operator renders ``nvidia.com/gpu`` from it); a manifest whose service
asks for ``tpu`` raises by name.

CLI:
    python -m dynamo_tpu_torch.sdk.build \\
        dynamo_tpu_torch.examples.llm.graphs.agg:Frontend \\
        -f dynamo_tpu_torch/examples/llm/configs/agg.json -o ./artifacts
    python -m dynamo_tpu_torch.sdk.build --inspect artifacts/agg-ab12cd34ef56.dyn.tar.gz

Deploy by artifact: ``llmctl deploy create NAME --from-artifact
<tarball>``; the record's spec embeds ``{artifact: {name, version, ...}}``
and the operator surfaces the version in the CR status
(``artifactVersion``).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tarfile
from typing import Dict, List, Optional

from .allocator import refuse_tpu
from .service import ServiceDefinition, graph_services

SCHEMA = "dynamo-tpu/artifact.v1"

# service-class → operator role mapping (deploy/operator.py ROLE_ARGS);
# anything unrecognized deploys as a generic worker unless the config
# names a role explicitly
_KNOWN_ROLES = {
    "frontend": "frontend",
    "processor": "processor",
    "worker": "worker",
    "decode": "decode",
    "decodeworker": "decode",
    "prefill": "prefill",
    "prefillworker": "prefill",
}


@dataclasses.dataclass
class Artifact:
    path: str
    manifest: dict

    @property
    def name(self) -> str:
        return self.manifest["name"]

    @property
    def version(self) -> str:
        return self.manifest["version"]


def _load_target(target: str) -> ServiceDefinition:
    """``pkg.module:Service`` or ``path/to/file.py:Service`` → the root
    ServiceDefinition of the graph."""
    if ":" not in target:
        raise ValueError(
            f"graph target {target!r} must be '<module-or-file>:<Service>'"
        )
    mod_ref, attr = target.rsplit(":", 1)
    if mod_ref.endswith(".py") or os.path.sep in mod_ref:
        spec = importlib.util.spec_from_file_location(
            "dynamo_graph_" + hashlib.sha256(mod_ref.encode()).hexdigest()[:8],
            mod_ref,
        )
        if spec is None:
            raise FileNotFoundError(mod_ref)
        module = importlib.util.module_from_spec(spec)
        # without the sys.modules entry, inspect.getsourcefile on classes
        # defined in the file raises TypeError — which would silently ship
        # an artifact with no code digests
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(mod_ref)
    root = getattr(module, attr)
    if not isinstance(root, ServiceDefinition):
        raise TypeError(f"{target} is not a @service-decorated class")
    return root


def _service_record(svc: ServiceDefinition) -> dict:
    name = svc.cls.__name__
    return {
        "class": name,
        "role": _KNOWN_ROLES.get(name.lower(), "worker"),
        "namespace": svc.spec.namespace,
        "workers": svc.spec.workers,
        "resources": svc.spec.resources,
        "endpoints": sorted(svc.endpoints),
        "links": [d.cls.__name__ for d in svc.links],
    }


def _source_files(services: List[ServiceDefinition]) -> List[str]:
    import inspect

    files = []
    for svc in services:
        try:
            f = inspect.getsourcefile(svc.cls)
        except TypeError:
            f = None
        if f and os.path.exists(f) and f not in files:
            files.append(f)
    return files


def _git_commit(paths: List[str]) -> Optional[str]:
    anchor = os.path.dirname(os.path.abspath(paths[0])) if paths else "."
    try:
        out = subprocess.run(
            ["git", "-C", anchor, "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10,
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        return None


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return "sha256:" + h.hexdigest()


def _model_cards(config: dict) -> Dict[str, str]:
    """Checksums of every model a config references (pin the weights a
    version deploys, not just the code)."""
    cards: Dict[str, str] = {}

    def walk(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in ("model-path", "model_path", "modelPath") and \
                        isinstance(v, str) and os.path.isdir(v):
                    try:
                        from ..llm.model_card import ModelDeploymentCard

                        cards[v] = ModelDeploymentCard.from_local_path(v).checksum
                    # dynlint: allow(silent-except) - failure IS recorded: checksum "unavailable"
                    except Exception:  # unreadable model dir: record absence
                        cards[v] = "unavailable"
                else:
                    walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(config)
    return cards


def build_artifact(
    target: str,
    config_path: Optional[str] = None,
    output_dir: str = ".",
    name: Optional[str] = None,
) -> Artifact:
    root = _load_target(target)
    services = graph_services(root)
    config: dict = {}
    config_text = ""
    if config_path:
        from .config import _load_text

        with open(config_path) as f:
            config_text = f.read()
        config = _load_text(config_text, config_path) or {}

    src_files = _source_files(services)
    repo_anchor = os.path.commonpath(src_files) if src_files else "."
    if os.path.isfile(repo_anchor):
        repo_anchor = os.path.dirname(repo_anchor)
    digests = {
        os.path.relpath(f, repo_anchor): _sha256_file(f) for f in src_files
    }

    mod_ref = target.rsplit(":", 1)[0]
    default_name = (
        os.path.basename(mod_ref).removesuffix(".py")
        if mod_ref.endswith(".py") or os.path.sep in mod_ref
        else mod_ref.rsplit(".", 1)[-1]
    )
    manifest = {
        "schema": SCHEMA,
        "name": name or default_name,
        "graph_target": target,
        "services": {
            svc.cls.__name__: _service_record(svc) for svc in services
        },
        "config": config,
        "code": {
            "git_commit": _git_commit(src_files),
            "digests": digests,
        },
        "model_cards": _model_cards(config),
    }
    # content-addressed version: everything that changes what would run.
    # created/git_commit excluded — a rebuild of identical content from a
    # dirty checkout or at a later time must not mint a new version
    basis = json.dumps(
        {k: manifest[k] for k in
         ("schema", "graph_target", "services", "config", "model_cards")}
        | {"digests": digests},
        sort_keys=True,
    ).encode()
    manifest["version"] = hashlib.sha256(basis).hexdigest()[:12]

    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(
        output_dir, f"{manifest['name']}-{manifest['version']}.dyn.tar.gz"
    )

    def add_bytes(tar, arcname, data: bytes):
        info = tarfile.TarInfo(arcname)
        info.size = len(data)
        info.mtime = 0
        tar.addfile(info, io.BytesIO(data))

    # byte-identical archives for identical content: entry mtimes are
    # zeroed AND the gzip header's embedded timestamp is pinned (no
    # "created" field in the manifest — the api-store records creation
    # time; the artifact records only what runs)
    import gzip

    with open(out_path, "wb") as raw, \
            gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as gz, \
            tarfile.open(fileobj=gz, mode="w") as tar:
        add_bytes(tar, "manifest.json",
                  json.dumps(manifest, indent=2).encode())
        if config_path:
            add_bytes(tar, "config" + os.path.splitext(config_path)[1],
                      config_text.encode())
        for f in src_files:
            with open(f, "rb") as fh:
                add_bytes(tar, os.path.join(
                    "src", os.path.relpath(f, repo_anchor)), fh.read())
    return Artifact(path=out_path, manifest=manifest)


def inspect_artifact(path: str) -> dict:
    with tarfile.open(path, "r:gz") as tar:
        try:
            f = tar.extractfile("manifest.json")
        except KeyError:
            f = None
        if f is None:
            raise ValueError(f"{path}: no manifest.json")
        manifest = json.loads(f.read().decode())
    if manifest.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: unknown artifact schema {manifest.get('schema')!r}"
        )
    return manifest


def deployment_spec(manifest: dict) -> dict:
    """Render an api-store/CR deployment spec from an artifact manifest —
    what ``llmctl deploy create --from-artifact`` registers and
    deploy/operator.py renders into cluster manifests."""
    services: Dict[str, dict] = {}
    for cls_name, rec in manifest["services"].items():
        resources = rec.get("resources") or {}
        refuse_tpu(resources, f"the artifact's service {cls_name}")
        svc: dict = {"role": rec["role"], "replicas": rec.get("workers", 1)}
        gpus = resources.get("gpu")
        if gpus:
            svc["gpus"] = gpus
        services[cls_name.lower()] = svc
    # per-service config carries deploy fields through, with the sdk's
    # Common/common-configs inheritance applied (ServiceConfig.get — the
    # same merge serve-time uses, so e.g. a model-path a Worker opts into
    # from Common reaches the rendered spec)
    from .config import ServiceConfig

    cfg = ServiceConfig(manifest.get("config") or {})
    for cls_name in manifest["services"]:
        key = cls_name.lower()
        merged = cfg.get(cls_name)
        for src_key, dst_key in (
            ("model-path", "modelPath"), ("model_path", "modelPath"),
            ("modelPath", "modelPath"), ("model-name", "modelName"),
            ("replicas", "replicas"),
            ("env", "env"), ("extraArgs", "extraArgs"),
        ):
            if src_key in merged:
                services[key][dst_key] = merged[src_key]
    spec: dict = {
        "services": services,
        "artifact": {
            "name": manifest["name"],
            "version": manifest["version"],
            "graphTarget": manifest["graph_target"],
            "gitCommit": (manifest.get("code") or {}).get("git_commit"),
            "modelCards": manifest.get("model_cards") or {},
        },
    }
    ns = {rec["namespace"] for rec in manifest["services"].values()}
    if len(ns) == 1:
        spec["namespace"] = ns.pop()
    return spec


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="dynamo-tpu-torch build",
        description="package a service graph into a versioned artifact",
    )
    p.add_argument("target", nargs="?",
                   help="<module-or-file>:<ServiceClass> graph root")
    p.add_argument("-f", "--config", default=None,
                   help="the graph's service config (JSON; YAML where the "
                        "yaml package is installed)")
    p.add_argument("-o", "--output-dir", default=".")
    p.add_argument("--name", default=None, help="artifact name override")
    p.add_argument("--inspect", default=None, metavar="TARBALL",
                   help="print an artifact's manifest and exit")
    args = p.parse_args(argv)
    if args.inspect:
        print(json.dumps(inspect_artifact(args.inspect), indent=2))
        return 0
    if not args.target:
        p.error("target is required (or use --inspect)")
    art = build_artifact(
        args.target, config_path=args.config,
        output_dir=args.output_dir, name=args.name,
    )
    print(f"built {art.name}:{art.version} -> {art.path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
