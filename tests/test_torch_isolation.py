"""The port imports neither jax nor anything of the JAX package.

``tests/conftest.py`` imports jax into every test process, so the import
check runs in a fresh interpreter: a ``sys.meta_path`` finder refuses
``jax``, ``jaxlib`` and ``dynamo_tpu``/``dynamo_tpu.*`` (``dynamo_tpu_torch``
is allowed), then every module of ``dynamo_tpu_torch`` and ``chip_smoke``
is imported, and CUDA must not have been initialised by any import. A
static scan of the import statements backs it up.
"""

import ast
import os
import subprocess
import sys
import textwrap
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


def _blocked(name: str) -> bool:
    return (name in ("jax", "jaxlib", "dynamo_tpu")
            or name.startswith(("jax.", "jaxlib.", "dynamo_tpu.")))


def test_blocked_names_match_exactly():
    assert _blocked("dynamo_tpu") and _blocked("dynamo_tpu.ops")
    assert _blocked("jax.numpy") and _blocked("jaxlib")
    assert not _blocked("dynamo_tpu_torch")
    assert not _blocked("dynamo_tpu_torch.ops.attention")
    assert not _blocked("jaxtyping")


def test_port_imports_without_jax_or_reference_package():
    mods = _port_modules() + ["chip_smoke"]
    # every kernel module is among them (the imports of its wrapper count)
    assert {"dynamo_tpu_torch.ops.epilogue", "dynamo_tpu_torch.ops.paged_verify",
            "dynamo_tpu_torch.ops.paged_decode",
            "dynamo_tpu_torch.ops.paged_flash"} <= set(mods)
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, sys
        for m in list(sys.modules):
            if m in ("jax", "jaxlib") or m.startswith(("jax.", "jaxlib.")):
                del sys.modules[m]

        def blocked(name):
            return (name in ("jax", "jaxlib", "dynamo_tpu")
                    or name.startswith(("jax.", "jaxlib.", "dynamo_tpu.")))

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if blocked(name):
                    raise ImportError("refused import of " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(REPO)!r})
        for m in {mods!r}:
            importlib.import_module(m)
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
