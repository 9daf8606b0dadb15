"""The port imports neither jax nor anything of the JAX package, nor the
packages it does not depend on.

``tests/conftest.py`` imports jax into every test process, so the import
check runs in a fresh interpreter: a ``sys.meta_path`` finder refuses
``jax``, ``jaxlib`` and ``dynamo_tpu``/``dynamo_tpu.*`` (``dynamo_tpu_torch``
is allowed), and the packages the reference's front stands on that the
port does not depend on (``aiohttp``, ``pydantic``, ``tokenizers``,
``regex``, ``msgpack``, ``safetensors``, ``transformers``, ``gguf``,
``ml_dtypes``: the checkpoint loader reads safetensors and GGUF files on the
standard library; ``jinja2``, a
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
           "ml_dtypes")


def _blocked(name: str) -> bool:
    return name.split(".")[0] in REFUSED


def test_blocked_names_match_exactly():
    assert _blocked("dynamo_tpu") and _blocked("dynamo_tpu.ops")
    assert _blocked("jax.numpy") and _blocked("jaxlib")
    assert not _blocked("dynamo_tpu_torch")
    assert not _blocked("dynamo_tpu_torch.ops.attention")
    assert not _blocked("jaxtyping")
    for name in ("aiohttp.web", "pydantic", "tokenizers.models", "regex",
                 "msgpack", "safetensors.torch", "transformers", "gguf",
                 "ml_dtypes"):
        assert _blocked(name)
    assert not _blocked("jinja2") and not _blocked("regexp")


def test_port_imports_without_jax_or_reference_package():
    mods = _port_modules() + ["chip_smoke"]
    # every kernel module is among them (the imports of its wrapper count)
    assert {"dynamo_tpu_torch.ops.epilogue", "dynamo_tpu_torch.ops.paged_verify",
            "dynamo_tpu_torch.ops.paged_decode", "dynamo_tpu_torch.ops.paged_flash",
            "dynamo_tpu_torch.ops.mla_decode", "dynamo_tpu_torch.models.deepseek",
            "dynamo_tpu_torch.models.mixtral", "dynamo_tpu_torch.models.quant",
            "dynamo_tpu_torch.engine.guided",
            "dynamo_tpu_torch.ops.transfer", "dynamo_tpu_torch.ops.sp_prefix",
            "dynamo_tpu_torch.parallel.ring_attention",
            "dynamo_tpu_torch.parallel.sequence",
            "dynamo_tpu_torch.llm.tokenizer", "dynamo_tpu_torch.llm.preprocessor",
            "dynamo_tpu_torch.llm.backend", "dynamo_tpu_torch.http.service",
            "dynamo_tpu_torch.protocols.openai", "dynamo_tpu_torch.cli.run",
            "dynamo_tpu_torch.telemetry.registry",
            "dynamo_tpu_torch.models.loader", "dynamo_tpu_torch.llm.gguf",
            "dynamo_tpu_torch.llm.gguf_tensors"} <= set(mods)
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


def _import_refusing_reference(mods, then=""):
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, sys
        for m in list(sys.modules):
            if m.split(".")[0] in {REFUSED!r} and m.split(".")[0] != "dynamo_tpu":
                del sys.modules[m]

        def blocked(name):
            return name.split(".")[0] in {REFUSED!r}

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
