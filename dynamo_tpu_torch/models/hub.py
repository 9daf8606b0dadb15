"""Resolve a model reference (a local directory or file, else a hub id) to
a local snapshot.

The port's copy of ``dynamo_tpu/models/hub.py``: a local directory or a
``.gguf`` file resolves to itself; anything else goes to
``huggingface_hub`` (imported lazily), which fetches the snapshot or
reuses its cache (``HF_HUB_OFFLINE=1`` serves the cache only). Without
``huggingface_hub`` installed, a name that is no local path is refused
with a clear ``FileNotFoundError``.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

# weights, tokenizer and metadata; consolidated or original torch files
# are skipped
_SNAPSHOT_PATTERNS = ["*.safetensors", "*.json", "*.model", "*.txt", "*.jinja"]


def resolve_model_path(name_or_path: str, revision: str | None = None) -> str:
    """A local directory or ``.gguf`` file → itself; else → the path of a
    hub snapshot. Raises a clear ``FileNotFoundError`` (not a deep stack)
    when the name is no local path and the hub cannot give it."""
    if os.path.isdir(name_or_path) or (
            os.path.isfile(name_or_path) and name_or_path.endswith(".gguf")):
        return name_or_path
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise FileNotFoundError(
            f"{name_or_path!r} is not a local directory and huggingface_hub "
            "is unavailable to fetch it") from e
    try:
        path = snapshot_download(name_or_path, revision=revision,
                                 allow_patterns=_SNAPSHOT_PATTERNS)
    except Exception as e:
        raise FileNotFoundError(
            f"cannot resolve model {name_or_path!r}: not a local directory, "
            f"and hub fetch failed ({type(e).__name__}: {e}). For air-gapped "
            "hosts pre-populate the HF cache and set HF_HUB_OFFLINE=1.") from e
    logger.info("resolved %s -> %s", name_or_path, path)
    return path
