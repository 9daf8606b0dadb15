"""Model Deployment Card: the single source of truth for a served model.

Reference analog: lib/llm/src/model_card/model.rs:55-360 — display name,
service slug, model info, tokenizer, prompt formatter, context length, KV
block size, and a checksum that lets routers/workers verify they agree on
preprocessing. Built from a local HF snapshot directory (config.json +
tokenizer.json + tokenizer_config.json).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import Any, Dict, List, Optional


def slugify(name: str) -> str:
    return re.sub(r"[^a-z0-9_.-]+", "-", name.lower()).strip("-")


@dataclasses.dataclass
class ModelDeploymentCard:
    display_name: str
    slug: str
    model_path: Optional[str] = None
    context_length: int = 4096
    kv_block_size: int = 16
    chat_template: Optional[str] = None
    bos_token_id: Optional[int] = None
    eos_token_ids: List[int] = dataclasses.field(default_factory=list)
    bos_token: Optional[str] = None
    eos_token: Optional[str] = None
    model_type: str = "chat"  # "chat" | "completions" | "both"
    # how this model emits tool calls (llm/tools.py FORMATS); "auto" probes
    tool_call_format: Optional[str] = "auto"
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checksum: Optional[str] = None

    def __post_init__(self):
        if self.checksum is None:
            self.checksum = self.compute_checksum()

    def compute_checksum(self) -> str:
        """Hash of everything that affects preprocessing agreement."""
        basis = json.dumps(
            {
                "display_name": self.display_name,
                "context_length": self.context_length,
                "kv_block_size": self.kv_block_size,
                "chat_template": self.chat_template,
                "bos_token_id": self.bos_token_id,
                "eos_token_ids": self.eos_token_ids,
            },
            sort_keys=True,
        ).encode()
        return hashlib.sha256(basis).hexdigest()[:16]

    @classmethod
    def from_local_path(
        cls,
        model_dir: str,
        display_name: Optional[str] = None,
        kv_block_size: int = 16,
    ) -> "ModelDeploymentCard":
        name = display_name or os.path.basename(os.path.normpath(model_dir))
        cfg_path = os.path.join(model_dir, "config.json")
        config: Dict[str, Any] = {}
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                config = json.load(f)

        eos = config.get("eos_token_id")
        eos_ids = [] if eos is None else ([eos] if isinstance(eos, int) else list(eos))
        bos = config.get("bos_token_id")
        context_length = int(
            config.get("max_position_embeddings")
            or config.get("n_positions")
            or 4096
        )

        chat_template = None
        bos_token = eos_token = None
        tc_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(tc_path):
            with open(tc_path) as f:
                tc = json.load(f)
            chat_template = tc.get("chat_template")
            if isinstance(chat_template, list):  # multi-template form
                named = {t.get("name"): t.get("template") for t in chat_template}
                chat_template = named.get("default") or next(iter(named.values()), None)

            def _tok_str(v):
                return v.get("content") if isinstance(v, dict) else v

            bos_token = _tok_str(tc.get("bos_token"))
            eos_token = _tok_str(tc.get("eos_token"))

        return cls(
            display_name=name,
            slug=slugify(name),
            model_path=os.path.abspath(model_dir),
            context_length=context_length,
            kv_block_size=kv_block_size,
            chat_template=chat_template,
            bos_token_id=bos,
            eos_token_ids=eos_ids,
            bos_token=bos_token,
            eos_token=eos_token,
            config=config,
        )

    def to_wire(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("config", None)  # big and derivable from model_path
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "ModelDeploymentCard":
        d = dict(d)
        d.setdefault("config", {})
        return cls(**d)
