"""Structured logging: env-filtered levels and a JSONL option.

The port's copy of ``dynamo_tpu/utils/logging.py``; every entry point
(``cli.run``, ``cli.metrics``, ``cli.llmctl``, the dynstore, the
api-store and the operator) installs it at start, so the ``DYN_LOG`` and
``DYN_LOGGING_JSONL`` that the operator's rendered pods set reach each
process.

Reference analog: lib/runtime/src/logging.rs:94-180 —
- ``DYN_LOG``             env-filter spec: ``info`` or
                          ``warn,dynamo_tpu_torch.deploy=debug``
- ``DYN_LOGGING_JSONL=1`` one JSON object per line (machine-shippable)
- ``DYN_LOG_USE_LOCAL_TZ=1`` local timestamps instead of UTC
"""

from __future__ import annotations

import json
import logging
import os
import sys
from datetime import datetime, timezone
from typing import Optional

FILTER_ENV = "DYN_LOG"
JSONL_ENV = "DYN_LOGGING_JSONL"
LOCAL_TZ_ENV = "DYN_LOG_USE_LOCAL_TZ"

_LEVELS = {
    "trace": logging.DEBUG,  # python has no TRACE; map down
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


class JsonlFormatter(logging.Formatter):
    """One JSON object per record: time, level, target, message, extras."""

    def __init__(self, local_tz: bool = False):
        super().__init__()
        self.local_tz = local_tz

    def format(self, record: logging.LogRecord) -> str:
        if self.local_tz:
            ts = datetime.fromtimestamp(record.created).astimezone()
        else:
            ts = datetime.fromtimestamp(record.created, tz=timezone.utc)
        out = {
            "time": ts.isoformat(timespec="microseconds"),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        for key in ("request_id", "stage", "stages"):
            value = getattr(record, key, None)
            if value is not None:
                out[key] = value
        if record.exc_info and record.exc_info[0] is not None:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False)


def parse_filter(spec: str, default_level: int = logging.INFO) -> tuple:
    """``"warn,foo=debug,bar.baz=error"`` → (root_level, {logger: level}).
    A spec with only per-logger directives keeps the caller's default root."""
    root = default_level
    per_logger = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, _, level = part.partition("=")
            per_logger[name.strip()] = _LEVELS.get(level.strip().lower(), logging.INFO)
        else:
            root = _LEVELS.get(part.lower(), logging.INFO)
    return root, per_logger


def setup_logging(default_level: int = logging.INFO, stream=None) -> None:
    """Install the process logging config from the DYN_* environment.

    Replaces ``logging.basicConfig`` at every binary entrypoint so one
    env surface controls format and filtering across frontend, workers,
    router, and broker — the reference's shared-format guarantee."""
    root_level, per_logger = (
        parse_filter(os.environ[FILTER_ENV], default_level)
        if os.environ.get(FILTER_ENV)
        else (default_level, {})
    )
    handler = logging.StreamHandler(stream or sys.stderr)
    if os.environ.get(JSONL_ENV, "").strip() in ("1", "true"):
        handler.setFormatter(
            JsonlFormatter(local_tz=os.environ.get(LOCAL_TZ_ENV) == "1")
        )
    else:
        handler.setFormatter(logging.Formatter(
            "%(levelname)s %(asctime)s %(name)s: %(message)s"
        ))
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(root_level)
    for name, level in per_logger.items():
        logging.getLogger(name).setLevel(level)

