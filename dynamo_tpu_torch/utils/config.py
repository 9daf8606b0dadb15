"""Layered runtime configuration: defaults → TOML files → DYN_* env.

The port's copy of ``dynamo_tpu/utils/config.py`` (reference analog:
lib/runtime/src/config.rs:26-176, Figment layering of
``Serialized::defaults`` / ``/opt/dynamo/{defaults,etc}/runtime.toml`` /
``Env::prefixed("DYN_RUNTIME_")`` with empty env values filtered out).
Same precedence (env on top), dataclass-typed, the standard library's
``tomllib``.

Usage:
    @dataclasses.dataclass
    class MyConfig:
        num_workers: int = 16

    cfg = from_settings(MyConfig, "DYN_RUNTIME_")
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tomllib
from typing import Optional, Sequence, Type, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

# the reference's search order: the defaults file, then the site file;
# later layers win
DEFAULT_CONFIG_FILES = (
    "/opt/dynamo/defaults/runtime.toml",
    "/opt/dynamo/etc/runtime.toml",
)
CONFIG_PATH_ENV = "DYN_CONFIG_PATH"  # one more TOML file, the top file layer


def _coerce(raw: str, field_type) -> object:
    """An env string → the dataclass field's type. ``field_type`` may be a
    string (postponed annotations) or a type."""
    t = field_type if isinstance(field_type, str) else str(field_type)
    if "bool" in t:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if "int" in t:
        return int(raw)
    if "float" in t:
        return float(raw)
    if "ist[" in t or t == "list":  # List[...] / list[...]
        return json.loads(raw)
    return raw


def from_settings(
    cls: Type[T],
    env_prefix: str,
    config_files: Sequence[str] = DEFAULT_CONFIG_FILES,
    section: Optional[str] = None,
) -> T:
    """Build ``cls`` from its defaults, the TOML layers, then
    ``{env_prefix}FIELD`` env vars (an empty value counts as unset, as the
    reference's filter_map does). Unknown TOML keys are skipped with a
    debug line; a bad env value raises, so a misconfiguration fails at
    startup."""
    values = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}

    paths = list(config_files)
    extra = os.environ.get(CONFIG_PATH_ENV)
    if extra:
        paths.append(extra)
    for path in paths:
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            data = tomllib.load(f)
        if section is not None:
            data = data.get(section, {})
        for key, value in data.items():
            if key in fields:
                values[key] = value
            else:
                logger.debug("ignoring unknown config key %s in %s", key, path)

    for name, field in fields.items():
        raw = os.environ.get(f"{env_prefix}{name.upper()}")
        if raw:  # empty env vars count as unset (the reference's rule)
            values[name] = _coerce(raw, field.type)
    return cls(**values)


@dataclasses.dataclass
class RuntimeSettings:
    """A worker process's runtime settings (the reference's
    RuntimeConfig / WorkerConfig).

    ``DYN_RUNTIME_NUM_WORKER_THREADS`` sizes the blocking-work executor;
    ``DYN_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT`` bounds the HTTP front's drain
    on SIGTERM.
    """

    num_worker_threads: int = 16
    graceful_shutdown_timeout: float = 30.0

    @classmethod
    def from_settings(cls) -> "RuntimeSettings":
        base = from_settings(cls, "DYN_RUNTIME_", section="runtime")
        # the reference reads the shutdown timeout under DYN_WORKER_
        raw = os.environ.get("DYN_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT")
        if raw:
            base.graceful_shutdown_timeout = float(raw)
        return base
