"""Service configuration: a section per service plus the Common opt-in.

The port's copy of ``dynamo_tpu/sdk/config.py`` (reference: the upstream
SDK's ``lib/config.py``): the config document maps service name →
options; a ``Common`` section holds shared values, and a service pulls
chosen Common keys by listing them under ``common-configs``. ``as_args``
renders a service's merged options as CLI flags for its worker process.

Sources (first match wins): an explicit path or dict, then the
``DYNAMO_TPU_SERVICE_CONFIG`` environment variable (the reference's name,
so a deployment sets one). Text is JSON, or YAML where the ``yaml``
package is installed; YAML without it raises by name.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

COMMON_SECTION = "Common"
COMMON_KEY = "common-configs"
ENV_VAR = "DYNAMO_TPU_SERVICE_CONFIG"


def _load_text(text: str, origin: str = ENV_VAR) -> dict:
    """A config document: JSON, or YAML where the ``yaml`` package exists
    (the card's machine is not known to have it)."""
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        try:
            import yaml
        except ImportError:
            raise ValueError(
                f"{origin} is not JSON ({e}) and the yaml package is not "
                f"installed to read it as YAML: give the config as JSON"
            ) from None
        return yaml.safe_load(text)


class ServiceConfig:
    _instance: Optional["ServiceConfig"] = None

    def __init__(self, data: Optional[dict] = None):
        self.data: dict = data or {}

    @classmethod
    def get_instance(cls) -> "ServiceConfig":
        if cls._instance is None:
            text = os.environ.get(ENV_VAR)
            cls._instance = cls(_load_text(text) if text else {})
        return cls._instance

    @classmethod
    def from_file(cls, path: str) -> "ServiceConfig":
        with open(path) as f:
            return cls(_load_text(f.read(), path) or {})

    def get(self, service: str) -> Dict[str, Any]:
        """A service's options merged with the Common keys it opts into.

        The service's own value wins over Common's for the same key. An
        opted-in key that Common lacks is skipped (a service may opt into
        keys only some deployments define).
        """
        section = dict(self.data.get(service, {}))
        wanted = section.pop(COMMON_KEY, [])
        common = self.data.get(COMMON_SECTION, {})
        merged: Dict[str, Any] = {
            k: common[k] for k in wanted if k in common
        }
        merged.update(section)
        return merged

    def as_args(self, service: str) -> List[str]:
        """Options as CLI flags: a true bool is a bare flag (false is left
        out), a list repeats its flag, anything else is ``--key value``."""
        args: List[str] = []
        for key, value in self.get(service).items():
            flag = f"--{key}"
            if isinstance(value, bool):
                if value:
                    args.append(flag)
            elif isinstance(value, (list, tuple)):
                for item in value:
                    args.extend([flag, str(item)])
            else:
                args.extend([flag, str(value)])
        return args
