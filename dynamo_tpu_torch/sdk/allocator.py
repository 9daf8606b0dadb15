"""The cards of the serve supervisor: one disjoint set per worker.

The port's counterpart of ``dynamo_tpu/sdk/allocator.py`` (whose
``TpuAllocator`` sets ``TPU_VISIBLE_CHIPS``), after the upstream SDK's
``ResourceAllocator.assign_gpus`` (reference:
deploy/dynamo/sdk/src/dynamo/sdk/cli/allocator.py:35-136): each spawned
worker gets its cards through ``CUDA_VISIBLE_DEVICES`` from its
``resources["gpu"]``, and a service with no ``gpu`` gets
``CUDA_VISIBLE_DEVICES=""``, so it never opens a CUDA context. The cards
are counted with ``nvidia-smi -L`` (or ``torch.cuda.device_count()``
where that tool is missing); ``DYNAMO_TPU_NUM_GPUS`` overrides the count.
A ``tpu`` resource raises by name.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, List, Optional, Tuple

NUM_GPUS_ENV = "DYNAMO_TPU_NUM_GPUS"


class AllocationError(RuntimeError):
    pass


def refuse_tpu(resources: Optional[Dict], where: str) -> None:
    """A ``tpu`` resource asks for a card the port does not serve."""
    if resources and "tpu" in resources:
        raise AllocationError(
            f"{where} asks for resources {{'tpu': {resources['tpu']!r}}}: the "
            f"PyTorch port serves NVIDIA cards; ask for 'gpu' instead")


class GpuAllocator:
    def __init__(self, total_gpus: Optional[int] = None):
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        # the names this process sees its cards by: a child's
        # CUDA_VISIBLE_DEVICES must name them, not their indices here
        self._names: Optional[List[str]] = (
            [c.strip() for c in visible.split(",") if c.strip()]
            if visible is not None else None)
        if total_gpus is None:
            env = os.environ.get(NUM_GPUS_ENV)
            total_gpus = int(env) if env else self._detect()
        self.total_gpus = total_gpus
        self._free: List[int] = list(range(total_gpus))

    def _detect(self) -> int:
        """The local card count, without a CUDA context in this process."""
        if self._names is not None:
            return len(self._names)
        try:
            out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                 text=True, timeout=30)
            if out.returncode == 0:
                return sum(1 for line in out.stdout.splitlines()
                           if line.startswith("GPU "))
        except (OSError, subprocess.TimeoutExpired):
            pass
        import torch

        return torch.cuda.device_count()

    @property
    def available(self) -> int:
        return len(self._free)

    def assign(self, count: int) -> List[int]:
        """Take ``count`` cards; raises when over-subscribed."""
        if count > self.available:
            raise AllocationError(
                f"need {count} GPUs, {self.available} of {self.total_gpus} left")
        gpus, self._free = self._free[:count], self._free[count:]
        return gpus

    def release(self, gpus: List[int]) -> None:
        """Give cards back (their worker exited) for reassignment."""
        self._free = sorted(set(self._free) | set(gpus))

    def env_for(self, resources: Dict) -> Tuple[Dict[str, str], List[int]]:
        """(env, cards) for one worker from its resource request
        (``{'gpu': N}``, or none for a service that needs no card). The
        caller owns the cards and ``release``s them when the worker
        exits."""
        refuse_tpu(resources, "a service")
        n = int(resources.get("gpu", 0))
        if n <= 0:
            return {"CUDA_VISIBLE_DEVICES": ""}, []
        gpus = self.assign(n)
        names = (self._names if self._names is not None
                 else [str(i) for i in range(self.total_gpus)])
        return {"CUDA_VISIBLE_DEVICES": ",".join(names[g] for g in gpus)}, gpus
