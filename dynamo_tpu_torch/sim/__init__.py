"""Trace-driven fleet simulator: the port's copy of ``dynamo_tpu/sim``.

A discrete-event harness that drives the port's REAL control plane
(``SlaPolicy``, ``AdmissionController``, ``PoolManager``,
``RecoveryController``, ``KvScheduler``) on a virtual clock against
simulated workers whose service times come from the device-time byte
model (``telemetry/device_time.py``). No decision logic is forked or
mocked; the sim only substitutes time and the data plane. It runs on no
device and imports no torch.

Entry points:

- ``python3 -m dynamo_tpu_torch.cli.fleetsim``: scenario → capacity-curve
  report
- :func:`dynamo_tpu_torch.sim.scenarios.run_scenario`: programmatic runs
- :mod:`dynamo_tpu_torch.sim.workload`: synthetic generators + trace replay

The reference's ``rag_pod`` scenario and its intra-pod pull backend need a
plane between cards, which the port does not have yet: both are refused by
name (``POD_REFUSED``).
"""

from .clock import VirtualClock, run_virtual
from .scenarios import SCENARIOS, run_scenario
from .workload import Request

__all__ = [
    "VirtualClock",
    "run_virtual",
    "SCENARIOS",
    "run_scenario",
    "Request",
]
