"""The planner's admission half: HTTP-edge admission control.

The port's copy of ``dynamo_tpu/planner``'s :class:`AdmissionController`
(priority classes from ``X-Priority``, bounded per-class queues with a
deadline, shedding and the recovery drain's gate). The closed-loop SLA
planner beside it (``signals``, ``policy``, ``planner``, ``actuation``)
is not ported yet, and the CLI refuses its ``--planner*`` flags by name.
"""

from .admission import (
    PRIORITY_CLASSES,
    PRIORITY_HEADER,
    AdmissionConfig,
    AdmissionController,
    AdmissionRejected,
    parse_priority,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "AdmissionRejected",
    "PRIORITY_CLASSES",
    "PRIORITY_HEADER",
    "parse_priority",
]
