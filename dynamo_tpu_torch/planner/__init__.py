"""Closed-loop SLA planner: telemetry in, scaling/admission actions out.

The port's copy of ``dynamo_tpu/planner``: the same modules and exports.

The subsystem between observation and actuation (reference deployment
plane, PAPER.md §1 layer 9): a rolling-window :class:`SignalStore`
feeds a deterministic :class:`SlaPolicy` whose typed actions — scale a
worker pool, rebalance the disagg split, tighten admission — are
applied by pluggable actuators (K8s Reconciler patch, api-store record
update, in-process router/admission knobs). The HTTP edge's
:class:`AdmissionController` is the load-shedding end of the loop.
"""

from .admission import (
    PRIORITY_CLASSES,
    PRIORITY_HEADER,
    AdmissionConfig,
    AdmissionController,
    AdmissionRejected,
    parse_priority,
)
from .actuation import (
    KubeActuator,
    LocalActuator,
    StoreScaleActuator,
    scale_cr_service,
)
from .planner import (
    Planner,
    PlannerConfig,
    aggregator_source,
    engine_metrics_source,
    slo_source,
)
from .policy import (
    Action,
    AdmissionAction,
    PolicyConfig,
    RebalanceAction,
    ScaleAction,
    SlaPolicy,
)
from .signals import SignalStore

__all__ = [
    "Action",
    "AdmissionAction",
    "AdmissionConfig",
    "AdmissionController",
    "AdmissionRejected",
    "KubeActuator",
    "LocalActuator",
    "Planner",
    "PlannerConfig",
    "PolicyConfig",
    "PRIORITY_CLASSES",
    "PRIORITY_HEADER",
    "RebalanceAction",
    "ScaleAction",
    "SignalStore",
    "SlaPolicy",
    "StoreScaleActuator",
    "aggregator_source",
    "engine_metrics_source",
    "parse_priority",
    "scale_cr_service",
    "slo_source",
]
