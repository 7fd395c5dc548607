"""serve — online scoring (counterpart of ``transmogrifai_tpu/serve``).

A fitted model binds to the card as a :class:`~.plan.CompiledScoringPlan`
(host encode, a device prefix with one encode launch per batch, a host
remainder); requests flow through an adaptive bounded queue
(:class:`~.batcher.MicroBatcher`, flush on size or deadline, pipelined
flushes), the fault-tolerance layer (:class:`~.resilience.ResilientScorer`)
and the blue/green swapper (:class:`~.swap.SwappableScorer`);
:class:`~.server.ScoringServer` composes them behind an in-process API.
:class:`~.registry.FleetServer` serves many tenants' models behind one
batcher (:class:`~.registry.ModelRegistry`: device-memory admission with
LRU eviction, TM509; reduced-precision classes, :class:`~.plan.Precision`,
behind the TM511 calibration gate), and ``serve/validator.py`` holds the
TM5xx/TM601 gates.
"""

from .batcher import (  # noqa: F401
    DEFAULT_SLO_CLASSES,
    BatcherClosedError,
    MicroBatcher,
    QueueFullError,
    SloClass,
)
from .faults import (  # noqa: F401
    CircuitOpenError,
    DeadlineExceededError,
    FaultHarness,
    LoadShedError,
    PoisonRecordError,
    TransientScoringError,
    is_retryable,
)
from .plan import TM511_BOUNDS, CompiledScoringPlan, Precision, compile_plan  # noqa: F401
from .registry import FleetServer, ModelRegistry, TenantState, UnknownTenantError  # noqa: F401
from .resilience import CircuitBreaker, ResilientScorer  # noqa: F401
from .server import ScoringServer  # noqa: F401
from .swap import ModelEntry, SwappableScorer, prediction_delta  # noqa: F401
from .validator import (  # noqa: F401
    check_fleet_admission,
    check_plan_admission,
    check_precision_parity,
    check_resilience_config,
    check_servability,
    check_swap_compatibility,
)

__all__ = [
    "BatcherClosedError",
    "CircuitBreaker",
    "CircuitOpenError",
    "CompiledScoringPlan",
    "DEFAULT_SLO_CLASSES",
    "DeadlineExceededError",
    "FaultHarness",
    "FleetServer",
    "LoadShedError",
    "MicroBatcher",
    "ModelEntry",
    "ModelRegistry",
    "PoisonRecordError",
    "Precision",
    "TM511_BOUNDS",
    "QueueFullError",
    "ResilientScorer",
    "ScoringServer",
    "SloClass",
    "SwappableScorer",
    "TenantState",
    "TransientScoringError",
    "UnknownTenantError",
    "check_fleet_admission",
    "check_plan_admission",
    "check_precision_parity",
    "check_resilience_config",
    "check_servability",
    "check_swap_compatibility",
    "compile_plan",
    "is_retryable",
    "prediction_delta",
]
