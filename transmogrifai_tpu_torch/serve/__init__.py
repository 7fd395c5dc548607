"""serve — online scoring (counterpart of ``transmogrifai_tpu/serve``).

A fitted model binds to the card as a :class:`~.plan.CompiledScoringPlan`
(host encode, a device prefix with one encode launch per batch, a host
remainder); requests flow through an adaptive bounded queue
(:class:`~.batcher.MicroBatcher`, flush on size or deadline, pipelined
flushes), the fault-tolerance layer (:class:`~.resilience.ResilientScorer`)
and the blue/green swapper (:class:`~.swap.SwappableScorer`);
:class:`~.server.ScoringServer` composes them behind an in-process API.
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
from .plan import CompiledScoringPlan  # noqa: F401
from .resilience import CircuitBreaker, ResilientScorer  # noqa: F401
from .server import ScoringServer  # noqa: F401
from .swap import ModelEntry, SwappableScorer, prediction_delta  # noqa: F401
from .validator import check_resilience_config, check_swap_compatibility  # noqa: F401

__all__ = [
    "BatcherClosedError",
    "CircuitBreaker",
    "CircuitOpenError",
    "CompiledScoringPlan",
    "DEFAULT_SLO_CLASSES",
    "DeadlineExceededError",
    "FaultHarness",
    "LoadShedError",
    "MicroBatcher",
    "ModelEntry",
    "PoisonRecordError",
    "QueueFullError",
    "ResilientScorer",
    "ScoringServer",
    "SloClass",
    "SwappableScorer",
    "TransientScoringError",
    "check_resilience_config",
    "check_swap_compatibility",
    "is_retryable",
    "prediction_delta",
]
