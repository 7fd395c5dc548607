from .plan import CompiledScoringPlan  # noqa: F401
