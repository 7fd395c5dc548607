"""FeatureGeneratorStage — origin stage of every raw feature (counterpart of
``transmogrifai_tpu/features/generator.py``).  It holds the extract function
(record -> typed value) and, for the aggregate and conditional readers, an
optional monoid aggregator and time window."""

from __future__ import annotations

from typing import Any, Callable, Optional, Type

from ..stages.base import PipelineStage
from ..types import FeatureType
from .feature import Feature


class FeatureGeneratorStage(PipelineStage):
    """0-input stage producing a raw feature from records."""

    def __init__(self, extract_fn: Callable[[Any], Any], ftype: Type[FeatureType],
                 output_name: str, is_response: bool = False, uid: str = "",
                 aggregator=None, aggregate_window_ms: Optional[int] = None):
        super().__init__(operation_name="featureGenStage", uid=uid)
        self.extract_fn = extract_fn
        self.ftype = ftype
        self.raw_name = output_name
        self.is_response = is_response
        self._aggregator = aggregator
        self.aggregate_window_ms = aggregate_window_ms

    @property
    def aggregator(self):
        """The monoid aggregator the aggregate readers fold events with (the
        type's default unless one was given)."""
        if self._aggregator is None:
            from ..aggregators.monoid import default_aggregator

            self._aggregator = default_aggregator(self.ftype)
        return self._aggregator

    def extract(self, record: Any) -> FeatureType:
        v = self.extract_fn(record)
        if isinstance(v, FeatureType):
            if not isinstance(v, self.ftype):
                raise TypeError(
                    f"extract for {self.raw_name!r} returned {type(v).__name__},"
                    f" expected {self.ftype.__name__}")
            return v
        return self.ftype(v)

    def get_output(self) -> Feature:
        if self._output_feature is None:
            raise ValueError(f"generator {self.raw_name!r} has no output feature")
        return self._output_feature

    def make_output_name(self) -> str:
        return self.raw_name

    def __repr__(self) -> str:
        return f"FeatureGeneratorStage({self.raw_name!r}: {self.ftype.__name__})"
