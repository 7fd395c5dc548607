"""Vector column metadata — every slot of a feature vector knows where it came from.

Host-only copy of ``transmogrifai_tpu/utils/vector_metadata.py`` (the port keeps
its own, so it never imports the JAX package).  Saved models carry it for the
SanityChecker's drop decisions and the selector's feature provenance.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

NULL_INDICATOR = "NullIndicatorValue"
OTHER_INDICATOR = "OTHER"


@dataclass(frozen=True)
class VectorColumnMetadata:
    """One slot of a feature vector."""

    parent_feature: str                 # raw/derived feature this slot derives from
    parent_type: str                    # FeatureType name of the parent
    grouping: Optional[str] = None      # group of related slots (e.g. map key, pivot group)
    indicator_value: Optional[str] = None  # categorical level ("Male", OTHER, NullIndicator)
    descriptor_value: Optional[str] = None  # continuous descriptor (e.g. "y_HourOfDay")
    index: int = 0                      # slot index within the full vector

    def make_name(self) -> str:
        parts = [self.parent_feature]
        if self.grouping:
            parts.append(self.grouping)
        if self.indicator_value:
            parts.append(self.indicator_value)
        if self.descriptor_value:
            parts.append(self.descriptor_value)
        parts.append(str(self.index))
        return "_".join(parts)

    @property
    def is_null_indicator(self) -> bool:
        return self.indicator_value == NULL_INDICATOR

    @property
    def is_other_indicator(self) -> bool:
        return self.indicator_value == OTHER_INDICATOR

    @property
    def is_indicator(self) -> bool:
        return self.indicator_value is not None

    def grouping_key(self) -> str:
        """Key identifying the categorical group this slot belongs to (for Cramér's V)."""
        return f"{self.parent_feature}:{self.grouping or ''}"

    def with_index(self, index: int) -> "VectorColumnMetadata":
        return VectorColumnMetadata(
            self.parent_feature, self.parent_type, self.grouping,
            self.indicator_value, self.descriptor_value, index,
        )

    def to_dict(self) -> dict:
        return {
            "parentFeature": self.parent_feature,
            "parentType": self.parent_type,
            "grouping": self.grouping,
            "indicatorValue": self.indicator_value,
            "descriptorValue": self.descriptor_value,
            "index": self.index,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "VectorColumnMetadata":
        return cls(
            parent_feature=d["parentFeature"],
            parent_type=d["parentType"],
            grouping=d.get("grouping"),
            indicator_value=d.get("indicatorValue"),
            descriptor_value=d.get("descriptorValue"),
            index=d.get("index", 0),
        )


@dataclass
class VectorMetadata:
    """Metadata for a whole OPVector column."""

    name: str
    columns: List[VectorColumnMetadata] = field(default_factory=list)
    history: Dict[str, dict] = field(default_factory=dict)  # feature name -> FeatureHistory dict

    @property
    def size(self) -> int:
        return len(self.columns)

    def column_names(self) -> List[str]:
        return [c.make_name() for c in self.columns]

    def reindexed(self) -> "VectorMetadata":
        cols = [c.with_index(i) for i, c in enumerate(self.columns)]
        return VectorMetadata(self.name, cols, dict(self.history))

    def select(self, indices: Sequence[int], name: Optional[str] = None) -> "VectorMetadata":
        cols = [self.columns[i] for i in indices]
        return VectorMetadata(name or self.name, cols, dict(self.history)).reindexed()

    @staticmethod
    def concat(name: str, metas: Sequence["VectorMetadata"]) -> "VectorMetadata":
        cols: List[VectorColumnMetadata] = []
        history: Dict[str, dict] = {}
        for m in metas:
            cols.extend(m.columns)
            history.update(m.history)
        return VectorMetadata(name, cols, history).reindexed()

    def grouping_keys(self) -> Dict[str, List[int]]:
        """Map categorical-group key -> slot indices (used by SanityChecker/Cramér's V)."""
        out: Dict[str, List[int]] = {}
        for c in self.columns:
            if c.is_indicator:
                out.setdefault(c.grouping_key(), []).append(c.index)
        return out

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "columns": [c.to_dict() for c in self.columns],
            "history": self.history,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "VectorMetadata":
        return cls(
            name=d["name"],
            columns=[VectorColumnMetadata.from_dict(c) for c in d.get("columns", [])],
            history=d.get("history", {}),
        )
