"""Typed feature DAG nodes (counterpart of ``transmogrifai_tpu/features/feature.py``).

A ``Feature`` knows its ``origin_stage`` and that stage's input features
(``parents``); the scoring plan walks this DAG back from the result features
to the raw ones.  DAGs are rebuilt from saved models or wired by hand:
``FeatureBuilder`` makes raw features and ``feature.transform_with(stage,
*others)`` applies a stage.
"""

from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Tuple, Type

from ..types import FeatureType

if TYPE_CHECKING:  # pragma: no cover
    from ..stages.base import PipelineStage


_uid_counter = itertools.count()


def feature_uid() -> str:
    """A fresh unique feature id."""
    return f"Feature_{next(_uid_counter):012x}"


class Feature:
    """A typed node in the feature lineage DAG."""

    __slots__ = ("name", "ftype", "is_response", "origin_stage", "parents", "uid",
                 "distributions")

    def __init__(self, name: str, ftype: Type[FeatureType], is_response: bool,
                 origin_stage: Optional["PipelineStage"],
                 parents: Tuple["Feature", ...] = (), uid: str = "",
                 distributions: Tuple = ()):
        if not issubclass(ftype, FeatureType):
            raise TypeError(f"ftype must be a FeatureType subclass, got {ftype!r}")
        if not uid:
            raise ValueError(f"feature {name!r} needs a uid")
        self.name = name
        self.ftype = ftype
        self.is_response = is_response
        self.origin_stage = origin_stage
        self.parents = tuple(parents)
        self.uid = uid
        self.distributions = tuple(distributions)

    def __hash__(self) -> int:
        return hash(self.uid)

    def __eq__(self, other) -> bool:
        return isinstance(other, Feature) and other.uid == self.uid

    def __repr__(self) -> str:
        kind = "response" if self.is_response else "predictor"
        return f"Feature<{self.ftype.__name__}>({self.name!r}, {kind}, uid={self.uid})"

    @property
    def is_raw(self) -> bool:
        return len(self.parents) == 0

    @property
    def origin_stage_name(self) -> str:
        return self.origin_stage.operation_name if self.origin_stage else "raw"

    def transform_with(self, stage: "PipelineStage", *others: "Feature") -> "Feature":
        """Apply ``stage`` to this feature (and co-inputs); its output feature."""
        stage.set_input(self, *others)
        return stage.get_output()

    def raw_features(self) -> List["Feature"]:
        """All raw ancestors (deduplicated, stable depth-first order)."""
        seen: Dict[str, Feature] = {}
        visited: set = set()
        stack: List[Feature] = [self]
        while stack:
            f = stack.pop()
            if f.uid in visited:
                continue
            visited.add(f.uid)
            if f.is_raw:
                seen.setdefault(f.uid, f)
            else:
                stack.extend(reversed(f.parents))
        return list(seen.values())

    def parent_stages(self) -> Dict["PipelineStage", int]:
        """Stage -> max distance from this feature (0 = its own origin stage)."""
        distances: Dict["PipelineStage", int] = {}
        frontier: List[Tuple[Feature, int]] = [(self, 0)]
        while frontier:
            feat, dist = frontier.pop()
            stage = feat.origin_stage
            if stage is None:
                continue
            prev = distances.get(stage)
            if prev is None or dist > prev:
                distances[stage] = dist
                for p in feat.parents:
                    frontier.append((p, dist + 1))
        return distances

    def all_features(self) -> List["Feature"]:
        """Every feature in this feature's ancestry, itself included, once each."""
        seen: Dict[str, Feature] = {}
        stack = [self]
        while stack:
            f = stack.pop()
            if f.uid in seen:
                continue
            seen[f.uid] = f
            stack.extend(f.parents)
        return list(seen.values())

    def pretty_parent_stages(self, indent: int = 0) -> str:
        """Human-readable lineage tree."""
        lines = [f"{'  ' * indent}{'+-- ' if indent else ''}{self.origin_stage_name} -> "
                 f"{self.name} ({self.ftype.__name__})"]
        for p in self.parents:
            lines.append(p.pretty_parent_stages(indent + 1))
        return "\n".join(lines)

    def as_raw(self, is_response: Optional[bool] = None) -> "Feature":
        """A raw copy of this feature, read by name from a record (no lineage)."""
        from .generator import FeatureGeneratorStage

        resp = self.is_response if is_response is None else is_response
        stage = FeatureGeneratorStage(extract_fn=_NamedExtract(self.name),
                                      ftype=self.ftype, output_name=self.name,
                                      is_response=resp)
        return stage.get_output()

    def history(self) -> "FeatureHistory":
        """Provenance (origin raw features, stage operation names) that
        vector metadata records per input feature (``.to_dict()``)."""
        origins = sorted(f.name for f in self.raw_features()) \
            if not self.is_raw else [self.name]
        stages = sorted({s.operation_name for s in self.parent_stages()})
        return FeatureHistory(origin_features=origins, stages=stages)


class _NamedExtract:
    """Extract function reading a named field from a record dict."""

    __slots__ = ("key",)

    def __init__(self, key: str):
        self.key = key

    def __call__(self, record):
        if isinstance(record, dict):
            return record.get(self.key)
        return getattr(record, self.key, None)

    def __repr__(self):
        return f"_NamedExtract({self.key!r})"


class FeatureHistory:
    """Provenance of a derived feature: its raw origins and the operation
    names of the stages between."""

    __slots__ = ("origin_features", "stages")

    def __init__(self, origin_features: Iterable[str], stages: Iterable[str]):
        self.origin_features = list(origin_features)
        self.stages = list(stages)

    def to_dict(self) -> dict:
        return {"originFeatures": self.origin_features, "stages": self.stages}

    def merge(self, other: "FeatureHistory") -> "FeatureHistory":
        return FeatureHistory(
            sorted(set(self.origin_features) | set(other.origin_features)),
            sorted(set(self.stages) | set(other.stages)))

    def __repr__(self):
        return f"FeatureHistory(origins={self.origin_features}, stages={self.stages})"
