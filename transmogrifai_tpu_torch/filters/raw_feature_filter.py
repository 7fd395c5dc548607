"""RawFeatureFilter: drops unhealthy raw features before the DAG is fitted
(the reference's counterpart: ``transmogrifai_tpu/filters/raw_feature_filter.py``).

Checks per raw predictor feature (per key for maps):

- a fill rate below ``min_fill`` (training, and scoring when given);
- a train-vs-scoring fill difference or fill ratio too large;
- a train-vs-scoring Jensen-Shannon divergence too large;
- a null indicator too correlated with the label (leakage through
  missingness).

A map feature goes only when every one of its keys goes; its bad keys are
stripped from the surviving column.  The numeric histograms run on the
device (``distribution.py``); the decisions, the null-label correlations
(float64, ``utils/stats.py::pearson_with_label``) and the DAG rewiring
(:func:`apply_blacklist`) on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..data.dataset import Column, Dataset
from ..features.feature import Feature
from ..utils.stats import pearson_with_label
from .distribution import FeatureDistribution, compute_distributions


@dataclass
class FeatureMetrics:
    """Everything RFF measured about one feature (ExclusionReasons equivalent)."""

    name: str
    key: Optional[str]
    train_fill_rate: float
    score_fill_rate: Optional[float] = None
    fill_rate_diff: Optional[float] = None
    fill_ratio_diff: Optional[float] = None
    js_divergence: Optional[float] = None
    null_label_correlation: Optional[float] = None
    reasons: List[str] = field(default_factory=list)

    @property
    def excluded(self) -> bool:
        return bool(self.reasons)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "key": self.key,
            "trainFillRate": self.train_fill_rate,
            "scoreFillRate": self.score_fill_rate,
            "fillRateDiff": self.fill_rate_diff,
            "fillRatioDiff": self.fill_ratio_diff,
            "jsDivergence": self.js_divergence,
            "nullLabelCorrelation": self.null_label_correlation,
            "exclusionReasons": self.reasons,
        }


@dataclass
class RawFeatureFilterResults:
    """Serializable record of the filter run (RawFeatureFilterResults in the reference)."""

    train_distributions: List[FeatureDistribution] = field(default_factory=list)
    score_distributions: List[FeatureDistribution] = field(default_factory=list)
    metrics: List[FeatureMetrics] = field(default_factory=list)
    excluded_features: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "trainDistributions": [d.to_dict() for d in self.train_distributions],
            "scoreDistributions": [d.to_dict() for d in self.score_distributions],
            "metrics": [m.to_dict() for m in self.metrics],
            "excludedFeatures": self.excluded_features,
        }


class RawFeatureFilter:
    """Configurable raw-feature hygiene filter (defaults mirror RawFeatureFilter.scala)."""

    def __init__(
        self,
        bins: int = 100,
        min_fill: float = 0.001,
        max_fill_difference: float = 0.90,
        max_fill_ratio_diff: float = 20.0,
        max_js_divergence: float = 0.90,
        max_correlation: float = 0.95,
        min_scoring_rows: int = 500,
        protected_features: Sequence[str] = (),
        js_divergence_protected_features: Sequence[str] = (),
        scoring_dataset: Optional[Dataset] = None,
        scoring_reader=None,
    ):
        self.bins = bins
        self.min_fill = min_fill
        self.max_fill_difference = max_fill_difference
        self.max_fill_ratio_diff = max_fill_ratio_diff
        self.max_js_divergence = max_js_divergence
        self.max_correlation = max_correlation
        self.min_scoring_rows = min_scoring_rows
        self.protected_features = set(protected_features)
        self.js_protected = set(js_divergence_protected_features)
        self.scoring_dataset = scoring_dataset
        self.scoring_reader = scoring_reader

    # -- scoring data --------------------------------------------------------
    def _get_scoring(self, raw_features: Sequence[Feature]) -> Optional[Dataset]:
        if self.scoring_dataset is not None:
            return self.scoring_dataset
        if self.scoring_reader is not None:
            return self.scoring_reader.generate_dataset(
                [f for f in raw_features if not f.is_response])
        return None

    # -- null-label leakage --------------------------------------------------
    @staticmethod
    def _null_indicator(col: Column, key: Optional[str]) -> np.ndarray:
        if key is not None:
            return np.array([1.0 if (not m or m.get(key) is None) else 0.0
                             for m in col.data], dtype=np.float64)
        return (~col.present()).astype(np.float64)

    def _null_label_correlations(
        self, dataset: Dataset, raw_features: Sequence[Feature],
        dists: Sequence[FeatureDistribution],
    ) -> Dict[Tuple[str, Optional[str]], float]:
        label_f = next((f for f in raw_features if f.is_response), None)
        if label_f is None or label_f.name not in dataset:
            return {}
        label_col = dataset[label_f.name]
        if not label_col.is_numeric:
            return {}
        y = np.nan_to_num(label_col.values_f64())
        cols = [(d.name, d.key) for d in dists]
        if not cols:
            return {}
        indicators = np.stack(
            [self._null_indicator(dataset[name], key) for name, key in cols], axis=1)
        corr = pearson_with_label(indicators, y)
        return {c: (0.0 if np.isnan(v) else float(v)) for c, v in zip(cols, corr)}

    # -- the filter ----------------------------------------------------------
    def filter_raw(
        self,
        dataset: Dataset,
        raw_features: Sequence[Feature],
        result_features: Optional[Sequence[Feature]] = None,
        *, device=None,
    ) -> Tuple[Dataset, List[str], RawFeatureFilterResults]:
        """Returns (filtered dataset, blacklist of feature names, results
        record); the histograms run on ``device`` (the CUDA card unless the
        caller names another).

        When ``result_features`` is given, the stage DAG is rewired in place
        so sequence stages drop blacklisted inputs (:func:`apply_blacklist`).
        """
        from ..perf.kernels.dispatch import resolve_device

        dev = resolve_device(device)
        train_dists = compute_distributions(dataset, raw_features, bins=self.bins,
                                            text_bins=self.bins, device=dev)
        scoring = self._get_scoring(raw_features)
        use_scoring = scoring is not None and scoring.n_rows >= self.min_scoring_rows
        score_dists: List[FeatureDistribution] = []
        score_by_key: Dict[Tuple[str, Optional[str]], FeatureDistribution] = {}
        if use_scoring:
            train_summaries = {(d.name, d.key): d.summary_info for d in train_dists}
            score_dists = compute_distributions(scoring, raw_features, bins=self.bins,
                                                text_bins=self.bins,
                                                ref_summaries=train_summaries, device=dev)
            score_by_key = {(d.name, d.key): d for d in score_dists}

        null_corr = self._null_label_correlations(dataset, raw_features, train_dists)

        metrics: List[FeatureMetrics] = []
        excluded: Set[str] = set()
        for d in train_dists:
            m = FeatureMetrics(name=d.name, key=d.key, train_fill_rate=d.fill_rate)
            protected = d.name in self.protected_features
            if d.fill_rate < self.min_fill:
                m.reasons.append(
                    f"train fill rate {d.fill_rate:.4f} below minimum {self.min_fill}")
            sd = score_by_key.get((d.name, d.key))
            if use_scoring and sd is None:
                # absent at scoring time is the most extreme drift
                m.score_fill_rate = 0.0
                m.reasons.append("feature absent from scoring data")
            if sd is not None:
                m.score_fill_rate = sd.fill_rate
                m.fill_rate_diff = d.relative_fill_delta(sd)
                m.fill_ratio_diff = d.relative_fill_ratio(sd)
                if sd.fill_rate < self.min_fill:
                    m.reasons.append(
                        f"score fill rate {sd.fill_rate:.4f} below minimum {self.min_fill}")
                if m.fill_rate_diff > self.max_fill_difference:
                    m.reasons.append(
                        f"train/score fill difference {m.fill_rate_diff:.4f} above"
                        f" {self.max_fill_difference}")
                if m.fill_ratio_diff > self.max_fill_ratio_diff:
                    m.reasons.append(
                        f"train/score fill ratio {m.fill_ratio_diff:.2f} above"
                        f" {self.max_fill_ratio_diff}")
                if d.name not in self.js_protected:
                    m.js_divergence = d.js_divergence(sd)
                    if m.js_divergence > self.max_js_divergence:
                        m.reasons.append(
                            f"train/score JS divergence {m.js_divergence:.4f} above"
                            f" {self.max_js_divergence}")
            c = null_corr.get((d.name, d.key))
            if c is not None:
                m.null_label_correlation = c
                if abs(c) > self.max_correlation:
                    m.reasons.append(
                        f"null-indicator/label correlation {c:.4f} above"
                        f" {self.max_correlation}")
            if protected and m.reasons:
                m.reasons = []  # protected features are never excluded
            metrics.append(m)
            if m.excluded:
                excluded.add(d.name)

        # a map feature is excluded only when every one of its keys is excluded;
        # per-key removal happens in the column rewrite below
        map_key_reasons: Dict[str, List[Tuple[Optional[str], bool]]] = {}
        for m in metrics:
            if m.key is not None:
                map_key_reasons.setdefault(m.name, []).append((m.key, m.excluded))
        for name, keys in map_key_reasons.items():
            if not all(bad for _, bad in keys):
                excluded.discard(name)

        blacklist = sorted(excluded)
        filtered = dataset.drop([n for n in blacklist if n in dataset.names])
        # strip excluded keys out of surviving map columns
        for name, keys in map_key_reasons.items():
            bad_keys = {k for k, bad in keys if bad}
            if name in blacklist or not bad_keys or name not in filtered.names:
                continue
            col = filtered[name]
            new = np.empty(len(col), dtype=object)
            for i, mvals in enumerate(col.data):
                new[i] = {k: v for k, v in mvals.items() if k not in bad_keys} \
                    if mvals else mvals
            filtered = filtered.with_column(name, Column(col.ftype, new, None, col.meta))

        if result_features is not None and blacklist:
            apply_blacklist(result_features, blacklist)

        results = RawFeatureFilterResults(
            train_distributions=train_dists,
            score_distributions=score_dists,
            metrics=metrics,
            excluded_features=blacklist,
        )
        return filtered, blacklist, results


def apply_blacklist(result_features: Sequence[Feature], blacklist: Sequence[str]) -> None:
    """Rewire the DAG so no stage consumes a blacklisted feature.

    Sequence stages drop the blacklisted inputs in place (output feature identity is
    preserved so downstream wiring survives); fixed-arity stages propagate the blacklist
    to their output.  A blacklisted *result* feature is an error — the model cannot be
    trained without it (OpWorkflow.setBlacklist :112-154 semantics).
    """
    bad_uids: Set[str] = set()
    by_name = set(blacklist)

    from ..workflow.dag import compute_dag

    for f in result_features:
        for raw in f.raw_features():
            if raw.name in by_name:
                bad_uids.add(raw.uid)

    # pass 1: plan (no mutation) so a blacklisted result feature leaves the DAG intact
    prune_plan: List[Tuple[Any, Tuple[Feature, ...]]] = []
    for layer in compute_dag(result_features):
        for stage in layer:
            if not any(f.uid in bad_uids for f in stage.inputs):
                continue
            remaining = tuple(f for f in stage.inputs if f.uid not in bad_uids)
            fixed = len(stage.input_types)
            is_sequence = stage.sequence_input_type is not None
            if is_sequence and len(remaining) >= fixed + stage.min_sequence_inputs \
                    and all(f.uid not in bad_uids for f in stage.inputs[:fixed]):
                prune_plan.append((stage, remaining))
            else:
                bad_uids.add(stage.get_output().uid)

    for f in result_features:
        if f.uid in bad_uids:
            raise ValueError(
                f"Result feature {f.name!r} depends only on blacklisted features; "
                "relax RawFeatureFilter thresholds or protect its inputs")

    # pass 2: apply — prune in place, keeping output feature objects (name stability)
    for stage, remaining in prune_plan:
        stage._input_features = remaining
