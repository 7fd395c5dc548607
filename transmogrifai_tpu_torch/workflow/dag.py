"""DAG scheduling — layer stages by max distance to the result features.

Counterpart of ``transmogrifai_tpu/workflow/dag.py``: a stage's layer is its
maximum distance from any result feature; layers run from the deepest
(closest to the raw features) to distance 0, and stages within a layer are
ordered by uid, so the port visits stages in the reference's order.
:func:`cut_dag` splits the DAG around its model selector for
workflow-level CV.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from ..checkers.diagnostics import DagCycleError
from ..features.feature import Feature
from ..features.generator import FeatureGeneratorStage

if TYPE_CHECKING:  # pragma: no cover
    from ..stages.base import PipelineStage


def find_feature_cycle(result_features: Sequence[Feature]) -> Optional[List[Feature]]:
    """First cycle reachable from the result features, or None if acyclic
    (iterative white/grey/black DFS over feature parents)."""
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    for root in result_features:
        if color.get(root.uid, WHITE) != WHITE:
            continue
        color[root.uid] = GREY
        path: List[Feature] = [root]
        stack = [(root, iter(root.parents))]
        while stack:
            _node, it = stack[-1]
            descended = False
            for nxt in it:
                c = color.get(nxt.uid, WHITE)
                if c == GREY:
                    i = next(i for i, f in enumerate(path) if f.uid == nxt.uid)
                    return path[i:] + [nxt]
                if c == WHITE:
                    color[nxt.uid] = GREY
                    path.append(nxt)
                    stack.append((nxt, iter(nxt.parents)))
                    descended = True
                    break
            if not descended:
                done, _ = stack.pop()
                path.pop()
                color[done.uid] = BLACK
    return None


def cycle_stage_uids(cycle: Sequence[Feature]) -> List[str]:
    """Stage uids along a feature cycle (feature names for raw features)."""
    return [f.origin_stage.uid if f.origin_stage is not None else f"feature:{f.name}"
            for f in cycle]


def compute_dag(result_features: Sequence[Feature]) -> List[List["PipelineStage"]]:
    """Layered DAG of non-generator stages, dependency layers first; a
    cyclic graph raises :class:`DagCycleError` (TM101, the cycle's stage
    uids)."""
    cycle = find_feature_cycle(result_features)
    if cycle is not None:
        raise DagCycleError(cycle_stage_uids(cycle))
    distances: Dict["PipelineStage", int] = {}
    for f in result_features:
        for stage, dist in f.parent_stages().items():
            prev = distances.get(stage)
            if prev is None or dist > prev:
                distances[stage] = dist
    items = [(stage, dist) for stage, dist in distances.items()
             if not isinstance(stage, FeatureGeneratorStage)]
    if not items:
        return []
    max_dist = max(dist for _, dist in items)
    layers: List[List["PipelineStage"]] = [[] for _ in range(max_dist + 1)]
    for stage, dist in items:
        layers[max_dist - dist].append(stage)
    for layer in layers:
        layer.sort(key=lambda s: s.uid)
    return [layer for layer in layers if layer]


def raw_feature_generators(result_features: Sequence[Feature]) -> List[FeatureGeneratorStage]:
    """Every FeatureGeneratorStage reachable from the result features, once
    each, ordered by raw name."""
    seen: Dict[str, FeatureGeneratorStage] = {}
    for f in result_features:
        for raw in f.raw_features():
            stage = raw.origin_stage
            if isinstance(stage, FeatureGeneratorStage):
                seen.setdefault(stage.uid, stage)
    return sorted(seen.values(), key=lambda s: s.raw_name)


def all_stages(result_features: Sequence[Feature]) -> List["PipelineStage"]:
    """Every non-generator stage in execution order (flattened layers)."""
    return [s for layer in compute_dag(result_features) for s in layer]


def is_a(stage, cls) -> bool:
    """``isinstance(stage, cls)``, where a loaded model's estimator node
    (``stages/base.py::EstimatorStub``) counts as its estimator class."""
    from ..stages.base import EstimatorStub

    if isinstance(stage, EstimatorStub):
        own = stage._estimator_cls()
        return own is not None and issubclass(own, cls)
    return isinstance(stage, cls)


def cut_dag(result_features: Sequence[Feature]):
    """Split the DAG around its one ModelSelector for workflow-level CV:
    ``(before, during, selector)``, or None when the DAG has no selector
    (more than one raises).

    - ``before``: the selector's label-independent upstream stages, and the
      stages that make the label (a StringIndexer on the response is the
      label, not leakage): fitted once, outside CV;
    - ``during``: the upstream estimators that read the response, and
      everything downstream of them up to the selector: re-fitted per fold.
    """
    from ..models.selector import ModelSelector
    from ..stages.base import Estimator

    stages_topo = all_stages(result_features)
    selectors = [s for s in stages_topo if is_a(s, ModelSelector)]
    if not selectors:
        return None
    if len(selectors) > 1:
        raise ValueError(
            "workflow-level CV requires exactly one ModelSelector in the DAG; "
            f"found {len(selectors)}")
    sel = selectors[0]

    def ancestors(features) -> set:
        seen: set = set()
        stack = list(features)
        while stack:
            st = stack.pop().origin_stage
            if st is None or isinstance(st, FeatureGeneratorStage) or st.uid in seen:
                continue
            seen.add(st.uid)
            stack.extend(st.inputs)
        return seen

    upstream = ancestors(sel.inputs)
    label_path = ancestors(sel.inputs[:1])
    during = {s.uid for s in stages_topo
              if s.uid in upstream and s.uid not in label_path
              and isinstance(s, Estimator) and any(f.is_response for f in s.inputs)}
    changed = True
    while changed:
        changed = False
        for s in stages_topo:
            if s.uid in upstream and s.uid not in during and any(
                    p.origin_stage is not None
                    and not isinstance(p.origin_stage, FeatureGeneratorStage)
                    and p.origin_stage.uid in during for p in s.inputs):
                during.add(s.uid)
                changed = True
    before = [s for s in stages_topo if s.uid in upstream and s.uid not in during]
    return before, [s for s in stages_topo if s.uid in during], sel
