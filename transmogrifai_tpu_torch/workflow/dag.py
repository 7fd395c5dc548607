"""DAG scheduling — layer stages by max distance to the result features.

Counterpart of ``transmogrifai_tpu/workflow/dag.py``: a stage's layer is its
maximum distance from any result feature; layers run from the deepest
(closest to the raw features) to distance 0, and stages within a layer are
ordered by uid, so the port visits stages in the reference's order.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

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


def compute_dag(result_features: Sequence[Feature]) -> List[List["PipelineStage"]]:
    """Layered DAG of non-generator stages, dependency layers first."""
    cycle = find_feature_cycle(result_features)
    if cycle is not None:
        raise ValueError(
            f"[TM101] feature DAG has a cycle through {[f.name for f in cycle]}")
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


def all_stages(result_features: Sequence[Feature]) -> List["PipelineStage"]:
    """Every non-generator stage in execution order (flattened layers)."""
    return [s for layer in compute_dag(result_features) for s in layer]
