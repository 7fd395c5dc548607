"""Random hyperparameter-search builder (the reference's counterpart:
``transmogrifai_tpu/models/random_param.py``, copied: the same
``np.random.default_rng`` stream gives the same grids).

Builds N random param maps from per-param distributions (uniform over a
range, exponential/log-uniform, a subset of discrete values) to feed a
ModelSelector instead of an exhaustive grid.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

_UNIFORM = "uniform"
_EXPONENTIAL = "exponential"
_SUBSET = "subset"


class RandomParamBuilder:
    """Accumulates param distributions, then samples N param maps.

    >>> grids = (RandomParamBuilder(seed=7)
    ...          .exponential("reg_param", 1e-4, 1e-1)
    ...          .uniform("max_depth", 2, 8, integer=True)
    ...          .subset("elastic_net", [0.0, 0.5, 1.0])
    ...          .build(10))
    """

    def __init__(self, seed: int = 42):
        self._rng = np.random.default_rng(seed)
        self._params: List[Tuple[str, str, Any, Any, Sequence[Any]]] = []

    def uniform(self, name: str, lo: float, hi: float,
                integer: bool = False) -> "RandomParamBuilder":
        if not lo < hi:
            raise ValueError(f"uniform({name!r}): min must be less than max")
        self._params.append((name, _UNIFORM, lo, hi, (integer,)))
        return self

    def exponential(self, name: str, lo: float, hi: float) -> "RandomParamBuilder":
        """Log-uniform over [lo, hi]; both bounds must be positive."""
        if not 0 < lo < hi:
            raise ValueError(f"exponential({name!r}): need 0 < min < max")
        self._params.append((name, _EXPONENTIAL, lo, hi, ()))
        return self

    def subset(self, name: str, values: Sequence[Any]) -> "RandomParamBuilder":
        if not values:
            raise ValueError(f"subset({name!r}): need at least one value")
        self._params.append((name, _SUBSET, None, None, list(values)))
        return self

    def build(self, n: int) -> List[Dict[str, Any]]:
        if not self._params:
            raise ValueError("no param distributions added")
        out: List[Dict[str, Any]] = []
        for _ in range(n):
            grid: Dict[str, Any] = {}
            for name, dist, lo, hi, extra in self._params:
                if dist == _UNIFORM:
                    integer = extra[0]
                    if integer:
                        grid[name] = int(self._rng.integers(int(lo), int(hi) + 1))
                    else:
                        grid[name] = float(self._rng.uniform(lo, hi))
                elif dist == _EXPONENTIAL:
                    grid[name] = float(np.exp(
                        self._rng.uniform(np.log(lo), np.log(hi))))
                else:
                    grid[name] = extra[int(self._rng.integers(0, len(extra)))]
            out.append(grid)
        return out
