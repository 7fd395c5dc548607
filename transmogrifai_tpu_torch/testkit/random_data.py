"""Random typed-data generators with null-probability control (counterpart of
``transmogrifai_tpu/testkit/random_data.py``: numpy draws, so a seed gives the
reference's values).

Reference: testkit/.../testkit/RandomReal.scala, RandomText.scala, RandomIntegral.scala,
RandomMap.scala, RandomList.scala, RandomData.scala (InfiniteStream + ProbabilityOfEmpty).

Each generator is an infinite deterministic stream: ``gen.limit(n)`` returns n raw values
(None where empty), ``gen.take(n)`` returns typed FeatureType instances.  Generators are
seeded — same seed, same data — which is what makes property-style stage tests
reproducible (SURVEY §4 "deterministic random typed-data generators").
"""

from __future__ import annotations

import string
from typing import Any, Callable, Dict, List, Optional, Sequence, Type

import numpy as np

from ..types import FeatureType


class RandomGenerator:
    """Base: infinite stream of raw values with P(empty) control."""

    def __init__(self, ftype: Type[FeatureType], seed: int = 42,
                 probability_of_empty: float = 0.0):
        self.ftype = ftype
        self.seed = seed
        self.probability_of_empty = probability_of_empty
        self._rng = np.random.default_rng(seed)

    def reset(self) -> "RandomGenerator":
        self._rng = np.random.default_rng(self.seed)
        return self

    def with_probability_of_empty(self, p: float) -> "RandomGenerator":
        self.probability_of_empty = p
        return self

    def _value(self, rng) -> Any:
        raise NotImplementedError

    def limit(self, n: int) -> List[Any]:
        """n raw values (None where the empty coin lands)."""
        out = []
        for _ in range(n):
            if self.probability_of_empty > 0 and \
                    self._rng.random() < self.probability_of_empty:
                out.append(None)
            else:
                out.append(self._value(self._rng))
        return out

    def take(self, n: int) -> List[FeatureType]:
        return [self.ftype(v) for v in self.limit(n)]


class RandomReal(RandomGenerator):
    """Gaussian / uniform / log-normal reals (RandomReal.scala distributions)."""

    def __init__(self, ftype: Optional[Type[FeatureType]] = None, seed: int = 42,
                 probability_of_empty: float = 0.0, distribution: str = "normal",
                 mean: float = 0.0, sigma: float = 1.0, low: float = 0.0,
                 high: float = 1.0):
        from ..types import Real

        super().__init__(ftype or Real, seed, probability_of_empty)
        self.distribution = distribution
        self.mean, self.sigma, self.low, self.high = mean, sigma, low, high

    @classmethod
    def normal(cls, mean: float = 0.0, sigma: float = 1.0, **kw) -> "RandomReal":
        return cls(distribution="normal", mean=mean, sigma=sigma, **kw)

    @classmethod
    def uniform(cls, low: float = 0.0, high: float = 1.0, **kw) -> "RandomReal":
        return cls(distribution="uniform", low=low, high=high, **kw)

    @classmethod
    def lognormal(cls, mean: float = 0.0, sigma: float = 1.0, **kw) -> "RandomReal":
        return cls(distribution="lognormal", mean=mean, sigma=sigma, **kw)

    def _value(self, rng):
        if self.distribution == "uniform":
            return float(rng.uniform(self.low, self.high))
        if self.distribution == "lognormal":
            return float(rng.lognormal(self.mean, self.sigma))
        return float(rng.normal(self.mean, self.sigma))


class RandomIntegral(RandomGenerator):
    def __init__(self, low: int = 0, high: int = 100, seed: int = 42,
                 probability_of_empty: float = 0.0,
                 ftype: Optional[Type[FeatureType]] = None):
        from ..types import Integral

        super().__init__(ftype or Integral, seed, probability_of_empty)
        self.low, self.high = low, high

    def _value(self, rng):
        return int(rng.integers(self.low, self.high))


class RandomBinary(RandomGenerator):
    def __init__(self, probability_of_true: float = 0.5, seed: int = 42,
                 probability_of_empty: float = 0.0):
        from ..types import Binary

        super().__init__(Binary, seed, probability_of_empty)
        self.probability_of_true = probability_of_true

    def _value(self, rng):
        return bool(rng.random() < self.probability_of_true)


class RandomText(RandomGenerator):
    """Random strings / picklist draws (RandomText.scala)."""

    def __init__(self, ftype: Optional[Type[FeatureType]] = None, seed: int = 42,
                 probability_of_empty: float = 0.0, min_len: int = 3,
                 max_len: int = 10, alphabet: str = string.ascii_lowercase,
                 domain: Optional[Sequence[str]] = None):
        from ..types import Text

        super().__init__(ftype or Text, seed, probability_of_empty)
        self.min_len, self.max_len = min_len, max_len
        self.alphabet = alphabet
        self.domain = list(domain) if domain is not None else None

    @classmethod
    def strings(cls, min_len: int = 3, max_len: int = 10, **kw) -> "RandomText":
        return cls(min_len=min_len, max_len=max_len, **kw)

    @classmethod
    def emails(cls, domain: str = "example.com", **kw) -> "RandomText":
        from ..types import Email

        g = cls(ftype=Email, **kw)
        g._email_domain = domain
        return g

    def _value(self, rng):
        if self.domain is not None:
            return str(self.domain[int(rng.integers(0, len(self.domain)))])
        n = int(rng.integers(self.min_len, self.max_len + 1))
        s = "".join(self.alphabet[int(i)] for i in
                    rng.integers(0, len(self.alphabet), n))
        if hasattr(self, "_email_domain"):
            return f"{s}@{self._email_domain}"
        return s


class RandomPickList(RandomText):
    def __init__(self, domain: Sequence[str], seed: int = 42,
                 probability_of_empty: float = 0.0):
        from ..types import PickList

        super().__init__(ftype=PickList, seed=seed,
                         probability_of_empty=probability_of_empty, domain=domain)


class RandomMultiPickList(RandomGenerator):
    def __init__(self, domain: Sequence[str], max_size: int = 3, seed: int = 42,
                 probability_of_empty: float = 0.0):
        from ..types import MultiPickList

        super().__init__(MultiPickList, seed, probability_of_empty)
        self.domain = list(domain)
        self.max_size = max_size

    def _value(self, rng):
        k = int(rng.integers(0, self.max_size + 1))
        if k == 0:
            return set()
        return {self.domain[int(i)] for i in rng.integers(0, len(self.domain), k)}


class RandomList(RandomGenerator):
    """Lists of values drawn from an element generator (RandomList.scala)."""

    def __init__(self, element: RandomGenerator, min_size: int = 0, max_size: int = 5,
                 seed: int = 42, probability_of_empty: float = 0.0,
                 ftype: Optional[Type[FeatureType]] = None):
        from ..types import TextList

        super().__init__(ftype or TextList, seed, probability_of_empty)
        self.element = element
        self.min_size, self.max_size = min_size, max_size

    def _value(self, rng):
        k = int(rng.integers(self.min_size, self.max_size + 1))
        return [self.element._value(rng) for _ in range(k)]


class RandomMap(RandomGenerator):
    """Maps with keys key0..key{k} and values from an element generator."""

    def __init__(self, element: RandomGenerator, keys: Sequence[str] = (),
                 max_size: int = 4, seed: int = 42,
                 probability_of_empty: float = 0.0,
                 ftype: Optional[Type[FeatureType]] = None):
        from ..types import TextMap

        super().__init__(ftype or TextMap, seed, probability_of_empty)
        self.element = element
        self.keys = list(keys) or [f"key{i}" for i in range(max_size)]

    def _value(self, rng):
        out = {}
        for k in self.keys:
            if rng.random() < 0.5:
                out[k] = self.element._value(rng)
        return out


class RandomVector(RandomGenerator):
    def __init__(self, dim: int, seed: int = 42, sigma: float = 1.0):
        from ..types import OPVector

        super().__init__(OPVector, seed, 0.0)
        self.dim = dim
        self.sigma = sigma

    def _value(self, rng):
        return rng.normal(0.0, self.sigma, self.dim)
