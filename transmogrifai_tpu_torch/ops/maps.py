"""Map vectorizers: per-key expansion of row-wise maps (counterpart of
``transmogrifai_tpu/ops/maps.py``).

A fit discovers each map's key set on the host; every key becomes a
pseudo-column vectorized like its scalar counterpart (mean fill + null
indicator for numerics and geolocations, a top-K pivot for categorical
strings and sets), with the metadata ``grouping`` = the key, so the
SanityChecker groups its categorical statistics by key.  Keys are sorted,
and cleaned where the reference cleans them: two raw keys that clean to one
merge their counts in the fit, and in a transform the later one wins.  All
of it is host work, as in the reference: the models have no device half.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

from ..data.dataset import Column
from ..features.feature import Feature
from ..stages.base import Param, SequenceEstimator, Transformer
from ..types import OPMap, OPVector
from ..types.maps import _BooleanMap, _DoubleMap, _LongMap, _SetMap, _StringMap
from ..utils.vector_metadata import (
    NULL_INDICATOR,
    OTHER_INDICATOR,
    VectorColumnMetadata,
    VectorMetadata,
)
from .onehot import MIN_SUPPORT_DEFAULT, TOP_K_DEFAULT, clean_text_value


class NumericMapVectorizer(SequenceEstimator):
    """Real/Integral/Binary maps -> per-key impute(mean)+null-indicator columns."""

    sequence_input_type = OPMap
    output_type = OPVector

    track_nulls = Param(default=True)
    clean_keys = Param(default=True)

    def _key(self, k: str) -> str:
        return clean_text_value(k) if self.clean_keys else k

    def fit_columns(self, cols, dataset, device):
        keys: List[List[str]] = []
        fills: List[Dict[str, float]] = []
        for col in cols:
            sums: Dict[str, float] = {}
            counts: Dict[str, int] = {}
            for m in col.data:
                for k, v in (m or {}).items():
                    k = self._key(k)
                    sums[k] = sums.get(k, 0.0) + float(v)
                    counts[k] = counts.get(k, 0) + 1
            ks = sorted(sums)
            keys.append(ks)
            fills.append({k: sums[k] / counts[k] for k in ks})
        return NumericMapVectorizerModel(
            keys=keys, fills=fills, track_nulls=self.track_nulls,
            clean_keys=self.clean_keys,
        )


class NumericMapVectorizerModel(Transformer):
    sequence_input_type = OPMap
    output_type = OPVector

    def __init__(self, keys: List[List[str]], fills: List[Dict[str, float]],
                 track_nulls: bool = True, clean_keys: bool = True, **kw):
        super().__init__(**kw)
        self.keys = keys
        self.fills = fills
        self.track_nulls = track_nulls
        self.clean_keys = clean_keys

    def _key(self, k: str) -> str:
        return clean_text_value(k) if self.clean_keys else k

    def transform_columns(self, cols, dataset):
        n = len(cols[0])
        blocks: List[np.ndarray] = []
        meta_cols: List[VectorColumnMetadata] = []
        for f, col, keys, fills in zip(self.inputs, cols, self.keys, self.fills):
            per_key = 2 if self.track_nulls else 1
            block = np.zeros((n, len(keys) * per_key), dtype=np.float32)
            index = {k: j for j, k in enumerate(keys)}
            for j, k in enumerate(keys):
                block[:, j * per_key] = fills[k]
                if self.track_nulls:
                    block[:, j * per_key + 1] = 1.0
            for i, m in enumerate(col.data):
                for k, v in (m or {}).items():
                    j = index.get(self._key(k))
                    if j is not None:
                        block[i, j * per_key] = float(v)
                        if self.track_nulls:
                            block[i, j * per_key + 1] = 0.0
            blocks.append(block)
            for k in keys:
                meta_cols.append(VectorColumnMetadata(f.name, f.ftype.__name__, grouping=k))
                if self.track_nulls:
                    meta_cols.append(VectorColumnMetadata(
                        f.name, f.ftype.__name__, grouping=k,
                        indicator_value=NULL_INDICATOR))
        meta = VectorMetadata(
            self.output_name, meta_cols,
            {f.name: f.history().to_dict() for f in self.inputs},
        ).reindexed()
        return Column.vector(np.hstack(blocks) if blocks else np.zeros((n, 0), np.float32),
                             meta)


class TextMapPivotVectorizer(SequenceEstimator):
    """String maps -> per-key top-K pivot (+OTHER, +null indicator)."""

    sequence_input_type = OPMap
    output_type = OPVector

    top_k = Param(default=TOP_K_DEFAULT)
    min_support = Param(default=MIN_SUPPORT_DEFAULT)
    clean_text = Param(default=True)
    track_nulls = Param(default=True)

    def fit_columns(self, cols, dataset, device):
        vocabs: List[Dict[str, List[str]]] = []
        for col in cols:
            counts: Dict[str, Counter] = {}
            for m in col.data:
                for k, v in (m or {}).items():
                    k = clean_text_value(k) if self.clean_text else k
                    if isinstance(v, (set, frozenset, list, tuple)):
                        vals = [clean_text_value(x) if self.clean_text else x for x in v]
                    else:
                        vals = [clean_text_value(v) if self.clean_text else v]
                    c = counts.setdefault(k, Counter())
                    for x in vals:
                        if x:
                            c[x] += 1
            vocab: Dict[str, List[str]] = {}
            for k in sorted(counts):
                kept = [v for v, c in counts[k].items() if c >= self.min_support]
                vocab[k] = sorted(kept, key=lambda v: (-counts[k][v], v))[: self.top_k]
            vocabs.append(vocab)
        return TextMapPivotVectorizerModel(
            vocabs=vocabs, clean_text=self.clean_text, track_nulls=self.track_nulls
        )


class TextMapPivotVectorizerModel(Transformer):
    sequence_input_type = OPMap
    output_type = OPVector

    def __init__(self, vocabs: List[Dict[str, List[str]]], clean_text: bool = True,
                 track_nulls: bool = True, **kw):
        super().__init__(**kw)
        self.vocabs = vocabs
        self.clean_text = clean_text
        self.track_nulls = track_nulls

    def transform_columns(self, cols, dataset):
        n = len(cols[0])
        blocks: List[np.ndarray] = []
        meta_cols: List[VectorColumnMetadata] = []
        for f, col, vocab in zip(self.inputs, cols, self.vocabs):
            keys = sorted(vocab)
            offsets: Dict[str, int] = {}
            width = 0
            for k in keys:
                offsets[k] = width
                width += len(vocab[k]) + 1 + (1 if self.track_nulls else 0)
            block = np.zeros((n, width), dtype=np.float32)
            if self.track_nulls:
                for k in keys:
                    block[:, offsets[k] + len(vocab[k]) + 1] = 1.0
            for i, m in enumerate(col.data):
                cleaned = {}
                for k, v in (m or {}).items():
                    cleaned[clean_text_value(k) if self.clean_text else k] = v
                for k in keys:
                    if k not in cleaned:
                        continue
                    base = offsets[k]
                    kv = len(vocab[k])
                    if self.track_nulls:
                        block[i, base + kv + 1] = 0.0
                    v = cleaned[k]
                    vals = v if isinstance(v, (set, frozenset, list, tuple)) else [v]
                    for x in vals:
                        x = clean_text_value(x) if self.clean_text else x
                        try:
                            j = vocab[k].index(x)
                            block[i, base + j] = 1.0
                        except ValueError:
                            block[i, base + kv] = 1.0  # OTHER
            blocks.append(block)
            for k in keys:
                for level in vocab[k]:
                    meta_cols.append(VectorColumnMetadata(
                        f.name, f.ftype.__name__, grouping=k, indicator_value=level))
                meta_cols.append(VectorColumnMetadata(
                    f.name, f.ftype.__name__, grouping=k, indicator_value=OTHER_INDICATOR))
                if self.track_nulls:
                    meta_cols.append(VectorColumnMetadata(
                        f.name, f.ftype.__name__, grouping=k, indicator_value=NULL_INDICATOR))
        meta = VectorMetadata(
            self.output_name, meta_cols,
            {f.name: f.history().to_dict() for f in self.inputs},
        ).reindexed()
        return Column.vector(np.hstack(blocks) if blocks else np.zeros((n, 0), np.float32),
                             meta)


def transmogrify_maps(features: Sequence[Feature]) -> List[Feature]:
    """Default vectorization for map features, grouped by value family.

    Mirrors the reference's per-type defaults: date maps take the unit-circle
    encoding (DateMapToUnitCircleVectorizer), free-text maps the per-key smart
    categorical-vs-text decision (SmartTextMapVectorizer), categorical-string
    and set maps the per-key pivot, numeric/boolean maps mean-fill + null track.
    """
    from ..types.maps import DateMap, TextAreaMap, TextMap

    numeric: List[Feature] = []
    stringy: List[Feature] = []
    dateish: List[Feature] = []
    smart_text: List[Feature] = []
    for f in features:
        if issubclass(f.ftype, DateMap):  # DateTimeMap subclasses DateMap
            dateish.append(f)
        elif issubclass(f.ftype, (_DoubleMap, _LongMap, _BooleanMap)):
            numeric.append(f)
        elif issubclass(f.ftype, (TextMap, TextAreaMap)):
            smart_text.append(f)
        elif issubclass(f.ftype, (_StringMap, _SetMap)):
            stringy.append(f)
        else:
            from ..types import GeolocationMap

            if issubclass(f.ftype, GeolocationMap):
                # geo maps: treat each key's [lat,lon,acc] triple numerically via mean-fill
                numeric.append(f)
            else:
                raise NotImplementedError(
                    f"No map vectorizer for {f.ftype.__name__} yet"
                )
    out: List[Feature] = []
    if numeric:
        geo = [f for f in numeric if f.ftype.__name__ == "GeolocationMap"]
        plain = [f for f in numeric if f.ftype.__name__ != "GeolocationMap"]
        if plain:
            out.append(plain[0].transform_with(NumericMapVectorizer(), *plain[1:]))
        if geo:
            out.append(geo[0].transform_with(GeolocationMapVectorizer(), *geo[1:]))
    if stringy:
        out.append(stringy[0].transform_with(TextMapPivotVectorizer(), *stringy[1:]))
    if smart_text:
        from .text_smart import SmartTextMapVectorizer

        out.append(smart_text[0].transform_with(
            SmartTextMapVectorizer(), *smart_text[1:]))
    if dateish:
        from .collections_lift import DateMapToUnitCircleVectorizer

        out.append(dateish[0].transform_with(
            DateMapToUnitCircleVectorizer(), *dateish[1:]))
    return out


class GeolocationMapVectorizer(SequenceEstimator):
    """Geolocation maps -> per-key [lat, lon, accuracy] mean-filled + null indicator."""

    sequence_input_type = OPMap
    output_type = OPVector

    track_nulls = Param(default=True)

    def fit_columns(self, cols, dataset, device):
        keys: List[List[str]] = []
        fills: List[Dict[str, np.ndarray]] = []
        for col in cols:
            sums: Dict[str, np.ndarray] = {}
            counts: Dict[str, int] = {}
            for m in col.data:
                for k, v in (m or {}).items():
                    if len(v) != 3:
                        continue
                    arr = np.asarray(v, dtype=np.float64)
                    sums[k] = sums.get(k, np.zeros(3)) + arr
                    counts[k] = counts.get(k, 0) + 1
            ks = sorted(sums)
            keys.append(ks)
            fills.append({k: sums[k] / counts[k] for k in ks})
        return GeolocationMapVectorizerModel(keys=keys, fills=fills,
                                             track_nulls=self.track_nulls)


class GeolocationMapVectorizerModel(Transformer):
    sequence_input_type = OPMap
    output_type = OPVector

    def __init__(self, keys: List[List[str]], fills: List[Dict[str, np.ndarray]],
                 track_nulls: bool = True, **kw):
        super().__init__(**kw)
        self.keys = keys
        self.fills = fills
        self.track_nulls = track_nulls

    def transform_columns(self, cols, dataset):
        n = len(cols[0])
        blocks: List[np.ndarray] = []
        meta_cols: List[VectorColumnMetadata] = []
        for f, col, keys, fills in zip(self.inputs, cols, self.keys, self.fills):
            per_key = 3 + (1 if self.track_nulls else 0)
            block = np.zeros((n, len(keys) * per_key), dtype=np.float32)
            index = {k: j for j, k in enumerate(keys)}
            for j, k in enumerate(keys):
                block[:, j * per_key: j * per_key + 3] = fills[k]
                if self.track_nulls:
                    block[:, j * per_key + 3] = 1.0
            for i, m in enumerate(col.data):
                for k, v in (m or {}).items():
                    j = index.get(k)
                    if j is not None and len(v) == 3:
                        block[i, j * per_key: j * per_key + 3] = v
                        if self.track_nulls:
                            block[i, j * per_key + 3] = 0.0
            blocks.append(block)
            for k in keys:
                for d in ("lat", "lon", "accuracy"):
                    meta_cols.append(VectorColumnMetadata(
                        f.name, f.ftype.__name__, grouping=k, descriptor_value=d))
                if self.track_nulls:
                    meta_cols.append(VectorColumnMetadata(
                        f.name, f.ftype.__name__, grouping=k,
                        indicator_value=NULL_INDICATOR))
        meta = VectorMetadata(
            self.output_name, meta_cols,
            {f.name: f.history().to_dict() for f in self.inputs},
        ).reindexed()
        return Column.vector(np.hstack(blocks) if blocks else np.zeros((n, 0), np.float32),
                             meta)
