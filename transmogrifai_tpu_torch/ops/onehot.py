"""One-hot pivots of categorical text and multi-pick lists (counterpart of
``transmogrifai_tpu/ops/onehot.py``: ``OneHotVectorizer``,
``MultiPickListVectorizer`` and their models).

String work stays on the host.  The fit keeps each feature's top-K levels by
count (ties by value) that reach the minimum support, with the reference's
``Counter`` and sort, so the vocabularies come out equal.  Each slot's raw
values encode to int32 level codes (vocab index, ``k`` = OTHER, ``k+1`` =
null, or -1 when nulls are untracked).  The device half writes every slot's
one-hot block into one (n, sum of widths) output with one launch of the
encode kernel (``perf/kernels/encode.py``, K4's slots).  A multi-pick row
lights several levels, which no single level code can say, so the
multi-pick model stays on the host, as in the reference.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Column
from ..perf.kernels import encode as KE
from ..stages.base import Param, SequenceEstimator, Transformer
from ..types import OPSet, OPVector, Text
from ..utils.vector_metadata import (
    NULL_INDICATOR,
    OTHER_INDICATOR,
    VectorColumnMetadata,
    VectorMetadata,
)

TOP_K_DEFAULT = 20          # the reference Transmogrifier's TopK
MIN_SUPPORT_DEFAULT = 10    # and its MinSupport
#: per-slot bound on the serving code memo (high-cardinality junk values must
#: not grow an unbounded cache inside a long-lived scoring process)
_CODE_MEMO_MAX = 65536


def clean_text_value(v: str) -> str:
    """Normalize a categorical level (reference TextParams.cleanText semantics)."""
    return "".join(ch for ch in v.strip() if ch.isalnum() or ch == " ")


class _OneHotFitMixin:
    def _fit_vocab(self, value_lists: Sequence[Sequence[str]]) -> List[List[str]]:
        """Per input feature: ordered kept levels (top-K by count, min support)."""
        vocabs = []
        for values in value_lists:
            counts = Counter(values)
            kept = [
                v for v, c in counts.most_common()
                if c >= self.min_support
            ]
            # stable order: count desc, then value asc (deterministic across runs)
            kept = sorted(kept, key=lambda v: (-counts[v], v))[: self.top_k]
            vocabs.append(kept)
        return vocabs


class OneHotVectorizer(_OneHotFitMixin, SequenceEstimator):
    """Single-select categorical (PickList/ComboBox/location text) pivot."""

    sequence_input_type = Text
    output_type = OPVector

    top_k = Param(default=TOP_K_DEFAULT)
    min_support = Param(default=MIN_SUPPORT_DEFAULT)
    clean_text = Param(default=True)
    track_nulls = Param(default=True)

    def _levels_of(self, col: Column) -> List[str]:
        out = []
        cleaned: Dict[str, str] = {}  # each distinct raw value cleaned once
        for v in col.data:
            if v is None or v == "":
                continue
            if self.clean_text:
                c = cleaned.get(v)
                if c is None:
                    c = cleaned[v] = clean_text_value(v)
                v = c
            out.append(v)
        return out

    def fit_columns(self, cols, dataset, device):
        vocabs = self._fit_vocab([self._levels_of(c) for c in cols])
        return OneHotVectorizerModel(
            vocabs=vocabs, clean_text=self.clean_text, track_nulls=self.track_nulls)


class OneHotVectorizerModel(Transformer):
    sequence_input_type = Text
    output_type = OPVector

    def __init__(self, vocabs: List[List[str]], clean_text: bool = True,
                 track_nulls: bool = True, **kw):
        super().__init__(**kw)
        self.vocabs = vocabs
        self.clean_text = clean_text
        self.track_nulls = track_nulls

    def slot_width(self, slot: int) -> int:
        return len(self.vocabs[slot]) + 1 + (1 if self.track_nulls else 0)

    def device_lifts_input(self, slot: int) -> bool:
        return True

    def encode_device_input(self, slot: int, col: Column) -> np.ndarray:
        """Text column -> int32 level codes; raw values memoize their code per
        slot, so steady-state serving encodes a level with one dict hit."""
        memo = self._code_memo(slot)
        try:
            codes = [memo.get(v, -2) for v in col.data]
        except TypeError:  # unhashable junk value: let the typed path reject it
            codes = [-2] * len(col.data)
        if -2 in codes:
            vocab = self.vocabs[slot]
            index = {lv: i for i, lv in enumerate(vocab)}
            k = len(vocab)
            null_code = k + 1 if self.track_nulls else -1
            for i, c in enumerate(codes):
                if c != -2:
                    continue
                raw = v = col.data[i]
                try:  # a value met earlier in this column
                    c = memo.get(raw, -2)
                except TypeError:
                    pass
                if c == -2:
                    if v is not None and type(v) is not str:  # noqa: E721
                        v = self.inputs[slot].ftype._convert(v)
                    if v is None or v == "":
                        c = null_code
                    else:
                        c = index.get(clean_text_value(v) if self.clean_text else v, k)
                    if len(memo) < _CODE_MEMO_MAX:
                        try:
                            memo[raw] = c
                        except TypeError:
                            pass
                codes[i] = c
        return np.asarray(codes, dtype=np.int32)

    def _code_memo(self, slot: int) -> Dict:
        memos = self.__dict__.setdefault("_code_memos", {})
        return memos.setdefault(slot, {})

    def device_slot_specs(self) -> Tuple[KE.SlotSpec, ...]:
        return tuple(KE.onehot_slot(self.slot_width(slot))
                     for slot in range(len(self.vocabs)))

    def device_transform(self, *codes: torch.Tensor) -> torch.Tensor:
        """Every slot's block, in slot order, from one encode launch."""
        return KE.encode_slots(codes, KE.slot_table(self.device_slot_specs()))

    def _meta(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for f, vocab in zip(self.inputs, self.vocabs):
            for level in vocab:
                cols.append(VectorColumnMetadata(f.name, f.ftype.__name__,
                                                 grouping=f.name, indicator_value=level))
            cols.append(VectorColumnMetadata(f.name, f.ftype.__name__,
                                             grouping=f.name, indicator_value=OTHER_INDICATOR))
            if self.track_nulls:
                cols.append(VectorColumnMetadata(f.name, f.ftype.__name__,
                                                 grouping=f.name, indicator_value=NULL_INDICATOR))
        return VectorMetadata(self.output_name, cols,
                              {f.name: f.history() for f in self.inputs}).reindexed()

    def transform_columns(self, cols, dataset):
        n = len(cols[0])
        blocks = []
        for col, vocab in zip(cols, self.vocabs):
            k = len(vocab)
            block = np.zeros((n, k + 1 + (1 if self.track_nulls else 0)), dtype=np.float32)
            index = {v: i for i, v in enumerate(vocab)}
            for i, v in enumerate(col.data):
                if v is None or v == "":
                    if self.track_nulls:
                        block[i, k + 1] = 1.0
                    continue
                j = index.get(clean_text_value(v) if self.clean_text else v)
                block[i, k if j is None else j] = 1.0
            blocks.append(block)
        return Column.vector(np.hstack(blocks), self._meta())


class MultiPickListVectorizer(_OneHotFitMixin, SequenceEstimator):
    """Multi-select categorical: each set member lights its level column."""

    sequence_input_type = OPSet
    output_type = OPVector

    top_k = Param(default=TOP_K_DEFAULT)
    min_support = Param(default=MIN_SUPPORT_DEFAULT)
    clean_text = Param(default=True)
    track_nulls = Param(default=True)

    def fit_columns(self, cols, dataset, device):
        value_lists = []
        for c in cols:
            vals = []
            for s in c.data:
                for v in s or ():
                    vals.append(clean_text_value(v) if self.clean_text else v)
            value_lists.append(vals)
        return MultiPickListVectorizerModel(
            vocabs=self._fit_vocab(value_lists), clean_text=self.clean_text,
            track_nulls=self.track_nulls)


class MultiPickListVectorizerModel(OneHotVectorizerModel):
    """Host only: a row's members light several columns of its block."""

    sequence_input_type = OPSet
    output_type = OPVector

    device_transform = None

    def device_lifts_input(self, slot: int) -> bool:
        return False

    def device_slot_specs(self):
        return None

    def transform_columns(self, cols, dataset):
        n = len(cols[0])
        blocks = []
        for col, vocab in zip(cols, self.vocabs):
            k = len(vocab)
            block = np.zeros((n, k + 1 + (1 if self.track_nulls else 0)), dtype=np.float32)
            index = {v: i for i, v in enumerate(vocab)}
            for i, members in enumerate(col.data):
                if not members:
                    if self.track_nulls:
                        block[i, k + 1] = 1.0
                    continue
                for v in members:
                    j = index.get(clean_text_value(v) if self.clean_text else v)
                    block[i, k if j is None else j] = 1.0
            blocks.append(block)
        return Column.vector(np.hstack(blocks), self._meta())
