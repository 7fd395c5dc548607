"""One-hot pivot of categorical text (counterpart of ``transmogrifai_tpu/ops/onehot.py``,
scoring half of ``OneHotVectorizerModel``).

String work stays on the host: each slot's raw values encode to int32 level
codes (vocab index, ``k`` = OTHER, ``k+1`` = null, or -1 when nulls are
untracked).  The device half writes every slot's one-hot block into one
(n, sum of widths) output with one launch of the encode kernel
(``perf/kernels/encode.py``, K4's slots).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..data.dataset import Column
from ..perf.kernels import encode as KE
from ..stages.base import Transformer
from ..utils.vector_metadata import (
    NULL_INDICATOR,
    OTHER_INDICATOR,
    VectorColumnMetadata,
    VectorMetadata,
)

#: per-slot bound on the serving code memo (high-cardinality junk values must
#: not grow an unbounded cache inside a long-lived scoring process)
_CODE_MEMO_MAX = 65536


def clean_text_value(v: str) -> str:
    """Normalize a categorical level (reference TextParams.cleanText semantics)."""
    return "".join(ch for ch in v.strip() if ch.isalnum() or ch == " ")


class OneHotVectorizerModel(Transformer):

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
                if v is not None and type(v) is not str:  # noqa: E721
                    v = self.inputs[slot].ftype._convert(v)
                if v is None or v == "":
                    c = null_code
                else:
                    c = index.get(clean_text_value(v) if self.clean_text else v, k)
                codes[i] = c
                if len(memo) < _CODE_MEMO_MAX:
                    try:
                        memo[raw] = c
                    except TypeError:
                        pass
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
