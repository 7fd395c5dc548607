"""Math transformers with empty-safe semantics (counterpart of
``transmogrifai_tpu/ops/math.py``).

Host stages in float64 numpy, as in the reference: a binary op is empty
unless both operands are present, a scalar op propagates emptiness, a
division whose result is not finite is empty, and an empty value stores
0.0.  They have no device half, so a prefix that reads one of their outputs
runs on the host from there (as the JAX plan does).
"""

from __future__ import annotations

import numpy as np

from ..data.dataset import Column
from ..stages.base import BinaryTransformer, Param, UnaryTransformer
from ..types import OPNumeric, Real

_OPS = {
    "plus": np.add,
    "minus": np.subtract,
    "multiply": np.multiply,
    "divide": np.divide,
}


def _masked_result(vals: np.ndarray, ok: np.ndarray) -> Column:
    data = np.where(ok, vals, 0.0)
    return Column(Real, data.astype(np.float64), ok.astype(np.bool_))


class BinaryMathTransformer(BinaryTransformer):
    """plus/minus/multiply/divide of two numeric features -> Real."""

    input_types = (OPNumeric, OPNumeric)
    output_type = Real

    op = Param(default="plus", validator=lambda v: v in _OPS)

    def __init__(self, op: str = "plus", **kw):
        kw.setdefault("operation_name", op)
        super().__init__(**kw)
        self.op = op

    def transform_columns(self, cols, dataset):
        a, b = cols
        av, bv = a.values_f64(), b.values_f64()
        ok = ~(np.isnan(av) | np.isnan(bv))
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            vals = _OPS[self.op](av, bv)
        if self.op == "divide":
            ok = ok & np.isfinite(vals)
        return _masked_result(np.nan_to_num(vals), ok)


class ScalarMathTransformer(UnaryTransformer):
    """feature (op) scalar -> Real; empty in, empty out."""

    input_types = (OPNumeric,)
    output_type = Real

    op = Param(default="plus", validator=lambda v: v in _OPS)
    scalar = Param(default=0.0)

    def __init__(self, op: str = "plus", scalar: float = 0.0, **kw):
        kw.setdefault("operation_name", f"{op}S")
        super().__init__(**kw)
        self.op = op
        self.scalar = float(scalar)

    def transform_columns(self, cols, dataset):
        v = cols[0].values_f64()
        ok = ~np.isnan(v)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            vals = _OPS[self.op](v, self.scalar)
        if self.op == "divide":
            ok = ok & np.isfinite(vals)
        return _masked_result(np.nan_to_num(vals), ok)


class AliasTransformer(UnaryTransformer):
    """Rename a feature without computation: the output is named ``name``
    and typed as the input."""

    input_types = (OPNumeric,)

    def __init__(self, name: str, **kw):
        kw.setdefault("operation_name", "alias")
        super().__init__(**kw)
        self.alias_name = name

    def make_output_name(self) -> str:
        return self.alias_name

    def _output_ftype(self):
        return self.inputs[0].ftype if self.inputs else Real

    def transform_columns(self, cols, dataset):
        return cols[0]
