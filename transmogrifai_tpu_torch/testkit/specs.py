"""Shared behavior specs — the contract every stage must satisfy (counterpart
of ``transmogrifai_tpu/testkit/specs.py``; the serde round trip goes through
the port's ``workflow/serde.py``).

Reference: features/.../test/OpTransformerSpec.scala:1-162 (transform parity, row-level
parity, copy, serde round-trip, metadata) and OpEstimatorSpec.scala:55-143 (fit produces
model, model registered against the transformer spec).  Stage test suites call these two
functions instead of re-implementing the checks.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from ..data.dataset import Column, Dataset
from ..stages.base import Estimator, Transformer


def _columns_equal(a: Column, b: Column, rtol: float = 1e-6) -> None:
    assert len(a) == len(b), f"length mismatch: {len(a)} != {len(b)}"
    if a.data.dtype == object or b.data.dtype == object:
        for i, (x, y) in enumerate(zip(a.to_values(), b.to_values())):
            assert x == y, f"row {i}: {x!r} != {y!r}"
    else:
        np.testing.assert_allclose(
            np.asarray(a.data, dtype=np.float64),
            np.asarray(b.data, dtype=np.float64), rtol=rtol, atol=1e-9)
        if a.mask is not None or b.mask is not None:
            np.testing.assert_array_equal(a.present(), b.present())


def _roundtrip(stage: Transformer) -> Transformer:
    """Serde round-trip through the registry-based stage codec (in memory)."""
    from ..workflow.serde import _Decoder, _Encoder, decode_stage, encode_stage

    enc = _Encoder()
    state = encode_stage(stage, enc, full=True)
    dec = _Decoder(enc.arrays)
    clone = decode_stage(state, dec)
    clone._input_features = stage._input_features
    clone._output_feature = stage._output_feature
    return clone


def assert_transformer_spec(
    transformer: Transformer,
    dataset: Dataset,
    expected: Optional[Sequence[Any]] = None,
    check_row_parity: bool = True,
    check_serde: bool = True,
) -> Column:
    """Assert the OpTransformerSpec contract; returns the transform output column."""
    assert isinstance(transformer, Transformer), "stage must be a Transformer"
    out_ds = transformer.transform(dataset)
    out = out_ds[transformer.output_name]

    # 1. expected result
    if expected is not None:
        got = out.to_values()
        assert len(got) == len(expected)
        for i, (g, e) in enumerate(zip(got, expected)):
            if isinstance(e, float) and isinstance(g, float):
                np.testing.assert_allclose(g, e, rtol=1e-6, err_msg=f"row {i}")
            elif isinstance(e, np.ndarray) or isinstance(g, np.ndarray):
                np.testing.assert_allclose(np.asarray(g, dtype=np.float64),
                                           np.asarray(e, dtype=np.float64),
                                           rtol=1e-6, err_msg=f"row {i}")
            else:
                assert g == e, f"row {i}: {g!r} != {e!r}"

    # 2. row-level parity (reference transformRow)
    if check_row_parity and len(dataset.names) > 0:
        n_check = min(len(out), 5)
        in_cols = [dataset[f.name] for f in transformer.inputs]
        col_values = [c.to_values() for c in in_cols]
        whole = out.to_values()
        for i in range(n_check):
            row_vals = [vals[i] for vals in col_values]
            single = transformer.transform_values(row_vals)
            w = whole[i]
            if isinstance(w, np.ndarray) or isinstance(single, np.ndarray):
                np.testing.assert_allclose(np.asarray(single, dtype=np.float64),
                                           np.asarray(w, dtype=np.float64),
                                           rtol=1e-6, err_msg=f"row {i}")
            elif isinstance(w, float) and isinstance(single, float):
                np.testing.assert_allclose(single, w, rtol=1e-6, err_msg=f"row {i}")
            elif isinstance(w, dict) and isinstance(single, dict):
                # e.g. Prediction payloads: float values need tolerance (the
                # column path reduces on device, the row path on host)
                assert single.keys() == w.keys(), f"row {i}: {single!r} != {w!r}"
                for k in w:
                    if isinstance(w[k], float) and isinstance(single[k], float):
                        np.testing.assert_allclose(
                            single[k], w[k], rtol=1e-6, atol=1e-9,
                            err_msg=f"row {i} key {k!r}")
                    else:
                        assert single[k] == w[k], f"row {i} key {k!r}"
            else:
                assert single == w, f"row {i}: transform_values {single!r} != {w!r}"

    # 3. copy() preserves behavior
    clone = transformer.copy()
    assert clone.uid == transformer.uid
    assert clone.get_params() == transformer.get_params()
    _columns_equal(clone.transform(dataset)[clone.output_name], out)

    # 4. serde round-trip preserves behavior
    if check_serde:
        restored = _roundtrip(transformer)
        assert type(restored) is type(transformer)
        _columns_equal(restored.transform(dataset)[restored.output_name], out)

    return out


def assert_estimator_spec(
    estimator: Estimator,
    dataset: Dataset,
    expected: Optional[Sequence[Any]] = None,
    check_row_parity: bool = True,
    check_serde: bool = True,
) -> Transformer:
    """Assert the OpEstimatorSpec contract; returns the fitted model.

    Fit must produce a Transformer bound to the estimator's uid/output, a re-fit must
    produce the same result (determinism), and the fitted model must itself satisfy the
    full transformer spec.
    """
    assert isinstance(estimator, Estimator)
    model = estimator.fit(dataset)
    assert isinstance(model, Transformer)
    assert model.is_model
    assert model.uid == estimator.uid, "model must share the estimator uid"
    assert model.output_name == estimator.output_name

    model2 = estimator.fit(dataset)
    _columns_equal(model2.transform(dataset)[model2.output_name],
                   model.transform(dataset)[model.output_name])

    assert_transformer_spec(model, dataset, expected=expected,
                            check_row_parity=check_row_parity,
                            check_serde=check_serde)
    return model
