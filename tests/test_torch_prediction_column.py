"""A scored dataset's prediction column through take, split, concat and the
chunked store, in the port and in the JAX package.

The same 40 seeded rows (a label and a binary prediction column) in both
packages: ``Dataset.split(0.25)``, ``Dataset.take``, ``Dataset.concat``,
``ChunkedDataset.take`` and ``ChunkedDataset.chunk`` keep the column a
prediction column, and ``Evaluators.binary_classification()`` over each
part gives the reference's metrics exactly.  ``PredictionColumn.concat``
refuses a plain column as the reference's does, and its single-pass
concatenation of many parts (the out-of-core epoch's, ``workflow/ooc.py``)
equals the pairwise one.
"""

import numpy as np
import pytest

from transmogrifai_tpu.data.chunked import ChunkedDataset as JChunked
from transmogrifai_tpu.data.dataset import Column as JColumn
from transmogrifai_tpu.data.dataset import Dataset as JDataset
from transmogrifai_tpu.evaluators.base import Evaluators as JEvaluators
from transmogrifai_tpu.models.prediction import PredictionColumn as JPred
from transmogrifai_tpu.types import RealNN as JRealNN
from transmogrifai_tpu_torch.data.chunked import ChunkedDataset as TChunked
from transmogrifai_tpu_torch.data.dataset import Column as TColumn
from transmogrifai_tpu_torch.data.dataset import Dataset as TDataset
from transmogrifai_tpu_torch.evaluators.base import Evaluators as TEvaluators
from transmogrifai_tpu_torch.models.prediction import PredictionColumn as TPred
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
from transmogrifai_tpu_torch.types import RealNN as TRealNN

N = 40
PACKAGES = {
    "torch": (TDataset, TColumn, TPred, TRealNN, TChunked, TEvaluators),
    "jax": (JDataset, JColumn, JPred, JRealNN, JChunked, JEvaluators),
}


@pytest.fixture(autouse=True)
def _cpu():
    with use_device("cpu"):
        yield


def _scored(key):
    """The 40 rows: a 0/1 label and a classifier's raw margins and
    probabilities that rank it imperfectly."""
    Dataset, Column, Pred, RealNN, _, _ = PACKAGES[key]
    rng = np.random.default_rng(40)
    y = (rng.random(N) < 0.45).astype(np.float64)
    margin = rng.normal(size=N) + 1.2 * (y - 0.5)
    p1 = 1.0 / (1.0 + np.exp(-margin))
    return Dataset({
        "y": Column.from_values(RealNN, list(y)),
        "p": Pred.classification(np.column_stack([-margin, margin]),
                                 np.column_stack([1.0 - p1, p1])),
    })


def _parts(key, tmp_path):
    """Each way a scored dataset is cut, by name."""
    ds = _scored(key)
    chunked = PACKAGES[key][4].from_dataset(ds, chunk_rows=16,
                                            spill_dir=str(tmp_path / key))
    idx = np.random.default_rng(7).permutation(N)[:25]
    train, test = ds.split(0.25)
    return {
        "split_train": train,
        "split_test": test,
        "take": ds.take(idx),
        "concat": ds.take(idx[:12]).concat(ds.take(idx[12:])),
        "chunked_take": chunked.take(idx),
        "chunked_chunk": chunked.chunk(1),
    }


@pytest.mark.parametrize("part", ["split_train", "split_test", "take", "concat",
                                  "chunked_take", "chunked_chunk"])
def test_evaluates_equal_to_the_jax_package(part, tmp_path):
    t = _parts("torch", tmp_path)[part]
    j = _parts("jax", tmp_path)[part]
    got = TEvaluators.binary_classification().evaluate(t, "y", "p")
    want = JEvaluators.binary_classification().evaluate(j, "y", "p")
    assert got == want
    assert isinstance(t["p"], TPred)
    np.testing.assert_array_equal(t["p"].data, j["p"].data)
    assert 0.0 < got["auPR"] < 1.0


def test_concat_refuses_a_plain_column():
    p = _scored("torch")["p"]
    with pytest.raises(TypeError, match="PredictionColumns"):
        p.concat(TColumn(p.ftype, p.data, None, None))


def test_single_pass_concat_equals_pairwise():
    p = _scored("torch")["p"]
    parts = [p.take(np.arange(lo, min(lo + 16, N))) for lo in range(0, N, 16)]
    whole = parts[0].concat(*parts[1:])
    pairwise = parts[0].concat(parts[1]).concat(parts[2])
    assert isinstance(whole, TPred)
    for k in ("pred", "raw", "prob", "data"):
        np.testing.assert_array_equal(getattr(whole, k), getattr(pairwise, k))
        np.testing.assert_array_equal(getattr(whole, k), getattr(p, k))
