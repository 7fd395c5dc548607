"""Ben-Haim/Tom-Tov streaming histogram sketch (SURVEY §2.13 StreamingHistogram)
on the port: the reference's ``tests/test_streaming_histogram.py`` with the
import swapped, on the CPU, and the sketch against the JAX package's on the same
seeded data (bins, totals, quantiles, ``sum_until``, densities, merges and the
serialized form, all equal)."""

import numpy as np
import pytest

from transmogrifai_tpu.utils.streaming_histogram import StreamingHistogram as JHist
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
from transmogrifai_tpu_torch.utils.streaming_histogram import StreamingHistogram


@pytest.fixture(autouse=True)
def _cpu():
    with use_device("cpu"):
        yield


class TestStreamingHistogram:
    def test_bounded_bins(self):
        h = StreamingHistogram(max_bins=8)
        h.update(np.arange(1000, dtype=float))
        assert len(h.bins) <= 8
        assert h.total == 1000

    def test_exact_when_under_capacity(self):
        h = StreamingHistogram(max_bins=16)
        h.update([1.0, 2.0, 2.0, 5.0])
        assert h.bins == [(1.0, 1.0), (2.0, 2.0), (5.0, 1.0)]

    def test_nan_ignored_empty_ok(self):
        h = StreamingHistogram(max_bins=4)
        h.update([np.nan, np.nan])
        assert h.total == 0
        assert h.sum_until(10.0) == 0.0
        assert np.isnan(h.quantile(0.5))

    def test_merge_is_commutative_and_counts_add(self):
        rng = np.random.default_rng(0)
        a = StreamingHistogram(32).update(rng.normal(size=500))
        b = StreamingHistogram(32).update(rng.normal(2.0, size=300))
        m1, m2 = a.merge(b), b.merge(a)
        assert m1.total == pytest.approx(800)
        assert m1.bins == m2.bins

    def test_merge_close_to_bulk(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=4000)
        whole = StreamingHistogram(64).update(x)
        parts = StreamingHistogram(64).update(x[:2000]).merge(
            StreamingHistogram(64).update(x[2000:]))
        for q in (0.1, 0.5, 0.9):
            assert whole.quantile(q) == pytest.approx(parts.quantile(q), abs=0.15)

    def test_quantiles_approximate_true_quantiles(self):
        rng = np.random.default_rng(2)
        x = rng.normal(size=10_000)
        h = StreamingHistogram(max_bins=100).update(x)
        for q in (0.05, 0.25, 0.5, 0.75, 0.95):
            assert h.quantile(q) == pytest.approx(np.quantile(x, q), abs=0.1)

    def test_sum_until_monotone_and_bounded(self):
        rng = np.random.default_rng(3)
        h = StreamingHistogram(32).update(rng.uniform(0, 10, size=1000))
        pts = np.linspace(-1, 11, 50)
        sums = [h.sum_until(p) for p in pts]
        assert sums == sorted(sums)
        assert sums[0] == 0.0
        assert sums[-1] == pytest.approx(1000)

    def test_density_partitions_total(self):
        rng = np.random.default_rng(4)
        h = StreamingHistogram(32).update(rng.normal(size=2000))
        d = h.density(np.linspace(-6, 6, 25))
        assert d.sum() == pytest.approx(h.total, rel=0.01)
        assert (d >= 0).all()

    def test_serde_round_trip(self):
        h = StreamingHistogram(16).update([1, 2, 3, 4, 5.5])
        h2 = StreamingHistogram.from_dict(h.to_dict())
        assert h2.bins == h.bins
        assert h2.max_bins == h.max_bins

    def test_tiny_scale_values_keep_shape(self):
        # values below ~1e-8 must not collapse into one bin
        h = StreamingHistogram(64).update([i * 1e-9 for i in range(100)])
        assert len(h.bins) == 64
        assert h.quantile(0.9) == pytest.approx(9e-8, rel=0.2)

    def test_rejects_tiny_capacity(self):
        with pytest.raises(ValueError):
            StreamingHistogram(max_bins=1)


# ---------------------------------------------------------------------------
# The sketch against the JAX package's
# ---------------------------------------------------------------------------

def _blocks(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=3000), rng.exponential(2.0, size=1500),
                        [np.nan] * 7, rng.uniform(-50, 50, size=500)])
    rng.shuffle(x)
    return np.array_split(x, 5)


def _summary(h):
    pts = np.linspace(-60, 60, 41)
    return {"bins": h.bins, "total": h.total,
            "quantiles": [h.quantile(q) for q in (0.01, 0.1, 0.25, 0.5, 0.9, 0.999)],
            "sum_until": [h.sum_until(p) for p in pts],
            "density": h.density(pts).tolist(), "dict": h.to_dict()}


@pytest.mark.parametrize("max_bins", [2, 16, 64])
@pytest.mark.parametrize("seed", [0, 5])
def test_equals_the_jax_package(max_bins, seed):
    blocks = _blocks(seed)
    th, jh = StreamingHistogram(max_bins), JHist(max_bins)
    for b in blocks:  # block-by-block updates
        th.update(b)
        jh.update(b)
        assert th.bins == jh.bins
    assert _summary(th) == _summary(jh)
    # merges of per-block sketches, both orders
    tparts = [StreamingHistogram(max_bins).update(b) for b in blocks]
    jparts = [JHist(max_bins).update(b) for b in blocks]
    tm, jm = tparts[0], jparts[0]
    for tp, jp in zip(tparts[1:], jparts[1:]):
        tm, jm = tm.merge(tp), jm.merge(jp)
    assert _summary(tm) == _summary(jm)
    assert tparts[3].merge(tparts[1]).bins == jparts[3].merge(jparts[1]).bins
    assert StreamingHistogram.from_dict(jh.to_dict()).bins == th.bins
