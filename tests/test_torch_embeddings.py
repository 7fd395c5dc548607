"""Word2Vec and LDA: the port against the JAX package.

Both packages fit the same cleaned token lists (the text table of
``tests/torch_text_data.py`` from a numpy seed) on the CPU, with the reference's
threefry initial draws fed to the port's seams (``draw_word2vec_init``,
``draw_lda_init``):

- the (center, context) pairs of the port's vectorized builder equal the
  reference's loop element for element, and an epoch's permutation and
  negatives equal the reference's draws from the same generator;
- Word2Vec's vectors lie within 1e-5 (absolute; they are ~3e-2) of the
  reference's: float32 sums in another order;
- LDA's topic-word matrix and the E-step's ``gamma`` lie within 1e-4 of the
  reference's, relative: XLA's float32 digamma and torch's differ in the
  last bits;
- the transforms: Word2VecModel's means bitwise, LDAModel's proportions
  within 1e-5;

and the port alone: the default draws, the empty vocabularies, and an
LDAModel called with no device on a machine with no card raises (it never
moves itself to the CPU).  The fixture's standalone fits
(``fixtures/text_stack/embeddings.npz``, what the card's run holds) are
reproduced here too.
"""

import os
import sys

import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
from transmogrifai_tpu.ops import embeddings as je
import transmogrifai_tpu_torch as T
from transmogrifai_tpu_torch.data.dataset import Column
from transmogrifai_tpu_torch.ops import embeddings as te
from transmogrifai_tpu_torch.ops import text as tt
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
from transmogrifai_tpu_torch.types import TextList

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_text_data as D  # noqa: E402

FIXTURE = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "text_stack")
EMBED = np.load(os.path.join(FIXTURE, "embeddings.npz"))
CPU = torch.device("cpu")


def _docs(n: int, seed: int = 0, rows: int = None):
    """Cleaned token lists of the first ``rows`` of a table of ``n``."""
    cols, _ = D.make_text(n, seed=seed)
    text = Column.from_values(T.types.Text, cols["review"][:rows or n])
    toks = tt.TextTokenizer().transform_columns([text], None)
    return list(tt.StopWordsRemover().transform_columns([toks], None).data)


@pytest.fixture(scope="module")
def docs():
    return _docs(300, seed=5)


def _jcol(docs):
    return J.Dataset.from_features({"d": docs}, {"d": J.types.TextList})["d"]


def _tcol(docs):
    return Column.from_values(TextList, docs)


def reference_pairs(docs, index, window):
    """The reference's loop (embeddings.py's fit)."""
    centers, contexts = [], []
    for toks in docs:
        ids = [index[t] for t in (toks or ()) if t in index]
        for i, c in enumerate(ids):
            lo, hi = max(0, i - window), min(len(ids), i + window + 1)
            for j in range(lo, hi):
                if j != i:
                    centers.append(c)
                    contexts.append(ids[j])
    return np.asarray(centers, np.int32), np.asarray(contexts, np.int32)


def jax_w2v_draws(seed, v, dim):
    import jax
    import jax.numpy as jnp

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return tuple(np.asarray(jax.random.uniform(k, (v, dim), jnp.float32,
                                               -0.5 / dim, 0.5 / dim)) for k in (k1, k2))


def jax_lda_draw(seed, k, v):
    import jax
    import jax.numpy as jnp

    return np.asarray((jax.random.gamma(jax.random.PRNGKey(seed), 100.0, (k, v))
                       / 100.0).astype(jnp.float32))


@pytest.fixture
def fed(monkeypatch):
    """Feed the port's seams the reference's draws for whatever seed and
    shape the fit asks."""
    def w2v(seed, v, dim, device):
        w_in, w_out = jax_w2v_draws(seed, v, dim)
        return torch.from_numpy(w_in).to(device), torch.from_numpy(w_out).to(device)

    def lda(seed, k, v, device):
        return torch.from_numpy(jax_lda_draw(seed, k, v)).to(device)

    monkeypatch.setattr(te, "draw_word2vec_init", w2v)
    monkeypatch.setattr(te, "draw_lda_init", lda)


class TestPairsAndDraws:
    @pytest.mark.parametrize("window", [1, 2, 5, 40])
    def test_pairs_equal_the_reference_loop(self, docs, window):
        rows = docs + [None, [], ["zzz-not-in-vocab"], ["x"], ["x", "x"]]
        vocab = te._build_vocab(rows, 2, 150)
        index = {t: j for j, t in enumerate(vocab)}
        c, x = te.skipgram_pairs(rows, index, window)
        rc, rx = reference_pairs(rows, index, window)
        assert c.dtype == x.dtype == np.int32
        assert np.array_equal(c, rc) and np.array_equal(x, rx)

    def test_no_pairs(self):
        c, x = te.skipgram_pairs([["a"], [], None], {"a": 0}, 5)
        assert c.size == x.size == 0

    @pytest.mark.parametrize("batch,num_neg", [(64, 4), (1000, 2), (7, 1)])
    def test_epoch_draws_equal_the_reference(self, docs, batch, num_neg):
        vocab = te._build_vocab(docs, 1, 120)
        index = {t: j for j, t in enumerate(vocab)}
        centers, contexts = te.skipgram_pairs(docs, index, 5)
        freq = np.bincount(contexts, minlength=len(vocab)).astype(np.float64)
        p = freq ** 0.75
        p /= p.sum()
        n_pairs = len(centers)
        steps = max(1, -(-n_pairs // batch))
        padded = steps * batch
        got_rng, want_rng = np.random.default_rng(42), np.random.default_rng(42)
        for _ in range(2):
            got = te.skipgram_epoch(got_rng, centers, contexts, len(vocab), p, steps,
                                    batch, num_neg)
            # the reference's epoch (embeddings.py's _train_skipgram)
            order = want_rng.permutation(n_pairs)
            c = np.zeros(padded, np.int32)
            x = np.zeros(padded, np.int32)
            c[:n_pairs] = centers[order]
            x[:n_pairs] = contexts[order]
            neg = want_rng.choice(len(vocab), size=(padded, num_neg), p=p).astype(np.int32)
            assert np.array_equal(got[:, 0], c) and np.array_equal(got[:, 1], x)
            assert np.array_equal(got[:, 2:], neg)

    def test_default_draws(self):
        a_in, a_out = te.draw_word2vec_init(3, 50, 8, CPU)
        b_in, _ = te.draw_word2vec_init(3, 50, 8, CPU)
        assert torch.equal(a_in, b_in) and not torch.equal(a_in, a_out)
        assert a_in.dtype == torch.float32 and float(a_in.abs().max()) <= 0.5 / 8
        lam = te.draw_lda_init(3, 4, 500, CPU)
        assert lam.shape == (4, 500) and lam.dtype == torch.float32
        assert abs(float(lam.mean()) - 1.0) < 0.01 and torch.equal(lam, te.draw_lda_init(3, 4, 500, CPU))


class TestWord2Vec:
    @pytest.mark.parametrize("params", [
        {"embedding_dim": 16, "max_vocab": 200, "epochs": 1},
        {"embedding_dim": 16, "max_vocab": 150, "epochs": 2, "batch_size": 100,
         "num_negatives": 2, "window_size": 3},
        {"embedding_dim": 8, "max_vocab": 60, "min_count": 3, "epochs": 1,
         "learning_rate": 0.2, "seed": 7}])
    def test_fit_within_tolerance_of_the_reference(self, docs, fed, params):
        seen = {}
        real = je._train_skipgram

        def spy(v_size, dim, centers, contexts, neg_p, *rest):
            seen.update(centers=np.array(centers), contexts=np.array(contexts),
                        neg_p=np.array(neg_p))
            return real(v_size, dim, centers, contexts, neg_p, *rest)

        je._train_skipgram = spy
        try:
            jm = je.Word2Vec(**params).fit_columns([_jcol(docs)], None)
        finally:
            je._train_skipgram = real
        tm = te.Word2Vec(**params).fit_columns([_tcol(docs)], None, CPU)
        assert tm.vocab == jm.vocab
        index = {t: j for j, t in enumerate(tm.vocab)}
        c, x = te.skipgram_pairs(docs, index, int(params.get("window_size", 5)))
        assert np.array_equal(c, seen["centers"]) and np.array_equal(x, seen["contexts"])
        assert tm.vectors.dtype == np.float32 and tm.vectors.shape == jm.vectors.shape
        np.testing.assert_allclose(tm.vectors, jm.vectors, rtol=0, atol=1e-5)

    def test_transform_bitwise_on_the_same_vectors(self, docs):
        rng = np.random.default_rng(0)
        vocab = te._build_vocab(docs, 1, 100)
        vecs = rng.standard_normal((len(vocab), 12)).astype(np.float32)
        rows = docs + [None, [], ["not-a-word"]]
        for P, mod, col in ((J, je, _jcol), (T, te, _tcol)):
            f = P.FeatureBuilder.of("d", P.types.TextList).extract_field().as_predictor()
            m = mod.Word2VecModel(vocab=vocab, vectors=vecs)
            f.transform_with(m)
            if P is J:
                want = m.transform_columns([col(rows)], None)
            else:
                got = m.transform_columns([col(rows)], None)
        assert got.data.tobytes() == want.data.tobytes()
        assert [c.descriptor_value for c in got.meta.columns] == \
            [c.descriptor_value for c in want.meta.columns]

    def test_empty_vocabulary_and_no_pairs(self):
        m = te.Word2Vec(embedding_dim=5).fit_columns([_tcol([None, []])], None, CPU)
        assert m.vocab == [] and m.vectors.shape == (0, 5)
        m = te.Word2Vec(embedding_dim=5).fit_columns([_tcol([["a"], ["b"]])], None, CPU)
        assert m.vocab == ["a", "b"] and not m.vectors.any()

    def test_the_fixture_fit(self):
        docs = _docs(2000, seed=0, rows=400)
        w_in, w_out = EMBED["w2v_w_in0"], EMBED["w2v_w_out0"]
        real = te.draw_word2vec_init
        te.draw_word2vec_init = lambda s, v, d, dev: (torch.from_numpy(w_in.copy()),
                                                      torch.from_numpy(w_out.copy()))
        try:
            m = te.Word2Vec(embedding_dim=16, max_vocab=200, epochs=2, batch_size=256) \
                .fit_columns([_tcol(docs)], None, CPU)
        finally:
            te.draw_word2vec_init = real
        assert m.vocab == list(EMBED["w2v_vocab"])
        np.testing.assert_allclose(m.vectors, EMBED["w2v_vectors"], rtol=0, atol=1e-5)


class TestLDA:
    @pytest.mark.parametrize("params", [
        {"k": 4, "max_vocab": 200, "max_iter": 5},
        {"k": 3, "max_vocab": 80, "max_iter": 3, "inner_iter": 2, "min_count": 2, "seed": 9}])
    def test_fit_and_transform_within_tolerance(self, docs, fed, params):
        jm = je.LDA(**params).fit_columns([_jcol(docs)], None)
        tm = te.LDA(**params).fit_columns([_tcol(docs)], None, CPU)
        assert tm.vocab == jm.vocab and tm.k == jm.k and tm.inner_iter == jm.inner_iter
        assert tm.topic_word.dtype == np.float32
        np.testing.assert_allclose(tm.topic_word, jm.topic_word, rtol=1e-4, atol=0)
        rows = docs[:60] + [None, [], ["not-a-word"]]
        for P, m, col in ((J, jm, _jcol), (T, tm, _tcol)):
            f = P.FeatureBuilder.of("d", P.types.TextList).extract_field().as_predictor()
            f.transform_with(m)
        want = jm.transform_columns([_jcol(rows)], None)
        got = tm.transform(T.Dataset({"d": _tcol(rows)}), device="cpu")[tm.output_name]
        np.testing.assert_allclose(got.data, want.data, rtol=0, atol=1e-5)
        assert [c.descriptor_value for c in got.meta.columns] == \
            [c.descriptor_value for c in want.meta.columns]

    def test_e_step_gamma_of_the_fixture(self):
        docs = _docs(2000, seed=0, rows=400)
        real = te.draw_lda_init
        te.draw_lda_init = lambda s, k, v, dev: torch.from_numpy(EMBED["lda_lam0"].copy())
        try:
            m = te.LDA(k=4, max_vocab=200, max_iter=5, inner_iter=5) \
                .fit_columns([_tcol(docs)], None, CPU)
        finally:
            te.draw_lda_init = real
        assert m.vocab == list(EMBED["lda_vocab"])
        np.testing.assert_allclose(m.topic_word, EMBED["lda_topic_word"], rtol=1e-4)
        x = te._count_matrix(docs, {t: j for j, t in enumerate(m.vocab)})
        gamma = te.e_step(torch.from_numpy(x), torch.from_numpy(EMBED["lda_topic_word"]),
                          0.25, 5)[0].numpy()
        np.testing.assert_allclose(gamma, EMBED["lda_gamma"], rtol=1e-4)

    def test_empty_vocabulary_is_uniform(self):
        m = te.LDA(k=4).fit_columns([_tcol([None, []])], None, CPU)
        f = T.FeatureBuilder.of("d", TextList).extract_field().as_predictor()
        f.transform_with(m)
        out = m.transform_columns([_tcol([None, ["a"]])], None)
        assert np.array_equal(out.data, np.full((2, 4), 0.25, np.float32))

    def test_transform_needs_a_device(self, docs):
        m = te.LDA(k=3, max_vocab=50, max_iter=1).fit_columns([_tcol(docs)], None, CPU)
        f = T.FeatureBuilder.of("d", TextList).extract_field().as_predictor()
        f.transform_with(m)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                m.transform_columns([_tcol(docs[:3])], None)
        with use_device("cpu"):
            a = m.transform_columns([_tcol(docs[:3])], None)
        b = m.transform(T.Dataset({"d": _tcol(docs[:3])}), device="cpu")[m.output_name]
        assert a.data.tobytes() == b.data.tobytes()


@pytest.mark.parametrize("shortcut,cls", [("word2vec", "Word2Vec"), ("lda_topics", "LDA")])
def test_dsl_shortcut_fits_on_the_named_device(shortcut, cls, docs):
    f = T.FeatureBuilder.of("d", TextList).extract_field().as_predictor()
    out = getattr(f, shortcut)(seed=3)
    assert type(out.origin_stage).__name__ == cls and out.ftype.__name__ == "OPVector"
    ds = T.Dataset({"d": _tcol(docs[:40])})
    model = T.Workflow().set_input_dataset(ds).set_result_features(out).train(device="cpu")
    assert type(model.fitted[out.origin_stage.uid]).__name__ == f"{cls}Model"
