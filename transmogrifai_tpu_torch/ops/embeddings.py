"""Text embedding estimators: Word2Vec and LDA, trained on the device
(counterpart of ``transmogrifai_tpu/ops/embeddings.py``).

The roles of TransmogrifAI's OpWord2Vec (a document's vector is the mean of
its words' vectors) and OpLDA (a document's vector is its distribution over
``k`` topics).  Vocabulary, (center, context) pairs and count matrices are
built on the host, as in the reference: strings never reach the device.  The
training loops are plain torch on the fit's device (the CUDA card unless the
caller names another), with float32 products in full precision (TF32 off):

- Word2Vec: skip-gram with negative sampling.  Each SGD step is a gather ->
  dot -> scatter-add over one batch of pairs; the gradient of the
  reference's loss is written out in closed form (:func:`skipgram_step`),
  and the updates accumulate with ``index_put_(accumulate=True)``, which
  sums the rows of a repeated index in a fixed order (run to run the same
  bits; ``index_add_``'s float atomics would not be).  An epoch's pairs and
  negatives reach the device in one copy, and the step loop has no host
  sync.
- LDA: batch variational Bayes (Hoffman et al.): the E-step's fixed-point
  updates and the M-step's sufficient statistics are (docs x topics) @
  (topics x vocab) products over the dense count matrix.  ``LDAModel`` runs
  the same E-step at transform time, on the device of the workflow or
  serving plan that calls it.

Random draws the reference makes with numpy (the pair order and the
negatives) are made here in the same order from the same generator, so they
are identical.  The reference's initial draws come from threefry, which torch
cannot reproduce: each has one seam, :func:`draw_word2vec_init` and
:func:`draw_lda_init`, which parity runs replace with the reference's draws.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..data.dataset import Column
from ..models.base import full_f32
from ..perf.kernels.dispatch import resolve_device
from ..stages.base import Param, Transformer, UnaryEstimator, UnaryTransformer
from ..types import OPVector, TextList
from ..utils.vector_metadata import VectorColumnMetadata, VectorMetadata


def _build_vocab(docs, min_count: int, max_vocab: int) -> List[str]:
    counts: Dict[str, int] = {}
    for toks in docs:
        for t in toks or ():
            counts[t] = counts.get(t, 0) + 1
    vocab = sorted((t for t, c in counts.items() if c >= min_count),
                   key=lambda t: (-counts[t], t))
    return vocab[:max_vocab]


def _count_matrix(docs, index: Dict[str, int]) -> np.ndarray:
    """(docs, vocab) float32 token counts of the in-vocabulary tokens."""
    x = np.zeros((len(docs), len(index)), np.float32)
    for i, toks in enumerate(docs):
        for t in toks or ():
            j = index.get(t)
            if j is not None:
                x[i, j] += 1.0
    return x


# ---------------------------------------------------------------------------
# Word2Vec
# ---------------------------------------------------------------------------

def skipgram_pairs(docs, index: Dict[str, int], window: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(centers, contexts) int32 of every in-window pair, in the reference's
    order: document by document, each in-vocabulary token i in turn, its
    contexts j from ``i - window`` to ``i + window`` ascending, j != i.

    Vectorized: every position's run of contexts is laid out by ``repeat``,
    and the center's own position is stepped over."""
    ids: List[int] = []
    lengths: List[int] = []
    for toks in docs:
        row = [index[t] for t in (toks or ()) if t in index]
        ids.extend(row)
        lengths.append(len(row))
    flat = np.asarray(ids, np.int64)
    if flat.size == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    lens = np.asarray(lengths, np.int64)
    starts = np.repeat(np.cumsum(lens) - lens, lens)   # each position's doc start
    pos = np.arange(flat.size, dtype=np.int64)
    local = pos - starts
    lo = starts + np.maximum(0, local - window)
    hi = starts + np.minimum(np.repeat(lens, lens), local + window + 1)
    counts = hi - lo - 1                                # contexts per position
    total = int(counts.sum())
    first = np.repeat(np.cumsum(counts) - counts, counts)
    j = np.repeat(lo, counts) + (np.arange(total, dtype=np.int64) - first)
    center_pos = np.repeat(pos, counts)
    j += j >= center_pos
    return flat[center_pos].astype(np.int32), flat[j].astype(np.int32)


class Word2Vec(UnaryEstimator):
    """TextList -> OPVector: skip-gram embeddings, doc vector = mean of word vectors.

    The OpWord2Vec capability: a vocabulary with ``min_count``, window-based
    contexts, a fixed-dimension output, the averaged transform.  Training is
    negative-sampling SGD, as in the reference (not Spark's hierarchical
    softmax).
    """

    input_types = (TextList,)
    output_type = OPVector

    embedding_dim = Param(default=64)
    window_size = Param(default=5)
    min_count = Param(default=1)
    max_vocab = Param(default=10_000)
    num_negatives = Param(default=4)
    epochs = Param(default=3)
    batch_size = Param(default=1024)
    learning_rate = Param(default=0.05)
    seed = Param(default=42)

    def fit_columns(self, cols: List[Column], dataset, device) -> Transformer:
        docs = cols[0].data
        vocab = _build_vocab(docs, self.min_count, self.max_vocab)
        dim = int(self.embedding_dim)
        if not vocab:
            return Word2VecModel(vocab=[], vectors=np.zeros((0, dim), np.float32))
        index = {t: j for j, t in enumerate(vocab)}
        centers, contexts = skipgram_pairs(docs, index, int(self.window_size))
        if not centers.size:
            return Word2VecModel(vocab=vocab,
                                 vectors=np.zeros((len(vocab), dim), np.float32))
        rng = np.random.default_rng(self.seed)
        # unigram^0.75 negative-sampling distribution (word2vec standard)
        freq = np.bincount(contexts, minlength=len(vocab)).astype(np.float64)
        p = freq ** 0.75
        p /= p.sum()
        vectors = train_skipgram(
            len(vocab), dim, centers, contexts, p, int(self.epochs),
            int(self.batch_size), int(self.num_negatives),
            float(self.learning_rate), int(self.seed), rng, device)
        return Word2VecModel(vocab=vocab, vectors=vectors)


def draw_word2vec_init(seed: int, v_size: int, dim: int, device
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w_in, w_out), each (v_size, dim) float32 uniform in +-0.5/dim, from a
    generator seeded ``seed`` on ``device``.  The one seam for Word2Vec's
    initial draws: parity runs replace it with the reference's."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    bound = 0.5 / dim
    w_in = torch.empty((v_size, dim), dtype=torch.float32, device=device)
    w_out = torch.empty((v_size, dim), dtype=torch.float32, device=device)
    w_in.uniform_(-bound, bound, generator=g)
    w_out.uniform_(-bound, bound, generator=g)
    return w_in, w_out


#: Word2Vec's SGD steps and epochs and LDA's E-steps since the last reset
_COUNTS: Dict[str, int] = {"skipgram_steps": 0, "skipgram_epochs": 0,
                           "lda_e_steps": 0}


def launch_counts() -> Dict[str, int]:
    return dict(_COUNTS)


def reset_launch_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0  # opcheck: allow(TM306) loop counters, reset between runs by their one reader


def skipgram_step(w_in: torch.Tensor, w_out: torch.Tensor, c: torch.Tensor,
                  out_idx: torch.Tensor, scale: torch.Tensor, sign: torch.Tensor,
                  lr: float) -> None:
    """One SGD step of the reference's loss, in place.

    ``c`` (B,) centers; ``out_idx`` (B, 1 + K) the context then the K
    negatives; ``scale`` (B,) = ``-w / max(sum(w), 1)`` (zero on padded
    pairs); ``sign`` (1 + K,) = (+1, -1, ..., -1).  With ``z`` the logits,
    d loss / d z = ``sign * scale * sigmoid(-sign * z)`` (log_sigmoid's
    derivative), whose products with the gathered rows give both gradients;
    every row update is summed by ``index_put_(accumulate=True)``."""
    vin = w_in[c]                                        # (B, d)
    vout = w_out[out_idx]                                # (B, 1+K, d)
    z = torch.bmm(vout, vin.unsqueeze(2)).squeeze(2)     # (B, 1+K)
    coef = torch.sigmoid(z * -sign).mul_(sign).mul_(scale.unsqueeze(1))
    g_in = torch.bmm(coef.unsqueeze(1), vout).squeeze(1)            # (B, d)
    g_out = coef.unsqueeze(2) * vin.unsqueeze(1)                    # (B, 1+K, d)
    w_in.index_put_((c,), g_in.mul_(-lr), accumulate=True)
    w_out.index_put_((out_idx.reshape(-1),),
                     g_out.mul_(-lr).reshape(-1, w_out.shape[1]), accumulate=True)


def skipgram_epoch(rng, centers: np.ndarray, contexts: np.ndarray, v_size: int,
                   neg_p: np.ndarray, steps: int, batch: int, num_neg: int
                   ) -> np.ndarray:
    """One epoch's (steps * batch, 2 + K) int32 array: the shuffled centers,
    their contexts, then K negatives a pair; the padding of the last batch
    is zero.  Draws from ``rng`` in the reference's order: one permutation,
    then the (padded, K) negatives."""
    n_pairs = len(centers)
    packed = np.zeros((steps * batch, 2 + num_neg), np.int32)
    order = rng.permutation(n_pairs)
    packed[:n_pairs, 0] = centers[order]
    packed[:n_pairs, 1] = contexts[order]
    packed[:, 2:] = rng.choice(v_size, size=(steps * batch, num_neg), p=neg_p)
    return packed


def train_skipgram(v_size: int, dim: int, centers: np.ndarray,
                   contexts: np.ndarray, neg_p: np.ndarray, epochs: int,
                   batch: int, num_neg: int, lr: float, seed: int, rng,
                   device) -> np.ndarray:
    """Skip-gram SGD on ``device``; returns the input embeddings (float32).

    Each epoch's array (:func:`skipgram_epoch`) is copied to the device at
    once; the steps then run without a host sync."""
    device = resolve_device(device)
    w_in, w_out = draw_word2vec_init(seed, v_size, dim, device)
    n_pairs = len(centers)
    steps = max(1, -(-n_pairs // batch))
    sign = torch.full((1 + num_neg,), -1.0, dtype=torch.float32, device=device)
    sign[0] = 1.0
    # the loss's weights: 1 on real pairs, 0 on the padding of the last batch
    w = (torch.arange(steps * batch, device=device) < n_pairs).to(torch.float32)
    w = w.reshape(steps, batch)
    scale = w * (-1.0 / torch.clamp(w.sum(dim=1, keepdim=True), min=1.0))
    pinned = device.type == "cuda"
    with full_f32():
        for _ in range(epochs):
            host = torch.from_numpy(skipgram_epoch(rng, centers, contexts, v_size, neg_p,
                                                   steps, batch, num_neg))
            if pinned:
                host = host.pin_memory()
            ep = host.to(device, non_blocking=pinned).to(torch.int64)
            ep = ep.reshape(steps, batch, 2 + num_neg)
            for s in range(steps):
                skipgram_step(w_in, w_out, ep[s, :, 0], ep[s, :, 1:], scale[s],
                              sign, lr)
            _COUNTS["skipgram_steps"] += steps  # opcheck: allow(TM306) loop counters of the one fitting thread
            _COUNTS["skipgram_epochs"] += 1  # opcheck: allow(TM306) loop counters of the one fitting thread
    return w_in.cpu().numpy()


class Word2VecModel(UnaryTransformer):
    """Averages fitted word vectors over each document's in-vocab tokens
    (host float32 numpy, as in the reference)."""

    input_types = (TextList,)
    output_type = OPVector

    def __init__(self, vocab: List[str], vectors: np.ndarray, **kw):
        super().__init__(**kw)
        self.vocab = list(vocab)
        self.vectors = np.asarray(vectors, np.float32)

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        f = self.inputs[0]
        index = {t: j for j, t in enumerate(self.vocab)}
        dim = self.vectors.shape[1] if self.vectors.ndim == 2 else 0
        block = np.zeros((len(cols[0]), dim), np.float32)
        for i, toks in enumerate(cols[0].data):
            ids = [index[t] for t in (toks or ()) if t in index]
            if ids:
                block[i] = self.vectors[ids].mean(axis=0)
        meta_cols = [
            VectorColumnMetadata(f.name, f.ftype.__name__, grouping=f.name,
                                 descriptor_value=f"w2v_{b}")
            for b in range(dim)
        ]
        meta = VectorMetadata(self.output_name, meta_cols).reindexed()
        return Column.vector(block, meta)


# ---------------------------------------------------------------------------
# LDA
# ---------------------------------------------------------------------------

class LDA(UnaryEstimator):
    """TextList -> OPVector of k topic proportions (the OpLDA capability).

    Batch variational Bayes (Hoffman et al.) over the dense (docs x vocab)
    count matrix, copied to the device once per fit.
    """

    input_types = (TextList,)
    output_type = OPVector

    k = Param(default=10, validator=lambda v: v >= 2)
    max_iter = Param(default=20)
    inner_iter = Param(default=5, doc="gamma updates per E-step")
    min_count = Param(default=1)
    max_vocab = Param(default=10_000)
    seed = Param(default=42)

    def fit_columns(self, cols: List[Column], dataset, device) -> Transformer:
        docs = cols[0].data
        vocab = _build_vocab(docs, self.min_count, self.max_vocab)
        k = int(self.k)
        if not vocab:
            return LDAModel(vocab=[], topic_word=np.full((k, 1), 1.0, np.float32),
                            k=k, inner_iter=int(self.inner_iter))
        x = _count_matrix(docs, {t: j for j, t in enumerate(vocab)})
        lam = fit_lda(x, k, int(self.max_iter), int(self.inner_iter),
                      int(self.seed), device)
        return LDAModel(vocab=vocab, topic_word=lam, k=k,
                        inner_iter=int(self.inner_iter))


def draw_lda_init(seed: int, k: int, v: int, device) -> torch.Tensor:
    """(k, v) float32 Gamma(100, 1) / 100 from a generator seeded ``seed`` on
    ``device``: LDA's initial topic-word matrix.  The one seam for LDA's
    draw: parity runs replace it with the reference's."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    shape = torch.full((k, v), 100.0, dtype=torch.float32, device=device)
    return torch._standard_gamma(shape, generator=g) / 100.0


def _elog_dirichlet(a: torch.Tensor) -> torch.Tensor:
    return torch.special.digamma(a) - torch.special.digamma(a.sum(dim=-1, keepdim=True))


def e_step(x: torch.Tensor, lam: torch.Tensor, alpha: float, n_iter: int):
    """(gamma, expElogtheta, x / phinorm, expElogbeta) after ``n_iter``
    fixed-point updates of the documents' topic weights ``gamma``, on the
    tensors' device."""
    exp_elog_beta = torch.exp(_elog_dirichlet(lam))                 # (k, V)
    gamma = torch.ones((x.shape[0], lam.shape[0]), dtype=torch.float32,
                       device=x.device)
    for _ in range(n_iter):
        exp_elog_theta = torch.exp(_elog_dirichlet(gamma))          # (D, k)
        phinorm = (exp_elog_theta @ exp_elog_beta).add_(1e-30)      # (D, V)
        ratio = torch.div(x, phinorm, out=phinorm)
        gamma = alpha + exp_elog_theta * (ratio @ exp_elog_beta.T)
    exp_elog_theta = torch.exp(_elog_dirichlet(gamma))
    phinorm = (exp_elog_theta @ exp_elog_beta).add_(1e-30)
    _COUNTS["lda_e_steps"] += 1  # opcheck: allow(TM306) loop counters of the one fitting thread
    return gamma, exp_elog_theta, torch.div(x, phinorm, out=phinorm), exp_elog_beta


def fit_lda(x: np.ndarray, k: int, max_iter: int, inner_iter: int, seed: int,
            device) -> np.ndarray:
    """The topic-word matrix (k, V) float32 after ``max_iter`` EM rounds on
    ``device``; ``x`` (docs x vocab) is copied there once."""
    device = resolve_device(device)
    alpha = 1.0 / k
    eta = 1.0 / k
    lam = draw_lda_init(seed, k, x.shape[1], device).to(torch.float32)
    xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    with full_f32():
        for _ in range(max_iter):
            _, exp_elog_theta, ratio, exp_elog_beta = e_step(xd, lam, alpha, inner_iter)
            lam = eta + exp_elog_beta * (exp_elog_theta.T @ ratio)
            del ratio
    return lam.cpu().numpy()


class LDAModel(UnaryTransformer):
    """Infers per-doc topic proportions with the fitted topic-word matrix:
    the E-step on the device of the workflow or serving plan that calls it
    (``transform(dataset, device)``; called without one, the device
    entry points' default: the card unless ``use_device`` names another),
    with one fetch of ``gamma``."""

    input_types = (TextList,)
    output_type = OPVector
    #: ``transform`` takes the device its E-step runs on
    scores_on_device = True

    def __init__(self, vocab: List[str], topic_word: np.ndarray, k: int,
                 inner_iter: int = 5, **kw):
        super().__init__(**kw)
        self.vocab = list(vocab)
        self.topic_word = np.asarray(topic_word, np.float32)
        self.k = int(k)
        self.inner_iter = int(inner_iter)

    def transform(self, dataset, device=None):
        col = dataset[self.inputs[0].name]
        return dataset.with_column(self.output_name, self.topics(col, device))

    def transform_columns(self, cols: List[Column], dataset) -> Column:
        return self.topics(cols[0])

    def topics(self, col: Column, device=None) -> Column:
        f = self.inputs[0]
        n = len(col)
        if not self.vocab:
            block = np.full((n, self.k), 1.0 / self.k, np.float32)
        else:
            dev = resolve_device(device)
            x = _count_matrix(col.data, {t: j for j, t in enumerate(self.vocab)})
            lam = torch.from_numpy(self.topic_word).to(dev)
            with full_f32():
                gamma, _, _, _ = e_step(torch.from_numpy(x).to(dev), lam,
                                        1.0 / self.k, self.inner_iter)
            gamma = gamma.cpu().numpy()
            block = (gamma / gamma.sum(axis=1, keepdims=True)).astype(np.float32)
        meta_cols = [
            VectorColumnMetadata(f.name, f.ftype.__name__, grouping=f.name,
                                 descriptor_value=f"topic_{b}")
            for b in range(self.k)
        ]
        meta = VectorMetadata(self.output_name, meta_cols).reindexed()
        return Column.vector(block, meta)

