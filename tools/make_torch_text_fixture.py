"""Run the reference's text stack with the JAX package and save its record
for the PyTorch port.

Everything runs here on the CPU, by the reference package (its encode
kernels in interpret mode, as its own tests run them).  The output directory
(default ``transmogrifai_tpu_torch/fixtures/text_stack``) holds:

- ``record.json``:
  - ``text_reviews``: ``examples/text_reviews.py`` run as it is: the fitted
    states, the CV metrics, the evaluate metrics, the training vector's
    shape and sha256, and the side workflow's language and NER maps of every
    row;
  - ``blocks``: the tokenizer, stop-word, bigram, HashingTF and
    CountVectorizer outputs of the first :data:`BLOCK_ROWS` rows of the text
    table (``tests/torch_text_data.py``, seed 0) as sha256 digests, with the
    CountVectorizer's vocabulary;
  - ``ner``: the hand-labelled real-prose sentences of
    ``tests/ner_real_fixture{,_es,_nl}.py`` and the NameEntityRecognizer's
    maps of each, with the language pinned and detected;
  - ``pipeline``: the small text pipeline (``text_pipeline(wide=False)``)
    trained on :data:`PIPELINE_ROWS` rows: fitted states, CV metrics, the
    winner's coefficients, and ``2 x 32`` request records with the JAX
    serving plan's output records;
- ``embeddings.npz``: Word2Vec (dim 16, <= 200 words, 2 epochs) and LDA
  (k 4, <= 200 words, 5 x 5 iterations) fitted alone on the cleaned tokens
  of the first :data:`EMBED_ROWS` rows: their initial draws (threefry), the
  fitted vectors and topic-word matrix, and the E-step's ``gamma`` over the
  same documents; also the initial draws of the pipeline's own Word2Vec
  and LDA (``pipe_*``);
- ``model/``: the pipeline's model as the JAX package saves it
  (``model.json.gz`` + ``arrays.npz``).

Run from the repo root (takes about a minute):

    JAX_PLATFORMS=cpu python tools/make_torch_text_fixture.py
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import types

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures", "text_stack")
BLOCK_ROWS = 2000
EMBED_ROWS = 400
PIPELINE_ROWS = 1024
BATCH = 32
N_BATCHES = 2
W2V = {"embedding_dim": 16, "max_vocab": 200, "epochs": 2, "batch_size": 256}
LDA = {"k": 4, "max_vocab": 200, "max_iter": 5, "inner_iter": 5}


def w2v_init(seed: int, v_size: int, dim: int):
    """The reference's Word2Vec initial draws (embeddings.py's threefry)."""
    import jax
    import jax.numpy as jnp

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    lo, hi = -0.5 / dim, 0.5 / dim
    return (np.asarray(jax.random.uniform(k1, (v_size, dim), jnp.float32, lo, hi)),
            np.asarray(jax.random.uniform(k2, (v_size, dim), jnp.float32, lo, hi)))


def lda_init(seed: int, k: int, v: int):
    """The reference's LDA initial topic-word draw."""
    import jax
    import jax.numpy as jnp

    lam0 = jax.random.gamma(jax.random.PRNGKey(seed), 100.0, (k, v)) / 100.0
    return np.asarray(lam0.astype(jnp.float32))


def cv_of(summary) -> list:
    return [{"grid": e.grid, "values": [float(v) for v in e.metric_values]}
            for e in summary.validation_results]


def run_text_reviews(J, T) -> dict:
    from transmogrifai_tpu.perf.kernels import dispatch as KD
    from transmogrifai_tpu.workflow.fit import transform_dag

    with KD.force_kernel_mode("interpret"):
        got = T.run_text_reviews(REPO, J, transform_dag)
    return {k: got[k] for k in ("states", "cv", "metrics", "vector", "languages", "ner")}


def run_blocks(J, T, cols, ftypes) -> dict:
    from transmogrifai_tpu.ops import text
    from transmogrifai_tpu.workflow.fit import transform_dag

    fb = {k: J.FeatureBuilder.of(k, ftypes[k]).extract_field().as_predictor()
          for k in ("review",)}
    tokens = fb["review"].tokenize()
    clean = tokens.transform_with(text.StopWordsRemover())
    bigrams = clean.transform_with(text.NGramTransformer(n=2))
    counts = bigrams.transform_with(text.CountVectorizer(vocab_size=512))
    hashed = clean.transform_with(text.HashingTF(num_features=512))
    ds = J.Dataset.from_features({"review": cols["review"]}, {"review": ftypes["review"]})
    feats = [tokens, clean, bigrams, counts, hashed]
    model = J.Workflow().set_input_dataset(ds).set_result_features(*feats).train()
    out = transform_dag(ds, feats, model.fitted)
    cv = next(s for s in model.fitted.values() if type(s).__name__ == "CountVectorizerModel")
    return {"rows": BLOCK_ROWS,
            **{k: T.token_digest(out[f.name].data)
               for k, f in (("tokens", tokens), ("clean", clean), ("bigrams", bigrams))},
            "counts": T.block_digest(out[counts.name].data),
            "hashed": T.block_digest(out[hashed.name].data),
            "count_vocab": list(cv.vocab)}


def run_ner() -> dict:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from ner_real_fixture import REAL_TEXT
    from ner_real_fixture_es import REAL_TEXT_ES
    from ner_real_fixture_nl import REAL_TEXT_NL
    from transmogrifai_tpu.ops.ner import NameEntityRecognizer

    out = {}
    for lang, rows in (("en", REAL_TEXT), ("es", REAL_TEXT_ES), ("nl", REAL_TEXT_NL)):
        pinned = NameEntityRecognizer(language=lang)
        auto = NameEntityRecognizer()
        out[lang] = [{"sentence": s, "pinned": pinned.transform_values([s]),
                      "auto": auto.transform_values([s])} for s, _ in rows]
    return out


def run_embeddings(J, cols, ftypes) -> dict:
    from transmogrifai_tpu.ops import embeddings, text
    from transmogrifai_tpu.workflow.fit import transform_dag

    review = J.FeatureBuilder.of("review", ftypes["review"]).extract_field().as_predictor()
    clean = review.tokenize().transform_with(text.StopWordsRemover())
    ds = J.Dataset.from_features({"review": cols["review"][:EMBED_ROWS]},
                                 {"review": ftypes["review"]})
    docs = transform_dag(ds, [clean], {})[clean.name]
    w2v = embeddings.Word2Vec(**W2V).fit_columns([docs], None)
    lda = embeddings.LDA(**LDA).fit_columns([docs], None)
    w_in0, w_out0 = w2v_init(42, len(w2v.vocab), W2V["embedding_dim"])
    lam0 = lda_init(42, LDA["k"], len(lda.vocab))
    import jax.numpy as jnp

    index = {t: j for j, t in enumerate(lda.vocab)}
    x = np.zeros((len(docs), len(lda.vocab)), np.float32)
    for i, toks in enumerate(docs.data):
        for t in toks or ():
            if t in index:
                x[i, index[t]] += 1.0
    gamma = np.asarray(embeddings._e_step(jnp.asarray(x), jnp.asarray(lda.topic_word),
                                          1.0 / LDA["k"], LDA["inner_iter"])[0])
    return {"w2v_vocab": np.asarray(w2v.vocab), "w2v_w_in0": w_in0, "w2v_w_out0": w_out0,
            "w2v_vectors": w2v.vectors, "lda_vocab": np.asarray(lda.vocab),
            "lda_lam0": lam0, "lda_topic_word": lda.topic_word, "lda_gamma": gamma}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch_families_data as F
    import torch_text_data as T
    import transmogrifai_tpu as J
    from transmogrifai_tpu.models.logistic import LogisticRegression
    from transmogrifai_tpu.ops import embeddings, text
    from transmogrifai_tpu.perf.kernels import dispatch as KD
    from transmogrifai_tpu.types import feature_type_by_name

    record = {"text_reviews": run_text_reviews(J, T)}
    cols, schema = T.make_text(max(BLOCK_ROWS, PIPELINE_ROWS), seed=0)
    ftypes = {s["name"]: feature_type_by_name(s["type"]) for s in schema}
    record["blocks"] = run_blocks(J, T, {k: v[:BLOCK_ROWS] for k, v in cols.items()}, ftypes)
    record["ner"] = run_ner()
    arrays = run_embeddings(J, cols, ftypes)

    pcols = {k: v[:PIPELINE_ROWS] for k, v in cols.items()}
    ns = types.SimpleNamespace(
        FeatureBuilder=J.FeatureBuilder, transmogrify=J.transmogrify,
        SanityChecker=J.SanityChecker,
        BinaryClassificationModelSelector=J.BinaryClassificationModelSelector,
        LogisticRegression=LogisticRegression, text=text, embeddings=embeddings)
    label, sel, checker, pred, handles = T.text_pipeline(ns, ftypes, wide=False)
    ds = J.Dataset.from_features(pcols, ftypes)
    with KD.force_kernel_mode("interpret"):
        model = J.Workflow().set_input_dataset(ds).set_result_features(label, pred).train()
    w2v = model.fitted[handles["w2v"].origin_stage.uid]
    lda = model.fitted[handles["lda"].origin_stage.uid]
    arrays["pipe_w2v_w_in0"], arrays["pipe_w2v_w_out0"] = w2v_init(
        42, len(w2v.vocab), T.SMALL["w2v"]["embedding_dim"])
    arrays["pipe_lda_lam0"] = lda_init(42, T.SMALL["lda"]["k"], len(lda.vocab))
    arrays["pipe_w2v_vectors"] = w2v.vectors
    arrays["pipe_lda_topic_word"] = lda.topic_word

    if os.path.isdir(args.out):
        shutil.rmtree(args.out)
    model_dir = os.path.join(args.out, "model")
    model.save(model_dir)
    plan = model.serving_plan()
    batches = []
    with KD.force_kernel_mode("interpret"):
        for b in range(N_BATCHES):
            recs = T.make_records(pcols, range(b * BATCH, (b + 1) * BATCH))
            batches.append({"records": recs, "scored": plan.score(recs)})
    summary = model.fitted[sel.uid].summary
    win = model.fitted[sel.uid].model
    record["pipeline"] = {
        "rows": PIPELINE_ROWS, "seed": 0, "prediction": pred.name,
        "states": T.fitted_states(model), "cv": cv_of(summary),
        "winner": {"name": summary.best_model_name, "grid": summary.best_grid,
                   "coef": F.plain(np.asarray(win.coef)),
                   "intercept": float(win.intercept)},
        "batches": batches}
    with open(os.path.join(args.out, "record.json"), "w") as fh:
        json.dump(record, fh, separators=(",", ":"))
    np.savez_compressed(os.path.join(args.out, "embeddings.npz"), **arrays)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(args.out) for f in fs)
    print(json.dumps({"out": args.out, "bytes": size,
                      "text_reviews": {k: record["text_reviews"][k]
                                       for k in ("cv", "metrics", "vector")},
                      "pipeline_cv": record["pipeline"]["cv"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
