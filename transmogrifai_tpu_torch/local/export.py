"""Standalone (numpy-only) scoring export — the MLeap-bundle role
(counterpart of ``transmogrifai_tpu/local/export.py``).

Reference: MLeap serialization gives the reference a serving artifact
loadable OUTSIDE the training stack (OpWorkflowModelLocal.scala:93-200 runs
scoring with no Spark session).  ``export_standalone(model, out_dir)`` plays
that role: it compiles a fitted pipeline of this package's stages into

    out_dir/
      scorer.py       self-contained numpy interpreter (no torch, no jax, no
                      framework import — stdlib + numpy only)
      program.json    the op program (stage semantics, column wiring)
      arrays.npz      fitted parameters (fills, coefs, trees) as numpy
                      arrays of the reference's dtypes, never tensors
      _tl_text.py     (text pipelines only) vendored pure-stdlib analysis
      _tl_lang.py     runtime: tokenizer, per-language analyzers, murmur3 —
      _tl_hashing.py  copied from this package's utils/ at export time

The bundle is the program the JAX package exports for the same model
(``program.json`` equal, every array bitwise, ``scorer.py`` the same
text).  It scores on the host by contract: the MLeap role is a scorer with
no framework at all, not a fallback of the card's path.

Supported surface: feature generators (field extract), every transmogrify()
default vectorizer (RealNN/Numeric/Binary/one-hot/multi-hot/SmartText(+map)/
date unit-circle/date-list pivots/text-list hashing/geolocation(+map)/
numeric+text-pivot maps), string indexer, scalers (standard/fill-mean/
percentile), combiner, SanityChecker selection, and the linear/tree/NB/MLP/
GLM/softmax model heads plus isotonic calibration — the reference's list.
Anything else (a decision-tree bucketizer among them, as in the reference)
raises at export time with the stage named.

The generated scorer reproduces the framework's HOST prediction paths
(float64 matvecs; the trees' vectorized numpy traversal), so
``scorer.score(records)`` round-trips the in-process ``score_function``
within 1e-6.  RealNN (non-nullable) inputs RAISE on a missing/NaN value at
scoring time, as the in-process path does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np
import torch

from ..features.feature import _NamedExtract
from ..workflow.dag import compute_dag
from ..workflow.fit import _resolve
from .scoring import bound_generators

#: op kinds that terminate the program with a prediction payload
_MODEL_OPS = frozenset({"logistic", "linear", "svc", "trees", "softmax",
                        "naive_bayes", "mlp", "glm"})
#: ops allowed to FOLLOW a model op (post-prediction calibration)
_TAIL_OPS = _MODEL_OPS | {"isotonic"}

#: text-runtime ops that need the vendored analysis modules in the bundle
_TEXT_OPS = frozenset({"smart_text", "smart_text_map", "text_list_hash"})


def export_standalone(model, out_dir: str) -> str:
    """Compile ``model`` (a fitted WorkflowModel) into a numpy-only scoring
    directory; returns the path to the generated ``scorer.py``.  Host work:
    it reads the fitted stages and launches nothing."""
    generators = bound_generators(model.result_features)
    plan = [s for layer in compute_dag(model.result_features) for s in layer]
    arrays: Dict[str, np.ndarray] = {}
    ops: List[dict] = []

    def store(name: str, arr) -> str:
        arrays[name] = to_numpy(arr)
        return name

    raw_inputs: List[dict] = []
    for g in generators:
        if g.is_response:
            continue  # labels are absent at serving time
        if not isinstance(g.extract_fn, _NamedExtract):
            raise ValueError(
                f"standalone export requires field-extract raw features; "
                f"{g.raw_name!r} uses a custom extract function")
        kind = "numeric" if _is_numeric_ftype(g.ftype) else "string"
        raw_inputs.append({"name": g.raw_name,
                           "key": g.extract_fn.key, "kind": kind})

    for i, stage in enumerate(plan):
        if stage.inputs and all(getattr(f, "is_response", False)
                                for f in stage.inputs):
            continue  # label-side stage (e.g. response StringIndexer):
            # never computed at serving time
        runner = _resolve(stage, model.fitted)
        ops.append(_compile_stage(i, stage, runner, store))
    if not ops or ops[-1]["op"] not in _TAIL_OPS:
        raise ValueError(
            "standalone export requires the pipeline to END in a "
            "model stage (the scorer's output contract); got "
            f"{ops[-1]['op'] if ops else 'an empty plan'}")

    os.makedirs(out_dir, exist_ok=True)
    program = {"raw_inputs": raw_inputs, "ops": ops}
    with open(os.path.join(out_dir, "program.json"), "w") as fh:
        json.dump(program, fh, indent=1)
    np.savez_compressed(os.path.join(out_dir, "arrays.npz"), **arrays)
    if any(op["op"] in _TEXT_OPS for op in ops):
        _vendor_text_runtime(out_dir)
    scorer_path = os.path.join(out_dir, "scorer.py")
    with open(scorer_path, "w") as fh:
        fh.write(_SCORER_TEMPLATE)
    return scorer_path


def to_numpy(v) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array: the bundle
    holds no tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _vendor_text_runtime(out_dir: str) -> None:
    """Copy the pure-stdlib analysis modules into the bundle (MLeap bundles
    likewise carry their runtime).  This package's utils/text.py, lang.py
    and hashing.py import only re, unicodedata and typing, so the bundle
    stays framework-free; the only rewrite is the relative import."""
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "utils")
    for src_name, dst_name in (("text.py", "_tl_text.py"),
                               ("lang.py", "_tl_lang.py"),
                               ("hashing.py", "_tl_hashing.py")):
        with open(os.path.join(base, src_name)) as fh:
            src = fh.read()
        src = src.replace("from .lang import", "from _tl_lang import")
        src = src.replace("from .hashing import", "from _tl_hashing import")
        with open(os.path.join(out_dir, dst_name), "w") as fh:
            fh.write("# VENDORED at export time from transmogrifai_tpu_torch/"
                     f"utils/{src_name} — do not edit\n" + src)


def _is_numeric_ftype(ftype) -> bool:
    from ..types import Date, OPNumeric

    return issubclass(ftype, (OPNumeric, Date))


def _kv_list(d: Dict[str, Any]) -> List[List[Any]]:
    """Insertion-ordered [key, value] pairs (JSON round-trip-safe)."""
    return [[k, v] for k, v in d.items()]


def _compile_stage(i: int, stage, runner, store) -> dict:
    from ..checkers.sanity import SanityCheckerModel
    from ..models.glm import GLMModel
    from ..models.isotonic import IsotonicCalibratorModel
    from ..models.linear import LinearRegressionModel
    from ..models.logistic import LogisticRegressionModel
    from ..models.mlp import MLPClassifierModel
    from ..models.naive_bayes import NaiveBayesModel
    from ..models.selector import SelectedModel
    from ..models.softmax import MultinomialLogisticRegressionModel
    from ..models.svm import LinearSVCModel
    from ..models.trees import (ForestClassifierModel, ForestRegressorModel,
                                GBTClassifierModel, GBTRegressorModel)
    from ..ops.combiner import VectorsCombiner
    from ..ops.dates import DateListVectorizer, DateToUnitCircleVectorizer
    from ..ops.geo import GeolocationVectorizerModel
    from ..ops.maps import (GeolocationMapVectorizerModel,
                            NumericMapVectorizerModel,
                            TextMapPivotVectorizerModel)
    from ..ops.numeric import (BinaryVectorizer, NumericVectorizerModel,
                               RealNNVectorizer)
    from ..ops.onehot import OneHotVectorizerModel, StringIndexerModel
    from ..ops.scalers import (FillMissingWithMeanModel,
                               PercentileCalibratorModel, StandardScalerModel)
    from ..ops.text_lists import TextListHashingVectorizer
    from ..ops.text_smart import (SmartTextMapVectorizerModel,
                                  SmartTextVectorizerModel)

    name = type(runner).__name__
    inputs = [f.name for f in stage.inputs]
    out = stage.output_name

    if isinstance(runner, NumericVectorizerModel):
        return {"op": "numeric_vectorize", "inputs": inputs, "out": out,
                "fills": store(f"op{i}_fills", runner.fills),
                "track_nulls": bool(runner.track_nulls)}
    if isinstance(runner, RealNNVectorizer):
        # non-nullable: a NaN at serving time must RAISE (in-process parity:
        # Column.from_values rejects missing RealNN) — r4 advisor finding
        return {"op": "numeric_vectorize", "inputs": inputs, "out": out,
                "fills": store(f"op{i}_fills", np.zeros(len(inputs))),
                "track_nulls": False, "non_nullable": True}
    if isinstance(runner, BinaryVectorizer):
        # identical serving semantics to a numeric vectorizer with zero
        # fills (missing -> 0 + null indicator) — reuse that op
        return {"op": "numeric_vectorize", "inputs": inputs, "out": out,
                "fills": store(f"op{i}_fills", np.zeros(len(inputs))),
                "track_nulls": bool(runner.track_nulls)}
    if isinstance(runner, OneHotVectorizerModel):
        from ..ops.onehot import MultiPickListVectorizerModel

        multi = isinstance(runner, MultiPickListVectorizerModel)
        return {"op": "multihot" if multi else "onehot",
                "inputs": inputs, "out": out,
                "vocabs": [[str(x) for x in v] for v in runner.vocabs],
                "clean_text": bool(runner.clean_text),
                "track_nulls": bool(runner.track_nulls)}
    if isinstance(runner, SmartTextVectorizerModel):
        plans = []
        for fi in range(len(inputs)):  # opcheck: allow(TM302) a loop over a stage's inputs, at export (host, once)
            plans.append({"cat": bool(runner.is_categorical[fi]),
                          "vocab": [str(v) for v in runner.vocabs[fi]],
                          "lang": runner._lang(fi)})
        return {"op": "smart_text", "inputs": inputs, "out": out,
                "plans": plans, "num_hashes": int(runner.num_hashes),
                "clean_text": bool(runner.clean_text),
                "track_nulls": bool(runner.track_nulls),
                "track_text_len": bool(runner.track_text_len)}
    if isinstance(runner, SmartTextMapVectorizerModel):
        return {"op": "smart_text_map", "inputs": inputs, "out": out,
                "key_plans": [_kv_list(p) for p in runner.key_plans],
                "num_hashes": int(runner.num_hashes),
                "clean_text": bool(runner.clean_text),
                "track_nulls": bool(runner.track_nulls)}
    if isinstance(runner, DateToUnitCircleVectorizer):
        return {"op": "date_unit_circle", "inputs": inputs, "out": out,
                "time_periods": list(runner.time_periods)}
    if isinstance(runner, DateListVectorizer):
        return {"op": "date_list", "inputs": inputs, "out": out,
                "pivot": str(runner.pivot),
                "fill_value": float(runner.fill_value),
                "reference_date_ms": int(runner.reference_date_ms),
                "track_nulls": bool(runner.track_nulls)}
    if isinstance(runner, TextListHashingVectorizer):
        return {"op": "text_list_hash", "inputs": inputs, "out": out,
                "num_hashes": int(runner.num_hashes),
                "shared_hash_space": bool(runner.shared_hash_space),
                "track_nulls": bool(runner.track_nulls)}
    if isinstance(runner, GeolocationVectorizerModel):
        return {"op": "geo_vectorize", "inputs": inputs, "out": out,
                "fills": store(f"op{i}_fills", runner.fills),
                "track_nulls": bool(runner.track_nulls)}
    if isinstance(runner, GeolocationMapVectorizerModel):
        return {"op": "geo_map", "inputs": inputs, "out": out,
                "keys": runner.keys,
                "fills": [store(f"op{i}_f{j}",
                                np.array([runner.fills[j][k]
                                          for k in runner.keys[j]]))
                          for j in range(len(inputs))],
                "track_nulls": bool(runner.track_nulls)}
    if isinstance(runner, NumericMapVectorizerModel):
        return {"op": "numeric_map", "inputs": inputs, "out": out,
                "keys": runner.keys,
                "fills": [store(f"op{i}_f{j}",
                                np.array([runner.fills[j][k]
                                          for k in runner.keys[j]]))
                          for j in range(len(inputs))],
                "track_nulls": bool(runner.track_nulls),
                "clean_keys": bool(runner.clean_keys)}
    if isinstance(runner, TextMapPivotVectorizerModel):
        return {"op": "text_map_pivot", "inputs": inputs, "out": out,
                "vocabs": [_kv_list({k: v[k] for k in sorted(v)})
                           for v in runner.vocabs],
                "clean_text": bool(runner.clean_text),
                "track_nulls": bool(runner.track_nulls)}
    if isinstance(runner, StringIndexerModel):
        return {"op": "string_indexer", "inputs": inputs, "out": out,
                "labels": [str(v) for v in runner.labels],
                "handle_invalid": str(runner.handle_invalid)}
    if isinstance(runner, FillMissingWithMeanModel):
        return {"op": "fill_mean", "inputs": inputs, "out": out,
                "mean": float(runner.mean)}
    if isinstance(runner, StandardScalerModel):
        return {"op": "standard_scaler", "inputs": inputs, "out": out,
                "mean": float(runner.mean), "std": float(runner.std)}
    if isinstance(runner, PercentileCalibratorModel):
        return {"op": "percentile_calibrator", "inputs": inputs, "out": out,
                "splits": store(f"op{i}_splits", runner.splits)}
    if isinstance(runner, VectorsCombiner):
        return {"op": "concat", "inputs": inputs, "out": out}
    if isinstance(runner, SanityCheckerModel):
        return {"op": "select", "inputs": inputs[1:], "out": out,
                "indices": store(f"op{i}_kept",
                                 np.asarray(runner.kept_indices, np.int64))}
    if isinstance(runner, IsotonicCalibratorModel):
        return {"op": "isotonic", "inputs": inputs[1:], "out": out,
                "knots_x": store(f"op{i}_kx", runner.knots_x),
                "knots_y": store(f"op{i}_ky", runner.knots_y)}
    if isinstance(runner, SelectedModel):
        runner = runner.model
        name = type(runner).__name__
    if isinstance(runner, (LogisticRegressionModel, LinearRegressionModel,
                           LinearSVCModel)):
        kind = {"LogisticRegressionModel": "logistic",
                "LinearRegressionModel": "linear",
                "LinearSVCModel": "svc"}[type(runner).__name__]
        return {"op": kind, "inputs": inputs[-1:], "out": out,
                "coef": store(f"op{i}_coef", runner.coef),
                "intercept": float(runner.intercept)}
    if isinstance(runner, MultinomialLogisticRegressionModel):
        return {"op": "softmax", "inputs": inputs[-1:], "out": out,
                "coef": store(f"op{i}_coef", runner.coef),
                "intercept": store(f"op{i}_b", runner.intercept)}
    if isinstance(runner, NaiveBayesModel):
        return {"op": "naive_bayes", "inputs": inputs[-1:], "out": out,
                "classes": store(f"op{i}_cls", runner.classes),
                "log_prior": store(f"op{i}_lp", runner.log_prior),
                "log_theta": store(f"op{i}_lt", runner.log_theta),
                "shift": store(f"op{i}_sh", runner.shift)}
    if isinstance(runner, MLPClassifierModel):
        spec = {"op": "mlp", "inputs": inputs[-1:], "out": out,
                "classes": store(f"op{i}_cls", runner.classes),
                "n_layers": len(runner.weights)}
        for li, (wm, b) in enumerate(runner.weights):
            spec[f"w{li}"] = store(f"op{i}_w{li}", wm)
            spec[f"b{li}"] = store(f"op{i}_b{li}", b)
        return spec
    if isinstance(runner, GLMModel):
        return {"op": "glm", "inputs": inputs[-1:], "out": out,
                "coef": store(f"op{i}_coef", runner.coef),
                "intercept": float(runner.intercept),
                "family": str(runner.family)}
    if isinstance(runner, (GBTClassifierModel, GBTRegressorModel,
                           ForestClassifierModel, ForestRegressorModel)):
        spec = {"op": "trees", "inputs": inputs[-1:], "out": out,
                "flavor": {"GBTClassifierModel": "gbt_cls",
                           "GBTRegressorModel": "gbt_reg",
                           "ForestClassifierModel": "rf_cls",
                           "ForestRegressorModel": "rf_reg"}[name],
                "max_depth": int(runner.max_depth),
                "n_bins": int(runner.n_bins),
                "edges": store(f"op{i}_edges", runner.edges),
                "base_score": store(f"op{i}_base", runner.base_score)}
        for k, v in runner.trees.items():
            spec[f"t_{k}"] = store(f"op{i}_t_{k}", v)
        return spec
    raise ValueError(
        f"standalone export does not support stage {stage.uid} "
        f"(resolved to {name}) yet — the in-process score_function covers it")


_SCORER_TEMPLATE = '''"""GENERATED standalone scorer — numpy + stdlib only (MLeap-bundle role).

Usage:
    from scorer import Scorer
    s = Scorer(__file__rooted_dir)   # or Scorer() for the file's own dir
    out = s.score([{"x1": 0.3, "color": "red"}, ...])
    # -> [{"prediction": 1.0, "probability": [..], "score": ..}, ...]
"""
import json
import os
import sys

import numpy as np

# intentionally no jax / framework imports anywhere in this module — the
# round-trip test asserts sys.modules stays clean after scoring.  Text
# pipelines lazily import the VENDORED analysis modules (_tl_*.py) shipped
# inside this bundle.

_PERIOD_SIZE = {"HourOfDay": 24.0, "DayOfWeek": 7.0, "DayOfMonth": 31.0,
                "DayOfYear": 366.0}
_MODE_SPECS = {"ModeDay": ("DayOfWeek", 7, True),
               "ModeMonth": ("MonthOfYear", 12, True),
               "ModeHour": ("HourOfDay", 24, False)}
_DAY_MS = 24 * 3600 * 1000


def _time_period(ms, period):
    """Calendar-period ordinal from epoch-millis (UTC) — mirrors the
    framework's extract_time_period exactly (java.time conventions)."""
    secs = ms.astype("datetime64[ms]").astype("datetime64[s]")
    days = secs.astype("datetime64[D]")
    if period == "HourOfDay":
        return ((secs - days).astype("timedelta64[h]").astype(np.int64)) % 24
    if period == "DayOfWeek":
        return ((days.astype(np.int64) + 3) % 7) + 1
    if period == "DayOfMonth":
        return (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    if period == "DayOfYear":
        return (days - days.astype("datetime64[Y]")).astype(np.int64) + 1
    if period == "MonthOfYear":
        return (days.astype("datetime64[M]").astype(np.int64) % 12) + 1
    if period in ("WeekOfMonth", "WeekOfYear"):
        unit = "M" if period == "WeekOfMonth" else "Y"
        first = days.astype("datetime64[%s]" % unit).astype("datetime64[D]")
        first_dow = (first.astype(np.int64) + 3) % 7
        ordinal = (days - first).astype(np.int64)
        return (ordinal + first_dow) // 7 + 1
    raise ValueError("unknown period %r" % (period,))


def _softmax(raw):
    m = raw.max(axis=1, keepdims=True)
    e = np.exp(raw - m)
    return e / e.sum(axis=1, keepdims=True)


class Scorer:
    def __init__(self, base_dir=None):
        base = base_dir or os.path.dirname(os.path.abspath(__file__))
        self._base = base
        with open(os.path.join(base, "program.json")) as fh:
            self.program = json.load(fh)
        self.arrays = dict(np.load(os.path.join(base, "arrays.npz"),
                                   allow_pickle=False))
        self._text = None

    def _text_runtime(self):
        """Lazy import of the vendored analysis modules in this bundle."""
        if self._text is None:
            if self._base not in sys.path:
                sys.path.insert(0, self._base)
            import _tl_hashing
            import _tl_text
            self._text = (_tl_text, _tl_hashing)
        return self._text

    # -- raw extraction ----------------------------------------------------
    def _extract(self, records):
        cols = {}
        for spec in self.program["raw_inputs"]:
            key = spec["key"]
            if spec["kind"] == "numeric":
                vals = np.array(
                    [self._num(r.get(key)) for r in records], np.float64)
            else:
                vals = [r.get(key) for r in records]
            cols[spec["name"]] = vals
        return cols

    @staticmethod
    def _num(v):
        if v is None or v == "":
            return np.nan
        return float(v)

    @staticmethod
    def _clean(v):
        return "".join(ch for ch in str(v).strip()
                       if ch.isalnum() or ch == " ")

    def _hash_docs(self, docs, width):
        """(n, width) float32 hashed token counts — HashingTF semantics,
        identical to the framework kernel (murmur3 seed 42 % width)."""
        _, hashing = self._text_runtime()
        out = np.zeros((len(docs), width), np.float32)
        for i, toks in enumerate(docs):
            for t in toks or ():
                out[i, hashing.hash_to_bucket(t, width, 42)] += 1.0
        return out

    def _hashed_text_block(self, values, lang, width):
        """SmartText hashed branch: tokenize (en/unknown) or per-language
        analyze (stemming), then the hashing trick — framework parity."""
        text, _ = self._text_runtime()
        if lang in ("en", "unknown") or lang not in text.analyzer_languages():
            docs = [text.tokenize("" if v is None else str(v))
                    for v in values]
        else:
            docs = [text.analyze(v, language=lang, stemming="auto")
                    for v in values]
        return self._hash_docs(docs, width)

    def _cat_block(self, values, vocab, clean_text, track_nulls):
        n = len(values)
        k = len(vocab)
        width = k + 1 + (1 if track_nulls else 0)
        block = np.zeros((n, width), np.float64)
        index = {v: i for i, v in enumerate(vocab)}
        for i, v in enumerate(values):
            if not v:
                if track_nulls:
                    block[i, k + 1] = 1.0
                continue
            key = self._clean(v) if clean_text else v
            j = index.get(key)
            block[i, k if j is None else j] = 1.0
        return block

    # -- ops ---------------------------------------------------------------
    def score(self, records):
        cols = self._extract(records)
        n = len(records)
        out_col = None
        for op in self.program["ops"]:
            kind = op["op"]
            fn = getattr(self, "_op_" + kind, None)
            if fn is None:
                raise ValueError("unknown op %r" % (kind,))
            res = fn(op, cols, n)
            if res is not None:
                out_col = res
        rows = []
        for i in range(n):
            row = {"prediction": float(out_col["prediction"][i]),
                   "score": float(np.asarray(out_col["score"][i]).ravel()[0])}
            if out_col["probability"] is not None:
                row["probability"] = [float(v)
                                      for v in out_col["probability"][i]]
            rows.append(row)
        return rows

    # each _op_* returns None for transformers, or the prediction payload
    # dict for model heads (the LAST one wins — isotonic rewrites it)

    def _op_numeric_vectorize(self, op, cols, n):
        x = np.column_stack([cols[c] for c in op["inputs"]])
        nan = np.isnan(x)
        if op.get("non_nullable") and nan.any():
            bad = [c for j, c in enumerate(op["inputs"]) if nan[:, j].any()]
            raise ValueError(
                "non-nullable (RealNN) inputs %r received missing/NaN values "
                "at scoring time" % (bad,))
        filled = np.where(nan, self.arrays[op["fills"]][None, :], x)
        if op["track_nulls"]:
            # interleaved [value, null] per feature, f32 emit — exactly the
            # framework vectorizer's block layout
            nn, d = filled.shape
            block = np.empty((nn, 2 * d), np.float32)
            block[:, 0::2] = filled
            block[:, 1::2] = nan
        else:
            block = filled.astype(np.float32)
        cols[op["out"]] = block.astype(np.float64)

    def _op_onehot(self, op, cols, n):
        blocks = []
        for cname, vocab in zip(op["inputs"], op["vocabs"]):
            blocks.append(self._cat_block(cols[cname], vocab,
                                          op["clean_text"],
                                          op["track_nulls"]))
        cols[op["out"]] = np.hstack(blocks)

    def _op_multihot(self, op, cols, n):
        blocks = []
        for cname, vocab in zip(op["inputs"], op["vocabs"]):
            vals = cols[cname]
            k = len(vocab)
            width = k + 1 + (1 if op["track_nulls"] else 0)
            block = np.zeros((n, width), np.float64)
            index = {v: i for i, v in enumerate(vocab)}
            for i, members in enumerate(vals):
                if not members:
                    if op["track_nulls"]:
                        block[i, k + 1] = 1.0
                    continue
                for v in members:
                    key = self._clean(v) if op["clean_text"] else v
                    j = index.get(key)
                    block[i, k if j is None else j] = 1.0
            blocks.append(block)
        cols[op["out"]] = np.hstack(blocks)

    def _op_smart_text(self, op, cols, n):
        blocks = []
        for cname, plan in zip(op["inputs"], op["plans"]):
            values = cols[cname]
            if plan["cat"]:
                block = self._cat_block(values, plan["vocab"],
                                        op["clean_text"], op["track_nulls"])
            else:
                block = self._hashed_text_block(values, plan["lang"],
                                                op["num_hashes"]
                                                ).astype(np.float64)
                extras = []
                if op["track_text_len"]:
                    extras.append(np.array(
                        [float(len(v)) if v else 0.0 for v in values]
                    )[:, None])
                if op["track_nulls"]:
                    extras.append(np.array(
                        [0.0 if v else 1.0 for v in values])[:, None])
                if extras:
                    block = np.hstack([block] + extras)
            blocks.append(block)
        cols[op["out"]] = np.hstack(blocks)

    def _op_smart_text_map(self, op, cols, n):
        blocks = []
        for cname, plan in zip(op["inputs"], op["key_plans"]):
            maps = cols[cname]
            for key, spec in plan:
                values = [(m or {}).get(key) for m in maps]
                if spec["categorical"]:
                    blocks.append(self._cat_block(
                        values, spec["vocab"], op["clean_text"],
                        op["track_nulls"]))
                else:
                    block = self._hashed_text_block(
                        values, spec.get("language", "en"),
                        op["num_hashes"]).astype(np.float64)
                    if op["track_nulls"]:
                        nulls = np.array([0.0 if v else 1.0 for v in values])
                        block = np.hstack([block, nulls[:, None]])
                    blocks.append(block)
        cols[op["out"]] = np.hstack(blocks) if blocks \
            else np.zeros((n, 0), np.float64)

    def _op_date_unit_circle(self, op, cols, n):
        blocks = []
        for cname in op["inputs"]:
            v = np.asarray(cols[cname], np.float64)
            present = np.isfinite(v)
            ms = np.where(present, v, 0.0).astype(np.int64)
            for period in op["time_periods"]:
                vals = _time_period(ms, period).astype(np.float64)
                if period in ("DayOfWeek", "DayOfMonth", "DayOfYear"):
                    vals -= 1.0
                angle = 2.0 * np.pi * vals / _PERIOD_SIZE[period]
                cos = np.where(present, np.cos(angle), 0.0)
                sin = np.where(present, np.sin(angle), 0.0)
                blocks.append(np.column_stack([cos, sin])
                              .astype(np.float32).astype(np.float64))
        cols[op["out"]] = np.hstack(blocks)

    def _op_date_list(self, op, cols, n):
        pivot = op["pivot"]
        blocks = []
        for cname in op["inputs"]:
            lists = cols[cname]
            if pivot in ("SinceFirst", "SinceLast"):
                vals = np.full(n, float(op["fill_value"]))
                present = np.zeros(n, bool)
                for i, lst in enumerate(lists):
                    if lst:
                        t = min(lst) if pivot == "SinceFirst" else max(lst)
                        vals[i] = (op["reference_date_ms"] - int(t)) / _DAY_MS
                        present[i] = True
                blocks.append(vals[:, None].astype(np.float32)
                              .astype(np.float64))
            else:
                period, card, one_based = _MODE_SPECS[pivot]
                block = np.zeros((n, card), np.float64)
                present = np.zeros(n, bool)
                for i, lst in enumerate(lists):
                    if not lst:
                        continue
                    ords = _time_period(np.asarray(lst, np.int64), period)
                    uv, uc = np.unique(ords, return_counts=True)
                    mode = int(uv[np.argmax(uc)]) - (1 if one_based else 0)
                    block[i, mode] = 1.0
                    present[i] = True
                blocks.append(block)
            if op["track_nulls"]:
                blocks.append((~present).astype(np.float64)[:, None])
        cols[op["out"]] = np.hstack(blocks)

    def _op_text_list_hash(self, op, cols, n):
        width = op["num_hashes"]
        blocks = []
        if op["shared_hash_space"]:
            block = np.zeros((n, width), np.float32)
            for cname in op["inputs"]:
                block = block + self._hash_docs(cols[cname], width)
            blocks.append(block.astype(np.float64))
        else:
            for cname in op["inputs"]:
                blocks.append(self._hash_docs(cols[cname], width)
                              .astype(np.float64))
        if op["track_nulls"]:
            for cname in op["inputs"]:
                nulls = np.array([0.0 if t else 1.0 for t in cols[cname]])
                blocks.append(nulls[:, None])
        cols[op["out"]] = np.hstack(blocks)

    def _op_geo_vectorize(self, op, cols, n):
        fills = self.arrays[op["fills"]]
        blocks = []
        for j, cname in enumerate(op["inputs"]):
            vals = cols[cname]
            block = np.tile(fills[j][None, :], (n, 1)).astype(np.float64)
            present = np.zeros(n, bool)
            for i, v in enumerate(vals):
                if v is not None and len(v) == 3:
                    block[i] = np.asarray(v, np.float64)
                    present[i] = True
            parts = [block.astype(np.float32).astype(np.float64)]
            if op["track_nulls"]:
                parts.append((~present).astype(np.float64)[:, None])
            blocks.append(np.hstack(parts))
        cols[op["out"]] = np.hstack(blocks)

    def _op_numeric_map(self, op, cols, n):
        blocks = []
        for j, cname in enumerate(op["inputs"]):
            keys = op["keys"][j]
            fills = self.arrays[op["fills"][j]]
            per_key = 2 if op["track_nulls"] else 1
            block = np.zeros((n, len(keys) * per_key), np.float64)
            index = {k: jj for jj, k in enumerate(keys)}
            for jj in range(len(keys)):
                block[:, jj * per_key] = fills[jj]
                if op["track_nulls"]:
                    block[:, jj * per_key + 1] = 1.0
            for i, m in enumerate(cols[cname]):
                for k, v in (m or {}).items():
                    kk = self._clean(k) if op["clean_keys"] else k
                    jj = index.get(kk)
                    if jj is not None:
                        block[i, jj * per_key] = float(v)
                        if op["track_nulls"]:
                            block[i, jj * per_key + 1] = 0.0
            blocks.append(block.astype(np.float32).astype(np.float64))
        cols[op["out"]] = np.hstack(blocks)

    def _op_geo_map(self, op, cols, n):
        blocks = []
        for j, cname in enumerate(op["inputs"]):
            keys = op["keys"][j]
            fills = self.arrays[op["fills"][j]]
            per_key = 3 + (1 if op["track_nulls"] else 0)
            block = np.zeros((n, len(keys) * per_key), np.float64)
            index = {k: jj for jj, k in enumerate(keys)}
            for jj in range(len(keys)):
                block[:, jj * per_key: jj * per_key + 3] = fills[jj]
                if op["track_nulls"]:
                    block[:, jj * per_key + 3] = 1.0
            for i, m in enumerate(cols[cname]):
                for k, v in (m or {}).items():
                    jj = index.get(k)
                    if jj is not None and len(v) == 3:
                        block[i, jj * per_key: jj * per_key + 3] = v
                        if op["track_nulls"]:
                            block[i, jj * per_key + 3] = 0.0
            blocks.append(block.astype(np.float32).astype(np.float64))
        cols[op["out"]] = np.hstack(blocks)

    def _op_text_map_pivot(self, op, cols, n):
        blocks = []
        for j, cname in enumerate(op["inputs"]):
            vocab = dict((k, v) for k, v in op["vocabs"][j])
            keys = sorted(vocab)
            offsets = {}
            width = 0
            for k in keys:
                offsets[k] = width
                width += len(vocab[k]) + 1 + (1 if op["track_nulls"] else 0)
            block = np.zeros((n, width), np.float64)
            if op["track_nulls"]:
                for k in keys:
                    block[:, offsets[k] + len(vocab[k]) + 1] = 1.0
            for i, m in enumerate(cols[cname]):
                cleaned = {}
                for k, v in (m or {}).items():
                    cleaned[self._clean(k) if op["clean_text"] else k] = v
                for k in keys:
                    if k not in cleaned:
                        continue
                    base = offsets[k]
                    kv = len(vocab[k])
                    if op["track_nulls"]:
                        block[i, base + kv + 1] = 0.0
                    v = cleaned[k]
                    vals = v if isinstance(v, (list, tuple, set)) else [v]
                    for x in vals:
                        x = self._clean(x) if op["clean_text"] else x
                        if x in vocab[k]:
                            block[i, base + vocab[k].index(x)] = 1.0
                        else:
                            block[i, base + kv] = 1.0
            blocks.append(block)
        cols[op["out"]] = np.hstack(blocks)

    def _op_string_indexer(self, op, cols, n):
        index = {t: float(j) for j, t in enumerate(op["labels"])}
        unseen = float(len(op["labels"]))
        out = np.empty(n, np.float64)
        for i, v in enumerate(cols[op["inputs"][0]]):
            if v is None or v not in index:
                if op["handle_invalid"] == "error":
                    raise ValueError(
                        "StringIndexer: unseen/missing value %r at scoring "
                        "time (fitted with handle_invalid='error')" % (v,))
                out[i] = unseen
            else:
                out[i] = index[v]
        cols[op["out"]] = out

    def _op_fill_mean(self, op, cols, n):
        v = np.asarray(cols[op["inputs"][0]], np.float64)
        cols[op["out"]] = np.where(np.isnan(v), op["mean"], v)

    def _op_standard_scaler(self, op, cols, n):
        v = np.asarray(cols[op["inputs"][0]], np.float64)
        cols[op["out"]] = (v - op["mean"]) / op["std"]

    def _op_percentile_calibrator(self, op, cols, n):
        v = np.asarray(cols[op["inputs"][0]], np.float64)
        splits = self.arrays[op["splits"]]
        idx = np.clip(np.searchsorted(splits[1:-1], v, side="right"),
                      0, len(splits) - 2)
        cols[op["out"]] = idx.astype(np.float64)

    def _op_concat(self, op, cols, n):
        cols[op["out"]] = np.hstack(
            [np.asarray(cols[c]).reshape(n, -1) for c in op["inputs"]])

    def _op_select(self, op, cols, n):
        cols[op["out"]] = \\
            cols[op["inputs"][0]][:, self.arrays[op["indices"]]]

    def _op_isotonic(self, op, cols, n):
        s = np.asarray(cols[op["inputs"][-1]], np.float64).reshape(-1)
        cal = np.interp(s, self.arrays[op["knots_x"]],
                        self.arrays[op["knots_y"]])
        cols[op["out"]] = cal
        return {"prediction": cal, "probability": None, "score": cal}

    # -- model heads -------------------------------------------------------
    def _op_logistic(self, op, cols, n):
        x = cols[op["inputs"][-1]]
        z = x @ self.arrays[op["coef"]] + op["intercept"]
        p1 = 1.0 / (1.0 + np.exp(-z))
        cols[op["out"]] = p1
        return {"prediction": (p1 > 0.5).astype(np.float64),
                "probability": np.column_stack([1 - p1, p1]), "score": z}

    def _op_linear(self, op, cols, n):
        x = cols[op["inputs"][-1]]
        z = x @ self.arrays[op["coef"]] + op["intercept"]
        cols[op["out"]] = z
        return {"prediction": z, "probability": None, "score": z}

    def _op_svc(self, op, cols, n):
        x = cols[op["inputs"][-1]]
        z = x @ self.arrays[op["coef"]] + op["intercept"]
        cols[op["out"]] = z
        return {"prediction": (z > 0).astype(np.float64),
                "probability": None, "score": z}

    def _op_softmax(self, op, cols, n):
        x = cols[op["inputs"][-1]]
        logits = x @ self.arrays[op["coef"]] + self.arrays[op["intercept"]]
        prob = _softmax(logits)
        pred = prob.argmax(1).astype(np.float64)
        cols[op["out"]] = pred
        return {"prediction": pred, "probability": prob,
                "score": prob.max(1)}

    def _op_naive_bayes(self, op, cols, n):
        x = np.maximum(cols[op["inputs"][-1]]
                       - self.arrays[op["shift"]], 0.0)
        raw = x @ self.arrays[op["log_theta"]].T + self.arrays[op["log_prior"]]
        prob = _softmax(raw)
        pred = self.arrays[op["classes"]][np.argmax(raw, axis=1)]
        cols[op["out"]] = pred
        return {"prediction": pred, "probability": prob,
                "score": prob.max(1)}

    def _op_mlp(self, op, cols, n):
        h = np.asarray(cols[op["inputs"][-1]], np.float64)
        for li in range(op["n_layers"] - 1):
            h = np.tanh(h @ self.arrays[op["w%d" % li]]
                        + self.arrays[op["b%d" % li]])
        li = op["n_layers"] - 1
        raw = h @ self.arrays[op["w%d" % li]] + self.arrays[op["b%d" % li]]
        prob = _softmax(raw)
        pred = self.arrays[op["classes"]][np.argmax(raw, axis=1)]
        cols[op["out"]] = pred
        return {"prediction": pred, "probability": prob,
                "score": prob.max(1)}

    def _op_glm(self, op, cols, n):
        x = cols[op["inputs"][-1]]
        eta = x @ self.arrays[op["coef"]] + op["intercept"]
        fam = op["family"]
        if fam == "binomial":
            mu = 1.0 / (1.0 + np.exp(-eta))
        elif fam in ("poisson", "gamma"):
            mu = np.exp(np.clip(eta, -30, 30))
        else:
            mu = eta
        cols[op["out"]] = mu
        return {"prediction": mu, "probability": None, "score": mu}

    def _op_trees(self, op, cols, n):
        out_col = self._trees(op, cols[op["inputs"][-1]])
        cols[op["out"]] = out_col["score"]
        return out_col

    def _trees(self, op, x):
        a = self.arrays
        edges = a[op["edges"]]
        n_bins = op["n_bins"]
        x = np.asarray(x).astype(np.float32)  # bin compares mirror f32 fit
        n, d = x.shape
        binned = np.empty((n, d), np.int32)
        for j in range(d):
            binned[:, j] = np.searchsorted(edges[j], x[:, j], side="right")
        binned[~np.isfinite(x)] = n_bins
        feat, thr = a[op["t_feat"]], a[op["t_thr_bin"]]
        miss, leaf = a[op["t_miss_left"]], a[op["t_is_leaf"]]
        value = a[op["t_value"]]
        T = feat.shape[0]
        node = np.zeros((T, n), np.int32)
        rows = np.arange(n)
        for _ in range(op["max_depth"]):
            nf = np.take_along_axis(feat, node, 1)
            nb = binned[rows[None, :], nf]
            nmiss = np.take_along_axis(miss, node, 1)
            nthr = np.take_along_axis(thr, node, 1)
            go_left = np.where(nb == n_bins, nmiss, nb <= nthr)
            child = np.where(go_left, 2 * node + 1, 2 * node + 2)
            node = np.where(np.take_along_axis(leaf, node, 1), node, child)
        margin = value[np.arange(T)[:, None], node].sum(axis=0) \\
            .astype(np.float64) + a[op["base_score"]][None, :]
        flavor = op["flavor"]
        if flavor == "gbt_cls":
            if margin.shape[1] == 1:
                z = margin[:, 0]
                p1 = 1.0 / (1.0 + np.exp(-z))
                return {"prediction": (p1 > 0.5).astype(np.float64),
                        "probability": np.column_stack([1 - p1, p1]),
                        "score": z}
            prob = _softmax(margin)
            return {"prediction": prob.argmax(1).astype(np.float64),
                    "probability": prob, "score": prob.max(1)}
        if flavor == "rf_cls":
            mean = margin / T
            if mean.shape[1] == 1:
                p1 = np.clip(mean[:, 0], 0.0, 1.0)
                return {"prediction": (p1 > 0.5).astype(np.float64),
                        "probability": np.column_stack([1 - p1, p1]),
                        "score": p1}
            prob = np.clip(mean, 0.0, 1.0)
            prob = prob / np.maximum(prob.sum(1, keepdims=True), 1e-12)
            return {"prediction": prob.argmax(1).astype(np.float64),
                    "probability": prob, "score": prob.max(1)}
        pred = margin[:, 0] / (T if flavor == "rf_reg" else 1.0)
        return {"prediction": pred, "probability": None, "score": pred}
'''
