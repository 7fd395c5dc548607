"""Readers, monoid aggregation, OpParams and the WorkflowRunner of the port
against the JAX package, on the same records and files (in ``tmp_path``).

- ``aggregators/monoid.py``: each type's default aggregator and
  ``aggregate_events`` with cut-offs and windows, predictor and response;
- ``readers/``: ``CustomReader``, ``rows_to_dataset``, ``DataFrameReader``,
  the CSV, Parquet, JSON-lines and Avro readers (each package reads the
  other's Avro container bytes), ``StreamingReader``'s batches, the
  aggregate, conditional and joined readers, and ``DataReaders``;
- ``features/builder.py``: ``from_dataframe``, ``from_schema``, ``window``;
- ``params.py``: ``OpParams`` from JSON and YAML, its files and its stage
  overrides (params set in code win);
- ``workflow/``: ``set_reader``, ``set_parameters``, ``with_model_stages``,
  ``summary_pretty``, ``compute_data_up_to``, ``score``/``evaluate`` through
  the reader, and ``WorkflowRunner``/``App`` over TRAIN, SCORE, FEATURES and
  EVALUATE (STREAMING_SCORE: ``tests/test_torch_streaming.py``); every
  param that needs a module not ported yet raises naming it.
"""

import json
import os
import re

import numpy as np
import pandas as pd
import pytest

import transmogrifai_tpu as J
import transmogrifai_tpu.aggregators.monoid as J_mon
import transmogrifai_tpu.params as J_params
import transmogrifai_tpu.readers.avro as J_avro
import transmogrifai_tpu.readers.base as J_rb
import transmogrifai_tpu.readers.files as J_rf
import transmogrifai_tpu.readers.joined as J_rj
import transmogrifai_tpu.workflow.runner as J_run
import transmogrifai_tpu.types as JT
import transmogrifai_tpu_torch as T
import transmogrifai_tpu_torch.aggregators.monoid as T_mon
import transmogrifai_tpu_torch.params as T_params
import transmogrifai_tpu_torch.readers.avro as T_avro
import transmogrifai_tpu_torch.readers.base as T_rb
import transmogrifai_tpu_torch.readers.files as T_rf
import transmogrifai_tpu_torch.readers.joined as T_rj
import transmogrifai_tpu_torch.workflow.runner as T_run
import transmogrifai_tpu_torch.types as TT
from transmogrifai_tpu.models.logistic import LogisticRegression as JLR
from transmogrifai_tpu_torch.models.logistic import LogisticRegression as TLR
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device

PKGS = {"j": (J, JT, J_rb, J_rf, J_rj, J_mon), "t": (T, TT, T_rb, T_rf, T_rj, T_mon)}


def _values(ds, names=None):
    """Column values by name, NaN as the string "nan" (so equal tables
    compare equal)."""
    return {n: ["nan" if isinstance(v, float) and v != v else v
                for v in ds[n].to_values()] for n in (names or ds.names)}


def _same_ds(jds, tds):
    assert jds.names == tds.names
    for n in jds.names:
        a, b = jds[n].to_values(), tds[n].to_values()
        if jds[n].kind.value == "vector":
            assert all(np.array_equal(x, y) for x, y in zip(a, b)), n
        else:
            assert a == b, n
        assert jds[n].ftype.__name__ == tds[n].ftype.__name__


def _feats(pkg, spec, response=()):
    """Raw features of ``spec`` ({name: type name}) in ``pkg``."""
    out = []
    for name, tname in spec.items():
        b = pkg.FeatureBuilder.of(name, tname).extract_field()
        out.append(b.as_response() if name in response else b.as_predictor())
    return out


# -- aggregators/monoid.py ---------------------------------------------------------

EVENTS = {
    "Real": [1.5, None, 2.0, -0.5],
    "Integral": [3, 4, None, 1],
    "Date": [500, 300, None, 900],
    "Binary": [False, None, True, False],
    "Text": ["a", None, "b c", "d"],
    "PickList": [None, "x", "y", None],
    "TextList": [["a"], [], ["b", "c"], ["a"]],
    "MultiPickList": [{"a"}, set(), {"b"}, {"a", "c"}],
    "Geolocation": [[1.0, 2.0, 3.0], [], [3.0, 4.0, 1.0], [5.0, 6.0, 2.0]],
}


class TestMonoids:
    @pytest.mark.parametrize("tname", sorted(EVENTS))
    @pytest.mark.parametrize("cutoff, window, response", [
        (None, None, False), (250, None, False), (250, 100, False),
        (250, None, True), (250, 500, True)])
    def test_aggregate_events(self, tname, cutoff, window, response):
        vals = EVENTS[tname]
        times = [100, 200, 300, 400]
        out = []
        for mon, tmod in ((J_mon, JT), (T_mon, TT)):
            events = [mon.Event(t, v, response) for t, v in zip(times, vals)]
            out.append(mon.aggregate_events(tmod.feature_type_by_name(tname), events,
                                            is_response=response, cutoff_ms=cutoff,
                                            window_ms=window))
        assert out[1] == out[0]

    def test_prediction_and_vector_defaults(self):
        for tname in ("Prediction", "OPVector"):
            jagg = J_mon.default_aggregator(JT.feature_type_by_name(tname))
            tagg = T_mon.default_aggregator(TT.feature_type_by_name(tname))
            vals = ([{"prediction": 1.0}, {"prediction": 0.0, "p": 2.0}]
                    if tname == "Prediction" else [np.float32([1, 2]), np.float32([3, 4])])
            a, b = jagg.reduce(vals), tagg.reduce(vals)
            assert (a == b) if tname == "Prediction" else np.array_equal(a, b)

    def test_custom_aggregator_and_window_on_the_feature(self):
        agg = T_mon.MonoidAggregator(None, lambda a, b: b if a is None else max(a, b))
        f = T.FeatureBuilder.Real("amount").extract_field().aggregate(agg).window(150) \
            .as_predictor()
        g = f.origin_stage
        assert g.aggregator is agg and g.aggregate_window_ms == 150

    @pytest.mark.parametrize("kind", ["unix", "no_cutoff", "function"])
    def test_cutoff_time(self, kind):
        rec = {"t": 42}
        got = []
        for mon in (J_mon, T_mon):
            c = {"unix": lambda: mon.CutOffTime.unix(250),
                 "no_cutoff": mon.CutOffTime.no_cutoff,
                 "function": lambda: mon.CutOffTime.function(lambda r: r["t"] * 2)}[kind]()
            got.append((c.kind, c.cutoff_for(rec)))
        assert got[0] == got[1]

    def test_a_typed_map_has_no_default_yet(self):
        """The typed maps are ported now: a map type with no default of its
        own folds as the reference's does (the later value of a key wins)."""
        values = [{"a": "x"}, {"a": "y", "b": "z"}, {}]
        got = []
        for mon, types_mod in ((T_mon, TT), (J_mon, JT)):
            class SomeMap(types_mod.OPMap):
                pass

            agg = mon.default_aggregator(SomeMap)
            acc = agg.zero
            for v in values:
                acc = agg.plus(acc, v)
            got.append(agg.present(acc))
        assert got[0] == got[1] == {"a": "y", "b": "z"}


# -- readers -------------------------------------------------------------------------

RECORDS = [
    {"id": "k1", "x": 1.5, "n": 3, "c": "a", "y": 1.0, "flag": True},
    {"id": "k2", "x": None, "n": None, "c": None, "y": 0.0, "flag": False},
    {"id": "k3", "x": -2.0, "n": 7, "c": "b", "y": 1.0, "flag": None},
]
SPEC = {"id": "ID", "x": "Real", "n": "Integral", "c": "PickList", "y": "RealNN",
        "flag": "Binary"}


class TestReaders:
    def test_custom_reader_and_rows_to_dataset(self):
        out = []
        for key, (pkg, _, rb, _, _, _) in PKGS.items():
            feats = _feats(pkg, SPEC, response=("y",))
            out.append(rb.CustomReader(lambda: RECORDS, key_fn=lambda r: r["id"])
                       .generate_dataset(feats))
        _same_ds(*out)

    def test_missing_response_only_when_scoring(self):
        recs = [{k: v for k, v in r.items() if k != "y"} for r in RECORDS]
        for pkg, rb in ((J, J_rb), (T, T_rb)):
            feats = _feats(pkg, SPEC, response=("y",))
            ds = rb.rows_to_dataset(recs, feats, allow_missing_response=True)
            assert "y" not in ds and ds.n_rows == 3
            with pytest.raises(Exception):
                rb.rows_to_dataset(recs, feats)

    def test_generate_chunked_is_refused_by_name(self, tmp_path):
        """``generate_chunked`` is ported (it was refused by name until the
        chunked store came): once materialized it equals
        ``generate_dataset``, in chunks of ``chunk_rows`` records, as in the
        JAX package; the aggregate readers still refuse it by name."""
        out = []
        for key, (pkg, rb) in {"j": (J, J_rb), "t": (T, T_rb)}.items():
            feats = _feats(pkg, SPEC, response=("y",))
            cds = rb.CustomReader(lambda: RECORDS).generate_chunked(
                feats, chunk_rows=2, spill_dir=str(tmp_path / key))
            assert (cds.n_rows, cds.n_chunks, cds.chunk_rows) == (3, 2, 2)
            got = cds.materialize()
            _same_ds(rb.CustomReader(lambda: RECORDS).generate_dataset(feats), got)
            out.append(got)
            agg = rb.AggregateReader(rb.CustomReader(lambda: RECORDS),
                                     key_fn=lambda r: r["id"], time_fn=lambda r: 0)
            with pytest.raises(NotImplementedError, match="generate_chunked"):
                agg.generate_chunked(feats)
        _same_ds(*out)

    def _frame(self):
        return pd.DataFrame({"id": ["k1", "k2", "k3"], "x": [1.5, np.nan, -2.0],
                             "n": [3, 4, 7], "c": ["a", None, "b"],
                             "y": [1.0, 0.0, 1.0], "flag": [True, False, True]})

    def test_dataframe_reader(self):
        out = []
        for key, (pkg, _, _, rf, _, _) in PKGS.items():
            feats = _feats(pkg, SPEC, response=("y",))
            feats.append(pkg.FeatureBuilder.Real("x2").extract(
                lambda r: None if r["x"] != r["x"] else 2 * r["x"]).as_predictor())
            out.append(rf.DataReaders.Simple.dataframe(self._frame()).generate_dataset(feats))
        _same_ds(*out)
        with pytest.raises(KeyError, match="missing columns"):
            T_rf.DataReaders.Simple.dataframe(self._frame()).generate_dataset(
                _feats(T, {"absent": "Real"}))

    @pytest.mark.parametrize("fmt", ["csv", "csv_headers", "json_lines", "parquet"])
    def test_file_readers(self, fmt, tmp_path):
        df = self._frame()
        path = str(tmp_path / f"data.{fmt}")
        if fmt.startswith("csv"):
            df.to_csv(path, index=False, header=(fmt == "csv"))
        elif fmt == "json_lines":
            df.to_json(path, orient="records", lines=True)
        else:
            df.to_parquet(path)
        out = []
        for key, (pkg, _, _, rf, _, _) in PKGS.items():
            S = rf.DataReaders.Simple
            reader = {"csv": lambda: S.csv_auto(path),
                      "csv_headers": lambda: S.csv(path, headers=list(df.columns)),
                      "json_lines": lambda: S.json_lines(path),
                      "parquet": lambda: S.parquet(path)}[fmt]()
            out.append(reader.generate_dataset(_feats(pkg, SPEC, response=("y",))))
        _same_ds(*out)

    @pytest.mark.parametrize("writer", ["j", "t"])
    @pytest.mark.parametrize("codec", ["null", "deflate"])
    def test_avro_crosses_both_ways(self, writer, codec, tmp_path):
        schema = {"type": "record", "name": "Row", "fields": [
            {"name": "id", "type": "string"},
            {"name": "x", "type": ["null", "double"]},
            {"name": "n", "type": ["null", "long"]},
            {"name": "c", "type": ["null", "string"]},
            {"name": "y", "type": "double"},
            {"name": "flag", "type": ["null", "boolean"]}]}
        path = str(tmp_path / "rows.avro")
        (J_avro if writer == "j" else T_avro).write_container(path, schema, RECORDS, codec)
        other = str(tmp_path / "other.avro")
        (T_avro if writer == "j" else J_avro).write_container(other, schema, RECORDS, codec)
        with open(path, "rb") as a, open(other, "rb") as b:
            assert a.read() == b.read()     # the same bytes from both codecs
        out = []
        for key, (pkg, _, _, rf, _, _) in PKGS.items():
            reader = rf.DataReaders.Simple.avro(path)
            assert reader.schema == schema
            out.append(reader.generate_dataset(_feats(pkg, SPEC, response=("y",))))
        _same_ds(*out)
        assert list(T_avro.read_container(path)[1]) == RECORDS

    def test_streaming_reader_batches(self):
        out = []
        for key, (pkg, tmod, rb, rf, _, _) in PKGS.items():
            feats = _feats(pkg, SPEC, response=("y",))
            recs = [{k: v for k, v in r.items() if k != "y"} for r in RECORDS]
            batches = [recs[:2], pd.DataFrame(recs[2:]),
                       rb.CustomReader(lambda: RECORDS)]
            out.append(list(rf.StreamingReader(batches).stream_datasets(feats)))
        for a, b in zip(*out):
            _same_ds(a, b)
        assert "y" not in out[1][0] and "y" not in out[1][1] and "y" in out[1][2]


PURCHASES = [
    {"id": "a", "t": 100, "amount": 10.0, "store": "north", "churn": None},
    {"id": "a", "t": 200, "amount": 20.0, "store": "north", "churn": None},
    {"id": "a", "t": 300, "amount": 40.0, "store": "south", "churn": 1.0},
    {"id": "b", "t": 150, "amount": 5.0, "store": "south", "churn": 0.0},
    {"id": "b", "t": 250, "amount": 15.0, "store": "south", "churn": 1.0},
    {"id": "c", "t": 120, "amount": 7.0, "store": "north", "churn": 0.0},
]


def _purchase_feats(pkg, window=None):
    amount = pkg.FeatureBuilder.Real("amount").extract_field()
    if window is not None:
        amount = amount.window(window)
    return [amount.as_predictor(),
            pkg.FeatureBuilder.Text("store").extract_field().as_predictor(),
            pkg.FeatureBuilder.Real("churn").extract_field().as_response()]


class TestAggregateReaders:
    @pytest.mark.parametrize("cutoff", [None, 250])
    @pytest.mark.parametrize("window", [None, 120])
    def test_aggregate_reader(self, cutoff, window):
        out = []
        for key, (pkg, _, rb, _, _, mon) in PKGS.items():
            c = mon.CutOffTime.unix(cutoff) if cutoff else mon.CutOffTime.no_cutoff()
            reader = rb.AggregateReader(rb.CustomReader(lambda: PURCHASES),
                                        key_fn=lambda r: r["id"],
                                        time_fn=lambda r: r["t"], cutoff=c)
            ds, keys = reader.generate_dataset_with_keys(_purchase_feats(pkg, window))
            out.append((keys, _values(ds)))
        assert out[0] == out[1]

    @pytest.mark.parametrize("drop", [True, False])
    def test_conditional_reader(self, drop):
        out = []
        for key, (pkg, _, rb, _, _, _) in PKGS.items():
            reader = rb.ConditionalReader(rb.CustomReader(lambda: PURCHASES),
                                          key_fn=lambda r: r["id"],
                                          time_fn=lambda r: r["t"],
                                          condition_fn=lambda r: r["store"] == "south",
                                          drop_if_no_condition=drop)
            ds, keys = reader.generate_dataset_with_keys(_purchase_feats(pkg))
            out.append((keys, _values(ds)))
            assert reader.generate_dataset(_purchase_feats(pkg)).n_rows == len(keys)
        assert out[0] == out[1]
        assert out[1][0] == (["a", "b"] if drop else ["a", "b", "c"])

    def test_aggregate_readers_refuse_chunked_events(self):
        reader = T_rb.AggregateReader(T_rb.CustomReader(lambda: PURCHASES),
                                      key_fn=lambda r: r["id"], time_fn=lambda r: r["t"])
        with pytest.raises(NotImplementedError, match="per-event"):
            reader.generate_chunked(_purchase_feats(T))

    def test_data_readers_factories(self):
        df = pd.DataFrame(PURCHASES)
        out = []
        for key, (pkg, _, _, rf, _, mon) in PKGS.items():
            agg = rf.DataReaders.Aggregate.dataframe(
                df, key_fn=lambda r: r["id"], time_fn=lambda r: r["t"],
                cutoff=mon.CutOffTime.unix(260))
            cond = rf.DataReaders.Conditional.dataframe(
                df, key_fn=lambda r: r["id"], time_fn=lambda r: r["t"],
                condition_fn=lambda r: r["amount"] > 12)
            out.append([_values(r.generate_dataset(_purchase_feats(pkg)))
                        for r in (agg, cond)])
        assert out[0] == out[1]


CUSTOMERS = [{"cid": "a", "age": 30.0}, {"cid": "b", "age": 41.0},
             {"cid": "d", "age": 25.0}]
ORDERS = [{"oid": "a", "price": 5.0, "ts": 100, "cut": 250},
          {"oid": "a", "price": 7.0, "ts": 300, "cut": 250},
          {"oid": "b", "price": 2.0, "ts": 90, "cut": 100},
          {"oid": "c", "price": 9.0, "ts": 50, "cut": 60}]


class TestJoinedReaders:
    @pytest.mark.parametrize("join", ["INNER", "LEFT_OUTER", "RIGHT_OUTER", "FULL_OUTER"])
    def test_joined_reader(self, join):
        out = []
        for key, (pkg, _, rb, _, rj, _) in PKGS.items():
            left = rb.CustomReader(lambda: CUSTOMERS, key_fn=lambda r: r["cid"])
            right = rb.CustomReader(lambda: ORDERS, key_fn=lambda r: r["oid"])
            reader = rj.JoinedReader(left, right, ["age"], getattr(rj.JoinType, join))
            feats = _feats(pkg, {"age": "Real", "price": "Real"})
            ds, keys = reader._generate_with_keys(feats)
            out.append((keys, _values(ds)))
        assert out[0] == out[1]

    @pytest.mark.parametrize("window", [None, 150])
    def test_joined_aggregate_reader(self, window):
        out = []
        for key, (pkg, _, rb, _, rj, _) in PKGS.items():
            left = rb.CustomReader(lambda: CUSTOMERS, key_fn=lambda r: r["cid"])
            right = rb.CustomReader(lambda: ORDERS, key_fn=lambda r: r["oid"])
            tf = rj.TimeBasedFilter(condition=rj.TimeColumn("cut", keep=False),
                                    primary=rj.TimeColumn("ts", keep=False),
                                    window_ms=window)
            reader = rj.JoinedReader(left, right, ["age"], rj.JoinType.LEFT_OUTER) \
                .with_secondary_aggregation(tf)
            feats = _feats(pkg, {"age": "Real", "price": "Real", "cut": "Integral",
                                 "ts": "Integral"})
            out.append(_values(reader.generate_dataset(feats)))
        assert out[0] == out[1] and "cut" not in out[1]

    def test_a_left_name_off_by_case_is_refused(self):
        reader = T_rj.JoinedReader(T_rb.CustomReader(lambda: CUSTOMERS, key_fn=lambda r: r["cid"]),
                                   T_rb.CustomReader(lambda: ORDERS, key_fn=lambda r: r["oid"]),
                                   ["Age"])
        with pytest.raises(ValueError, match="differs only in case"):
            reader.generate_dataset(_feats(T, {"age": "Real", "price": "Real"}))


# -- features/builder.py and Dataset.to_pandas ----------------------------------------

class TestBuilder:
    def test_from_dataframe(self):
        df = pd.DataFrame({"a": [1.5, np.nan, 3.0], "b": [1, 2, 3], "c": ["x", None, "z"],
                           "d": [True, False, True], "y": [0, 1, 1]})
        out = []
        for pkg in (J, T):
            feats, ds = pkg.FeatureBuilder.from_dataframe(df, response="y")
            out.append(([(f.name, f.ftype.__name__, f.is_response) for f in feats], ds))
        assert out[0][0] == out[1][0]
        _same_ds(out[0][1], out[1][1])

    def test_from_schema(self):
        schema = {"a": "Real", "b": "PickList", "y": "RealNN"}
        got = [[(f.name, f.ftype.__name__, f.is_response)
                for f in pkg.FeatureBuilder.from_schema(schema, response="y")]
               for pkg in (J, T)]
        assert got[0] == got[1]

    def test_to_pandas(self):
        frames = []
        for key, (pkg, _, rb, _, _, _) in PKGS.items():
            ds = rb.CustomReader(lambda: RECORDS).generate_dataset(
                _feats(pkg, SPEC, response=("y",)))
            frames.append(ds.to_pandas())
        pd.testing.assert_frame_equal(frames[1], frames[0])


# -- params.py -----------------------------------------------------------------------

PARAMS = {
    "stageParams": {"LogisticRegression": {"reg_param": 0.5, "max_iter": 7}},
    "readerParams": {"train": {"path": "/data/t.csv", "custom": {"sep": ";"}}},
    "modelLocation": "m", "metricsLocation": "m.json", "writeLocation": "w.csv",
    "batchDurationSecs": 3, "customTagName": "tag", "customParams": {"k": 1},
}
YAML = """\
# a run
stageParams:
  LogisticRegression:
    reg_param: 0.5
    max_iter: 7
readerParams:
  train:
    path: /data/t.csv
modelLocation: m
batchDurationSecs: 3
logStageMetrics: false
customTagName: "tag"
"""


class TestOpParams:
    def test_json_round_trip(self, tmp_path):
        got = []
        for mod in (J_params, T_params):
            p = mod.OpParams.from_string(json.dumps(PARAMS))
            path = str(tmp_path / f"{mod.__name__}.json")
            p.save(path)
            got.append((p.to_dict(), mod.OpParams.from_file(path).to_dict()))
        assert got[0] == got[1] and got[1][0] == got[1][1]

    def test_yaml(self):
        assert T_params.OpParams.from_string(YAML).to_dict() == \
            J_params.OpParams.from_string(YAML).to_dict()
        assert T_params._parse_simple_yaml(YAML) == J_params._parse_simple_yaml(YAML)

    def test_code_wins_over_config(self):
        lr = TLR(reg_param=0.01)
        applied = T_params.OpParams.from_dict(PARAMS).apply_to_stages([lr])
        assert lr.reg_param == 0.01 and lr.max_iter == 7
        assert applied == {lr.uid: {"max_iter": 7}}
        with pytest.raises(ValueError, match="has no param 'nope'"):
            T_params.OpParams(stage_params={"LogisticRegression": {"nope": 1}}) \
                .apply_to_stages([TLR()])


# -- the workflow surface and the runner ----------------------------------------------

def _table(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    y = (x[:, 0] - 0.5 * x[:, 1] + rng.normal(scale=0.5, size=n) > 0).astype(float)
    return [{"x0": float(a), "x1": None if b < -1.2 else float(b), "x2": float(c),
             "y": float(t)} for (a, b, c), t in zip(x, y)]


TRAIN, SCORE = _table(400, 0), _table(120, 1)


def _lr_workflow(pkg, lr_cls, reader):
    y = pkg.FeatureBuilder.RealNN("y").extract_field().as_response()
    xs = [pkg.FeatureBuilder.Real(f"x{i}").extract_field().as_predictor() for i in range(3)]
    vec = pkg.transmogrify(xs)
    sel = pkg.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, models=[(lr_cls(), [{"reg_param": 0.01}, {"reg_param": 0.1}])])
    pred = y.transform_with(sel, vec)
    return pkg.Workflow().set_reader(reader).set_result_features(y, pred), vec


class _Apps:
    """The same App in both packages, over a records reader."""

    def __init__(self, key, evaluator=False):
        pkg, _, rb, _, _, _ = PKGS[key]
        run = J_run if key == "j" else T_run
        lr_cls = JLR if key == "j" else TLR
        outer = self

        class LrApp(run.App):
            """One runner for every run: the features run computes the
            trained DAG's own vector feature."""

            def runner(self, params):
                if outer.runner is None:
                    wf, vec = _lr_workflow(pkg, lr_cls, rb.CustomReader(lambda: TRAIN))
                    outer.vec = vec
                    outer.runner = run.WorkflowRunner(
                        workflow=wf, scoring_reader=rb.CustomReader(lambda: SCORE),
                        evaluator=(pkg.Evaluators.binary_classification()
                                   if evaluator else None),
                        features_to_compute=vec)
                return outer.runner

        self.runner = None
        self.app = LrApp()


def _both_runs(tmp_path, argv_for):
    out = {}
    for key in ("j", "t"):
        loc = str(tmp_path / f"model_{key}")
        apps = _Apps(key, evaluator=True)
        with use_device("cpu"):
            res = [apps.app.main(argv) for argv in argv_for(loc, key)]
        out[key] = res
    return out


class TestRunner:
    def test_train_score_features_evaluate(self, tmp_path):
        def argv(loc, key):
            return [["--run-type", "train", "--model-location", loc,
                     "--metrics-location", str(tmp_path / f"metrics_{key}.json")],
                    ["--run-type", "score", "--model-location", loc,
                     "--write-location", str(tmp_path / f"scores_{key}.csv")],
                    ["--run-type", "features", "--model-location", loc,
                     "--write-location", str(tmp_path / f"features_{key}.json")],
                    ["--run-type", "evaluate", "--model-location", loc]]

        runs = _both_runs(tmp_path, argv)
        (jt, js, jf, je), (tt, ts, tf, te) = runs["j"], runs["t"]
        assert [r.run_type.value for r in runs["t"]] == ["train", "score", "features",
                                                         "evaluate"]
        assert tt.metrics["bestModelName"] == jt.metrics["bestModelName"]
        assert tt.metrics["bestGrid"] == jt.metrics["bestGrid"]
        for a, b in zip(jt.metrics["validationResults"], tt.metrics["validationResults"]):
            np.testing.assert_allclose(b["values"], a["values"], rtol=0, atol=1e-4)
        for a, b in ((js.metrics, ts.metrics), (je.metrics, te.metrics)):
            for k in ("auROC", "auPR", "error"):
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-4)
        with open(tmp_path / "metrics_t.json") as fh:
            assert json.load(fh)["runType"] == "train"
        jcsv = pd.read_csv(tmp_path / "scores_j.csv")
        tcsv = pd.read_csv(tmp_path / "scores_t.csv")
        uidless = lambda cols: [re.sub(r"_[0-9a-f]{12}", "", c) for c in cols]  # noqa: E731
        assert uidless(tcsv.columns) == uidless(jcsv.columns) and len(tcsv) == len(SCORE)
        jv, tv = jf.scores, tf.scores
        a = np.asarray(jv[[n for n in jv.names if n.startswith("x0-x1-x2")][0]].data)
        b = tv[[n for n in tv.names if n.startswith("x0-x1-x2")][0]].data
        assert a.tobytes() == b.tobytes()
        assert os.path.exists(tmp_path / "features_t.json")

    def test_train_reads_param_overrides_from_a_file(self, tmp_path):
        path = str(tmp_path / "params.yaml")
        with open(path, "w") as fh:
            fh.write("stageParams:\n  LogisticRegression:\n    max_iter: 3\n")
        apps = _Apps("t")
        with use_device("cpu"):
            res = apps.app.main(["--run-type", "train", "--param-location", path])
        assert res.model_location is None and res.metrics["bestModelName"]
        sel = apps.vec.origin_stage  # the vector's stage; the LR sits in the selector
        assert sel is not None

    @pytest.mark.parametrize("what, kw, match", [
        ("streaming_score", {"log_stage_metrics": True}, "log_stage_metrics"),
        ("train", {"log_stage_metrics": True}, "log_stage_metrics"),
        ("train", {"collect_stage_metrics": True}, "collect_stage_metrics"),
        ("train", {"profile_trace_dir": "p"}, "profile_trace_dir")])
    def test_unported_run_type_or_param_raises_by_name(self, what, kw, match,
                                                       tmp_path, caplog):
        """The runner's stage-metrics and profile options (each raised by
        name before the port had ``obs/``) now give what the reference's
        give: ``match`` names the option each case exercises."""
        import glob
        import logging

        from transmogrifai_tpu_torch.readers.streaming import (
            ListSource, MicroBatchStreamingReader)
        from transmogrifai_tpu_torch.utils.listener import active_listeners

        wf, _vec = _lr_workflow(T, TLR, T_rb.CustomReader(lambda: TRAIN))
        loc = str(tmp_path / "model")
        # the trace directory lands under the test's own tmp_path
        kw = {k: str(tmp_path / v) if k == "profile_trace_dir" else v
              for k, v in kw.items()}
        params = T_params.OpParams(**kw)
        with use_device("cpu"), caplog.at_level(
                logging.INFO, logger="transmogrifai_tpu_torch.metrics"):
            if what == "streaming_score":
                T_run.WorkflowRunner(workflow=wf).run(
                    T_run.RunType.TRAIN, T_params.OpParams(model_location=loc))
                caplog.clear()
                reader = MicroBatchStreamingReader(
                    ListSource([{k: v for k, v in r.items() if k != "y"}
                                for r in SCORE]),
                    batch_interval=0.0, max_batch_records=60, max_empty_polls=0,
                    sleep=lambda s: None)
                params = T_params.OpParams(model_location=loc, **kw)
                res = T_run.WorkflowRunner(workflow=T.Workflow(),
                                           streaming_reader=reader).run(
                    T_run.RunType(what), params)
            else:
                res = T_run.WorkflowRunner(workflow=wf).run(
                    T_run.RunType(what), params)
        assert active_listeners() == []
        logged = [r.getMessage() for r in caplog.records
                  if r.name == "transmogrifai_tpu_torch.metrics"]
        if match == "log_stage_metrics":
            # every fitted stage's transform lands once per scored table;
            # a train also logs its fits
            assert any(" transform: " in m for m in logged), logged
            assert any(" fit: " in m for m in logged) == (what == "train")
            assert "appMetrics" not in res.metrics
        elif match == "collect_stage_metrics":
            # one record per stage fit and transform, each with the rows and
            # columns the JAX package's per-stage path reports
            jwf, _ = _lr_workflow(J, JLR, J_rb.CustomReader(lambda: TRAIN))
            jres = J_run.WorkflowRunner(workflow=jwf).run(
                J_run.RunType.TRAIN, J_params.OpParams(**kw))
            app = res.metrics["appMetrics"]
            assert app["runType"] == "train" and not logged
            shape = lambda a: [(m["stage_class"], m["phase"], m["n_rows"],  # noqa: E731
                                m["n_cols_in"], m["n_cols_out"])
                               for m in a["stageMetrics"]]
            assert shape(app) == shape(jres.metrics["appMetrics"])
            assert ("SelectedModel", "transform", len(TRAIN), 5, 6) in shape(app)
        else:
            (trace,) = glob.glob(os.path.join(kw["profile_trace_dir"], "trace-*.json"))
            with open(trace) as fh:
                assert json.load(fh)["traceEvents"]

    def test_run_types_and_result_equal_the_reference(self):
        assert [t.value for t in T_run.RunType] == [t.value for t in J_run.RunType]
        r = T_run.RunResult(T_run.RunType.SCORE, {"a": 1.0}, "loc")
        assert r.to_dict() == J_run.RunResult(J_run.RunType.SCORE, {"a": 1.0}, "loc").to_dict()


class TestWorkflowSurface:
    @pytest.fixture(scope="class")
    def trained(self):
        out = {}
        for key in ("j", "t"):
            pkg, _, rb, _, _, _ = PKGS[key]
            wf, vec = _lr_workflow(pkg, JLR if key == "j" else TLR,
                                   rb.CustomReader(lambda: TRAIN))
            model = wf.train() if key == "j" else wf.train(device="cpu")
            out[key] = (wf, vec, model)
        return out

    def test_summary_pretty_lines(self, trained):
        j, t = trained["j"][2].summary_pretty(), trained["t"][2].summary_pretty()
        assert t.splitlines()[0] == j.splitlines()[0]
        assert t.splitlines()[1:4] == j.splitlines()[1:4]     # the table's head
        assert len(t.splitlines()) == len(j.splitlines())

    def test_score_and_evaluate_through_the_reader(self, trained):
        jm, tm = trained["j"][2], trained["t"][2]
        for m in (jm, tm):
            m.set_reader(PKGS["j" if m is jm else "t"][2].CustomReader(lambda: SCORE))
        js, jmet = jm.score_and_evaluate(J.Evaluators.binary_classification())
        ts, tmet = tm.score_and_evaluate(T.Evaluators.binary_classification(), device="cpu")
        assert ts.n_rows == js.n_rows == len(SCORE)
        np.testing.assert_allclose(tmet["auPR"], jmet["auPR"], rtol=0, atol=1e-4)
        assert tm.score(device="cpu").n_rows == len(SCORE)

    def test_compute_data_up_to(self, trained):
        (_, jv, jm), (_, tv, tm) = trained["j"], trained["t"]
        recs = SCORE[:50]
        jds = J_rb.rows_to_dataset(recs, jv.raw_features())
        tds = T_rb.rows_to_dataset(recs, tv.raw_features())
        a = jm.compute_data_up_to(jv, jds)[jv.name].data
        b = tm.compute_data_up_to(tv, tds, device="cpu")[tv.name].data
        assert np.asarray(a).tobytes() == b.tobytes()

    def test_with_model_stages_reuses_the_fits(self, trained):
        wf, vec, model = trained["t"]
        wf2 = T.Workflow().set_reader(T_rb.CustomReader(lambda: TRAIN)) \
            .set_result_features(*model.result_features).with_model_stages(model)
        m2 = wf2.train(device="cpu")
        assert all(m2.fitted[u] is t for u, t in model.fitted.items())
        assert [r for r in wf2.last_train_profile if r["kind"] == "fit"] == []

    def test_set_parameters_applies_to_stages(self):
        wf, _ = _lr_workflow(T, TLR, T_rb.CustomReader(lambda: TRAIN))
        wf.set_parameters(T_params.OpParams(
            stage_params={"BinaryClassificationModelSelector": {}}))
        from transmogrifai_tpu_torch.ops.numeric import NumericVectorizer

        wf.set_parameters(T_params.OpParams(
            stage_params={"NumericVectorizer": {"track_nulls": False}}))
        stages = [s for s in T.workflow.dag.all_stages(wf.result_features)
                  if isinstance(s, NumericVectorizer)]
        assert stages and all(s.track_nulls is False for s in stages)
