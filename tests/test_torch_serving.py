"""The port's serving path against the JAX package, end to end.

(a) the committed full-width fixture, loaded by both packages, scores 300
    seeded records (missing values, unseen levels, absent fields) to equal
    record lists: JAX ``serving_plan().score`` vs the port's
    ``serving_plan(device="cpu").score``;
(b) a small model trained here by the JAX package, saved, and loaded by the
    port, scores equally too;
(c) a saved model with a stage or type the port lacks refuses to load and
    names it;
(d) neither the port nor ``chip_smoke.py`` imports JAX or the JAX package;
(e) with no card, the device default raises instead of running on the CPU;
(f) the plan encodes every one-hot and bucketize slot of a batch with one
    slot table, from operands packed into one staging buffer per dtype;
(g) a JAX-saved bucketizer of 5000 splits (past what one launch stages in
    shared memory) serves through the port's plan with records equal to
    the JAX plan's;
(h) ``serving_plan`` and ``score`` take the reference's parameters in its
    order, ``device`` by keyword only.
"""

import ast
import gzip
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from transmogrifai_tpu.workflow.workflow import WorkflowModel as JModel
from transmogrifai_tpu_torch import WorkflowModel as TModel
from transmogrifai_tpu_torch.checkers.diagnostics import OpCheckError
from transmogrifai_tpu_torch.types import FeatureTypeError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "transmogrifai_tpu_torch")
FIXTURE = os.path.join(PORT, "fixtures", "serving_wide")
sys.path.insert(0, os.path.join(REPO, "tools"))

import make_torch_serving_fixture as fixture_tool  # noqa: E402


def _records(schema_features, n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = {}
        for f in schema_features:
            if f.get("response"):
                continue
            u = rng.random()
            if u < 0.03:
                continue                          # field absent
            if u < 0.12:
                r[f["name"]] = None
            elif f["type"] == "Real":
                r[f["name"]] = float(rng.normal() * 1.3)
            elif f["type"] == "Binary":
                r[f["name"]] = bool(rng.random() < 0.3)
            elif u < 0.18:
                r[f["name"]] = f"never seen {int(rng.integers(99))}"
            elif u < 0.2:
                r[f["name"]] = ""
            else:
                r[f["name"]] = str(rng.choice(f["levels"]))
        out.append(r)
    return out


@pytest.fixture(scope="module")
def fixture_models():
    with open(os.path.join(FIXTURE, "schema.json")) as fh:
        schema = json.load(fh)
    return JModel.load(FIXTURE), TModel.load(FIXTURE), schema


class TestFixtureParity:
    def test_fixture_is_full_width_with_real_splits(self, fixture_models):
        _, tm, schema = fixture_models
        types = [f["type"] for f in schema["features"]]
        assert (types.count("Real"), types.count("PickList"),
                types.count("Binary")) == (64, 32, 4)
        split = [t for t in tm.fitted.values()
                 if type(t).__name__ == "DecisionTreeNumericBucketizerModel"]
        assert len(split) == 8 and all(t.should_split for t in split)
        size = sum(os.path.getsize(os.path.join(FIXTURE, f))
                   for f in os.listdir(FIXTURE))
        assert size < 5 * 1024 * 1024

    @pytest.mark.parametrize("n, seed", [(300, 0), (37, 1), (1, 2)])
    def test_records_equal_jax_serving_plan(self, fixture_models, n, seed):
        jm, tm, schema = fixture_models
        recs = _records(schema["features"], n, seed)
        ref = jm.serving_plan().score(recs)
        got = tm.serving_plan(device="cpu").score(recs)
        assert len(got) == n
        assert got == ref

    def test_prefix_vectors_bitwise_vs_jax_program(self, fixture_models):
        """The port's prefix output equals the reference's compiled prefix
        program on the same padded entries (bucket 64 for 37 rows)."""
        jm, tm, schema = fixture_models
        recs = _records(schema["features"], 37, 3)
        jplan = jm.serving_plan()
        tplan = tm.serving_plan(device="cpu")
        got = tplan.prefix_outputs(recs)
        # reproduce the reference's entries through its own encode path
        entries = []
        for key in jplan._entry_keys:
            if key[0] == "lift":
                entries.append(jplan._entry_lifts[key](recs))
            else:
                runner, slot, raw = jplan._entry_encoders[key]
                from transmogrifai_tpu.serve.plan import _light_column

                gen = next(g for g in jplan._generators if g.raw_name == raw)
                entries.append(np.asarray(runner.encode_device_input(
                    slot, _light_column(gen, recs))))
        from transmogrifai_tpu.serve.plan import _pad_rows

        compiled = jplan._ensure_compiled(64)
        ref = [np.asarray(o)[:37] for o in compiled(*[_pad_rows(a, 64) for a in entries])]
        assert len(got) == len(ref) == 1
        assert got[0].shape == ref[0].shape == (37, 866)
        assert got[0].tobytes() == ref[0].tobytes()

    def test_columnar_score_matches_jax_score(self, fixture_models):
        from transmogrifai_tpu.data.dataset import Dataset as JDataset
        from transmogrifai_tpu.types import feature_type_by_name as jft
        from transmogrifai_tpu_torch.data.dataset import Dataset as TDataset
        from transmogrifai_tpu_torch.types import feature_type_by_name as tft

        jm, tm, schema = fixture_models
        feats = [f for f in schema["features"] if not f.get("response")]
        recs = _records(feats, 200, 4)
        values = {f["name"]: [r.get(f["name"]) for r in recs] for f in feats}
        jds = JDataset.from_features(values, {f["name"]: jft(f["type"]) for f in feats})
        tds = TDataset.from_features(values, {f["name"]: tft(f["type"]) for f in feats})
        pred = next(f.name for f in tm.result_features
                    if f.ftype.__name__ == "Prediction")
        ref = jm.score(jds)[pred]
        got = tm.score(tds, device="cpu")[pred]
        assert got.data.tobytes() == np.asarray(ref.data).tobytes()

    def test_malformed_requests_refused_like_reference(self, fixture_models):
        jm, tm, schema = fixture_models
        recs = _records(schema["features"], 5, 5)
        recs[2]["r0"] = "1.2"                     # numpy would parse it
        with pytest.raises(TypeError):
            jm.serving_plan().score(recs)
        with pytest.raises(FeatureTypeError):
            tm.serving_plan(device="cpu").score(recs)

    def test_plan_metrics_and_timings(self, fixture_models):
        _, tm, schema = fixture_models
        plan = tm.serving_plan(device="cpu")
        plan.score(_records(schema["features"], 20, 6))
        m = plan.metrics()
        assert m["scored_records"] == 20 and m["scored_batches"] == 1
        assert m["fused_stages"] == 13 and m["host_stages"] == 1
        assert set(plan.last_timings) == {"encode_ms", "device_ms", "host_ms"}


class TestEncodeGroup:
    """The prefix's one-hot and bucketize stages as one slot table."""

    def test_one_table_for_every_encode_stage(self, fixture_models):
        _, tm, schema = fixture_models
        plan = tm.serving_plan(device="cpu")
        table = plan._encode_table
        kinds = [s.kind for s in table.specs]
        assert (kinds.count("onehot"), kinds.count("bucketize")) == (32, 8)
        assert table.width == 730 and table.chunks == [(0, 40)]
        assert [type(r).__name__ for r, _, _ in plan._wiring] == [
            "BinaryVectorizer", "NumericVectorizerModel", "VectorsCombiner",
            "SanityCheckerModel"]
        plan.score(_records(schema["features"], 20, 8))
        st = plan._staging[32]
        assert sorted((str(host.dtype), host.shape) for _, host, _, _ in st.buffers) \
            == [("float32", (68, 32)), ("int32", (32, 32))]
        assert plan.metrics()["h2d_copies"] == 0          # the CPU copies nothing

    def test_blocks_equal_each_stage_own_device_transform(self, fixture_models):
        _, tm, schema = fixture_models
        plan = tm.serving_plan(device="cpu")
        recs = _records(schema["features"], 37, 9)
        entries = plan._encode_records(recs)[1]
        ops_in = plan._stage(entries, 37, 64)
        env = {}
        plan._encode(ops_in, 64, env)
        grouped = {uid for uid, _, _ in plan._encode_blocks}
        assert len(grouped) == 9
        for runner in plan._prefix:
            uid = runner.get_output().uid
            if uid not in grouped:
                continue
            srcs = [plan._slot_sources[(runner.uid, k)] for k in
                    (runner.device_input_slots or range(len(runner.inputs)))]
            own = runner.device_transform(*[ops_in[i] for _, i in srcs])
            assert own.shape == env[uid].shape
            assert own.numpy().tobytes() == env[uid].contiguous().numpy().tobytes()

    @pytest.mark.parametrize("sizes", [(37, 20, 64), (1024, 3, 1024)])
    def test_staging_reuse_across_batches_equal_jax(self, fixture_models, sizes):
        """Batches of one bucket refill the same staging buffers: smaller
        batches after larger ones must not see stale rows."""
        jm, tm, schema = fixture_models
        plan, jplan = tm.serving_plan(device="cpu"), jm.serving_plan()
        for i, n in enumerate(sizes):
            recs = _records(schema["features"], n, 20 + i)
            assert plan.score(recs) == jplan.score(recs)

    def test_unsplit_bucketizer_stays_a_torch_op(self):
        from transmogrifai_tpu_torch.ops.bucketizers import DecisionTreeNumericBucketizerModel

        x = torch.tensor([0.5, float("nan"), -2.0])
        for tn in (True, False):
            m = DecisionTreeNumericBucketizerModel(False, [], track_nulls=tn)
            assert m.device_slot_specs() is None
            out = m.device_transform(x)
            assert out.shape == (3, int(tn))
            if tn:
                assert out[:, 0].tolist() == [0.0, 1.0, 0.0]


@pytest.fixture(scope="module")
def tiny_saved(tmp_path_factory):
    """3 Real (1 auto-bucketized), 2 PickList, 300 rows, trained by JAX."""
    cols, schema = fixture_tool.make_data(300, n_real=3, n_bucketized=1,
                                          n_pick=2, n_levels=6, n_binary=0,
                                          seed=7)
    model = fixture_tool.train(cols, schema)
    path = str(tmp_path_factory.mktemp("tiny") / "model")
    model.save(path)
    return path, schema


class TestTrainedOnTheFly:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_records_equal_jax(self, tiny_saved, seed):
        path, schema = tiny_saved
        recs = _records(schema, 120, seed)
        ref = JModel.load(path).serving_plan().score(recs)
        got = TModel.load(path).serving_plan(device="cpu").score(recs)
        assert got == ref

    def test_supplied_label_with_none_raises(self, tiny_saved):
        """The label (RealNN) is a response: absent at serve time it is
        skipped; supplied but None in some records it must raise."""
        path, schema = tiny_saved
        recs = _records(schema, 4, 3)
        for r in recs:
            r["label"] = 1.0
        recs[1]["label"] = None
        with pytest.raises(Exception):
            JModel.load(path).serving_plan().score(recs)
        with pytest.raises(FeatureTypeError):
            TModel.load(path).serving_plan(device="cpu").score(recs)


class TestLifts:
    """The float32 lift of a raw numeric feature, port against reference."""

    def _gens(self, type_name):
        from transmogrifai_tpu.features.feature import _NamedExtract as JX
        from transmogrifai_tpu.features.generator import FeatureGeneratorStage as JG
        from transmogrifai_tpu.types import feature_type_by_name as jft
        from transmogrifai_tpu_torch.features.feature import _NamedExtract as TX
        from transmogrifai_tpu_torch.features.generator import FeatureGeneratorStage as TG
        from transmogrifai_tpu_torch.types import feature_type_by_name as tft

        return (JG(JX("v"), jft(type_name), "v"),
                TG(TX("v"), tft(type_name), "v", uid="FeatureGeneratorStage_v"))

    @pytest.mark.parametrize("type_name, values", [
        ("Real", [1.5, None, -0.1, 3, True, 1e30]),
        ("Binary", [True, None, False, 1, 0.0]),
        ("RealNN", [0.25, 7, -3.5]),
        ("Geolocation", [[10.5, -20.25, 3], None, [], [0, 0, 1], (-89.9, 179.5, 7.0)]),
    ])
    def test_lift_bitwise(self, type_name, values):
        from transmogrifai_tpu.serve.plan import _lift_builder as jlift
        from transmogrifai_tpu_torch.serve.plan import _lift_builder as tlift

        jg, tg = self._gens(type_name)
        recs = [{"v": v} for v in values]
        ref, got = jlift(jg)(recs), tlift(tg)(recs)
        assert got.dtype == ref.dtype == np.float32
        assert got.tobytes() == ref.tobytes()

    def test_realnn_none_raises_non_nullable(self):
        from transmogrifai_tpu.serve.plan import _lift_builder as jlift
        from transmogrifai_tpu.types import NonNullableEmptyException as JNN
        from transmogrifai_tpu_torch.serve.plan import _lift_builder as tlift
        from transmogrifai_tpu_torch.types import NonNullableEmptyException as TNN

        jg, tg = self._gens("RealNN")
        recs = [{"v": 1.0}, {"v": None}]
        with pytest.raises(JNN):
            jlift(jg)(recs)
        with pytest.raises(TNN):
            tlift(tg)(recs)


def _rewrite_manifest(src: str, dst: str, edit) -> str:
    shutil.copytree(src, dst)
    p = os.path.join(dst, "model.json.gz")
    with gzip.open(p, "rt") as fh:
        manifest = json.load(fh)
    edit(manifest)
    with gzip.open(p, "wt") as fh:
        json.dump(manifest, fh)
    return dst


class TestUnportedStages:
    def test_unported_model_class_is_named(self, tmp_path):
        def edit(m):
            sel = next(s for s in m["fitted"].values() if s["class"] == "SelectedModel")
            # every model class of the reference is ported: a name neither
            # package has stands for a class the port lacks
            sel["attrs"]["model"]["__stage__"]["class"] = "HologramClassifierModel"
        path = _rewrite_manifest(FIXTURE, str(tmp_path / "m"), edit)
        with pytest.raises(ValueError, match="HologramClassifierModel"):
            TModel.load(path)

    def test_unported_transformer_class_is_named(self, tmp_path):
        def edit(m):
            comb = next(s for s in m["stages"] if s["class"] == "VectorsCombiner")
            comb["class"] = "HologramCombiner"  # a class neither package has
        path = _rewrite_manifest(FIXTURE, str(tmp_path / "m"), edit)
        with pytest.raises(ValueError, match="HologramCombiner"):
            TModel.load(path)

    def test_unported_feature_type_is_named(self, tmp_path):
        def edit(m):
            for f in m["features"]:
                if f["name"] == "p0":
                    # every type of the reference is ported: a name neither
                    # package has stands for a type the port lacks
                    f["ftype"] = "HologramMap"
        path = _rewrite_manifest(FIXTURE, str(tmp_path / "m"), edit)
        with pytest.raises(FeatureTypeError, match="HologramMap"):
            TModel.load(path)


_NO_JAX_PROBE = r"""
import sys
sys.path.insert(0, {repo!r})
import torch, numpy  # the port's own dependencies
before = set(sys.modules)
import transmogrifai_tpu_torch
from transmogrifai_tpu_torch.perf.kernels import encode, dispatch, histogram, splitscan, routing
from transmogrifai_tpu_torch.models import base, logistic, selector, svm, trees, tuning
from transmogrifai_tpu_torch.evaluators import base as ev_base, metrics
from transmogrifai_tpu_torch.features import builder
from transmogrifai_tpu_torch.workflow import fit, serde, workflow
from transmogrifai_tpu_torch.serve import batcher, faults, pipeline, plan, resilience, server, swap, validator
from transmogrifai_tpu_torch.obs import metrics as obs_metrics, overlap
from transmogrifai_tpu_torch.obs import flight, profile, reqtrace, trace
from transmogrifai_tpu_torch.perf import timers
from transmogrifai_tpu_torch.utils import listener
from transmogrifai_tpu_torch.checkers import diagnostics
from transmogrifai_tpu_torch.ops import dates, geo, text_lists, text_smart
from transmogrifai_tpu_torch.ops import bucketizers, collections_lift, maps
from transmogrifai_tpu_torch.filters import distribution, raw_feature_filter
from transmogrifai_tpu_torch.types import maps as map_types
from transmogrifai_tpu_torch.ops import math, misc, onehot, scalers
from transmogrifai_tpu_torch.ops import domains, embeddings, ner, ner_lang, ner_model, phone
from transmogrifai_tpu_torch.ops import text as text_ops
from transmogrifai_tpu_torch.utils import hashing, lang, pretty, text
from transmogrifai_tpu_torch import native, dsl, params
from transmogrifai_tpu_torch.aggregators import monoid
from transmogrifai_tpu_torch.readers import avro, base as readers_base, files, joined
from transmogrifai_tpu_torch.stages import functions
from transmogrifai_tpu_torch.workflow import runner
from transmogrifai_tpu_torch.readers import streaming
from transmogrifai_tpu_torch.local import export as local_export, scoring as local_scoring
from transmogrifai_tpu_torch.workflow import checkpoint, continual, resilience as wf_resilience
from transmogrifai_tpu_torch.serve import registry
from transmogrifai_tpu_torch.obs import slo
from transmogrifai_tpu_torch.checkers import plancheck
from transmogrifai_tpu_torch.perf import programs
from transmogrifai_tpu_torch.deploy import bundle as deploy_bundle, store as deploy_store
from transmogrifai_tpu_torch.cli import deploy as cli_deploy
serde._register_stages()
import chip_smoke
sys.path.insert(0, {repo!r} + "/tests")
import torch_examples_data, torch_wide_data, torch_encode_cases, torch_maps_data, torch_text_data
import torch_stream_data
sys.path.insert(0, {repo!r} + "/tools")
import torch_deploy_gate
bad = sorted(m for m in set(sys.modules) - before
             if m.split(".")[0] in ("jax", "jaxlib", "transmogrifai_tpu"))
print("BAD=" + ",".join(bad))
"""


class TestNoJax:
    def test_subprocess_import_loads_no_jax(self):
        out = subprocess.run(
            [sys.executable, "-c", _NO_JAX_PROBE.format(repo=REPO)],
            capture_output=True, text=True, cwd=REPO, timeout=120,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        assert out.returncode == 0, out.stderr
        assert "BAD=\n" in out.stdout, out.stdout

    @pytest.mark.parametrize("root", ["transmogrifai_tpu_torch", "chip_smoke.py",
                                      os.path.join("tests", "torch_encode_cases.py"),
                                      os.path.join("tests", "torch_wide_data.py"),
                                      os.path.join("tests", "torch_families_data.py"),
                                      os.path.join("tests", "torch_examples_data.py"),
                                      os.path.join("tests", "torch_maps_data.py"),
                                      os.path.join("tests", "torch_text_data.py"),
                                      os.path.join("tests", "torch_stream_data.py"),
                                      os.path.join("tests", "torch_ooc_data.py"),
                                      os.path.join("tools", "torch_deploy_gate.py")])
    def test_ast_scan_finds_no_jax_import(self, root):
        path = os.path.join(REPO, root)
        files = [path] if path.endswith(".py") else [
            os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
            if f.endswith(".py")]
        assert files
        if root == "transmogrifai_tpu_torch":
            assert os.path.join(path, "models", "svm.py") in files
            assert os.path.join(path, "models", "logistic.py") in files
            for mod in (("checkers", "sanity.py"), ("ops", "transmogrifier.py"),
                        ("dsl.py",), ("utils", "stats.py"), ("workflow", "plan.py"),
                        ("checkers", "diagnostics.py"), ("obs", "metrics.py"),
                        ("obs", "overlap.py"), ("native", "__init__.py"),
                        ("ops", "text_smart.py"), ("ops", "text_lists.py"),
                        ("ops", "dates.py"), ("ops", "geo.py"), ("utils", "lang.py"),
                        ("utils", "text.py"), ("utils", "hashing.py"),
                        ("utils", "pretty.py"), ("ops", "math.py"), ("ops", "misc.py"),
                        ("ops", "scalers.py"), ("ops", "onehot.py"), ("params.py",),
                        ("aggregators", "monoid.py"), ("stages", "functions.py"),
                        ("stages", "base.py"), ("features", "builder.py"),
                        ("data", "dataset.py"), ("workflow", "runner.py"),
                        ("workflow", "workflow.py"), ("workflow", "fit.py"),
                        ("types", "maps.py"), ("ops", "maps.py"),
                        ("ops", "collections_lift.py"), ("ops", "bucketizers.py"),
                        ("filters", "__init__.py"), ("filters", "distribution.py"),
                        ("filters", "raw_feature_filter.py"),
                        *(("ops", f"{m}.py") for m in (
                            "text", "ner", "ner_lang", "ner_model", "embeddings",
                            "phone", "domains")),
                        *(("readers", f"{m}.py") for m in (
                            "avro", "base", "files", "joined", "streaming")),
                        *(("local", f"{m}.py") for m in (
                            "__init__", "scoring", "export")),
                        *(("workflow", f"{m}.py") for m in (
                            "checkpoint", "resilience", "continual")),
                        *(("serve", f"{m}.py") for m in (
                            "batcher", "faults", "pipeline", "plan", "resilience",
                            "server", "swap", "validator", "registry")),
                        ("obs", "slo.py"), ("checkers", "plancheck.py"),
                        ("ops", "_consts.py"), ("features", "feature.py"),
                        *(("types", f"{m}.py") for m in (
                            "__init__", "base", "numerics", "text", "collections")),
                        *(("insights", f"{m}.py") for m in (
                            "__init__", "loco", "model_insights")),
                        *(("models", f"{m}.py") for m in (
                            "__init__", "mlp", "isotonic", "random_param", "combiner")),
                        ("workflow", "dag.py"),
                        *(("obs", f"{m}.py") for m in (
                            "__init__", "trace", "flight", "reqtrace", "profile")),
                        ("perf", "__init__.py"), ("perf", "timers.py"),
                        ("utils", "listener.py"), ("data", "chunked.py"),
                        ("readers", "prefetch.py"), ("workflow", "ooc.py"),
                        ("perf", "programs.py"),
                        *(("deploy", f"{m}.py") for m in ("__init__", "bundle", "store")),
                        *(("cli", f"{m}.py") for m in ("__init__", "__main__", "deploy"))):
                assert os.path.join(path, *mod) in files
        bad = []
        for fn in files:
            with open(fn) as fh:
                tree = ast.parse(fh.read(), fn)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for n in names:
                    if n.split(".")[0] in ("jax", "jaxlib", "transmogrifai_tpu"):
                        bad.append(f"{fn}: {n}")
        assert not bad, bad


@pytest.fixture(scope="module")
def saved_5000_splits(tmp_path_factory):
    """A JAX-trained x -> DecisionTreeNumericBucketizer model whose fitted
    splits are replaced by 5000 sorted splits (+-inf at the ends) before the
    JAX package saves it."""
    from transmogrifai_tpu.data.dataset import Column as JCol
    from transmogrifai_tpu.data.dataset import Dataset as JDs
    from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
    from transmogrifai_tpu.ops.bucketizers import DecisionTreeNumericBucketizer
    from transmogrifai_tpu.types import Real as JReal
    from transmogrifai_tpu.types import RealNN as JRealNN
    from transmogrifai_tpu.workflow.workflow import Workflow as JWorkflow

    rng = np.random.default_rng(0)
    xv = rng.normal(size=400)
    label = JFB.RealNN("label").extract_field().as_response()
    x = JFB.Real("x").extract_field().as_predictor()
    est = DecisionTreeNumericBucketizer(track_invalid=True)
    vec = label.transform_with(est, x)
    ds = JDs({"label": JCol.from_values(JRealNN, (xv > 0).astype(float).tolist()),
              "x": JCol.from_values(JReal, xv.tolist())})
    model = JWorkflow().set_input_dataset(ds).set_result_features(vec).train()
    splits = np.sort(rng.normal(size=4998))
    model.fitted[est.uid].splits = [-np.inf, *splits.tolist(), np.inf]
    path = str(tmp_path_factory.mktemp("splits5000") / "model")
    model.save(path)
    recs = [{"x": float(v)} for v in rng.normal(size=60)]
    recs += [{"x": float(splits[7])}, {"x": None}, {"x": float("nan")},
             {"x": float("inf")}, {}]
    return path, recs


class TestOversizedBucketizer:
    def test_5000_splits_serve_equal_to_jax(self, saved_5000_splits):
        path, recs = saved_5000_splits
        ref = JModel.load(path).serving_plan().score(recs)
        plan = TModel.load(path).serving_plan(device="cpu")
        (k,) = [i for i, s in enumerate(plan._encode_table.specs)
                if len(s.splits) == 5000]
        assert (k, k + 1) in plan._encode_table.chunks      # a launch of its own
        got = plan.score(recs)
        assert len(got[0]) == 1 and len(next(iter(got[0].values()))) == 4999 + 2
        assert got == ref


class TestEntryPointSignatures:
    def test_serving_plan_takes_the_reference_order(self, fixture_models):
        _, tm, _ = fixture_models
        plan = tm.serving_plan(16, 512, True, device="cpu")
        assert (plan.min_bucket, plan.max_bucket) == (16, 512)
        assert plan.device == torch.device("cpu")
        assert tm.serving_plan(8, 1024, True, 1e9, device="cpu").max_bucket == 1024
        with pytest.raises(OpCheckError, match="TM601"):
            tm.serving_plan(8, 1024, True, 4096.0, device="cpu")
        with pytest.raises(TypeError):
            tm.serving_plan("cpu")

    def test_score_takes_the_reference_order(self, fixture_models):
        from transmogrifai_tpu_torch.data.dataset import Column as TCol
        from transmogrifai_tpu_torch.data.dataset import Dataset as TDs
        from transmogrifai_tpu_torch.types import Real as TReal

        _, tm, schema = fixture_models
        reals = [f["name"] for f in schema["features"] if f["type"] == "Real"]
        others = [f for f in schema["features"]
                  if f["type"] != "Real" and not f.get("response")]
        rng = np.random.default_rng(3)
        cols = {r: TCol.from_values(TReal, rng.normal(size=5).tolist()) for r in reals}
        from transmogrifai_tpu_torch.types import feature_type_by_name

        for f in others:
            cols[f["name"]] = TCol.from_values(feature_type_by_name(f["type"]),
                                               [None] * 5)
        ds = TDs(cols)
        short = tm.score(ds, device="cpu")
        full = tm.score(ds, True, device="cpu")
        assert set(short.names) < set(full.names)
        with pytest.raises(ValueError, match="needs a dataset or a reader"):
            tm.score(device="cpu")
        with pytest.raises(TypeError):
            tm.score(ds, False, "cpu")

    def test_signatures_equal_the_reference(self):
        import inspect

        for name in ("serving_plan", "score"):
            ref = list(inspect.signature(getattr(JModel, name)).parameters)
            got = inspect.signature(getattr(TModel, name)).parameters
            assert [p for p in got if p != "device"] == ref
            assert got["device"].kind is inspect.Parameter.KEYWORD_ONLY


class TestDeviceDefault:
    def test_serving_plan_without_card_raises(self, fixture_models, monkeypatch):
        _, tm, _ = fixture_models
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.serving_plan()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.score(None)

    def test_explicit_cpu_plan_runs_on_cpu(self, fixture_models):
        _, tm, _ = fixture_models
        assert tm.serving_plan(device="cpu").device == torch.device("cpu")
