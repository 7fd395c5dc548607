"""Project generator: CSV (+ optional schema) -> runnable AutoML project.

Counterpart of ``transmogrifai_tpu/cli/gen.py`` (the reference's
cli/.../gen/ProjectGenerator.scala + FileGenerator templating into
templates/simple; AvroField -> feature-type mapping; ProblemKind
(binary/multiclass/regression) detection from the response column).  The
generated project imports ``transmogrifai_tpu_torch``; otherwise its files
are the JAX package's, byte for byte.  Its App trains and scores where the
port's entry points run: on the card, or under
``perf.kernels.dispatch.use_device``.

:func:`main` is the parser of every ``cli`` subcommand, as in the
reference.
"""

from __future__ import annotations

import enum
import json
import os
import re
import sys
from typing import Dict, Optional, Tuple


class ProblemKind(enum.Enum):
    BINARY = "binary"
    MULTICLASS = "multiclass"
    REGRESSION = "regression"


def infer_schema(csv_path: str, id_column: Optional[str] = None) -> Dict[str, str]:
    """Column -> feature type name, inferred from the CSV (SchemaSource auto-infer)."""
    import pandas as pd

    return infer_schema_df(pd.read_csv(csv_path), id_column=id_column)


def infer_schema_df(df, id_column: Optional[str] = None) -> Dict[str, str]:
    from ..features.builder import _infer_ftype

    schema: Dict[str, str] = {}
    for name in df.columns:
        if name == id_column:
            schema[name] = "ID"
            continue
        series = df[name]
        ftype = _infer_ftype(series).__name__
        if ftype == "Text":
            # cardinality heuristic: few distinct values -> PickList
            nunique = series.nunique(dropna=True)
            if nunique <= max(30, int(len(series) ** 0.5)):
                ftype = "PickList"
        schema[name] = ftype
    return schema


def detect_problem_kind(csv_path: str, response: str) -> ProblemKind:
    """Reference ProblemKind detection: distinct values of the response column."""
    import pandas as pd

    col = pd.read_csv(csv_path, usecols=[response])[response]
    return detect_problem_kind_col(col)


def detect_problem_kind_col(col) -> ProblemKind:
    import pandas as pd

    col = col.dropna()
    distinct = col.nunique()
    if distinct <= 2:
        return ProblemKind.BINARY
    if not pd.api.types.is_numeric_dtype(col.dtype):
        # string-labeled response: low cardinality is multiclass, otherwise unusable
        if distinct <= 30:
            return ProblemKind.MULTICLASS
        raise ValueError(
            f"response column has {distinct} distinct non-numeric values — "
            "not usable as a classification label or regression target")
    if distinct <= 30 and pd.api.types.is_integer_dtype(col.dtype):
        return ProblemKind.MULTICLASS
    # float-typed but integral-valued and low-cardinality is still multiclass
    if distinct <= 30 and (col == col.astype(int)).all():
        return ProblemKind.MULTICLASS
    return ProblemKind.REGRESSION


_SELECTOR = {
    ProblemKind.BINARY: ("BinaryClassificationModelSelector", "binary_classification"),
    ProblemKind.MULTICLASS: ("MultiClassificationModelSelector", "multi_classification"),
    ProblemKind.REGRESSION: ("RegressionModelSelector", "regression"),
}

_MAIN_TEMPLATE = '''"""{name} — generated by transmogrifai_tpu_torch `gen` from {csv_name}."""

import os

from transmogrifai_tpu_torch import FeatureBuilder, Workflow, transmogrify
from transmogrifai_tpu_torch.evaluators.base import Evaluators
from transmogrifai_tpu_torch.models.selector import {selector}
from transmogrifai_tpu_torch.params import OpParams
from transmogrifai_tpu_torch.readers.files import DataReaders
from transmogrifai_tpu_torch.workflow.runner import App, RunType, WorkflowRunner

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, {csv_name!r})

SCHEMA = {schema}

RESPONSE = {response!r}

# label value -> class index for string-labeled responses (None for numeric labels)
LABELS = {labels}


def _extract_response(record):
    v = record[RESPONSE]
    if v is None or v != v:  # missing/NaN -> None so RealNN fails loudly, not KeyError
        return None
    try:
        return float(LABELS[str(v)])
    except KeyError:
        raise ValueError(
            f"unseen response label {{v!r}}; known labels: {{sorted(LABELS)}}") from None


def build_workflow():
    predictor_schema = {{k: v for k, v in SCHEMA.items() if k != RESPONSE}}
    features = FeatureBuilder.from_schema(predictor_schema)
    if LABELS is not None:
        response = (FeatureBuilder.RealNN(RESPONSE)
                    .extract(_extract_response).as_response())
    else:  # numeric labels: named-field fast path, NaN rejected by RealNN column
        response = FeatureBuilder.RealNN(RESPONSE).extract_field().as_response()
    predictors = [f for f in features if f.name != {id_column!r}]

    feature_vector = transmogrify(predictors)
    checked = response.sanity_check(feature_vector)
    prediction = response.transform_with(
        {selector}.with_cross_validation(), checked)
    return Workflow().set_result_features(response, prediction)


class {app_class}(App):
    def runner(self, params: OpParams) -> WorkflowRunner:
        reader = DataReaders.Simple.{reader_fn}(DATA)
        return WorkflowRunner(
            workflow=build_workflow(),
            train_reader=reader,
            scoring_reader=reader,
            evaluator=Evaluators.{evaluator}(),
        )


if __name__ == "__main__":
    result = {app_class}().main()
    print(result.to_dict())
'''

_README_TEMPLATE = """# {name}

Generated by `python -m transmogrifai_tpu_torch.cli gen` from `{csv_name}`
(problem kind: **{kind}**, response: `{response}`).

Train:

    python main.py --run-type train --model-location ./model --metrics-location ./metrics.json

Score:

    python main.py --run-type score --model-location ./model --write-location ./scores.csv

Evaluate:

    python main.py --run-type evaluate --model-location ./model --metrics-location ./eval.json
"""


_TEST_TEMPLATE = '''"""Generated smoke test: train end-to-end, score, and round-trip the model.

Run:  python -m pytest test_project.py -q
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def test_train_and_score(tmp_path):
    from main import {app_class}

    model_loc = str(tmp_path / "model")
    res = {app_class}().main(["--run-type", "train",
                              "--model-location", model_loc])
    assert res.metrics, "training must produce selector metrics"
    assert os.path.exists(model_loc)

    res2 = {app_class}().main(["--run-type", "score",
                               "--model-location", model_loc,
                               "--write-location", str(tmp_path / "scores")])
    assert res2.run_type.value == "score"
'''


def _classify_name(name: str) -> str:
    parts = re.split(r"[^0-9a-zA-Z]+", name)
    cls = "".join(p.capitalize() for p in parts if p)
    if not cls or not cls[0].isalpha():
        cls = "App" + cls
    return cls


def generate_project(
    csv_path: str,
    response: str,
    output_dir: str,
    name: str = "GeneratedApp",
    id_column: Optional[str] = None,
    schema_path: Optional[str] = None,
) -> Tuple[str, ProblemKind]:
    """Generate main.py / README.md / params.json into ``output_dir``.

    ``csv_path`` may also be an ``.avro`` container file.  ``schema_path``
    (an ``.avsc`` Avro schema) is the typed alternative to inference — the
    reference CLI's primary schema source (cli/.../gen/AvroField.scala).
    """
    import pandas as pd

    if csv_path.endswith(".avro"):
        from ..readers.avro import read_container

        _, records = read_container(csv_path)
        df = pd.DataFrame(list(records))
    else:
        df = pd.read_csv(csv_path)
    if schema_path is not None:
        from ..readers.avro import ftype_schema_from_avsc

        with open(schema_path) as fh:
            schema = ftype_schema_from_avsc(fh.read(), id_column=id_column)
        missing = set(schema) - set(map(str, df.columns))
        if missing:
            raise ValueError(
                f".avsc fields absent from the data: {sorted(missing)}")
    else:
        schema = infer_schema_df(df, id_column=id_column)
    if response not in schema:
        raise ValueError(
            f"response column {response!r} not in data (columns: {sorted(schema)})")
    schema[response] = "RealNN"
    resp_col = df[response]
    kind = detect_problem_kind_col(resp_col)
    labels = None
    if not pd.api.types.is_numeric_dtype(resp_col.dropna().dtype):
        labels = {str(v): float(i)
                  for i, v in enumerate(sorted(resp_col.dropna().unique(), key=str))}
    selector, evaluator = _SELECTOR[kind]

    os.makedirs(output_dir, exist_ok=True)
    csv_name = os.path.basename(csv_path)
    import shutil

    dest_csv = os.path.join(output_dir, csv_name)
    if os.path.abspath(csv_path) != os.path.abspath(dest_csv):
        shutil.copy(csv_path, dest_csv)

    main_py = _MAIN_TEMPLATE.format(
        name=name, csv_name=csv_name, schema=json.dumps(schema, indent=4),
        response=response, id_column=id_column, labels=repr(labels),
        selector=selector, evaluator=evaluator, app_class=_classify_name(name),
        reader_fn="avro" if csv_name.endswith(".avro") else "csv_auto")
    with open(os.path.join(output_dir, "main.py"), "w") as fh:
        fh.write(main_py)
    with open(os.path.join(output_dir, "README.md"), "w") as fh:
        fh.write(_README_TEMPLATE.format(name=name, csv_name=csv_name,
                                         kind=kind.value, response=response))
    with open(os.path.join(output_dir, "params.json"), "w") as fh:
        json.dump({"stageParams": {}, "customParams": {}}, fh, indent=2)
    with open(os.path.join(output_dir, "test_project.py"), "w") as fh:
        fh.write(_TEST_TEMPLATE.format(app_class=_classify_name(name)))
    return output_dir, kind


def main(argv=None) -> int:
    """``python -m transmogrifai_tpu_torch.cli <command>``: gen, deploy,
    lint, serve, top, train and tune."""
    import argparse

    from . import UNPORTED
    from .deploy import add_deploy_parser, run_deploy
    from .lint import add_lint_parser, run_lint
    from .serve import add_serve_parser, run_serve
    from .top import add_top_parser, run_top
    from .train import add_train_parser, run_train
    from .tune import add_tune_parser, run_tune

    ap = argparse.ArgumentParser(prog="transmogrifai_tpu_torch.cli")
    sub = ap.add_subparsers(dest="command", required=True)
    g = sub.add_parser("gen", help="generate a project from a CSV or Avro file")
    g.add_argument("--input", required=True, help="training CSV or .avro file")
    g.add_argument("--response", required=True, help="response column name")
    g.add_argument("--output", required=True, help="output project directory")
    g.add_argument("--name", default="GeneratedApp")
    g.add_argument("--id", dest="id_column", default=None)
    g.add_argument("--schema", dest="schema_path", default=None,
                   help=".avsc Avro schema (typed alternative to inference)")
    add_deploy_parser(sub)
    add_lint_parser(sub)
    add_serve_parser(sub)
    add_top_parser(sub)
    add_train_parser(sub)
    add_tune_parser(sub)
    for name in UNPORTED:
        sub.add_parser(name, help=f"the reference's `{name}` (not ported)")
    # an unported command's own arguments are not known here: they are left
    # over, and the command refuses by name below
    ns, extra = ap.parse_known_args(argv)
    if ns.command in UNPORTED:
        print(f"transmogrifai_tpu_torch.cli: `{ns.command}` is not ported to "
              "transmogrifai_tpu_torch yet (ported: deploy, gen, lint, serve, "
              "top, train, tune)", file=sys.stderr)
        return 2
    if extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    if ns.command == "deploy":
        return run_deploy(ns)
    if ns.command == "lint":
        return run_lint(ns)
    if ns.command == "serve":
        return run_serve(ns)
    if ns.command == "top":
        return run_top(ns)
    if ns.command == "train":
        return run_train(ns)
    if ns.command == "tune":
        return run_tune(ns)
    out, kind = generate_project(ns.input, ns.response, ns.output,
                                 name=ns.name, id_column=ns.id_column,
                                 schema_path=ns.schema_path)
    print(f"Generated {kind.value} project at {out}")
    return 0
