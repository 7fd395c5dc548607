"""``train`` subcommand — durable, resumable AutoML training from a CSV.

Counterpart of ``transmogrifai_tpu/cli/train.py``. Reference role: the
reference's ``OpWorkflowRunner --run-type train`` rides Spark's lineage
recovery — a preempted executor recomputes and the job finishes. This
subcommand is the operator surface over this repo's equivalent
(workflow/resilience.py): training with ``--resume DIR`` commits every
completed sweep block to an fsync'd journal and every fitted stage to a
stage checkpoint, so a SIGKILL'd run re-invoked with the same ``--resume``
dir skips the committed prefix and produces a bitwise-identical model.
``--device`` names the device (default: the card).

The model pipeline is the ``gen`` auto-workflow: schema inferred from the
CSV, problem kind detected from the response column, ``transmogrify`` +
sanity check + the matching model selector with cross-validation.

Run::

    python -m transmogrifai_tpu_torch.cli train --input data.csv --response label \\
        --model-location ./model --resume ./train-ckpt

On completion the journal's hit/miss/commit counters print, so an operator
can see exactly how much of a resumed run replayed from the journal.
"""

from __future__ import annotations

import json
import os


def add_train_parser(sub) -> None:
    p = sub.add_parser(
        "train", help="train an auto-generated workflow from a CSV, with "
                      "durable --resume fault tolerance "
                      "(workflow/resilience.py)")
    p.add_argument("--input", required=True, help="training CSV file")
    p.add_argument("--response", required=True, help="response column name")
    p.add_argument("--model-location", required=True, metavar="DIR",
                   help="directory to save the fitted model")
    p.add_argument("--resume", default=None, metavar="DIR",
                   help="durable checkpoint directory: sweep journal + "
                        "stage checkpoints + chunk offsets; re-running "
                        "with the same dir resumes past completed work")
    p.add_argument("--id", dest="id_column", default=None,
                   help="identifier column to exclude from predictors")
    p.add_argument("--test-fraction", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--format", choices=["text", "json"], default="text",
                   dest="out_format",
                   help="'json' emits one JSON summary object line")
    p.add_argument("--device", default=None,
                   help="device the workflow trains on (default: the card)")


def build_auto_workflow(csv_path: str, response: str,
                        id_column=None):
    """The ``gen`` template's workflow, built in-process: inferred schema,
    detected problem kind, transmogrify + sanity check + CV selector."""
    import pandas as pd

    from .. import FeatureBuilder, Workflow, transmogrify
    from ..models import selector as selectors
    from ..readers.files import DataReaders
    from .gen import ProblemKind, detect_problem_kind_col, infer_schema_df

    df = pd.read_csv(csv_path)
    if response not in df.columns:
        raise SystemExit(f"train: response column {response!r} not in "
                         f"{csv_path} (columns: {list(df.columns)})")
    schema = infer_schema_df(df, id_column=id_column)
    kind = detect_problem_kind_col(df[response])
    labels = None
    if kind is not ProblemKind.REGRESSION:
        import pandas as pd_mod

        col = df[response].dropna()
        if not pd_mod.api.types.is_numeric_dtype(col.dtype):
            labels = {str(v): i for i, v in enumerate(sorted(col.unique()))}

    if labels is not None:
        lab = dict(labels)

        def _extract_response(record, _labels=lab, _resp=response):
            v = record[_resp]
            if v is None or v != v:
                return None
            return float(_labels[str(v)])

        resp = (FeatureBuilder.RealNN(response)
                .extract(_extract_response).as_response())
    else:
        resp = FeatureBuilder.RealNN(response).extract_field().as_response()

    predictor_schema = {k: v for k, v in schema.items() if k != response}
    features = FeatureBuilder.from_schema(predictor_schema)
    predictors = [f for f in features if f.name != id_column]
    checked = resp.sanity_check(transmogrify(predictors))
    sel_cls = {
        ProblemKind.BINARY: selectors.BinaryClassificationModelSelector,
        ProblemKind.MULTICLASS: selectors.MultiClassificationModelSelector,
        ProblemKind.REGRESSION: selectors.RegressionModelSelector,
    }[kind]
    prediction = resp.transform_with(sel_cls.with_cross_validation(), checked)
    reader = DataReaders.Simple.dataframe(df)
    wf = Workflow().set_result_features(resp, prediction).set_reader(reader)
    return wf, kind


def run_train(ns) -> int:
    from ..workflow import resilience

    wf, kind = build_auto_workflow(ns.input, ns.response,
                                   id_column=ns.id_column)
    model = wf.train(test_fraction=ns.test_fraction, seed=ns.seed,
                     resume=ns.resume, device=ns.device)
    os.makedirs(ns.model_location, exist_ok=True)
    model.save(ns.model_location)

    summary = model.summary()
    journal = None
    if ns.resume is not None:
        # train() popped its resilience frame before returning; last()
        # keeps the run's counters alive for exactly this report
        res = resilience.last()
        j = res.journal if res is not None else None
        journal = {
            "hits": j.hits if j else 0,
            "misses": j.misses if j else 0,
            "commits": j.commits if j else 0,
            "entries": len(j.keys()) if j else 0,
            "retries": res.retries if res is not None else 0,
            "degradations": res.degradations if res is not None else [],
        }
    payload = {
        "kind": kind.value,
        "modelLocation": ns.model_location,
        "bestModel": summary.best_model_name if summary else None,
        "resume": ns.resume,
        "journal": journal,
    }
    if ns.out_format == "json":
        print(json.dumps(payload, sort_keys=True))
    else:
        print(f"train: {kind.value} model "
              f"({payload['bestModel']}) saved to {ns.model_location}")
        if journal is not None:
            print(f"train: resume dir {ns.resume} — journal "
                  f"{journal['entries']} block(s), {journal['hits']} hit(s), "
                  f"{journal['commits']} commit(s), "
                  f"{journal['retries']} retr"
                  f"{'y' if journal['retries'] == 1 else 'ies'}, "
                  f"{len(journal['degradations'])} degradation(s)")
    return 0
