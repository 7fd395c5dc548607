"""Run the reference's scoring, streaming and continual flows with the JAX
package and save their record for the PyTorch port.

Writes (default) ``transmogrifai_tpu_torch/fixtures/streaming/``:

- ``example.json`` — ``examples/serving_streaming.py``'s run: the best
  model's name, the in-process scorer's prediction, the standalone bundle's
  output and the number of streamed micro-batches;
- ``bundle_families/`` — ``program.json``, ``arrays.npz`` and ``scorer.py``
  of the JAX package's ``export_standalone`` of the committed
  ``fixtures/training_families`` model (text, dates, geolocations);
- ``export_refusals.json`` — the message the JAX export raises for
  ``fixtures/serving_wide``: its decision-tree bucketizers are outside the
  bundle's supported stages;
- ``continual.json`` — ``tests/torch_stream_data.py``'s base model's LR
  coefficients and, per scenario of ``tests/test_continual.py``'s
  end-to-end loop (drift -> refit -> shadow -> swap; every refit failing;
  every shadow score failing), the loop's counters, diagnostic codes, swap
  and batcher counters and the candidate's coefficients.

The tests (``tests/test_torch_local.py``, ``test_torch_continual.py``,
``test_torch_examples.py``) and ``chip_smoke.py`` read the record; neither
imports JAX.  Run from the repo root on the CPU (about 30 s):

    JAX_PLATFORMS=cpu python tools/make_torch_streaming_fixture.py
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FIXTURES = os.path.join(REPO, "transmogrifai_tpu_torch", "fixtures")
DEFAULT_OUT = os.path.join(PORT_FIXTURES, "streaming")


def jax_namespace():
    """The JAX package's names that ``tests/torch_stream_data.py`` uses."""
    import transmogrifai_tpu as J
    from transmogrifai_tpu.models.logistic import LogisticRegression
    from transmogrifai_tpu.readers import ListSource, MicroBatchStreamingReader
    from transmogrifai_tpu.readers.base import rows_to_dataset
    from transmogrifai_tpu.serve import (FaultHarness, ScoringServer,
                                         TransientScoringError)
    from transmogrifai_tpu.workflow import continual
    from transmogrifai_tpu.workflow.workflow import dedup_raw_features

    return types.SimpleNamespace(
        FeatureBuilder=J.FeatureBuilder, transmogrify=J.transmogrify,
        BinaryClassificationModelSelector=J.BinaryClassificationModelSelector,
        LogisticRegression=LogisticRegression, Workflow=J.Workflow,
        rows_to_dataset=rows_to_dataset, dedup_raw_features=dedup_raw_features,
        ScoringServer=ScoringServer, ListSource=ListSource,
        MicroBatchStreamingReader=MicroBatchStreamingReader,
        FaultHarness=FaultHarness, TransientScoringError=TransientScoringError,
        continual=continual)


def run_example() -> dict:
    path = os.path.join(REPO, "examples", "serving_streaming.py")
    mod = types.ModuleType("serving_streaming")
    mod.__file__ = path
    with open(path) as fh:
        exec(compile(fh.read(), path, "exec"), mod.__dict__)
    captured = {}
    train = mod.train_model

    def keep(workdir):
        wf, model = train(workdir)
        captured["best"] = model.summary().best_model_name
        return wf, model

    mod.train_model = keep
    out = mod.main()
    return {"best_model_name": captured["best"], "in_process": out["in_process"],
            "standalone": out["standalone"],
            "batches": out["result"].metrics["batches"]}


def export_bundles(out_dir: str) -> dict:
    from transmogrifai_tpu.local import export_standalone
    from transmogrifai_tpu.workflow.workflow import WorkflowModel
    import transmogrifai_tpu.models.logistic  # noqa: F401  (registers the head)

    fam = WorkflowModel.load(os.path.join(PORT_FIXTURES, "training_families"))
    tmp = tempfile.mkdtemp(prefix="tmog_bundle_")
    try:
        export_standalone(fam, tmp)
        dst = os.path.join(out_dir, "bundle_families")
        os.makedirs(dst, exist_ok=True)
        for name in ("program.json", "arrays.npz", "scorer.py"):
            shutil.copyfile(os.path.join(tmp, name), os.path.join(dst, name))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wide = WorkflowModel.load(os.path.join(PORT_FIXTURES, "serving_wide"))
    try:
        export_standalone(wide, tempfile.mkdtemp(prefix="tmog_bundle_"))
    except ValueError as e:
        return {"serving_wide": str(e)}
    raise AssertionError("the JAX export accepted serving_wide")


def run_continual() -> dict:
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_stream_data as S

    pkg = jax_namespace()
    base = S.continual_base(pkg, {})
    return {"base_coefficients": S.coefficients(base[0]),
            "scenarios": {name: S.run_e2e(pkg, base, name, {})
                          for name in S.SCENARIOS}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    record = {
        "example.json": run_example(),
        "export_refusals.json": export_bundles(args.out),
        "continual.json": run_continual(),
    }
    for name, payload in record.items():
        with open(os.path.join(args.out, name), "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
    print(json.dumps({k: sorted(v) for k, v in record.items()}))


if __name__ == "__main__":
    main()
