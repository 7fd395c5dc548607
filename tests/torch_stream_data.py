"""The continual-training scenarios of ``tests/test_continual.py``, written
once for either package.

:func:`make_records` is that file's record maker (a labelled stream of three
Reals, optionally shifted or with missing values); :func:`continual_base`
trains its base model (transmogrify -> SanityChecker -> a train/validation
LR selector) from 256 records; :func:`run_e2e` streams records through a
``ScoringServer`` and a ``ContinualTrainer`` and returns what the loop did.
``pkg`` is a namespace holding the package's ``FeatureBuilder``,
``transmogrify``, ``BinaryClassificationModelSelector``,
``LogisticRegression``, ``Workflow``, ``rows_to_dataset``,
``dedup_raw_features``, ``ScoringServer``, ``ListSource``,
``MicroBatchStreamingReader`` and the ``continual`` module; ``device_kw``
is ``{}`` for the JAX package and ``{"device": ...}`` for the port.
``tools/make_torch_streaming_fixture.py`` records the JAX package's runs in
``transmogrifai_tpu_torch/fixtures/streaming/continual.json``; the port's
tests and ``chip_smoke.py`` hold the port's runs to it.
"""

from __future__ import annotations

import numpy as np

N_TRAIN = 256

#: the loop's counters that do not depend on thread timing (how many drift
#: evaluations run before the shadow mirror reaches the gate does)
STABLE_COUNTERS = ("batches", "records", "record_errors", "refits",
                   "refit_failures", "candidates_staged", "gate_rejections",
                   "promotions", "swap_failures")

#: name -> (records seed, shift, harness script or None); the scenarios of
#: ``tests/test_continual.py::TestContinualE2E``
SCENARIOS = {
    "drift_swap": (41, 3.0, None),
    "refit_faults": (42, 3.0, "refit"),
    "shadow_faults": (44, 3.0, "shadow"),
}


def make_records(n, seed, shift=0.0, missing_rate=0.0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 3)) + shift
    out = []
    for i in range(n):
        rec = {"label": float(r.random() < 1 / (1 + np.exp(-x[i, 0])))}
        for j in range(3):
            rec[f"num{j}"] = None if r.random() < missing_rate \
                else float(x[i, j])
        out.append(rec)
    return out


def continual_base(pkg, device_kw):
    """(model, raw features, train dataset, train-time snapshot)."""
    train = make_records(N_TRAIN, 1)
    label = pkg.FeatureBuilder.RealNN("label").extract_field().as_response()
    feats = [pkg.FeatureBuilder.Real(f"num{j}").extract_field().as_predictor()
             for j in range(3)]
    checked = label.sanity_check(pkg.transmogrify(feats))
    sel = pkg.BinaryClassificationModelSelector.with_train_validation_split(
        models=[(pkg.LogisticRegression(), [{"reg_param": 0.01}])])
    pred = label.transform_with(sel, checked)
    ds = pkg.rows_to_dataset(train, [label, *feats])
    model = pkg.Workflow().set_result_features(label, pred) \
        .set_input_dataset(ds).train(**device_kw)
    raws = pkg.dedup_raw_features(model.result_features)
    train_ds = pkg.rows_to_dataset(train, raws)
    snap = pkg.continual.TrainingSnapshot.from_dataset(train_ds, features=raws)
    return model, raws, train_ds, snap


def _fault(pkg, point):
    harness = pkg.FaultHarness(seed=0)
    harness.fail_when(point, lambda ctx: True,
                      lambda: pkg.TransientScoringError(f"{point} down"))
    return harness


def coefficients(model) -> list:
    """The selected LR's coefficients then its intercept (float64)."""
    sel = model.selector_model()
    head = getattr(sel, "model", sel)
    coef = head.coef
    coef = coef.detach().cpu().numpy() if hasattr(coef, "detach") else coef
    return [float(v) for v in np.asarray(coef, np.float64).ravel()] \
        + [float(head.intercept)]


def run_e2e(pkg, base, scenario: str, device_kw) -> dict:
    """Stream the scenario's 512 records through the loop; returns the
    trainer's counters, its diagnostic codes (in order), the swap and
    batcher counters and the candidate's coefficients."""
    model, raws, train_ds, snap = base
    seed, shift, fault = SCENARIOS[scenario]
    records = make_records(512, seed, shift=shift)
    cont = pkg.continual
    server = pkg.ScoringServer(model, max_batch=64, max_wait_ms=1.0,
                               max_queue=8192, **device_kw)
    refit = cont.RefitController(
        model, sleep=lambda s: None,
        **({"max_retries": 1} if fault == "refit" else {}), **device_kw)
    reader = pkg.MicroBatchStreamingReader(
        pkg.ListSource(records, "stream"), batch_interval=0.0,
        max_batch_records=128, max_empty_polls=1)
    # drain the shadow mirror after every batch: the gate then sees the same
    # mirrored counts whatever the worker thread's timing
    trainer = cont.ContinualTrainer(
        server, model, reader, snapshot=snap, refit=refit,
        gate=cont.PromotionGate(min_shadow_records=64),
        window_records=N_TRAIN, drift_params={"min_records": 128},
        probation_batches=2,
        on_batch=lambda recs, out: server.has_candidate() and server.shadow_report())
    try:
        if fault is not None:
            with _fault(pkg, fault):
                metrics = trainer.run()
        else:
            metrics = trainer.run()
        sm = server.metrics()
    finally:
        server.close()
    swap = metrics["swap"]
    last = metrics.get("last_refit") or {}
    cand = trainer.last_refit.model if trainer.last_refit is not None else None
    return {
        "counters": {k: int(metrics[k]) for k in STABLE_COUNTERS},
        "drift_evaluations": int(metrics["drift_evaluations"]),
        "codes": [d.code for d in trainer.diagnostics],
        "swap": {"swaps": swap["swaps"], "rollbacks": swap["rollbacks"],
                 "active_version": swap["active_version"],
                 "shared_prefix": [h.get("shared_prefix")
                                   for h in swap.get("history", [])]},
        "batcher": {k: sm["batcher"][k] for k in
                    ("submitted", "completed", "failed", "cancelled")},
        "prefix_reused": last.get("prefix_reused"),
        "backend_compiles": last.get("backend_compiles"),
        "candidate_coefficients": coefficients(cand) if cand is not None else None,
    }


#: a driver that scores records with an exported bundle in a fresh
#: interpreter where torch, jax and both packages cannot be imported
_BUNDLE_DRIVER = r'''
import json, sys, time
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "jaxlib", "triton",
                                  "transmogrifai_tpu", "transmogrifai_tpu_torch"):
            raise ImportError("blocked in the bundle's process: " + name)
        return None
sys.meta_path.insert(0, _Block())
sys.path.insert(0, sys.argv[1])
from scorer import Scorer
with open(sys.argv[2]) as fh:
    records = json.load(fh)
batch = int(sys.argv[3])
s = Scorer()
s.score(records[:batch])
t0 = time.perf_counter()
out = []
for i in range(0, len(records), batch):
    out.extend(s.score(records[i:i + batch]))
seconds = time.perf_counter() - t0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("torch", "jax", "jaxlib", "transmogrifai_tpu",
                 "transmogrifai_tpu_torch"))
print(json.dumps({"rows": [{k: (v.tolist() if hasattr(v, "tolist") else v)
                            for k, v in r.items()} for r in out],
                  "seconds": seconds, "loaded": loaded}))
'''


def run_bundle(bundle_dir: str, records: list, batch: int = 1024,
               timeout: float = 600.0) -> dict:
    """Score ``records`` with the bundle in ``bundle_dir`` in a subprocess
    that cannot import torch, jax or either package, ``batch`` records a
    call; returns ``{"rows": [...], "seconds": scoring seconds after a
    warm-up call, "loaded": framework modules seen (must be empty)}``."""
    import json
    import os
    import subprocess
    import sys
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as fh:
        json.dump(records, fh)
        path = fh.name
    try:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run(
            [sys.executable, "-c", _BUNDLE_DRIVER, bundle_dir, path, str(batch)],
            capture_output=True, text=True, timeout=timeout, env=env,
            cwd=bundle_dir)
    finally:
        os.remove(path)
    if out.returncode != 0:
        raise RuntimeError(f"bundle scoring failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def bundle_deviation(bundle_rows: list, scored: list, pred_name: str) -> float:
    """Largest |bundle probability_1 - in-process probability_1| (or of the
    prediction, for a regression head) over the rows."""
    dev = 0.0
    for b, r in zip(bundle_rows, scored, strict=True):
        p = r[pred_name]
        if b.get("probability") is not None:
            dev = max(dev, abs(b["probability"][1] - p["probability_1"]))
        else:
            dev = max(dev, abs(b["prediction"] - p["prediction"]))
    return dev
