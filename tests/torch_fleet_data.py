"""Models and call sequences shared by the Fleet's CPU tests
(``tests/test_torch_fleet.py``, ``test_torch_precision.py``,
``test_torch_slo.py``).

The models come from the JAX package's own recipes (``tests/test_fleet.py``
seeds 7/99/123, ``tests/test_slo.py`` seed 11, ``tests/test_precision.py``
seed 7 with a third feature), trained there, saved in its format and
loaded into the port (``workflow/serde.py``), so both packages hold the same
fitted state.  :func:`fleet_sequence` feeds one sequence of
register/submit/stage/promote/rollback/unregister calls to either
package's ``FleetServer`` and returns the decisions and records it saw.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Any, Dict, List

import numpy as np

MIN_BUCKET, MAX_BUCKET = 8, 64


def train_precision_model():
    """The JAX package's ``tests/test_precision.py`` fixture: x1, color and
    a Real ``age`` with 15 % missing, 400 rows, seed 7."""
    import pandas as pd

    from transmogrifai_tpu import (BinaryClassificationModelSelector, FeatureBuilder,
                                   Workflow, transmogrify)
    from transmogrifai_tpu.models.logistic import LogisticRegression
    from transmogrifai_tpu.readers.files import DataReaders

    rng = np.random.default_rng(7)
    n = 400
    x1 = rng.normal(0, 1, n)
    color = rng.choice(["red", "green", "blue"], n)
    age = np.where(rng.random(n) < 0.15, None, rng.normal(40, 10, n))
    y = (rng.random(n) < 1 / (1 + np.exp(-(1.5 * x1 + (color == "red"))))).astype(float)
    records = [{"label": float(y[i]), "x1": float(x1[i]), "color": str(color[i]),
                "age": None if age[i] is None else float(age[i])} for i in range(n)]
    label = FeatureBuilder.RealNN("label").extract_field().as_response()
    f_x1 = FeatureBuilder.Real("x1").extract_field().as_predictor()
    f_color = FeatureBuilder.PickList("color").extract_field().as_predictor()
    f_age = FeatureBuilder.Real("age").extract_field().as_predictor()
    checked = label.sanity_check(transmogrify([f_x1, f_color, f_age]))
    sel = BinaryClassificationModelSelector.with_train_validation_split(
        models=[(LogisticRegression(), [{"reg_param": 0.01}])])
    pred = label.transform_with(sel, checked)
    model = (Workflow().set_result_features(label, pred)
             .set_reader(DataReaders.Simple.dataframe(pd.DataFrame(records)))).train()
    return model, records


def port_copy(jmodel, path: str):
    """The JAX model saved under ``path`` and loaded by the port."""
    import transmogrifai_tpu_torch as T

    jmodel.save(path)
    return T.WorkflowModel.load(path)


def peak(plan) -> int:
    """A plan's static peak device-memory estimate, by its own package."""
    mod = type(plan).__module__.split(".")[0]
    if mod == "transmogrifai_tpu_torch":
        from transmogrifai_tpu_torch.checkers.plancheck import analyze_scoring_plan
    else:
        from transmogrifai_tpu.checkers.plancheck import analyze_scoring_plan
    return int(analyze_scoring_plan(plan).peak_hbm_bytes)


@contextlib.contextmanager
def _bounds(S, bf16_bound):
    """Temporarily set the package's bf16 TM511 bound."""
    old = S.TM511_BOUNDS[S.Precision.BF16]
    S.TM511_BOUNDS[S.Precision.BF16] = bf16_bound
    try:
        yield
    finally:
        S.TM511_BOUNDS[S.Precision.BF16] = old


def _codes(exc) -> List[str]:
    return [d.code for d in exc.report.errors()]


def fleet_sequence(S, models: Dict[str, Any], **fleet_kw) -> Dict[str, Any]:
    """One call sequence against ``S.FleetServer`` (``S``: either package's
    ``serve`` module; ``models``: {"A"|"B"|"C"|"P": (model, records)} of
    that package; ``fleet_kw``: e.g. the port's ``device``).  Every flush
    is one tenant's 8 records (flush on size), so a tenant's sub-batch is
    exactly its records.  Returns the decisions, refusal codes, warm
    buckets, metric series and each scored sub-batch's records."""
    OpCheckError = importlib.import_module(
        S.__name__.split(".")[0] + ".checkers.diagnostics").OpCheckError
    (ma, ra), (mb, rb), (mc, rc) = models["A"], models["B"], models["C"]
    mp, rp = models["P"]
    rp = [{k: v for k, v in r.items() if k != "label"} for r in rp]
    out: Dict[str, Any] = {"records": [], "log": []}
    log = out["log"]

    def plan_of(m):
        return S.compile_plan(m, MIN_BUCKET, MAX_BUCKET, **fleet_kw)

    pa, pb = peak(plan_of(ma)), peak(plan_of(mb))

    def score(fleet, tenant, recs):
        futs = [fleet.submit(tenant, r) for r in recs[:8]]
        out["records"].append((tenant, [f.result(timeout=60) for f in futs]))

    def warm(fleet):
        m = fleet.metrics()["tenants"]
        return {t: bool(row["warm_buckets"]) for t, row in m.items()}

    fleet = S.FleetServer(max_batch=8, max_wait_ms=500, min_bucket=MIN_BUCKET,
                          max_bucket=MAX_BUCKET, hbm_budget=pa + pb, **fleet_kw)
    try:
        fleet.register("a", ma, slo="gold")
        fleet.register("b", mb, slo="bronze")
        score(fleet, "b", rb)
        score(fleet, "a", ra)
        fleet.register("c", mc, slo="silver")          # evicts b, the coldest
        log.append(("after_c", warm(fleet), fleet.metrics()["fleet"]["evictions"]))
        score(fleet, "b", rb)                           # b rebuilds its buckets
        score(fleet, "c", rc)
        fleet.register("a2", ma, slo="silver")          # shares a's fingerprint
        m = fleet.metrics()["fleet"]
        log.append(("after_a2", warm(fleet), m["shared_prefix_registrations"],
                    m["evictions"]))
        fp = fleet.stage_candidate("a", ma, warm=False)
        log.append(("stage_same_fp", fp == fleet.metrics()["tenants"]["a"]["fingerprint"]))
        score(fleet, "a", ra)
        rec = fleet.promote("a", probation_batches=2)
        log.append(("promote", rec["tenant"], rec["shared_prefix"]))
        log.append(("rollback", fleet.rollback("a")["tenant"]))
        try:
            fleet.stage_candidate("a", ma, warm=False, precision="bf16",
                                  calibration=ra[:16])
        except OpCheckError as e:
            log.append(("swap_bf16", _codes(e)))
        fleet.unregister("c")
        log.append(("unregister_c", fleet.tenants(),
                    sorted(fleet.registry.labeled_values("tenant")),
                    sorted(v for v in fleet.registry.labeled_values("entry"))))
        score(fleet, "a2", ra)
        out["fleet_series"] = sorted(k for k in fleet.registry.snapshot()
                                     if k.startswith("tmog_serve_fleet"))
    finally:
        fleet.close()

    # reduced precision: admitted past TM511, refused when the bound is tight
    reg = S.ModelRegistry(min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET, **fleet_kw)
    reg.register("quant", mp, precision="bf16", calibration=rp[:64], warm=False)
    log.append(("bf16_admitted", reg.metrics()["tenants"]["quant"]["precision"]))
    with _bounds(S, 1e-12):
        try:
            reg.register("tight", mp, precision="bf16", calibration=rp[:64], warm=False)
        except OpCheckError as e:
            log.append(("bf16_tight", _codes(e), "tight" in reg))
    reg.unregister("quant")

    # terminal refusals: a fleet budget nothing fits (TM509) and a plan
    # budget under its own estimate (TM601)
    tiny = S.FleetServer(max_batch=8, max_wait_ms=1, hbm_budget=16.0, **fleet_kw)
    try:
        try:
            tiny.register("tiny", ma)
        except OpCheckError as e:
            log.append(("tiny", _codes(e), tiny.tenants(),
                        tiny.metrics()["fleet"]["admission_refusals"]))
    finally:
        tiny.close()
    try:
        S.compile_plan(ma, MIN_BUCKET, MAX_BUCKET, hbm_budget=pa // 2, **fleet_kw)
    except OpCheckError as e:
        log.append(("plan_budget", _codes(e)))
    return out
