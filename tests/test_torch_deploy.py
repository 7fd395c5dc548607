"""The deploy artifact store in the port (``deploy/``), on the CPU: the
reference's ``tests/test_deploy.py`` test by test with the import swapped,
held to the JAX package.

One model — the reference's ``_train(7)`` recipe, trained by the JAX
package and loaded by the port through ``workflow/serde.py`` — is packed by
the port once; tests copy the dir before tampering.  Every score is held
BITWISE to the JAX package's live plan on the same records
(``packed["ref"]``): the reference's own hydrated scores cannot be had on
this CPU (its deserialized executables expect the suite's 8-device mesh),
and its live plan is what a hydrated plan must equal.

The port's counterparts of the reference's cases:

- its jax-version refusal is the CUDA-toolkit coupling of a packed kernel
  library (one built by a toolkit newer than the CUDA the driver runs is
  never loaded) and the refusal of an artifact with no ``torchVersion``;
- its kernel-mode drift is kernel-token drift (another build of the
  kernels: other flags, or serve donation), a clean miss;
- its "zero backend compiles" boot is: no ``nvcc_build`` event, the bucket
  allocations (``staging`` / ``landing``) inside ``register``, and no
  compile event of any kind from the end of ``register`` to the last
  served record.

Kernel libraries are installed and refused with a dummy file here (nothing
is loaded on the CPU); the card tests load a real one
(``tests/test_torch_cuda.py``).
"""

import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
import transmogrifai_tpu.deploy as JD
from transmogrifai_tpu.models.logistic import LogisticRegression as JLR
from transmogrifai_tpu.obs import flight as j_flight
from transmogrifai_tpu.readers.files import DataReaders as JDataReaders
from transmogrifai_tpu_torch import WorkflowModel
from transmogrifai_tpu_torch.deploy import (
    BUNDLE_VERSION,
    ArtifactStore,
    DeployBundle,
    artifact_key,
    artifact_store_stats,
    check_bundle,
    pack_model,
    reset_artifact_store_stats,
)
from transmogrifai_tpu_torch.deploy import bundle as bundle_mod
from transmogrifai_tpu_torch.obs import flight as obs_flight
from transmogrifai_tpu_torch.obs.flight import FlightRecorder
from transmogrifai_tpu_torch.perf import (
    deserialize_compiled,
    measure_compiles,
    serialize_compiled,
)
from transmogrifai_tpu_torch.perf.kernels import dispatch
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
from transmogrifai_tpu_torch.serve import FleetServer
from transmogrifai_tpu_torch.serve import plan as plan_mod

MIN_BUCKET, MAX_BUCKET = 8, 64
LADDER = [8, 16, 32, 64]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _train_reference(seed: int, n: int = 220):
    """The reference's ``_train``: the JAX package trains the model."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    x1 = rng.normal(0, 1, n)
    color = rng.choice(["red", "green", "blue"], n)
    y = (rng.random(n) < 1 / (1 + np.exp(-(1.5 * x1 + (color == "red"))))
         ).astype(float)
    records = [{"label": float(y[i]), "x1": float(x1[i]),
                "color": str(color[i])} for i in range(n)]
    label = J.FeatureBuilder.RealNN("label").extract_field().as_response()
    f_x1 = J.FeatureBuilder.Real("x1").extract_field().as_predictor()
    f_color = J.FeatureBuilder.PickList("color").extract_field().as_predictor()
    checked = label.sanity_check(J.transmogrify([f_x1, f_color]))
    sel = J.BinaryClassificationModelSelector.with_train_validation_split(
        models=[(JLR(), [{"reg_param": 0.01}])])
    pred = label.transform_with(sel, checked)
    model = (J.Workflow().set_result_features(label, pred)
             .set_reader(JDataReaders.Simple.dataframe(pd.DataFrame(records)))
             ).train()
    nolabel = [{k: v for k, v in r.items() if k != "label"} for r in records]
    return model, nolabel


def _cold():
    """A fresh process as far as the port can make one: no plan's device
    state left behind to share."""
    gc.collect()
    with plan_mod._SHARED_LOCK:
        plan_mod._SHARED.clear()


def _fresh_plan(model):
    return model.serving_plan(min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """The reference's model (trained by the JAX package, saved, loaded by
    the port) packed once by the port; ``ref`` is the JAX package's LIVE
    plan's scores — the bitwise baseline — and ``jroot`` the same model
    packed by the JAX package."""
    jmodel, records = _train_reference(7)
    saved = str(tmp_path_factory.mktemp("saved") / "model")
    jmodel.save(saved)
    model = WorkflowModel.load(saved)
    jplan = jmodel.serving_plan(min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET)
    ref = jplan.score(records[:40])
    jplan.release_executables()
    jroot = str(tmp_path_factory.mktemp("jax_artifact"))
    JD.pack_model(jmodel, jroot, min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET)
    root = str(tmp_path_factory.mktemp("artifact"))
    with use_device("cpu"):
        bundle = pack_model(model, root, min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET)
    return {"model": model, "jmodel": jmodel, "records": records, "root": root,
            "bundle": bundle, "ref": ref, "jroot": jroot}


@pytest.fixture(autouse=True)
def _clean_flight():
    obs_flight.uninstall_recorder()
    with use_device("cpu"):
        yield
    obs_flight.uninstall_recorder()


def _rewrite_manifest(root, edit):
    path = os.path.join(root, "manifest.json")
    with open(path) as fh:
        m = json.load(fh)
    edit(m)
    with open(path, "w") as fh:
        json.dump(m, fh)


def _put_object(root, m, rel, blob):
    """Write an object and record it as the manifest records packed ones."""
    os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
    with open(os.path.join(root, rel), "wb") as fh:
        fh.write(blob)
    return {"file": rel, "sha256": hashlib.sha256(blob).hexdigest(), "size": len(blob)}


def _with_library(root, *, source_digest=None, toolkit="12.8", blob=b"\x7fELF dummy"):
    """Make the artifact's buckets load a kernel library ``encode`` carried
    as a (dummy) library object, every hash recorded as pack records it."""
    def edit(m):
        for meta in m["plan"]["objects"].values():
            with open(os.path.join(root, meta["file"]), "rb") as fh:
                exe = json.load(fh)
            exe["libraries"] = ["encode"]
            blob_b = (json.dumps(exe, sort_keys=True) + "\n").encode()
            meta.update(_put_object(root, m, meta["file"], blob_b))
        sha = hashlib.sha256(blob).hexdigest()
        m["plan"]["libraries"] = {"encode": {
            **_put_object(root, m, os.path.join("objects", sha[:2], f"{sha}.so"), blob),
            "sourceDigest": source_digest or dispatch.source_digest("encode"),
            "cudaToolkit": toolkit}}
    _rewrite_manifest(root, edit)


def _tampered_copy(packed, tmp_path, mutate, name="artifact"):
    root = str(tmp_path / name)
    shutil.copytree(packed["root"], root)
    mutate(root)
    return root


class TestPackAndManifest:
    def test_bundle_layout_and_manifest_schema(self, packed):
        root = packed["root"]
        m = DeployBundle.load(root).manifest
        assert m["bundleVersion"] == BUNDLE_VERSION
        assert os.path.isdir(os.path.join(root, "model"))
        plan = m["plan"]
        assert plan["minBucket"] == MIN_BUCKET
        assert plan["maxBucket"] == MAX_BUCKET
        assert plan["buckets"] == LADDER
        assert set(plan["objects"]) == {"8", "16", "32", "64"}
        assert plan["fingerprint"] and plan["contentFingerprint"]
        assert plan["fingerprint"] != plan["contentFingerprint"]
        assert plan["libraries"] == {}          # nothing loads on the CPU
        assert plan["donated"] is False
        env = m["environment"]
        assert env["torchVersion"] == torch.__version__
        assert env["kernelToken"] == dispatch.cache_token()
        assert env["kernelToken"].startswith("kernels:")
        assert env["platform"] == "cpu" and env["deviceKind"] == "cpu"
        assert set(env) == {"torchVersion", "cudaVersion", "platform", "deviceKind",
                            "deviceCount", "computeCapability", "kernelToken",
                            "meshToken"}
        assert env["meshToken"] == "null"      # packed without a mesh
        assert set(env["cudaVersion"]) == {"toolkit", "torch", "driver"}
        # the port's op-graph corpus (tests/goldens/torch_ir) is packed
        from transmogrifai_tpu_torch.checkers.irsnap import default_goldens_dir
        from transmogrifai_tpu_torch.deploy.bundle import ir_corpus_fingerprints

        assert m["irCorpus"] == ir_corpus_fingerprints()
        with open(os.path.join(default_goldens_dir(), "index.json")) as fh:
            index = json.load(fh)
        assert m["irCorpus"]["entries"] == {
            k: v["irFingerprint"] for k, v in index["entries"].items()}
        assert m["irCorpus"]["torchVersion"] == index["torchVersion"]
        # the manifest's keys are the reference's (plus the port's libraries
        # and donation flag)
        jm = JD.DeployBundle.load(packed["jroot"]).manifest
        assert set(m) == set(jm)
        assert set(plan) - set(jm["plan"]) == {"libraries", "donated"}

    def test_objects_are_content_addressed_by_executable_key(self, packed):
        bundle = DeployBundle.load(packed["root"])
        env = bundle.environment
        for bucket_s, meta in bundle.plan["objects"].items():
            digest = artifact_key(bundle.plan["fingerprint"], int(bucket_s),
                                  kernel_token=env["kernelToken"])
            assert meta["keyDigest"] == digest
            assert meta["file"] == os.path.join("objects", digest[:2],
                                                f"{digest}.bucket.json")
            path = bundle.object_path(meta["file"])
            assert os.path.getsize(path) == meta["size"]

    def test_artifact_key_distinguishes_every_component(self):
        base = artifact_key("fp", 8, kernel_token="k")
        assert artifact_key("fp2", 8, kernel_token="k") != base
        assert artifact_key("fp", 16, kernel_token="k") != base
        assert artifact_key("fp", 8, kernel_token="k2") != base
        assert artifact_key("fp", 8) == artifact_key(
            "fp", 8, kernel_token=dispatch.cache_token())

    def test_verify_clean_artifact_reports_nothing(self, packed):
        report, drift = ArtifactStore(packed["root"]).verify(packed["model"])
        assert report.errors() == []
        assert drift == []

    def test_bucket_payload_is_json_never_pickle(self, packed):
        """A bucket object is JSON of one format: it round-trips byte for
        byte, names what the bucket allocates, and anything else —
        another package's pickled executable included — is refused before
        anything in it is used."""
        import pickle

        bundle = DeployBundle.load(packed["root"])
        meta = bundle.plan["objects"]["16"]
        with open(bundle.object_path(meta["file"]), "rb") as fh:
            blob = fh.read()
        exe = deserialize_compiled(blob)
        assert isinstance(exe, plan_mod.BucketExecutable)
        assert exe.bucket == 16 and exe.fingerprint == bundle.plan["fingerprint"]
        assert exe.libraries == []
        assert [[list(t), d] for t, d in exe.entry_specs] == bundle.plan["entrySpecs"]
        assert serialize_compiled(exe) == blob
        for bad in (pickle.dumps({"format": "tmog-aot-v1"}), b"{}", b"\x00\x01",
                    json.dumps({"format": "tmog-torch-bucket-v1"}).encode()):
            with pytest.raises(ValueError):
                deserialize_compiled(bad)
        with pytest.raises(TypeError):
            serialize_compiled(object())

    def test_live_port_plan_equals_the_reference_live_plan(self, packed):
        plan = _fresh_plan(packed["model"])
        assert plan.score(packed["records"][:40]) == packed["ref"]
        plan.release_executables()


class TestHydrate:
    def test_hydrate_zero_compiles_bitwise_equal(self, packed):
        _cold()
        plan = _fresh_plan(packed["model"])
        with measure_compiles() as boot:
            res = ArtifactStore(packed["root"]).hydrate(plan)
        assert res == {"hydrated": LADDER, "refused": False, "reasons": [],
                       "drift": []}
        # hydration's allocations are real work, reported as such
        assert boot.events == {"staging": 4, "landing": 4}
        assert plan.warm_buckets() == LADDER and plan._warmed
        with measure_compiles() as probe:
            plan.warm()
            got = plan.score(packed["records"][:40])
        assert probe.backend_compiles == 0
        assert got == packed["ref"]
        plan.release_executables()

    def test_fleet_register_hydrates_and_dedups_shared_tenants(self, packed):
        _cold()
        reset_artifact_store_stats()
        rec = obs_flight.install_recorder(FlightRecorder())
        with measure_compiles() as probe:
            with FleetServer(max_batch=32, max_wait_ms=1.0,
                             min_bucket=MIN_BUCKET,
                             max_bucket=MAX_BUCKET) as fleet:
                for t in ("a", "b", "c"):
                    fleet.register(t, packed["model"], artifact=packed["root"])
                registered = probe.events
                with measure_compiles() as serving:
                    futs = [fleet.submit(t, r) for t in ("a", "b", "c")
                            for r in packed["records"][:10]]
                    rows = [f.result(timeout=120) for f in futs]
                    after = serving.events
        assert after == {}
        # the first tenant's staging and landing ring, each later tenant its
        # own landing ring only; no kernel build anywhere
        assert registered == {"staging": 4, "landing": 12}
        stats = artifact_store_stats()
        # only the FIRST tenant of the fingerprint reads the disk; b and c
        # share its device state
        assert stats["hits"] == 4
        assert stats["refusals"] == 0
        hydr = rec.events("artifact_hydrated")
        assert len(hydr) == 1
        assert hydr[0]["data"]["buckets"] == LADDER
        assert hydr[0]["data"]["live_compile_buckets"] == []
        assert hydr[0]["data"]["tenant"] == "a"
        for t in range(3):
            assert rows[t * 10:(t + 1) * 10] == packed["ref"][:10]

    def test_release_emits_flight_event(self, packed):
        _cold()
        plan = _fresh_plan(packed["model"])
        ArtifactStore(packed["root"]).hydrate(plan)
        rec = obs_flight.install_recorder(FlightRecorder())
        n = plan.release_executables()
        assert n > 0
        evs = rec.events("executable_release")
        assert len(evs) == 1
        assert evs[0]["data"]["fingerprint"] == plan.fingerprint
        assert evs[0]["data"]["buckets"] == LADDER
        assert evs[0]["data"]["drop_shared"] is True
        assert plan.release_executables() == 0
        assert len(rec.events("executable_release")) == 1

    def test_partial_adoption_does_not_arm_the_warm_expectation(self, packed):
        """Adopting part of the ladder leaves the plan cold (its missing
        buckets allocate later, legitimately); the whole ladder warms it."""
        _cold()
        plan = _fresh_plan(packed["model"])
        bundle = DeployBundle.load(packed["root"])
        exes = {}
        for b, meta in bundle.plan["objects"].items():
            with open(bundle.object_path(meta["file"]), "rb") as fh:
                exes[int(b)] = deserialize_compiled(fh.read())
        plan.adopt_executable(8, exes[8])
        assert plan.warm_buckets() == [8] and not plan._warmed
        with pytest.raises(ValueError, match="filed under"):
            plan.adopt_executable(16, exes[8])
        for b in (16, 32, 64):
            plan.adopt_executable(b, exes[b])
        assert plan._warmed
        assert plan.score(packed["records"][:40]) == packed["ref"]
        plan.release_executables()


def _assert_refused_with_fallback(packed, root, reason_substr):
    """The tampered artifact refuses (TM510 + flight event), adopts NOTHING,
    and the live build is bitwise the reference's live plan."""
    _cold()
    reset_artifact_store_stats()
    plan = _fresh_plan(packed["model"])
    rec = obs_flight.install_recorder(FlightRecorder())
    try:
        with measure_compiles() as c:
            res = ArtifactStore(root).hydrate(plan, tenant="t")
        assert c.backend_compiles == 0
        assert res["refused"] is True
        assert any(reason_substr in r for r in res["reasons"]), res["reasons"]
        assert res["hydrated"] == []
        assert plan.warm_buckets() == []
        evs = rec.events("artifact_refused")
        assert len(evs) == 1
        assert evs[0]["data"]["code"] == "TM510"
        assert evs[0]["data"]["tenant"] == "t"
        assert any(reason_substr in r for r in evs[0]["data"]["reasons"])
    finally:
        obs_flight.uninstall_recorder()
    stats = artifact_store_stats()
    assert stats["refusals"] == 1 and stats["hits"] == 0
    plan.warm()
    assert plan.score(packed["records"][:40]) == packed["ref"]
    plan.release_executables()
    return res


def _edit_env(**changes):
    def mutate(root):
        _rewrite_manifest(root, lambda m: m["environment"].update(changes))
    return mutate


class TestRefusal:
    def test_truncated_object_refused_then_live_fallback(self, packed, tmp_path):
        def mutate(root):
            bundle = DeployBundle.load(root)
            meta = bundle.plan["objects"]["16"]
            with open(bundle.object_path(meta["file"]), "r+b") as fh:
                fh.truncate(meta["size"] // 2)

        root = _tampered_copy(packed, tmp_path, mutate)
        _assert_refused_with_fallback(packed, root, "fails integrity")

    def test_content_fingerprint_drift_refused(self, packed, tmp_path):
        def mutate(root):
            _rewrite_manifest(root, lambda m: m["plan"].update(
                contentFingerprint="0" * 64))

        root = _tampered_copy(packed, tmp_path, mutate)
        _assert_refused_with_fallback(packed, root, "content fingerprint mismatch")

    def test_cuda_toolkit_coupling_refused(self, packed, tmp_path, monkeypatch):
        """The port's counterpart of the reference's jax-version refusal: a
        kernel library carries its toolkit's CUDA runtime, so one built by a
        toolkit newer than the CUDA the driver runs is never loaded (an
        older toolkit's is: the driver runs what older toolkits built)."""
        monkeypatch.setattr(bundle_mod, "cuda_driver_version", lambda: "12.8")
        for toolkit in ("12.9", "13.0", None):
            root = _tampered_copy(packed, tmp_path,
                                  lambda r: _with_library(r, toolkit=toolkit),
                                  name=f"artifact_{toolkit}")
            _assert_refused_with_fallback(packed, root, "needs a driver at least that new")
        for toolkit in ("12.8", "12.4", "11.8"):
            bundle = DeployBundle.load(_tampered_copy(
                packed, tmp_path, lambda r: _with_library(r, toolkit=toolkit),
                name=f"artifact_{toolkit}"))
            assert check_bundle(bundle)[0].errors() == [], toolkit

    def test_missing_torch_version_refused(self, packed, tmp_path):
        def mutate(root):
            _rewrite_manifest(root, lambda m: m["environment"].pop("torchVersion"))

        root = _tampered_copy(packed, tmp_path, mutate)
        _assert_refused_with_fallback(packed, root, "no torchVersion")

    def test_unknown_payload_format_refused(self, packed, tmp_path):
        """Bytes that verify but are not this package's bucket executable
        (here the reference's format tag) are refused before any bucket is
        adopted."""
        def mutate(root):
            def edit(m):
                meta = m["plan"]["objects"]["32"]
                meta.update(_put_object(root, m, meta["file"], json.dumps(
                    {"format": "tmog-aot-v1", "payload": "00"}).encode()))
            _rewrite_manifest(root, edit)

        root = _tampered_copy(packed, tmp_path, mutate)
        _assert_refused_with_fallback(packed, root, "unknown bucket executable format")

    def test_executable_of_another_plan_refused(self, packed, tmp_path):
        def mutate(root):
            def edit(m):
                meta = m["plan"]["objects"]["64"]
                with open(os.path.join(root, meta["file"])) as fh:
                    exe = json.load(fh)
                exe["stagingDtypes"] = ["float64"] * len(exe["stagingDtypes"])
                meta.update(_put_object(root, m, meta["file"],
                                        json.dumps(exe).encode()))
            _rewrite_manifest(root, edit)

        root = _tampered_copy(packed, tmp_path, mutate)
        _assert_refused_with_fallback(packed, root, "staging dtypes")

    def test_truncated_library_refused(self, packed, tmp_path):
        def mutate(root):
            _with_library(root)
            lib = DeployBundle.load(root).plan["libraries"]["encode"]
            with open(os.path.join(root, lib["file"]), "r+b") as fh:
                fh.truncate(lib["size"] // 2)

        root = _tampered_copy(packed, tmp_path, mutate)
        _assert_refused_with_fallback(packed, root, "library object encode fails integrity")

    def test_missing_manifest_refused(self, packed, tmp_path):
        root = str(tmp_path / "empty")
        os.makedirs(root)
        _assert_refused_with_fallback(packed, root, "manifest unreadable")

    def test_newer_bundle_version_refused(self, packed, tmp_path):
        def mutate(root):
            _rewrite_manifest(root, lambda m: m.update(bundleVersion=BUNDLE_VERSION + 1))

        root = _tampered_copy(packed, tmp_path, mutate)
        _assert_refused_with_fallback(packed, root, "newer than this reader")

    def test_ir_corpus_drift_refused_by_check_bundle(self, packed):
        """The gate-time corpus check: a program-surface change since pack
        (one golden's content fingerprint moved) refuses the artifact."""
        bundle = DeployBundle.load(packed["root"])
        bundle.manifest["irCorpus"] = {"entries": {"a/golden": "fp1", "b/golden": "fp2"}}
        live = {"entries": {"a/golden": "fp1", "b/golden": "drifted"}}
        report, _drift = check_bundle(bundle, live_corpus=live)
        assert [d.code for d in report.errors()] == ["TM510"]
        assert "b/golden" in report.errors()[0].message
        report, _drift = check_bundle(bundle, live_corpus={"entries": {"a/golden": "fp1"}})
        assert report.errors() == []

    def test_packed_corpus_drift_against_a_changed_golden_corpus(self, packed, tmp_path):
        """The packed ``irCorpus`` is the committed op-graph corpus; a live
        corpus whose family graph changed since pack (a kernel or stage
        edit re-goldened) refuses the artifact with TM510, as the reference
        does; the unchanged corpus admits it."""
        import shutil

        from transmogrifai_tpu_torch.checkers.irsnap import (
            default_goldens_dir,
            load_corpus,
            save_corpus,
            IRSnapshot,
        )
        from transmogrifai_tpu_torch.deploy.bundle import ir_corpus_fingerprints

        bundle = DeployBundle.load(packed["root"])
        report, _drift = check_bundle(bundle, live_corpus=ir_corpus_fingerprints())
        assert report.errors() == []
        dst = tmp_path / "torch_ir"
        shutil.copytree(default_goldens_dir(), dst)
        snaps, _index = load_corpus(str(dst))
        key = "perf.kernels.encode"
        snaps[key] = IRSnapshot.from_text(key, snaps[key].text.replace("f32[", "f64["))
        save_corpus(snaps, str(dst))
        report, _drift = check_bundle(bundle,
                                      live_corpus=ir_corpus_fingerprints(str(dst)))
        assert [d.code for d in report.errors()] == ["TM510"]
        assert key in report.errors()[0].message


class TestCleanMiss:
    def _assert_missed(self, packed, root, drift_substr, plan_ctx=None):
        _cold()
        reset_artifact_store_stats()
        plan = _fresh_plan(packed["model"])
        rec = obs_flight.install_recorder(FlightRecorder())
        try:
            with measure_compiles() as c:
                res = ArtifactStore(root).hydrate(plan)
        finally:
            obs_flight.uninstall_recorder()
        assert c.backend_compiles == 0
        assert res["refused"] is False
        assert res["hydrated"] == []
        assert any(drift_substr in d for d in res["drift"] + res["reasons"]) \
            or any(drift_substr in r for ev in rec.events("artifact_miss")
                   for r in ev["data"]["reasons"]), res
        assert rec.events("artifact_refused") == []
        assert len(rec.events("artifact_miss")) == 1
        stats = artifact_store_stats()
        assert stats["refusals"] == 0 and stats["hits"] == 0
        assert stats["misses"] == 4
        plan.warm()
        assert plan.score(packed["records"][:40]) == packed["ref"]
        plan.release_executables()
        return res

    def test_kernel_token_drift_misses_cleanly(self, packed, monkeypatch):
        """Another build of the kernels (here other nvcc flags) is not
        tampering: the plan's fingerprint legitimately differs, so hydration
        misses back to a live build with a warning — no TM510."""
        monkeypatch.setattr(dispatch, "NVCC_FLAGS", dispatch.NVCC_FLAGS + ("-lineinfo",))
        res = self._assert_missed(packed, packed["root"], "kernel token drift")
        assert any("kernel token drift" in d for d in res["drift"])

    def test_donated_plan_never_hydrates_an_undonated_artifact(self, packed):
        with dispatch.force_serve_donation(True):
            plan = _fresh_plan(packed["model"])
            assert plan.donated and ":serve-donate" in dispatch.cache_token()
            assert plan.fingerprint != DeployBundle.load(packed["root"]).plan["fingerprint"]
            assert plan.content_fingerprint == \
                DeployBundle.load(packed["root"]).plan["contentFingerprint"]
            self._assert_missed(packed, packed["root"], "kernel token drift")

    def test_device_kind_drift_misses_cleanly(self, packed, tmp_path):
        root = _tampered_copy(packed, tmp_path, _edit_env(
            deviceKind="NVIDIA H100 80GB HBM3", platform="gpu",
            computeCapability="9.0"))
        res = self._assert_missed(packed, root, "device kind drift")
        assert {d.split(" drift")[0] for d in res["drift"]} == {
            "device kind", "platform", "compute capability"}

    def test_library_of_other_sources_misses_and_is_not_installed(
            self, packed, tmp_path, monkeypatch):
        monkeypatch.setenv("TMOG_TORCH_BUILD_DIR", str(tmp_path / "build"))
        root = _tampered_copy(packed, tmp_path,
                              lambda r: _with_library(r, source_digest="0" * 64))
        self._assert_missed(packed, root, "other sources")
        assert not os.path.exists(tmp_path / "build")

    def test_check_bundle_reports_drift_not_error(self, packed):
        bundle = DeployBundle.load(packed["root"])
        bundle.manifest["environment"]["kernelToken"] = "kernels:other"
        report, drift = check_bundle(bundle)
        assert report.errors() == []
        assert any("kernel token drift" in d for d in drift)


class TestLibraries:
    """A packed kernel library: installed for this process alone (into
    ``artifacts/<sha256>/`` of the build directory) only for the live
    source digest, loaded from there with no ``nvcc``, never taken by
    ``build()`` for a build of the checkout's sources, and packed with the
    toolkit its build record names (a dummy file: nothing is loaded on the
    CPU)."""

    @pytest.fixture(autouse=True)
    def _kernels(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TMOG_TORCH_BUILD_DIR", str(tmp_path / "build"))
        monkeypatch.setattr(dispatch, "BUILD_INFO", {})
        monkeypatch.setattr(dispatch, "_INSTALLED", {})
        monkeypatch.setattr(dispatch, "_LIBS", {})

    @staticmethod
    def _no_nvcc(monkeypatch):
        def no_nvcc():
            raise dispatch.KernelError("nvcc not found")

        monkeypatch.setattr(dispatch, "nvcc_path", no_nvcc)

    def test_install_then_build_finds_it_without_nvcc(self, tmp_path, monkeypatch):
        self._no_nvcc(monkeypatch)
        digest = dispatch.source_digest("encode")
        path = dispatch.install_library("encode", b"prebuilt", digest, toolkit="12.8")
        sha = hashlib.sha256(b"prebuilt").hexdigest()
        assert path == str(tmp_path / "build" / "artifacts" / sha / f"encode-{digest[:16]}.so")
        assert dispatch.library_file("encode") == path != dispatch.library_path("encode")
        with open(path, "rb") as fh:
            assert fh.read() == b"prebuilt"
        assert dispatch.library_record("encode") == {
            "sourceDigest": digest, "cudaToolkit": "12.8", "origin": f"artifact:{sha}"}
        assert [p for p in os.listdir(os.path.dirname(path)) if p.endswith(".tmp")] == []
        # load() takes the installed file with no nvcc (the dummy then fails
        # to dlopen, which is the loader's error, not a build)
        with measure_compiles() as c:
            with pytest.raises(dispatch.KernelError, match="cannot load kernel library"):
                dispatch.load("encode", {})
        assert c.events == {}
        assert dispatch.BUILD_INFO["encode"]["log"] == f"installed {path}"
        # the build directory gained no library of its own: build(), what a
        # process that never hydrated runs, still needs nvcc and says so
        assert not os.path.exists(dispatch.library_path("encode"))
        with pytest.raises(dispatch.KernelError, match="nvcc"):
            dispatch.build(["encode"])
        # uninstalled, load() is back on the checkout's own build
        dispatch.uninstall_library("encode")
        assert dispatch.library_file("encode") == dispatch.library_path("encode")
        assert not os.path.exists(path) and not os.path.exists(path + ".json")

    def test_build_needs_the_build_record(self, monkeypatch):
        """A library in the build directory counts as built only beside its
        build record (the toolkit that built it); without one it is built
        again."""
        self._no_nvcc(monkeypatch)
        path = dispatch.library_path("encode")
        os.makedirs(os.path.dirname(path))
        with open(path, "wb") as fh:
            fh.write(b"built elsewhere")
        with pytest.raises(dispatch.KernelError, match="nvcc"):
            dispatch.build(["encode"])
        with open(path + ".json", "w") as fh:
            json.dump({"sourceDigest": dispatch.source_digest("encode"),
                       "cudaToolkit": "12.8", "origin": "nvcc"}, fh)
        with measure_compiles() as c:
            assert dispatch.build(["encode"]) == {"encode": path}
        assert c.events == {} and dispatch.BUILD_INFO["encode"]["log"] == "cached"

    def test_library_of_other_sources_is_never_installed(self, tmp_path):
        assert dispatch.install_library("encode", b"x", "0" * 64) is None
        assert not os.path.exists(tmp_path / "build")
        assert dispatch.library_file("encode") == dispatch.library_path("encode")

    def test_pack_records_the_toolkit_that_built_the_library(
            self, packed, tmp_path, monkeypatch):
        """The toolkit a packed library names is the one its build record
        names, not the nvcc live at pack time; a library with no record of
        this checkout's source is not packed."""
        import contextlib

        @contextlib.contextmanager
        def loads_encode():
            yield {"encode"}

        monkeypatch.setattr(plan_mod, "libraries_used", loads_encode)
        monkeypatch.setattr(dispatch, "toolkit_version", lambda: "12.8")
        path = dispatch.library_path("encode")
        os.makedirs(os.path.dirname(path))
        with open(path, "wb") as fh:
            fh.write(b"\x7fELF built by 11.8")
        digest = dispatch.source_digest("encode")
        with open(path + ".json", "w") as fh:
            json.dump({"sourceDigest": digest, "cudaToolkit": "11.8", "origin": "nvcc"}, fh)
        bundle = pack_model(packed["model"], str(tmp_path / "art"),
                            min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET)
        lib = bundle.plan["libraries"]["encode"]
        assert (lib["cudaToolkit"], lib["sourceDigest"]) == ("11.8", digest)
        with open(os.path.join(bundle.root, lib["file"]), "rb") as fh:
            assert fh.read() == b"\x7fELF built by 11.8"
        # the recorded toolkit travels: the replica's installed copy names it
        _cold()
        res = ArtifactStore(bundle.root).hydrate(_fresh_plan(packed["model"]))
        assert res["hydrated"] == LADDER, res
        assert dispatch.library_record("encode")["cudaToolkit"] == "11.8"
        dispatch.uninstall_library("encode")
        os.remove(path + ".json")
        with pytest.raises(ValueError, match="no build record"):
            pack_model(packed["model"], str(tmp_path / "art2"),
                       min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET)

    def test_hydrate_installs_the_packed_library(self, packed, tmp_path):
        root = _tampered_copy(packed, tmp_path, lambda r: _with_library(r))
        assert ArtifactStore(root).verify(packed["model"])[0].errors() == []
        _cold()
        plan = _fresh_plan(packed["model"])
        with measure_compiles() as c:
            res = ArtifactStore(root).hydrate(plan)
        assert res["hydrated"] == LADDER and not res["refused"]
        assert c.events == {"staging": 4, "landing": 4}
        path = dispatch.library_file("encode")
        assert path.startswith(str(tmp_path / "build" / "artifacts") + os.sep)
        with open(path, "rb") as fh:
            assert fh.read() == b"\x7fELF dummy"
        assert dispatch.library_record("encode")["cudaToolkit"] == "12.8"
        assert not os.path.exists(dispatch.library_path("encode"))
        plan.warm()
        assert plan.score(packed["records"][:40]) == packed["ref"]
        plan.release_executables()

    def test_executables_need_a_library_the_artifact_lacks(self, packed, tmp_path):
        def mutate(root):
            _with_library(root)
            _rewrite_manifest(root, lambda m: m["plan"].update(libraries={}))

        root = _tampered_copy(packed, tmp_path, mutate)
        _assert_refused_with_fallback(packed, root, "does not carry")


class TestColdStartSubprocess:
    def test_cold_process_boots_fleet_at_zero_compiles(self, packed, tmp_path):
        """A fresh process with an empty kernel build directory and no
        CUDA toolkit boots two tenants from the artifact dir: no nvcc build,
        the first tenant's buckets allocated from the artifact inside
        register, no compile event of any kind after register, one
        artifact_hydrated event, and scores bitwise the reference's live
        plan."""
        recs = packed["records"][:24]
        recs_path = tmp_path / "records.json"
        recs_path.write_text(json.dumps(recs))
        script = tmp_path / "boot.py"
        script.write_text(
            "import json, sys\n"
            "from transmogrifai_tpu_torch.deploy import ArtifactStore, DeployBundle\n"
            "from transmogrifai_tpu_torch.obs import flight\n"
            "from transmogrifai_tpu_torch.perf import measure_compiles\n"
            "from transmogrifai_tpu_torch.serve import FleetServer\n"
            "art, recs_path = sys.argv[1], sys.argv[2]\n"
            "recs = json.load(open(recs_path))\n"
            "rec = flight.install_recorder(flight.FlightRecorder())\n"
            "model = DeployBundle.load(art).load_model()\n"
            "with measure_compiles() as probe:\n"
            "    with FleetServer(max_batch=32, max_wait_ms=1.0,\n"
            f"                     min_bucket={MIN_BUCKET},\n"
            f"                     max_bucket={MAX_BUCKET}, device='cpu') as fleet:\n"
            "        fleet.register('a', model, artifact=art)\n"
            "        fleet.register('b', model, artifact=ArtifactStore(art))\n"
            "        boot = probe.events\n"
            "        futs = [fleet.submit('ab'[i % 2], r)\n"
            "                for i, r in enumerate(recs)]\n"
            "        scores = [f.result(timeout=120) for f in futs]\n"
            "    events = probe.events\n"
            "hyd = [e['data'] for e in rec.events('artifact_hydrated')]\n"
            "print(json.dumps({'boot': boot, 'events': events, 'hydrated': hyd,\n"
            "                  'scores': scores}))\n")
        empty_cuda = tmp_path / "no_cuda"
        empty_cuda.mkdir()
        path = os.pathsep.join(p for p in os.environ.get("PATH", "").split(os.pathsep)
                               if p and not os.path.exists(os.path.join(p, "nvcc")))
        env = {**os.environ, "PYTHONPATH": REPO, "CUDA_HOME": str(empty_cuda),
               "PATH": path, "TMOG_TORCH_BUILD_DIR": str(tmp_path / "kernels")}
        env.pop("CUDA_PATH", None)
        out = subprocess.run(
            [sys.executable, str(script), packed["root"], str(recs_path)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert "nvcc_build" not in got["events"]
        # the allocations happened inside register; serving added none
        assert got["events"] == got["boot"] == {"staging": 4, "landing": 8}, \
            out.stderr[-2000:]
        assert len(got["hydrated"]) == 1
        assert got["hydrated"][0]["live_compile_buckets"] == []
        assert got["hydrated"][0]["buckets"] == LADDER
        # bitwise across the process boundary: JSON round-trips floats
        assert got["scores"] == json.loads(json.dumps(packed["ref"][:24]))


class TestDeployGate:
    def _gate(self):
        sys.path.insert(0, os.path.join(REPO, "tools"))
        try:
            import torch_deploy_gate
        finally:
            sys.path.pop(0)
        return torch_deploy_gate

    def test_good_artifact_rc0(self, packed, capsys):
        rc = self._gate().main(["--artifact", packed["root"]])
        assert rc == 0
        assert "torch_deploy_gate: OK" in capsys.readouterr().out

    def test_tampered_artifact_rc1(self, packed, tmp_path, capsys):
        def mutate(root):
            bundle = DeployBundle.load(root)
            meta = bundle.plan["objects"]["8"]
            with open(bundle.object_path(meta["file"]), "ab") as fh:
                fh.write(b"garbage")

        root = _tampered_copy(packed, tmp_path, mutate)
        rc = self._gate().main(["--artifact", root])
        assert rc == 1
        out = capsys.readouterr().out
        assert "TM510" in out and "FAIL" in out

    def test_empty_dir_is_fatal_not_green(self, tmp_path):
        root = str(tmp_path / "nothing")
        os.makedirs(root)
        with pytest.raises(SystemExit, match="refusing to report OK"):
            self._gate().main(["--artifact", root])

    def test_missing_dir_is_fatal_not_green(self, tmp_path):
        with pytest.raises(SystemExit, match="refusing to report OK"):
            self._gate().main(["--artifact", str(tmp_path / "absent")])

    def test_unparseable_manifest_is_fatal(self, packed, tmp_path):
        def mutate(root):
            with open(os.path.join(root, "manifest.json"), "w") as fh:
                fh.write("{not json")

        root = _tampered_copy(packed, tmp_path, mutate)
        with pytest.raises(SystemExit, match="refusing to report OK"):
            self._gate().main(["--artifact", root])


class TestCli:
    def test_deploy_verify_cli_rc(self, packed, tmp_path, capsys):
        from transmogrifai_tpu_torch.cli import main as cli_main

        rc = cli_main(["deploy", "verify", "--artifact", packed["root"]])
        assert rc == 0
        summary = json.loads(capsys.readouterr().out.strip())
        assert summary["refused"] is False

        def mutate(root):
            _rewrite_manifest(root, lambda m: m["environment"].pop("torchVersion"))

        bad = _tampered_copy(packed, tmp_path, mutate)
        rc = cli_main(["deploy", "verify", "--artifact", bad])
        assert rc == 1
        captured = capsys.readouterr()
        assert json.loads(captured.out.strip())["refused"] is True
        assert "TM510" in captured.err

    def test_deploy_pack_cli_roundtrip(self, packed, tmp_path, capsys):
        from transmogrifai_tpu_torch.cli import main as cli_main

        model_dir = str(tmp_path / "model")
        packed["model"].save(model_dir)
        out_dir = str(tmp_path / "artifact")
        rc = cli_main(["deploy", "pack", "--model", model_dir,
                       "--out", out_dir, "--min-bucket", str(MIN_BUCKET),
                       "--max-bucket", str(MAX_BUCKET), "--device", "cpu"])
        assert rc == 0
        summary = json.loads(capsys.readouterr().out.strip())
        assert summary["buckets"] == LADDER
        assert summary["libraries"] == []
        assert summary["contentFingerprint"] == \
            DeployBundle.load(packed["root"]).plan["contentFingerprint"]
        rc = cli_main(["deploy", "verify", "--artifact", out_dir])
        assert rc == 0

    def test_deploy_boot_cli_serves_the_records(self, packed, tmp_path, capsys):
        from transmogrifai_tpu_torch.cli import main as cli_main

        recs = tmp_path / "requests.jsonl"
        recs.write_text("".join(json.dumps(r) + "\n" for r in packed["records"][:16]))
        scores = tmp_path / "scores.jsonl"
        _cold()
        rc = cli_main(["deploy", "boot", "--artifact", packed["root"], "--tenants", "2",
                       "--records", str(recs), "--output", str(scores),
                       "--max-batch", "16", "--max-wait-ms", "200", "--device", "cpu"])
        assert rc == 0
        summary = json.loads(capsys.readouterr().out.strip())
        assert summary["tenants"] == ["tenant0", "tenant1"]
        assert summary["scored_records"] == 16
        assert summary["serve_compile_events"] == {}
        assert "nvcc_build" not in summary["boot_compile_events"]
        got = [json.loads(line) for line in scores.read_text().splitlines()]
        assert got == json.loads(json.dumps(packed["ref"][:16]))

    @pytest.mark.parametrize("command", ["lint"])
    def test_unported_commands_refuse_by_name(self, command, capsys):
        """Every command of the reference is ported now (``UNPORTED`` is
        empty): ``lint`` parses its own arguments, so one it does not take
        is an argparse error, not a refusal by name."""
        from transmogrifai_tpu_torch.cli import UNPORTED
        from transmogrifai_tpu_torch.cli import main as cli_main

        assert command not in UNPORTED
        with pytest.raises(SystemExit):
            cli_main([command, "--input", "x.csv"])
        assert "is not ported" not in capsys.readouterr().err


class TestPackRefusesEmptyWork:
    def test_pack_host_only_model_raises(self, packed, monkeypatch):
        """A host-only plan has no executables; packing an empty artifact
        that every verifier would refuse is refused at CREATION instead."""
        from transmogrifai_tpu_torch.serve.plan import CompiledScoringPlan

        monkeypatch.setattr(CompiledScoringPlan, "device_stage_uids",
                            property(lambda self: []))
        with pytest.raises(ValueError, match="no device prefix"):
            ArtifactStore(packed["root"] + "_none").pack(packed["model"])
        assert not os.path.exists(packed["root"] + "_none")


class TestCrossPackage:
    """Saved models cross between the packages both ways; executables are
    refused both ways, and each side then serves live output bitwise equal
    to never having had an artifact."""

    def test_port_loads_the_reference_packed_model(self, packed):
        model = DeployBundle.load(packed["jroot"]).load_model()
        assert isinstance(model, WorkflowModel)
        plan = _fresh_plan(model)
        assert plan.score(packed["records"][:40]) == packed["ref"]
        plan.release_executables()

    def test_reference_loads_the_port_packed_model(self, packed):
        jmodel = JD.DeployBundle.load(packed["root"]).load_model()
        assert isinstance(jmodel, J.WorkflowModel)
        jplan = jmodel.serving_plan(min_bucket=MIN_BUCKET, max_bucket=MAX_BUCKET)
        assert jplan.score(packed["records"][:40]) == packed["ref"]
        jplan.release_executables()

    def test_port_refuses_the_reference_executables(self, packed):
        res = _assert_refused_with_fallback(packed, packed["jroot"], "no torchVersion")
        report, _ = ArtifactStore(packed["jroot"]).verify(packed["model"])
        assert {d.code for d in report.errors()} == {"TM510"}

    def test_reference_refuses_the_port_executables(self, packed):
        j_flight.uninstall_recorder()
        rec = j_flight.install_recorder(j_flight.FlightRecorder())
        try:
            jplan = packed["jmodel"].serving_plan(min_bucket=MIN_BUCKET,
                                                  max_bucket=MAX_BUCKET)
            res = JD.ArtifactStore(packed["root"]).hydrate(jplan, tenant="j")
            assert res["refused"] is True and res["hydrated"] == []
            assert any("jax-version-coupled" in r for r in res["reasons"]), res
            evs = rec.events("artifact_refused")
            assert len(evs) == 1 and evs[0]["data"]["code"] == "TM510"
        finally:
            j_flight.uninstall_recorder()
        jplan.warm()
        assert jplan.score(packed["records"][:40]) == packed["ref"]
        jplan.release_executables()
