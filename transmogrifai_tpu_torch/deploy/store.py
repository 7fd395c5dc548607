"""ArtifactStore — content-addressed on-disk store of serving executables
(the port's counterpart of ``transmogrifai_tpu/deploy/store.py``).

Pack side (a build host with ``nvcc``): warm a fitted model's serving plan,
serialize every bucket's executable (``perf.programs.serialize_compiled``:
its staging and landing specs and the kernel libraries it loads) into
``objects/<dd>/<key>.bucket.json`` where the key is the executable's cache
key — plan fingerprint x bucket x kernel token — copy each kernel library
the plan loaded on the card into ``objects/<dd>/<sha256>.so``, and write
the DeployBundle manifest (bundle.py) beside the model checkpoint.

Hydrate side (a replica's boot, which may have no ``nvcc``): verify the
manifest (integrity hashes first), parse every bucket object, install each
verified library for this process
(``perf/kernels/dispatch.py::install_library``, only for the live source
digest, into a directory keyed by its sha256) and load it, then adopt each
bucket into the live plan
(``CompiledScoringPlan.adopt_executable``): its staging buffers land in the
fingerprint's shared state, so later tenants of the fingerprint allocate
none, and no kernel is built.

Every decision is observable: ``artifact_packed`` / ``artifact_hydrated`` /
``artifact_miss`` / ``artifact_refused`` flight events (obs/flight.py),
process-wide counters (``artifact_store_stats``), TM510 diagnostics for
every refusal, and ``deploy.*`` phases (``perf/timers.py``) timing the
hydrate's parts.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..obs import flight as obs_flight
from ..perf.timers import phase
from .bundle import (
    BUNDLE_VERSION,
    MANIFEST_NAME,
    MODEL_DIR,
    OBJECTS_DIR,
    DeployBundle,
    check_bundle,
    environment_provenance,
    ir_corpus_fingerprints,
)

log = logging.getLogger(__name__)

#: process-wide accounting: where did the buckets come from?
_STATS: Dict[str, int] = {"hits": 0, "misses": 0, "refusals": 0, "packed": 0}
_STATS_LOCK = threading.Lock()


def artifact_store_stats() -> Dict[str, int]:
    """Process-wide artifact counters: ``hits`` (buckets hydrated from an
    artifact), ``misses`` (buckets left to a live build), ``refusals``
    (whole artifacts refused with TM510), ``packed``."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_artifact_store_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += n


def artifact_key(fingerprint: str, bucket: int, *,
                 mesh_token_str: Optional[str] = None,
                 kernel_token: Optional[str] = None) -> str:
    """Content address of one bucket executable: plan fingerprint x bucket x
    mesh token x kernel token (the fingerprint already folds both tokens
    in, but the key spells them out so the on-disk address never relies on
    the fingerprint's internals)."""
    if kernel_token is None:
        from ..perf.kernels.dispatch import cache_token

        kernel_token = cache_token()
    if mesh_token_str is None:
        from ..parallel.mesh import mesh_token

        mesh_token_str = json.dumps(mesh_token())
    h = hashlib.blake2b(digest_size=20)
    h.update(json.dumps(["tmog-torch-bucket", BUNDLE_VERSION, fingerprint,
                         int(bucket), mesh_token_str, kernel_token]).encode())
    return h.hexdigest()


def _write_atomic(path: str, data: bytes) -> None:
    """tmp + rename so a crashed pack never leaves a half-written object a
    later verify could read as truncation of a *finished* pack."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _object(root: str, rel: str, blob: bytes) -> Dict[str, Any]:
    _write_atomic(os.path.join(root, rel), blob)
    return {"file": rel, "sha256": hashlib.sha256(blob).hexdigest(), "size": len(blob)}


class ArtifactStore:
    """One artifact dir (= one DeployBundle): pack, verify, hydrate."""

    def __init__(self, root: str):
        self.root = str(root)
        # serializes this process' writers; cross-process safety comes from
        # the tmp+rename discipline, not from this lock
        self._write_lock = threading.Lock()

    # -- pack ----------------------------------------------------------------
    def pack(self, model, *, min_bucket: int = 8, max_bucket: int = 1024,
             buckets: Optional[Sequence[int]] = None,
             goldens_dir: Optional[str] = None,
             precision: Optional[str] = None, device=None) -> DeployBundle:
        """Warm ``model``'s serving plan on ``device`` (the card unless it
        names another) and pack it: the model checkpoint, one executable per
        bucket, one object per kernel library the plan loaded, the manifest.

        ``precision`` packs the plan at a reduced numeric class; the class
        joins the plan fingerprint, hence every ``artifact_key``, and is
        recorded so ``verify(model)`` recomputes the content fingerprint at
        the same class.  Raises ``ValueError`` for a host-only model (no
        device prefix: nothing to pack, and an empty artifact would be
        refused by every verifier)."""
        from ..perf.kernels import dispatch
        from ..perf.programs import serialize_compiled
        from ..serve.plan import CompiledScoringPlan

        plan = CompiledScoringPlan(model, min_bucket=min_bucket, max_bucket=max_bucket,
                                   precision=precision, device=device)
        if not plan.device_stage_uids:
            raise ValueError(
                "model has no device prefix — there are no executables to "
                "pack; a host-only model starts without kernels anyway")
        ladder = list(buckets) if buckets is not None else plan.bucket_ladder()

        env = environment_provenance(plan.device)
        objects: Dict[str, Dict[str, Any]] = {}
        libraries: Dict[str, Dict[str, Any]] = {}
        with self._write_lock:
            model.save(os.path.join(self.root, MODEL_DIR))
            needed = set()
            for b in ladder:
                exe = plan.executable(b)
                needed.update(exe.libraries)
                digest = artifact_key(plan.fingerprint, b,
                                      mesh_token_str=env["meshToken"],
                                      kernel_token=env["kernelToken"])
                rel = os.path.join(OBJECTS_DIR, digest[:2], f"{digest}.bucket.json")
                objects[str(int(b))] = {"keyDigest": digest,
                                        **_object(self.root, rel, serialize_compiled(exe))}
            for name in sorted(needed):
                # the toolkit is the one that built this very file, from its
                # build record, never the nvcc that happens to be live now
                record = dispatch.library_record(name)
                if record.get("sourceDigest") != dispatch.source_digest(name) \
                        or not record.get("cudaToolkit"):
                    raise ValueError(
                        f"kernel library {name} ({dispatch.library_file(name)}) has "
                        f"no build record of this checkout's source and its CUDA "
                        f"toolkit: {record or 'none'}; rebuild it before packing")
                with open(dispatch.library_file(name), "rb") as fh:
                    blob = fh.read()
                sha = hashlib.sha256(blob).hexdigest()
                rel = os.path.join(OBJECTS_DIR, sha[:2], f"{sha}.so")
                libraries[name] = {**_object(self.root, rel, blob),
                                   "sourceDigest": record["sourceDigest"],
                                   "cudaToolkit": record["cudaToolkit"]}
            manifest = {
                "bundleVersion": BUNDLE_VERSION,
                "createdAt": round(time.time(), 3),
                "model": {"path": MODEL_DIR,
                          "resultFeatures": [f.name for f in model.result_features]},
                "plan": {
                    "fingerprint": plan.fingerprint,
                    "contentFingerprint": plan.content_fingerprint,
                    "precision": plan.precision,
                    "donated": plan.donated,
                    "minBucket": plan.min_bucket,
                    "maxBucket": plan.max_bucket,
                    "buckets": [int(b) for b in ladder],
                    "entrySpecs": [[list(t), d] for t, d in plan.entry_specs],
                    "objects": objects,
                    "libraries": libraries,
                },
                "environment": env,
                "irCorpus": ir_corpus_fingerprints(goldens_dir),
            }
            _write_atomic(os.path.join(self.root, MANIFEST_NAME),
                          (json.dumps(manifest, indent=2, sort_keys=True) + "\n").encode())
        _bump("packed")
        obs_flight.record_event("artifact_packed", root=self.root,
                                fingerprint=plan.fingerprint,
                                buckets=[int(b) for b in ladder])
        return DeployBundle(root=self.root, manifest=manifest)

    # -- verify ---------------------------------------------------------------
    def verify(self, model=None, *, min_bucket: Optional[int] = None,
               max_bucket: Optional[int] = None,
               live_corpus: Optional[Dict[str, Any]] = None,
               device=None) -> Tuple[Any, List[str]]:
        """(TM510 DiagnosticReport, drift warnings) for this artifact dir,
        drift judged against ``device`` (see
        ``bundle.environment_provenance``).

        With ``model``, the live plan's content fingerprint is recomputed
        (on the host: it names no device) and compared (staleness); without
        it only structure, integrity and provenance are checked.
        ``live_corpus`` arms the IR-corpus drift check."""
        from ..checkers.diagnostics import DiagnosticReport, make_diagnostic

        try:
            bundle = DeployBundle.load(self.root)
        except (OSError, ValueError) as e:
            report = DiagnosticReport()
            report.diagnostics.append(make_diagnostic(
                "TM510", f"artifact manifest unreadable: {e}",
                location=os.path.join(self.root, MANIFEST_NAME)))
            return report, []
        content_fp = None
        if model is not None:
            from ..serve.plan import CompiledScoringPlan

            mb = bundle.plan.get("minBucket", 8) if min_bucket is None else min_bucket
            xb = bundle.plan.get("maxBucket", 1024) if max_bucket is None else max_bucket
            content_fp = CompiledScoringPlan(
                model, min_bucket=mb, max_bucket=xb,
                precision=bundle.plan.get("precision"), device="cpu").content_fingerprint
        return check_bundle(bundle, content_fingerprint=content_fp,
                            live_corpus=live_corpus, device=device)

    # -- hydrate ---------------------------------------------------------------
    def hydrate(self, plan, tenant: Optional[str] = None) -> Dict[str, Any]:
        """Adopt this artifact's executables into ``plan``; never raises on a
        bad artifact.

        Fail-closed: integrity, version, provenance and content problems
        refuse the WHOLE artifact (TM510 + ``artifact_refused``) before any
        object is parsed; every bucket object is parsed and checked against
        the plan, and every library installed and loaded, before any bucket
        is adopted, so a refusal at any step adopts nothing and the caller's
        ``warm()`` builds live as if there were no artifact.  Environment
        drift is a clean miss (a warning + ``artifact_miss``).  A library of
        other kernel sources is never installed (a clean miss); one that
        verifies but fails to load refuses the artifact with the loader's
        error.

        Returns ``{"hydrated": [buckets], "refused": bool, "reasons": [...],
        "drift": [...]}``."""
        out: Dict[str, Any] = {"hydrated": [], "refused": False,
                               "reasons": [], "drift": []}

        def refused(reasons: List[str]) -> Dict[str, Any]:
            out["refused"] = True
            out["reasons"] = reasons
            _bump("refusals")
            _bump("misses", len(plan.bucket_ladder()))
            for r in reasons:
                log.warning("TM510 deploy artifact refused (%s): %s", self.root, r)
            obs_flight.record_event("artifact_refused", code="TM510",
                                    root=self.root, tenant=tenant,
                                    reasons=reasons[:8])
            return out

        def missed(reasons: List[str]) -> Dict[str, Any]:
            for r in reasons:
                log.warning("deploy artifact miss (%s): %s", self.root, r)
            _bump("misses", len(plan.bucket_ladder()))
            obs_flight.record_event("artifact_miss", root=self.root,
                                    tenant=tenant, reasons=reasons[:8])
            return out

        with phase("deploy.verify"):
            try:
                bundle = DeployBundle.load(self.root)
            except (OSError, ValueError) as e:
                return refused([f"artifact manifest unreadable: {e}"])
            report, drift = check_bundle(
                bundle, content_fingerprint=plan.content_fingerprint,
                device=plan.device)
        out["drift"] = drift
        if report.errors():
            return refused([d.message for d in report.errors()])

        manifest_plan = bundle.plan
        if drift or manifest_plan.get("fingerprint") != plan.fingerprint:
            # content verified equal above, so this is environment drift:
            # the executable key legitimately differs — miss cleanly
            return missed(drift or ["environment-qualified fingerprint differs "
                                    "(packed under another device or kernel "
                                    "environment)"])

        from ..perf.kernels import dispatch
        from ..perf.programs import deserialize_compiled

        wanted = set(plan.bucket_ladder())
        loaded: Dict[int, Any] = {}
        with phase("deploy.deserialize"):
            try:
                for bucket_s, meta in sorted(manifest_plan["objects"].items(),
                                             key=lambda kv: int(kv[0])):
                    bucket = int(bucket_s)
                    if bucket not in wanted:
                        continue
                    with open(bundle.object_path(meta["file"]), "rb") as fh:
                        exe = deserialize_compiled(fh.read())
                    plan.check_executable(exe, bucket)
                    loaded[bucket] = exe
            except (OSError, ValueError, KeyError, TypeError) as e:
                return refused([f"executable payload failed to load: {e}"])

        libraries = manifest_plan.get("libraries", {}) or {}
        needed = sorted({n for exe in loaded.values() for n in exe.libraries})
        with phase("deploy.libraries"):
            missing = [n for n in needed if n not in libraries]
            if missing:
                return refused([f"executables load kernel libraries the artifact "
                                f"does not carry: {missing}"])
            stale = [n for n in needed
                     if libraries[n].get("sourceDigest") != dispatch.source_digest(n)]
            if stale:
                return missed([f"kernel library {n} was built from other sources "
                               "than this checkout's — not installed; the plan "
                               "builds it live" for n in stale])
            for name in needed:
                meta = libraries[name]
                try:
                    with open(bundle.object_path(meta["file"]), "rb") as fh:
                        dispatch.install_library(name, fh.read(), meta["sourceDigest"],
                                                 toolkit=meta.get("cudaToolkit"))
                    if plan.device.type == "cuda":
                        dispatch.load(name, {})
                except (OSError, dispatch.KernelError) as e:
                    dispatch.uninstall_library(name)  # never leave a library that does not load
                    return refused([f"kernel library {name} failed to install or "
                                    f"load: {e}"])

        with phase("deploy.adopt"):
            for bucket, exe in sorted(loaded.items()):
                plan.adopt_executable(bucket, exe)
        out["hydrated"] = sorted(loaded)
        _bump("hits", len(loaded))
        misses = sorted(wanted - set(loaded))
        if misses:
            _bump("misses", len(misses))
        obs_flight.record_event("artifact_hydrated", root=self.root,
                                tenant=tenant, fingerprint=plan.fingerprint,
                                buckets=sorted(loaded),
                                live_compile_buckets=misses)
        return out

    def load_model(self):
        return DeployBundle.load(self.root).load_model()


def pack_model(model, root: str, **kwargs) -> DeployBundle:
    """Convenience wrapper: ``ArtifactStore(root).pack(model, **kwargs)``."""
    return ArtifactStore(root).pack(model, **kwargs)
