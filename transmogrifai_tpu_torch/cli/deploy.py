"""`cli deploy` — pack / verify / boot the deploy artifact store (deploy/).

    # build host (with nvcc): pack a trained model's bucket executables, its
    # kernel libraries and its checkpoint
    python -m transmogrifai_tpu_torch.cli deploy pack \
        --model saved_model/ --out artifact/ --min-bucket 8 --max-bucket 256

    # CI / pre-rollout: verify integrity, provenance, staleness (rc 1 on
    # any TM510 refusal; drift prints as warnings)
    python -m transmogrifai_tpu_torch.cli deploy verify --artifact artifact/

    # replica boot: a FleetServer from the artifact dir, no kernel build,
    # optionally scoring a JSONL replay to prove it serves
    python -m transmogrifai_tpu_torch.cli deploy boot --artifact artifact/ \
        --tenants 4 --records requests.jsonl --output scores.jsonl

Every subcommand prints one JSON summary object (stdout for pack/boot,
stderr for verify's diagnostics) so rollout tooling can parse outcomes.
``--device`` (pack, boot) names the device; without it the card.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict

__all__ = ["add_deploy_parser", "run_deploy"]


def add_deploy_parser(sub) -> None:
    p = sub.add_parser(
        "deploy", help="pack/verify/boot content-addressed serving artifacts "
                       "(replicas that boot without building a kernel)")
    dsub = p.add_subparsers(dest="deploy_command", required=True)

    pk = dsub.add_parser("pack", help="pack a trained model's bucket executables "
                                      "and kernel libraries into an artifact dir")
    pk.add_argument("--model", required=True,
                    help="saved WorkflowModel directory (model.save(path))")
    pk.add_argument("--out", required=True, help="artifact dir to write")
    pk.add_argument("--min-bucket", type=int, default=8)
    pk.add_argument("--max-bucket", type=int, default=1024)
    pk.add_argument("--device", default=None,
                    help="device the plan is warmed on (default: the card)")

    vf = dsub.add_parser("verify", help="check an artifact dir: integrity "
                                        "hashes, provenance, staleness "
                                        "(rc 1 on TM510)")
    vf.add_argument("--artifact", required=True, help="artifact dir")
    vf.add_argument("--model", default=None,
                    help="saved model dir to recompute the live content "
                         "fingerprint against (staleness check); defaults "
                         "to the checkpoint inside the bundle")
    vf.add_argument("--goldens", default=None, metavar="DIR",
                    help="the reference's IR golden corpus option; the port has "
                         "no IR corpus yet, so no corpus-drift check runs")

    bt = dsub.add_parser("boot", help="boot a FleetServer from the artifact "
                                      "dir and report boot compile counts")
    bt.add_argument("--artifact", required=True, help="artifact dir")
    bt.add_argument("--tenants", type=int, default=1,
                    help="register N tenants from the one artifact (default 1)")
    bt.add_argument("--records", default=None,
                    help="optional JSONL records to score after boot ('-' for stdin)")
    bt.add_argument("--output", default="-",
                    help="JSONL scores destination (default: stdout)")
    bt.add_argument("--max-batch", type=int, default=256)
    bt.add_argument("--max-wait-ms", type=float, default=2.0)
    bt.add_argument("--device", default=None,
                    help="device the fleet serves on (default: the card)")


def _pack(ns) -> int:
    from ..deploy import pack_model
    from ..workflow.workflow import WorkflowModel

    model = WorkflowModel.load(ns.model)
    bundle = pack_model(model, ns.out, min_bucket=ns.min_bucket,
                        max_bucket=ns.max_bucket, device=ns.device)
    print(json.dumps({
        "artifact": ns.out,
        "fingerprint": bundle.plan["fingerprint"],
        "contentFingerprint": bundle.plan["contentFingerprint"],
        "buckets": bundle.plan["buckets"],
        "objects": len(bundle.plan["objects"]),
        "libraries": sorted(bundle.plan["libraries"]),
        "torchVersion": bundle.environment["torchVersion"],
    }, sort_keys=True))
    return 0


def _verify(ns) -> int:
    from ..deploy import ArtifactStore, DeployBundle
    from ..deploy.bundle import ir_corpus_fingerprints

    store = ArtifactStore(ns.artifact)
    model = None
    if ns.model is not None:
        from ..workflow.workflow import WorkflowModel

        model = WorkflowModel.load(ns.model)
    else:
        try:
            model = DeployBundle.load(ns.artifact).load_model()
        except Exception:  # noqa: BLE001 — verify() reports the bad bundle
            model = None
    report, drift = store.verify(model, live_corpus=ir_corpus_fingerprints(ns.goldens))
    for d in report:
        print(d.pretty(), file=sys.stderr)
    for w in drift:
        print(f"deploy verify: drift warning: {w}", file=sys.stderr)
    errors = report.errors()
    print(json.dumps({
        "artifact": ns.artifact,
        "refused": bool(errors),
        "errors": len(errors),
        "drift": drift,
    }, sort_keys=True))
    return 1 if errors else 0


def _boot(ns) -> int:
    from ..deploy import ArtifactStore, DeployBundle, artifact_store_stats
    from ..perf import measure_compiles
    from ..serve import FleetServer

    bundle = DeployBundle.load(ns.artifact)
    model = bundle.load_model()
    store = ArtifactStore(ns.artifact)
    min_bucket = bundle.plan.get("minBucket", 8)
    max_bucket = bundle.plan.get("maxBucket", 1024)
    tenants = [f"tenant{i}" for i in range(max(1, ns.tenants))]
    records = []
    if ns.records is not None:
        from .serve import _read_records

        records, _skipped = _read_records(ns.records)

    summary: Dict[str, Any] = {"artifact": ns.artifact, "tenants": tenants}
    with measure_compiles() as probe:
        with FleetServer(max_batch=ns.max_batch, max_wait_ms=ns.max_wait_ms,
                         min_bucket=min_bucket, max_bucket=max_bucket,
                         device=ns.device) as fleet:
            for t in tenants:
                fleet.register(t, model, artifact=store)
            boot = probe.to_dict()
            summary["boot_backend_compiles"] = boot["backend_compiles"]
            summary["boot_compile_events"] = boot["events"]
            if records:
                out = sys.stdout if ns.output == "-" else open(ns.output, "w")
                try:
                    futs = [fleet.submit(tenants[i % len(tenants)], r)
                            for i, r in enumerate(records)]
                    for f in futs:
                        out.write(json.dumps(f.result(timeout=120), default=str) + "\n")
                finally:
                    if out is not sys.stdout:
                        out.close()
                summary["scored_records"] = len(records)
        summary["serve_compile_events"] = {
            k: v - boot["events"].get(k, 0) for k, v in probe.events.items()
            if v - boot["events"].get(k, 0)}
    summary["artifact_store"] = artifact_store_stats()
    print(json.dumps(summary, sort_keys=True, default=str),
          file=sys.stderr if ns.output == "-" and records else sys.stdout)
    return 0


def run_deploy(ns) -> int:
    if ns.deploy_command == "pack":
        return _pack(ns)
    if ns.deploy_command == "verify":
        return _verify(ns)
    return _boot(ns)
