#!/usr/bin/env python
"""torch_deploy_gate — CI gate over a packed serving artifact dir of
transmogrifai_tpu_torch (``deploy/``).

Verifies the artifact the rollout is about to ship: manifest integrity
(every object's sha256 and size, kernel libraries included), provenance
(packed by this package; each library's CUDA toolkit no newer than the
CUDA the driver runs) and staleness (the bundled checkpoint's live content
fingerprint; the reference's IR-corpus check waits for the port's IR
corpus).

Exit-code contract:

- rc **1** when verification emits any TM510 refusal — the artifact is
  stale or tampered and must be re-packed, never shipped;
- environment drift (device kind, platform, device count, compute
  capability, kernel token) prints as a warning and does NOT flip the rc:
  the artifact is valid, it just will not hydrate here;
- a gate that cannot run — no artifact dir, an unreadable or unparseable
  manifest, a checkpoint that will not load — is FATAL (SystemExit), never
  green: an unverifiable artifact must not read as OK.

Usage::

    python tools/torch_deploy_gate.py --artifact path/to/artifact
        [--goldens DIR] [--skip-fingerprint]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_deploy_gate",
        description="fail CI when a packed serving artifact is stale or "
                    "tampered (TM510); fatal when it cannot be verified")
    ap.add_argument("--artifact", required=True,
                    help="packed artifact dir (cli deploy pack --out)")
    ap.add_argument("--goldens", default=None, metavar="DIR",
                    help="the reference's IR golden corpus option; the port has "
                         "no IR corpus yet, so no corpus-drift check runs")
    ap.add_argument("--skip-fingerprint", action="store_true",
                    help="skip recomputing the live content fingerprint "
                         "(skips loading the bundled checkpoint; integrity "
                         "+ provenance checks still run)")
    ns = ap.parse_args(argv)

    if not os.path.isdir(ns.artifact):
        raise SystemExit(f"torch_deploy_gate: {ns.artifact!r} is not a directory "
                         "— refusing to report OK")

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from transmogrifai_tpu_torch.deploy import ArtifactStore, DeployBundle
    from transmogrifai_tpu_torch.deploy.bundle import ir_corpus_fingerprints

    try:
        bundle = DeployBundle.load(ns.artifact)
    except (OSError, ValueError) as e:
        # an empty dir / a missing or malformed manifest is not "no
        # findings": there is nothing to verify
        raise SystemExit(f"torch_deploy_gate: cannot read manifest under "
                         f"{ns.artifact!r} ({e}) — refusing to report OK")

    model = None
    if not ns.skip_fingerprint:
        try:
            model = bundle.load_model()
        except Exception as e:  # noqa: BLE001 — any load failure is fatal
            raise SystemExit(f"torch_deploy_gate: bundled checkpoint will not "
                             f"load ({type(e).__name__}: {e}) — cannot "
                             "recompute the live content fingerprint; "
                             "refusing to report OK")

    live_corpus = ir_corpus_fingerprints(ns.goldens)
    if live_corpus is None:
        print("torch_deploy_gate: no IR corpus (the port has none yet) — "
              "corpus-drift check skipped")

    report, drift = ArtifactStore(ns.artifact).verify(model, live_corpus=live_corpus)
    for d in report:
        print(f"torch_deploy_gate: {d.pretty()}")
    for w in drift:
        print(f"torch_deploy_gate: [drift warning] {w}  (never gates)")

    errors = report.errors()
    if errors:
        print(f"torch_deploy_gate: FAIL — {len(errors)} TM510 refusal(s); the "
              "artifact must be re-packed (`cli deploy pack`) from the "
              "current model and environment, never shipped as-is")
        return 1
    plan = bundle.plan
    print(f"torch_deploy_gate: OK — manifest, {len(plan.get('objects', {}))} "
          f"bucket object(s), {len(plan.get('libraries', {}) or {})} library "
          "object(s), provenance and fingerprints verified"
          + (f"; {len(drift)} environment-drift warning(s)" if drift else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
