#!/usr/bin/env python
"""torch_ir_gate — CI helper over ``python -m transmogrifai_tpu_torch.cli
lint --ir --format json``: fail on NEW TM7xx errors only (the
torch_lint_gate.py exit-code contract, applied to the port's op-graph golden
corpus, ``tests/goldens/torch_ir``).

Exit-code contract:

- rc **1** only when the IR differ emits an ERROR-severity diagnostic
  (TM704 dtype/widening drift, TM705 sharded-sort miscompile hazard) whose
  stable key is not recorded in the baseline file.
- TM701 benign text drift, TM702 fusion/layout and TM703 collective drift
  NEVER flip the exit code — they print for visibility.  (A torch upgrade
  is expected to produce some: decompositions move between releases;
  re-golden with ``cli lint --ir --update-goldens`` once reviewed.)
- Known errors (present in the baseline) keep rc 0 for incremental burndown;
  ``--update-baseline`` rewrites the baseline and exits 0.
- A lint crash / missing corpus is rc != 0 with no parseable output and is
  FATAL — a gate whose baseline went missing must not read as green.

Usage::

    python tools/torch_ir_gate.py [--baseline tools/torch_ir_baseline.json]
        [--update-baseline] [-- extra `cli lint` args, e.g. --ir-family ...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_lint_gate import error_key  # noqa: E402  — shared stable-key format


def run_ir_json(lint_args: List[str]) -> List[Dict]:
    """Run ``cli lint --ir --format json``; parse its JSONL diagnostics."""
    cmd = [sys.executable, "-m", "transmogrifai_tpu_torch.cli", "lint", "--ir",
           "--format", "json", "--fail-on", "error", *lint_args]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    diags: List[Dict] = []
    parsed_any = False
    for line in proc.stdout.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        parsed_any = True
        if "irDiff" in obj or "planCostReport" in obj:
            continue  # summary line, not a diagnostic
        if "code" in obj:
            diags.append(obj)
    if not parsed_any:
        # zero parseable output is NOT "no findings": the lint refused to
        # run (missing golden corpus, crash, lost args) — a gate that reads
        # that as green would mask exactly what it exists to catch
        sys.stderr.write(proc.stderr)
        raise SystemExit(
            f"torch_ir_gate: lint --ir produced no parseable output "
            f"(rc={proc.returncode}) — refusing to report OK")
    return diags


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_ir_gate",
        description="fail CI on NEW IR-corpus errors only (TM704/TM705; "
                    "TM701-TM703 never flip the exit code)")
    ap.add_argument("--baseline", default="tools/torch_ir_baseline.json",
                    help="JSON file of known error keys (default: "
                         "tools/torch_ir_baseline.json; absent = empty)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline with the current error set "
                         "and exit 0")
    ap.add_argument("lint_args", nargs=argparse.REMAINDER,
                    help="extra arguments forwarded to `cli lint --ir` "
                         "(prefix with --), e.g. --goldens DIR / "
                         "--ir-family perf.kernels")
    ns = ap.parse_args(argv)
    lint_args = [a for a in ns.lint_args if a != "--"]

    diags = run_ir_json(lint_args)
    errors = [d for d in diags if d.get("severity") == "error"]
    others = [d for d in diags if d.get("severity") != "error"]

    baseline: List[str] = []
    if os.path.exists(ns.baseline):
        with open(ns.baseline) as fh:
            baseline = json.load(fh).get("errors", [])

    current_keys = sorted({error_key(d) for d in errors})
    if ns.update_baseline:
        os.makedirs(os.path.dirname(os.path.abspath(ns.baseline)),
                    exist_ok=True)
        with open(ns.baseline, "w") as fh:
            json.dump({"errors": current_keys}, fh, indent=2)
            fh.write("\n")
        print(f"torch_ir_gate: baseline updated with {len(current_keys)} "
              f"error key(s) -> {ns.baseline}")
        return 0

    known = set(baseline)
    new_errors = [d for d in errors if error_key(d) not in known]
    stale = sorted(known - set(current_keys))

    for d in others:
        print(f"torch_ir_gate: [{d.get('severity')}] {d.get('code')}: "
              f"{d.get('message')}  (never gates)")
    for d in errors:
        tag = "NEW" if error_key(d) not in known else "known"
        print(f"torch_ir_gate: [{tag} error] {error_key(d)}: {d.get('message')}")
    if stale:
        print(f"torch_ir_gate: {len(stale)} baseline entr(ies) no longer fire — "
              f"consider --update-baseline: {', '.join(stale)}")

    if new_errors:
        print(f"torch_ir_gate: FAIL — {len(new_errors)} new error(s); triage them and "
              f"re-golden with `cli lint --ir --update-goldens` once "
              f"understood")
        return 1
    print(f"torch_ir_gate: OK — {len(errors)} known error(s), "
          f"{len(others)} info/warning finding(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
