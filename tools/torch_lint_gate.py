#!/usr/bin/env python
"""torch_lint_gate — CI helper over ``python -m transmogrifai_tpu_torch.cli
lint --format json``: fail on NEW errors (the contract of the JAX package's
``tools/lint_gate.py``, over the port, with the port's own baseline).

Exit-code contract:

- rc **1** only when the lint emits an ERROR-severity diagnostic that is not
  recorded in the baseline file.
- INFO and WARNING findings NEVER flip the exit code — they print for
  visibility, nothing more.  (Use plain ``cli lint --fail-on warning`` for a
  stricter local gate.)
- Known errors (present in the baseline) keep rc 0, so a legacy finding can
  be burned down incrementally without blocking every unrelated PR.
- ``--update-baseline`` rewrites the baseline to the current error set and
  exits 0.

The baseline stores stable error keys — ``code @ stageUid-or-location`` —
not messages, so message rewording does not churn it.

Usage::

    python tools/torch_lint_gate.py [--baseline tools/torch_lint_baseline.json]
        [--update-baseline] -- --workflow myproj.main:build --path myproj/
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List


def error_key(d: Dict) -> str:
    where = d.get("stageUid") or d.get("location") or "<workflow>"
    return f"{d.get('code', '?')} @ {where}"


def run_lint_json(lint_args: List[str]) -> List[Dict]:
    """Run ``cli lint --format json`` and parse its JSONL diagnostics.

    The lint's own exit code is ignored here — the gate applies its own
    contract; only a crash (no parseable output at all) is fatal.
    """
    cmd = [sys.executable, "-m", "transmogrifai_tpu_torch.cli", "lint",
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
        if "planCostReport" in obj:
            continue  # cost report line, not a diagnostic
        if "code" in obj:
            diags.append(obj)
    if not parsed_any and proc.returncode != 0:
        # rc 1 with zero parseable output is NOT "no findings": it is the
        # lint refusing to run (bad --model path, lost args in CI YAML
        # quoting, a crash) — a gate that reads that as green would mask
        # exactly the misconfiguration it exists to catch
        sys.stderr.write(proc.stderr)
        raise SystemExit(
            f"torch_lint_gate: lint failed (rc={proc.returncode}) with no "
            f"parseable output — refusing to report OK")
    return diags


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_lint_gate",
        description="fail CI on NEW lint errors only (INFO/WARNING never "
                    "flip the exit code)")
    ap.add_argument("--baseline", default="tools/torch_lint_baseline.json",
                    help="JSON file of known error keys (default: "
                         "tools/torch_lint_baseline.json; absent = empty)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline with the current error set "
                         "and exit 0")
    ap.add_argument("lint_args", nargs=argparse.REMAINDER,
                    help="arguments forwarded to `cli lint` (prefix with --)")
    ns = ap.parse_args(argv)
    lint_args = [a for a in ns.lint_args if a != "--"]
    if not lint_args:
        ap.error("no lint arguments given — pass e.g. "
                 "`-- --workflow pkg.mod:build --path pkg/`")

    diags = run_lint_json(lint_args)
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
        print(f"torch_lint_gate: baseline updated with {len(current_keys)} "
              f"error key(s) -> {ns.baseline}")
        return 0

    known = set(baseline)
    new_errors = [d for d in errors if error_key(d) not in known]
    stale = sorted(known - set(current_keys))

    for d in others:
        print(f"torch_lint_gate: [{d.get('severity')}] {d.get('code')}: "
              f"{d.get('message')}  (never gates)")
    for d in errors:
        tag = "NEW" if error_key(d) not in known else "known"
        print(f"torch_lint_gate: [{tag} error] {error_key(d)}: {d.get('message')}")
    if stale:
        print(f"torch_lint_gate: {len(stale)} baseline entr(ies) no longer fire — "
              f"consider --update-baseline: {', '.join(stale)}")

    if new_errors:
        print(f"torch_lint_gate: FAIL — {len(new_errors)} new error(s)")
        return 1
    print(f"torch_lint_gate: OK — {len(errors)} known error(s), "
          f"{len(others)} info/warning finding(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
