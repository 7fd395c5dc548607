#!/usr/bin/env python
"""torch_static_gate — the single CI entrypoint for every static-analysis
gate of the port (the contract of the JAX package's ``tools/static_gate.py``).

Runs, in order:

1. **torch_ir_gate** (tools/torch_ir_gate.py): the op-graph golden-corpus differ — always, no
   target needed (the builtin program-family corpus is self-contained);
2. **torch_lint_gate** (tools/torch_lint_gate.py): the TM1xx-TM6xx diagnostic gate —
   when lint arguments are provided after ``--`` (it needs a --workflow /
   --model / --path target);
3. **threads gate** (``--threads``): the TM31x whole-program concurrency
   analyzer (checkers/threadcheck.py) over the repo's threaded serving
   surface (THREADED_SURFACE), through torch_lint_gate's same new-errors-only
   contract against ``tools/torch_threads_baseline.json``;
4. **deploy gate** (``--deploy-artifact DIR``): verifies a packed
   artifact dir (tools/torch_deploy_gate.py) — rc 1 on any TM510 refusal
   (integrity/provenance/staleness), fatal when the artifact cannot be
   read at all.

One merged exit-code contract, inherited from both gates: rc **1** only when
either gate finds a NEW error-severity diagnostic relative to its baseline;
INFO/WARNING findings never flip the rc; a gate that cannot run (crash,
missing corpus, no parseable output) is fatal, never green.

Usage::

    # IR corpus only
    python tools/torch_static_gate.py

    # IR corpus + workflow/source lint
    python tools/torch_static_gate.py -- --workflow myproj.main:build --path myproj/

    # custom baselines
    python tools/torch_static_gate.py --ir-baseline tools/torch_ir_baseline.json \
        --lint-baseline tools/torch_lint_baseline.json -- --path myproj/
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ir_gate as ir_gate  # noqa: E402
import torch_lint_gate as lint_gate  # noqa: E402

#: family markers the golden corpus must keep pinned — a re-golden (or a
#: hand edit) that drops every family carrying one of these would silently
#: un-pin a whole program surface: the chunk tile, the reduced-precision
#: scoring prefixes, and the hand-written kernels' own families
REQUIRED_FAMILY_MARKERS = ("@chunk", "@bf16", "@int8", "perf.kernels.")

#: the threaded surface the ``--threads`` gate lints: every module of the
#: port that owns a lock, a background thread, or state those reach
THREADED_SURFACE = (
    "transmogrifai_tpu_torch/serve",
    "transmogrifai_tpu_torch/obs",
    "transmogrifai_tpu_torch/perf",
    "transmogrifai_tpu_torch/checkers",
    "transmogrifai_tpu_torch/deploy",
    "transmogrifai_tpu_torch/workflow/continual.py",
    "transmogrifai_tpu_torch/workflow/resilience.py",
    "transmogrifai_tpu_torch/readers/prefetch.py",
    "transmogrifai_tpu_torch/data/chunked.py",
)


def check_required_families(goldens_dir: str) -> int:
    """rc 1 when the corpus index no longer holds any family for one of the
    REQUIRED_FAMILY_MARKERS (missing corpus handled by ir_gate itself)."""
    index_path = os.path.join(goldens_dir, "index.json")
    try:
        with open(index_path) as fh:
            entries = json.load(fh).get("entries", {})
    except (OSError, ValueError):
        # absent OR malformed corpus (JSONDecodeError is a ValueError) is
        # ir_gate's (fatal) finding, not ours
        return 0
    rc = 0
    for marker in REQUIRED_FAMILY_MARKERS:
        hits = [k for k in entries if marker in k]
        if not hits:
            print(f"torch_static_gate: FAIL — no golden family carries {marker!r}; "
                  f"the corpus un-pinned a required program surface")
            rc = 1
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_static_gate",
        description="run ir_gate + lint_gate with one merged exit-code "
                    "contract (rc 1 only on NEW errors in either)")
    ap.add_argument("--ir-baseline", default="tools/torch_ir_baseline.json",
                    help="ir_gate baseline file")
    ap.add_argument("--lint-baseline", default="tools/torch_lint_baseline.json",
                    help="lint_gate baseline file")
    ap.add_argument("--skip-ir", action="store_true",
                    help="skip the IR corpus gate")
    ap.add_argument("--threads", action="store_true",
                    help="run the TM31x concurrency gate over the threaded "
                         "serving surface (new-errors-only vs "
                         "--threads-baseline)")
    ap.add_argument("--threads-baseline",
                    default="tools/torch_threads_baseline.json",
                    help="threads-gate baseline file")
    ap.add_argument("--deploy-artifact", default=None, metavar="DIR",
                    help="packed artifact dir to verify via "
                         "torch_deploy_gate (rc 1 on TM510 refusals)")
    ap.add_argument("--goldens", default=None, metavar="DIR",
                    help="golden IR corpus directory forwarded to ir_gate")
    ap.add_argument("lint_args", nargs=argparse.REMAINDER,
                    help="arguments forwarded to `cli lint` via lint_gate "
                         "(prefix with --); omit to run the IR gate only")
    ns = ap.parse_args(argv)
    lint_args = [a for a in ns.lint_args if a != "--"]

    rc = 0
    if not ns.skip_ir:
        ir_argv = ["--baseline", ns.ir_baseline]
        if ns.goldens:
            ir_argv += ["--", "--goldens", ns.goldens]
        print("torch_static_gate: running ir_gate ...")
        rc_ir = ir_gate.main(ir_argv)
        print(f"torch_static_gate: ir_gate rc={rc_ir}")
        rc = max(rc, rc_ir)
        goldens_dir = ns.goldens or os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tests", "goldens", "torch_ir")
        rc = max(rc, check_required_families(goldens_dir))

    if lint_args:
        print("torch_static_gate: running lint_gate ...")
        rc_lint = lint_gate.main(["--baseline", ns.lint_baseline, "--",
                                  *lint_args])
        print(f"torch_static_gate: lint_gate rc={rc_lint}")
        rc = max(rc, rc_lint)
    elif ns.skip_ir and not ns.threads and not ns.deploy_artifact:
        # every gate disabled: refuse to report a green nothing
        raise SystemExit("torch_static_gate: --skip-ir with no lint args and no "
                         "--threads runs NO gate — refusing to exit 0")
    else:
        print("torch_static_gate: no lint args — lint_gate skipped "
              "(pass `-- --workflow ... --path ...` to enable)")

    if ns.threads:
        repo_root = os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))
        surface = [os.path.join(repo_root, p) for p in THREADED_SURFACE]
        missing = [p for p in surface if not os.path.exists(p)]
        if missing:
            # a renamed module must shrink THREADED_SURFACE consciously,
            # not silently drop out of the gate
            raise SystemExit("torch_static_gate: threads surface missing: "
                             + ", ".join(missing))
        threads_args = []
        for p in surface:
            threads_args += ["--path", p]
        threads_args.append("--threads")
        print("torch_static_gate: running threads gate (TM31x) ...")
        rc_thr = lint_gate.main(["--baseline", ns.threads_baseline, "--",
                                 *threads_args])
        print(f"torch_static_gate: threads gate rc={rc_thr}")
        rc = max(rc, rc_thr)

    if ns.deploy_artifact:
        import torch_deploy_gate as deploy_gate

        deploy_argv = ["--artifact", ns.deploy_artifact]
        if ns.goldens:
            deploy_argv += ["--goldens", ns.goldens]
        print("torch_static_gate: running deploy_gate ...")
        rc_dep = deploy_gate.main(deploy_argv)
        print(f"torch_static_gate: deploy_gate rc={rc_dep}")
        rc = max(rc, rc_dep)

    print(f"torch_static_gate: {'FAIL' if rc else 'OK'} (rc={rc})")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
