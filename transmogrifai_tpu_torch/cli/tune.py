"""``tune`` subcommand — operate the persistent kernel autotuner.

Counterpart of ``transmogrifai_tpu/cli/tune.py``.  Reference role: the
reference selects models by sweeping candidate grids; ``perf/autotune.py``
applies the same discipline to the Hopper kernels' launch plans.  This
subcommand is the operator surface over that store:

- ``tune show``   — list every verified winner in the store plus the
  ``tune=<digest>`` cache-token component the current process would adopt.
- ``tune run``    — sweep one ``--family`` (or all families) now on
  ``--device`` (default: the card), verify each candidate against the
  kernel's plain version there, persist the winners.
- ``tune clear``  — delete every store entry and drop in-process adoption
  (the next lookup re-reads the now-empty store; tokens revert to untuned).

All actions honor ``--store DIR`` (default: ``TMOG_AUTOTUNE_DIR`` or
``autotune/`` beside the kernel build directory).
``--format json`` emits ONE JSON OBJECT PER LINE (the cli lint JSONL
contract): one ``{"winner": ...}`` / ``{"sweep": ...}`` / ``{"cleared": N}``
line per result, so CI can consume it without a streaming JSON parser.

Run::

    python -m transmogrifai_tpu_torch.cli tune show
    python -m transmogrifai_tpu_torch.cli tune run --family hist --format json
"""

from __future__ import annotations

import json


def add_tune_parser(sub) -> None:
    p = sub.add_parser(
        "tune", help="show / run / clear the persistent kernel autotuner "
                     "store (perf/autotune.py)")
    p.add_argument("action", choices=["show", "run", "clear"],
                   help="show: list verified winners; run: sweep now and "
                        "persist; clear: delete every store entry")
    p.add_argument("--family", action="append", default=[],
                   dest="families",
                   help="restrict 'run' to one kernel family (repeatable; "
                        "default: all families)")
    p.add_argument("--store", default=None, metavar="DIR",
                   help="winner store directory (default: TMOG_AUTOTUNE_DIR "
                        "or autotune/ beside the kernel build directory)")
    p.add_argument("--device", default=None,
                   help="device 'run' sweeps on (default: the card)")
    p.add_argument("--reps", type=int, default=None,
                   help="timing repetitions per candidate (default 3; "
                        "min-of-reps, compile excluded)")
    p.add_argument("--format", choices=["text", "json"], default="text",
                   dest="out_format",
                   help="'json' emits one JSON object per line — one "
                        "winner/sweep/cleared record each")


def _decision_dict(dec) -> dict:
    return {
        "family": dec.family, "shapeClass": dec.shape_class,
        "deviceKind": dec.device_kind, "params": dict(dec.params),
        "source": dec.source, "verified": dec.verified,
        "candidates": dec.candidates, "bestSeconds": dec.best_seconds,
        "defaultSeconds": dec.default_seconds, "eligible": dec.eligible,
        "isDefault": dec.is_default(),
    }


def run_tune(ns) -> int:
    from ..perf import autotune

    store = ns.store or autotune.store_dir()
    as_json = ns.out_format == "json"
    if ns.action == "clear":
        removed = autotune.clear(store)
        if as_json:
            print(json.dumps({"cleared": removed, "store": store}))
        else:
            print(f"tune: cleared {removed} winner entr"
                  f"{'y' if removed == 1 else 'ies'} from {store}")
        return 0
    if ns.action == "run":
        unknown = [f for f in ns.families if f not in autotune.FAMILIES]
        if unknown:
            raise SystemExit(
                f"tune: unknown famil"
                f"{'y' if len(unknown) == 1 else 'ies'} "
                f"{', '.join(sorted(unknown))} "
                f"(known: {', '.join(autotune.FAMILIES)})")
        families = tuple(dict.fromkeys(ns.families)) or autotune.FAMILIES
        kwargs = {"store": store, "device": ns.device}
        if ns.reps is not None:
            kwargs["reps"] = max(1, ns.reps)
        rc = 0
        for family in families:
            dec = autotune.sweep(family, **kwargs)
            if not dec.verified:
                # every candidate (including the default) failed parity or
                # crashed — the sweep adopted defaults; surface it as a
                # failure so CI does not read a broken sweep as tuned
                rc = 1
            if as_json:
                print(json.dumps({"sweep": _decision_dict(dec)}))
            else:
                speedup = ""
                if dec.best_seconds and dec.default_seconds:
                    ratio = dec.default_seconds / dec.best_seconds
                    speedup = f"  ({ratio:.2f}x vs default)"
                print(f"tune: {family:<7} {dec.shape_class}  -> "
                      f"{dec.params}  "
                      f"[{'verified' if dec.verified else 'UNVERIFIED'}, "
                      f"{dec.candidates} candidates]{speedup}")
        if not as_json:
            print(f"tune: store {store}  token "
                  f"{autotune.provenance()['token'] or '(untuned)'}")
        return rc
    # show
    entries = autotune.winners(store)
    if as_json:
        for entry in entries:
            print(json.dumps({"winner": entry}, sort_keys=True))
        print(json.dumps({"store": store, "count": len(entries),
                          "token": autotune.provenance()["token"],
                          "sweeps": autotune.sweep_count()}))
        return 0
    if not entries:
        print(f"tune: no verified winners in {store} "
              f"(run `cli tune run` or set TMOG_AUTOTUNE=1)")
        return 0
    for entry in entries:
        print(f"tune: {entry.get('family', '?'):<7} "
              f"{entry.get('shape_class', '?')}  -> {entry.get('params')}  "
              f"[{entry.get('device_kind', '?')}, "
              f"{entry.get('eligible', '?')}/{entry.get('candidates', '?')} "
              f"eligible]")
    tok = autotune.provenance()["token"]
    print(f"tune: {len(entries)} winner entr"
          f"{'y' if len(entries) == 1 else 'ies'} in {store}  "
          f"token {tok or '(untuned)'}")
    return 0
