"""``top`` subcommand — a live one-screen fleet ops console.

Counterpart of ``transmogrifai_tpu/cli/top.py``. Reference role: the
reference's ModelInsights answers "what is this model doing" offline; ``cli
top`` is the runtime fleet sibling — one refreshing screen of per-tenant rps
/ p99 / SLO-budget-remaining / breaker state / HBM residency, rendered from
the ``statusz`` JSONL stream a serving process emits (``cli serve --models
DIR --statusz-out status.jsonl`` appends one ``FleetServer.statusz()`` line
per interval; any embedding can do the same). The console is a pure
*reader*: it never touches the serving process, so attaching/detaching it
cannot perturb p99s.

Run::

    python -m transmogrifai_tpu_torch.cli top --statusz status.jsonl

``--once`` renders a single frame and exits (scripts/tests); ``--frames N``
bounds the refresh loop.  It reads a file and touches no device, so it takes
no ``--device``.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional


def add_top_parser(sub) -> None:
    p = sub.add_parser(
        "top", help="live one-screen fleet console over a statusz JSONL "
                    "stream (cli serve --models --statusz-out)")
    p.add_argument("--statusz", required=True,
                   help="statusz JSONL file to tail (newest line wins)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh seconds (default 2)")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit")
    p.add_argument("--frames", type=int, default=None,
                   help="render this many frames then exit (default: "
                        "until interrupted)")
    p.add_argument("--no-clear", action="store_true",
                   help="append frames instead of clearing the screen "
                        "(pipes, logs)")


#: bytes read from the end of the statusz stream per frame — a multi-day
#: serve appends forever, and the console must stay a constant-cost reader
_TAIL_BYTES = 65536


def _read_last_status(path: str) -> Optional[Dict[str, Any]]:
    """The newest parseable statusz line (None on no file / no line yet —
    the console shows a waiting banner instead of crashing on a race with
    the writer's first append).  Reads only a bounded tail of the file, so
    refresh cost does not grow with the stream's age."""
    try:
        with open(path, "rb") as fh:
            fh.seek(0, 2)
            size = fh.tell()
            fh.seek(max(0, size - _TAIL_BYTES))
            tail = fh.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    lines = tail.splitlines()
    if size > _TAIL_BYTES and lines:
        lines = lines[1:]  # the first tail line may be truncated mid-record
    for line in reversed(lines):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and "tenants" in obj:
            return obj
    return None


def _fmt(v: Any, width: int, suffix: str = "") -> str:
    if v is None:
        return "-".rjust(width)
    if isinstance(v, float):
        return f"{v:.1f}{suffix}".rjust(width)
    return f"{v}{suffix}".rjust(width)


def _budget_cell(row: Dict[str, Any]) -> str:
    rem = row.get("budget_remaining")
    if rem is None:
        return "-".rjust(7)
    pct = f"{max(rem, -9.99) * 100:.0f}%"
    if row.get("escalated"):
        pct += "!"
    return pct.rjust(7)


def format_statusz(status: Dict[str, Any]) -> str:
    """Render one ``FleetServer.statusz()`` payload as the one-screen
    console frame (plain text, fixed-width columns)."""
    fleet = status.get("fleet", {})
    ts = status.get("ts")
    when = time.strftime("%H:%M:%S", time.localtime(ts)) if ts else "-"
    hbm = fleet.get("resident_hbm_bytes")
    budget = fleet.get("hbm_budget")
    hbm_cell = "-" if hbm is None else f"{hbm / 1e6:.1f}MB"
    if budget:
        hbm_cell += f"/{budget / 1e6:.0f}MB"
    lines: List[str] = [
        f"fleet @ {when}  tenants={fleet.get('tenants', 0)}  "
        f"queue={fleet.get('queue_depth', 0)}  hbm={hbm_cell}  "
        f"shed={fleet.get('shed', 0)}  "
        f"evictions={fleet.get('evictions', 0)}  "
        f"device_s={fleet.get('device_seconds', 0.0):.3f}  "
        f"pipe={fleet.get('pipeline_depth', 0)}"
        f"@{fleet.get('pipeline_overlap', 0.0):.2f}  "
        f"slo={'armed' if fleet.get('slo_monitor_armed') else 'off'}",
        f"{'TENANT':<12}{'SLO':<8}{'PREC':<6}{'RPS':>8}{'P99ms':>8}"
        f"{'BUDGET':>7}{'BURN':>6}{'BRKR':>10}{'WARM':>5}{'SHED':>6}"
        f"{'DLEXP':>6}{'FAIL':>6}{'DEV_s':>8}",
    ]
    for tenant in sorted(status.get("tenants", {})):
        row = status["tenants"][tenant]
        burn = row.get("burn_fast")
        breaker = row.get("breaker") or "-"
        lines.append(
            f"{tenant[:11]:<12}{str(row.get('slo', '-'))[:7]:<8}"
            f"{str(row.get('precision') or 'f32')[:5]:<6}"
            f"{_fmt(row.get('rps'), 8)}"
            f"{_fmt(row.get('p99_ms'), 8)}"
            f"{_budget_cell(row)}"
            f"{_fmt(burn, 6)}"
            f"{breaker[:9]:>10}"
            f"{_fmt(row.get('warm_buckets'), 5)}"
            f"{_fmt(row.get('shed', 0), 6)}"
            f"{_fmt(row.get('deadline_expired', 0), 6)}"
            f"{_fmt(row.get('failed', 0), 6)}"
            f"{row.get('device_seconds', 0.0):>8.3f}")
    firing = [(t, r["slo_firing"])
              for t, r in sorted(status.get("tenants", {}).items())
              if r.get("slo_firing")]
    for tenant, kinds in firing:
        lines.append(f"!! {tenant}: SLO burn firing ({', '.join(kinds)})")
    return "\n".join(lines)


def run_top(ns) -> int:
    frames = 1 if ns.once else ns.frames
    rendered = 0
    try:
        while True:
            status = _read_last_status(ns.statusz)
            if not ns.no_clear and sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            if status is None:
                print(f"top: waiting for statusz lines in {ns.statusz!r} "
                      "(cli serve --models --statusz-out writes them)")
            else:
                print(format_statusz(status))
            sys.stdout.flush()
            rendered += 1
            if frames is not None and rendered >= frames:
                return 0
            time.sleep(max(ns.interval, 0.05))
    except KeyboardInterrupt:
        return 0
