"""Pretty-printing table (counterpart of ``transmogrifai_tpu/utils/pretty.py``,
copied)."""

from __future__ import annotations

from typing import Sequence, Tuple


class Table:
    def __init__(self, header: Sequence[str], rows: Sequence[Tuple]):
        self.header = [str(h) for h in header]
        self.rows = [[str(c) for c in row] for row in rows]

    def render(self) -> str:
        widths = [len(h) for h in self.header]
        for row in self.rows:
            for i, c in enumerate(row):
                widths[i] = max(widths[i], len(c))

        def line(cells, fill=" "):
            return "| " + " | ".join(c.ljust(w, fill) for c, w in zip(cells, widths)) + " |"

        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        out = [sep, line(self.header), sep]
        out += [line(r) for r in self.rows]
        out.append(sep)
        return "\n".join(out)
