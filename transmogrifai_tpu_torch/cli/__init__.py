"""cli — ``python -m transmogrifai_tpu_torch.cli <command>`` (counterpart
of ``transmogrifai_tpu/cli``).

``deploy pack|verify|boot`` (``cli/deploy.py``) is ported.  The reference's
other commands — ``gen``, ``lint``, ``serve``, ``top``, ``train`` and
``tune`` — are registered under their names and refuse to run, by name,
until they are ported.
"""

from __future__ import annotations

import argparse
import sys

#: the reference's commands this package has not ported yet
UNPORTED = ("gen", "lint", "serve", "top", "train", "tune")

__all__ = ["main", "UNPORTED"]


def main(argv=None) -> int:
    from .deploy import add_deploy_parser, run_deploy

    ap = argparse.ArgumentParser(prog="transmogrifai_tpu_torch.cli")
    sub = ap.add_subparsers(dest="command", required=True)
    add_deploy_parser(sub)
    for name in UNPORTED:
        sub.add_parser(name, help=f"the reference's `{name}` (not ported)")
    # an unported command's own arguments are not known here: they are left
    # over, and the command refuses by name below
    ns, extra = ap.parse_known_args(argv)
    if ns.command == "deploy":
        if extra:
            ap.error(f"unrecognized arguments: {' '.join(extra)}")
        return run_deploy(ns)
    print(f"transmogrifai_tpu_torch.cli: `{ns.command}` is not ported to "
          "transmogrifai_tpu_torch yet (ported: deploy)", file=sys.stderr)
    return 2
