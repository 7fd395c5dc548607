"""cli — ``python -m transmogrifai_tpu_torch.cli <command>`` (counterpart
of ``transmogrifai_tpu/cli``): the ``gen`` project generator
(``cli/gen.py``, whose :func:`main` parses every command), ``train``,
``serve``, ``top``, ``tune`` and ``deploy pack|verify|boot``.

The reference's ``lint`` (its static analysis, not ported) is registered
under its name and refuses to run, by name.

Usage: ``python -m transmogrifai_tpu_torch.cli gen --input data.csv
--response label --id id --output ./myproject --name MyApp``
"""

from .gen import ProblemKind, detect_problem_kind, generate_project, infer_schema, main

#: the reference's commands this package has not ported yet
UNPORTED = ("lint",)

__all__ = ["generate_project", "infer_schema", "detect_problem_kind", "ProblemKind",
           "main", "UNPORTED"]
