"""cli — ``python -m transmogrifai_tpu_torch.cli <command>`` (counterpart
of ``transmogrifai_tpu/cli``): the ``gen`` project generator
(``cli/gen.py``, whose :func:`main` parses every command), ``train``,
``serve``, ``top``, ``tune``, ``deploy pack|verify|boot`` and ``lint`` (the
static analysis, ``cli/lint.py``).

Usage: ``python -m transmogrifai_tpu_torch.cli gen --input data.csv
--response label --id id --output ./myproject --name MyApp``
"""

from .gen import ProblemKind, detect_problem_kind, generate_project, infer_schema, main

#: the reference's commands this package has not ported yet (every one is)
UNPORTED = ()

__all__ = ["generate_project", "infer_schema", "detect_problem_kind", "ProblemKind",
           "main", "UNPORTED"]
