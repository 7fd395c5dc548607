"""Partition of a fitted DAG into a device prefix and a host remainder
(counterpart of the shared primitives in ``transmogrifai_tpu/workflow/plan.py``).

A runner joins the device prefix when it exposes ``device_transform`` and every
input slot it reads on the device is either another prefix output or a raw
feature the plan can lift (a numeric kind, lifted to float32 with NaN for
missing) or the stage encodes itself (``device_lifts_input``).  Everything
else runs on the host, through the ordinary columnar ``transform``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

from ..data.dataset import Dataset
from ..features.generator import FeatureGeneratorStage
from ..types import ColumnKind

#: kinds with a canonical device lift: float32 rows, NaN where missing.
#: VECTOR is absent on purpose: a width known only from the data would make
#: the prefix's output width depend on the batch.
DEVICE_LIFT_KINDS = frozenset({ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL})


def device_slots(runner) -> Tuple[int, ...]:
    """Input slots a runner's ``device_transform`` consumes (default: all)."""
    slots = getattr(runner, "device_input_slots", None)
    if slots is None:
        return tuple(range(len(runner.inputs)))
    return tuple(slots)


def partition_device_prefix(runners: Sequence[Any], entry_ok: Callable):
    """Split topo-ordered runners into ``(prefix, remainder, device_uids)``,
    ``device_uids`` being the feature uids the prefix materializes."""
    device_uids: set = set()
    prefix: List[Any] = []
    remainder: List[Any] = []
    for runner in runners:
        ok = callable(getattr(runner, "device_transform", None)) \
            and len(runner.inputs) > 0
        if ok:
            for slot in device_slots(runner):
                f = runner.inputs[slot]
                if f.uid in device_uids or entry_ok(runner, slot, f):
                    continue
                ok = False
                break
        if ok:
            prefix.append(runner)
            device_uids.add(runner.get_output().uid)
        else:
            remainder.append(runner)
    return prefix, remainder, device_uids


def _serving_entry_ok(runner, slot, f) -> bool:
    """Serving rule: raw features only, canonical lift or stage encoding."""
    return isinstance(f.origin_stage, FeatureGeneratorStage) and (
        f.ftype.kind in DEVICE_LIFT_KINDS or runner.device_lifts_input(slot))


def partition_scoring_stages(runners: Sequence[Any]):
    return partition_device_prefix(runners, _serving_entry_ok)


def run_host_stages(dataset: Dataset, runners: Sequence[Any],
                    device=None) -> Dataset:
    """The host remainder: each runner's columnar ``transform`` in order.
    A runner that ``scores_on_device`` (a fitted model) is told ``device``,
    where it may score large batches."""
    out = dataset
    for runner in runners:
        if getattr(runner, "scores_on_device", False):
            out = runner.transform(out, device=device)
        else:
            out = runner.transform(out)
    return out
