"""CompiledScoringPlan — a fitted model bound for online scoring on the card.

Counterpart of ``transmogrifai_tpu/serve/plan.py``.  A plan works in three
parts, each timed (``last_timings``, ``metrics()``):

1. **host encode** — field extraction; float32 lifts of raw numeric features
   (NaN for missing, one lift shared by every stage that reads the feature);
   stage-owned encodings such as the one-hot level codes;
2. **device prefix** — the machinery shared with the training-time plan
   (``workflow/plan.py::DevicePrefix``): the batch's operands, padded, are
   packed into one pinned host buffer per dtype and reach ``device`` in one
   copy each; every prefix stage whose device half is the encode kernel and
   whose inputs are all operands (the one-hot and bucketize slots) is
   encoded by one launch of it (``perf/kernels/encode.py::encode_slots``);
   the other prefix stages run in topological order as torch ops and the
   port's CUDA kernels; the outputs the host still needs come back as numpy;
3. **host remainder** — every other stage (the model head, float64 numpy)
   through its columnar ``transform``; a tree head scores batches above 512
   rows on the plan's device.

Batches pad to power-of-two row buckets (as the reference, whose jit cache
needed them): the kernels see a handful of shapes, and a batch's padded rows
never reach its real ones because device transforms are row-local.

The plan runs on the CUDA card unless ``device`` names another device; with
no card and no device it raises.  ``device="cpu"`` runs every kernel's plain
PyTorch version — the tests' path, and the reference the card is held to.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Column, Dataset
from ..features.feature import Feature, _NamedExtract
from ..features.generator import FeatureGeneratorStage
from ..perf.kernels.dispatch import resolve_device
from ..types import ColumnKind, NonNullableEmptyException
from ..workflow.dag import compute_dag
from ..workflow.plan import (
    DevicePrefix,
    Staging,
    run_host_stages,
    serving_entry_ok,
)


def resolve_scoring_stages(result_features: Sequence[Feature],
                           fitted: Mapping[str, Any]) -> list:
    """Topologically ordered fitted runners for the scoring path; an
    estimator node without a fitted model is an error."""
    from ..stages.base import Estimator

    runners = []
    for layer in compute_dag(result_features):
        for stage in layer:
            runner = fitted.get(stage.uid)
            if runner is None:
                if isinstance(stage, Estimator):
                    raise ValueError(
                        f"[TM501] Stage {stage.uid} is an unfitted estimator; "
                        "cannot compile a scoring plan")
                runner = stage
            runners.append(runner)
    return runners


def _bucket_for(n: int, min_bucket: int, max_bucket: int) -> int:
    b = max(int(min_bucket), 1 << max(0, (int(n) - 1)).bit_length())
    return min(b, max_bucket)


def _extract(gen: FeatureGeneratorStage, records) -> list:
    fn = gen.extract_fn
    if isinstance(fn, _NamedExtract):
        try:  # dict records: direct field reads
            return [r.get(fn.key) for r in records]
        except AttributeError:
            pass
    return [fn(r) for r in records]


def _lift_builder(gen: FeatureGeneratorStage) -> Callable:
    """records -> float32 operand of a raw numeric feature, with the same
    conversions and non-nullable checks as building its typed column."""
    ftype = gen.ftype
    conv = ftype._convert
    nullable = ftype.is_nullable
    name = gen.raw_name

    def build(records):
        vals = _extract(gen, records)
        if None in vals:
            if not nullable:
                raise NonNullableEmptyException(
                    f"{ftype.__name__} feature {name!r} cannot be empty")
            vals = [np.nan if v is None else v for v in vals]
        try:
            out = np.asarray(vals, dtype=np.float32)
        except (TypeError, ValueError):
            return np.asarray([np.nan if (c := conv(v)) is None else c
                               for v in vals], dtype=np.float32)
        if str in set(map(type, vals)):  # numpy parses "1.2"; the typed
            for v in vals:               # path must refuse it
                conv(v)
        return out
    return build


def extract_columns(records: Sequence[Any], named_gens,
                    allow_missing_response: bool = False) -> Dict[str, Column]:
    """Typed columns of (name, generator) pairs over the records.  With
    ``allow_missing_response`` a response absent from every record is
    skipped (scoring batches carry no label); a malformed one still raises."""
    cols: Dict[str, Column] = {}
    for name, g in named_gens:
        try:
            cols[name] = Column.from_values(
                g.ftype, [g.extract(r).value for r in records])
        except Exception:
            if not (allow_missing_response and g.is_response):
                raise
            fn = getattr(g, "extract_fn", None)
            if isinstance(fn, _NamedExtract) and any(
                    isinstance(r, dict) and r.get(fn.key) is not None
                    for r in records):
                raise
    return cols


def _plain(v: Any):
    """numpy scalars and arrays -> plain python for the output records."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


class CompiledScoringPlan(DevicePrefix):
    """Fitted workflow model bound to a device for batch scoring.

    ``plan.score(records)`` returns one ``{result feature name: value}`` dict
    per record, the reference plan's output contract.
    """

    def __init__(self, model, device=None, min_bucket: int = 8,
                 max_bucket: int = 1024):
        if max_bucket < min_bucket or min_bucket < 1:
            raise ValueError(f"bad bucket range [{min_bucket}, {max_bucket}]")
        self.min_bucket = 1 << (int(min_bucket) - 1).bit_length()
        self.max_bucket = 1 << (int(max_bucket) - 1).bit_length()
        self.result_features: List[Feature] = list(model.result_features)
        super().__init__(resolve_scoring_stages(self.result_features, model.fitted),
                         serving_entry_ok, resolve_device(device))
        self._generators = self._collect_generators()
        self._build_sources()
        #: row bucket -> its staging buffers (built at the bucket's first batch)
        self._staging: Dict[int, Staging] = {}
        self._counters = {"scored_records": 0, "scored_batches": 0,
                          "encode_ms": 0.0, "device_ms": 0.0, "host_ms": 0.0,
                          "h2d_copies": 0}
        #: per-part milliseconds of the last batch: host encode, device
        #: prefix (H2D copies + kernels; CUDA events on the card), host remainder
        self.last_timings: Dict[str, float] = {}

    def metrics(self) -> Dict[str, Any]:
        out = dict(self._counters)
        out.update(device=str(self.device), fused_stages=len(self._prefix),
                   host_stages=len(self._remainder))
        return out

    # -- construction helpers ------------------------------------------------
    def _collect_generators(self) -> List[FeatureGeneratorStage]:
        seen: Dict[str, FeatureGeneratorStage] = {}
        for f in self.result_features:
            for raw in f.raw_features():
                st = raw.origin_stage
                if isinstance(st, FeatureGeneratorStage):
                    seen.setdefault(st.uid, st)
        return list(seen.values())

    def _build_sources(self) -> None:
        """Where each entry comes from in a batch of records, and which
        prefix outputs and raw columns the host remainder needs."""
        self._lift_builders: Dict[tuple, Callable] = {
            key: _lift_builder(f.origin_stage) for key, f in self._entry_lifts.items()}
        needed: Dict[str, Feature] = {}
        for runner in self._remainder:
            for f in runner.inputs:
                if f.uid in self._device_uids:
                    needed.setdefault(f.uid, f)
        for f in self.result_features:
            if f.uid in self._device_uids:
                needed.setdefault(f.uid, f)
        self._out_features = list(needed.values())
        self._out_uids = [f.uid for f in self._out_features]
        # raw columns the host still needs: remainder inputs and raw results
        host_needed: Dict[str, FeatureGeneratorStage] = {}
        for runner in self._remainder:
            for f in runner.inputs:
                if isinstance(f.origin_stage, FeatureGeneratorStage):
                    host_needed.setdefault(f.name, f.origin_stage)
        for f in self.result_features:
            if isinstance(f.origin_stage, FeatureGeneratorStage):
                host_needed.setdefault(f.name, f.origin_stage)
        self._host_raw = list(host_needed.items())
        # encoder inputs the host needs for nothing else skip typed conversion
        self._encoder_light: Dict[str, FeatureGeneratorStage] = {}
        for _runner, _slot, f in self._entry_encoders.values():
            gen = f.origin_stage
            if gen.raw_name not in host_needed:
                self._encoder_light[gen.raw_name] = gen

    def _stage(self, entries: List[np.ndarray], n: int,
               bucket: int) -> List[torch.Tensor]:
        """The batch's entries as device operands, through the bucket's
        staging buffers (one copy per dtype)."""
        for e in entries:
            if e.ndim != 1 or e.shape[0] != n:
                raise ValueError(f"a prefix operand must be 1-D with {n} rows, "
                                 f"got shape {e.shape}")
        dtypes = tuple(e.dtype for e in entries)
        st = self._staging.get(bucket)
        if st is None or st.dtypes != dtypes:
            st = self._staging[bucket] = Staging(dtypes, bucket, self.device)
        self._counters["h2d_copies"] += st.load(entries, n)
        return st.operands

    # -- the three parts -----------------------------------------------------
    def _encode_records(self, records) -> Tuple[Dict[str, Column], List[np.ndarray]]:
        host_cols = extract_columns(records, self._host_raw,
                                    allow_missing_response=True)
        enc_cols = dict(host_cols)
        for raw_name, gen in self._encoder_light.items():
            enc_cols[raw_name] = Column(gen.ftype, np.array(_extract(gen, records),
                                                            dtype=object))
        entries = []
        for key in self._entry_keys:
            if key[0] == "lift":
                entries.append(self._lift_builders[key](records))
            else:
                runner, slot, f = self._entry_encoders[key]
                raw_name = f.origin_stage.raw_name
                col = enc_cols.get(raw_name)
                if col is None:
                    raise ValueError(f"raw feature {raw_name!r} is required by "
                                     f"{runner.uid} but absent from the records")
                entries.append(np.asarray(runner.encode_device_input(slot, col)))
        return host_cols, entries

    def _run_prefix(self, entries: List[np.ndarray], n: int) -> List[np.ndarray]:
        """Pad, move to the device, run the prefix, bring its needed outputs
        back (the copy back is the batch's one synchronisation)."""
        if not self._prefix:
            self.last_timings["device_ms"] = 0.0
            return []
        bucket = _bucket_for(n, self.min_bucket, self.max_bucket)
        on_card = self.device.type == "cuda"
        t0 = time.perf_counter()
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        ops_in = self._stage(entries, n, bucket)
        env: Dict[str, torch.Tensor] = {}
        self._encode(ops_in, bucket, env)
        self._run_wiring(ops_in, env)
        if on_card:
            end.record()
        outs = [env[u][:n].cpu().numpy() for u in self._out_uids]
        self.last_timings["device_ms"] = start.elapsed_time(end) if on_card \
            else (time.perf_counter() - t0) * 1e3
        return outs

    @staticmethod
    def _materialize(f: Feature, arr: np.ndarray) -> Column:
        if f.ftype.kind is ColumnKind.VECTOR:
            return Column.vector(arr)
        if f.ftype.kind in (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL):
            return Column(f.ftype, arr.astype(np.float64),
                          np.ones(arr.shape[0], dtype=np.bool_))
        return Column(f.ftype, arr)

    def _run(self, host_cols: Dict[str, Column], entries: List[np.ndarray],
             n: int, t_encode: float) -> Dataset:
        outs = self._run_prefix(entries, n)
        t0 = time.perf_counter()
        cols = dict(host_cols)
        for f, arr in zip(self._out_features, outs):
            cols[f.name] = self._materialize(f, arr)
        ds = run_host_stages(Dataset(cols), self._remainder, device=self.device)
        self.last_timings["host_ms"] = (time.perf_counter() - t0) * 1e3
        self.last_timings["encode_ms"] = t_encode * 1e3
        for k in ("encode_ms", "device_ms", "host_ms"):
            self._counters[k] += self.last_timings[k]
        self._counters["scored_records"] += n
        self._counters["scored_batches"] += 1
        return ds

    # -- scoring -------------------------------------------------------------
    def prefix_outputs(self, records: Sequence[Mapping[str, Any]]) -> List[np.ndarray]:
        """The device prefix's outputs for one batch (at most ``max_bucket``
        records), as host arrays in the order of the features the host needs
        from the device — what ``score`` feeds the host remainder."""
        if not 0 < len(records) <= self.max_bucket:
            raise ValueError(f"prefix_outputs takes 1..{self.max_bucket} records")
        return self._run_prefix(self._encode_records(records)[1], len(records))

    def score(self, records: Sequence[Mapping[str, Any]]) -> List[Dict[str, Any]]:
        """Batch scoring: host encode, device prefix, host remainder."""
        n = len(records)
        if n == 0:
            return []
        if n > self.max_bucket:
            out: List[Dict[str, Any]] = []
            for i in range(0, n, self.max_bucket):
                out.extend(self.score(records[i:i + self.max_bucket]))
            return out
        t0 = time.perf_counter()
        host_cols, entries = self._encode_records(records)
        ds = self._run(host_cols, entries, n, time.perf_counter() - t0)
        return self._rows_from(ds, n)

    def _rows_from(self, ds: Dataset, n: int) -> List[Dict[str, Any]]:
        from ..models.prediction import PredictionColumn

        out: List[Dict[str, Any]] = [{} for _ in range(n)]
        for f in self.result_features:
            if f.name not in ds:
                continue
            col = ds[f.name]
            if isinstance(col, PredictionColumn):
                for row, v in zip(out, col.to_values()):
                    row[f.name] = v
            else:
                for row, v in zip(out, col.to_values()):
                    row[f.name] = _plain(v)
        return out

