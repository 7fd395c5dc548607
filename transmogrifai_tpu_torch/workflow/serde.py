"""Load a model saved by the reference package (counterpart of
``transmogrifai_tpu/workflow/serde.py``, load half only).

The reference's ``save_model`` writes a directory with ``model.json.gz`` (the
manifest: features, stage states, fitted-model states) and ``arrays.npz``
(every numpy array the states hold), at ``FORMAT_VERSION`` 1.  This loader is
the bridge that carries the JAX package's fitted parameters, as numpy
arrays, into the port's stages:

- transformer and fitted-model states rebuild through the port's
  ``STAGE_REGISTRY``, keyed by the reference class names, with their params
  and attributes restored as saved (arrays stay numpy);
- estimator nodes were saved as stubs (uid + wiring) and load as
  :class:`~..stages.base.EstimatorStub`; scoring resolves them to the fitted
  model saved under the same uid;
- a stage class the port does not have raises ``ValueError`` naming it, and
  nothing is returned: a model never loads half-built.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Any, Dict, Tuple

import numpy as np

from ..features.feature import Feature, _NamedExtract
from ..features.generator import FeatureGeneratorStage
from ..stages.base import EstimatorStub, PipelineStage, STAGE_REGISTRY, Transformer
from ..types import feature_type_by_name
from ..utils.vector_metadata import VectorMetadata

FORMAT_VERSION = 1


def _register_stages() -> None:
    """Import every module that defines a ported stage class."""
    from ..checkers import sanity  # noqa: F401
    from ..models import logistic, selector  # noqa: F401
    from ..ops import bucketizers, combiner, numeric, onehot, scalers  # noqa: F401


class _Decoder:
    def __init__(self, arrays):
        self.arrays = arrays

    def decode(self, v: Any) -> Any:
        if not isinstance(v, dict):
            return v
        if "__ndarray__" in v:
            return self.arrays[v["__ndarray__"]]
        if "__list__" in v:
            items = [self.decode(x) for x in v["__list__"]]
            return tuple(items) if v.get("__tuple__") else items
        if "__set__" in v:
            return {self.decode(x) for x in v["__set__"]}
        if "__dict__" in v:
            return {self.decode(k): self.decode(x) for k, x in v["__dict__"]}
        if "__named_extract__" in v:
            return _NamedExtract(v["__named_extract__"])
        if "__stage__" in v:
            return decode_stage(v["__stage__"], self)
        if "__vector_metadata__" in v:
            return VectorMetadata.from_dict(v["__vector_metadata__"])
        if "__dataclass__" in v:
            # summaries (selector, sanity checker) restore as plain data
            return self.decode(v["data"])
        if "__registered_fn__" in v or "__imported_fn__" in v:
            raise ValueError(
                f"saved function {v.get('__registered_fn__') or v.get('__imported_fn__')!r} "
                "is not ported to transmogrifai_tpu_torch: only named-field "
                "extracts load")
        if "__unserializable__" in v:
            return None
        return {k: self.decode(x) for k, x in v.items()}


def decode_stage(state: dict, dec: _Decoder) -> PipelineStage:
    cls_name = state["class"]
    if "generator" in state:
        g = state["generator"]
        extract = dec.decode(g["extract"]) or _NamedExtract(g["rawName"])
        return FeatureGeneratorStage(
            extract_fn=extract, ftype=feature_type_by_name(g["ftype"]),
            output_name=g["rawName"], is_response=g["isResponse"],
            uid=state["uid"])
    if not state.get("full", True):
        return EstimatorStub(cls_name, uid=state["uid"],
                             operation_name=state["operationName"])
    cls = STAGE_REGISTRY.get(cls_name)
    if cls is None or cls is EstimatorStub:
        raise ValueError(
            f"stage class {cls_name!r} (uid {state['uid']}) is not ported to "
            "transmogrifai_tpu_torch yet; this model cannot load")
    stage = object.__new__(cls)
    stage._param_values = {}
    stage.uid = state["uid"]
    stage.operation_name = state["operationName"]
    stage._input_features = ()
    stage._output_feature = None
    params = dec.decode(state["params"]) or {}
    cls_params = stage._class_params()
    for k, v in params.items():
        if k in cls_params:
            stage._param_values[k] = v
    for k, v in (state.get("attrs") or {}).items():
        setattr(stage, k, dec.decode(v))
    return stage


def load_model(path: str):
    """Rebuild the ``WorkflowModel`` saved at ``path`` by the reference."""
    from .workflow import WorkflowModel

    _register_stages()
    with gzip.open(os.path.join(path, "model.json.gz"), "rt") as fh:
        manifest = json.load(fh)
    if manifest["formatVersion"] > FORMAT_VERSION:
        raise ValueError(
            f"model saved by format version {manifest['formatVersion']}; this "
            f"loader reads up to {FORMAT_VERSION}")
    with np.load(os.path.join(path, "arrays.npz"), allow_pickle=False) as npz:
        dec = _Decoder({k: npz[k] for k in npz.files})

    uids = [s["uid"] for s in manifest["stages"]]
    dups = sorted({u for u in uids if uids.count(u) > 1})
    if dups:
        raise ValueError(f"[TM102] model manifest contains duplicate stage uid(s): {dups}")
    stage_states = {s["uid"]: s for s in manifest["stages"]}
    feat_states = {f["uid"]: f for f in manifest["features"]}
    stages: Dict[str, PipelineStage] = {}
    features: Dict[str, Feature] = {}

    def build_stage(uid: str, parents: Tuple[Feature, ...]) -> PipelineStage:
        if uid not in stages:
            st = decode_stage(stage_states[uid], dec)
            st._input_features = parents
            stages[uid] = st
        return stages[uid]

    def build_feature(uid: str) -> Feature:
        if uid in features:
            return features[uid]
        fs = feat_states[uid]
        parents = tuple(build_feature(p) for p in fs["parentUids"])
        origin = None
        if fs["originStageUid"] is not None:
            origin = build_stage(fs["originStageUid"], parents)
        feat = Feature(name=fs["name"], ftype=feature_type_by_name(fs["ftype"]),
                       is_response=fs["isResponse"], origin_stage=origin,
                       parents=parents, uid=uid)
        features[uid] = feat
        if origin is not None:
            origin._output_feature = feat
        return feat

    result_features = [build_feature(u) for u in manifest["resultFeatureUids"]]

    fitted: Dict[str, Transformer] = {}
    for uid, s in manifest["fitted"].items():
        t = decode_stage(s, dec)
        if uid in stages:
            t._input_features = stages[uid]._input_features
            t._output_feature = stages[uid]._output_feature
        else:
            t._input_features = tuple(
                features[u] for u in s["inputUids"] if u in features)
        fitted[uid] = t

    return WorkflowModel(result_features=result_features, fitted=fitted)
